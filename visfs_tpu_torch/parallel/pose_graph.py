"""Distributed pose-graph optimization, the global mapping back-end's solve
(torch port of visfs_tpu.parallel.pose_graph).

Keyframe poses are replicated on every rank and the constraint edges are
split over the mesh's ranks, a contiguous block each (shard_map's split):

  * Gauss-Newton with the relative-pose factor (solver/factors.py) and a
    Huber weight;
  * the sparse normal system is never built: a matrix-free preconditioned
    conjugate gradient runs with per-edge gathers and per-pose sums, the
    per-edge terms made on the rank's edges;
  * a block-Jacobi preconditioner (6x6 per pose) whose blocks are
    inverted in closed form (``solve6x6_spd``): the reference's
    ``jnp.linalg.inv`` would be a batched LU, and no step here waits for
    the host.

Each per-pose sum adds a pose's terms in one fixed order on every device
(``ops/kernels/segment_sum.py``: on the card a kernel walks each pose's
terms, laid out once per graph; on the CPU ``index_add_``): its from-side
terms in edge order, then its to-side terms.  ``index_add_`` on the card
would add in atomic order, and a graph with closures (poses of 3 edges or
more) turns that last-bit difference into ~1e-4 m after the CG; so two
solves of one graph give one answer with no global flag.

Where the reference psums each rank's per-pose partial sums (the
gradient, the preconditioner, every CG matvec, chi2), each rank here
all-gathers the ranks' per-edge terms (one ``all_gather`` a scatter,
skipped for a mesh of one) and adds all of them in the one-rank solve's
order: a sum of partials would associate a pose's terms differently.  A
rank makes its edges' terms (w J^T r, w J^T J, w J^T y) through
``ops/kernels/edge_products.py``: on the card a kernel computes each
element in the CPU einsum's order whatever the shard's size (the einsum's
batched product on the card rounds by the batch: a 128-edge shard's terms
differed in their last bits from the 512-edge graph's rows); on the CPU
the einsums.  So the sharded solve equals the one-rank solve bit for bit,
on the CPU and on the card.  The loops run a fixed count with no
data-dependent exit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.kernels.edge_products import (edge_blocks, edge_gradient,
                                         edge_matvec)
from ..ops.kernels.segment_sum import Segments, segment_sum, segments
from ..solver.factors import (apply_tangent, huber_weight,
                              pose_link_jacobians, pose_link_residual,
                              solve6x6_spd)
from .mesh import Mesh, all_gather, shard


class PoseGraph(NamedTuple):
    """N poses (camera-from-world q/t) and E directed relative-pose
    edges."""

    pose_q: torch.Tensor  # [N, 4]
    pose_t: torch.Tensor  # [N, 3]
    pose_fixed: torch.Tensor  # [N] bool (gauge anchors)
    edge_i: torch.Tensor  # [E] int from-pose index
    edge_j: torch.Tensor  # [E] int to-pose index
    edge_q: torch.Tensor  # [E, 4] measured relative rotation
    edge_t: torch.Tensor  # [E, 3]
    edge_info: torch.Tensor  # [E] scalar information weight
    edge_mask: torch.Tensor  # [E] bool


def _edge_terms(g: PoseGraph, pose_q, pose_t, huber_delta):
    """Residuals, Jacobians and robust weights of (a shard of) the edges."""
    qi, ti = pose_q[g.edge_i], pose_t[g.edge_i]
    qj, tj = pose_q[g.edge_j], pose_t[g.edge_j]
    r = pose_link_residual(qi, ti, qj, tj, g.edge_q, g.edge_t)
    Ji, Jj = pose_link_jacobians(qi, ti, qj, tj, g.edge_q, g.edge_t)
    chi2 = g.edge_info * torch.sum(r * r, dim=-1)
    w = g.edge_info * huber_weight(chi2, huber_delta) \
        * g.edge_mask.to(r.dtype)
    return r, Ji, Jj, w, chi2


def _scatter(n: int, edges: Segments, terms, group):
    """Per-pose sums of the edges' stacked [E, 2, ...] from- and to-side
    terms: the ranks' terms gathered in edge order, then added on every
    rank in the fixed order."""
    return segment_sum(all_gather(terms, group), edges, n)


def _shard_edges(graph: PoseGraph, mesh: Optional[Mesh]):
    """This rank's edges (indices as int64), the poses whole; and where
    every edge's terms are added (laid out once per graph)."""
    group = None if mesh is None else mesh.group
    e = {f: shard(getattr(graph, f), group) for f in PoseGraph._fields
         if f.startswith("edge_")}
    e["edge_i"] = e["edge_i"].long()
    e["edge_j"] = e["edge_j"].long()
    return graph._replace(**e), segments(graph.edge_i, graph.edge_j,
                                         graph.edge_mask,
                                         graph.pose_q.shape[0])


def _gn_step(g: PoseGraph, edges: Segments, group, huber_delta, lam,
             cg_iters):
    """One Gauss-Newton step on a rank's edge shard: (q, t, chi2)."""
    N = g.pose_q.shape[0]
    dtype = g.pose_t.dtype
    free = (~g.pose_fixed).to(dtype)[:, None]  # [N, 1]
    r, Ji, Jj, w, chi2 = _edge_terms(g, g.pose_q, g.pose_t, huber_delta)
    total_chi2 = torch.sum(all_gather(chi2 * g.edge_mask.to(dtype), group))

    # gradient b = -J^T W r, summed per pose over every rank's edges
    b = _scatter(N, edges, -edge_gradient(w, Ji, Jj, r), group) * free

    # block-Jacobi preconditioner: the 6x6 diagonal blocks of H
    M = _scatter(N, edges, edge_blocks(w, Ji, Jj), group)
    eye6 = torch.eye(6, dtype=dtype, device=M.device)
    M = M + (lam + 1e-6) * eye6
    # the blocks are SPD: M^-1's columns by the closed-form 6x6 solve
    M_inv = solve6x6_spd(M[:, None], eye6.expand(N, 6, 6))

    def matvec(x):
        """H x with H = J^T W J (+ lam I), matrix-free over edges (J_e x
        made inside edge_matvec)."""
        z = _scatter(N, edges, edge_matvec(w, Ji, Jj, x, g.edge_i, g.edge_j),
                     group)
        return (z + lam * x) * free

    def precond(x):
        return torch.einsum("nij,nj->ni", M_inv, x) * free

    def guarded(d):
        return torch.where(torch.abs(d) < 1e-12, torch.ones_like(d), d)

    # preconditioned CG on the 6N system, a fixed count of iterations
    x = torch.zeros((N, 6), dtype=dtype, device=b.device)
    rr = b - matvec(x)
    z = precond(rr)
    p = z
    for _ in range(cg_iters):
        Ap = matvec(p)
        rz = torch.sum(rr * z)
        alpha = rz / guarded(torch.sum(p * Ap))
        x = x + alpha * p
        rr = rr - alpha * Ap
        z_new = precond(rr)
        beta = torch.sum(rr * z_new) / guarded(rz)
        z, p = z_new, z_new + beta * p
    dx = torch.where(torch.isfinite(x), x, torch.zeros_like(x)) * free

    new_q, new_t = apply_tangent(g.pose_q, g.pose_t, dx)
    fixed = g.pose_fixed[:, None]
    return (torch.where(fixed, g.pose_q, new_q),
            torch.where(fixed, g.pose_t, new_t), total_chi2)


def gn_step(graph: PoseGraph, mesh: Optional[Mesh] = None,
            huber_delta: float = 1.0, lam: float = 1e-6,
            cg_iters: int = 50):
    """One Gauss-Newton step, the edges split over the mesh's ranks (every
    rank passes the whole graph); returns (pose_q, pose_t, chi2), chi2 at
    the step's input poses."""
    g, edges = _shard_edges(graph, mesh)
    return _gn_step(g, edges, None if mesh is None else mesh.group,
                    huber_delta, lam, cg_iters)


def optimize(graph: PoseGraph, mesh: Optional[Mesh] = None,
             iterations: int = 10, huber_delta: float = 1.0,
             lam: float = 1e-6, cg_iters: int = 50):
    """``iterations`` Gauss-Newton steps, the edges split over the mesh's
    ranks (every rank passes the whole graph and gets the same result);
    returns (q, t, chi2 of the last step's input poses)."""
    g, edges = _shard_edges(graph, mesh)
    group = None if mesh is None else mesh.group
    chi2 = torch.zeros((), dtype=g.pose_t.dtype, device=g.pose_t.device)
    for _ in range(iterations):
        q, t, chi2 = _gn_step(g, edges, group, huber_delta, lam, cg_iters)
        g = g._replace(pose_q=q, pose_t=t)
    return g.pose_q, g.pose_t, chi2
