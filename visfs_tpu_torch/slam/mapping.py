"""Global mapping back-end: a keyframe pose graph with verified loop
closures (torch port of visfs_tpu.slam.mapping).

VO keyframes accumulate into a fixed-capacity pose graph whose edges split
over a mesh's ranks and are solved by the matrix-free Gauss-Newton of
parallel/pose_graph.py.  Keyframe poses are stored as robot poses Twr; the
graph is optimized over their inverses Trw, so the relative-pose factor's
measurement is the plain odometry delta T_r1r2.

The graph operations are sync-free: an insert writes its row by a mask
over the capacity (no row matches at capacity: the insert is a no-op with
the counters clamped), and the reference's ``lax.cond`` is a
``torch.where`` over the edge fields.  ``MappingBackend`` is the host-side
driver; its per-candidate ``int``/``bool`` reads are host-side in the
reference too.  ``verify_loop`` never waits for the host: NCC matching, 48
Kabsch hypotheses (ops/rigid.py's sync-free closed form) scored by
reprojection, then the PnP RANSAC of ops/pnp.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import prng
from ..core.camera import project
from ..core.lie import mat_apply, mat_inv_se3, mat_to_quat, se3_matrix
from ..ops import pnp
from ..ops.image import extract_patch_bilinear
from ..ops.rigid import kabsch
from ..parallel import pose_graph
from ..parallel.mesh import Mesh
from .state import KeyframeGraph, KeyframeSnapshot
from .tracker import backproject

def init_graph(max_nodes: int = 1024, max_edges: int = 4096,
               device="cuda") -> KeyframeGraph:
    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    def unit_quats(n):
        q = f32(n, 4)
        q[:, 0] = 1.0
        return q

    return KeyframeGraph(
        pose_q=unit_quats(max_nodes), pose_t=f32(max_nodes, 3),
        stamp=f32(max_nodes), robot=i32(max_nodes),
        valid=torch.zeros(max_nodes, dtype=torch.bool, device=device),
        n_nodes=i32(), edge_i=i32(max_edges), edge_j=i32(max_edges),
        edge_q=unit_quats(max_edges), edge_t=f32(max_edges, 3),
        edge_info=f32(max_edges),
        edge_valid=torch.zeros(max_edges, dtype=torch.bool, device=device),
        n_edges=i32())


def _row(n, capacity: int, device):
    """[capacity] mask of row n (all False at n >= capacity: the write is
    dropped)."""
    return torch.arange(capacity, device=device) == n


def _set(at, value, field):
    """field with the rows in ``at`` set to value."""
    value = torch.as_tensor(value, dtype=field.dtype, device=field.device)
    return torch.where(at.reshape(at.shape + (1,) * (field.dim() - 1)),
                       value, field)


def _append_edge(g: KeyframeGraph, i, j, rel_q, rel_t, info) -> KeyframeGraph:
    E = g.edge_i.shape[0]
    e = g.n_edges
    at = _row(e, E, e.device)
    return g._replace(
        edge_i=_set(at, i, g.edge_i), edge_j=_set(at, j, g.edge_j),
        edge_q=_set(at, rel_q, g.edge_q), edge_t=_set(at, rel_t, g.edge_t),
        edge_info=_set(at, info, g.edge_info),
        edge_valid=_set(at, True, g.edge_valid),
        n_edges=torch.clamp(e + 1, max=E))


def add_keyframe(g: KeyframeGraph, pose, stamp, odom_info: float = 1e4,
                 robot=0, prev_node=None) -> KeyframeGraph:
    """Append a keyframe (Twr 4x4 on the graph's device), linked by an
    odometry edge measured from the current estimates.

    prev_node selects the odometry-chain predecessor: by default the last
    inserted node; a multi-robot session passes each robot's own previous
    keyframe so odometry chains never cross robots (-1 for a robot's first
    keyframe: no odometry edge).  At capacity the insert is a no-op and the
    counters stay clamped."""
    N = g.pose_q.shape[0]
    n = g.n_nodes
    prev = n - 1 if prev_node is None else torch.as_tensor(
        prev_node, dtype=torch.int32, device=n.device)
    at = _row(n, N, n.device)
    g = g._replace(
        pose_q=_set(at, mat_to_quat(pose[:3, :3]), g.pose_q),
        pose_t=_set(at, pose[:3, 3], g.pose_t),
        stamp=_set(at, stamp, g.stamp), robot=_set(at, robot, g.robot),
        valid=_set(at, True, g.valid), n_nodes=torch.clamp(n + 1, max=N))
    # the odometry edge, kept where the predecessor exists and the node fit
    k = torch.clamp(prev, 0, N - 1).reshape(1).long()
    prev_pose = se3_matrix(torch.index_select(g.pose_q, 0, k)[0],
                           torch.index_select(g.pose_t, 0, k)[0])
    rel = mat_inv_se3(prev_pose) @ pose
    linked = _append_edge(g, prev, n, mat_to_quat(rel[:3, :3]), rel[:3, 3],
                          odom_info)
    take = (prev >= 0) & (n < N)
    return g._replace(**{f: torch.where(take, getattr(linked, f),
                                        getattr(g, f))
                         for f in KeyframeGraph._fields
                         if f.startswith(("edge_", "n_edges"))})


def add_loop_closure(g: KeyframeGraph, i, j, rel,
                     info: float = 1e4) -> KeyframeGraph:
    """Add a loop-closure edge: rel = measured T_ri_rj (4x4).  No-op at
    edge capacity."""
    return _append_edge(g, i, j, mat_to_quat(rel[:3, :3]), rel[:3, 3], info)


def propose_loop_candidates(g: KeyframeGraph, radius: float = 2.0,
                            min_gap: int = 10, max_candidates: int = 16):
    """Proximity loop candidates: node pairs within ``radius`` that belong to
    different robots (any index distance) or lie at least ``min_gap``
    indices apart.  The gap counts global node indices, which interleave
    when robots alternate (the reference's behaviour, kept for parity).
    Returns ([K, 2] indices, [K] validity), nearest first, ties to the
    lower flat index as lax.top_k breaks them."""
    N = g.pose_t.shape[0]
    d2 = torch.sum((g.pose_t[:, None, :] - g.pose_t[None, :, :]) ** 2,
                   dim=-1)
    ii = torch.arange(N, device=d2.device)
    cross = g.robot[:, None] != g.robot[None, :]
    gap_ok = (ii[None, :] - ii[:, None] >= min_gap) | (
        cross & (ii[None, :] > ii[:, None]))
    pairmask = (g.valid[:, None] & g.valid[None, :] & gap_ok
                & (d2 <= radius * radius))
    score = torch.where(pairmask, -d2, torch.full_like(d2, -torch.inf))
    top, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    top, idx = top[:max_candidates], idx[:max_candidates]
    return torch.stack([idx // N, idx % N], dim=-1), torch.isfinite(top)


def optimize_graph(g: KeyframeGraph, mesh: Optional[Mesh] = None,
                   iterations: int = 10, huber_delta: float = 1.0,
                   cg_iters: int = 50):
    """The pose-graph solve; returns the updated graph and the final chi2.
    Node 0 anchors the gauge."""
    Trw = mat_inv_se3(se3_matrix(g.pose_q, g.pose_t))
    N = g.pose_q.shape[0]
    graph = pose_graph.PoseGraph(
        pose_q=mat_to_quat(Trw[..., :3, :3]), pose_t=Trw[..., :3, 3],
        pose_fixed=(~g.valid) | (torch.arange(N, device=g.valid.device)
                                 == 0),
        edge_i=g.edge_i, edge_j=g.edge_j, edge_q=g.edge_q, edge_t=g.edge_t,
        edge_info=g.edge_info, edge_mask=g.edge_valid)
    q, t, chi2 = pose_graph.optimize(graph, mesh, iterations=iterations,
                                     huber_delta=huber_delta,
                                     cg_iters=cg_iters)
    Twr = mat_inv_se3(se3_matrix(q, t))
    v = g.valid[:, None]
    return g._replace(
        pose_q=torch.where(v, mat_to_quat(Twr[..., :3, :3]), g.pose_q),
        pose_t=torch.where(v, Twr[..., :3, 3], g.pose_t)), chi2


class MappingBackend:
    """Host-side driver: accumulate VO keyframes, close loops, optimize.

        backend = MappingBackend(mesh)        # mesh None: one process
        for each VO output: backend.maybe_add(out)   # uses out.keyframe
        backend.close_loops(cam)              # or add_loop_closure(i, j, rel)
        backend.optimize()
        corrected = backend.poses()

    The graph and the snapshots live on ``device`` ("cuda" unless the
    caller asks for "cpu")."""

    def __init__(self, mesh: Optional[Mesh] = None, max_nodes: int = 1024,
                 max_edges: int = 4096, odom_info: float = 1e4,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MappingBackend: device 'cuda' requested but "
                               "CUDA is not available")
        self.mesh = mesh
        self.graph = init_graph(max_nodes, max_edges, self.device)
        self.odom_info = odom_info
        self.snapshots: dict[int, KeyframeSnapshot] = {}
        # Per-robot tail of the odometry chain: robot r's next keyframe
        # links to _last_node[r], never to another robot's chain.
        self._last_node: dict[int, int] = {}
        # Pairs close_loops already decided (accepted or rejected):
        # verifying them again would duplicate edges and their information.
        self._decided_pairs: set[tuple[int, int]] = set()

    def maybe_add(self, frame_output, snapshot=None, robot: int = 0) -> bool:
        """Add a keyframe from a FrameOutput (numpy fields) when it is one
        and tracked."""
        if bool(frame_output.keyframe) and not bool(frame_output.lost):
            self.add_keyframe(frame_output.pose, frame_output.stamp,
                              snapshot=snapshot, robot=robot)
            return True
        return False

    def add_keyframe(self, pose, stamp, snapshot=None, robot: int = 0):
        """Insert a keyframe; returns its node id, or None when the graph is
        at node capacity (the insert is then a no-op)."""
        node_id = int(self.graph.n_nodes)
        if node_id >= self.graph.pose_q.shape[0]:
            return None
        if snapshot is not None:
            self.snapshots[node_id] = snapshot
        prev = self._last_node.get(int(robot), -1)
        self.graph = add_keyframe(
            self.graph, torch.as_tensor(np.array(pose, np.float32),
                                        device=self.device),
            np.float32(stamp), self.odom_info, robot=int(robot),
            prev_node=prev)
        self._last_node[int(robot)] = node_id
        return node_id

    def add_loop_closure(self, i: int, j: int, rel, info: float = 1e4):
        rel = torch.as_tensor(rel, dtype=torch.float32, device=self.device)
        self.graph = add_loop_closure(self.graph, int(i), int(j), rel,
                                      np.float32(info))

    def loop_candidates(self, radius: float = 2.0, min_gap: int = 10):
        pairs, valid = propose_loop_candidates(self.graph, radius, min_gap)
        return pairs.cpu().numpy()[valid.cpu().numpy()]

    def close_loops(self, cam, radius: float = 2.0, min_gap: int = 10,
                    min_inliers: int = 10, min_ncc: float = 0.4,
                    seed: int = 0) -> int:
        """Propose, verify and insert loop closures.

        Runs verify_loop on every not-yet-decided proximity candidate whose
        endpoints both carry snapshots; accepted closures (>= min_inliers)
        become edges with information 1e3 per inlier.  Returns the number
        of closures added."""
        key = prng.PRNGKey(seed, self.device)
        added = 0
        for (i, j) in self.loop_candidates(radius, min_gap):
            pair = (int(i), int(j))
            if pair in self._decided_pairs:
                continue
            si = self.snapshots.get(pair[0])
            sj = self.snapshots.get(pair[1])
            if si is None or sj is None:
                continue
            key, sub = prng.split(key)
            rel, ok, n_inl = verify_loop(si, sj, cam, sub,
                                         min_inliers=min_inliers,
                                         min_ncc=min_ncc)
            self._decided_pairs.add(pair)
            if bool(ok) and int(n_inl) >= min_inliers:
                self.add_loop_closure(pair[0], pair[1], rel,
                                      info=1e3 * float(n_inl))
                added += 1
        return added

    def optimize(self, iterations: int = 10, cg_iters: int = 50) -> float:
        self.graph, chi2 = optimize_graph(self.graph, self.mesh,
                                          iterations=iterations,
                                          cg_iters=cg_iters)
        return float(chi2)

    def poses(self) -> np.ndarray:
        """[n, 4, 4] keyframe poses Twr."""
        n = int(self.graph.n_nodes)
        return se3_matrix(self.graph.pose_q[:n],
                          self.graph.pose_t[:n]).cpu().numpy()


# ---------------------------------------------------------------------------
# Loop-closure verification: keyframe feature snapshots matched by
# normalized patch correlation, then a Kabsch / PnP-RANSAC relative pose
# with an inlier gate.
# ---------------------------------------------------------------------------

def snapshot_features(features, left_img, cam, max_kp: int = 64,
                      patch_size: int = 8,
                      scales: tuple = (1, 3, 6)) -> KeyframeSnapshot:
    """A KeyframeSnapshot from the live feature table and left image.

    Selects the ``max_kp`` longest-tracked features with a current
    observation and valid depth (ties to the lower slot, as lax.top_k) and
    describes each at every scale s by a ``patch_size`` x ``patch_size``
    grid average-pooled from a ``patch_size * s`` pixel window, each block
    zero-mean and unit-norm, concatenated."""
    cur = features.uv.shape[1] - 1
    ok = features.valid & features.obs_mask[:, cur] \
        & (features.depth[:, cur] > 0)
    score = torch.where(ok, features.track_cnt,
                        torch.full_like(features.track_cnt, -1))
    idx = torch.sort(score, descending=True, stable=True)[1][:max_kp]
    uv = features.uv[idx, cur]
    p_robot = backproject(cam, uv, features.depth[idx, cur])
    blocks = []
    for s in scales:
        raw = extract_patch_bilinear(left_img, uv, patch_size * s)
        pooled = raw.reshape(max_kp, patch_size, s, patch_size, s).mean(
            dim=(2, 4)).reshape(max_kp, patch_size * patch_size)
        cen = pooled - torch.mean(pooled, dim=1, keepdim=True)
        blocks.append(cen / torch.clamp(torch.linalg.vector_norm(
            cen, dim=1, keepdim=True), min=1e-6))
    patches = torch.cat(blocks, dim=1) / torch.sqrt(torch.tensor(
        float(len(scales)), dtype=left_img.dtype, device=left_img.device))
    return KeyframeSnapshot(uv=uv, p_robot=p_robot, patch=patches,
                            valid=score[idx] >= 0)


def verify_loop(snap_i: KeyframeSnapshot, snap_j: KeyframeSnapshot, cam,
                rng_key, min_inliers: int = 10, min_ncc: float = 0.4,
                ratio: float = 0.99, px_gate: float = 3.0,
                depth_sigma_px: float = 0.5):
    """Geometric verification of a loop candidate (i, j).

      1. appearance matching: normalized cross-correlation of the patches,
         mutual nearest and a ratio test;
      2. global initialization: 48 minimal 3-point Kabsch solves on the
         matched stereo points (subsets by Gumbel top-3, biased toward
         near, range-certain points), scored by reprojection error in j's
         image (pixels, not metres: stereo range error grows as z^2);
      3. precision and gating: PnP RANSAC seeded with the best hypothesis.

    Returns (rel [4, 4] = T_ri_rj, ok, n_inliers), all on the device."""
    if snap_i.uv.shape[0] != snap_j.uv.shape[0]:
        raise ValueError(
            "verify_loop requires snapshots of equal max_kp; got "
            f"{snap_i.uv.shape[0]} vs {snap_j.uv.shape[0]}")
    M = snap_i.uv.shape[0]
    dev = snap_i.uv.device
    ar = torch.arange(M, device=dev)
    ncc = snap_i.patch @ snap_j.patch.T  # [M, M]
    pairmask = snap_i.valid[:, None] & snap_j.valid[None, :]
    ncc = torch.where(pairmask, ncc, torch.full_like(ncc, -2.0))

    best_j = torch.argmax(ncc, dim=1)  # the first maximum, as jnp.argmax
    row = torch.take_along_dim(ncc, best_j[:, None], dim=1)[:, 0]
    row2 = torch.amax(torch.where(best_j[:, None] == ar[None, :],
                                  torch.full_like(ncc, -2.0), ncc), dim=1)
    mutual = torch.argmax(ncc, dim=0)[best_j] == ar
    match_ok = snap_i.valid & mutual & (row >= min_ncc) \
        & (row2 <= ratio * row)

    # Coarse rel: p_i ~= R p_j + t, hypotheses scored by reprojecting i's
    # points into j's image against the matched pixels.
    key_k, key_p = prng.split(rng_key)
    dtype = snap_i.p_robot.dtype
    p_i = snap_i.p_robot
    p_j = snap_j.p_robot[best_j]
    uv_j = snap_j.uv[best_j]
    z_i = torch.linalg.vector_norm(p_i, dim=-1)
    z_j = torch.linalg.vector_norm(p_j, dim=-1)
    sigma = (depth_sigma_px / cam.bf) * torch.sqrt(z_i ** 4 + z_j ** 4)
    conf = -torch.log(torch.clamp(sigma, min=1e-4))
    n_hyp = 48
    g = prng.gumbel(key_k, (n_hyp, M))
    scores = torch.where(match_ok[None, :], g + conf[None, :],
                         torch.full_like(g, -torch.inf))
    subsets = torch.sort(scores, dim=-1, descending=True,
                         stable=True)[1][:, :3]  # lax.top_k's order
    w = torch.zeros((n_hyp, M), dtype=dtype, device=dev).scatter(
        1, subsets, 1.0) * match_ok.to(dtype)
    Rs, ts = kabsch(p_i, p_j, w)  # [n_hyp, 3, 3], [n_hyp, 3]
    p_in_j = (p_i[None] - ts[:, None, :]) @ Rs  # rows: R^T (p_i - t)
    p_img = mat_apply(cam.t_ir, p_in_j)
    err = torch.linalg.vector_norm(project(cam, p_img) - uv_j, dim=-1)
    inl = match_ok & (err <= px_gate) & (p_img[..., 2] > 0.1)
    counts = torch.sum(inl, dim=-1)
    bh = torch.argmax(counts).reshape(1)  # a 1-d index: no host read
    R0 = torch.index_select(Rs, 0, bh)[0]
    t0 = torch.index_select(ts, 0, bh)[0]
    coarse_ok = ((torch.index_select(counts, 0, bh)[0] >= min_inliers)
                 & torch.all(torch.isfinite(R0))
                 & torch.all(torch.isfinite(t0)))
    rel0 = torch.cat([torch.cat([R0, t0[:, None]], dim=1),
                      torch.eye(4, dtype=dtype, device=dev)[3:]], dim=0)

    # PnP refinement: i's robot-frame points against j's pixels, the guess
    # from the Kabsch estimate.
    guess_cam = mat_inv_se3(rel0 @ cam.t_ri)
    res = pnp.solve_pnp_ransac(
        snap_i.p_robot, uv_j, match_ok, mat_to_quat(guess_cam[:3, :3]),
        guess_cam[:3, 3], cam.fx, cam.fy, cam.cx, cam.cy, key_p,
        pnp.PnPSettings(iterations=16, min_inliers=min_inliers))
    rel = mat_inv_se3(cam.t_ri @ se3_matrix(res.q, res.t))
    return (torch.where(res.ok, rel, rel0), coarse_ok & res.ok,
            res.n_inliers)
