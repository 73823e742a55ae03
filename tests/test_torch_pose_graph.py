"""visfs_tpu_torch.parallel.pose_graph and slam.mapping's solve against
visfs_tpu's, the reference on its 8-device virtual CPU mesh ("edges"), the
port in one process.

Problems: tests/test_distributed.py's build_pose_graph (a 32-pose circle
with three loop closures, every pose but the anchor perturbed) and
tests/test_mapping.py's drifting square loop with its two closures.
Tolerances: q and t within 1e-4, chi2 rtol 1e-3, the anchor bit-fixed;
MappingBackend over the loop: poses within 1e-4 after optimize.  The
port's 6x6 preconditioner blocks are inverted in closed form and its
scatters are index_add_, so the CG iterates differ from the reference's by
rounding only."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from visfs_tpu.parallel import pose_graph as jpg
from visfs_tpu.slam import mapping as jmap
from visfs_tpu_torch.parallel import pose_graph as tpg
from visfs_tpu_torch.parallel.mesh import edge_mesh
from visfs_tpu_torch.slam import mapping as tmap
from visfs_tpu_torch.slam.state import graph_from_numpy, graph_to_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_distributed import build_pose_graph  # noqa: E402
from test_mapping import square_loop_trajectory  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices()[:8]), ("edges",))


def _torch_graph(g):
    return tpg.PoseGraph(*(torch.from_numpy(np.array(x)) for x in g))


@pytest.fixture(scope="module")
def circle(jmesh):
    graph, _, _ = build_pose_graph(np.random.default_rng(42))
    ref = jpg.optimize(graph, jmesh, iterations=10, cg_iters=60)
    port = tpg.optimize(_torch_graph(graph), edge_mesh(), iterations=10,
                        cg_iters=60)
    return graph, [np.asarray(x) for x in ref], [x.numpy() for x in port]


def test_circle_poses_match_reference(circle):
    _, (q_r, t_r, _), (q, t, _) = circle
    np.testing.assert_allclose(q, q_r, atol=1e-4)
    np.testing.assert_allclose(t, t_r, atol=1e-4)


def test_circle_chi2_matches_reference(circle):
    _, (_, _, chi2_r), (_, _, chi2) = circle
    np.testing.assert_allclose(chi2, chi2_r, rtol=1e-3, atol=1e-9)


def test_circle_anchor_bit_fixed(circle):
    graph, _, (q, t, _) = circle
    np.testing.assert_array_equal(q[0], np.asarray(graph.pose_q[0]))
    np.testing.assert_array_equal(t[0], np.asarray(graph.pose_t[0]))


def test_gn_step_matches_reference(circle, jmesh):
    graph = circle[0]
    ref = jax.jit(lambda g: jpg.gn_step(g, jmesh, cg_iters=30))(graph)
    port = tpg.gn_step(_torch_graph(graph), None, cg_iters=30)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-3)


def square_loop_backend(backend_cls, mesh, **kw):
    """tests/test_mapping.py's loop-closure scenario: the drifting square
    loop as keyframes, its end-to-start and mid-loop closures."""
    gt, est = square_loop_trajectory(drift=0.015, seed=3)
    backend = backend_cls(mesh, max_nodes=64, max_edges=512, **kw)
    for k in range(len(est)):
        backend.add_keyframe(est[k], float(k))
    n = len(est)
    backend.add_loop_closure(0, n - 1, np.linalg.inv(gt[0]) @ gt[n - 1],
                             info=1e5)
    backend.add_loop_closure(0, n // 2, np.linalg.inv(gt[0]) @ gt[n // 2],
                             info=1e5)
    return backend


@pytest.fixture(scope="module")
def square(jmesh):
    """(the reference graph as numpy, its solve (jitted: the graph, chi2),
    the port's backend over the same loop)."""
    ref = square_loop_backend(jmap.MappingBackend, jmesh)
    solve = jax.jit(lambda g: jmap.optimize_graph(g, jmesh, iterations=10,
                                                  cg_iters=80))
    g_r, chi2_r = jax.device_get(solve(ref.graph))
    port = square_loop_backend(tmap.MappingBackend, None, device="cpu")
    return jax.device_get(ref.graph), g_r, float(chi2_r), port


def test_square_optimize_graph_matches_reference(square):
    g_np, g_r, chi2_r, _ = square
    g, chi2 = tmap.optimize_graph(graph_from_numpy(g_np, "cpu"), None,
                                  iterations=10, cg_iters=80)
    out = graph_to_numpy(g)
    np.testing.assert_allclose(out.pose_t, g_r.pose_t, atol=1e-4)
    np.testing.assert_allclose(out.pose_q, g_r.pose_q, atol=1e-4)
    np.testing.assert_allclose(float(chi2), chi2_r, rtol=1e-3)
    np.testing.assert_array_equal(out.pose_q[0], g_np.pose_q[0])
    np.testing.assert_array_equal(out.pose_t[0], g_np.pose_t[0])


def test_square_backend_matches_reference(square):
    """The port's MappingBackend (its own keyframe inserts and closures)
    against the reference MappingBackend's graph solved as its optimize()
    solves it."""
    _, g_r, chi2_r, port = square
    chi2 = port.optimize(iterations=10, cg_iters=80)
    n = len(port.poses())
    np.testing.assert_allclose(port.graph.pose_t[:n].numpy(), g_r.pose_t[:n],
                               atol=1e-4)
    np.testing.assert_allclose(port.graph.pose_q[:n].numpy(), g_r.pose_q[:n],
                               atol=1e-4)
    np.testing.assert_allclose(chi2, chi2_r, rtol=1e-3)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _walk(terms, seg, n):
    """csrc/segment_sum.cu's walk in PyTorch: for each pose, starting from
    +0, its rows[start[p]:start[p+1]] added one at a time in order (a
    finished run adds +0, which changes no sum that starts at +0)."""
    e = seg.i.shape[0]
    flat = terms.reshape(2 * e, -1)
    acc = torch.zeros((n, flat.shape[1]), dtype=terms.dtype)
    count = seg.start[1:] - seg.start[:-1]
    for k in range(int(count.max()) if n else 0):
        live = k < count
        row = seg.rows[torch.where(live, seg.start[:-1] + k, 0)]
        acc = acc + torch.where(live[:, None], flat[row],
                                torch.zeros((), dtype=terms.dtype))
    return acc.reshape((n,) + terms.shape[2:])


def _graph_with_closures(name, circle, square):
    """The circle (three closures, pose 0 with three edges, padded with
    masked edges) or the square loop's MappingBackend graph (two closures,
    512 edge slots, most of them masked)."""
    if name == "circle":
        return _torch_graph(circle[0])
    g = square[3].graph
    return tpg.PoseGraph(g.pose_q, g.pose_t, ~g.valid, g.edge_i, g.edge_j,
                         g.edge_q, g.edge_t, g.edge_info, g.edge_valid)


@pytest.mark.parametrize("shape", [(6,), (6, 6)])
@pytest.mark.parametrize("name", ["circle", "square"])
def test_scatter_fixed_order_bit_equal_to_index_add(name, shape, circle,
                                                     square):
    """_scatter (the fixed-order per-pose sum) with deterministic algorithms
    off, on a graph where poses have 3 edges or more on both sides, is bit
    for bit the old order, written out here: index_add_ of the from-side
    terms, then of the to-side terms; so is the card kernel's walk of the
    per-graph layout.  A masked edge's terms are its weight's 0 times a
    term (signed zeros included)."""
    assert not torch.are_deterministic_algorithms_enabled()
    graph = _graph_with_closures(name, circle, square)
    n = graph.pose_q.shape[0]
    _, edges = tpg._shard_edges(graph, None)
    i, j = graph.edge_i.long(), graph.edge_j.long()
    mask = graph.edge_mask
    degree = torch.bincount(i[mask], minlength=n) + torch.bincount(
        j[mask], minlength=n)
    assert int(degree.max()) >= 3
    assert bool(((torch.bincount(i[mask], minlength=n) > 0)
                 & (torch.bincount(j[mask], minlength=n) > 0)).any())
    rng = np.random.default_rng(len(shape))
    w = mask.to(torch.float32).reshape((-1,) + (1,) * len(shape))
    vi, vj = (torch.from_numpy(rng.normal(size=(len(i),) + shape).astype(
        np.float32)) * w for _ in range(2))
    terms = torch.stack((vi, vj), 1)
    got = tpg._scatter(n, edges, terms, None)
    old = torch.zeros((n,) + shape).index_add_(0, i, vi).index_add_(0, j, vj)
    assert torch.equal(_bits(got), _bits(old))
    walked = _walk(terms, edges, n)
    assert torch.equal(_bits(walked), _bits(old))
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("name", ["circle", "square"])
def test_solve_through_the_kernels_walk_is_bit_equal(name, circle, square,
                                                     monkeypatch):
    """The whole solve with the card kernel's walk in place of the CPU's
    index_add_ pair (the solve's own per-edge terms, masked edges
    included) gives the same bits: poses and chi2."""
    graph = _graph_with_closures(name, circle, square)
    want = tpg.optimize(graph, None, iterations=3, cg_iters=20)
    monkeypatch.setattr(tpg, "segment_sum", _walk)
    got = tpg.optimize(graph, None, iterations=3, cg_iters=20)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
