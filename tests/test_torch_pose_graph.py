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
