"""The slice as a whole: visfs_tpu_torch's MultiRobotMapping against
visfs_tpu's, on the same frames.

Two robots at 160x120 (the slice parameters of tests/test_torch_system.py,
each reference System's LK levels on its Pallas kernel, the formulation
the port's K1 computes): robot 0 drives frames 0-7 of the textured square
loop, robot 1 frames 1-8 from the start pose seq.poses[1], so their
keyframes interleave a frame apart and cross-robot closures exist.
Tolerances: keyframe counts and the graph's node and edge counts
identical, graph poses within 1e-3 m per keyframe, the same accepted
closures (pairs, in order), poses after optimize within 1e-3 m.  The VO
slice tracks the reference within 3e-5 m per frame over 8 frames here
(tests/test_torch_system.py)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from visfs_tpu.io.sim import cached_textured_sequence
from visfs_tpu.slam.multi_robot import MultiRobotMapping as JMultiRobot
from visfs_tpu_torch.slam.multi_robot import MultiRobotMapping

torch.set_num_threads(1)

PARAMS = {
    "Tracker/MaxFeatures": 40,
    "Tracker/MinDistance": 12,
    "Tracker/QualityLevel": 0.05,
    "LocalMap/MapSize": 5,
    "Optimizer/Iterations": 20,
    "Estimator/Force3DoF": True,
    "Estimator/ToleranceTranslation": 0.40,
}
FRAMES = {0: range(0, 8), 1: range(1, 9)}
SESSION = dict(max_nodes=32, max_edges=128, snapshot_kp=40)
LOOPS = dict(radius=2.0, min_gap=4, min_inliers=10)


def _drive(session, seq):
    cam = seq.camera
    session.init(float(cam.fx), float(cam.fy), float(cam.cx),
                 float(cam.cy), float(cam.baseline), width=cam.width,
                 height=cam.height)
    for r, frames in FRAMES.items():
        for k in frames:
            session.input_primary_sensor_data(r, float(seq.stamps[k]),
                                              seq.left[k], seq.right[k])
    session.finish()
    return session


def _edges(g):
    """The graph's (i, j) edge list, for either package's graph."""
    n = int(g.n_edges)
    ei, ej = (np.asarray(x[:n].cpu() if torch.is_tensor(x) else x[:n])
              for x in (g.edge_i, g.edge_j))
    return list(zip(ei.tolist(), ej.tolist()))


@pytest.fixture(scope="module")
def sessions():
    seq = cached_textured_sequence(n_frames=9, width=160, height=120,
                                   motion="square", seed=0, speed=2.0)
    starts = [np.eye(4, dtype=np.float32), seq.poses[1]]
    ref = JMultiRobot(PARAMS, n_robots=2,
                      mesh=JMesh(np.array(jax.devices()[:8]), ("edges",)),
                      start_poses=starts, **SESSION)
    for s in ref.systems:
        s.lk_params = s.lk_params._replace(backend="pallas")
    port = MultiRobotMapping(PARAMS, n_robots=2, start_poses=starts,
                             device="cpu", **SESSION)
    _drive(ref, seq)
    _drive(port, seq)
    out = {"keyframes": (port.keyframe_counts(), ref.keyframe_counts()),
           "graph": (port.poses(), ref.poses()),
           "edges_before": (_edges(port.backend.graph),
                            _edges(ref.backend.graph))}
    out["added"] = (port.close_loops(**LOOPS), ref.close_loops(**LOOPS))
    out["edges"] = (_edges(port.backend.graph), _edges(ref.backend.graph))
    out["cross"] = (port.cross_robot_edges(), ref.cross_robot_edges())
    out["chi2"] = (port.optimize(iterations=8, cg_iters=40),
                   ref.optimize(iterations=8, cg_iters=40))
    out["optimized"] = (port.poses(), ref.poses())
    out["robot1"] = (port.poses(robot=1), ref.poses(robot=1))
    return out


def test_keyframe_counts_match(sessions):
    port, ref = sessions["keyframes"]
    assert port == ref
    assert min(port) >= 3


def test_graph_counts_and_odometry_edges_match(sessions):
    port, ref = sessions["edges_before"]
    assert port == ref
    assert len(sessions["graph"][0]) == len(sessions["graph"][1])


def test_graph_poses_match(sessions):
    port, ref = sessions["graph"]
    assert np.abs(port[:, :3, 3] - ref[:, :3, 3]).max() <= 1e-3
    assert np.abs(port[:, :3, :3] - ref[:, :3, :3]).max() <= 1e-3


def test_same_closures(sessions):
    assert sessions["added"][0] == sessions["added"][1] >= 1
    assert sessions["edges"][0] == sessions["edges"][1]
    assert sessions["cross"][0] == sessions["cross"][1] >= 1


def test_optimized_poses_match(sessions):
    port, ref = sessions["optimized"]
    assert np.all(np.isfinite(port))
    assert np.abs(port[:, :3, 3] - ref[:, :3, 3]).max() <= 1e-3
    np.testing.assert_allclose(sessions["chi2"][0], sessions["chi2"][1],
                               rtol=1e-2, atol=1e-3)
    a, b = sessions["robot1"]
    assert len(a) == len(b) == sessions["keyframes"][0][1]
