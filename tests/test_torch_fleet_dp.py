"""The fleet across ranks on torch.distributed: two gloo ranks on the CPU
(spawned processes, a free localhost port and the timeout of
tests/test_torch_distributed.py), one VO stream a rank.

  * dp_fleet_step at SensorStrategy 3 (laser, wheel rows, submaps) on
    tests/test_fleet.py's scene, 4 frames: rank r runs the plain vo_step on
    its own stream (seed r), and every rank sees every rank's FrameOutput
    gathered into [B].  Each row is bit-equal to a single-stream System of
    that seed over the same frames, and the ranks' gathered outputs are
    identical.
  * FleetMapping on tests/test_torch_multi_robot.py's frames (robot 0
    frames 0-7, robot 1 frames 1-8 from start pose seq.poses[1]) against
    the port's MultiRobotMapping fed in the fleet's lockstep order (robot
    0's frame k, then robot 1's), with the fleet's seeds: identical
    keyframe counts, node and edge lists and accepted closures; poses after
    optimize within 1e-5 m (the edge-sharded solve against the one-process
    solve, tests/test_torch_distributed.py's bound).  Every rank holds the
    same graph.

This file compiles no JAX program: MultiRobotMapping is held against the
JAX package in tests/test_torch_multi_robot.py."""

import multiprocessing
import os
import socket
import sys

import numpy as np
import pytest
import torch

from visfs_tpu_torch.io.sim import cached_textured_sequence, generate_sequence
from visfs_tpu_torch.parallel.mesh import Mesh, fleet_mesh
from visfs_tpu_torch.slam.fleet import dp_fleet_step
from visfs_tpu_torch.slam.multi_robot import FleetMapping, MultiRobotMapping
from visfs_tpu_torch.slam.system import System

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
TIMEOUT_S = 240
MAP_FRAMES = 8


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _camera(cam):
    return dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
                cy=float(cam.cy), baseline=float(cam.baseline),
                width=cam.width, height=cam.height)


@pytest.fixture(scope="module")
def scenes():
    dp = generate_sequence(n_frames=4, n_points=200, width=160, height=120,
                           seed=11, motion="arc", with_laser=True,
                           n_beams=60, device="cpu")
    dp_seq = dict(camera=_camera(dp.camera), stamps=np.asarray(dp.stamps),
                  left=dp.left, right=dp.right,
                  wheel_odom=np.asarray(dp.wheel_odom, np.float32),
                  scans=[np.asarray(s, np.float32) for s in dp.laser_scans])
    mr = cached_textured_sequence(n_frames=MAP_FRAMES + 1, width=160,
                                  height=120, motion="square", seed=0,
                                  speed=2.0, device="cpu")
    map_seq = dict(camera=_camera(mr.camera), stamps=np.asarray(mr.stamps),
                   left=mr.left, right=mr.right,
                   starts=[np.eye(4, dtype=np.float32), mr.poses[1]])
    return dp_seq, map_seq


def _single_dp(seq, seed):
    s = worker.dp_system(seed, seq["camera"])
    return s.run_sequence(seq["stamps"], seq["left"], seq["right"],
                          wheel_odom=seq["wheel_odom"], scans=seq["scans"])


def _multi_robot(seq):
    """MultiRobotMapping with the fleet's seeds, fed in lockstep."""
    mr = MultiRobotMapping(worker.MAP_PARAMS, n_robots=WORLD,
                           start_poses=seq["starts"], device="cpu",
                           **worker.SESSION)
    mr.systems = [System(worker.MAP_PARAMS, device="cpu", seed=r)
                  for r in range(WORLD)]
    worker.init_camera(mr, seq["camera"])
    for k in range(MAP_FRAMES):
        for r in range(WORLD):
            mr.input_primary_sensor_data(
                r, float(seq["stamps"][k + r]), seq["left"][k + r],
                seq["right"][k + r])
    mr.finish()
    out = dict(keyframes=mr.keyframe_counts(), graph=mr.poses(),
               edges_before=worker.graph_edges(mr.backend.graph))
    out["added"] = mr.close_loops(**worker.LOOPS)
    out["edges"] = worker.graph_edges(mr.backend.graph)
    out["cross"] = mr.cross_robot_edges()
    out["chi2"] = mr.optimize(**worker.SOLVE)
    out["optimized"] = mr.poses()
    out["robot1"] = mr.poses(robot=1)
    return out


@pytest.fixture(scope="module")
def runs(scenes):
    """(each rank's results, the single-stream Systems' outputs, the
    one-process MultiRobotMapping's session); the one-process runs go while
    the ranks work."""
    dp_seq, map_seq = scenes
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=worker.fleet_worker,
                         args=(r, WORLD, port, dp_seq, map_seq, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        singles = [_single_dp(dp_seq, r) for r in range(WORLD)]
        session = _multi_robot(map_seq)
        ranks = dict(queue.get(timeout=TIMEOUT_S) for _ in range(WORLD))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert all(not p.is_alive() for p in procs)
    for r, out in ranks.items():
        assert isinstance(out, dict), f"rank {r}: {out}"
    return ranks, singles, session


FIELDS = ("pose", "transform", "lost", "n_features", "n_matches",
          "n_inliers", "n_new", "keyframe", "ba_chi2", "ba_ok", "velocity",
          "stamp", "covariance")


@pytest.mark.parametrize("frame", range(4))
@pytest.mark.parametrize("stream", range(WORLD))
def test_dp_fleet_row_is_its_single_system(runs, stream, frame):
    ranks, singles, _ = runs
    got = ranks[0]["dp"][frame]
    want = singles[stream][frame]
    for f in FIELDS:
        assert got[f].shape[0] == WORLD
        np.testing.assert_array_equal(got[f][stream], np.asarray(
            getattr(want, f)), err_msg=f)
    assert not bool(want.lost) or frame == 0


def test_dp_fleet_ranks_see_the_same_outputs(runs):
    ranks = runs[0]
    for a, b in zip(ranks[0]["dp"], ranks[1]["dp"]):
        for f in FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_dp_fleet_runs_the_laser_strategy(runs):
    """Strategy 3 rides the dp axis: both streams track all 4 frames."""
    ranks, singles, _ = runs
    last = ranks[0]["dp"][-1]
    assert not last["lost"].any()
    assert np.all(np.isfinite(last["pose"]))
    assert len(singles[0]) == 4


@pytest.mark.parametrize("rank", range(WORLD))
def test_fleet_mapping_keyframes_and_graph_match(runs, rank):
    ranks, _, session = runs
    got = ranks[rank]["mapping"]
    assert got["keyframes"] == session["keyframes"]
    assert min(got["keyframes"]) >= 3
    assert got["edges_before"] == session["edges_before"]
    assert len(got["graph"]) == len(session["graph"])
    np.testing.assert_array_equal(got["graph"], session["graph"])


@pytest.mark.parametrize("rank", range(WORLD))
def test_fleet_mapping_closures_match(runs, rank):
    ranks, _, session = runs
    got = ranks[rank]["mapping"]
    assert got["added"] == session["added"] >= 1
    assert got["edges"] == session["edges"]
    assert got["cross"] == session["cross"] >= 1


@pytest.mark.parametrize("rank", range(WORLD))
def test_fleet_mapping_optimized_poses_match(runs, rank):
    ranks, _, session = runs
    got = ranks[rank]["mapping"]
    assert np.all(np.isfinite(got["optimized"]))
    assert np.abs(got["optimized"][:, :3, 3]
                  - session["optimized"][:, :3, 3]).max() <= 1e-5
    np.testing.assert_allclose(got["chi2"], session["chi2"], rtol=1e-3,
                               atol=1e-9)
    assert len(got["robot1"]) == len(session["robot1"])


def test_ranks_hold_the_same_graph(runs):
    a, b = (runs[0][r]["mapping"] for r in range(WORLD))
    np.testing.assert_array_equal(a["optimized"], b["optimized"])
    assert a["edges"] == b["edges"]


def test_one_process_fleet_mapping_is_one_robot(scenes):
    _, seq = scenes
    fm = FleetMapping(worker.MAP_PARAMS, None, device="cpu",
                      **worker.SESSION)
    worker.init_camera(fm, seq["camera"])
    out = fm.step(seq["stamps"][:1], seq["left"][:1], seq["right"][:1])
    assert fm.n_robots == 1 and out.pose.shape == (1, 4, 4)
    assert fm.keyframe_counts() == [0]  # the bootstrap frame is lost


def test_dp_fleet_step_one_process(scenes):
    """With no group the gathered outputs are this stream's, [1]."""
    seq, _ = scenes
    s = worker.dp_system(0, seq["camera"])
    pts, msk, tms = s._scan_inputs(seq["scans"][0], None)
    _, out = dp_fleet_step(fleet_mesh(None), s.state,
                           s._as_image(seq["left"][0]),
                           s._as_image(seq["right"][0]),
                           torch.full((), float(seq["stamps"][0])),
                           s.camera, s.settings, s.lk_params, s._cfg_hash,
                           scan_points=pts, scan_mask=msk)
    assert out.pose.shape == (1, 4, 4) and out.lost.dtype == torch.bool


def test_fleet_sessions_refuse_another_axis():
    with pytest.raises(ValueError, match="dp"):
        FleetMapping(worker.MAP_PARAMS, Mesh(None, "edges"), device="cpu")
    with pytest.raises(ValueError, match="dp"):
        dp_fleet_step(Mesh(None, "lm"), None, None, None, None, None, None,
                      None, None)
