"""System(profile_stages=True), the stage timer and the publication
structures of visfs_tpu_torch.

The profiled step runs the fused step's four stage functions with a device
synchronisation after each, so its poses and counts equal the fused path's
bit for bit on the CPU; its time_* fields hold the invariants of
tests/test_system_e2e.py::TestStageProfiling, and the fused path leaves
them 0.  frame_output_to_messages and laser_scan_to_points equal
visfs_tpu.io.interface's on the same numbers (quaternion within 1e-6)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from visfs_tpu.io import interface as jif
from visfs_tpu.slam.state import FrameOutput as JFrameOutput
from visfs_tpu_torch.io import interface as tif
from visfs_tpu_torch.io.sim import ate_rmse, generate_sequence
from visfs_tpu_torch.slam.state import FrameOutput
from visfs_tpu_torch.slam.system import System
from visfs_tpu_torch.utils import timer

torch.set_num_threads(1)

PARAMS = {  # tests/test_system_e2e.py's
    "Tracker/MaxFeatures": 150,
    "Tracker/MinDistance": 16,
    "Optimizer/Iterations": 10,
}
TIMES = ("time_tracking", "time_estimation", "local_bundle_time",
         "time_total")


def _run(seq, **kw):
    s = System(dict(PARAMS), device="cpu", **kw)
    cam = seq.camera
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    return s.run_sequence(seq.stamps, seq.left, seq.right)


@pytest.fixture(scope="module")
def runs():
    seq = generate_sequence(n_frames=6, n_points=300, seed=10, device="cpu")
    return seq, _run(seq, profile_stages=True), _run(seq)


def test_profiled_step_equals_fused_step(runs):
    _, prof, fused = runs
    assert len(prof) == len(fused) == 6
    for a, b in zip(prof, fused):
        for f in FrameOutput._fields:
            if f not in TIMES:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=f)


def test_timing_fields_populated_and_published(runs):
    """tests/test_system_e2e.py::TestStageProfiling::
    test_timing_fields_populated_and_published through the port."""
    seq, prof, _ = runs
    for o in prof:
        assert float(o.time_tracking) > 0.0
        assert float(o.local_bundle_time) > 0.0
        assert float(o.time_estimation) >= float(o.local_bundle_time)
        assert float(o.time_total) >= (float(o.time_tracking)
                                       + float(o.time_estimation)) * 0.99
    est = np.stack([o.pose for o in prof])
    assert ate_rmse(est, seq.poses) < 0.02
    _, info = tif.frame_output_to_messages(prof[-1])
    assert info.time_total > 0.0 and info.local_bundle_time > 0.0


def test_fused_path_zero_timings(runs):
    _, _, fused = runs
    for o in fused:
        assert all(float(getattr(o, f)) == 0.0 for f in TIMES)


def _as_reference(out):
    return JFrameOutput(**{f: np.asarray(getattr(out, f))
                           for f in FrameOutput._fields})


@pytest.mark.parametrize("lost", [False, True])
def test_messages_match_reference(runs, lost):
    _, prof, _ = runs
    out = prof[-1]._replace(lost=np.bool_(lost))
    odom, info = tif.frame_output_to_messages(out, prev_stamp=0.4)
    odom_r, info_r = jif.frame_output_to_messages(_as_reference(out),
                                                  prev_stamp=0.4)
    assert dataclasses.asdict(info) == dataclasses.asdict(info_r)
    a, b = dataclasses.asdict(odom), dataclasses.asdict(odom_r)
    np.testing.assert_allclose(a.pop("orientation_wxyz"),
                               np.asarray(b.pop("orientation_wxyz")),
                               atol=1e-6)
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    # tensors are accepted too
    t_out = FrameOutput(*[torch.as_tensor(np.asarray(getattr(out, f)))
                          for f in FrameOutput._fields])
    _, info_t = tif.frame_output_to_messages(t_out, prev_stamp=0.4)
    assert dataclasses.asdict(info_t) == dataclasses.asdict(info)


def test_laser_scan_to_points_matches_reference():
    rng = np.random.default_rng(4)
    ranges = rng.uniform(0.05, 40.0, 181)
    inten = rng.uniform(0, 100, 181)
    kw = dict(angle_min=-1.57, angle_increment=0.0174, range_min=0.1,
              range_max=30.0, stamp=12.5, time_increment=1e-4)
    a = tif.laser_scan_to_points(ranges, intensities=inten, **kw)
    b = jif.laser_scan_to_points(ranges, intensities=inten, **kw)
    for k, v in dataclasses.asdict(a).items():
        np.testing.assert_array_equal(v, getattr(b, k), err_msg=k)


def test_stage_timer():
    t = timer.StageTimer()
    time.sleep(0.01)
    before = time.perf_counter()
    assert t.elapsed() >= 0.0099  # since construction
    x = torch.ones(64, 64)
    dt = t.elapsed(sync=(x @ x, [x * 2]))
    assert 0.0 <= dt <= time.perf_counter() - before  # restarted
    time.sleep(0.01)
    assert t.elapsed(sync=x) >= 0.0099


def test_device_trace_writes_a_trace(tmp_path):
    with timer.device_trace(str(tmp_path)):
        torch.ones(8) + 1
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())
