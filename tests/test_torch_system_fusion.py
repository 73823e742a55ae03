"""SensorStrategy 3, the reference's mapping configuration (stereo, laser and
wheel, with submap building; bench phase 4): visfs_tpu_torch's System
against visfs_tpu's over the reference's own 8 frames at 160x120 with its
wheel rows and scans (tests/torch_fusion_slice.py; strategies 2, 4 and 5
are tests/test_torch_system_fusion_s{2,4,5}.py).

Per frame: translation 1e-3 m, yaw 1e-3 rad, inliers within 1, identical
lost flags.  The submaps: identical slot_valid, num_range_data and
finished, max_xy within 1e-4 m, at most 0.1 % of the known cells
different.  Also: the port continues from the reference's mid-sequence
laser state; state_from_numpy / state_to_numpy round-trip that state
exactly; input_wheel_odometry_batch leaves the odometry buffer that K
single calls leave, and the reference's batch too."""

import jax
import numpy as np
import pytest
import torch

from torch_fusion_slice import (N_FRAMES, check_ate, check_frame,
                                check_from_mid_state, check_submaps,
                                fusion_run, init, params)
from visfs_tpu.slam.system import System as JSystem
from visfs_tpu_torch.slam.state import state_from_numpy, state_to_numpy
from visfs_tpu_torch.slam.system import System

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

STRATEGY = 3
__all__ = ["fusion_run"]


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_frame_matches_reference(fusion_run, frame):
    check_frame(fusion_run, frame)


def test_ate_matches_reference(fusion_run):
    check_ate(fusion_run)
    from visfs_tpu_torch.io.sim import ate_rmse

    est = np.stack([o.pose for o in fusion_run["port_outs"]])
    assert ate_rmse(est, fusion_run["seq"].poses) < 0.1


def test_submaps_match_reference(fusion_run):
    check_submaps(fusion_run)


def test_port_continues_from_reference_state(fusion_run):
    check_from_mid_state(fusion_run, STRATEGY)


def test_laser_state_numpy_round_trip(fusion_run):
    ref_np = fusion_run["mid_state"]
    back = state_to_numpy(state_from_numpy(ref_np, "cpu"))
    assert back.laser is not None
    assert int(np.asarray(ref_np.laser.submaps.num_range_data).sum()) > 0
    a = jax.tree_util.tree_leaves(ref_np)
    b = jax.tree_util.tree_leaves(tuple(back))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(y, x)


def test_wheel_odometry_batch_equals_single_calls(fusion_run):
    """70 rows (past the 64-slot ring and a 16-row padding boundary) in one
    batch, against 70 input_wheel_odometry calls and the reference's
    batch."""
    rng = np.random.default_rng(0)
    n = 70
    stamps = np.arange(n) * 0.01 + 0.005
    pose6 = rng.normal(size=(n, 6)).astype(np.float32)
    vel6 = rng.normal(size=(n, 6)).astype(np.float32)
    cam = fusion_run["seq"].camera
    batch, single = (System(params(2), device="cpu") for _ in range(2))
    ref = JSystem(params(2))
    for s in (batch, single, ref):
        init(s, cam)
    batch.input_wheel_odometry_batch(stamps[:5], pose6[:5], vel6[:5])
    batch.input_wheel_odometry_batch(stamps[5:], pose6[5:], vel6[5:])
    for k in range(n):
        single.input_wheel_odometry(stamps[k], pose6[k], vel6[k])
    ref.input_wheel_odometry_batch(stamps[:5], pose6[:5], vel6[:5])
    ref.input_wheel_odometry_batch(stamps[5:], pose6[5:], vel6[5:])
    ref_odom = jax.device_get(ref.state.odom)
    for f in ("stamp", "pose", "velocity", "valid", "head"):
        a = getattr(batch.state.odom, f).numpy()
        np.testing.assert_array_equal(a, getattr(single.state.odom, f))
        np.testing.assert_array_equal(a, np.asarray(getattr(ref_odom, f)))
    assert int(batch.state.odom.head) == n
