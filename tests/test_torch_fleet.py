"""The fleet: visfs_tpu_torch's FleetSystem (B = 2 streams in one vmapped
step, on the CPU) against visfs_tpu's FleetSystem, whose LK levels run the
Pallas kernel (LKParams(backend="pallas"), interpret mode on the CPU) under
its vmap.

Both fleets get tests/test_torch_system.py's 160x120 scene and PARAMS:
stream 0 frames 0-7, stream 1 frames 1-8.  Tolerances per stream and
frame: translation 1e-3 m, yaw 1e-3 rad, n_inliers within 1, identical
lost flags.  The reference fleet's stacked state also crosses into the port
through state_from_numpy."""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from visfs_tpu.io.sim import cached_textured_sequence
from visfs_tpu.slam.fleet import FleetSystem as JFleetSystem
from visfs_tpu_torch.slam.fleet import FleetSystem, stream_state
from visfs_tpu_torch.slam.state import state_from_numpy, state_to_numpy

# One intra-op thread: the suite runs several pytest workers on shared
# cores (tests/test_torch_system.py).
torch.set_num_threads(1)

N_FRAMES = 8
B = 2
PARAMS = {
    "Tracker/MaxFeatures": 40,
    "Tracker/MinDistance": 12,
    "Tracker/QualityLevel": 0.05,
    "LocalMap/MapSize": 5,
    "Optimizer/Iterations": 20,
    "Estimator/Force3DoF": True,
    "Estimator/ToleranceTranslation": 0.40,
}


def _init(s, cam):
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)


def fleet_inputs(seq):
    """[T, B] stamps and [T, B, H, W] images: stream b runs frames
    b .. b + N_FRAMES - 1."""
    def lane(a):
        return np.stack([a[b:b + N_FRAMES] for b in range(B)], axis=1)

    return lane(seq.stamps), lane(seq.left), lane(seq.right)


@pytest.fixture(scope="module")
def fleets():
    seq = cached_textured_sequence(n_frames=N_FRAMES + B - 1, width=160,
                                   height=120, motion="square", seed=0,
                                   speed=2.0)
    stamps, lefts, rights = fleet_inputs(seq)
    port = FleetSystem(PARAMS, n_streams=B, device="cpu")
    _init(port, seq.camera)
    ref = JFleetSystem(PARAMS, n_streams=B)
    ref.lk_params = ref.lk_params._replace(backend="pallas")
    _init(ref, seq.camera)
    # the port's fleet runs beside the reference's compile (XLA compiles
    # without the GIL), which takes most of this file's time
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port_run = pool.submit(port.run_sequences, stamps, lefts, rights)
        ref_outs = ref.run_sequences(stamps, lefts, rights)
        port_outs = port_run.result()
    return dict(seq=seq, ref=ref, ref_outs=ref_outs, port=port,
                port_outs=port_outs)


def _yaw(T):
    return np.arctan2(T[1, 0], T[0, 0])


@pytest.mark.parametrize("frame", range(N_FRAMES))
@pytest.mark.parametrize("stream", range(B))
def test_fleet_frame_matches_reference(fleets, stream, frame):
    a = fleets["ref_outs"][frame]
    b = fleets["port_outs"][frame]
    pa, pb = np.asarray(a.pose[stream]), b.pose[stream]
    assert b.pose.shape == (B, 4, 4) and np.all(np.isfinite(pb))
    np.testing.assert_allclose(pb[:3, 3], pa[:3, 3], atol=1e-3)
    assert abs(_yaw(pb) - _yaw(pa)) <= 1e-3
    assert abs(int(b.n_inliers[stream]) - int(a.n_inliers[stream])) <= 1
    assert bool(b.lost[stream]) == bool(a.lost[stream])
    assert bool(b.lost[stream]) == (frame == 0)  # only the bootstrap frame


@pytest.mark.parametrize("stream", range(B))
def test_fleet_stream_ate(fleets, stream):
    from visfs_tpu_torch.io.sim import ate_rmse

    # the stream's ground truth from its own first frame, where it starts
    gt = fleets["seq"].poses[stream:stream + N_FRAMES]
    gt = np.linalg.inv(gt[0]) @ gt
    est = np.stack([o.pose[stream] for o in fleets["port_outs"]])
    ref = np.stack([np.asarray(o.pose[stream]) for o in fleets["ref_outs"]])
    ate = ate_rmse(est, gt)
    assert ate < 0.1
    assert abs(ate - ate_rmse(ref, gt)) < 1e-3


def test_fleet_outputs_have_the_stream_axis(fleets):
    out = fleets["port_outs"][-1]
    assert len(fleets["port_outs"]) == N_FRAMES
    for f in ("lost", "n_inliers", "keyframe", "stamp"):
        assert np.asarray(getattr(out, f)).shape == (B,)
    assert out.covariance.shape == (B, 6, 6)
    np.testing.assert_array_equal(
        out.stamp, np.float32(fleets["seq"].stamps[N_FRAMES - 1:
                                                   N_FRAMES - 1 + B]))


def test_stacked_state_round_trip(fleets):
    """The reference fleet's [B]-stacked state through state_from_numpy and
    back is bit-equal, and stream i of it is a single-stream state."""
    ref_np = jax.device_get(fleets["ref"].states)
    port = state_from_numpy(ref_np, "cpu")
    assert port.pose_t.shape == (B, 3) and port.rng_key.shape == (B, 2)
    a = jax.tree_util.tree_leaves(ref_np)
    b = jax.tree_util.tree_leaves(state_to_numpy(port))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(y, x)
    one = stream_state(port, 1)
    assert one.prev_left.shape == (120, 160)
    np.testing.assert_array_equal(one.features.fid.numpy(),
                                  np.asarray(ref_np.features.fid[1]))


def test_fleet_state_matches_reference(fleets):
    """After the run, each stream's frame count, window slots and lost
    flag equal the reference's."""
    ref_np = jax.device_get(fleets["ref"].states)
    port = state_to_numpy(fleets["port"].states)
    for get in (lambda s: s.frame_count, lambda s: s.window.valid,
                lambda s: s.window.frame_id, lambda s: s.lost):
        np.testing.assert_array_equal(get(port), np.asarray(get(ref_np)))
