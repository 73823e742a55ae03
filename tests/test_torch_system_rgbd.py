"""SensorStrategy 1 (RGBD): visfs_tpu_torch's System against visfs_tpu's
over the reference's 8 frames at 160x120 with the ray-cast depth as the
right image (tests/torch_mode_slice.py: per frame translation and yaw
within 3e-5, identical inliers and lost flags), and tests/test_rgbd.py's
two cases through the port: ATE < 0.02 m on the starfield with its splatted
depth, and no feature observed where the depth is invalid.  The step runs
one K1 track a frame (the temporal one) and builds no right pyramid."""

import numpy as np
import pytest
import torch

import torch_mode_slice as ms
from visfs_tpu_torch.io.sim import ate_rmse, generate_sequence
from visfs_tpu_torch.slam.system import System

torch.set_num_threads(1)

RGBD = {"System/SensorStrategy": 1}


@pytest.fixture(scope="module")
def pair():
    return ms.run(RGBD, depth=True)


@pytest.mark.parametrize("frame", range(ms.N_FRAMES))
def test_rgbd_frame_matches_reference(pair, frame):
    ms.check_frame(pair["ref_outs"][frame], pair["port_outs"][frame], frame)


def test_rgbd_runs_only_the_temporal_track(pair):
    # one bidirectional K1 call a frame: depth replaces the stereo track
    assert pair["k1_calls"] == [True] * ms.N_FRAMES


def test_rgbd_table_holds_the_depth_lookup(pair):
    seq, ref, port = pair["seq"], pair["ref"], pair["port"]
    # the last frame's table: stored depth is the depth image at the
    # truncated pixel, uR = uL - bf/z
    f = port.state.features
    obs = f.obs_mask[:, -1] & f.valid
    uv = f.uv[obs, -1]
    z = torch.from_numpy(seq.depth[-1])[uv[:, 1].long(), uv[:, 0].long()]
    np.testing.assert_allclose(f.depth[obs, -1].numpy(), z.numpy(),
                               rtol=1e-6)
    bf = float(port.camera.bf)
    np.testing.assert_allclose(f.uv_right[obs, -1, 0].numpy(),
                               (uv[:, 0] - bf / z).numpy(), rtol=1e-5)
    np.testing.assert_array_equal(f.valid.numpy(),
                                  np.asarray(ref.state.features.valid))


def _system(params, cam):
    s = System(params, device="cpu")
    ms.init(s, cam)
    return s


def test_rgbd_vo_tracks_trajectory():
    """tests/test_rgbd.py::test_rgbd_vo_tracks_trajectory through the port."""
    seq = generate_sequence(n_frames=10, n_points=400, seed=21,
                            motion="forward", with_depth=True, device="cpu")
    s = _system(dict(RGBD, **{"Tracker/MaxFeatures": 150,
                              "Tracker/MinDistance": 16,
                              "Optimizer/Iterations": 10}), seq.camera)
    outs = s.run_sequence(seq.stamps, seq.left, seq.depth)
    assert not any(bool(o.lost) for o in outs[1:])
    ate = ate_rmse(np.stack([o.pose for o in outs]), seq.poses)
    assert ate < 0.02, ate


def test_rgbd_rejects_invalid_depth():
    """tests/test_rgbd.py::test_rgbd_rejects_invalid_depth through the
    port: features on zero-depth pixels never enter the map."""
    seq = generate_sequence(n_frames=4, n_points=300, seed=22,
                            with_depth=True, device="cpu")
    cam = seq.camera
    depth = np.array(seq.depth)
    depth[:, :, : cam.width // 2] = 0.0
    s = _system(dict(RGBD, **{"Tracker/MaxFeatures": 150,
                              "Tracker/MinDistance": 16}), cam)
    s.run_sequence(seq.stamps, seq.left, depth)
    f = s.state.features
    observed = (f.obs_mask & f.valid[:, None]).numpy()
    assert observed.any()
    assert (f.uv.numpy()[observed][:, 0] >= cam.width // 2 - 1).all()
