"""System/CLAHE: visfs_tpu_torch's System against visfs_tpu's over the
reference's 8 frames at 160x120 with CLAHE on both images
(tests/torch_mode_slice.py: per frame translation and yaw within 3e-5,
identical inliers and lost flags; the carried previous images are the
equalized ones), and tests/test_textured_e2e.py::test_clahe_through_pipeline
through the port: no lost frame and ATE < 0.12 m over the 40-frame
exposure-drifting arc."""

import numpy as np
import pytest
import torch

import torch_mode_slice as ms
from visfs_tpu.io.sim import cached_textured_sequence
from visfs_tpu_torch.io.sim import ate_rmse
from visfs_tpu_torch.ops.image import clahe
from visfs_tpu_torch.slam.system import System

torch.set_num_threads(1)

CLAHE = {"System/CLAHE": True}


@pytest.fixture(scope="module")
def pair():
    return ms.run(CLAHE)


@pytest.mark.parametrize("frame", range(ms.N_FRAMES))
def test_clahe_frame_matches_reference(pair, frame):
    ms.check_frame(pair["ref_outs"][frame], pair["port_outs"][frame], frame)


def test_clahe_images_carried_equalized(pair):
    seq, ref, port = pair["seq"], pair["ref"], pair["port"]
    assert port.cfg.system_clahe
    left = clahe(torch.from_numpy(seq.left[-1]))
    np.testing.assert_array_equal(port.state.prev_left.numpy(),
                                  left.numpy())
    np.testing.assert_allclose(port.state.prev_right.numpy(),
                               np.asarray(ref.state.prev_right), atol=1e-4)
    assert pair["k1_calls"] == [True, True] * ms.N_FRAMES


def test_clahe_through_pipeline():
    """tests/test_textured_e2e.py::test_clahe_through_pipeline through the
    port (the reference's sequence, its parameters)."""
    seq = cached_textured_sequence(n_frames=40, width=256, height=192,
                                   motion="arc", seed=9, pixel_noise=2.0,
                                   exposure_drift=0.06)
    s = System({"Tracker/MaxFeatures": 150, "Tracker/MinDistance": 12,
                "Optimizer/Iterations": 10, **CLAHE}, device="cpu")
    ms.init(s, seq.camera)
    outs = s.run_sequence(seq.stamps, seq.left, seq.right)
    assert not any(bool(o.lost) for o in outs[1:])
    ate = ate_rmse(np.stack([o.pose for o in outs]), seq.poses[:len(outs)])
    assert ate < 0.12, ate
