"""visfs_tpu_torch.io.sim.render_textured_views (the ray casts of chosen
frames, which chip_smoke.py's phase render holds "cuda" against "cpu")
against the port's own generate_textured_sequence and against visfs_tpu's
generator on the same seed.

At 160x120: the views of frames (0, 5, 11) equal the sequence's images
where pixel noise and exposure drift are off (the images are the render's
affine map), the depth and the scans equal the sequence's, bit for bit;
the same frames' depth and scans equal the JAX package's sequence."""

import numpy as np
import pytest
import torch

from visfs_tpu.io import sim as jsim
from visfs_tpu_torch.io import sim as tsim

torch.set_num_threads(1)

SCENE = dict(n_frames=12, width=160, height=120, motion="square", seed=1,
             speed=2.0, with_laser=True, n_beams=180)
FRAMES = (0, 5, 11)


@pytest.fixture(scope="module")
def views():
    return tsim.render_textured_views(FRAMES, device="cpu", **SCENE)


@pytest.mark.parametrize("side", [0, 1])
def test_views_are_the_sequence_images(views, side):
    seq = tsim.generate_textured_sequence(
        device="cpu", pixel_noise=0.0, exposure_drift=0.0, **SCENE)
    images = (seq.left, seq.right)[side][list(FRAMES)]
    got = np.clip(views[0][:, side] * 175.0 + 35.0, 0.0, 255.0).astype(
        np.float32)
    np.testing.assert_array_equal(got, images)


@pytest.mark.parametrize("what", ["depth", "scans"])
def test_depth_and_scans_are_the_sequence_and_reference(views, what):
    kw = dict(SCENE, with_depth=True)
    port = tsim.generate_textured_sequence(device="cpu", **kw)
    ref = jsim.generate_textured_sequence(**kw)
    got = views[1] if what == "depth" else views[2]
    attr = "depth" if what == "depth" else "laser_scans"
    np.testing.assert_array_equal(got, getattr(port, attr)[list(FRAMES)])
    np.testing.assert_array_equal(got,
                                  np.asarray(getattr(ref, attr))[list(FRAMES)])


def test_noisy_scans_are_refused():
    with pytest.raises(ValueError):
        tsim.render_textured_views((0,), device="cpu", laser_noise=0.01,
                                   **SCENE)
