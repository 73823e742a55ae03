"""visfs_tpu_torch.io.sim against visfs_tpu.io.sim: the starfield
generator (generate_sequence, with its depth map and its room scans), the
textured generator's depth, and the textured renderer at VGA.

Tolerances: starfield images within 1e-3 levels (splats summed in the same
order from poses that may differ by an ulp), depth within 1e-6 m, scans
within 1e-5 m, odometry within 1e-6; textured depth exact at 160x120; at
640x480 every 8-bit pixel of the first 8 frames of the bench loop (seed 0,
speed 2.0, square) equal, left and right, and the depth equal."""

import numpy as np
import pytest
import torch

from visfs_tpu.io import sim as jsim
from visfs_tpu_torch.io import sim as tsim

torch.set_num_threads(1)


def _pair(**kw):
    return (jsim.generate_sequence(**kw),
            tsim.generate_sequence(device="cpu", **kw))


@pytest.fixture(scope="module")
def starfield():
    return _pair(n_frames=6, n_points=300, width=160, height=120, seed=3,
                 motion="arc", odom_noise=0.002, with_laser=True, n_beams=90,
                 laser_noise=0.01, with_depth=True)


@pytest.mark.parametrize("field,atol", [
    ("left", 1e-3), ("right", 1e-3), ("depth", 1e-6), ("laser_scans", 1e-5),
    ("wheel_odom", 1e-6), ("poses", 1e-6), ("points", 0.0),
    ("stamps", 0.0)])
def test_starfield_matches_reference(starfield, field, atol):
    ref, port = starfield
    r, p = np.asarray(getattr(ref, field)), getattr(port, field)
    assert p.shape == r.shape and p.dtype == r.dtype
    np.testing.assert_allclose(p, r, atol=atol, rtol=0)
    assert port.room == ref.room


@pytest.mark.parametrize("motion", ["forward", "yaw"])
def test_starfield_motions_match(motion):
    ref, port = _pair(n_frames=3, n_points=200, width=160, height=120,
                      seed=5, motion=motion, with_depth=True)
    np.testing.assert_allclose(port.poses, ref.poses, atol=1e-6)
    np.testing.assert_allclose(port.left, ref.left, atol=1e-3)
    np.testing.assert_allclose(port.depth, ref.depth, atol=1e-6)
    assert ref.laser_scans is None and port.laser_scans is None
    # depth where splats land, 0 elsewhere (RGBD's invalid-depth case)
    assert (port.depth > 0).any() and (port.depth == 0).any()


def test_room_scan_matches_reference():
    # the starfield's scans: the textured world's scan with no pillars
    pose = np.eye(4, dtype=np.float32)
    pose[:2, 3] = (1.5, -0.5)
    c, s = np.cos(0.3), np.sin(0.3)
    pose[:2, :2] = [[c, -s], [s, c]]
    room = (-3.0, 18.0, -8.0, 8.0)
    for noise in (0.0, 0.02):
        a = jsim._scan_rectangle_room(pose, room, 64,
                                      np.random.default_rng(1), noise)
        b = tsim._scan_world(pose, room, (), 64, np.random.default_rng(1),
                             noise)
        np.testing.assert_array_equal(b, a)


def test_textured_depth_matches_reference(tmp_path):
    kw = dict(n_frames=4, width=160, height=120, motion="square", seed=0,
              speed=2.0, with_depth=True)
    ref = jsim.generate_textured_sequence(**kw)
    port = tsim.generate_textured_sequence(device="cpu", **kw)
    assert port.depth.dtype == np.float32 and port.depth.shape == (4, 120,
                                                                   160)
    np.testing.assert_array_equal(port.depth, ref.depth)
    # z-depth where a plane is hit: a closed room hits everywhere
    assert (port.depth > 0.25).all()
    # the cache keeps depth as float32 metres, not quantized
    first = tsim.cached_textured_sequence(cache_dir=str(tmp_path),
                                          device="cpu", **kw)
    again = tsim.cached_textured_sequence(cache_dir=str(tmp_path),
                                          device="cpu", **kw)
    np.testing.assert_array_equal(first.depth, port.depth)
    np.testing.assert_array_equal(again.depth, port.depth)
    np.testing.assert_array_equal(again.left, first.left)


def test_textured_vga_pixels_equal_reference():
    """The ray cast at 640x480 over the bench loop's first 8 frames: the
    8-bit pixels the System sees, left and right, all equal."""
    kw = dict(n_frames=8, width=640, height=480, motion="square", seed=0,
              speed=2.0, with_depth=True)
    ref = jsim.generate_textured_sequence(**kw)
    port = tsim.generate_textured_sequence(device="cpu", **kw)

    def q(a):
        return np.clip(a, 0, 255).astype(np.uint8)

    for side in ("left", "right"):
        differ = int((q(getattr(port, side)) != q(getattr(ref, side))).sum())
        assert differ == 0, f"{side}: {differ} pixels differ"
    np.testing.assert_array_equal(port.depth, ref.depth)
