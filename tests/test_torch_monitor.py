"""The port's monitor (visfs_tpu_torch.slam.monitor) against the JAX
package's: render_frame pixel-equal to the reference's on the same state
(a port CPU run's, handed to the reference as numpy by state_to_numpy),
render_submap pixel-equal on the same laser state and None without one,
the bitmap glyphs equal, and LiveMonitor running headless."""

import numpy as np
import pytest
import torch

from visfs_tpu.slam import monitor as jmon
from visfs_tpu_torch.io.sim import cached_textured_sequence
from visfs_tpu_torch.slam import monitor as tmon
from visfs_tpu_torch.slam.state import state_to_numpy
from visfs_tpu_torch.slam.system import System

torch.set_num_threads(1)

PARAMS = {
    "Tracker/MaxFeatures": 40,
    "Tracker/MinDistance": 12,
    "Tracker/QualityLevel": 0.05,
    "Estimator/Force3DoF": True,
    "LocalMap/NumRangeDataLimit": 3,
}
N_FRAMES = 4


def _run(strategy):
    seq = cached_textured_sequence(n_frames=N_FRAMES, width=160, height=120,
                                   motion="square", seed=0, speed=2.0,
                                   with_laser=True, device="cpu")
    s = System(dict(PARAMS, **{"System/SensorStrategy": strategy}),
               device="cpu", scan_capacity=192, submap_extent_cells=64)
    cam = seq.camera
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    s.run_sequence(seq.stamps, seq.left, seq.right,
                   wheel_odom=seq.wheel_odom if strategy >= 2 else None,
                   scans=seq.laser_scans if strategy >= 3 else None)
    return seq, s


@pytest.fixture(scope="module")
def run3():
    return _run(3)


def test_render_frame_equals_the_reference(run3):
    seq, s = run3
    left, right = seq.left[-1], seq.right[-1]
    port = tmon.render_frame(s.state, torch.from_numpy(left),
                             torch.from_numpy(right))
    ref = jmon.render_frame(state_to_numpy(s.state), left, right)
    assert port.shape == (120, 320, 3) and port.dtype == np.uint8
    np.testing.assert_array_equal(port, ref)
    # something was drawn: tracked keypoints and depth labels
    assert (port != np.repeat(port[..., :1], 3, axis=-1)).any()


def test_render_submap_equals_the_reference(run3):
    _, s = run3
    port = tmon.render_submap(s.state)
    ref = jmon.render_submap(state_to_numpy(s.state))
    assert port is not None and port.shape == (64, 64)
    assert port.dtype == np.uint8
    np.testing.assert_array_equal(port, ref)
    assert len(np.unique(port)) > 2  # free, occupied and unknown cells


def test_render_submap_is_none_without_a_laser():
    seq = cached_textured_sequence(n_frames=N_FRAMES, width=160, height=120,
                                   motion="square", seed=0, speed=2.0,
                                   with_laser=True, device="cpu")
    s = System(PARAMS, device="cpu")
    cam = seq.camera
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    assert s.state.laser is None
    assert tmon.render_submap(s.state) is None
    assert jmon.render_submap(state_to_numpy(s.state)) is None


@pytest.mark.parametrize("text", ["0123456789", "-3.5", "12.7", "a1b"])
def test_draw_text_glyphs_equal(text):
    a = np.zeros((9, 48, 3), np.uint8)
    b = a.copy()
    jmon._draw_text(a, 1.4, 2.6, text, jmon.GREEN)
    tmon._draw_text(b, 1.4, 2.6, text, tmon.GREEN)
    np.testing.assert_array_equal(b, a)
    assert a.any()


def test_live_monitor_headless(run3, tmp_path, monkeypatch):
    seq, s = run3
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    mon = tmon.LiveMonitor(save_dir=str(tmp_path / "frames"))
    assert not mon._windows_ok
    for _ in range(2):
        canvas = mon.show(s.state, seq.left[-1], seq.right[-1])
    mon.close()
    assert canvas.shape == (120, 320, 3)
    saved = sorted(p.name for p in (tmp_path / "frames").iterdir())
    assert saved in (["frame_00000.png", "frame_00001.png"],
                     ["frame_00000.npy", "frame_00001.npy"])
