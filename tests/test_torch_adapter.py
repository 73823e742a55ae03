"""The port's node adapter (visfs_tpu_torch.io.adapter) against the JAX
package's visfs_tpu.io.adapter.

- The repo's operating points load and validate as the reference's (node,
  visfs and frames blocks equal), an unknown key raises at load, and the
  port's literals (operating_points.operating_point) equal the loaded
  files.
- static_frame_transform within 1e-7 of the reference's.
- Bring-up on a StaticTransport: the baseline falls back to the right
  camera info, and a static transport without camera info raises
  TimeoutError.
- The exact-stamp gather path publishes odometry within 1e-3 m and 1e-3
  rad per frame of the reference adapter's on the same 4 frames at 160x120,
  inliers within 1 and identical lost flags (the tolerance of
  tests/test_torch_system.py), both at the reference System's own LK
  configuration (the jnp level, direct iteration).
- The native-runtime path: the same frames through the port's runtime give
  the gather path's odometry bit-equal (same device, same inputs, same
  order), and configs/sim_mapping.yaml's whole operating point (strategy 3,
  CLAHE, wheel rows and scans) runs through it with every wheel row in the
  odometry buffer."""

import dataclasses
import pathlib
import time

import numpy as np
import pytest
import torch

from visfs_tpu.io import adapter as jad
from visfs_tpu.io.sim import cached_textured_sequence
from visfs_tpu_torch import operating_points
from visfs_tpu_torch.io import adapter as tad
from visfs_tpu_torch.slam.system import System

torch.set_num_threads(1)

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
N_FRAMES = 4
OVERRIDES = {"Tracker/MaxFeatures": 40, "Tracker/MinDistance": 12,
             "Tracker/QualityLevel": 0.05, "Optimizer/Iterations": 20}


def _infos(mod, cam):
    fx, fy, cx, cy = (float(cam.fx), float(cam.fy), float(cam.cx),
                      float(cam.cy))
    left = mod.CameraInfo(cam.width, cam.height, fx, fy, cx, cy)
    right = mod.CameraInfo(cam.width, cam.height, fx, fy, cx, cy,
                           tx=-fx * float(cam.baseline))
    return left, right


class PortSystem(System):
    """The port's System at the reference System's own LK configuration,
    on the CPU."""

    def __init__(self, params, device="cpu", **kw):
        super().__init__(params, device="cpu", **kw)
        self.lk_params = dataclasses.replace(self.lk_params, backend="jnp")


@pytest.fixture(scope="module")
def seq():
    return cached_textured_sequence(n_frames=N_FRAMES, width=160, height=120,
                                    motion="square", seed=0, speed=2.0)


@pytest.mark.parametrize("name", ["sim_mapping", "sim_localization",
                                  "real_localization"])
def test_operating_points_load_as_the_reference(name):
    ref = jad.load_operating_point(CONFIGS / f"{name}.yaml")
    port = tad.load_operating_point(CONFIGS / f"{name}.yaml")
    assert port.node == ref.node and port.visfs == ref.visfs
    assert port.frames == ref.frames
    assert port.subscribe_wheel_odom == ref.subscribe_wheel_odom
    assert port.subscribe_laser_scan == ref.subscribe_laser_scan
    if name in ("sim_mapping", "sim_localization"):
        lit = operating_points.operating_point(name)
        assert (lit.node, lit.visfs, lit.frames) == (
            port.node, port.visfs, port.frames)


def test_unknown_key_raises_at_load(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("visfs:\n  Tracker/NoSuchParam: 3\n")
    for mod in (jad, tad):
        with pytest.raises(KeyError):
            mod.load_operating_point(bad)


def test_static_frame_transform_matches_the_reference():
    frames = dict(tad.load_operating_point(
        CONFIGS / "sim_mapping.yaml").frames)
    frames["tilted"] = {"parent": "base_link", "xyz": [0.1, -0.2, 0.3],
                        "rpy": [0.3, -0.2, 1.1]}
    for child in ("camera_link", "sick_laser_link", "tilted"):
        ref = jad.static_frame_transform(frames, child)
        port = tad.static_frame_transform(frames, child)
        assert port.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(port, ref, atol=1e-7, rtol=0)
    assert tad.static_frame_transform(frames, "nowhere") is None


def test_baseline_falls_back_to_camera_info(seq):
    left_i, right_i = _infos(tad, seq.camera)
    op = tad.load_operating_point(CONFIGS / "sim_localization.yaml")
    op.node["base_line"] = 0.0  # launch leaves it unset
    ad = tad.VISFSAdapter(op, tad.StaticTransport(left_i, right_i),
                          use_native_runtime=False, device="cpu")
    assert ad.system.device.type == "cpu"
    assert float(ad.system.camera.baseline) == pytest.approx(
        float(seq.camera.baseline), rel=1e-6)


def test_missing_camera_info_raises_on_static_transport(seq):
    class NoInfo(tad.StaticTransport):
        def wait_for_camera_info(self, side, timeout_s=3.0):
            return None

    left_i, right_i = _infos(tad, seq.camera)
    op = tad.load_operating_point(CONFIGS / "sim_localization.yaml")
    with pytest.raises(TimeoutError):
        tad.VISFSAdapter(op, NoInfo(left_i, right_i),
                         use_native_runtime=False, device="cpu")


def _point(mod):
    op = mod.load_operating_point(CONFIGS / "sim_localization.yaml")
    op.node["base_line"] = 0.0
    op.visfs.update(OVERRIDES)
    return op


def _frames_tree():
    return {"camera_link": {"parent": "base_link", "xyz": [0, 0, 0.0],
                            "rpy": [0, 0, 0]}}


def _gather_run(mod, seq, **kw):
    left_i, right_i = _infos(mod, seq.camera)
    tr = mod.StaticTransport(left_i, right_i, frames=_frames_tree())
    ad = mod.VISFSAdapter(_point(mod), tr, use_native_runtime=False, **kw)
    for i in range(N_FRAMES):
        t = float(seq.stamps[i])
        tr.inject("left/image", t, seq.left[i])
        tr.inject("right/image", t, seq.right[i])
        ad.spin_once()
    return tr.published


@pytest.fixture(scope="module")
def gather_runs(seq):
    ref = _gather_run(jad, seq)
    port = _gather_run(tad, seq, system_cls=PortSystem)
    return ref, port


def _yaw(q):
    w, x, y, z = q
    return np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def test_gather_path_odometry_matches_the_reference(gather_runs):
    ref, port = gather_runs
    assert len(port["odom"]) == len(ref["odom"]) == N_FRAMES
    for a, b, ia, ib in zip(port["odom"], ref["odom"], port["odom_info"],
                            ref["odom_info"]):
        assert a.stamp == b.stamp and a.valid == b.valid
        assert np.abs(np.asarray(a.position)
                      - np.asarray(b.position)).max() <= 1e-3
        assert abs(_yaw(a.orientation_wxyz)
                   - _yaw(b.orientation_wxyz)) <= 1e-3
        assert ia.lost == ib.lost
        assert abs(ia.inliers - ib.inliers) <= 1
        assert ia.interval == pytest.approx(ib.interval)
    moved = np.asarray(ref["odom"][-1].position)
    assert np.linalg.norm(moved) > 0.05  # the robot really moved


def test_native_runtime_path_equals_the_gather_path(seq, gather_runs):
    _, gathered = gather_runs
    left_i, right_i = _infos(tad, seq.camera)
    tr = tad.StaticTransport(left_i, right_i, frames=_frames_tree())
    ad = tad.VISFSAdapter(_point(tad), tr, system_cls=PortSystem,
                          use_native_runtime=True, device="cpu")
    ad.start()
    n = 0
    try:
        for i in range(N_FRAMES):
            t = float(seq.stamps[i])
            tr.inject("left/image", t, seq.left[i])
            tr.inject("right/image", t, seq.right[i])
        deadline = time.time() + 120
        while n < N_FRAMES and time.time() < deadline:
            n += ad.spin_once()
            time.sleep(0.01)
    finally:
        ad.stop()
    assert n == N_FRAMES
    stats = ad._rt.stats()
    assert stats["synced"] == stats["processed"] == N_FRAMES
    for a, b in zip(tr.published["odom"], gathered["odom"]):
        for f in ("stamp", "position", "orientation_wxyz",
                  "pose_covariance", "linear_velocity", "valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


def test_native_runtime_with_the_mapping_point():
    """configs/sim_mapping.yaml's operating point (strategy 3, CLAHE, wheel
    rows and scans subscribed) through the native runtime at 160x120:
    frames injected with back-pressure, wheel rows in stamp order from the
    feeding thread while the worker steps; every frame published and every
    wheel row in the odometry buffer."""
    from visfs_tpu_torch.io.sim import cached_textured_sequence as tseq

    n_frames = 6
    s = tseq(n_frames=n_frames, width=160, height=120, motion="square",
             seed=1, speed=2.0, with_laser=True, n_beams=180, device="cpu")
    op = operating_points.operating_point("sim_mapping")
    op.node["base_line"] = 0.0
    op.visfs.update(OVERRIDES)
    op.frames = {c: {"parent": "base_link", "xyz": [0.0, 0.0, 0.0],
                     "rpy": [0.0, 0.0, 0.0]}
                 for c in ("camera_link", "sick_laser_link")}
    left_i, right_i = _infos(tad, s.camera)
    tr = tad.StaticTransport(left_i, right_i, frames=op.frames)
    ad = tad.VISFSAdapter(op, tr, system_cls=lambda p, device: System(
        p, device=device, scan_capacity=192, submap_extent_cells=64),
        device="cpu")
    assert ad.system.cfg.system_sensor_strategy == 3
    assert ad.system.cfg.system_clahe
    capacity = int(op.node["queue_size"])
    ad.start()
    rows = n = 0
    try:
        for i in range(n_frames):
            while ad._rt.rt.queue_depth() >= capacity - 1:
                n += ad.spin_once()
                time.sleep(0.005)
            t = float(s.stamps[i])
            while rows < len(s.wheel_odom) and \
                    s.wheel_odom[rows][0] <= t + 1e-9:
                tr.inject("wheel_odom", float(s.wheel_odom[rows][0]),
                          s.wheel_odom[rows][1:7])
                rows += 1
            tr.inject("laser_scan", t, s.laser_scans[i])
            tr.inject("left/image", t, s.left[i])
            tr.inject("right/image", t, s.right[i])
            n += ad.spin_once()
        deadline = time.time() + 120
        while n < n_frames and time.time() < deadline:
            n += ad.spin_once()
            time.sleep(0.01)
    finally:
        ad.stop()
    stats = ad._rt.stats()
    assert n == n_frames and stats["processed"] == n_frames
    assert stats["dropped_unmatched"] == stats["dropped_overflow"] == 0
    assert int(ad.system.state.odom.head) == rows > 0
    odoms = tr.published["odom"]
    assert all(o.valid for o in odoms[1:])
    assert bool(ad.system.state.laser.submaps.slot_valid.any())
