"""visfs_tpu_torch.io.dataset, the port's own copy of visfs_tpu.io.dataset:
on the same written directories its readers return what the reference's
return, bit for bit (stamps, intrinsics, ground truth, every frame), its
writers write what the reference's read back, and
tests/test_dataset.py::test_tum_rgbd_roundtrip_and_vo runs through the
port's System (SensorStrategy 1, ATE < 0.02 m).  EuRoC needs yaml."""

import dataclasses

import numpy as np
import pytest
import torch

from visfs_tpu.io import dataset as jds
from visfs_tpu.io.sim import generate_sequence as jgenerate
from visfs_tpu_torch.io import dataset as tds
from visfs_tpu_torch.io.sim import ate_rmse
from visfs_tpu_torch.io.sim import generate_sequence as tgenerate
from visfs_tpu_torch.slam.system import System

torch.set_num_threads(1)


def _same_sequence(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name.endswith("_paths"):
            assert x == y
        elif isinstance(x, np.ndarray) or x is None:
            assert (x is None) == (y is None), f.name
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    for i in range(len(a)):
        for u, v in zip(a.frame(i), b.frame(i)):
            np.testing.assert_array_equal(u, v)


def test_associate_matches_reference():
    rng = np.random.default_rng(2)
    a = np.sort(rng.uniform(0, 3, 40))
    b = np.sort(rng.uniform(0, 3, 35))
    assert tds.associate(a, b, 0.02) == jds.associate(a, b, 0.02)
    assert tds.associate([0.0, 0.1, 0.2, 0.31],
                         [0.005, 0.11, 0.29, 0.309, 5.0]) == [(0, 0), (1, 1),
                                                              (3, 3)]


def test_tum_reader_matches_reference(tmp_path):
    seq = jgenerate(n_frames=3, n_points=200, seed=32, motion="forward",
                    with_depth=True)
    jds.write_tum_rgbd(seq, tmp_path, depth_scale=1000)
    _same_sequence(tds.read_tum_rgbd(tmp_path, depth_scale=1000),
                   jds.read_tum_rgbd(tmp_path, depth_scale=1000))
    (tmp_path / "calibration.txt").unlink()  # the freiburg3 defaults
    a, b = tds.read_tum_rgbd(tmp_path), jds.read_tum_rgbd(tmp_path)
    assert a.fx == b.fx == pytest.approx(535.4)
    np.testing.assert_array_equal(a.gt_at(a.stamps), b.gt_at(b.stamps))


def test_euroc_reader_matches_reference(tmp_path):
    pytest.importorskip("yaml")
    seq = jgenerate(n_frames=3, n_points=200, seed=31, motion="forward")
    jds.write_euroc(seq, tmp_path)
    a, b = tds.read_euroc(tmp_path), jds.read_euroc(tmp_path)
    _same_sequence(a, b)
    np.testing.assert_array_equal(a.gt_at(a.stamps), b.gt_at(b.stamps))


@pytest.mark.parametrize("fmt", ["tum", "euroc"])
def test_port_writers_read_back_by_reference(tmp_path, fmt):
    if fmt == "euroc":
        pytest.importorskip("yaml")
    seq = tgenerate(n_frames=3, n_points=200, seed=33, motion="forward",
                    with_depth=True, device="cpu")
    if fmt == "tum":
        tds.write_tum_rgbd(seq, tmp_path, depth_scale=1000)
        ds = jds.read_tum_rgbd(tmp_path, depth_scale=1000)
        _, _, depth0 = ds.frame(0)
        assert np.max(np.abs(depth0 - seq.depth[0])) < 2e-3
    else:
        tds.write_euroc(seq, tmp_path)
        ds = jds.read_euroc(tmp_path)
        np.testing.assert_allclose(ds.baseline, float(seq.camera.baseline),
                                   rtol=1e-5)
        np.testing.assert_allclose(
            ds.t_bs, seq.camera.t_ri.numpy().astype(np.float64), atol=1e-9)
    assert len(ds) == 3 and ds.fx == pytest.approx(float(seq.camera.fx))
    _, left0, _ = ds.frame(0)
    assert np.max(np.abs(left0 - np.clip(seq.left[0], 0, 255))) <= 1.0
    np.testing.assert_allclose(ds.gt_at(ds.stamps)[:, :3, 3],
                               seq.poses[:, :3, 3], atol=1e-6)


def test_tum_rgbd_roundtrip_and_vo(tmp_path):
    """tests/test_dataset.py::test_tum_rgbd_roundtrip_and_vo through the
    port: written, read back, and tracked at SensorStrategy 1."""
    seq = tgenerate(n_frames=8, n_points=400, seed=32, motion="forward",
                    with_depth=True, device="cpu")
    tds.write_tum_rgbd(seq, tmp_path, depth_scale=1000)
    ds = tds.read_tum_rgbd(tmp_path, depth_scale=1000)
    assert ds.kind == "tum" and len(ds) == 8
    np.testing.assert_allclose(ds.fx, float(seq.camera.fx), rtol=1e-6)
    _, _, depth0 = ds.frame(0)
    assert np.max(np.abs(depth0 - seq.depth[0])) < 2e-3
    s = System({"System/SensorStrategy": 1, "Tracker/MaxFeatures": 150,
                "Tracker/MinDistance": 16, "Optimizer/Iterations": 10},
               device="cpu")
    s.init(ds.fx, ds.fy, ds.cx, ds.cy, float(seq.camera.baseline),
           width=ds.width, height=ds.height)
    for stamp, left, right in ds.frames():
        s.input_primary_sensor_data(stamp, left, right)
    outs = s.drain_outputs()
    assert not any(bool(o.lost) for o in outs[1:])
    est = np.stack([o.pose for o in outs])
    ate = ate_rmse(est, ds.gt_at(ds.stamps)[:len(est)])
    assert ate < 0.02, ate
