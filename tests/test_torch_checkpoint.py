"""The port's checkpoint/resume (visfs_tpu_torch.io.checkpoint) against the
JAX package's visfs_tpu.io.checkpoint.

- A 160x120 SensorStrategy-3 port state after 4 frames (wheel rows, scans,
  two submap slots) saved and restored into a fresh System: every leaf
  bit-equal, and the next CPU step from it bit-equal in every output field
  and state leaf.
- config.json byte-equal to what the reference's save_system writes for the
  same parameters; a configuration mismatch raises the same ValueError.
- A mapping .npz written by the reference's save_mapping restored by the
  port (every graph leaf, snapshot and the bookkeeping equal), and one the
  port writes restored by the reference, also equal.
- ADVICE.md:4: the reference saves map.ckpt as map.ckpt.npz and restores
  map.npz (FileNotFoundError); the port appends .npz on both sides."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.config import config_from_parameters as jconfig
from visfs_tpu.io import checkpoint as jckpt
from visfs_tpu.slam import mapping as jmap
from visfs_tpu_torch.io import checkpoint as tckpt
from visfs_tpu_torch.io.sim import cached_textured_sequence
from visfs_tpu_torch.slam import mapping as tmap
from visfs_tpu_torch.slam.state import VOState
from visfs_tpu_torch.slam.system import System

torch.set_num_threads(1)

PARAMS = {
    "System/SensorStrategy": 3,
    "Tracker/MaxFeatures": 40,
    "Tracker/MinDistance": 12,
    "Tracker/QualityLevel": 0.05,
    "LocalMap/MapSize": 5,
    "Optimizer/Iterations": 20,
    "Estimator/Force3DoF": True,
    "Estimator/ToleranceTranslation": 0.40,
    "LocalMap/NumRangeDataLimit": 3,
}
SYSTEM_KW = dict(scan_capacity=192, submap_extent_cells=64)
N_SAVED = 4


def _system(cam, params=PARAMS):
    s = System(params, device="cpu", **SYSTEM_KW)
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    return s


def _feed(s, seq, i, odom_from):
    """Frame i's wheel rows (from row odom_from), then the frame and its
    scan; returns the next row."""
    j = odom_from
    while j < len(seq.wheel_odom) and \
            seq.wheel_odom[j][0] <= seq.stamps[i] + 1e-9:
        j += 1
    if j > odom_from:
        rows = seq.wheel_odom[odom_from:j]
        s.input_wheel_odometry_batch(rows[:, 0], rows[:, 1:7])
    s.input_primary_sensor_data(float(seq.stamps[i]), seq.left[i],
                                seq.right[i], scan=seq.laser_scans[i])
    return j


def _leaves(tree, prefix=""):
    if tree is None:
        return {}
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_leaves(getattr(tree, f), f"{prefix}{f}/"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert list(la) == list(lb)
    for k in la:
        x, y = la[k], lb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, k
            x, y = x.numpy(), y.numpy()
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    seq = cached_textured_sequence(n_frames=N_SAVED + 1, width=160,
                                   height=120, motion="square", seed=0,
                                   speed=2.0, with_laser=True, device="cpu")
    s = _system(seq.camera)
    odom = 0
    for i in range(N_SAVED):
        odom = _feed(s, seq, i, odom)
    s.drain_outputs()
    path = tmp_path_factory.mktemp("ckpt") / "system"
    tckpt.save_system(path, s)
    return seq, s, odom, path


def test_state_restores_bit_equal(saved):
    seq, s, _, path = saved
    assert bool(s.state.laser.submaps.slot_valid.any())
    assert int(s.state.odom.head) > 0
    fresh = _system(seq.camera)
    tckpt.restore_system(path, fresh)
    assert isinstance(fresh.state, VOState)
    _assert_bit_equal(fresh.state, s.state)


def test_the_next_step_from_the_restored_state_is_bit_equal(saved):
    seq, s, odom, path = saved
    fresh = _system(seq.camera)
    tckpt.restore_system(path, fresh)
    before = s.state
    outs = []
    for sys_ in (s, fresh):
        _feed(sys_, seq, N_SAVED, odom)
        outs.append(sys_.drain_outputs()[0])
    _assert_bit_equal(fresh.state, s.state)
    for f in outs[0]._fields:
        np.testing.assert_array_equal(np.asarray(getattr(outs[1], f)),
                                      np.asarray(getattr(outs[0], f)),
                                      err_msg=f)
    s.state = before  # the fixture's state for the other tests


def test_config_json_is_the_reference_bytes(saved, tmp_path):
    _, s, _, path = saved
    ref = types.SimpleNamespace(cfg=jconfig(PARAMS),
                                state={"x": np.zeros(2, np.float32)})
    jckpt.save_system(tmp_path / "ref", ref)
    assert (path / "config.json").read_bytes() == \
        (tmp_path / "ref" / "config.json").read_bytes()


def test_config_mismatch_raises(saved):
    seq, _, _, path = saved
    other = _system(seq.camera, dict(PARAMS, **{"Tracker/MaxFeatures": 41}))
    with pytest.raises(ValueError, match="does not match"):
        tckpt.restore_system(path, other)


def _reference_backend():
    """A reference MappingBackend with 5 keyframes of two robots, one loop
    closure, snapshots on 3 nodes and decided pairs."""
    rng = np.random.default_rng(3)
    b = jmap.MappingBackend(None, max_nodes=16, max_edges=32)
    for k in range(5):
        yaw = 0.1 * k
        pose = np.eye(4, dtype=np.float32)
        pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)],
                        [np.sin(yaw), np.cos(yaw)]]
        pose[:3, 3] = rng.normal(size=3)
        snap = None
        if k % 2 == 0:
            snap = jmap.KeyframeSnapshot(
                uv=jnp.asarray(rng.uniform(0, 160, (8, 2)), jnp.float32),
                p_robot=jnp.asarray(rng.normal(size=(8, 3)), jnp.float32),
                patch=jnp.asarray(rng.normal(size=(8, 12)), jnp.float32),
                valid=jnp.asarray(rng.uniform(size=8) > 0.3))
        b.add_keyframe(pose, 0.1 * k, snapshot=snap, robot=k % 2)
    b.add_loop_closure(0, 4, np.eye(4, dtype=np.float32), info=2e3)
    b._decided_pairs = {(0, 4), (1, 3)}
    b.odom_info = 5e3
    return b


def _assert_backends_equal(port, ref):
    g_ref = jax.device_get(ref.graph)
    for f in g_ref._fields:
        np.testing.assert_array_equal(getattr(port.graph, f).numpy(),
                                      np.asarray(getattr(g_ref, f)),
                                      err_msg=f)
    assert sorted(port.snapshots) == sorted(ref.snapshots)
    for k, snap in ref.snapshots.items():
        for f in snap._fields:
            np.testing.assert_array_equal(
                getattr(port.snapshots[k], f).numpy(),
                np.asarray(getattr(snap, f)), err_msg=f"{k}/{f}")
    assert port._last_node == ref._last_node
    assert port._decided_pairs == ref._decided_pairs
    assert port.odom_info == ref.odom_info


def test_reference_mapping_file_restores_in_the_port(tmp_path):
    ref = _reference_backend()
    jckpt.save_mapping(tmp_path / "map.npz", ref)
    port = tmap.MappingBackend(None, max_nodes=16, max_edges=32,
                               device="cpu")
    tckpt.restore_mapping(tmp_path / "map.npz", port)
    _assert_backends_equal(port, ref)
    small = tmap.MappingBackend(None, max_nodes=8, max_edges=32,
                                device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        tckpt.restore_mapping(tmp_path / "map.npz", small)


def test_port_mapping_file_restores_in_the_reference(tmp_path):
    ref = _reference_backend()
    jckpt.save_mapping(tmp_path / "a.npz", ref)
    port = tmap.MappingBackend(None, max_nodes=16, max_edges=32,
                               device="cpu")
    tckpt.restore_mapping(tmp_path / "a.npz", port)
    tckpt.save_mapping(tmp_path / "b.npz", port)
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = jmap.MappingBackend(None, max_nodes=16, max_edges=32)
    jckpt.restore_mapping(tmp_path / "b.npz", back)
    _assert_backends_equal(port, back)


def test_mapping_path_without_npz_suffix(tmp_path):
    """ADVICE.md:4 in the reference, fixed in the port."""
    ref = _reference_backend()
    jckpt.save_mapping(tmp_path / "ref.ckpt", ref)
    assert (tmp_path / "ref.ckpt.npz").exists()
    with pytest.raises(FileNotFoundError):
        jckpt.restore_mapping(tmp_path / "ref.ckpt",
                              jmap.MappingBackend(None, max_nodes=16,
                                                  max_edges=32))
    port = tmap.MappingBackend(None, max_nodes=16, max_edges=32,
                               device="cpu")
    tckpt.restore_mapping(tmp_path / "ref.ckpt", port)  # the same file
    _assert_backends_equal(port, ref)
    tckpt.save_mapping(tmp_path / "port.ckpt", port)
    assert (tmp_path / "port.ckpt.npz").exists()
    again = tmap.MappingBackend(None, max_nodes=16, max_edges=32,
                                device="cpu")
    tckpt.restore_mapping(tmp_path / "port.ckpt", again)
    _assert_backends_equal(again, ref)


def test_state_file_round_trips_json_free(saved, tmp_path):
    """save_state / restore_state alone, on a path without the suffix."""
    seq, s, _, _ = saved
    tckpt.save_state(tmp_path / "st", s.state)
    assert (tmp_path / "st.npz").exists()
    back = tckpt.restore_state(tmp_path / "st", _system(seq.camera).state)
    _assert_bit_equal(back, s.state)
    with pytest.raises(ValueError, match="shape"):
        other = System(PARAMS, device="cpu", scan_capacity=192,
                       submap_extent_cells=32)
        cam = seq.camera
        other.init(float(cam.fx), float(cam.fy), float(cam.cx),
                   float(cam.cy), float(cam.baseline), width=cam.width,
                   height=cam.height)
        tckpt.restore_state(tmp_path / "st", other.state)
