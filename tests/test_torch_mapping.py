"""visfs_tpu_torch.slam.mapping against visfs_tpu.slam.mapping: the keyframe
graph's operations, the loop candidates, the keyframe snapshot and loop
verification, on the same seeded inputs.

Tolerances: the graph operations bit-equal on poses that round exactly
(inserts at node and edge capacity included), and on random rotations ids,
masks and counters bit-equal with the floats within 1e-6 (XLA's compiled
mat_to_quat rounds the norm its own way); propose_loop_candidates' pairs
and validity identical (ties in distance to the lower flat index, as lax.top_k; the gap between
one robot's keyframes counted in global node indices, the reference's
quirk kept for parity); snapshot_features from one reference feature table
and image: uv and p_robot within 1e-5, valid identical, patch within 1e-4;
verify_loop on tests/test_mapping.py:111-156's scene, the reference's
snapshots carried across: identical ok, n_inliers within 1, rel within
1e-3 m and 1e-3 rad, the scrambled pair rejected by both; close_loops over
the same keyframes and snapshots: the same closures."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.core.lie import xyzrpy_to_mat
from visfs_tpu.io.sim import generate_sequence
from visfs_tpu.slam import mapping as jmap
from visfs_tpu.slam.system import System as JSystem
from visfs_tpu_torch.core import prng
from visfs_tpu_torch.core.camera import make_stereo_camera
from visfs_tpu_torch.slam import mapping as tmap
from visfs_tpu_torch.slam.state import (graph_from_numpy, graph_to_numpy,
                                        snapshot_from_numpy,
                                        snapshot_to_numpy, state_from_numpy)

torch.set_num_threads(1)

_propose = jax.jit(jmap.propose_loop_candidates,
                   static_argnames=("radius", "min_gap", "max_candidates"))


def _pose(x, y, yaw):
    return np.asarray(xyzrpy_to_mat(*[jnp.float32(v) for v in
                                      (x, y, 0.0, 0.0, 0.0, yaw)]))


def _same_graph(port, ref):
    out = graph_to_numpy(port)
    for f in jmap.KeyframeGraph._fields:
        np.testing.assert_array_equal(getattr(out, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def _graph_ops(lib, g, poses, robots, closures, as_arr):
    """Insert keyframes (robot-tagged, each robot's own chain) and loop
    closures through lib's functional graph operations."""
    last = {}
    for k, (pose, r) in enumerate(zip(poses, robots)):
        prev = last.get(r, -1)
        g = lib.add_keyframe(g, as_arr(pose), np.float32(0.1 * k), 1e4,
                             robot=as_arr(np.int32(r)),
                             prev_node=as_arr(np.int32(prev)))
        last[r] = k
    for i, j, rel, info in closures:
        g = lib.add_loop_closure(g, as_arr(np.int32(i)), as_arr(np.int32(j)),
                                 as_arr(rel), as_arr(np.float32(info)))
    return g


def _exact_pose(x, y, flip):
    """A pose whose rotation (yaw 0 or pi) and translation (halves) every
    rounding represents exactly."""
    T = np.diag([-1.0, -1.0, 1.0, 1.0] if flip else [1.0] * 4)
    T[:2, 3] = x, y
    return T.astype(np.float32)


def _graph_case(seed, exact):
    rng = np.random.default_rng(seed)
    if exact:
        poses = [_exact_pose(*(0.5 * rng.integers(-8, 8, 2)),
                             rng.integers(2)) for _ in range(8)]
        rels = [_exact_pose(0.5, -1.0, 1), _exact_pose(-1.5, 0.0, 0),
                _exact_pose(0.0, 2.5, 1)]
    else:
        poses = [_pose(*rng.normal(size=3)) for _ in range(8)]
        rels = [_pose(0.3, -0.1, 0.2), _pose(-0.2, 0.4, -0.1),
                _pose(0.05, 0.0, 0.3)]
    robots = [0, 0, 1, 0, 1, 1, 0, 1]
    closures = [(0, 2, rels[0], 1e3 * 12), (1, 7, rels[1], 1e3 * 15),
                (3, 4, rels[2], 1e3 * 11)]
    return poses, robots, closures


def _both_graphs(capacity, case):
    ref = _graph_ops(jmap, jmap.init_graph(*capacity), *case, jnp.asarray)
    port = _graph_ops(tmap, tmap.init_graph(*capacity, device="cpu"), *case,
                      lambda a: torch.as_tensor(np.array(a)))
    return port, jax.device_get(ref)


@pytest.mark.parametrize("capacity,n_edges", [((16, 32), 9), ((5, 12), 6),
                                              ((12, 6), 6)],
                         ids=["room", "node_capacity", "edge_capacity"])
def test_graph_ops_bit_equal(capacity, n_edges):
    """Two robots' interleaved keyframes and three closures on poses that
    round exactly, so every field is bit-equal: at node capacity the extra
    inserts are no-ops with n_nodes clamped, at edge capacity the extra
    edges are dropped with n_edges clamped, and odometry edges link each
    robot's own chain."""
    port, ref = _both_graphs(capacity, _graph_case(sum(capacity), True))
    _same_graph(port, ref)
    assert int(port.n_nodes) == min(8, capacity[0])
    assert int(port.n_edges) == n_edges


def test_graph_ops_match_reference_on_random_poses():
    """The same on random rotations: ids, masks and counters bit-equal,
    the float fields within 1e-6.  XLA's compiled mat_to_quat rounds the
    quaternion's norm its own way (it disagrees with the reference's own
    eager run in 5 % of random rotations, by an ulp)."""
    port, ref = _both_graphs((16, 32), _graph_case(3, False))
    out = graph_to_numpy(port)
    for f in jmap.KeyframeGraph._fields:
        a, b = getattr(out, f), np.asarray(getattr(ref, f))
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _candidate_graph(xy, robots, capacity=16):
    """A graph of keyframes at the given planar positions (numpy leaves)
    through the reference's own inserts."""
    g = jmap.init_graph(capacity, 64)
    last = {}
    for k, ((x, y), r) in enumerate(zip(xy, robots)):
        g = jmap.add_keyframe(g, jnp.asarray(_pose(x, y, 0.0)),
                              jnp.float32(k), 1e4, robot=jnp.int32(r),
                              prev_node=jnp.int32(last.get(r, -1)))
        last[r] = k
    return jax.device_get(g)


CANDIDATE_CASES = {
    # a lattice: many pairs at exactly the same distance
    "ties": ([(float(i % 4), float(i // 4)) for i in range(12)], [0] * 12,
             1.5, 3),
    # two robots interleaved: same-robot gaps count global indices
    "interleaved": ([(0.25 * (i // 2), 0.5 * (i % 2)) for i in range(14)],
                    [i % 2 for i in range(14)], 1.0, 6),
    "cross_adjacent": ([(0.0, 0.0), (0.5, 0.0), (3.0, 0.0)], [0, 1, 0], 2.0,
                       10),
}


@pytest.mark.parametrize("name", list(CANDIDATE_CASES))
def test_propose_loop_candidates_match_reference(name):
    xy, robots, radius, min_gap = CANDIDATE_CASES[name]
    g = _candidate_graph(xy, robots)
    pairs_r, valid_r = _propose(g, radius=radius, min_gap=min_gap)
    pairs, valid = tmap.propose_loop_candidates(
        graph_from_numpy(g, "cpu"), radius, min_gap)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_r))
    assert valid.any()
    np.testing.assert_array_equal(pairs.numpy()[valid.numpy()],
                                  np.asarray(pairs_r)[np.asarray(valid_r)])


# --- snapshots and verification on tests/test_mapping.py:111-156's scene ---

@pytest.fixture(scope="module")
def arc():
    seq = generate_sequence(n_frames=8, n_points=500, width=200, height=150,
                            motion="arc", seed=5)
    cam = seq.camera
    s = JSystem({"Tracker/MaxFeatures": 80, "Tracker/MinDistance": 8,
                 "Optimizer/Iterations": 8})
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    snaps, outs, states = [], [], []
    for k in range(6):
        s.input_primary_sensor_data(float(seq.stamps[k]), seq.left[k],
                                    seq.right[k])
        outs.append(s.output_odometry_info())
        states.append(jax.device_get(s.state))
        snaps.append(jax.device_get(s.keyframe_snapshot(max_kp=48)))
    tcam = make_stereo_camera(float(cam.fx), float(cam.fy), float(cam.cx),
                              float(cam.cy), float(cam.baseline),
                              width=cam.width, height=cam.height,
                              device="cpu")
    return dict(seq=seq, cam=s.camera, tcam=tcam, snaps=snaps, outs=outs,
                states=states)


@pytest.mark.parametrize("frame", [2, 5])
def test_snapshot_features_matches_reference(arc, frame):
    st = arc["states"][frame]
    ref = arc["snaps"][frame]
    port = snapshot_to_numpy(tmap.snapshot_features(
        state_from_numpy(st, "cpu").features, torch.from_numpy(
            np.array(st.prev_left)), arc["tcam"], max_kp=48))
    np.testing.assert_array_equal(port.valid, ref.valid)
    assert port.valid.sum() >= 20
    np.testing.assert_allclose(port.uv, ref.uv, atol=1e-5)
    np.testing.assert_allclose(port.p_robot, ref.p_robot, atol=1e-5)
    np.testing.assert_allclose(port.patch, ref.patch, atol=1e-4)


def test_keyframe_snapshot_entry_matches_snapshot_features(arc):
    """System.keyframe_snapshot is snapshot_features of the latest frame's
    table and (post-CLAHE) left image."""
    from visfs_tpu_torch.slam.system import System

    seq = arc["seq"]
    s = System({"Tracker/MaxFeatures": 80, "Tracker/MinDistance": 8,
                 "Optimizer/Iterations": 8}, device="cpu")
    cam = seq.camera
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    s.state = state_from_numpy(arc["states"][3], "cpu")
    snap = snapshot_to_numpy(s.keyframe_snapshot(max_kp=48))
    ref = arc["snaps"][3]
    np.testing.assert_array_equal(snap.valid, ref.valid)
    np.testing.assert_allclose(snap.patch, ref.patch, atol=1e-4)


def _rel_gap(a, b):
    """(max |dt| m, rotation angle rad): the angle from |Ra - Rb|_F =
    2 sqrt(2) sin(angle / 2), precise near 0 (the trace's arccos is not)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2.0 * np.sqrt(2.0))
    return (float(np.abs(a[:3, 3] - b[:3, 3]).max()),
            float(2.0 * np.arcsin(min(d, 1.0))))


def _scrambled(snap):
    return snap._replace(patch=np.random.default_rng(0).normal(
        size=snap.patch.shape).astype(np.float32))


VERIFY_CASES = {"loop_2_5": (2, 5, 0, False), "loop_1_4": (1, 4, 3, False),
                "loop_0_5": (0, 5, 7, False), "junk": (2, 5, 1, True)}


@pytest.mark.parametrize("name", list(VERIFY_CASES))
def test_verify_loop_matches_reference(arc, name):
    i, j, key, junk = VERIFY_CASES[name]
    si, sj = arc["snaps"][i], arc["snaps"][j]
    if junk:
        sj = _scrambled(sj)
    # the static arguments as close_loops passes them: one compile for both
    rel_r, ok_r, n_r = jax.device_get(jmap.verify_loop(
        si, sj, arc["cam"], jax.random.PRNGKey(key), min_inliers=10,
        min_ncc=0.4))
    rel, ok, n = tmap.verify_loop(snapshot_from_numpy(si, "cpu"),
                                  snapshot_from_numpy(sj, "cpu"),
                                  arc["tcam"], prng.PRNGKey(key),
                                  min_inliers=10)
    assert bool(ok) == bool(ok_r)
    assert abs(int(n) - int(n_r)) <= 1
    if junk:
        assert not bool(ok) or int(n) < 10
        return
    assert bool(ok) and int(n) >= 10
    dt, dang = _rel_gap(rel.numpy(), np.asarray(rel_r))
    assert dt <= 1e-3 and dang <= 1e-3, (dt, dang)


def test_close_loops_matches_reference(arc):
    """close_loops over the scene's keyframes (the reference's poses and
    snapshots carried across): the same closures, in order."""
    jb = jmap.MappingBackend(None, max_nodes=16, max_edges=64)
    tb = tmap.MappingBackend(None, max_nodes=16, max_edges=64, device="cpu")
    for k, (out, snap) in enumerate(zip(arc["outs"], arc["snaps"])):
        jb.add_keyframe(np.asarray(out.pose), float(k), snapshot=snap)
        tb.add_keyframe(np.asarray(out.pose), float(k),
                        snapshot=snapshot_from_numpy(snap, "cpu"))
    _same_graph(tb.graph, jax.device_get(jb.graph))
    added_r = jb.close_loops(arc["cam"], radius=5.0, min_gap=3,
                             min_inliers=10)
    added = tb.close_loops(arc["tcam"], radius=5.0, min_gap=3,
                           min_inliers=10)
    assert added == added_r >= 1
    assert tb.close_loops(arc["tcam"], radius=5.0, min_gap=3,
                          min_inliers=10) == 0
    g, g_r = graph_to_numpy(tb.graph), jax.device_get(jb.graph)
    n = int(g.n_edges)
    assert n == int(g_r.n_edges)
    np.testing.assert_array_equal(g.edge_i[:n], g_r.edge_i[:n])
    np.testing.assert_array_equal(g.edge_j[:n], g_r.edge_j[:n])
    np.testing.assert_allclose(g.edge_t[:n], g_r.edge_t[:n], atol=1e-3)
