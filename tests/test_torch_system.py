"""The slice: visfs_tpu_torch's System and tracker_step against visfs_tpu's,
whose LK levels run the Pallas kernel (LKParams(backend="pallas"), interpret
mode on the CPU) — the formulation the port's K1 computes.

Both engines get the same 8 frames at 160x120 (MaxFeatures 40, MinDistance
12).  Tolerances per frame: translation 1e-3 m, yaw 1e-3 rad, n_inliers
within 1, identical lost flags.  tracker_step starts from the reference's
mid-sequence state handed to the port through state_from_numpy."""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from visfs_tpu.io.sim import cached_textured_sequence
from visfs_tpu.slam import estimator as jest
from visfs_tpu.slam import tracker as jtrk
from visfs_tpu.slam.state import VOState as JVOState
from visfs_tpu.slam.system import System as JSystem
from visfs_tpu_torch.ops import lk as tlk
from visfs_tpu_torch.ops.lk import LKParams
from visfs_tpu_torch.slam import estimator as t_est
from visfs_tpu_torch.slam import tracker as ttrk
from visfs_tpu_torch.slam.state import state_from_numpy, state_to_numpy
from visfs_tpu_torch.slam.system import System

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

N_FRAMES = 8
MID = 4  # the tracker test starts from the state after frame MID - 1
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


@pytest.fixture(scope="module")
def slice_run():
    seq = cached_textured_sequence(n_frames=N_FRAMES, width=160, height=120,
                                   motion="square", seed=0, speed=2.0)
    ref = JSystem(PARAMS)
    ref.lk_params = ref.lk_params._replace(backend="pallas")
    _init(ref, seq.camera)
    ref_outs, mid_state = [], None
    for i in range(N_FRAMES):
        if i == MID:
            mid_state = jax.device_get(ref.state)
        ref.input_primary_sensor_data(float(seq.stamps[i]), seq.left[i],
                                      seq.right[i])
        ref_outs.append(ref.output_odometry_info())
    port = System(PARAMS, device="cpu")
    _init(port, seq.camera)
    # the bidirectional flag of every K1 pyramid call the step makes
    k1_calls = []
    k1_fn = tlk.lk_pyramid

    def k1_counted(*a, **kw):
        k1_calls.append(kw["bidirectional"])
        return k1_fn(*a, **kw)

    tlk.lk_pyramid = k1_counted
    try:
        port_outs = port.run_sequence(seq.stamps, seq.left, seq.right)
    finally:
        tlk.lk_pyramid = k1_fn
    return dict(seq=seq, ref=ref, ref_outs=ref_outs, port_outs=port_outs,
                mid_state=mid_state, k1_calls=k1_calls)


def _yaw(T):
    return np.arctan2(T[1, 0], T[0, 0])


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_slice_frame_matches_reference(slice_run, frame):
    a = slice_run["ref_outs"][frame]
    b = slice_run["port_outs"][frame]
    pa, pb = np.asarray(a.pose), b.pose
    assert pb.shape == (4, 4) and np.all(np.isfinite(pb))
    np.testing.assert_allclose(pb[:3, 3], pa[:3, 3], atol=1e-3)
    assert abs(_yaw(pb) - _yaw(pa)) <= 1e-3
    assert abs(int(b.n_inliers) - int(a.n_inliers)) <= 1
    assert bool(b.lost) == bool(a.lost)
    assert bool(b.lost) == (frame == 0)  # only the bootstrap frame


def test_slice_ate_matches_reference(slice_run):
    from visfs_tpu_torch.io.sim import ate_rmse

    gt = slice_run["seq"].poses
    ate = ate_rmse(np.stack([o.pose for o in slice_run["port_outs"]]), gt)
    ref = ate_rmse(np.stack([np.asarray(o.pose)
                             for o in slice_run["ref_outs"]]), gt)
    assert ate < 0.1
    assert abs(ate - ref) < 1e-3


def test_slice_runs_two_k1_tracks_per_frame(slice_run):
    # the temporal and the stereo track, each one bidirectional lk_pyramid
    # call (one launch on the card); frame 0 runs its masked temporal track
    assert slice_run["k1_calls"] == [True, True] * N_FRAMES


def _to_jax_state(np_state):
    """A port state_to_numpy result as the reference's VOState type."""
    from visfs_tpu.slam import state as js

    def conv(cls, src):
        return cls(**{f: getattr(src, f) for f in cls._fields})

    return JVOState(
        features=conv(js.FeatureTable, np_state.features),
        window=conv(js.WindowState, np_state.window),
        counters=conv(js.KeyframeCounters, np_state.counters),
        odom=conv(js.OdomBuffer, np_state.odom),
        **{f: getattr(np_state, f) for f in JVOState._fields
           if f not in ("features", "window", "counters", "odom")})


def test_state_numpy_round_trip(slice_run):
    ref_np = slice_run["mid_state"]
    back = state_to_numpy(state_from_numpy(ref_np, "cpu"))
    a = jax.tree_util.tree_leaves(ref_np)
    b = jax.tree_util.tree_leaves(_to_jax_state(back))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(y, x)


@pytest.fixture(scope="module")
def tracker_pair(slice_run):
    """tracker_step of both engines on frame MID from the reference's state
    after frame MID - 1 (marginalized by each engine's own marginalize)."""
    seq, ref = slice_run["seq"], slice_run["ref"]
    s = slice_run["mid_state"]
    guess = np.eye(4, dtype=np.float32)
    guess[0, 3] = 0.2  # 2 m/s at 10 fps
    kw = dict(max_features=40, quality_level=0.05, min_distance=12,
              min_inliers=12, flow_back=True, min_depth=0.2, max_depth=10.0)
    cam = ref.camera

    def jstep(state, left, right, g):
        from visfs_tpu.ops.lk import LKPyramid, lk_pad

        feats, _ = jest.marginalize(state.features, state.window,
                                    state.keyframe)
        h, w = state.prev_left.shape
        pyr = LKPyramid(tuple(lv[0] for lv in state.prev_pyr),
                        tuple(lv[1] for lv in state.prev_pyr),
                        tuple(lv[2] for lv in state.prev_pyr), h, w,
                        lk_pad(ref.lk_params))
        return jtrk.tracker_step(
            feats, state.prev_left, state.prev_right, left, right,
            state.has_prev, g, state.blocked_uv, state.blocked_valid,
            state.next_fid, state.frame_count, cam, **kw,
            lk_params=ref.lk_params, prev_pyr=pyr)

    out_ref = jax.device_get(jax.jit(jstep)(s, seq.left[MID], seq.right[MID],
                                            guess))
    ts = state_from_numpy(s, "cpu")
    port_sys = System(PARAMS, device="cpu")
    _init(port_sys, seq.camera)
    feats, _ = t_est.marginalize(ts.features, ts.window, ts.keyframe)
    h, w = ts.prev_left.shape
    out_port = ttrk.tracker_step(
        feats, ts.prev_left, ts.prev_right, torch.from_numpy(seq.left[MID]),
        torch.from_numpy(seq.right[MID]), ts.has_prev, torch.from_numpy(guess),
        ts.blocked_uv, ts.blocked_valid, ts.next_fid, ts.frame_count,
        port_sys.camera, **kw, lk_params=LKParams(),
        prev_pyr=ttrk.carried_pyramid(ts.prev_pyr, h, w, LKParams()))
    return out_ref, out_port


def test_tracker_counts_match(tracker_pair):
    ref, port = tracker_pair
    assert int(port.n_tracked) == int(ref.n_tracked) >= 12
    assert int(port.n_new) == int(ref.n_new)
    assert bool(port.track_lost) == bool(ref.track_lost) is False
    assert int(port.next_fid) == int(ref.next_fid)
    np.testing.assert_array_equal(port.temporal_mask.numpy(),
                                  np.asarray(ref.temporal_mask))


@pytest.mark.parametrize("field,atol", [
    ("fid", 0), ("valid", 0), ("obs_mask", 0), ("stable", 0),
    ("track_cnt", 0), ("start_frame", 0), ("end_frame", 0), ("uv", 0.01),
    ("uv_right", 0.01), ("depth", 1e-3), ("pw", 1e-3)])
def test_tracker_table_matches(tracker_pair, field, atol):
    ref, port = tracker_pair
    r = np.asarray(getattr(ref.features, field))
    p = getattr(port.features, field).numpy()
    assert p.dtype == r.dtype and p.shape == r.shape
    if atol:
        np.testing.assert_allclose(p, r, atol=atol, equal_nan=True)
    else:
        np.testing.assert_array_equal(p, r)


# --- no fallback, no JAX ----------------------------------------------------

def test_system_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the raise is for CUDA-less hosts")
    with pytest.raises(RuntimeError, match="CUDA"):
        System(PARAMS, device="cuda")


def test_system_requires_a_device():
    # the device defaults to "cuda": without a card that raises, and with
    # one the System lives there; "cpu" is only ever asked for
    if torch.cuda.is_available():
        assert System(PARAMS).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        System(PARAMS)


@pytest.mark.parametrize("strategy", [-1, 6])
def test_system_rejects_unknown_strategy(strategy):
    with pytest.raises(NotImplementedError):
        System({**PARAMS, "System/SensorStrategy": strategy}, device="cpu")


def test_system_rejects_bf16():
    with pytest.raises(ValueError):
        System({**PARAMS, "Tracker/FlowComputeDtype": "bfloat16"},
               device="cpu")


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import visfs_tpu_torch.slam.system, visfs_tpu_torch.io.sim\n"
            "import visfs_tpu_torch.ops.kernels.lk_level\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# --- extrapolator -----------------------------------------------------------

def test_extrapolator_matches_reference():
    from visfs_tpu.slam import extrapolator as jx
    from visfs_tpu.slam.state import OdomBuffer as JOdom
    from visfs_tpu_torch.slam import extrapolator as tx
    from visfs_tpu_torch.slam.state import OdomBuffer as TOdom

    rng = np.random.default_rng(1)
    C = 16
    stamps = (np.arange(12) * 0.01 + 0.5).astype(np.float32)
    poses = np.cumsum(rng.normal(scale=0.01, size=(12, 6)), 0).astype(
        np.float32)
    empty = dict(stamp=np.zeros(C, np.float32),
                 pose=np.zeros((C, 6), np.float32),
                 velocity=np.zeros((C, 6), np.float32),
                 valid=np.zeros(C, bool), head=np.int32(0))
    vel = rng.normal(scale=0.3, size=6).astype(np.float32)
    prev6 = poses[3] - 0.01
    args = (np.float32(0.605), np.float32(0.5), vel, np.bool_(True), prev6,
            np.bool_(True))

    def run(mod, buf, to_arr):
        for k in range(12):
            buf = mod.add_odometry(buf, to_arr(stamps[k]), to_arr(poses[k]),
                                   to_arr(poses[k] * 0.5))
        a = tuple(to_arr(x) for x in args)
        return (buf, mod.predict_align_pose(buf, a[0], 100),
                mod.extrapolate_pose(buf, *a, 0, 100),
                mod.extrapolate_pose(buf, *a, 2, 100))

    ref = jax.device_get(jax.jit(lambda: run(
        jx, JOdom(**{k: jax.numpy.asarray(v) for k, v in empty.items()}),
        jax.numpy.asarray))())
    port = run(tx, TOdom(**{k: torch.from_numpy(np.array(v))
                            for k, v in empty.items()}),
               lambda x: torch.from_numpy(np.array(x)))
    flat_r = jax.tree_util.tree_leaves(ref)
    flat_p = jax.tree_util.tree_leaves(port)
    assert len(flat_r) == len(flat_p)
    for r, p in zip(flat_r, flat_p):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5)
    assert bool(port[1][1])  # the stamp lies inside the buffered samples
