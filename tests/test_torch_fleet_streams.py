"""The port's FleetSystem against the port's own single-stream System, on
the CPU: the vmapped step is the single step, stream by stream.

The scene and PARAMS are tests/test_torch_system.py's (160x120): stream 0
runs frames 0-7 and stream 1 frames 1-8, each against a System of the
stream's seed over the same frames.  Tolerances per stream and frame:
translation 1e-3 m, yaw 1e-3 rad, n_inliers within 1, identical lost
flags.  Also: a fleet frame calls each LK track's op once for all streams
(2 calls a frame, the 2 launches of the card), stream 1 fed noise leaves
stream 0 as it was, strategy 2 with a wheel sample masked per stream,
CLAHE and the fundamental cull under the vmap, and the strategies the
fleet refuses.  JAX is not used here."""

import numpy as np
import pytest
import torch

from visfs_tpu_torch.io.sim import cached_textured_sequence
from visfs_tpu_torch.ops import lk as lk_ops
from visfs_tpu_torch.slam.fleet import FleetSystem
from visfs_tpu_torch.slam.system import System

torch.set_num_threads(1)

N_FRAMES = 8
B = 2
PARAMS = {
    "Tracker/MaxFeatures": 40,
    "Tracker/MinDistance": 12,
    "Tracker/QualityLevel": 0.05,
    "LocalMap/MapSize": 5,
    "Optimizer/Iterations": 20,
    "Estimator/Force3DoF": True,
    "Estimator/ToleranceTranslation": 0.40,
}
MODE_FRAMES = 4  # the CLAHE and cull fleets' depth


def _init(s, cam):
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)


@pytest.fixture(scope="module")
def seq():
    return cached_textured_sequence(n_frames=N_FRAMES + B - 1, width=160,
                                    height=120, motion="square", seed=0,
                                    speed=2.0, device="cpu")


def _lanes(seq, offsets, frames):
    def lane(a):
        return np.stack([a[o:o + frames] for o in offsets], axis=1)

    return lane(seq.stamps), lane(seq.left), lane(seq.right)


def _single(seq, params, seed, offset, frames, **kw):
    s = System(params, device="cpu", seed=seed)
    _init(s, seq.camera)
    return s.run_sequence(seq.stamps[offset:offset + frames],
                          seq.left[offset:offset + frames],
                          seq.right[offset:offset + frames], **kw)


def _fleet(seq, params, stamps, lefts, rights, **kw):
    f = FleetSystem(params, n_streams=B, device="cpu")
    _init(f, seq.camera)
    return f.run_sequences(stamps, lefts, rights, **kw)


def _gap(fleet_out, stream, single_out):
    """(|dt| m, |dyaw| rad, |d inliers|, lost flags equal)."""
    a, b = fleet_out.pose[stream], single_out.pose
    yaw = np.arctan2(a[1, 0], a[0, 0]) - np.arctan2(b[1, 0], b[0, 0])
    return (float(np.abs(a[:3, 3] - b[:3, 3]).max()), float(abs(yaw)),
            abs(int(fleet_out.n_inliers[stream]) - int(single_out.n_inliers)),
            bool(fleet_out.lost[stream]) == bool(single_out.lost))


def _assert_close(fleet_out, stream, single_out):
    dt, dyaw, dinl, same_lost = _gap(fleet_out, stream, single_out)
    assert dt <= 1e-3 and dyaw <= 1e-3 and dinl <= 1 and same_lost, (
        dt, dyaw, dinl, same_lost)


@pytest.fixture(scope="module")
def runs(seq):
    stamps, lefts, rights = _lanes(seq, range(B), N_FRAMES)
    calls = []
    entry = lk_ops.lk_pyramid

    def counted(*a, **kw):
        calls.append(a[2].shape)
        return entry(*a, **kw)

    lk_ops.lk_pyramid = counted
    try:
        fleet = _fleet(seq, PARAMS, stamps, lefts, rights)
    finally:
        lk_ops.lk_pyramid = entry
    singles = [_single(seq, PARAMS, b, b, N_FRAMES) for b in range(B)]
    return dict(fleet=fleet, singles=singles, calls=calls)


@pytest.mark.parametrize("frame", range(N_FRAMES))
@pytest.mark.parametrize("stream", range(B))
def test_fleet_stream_matches_its_single_system(runs, stream, frame):
    _assert_close(runs["fleet"][frame], stream, runs["singles"][stream][frame])
    assert bool(runs["fleet"][frame].lost[stream]) == (frame == 0)


def test_fleet_frame_is_two_lk_calls_for_all_streams(runs):
    # the temporal and the stereo track, each one call of the op with the
    # streams stacked by vmap (one launch on the card), whatever B is
    # (inside the vmap each call sees one stream's [N, 2] points)
    assert len(runs["calls"]) == 2 * N_FRAMES
    assert all(len(shape) == 2 and shape[1] == 2 for shape in runs["calls"])


@pytest.fixture(scope="module")
def noisy(seq):
    """Stream 0 as in ``runs``; stream 1 fed uniform noise images."""
    stamps, lefts, rights = _lanes(seq, (0, 0), N_FRAMES)
    rng = np.random.default_rng(0)
    noise = rng.uniform(0, 255, lefts[:, 1].shape).astype(np.float32)
    lefts[:, 1] = noise
    rights[:, 1] = noise
    return _fleet(seq, PARAMS, stamps, lefts, rights)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_streams_are_independent(runs, noisy, frame):
    _assert_close(noisy[frame], 0, runs["singles"][0][frame])
    assert np.all(np.isfinite(noisy[frame].pose))


S2_FRAMES = 6


@pytest.fixture(scope="module")
def strategy2(seq):
    """Strategy 2: every wheel sample reaches stream 0 and none reaches
    stream 1 (valid False), against single Systems fed the same."""
    p = dict(PARAMS, **{"System/SensorStrategy": 2})
    stamps, lefts, rights = _lanes(seq, (0, 0), S2_FRAMES)
    odom = np.asarray(seq.wheel_odom, np.float32)
    rows = np.stack([odom, odom], axis=1)  # [K, B, 8]
    rows[:, 1, 7] = 0.0
    fleet = _fleet(seq, p, stamps, lefts, rights, wheel_odom=rows)
    with_wheel = _single(seq, p, 0, 0, S2_FRAMES, wheel_odom=odom)
    without = _single(seq, p, 1, 0, S2_FRAMES)
    return fleet, (with_wheel, without)


@pytest.mark.parametrize("frame", range(S2_FRAMES))
@pytest.mark.parametrize("stream", range(B))
def test_strategy2_masked_wheel_rows(strategy2, stream, frame):
    fleet, singles = strategy2
    _assert_close(fleet[frame], stream, singles[stream][frame])


def test_strategy2_mask_keeps_a_buffer_untouched(seq):
    p = dict(PARAMS, **{"System/SensorStrategy": 2})
    f = FleetSystem(p, n_streams=B, device="cpu")
    _init(f, seq.camera)
    before = [t.clone() for t in f.states.odom]
    f.input_wheel_odometry([0.1, 0.1], np.ones((B, 6)),
                           valid=[True, False])
    after = f.states.odom
    assert int(after.head[0]) == 1 and int(after.head[1]) == 0
    for a, b in zip(after, before):
        assert torch.equal(a[1], b[1])
    assert float(after.pose[0, 0, 0]) == 1.0


MODES = {"clahe": {"System/CLAHE": True},
         "cull": {"Tracker/FlowBack": False,
                  "Tracker/CullByFundationMatrix": True}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fleet_modes_match_single_systems(seq, mode):
    p = dict(PARAMS, **MODES[mode])
    stamps, lefts, rights = _lanes(seq, range(B), MODE_FRAMES)
    fleet = _fleet(seq, p, stamps, lefts, rights)
    for b in range(B):
        single = _single(seq, p, b, b, MODE_FRAMES)
        for frame in range(MODE_FRAMES):
            _assert_close(fleet[frame], b, single[frame])


@pytest.mark.parametrize("strategy", [3, 4, 5])
def test_fleet_refuses_the_laser_strategies(strategy):
    with pytest.raises(NotImplementedError):
        FleetSystem({**PARAMS, "System/SensorStrategy": strategy},
                    device="cpu")


def test_fleet_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the raise is for CUDA-less hosts")
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetSystem(PARAMS)


def test_fleet_needs_init():
    f = FleetSystem(PARAMS, device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        f.input_primary_sensor_data(np.zeros(8), np.zeros((8, 120, 160)),
                                    np.zeros((8, 120, 160)))
