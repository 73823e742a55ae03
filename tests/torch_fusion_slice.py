"""Shared body of the tests/test_torch_system_fusion*.py files: one
SensorStrategy of visfs_tpu_torch's System against visfs_tpu's over the
reference's own 8 frames at 160x120 with its wheel rows and laser scans.

The reference's LK is its Pallas kernel (interpret mode on the CPU), the
formulation the port's K1 computes.  A submap rotates every 3 scans, so the
8 frames start a second one and finish the first.  One file a strategy:
each reference System compiles its own step (~35 s on the CPU)."""

import jax
import numpy as np
import pytest

from visfs_tpu.io.sim import cached_textured_sequence
from visfs_tpu.slam.system import System as JSystem
from visfs_tpu_torch.slam.system import System

N_FRAMES = 8
MID = 4  # the mid-sequence state is the reference's after frame MID - 1
PARAMS = {
    "Tracker/MaxFeatures": 40,
    "Tracker/MinDistance": 12,
    "Tracker/QualityLevel": 0.05,
    "LocalMap/MapSize": 5,
    "Optimizer/Iterations": 20,
    "Estimator/Force3DoF": True,
    "Estimator/ToleranceTranslation": 0.40,
    "LocalMap/NumRangeDataLimit": 3,
    # two pyramid levels: the reference inlines every level of its four LK
    # passes into the step it compiles, and these files are about the
    # sensor strategies (tests/test_torch_system.py holds the full LK)
    "Tracker/FlowMaxLevel": 1,
}
SYSTEM_KW = dict(scan_capacity=192, submap_extent_cells=64)


def params(strategy):
    return dict(PARAMS, **{"System/SensorStrategy": strategy})


def init(s, cam):
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)


def inputs(seq, strategy):
    """run_sequence's sensor inputs: scans for strategies 3-5, wheel rows
    for 2-4.  The reference branches on >= 2 for the wheel and on 4/5 for
    the laser BA, so 5 with wheel rows computes what 4 does; without them
    it runs its own path, PnP and the laser BA (as the reference's
    tests/test_laser_fusion.py runs it)."""
    kw = {"wheel_odom": seq.wheel_odom} if strategy <= 4 else {}
    if strategy >= 3:
        kw["scans"] = seq.laser_scans
    return kw


def run(strategy):
    """Both engines over the sequence: the outputs, the reference's state
    before frame MID (numpy), and both final states."""
    seq = cached_textured_sequence(n_frames=N_FRAMES, width=160, height=120,
                                   motion="square", seed=0, speed=2.0,
                                   with_laser=True)
    ref = JSystem(params(strategy), **SYSTEM_KW)
    ref.lk_params = ref.lk_params._replace(backend="pallas")
    init(ref, seq.camera)
    kw = inputs(seq, strategy)
    ref_outs = ref.run_sequence(seq.stamps[:MID], seq.left[:MID],
                                seq.right[:MID], **{
                                    k: (v if k == "wheel_odom" else v[:MID])
                                    for k, v in kw.items()})
    mid_state = jax.device_get(ref.state)
    odom_done = sum(1 for r in seq.wheel_odom
                    if r[0] <= seq.stamps[MID - 1] + 1e-9)
    rest = {k: (v[odom_done:] if k == "wheel_odom" else v[MID:])
            for k, v in kw.items()}
    ref_outs += ref.run_sequence(seq.stamps[MID:], seq.left[MID:],
                                 seq.right[MID:], **rest)
    port = System(params(strategy), device="cpu", **SYSTEM_KW)
    init(port, seq.camera)
    port_outs = port.run_sequence(seq.stamps, seq.left, seq.right, **kw)
    return dict(seq=seq, ref=ref, port=port, ref_outs=ref_outs,
                port_outs=port_outs, mid_state=mid_state, rest=rest)


def _yaw(T):
    return np.arctan2(T[1, 0], T[0, 0])


def check_frame(r, frame):
    """Per frame: translation 1e-3 m, yaw 1e-3 rad, inliers within 1,
    identical lost flags."""
    a, b = r["ref_outs"][frame], r["port_outs"][frame]
    pa, pb = np.asarray(a.pose), b.pose
    assert pb.shape == (4, 4) and np.all(np.isfinite(pb))
    np.testing.assert_allclose(pb[:3, 3], pa[:3, 3], atol=1e-3)
    assert abs(_yaw(pb) - _yaw(pa)) <= 1e-3
    assert abs(int(b.n_inliers) - int(a.n_inliers)) <= 1
    assert bool(b.lost) == bool(a.lost)
    assert bool(b.lost) == (frame == 0)  # only the bootstrap frame


def check_ate(r):
    from visfs_tpu_torch.io.sim import ate_rmse

    gt = r["seq"].poses
    ate = ate_rmse(np.stack([o.pose for o in r["port_outs"]]), gt)
    ref = ate_rmse(np.stack([np.asarray(o.pose) for o in r["ref_outs"]]),
                   gt)
    print(f"ATE: port {ate:.5f} m, reference {ref:.5f} m")
    assert abs(ate - ref) < 1e-3


def check_submaps(r):
    """Identical slot_valid, num_range_data and finished; max_xy within
    1e-4 m; at most 0.1 % of the known cells (known on either side)
    different, the count printed."""
    js = jax.device_get(r["ref"].state.laser.submaps)
    ts = r["port"].state.laser.submaps
    for f in ("slot_valid", "num_range_data", "finished"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    np.testing.assert_allclose(ts.max_xy.numpy(), np.asarray(js.max_xy),
                               atol=1e-4)
    jc = np.asarray(js.cells).astype(np.int32)
    tc = ts.cells.numpy()
    known = int(((jc != 0) | (tc != 0)).sum())
    differ = int((jc != tc).sum())
    print(f"submap cells: {differ} of {known} known cells differ")
    assert known > 1000
    assert differ <= 1e-3 * known
    # the 8 frames started a second submap and finished the first
    assert ts.slot_valid.tolist() == [True, True]
    assert ts.num_range_data.tolist() == [5, 2]


def check_from_mid_state(r, strategy, frames=2):
    """The port, handed the reference's laser state before frame MID by
    state_from_numpy, steps the next ``frames`` frames to the reference's
    poses."""
    from visfs_tpu_torch.slam.state import state_from_numpy

    seq = r["seq"]
    port = System(params(strategy), device="cpu", **SYSTEM_KW)
    init(port, seq.camera)
    port.state = state_from_numpy(r["mid_state"], "cpu")
    end = MID + frames
    rest = {k: (v if k == "wheel_odom" else v[:frames])
            for k, v in r["rest"].items()}
    outs = port.run_sequence(seq.stamps[MID:end], seq.left[MID:end],
                             seq.right[MID:end], **rest)
    assert len(outs) == frames
    for a, b in zip(r["ref_outs"][MID:], outs):
        np.testing.assert_allclose(b.pose[:3, 3], np.asarray(a.pose)[:3, 3],
                                   atol=1e-3)
        assert abs(int(b.n_inliers) - int(a.n_inliers)) <= 1


@pytest.fixture(scope="module")
def fusion_run(request):
    return run(request.module.STRATEGY)
