"""Shared body of tests/test_torch_system_{rgbd,clahe,cull}.py: one front-end
mode of visfs_tpu_torch's System against visfs_tpu's over the reference's
own 8 frames at 160x120 (the textured square loop, seed 0), as
tests/test_torch_system.py holds strategy 0.

The reference's LK is its Pallas kernel (interpret mode on the CPU), the
formulation the port's K1 computes.  One file a mode: each reference System
compiles its own step (~35-60 s on the CPU), and xdist spreads the files."""

import numpy as np

from visfs_tpu.io.sim import cached_textured_sequence
from visfs_tpu.slam.system import System as JSystem
from visfs_tpu_torch.ops import lk as tlk
from visfs_tpu_torch.slam.system import System

N_FRAMES = 8
PARAMS = {  # tests/test_torch_system.py's
    "Tracker/MaxFeatures": 40,
    "Tracker/MinDistance": 12,
    "Tracker/QualityLevel": 0.05,
    "LocalMap/MapSize": 5,
    "Optimizer/Iterations": 20,
    "Estimator/Force3DoF": True,
    "Estimator/ToleranceTranslation": 0.40,
}
# per frame: translation (m) and yaw (rad); lost flags and inliers equal
TOL_T = 3e-5
TOL_YAW = 3e-5


def init(s, cam):
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)


def run(extra, depth=False):
    """Both engines over the 8 frames with PARAMS + extra; depth feeds the
    ray-cast depth as the right image (SensorStrategy 1).  Returns a dict:
    the sequence, both engines' outputs and Systems, and the bidirectional
    flag of every K1 pyramid call the port's step made (k1_calls)."""
    seq = cached_textured_sequence(n_frames=N_FRAMES, width=160, height=120,
                                   motion="square", seed=0, speed=2.0,
                                   with_depth=depth)
    right = seq.depth if depth else seq.right
    p = dict(PARAMS, **extra)
    ref = JSystem(p)
    ref.lk_params = ref.lk_params._replace(backend="pallas")
    init(ref, seq.camera)
    ref_outs = ref.run_sequence(seq.stamps, seq.left, right)
    port = System(p, device="cpu")
    init(port, seq.camera)
    k1_calls, k1_fn = [], tlk.lk_pyramid

    def k1_counted(*a, **kw):
        k1_calls.append(kw["bidirectional"])
        return k1_fn(*a, **kw)

    tlk.lk_pyramid = k1_counted
    try:
        port_outs = port.run_sequence(seq.stamps, seq.left, right)
    finally:
        tlk.lk_pyramid = k1_fn
    return dict(seq=seq, ref_outs=ref_outs, port_outs=port_outs, ref=ref,
                port=port, k1_calls=k1_calls)


def yaw(T):
    return float(np.arctan2(T[1, 0], T[0, 0]))


def check_frame(ref_out, port_out, frame):
    """The port's frame against the reference's: finite pose, translation
    within TOL_T, yaw within TOL_YAW, identical inliers and lost flags."""
    pa, pb = np.asarray(ref_out.pose), np.asarray(port_out.pose)
    assert pb.shape == (4, 4) and np.all(np.isfinite(pb))
    dt = float(np.abs(pb[:3, 3] - pa[:3, 3]).max())
    assert dt <= TOL_T, (frame, dt)
    assert abs(yaw(pb) - yaw(pa)) <= TOL_YAW, frame
    assert int(port_out.n_inliers) == int(ref_out.n_inliers), frame
    assert bool(port_out.lost) == bool(ref_out.lost), frame
    assert bool(port_out.lost) == (frame == 0)  # only the bootstrap frame
