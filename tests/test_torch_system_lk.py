"""The slice through the jnp LK level: visfs_tpu_torch's System against
visfs_tpu's at the reference System's own LK configuration (the direct
iteration, LKParams() with no replacement) and in correlation form
(iter_mode="xcorr", whose tracks are each one call of K2's pyramid entry in
the port).

Both engines get the same 8 frames at 160x120 with tests/test_torch_system.py's
parameters and tolerances: per frame translation 1e-3 m, yaw 1e-3 rad,
n_inliers within 1, identical lost flags.  Also here: the port imports
neither JAX nor any visfs_tpu module, and its configuration registry equals
the reference's key by key."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from visfs_tpu.io.sim import cached_textured_sequence
from visfs_tpu.slam.system import System as JSystem
from visfs_tpu_torch.ops import lk as tlk
from visfs_tpu_torch.slam.system import System

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

N_FRAMES = 8
PARAMS = {
    "Tracker/MaxFeatures": 40,
    "Tracker/MinDistance": 12,
    "Tracker/QualityLevel": 0.05,
    "LocalMap/MapSize": 5,
    "Optimizer/Iterations": 20,
    "Estimator/Force3DoF": True,
    "Estimator/ToleranceTranslation": 0.40,
}
# mode -> (reference LKParams replacement, port LKParams replacement)
MODES = {
    "direct": ({}, dict(backend="jnp")),
    "xcorr": (dict(iter_mode="xcorr", backend="jnp-xcorr"),
              dict(backend="jnp", iter_mode="xcorr")),
}


def _init(s, cam):
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)


@pytest.fixture(scope="module", params=sorted(MODES))
def lk_slice(request):
    mode = request.param
    ref_kw, port_kw = MODES[mode]
    seq = cached_textured_sequence(n_frames=N_FRAMES, width=160, height=120,
                                   motion="square", seed=0, speed=2.0)
    ref = JSystem(PARAMS)
    if ref_kw:
        ref.lk_params = ref.lk_params._replace(**ref_kw)
    _init(ref, seq.camera)
    ref_outs = ref.run_sequence(seq.stamps, seq.left, seq.right)

    port = System(PARAMS, device="cpu")
    port.lk_params = dataclasses.replace(port.lk_params, **port_kw)
    _init(port, seq.camera)
    # count the K1 track calls (lk_pyramid), K2 track calls
    # (lk_xcorr_pyramid) and K2 level calls (lk_xcorr_iterate) the port's
    # step makes
    names = {"k1": "lk_pyramid", "k2_pyr": "lk_xcorr_pyramid",
             "k2": "lk_xcorr_iterate"}
    calls = dict.fromkeys(names, 0)
    fns = {key: getattr(tlk, name) for key, name in names.items()}

    def counted(key):
        def call(*a, **kw):
            calls[key] += 1
            return fns[key](*a, **kw)
        return call

    for key, name in names.items():
        setattr(tlk, name, counted(key))
    try:
        port_outs = port.run_sequence(seq.stamps, seq.left, seq.right)
    finally:
        for key, name in names.items():
            setattr(tlk, name, fns[key])
    return dict(mode=mode, seq=seq, ref_outs=ref_outs, port_outs=port_outs,
                calls=calls)


def _yaw(T):
    return np.arctan2(T[1, 0], T[0, 0])


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_lk_slice_frame_matches_reference(lk_slice, frame):
    a = lk_slice["ref_outs"][frame]
    b = lk_slice["port_outs"][frame]
    pa, pb = np.asarray(a.pose), b.pose
    assert pb.shape == (4, 4) and np.all(np.isfinite(pb))
    np.testing.assert_allclose(pb[:3, 3], pa[:3, 3], atol=1e-3)
    assert abs(_yaw(pb) - _yaw(pa)) <= 1e-3
    assert abs(int(b.n_inliers) - int(a.n_inliers)) <= 1
    assert bool(b.lost) == bool(a.lost)
    assert bool(b.lost) == (frame == 0)  # only the bootstrap frame


def test_lk_slice_ate_and_level_calls(lk_slice):
    from visfs_tpu_torch.io.sim import ate_rmse

    gt = lk_slice["seq"].poses
    ate = ate_rmse(np.stack([o.pose for o in lk_slice["port_outs"]]), gt)
    ref = ate_rmse(np.stack([np.asarray(o.pose)
                             for o in lk_slice["ref_outs"]]), gt)
    assert ate < 0.1
    assert abs(ate - ref) < 1e-3
    # every frame runs 2 LK tracks, the temporal and the stereo one, each
    # bidirectional (the step has no branch on data, so frame 0 runs its
    # masked temporal track too); at xcorr each is one call of K2's pyramid
    # entry (4 levels x 2 directions), the direct loop calls neither K2
    # entry; K1 never runs
    assert lk_slice["calls"]["k1"] == 0
    assert lk_slice["calls"]["k2"] == 0
    assert lk_slice["calls"]["k2_pyr"] == (
        2 * N_FRAMES if lk_slice["mode"] == "xcorr" else 0)


# --- the port stands alone --------------------------------------------------

def test_port_imports_neither_jax_nor_visfs_tpu():
    code = ("import sys\n"
            "import visfs_tpu_torch.slam.system, visfs_tpu_torch.io.sim\n"
            "import visfs_tpu_torch.ops.lk, visfs_tpu_torch.config\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith('jax.') or m == 'visfs_tpu'\n"
            "             or m.startswith('visfs_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_config_registry_equals_reference():
    from visfs_tpu import config as jc
    from visfs_tpu_torch import config as tc

    assert tc._REGISTRY == jc._REGISTRY
    assert tc.DEFAULT_PARAMETERS == jc.DEFAULT_PARAMETERS
    assert tc.PARAMETER_TYPES == jc.PARAMETER_TYPES
    assert tc.PARAMETER_DESCRIPTIONS == jc.PARAMETER_DESCRIPTIONS
    t_fields = [(f.name, f.type, f.default)
                for f in dataclasses.fields(tc.VISFSConfig)]
    j_fields = [(f.name, f.type, f.default)
                for f in dataclasses.fields(jc.VISFSConfig)]
    assert t_fields == j_fields
    assert tc.VISFSConfig._KEY_BY_FIELD == jc.VISFSConfig._KEY_BY_FIELD
    over = {"Tracker/MaxFeatures": "120", "Estimator/MinInliers": 3,
            "Estimator/Force3DoF": "true", "Tracker/FlowEps": "0.02"}
    t_cfg, j_cfg = tc.config_from_parameters(over), \
        jc.config_from_parameters(over)
    assert tc.config_to_parameters(t_cfg) == jc.config_to_parameters(j_cfg)
    assert t_cfg.estimator_min_inliers == 8  # the ROS layer's floor
    for key in ("Tracker/MaxFeatures", "Estimator/Force3DoF",
                "System/LogFolder"):
        assert tc.parse_value(key, "1") == jc.parse_value(key, "1")
    with pytest.raises(KeyError):
        tc.config_from_parameters({"Tracker/NoSuchKey": 1})
