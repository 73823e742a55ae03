"""Tracker/CullByFundationMatrix: visfs_tpu_torch's System against
visfs_tpu's over the reference's 8 frames at 160x120 with FlowBack off and
the fundamental-matrix RANSAC cull on its samples from the tracker's key
(tests/torch_mode_slice.py: per frame translation and yaw within 3e-5,
identical inliers and lost flags), and
tests/test_fundamental.py::test_e2e_with_fundamental_culling through the
port: no lost frame and ATE < 0.02 m over 8 starfield frames."""

import numpy as np
import pytest
import torch

import torch_mode_slice as ms
from visfs_tpu_torch.io.sim import ate_rmse, generate_sequence
from visfs_tpu_torch.slam import tracker as ttrk
from visfs_tpu_torch.slam.system import System

torch.set_num_threads(1)

CULL = {"Tracker/FlowBack": False, "Tracker/CullByFundationMatrix": True,
        "Tracker/FundationPixelError": 2.0}


@pytest.fixture(scope="module")
def pair():
    calls = []
    cull = ttrk.cull_with_fundamental

    def counted(p1, p2, mask, key, threshold, **kw):
        calls.append((key.clone(), threshold))
        return cull(p1, p2, mask, key, threshold=threshold, **kw)

    ttrk.cull_with_fundamental = counted
    try:
        out = ms.run(CULL)
    finally:
        ttrk.cull_with_fundamental = cull
    out["cull_calls"] = calls
    return out


@pytest.mark.parametrize("frame", range(ms.N_FRAMES))
def test_cull_frame_matches_reference(pair, frame):
    ms.check_frame(pair["ref_outs"][frame], pair["port_outs"][frame], frame)


def test_cull_runs_on_the_one_way_track(pair):
    # FlowBack off: both tracks one-way, the cull once a frame on the
    # temporal one, with the tracker's key (the third of the split) and
    # the configured pixel error
    from visfs_tpu_torch.core import prng

    assert pair["k1_calls"] == [False, False] * ms.N_FRAMES
    calls = pair["cull_calls"]
    assert len(calls) == ms.N_FRAMES
    assert all(thr == 2.0 for _, thr in calls)
    key = prng.PRNGKey(0)
    for k, _ in calls:
        key, _, trk_key = prng.split(key, 3)
        assert torch.equal(k, trk_key)


def test_e2e_with_fundamental_culling():
    """tests/test_fundamental.py::test_e2e_with_fundamental_culling through
    the port."""
    seq = generate_sequence(n_frames=8, n_points=400, seed=51,
                            motion="forward", device="cpu")
    s = System({"Tracker/MaxFeatures": 150, "Tracker/MinDistance": 16,
                **CULL}, device="cpu")
    ms.init(s, seq.camera)
    outs = s.run_sequence(seq.stamps, seq.left, seq.right)
    assert not any(bool(o.lost) for o in outs[1:])
    assert ate_rmse(np.stack([o.pose for o in outs]), seq.poses) < 0.02

