"""Card-only tests of visfs_tpu_torch: the CUDA kernel against its plain
PyTorch version, and the step on "cuda" against the step on "cpu".

This file imports no JAX (the card's machine has none).  Each test skips
without a GPU.  On the card, run it without the JAX conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda

Tolerances: K1 flow 0.05 px, ok identical, min_eig rtol 1e-3 (the repo's
LK tolerances, tests/test_lk_pallas.py); the step per frame translation
1e-3 m, yaw 1e-3 rad, inliers within 1, identical lost flags."""

import numpy as np
import pytest
import torch

from visfs_tpu_torch.io.sim import generate_textured_sequence
from visfs_tpu_torch.ops.kernels import lk_level as k1
from visfs_tpu_torch.ops.lk import LKParams, build_lk_pyramid
from visfs_tpu_torch.slam.system import System

pytestmark = pytest.mark.cuda


def _require_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.fixture(scope="module")
def seq():
    return generate_textured_sequence(n_frames=6, width=160, height=120,
                                      seed=0, speed=2.0)


@pytest.mark.parametrize("level", [0, 2])
def test_k1_cuda_kernel_matches_plain_version(seq, level):
    _require_gpu()
    p = LKParams()
    pyr0 = build_lk_pyramid(torch.from_numpy(seq.left[0]).cuda(), p)
    pyr1 = build_lk_pyramid(torch.from_numpy(seq.left[1]).cuda(), p)
    rng = np.random.default_rng(level)
    n = 64
    pts = torch.from_numpy(rng.uniform(10, [150, 110], (n, 2)).astype(
        np.float32)).cuda() / 2.0 ** level + pyr0.pad
    flow = torch.from_numpy(rng.normal(0, 1, (n, 2)).astype(
        np.float32)).cuda()
    active = torch.from_numpy((rng.uniform(size=n) > 0.2).astype(
        np.float32)).cuda()
    args = (pyr0.levels[level], pyr1.levels[level], pyr0.gx[level],
            pyr0.gy[level], pts.contiguous(), flow, active)
    kw = dict(win=p.win_size, iterations=p.iterations, eps=p.eps,
              min_eig_threshold=p.min_eig_threshold)
    before = k1.LAUNCHES
    fk, okk, ek = k1.lk_level(*args, **kw)
    fp, okp, ep = k1.lk_level_reference(*args, **kw)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    np.testing.assert_allclose(fk.cpu().numpy(), fp.cpu().numpy(), atol=0.05)
    np.testing.assert_array_equal(okk.cpu().numpy(), okp.cpu().numpy())
    np.testing.assert_allclose(ek.cpu().numpy(), ep.cpu().numpy(), rtol=1e-3,
                               atol=1e-6)
    inactive = active.cpu().numpy() == 0
    np.testing.assert_array_equal(fk.cpu().numpy()[inactive],
                                  flow.cpu().numpy()[inactive])


def test_step_on_cuda_matches_cpu(seq):
    _require_gpu()
    params = {"Tracker/MaxFeatures": 40, "Tracker/MinDistance": 12,
              "Tracker/QualityLevel": 0.05, "Optimizer/Iterations": 20,
              "Estimator/Force3DoF": True}
    cam = seq.camera
    outs = {}
    for dev in ("cuda", "cpu"):
        s = System(params, device=dev)
        s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(cam.baseline), width=cam.width, height=cam.height)
        outs[dev] = s.run_sequence(seq.stamps, seq.left, seq.right)
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(a.pose[:3, 3], b.pose[:3, 3], atol=1e-3)
        yaw = [np.arctan2(o.pose[1, 0], o.pose[0, 0]) for o in (a, b)]
        assert abs(yaw[0] - yaw[1]) <= 1e-3
        assert abs(int(a.n_inliers) - int(b.n_inliers)) <= 1
        assert bool(a.lost) == bool(b.lost)
