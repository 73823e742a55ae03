"""visfs_tpu_torch image ops, K1 (the LK level kernel) and pyramidal LK
against visfs_tpu on the same numpy-seeded inputs.

Tolerances: image ops atol 1e-3 on the 0-255 scale (the reference's
banded-matmul pyrDown sums in another order); K1's plain version against
the Pallas kernel (interpret mode) flow atol 2e-3 px, ok equal, min_eig
rtol 1e-4 — the same-formulation tolerance of tests/test_lk_pallas.py;
bidirectional pyramidal LK: status equal, points atol 0.01 px.
The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.ops import image as jim
from visfs_tpu.ops import lk as jlk
from visfs_tpu.ops.pallas.lk_kernel import lk_level_pallas
from visfs_tpu_torch.ops import image as tim
from visfs_tpu_torch.ops import lk as tlk
from visfs_tpu_torch.ops.kernels import lk_level as k1

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)


def texture(h, w, seed=0):
    """Blurred 8x8-block random texture in [0, 255] (numpy)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, size=(h // 8 + 1, w // 8 + 1)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), dtype=np.float32))[:h, :w]
    return np.array(jim.gaussian5(jnp.asarray(img)))  # writable, for torch


IMG = np.random.default_rng(11).uniform(0, 255, (120, 160)).astype(np.float32)
IMG_OPS = {
    "gaussian5": (jim.gaussian5, tim.gaussian5),
    "pyr_down": (jim.pyr_down, tim.pyr_down),
    "pyr_down_odd": (lambda x: jim.pyr_down(x[:, :-3]),
                     lambda x: tim.pyr_down(x[:, :-3])),
    "scharr_x": (lambda x: jim.scharr_gradients(x)[0],
                 lambda x: tim.scharr_gradients(x)[0]),
    "scharr_y": (lambda x: jim.scharr_gradients(x)[1],
                 lambda x: tim.scharr_gradients(x)[1]),
    "sobel_x": (lambda x: jim.sobel_gradients(x)[0],
                lambda x: tim.sobel_gradients(x)[0]),
    "sobel_y": (lambda x: jim.sobel_gradients(x)[1],
                lambda x: tim.sobel_gradients(x)[1]),
    "box3": (lambda x: jim.box_filter(x, 3), lambda x: tim.box_filter(x, 3)),
    "edge_pad": (lambda x: jnp.pad(x, 12, mode="edge"),
                 lambda x: tim.edge_pad(x, 12)),
}


@pytest.fixture(scope="module")
def image_refs():
    return jax.jit(lambda x: {k: f(x) for k, (f, _) in IMG_OPS.items()})(IMG)


@pytest.mark.parametrize("name", sorted(IMG_OPS))
def test_image_op_matches_reference(image_refs, name):
    port = IMG_OPS[name][1](torch.from_numpy(IMG)).numpy()
    ref = np.asarray(image_refs[name])
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=1e-3, err_msg=name)


def test_lk_pyramid_matches_reference():
    params = jlk.LKParams()
    ref = jax.jit(lambda x: jlk.build_lk_pyramid(x, params))(IMG)
    port = tlk.build_lk_pyramid(torch.from_numpy(IMG), tlk.LKParams())
    assert tlk.lk_pad(tlk.LKParams()) == jlk.lk_pad(params) == port.pad
    for name in ("levels", "gx", "gy"):
        for r, p in zip(getattr(ref, name), getattr(port, name)):
            assert p.shape == r.shape
            np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-3)


# --- K1: the plain version against lk_level_pallas (interpret mode) -------

def _level_inputs(case):
    win = 11 if case != "win21" else 21
    pad = win // 2 + 2
    img0 = texture(120, 160, seed=5)
    img1 = np.roll(np.roll(img0, 2, axis=0), 3, axis=1)
    imf = np.pad(img0, pad, mode="edge")
    imt = np.pad(img1, pad, mode="edge")
    gx, gy = (np.asarray(g) for g in jim.scharr_gradients(jnp.asarray(imf)))
    pts = np.array([[40.0, 30.0], [80.0, 60.0], [120.0, 90.0],
                    [60.0, 100.0]], np.float32) + pad
    flow = np.zeros((4, 2), np.float32)
    active = np.ones(4, np.float32)
    if case == "inactive":
        flow = np.array([[1.5, -0.5], [0.3, 0.2], [0, 0], [0, 0]], np.float32)
        active = np.array([0.0, 1.0, 0.0, 1.0], np.float32)
    if case == "border":
        # within 1.5 px of the image edge, windows in the replicated pad;
        # the `to` image is the `from` image (np.roll would wrap the edge)
        # and the flow starts off by under a pixel
        imt = imf
        pts = np.array([[1.5, 1.0], [158.0, 60.0], [80.0, 118.5],
                        [158.5, 1.2]], np.float32) + pad
        flow = np.array([[0.6, -0.4], [-0.5, 0.3], [0.2, 0.7],
                         [-0.6, -0.5]], np.float32)
    if case == "clipped":
        # window corners beyond the padded plane on every side: the integer
        # corner is clipped, the bilinear weights keep the unclipped
        # fraction (one step, so the comparison is not of a divergence)
        pts = np.array([[1.3, 2.6], [imf.shape[1] - 2.5, 30.0],
                        [50.0, imf.shape[0] - 1.2], [0.3, 0.7]], np.float32)
        flow = np.array([[-3.2, 1.0], [4.0, 0.5], [0.0, 5.0], [-1.0, -1.0]],
                        np.float32)
    return win, (imf, imt, gx, gy, pts, flow, active)


@pytest.mark.parametrize("case", ["shift", "inactive", "border", "clipped",
                                  "win21"])
def test_k1_plain_matches_pallas(case):
    win, arrays = _level_inputs(case)
    kw = dict(win=win, iterations=1 if case == "clipped" else 20, eps=0.01,
              min_eig_threshold=1e-4)
    ref = lk_level_pallas(*(jnp.asarray(a) for a in arrays), **kw,
                          interpret=True)
    port = k1.lk_level(*(torch.from_numpy(np.array(a)) for a in arrays),
                       **kw)
    flow_r, ok_r, eig_r = (np.asarray(r) for r in ref)
    flow_p, ok_p, eig_p = (p.numpy() for p in port)
    np.testing.assert_allclose(flow_p, flow_r, atol=2e-3)
    np.testing.assert_array_equal(ok_p, ok_r)
    np.testing.assert_allclose(eig_p, eig_r, rtol=1e-4, atol=1e-7)
    if case == "shift":
        np.testing.assert_allclose(flow_p[:, 0], 3.0, atol=0.3)
        np.testing.assert_allclose(flow_p[:, 1], 2.0, atol=0.3)
    if case == "inactive":
        np.testing.assert_array_equal(flow_p[[0, 2]], arrays[5][[0, 2]])


def test_k1_wrapper_counts_no_cpu_launch_and_checks_inputs():
    _, arrays = _level_inputs("shift")
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    kw = dict(win=11, iterations=5, eps=0.01, min_eig_threshold=1e-4)
    before = k1.LAUNCHES
    k1.lk_level(*t, **kw)
    assert k1.LAUNCHES == before  # the CPU path is the plain version
    with pytest.raises(TypeError):
        k1.lk_level(t[0].double(), *t[1:], **kw)
    with pytest.raises(ValueError):
        k1.lk_level(t[0], t[1][:-1], *t[2:], **kw)
    with pytest.raises(ValueError):
        k1.lk_level(t[0].t(), *t[1:], **kw)
    with pytest.raises(ValueError):
        k1.lk_level(*t[:4], t[4][:2], *t[5:], **kw)


def test_k1_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the raise is for CUDA-less hosts")
    _, arrays = _level_inputs("shift")
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    with pytest.raises(RuntimeError, match="CUDA"):
        k1.lk_level_cuda(*t, win=11, iterations=5, eps=0.01,
                         min_eig_threshold=1e-4)
    with pytest.raises(RuntimeError, match="CUDA"):
        k1.build()


# --- pyramidal bidirectional LK against the reference's Pallas backend ----

@pytest.fixture(scope="module")
def bidir():
    img0 = texture(120, 160, seed=9)
    rng = np.random.default_rng(4)
    img1 = np.roll(np.roll(img0, 3, axis=0), -4, axis=1) \
        + rng.normal(0, 1.0, img0.shape).astype(np.float32)
    pts = rng.uniform(8, 150, size=(24, 2)).astype(np.float32)
    pts[:, 1] = np.clip(pts[:, 1], 8, 110)
    init = pts + np.array([-3.0, 2.0], np.float32)
    valid = np.ones(24, bool)
    valid[::5] = False
    jp = jlk.LKParams(backend="pallas")

    def run(a, b, p, i, v):
        return jlk.lk_track_bidirectional_pyr(
            jlk.build_lk_pyramid(a, jp), jlk.build_lk_pyramid(b, jp), p, i, v,
            jp, fb_threshold=1.5)

    ref = jax.jit(run)(img0, img1, pts, init, valid)
    tp = tlk.LKParams()
    port = tlk.lk_track_bidirectional_pyr(
        tlk.build_lk_pyramid(torch.from_numpy(img0), tp),
        tlk.build_lk_pyramid(torch.from_numpy(img1), tp),
        torch.from_numpy(pts), torch.from_numpy(init), torch.from_numpy(valid),
        tp, fb_threshold=1.5)
    return ref, port


def test_lk_bidirectional_status_matches(bidir):
    ref, port = bidir
    np.testing.assert_array_equal(port.status.numpy(), np.asarray(ref.status))
    assert port.status.sum() >= 12


def test_lk_bidirectional_points_match(bidir):
    ref, port = bidir
    np.testing.assert_allclose(port.points.numpy(), np.asarray(ref.points),
                               atol=0.01)
    np.testing.assert_allclose(port.err.numpy(), np.asarray(ref.err),
                               rtol=1e-3, atol=1e-6)


def test_lk_params_from_config():
    from visfs_tpu.config import config_from_parameters

    cfg = config_from_parameters({"Tracker/FlowRegionExtract": "gather",
                                  "Tracker/FlowUnroll": 7,
                                  "Tracker/FlowWinSize": 15})
    p = tlk.LKParams.from_config(cfg)
    assert (p.win_size, p.max_level, p.iterations) == (15, 3, 30)
    with pytest.raises(ValueError, match="float32"):
        tlk.LKParams.from_config(config_from_parameters(
            {"Tracker/FlowComputeDtype": "bfloat16"}))
