"""visfs_tpu_torch's jnp LK level (direct and correlation-form iteration)
and K2 (the xcorr loop kernel) against visfs_tpu on the same numpy-seeded
inputs.

Tolerances: a level against the reference's same formulation flow atol
2e-3 px, ok equal, min_eig rtol 1e-4 (tests/test_lk_pallas.py's
same-formulation tolerance); correlation maps rtol 1e-5 and atol 1e-6 of
the map's largest entry (only the order of summation differs: each entry
is a 441-term sum whose terms reach ~1e6, so an entry near zero carries a
few float32 ulps of that scale, ~0.2, under any reordering); K2's plain
version against the Pallas kernel in interpret mode flow atol 2e-3 px,
inactive features bit-equal; the port's xcorr against its own direct
within 0.02 px (tests/test_lk_pallas.py:99-100); pyramidal LK status
equal, points atol 0.01 px.  The CUDA kernel itself runs only on a card:
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from visfs_tpu.ops import lk as jlk
from visfs_tpu.ops.pallas.lk_xcorr import lk_xcorr_iterate as jxcorr
from visfs_tpu_torch.ops import image as tim
from visfs_tpu_torch.ops import lk as tlk
from visfs_tpu_torch.ops.kernels import lk_xcorr as k2

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

ITERATIONS = 30


def texture(h, w, seed=0):
    """Blurred 8x8-block random texture in [0, 255] (numpy; blurred by the
    port, so making inputs compiles no XLA program)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, size=(h // 8 + 1, w // 8 + 1)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), dtype=np.float32))[:h, :w]
    return tim.gaussian5(torch.from_numpy(img)).numpy()


# Level cases: window 11 and 21; "clamp" starts 14 px off so the +-10 px
# search region clamps the offsets; "small_plane" is a plane smaller than
# the search region (level 3 of 160x120), whose outside rows read 0.
CASES = ("win11", "win21", "clamp", "small_plane")
MODES = {  # port iter_mode, reference backend
    "direct": ("direct", "jnp"),
    "jnp-xcorr": ("xcorr", "jnp-xcorr"),
    "pallas-xcorr": ("xcorr", "pallas-xcorr"),
}


def _level_case(case):
    win = 21 if case in ("win21", "small_plane") else 11
    h, w, n = (15, 20, 6) if case == "small_plane" else (120, 160, 16)
    pad = win // 2 + 2
    img0 = texture(h, w, seed=5)
    img1 = np.roll(np.roll(img0, 2, axis=0), 3, axis=1)
    imf = np.pad(img0, pad, mode="edge")
    imt = np.pad(img1, pad, mode="edge")
    gx, gy = (g.numpy() for g in tim.scharr_gradients(torch.from_numpy(imf)))
    rng = np.random.default_rng(3)
    pts = (rng.uniform(0, 1, (n, 2)) * [w - 1, h - 1]).astype(np.float32) \
        + pad
    flow = np.zeros((n, 2), np.float32)
    if case == "clamp":
        flow[:] = [-14.0, 1.0]
    active = np.ones(n, bool)
    active[1] = False
    return win, (imf, imt, gx, gy, pts, flow, active)


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port_params(win, mode, backend="jnp"):
    return tlk.LKParams(win_size=win, iterations=ITERATIONS,
                        iter_mode=MODES[mode][0], backend=backend)


def _k2_inputs():
    """K2's arguments from the port's real win-21 level setup, with an
    inactive feature carrying a nonzero flow and a feature started at its
    solution (it freezes after one step)."""
    win, arrays = _level_case("win21")
    t = _t(arrays)
    flow = t[5].clone()
    flow[1] = torch.tensor([1.5, -0.5])
    flow[2] = torch.tensor([3.0, 2.0])
    params = _port_params(win, "jnp-xcorr")
    s = tlk.level_setup(*t[:5], flow, params)
    args, kw = tlk.xcorr_inputs(s, t[4], flow, t[6], params)
    return args, kw


@pytest.fixture(scope="module")
def refs():
    """Every reference output of the level tests, from one jitted program."""
    cases = {c: _level_case(c) for c in CASES}
    k2_args, k2_kw = _k2_inputs()
    s = tlk.level_setup(*_t(cases["win21"][1][:6]),
                        _port_params(21, "direct"))
    maps_in = [x.numpy() for x in (s.region, s.gx, s.gy)]

    def run(arrs, k2a, maps):
        out = {}
        for case, (win, _) in cases.items():
            for mode, (it, backend) in MODES.items():
                p = jlk.LKParams(win_size=win, iterations=ITERATIONS,
                                 iter_mode=it, backend=backend)
                out[f"{case}/{mode}"] = jlk._track_level(*arrs[case], p)
        out["maps"] = jlk._xcorr_maps(*maps, 21)
        out["k2"] = jxcorr(*k2a, **k2_kw, interpret=True)
        return out

    arrs = {c: a for c, (_, a) in cases.items()}
    return jax.device_get(jax.jit(run)(
        arrs, [a.numpy() for a in k2_args], maps_in)), maps_in


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", CASES)
def test_track_level_matches_reference(refs, case, mode):
    win, arrays = _level_case(case)
    port = tlk._track_level(*_t(arrays), _port_params(win, mode))
    flow_r, ok_r, eig_r = (np.asarray(r) for r in refs[0][f"{case}/{mode}"])
    flow_p, ok_p, eig_p = (p.numpy() for p in port)
    np.testing.assert_allclose(flow_p, flow_r, atol=2e-3)
    np.testing.assert_array_equal(ok_p, ok_r)
    np.testing.assert_allclose(eig_p, eig_r, rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(flow_p[1], arrays[5][1])  # inactive
    if case in ("win11", "win21"):  # the known shift, bar wrapped borders
        np.testing.assert_allclose(np.median(flow_p[ok_p], axis=0),
                                   [3.0, 2.0], atol=0.05)


@pytest.mark.parametrize("case", CASES)
def test_xcorr_matches_direct(case):
    win, arrays = _level_case(case)
    direct = tlk._track_level(*_t(arrays), _port_params(win, "direct"))
    xcorr = tlk._track_level(*_t(arrays), _port_params(win, "jnp-xcorr"))
    np.testing.assert_allclose(xcorr[0].numpy(), direct[0].numpy(),
                               atol=0.02)
    np.testing.assert_array_equal(xcorr[1].numpy(), direct[1].numpy())


def test_xcorr_backends_are_one_function():
    """The reference's three xcorr backends are TPU lowerings of one loop;
    in the port all three run K2 (its plain version on the CPU)."""
    win, arrays = _level_case("win11")
    outs = [tlk._track_level(*_t(arrays), dataclasses.replace(
        _port_params(win, "jnp-xcorr"), backend=b))
        for b in ("jnp", "jnp-xcorr", "pallas-xcorr")]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a, b)


def test_xcorr_maps_match_reference(refs):
    ref, maps_in = refs
    c1, c2 = tlk._xcorr_maps(*(torch.from_numpy(m) for m in maps_in), 21)
    assert c1.shape == c2.shape == (16, 22, 22)
    for p, r in zip((c1, c2), ref["maps"]):
        r = np.asarray(r)
        np.testing.assert_allclose(p.numpy(), r, rtol=1e-5,
                                   atol=1e-6 * np.abs(r).max())


def test_k2_plain_matches_pallas_interpret(refs):
    args, kw = _k2_inputs()
    flow = k2.lk_xcorr_iterate(*args, **kw)
    _, steps = k2.xcorr_steps(*args, **kw)
    ref = np.asarray(refs[0]["k2"])
    np.testing.assert_allclose(flow.numpy(), ref, atol=2e-3)
    flow_in, active = args[9].numpy(), args[10].numpy()
    assert not active[1] and steps[1] == 0
    np.testing.assert_array_equal(flow.numpy()[~active], flow_in[~active])
    np.testing.assert_array_equal(ref[~active], flow_in[~active])
    assert 1 <= int(steps[2]) <= 2  # started at the solution: frozen early
    assert int(steps.max()) <= ITERATIONS


def test_k2_wrapper_counts_no_cpu_launch_and_checks_inputs():
    args, kw = _k2_inputs()
    before = k2.LAUNCHES
    k2.lk_xcorr_iterate(*args, **kw)
    assert k2.LAUNCHES == before  # the CPU path is the plain version
    with pytest.raises(TypeError):
        k2.lk_xcorr_iterate(args[0].double(), *args[1:], **kw)
    with pytest.raises(TypeError):
        k2.lk_xcorr_iterate(*args[:10], args[10].float(), **kw)
    with pytest.raises(ValueError):
        k2.lk_xcorr_iterate(args[0], args[1][:-1], *args[2:], **kw)
    with pytest.raises(ValueError):
        k2.lk_xcorr_iterate(args[0].transpose(1, 2), *args[1:], **kw)
    with pytest.raises(ValueError):
        k2.lk_xcorr_iterate(*args, **{**kw, "max_off": 22.0})


def test_k2_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the raise is for CUDA-less hosts")
    args, kw = _k2_inputs()
    with pytest.raises(RuntimeError, match="CUDA"):
        k2.lk_xcorr_iterate_cuda(*args, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        k2.build()


def test_lk_params_backend_and_iter_mode():
    from visfs_tpu_torch.config import config_from_parameters

    for backend in tlk.BACKENDS:
        for mode in tlk.ITER_MODES:
            p = tlk.LKParams(backend=backend, iter_mode=mode)
            assert (p.backend, p.iter_mode) == (backend, mode)
    ref = jlk.LKParams()
    assert (tlk.LKParams().backend, tlk.LKParams().iter_mode) == (
        ref.backend, ref.iter_mode)
    with pytest.raises(ValueError, match="backend"):
        tlk.LKParams(backend="xla")
    with pytest.raises(ValueError, match="iter_mode"):
        tlk.LKParams(iter_mode="fused")
    assert tlk.LKParams.from_config(config_from_parameters()).backend \
        == "pallas"


# --- pyramidal LK over the jnp level ----------------------------------------

@pytest.fixture(scope="module")
def pyr_runs():
    img0 = texture(120, 160, seed=9)
    rng = np.random.default_rng(4)
    img1 = np.roll(np.roll(img0, 3, axis=0), -4, axis=1) \
        + rng.normal(0, 1.0, img0.shape).astype(np.float32)
    pts = rng.uniform(8, 150, size=(24, 2)).astype(np.float32)
    pts[:, 1] = np.clip(pts[:, 1], 8, 110)
    init = pts + np.array([-3.0, 2.0], np.float32)
    valid = np.ones(24, bool)
    valid[::5] = False
    arrays = (img0, img1, pts, init, valid)
    jparams = {"direct": jlk.LKParams(),
               "xcorr": jlk.LKParams(iter_mode="xcorr",
                                     backend="jnp-xcorr")}

    def run(a, b, p, i, v):
        out = {}
        for mode, jp in jparams.items():
            pa, pb = jlk.build_lk_pyramid(a, jp), jlk.build_lk_pyramid(b, jp)
            out[f"bidir_pyr/{mode}"] = jlk.lk_track_bidirectional_pyr(
                pa, pb, p, i, v, jp, fb_threshold=1.5)
            out[f"track/{mode}"] = jlk.lk_track(a, b, p, i, v, params=jp)
            out[f"bidir/{mode}"] = jlk.lk_track_bidirectional(
                a, b, p, i, v, params=jp, fb_threshold=1.5)
        return out

    ref = jax.device_get(jax.jit(run)(*arrays))
    port = {}
    t = _t(arrays)
    for mode in jparams:
        tp = tlk.LKParams(iter_mode=mode)
        port[f"bidir_pyr/{mode}"] = tlk.lk_track_bidirectional_pyr(
            tlk.build_lk_pyramid(t[0], tp), tlk.build_lk_pyramid(t[1], tp),
            *t[2:], tp, fb_threshold=1.5)
        port[f"track/{mode}"] = tlk.lk_track(*t, params=tp)
        port[f"bidir/{mode}"] = tlk.lk_track_bidirectional(
            *t, params=tp, fb_threshold=1.5)
    return ref, port


@pytest.mark.parametrize("fn", ["bidir_pyr", "track", "bidir"])
@pytest.mark.parametrize("mode", ["direct", "xcorr"])
def test_pyramidal_lk_matches_reference(pyr_runs, fn, mode):
    ref, port = (r[f"{fn}/{mode}"] for r in pyr_runs)
    np.testing.assert_array_equal(port.status.numpy(), np.asarray(ref.status))
    assert port.status.sum() >= 12
    np.testing.assert_allclose(port.points.numpy(), np.asarray(ref.points),
                               atol=0.01)
    np.testing.assert_allclose(port.err.numpy(), np.asarray(ref.err),
                               rtol=1e-4, atol=1e-7)
