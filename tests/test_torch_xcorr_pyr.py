"""K2's pyramid entry (``lk_xcorr_pyramid``: every level of a pyramidal LK
track in correlation form — the jnp level's setup, the correlation maps and
the loop — and with ``bidirectional`` the reverse track and the gate, in one
launch on the card) on the CPU, where it runs its plain version.

* ``lk_xcorr_pyramid_reference`` is bit-equal to the composition the port
  ran before it: ``track_pyramid`` / ``track_bidirectional`` over
  ``ops.lk._track_level`` at iter_mode="xcorr" (kept here as the oracle);
  ``ops.lk.lk_track_pyr`` and ``lk_track_bidirectional_pyr`` at xcorr are
  one call of the entry.
* It agrees with the reference's ``lk_track_pyr`` and
  ``lk_track_bidirectional_pyr`` at iter_mode="xcorr", for
  backend="jnp-xcorr" (the jnp while loop) and "pallas-xcorr" (the Pallas
  loop in interpret mode): status equal, points atol 0.01 px, err rtol 1e-4
  (the pyramidal tolerances of tests/test_torch_xcorr.py).
* The inputs hold invalid features, a feature whose coarse-level window is
  flat (a 2-px checker vanishes at level 1; the forward track rejects it, so
  its reverse track is skipped), and a feature whose destination is
  occluded by another texture, so its forward track holds and its reverse
  track lands past the 1.5 px gate.  At 160x120 the coarsest level's plane
  is smaller than the ±10 px search region, whose outside rows read 0.
* The wrapper counts no launch on the CPU, rejects what the kernel does not
  take, and raises for a CUDA request without CUDA.

The kernel itself runs only on a card: tests/test_torch_cuda.py."""

import functools

import jax
import numpy as np
import pytest
import torch

from visfs_tpu.ops import lk as jlk
from visfs_tpu_torch.ops import image as tim
from visfs_tpu_torch.ops import lk as tlk
from visfs_tpu_torch.ops.kernels import lk_xcorr as k2
from visfs_tpu_torch.ops.kernels.pyramid import (track_bidirectional,
                                                track_pyramid)

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

H, W, N = 120, 160, 24
FB = 1.5
FLAT_COARSE, OCCLUDED = 0, 1  # the two constructed features
BACKENDS = ("jnp-xcorr", "pallas-xcorr")


def texture(h, w, seed=0):
    """Blurred 8x8-block random texture in [0, 255] (numpy; blurred by the
    port, so making inputs compiles no XLA program)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, size=(h // 8 + 1, w // 8 + 1)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), dtype=np.float32))[:h, :w]
    return tim.gaussian5(torch.from_numpy(img)).numpy()


def _inputs():
    img0 = texture(H, W, seed=9)
    yy, xx = np.mgrid[0:H, 0:W]
    checker = np.where((xx // 2 + yy // 2) % 2 == 0, 1.0, -1.0)
    img0[20:100, 30:110] = 128 + 40 * checker[20:100, 30:110]
    rng = np.random.default_rng(4)
    img1 = np.roll(np.roll(img0, 2, axis=0), 3, axis=1) \
        + rng.normal(0, 1.0, img0.shape).astype(np.float32)
    img1[22:38, 122:138] = texture(H, W, seed=33)[22:38, 122:138]
    pts = rng.uniform(8, 150, size=(N, 2)).astype(np.float32)
    pts[:, 1] = np.clip(pts[:, 1], 8, 110)
    pts[FLAT_COARSE] = [70.0, 60.0]  # the checker's centre
    pts[OCCLUDED] = [127.0, 28.0]  # lands in the occluder
    init = pts + np.array([3.0, 2.0], np.float32) \
        + rng.normal(0, 0.7, pts.shape).astype(np.float32)
    valid = np.ones(N, bool)
    valid[5::5] = False
    return (img0.astype(np.float32), img1.astype(np.float32), pts, init,
            valid)


def _params(win, backend="jnp"):
    return tlk.LKParams(win_size=win, backend=backend, iter_mode="xcorr")


def _kw(win):
    p = _params(win)
    return dict(win=win, max_level=p.max_level, iterations=p.iterations,
                eps=p.eps, min_eig_threshold=p.min_eig_threshold)


@pytest.fixture(scope="module", params=[11, 21], ids=["win11", "win21"])
def runs(request):
    """The reference (one jitted program per window, both xcorr backends)
    and the port's plain pyramid entry, forward ("track") and bidirectional
    ("bidir")."""
    win = request.param
    arrays = _inputs()

    def run(a, b, p, i, v):
        out = {}
        for backend in BACKENDS:
            jp = jlk.LKParams(win_size=win, iter_mode="xcorr",
                              backend=backend)
            pa, pb = jlk.build_lk_pyramid(a, jp), jlk.build_lk_pyramid(b, jp)
            out[f"{backend}/track"] = jlk.lk_track_pyr(pa, pb, p, i, v, jp)
            out[f"{backend}/bidir"] = jlk.lk_track_bidirectional_pyr(
                pa, pb, p, i, v, jp, fb_threshold=FB)
        return out

    ref = jax.device_get(jax.jit(run)(*arrays))
    tp = _params(win)
    img0, img1, pts, init, valid = (torch.from_numpy(a) for a in arrays)
    pyr0, pyr1 = tlk.build_lk_pyramid(img0, tp), tlk.build_lk_pyramid(img1, tp)
    args = (pyr0, pyr1, pts, init, valid)
    port = {fn: k2.lk_xcorr_pyramid(*args, **_kw(win),
                                    bidirectional=fn == "bidir",
                                    fb_threshold=FB)
            for fn in ("track", "bidir")}
    return dict(win=win, ref=ref, port=port, args=args)


def _oracle(args, win, bidirectional):
    """The port's xcorr track before the pyramid entry: the Python glue over
    one _track_level call per level."""
    track = functools.partial(
        track_pyramid, functools.partial(tlk._track_level,
                                         params=_params(win)),
        win=win, max_level=_params(win).max_level)
    if not bidirectional:
        return track(*args)
    return track_bidirectional(track, *args, FB)


@pytest.mark.parametrize("fn", ["track", "bidir"])
def test_plain_pyramid_bit_equal_to_level_composition(runs, fn):
    oracle = _oracle(runs["args"], runs["win"], fn == "bidir")
    for got, want in zip(runs["port"][fn], oracle):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("backend", ["jnp", "jnp-xcorr", "pallas-xcorr"])
def test_lk_track_at_xcorr_is_one_pyramid_call(runs, backend, monkeypatch):
    calls = []
    entry = tlk.lk_xcorr_pyramid

    def counted(*a, **kw):
        calls.append(kw["bidirectional"])
        return entry(*a, **kw)

    monkeypatch.setattr(tlk, "lk_xcorr_pyramid", counted)
    p = _params(runs["win"], backend)
    track = tlk.lk_track_pyr(*runs["args"], p)
    bidir = tlk.lk_track_bidirectional_pyr(*runs["args"], p,
                                           fb_threshold=FB)
    assert calls == [False, True]
    for fn, got in (("track", track), ("bidir", bidir)):
        for a, b in zip(got, runs["port"][fn]):
            assert torch.equal(a, b)
    # the direct iteration keeps the Python glue over _track_level
    tlk.lk_track_pyr(*runs["args"], tlk.LKParams(win_size=runs["win"]))
    assert calls == [False, True]


@pytest.mark.parametrize("fn", ["track", "bidir"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_plain_pyramid_matches_reference(runs, backend, fn):
    ref = runs["ref"][f"{backend}/{fn}"]
    points, status, err = runs["port"][fn]
    np.testing.assert_array_equal(status.numpy(), np.asarray(ref.status))
    assert status.sum() >= 8
    np.testing.assert_allclose(points.numpy(), np.asarray(ref.points),
                               atol=0.01)
    np.testing.assert_allclose(err.numpy(), np.asarray(ref.err), rtol=1e-4,
                               atol=1e-7)


def test_constructed_cases_are_covered(runs):
    win = runs["win"]
    pyr0, pyr1, pts, init, valid = runs["args"]
    kw = _kw(win)
    _, fwd_status, err = runs["port"]["track"]
    _, status, _ = runs["port"]["bidir"]
    assert not status[~valid].any()
    # the coarsest plane is smaller than the search region (R = win + 21)
    assert min(pyr0.levels[kw["max_level"]].shape) < win + 1 + 2 * tlk.MARGIN
    # FLAT_COARSE: ok at level 0 (its err, the level-0 min_eig, is large),
    # but a coarser level's window is flat: the forward track rejects it
    assert err[FLAT_COARSE] > 1.0 and not fwd_status[FLAT_COARSE]
    levels = []
    k2.lk_xcorr_pyramid_reference(*runs["args"], **kw, bidirectional=True,
                                  fb_threshold=FB, levels=levels)
    fwd, rev = levels[:kw["max_level"] + 1], levels[kw["max_level"] + 1:]
    assert not all(lv["setup"].ok_g[FLAT_COARSE] for lv in fwd[:-1])
    # ... so its reverse track has nothing to run (the kernel skips it)
    assert not any(lv["active"][FLAT_COARSE] for lv in rev)
    # the coarsest level runs its loop on a zero-filled region
    top = fwd[0]
    assert (top["active"] & top["setup"].ok_g).sum() >= 8
    # OCCLUDED: its forward track holds, its reverse track is tracked but
    # lands past the gate
    assert fwd_status[OCCLUDED] and not status[OCCLUDED]
    rev_points, rev_status, _ = k2.lk_xcorr_pyramid(
        pyr1, pyr0, runs["port"]["track"][0], pts, fwd_status, **kw,
        bidirectional=False, fb_threshold=FB)
    assert rev_status[OCCLUDED]
    assert torch.linalg.vector_norm(rev_points[OCCLUDED] - pts[OCCLUDED]) > FB
    # and the rest of the gate passes some features
    assert (fwd_status & status).sum() >= 8


# --- the wrapper -------------------------------------------------------------

def _small_args(win=11):
    img0, img1, pts, init, valid = (torch.from_numpy(a) for a in _inputs())
    p = _params(win)
    return (tlk.build_lk_pyramid(img0, p), tlk.build_lk_pyramid(img1, p),
            pts[:4].contiguous(), init[:4].contiguous(),
            valid[:4].contiguous())


def test_xcorr_pyramid_wrapper_counts_no_cpu_launch():
    args = _small_args()
    before = (k2.PYR_LAUNCHES, k2.LAUNCHES)
    points, status, err = k2.lk_xcorr_pyramid(*args, **_kw(11),
                                              bidirectional=True,
                                              fb_threshold=FB)
    assert (k2.PYR_LAUNCHES, k2.LAUNCHES) == before
    assert points.shape == (4, 2) and status.dtype == torch.bool
    assert err.shape == (4,)


def _replace_plane(pyr, fn):
    return pyr._replace(levels=(fn(pyr.levels[0]),) + pyr.levels[1:])


BAD_INPUTS = {
    "float64 plane": (TypeError, lambda a: (
        _replace_plane(a[0], lambda t: t.double()),) + a[1:]),
    "non-contiguous plane": (ValueError, lambda a: (
        _replace_plane(a[0], lambda t: t.t().contiguous().t()),) + a[1:]),
    "plane on another device": (ValueError, lambda a: (
        _replace_plane(a[0], lambda t: t.to("meta")),) + a[1:]),
    "planes of two shapes": (ValueError, lambda a: (
        _replace_plane(a[0], lambda t: t[:, :-1].contiguous()),) + a[1:]),
    "plane narrower than win + 2": (ValueError, lambda a: tuple(
        p._replace(levels=p.levels[:3] + (p.levels[3][:, :12].contiguous(),),
                   gx=p.gx[:3] + (p.gx[3][:, :12].contiguous(),),
                   gy=p.gy[:3] + (p.gy[3][:, :12].contiguous(),))
        for p in a[:2]) + a[2:]),
    "valid not bool": (TypeError, lambda a: a[:4] + (a[4].float(),)),
    "points not [N, 2]": (ValueError, lambda a: a[:2] + (
        a[2][:3].contiguous(),) + a[3:]),
    "pyramids of two pads": (ValueError, lambda a: (
        a[0]._replace(pad=a[0].pad + 1),) + a[1:]),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_xcorr_pyramid_wrapper_rejects_bad_inputs(case):
    exc, make = BAD_INPUTS[case]
    with pytest.raises(exc, match="lk_xcorr_pyramid"):
        k2.lk_xcorr_pyramid(*make(_small_args()), **_kw(11),
                            bidirectional=True, fb_threshold=FB)


def test_xcorr_pyramid_wrapper_rejects_what_the_kernel_does_not_take():
    args = _small_args()
    kw = dict(_kw(11), max_level=5)
    with pytest.raises(ValueError, match="max_level"):
        k2.lk_xcorr_pyramid(*args, **kw, bidirectional=False,
                            fb_threshold=FB)
    kw["max_level"] = 4  # within the kernel, beyond these pyramids
    with pytest.raises(ValueError, match="level"):
        k2.lk_xcorr_pyramid(*args, **kw, bidirectional=False,
                            fb_threshold=FB)
    with pytest.raises(ValueError, match="win"):
        k2.lk_xcorr_pyramid(*args, **dict(_kw(11), win=33),
                            bidirectional=False, fb_threshold=FB)


def test_xcorr_pyramid_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the raise is for CUDA-less hosts")
    with pytest.raises(RuntimeError, match="CUDA"):
        k2.lk_xcorr_pyramid_cuda(*_small_args(), **_kw(11),
                                 bidirectional=True, fb_threshold=FB)
