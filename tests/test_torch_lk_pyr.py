"""K1's pyramid entry (``lk_pyramid``: every level of a pyramidal LK track,
and with ``bidirectional`` the reverse track and the gate, in one launch on
the card) on the CPU, where it runs its plain version.

* ``lk_pyramid_reference`` is bit-equal to the composition it replaces:
  one ``lk_level`` call per level under the Python glue of
  ``lk_track_pyr`` / ``lk_track_bidirectional_pyr`` (kept here as the
  oracle).
* It agrees with the reference's ``lk_track_pyr`` and
  ``lk_track_bidirectional_pyr`` at ``backend="pallas"`` (the Pallas level
  in interpret mode): points atol 0.01 px, status equal, err rtol 1e-3 —
  the pyramidal tolerances of tests/test_torch_lk.py.
* The inputs hold invalid features, a feature whose coarse-level window is
  flat (a 2-px checker vanishes at level 1; it fails ``ok`` there and
  passes at level 0), and a feature whose destination is occluded by
  another texture, so its forward track holds and its reverse track lands
  past the 1.5 px gate.
* The wrapper counts no launch on the CPU, rejects what the kernel does not
  take, and raises for a CUDA request without CUDA.

The kernel itself runs only on a card: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.ops import image as jim
from visfs_tpu.ops import lk as jlk
from visfs_tpu_torch.ops import lk as tlk
from visfs_tpu_torch.ops.kernels import lk_level as k1

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

H, W, N = 120, 160, 24
FB = 1.5
FLAT_COARSE, OCCLUDED = 0, 1  # the two constructed features


def texture(h, w, seed=0):
    """Blurred 8x8-block random texture in [0, 255] (numpy)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, size=(h // 8 + 1, w // 8 + 1)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), dtype=np.float32))[:h, :w]
    return np.array(jim.gaussian5(jnp.asarray(img)))  # writable, for torch


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


def _kw(win):
    p = tlk.LKParams(win_size=win, backend="pallas")
    return dict(win=win, max_level=p.max_level, iterations=p.iterations,
                eps=p.eps, min_eig_threshold=p.min_eig_threshold)


@pytest.fixture(scope="module", params=[11, 21], ids=["win11", "win21"])
def runs(request):
    """The reference (one jitted program per window) and the port's plain
    pyramid entry, forward ("track") and bidirectional ("bidir")."""
    win = request.param
    arrays = _inputs()
    jp = jlk.LKParams(win_size=win, backend="pallas")

    def run(a, b, p, i, v):
        pa, pb = jlk.build_lk_pyramid(a, jp), jlk.build_lk_pyramid(b, jp)
        return {"track": jlk.lk_track_pyr(pa, pb, p, i, v, jp),
                "bidir": jlk.lk_track_bidirectional_pyr(pa, pb, p, i, v, jp,
                                                        fb_threshold=FB)}

    ref = jax.device_get(jax.jit(run)(*arrays))
    tp = tlk.LKParams(win_size=win, backend="pallas")
    img0, img1, pts, init, valid = (torch.from_numpy(a) for a in arrays)
    pyr0, pyr1 = tlk.build_lk_pyramid(img0, tp), tlk.build_lk_pyramid(img1, tp)
    args = (pyr0, pyr1, pts, init, valid)
    port = {fn: k1.lk_pyramid(*args, **_kw(win), bidirectional=fn == "bidir",
                              fb_threshold=FB)
            for fn in ("track", "bidir")}
    return dict(win=win, ref=ref, port=port, args=args)


def _composition(pyr_from, pyr_to, pts_from, pts_init, valid, *, win,
                 max_level, iterations, eps, min_eig_threshold):
    """The oracle: lk_track_pyr at backend "pallas" as the port had it, one
    lk_level call per level under the Python glue."""
    half = win // 2
    h, w, pad = pyr_from.height, pyr_from.width, pyr_from.pad
    flow = (pts_init - pts_from) / (2.0 ** max_level)
    ok = valid
    min_eig = None
    for level in range(max_level, -1, -1):
        pts_l = (pts_from / (2.0 ** level) + pad).contiguous()
        flow, okf, min_eig = k1.lk_level(
            pyr_from.levels[level], pyr_to.levels[level], pyr_from.gx[level],
            pyr_from.gy[level], pts_l, flow.contiguous(),
            ok.to(torch.float32).contiguous(), win=win,
            iterations=iterations, eps=eps,
            min_eig_threshold=min_eig_threshold)
        ok = ok & (okf > 0.0)
        if level > 0:
            flow = flow * 2.0
    pts_to = pts_from + flow
    inb = ((pts_to[:, 0] >= half) & (pts_to[:, 0] < w - half)
           & (pts_to[:, 1] >= half) & (pts_to[:, 1] < h - half))
    return pts_to, ok & inb & valid, min_eig


def _composition_bidir(pyr_from, pyr_to, pts_from, pts_init, valid, **kw):
    fwd = _composition(pyr_from, pyr_to, pts_from, pts_init, valid, **kw)
    rev = _composition(pyr_to, pyr_from, fwd[0], pts_from, fwd[1], **kw)
    dist = torch.linalg.vector_norm(rev[0] - pts_from, dim=-1)
    return fwd[0], fwd[1] & rev[1] & (dist <= FB), fwd[2]


@pytest.mark.parametrize("fn", ["track", "bidir"])
def test_plain_pyramid_bit_equal_to_level_composition(runs, fn):
    oracle = (_composition_bidir if fn == "bidir" else _composition)(
        *runs["args"], **_kw(runs["win"]))
    for got, want in zip(runs["port"][fn], oracle):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("fn", ["track", "bidir"])
def test_plain_pyramid_matches_reference_pallas(runs, fn):
    ref = runs["ref"][fn]
    points, status, err = runs["port"][fn]
    np.testing.assert_array_equal(status.numpy(), np.asarray(ref.status))
    assert status.sum() >= 8
    np.testing.assert_allclose(points.numpy(), np.asarray(ref.points),
                               atol=0.01)
    np.testing.assert_allclose(err.numpy(), np.asarray(ref.err), rtol=1e-3,
                               atol=1e-6)


def test_constructed_cases_are_covered(runs):
    pyr0, pyr1, pts, init, valid = runs["args"]
    kw = _kw(runs["win"])
    _, fwd_status, err = runs["port"]["track"]
    _, status, _ = runs["port"]["bidir"]
    assert not status[~valid].any()
    # FLAT_COARSE: ok at level 0 (its err, the level-0 min_eig, is large),
    # but a coarser level's window is flat and fails ok
    assert err[FLAT_COARSE] > 1.0 and not fwd_status[FLAT_COARSE]
    coarse = []
    for level in range(1, kw["max_level"] + 1):
        pts_l = (pts / 2.0 ** level + pyr0.pad)[FLAT_COARSE:FLAT_COARSE + 1]
        _, ok, _ = k1.lk_level_reference(
            pyr0.levels[level], pyr1.levels[level], pyr0.gx[level],
            pyr0.gy[level], pts_l, torch.zeros(1, 2), torch.ones(1),
            win=kw["win"], iterations=1, eps=kw["eps"],
            min_eig_threshold=kw["min_eig_threshold"])
        coarse.append(bool(ok[0]))
    assert not all(coarse)
    # OCCLUDED: its forward track holds, its reverse track is tracked but
    # lands past the gate
    assert fwd_status[OCCLUDED] and not status[OCCLUDED]
    rev_points, rev_status, _ = k1.lk_pyramid(
        pyr1, pyr0, runs["port"]["track"][0], pts, fwd_status, **kw,
        bidirectional=False, fb_threshold=FB)
    assert rev_status[OCCLUDED]
    assert torch.linalg.vector_norm(rev_points[OCCLUDED] - pts[OCCLUDED]) > FB
    # and the rest of the gate passes some features
    assert (fwd_status & status).sum() >= 8


# --- the wrapper ---------------------------------------------------------------

def _small_args(win=11):
    img0, img1, pts, init, valid = (torch.from_numpy(a) for a in _inputs())
    p = tlk.LKParams(win_size=win)
    return (tlk.build_lk_pyramid(img0, p), tlk.build_lk_pyramid(img1, p),
            pts[:4].contiguous(), init[:4].contiguous(),
            valid[:4].contiguous())


def test_pyramid_wrapper_counts_no_cpu_launch():
    args = _small_args()
    before = (k1.PYR_LAUNCHES, k1.LAUNCHES)
    points, status, err = k1.lk_pyramid(*args, **_kw(11), bidirectional=True,
                                        fb_threshold=FB)
    assert (k1.PYR_LAUNCHES, k1.LAUNCHES) == before
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
def test_pyramid_wrapper_rejects_bad_inputs(case):
    exc, make = BAD_INPUTS[case]
    with pytest.raises(exc):
        k1.lk_pyramid(*make(_small_args()), **_kw(11), bidirectional=True,
                      fb_threshold=FB)


def test_pyramid_wrapper_rejects_more_levels_than_the_kernel_takes():
    args = _small_args()
    kw = dict(_kw(11), max_level=k1.MAX_LEVELS)
    with pytest.raises(ValueError, match="max_level"):
        k1.lk_pyramid(*args, **kw, bidirectional=False, fb_threshold=FB)
    kw["max_level"] = 4  # within the kernel, beyond these pyramids
    with pytest.raises(ValueError, match="level"):
        k1.lk_pyramid(*args, **kw, bidirectional=False, fb_threshold=FB)


def test_pyramid_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the raise is for CUDA-less hosts")
    with pytest.raises(RuntimeError, match="CUDA"):
        k1.lk_pyramid_cuda(*_small_args(), **_kw(11), bidirectional=True,
                           fb_threshold=FB)
