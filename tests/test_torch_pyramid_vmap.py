"""The pyramid entries' batching rules on the CPU: ``lk_pyramid`` (K1) and
``lk_xcorr_pyramid`` (K2) under ``torch.func.vmap`` over a fleet's streams.

Each entry is a custom op whose rule stacks the streams and, on the card,
launches the kernel once with a stream axis; on CPU tensors it runs the
plain version stream by stream.  Here, for each entry, one and two
directions and batched or shared arguments: the vmapped call is bit-equal
to a loop of the plain version over the streams, and the rule runs once
for all streams.  The stacked [B, H, W] planes and [B, N, 2] points are the
kernels' stream-axis layout, and the checks refuse what it cannot take.
The batched launch itself runs only on a card: tests/test_torch_cuda.py.
JAX is not used here."""

import numpy as np
import pytest
import torch

from visfs_tpu_torch.ops import lk as tlk
from visfs_tpu_torch.ops.image import gaussian5
from visfs_tpu_torch.ops.kernels import lk_level as k1
from visfs_tpu_torch.ops.kernels import lk_xcorr as k2
from visfs_tpu_torch.ops.kernels import pyramid
from visfs_tpu_torch.ops.kernels.pyramid import Pyramid, check_pyr

torch.set_num_threads(1)

H, W, N, B = 72, 96, 10, 3
WIN = 11
KW = dict(win=WIN, max_level=2, iterations=10, eps=0.01,
          min_eig_threshold=1e-4, fb_threshold=1.5)
ENTRIES = {"lk_pyramid": (k1.lk_pyramid, k1.lk_pyramid_reference),
           "lk_xcorr_pyramid": (k2.lk_xcorr_pyramid,
                                k2.lk_xcorr_pyramid_reference)}


def _texture(rng):
    img = rng.uniform(0, 255, (H // 6 + 1, W // 6 + 1)).astype(np.float32)
    img = np.kron(img, np.ones((6, 6), np.float32))[:H, :W]
    return gaussian5(torch.from_numpy(img))


def _streams(seed=0):
    """Per stream: two pyramids (the second the first shifted by 2, 1 px
    with noise), points, their starts and a valid mask."""
    rng = np.random.default_rng(seed)
    p = tlk.LKParams(win_size=WIN, max_level=KW["max_level"])
    out = []
    for _ in range(B):
        img0 = _texture(rng)
        img1 = torch.roll(img0, (1, 2), (0, 1)) + torch.from_numpy(
            rng.normal(0, 1.0, (H, W)).astype(np.float32))
        pts = torch.from_numpy(rng.uniform(
            [10, 10], [W - 10, H - 10], (N, 2)).astype(np.float32))
        init = pts + torch.tensor([2.0, 1.0]) + torch.from_numpy(
            rng.normal(0, 0.5, (N, 2)).astype(np.float32))
        valid = torch.from_numpy(rng.uniform(size=N) > 0.2)
        out.append((tlk.build_lk_pyramid(img0, p),
                    tlk.build_lk_pyramid(img1, p), pts, init, valid))
    return out


def _stack(pyrs):
    return Pyramid(*(tuple(torch.stack(t) for t in zip(*f))
                     for f in zip(*[(q.levels, q.gx, q.gy) for q in pyrs])),
                   pyrs[0].height, pyrs[0].width, pyrs[0].pad)


def _vmapped(entry, streams, bidirectional, shared):
    """The entry under vmap over the streams; ``shared`` names the
    arguments given unbatched (stream 0's, for every stream)."""
    cols = list(zip(*streams))
    args = [_stack(cols[0]), _stack(cols[1])] + [torch.stack(c)
                                                 for c in cols[2:]]
    for k in shared:
        args[k] = streams[0][k]
    in_dims = tuple(None if k in shared else 0 for k in range(5))
    size = args[0][3:]  # height, width, pad: not mapped

    def one(planes_from, planes_to, pts, init, valid):
        return entry(Pyramid(*planes_from, *size), Pyramid(*planes_to, *size),
                     pts, init, valid, bidirectional=bidirectional, **KW)

    return torch.func.vmap(one, in_dims=in_dims)(
        tuple(args[0][:3]), tuple(args[1][:3]), *args[2:])


@pytest.fixture(scope="module")
def streams():
    return _streams()


CASES = [(name, bidi, shared) for name in ENTRIES for bidi in (True, False)
         for shared in ((), (1,), (2, 3))]


@pytest.mark.parametrize("name,bidirectional,shared", CASES)
def test_vmap_is_bit_equal_to_the_plain_loop(streams, name, bidirectional,
                                             shared):
    entry, plain = ENTRIES[name]
    got = _vmapped(entry, streams, bidirectional, shared)
    for b, s in enumerate(streams):
        args = [streams[0][k] if k in shared else s[k] for k in range(5)]
        want = plain(*args, bidirectional=bidirectional, **KW)
        for g, w in zip(got, want):
            assert g[b].dtype == w.dtype
            assert torch.equal(g[b], w), (name, b)
    assert got[0].shape == (B, N, 2) and got[1].shape == (B, N)


@pytest.mark.parametrize("name", ENTRIES)
def test_vmap_runs_the_rule_once_for_all_streams(streams, name,
                                                 monkeypatch):
    """One rule call sees the B stacked streams (one launch on the card);
    on the CPU it then runs the plain version once a stream."""
    entry, _ = ENTRIES[name]
    seen = []
    real = pyramid._stream

    def spy(pyrs, i):
        seen.append((id(pyrs), i))
        return real(pyrs, i)

    monkeypatch.setattr(pyramid, "_stream", spy)
    got = _vmapped(entry, streams, True, ())
    assert [i for _, i in seen] == list(range(B))
    assert len({key for key, _ in seen}) == 1
    assert got[0].shape == (B, N, 2)


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_outside_vmap_is_the_plain_version(streams, name):
    entry, plain = ENTRIES[name]
    s = streams[1]
    for g, w in zip(entry(*s, bidirectional=True, **KW),
                    plain(*s, bidirectional=True, **KW)):
        assert torch.equal(g, w)


def test_stream_axis_layout_is_checked(streams):
    """check_pyr takes the kernels' stream-axis layout: planes [B, H, W],
    points [B, N, 2], valid [B, N]; a mismatch of B or N raises."""
    cols = list(zip(*streams))
    pf, pt = _stack(cols[0]), _stack(cols[1])
    pts, init, valid = (torch.stack(c) for c in cols[2:])
    check_pyr(pf, pt, pts, init, valid, WIN, KW["max_level"], True, "t")
    with pytest.raises(ValueError):
        check_pyr(pf, pt, pts[:2], init[:2], valid[:2], WIN,
                  KW["max_level"], True, "t")
    with pytest.raises(ValueError):
        check_pyr(pf, pt, pts[:, :4], init, valid, WIN, KW["max_level"],
                  True, "t")
    with pytest.raises(ValueError):
        check_pyr(pf, pt, pts[None], init[None], valid[None], WIN,
                  KW["max_level"], True, "t")


@pytest.mark.parametrize("name", ENTRIES)
def test_batched_cuda_launch_raises_without_cuda(streams, name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the raise is for CUDA-less hosts")
    mod = k1 if name == "lk_pyramid" else k2
    cols = list(zip(*streams))
    args = (_stack(cols[0]), _stack(cols[1])) + tuple(
        torch.stack(c) for c in cols[2:])
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(mod, f"{name}_cuda")(*args, bidirectional=True, **KW)
