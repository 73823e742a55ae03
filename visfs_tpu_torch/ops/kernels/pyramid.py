"""What the two pyramid entries (K1's ``lk_pyramid``, K2's
``lk_xcorr_pyramid``) share: their limits, the checks of their inputs, the
launch of their one C signature, and the per-feature glue of a pyramidal
track in plain PyTorch (the reference's ``lk_track_pyr`` and
``lk_track_bidirectional_pyr`` around a level function), which both plain
versions and the port's direct jnp level run.

A pyramid argument is an ``ops.lk.LKPyramid`` (levels, gx, gy: per level
the padded plane and its gradients; height, width: the unpadded level-0
size; pad: the border padding).

Each pyramid entry is a ``torch.library`` custom op (``pyramid_op``) with a
batching rule, so ``torch.func.vmap`` over a fleet's streams (the port's
``slam.fleet.fleet_step``) tracks every stream's features in ONE launch:
the rule stacks the streams' planes [B, H, W] and points [B, N, 2] and
launches the kernel with a stream axis.  On CPU tensors the rule runs the
plain version stream by stream.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

# Pyramid levels one call takes (the kernels' parameter structs).
MAX_LEVELS = 5
# Largest window the kernels take.
MAX_WIN = 32
# ctypes argument types of a pyramid entry's C function (visfs_lk_pyr in
# lk_level.cu, visfs_lk_xcorr_pyr in lk_xcorr.cu: one signature): planes,
# shapes, levels, n_streams, plane strides, points stride, the six arrays,
# n, h0, w0, pad, win, iterations, then eps^2, the min-eig threshold,
# bidirectional, fb_threshold and the stream.
PYR_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                         ctypes.c_float, ctypes.c_void_p]


def check_tensors(where, tensors, dev):
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{where}: all tensors must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"{where}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{where}: tensors must be contiguous")


def pyr_planes(pyr_from, pyr_to, max_level: int, bidirectional: bool):
    """Per level, the planes the track reads: from, to, gx/gy of `from`,
    and with ``bidirectional`` gx/gy of `to` (the reverse track's)."""
    planes = []
    for level in range(max_level + 1):
        p = [pyr_from.levels[level], pyr_to.levels[level],
             pyr_from.gx[level], pyr_from.gy[level]]
        if bidirectional:
            p += [pyr_to.gx[level], pyr_to.gy[level]]
        planes.append(p)
    return planes


def check_shapes(pyr_from, pyr_to, win: int, max_level: int, where: str):
    """Raise on a level, window or pair of pyramids the kernels do not
    take."""
    if not 0 <= max_level < MAX_LEVELS:
        raise ValueError(f"{where}: max_level {max_level} outside "
                         f"[0, {MAX_LEVELS - 1}]")
    if not 1 <= win <= MAX_WIN:
        raise ValueError(f"{where}: win {win} outside [1, {MAX_WIN}]")
    for pyr in (pyr_from, pyr_to):
        if len(pyr.levels) <= max_level:
            raise ValueError(f"{where}: a pyramid of {len(pyr.levels)} "
                             f"levels has no level {max_level}")
    if (pyr_from.height, pyr_from.width, pyr_from.pad) != (
            pyr_to.height, pyr_to.width, pyr_to.pad):
        raise ValueError(f"{where}: the pyramids differ in size or pad")


def check_pyr(pyr_from, pyr_to, pts_from, pts_init, valid, win: int,
              max_level: int, bidirectional: bool, where: str):
    """Raise on what a pyramid entry's kernel does not take (``where`` names
    the entry in the message)."""
    check_shapes(pyr_from, pyr_to, win, max_level, where)
    dev = pts_from.device
    planes = pyr_planes(pyr_from, pyr_to, max_level, bidirectional)
    check_tensors(where, [t for p in planes for t in p]
                  + [pts_from, pts_init], dev)
    # A stream axis: planes [B, H, W], points [B, N, 2], valid [B, N].
    lead = tuple(pts_from.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"{where}: at most one stream axis")
    for p in planes:
        if p[0].dim() != 2 + len(lead) or p[0].shape[:-2] != lead \
                or any(t.shape != p[0].shape for t in p):
            raise ValueError(f"{where}: a level's planes must share one "
                             "[H, W] shape ([B, H, W] with a stream axis)")
        if min(p[0].shape[-2:]) < win + 2:
            raise ValueError(f"{where}: a {tuple(p[0].shape)} plane is "
                             f"narrower than win + 2 = {win + 2}")
    n = pts_from.shape[-2] if pts_from.dim() >= 2 else -1
    if pts_from.shape != lead + (n, 2) or pts_init.shape != lead + (n, 2) \
            or valid.shape != lead + (n,):
        raise ValueError(f"{where}: pts_from/pts_init [N, 2], valid [N] "
                         "([B, N, 2] and [B, N] with a stream axis)")
    if valid.device != dev or valid.dtype != torch.bool \
            or not valid.is_contiguous():
        raise TypeError(f"{where}: valid must be a contiguous bool tensor "
                        "on the points' device")


def launch_pyr(fn, where: str, pyr_from, pyr_to, pts_from, pts_init, valid,
               *, win: int, max_level: int, iterations: int, eps: float,
               min_eig_threshold: float, bidirectional: bool,
               fb_threshold: float):
    """Check the inputs and launch a pyramid entry's C function ``fn`` (of
    PYR_ARGTYPES) on PyTorch's current stream of the tensors' device;
    ``where`` names the entry.
    With a stream axis (planes [B, H, W], points [B, N, 2], valid [B, N])
    the one launch tracks every stream's features.
    Returns (points, status, err); raises when the launch fails."""
    if pts_from.device.type != "cuda":
        raise ValueError(f"{where}_cuda: tensors must be on a CUDA device")
    check_pyr(pyr_from, pyr_to, pts_from, pts_init, valid, win, max_level,
              bidirectional, where)
    levels = max_level + 1
    ptrs = (ctypes.c_void_p * (6 * levels))()
    shapes = (ctypes.c_int * (2 * levels))()
    strides = (ctypes.c_longlong * levels)()
    for level, p in enumerate(pyr_planes(pyr_from, pyr_to, max_level,
                                         bidirectional)):
        for k, t in enumerate(p):
            ptrs[6 * level + k] = t.data_ptr()
        shapes[2 * level], shapes[2 * level + 1] = p[0].shape[-2:]
        strides[level] = p[0].shape[-2] * p[0].shape[-1]
    n = pts_from.shape[-2]
    n_streams = pts_from.shape[0] if pts_from.dim() == 3 else 1
    points = torch.empty_like(pts_from)
    status = torch.empty_like(valid)
    err_out = torch.empty(valid.shape, dtype=torch.float32,
                          device=pts_from.device)
    # the C function launches on the calling thread's current device: make
    # it the tensors' (one process may drive several cards)
    with torch.cuda.device(pts_from.device):
        stream = torch.cuda.current_stream(pts_from.device).cuda_stream
        err = fn(ptrs, shapes, levels, n_streams, strides, n,
                 pts_from.data_ptr(), pts_init.data_ptr(), valid.data_ptr(),
                 points.data_ptr(), status.data_ptr(), err_out.data_ptr(), n,
                 pyr_from.height, pyr_from.width, pyr_from.pad, int(win),
                 int(iterations), float(eps) * float(eps),
                 float(min_eig_threshold), int(bool(bidirectional)),
                 float(fb_threshold), stream)
    if err != 0:
        raise RuntimeError(f"{where} kernel launch failed: CUDA error {err}")
    return points, status, err_out


def track_pyramid(level_fn, pyr_from, pyr_to, pts_from, pts_init, valid,
                  *, win: int, max_level: int):
    """The glue of the reference's lk_track_pyr around a level function
    ``level_fn(img_from, img_to, gx, gy, pts_l, flow, active) -> (flow,
    ok [N] bool, min_eig)`` (pts_l and flow at the level's scale, active
    [N] bool).  Returns (points, status, err)."""
    half = win // 2
    h, w, pad = pyr_from.height, pyr_from.width, pyr_from.pad
    flow = (pts_init - pts_from) / (2.0 ** max_level)
    ok = valid
    min_eig = torch.zeros(pts_from.shape[0], dtype=torch.float32,
                          device=pts_from.device)
    for level in range(max_level, -1, -1):
        pts_l = pts_from / (2.0 ** level) + pad
        flow, ok_g, min_eig = level_fn(
            pyr_from.levels[level], pyr_to.levels[level], pyr_from.gx[level],
            pyr_from.gy[level], pts_l, flow, ok)
        ok = ok & ok_g
        if level > 0:
            flow = flow * 2.0
    pts_to = pts_from + flow
    inb = ((pts_to[:, 0] >= half) & (pts_to[:, 0] < w - half)
           & (pts_to[:, 1] >= half) & (pts_to[:, 1] < h - half))
    return pts_to, ok & inb & valid, min_eig


def track_bidirectional(track, pyr_from, pyr_to, pts_from, pts_init, valid,
                        fb_threshold: float):
    """The reference's lk_track_bidirectional_pyr around a track function
    ``track(pyr_from, pyr_to, pts_from, pts_init, valid) -> (points,
    status, err)``: the reverse track from the forward points, seeded at
    pts_from, and the gate |reverse - pts_from| <= fb_threshold."""
    points, status, err = track(pyr_from, pyr_to, pts_from, pts_init, valid)
    rev_points, rev_status, _ = track(pyr_to, pyr_from, points, pts_from,
                                      status)
    dist = torch.linalg.vector_norm(rev_points - pts_from, dim=-1)
    return points, status & rev_status & (dist <= fb_threshold), err


# --- the custom op and its batching rule -------------------------------------

class Pyramid(NamedTuple):
    """A pyramid argument rebuilt from the op's flat arguments (the fields
    of ``ops.lk.LKPyramid``)."""

    levels: tuple
    gx: tuple
    gy: tuple
    height: int
    width: int
    pad: int


_OP_SCHEMA = (
    "(Tensor[] from_levels, Tensor[] from_gx, Tensor[] from_gy, "
    "Tensor[] to_levels, Tensor[] to_gx, Tensor[] to_gy, Tensor pts_from, "
    "Tensor pts_init, Tensor valid, int height, int width, int pad, int win, "
    "int max_level, int iterations, float eps, float min_eig_threshold, "
    "bool bidirectional, float fb_threshold) -> (Tensor, Tensor, Tensor)")
_N_LISTS = 6  # the op's plane lists: from levels/gx/gy, to levels/gx/gy
_KW = ("win", "max_level", "iterations", "eps", "min_eig_threshold",
       "bidirectional", "fb_threshold")


def pyramid_op(name: str, launch, plain):
    """A pyramid entry as the custom op ``visfs_tpu_torch::<name>``.

    ``launch(pyr_from, pyr_to, pts_from, pts_init, valid, **kw)`` launches
    the kernel (and counts the launch), with or without a stream axis;
    ``plain(...)`` is the plain version of one stream.  The op runs
    ``launch`` on CUDA tensors and ``plain`` on CPU tensors.  Its batching
    rule moves every batched argument's batch dimension to 0, expands the
    unbatched ones to the batch and makes ONE stream-axis launch on CUDA,
    or runs ``plain`` per stream on the CPU.  There is no backward (the
    reference's kernels have none).  Returns ``entry(pyr_from, pyr_to,
    pts_from, pts_init, valid, **kw) -> (points, status, err)``."""

    def unflat(args):
        planes, (pts_from, pts_init, valid, h, w, pad) = (
            args[:_N_LISTS], args[_N_LISTS:_N_LISTS + 6])
        pyr_from = Pyramid(tuple(planes[0]), tuple(planes[1]),
                           tuple(planes[2]), h, w, pad)
        pyr_to = Pyramid(tuple(planes[3]), tuple(planes[4]),
                         tuple(planes[5]), h, w, pad)
        kw = dict(zip(_KW, args[_N_LISTS + 6:]))
        return (pyr_from, pyr_to, pts_from, pts_init, valid), kw

    def run_plain(pyrs, kw):
        check_pyr(*pyrs, kw["win"], kw["max_level"], kw["bidirectional"],
                  name)
        return plain(*pyrs, **kw)

    @torch.library.custom_op(f"visfs_tpu_torch::{name}", mutates_args=(),
                             schema=_OP_SCHEMA)
    def op(*args):
        pyrs, kw = unflat(args)
        kind = pyrs[2].device.type
        if kind == "cuda":  # launch checks its inputs itself
            return launch(*pyrs, **kw)
        if kind == "cpu":
            return run_plain(pyrs, kw)
        raise ValueError(f"{name}: unsupported device {pyrs[2].device}")

    @op.register_vmap
    def _batched(info, in_dims, *args):
        b = info.batch_size

        def stack(t, d):
            t = t.movedim(d, 0) if d is not None else t.expand(b, *t.shape)
            return t.contiguous()

        flat = []
        for a, d in zip(args, in_dims):
            if isinstance(a, (list, tuple)):
                dims = d if isinstance(d, (list, tuple)) else [d] * len(a)
                flat.append([stack(t, e) for t, e in zip(a, dims)])
            elif isinstance(a, torch.Tensor):
                flat.append(stack(a, d))
            else:
                flat.append(a)
        pyrs, kw = unflat(flat)
        kind = pyrs[2].device.type
        if kind == "cuda":
            return launch(*pyrs, **kw), (0, 0, 0)
        if kind != "cpu":
            raise ValueError(f"{name}: unsupported device {pyrs[2].device}")
        outs = [run_plain(_stream(pyrs, i), kw) for i in range(b)]
        return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)

    def entry(pyr_from, pyr_to, pts_from, pts_init, valid, *, win: int,
              max_level: int, iterations: int, eps: float,
              min_eig_threshold: float, bidirectional: bool,
              fb_threshold: float):
        check_shapes(pyr_from, pyr_to, win, max_level, name)
        top = max_level + 1
        lists = [list(p[:top]) for pyr in (pyr_from, pyr_to)
                 for p in (pyr.levels, pyr.gx, pyr.gy)]
        # The dispatcher would pick one device for a mix; refuse it here.
        dev = pts_from.device
        if any(t.device != dev for p in lists for t in p) or \
                pts_init.device != dev or valid.device != dev:
            raise ValueError(f"{name}: all tensors must be on one device")
        return op(*lists, pts_from, pts_init, valid, int(pyr_from.height),
                  int(pyr_from.width), int(pyr_from.pad), int(win),
                  int(max_level), int(iterations), float(eps),
                  float(min_eig_threshold), bool(bidirectional),
                  float(fb_threshold))

    entry.op = op
    return entry


def _stream(pyrs, i):
    """Stream i of stacked pyramid arguments."""
    pyr_from, pyr_to, pts_from, pts_init, valid = pyrs

    def one(pyr):
        return pyr._replace(levels=tuple(t[i] for t in pyr.levels),
                            gx=tuple(t[i] for t in pyr.gx),
                            gy=tuple(t[i] for t in pyr.gy))

    return one(pyr_from), one(pyr_to), pts_from[i], pts_init[i], valid[i]
