"""What the two pyramid entries (K1's ``lk_pyramid``, K2's
``lk_xcorr_pyramid``) share: their limits, the checks of their inputs, the
launch of their one C signature, and the per-feature glue of a pyramidal
track in plain PyTorch (the reference's ``lk_track_pyr`` and
``lk_track_bidirectional_pyr`` around a level function), which both plain
versions and the port's direct jnp level run.

A pyramid argument is an ``ops.lk.LKPyramid`` (levels, gx, gy: per level
the padded plane and its gradients; height, width: the unpadded level-0
size; pad: the border padding).
"""

from __future__ import annotations

import ctypes

import torch

# Pyramid levels one call takes (the kernels' parameter structs).
MAX_LEVELS = 5
# Largest window the kernels take.
MAX_WIN = 32
# ctypes argument types of a pyramid entry's C function (visfs_lk_pyr in
# lk_level.cu, visfs_lk_xcorr_pyr in lk_xcorr.cu: one signature).
PYR_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [
    ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p]


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


def check_pyr(pyr_from, pyr_to, pts_from, pts_init, valid, win: int,
              max_level: int, bidirectional: bool, where: str):
    """Raise on what a pyramid entry's kernel does not take (``where`` names
    the entry in the message)."""
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
    dev = pts_from.device
    planes = pyr_planes(pyr_from, pyr_to, max_level, bidirectional)
    check_tensors(where, [t for p in planes for t in p]
                  + [pts_from, pts_init], dev)
    for p in planes:
        if p[0].dim() != 2 or any(t.shape != p[0].shape for t in p):
            raise ValueError(f"{where}: a level's planes must share one "
                             "[H, W] shape")
        if min(p[0].shape) < win + 2:
            raise ValueError(f"{where}: a {tuple(p[0].shape)} plane is "
                             f"narrower than win + 2 = {win + 2}")
    n = pts_from.shape[0]
    if pts_from.shape != (n, 2) or pts_init.shape != (n, 2) \
            or valid.shape != (n,):
        raise ValueError(f"{where}: pts_from/pts_init [N, 2], valid [N]")
    if valid.device != dev or valid.dtype != torch.bool \
            or not valid.is_contiguous():
        raise TypeError(f"{where}: valid must be a contiguous bool tensor "
                        "on the points' device")


def launch_pyr(fn, where: str, pyr_from, pyr_to, pts_from, pts_init, valid,
               *, win: int, max_level: int, iterations: int, eps: float,
               min_eig_threshold: float, bidirectional: bool,
               fb_threshold: float):
    """Check the inputs and launch a pyramid entry's C function ``fn`` (of
    PYR_ARGTYPES) on PyTorch's current stream; ``where`` names the entry.
    Returns (points, status, err); raises when the launch fails."""
    if pts_from.device.type != "cuda":
        raise ValueError(f"{where}_cuda: tensors must be on a CUDA device")
    check_pyr(pyr_from, pyr_to, pts_from, pts_init, valid, win, max_level,
              bidirectional, where)
    levels = max_level + 1
    ptrs = (ctypes.c_void_p * (6 * levels))()
    shapes = (ctypes.c_int * (2 * levels))()
    for level, p in enumerate(pyr_planes(pyr_from, pyr_to, max_level,
                                         bidirectional)):
        for k, t in enumerate(p):
            ptrs[6 * level + k] = t.data_ptr()
        shapes[2 * level], shapes[2 * level + 1] = p[0].shape
    n = pts_from.shape[0]
    points = torch.empty_like(pts_from)
    status = torch.empty_like(valid)
    err_out = torch.empty(n, dtype=torch.float32, device=pts_from.device)
    stream = torch.cuda.current_stream(pts_from.device).cuda_stream
    err = fn(ptrs, shapes, levels, pts_from.data_ptr(), pts_init.data_ptr(),
             valid.data_ptr(), points.data_ptr(), status.data_ptr(),
             err_out.data_ptr(), n, pyr_from.height, pyr_from.width,
             pyr_from.pad, int(win), int(iterations),
             float(eps) * float(eps), float(min_eig_threshold),
             int(bool(bidirectional)), float(fb_threshold), stream)
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
