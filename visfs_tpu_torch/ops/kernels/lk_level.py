"""K1: Lucas-Kanade on pyramid levels — CUDA kernel + plain version.

Two entries into one kernel body (``csrc/lk_level.cu`` states the
semantics and the design on the card):

* ``lk_level`` — one pyramid level for N features, what the reference Pallas
  kernel ``visfs_tpu/ops/pallas/lk_kernel.py:lk_level_pallas`` computes;
* ``lk_pyramid`` — a whole pyramidal track in one launch: every level, the
  per-feature glue of the reference's ``lk_track_pyr`` at
  ``backend="pallas"`` and, with ``bidirectional``, the reverse track and
  the forward-backward gate of ``lk_track_bidirectional_pyr``.

For CUDA tensors each launches the hand-written kernel on PyTorch's current
stream; for CPU tensors it runs its plain PyTorch version
(``lk_level_reference``: fixed ``iterations`` steps with masked updates, the
same function; ``lk_pyramid_reference``: that level under the same glue).
Anything else raises; there is no fallback from one to the other.

``LAUNCHES`` and ``PYR_LAUNCHES`` count the launches of each entry (the CPU
path does not count), so a run can show that the main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .pyramid import (MAX_LEVELS, PYR_ARGTYPES, check_tensors, launch_pyr,
                      pyramid_op, track_bidirectional, track_pyramid)

LAUNCHES = 0
PYR_LAUNCHES = 0

_LIB_NAME = "visfs_lk_level"
_SOURCES = ("lk_level.cu",)


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; returns it."""
    if not torch.cuda.is_available():
        raise RuntimeError("lk_level: CUDA kernel requested but CUDA is not "
                           "available")
    lib = load_library(_LIB_NAME, _SOURCES)
    fn = lib.visfs_lk_level
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.visfs_lk_pyr
    if fn.argtypes is None:
        fn.argtypes = PYR_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(img_from, img_to, gx, gy, pts, flow_in, active):
    planes = (img_from, img_to, gx, gy)
    check_tensors("lk_level", planes + (pts, flow_in, active),
                  img_from.device)
    if img_from.dim() != 2 or any(p.shape != img_from.shape for p in planes):
        raise ValueError("lk_level: planes must share one [H, W] shape")
    n = pts.shape[0]
    if pts.shape != (n, 2) or flow_in.shape != (n, 2) or active.shape != (n,):
        raise ValueError("lk_level: pts/flow_in [N, 2] and active [N]")


def lk_level(img_from, img_to, gx, gy, pts, flow_in, active, *, win: int,
             iterations: int, eps: float, min_eig_threshold: float):
    """One LK pyramid level.  Planes [H, W] f32 (pre-padded so windows never
    clip), pts/flow_in [N, 2] level-scale, active [N] f32 mask.
    Returns (flow [N, 2], ok [N] f32 in {0, 1}, min_eig [N])."""
    _check(img_from, img_to, gx, gy, pts, flow_in, active)
    kind = img_from.device.type
    if kind == "cpu":
        return lk_level_reference(img_from, img_to, gx, gy, pts, flow_in,
                                  active, win=win, iterations=iterations,
                                  eps=eps, min_eig_threshold=min_eig_threshold)
    if kind == "cuda":
        return lk_level_cuda(img_from, img_to, gx, gy, pts, flow_in, active,
                             win=win, iterations=iterations, eps=eps,
                             min_eig_threshold=min_eig_threshold)
    raise ValueError(f"lk_level: unsupported device {img_from.device}")


def lk_level_cuda(img_from, img_to, gx, gy, pts, flow_in, active, *,
                  win: int, iterations: int, eps: float,
                  min_eig_threshold: float):
    """Launch the one-level entry (raises when CUDA is absent or the launch
    fails)."""
    global LAUNCHES
    lib = build()
    if img_from.device.type != "cuda":
        raise ValueError("lk_level_cuda: tensors must be on a CUDA device")
    _check(img_from, img_to, gx, gy, pts, flow_in, active)
    n = pts.shape[0]
    h, w = img_from.shape
    flow = torch.empty_like(flow_in)
    ok = torch.empty_like(active)
    eig = torch.empty_like(active)
    with torch.cuda.device(img_from.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(img_from.device).cuda_stream
        err = lib.visfs_lk_level(
            img_from.data_ptr(), img_to.data_ptr(), gx.data_ptr(),
            gy.data_ptr(), pts.data_ptr(), flow_in.data_ptr(),
            active.data_ptr(), flow.data_ptr(), ok.data_ptr(),
            eig.data_ptr(), n, h, w, int(win), int(iterations),
            float(eps) * float(eps), float(min_eig_threshold), stream)
    if err != 0:
        raise RuntimeError(f"lk_level kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return flow, ok, eig


def _bilinear_patches(img, cx, cy, win: int):
    """[N, win, win] patches centred at (cx, cy), as _bilinear_patch: the
    integer corner is clipped, the weights come from the unclipped one."""
    h, w = img.shape
    half = win // 2
    x0 = cx - half
    y0 = cy - half
    flx = torch.floor(x0)
    fly = torch.floor(y0)
    fx = (x0 - flx)[:, None, None]
    fy = (y0 - fly)[:, None, None]
    ix = torch.clamp(flx.to(torch.int64), 0, w - win - 2)
    iy = torch.clamp(fly.to(torch.int64), 0, h - win - 2)
    taps = torch.arange(win + 1, device=img.device)
    rows = (iy[:, None] + taps)[:, :, None]
    cols = (ix[:, None] + taps)[:, None, :]
    region = img[rows, cols]  # [N, win+1, win+1]
    return ((1 - fx) * (1 - fy) * region[:, :-1, :-1]
            + fx * (1 - fy) * region[:, :-1, 1:]
            + (1 - fx) * fy * region[:, 1:, :-1]
            + fx * fy * region[:, 1:, 1:])


def lk_level_reference(img_from, img_to, gx, gy, pts, flow_in, active, *,
                       win: int, iterations: int, eps: float,
                       min_eig_threshold: float):
    """Plain PyTorch version of K1: the same function with the early exit
    replaced by ``iterations`` masked steps."""
    return level_steps(img_from, img_to, gx, gy, pts, flow_in, active,
                       win=win, iterations=iterations, eps=eps,
                       min_eig_threshold=min_eig_threshold)[:3]


def level_steps(img_from, img_to, gx, gy, pts, flow_in, active, *, win: int,
                iterations: int, eps: float, min_eig_threshold: float,
                trail: list | None = None):
    """The plain level: (flow, ok, min_eig, steps [N] int — the iterations
    each feature ran before it froze or met the cap).  A ``trail`` list
    receives, for every step, the ``to``-patch centres (cx [N], cy [N]) and
    the features that sampled there (run [N] bool)."""
    px, py = pts[:, 0], pts[:, 1]
    patch_i = _bilinear_patches(img_from, px, py, win)
    pgx = _bilinear_patches(gx, px, py, win)
    pgy = _bilinear_patches(gy, px, py, win)
    g11 = torch.sum(pgx * pgx, dim=(1, 2))
    g12 = torch.sum(pgx * pgy, dim=(1, 2))
    g22 = torch.sum(pgy * pgy, dim=(1, 2))
    det = g11 * g22 - g12 * g12
    trace = g11 + g22
    min_eig = (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det,
                                              min=0.0))) * 0.5 / (win * win)
    ok_g = (min_eig > min_eig_threshold) & (det > 1e-12)
    inv_det = 1.0 / torch.where(det > 1e-12, det, torch.ones_like(det))
    gi11 = g22 * inv_det
    gi12 = -g12 * inv_det
    gi22 = g11 * inv_det

    run0 = (active > 0.0) & ok_g
    run = run0
    flow = flow_in
    eps_sq = float(eps) * float(eps)
    steps = torch.zeros(run.shape, dtype=torch.int64, device=run.device)
    for _ in range(iterations):
        steps = steps + run.to(torch.int64)
        cx, cy = px + flow[:, 0], py + flow[:, 1]
        if trail is not None:
            trail.append((cx, cy, run))
        patch_j = _bilinear_patches(img_to, cx, cy, win)
        diff = patch_i - patch_j
        b1 = torch.sum(diff * pgx, dim=(1, 2))
        b2 = torch.sum(diff * pgy, dim=(1, 2))
        dx = gi11 * b1 + gi12 * b2
        dy = gi12 * b1 + gi22 * b2
        step = torch.stack([dx, dy], dim=-1)
        flow = torch.where(run[:, None], flow + step, flow)
        run = run & ((dx * dx + dy * dy) >= eps_sq)
    flow = torch.where(run0[:, None], flow, flow_in)
    return flow, ok_g.to(torch.float32), min_eig, steps

# --- the pyramid entry --------------------------------------------------------
#
# The checks, the launch and the glue are those of ``pyramid``, shared with
# K2's pyramid entry; MAX_LEVELS is the levels one call takes.

def lk_pyramid(pyr_from, pyr_to, pts_from, pts_init, valid, *, win: int,
               max_level: int, iterations: int, eps: float,
               min_eig_threshold: float, bidirectional: bool,
               fb_threshold: float):
    """Track pts_from [N, 2] (pyr_from's image) into pyr_to's image from
    pts_init, over levels max_level .. 0, for the features valid [N] bool
    selects; with ``bidirectional``, gate by the reverse track.
    Returns (points [N, 2], status [N] bool, err [N] level-0 min_eig).

    The custom op ``visfs_tpu_torch::lk_pyramid`` (``pyramid_op``): one
    launch on CUDA tensors, the plain version on CPU tensors; under
    ``torch.func.vmap`` one launch with a stream axis for all streams."""
    return _LK_PYRAMID(
        pyr_from, pyr_to, pts_from, pts_init, valid, win=win,
        max_level=max_level, iterations=iterations, eps=eps,
        min_eig_threshold=min_eig_threshold, bidirectional=bidirectional,
        fb_threshold=fb_threshold)


def lk_pyramid_cuda(pyr_from, pyr_to, pts_from, pts_init, valid, *,
                    win: int, max_level: int, iterations: int, eps: float,
                    min_eig_threshold: float, bidirectional: bool,
                    fb_threshold: float):
    """Launch the pyramid entry, with a stream axis for planes [B, H, W]
    and points [B, N, 2] (raises when CUDA is absent or the launch
    fails)."""
    global PYR_LAUNCHES
    out = launch_pyr(build().visfs_lk_pyr, "lk_pyramid", pyr_from, pyr_to,
                     pts_from, pts_init, valid, win=win, max_level=max_level,
                     iterations=iterations, eps=eps,
                     min_eig_threshold=min_eig_threshold,
                     bidirectional=bidirectional, fb_threshold=fb_threshold)
    PYR_LAUNCHES += 1
    return out


def lk_pyramid_reference(pyr_from, pyr_to, pts_from, pts_init, valid, *,
                         win: int, max_level: int, iterations: int,
                         eps: float, min_eig_threshold: float,
                         bidirectional: bool, fb_threshold: float,
                         levels: list | None = None):
    """Plain PyTorch version of the pyramid entry: ``level_steps`` per level
    under the glue of lk_track_pyr / lk_track_bidirectional_pyr.  A
    ``levels`` list receives, per level and direction in the order run
    (forward levels max_level .. 0, then the reverse ones), the planes
    (from, to, gx, gy), the level-scale points, the active mask [N] bool,
    the steps and the step trail of ``level_steps``."""

    def level_fn(img_from, img_to, gx, gy, pts_l, flow, active):
        trail = None if levels is None else []
        flow, okf, min_eig, steps = level_steps(
            img_from, img_to, gx, gy, pts_l, flow, active.to(torch.float32),
            win=win, iterations=iterations, eps=eps,
            min_eig_threshold=min_eig_threshold, trail=trail)
        if levels is not None:
            levels.append(dict(planes=(img_from, img_to, gx, gy), pts=pts_l,
                               active=active, steps=steps, trail=trail))
        return flow, okf > 0.0, min_eig

    track = functools.partial(track_pyramid, level_fn, win=win,
                              max_level=max_level)
    if not bidirectional:
        return track(pyr_from, pyr_to, pts_from, pts_init, valid)
    return track_bidirectional(track, pyr_from, pyr_to, pts_from, pts_init,
                               valid, fb_threshold)


_LK_PYRAMID = pyramid_op("lk_pyramid", lk_pyramid_cuda, lk_pyramid_reference)
