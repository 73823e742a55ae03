"""K1: one pyramid level of LK for N features — CUDA kernel + plain version.

``lk_level`` computes what the reference Pallas kernel
``visfs_tpu/ops/pallas/lk_kernel.py:lk_level_pallas`` computes (see
``csrc/lk_level.cu`` for the semantics and the design on the card).  For
CUDA tensors it launches the hand-written kernel on PyTorch's current
stream; for CPU tensors it runs ``lk_level_reference``, the plain PyTorch
version (fixed ``iterations`` steps with masked updates — the same
function).  Anything else raises; there is no fallback from one to the
other.

``LAUNCHES`` counts kernel launches (the CPU path does not count), so a run
can show that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library

LAUNCHES = 0

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
    return lib


def _check(img_from, img_to, gx, gy, pts, flow_in, active):
    planes = (img_from, img_to, gx, gy)
    dev = img_from.device
    for t in planes + (pts, flow_in, active):
        if t.device != dev:
            raise ValueError("lk_level: all tensors must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"lk_level: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("lk_level: tensors must be contiguous")
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
    """Launch the CUDA kernel (raises when CUDA is absent or the launch
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
    stream = torch.cuda.current_stream(img_from.device).cuda_stream
    err = lib.visfs_lk_level(
        img_from.data_ptr(), img_to.data_ptr(), gx.data_ptr(), gy.data_ptr(),
        pts.data_ptr(), flow_in.data_ptr(), active.data_ptr(),
        flow.data_ptr(), ok.data_ptr(), eig.data_ptr(),
        n, h, w, int(win), int(iterations), float(eps) * float(eps),
        float(min_eig_threshold), stream)
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
    for _ in range(iterations):
        patch_j = _bilinear_patches(img_to, px + flow[:, 0], py + flow[:, 1],
                                    win)
        diff = patch_i - patch_j
        b1 = torch.sum(diff * pgx, dim=(1, 2))
        b2 = torch.sum(diff * pgy, dim=(1, 2))
        dx = gi11 * b1 + gi12 * b2
        dy = gi12 * b1 + gi22 * b2
        step = torch.stack([dx, dy], dim=-1)
        flow = torch.where(run[:, None], flow + step, flow)
        run = run & ((dx * dx + dy * dy) >= eps_sq)
    flow = torch.where(run0[:, None], flow, flow_in)
    return flow, ok_g.to(torch.float32), min_eig
