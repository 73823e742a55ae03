"""K2: the LK iteration loop in correlation form — CUDA kernel + plain
version.

Two entries into one loop function (``csrc/lk_xcorr.cu`` states the
semantics and the design on the card):

* ``lk_xcorr_iterate`` — the loop of one level for N features, what the
  reference Pallas kernel ``visfs_tpu/ops/pallas/lk_xcorr.py:lk_xcorr_iterate``
  computes, with its signature and layouts;
* ``lk_xcorr_pyramid`` — a whole pyramidal track in correlation form in one
  launch: per level the jnp level's setup (``jnp_level.level_setup``), the
  correlation maps and the arguments of the loop
  (``jnp_level.xcorr_inputs``) and the loop itself, under the per-feature
  glue of ``lk_track_pyr`` (``pyramid.track_pyramid``) and,
  with ``bidirectional``, the reverse track and the gate of
  ``lk_track_bidirectional_pyr`` — what ``ops/lk.py`` runs at
  ``iter_mode="xcorr"``.

For CUDA tensors each launches the hand-written kernel on PyTorch's current
stream; for CPU tensors it runs its plain PyTorch version
(``lk_xcorr_iterate_reference``: full tent weights over the A x A map,
``iterations`` masked steps — the same function;
``lk_xcorr_pyramid_reference``: that loop after the jnp level's setup,
under the same glue).  Anything else raises; there is no fallback from one
to the other.

``LAUNCHES`` and ``PYR_LAUNCHES`` count the launches of each entry (the CPU
path does not count).  The library is built on its own
(``_build.load_library``, one nvcc call for ``lk_xcorr.cu``), so it can
build alongside K1's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .jnp_level import level_setup, xcorr_inputs
from .pyramid import (PYR_ARGTYPES, launch_pyr, pyramid_op,
                      track_bidirectional, track_pyramid)

LAUNCHES = 0
PYR_LAUNCHES = 0

LIB_NAME = "visfs_lk_xcorr"
_SOURCES = ("lk_xcorr.cu",)


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; returns it."""
    if not torch.cuda.is_available():
        raise RuntimeError("lk_xcorr: CUDA kernel requested but CUDA is not "
                           "available")
    lib = load_library(LIB_NAME, _SOURCES)
    fn = lib.visfs_lk_xcorr
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.visfs_lk_xcorr_pyr
    if fn.argtypes is None:
        fn.argtypes = PYR_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(C1, C2, vectors, flow, active, max_off):
    dev = C1.device
    for t in (C1, C2, *vectors, flow, active):
        if t.device != dev:
            raise ValueError("lk_xcorr: all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("lk_xcorr: tensors must be contiguous")
    for t in (C1, C2, *vectors, flow):
        if t.dtype != torch.float32:
            raise TypeError(f"lk_xcorr: expected float32, got {t.dtype}")
    if active.dtype != torch.bool:
        raise TypeError(f"lk_xcorr: active must be bool, got {active.dtype}")
    n, a = C1.shape[0], C1.shape[-1]
    if C1.shape != (n, a, a) or C2.shape != (n, a, a):
        raise ValueError("lk_xcorr: C1/C2 must share one [N, A, A] shape")
    if any(v.shape != (n,) for v in vectors) or active.shape != (n,) \
            or flow.shape != (n, 2):
        raise ValueError("lk_xcorr: scalars/active [N] and flow [N, 2]")
    if not 0.0 <= max_off <= a - 1:
        raise ValueError(f"lk_xcorr: max_off {max_off} outside [0, A - 1]")


def lk_xcorr_iterate(C1, C2, c1_const, c2_const, gi11, gi12, gi22, base_x,
                     base_y, flow, active, *, iterations: int, eps: float,
                     max_off: float):
    """Run the LK iteration loop on correlation maps; returns flow [N, 2].

    C1/C2: [N, A, A] f32; c1_const ... base_y: [N] f32; flow [N, 2] f32;
    active [N] bool (features inactive at entry keep their flow)."""
    vectors = (c1_const, c2_const, gi11, gi12, gi22, base_x, base_y)
    _check(C1, C2, vectors, flow, active, max_off)
    kind = C1.device.type
    if kind == "cpu":
        return lk_xcorr_iterate_reference(
            C1, C2, *vectors, flow, active, iterations=iterations, eps=eps,
            max_off=max_off)
    if kind == "cuda":
        return lk_xcorr_iterate_cuda(
            C1, C2, *vectors, flow, active, iterations=iterations, eps=eps,
            max_off=max_off)
    raise ValueError(f"lk_xcorr: unsupported device {C1.device}")


def lk_xcorr_iterate_cuda(C1, C2, c1_const, c2_const, gi11, gi12, gi22,
                          base_x, base_y, flow, active, *, iterations: int,
                          eps: float, max_off: float):
    """Launch the CUDA kernel (raises when CUDA is absent or the launch
    fails)."""
    global LAUNCHES
    lib = build()
    if C1.device.type != "cuda":
        raise ValueError("lk_xcorr_iterate_cuda: tensors must be on a CUDA "
                         "device")
    vectors = (c1_const, c2_const, gi11, gi12, gi22, base_x, base_y)
    _check(C1, C2, vectors, flow, active, max_off)
    n, a = C1.shape[0], C1.shape[-1]
    if (a * a) % 4 or C1.data_ptr() % 16 or C2.data_ptr() % 16:
        raise ValueError("lk_xcorr_iterate_cuda: the kernel copies the maps "
                         "with 16-byte loads: A * A must be a multiple of 4 "
                         "and C1/C2 16-byte aligned")
    out = torch.empty_like(flow)
    with torch.cuda.device(C1.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(C1.device).cuda_stream
        err = lib.visfs_lk_xcorr(
            C1.data_ptr(), C2.data_ptr(), *(v.data_ptr() for v in vectors),
            flow.data_ptr(), active.data_ptr(), out.data_ptr(), n, a,
            int(iterations), float(eps) * float(eps), float(max_off),
            stream)
    if err != 0:
        raise RuntimeError(f"lk_xcorr kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def xcorr_steps(C1, C2, c1_const, c2_const, gi11, gi12, gi22, base_x,
                base_y, flow, active, *, iterations: int, eps: float,
                max_off: float, trail: list | None = None):
    """The plain loop: (flow [N, 2], steps [N] int — the iterations each
    feature ran before it froze or met the cap).  A ``trail`` list receives,
    for every step, the clamped map offsets (offx [N], offy [N]) and the
    features that looked up there (run [N] bool)."""
    a = C1.shape[-1]
    ar = torch.arange(a, dtype=torch.float32, device=C1.device)
    eps_sq = float(eps) * float(eps)
    run = active
    steps = torch.zeros(active.shape, dtype=torch.int64, device=C1.device)
    for _ in range(iterations):
        offx = torch.clamp(base_x + flow[:, 0], 0.0, max_off)
        offy = torch.clamp(base_y + flow[:, 1], 0.0, max_off)
        if trail is not None:
            trail.append((offx, offy, run))
        wa = torch.clamp(1.0 - torch.abs(ar[None, :] - offy[:, None]), min=0.0)
        wb = torch.clamp(1.0 - torch.abs(ar[None, :] - offx[:, None]), min=0.0)
        b1 = c1_const - torch.einsum("nab,na,nb->n", C1, wa, wb)
        b2 = c2_const - torch.einsum("nab,na,nb->n", C2, wa, wb)
        dx = gi11 * b1 + gi12 * b2
        dy = gi12 * b1 + gi22 * b2
        step = torch.stack([dx, dy], dim=-1)
        flow = flow + torch.where(run[:, None], step, torch.zeros_like(step))
        steps = steps + run.to(torch.int64)
        run = run & ((dx * dx + dy * dy) >= eps_sq)
    return flow, steps


def lk_xcorr_iterate_reference(C1, C2, c1_const, c2_const, gi11, gi12, gi22,
                               base_x, base_y, flow, active, *,
                               iterations: int, eps: float, max_off: float):
    """Plain PyTorch version of K2 (reference lk.py:439-458): the same
    function with the early exit replaced by ``iterations`` masked steps."""
    return xcorr_steps(C1, C2, c1_const, c2_const, gi11, gi12, gi22, base_x,
                       base_y, flow, active, iterations=iterations, eps=eps,
                       max_off=max_off)[0]


# --- the pyramid entry -------------------------------------------------------
#
# A pyramid argument is an ops.lk.LKPyramid; the checks, the launch and the
# glue are those of ``pyramid``, shared with K1's pyramid entry.

def lk_xcorr_pyramid(pyr_from, pyr_to, pts_from, pts_init, valid, *,
                     win: int, max_level: int, iterations: int, eps: float,
                     min_eig_threshold: float, bidirectional: bool,
                     fb_threshold: float):
    """Track pts_from [N, 2] (pyr_from's image) into pyr_to's image from
    pts_init, over levels max_level .. 0, with the jnp level in correlation
    form, for the features valid [N] bool selects; with ``bidirectional``,
    gate by the reverse track.
    Returns (points [N, 2], status [N] bool, err [N] level-0 min_eig).

    The custom op ``visfs_tpu_torch::lk_xcorr_pyramid`` (``pyramid_op``): one
    launch on CUDA tensors, the plain version on CPU tensors; under
    ``torch.func.vmap`` one launch with a stream axis for all streams."""
    return _LK_XCORR_PYRAMID(
        pyr_from, pyr_to, pts_from, pts_init, valid, win=win,
        max_level=max_level, iterations=iterations, eps=eps,
        min_eig_threshold=min_eig_threshold, bidirectional=bidirectional,
        fb_threshold=fb_threshold)


def lk_xcorr_pyramid_cuda(pyr_from, pyr_to, pts_from, pts_init, valid, *,
                          win: int, max_level: int, iterations: int,
                          eps: float, min_eig_threshold: float,
                          bidirectional: bool, fb_threshold: float):
    """Launch the pyramid entry, with a stream axis for planes [B, H, W]
    and points [B, N, 2] (raises when CUDA is absent or the launch
    fails)."""
    global PYR_LAUNCHES
    out = launch_pyr(build().visfs_lk_xcorr_pyr, "lk_xcorr_pyramid",
                     pyr_from, pyr_to, pts_from, pts_init, valid, win=win,
                     max_level=max_level, iterations=iterations, eps=eps,
                     min_eig_threshold=min_eig_threshold,
                     bidirectional=bidirectional, fb_threshold=fb_threshold)
    PYR_LAUNCHES += 1
    return out


def lk_xcorr_pyramid_reference(pyr_from, pyr_to, pts_from, pts_init, valid,
                               *, win: int, max_level: int, iterations: int,
                               eps: float, min_eig_threshold: float,
                               bidirectional: bool, fb_threshold: float,
                               levels: list | None = None):
    """Plain PyTorch version of the pyramid entry: per level
    ``jnp_level.level_setup``, ``jnp_level.xcorr_inputs`` and
    ``xcorr_steps`` (what ``ops.lk._track_level`` runs at iter_mode="xcorr"
    on the CPU), under the glue of lk_track_pyr /
    lk_track_bidirectional_pyr.  A ``levels`` list receives, per level and
    direction in the order run (forward levels max_level .. 0, then the
    reverse ones), the planes (from, to, gx, gy), the level-scale points,
    the active mask [N] bool, the level setup, the loop's arguments
    (``xcorr_inputs``), the steps and the step trail of ``xcorr_steps``."""

    def level_fn(img_from, img_to, gx, gy, pts_l, flow, active):
        s = level_setup(img_from, img_to, gx, gy, pts_l, flow, win=win,
                        min_eig_threshold=min_eig_threshold)
        args, kw = xcorr_inputs(s, pts_l, flow, active, win=win,
                                iterations=iterations, eps=eps)
        trail = None if levels is None else []
        flow, steps = xcorr_steps(*args, **kw, trail=trail)
        if levels is not None:
            levels.append(dict(planes=(img_from, img_to, gx, gy), pts=pts_l,
                               active=active, setup=s, args=args, kw=kw,
                               steps=steps, trail=trail))
        return flow, s.ok_g, s.min_eig

    track = functools.partial(track_pyramid, level_fn, win=win,
                              max_level=max_level)
    if not bidirectional:
        return track(pyr_from, pyr_to, pts_from, pts_init, valid)
    return track_bidirectional(track, pyr_from, pyr_to, pts_from, pts_init,
                               valid, fb_threshold)


_LK_XCORR_PYRAMID = pyramid_op("lk_xcorr_pyramid", lk_xcorr_pyramid_cuda,
                               lk_xcorr_pyramid_reference)
