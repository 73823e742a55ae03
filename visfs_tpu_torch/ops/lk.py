"""Batched pyramidal Lucas-Kanade optical flow (torch port of
visfs_tpu.ops.lk).

``LKParams.backend`` chooses the level formulation as the reference does
(``lk_track_pyr``):

* ``"pallas"``: K1 (``ops.kernels.lk_level``), the port of the reference's
  Pallas level kernel; ``lk_track_pyr`` and ``lk_track_bidirectional_pyr``
  are each one ``lk_pyramid`` call, every level and the per-feature glue
  (and the reverse track) in one launch.  ``System`` runs this
  (``LKParams.from_config``).
* any other backend: ``_track_level``, the reference's own jnp level — a
  (win+2)^2 setup region with bilinear tents, and a ±10 px search region of
  the `to` plane around the level's starting centre, in which the iteration
  loop runs in one of two forms (``iter_mode``): "direct" samples the patch
  every step (plain PyTorch on either device), "xcorr" builds per-feature
  correlation maps and runs the loop in K2 (``ops.kernels.lk_xcorr``).

The reference's region_extract / setup_region / unroll / compute_dtype
fields choose TPU lowerings of the same numbers: the port implements one
(index-gathered regions, ``iterations`` masked steps with no early exit on
the host) and has no such fields; their config keys are accepted and
ignored.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from .image import build_pyramid, edge_pad, scharr_gradients
from .kernels.lk_level import (lk_pyramid, track_bidirectional,
                                track_pyramid)
from .kernels.lk_xcorr import lk_xcorr_iterate

BACKENDS = ("jnp", "pallas", "jnp-xcorr", "pallas-xcorr")
ITER_MODES = ("direct", "xcorr")
# Search margin (px) of the jnp level's `to` region around its starting
# centre; a feature whose flow leaves it clamps to the region edge.
MARGIN = 10


@dataclasses.dataclass(frozen=True)
class LKParams:
    win_size: int = 21
    max_level: int = 3
    iterations: int = 30
    eps: float = 0.01
    min_eig_threshold: float = 1e-4
    # "pallas": K1 per level.  "jnp", "jnp-xcorr", "pallas-xcorr": the jnp
    # level (_track_level).  The reference's three names pick TPU lowerings
    # of the xcorr loop; here each runs K2 on CUDA tensors and its plain
    # version on CPU tensors.
    backend: str = "jnp"
    # Iteration loop of the jnp level: "direct" or "xcorr".
    iter_mode: str = "direct"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"LKParams.backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.iter_mode not in ITER_MODES:
            raise ValueError(f"LKParams.iter_mode must be one of "
                             f"{ITER_MODES}, got {self.iter_mode!r}")

    @classmethod
    def from_config(cls, cfg) -> "LKParams":
        """LKParams of a VISFSConfig, on K1 (``backend="pallas"``): the
        port's System runs its hand-written level kernel, the
        formulation whose semantics the reference's Pallas kernel fixes.
        Tracker/FlowRegionExtract and Tracker/FlowUnroll select TPU
        formulations of the same result and are ignored;
        Tracker/FlowComputeDtype="bfloat16" (a measured negative result of
        the reference) is refused."""
        if cfg.tracker_flow_compute_dtype != "float32":
            raise ValueError(
                "Tracker/FlowComputeDtype: visfs_tpu_torch computes LK in "
                f"float32 only, got {cfg.tracker_flow_compute_dtype!r}")
        return cls(win_size=cfg.tracker_flow_win_size,
                   max_level=cfg.tracker_flow_max_level,
                   iterations=cfg.tracker_flow_iterations,
                   eps=cfg.tracker_flow_eps, backend="pallas")


class LKResult(NamedTuple):
    points: torch.Tensor  # [N, 2] tracked positions in `to` image
    status: torch.Tensor  # [N] bool
    err: torch.Tensor  # [N] min-eigenvalue error measure


class LKPyramid(NamedTuple):
    """Padded image pyramid + Scharr gradients, shared by the LK passes."""

    levels: tuple  # per level: padded image [Hl+2p, Wl+2p]
    gx: tuple  # per level: Scharr x-gradient of the padded image
    gy: tuple
    height: int  # unpadded level-0 dims
    width: int
    pad: int


def lk_pad(params: LKParams) -> int:
    """Border padding of LK pyramid levels (window radius + interpolation
    guard); the carried-pyramid state is sized with exactly this value."""
    return params.win_size // 2 + 2


def build_lk_pyramid(img, params: LKParams = LKParams()) -> LKPyramid:
    """Padded pyramid + gradients for use as either `from` or `to` image."""
    pad = lk_pad(params)
    levels, gxs, gys = [], [], []
    for im in build_pyramid(img, params.max_level):
        imp = edge_pad(im, pad)
        gx, gy = scharr_gradients(imp)
        levels.append(imp.contiguous())
        gxs.append(gx.contiguous())
        gys.append(gy.contiguous())
    h, w = img.shape
    return LKPyramid(tuple(levels), tuple(gxs), tuple(gys), h, w, pad)


# --- the jnp level (reference ops/lk.py:_track_level) ----------------------

class LevelSetup(NamedTuple):
    """What _track_level computes before its iteration loop."""

    patch_i: torch.Tensor  # [N, win, win] bilinear patch of `from`
    gx: torch.Tensor  # [N, win, win] patches of the gradients
    gy: torch.Tensor
    gi11: torch.Tensor  # [N] entries of G^-1 (det-scaled)
    gi12: torch.Tensor
    gi22: torch.Tensor
    ok_g: torch.Tensor  # [N] bool
    min_eig: torch.Tensor  # [N]
    region: torch.Tensor  # [N, R, R] `to` plane, R = win + 1 + 2 MARGIN
    origin: torch.Tensor  # [N, 2] (x, y) corner of region, float


def _regions(plane, iy, ix, size: int):
    """[N, size, size] integer-aligned regions of ``plane`` at corners
    (ix, iy); rows or columns outside the plane read 0 (as the reference's
    one-hot selector extraction does when the plane is smaller than the
    region)."""
    h, w = plane.shape[-2:]
    taps = torch.arange(size, device=plane.device)
    rows = iy[:, None] + taps
    cols = ix[:, None] + taps
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w))[:, None, :])
    vals = plane[..., rows.clamp(0, h - 1)[:, :, None],
                 cols.clamp(0, w - 1)[:, None, :]]
    return torch.where(inside, vals, torch.zeros((), device=plane.device))


def _tents(off, win: int, size: int):
    """[N, win, size] bilinear tent selectors max(0, 1 - |r - (off + p)|)."""
    taps_r = torch.arange(size, dtype=torch.float32, device=off.device)
    taps_p = torch.arange(win, dtype=torch.float32, device=off.device)
    return torch.clamp(1.0 - torch.abs(
        taps_r[None, None, :] - (off[:, None, None] + taps_p[None, :, None])),
        min=0.0)


def level_setup(img_from, img_to, grad_x, grad_y, pts_from, flow,
                params: LKParams) -> LevelSetup:
    """Setup of one jnp LK level (reference lk.py:170-308): patches, G,
    min_eig, ok and G^-1 from a (win+2)^2 region of the `from` planes, and
    the `to` region around pts_from + flow."""
    win = params.win_size
    half = win // 2
    h, w = img_from.shape
    x0 = torch.clamp(pts_from[:, 0] - half, 0.0, w - win - 1.0)
    y0 = torch.clamp(pts_from[:, 1] - half, 0.0, h - win - 1.0)
    rs = win + 2
    six = torch.clamp(torch.floor(x0).to(torch.int64), 0, w - rs)
    siy = torch.clamp(torch.floor(y0).to(torch.int64), 0, h - rs)
    reg3 = _regions(torch.stack([img_from, grad_x, grad_y]), siy, six, rs)
    sy = _tents(y0 - siy.to(torch.float32), win, rs)  # [N, win, Rs]
    sx = _tents(x0 - six.to(torch.float32), win, rs)
    patches = (sy @ reg3) @ sx.transpose(1, 2)  # [3, N, win, win]
    patch_i, gx, gy = patches.unbind(0)
    g11 = torch.sum(gx * gx, dim=(1, 2))
    g12 = torch.sum(gx * gy, dim=(1, 2))
    g22 = torch.sum(gy * gy, dim=(1, 2))
    det = g11 * g22 - g12 * g12
    trace = g11 + g22
    min_eig = (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det,
                                              min=0.0))) * 0.5 / (win * win)
    ok_g = (min_eig > params.min_eig_threshold) & (det > 1e-12)
    inv_det = 1.0 / torch.where(det > 1e-12, det, torch.ones_like(det))

    r = win + 1 + 2 * MARGIN
    ctr = pts_from + flow
    oix = torch.clamp(torch.floor(ctr[:, 0]).to(torch.int64) - half - MARGIN,
                      0, w - r)
    oiy = torch.clamp(torch.floor(ctr[:, 1]).to(torch.int64) - half - MARGIN,
                      0, h - r)
    return LevelSetup(
        patch_i=patch_i, gx=gx, gy=gy, gi11=g22 * inv_det,
        gi12=-g12 * inv_det, gi22=g11 * inv_det, ok_g=ok_g, min_eig=min_eig,
        region=_regions(img_to, oiy, oix, r),
        origin=torch.stack([oix, oiy], dim=-1).to(torch.float32))


def _iterate_direct(s: LevelSetup, pts_from, flow, active, params: LKParams):
    """The direct loop (reference lk.py:318-376): sample the `to` patch
    from the region at the clamped offset every step, as ``iterations``
    masked steps."""
    win = params.win_size
    half = win // 2
    size = s.region.shape[1]
    max_off = float(size - win - 1)
    eps_sq = params.eps * params.eps
    run = active & s.ok_g
    for _ in range(params.iterations):
        offx = torch.clamp(pts_from[:, 0] + flow[:, 0] - half - s.origin[:, 0],
                           0.0, max_off)
        offy = torch.clamp(pts_from[:, 1] + flow[:, 1] - half - s.origin[:, 1],
                           0.0, max_off)
        patch_j = (_tents(offy, win, size) @ s.region) \
            @ _tents(offx, win, size).transpose(1, 2)
        diff = s.patch_i - patch_j
        b1 = torch.sum(diff * s.gx, dim=(1, 2))
        b2 = torch.sum(diff * s.gy, dim=(1, 2))
        dx = s.gi11 * b1 + s.gi12 * b2
        dy = s.gi12 * b1 + s.gi22 * b2
        step = torch.stack([dx, dy], dim=-1)
        flow = flow + torch.where(run[:, None], step, torch.zeros_like(step))
        run = run & ((dx * dx + dy * dy) >= eps_sq)
    return flow


def _xcorr_maps(region, gx, gy, win: int):
    """Per-feature cross-correlation maps of the `to` region against the
    `from` gradients: C[n,a,b] = sum_pq region[n,a+p,b+q] * g[n,p,q], both
    [N, A, A] with A = R - win + 1 (reference lk.py:_xcorr_maps).

    One batched product contracts p over the row-shifted view of the
    region, then one strided view sums the win column diagonals."""
    n, r, _ = region.shape
    a = r - win + 1
    region = region.contiguous()
    # shifted[n, a, c, p] = region[n, a + p, c]
    shifted = region.as_strided((n, a, r, win), (r * r, r, 1, r))
    y = shifted.reshape(n, a * r, win) @ torch.cat([gx, gy], dim=2)
    y = y.reshape(n, a, r, 2, win)  # y[n, a, c, k, q], contiguous
    # diag[n, a, b, k, q] = y[n, a, b + q, k, q]
    diag = y.as_strided((n, a, a, 2, win),
                        (a * r * 2 * win, r * 2 * win, 2 * win, win,
                         2 * win + 1))
    c1, c2 = torch.movedim(diag.sum(dim=-1), -1, 0).contiguous()
    return c1, c2


def xcorr_inputs(s: LevelSetup, pts_from, flow, active, params: LKParams):
    """The arguments of K2 for one level (reference lk.py:409-437):
    (positional tuple, keyword dict) of ``lk_xcorr_iterate``."""
    win = params.win_size
    half = win // 2
    c1, c2 = _xcorr_maps(s.region, s.gx, s.gy, win)
    args = (c1, c2, torch.sum(s.patch_i * s.gx, dim=(1, 2)),
            torch.sum(s.patch_i * s.gy, dim=(1, 2)), s.gi11, s.gi12, s.gi22,
            pts_from[:, 0] - half - s.origin[:, 0],
            pts_from[:, 1] - half - s.origin[:, 1], flow.contiguous(),
            active & s.ok_g)
    kw = dict(iterations=params.iterations, eps=params.eps,
              max_off=float(s.region.shape[1] - win - 1))
    return args, kw


def _track_level(img_from, img_to, grad_x, grad_y, pts_from, flow, active,
                 params: LKParams):
    """One jnp pyramid level of LK for all features; pts_from and flow
    [N, 2] at this level's scale, active [N] bool.
    Returns (flow, ok, min_eig)."""
    s = level_setup(img_from, img_to, grad_x, grad_y, pts_from, flow, params)
    if params.iter_mode == "xcorr":
        args, kw = xcorr_inputs(s, pts_from, flow, active, params)
        flow = lk_xcorr_iterate(*args, **kw)
    else:
        flow = _iterate_direct(s, pts_from, flow, active, params)
    return flow, s.ok_g, s.min_eig


# --- pyramidal tracking ------------------------------------------------------

def _k1_pyramid(pyr_from, pyr_to, pts_from, pts_init, valid_mask,
                params: LKParams, bidirectional: bool,
                fb_threshold: float) -> LKResult:
    return LKResult(*lk_pyramid(
        pyr_from, pyr_to, pts_from, pts_init, valid_mask,
        win=params.win_size, max_level=params.max_level,
        iterations=params.iterations, eps=params.eps,
        min_eig_threshold=params.min_eig_threshold,
        bidirectional=bidirectional, fb_threshold=fb_threshold))


def _jnp_track(params: LKParams):
    """(pyr_from, pyr_to, pts_from, pts_init, valid) -> (points, status,
    err): the pyramid glue around the jnp level."""
    return functools.partial(
        track_pyramid, functools.partial(_track_level, params=params),
        win=params.win_size, max_level=params.max_level)


def lk_track_pyr(pyr_from: LKPyramid, pyr_to: LKPyramid, pts_from, pts_init,
                 valid_mask, params: LKParams = LKParams()) -> LKResult:
    """Track pts_from (in pyr_from's image) into pyr_to's image, starting
    from pts_init; valid_mask [N] selects the features to track."""
    if params.backend == "pallas":
        return _k1_pyramid(pyr_from, pyr_to, pts_from, pts_init, valid_mask,
                           params, False, 0.0)
    return LKResult(*_jnp_track(params)(pyr_from, pyr_to, pts_from, pts_init,
                                        valid_mask))


def lk_track_bidirectional_pyr(pyr_from: LKPyramid, pyr_to: LKPyramid,
                               pts_from, pts_init, valid_mask,
                               params: LKParams = LKParams(),
                               fb_threshold: float = 1.5) -> LKResult:
    """Forward LK + reverse-flow consistency gate (Tracker.cpp:260-274)."""
    if params.backend == "pallas":
        return _k1_pyramid(pyr_from, pyr_to, pts_from, pts_init, valid_mask,
                           params, True, fb_threshold)
    return LKResult(*track_bidirectional(
        _jnp_track(params), pyr_from, pyr_to, pts_from, pts_init, valid_mask,
        fb_threshold))


def lk_track(img_from, img_to, pts_from, pts_init, valid_mask,
             params: LKParams = LKParams()) -> LKResult:
    """lk_track_pyr on freshly built pyramids (standalone convenience)."""
    return lk_track_pyr(build_lk_pyramid(img_from, params),
                        build_lk_pyramid(img_to, params), pts_from, pts_init,
                        valid_mask, params)


def lk_track_bidirectional(img_from, img_to, pts_from, pts_init, valid_mask,
                           params: LKParams = LKParams(),
                           fb_threshold: float = 1.5) -> LKResult:
    """lk_track_bidirectional_pyr on freshly built pyramids."""
    return lk_track_bidirectional_pyr(
        build_lk_pyramid(img_from, params), build_lk_pyramid(img_to, params),
        pts_from, pts_init, valid_mask, params, fb_threshold=fb_threshold)
