"""Batched pyramidal Lucas-Kanade optical flow (torch port of
visfs_tpu.ops.lk).

``LKParams.backend`` chooses the level formulation as the reference does
(``lk_track_pyr``):

* ``"pallas"``: K1 (``ops.kernels.lk_level``), the port of the reference's
  Pallas level kernel; ``lk_track_pyr`` and ``lk_track_bidirectional_pyr``
  are each one ``lk_pyramid`` call, every level and the per-feature glue
  (and the reverse track) in one launch.  ``System`` runs this
  (``LKParams.from_config``).
* any other backend: the reference's own jnp level (``_track_level``) — a
  (win+2)^2 setup region with bilinear tents, and a ±10 px search region of
  the `to` plane around the level's starting centre, in which the iteration
  loop runs in one of two forms (``iter_mode``): "direct" samples the patch
  every step (plain PyTorch on either device, under the glue of
  ``track_pyramid``); "xcorr" builds per-feature correlation maps and runs
  the loop on them, and there ``lk_track_pyr`` and
  ``lk_track_bidirectional_pyr`` are each one ``lk_xcorr_pyramid`` call
  (K2, ``ops.kernels.lk_xcorr``): every level's setup, maps and loop and
  the glue (and the reverse track) in one launch.

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
from .kernels import jnp_level
# The jnp level's pieces; MARGIN, LevelSetup and _xcorr_maps are also this
# module's interface to it.
from .kernels.jnp_level import MARGIN, LevelSetup
from .kernels.jnp_level import tents as _tents
from .kernels.jnp_level import xcorr_maps as _xcorr_maps
from .kernels.lk_level import lk_pyramid
from .kernels.lk_xcorr import lk_xcorr_iterate, lk_xcorr_pyramid
from .kernels.pyramid import track_bidirectional, track_pyramid

BACKENDS = ("jnp", "pallas", "jnp-xcorr", "pallas-xcorr")
ITER_MODES = ("direct", "xcorr")


@dataclasses.dataclass(frozen=True)
class LKParams:
    win_size: int = 21
    max_level: int = 3
    iterations: int = 30
    eps: float = 0.01
    min_eig_threshold: float = 1e-4
    # "pallas": K1.  "jnp", "jnp-xcorr", "pallas-xcorr": the jnp level
    # (_track_level).  The reference's three names pick TPU lowerings of
    # the xcorr loop; here each runs K2 on CUDA tensors and its plain
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
#
# Its setup, maps and loop arguments are ``kernels.jnp_level``'s (K2's plain
# version runs them too); these two take them with an LKParams.

def level_setup(img_from, img_to, grad_x, grad_y, pts_from, flow,
                params: LKParams) -> LevelSetup:
    """Setup of one jnp LK level (``jnp_level.level_setup``)."""
    return jnp_level.level_setup(
        img_from, img_to, grad_x, grad_y, pts_from, flow,
        win=params.win_size, min_eig_threshold=params.min_eig_threshold)


def xcorr_inputs(s: LevelSetup, pts_from, flow, active, params: LKParams):
    """The arguments of K2's loop for one level
    (``jnp_level.xcorr_inputs``)."""
    return jnp_level.xcorr_inputs(s, pts_from, flow, active,
                                  win=params.win_size,
                                  iterations=params.iterations,
                                  eps=params.eps)


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

def _fused_pyramid(pyr_from, pyr_to, pts_from, pts_init, valid_mask,
                   params: LKParams, bidirectional: bool,
                   fb_threshold: float) -> LKResult | None:
    """The track as one launch of a pyramid entry: K1's at backend
    "pallas", K2's in correlation form; None for the direct jnp level."""
    if params.backend == "pallas":
        entry = lk_pyramid
    elif params.iter_mode == "xcorr":
        entry = lk_xcorr_pyramid
    else:
        return None
    return LKResult(*entry(
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
    fused = _fused_pyramid(pyr_from, pyr_to, pts_from, pts_init, valid_mask,
                           params, False, 0.0)
    if fused is not None:
        return fused
    return LKResult(*_jnp_track(params)(pyr_from, pyr_to, pts_from, pts_init,
                                        valid_mask))


def lk_track_bidirectional_pyr(pyr_from: LKPyramid, pyr_to: LKPyramid,
                               pts_from, pts_init, valid_mask,
                               params: LKParams = LKParams(),
                               fb_threshold: float = 1.5) -> LKResult:
    """Forward LK + reverse-flow consistency gate (Tracker.cpp:260-274)."""
    fused = _fused_pyramid(pyr_from, pyr_to, pts_from, pts_init, valid_mask,
                           params, True, fb_threshold)
    if fused is not None:
        return fused
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
