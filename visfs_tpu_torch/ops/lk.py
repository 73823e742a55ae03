"""Batched pyramidal Lucas-Kanade optical flow (torch port of
visfs_tpu.ops.lk).

One formulation only: every pyramid level goes through K1
(``ops.kernels.lk_level``), the port of the reference's Pallas level kernel
(``LKParams(backend="pallas")`` in the reference).  The reference's other
formulations (jnp "direct" and "xcorr" iteration, matmul/gather region
extraction, unrolling) are TPU lowerings of the same tracker; their config
keys are accepted and change nothing here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .image import build_pyramid, edge_pad, scharr_gradients
from .kernels.lk_level import lk_level


@dataclasses.dataclass(frozen=True)
class LKParams:
    win_size: int = 21
    max_level: int = 3
    iterations: int = 30
    eps: float = 0.01
    min_eig_threshold: float = 1e-4

    @classmethod
    def from_config(cls, cfg) -> "LKParams":
        """LKParams of a VISFSConfig.  Tracker/FlowRegionExtract and
        Tracker/FlowUnroll select TPU formulations of the same result and
        are ignored; Tracker/FlowComputeDtype="bfloat16" (a measured
        negative result of the reference) is refused."""
        if cfg.tracker_flow_compute_dtype != "float32":
            raise ValueError(
                "Tracker/FlowComputeDtype: visfs_tpu_torch computes LK in "
                f"float32 only, got {cfg.tracker_flow_compute_dtype!r}")
        return cls(win_size=cfg.tracker_flow_win_size,
                   max_level=cfg.tracker_flow_max_level,
                   iterations=cfg.tracker_flow_iterations,
                   eps=cfg.tracker_flow_eps)


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


def lk_track_pyr(pyr_from: LKPyramid, pyr_to: LKPyramid, pts_from, pts_init,
                 valid_mask, params: LKParams = LKParams()) -> LKResult:
    """Track pts_from (in pyr_from's image) into pyr_to's image, starting
    from pts_init; valid_mask [N] selects the features to track."""
    h, w = pyr_from.height, pyr_from.width
    half = params.win_size // 2
    pad = pyr_from.pad
    flow = (pts_init - pts_from) / (2.0 ** params.max_level)
    ok = valid_mask
    min_eig = torch.zeros(pts_from.shape[0], dtype=torch.float32,
                          device=pts_from.device)
    for level in range(params.max_level, -1, -1):
        pts_l = (pts_from / (2.0 ** level) + pad).contiguous()
        flow, okf, min_eig = lk_level(
            pyr_from.levels[level], pyr_to.levels[level],
            pyr_from.gx[level], pyr_from.gy[level], pts_l, flow.contiguous(),
            ok.to(torch.float32).contiguous(),
            win=params.win_size, iterations=params.iterations, eps=params.eps,
            min_eig_threshold=params.min_eig_threshold)
        ok = ok & (okf > 0.0)
        if level > 0:
            flow = flow * 2.0
    pts_to = pts_from + flow
    inb = ((pts_to[:, 0] >= half) & (pts_to[:, 0] < w - half)
           & (pts_to[:, 1] >= half) & (pts_to[:, 1] < h - half))
    return LKResult(points=pts_to, status=ok & inb & valid_mask, err=min_eig)


def lk_track_bidirectional_pyr(pyr_from: LKPyramid, pyr_to: LKPyramid,
                               pts_from, pts_init, valid_mask,
                               params: LKParams = LKParams(),
                               fb_threshold: float = 1.5) -> LKResult:
    """Forward LK + reverse-flow consistency gate (Tracker.cpp:260-274)."""
    fwd = lk_track_pyr(pyr_from, pyr_to, pts_from, pts_init, valid_mask,
                       params)
    rev = lk_track_pyr(pyr_to, pyr_from, fwd.points, pts_from, fwd.status,
                       params)
    dist = torch.linalg.vector_norm(rev.points - pts_from, dim=-1)
    status = fwd.status & rev.status & (dist <= fb_threshold)
    return LKResult(points=fwd.points, status=status, err=fwd.err)
