"""Good-features-to-track corner detection (torch port of
visfs_tpu.ops.gftt).

Shi-Tomasi score from Sobel gradients and a 3x3 block sum, 3x3 non-max
suppression, a quality gate relative to the best score, one candidate per
half-min-distance cell, suppression around tracked and blocked features,
six rounds of iterated greedy min-distance selection on the cell grid, and
the top-K by score.  Ties resolve to the lowest index, as ``jnp.argmax``
and ``lax.top_k`` do (first-maximum argmax, stable descending sort).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .image import box_filter, sobel_gradients

_OFFSETS = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
            if (dy, dx) != (0, 0)]


class GFTTResult(NamedTuple):
    points: torch.Tensor  # [K, 2] (x, y), score-sorted descending
    scores: torch.Tensor  # [K]
    valid: torch.Tensor  # [K] bool


def min_eig_score(img):
    """Shi-Tomasi response map (cv::cornerMinEigenVal, blockSize=3)."""
    ix, iy = sobel_gradients(img)
    ixx = box_filter(ix * ix, 3)
    iyy = box_filter(iy * iy, 3)
    ixy = box_filter(ix * iy, 3)
    half_tr = 0.5 * (ixx + iyy)
    half_diff = 0.5 * (ixx - iyy)
    return half_tr - torch.sqrt(half_diff * half_diff + ixy * ixy)


def _neighbours(a, fill):
    """[24, gh, gw]: for each 5x5 offset (dy, dx) != 0, result[o, y, x] =
    a[y + dy, x + dx], or ``fill`` off the grid."""
    gh, gw = a.shape
    ap = torch.full((gh + 4, gw + 4), fill, dtype=a.dtype, device=a.device)
    ap[2:gh + 2, 2:gw + 2] = a
    return torch.stack([ap[2 + dy:2 + dy + gh, 2 + dx:2 + dx + gw]
                        for dy, dx in _OFFSETS])


def _suppress(cand, cand_valid, pts, mask, radius: float):
    d2 = torch.sum((cand[:, None, :] - pts[None, :, :]) ** 2, dim=-1)
    near = torch.any((d2 < radius * radius) & mask[None, :], dim=1)
    return cand_valid & ~near


def gftt_detect(img, max_corners: int, quality_level: float,
                min_distance: int, existing_pts=None, existing_mask=None,
                blocked_pts=None, blocked_mask=None,
                border: int = 12) -> GFTTResult:
    """Detect up to max_corners new corners, min_distance away from the
    existing features and min_distance/2 away from blocked ones."""
    h, w = img.shape
    dev = img.device
    score = min_eig_score(img)

    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) \
        & (xs < w - border)
    zero = torch.zeros_like(score)
    score = torch.where(inside, score, zero)

    # 3x3 non-max suppression with -inf padding.
    ninf = float("-inf")
    rowp = torch.nn.functional.pad(score, (0, 0, 1, 1), value=ninf)
    rowmax = torch.maximum(torch.maximum(rowp[:-2], rowp[1:-1]), rowp[2:])
    colp = torch.nn.functional.pad(rowmax, (1, 1, 0, 0), value=ninf)
    neigh = torch.maximum(torch.maximum(colp[:, :-2], colp[:, 1:-1]),
                          colp[:, 2:])
    score = torch.where(score >= neigh, score, zero)

    thresh = quality_level * torch.max(score)
    score = torch.where(score >= thresh, score, zero)

    # One candidate per half-min-distance cell.
    cell = max((int(min_distance) + 1) // 2, 1)
    gh, gw = h // cell, w // cell
    cells = score[:gh * cell, :gw * cell].reshape(gh, cell, gw, cell)
    cells = cells.permute(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    best = torch.argmax(cells, dim=1)
    best_score = torch.gather(cells, 1, best[:, None])[:, 0]
    lin = torch.arange(gh * gw, device=dev)
    cy = best // cell + (lin // gw) * cell
    cx = best % cell + (lin % gw) * cell
    cand = torch.stack([cx, cy], dim=-1).to(img.dtype)
    cand_valid = best_score > 0.0

    if existing_pts is not None:
        cand_valid = _suppress(cand, cand_valid, existing_pts, existing_mask,
                               float(min_distance))
    if blocked_pts is not None:
        cand_valid = _suppress(cand, cand_valid, blocked_pts, blocked_mask,
                               float(min_distance) / 2.0)

    # Iterated greedy min-distance selection on the cell grid.  Distances
    # and the better-neighbour order are fixed across rounds, so they are
    # computed once for the 24 offsets of the 5x5 cell neighbourhood.
    gs = best_score.reshape(gh, gw)
    gxp = cand[:, 0].reshape(gh, gw)
    gyp = cand[:, 1].reshape(gh, gw)
    glin = lin.reshape(gh, gw)
    ns = _neighbours(gs, ninf)
    nx = _neighbours(gxp, 1e9)
    ny = _neighbours(gyp, 1e9)
    nl = _neighbours(glin, -1)
    md2 = float(min_distance) ** 2
    close = ((nx - gxp) ** 2 + (ny - gyp) ** 2) < md2
    better = (ns > gs) | ((ns == gs) & (nl < glin))
    close_better = close & better
    alive = cand_valid.reshape(gh, gw)
    selected = torch.zeros_like(alive)
    for _ in range(6):
        has_better = torch.any(_neighbours(alive, False) & close_better, 0)
        selected = selected | (alive & ~has_better)
        kill = torch.any(_neighbours(selected, False) & close, 0)
        alive = alive & ~selected & ~kill
    cand_valid = selected.reshape(gh * gw)

    # Top-K by score (stable descending sort: lower index first on ties).
    ranked = torch.where(cand_valid, best_score,
                         torch.full_like(best_score, ninf))
    k = min(max_corners, ranked.shape[0])
    top_scores, top_idx = torch.sort(ranked, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    top_pts = cand[top_idx]
    top_valid = torch.isfinite(top_scores) & (top_scores > 0.0)
    if k < max_corners:
        pad = max_corners - k
        top_pts = torch.cat([top_pts, top_pts.new_zeros((pad, 2))])
        top_scores = torch.cat([top_scores,
                                top_scores.new_full((pad,), ninf)])
        top_valid = torch.cat([top_valid, top_valid.new_zeros(pad)])
    return GFTTResult(points=top_pts, scores=top_scores, valid=top_valid)
