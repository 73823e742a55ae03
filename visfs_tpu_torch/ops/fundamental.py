"""Batched fundamental-matrix RANSAC outlier culling (torch port of
visfs_tpu.ops.fundamental).

Replaces cv::findFundamentalMat(FM_RANSAC) as the reference's optional
track-culling path uses it (Tracker::rejectOutlierWithFundationMatrix,
corelib/src/Tracker.cpp:83-96, Tracker/CullByFundationMatrix): K
hypotheses at once, each a normalized 8-point solve on a sample drawn by
Gumbel top-8 from the threefry key, scored by the Sampson distance at the
pixel threshold (Tracker/FundationPixelError); the best hypothesis's inlier
set is returned.

No host synchronisation: where the reference calls ``eigh`` on the 9x9
normal matrices and ``svd`` on the 3x3 solutions (their CUDA versions wait
for the device to check for errors), the null vector comes from the
sync-free shifted inverse iteration of ``ops.pnp`` and the rank-2
projection from the closed-form 3x3 eigensolver: F - (F v3) v3^T, v3 the
smallest eigenvector of F^T F, which is F with its smallest singular value
set to zero.  The sign of the null vector does not change the Sampson
distance.
"""

from __future__ import annotations

import math

import torch

from ..core import prng
from .pnp import _smallest_two_eigvecs, sym_eigh_3x3


def _normalize(pts, mask):
    """Hartley normalization of the masked points: zero mean, sqrt(2) RMS
    radius.  Returns (normalized pts [N, 2], T [3, 3])."""
    w = mask.to(pts.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    d = torch.sqrt(torch.sum((pts - mean) ** 2, dim=-1))
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(d * w) / n, min=1e-9)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([torch.stack([scale, zero, -scale * mean[0]]),
                     torch.stack([zero, scale, -scale * mean[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - mean) * scale, T


def _eight_point(p1n, p2n, sel_w):
    """Weighted linear 8-point solves -> rank-2 F in normalized coordinates;
    sel_w [K, N] weights select each hypothesis's sample.  Returns [K, 3,
    3]."""
    x1, y1 = p1n[:, 0], p1n[:, 1]
    x2, y2 = p2n[:, 0], p2n[:, 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)  # [N, 9]
    A = A * sel_w[..., None]  # [K, N, 9]
    f, _ = _smallest_two_eigvecs(A.transpose(-1, -2) @ A, second=False)
    F = f.reshape(f.shape[:-1] + (3, 3))
    _, V = sym_eigh_3x3(F.transpose(-1, -2) @ F)
    v3 = V[..., :, 0:1]  # [K, 3, 1], the smallest eigenvector
    return F - (F @ v3) @ v3.transpose(-1, -2)


def sampson_distance(F, p1, p2):
    """Squared Sampson distance (pixel^2) of correspondences p1 <-> p2 [N,
    2] under F [..., 3, 3]; returns [..., N]."""
    ones = torch.ones_like(p1[:, :1])
    x1 = torch.cat([p1, ones], dim=-1)
    x2 = torch.cat([p2, ones], dim=-1)
    Fx1 = x1 @ F.transpose(-1, -2)  # [..., N, 3] = F x1
    Ftx2 = x2 @ F  # F^T x2
    num = torch.sum(x2 * Fx1, dim=-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def cull_with_fundamental(p1, p2, mask, key, threshold: float = 1.0,
                          hypotheses: int = 32):
    """RANSAC F-matrix inlier mask for correspondences p1 <-> p2 [N, 2]
    (pixels), mask [N] the valid ones, key a threefry key.  Returns
    (inlier mask [N], F [3, 3])."""
    N = p1.shape[0]
    dtype = p1.dtype
    p1n, T1 = _normalize(p1, mask)
    p2n, T2 = _normalize(p2, mask)

    g = prng.gumbel(key, (hypotheses, N), dtype=dtype)
    scores = torch.where(mask[None, :], g, torch.full_like(g, -math.inf))
    sel = torch.topk(scores, 8, dim=1).indices  # [K, 8]
    w = torch.zeros((hypotheses, N), dtype=dtype, device=p1.device)
    w = w.scatter(1, sel, 1.0) * mask.to(dtype)
    Fs = T2.T @ _eight_point(p1n, p2n, w) @ T1  # denormalized [K, 3, 3]
    thr2 = threshold * threshold
    counts = torch.sum((sampson_distance(Fs, p1, p2) <= thr2) & mask, dim=1)
    # the first maximum, as jnp.argmax; index_select, since a 0-d index
    # tensor would synchronise with the host
    F = Fs.index_select(0, torch.argmax(counts).reshape(1))[0]
    inliers = (sampson_distance(F, p1, p2) <= thr2) & mask
    return inliers, F
