"""The reference's jnp LK level before its iteration loop, in plain PyTorch
(reference ``visfs_tpu/ops/lk.py``: ``_track_level``'s setup,
``_xcorr_maps`` and the arguments of ``_iterate_xcorr``).

``ops.lk`` runs it under both iteration forms; K2's plain version
(``lk_xcorr.lk_xcorr_pyramid_reference``) runs it before the loop, and
K2's pyramid kernel computes the same numbers in the block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Search margin (px) of the `to` region around the level's starting centre;
# a feature whose flow leaves it clamps to the region edge.
MARGIN = 10


class LevelSetup(NamedTuple):
    """What the jnp level computes before its iteration loop."""

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


def regions(plane, iy, ix, size: int):
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


def tents(off, win: int, size: int):
    """[N, win, size] bilinear tent selectors max(0, 1 - |r - (off + p)|)."""
    taps_r = torch.arange(size, dtype=torch.float32, device=off.device)
    taps_p = torch.arange(win, dtype=torch.float32, device=off.device)
    return torch.clamp(1.0 - torch.abs(
        taps_r[None, None, :] - (off[:, None, None] + taps_p[None, :, None])),
        min=0.0)


def level_setup(img_from, img_to, grad_x, grad_y, pts_from, flow, *,
                win: int, min_eig_threshold: float) -> LevelSetup:
    """Setup of one jnp LK level (reference lk.py:170-308): patches, G,
    min_eig, ok and G^-1 from a (win+2)^2 region of the `from` planes, and
    the `to` region around pts_from + flow."""
    half = win // 2
    h, w = img_from.shape
    x0 = torch.clamp(pts_from[:, 0] - half, 0.0, w - win - 1.0)
    y0 = torch.clamp(pts_from[:, 1] - half, 0.0, h - win - 1.0)
    rs = win + 2
    six = torch.clamp(torch.floor(x0).to(torch.int64), 0, w - rs)
    siy = torch.clamp(torch.floor(y0).to(torch.int64), 0, h - rs)
    reg3 = regions(torch.stack([img_from, grad_x, grad_y]), siy, six, rs)
    sy = tents(y0 - siy.to(torch.float32), win, rs)  # [N, win, Rs]
    sx = tents(x0 - six.to(torch.float32), win, rs)
    patches = (sy @ reg3) @ sx.transpose(1, 2)  # [3, N, win, win]
    patch_i, gx, gy = patches.unbind(0)
    g11 = torch.sum(gx * gx, dim=(1, 2))
    g12 = torch.sum(gx * gy, dim=(1, 2))
    g22 = torch.sum(gy * gy, dim=(1, 2))
    det = g11 * g22 - g12 * g12
    trace = g11 + g22
    min_eig = (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det,
                                              min=0.0))) * 0.5 / (win * win)
    ok_g = (min_eig > min_eig_threshold) & (det > 1e-12)
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
        region=regions(img_to, oiy, oix, r),
        origin=torch.stack([oix, oiy], dim=-1).to(torch.float32))


def xcorr_maps(region, gx, gy, win: int):
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


def xcorr_inputs(s: LevelSetup, pts_from, flow, active, *, win: int,
                 iterations: int, eps: float):
    """The arguments of K2's loop for one level (reference lk.py:409-437):
    (positional tuple, keyword dict) of ``lk_xcorr.lk_xcorr_iterate``."""
    half = win // 2
    c1, c2 = xcorr_maps(s.region, s.gx, s.gy, win)
    args = (c1, c2, torch.sum(s.patch_i * s.gx, dim=(1, 2)),
            torch.sum(s.patch_i * s.gy, dim=(1, 2)), s.gi11, s.gi12, s.gi22,
            pts_from[:, 0] - half - s.origin[:, 0],
            pts_from[:, 1] - half - s.origin[:, 1], flow.contiguous(),
            active & s.ok_g)
    kw = dict(iterations=iterations, eps=eps,
              max_off=float(s.region.shape[1] - win - 1))
    return args, kw
