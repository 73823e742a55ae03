"""Image primitives: separable filters, pyramids, gradients
(torch port of visfs_tpu.ops.image).

Images are single-channel float32 [H, W] tensors in [0, 255].  Every filter
replicates the edge, like the reference.  ``pyr_down`` is the 5-tap
binomial stencil with edge replication and 2x decimation — the same function
the reference expresses as two banded matmuls (a TPU lowering).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lie import fma

_BINOMIAL5 = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _edge_index(n: int, pad: int, device):
    return torch.clamp(torch.arange(-pad, n + pad, device=device), 0, n - 1)


def _conv1d(img, kernel, axis: int):
    """'same' correlation with edge replication along one axis; taps summed
    left to right like the reference's shift-and-add."""
    k = len(kernel)
    pad = k // 2
    n = img.shape[axis]
    img_p = torch.index_select(img, axis, _edge_index(n, pad, img.device))
    out = kernel[0] * img_p.narrow(axis, 0, n)
    for i in range(1, k):
        out = out + kernel[i] * img_p.narrow(axis, i, n)
    return out


def sep_filter(img, kv, kh):
    """Apply vertical kernel kv then horizontal kernel kh."""
    return _conv1d(_conv1d(img, kv, 0), kh, 1)


def gaussian5(img):
    """5x5 binomial blur (the pyrDown kernel)."""
    return sep_filter(img, _BINOMIAL5, _BINOMIAL5)


def _pyr_down_axis(img, axis: int):
    n = img.shape[axis]
    n_out = (n + 1) // 2
    base = 2 * torch.arange(n_out, device=img.device) - 2
    out = None
    for j, wgt in enumerate(_BINOMIAL5):
        tap = torch.index_select(img, axis, torch.clamp(base + j, 0, n - 1))
        out = wgt * tap if out is None else out + wgt * tap
    return out


def pyr_down(img):
    """Blur + 2x decimate (cv::pyrDown semantics, output size ceil(n/2))."""
    return _pyr_down_axis(_pyr_down_axis(img, 0), 1)


def build_pyramid(img, max_level: int):
    """List of images, level 0 = full resolution ... max_level coarsest."""
    levels = [img]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1]))
    return levels


def scharr_gradients(img):
    """Scharr 3x3 x/y gradients scaled like cv::Scharr inside LK."""
    smooth = (3.0 / 16, 10.0 / 16, 3.0 / 16)
    diff = (-0.5, 0.0, 0.5)
    return sep_filter(img, smooth, diff), sep_filter(img, diff, smooth)


def sobel_gradients(img):
    """Sobel 3x3 gradients (used by the GFTT min-eigenvalue score)."""
    smooth = (1.0, 2.0, 1.0)
    diff = (-1.0, 0.0, 1.0)
    return sep_filter(img, smooth, diff), sep_filter(img, diff, smooth)


def box_filter(img, size: int):
    """size x size box sum (not normalized)."""
    k = (1.0,) * size
    return sep_filter(img, k, k)


def edge_pad(img, pad: int):
    """Pad both axes by ``pad`` with edge replication (jnp.pad mode="edge")."""
    h, w = img.shape
    rows = _edge_index(h, pad, img.device)
    cols = _edge_index(w, pad, img.device)
    return img[rows[:, None], cols[None, :]]


def extract_patch_bilinear(img, center, size: int):
    """Bilinearly interpolated size x size patches at ``center`` [..., 2]
    (x, y): [..., size, size] (row = y, col = x), one per centre.

    A patch samples center + (dx, dy) for dx, dy from -(size//2) to
    size - 1 - size//2.  The weights come from the unclamped corner; the
    integer corner is clamped to [0, w - size - 1] (and the rows alike), so
    a patch near the border reads the border region with the same weights,
    as the reference's dynamic_slice does."""
    h, w = img.shape
    half = size // 2
    x0 = center[..., 0] - half
    y0 = center[..., 1] - half
    fx0 = torch.floor(x0)
    fy0 = torch.floor(y0)
    fx = (x0 - fx0)[..., None, None]
    fy = (y0 - fy0)[..., None, None]
    ix = torch.clamp(fx0.long(), 0, w - size - 1)
    iy = torch.clamp(fy0.long(), 0, h - size - 1)
    taps = torch.arange(size + 1, device=img.device)
    region = img[(iy[..., None] + taps)[..., :, None],
                 (ix[..., None] + taps)[..., None, :]]
    return ((1 - fx) * (1 - fy) * region[..., :-1, :-1]
            + fx * (1 - fy) * region[..., :-1, 1:]
            + (1 - fx) * fy * region[..., 1:, :-1]
            + fx * fy * region[..., 1:, 1:])


def in_bounds(pts, width, height, margin=0.0):
    """[..., 2] (x, y) points inside the image with a margin."""
    x, y = pts[..., 0], pts[..., 1]
    return ((x >= margin) & (x < width - margin) & (y >= margin)
            & (y < height - margin))


def clahe_luts(img, clip_limit: float = 3.0, grid: int = 8,
               n_bins: int = 256):
    """CLAHE's per-tile look-up tables [grid, grid, n_bins]: each tile's
    histogram clipped at clip_limit times the mean bin, the excess spread
    evenly, and its CDF scaled to [0, n_bins - 1]."""
    h, w = img.shape
    th, tw = h // grid, w // grid
    tiles = img[:th * grid, :tw * grid].reshape(grid, th, grid, tw)
    tiles = tiles.permute(0, 2, 1, 3).reshape(grid * grid, th * tw)
    bins = torch.clamp(tiles.to(torch.int64), 0, n_bins - 1)
    # adds of 1.0: exact counts below 2^24
    hist = torch.zeros((grid * grid, n_bins), dtype=torch.float32,
                       device=img.device).scatter_add(
                           1, bins, torch.ones_like(tiles))
    clip = clip_limit * (th * tw) / n_bins
    excess = torch.sum(torch.clamp(hist - clip, min=0.0), dim=1,
                       keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess / n_bins
    cdf = torch.cumsum(hist, dim=1)
    cdf = cdf / cdf[:, -1:]
    return (cdf * (n_bins - 1)).reshape(grid, grid, n_bins)


def clahe(img, clip_limit: float = 3.0, grid: int = 8, n_bins: int = 256):
    """Contrast-limited adaptive histogram equalization (System.cpp:107-111),
    cv::createCLAHE(3.0, (8, 8)) in fixed shapes: per-tile clipped
    histograms -> CDF look-up tables, interpolated bilinearly between tile
    centres.  Tiles cover the first (H // grid) * grid rows and
    (W // grid) * grid columns; values in [0, 255]; float32 out."""
    h, w = img.shape
    th, tw = h // grid, w // grid
    dev = img.device
    luts = clahe_luts(img, clip_limit, grid, n_bins)

    # Rounded as the reference's compiled program rounds them: the constant
    # divisors as products with their float32 reciprocals, and each
    # weighted pair of taps as one fused multiply-add (fma(1 - f, a, f b)).
    ys = (torch.arange(h, dtype=torch.float32, device=dev) - th / 2) \
        * float(np.float32(1.0) / np.float32(th))
    xs = (torch.arange(w, dtype=torch.float32, device=dev) - tw / 2) \
        * float(np.float32(1.0) / np.float32(tw))
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, grid - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, grid - 1)
    y1 = torch.clamp(y0 + 1, 0, grid - 1)
    x1 = torch.clamp(x0 + 1, 0, grid - 1)
    fy = torch.clamp(ys - y0.to(torch.float32), 0.0, 1.0)[:, None]
    fx = torch.clamp(xs - x0.to(torch.float32), 0.0, 1.0)[None, :]
    v = torch.clamp(img.to(torch.int64), 0, n_bins - 1)
    lut00 = luts[y0[:, None], x0[None, :], v]
    lut01 = luts[y0[:, None], x1[None, :], v]
    lut10 = luts[y1[:, None], x0[None, :], v]
    lut11 = luts[y1[:, None], x1[None, :], v]
    top = fma(1 - fx, lut00, fx * lut01)
    bottom = fma(1 - fx, lut10, fx * lut11)
    return fma((1 - fy).expand_as(top), top, fy * bottom).to(img.dtype)
