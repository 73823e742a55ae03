"""Image primitives: separable filters, pyramids, gradients
(torch port of visfs_tpu.ops.image).

Images are single-channel float32 [H, W] tensors in [0, 255].  Every filter
replicates the edge, like the reference.  ``pyr_down`` is the 5-tap
binomial stencil with edge replication and 2x decimation — the same function
the reference expresses as two banded matmuls (a TPU lowering).
"""

from __future__ import annotations

import torch

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
