"""The pose graph's per-pose sums in one fixed order — CUDA kernel + plain
version.

The pose-graph solve (``parallel/pose_graph.py``) adds, for every pose, the
from-side terms of the edges leaving it and the to-side terms of the edges
reaching it.  ``segment_sum`` computes that sum in one order on every
device, whatever ``torch.are_deterministic_algorithms_enabled()`` says: for
pose p, first the from-side terms of its edges in edge order, then their
to-side terms in edge order (``csrc/segment_sum.cu`` states it on the card).

For CUDA tensors it launches the hand-written kernel on PyTorch's current
stream: a thread per (pose, column) walks the pose's run of ``Segments``,
built once per graph.  For CPU tensors it runs its plain version,
``segment_sum_reference``: ``index_add_`` of the from-side terms, then of
the to-side terms, which on the CPU adds each index in order, the same
order.  (``index_add_`` on the card adds in atomic order.)  Anything else
raises; there is no fallback from one to the other.

``LAUNCHES`` counts the kernel's launches (the CPU path does not count), so
a run can show that the solve went through it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import load_library

LAUNCHES = 0

LIB_NAME = "visfs_segment_sum"
_SOURCES = ("segment_sum.cu",)


class Segments(NamedTuple):
    """Where each pose's terms lie among an edge list's stacked [E, 2, ...]
    terms (edge e's from side row 2e, its to side row 2e + 1)."""

    i: torch.Tensor  # [E] int64 from-pose of each edge
    j: torch.Tensor  # [E] int64 to-pose of each edge
    rows: torch.Tensor  # [2E] int64 the rows in walking order, pose-major
    start: torch.Tensor  # [N + 1] int64 pose p's rows: rows[start[p]:start[p+1]]


def segments(edge_i, edge_j, edge_mask, n: int) -> Segments:
    """The walking order of the edges' endpoints over n poses, on the
    edges' device with no host sync: a stable sort of the from-poses
    followed by the to-poses, so each pose's from-side rows come in edge
    order before its to-side rows.  A masked edge's endpoints sort after
    every pose (key n) and no pose walks them: their terms carry a weight
    of 0, and an exact 0 adds nothing to a sum started at +0."""
    i, j = edge_i.long(), edge_j.long()
    e = i.shape[0]
    mask = torch.cat((edge_mask, edge_mask)).bool()
    keys = torch.where(mask, torch.cat((i, j)), torch.full_like(mask, n,
                                                                 dtype=i.dtype))
    sorted_keys, order = torch.sort(keys, stable=True)
    rows = torch.where(order < e, 2 * order, 2 * (order - e) + 1)
    start = torch.searchsorted(
        sorted_keys, torch.arange(n + 1, dtype=i.dtype, device=i.device))
    return Segments(i, j, rows, start)


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; returns it."""
    if not torch.cuda.is_available():
        raise RuntimeError("segment_sum: CUDA kernel requested but CUDA is "
                           "not available")
    lib = load_library(LIB_NAME, _SOURCES)
    fn = lib.visfs_segment_sum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(terms, seg: Segments):
    e = seg.i.shape[0]
    if terms.dim() < 2 or terms.shape[:2] != (e, 2):
        raise ValueError(f"segment_sum: terms must be [E, 2, ...] with E = "
                         f"{e}, got {tuple(terms.shape)}")
    if any(t.device != terms.device for t in seg):
        raise ValueError("segment_sum: all tensors must be on one device")


def segment_sum(terms, seg: Segments, n: int):
    """Per-pose sums [n, ...] of ``terms`` [E, 2, ...] (each edge's from-
    and to-side terms) in the fixed order."""
    _check(terms, seg)
    kind = terms.device.type
    if kind == "cpu":
        return segment_sum_reference(terms, seg, n)
    if kind == "cuda":
        return segment_sum_cuda(terms, seg, n)
    raise ValueError(f"segment_sum: unsupported device {terms.device}")


def segment_sum_reference(terms, seg: Segments, n: int):
    """The plain version: ``index_add_`` of the from-side terms, then of the
    to-side terms, into zeros."""
    out = terms.new_zeros((n,) + terms.shape[2:])
    return out.index_add_(0, seg.i, terms[:, 0]).index_add_(
        0, seg.j, terms[:, 1])


def segment_sum_cuda(terms, seg: Segments, n: int):
    """Launch the kernel (raises when CUDA is absent or the launch
    fails)."""
    global LAUNCHES
    lib = build()
    _check(terms, seg)
    if terms.device.type != "cuda":
        raise ValueError("segment_sum_cuda: tensors must be on a CUDA device")
    if terms.dtype != torch.float32:
        raise TypeError(f"segment_sum_cuda: expected float32, got "
                        f"{terms.dtype}")
    terms = terms.contiguous()
    cols = 1
    for d in terms.shape[2:]:
        cols *= d
    out = torch.empty((n,) + terms.shape[2:], dtype=terms.dtype,
                      device=terms.device)
    with torch.cuda.device(terms.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(terms.device).cuda_stream
        err = lib.visfs_segment_sum(terms.data_ptr(), seg.rows.data_ptr(),
                                    seg.start.data_ptr(), out.data_ptr(), n,
                                    cols, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
