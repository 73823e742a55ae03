"""The pose graph's per-edge products in one fixed order — CUDA kernel
(K4), plain version and order oracle.

The pose-graph solve (``parallel/pose_graph.py``) makes, on a rank's block
of edges, the terms it adds per pose (``segment_sum``, K3), each stacked
[E, 2, ...] with the from side (Ji) before the to side (Jj):

  * ``edge_gradient(w, Ji, Jj, r)``: w Ji^T r and w Jj^T r, [E, 2, 6] (the
    solve negates them; a negation is exact);
  * ``edge_blocks(w, Ji, Jj)``: w Ji^T Ji and w Jj^T Jj, [E, 2, 6, 6];
  * ``edge_matvec(w, Ji, Jj, x, edge_i, edge_j)``: y = Ji x[edge_i] + Jj
    x[edge_j], then w Ji^T y and w Jj^T y, [E, 2, 6].

For CUDA tensors each launches the hand-written kernel
(``csrc/edge_products.cu``) on PyTorch's current stream, on the tensors'
card; it computes every element in the order the CPU's ``torch.einsum``
does, whatever the batch (cuBLAS, which ``torch.einsum`` reaches on the
card, picks its kernel and so its rounding by the batch size, and a shard's
terms would differ from the same rows of the whole graph's).  For CPU
tensors each runs its plain version, the einsums the solve wrote before
(``edge_products_reference``).  Anything else raises; there is no fallback
from one to the other.

``edge_products_oracle`` is the kernel's order written out as elementwise
float32 ops, each rounded on its own: the same bits on every CPU, and on
the CPU the einsums' bits (``tests/test_torch_edge_products.py``).  The
card's kernel is held to it.

``LAUNCHES`` counts the kernel's launches (the CPU path does not count), so
a run can show that the solve went through it.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library

LAUNCHES = 0

LIB_NAME = "visfs_edge_products"
_SOURCES = ("edge_products.cu",)
# the entries, in the C entry's mode order
ENTRIES = ("gradient", "blocks", "matvec")


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; returns it."""
    if not torch.cuda.is_available():
        raise RuntimeError("edge_products: CUDA kernel requested but CUDA "
                           "is not available")
    lib = load_library(LIB_NAME, _SOURCES)
    fn = lib.visfs_edge_products
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def edge_gradient(w, Ji, Jj, r):
    """[E, 2, 6]: w Ji^T r and w Jj^T r."""
    return edge_products("gradient", w, Ji, Jj, r)


def edge_blocks(w, Ji, Jj):
    """[E, 2, 6, 6]: w Ji^T Ji and w Jj^T Jj."""
    return edge_products("blocks", w, Ji, Jj)


def edge_matvec(w, Ji, Jj, x, edge_i, edge_j):
    """[E, 2, 6]: w Ji^T y and w Jj^T y, y = Ji x[edge_i] + Jj x[edge_j].
    On the card an index outside [0, N) gives its edge NaN terms (the
    indices are not read on the host, which would wait for the card)."""
    return edge_products("matvec", w, Ji, Jj, x, edge_i, edge_j)


def _check(entry, w, Ji, Jj, *rest):
    if entry not in ENTRIES:
        raise ValueError(f"edge_products: unknown entry {entry!r}")
    want = {"gradient": 1, "blocks": 0, "matvec": 3}[entry]
    if len(rest) != want:
        raise TypeError(f"edge_products {entry}: {want} tensors after w, "
                        f"Ji, Jj, got {len(rest)}")
    e = w.shape[0]
    shapes = [(w, (e,)), (Ji, (e, 6, 6)), (Jj, (e, 6, 6))]
    if entry == "gradient":
        shapes.append((rest[0], (e, 6)))
    elif entry == "matvec":
        x, edge_i, edge_j = rest
        if x.dim() != 2 or x.shape[1] != 6:
            raise ValueError(f"edge_products matvec: x must be [N, 6], got "
                             f"{tuple(x.shape)}")
        shapes += [(edge_i, (e,)), (edge_j, (e,))]
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"edge_products {entry}: expected a tensor of "
                             f"shape {shape}, got {tuple(t.shape)}")
    if any(t.device != w.device for t in (Ji, Jj) + rest):
        raise ValueError("edge_products: all tensors must be on one device")


def edge_products(entry, w, Ji, Jj, *rest):
    """``entry`` ("gradient": r; "blocks"; "matvec": x, edge_i, edge_j) of
    the edges' products, [E, 2, ...]: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check(entry, w, Ji, Jj, *rest)
    kind = w.device.type
    if kind == "cpu":
        return edge_products_reference(entry, w, Ji, Jj, *rest)
    if kind == "cuda":
        return edge_products_cuda(entry, w, Ji, Jj, *rest)
    raise ValueError(f"edge_products: unsupported device {w.device}")


def edge_products_reference(entry, w, Ji, Jj, *rest):
    """The plain version: the solve's einsums, from side and to side
    stacked."""
    if entry == "blocks":
        return torch.stack((torch.einsum("e,eki,ekj->eij", w, Ji, Ji),
                            torch.einsum("e,eki,ekj->eij", w, Jj, Jj)), 1)
    if entry == "gradient":
        (v,) = rest
    else:
        x, edge_i, edge_j = rest
        v = torch.einsum("eki,ei->ek", Ji, x[edge_i]) \
            + torch.einsum("eki,ei->ek", Jj, x[edge_j])  # [E, 6] = J_e x
    return torch.stack((torch.einsum("e,eki,ek->ei", w, Ji, v),
                        torch.einsum("e,eki,ek->ei", w, Jj, v)), 1)


def _weighted_jt(w, J, v):
    """sum over k of J[:, k, i] * (w * v[:, k]), from +0, k ascending."""
    t = w[:, None] * v
    acc = torch.zeros_like(v)
    for k in range(6):
        acc = acc + J[:, k, :] * t[:, k, None]
    return acc


def _j_x(J, x):
    """sum over i of J[:, k, i] * x[:, i], from +0, i ascending."""
    acc = torch.zeros_like(x)
    for i in range(6):
        acc = acc + J[:, :, i] * x[:, i, None]
    return acc


def _weighted_jt_j(w, J):
    """sum over k of (w * J[:, k, i]) * J[:, k, j], from +0, k ascending."""
    acc = torch.zeros_like(J)
    for k in range(6):
        acc = acc + (w[:, None] * J[:, k, :])[:, :, None] * J[:, k, None, :]
    return acc


def edge_products_oracle(entry, w, Ji, Jj, *rest):
    """The kernel's order as elementwise float32 ops, each product and each
    add rounded on its own: what the kernel is held to, bit for bit."""
    _check(entry, w, Ji, Jj, *rest)
    if entry == "blocks":
        return torch.stack((_weighted_jt_j(w, Ji), _weighted_jt_j(w, Jj)), 1)
    if entry == "gradient":
        (v,) = rest
    else:
        x, edge_i, edge_j = rest
        v = _j_x(Ji, x[edge_i]) + _j_x(Jj, x[edge_j])
    return torch.stack((_weighted_jt(w, Ji, v), _weighted_jt(w, Jj, v)), 1)


def edge_products_cuda(entry, w, Ji, Jj, *rest):
    """Launch the kernel (raises when CUDA is absent or the launch
    fails)."""
    global LAUNCHES
    lib = build()
    _check(entry, w, Ji, Jj, *rest)
    if w.device.type != "cuda":
        raise ValueError("edge_products_cuda: tensors must be on a CUDA "
                         "device")
    v = x = edge_i = edge_j = None
    if entry == "gradient":
        (v,) = rest
    elif entry == "matvec":
        x, edge_i, edge_j = rest
        edge_i, edge_j = edge_i.long().contiguous(), edge_j.long().contiguous()
    floats = [t for t in (w, Ji, Jj, v, x) if t is not None]
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"edge_products_cuda: expected float32, got "
                        f"{[t.dtype for t in floats]}")
    w, Ji, Jj = w.contiguous(), Ji.contiguous(), Jj.contiguous()
    v = None if v is None else v.contiguous()
    x = None if x is None else x.contiguous()
    e = w.shape[0]
    cols = (6, 6) if entry == "blocks" else (6,)
    out = torch.empty((e, 2) + cols, dtype=torch.float32, device=w.device)
    if e == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(w.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.visfs_edge_products(
            ENTRIES.index(entry), w.data_ptr(), Ji.data_ptr(), Jj.data_ptr(),
            ptr(v), ptr(x), ptr(edge_i), ptr(edge_j), out.data_ptr(), e,
            0 if x is None else x.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"edge_products kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
