"""Probes of the pose-graph solve's per-pose sums and per-edge terms on the
card (visfs_tpu_torch.parallel.pose_graph), on a padded graph of the
backend cell's capacity (128 nodes, 512 edge slots, a drifting chain with
closures, most slots masked).

    python tools/torch_pose_graph_probe.py [--device cuda]
        [--probes k3,scatter,shards,solve]

Prints one JSON line a probe:

  * ``scatter``: candidate per-pose sums in PyTorch calls (two
    ``index_put_(accumulate=True)``, one over the 2E endpoints, and
    ``index_add_``) at [E, 6] and [E, 6, 6]: bits against the CPU's
    ``index_add_`` order (the plain version of K3), bits between 20
    repeats, host syncs in one call;
  * ``solve``: whole ``optimize`` solves (10 Gauss-Newton steps x 60 CG
    steps) with each candidate in place of K3: bits between two solves and
    against K3's solve, host syncs, host ms a solve, kernels a solve;
  * ``shards``: each aten op of the per-edge terms (``_edge_terms``, the
    ``@`` products of ``pose_link_jacobians`` among them) and the products
    the solve sums per pose (K4, ``ops/kernels/edge_products.py``, as the
    solve calls it) on the whole graph and on each block of 2, 4 and 8
    ranks, as ``parallel.mesh.shard`` splits it: the first op whose block
    output differs in any bit from the whole graph's rows, with its shapes
    (null: none), and the words differing in each output;
  * ``k3``: K3's device time a launch at both shapes in a torch.profiler
    trace of this fresh process (median of 20).

On ``--device cpu`` only the bits are meaningful (no syncs, no kernels).
"""

import argparse
import contextlib
import json
import os
import sys
import time
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_NODES, N_EDGES, N_LIVE = 128, 512, 90


def probe_graph(device):
    """A chain of N_LIVE poses drifting from a square loop, with a closure
    every 10 poses to pose 0 or to the pose 40 back, in N_NODES nodes and
    N_EDGES edge slots (the rest masked), as a PoseGraph."""
    import torch

    from visfs_tpu_torch.parallel.pose_graph import PoseGraph

    rng = np.random.default_rng(7)
    yaw = np.cumsum(rng.normal(0.07, 0.01, N_NODES))
    t = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw), rng.normal(
        0, 0.01, N_NODES)], 1) * 0.3, 0)
    q = np.stack([np.cos(yaw / 2), np.zeros(N_NODES), np.zeros(N_NODES),
                  np.sin(yaw / 2)], 1)
    pairs = [(k, k + 1) for k in range(N_LIVE - 1)]
    pairs += [(k, 0 if k % 20 else k - 40) for k in range(50, N_LIVE, 10)]
    ei = np.zeros(N_EDGES, np.int32)
    ej = np.zeros(N_EDGES, np.int32)
    eq = np.tile([1.0, 0.0, 0.0, 0.0], (N_EDGES, 1))
    et = np.zeros((N_EDGES, 3))
    mask = np.zeros(N_EDGES, bool)
    for e, (a, b) in enumerate(pairs):
        ei[e], ej[e], mask[e] = a, b, True
        dy = yaw[b] - yaw[a] + rng.normal(0, 0.01)
        eq[e] = [np.cos(dy / 2), 0, 0, np.sin(dy / 2)]
        et[e] = rng.normal(0, 0.3, 3)
    q = q + rng.normal(0, 1e-3, q.shape)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    fixed = np.zeros(N_NODES, bool)
    fixed[0] = True
    fixed[N_LIVE:] = True

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return PoseGraph(f32(q), f32(t), torch.tensor(fixed, device=device),
                     torch.tensor(ei, device=device),
                     torch.tensor(ej, device=device), f32(eq), f32(et),
                     f32(np.where(mask, 100.0, 1.0)),
                     torch.tensor(mask, device=device))


@contextlib.contextmanager
def syncs(device):
    import torch

    found = []
    if device != "cuda":
        yield found
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(0)
    found.extend(str(w.message)[:120] for w in caught
                 if "synchroniz" in str(w.message))


def candidates():
    """name -> sum(n, i, j, vi, vj) in PyTorch calls."""
    import torch

    def two_puts(n, i, j, vi, vj):
        out = vi.new_zeros((n,) + vi.shape[1:])
        return out.index_put_((i,), vi, accumulate=True).index_put_(
            (j,), vj, accumulate=True)

    def one_put(n, i, j, vi, vj):
        out = vi.new_zeros((n,) + vi.shape[1:])
        return out.index_put_((torch.cat((i, j)),), torch.cat((vi, vj)),
                              accumulate=True)

    def index_add(n, i, j, vi, vj):
        out = vi.new_zeros((n,) + vi.shape[1:])
        return out.index_add_(0, i, vi).index_add_(0, j, vj)

    return {"index_put_x2": two_puts, "index_put_2E": one_put,
            "index_add_x2": index_add}


def bits(x):
    return x.detach().cpu().contiguous().view(-1).numpy().view(np.int32)


def probe_scatter(device, g):
    import torch

    n = g.pose_q.shape[0]
    i, j = g.edge_i.long(), g.edge_j.long()
    w = g.edge_mask.float()
    rows = []
    for shape in ((6,), (6, 6)):
        rng = np.random.default_rng(len(shape))
        vi, vj = (torch.tensor(rng.normal(size=(N_EDGES,) + shape).astype(
            np.float32), device=device) * w.reshape((-1,) + (1,) * len(shape))
            for _ in range(2))
        want = torch.zeros((n,) + shape).index_add_(
            0, i.cpu(), vi.cpu()).index_add_(0, j.cpu(), vj.cpu())
        for name, fn in candidates().items():
            fn(n, i, j, vi, vj)
            with syncs(device) as found:
                first = fn(n, i, j, vi, vj)
            reps = [fn(n, i, j, vi, vj) for _ in range(20)]
            rows.append(dict(
                shape=list(shape), candidate=name,
                differing_from_cpu_order=int(
                    (bits(first) != bits(want)).sum()),
                repeats_differing=sum(int((bits(r) != bits(first)).any())
                                      for r in reps),
                host_syncs=len(found), sync_messages=sorted(set(found))[:2]))
    return rows


def kernels_in(fn, device):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device != "cuda":
        return None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def probe_solve(device, g):
    import torch

    import visfs_tpu_torch.parallel.pose_graph as tpg

    kw = dict(iterations=10, cg_iters=60)
    original = tpg._scatter

    def solve():
        out = tpg.optimize(g, None, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        return out

    base = solve()
    rows = []
    for name, fn in [("k3", None)] + list(candidates().items()):
        if fn is not None:
            tpg._scatter = (lambda f: lambda n, edges, terms, group: f(
                n, edges.i, edges.j, terms[:, 0], terms[:, 1]))(fn)
        try:
            solve()
            with syncs(device) as found:
                a = solve()
            t0 = time.perf_counter()
            b = solve()
            ms = (time.perf_counter() - t0) * 1e3
            rows.append(dict(
                candidate=name, host_syncs=len(found),
                repeat_bits_differing=sum(
                    int((bits(x) != bits(y)).sum()) for x, y in zip(a, b)),
                bits_differing_from_k3=sum(
                    int((bits(x) != bits(y)).sum()) for x, y in zip(a, base)),
                max_gap_to_k3_m=float((a[1] - base[1]).abs().max()),
                solve_ms=ms, kernels=kernels_in(solve, device)))
        finally:
            tpg._scatter = original
    return rows


def edge_products(g, x):
    """The per-edge terms a Gauss-Newton step makes and sums per pose, as
    _gn_step makes them (K4 on the card)."""
    import visfs_tpu_torch.parallel.pose_graph as tpg

    r, Ji, Jj, w, chi2 = tpg._edge_terms(g, g.pose_q, g.pose_t, 1.0)
    return [r, Ji, Jj, w, chi2, tpg.edge_gradient(w, Ji, Jj, r),
            tpg.edge_blocks(w, Ji, Jj),
            tpg.edge_matvec(w, Ji, Jj, x, g.edge_i.long(), g.edge_j.long())]


def recorded(fn):
    """fn()'s aten ops with their outputs, in call order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ops.append((str(func), out, [tuple(a.shape) for a in args
                                         if hasattr(a, "shape")]))
            return out

    with Record():
        final = fn()
    return ops, final


def probe_shards(device, g):
    import torch

    rng = np.random.default_rng(11)
    x = torch.tensor(rng.normal(size=(N_NODES, 6)).astype(np.float32),
                     device=device)
    whole_ops, whole = recorded(lambda: edge_products(g, x))
    rows = []
    for world in (2, 4, 8):
        per = N_EDGES // world
        first, outputs_differing = None, [0] * len(whole)
        for rank in range(world):
            lo, hi = rank * per, (rank + 1) * per
            part = g._replace(**{f: getattr(g, f)[lo:hi]
                                 for f in g._fields if f.startswith("edge_")})
            ops, outs = recorded(lambda: edge_products(part, x))
            for k, (a, b) in enumerate(zip(whole, outs)):
                outputs_differing[k] += int(
                    (bits(a[lo:hi]) != bits(b)).sum())
            for (name, out, shapes), (wname, wout, _) in zip(ops, whole_ops):
                if not (isinstance(out, torch.Tensor)
                        and isinstance(wout, torch.Tensor)
                        and out.dim() and wout.dim()
                        and wout.shape[0] == N_EDGES
                        and out.shape[0] == per):
                    continue
                n_diff = int((bits(wout[lo:hi]) != bits(out)).sum())
                if n_diff and first is None:
                    first = dict(rank=rank, op=name, input_shapes=shapes,
                                 whole_op=wname, words_differing=n_diff)
        rows.append(dict(world=world, edges_a_rank=per,
                         first_differing_op=first,
                         outputs=["r", "Ji", "Jj", "w", "chi2",
                                  "w J^T r (K4)", "w J^T J (K4)",
                                  "w J^T y (K4)"],
                         words_differing_per_output=outputs_differing))
    return rows


def probe_k3(device):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from visfs_tpu_torch.ops.kernels import segment_sum as k3

    if device != "cuda":
        return None
    g = probe_graph(device)
    n = g.pose_q.shape[0]
    seg = k3.segments(g.edge_i, g.edge_j, g.edge_mask, n)
    rows = []
    for shape in ((6,), (6, 6)):
        terms = torch.randn((N_EDGES, 2) + shape, device=device)
        k3.segment_sum(terms, seg, n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                k3.segment_sum(terms, seg, n)
            torch.cuda.synchronize()
        us = sorted(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and "segment_sum" in e.name)
        rows.append(dict(shape=list(shape), records=len(us),
                         device_us=us[len(us) // 2] if us else None))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--probes", default="k3,scatter,shards,solve",
                    help="the probes to run, comma-separated")
    args = ap.parse_args()
    probes = args.probes.split(",")
    import torch

    torch.manual_seed(0)
    if args.device == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    g = probe_graph(args.device)
    if "k3" in probes:
        print(json.dumps({"k3": probe_k3(args.device)}), flush=True)
    for name, probe in (("scatter", probe_scatter), ("shards", probe_shards),
                        ("solve", probe_solve)):
        if name in probes:
            for row in probe(args.device, g):
                print(json.dumps({name: row}), flush=True)


if __name__ == "__main__":
    main()
