"""Weak scaling of visfs_tpu_torch's distributed mapping back-end (the twin
of bench_scaling.py) on torch.distributed.

The landmark-sharded Schur BA (parallel/distributed_ba.py) and the
edge-sharded pose-graph solve (parallel/pose_graph.py) with the per-rank
problem held constant while the world grows, so ideal scaling keeps the
wall time flat (efficiency = t(1) / t(n)).  Each world size is its own set
of spawned processes on a free localhost port: one card a rank over NCCL
(the default), or with --device cpu gloo ranks on the CPU (one intra-op
thread each).
Every rank builds the same seeded problem and solves it sharded; rank 0
times ``reps`` solves after one warm-up, each ended by a barrier (and a
device synchronisation on the card).

    python tools/torch_bench_scaling.py [--sizes 1,2,4] [--device cuda|cpu]
        [--lm-per-rank 4096] [--edges-per-rank 4096] [--reps 5]

Prints one JSON line per world size and a summary line (the reference's
keys), and on the card the card's name and power limit.
"""

import argparse
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

P = 6  # poses of the BA problem (the reference's)
BA_ITERATIONS = 5
GRAPH_SOLVE = dict(iterations=3, cg_iters=16)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_problem(L, device):
    """The reference's BA problem: L landmarks seen by P identity cameras
    (observations projected without noise), landmarks offset by 5 cm."""
    import numpy as np
    import torch

    from visfs_tpu_torch.solver import ba
    from visfs_tpu_torch.solver.factors import (StereoIntrinsics,
                                                project_stereo_point)

    rng = np.random.default_rng(0)
    intr = StereoIntrinsics(*(torch.tensor(v, dtype=torch.float32,
                                           device=device)
                              for v in (458.0, 458.0, 320.0, 240.0, 50.0)))
    lm = torch.tensor(np.stack([rng.uniform(-2, 2, L), rng.uniform(-2, 2, L),
                                rng.uniform(3, 8, L)], -1),
                      dtype=torch.float32, device=device)
    obs = project_stereo_point(lm, intr)[:, None, :].expand(L, P, 3)
    qid = torch.zeros((P, 4), device=device)
    qid[:, 0] = 1.0
    pose_t = torch.zeros((P, 3), device=device)
    pose_t[:, 2] = 0.01 * torch.arange(P, device=device)
    link_q = torch.zeros((P - 1, 4), device=device)
    link_q[:, 0] = 1.0
    fixed = torch.zeros(P, dtype=torch.bool, device=device)
    fixed[0] = True
    return ba.BAProblem(
        pose_q=qid, pose_t=pose_t,
        pose_valid=torch.ones(P, dtype=torch.bool, device=device),
        pose_fixed=fixed, lm_pos=lm + 0.05,
        lm_valid=torch.ones(L, dtype=torch.bool, device=device),
        lm_fixed=torch.zeros(L, dtype=torch.bool, device=device),
        obs=obs.contiguous(),
        obs_mask=torch.ones((L, P), dtype=torch.bool, device=device),
        link_q=link_q, link_t=torch.zeros((P - 1, 3), device=device),
        link_mask=torch.zeros(P - 1, dtype=torch.bool, device=device),
        intr=intr)


def make_graph(E, device):
    """The reference's pose graph: a chain of max(E / 8, 16) poses 0.1 m
    apart and E random consecutive-pair edges measuring 0.1 m."""
    import numpy as np
    import torch

    from visfs_tpu_torch.parallel import pose_graph

    rng = np.random.default_rng(1)
    N = max(E // 8, 16)
    gq = torch.zeros((N, 4), device=device)
    gq[:, 0] = 1.0
    gt = torch.zeros((N, 3), device=device)
    gt[:, 0] = 0.1 * torch.arange(N, dtype=torch.float32, device=device)
    ei = torch.tensor(rng.integers(0, N - 1, E), dtype=torch.int32,
                      device=device)
    eq = torch.zeros((E, 4), device=device)
    eq[:, 0] = 1.0
    et = torch.zeros((E, 3), device=device)
    et[:, 0] = 0.1
    fixed = torch.zeros(N, dtype=torch.bool, device=device)
    fixed[0] = True
    return pose_graph.PoseGraph(
        pose_q=gq, pose_t=gt, pose_fixed=fixed, edge_i=ei, edge_j=ei + 1,
        edge_q=eq, edge_t=et, edge_info=torch.ones(E, device=device),
        edge_mask=torch.ones(E, dtype=torch.bool, device=device))


def rank_main(rank, world, port, args, queue):
    import torch
    import torch.distributed as dist

    from visfs_tpu_torch.parallel import distributed_ba, pose_graph
    from visfs_tpu_torch.parallel.mesh import (edge_mesh,
                                               initialize_multihost,
                                               landmark_mesh)
    from visfs_tpu_torch.solver import ba

    torch.set_num_threads(1)
    try:
        device = args.device
        if device == "cuda":
            torch.cuda.set_device(rank)
            device = f"cuda:{rank}"
        initialize_multihost(f"tcp://127.0.0.1:{port}", world, rank,
                             backend="nccl" if args.device == "cuda"
                             else "gloo")
        group = dist.group.WORLD
        prob = make_problem(args.lm_per_rank * world, device)
        graph = make_graph(args.edges_per_rank * world, device)
        settings = ba.BASettings(iterations=BA_ITERATIONS)

        def sync():
            if args.device == "cuda":
                torch.cuda.synchronize()
            dist.barrier()

        def timed(fn):
            fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
                sync()
            return (time.perf_counter() - t0) / args.reps

        t_ba = timed(lambda: distributed_ba.distributed_local_optimize(
            prob, settings, landmark_mesh(group)))
        t_pg = timed(lambda: pose_graph.optimize(graph, edge_mesh(group),
                                                 **GRAPH_SOLVE))
        if rank == 0:
            queue.put((t_ba, t_pg))
        dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 — report, then fail the rank
        queue.put(f"rank {rank}: {type(e).__name__}: {e}")
        raise


def run_world(world, args):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        out = queue.get(timeout=args.timeout)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if isinstance(out, str):
        raise RuntimeError(out)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="1,2,4")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: one card a rank over NCCL; cpu: gloo ranks")
    ap.add_argument("--lm-per-rank", type=int, default=4096)
    ap.add_argument("--edges-per-rank", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    sizes = [int(s) for s in args.sizes.split(",")]
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"cards: {smi}", flush=True)
    results = []
    for n in sizes:
        t_ba, t_pg = run_world(n, args)
        results.append((n, t_ba, t_pg))
        print(json.dumps({
            "devices": n, "backend": "nccl" if args.device == "cuda"
            else "gloo", "ba_landmarks": args.lm_per_rank * n,
            "ba_s": t_ba, "pose_graph_edges": args.edges_per_rank * n,
            "pose_graph_s": t_pg}), flush=True)
    if len(results) > 1:
        n1, ba1, pg1 = results[0]
        nN, baN, pgN = results[-1]
        print(json.dumps({
            "metric": "weak_scaling_efficiency", "devices": nN,
            "ba_efficiency": ba1 / baN, "pose_graph_efficiency": pg1 / pgN}))


if __name__ == "__main__":
    main()
