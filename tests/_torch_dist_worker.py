"""Worker of tests/test_torch_distributed.py: one rank of a gloo process
group on the CPU running visfs_tpu_torch's sharded solvers.

Imports torch and visfs_tpu_torch only (no JAX), so a spawned rank starts
in a couple of seconds.  Problems arrive as dicts of numpy arrays and
results go back the same way.
"""

import numpy as np
import torch

from visfs_tpu_torch.parallel import distributed_ba, pose_graph
from visfs_tpu_torch.parallel.mesh import (edge_mesh, initialize_multihost,
                                           landmark_mesh)
from visfs_tpu_torch.solver import ba
from visfs_tpu_torch.solver.factors import StereoIntrinsics

GRAPH_SOLVE = dict(iterations=10, cg_iters=60)
BA_SETTINGS = dict(iterations=10)


def torch_pose_graph(arrays):
    return pose_graph.PoseGraph(**{k: torch.from_numpy(v)
                                   for k, v in arrays.items()})


def torch_problem(arrays):
    intr = StereoIntrinsics(*(torch.tensor(v) for v in arrays["intr"]))
    return ba.BAProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()
                           if k != "intr"}, intr=intr)


def solve(group, graph, problem):
    """The edge-sharded pose-graph solve, the landmark-sharded BA and one
    sharded Gauss-Newton step over ``group`` (None: this process alone),
    as numpy."""
    q, t, chi2 = pose_graph.optimize(torch_pose_graph(graph),
                                     edge_mesh(group), **GRAPH_SOLVE)
    prob = torch_problem(problem)
    res = distributed_ba.distributed_local_optimize(
        prob, ba.BASettings(**BA_SETTINGS), landmark_mesh(group))
    gn = distributed_ba.distributed_gn_step(
        prob, ba.BASettings(**BA_SETTINGS), landmark_mesh(group), lam=0.0)
    out = dict(graph_q=q, graph_t=t, graph_chi2=chi2, ba_q=res.pose_q,
               ba_t=res.pose_t, ba_lm=res.lm_pos, ba_outliers=res.outliers,
               ba_chi2=res.chi2, ba_ok=res.ok, gn_q=gn[0], gn_t=gn[1],
               gn_lm=gn[2])
    return {k: np.asarray(v.numpy()) for k, v in out.items()}


def worker(rank, world, port, graph, problem, queue):
    torch.set_num_threads(1)
    try:
        initialize_multihost(f"tcp://127.0.0.1:{port}", world, rank,
                             backend="gloo", timeout_s=60.0)
        import torch.distributed as dist

        out = solve(dist.group.WORLD, graph, problem)
        dist.destroy_process_group()
        queue.put((rank, out))
    except Exception as e:  # noqa: BLE001 — reported to the test
        queue.put((rank, f"{type(e).__name__}: {e}"))
