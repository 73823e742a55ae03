"""Distributed bundle adjustment: the landmark axis split over ranks (torch
port of visfs_tpu.parallel.distributed_ba).

``distributed_local_optimize`` is not a separate solver: it is
``solver.ba.local_optimize`` on each rank's landmark shard with the mesh's
process group threaded through its reductions.  Every rank builds the
reduced camera system of its landmarks, all-reduces combine the [6P, 6P]
Schur terms and the chi2 totals, the pose solve, the LM accept/reject, the
two-pass demotion and the divergence checks run replicated, and landmark
back-substitution stays local.  The semantics are those of the one-process
solver by construction.  Communication per iteration is O(P^2) floats,
independent of the landmark count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..solver import ba
from .mesh import Mesh, all_gather, shard

# the BAProblem leaves indexed by landmark (the shard_map-sharded ones)
_LM_FIELDS = ("lm_pos", "lm_valid", "lm_fixed", "obs", "obs_mask")


def _local_problem(problem: ba.BAProblem, mesh: Optional[Mesh]):
    group = None if mesh is None else mesh.group
    return problem._replace(**{f: shard(getattr(problem, f), group)
                               for f in _LM_FIELDS}), group


def distributed_local_optimize(problem: ba.BAProblem,
                               settings: ba.BASettings,
                               mesh: Optional[Mesh] = None) -> ba.BAResult:
    """Landmark-sharded two-pass Schur BA == local_optimize, distributed.

    Every rank passes the whole problem, whose landmark count must divide
    by the mesh's ranks (``mesh.pad_to_devices``), and gets the whole
    result: the landmarks and outlier flags gathered back together, the
    poses, chi2 and the divergence flag replicated."""
    local, group = _local_problem(problem, mesh)
    res = ba.local_optimize(local, settings, group)
    return res._replace(lm_pos=all_gather(res.lm_pos, group),
                        outliers=all_gather(res.outliers, group))


def distributed_gn_step(problem: ba.BAProblem, settings: ba.BASettings,
                        mesh: Optional[Mesh] = None, lam: float = 1e-4):
    """One undamped Gauss-Newton step of landmark-sharded Schur BA, the
    minimal building block (one step's communication); returns (pose_q,
    pose_t, lm_pos) with the landmarks gathered."""
    gn = dataclasses.replace(settings, use_levenberg=False, iterations=2,
                             init_lambda=lam)
    local, group = _local_problem(problem, mesh)
    active = (local.obs_mask & local.lm_valid[:, None]
              & local.pose_valid[None, :]).to(local.pose_t.dtype)
    q, t, lm = ba._optimize_pass(local, local.pose_q, local.pose_t,
                                 local.lm_pos, active, gn, 1, group)
    return q, t, all_gather(lm, group)
