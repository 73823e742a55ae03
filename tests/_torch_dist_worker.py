"""Worker of tests/test_torch_distributed.py, tests/test_torch_fleet_dp.py
and tests/test_torch_multichip.py: one rank of a gloo process group on the
CPU running visfs_tpu_torch's sharded solvers (``worker``), its fleet
across ranks (``fleet_worker``: dp_fleet_step and FleetMapping) or one
dp_fleet_step from given states (``tiny_dp_worker``).

Imports torch and visfs_tpu_torch only (no JAX), so a spawned rank starts
in a couple of seconds.  Problems arrive as dicts of numpy arrays and
results go back the same way.
"""

import numpy as np
import torch

from visfs_tpu_torch.parallel import distributed_ba, pose_graph
from visfs_tpu_torch.parallel.mesh import (edge_mesh, fleet_mesh,
                                           initialize_multihost,
                                           landmark_mesh)
from visfs_tpu_torch.slam.fleet import dp_fleet_step
from visfs_tpu_torch.slam.multi_robot import FleetMapping
from visfs_tpu_torch.slam.system import System
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


# --- the fleet across ranks --------------------------------------------------

# tests/test_fleet.py's strategy-3 scene and parameters (dp_fleet_step)
DP_PARAMS = {"System/SensorStrategy": 3, "Tracker/MaxFeatures": 60,
             "Tracker/MinDistance": 12, "Optimizer/Iterations": 4,
             "LocalMap/NumRangeDataLimit": 20}
DP_SYSTEM = dict(scan_capacity=128, submap_extent_cells=128)
# tests/test_torch_multi_robot.py's session (FleetMapping)
MAP_PARAMS = {"Tracker/MaxFeatures": 40, "Tracker/MinDistance": 12,
              "Tracker/QualityLevel": 0.05, "LocalMap/MapSize": 5,
              "Optimizer/Iterations": 20, "Estimator/Force3DoF": True,
              "Estimator/ToleranceTranslation": 0.40}
SESSION = dict(max_nodes=32, max_edges=128, snapshot_kp=40)
LOOPS = dict(radius=2.0, min_gap=4, min_inliers=10)
SOLVE = dict(iterations=8, cg_iters=40)


def init_camera(session, cam):
    """init() of a System or a session with a camera dict."""
    session.init(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                 cam["baseline"], width=cam["width"], height=cam["height"])


def dp_system(seed, cam):
    s = System(DP_PARAMS, device="cpu", seed=seed, **DP_SYSTEM)
    init_camera(s, cam)
    return s


def dp_fleet_run(group, rank, seq):
    """This rank's stream (a System of seed ``rank``, as its state holder
    and feeder) stepped by dp_fleet_step over the strategy-3 scene: the
    wheel rows up to each frame in one batch, then the frame with its
    scan.  Returns every frame's gathered [B] outputs, as numpy."""
    s = dp_system(rank, seq["camera"])
    mesh = fleet_mesh(group)
    wheel, odom_i, frames = seq["wheel_odom"], 0, []
    for i, stamp in enumerate(seq["stamps"]):
        j = odom_i
        while j < len(wheel) and wheel[j][0] <= stamp + 1e-9:
            j += 1
        if j > odom_i:
            s.input_wheel_odometry_batch(wheel[odom_i:j, 0],
                                         wheel[odom_i:j, 1:7])
            odom_i = j
        pts, msk, tms = s._scan_inputs(seq["scans"][i], None)
        s.state, out = dp_fleet_step(
            mesh, s.state, s._as_image(seq["left"][i]),
            s._as_image(seq["right"][i]),
            torch.full((), float(stamp), dtype=torch.float32),
            s.camera, s.settings, s.lk_params, s._cfg_hash,
            scan_points=pts, scan_mask=msk, scan_times=tms)
        frames.append({f: v.numpy() for f, v in out._asdict().items()
                       if torch.is_tensor(v)})
    return frames


def graph_edges(g):
    n = int(g.n_edges)
    return list(zip(g.edge_i[:n].tolist(), g.edge_j[:n].tolist()))


def fleet_mapping_run(group, seq):
    """FleetMapping on the multi-robot scene: robot r drives frames r ..
    r + 7 in lockstep, then close_loops and optimize."""
    fm = FleetMapping(MAP_PARAMS, fleet_mesh(group),
                      start_poses=seq["starts"], device="cpu", **SESSION)
    init_camera(fm, seq["camera"])
    n = fm.n_robots
    for k in range(len(seq["stamps"]) - n + 1):
        fm.step(seq["stamps"][k:k + n], seq["left"][k:k + n],
                seq["right"][k:k + n])
    out = dict(keyframes=fm.keyframe_counts(), graph=fm.poses(),
               edges_before=graph_edges(fm.backend.graph))
    out["added"] = fm.close_loops(**LOOPS)
    out["edges"] = graph_edges(fm.backend.graph)
    out["cross"] = fm.cross_robot_edges()
    out["chi2"] = fm.optimize(**SOLVE)
    out["optimized"] = fm.poses()
    out["robot1"] = fm.poses(robot=1)
    return out


def fleet_worker(rank, world, port, dp_seq, map_seq, queue):
    torch.set_num_threads(1)
    try:
        initialize_multihost(f"tcp://127.0.0.1:{port}", world, rank,
                             backend="gloo", timeout_s=60.0)
        import torch.distributed as dist

        out = dict(dp=dp_fleet_run(dist.group.WORLD, rank, dp_seq),
                   mapping=fleet_mapping_run(dist.group.WORLD, map_seq))
        dist.destroy_process_group()
        queue.put((rank, out))
    except Exception as e:  # noqa: BLE001 — reported to the test
        import traceback

        queue.put((rank, f"{type(e).__name__}: {e}\n"
                         f"{traceback.format_exc()}"))


def tiny_dp_worker(rank, world, port, setup, frames, queue):
    """dp_fleet_step on two gloo ranks from the JAX dryrun's tiny setup:
    ``setup`` holds its parameters, camera and the starting state (the
    port's numpy state), ``frames`` per frame the [B, H, W] images and the
    stamps.  Returns this rank's new state's pose and the gathered
    outputs of every frame, as numpy."""
    torch.set_num_threads(1)
    try:
        from visfs_tpu_torch.core.camera import make_stereo_camera
        from visfs_tpu_torch.config import config_from_parameters
        from visfs_tpu_torch.ops.lk import LKParams
        from visfs_tpu_torch.slam.state import state_from_numpy
        from visfs_tpu_torch.slam.system import (_build_settings,
                                                 build_cfg_hash)

        initialize_multihost(f"tcp://127.0.0.1:{port}", world, rank,
                             backend="gloo", timeout_s=60.0)
        import torch.distributed as dist

        cfg = config_from_parameters(setup["params"])
        cam = make_stereo_camera(**setup["camera"], device="cpu")
        lk = LKParams(**setup["lk"])
        state = state_from_numpy(setup["state"], "cpu")
        outs = []
        for left, right, stamp in frames:
            state, out = dp_fleet_step(
                fleet_mesh(dist.group.WORLD), state,
                torch.from_numpy(left[rank]), torch.from_numpy(right[rank]),
                torch.tensor(stamp[rank], dtype=torch.float32), cam,
                _build_settings(cfg), lk, build_cfg_hash(cfg))
            outs.append({f: v.numpy() for f, v in out._asdict().items()
                         if torch.is_tensor(v)})
        dist.destroy_process_group()
        queue.put((rank, outs))
    except Exception as e:  # noqa: BLE001 — reported to the test
        import traceback

        queue.put((rank, f"{type(e).__name__}: {e}\n"
                         f"{traceback.format_exc()}"))
