"""Multi-robot mapping session: several VO streams building one map (torch
port of visfs_tpu.slam.multi_robot's ``MultiRobotMapping`` and
``FleetMapping``).

N independent ``System`` instances run on the host's schedule (any mix of
sensor strategies) and feed one shared ``MappingBackend``: keyframes carry
their robot id, odometry edges stay within a robot's chain, and each
robot's VO poses are lifted into the shared world frame by its known start
pose (T_world_robot = T_world_start @ T_vo).  Cross-robot loop closures
are proximity candidates between different robots' keyframes at any index
distance, verified by ``mapping.verify_loop`` and solved by the
edge-sharded pose graph.  With identity start poses the robots' chains
float until the first cross-robot closure ties them together (only node
0's gauge is anchored).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import VISFSConfig, config_from_parameters
from ..core.camera import make_stereo_camera
from ..ops.lk import LKParams, lk_pad
from ..parallel.mesh import Mesh, edge_mesh, gather_stacked
from .fleet import dp_fleet_step, fleet_outputs_to_numpy
from .mapping import MappingBackend, snapshot_features
from .state import FrameOutput, KeyframeSnapshot, init_state
from .system import System, _build_settings, build_cfg_hash


class _SharedGraph:
    """What both sessions do with their one keyframe graph (``backend``,
    ``camera`` and the per-robot ``_n_keyframes`` are the session's)."""

    def close_loops(self, radius: float = 2.0, min_gap: int = 10,
                    min_inliers: int = 10, min_ncc: float = 0.4) -> int:
        """Verify and insert loop closures, cross-robot pairs included."""
        return self.backend.close_loops(
            self.camera, radius=radius, min_gap=min_gap,
            min_inliers=min_inliers, min_ncc=min_ncc)

    def optimize(self, iterations: int = 10, cg_iters: int = 50) -> float:
        return self.backend.optimize(iterations=iterations,
                                     cg_iters=cg_iters)

    def poses(self, robot: Optional[int] = None) -> np.ndarray:
        """Keyframe poses ([n, 4, 4]), one robot's if given."""
        poses = self.backend.poses()
        if robot is None:
            return poses
        rob = self.backend.graph.robot[:len(poses)].cpu().numpy()
        return poses[rob == robot]

    def keyframe_counts(self):
        return list(self._n_keyframes)

    def cross_robot_edges(self) -> int:
        """Accepted loop-closure edges linking different robots."""
        g = self.backend.graph
        n_e = int(g.n_edges)
        rob = g.robot.cpu().numpy()
        ei = g.edge_i[:n_e].cpu().numpy()
        ej = g.edge_j[:n_e].cpu().numpy()
        return int(np.sum(rob[ei] != rob[ej]))


class MultiRobotMapping(_SharedGraph):
    """Host-side driver: N robots' VO into one shared keyframe graph.

    parameters: the VISFS parameter map all robots share; n_robots: the
    fleet size; mesh: the pose-graph solve's ``parallel.mesh.Mesh`` (None:
    this process alone); start_poses: optional [B, 4, 4] world-frame start
    pose per robot (identity by default: unknown relative starts);
    device: where the Systems, the graph and the snapshots live ("cuda"
    unless the caller asks for "cpu"); system_kwargs go to each System."""

    def __init__(self, parameters, n_robots: int,
                 mesh: Optional[Mesh] = None,
                 start_poses: Optional[Sequence] = None,
                 max_nodes: int = 1024, max_edges: int = 4096,
                 snapshot_kp: int = 64, device="cuda", **system_kwargs):
        self.n_robots = int(n_robots)
        self.systems = [System(parameters, device=device, **system_kwargs)
                        for _ in range(self.n_robots)]
        self.backend = MappingBackend(mesh, max_nodes=max_nodes,
                                      max_edges=max_edges, device=device)
        if start_poses is None:
            start_poses = [np.eye(4, dtype=np.float32)] * self.n_robots
        self.start_poses = [np.asarray(p, np.float32) for p in start_poses]
        self.snapshot_kp = snapshot_kp
        self._n_keyframes = [0] * self.n_robots

    def init(self, fx, fy, cx, cy, baseline, *, width, height, **kw):
        for s in self.systems:
            s.init(fx, fy, cx, cy, baseline, width=width, height=height,
                   **kw)

    @property
    def camera(self):
        return self.systems[0].camera

    def input_primary_sensor_data(self, robot: int, stamp: float, left,
                                  right, scan=None, scan_times=None):
        """Feed one frame of one robot, then harvest its finished
        keyframes: the snapshot is taken right after the input, so it is of
        the keyframe's own frame."""
        self.systems[robot].input_primary_sensor_data(
            stamp, left, right, scan=scan, scan_times=scan_times)
        self._harvest(robot)

    def input_wheel_odometry(self, robot: int, stamp: float, pose6,
                             velocity6=None):
        self.systems[robot].input_wheel_odometry(stamp, pose6, velocity6)

    def _harvest(self, robot: int):
        sys_ = self.systems[robot]
        while True:
            out = sys_.output_odometry_info()
            if out is None:
                return
            if bool(out.keyframe) and not bool(out.lost):
                world_pose = self.start_poses[robot] @ np.asarray(out.pose)
                snap = sys_.keyframe_snapshot(max_kp=self.snapshot_kp)
                node = self.backend.add_keyframe(
                    world_pose, float(out.stamp), snapshot=snap, robot=robot)
                if node is not None:
                    self._n_keyframes[robot] += 1

    def finish(self):
        """Harvest every robot's pending outputs into the graph."""
        for r in range(self.n_robots):
            self._harvest(r)


class FleetMapping(_SharedGraph):
    """Lockstep multi-robot mapping, one robot per rank of a ``dp`` mesh
    (``slam.fleet.dp_fleet_step``: every sensor strategy, laser included),
    all feeding one shared keyframe graph; the twin of ``MultiRobotMapping``
    (N Systems on one host's schedule).

    mesh: a ``parallel.mesh.Mesh`` with axis "dp" (``fleet_mesh(group)``);
    None is this process alone, a session of one robot.  Robot r is rank r,
    its state seeded seed + r.  Every rank holds the same graph: a robot
    that makes a keyframe snapshots it on its rank, the snapshots are
    all-gathered, and every rank inserts them in robot order.  The
    pose-graph solve is edge-sharded over the same group.  ``lk_params``
    comes from the config with ``backend="pallas"`` (K1), as ``System``'s
    does; device "cuda" unless the caller asks for "cpu"."""

    def __init__(self, parameters, mesh: Optional[Mesh] = None,
                 start_poses=None, max_nodes: int = 1024,
                 max_edges: int = 4096, snapshot_kp: int = 64,
                 feature_capacity_factor: int = 3, seed: int = 0,
                 device="cuda"):
        if mesh is not None and mesh.axis != "dp":
            raise ValueError(f"FleetMapping: a mesh with axis 'dp', got "
                             f"{mesh.axis!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FleetMapping: device 'cuda' requested but "
                               "CUDA is not available")
        self.mesh = mesh
        group = None if mesh is None else mesh.group
        self.n_robots = 1 if group is None else dist.get_world_size(group)
        self.robot = 0 if group is None else dist.get_rank(group)
        self.cfg: VISFSConfig = (
            parameters if isinstance(parameters, VISFSConfig)
            else config_from_parameters(parameters))
        self.settings = _build_settings(self.cfg)
        self.lk_params = LKParams.from_config(self.cfg)
        self._cfg_hash = build_cfg_hash(self.cfg)
        self._capacity_factor = feature_capacity_factor
        self._seed = seed
        self.camera = None
        self.state = None  # this rank's robot
        self.backend = MappingBackend(edge_mesh(group), max_nodes=max_nodes,
                                      max_edges=max_edges, device=device)
        if start_poses is None:
            start_poses = [np.eye(4, dtype=np.float32)] * self.n_robots
        self.start_poses = [np.asarray(p, np.float32) for p in start_poses]
        self.snapshot_kp = snapshot_kp
        self._n_keyframes = [0] * self.n_robots

    def init(self, fx, fy, cx, cy, baseline, *, width, height):
        self.camera = make_stereo_camera(fx, fy, cx, cy, baseline,
                                         width=width, height=height,
                                         device=self.device)
        self.state = init_state(
            height, width,
            capacity=int(self._capacity_factor
                         * self.cfg.tracker_max_features),
            window=self.cfg.local_map_map_size + 1, device=self.device,
            seed=self._seed + self.robot, lk_pad=lk_pad(self.lk_params),
            lk_max_level=self.lk_params.max_level)

    def step(self, stamps, lefts, rights) -> FrameOutput:
        """Advance the whole fleet one frame: stamps [B], images [B, H, W]
        (each rank reads its own robot's row).  Harvests the keyframes into
        the shared graph; returns the [B]-batched FrameOutput (numpy)."""
        r = self.robot
        self.state, outs = dp_fleet_step(
            self.mesh, self.state,
            torch.as_tensor(lefts[r], dtype=torch.float32,
                            device=self.device).contiguous(),
            torch.as_tensor(rights[r], dtype=torch.float32,
                            device=self.device).contiguous(),
            torch.full((), float(stamps[r]), dtype=torch.float32,
                       device=self.device),
            self.camera, self.settings, self.lk_params, self._cfg_hash)
        host = fleet_outputs_to_numpy([outs])[0]
        made = [bool(host.keyframe[i]) and not bool(host.lost[i])
                for i in range(self.n_robots)]
        if any(made):
            # fixed shapes: every rank sends its snapshot, the keyframes'
            # are kept
            snap = snapshot_features(self.state.features,
                                     self.state.prev_left, self.camera,
                                     max_kp=self.snapshot_kp)
            rows = gather_stacked(snap, None if self.mesh is None
                                  else self.mesh.group)
            for i in range(self.n_robots):
                if not made[i]:
                    continue
                world_pose = self.start_poses[i] @ np.asarray(host.pose[i])
                node = self.backend.add_keyframe(
                    world_pose, float(host.stamp[i]),
                    snapshot=KeyframeSnapshot(*[f[i] for f in rows]),
                    robot=i)
                if node is not None:
                    self._n_keyframes[i] += 1
        return host
