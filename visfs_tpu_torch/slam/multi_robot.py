"""Multi-robot mapping session: several VO streams building one map (torch
port of visfs_tpu.slam.multi_robot's ``MultiRobotMapping``).

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

from ..parallel.mesh import Mesh
from .mapping import MappingBackend
from .system import System


class MultiRobotMapping:
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
