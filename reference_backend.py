"""The JAX package's mapping back-end (visfs_tpu) on the CPU at the point of
chip_smoke.py's phase backend: the reference figures beside which PERF.md
sets visfs_tpu_torch's run of it on the card, and the reference's count of
cross-robot closures that the phase holds the port to.

The session is tests/test_multi_robot.py:112-180's two-robot e2e scenario
at the bench's width and parameters (bench.py:57-72): MultiRobotMapping
with 2 robots over the textured square loop at 640x480 (seed 11, loops
2.0, room (-3, 13, -6, 6)) of FRAMES frames; robot 0 drives the first
lap, robot 1 the second from the start pose seq.poses[FRAMES // 2];
max_nodes 128, max_edges 512, snapshot_kp 48; close_loops(radius=2.5,
min_gap=8, min_inliers=10), optimize(iterations=10, cg_iters=60), the pose
graph on a one-device "edges" mesh.  FRAMES is 240 (chip_smoke.py's
phase backend): at the reference test's 160 the corners turn 0.18 rad a
frame and at this width the JAX package's VO loses 7 frames a robot at
the first corner (--frames 160 shows it).

    JAX_PLATFORMS=cpu python reference_backend.py [--frames 240]
        [--robot-frames N]

--robot-frames N drives each robot over the first N frames of its lap
(robot 0 frames 0..N-1, robot 1 frames FRAMES // 2 .. FRAMES // 2 + N - 1,
from its start pose there): the same scene and corner rate at fewer
frames (chip_smoke.py's phase backend runs N = 60).

Prints one JSON line: per robot the VO ATE over its frames after the
bootstrap frame (robot 1 lifted by its start pose) and its lost frames,
keyframes per robot, candidates, the decided pairs with (ok, n_inliers),
closures, cross-robot edges, chi2 before and after optimize, and the
keyframes' planar error (max and mean, m) before and after optimize, as
the reference test measures it.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

RENDER = dict(width=640, height=480, motion="square", seed=11, loops=2.0,
              room=(-3.0, 13.0, -6.0, 6.0))
SESSION = dict(max_nodes=128, max_edges=512, snapshot_kp=48)
LOOPS = dict(radius=2.5, min_gap=8, min_inliers=10)
SOLVE = dict(iterations=10, cg_iters=60)


def keyframe_error(poses, g, seq):
    """Planar error of each keyframe against the ground truth at its stamp
    (tests/test_multi_robot.py:160-172)."""
    n = len(poses)
    stamps = np.asarray(g.stamp[:n])
    idx = np.clip(np.searchsorted(seq.stamps, stamps - 1e-6), 0,
                  len(seq.stamps) - 1)
    return np.linalg.norm(poses[:, :2, 3] - seq.poses[idx][:, :2, 3],
                          axis=-1)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--robot-frames", type=int, default=None)
    args = ap.parse_args()
    n_frames = args.frames
    lap = n_frames // 2
    n_robot = lap if args.robot_frames is None else args.robot_frames
    robot_frames = (range(0, n_robot), range(lap, lap + n_robot))

    import jax

    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    from bench import _params
    from visfs_tpu.io.sim import ate_rmse, cached_textured_sequence
    from visfs_tpu.slam import mapping
    from visfs_tpu.slam.multi_robot import MultiRobotMapping

    seq = cached_textured_sequence(n_frames=n_frames, **RENDER)
    cam = seq.camera
    mesh = Mesh(np.array(jax.devices()[:1]), ("edges",))
    session = MultiRobotMapping(
        _params(640), n_robots=2, mesh=mesh,
        start_poses=[np.eye(4, dtype=np.float32), seq.poses[lap]], **SESSION)
    session.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                 float(cam.baseline), width=cam.width, height=cam.height)

    # the VO outputs, seen through the harvest as MultiRobotMapping pops them
    vo = {0: [], 1: []}
    for r, s in enumerate(session.systems):
        pop = s.output_odometry_info

        def recorded(pop=pop, r=r):
            out = pop()
            if out is not None:
                vo[r].append(out)
            return out

        s.output_odometry_info = recorded
    for r, frames in enumerate(robot_frames):
        for k in frames:
            session.input_primary_sensor_data(r, float(seq.stamps[k]),
                                              seq.left[k], seq.right[k])
    session.finish()

    robots = []
    for r, frames in enumerate(robot_frames):
        outs = vo[r][1:]
        est = np.stack([session.start_poses[r] @ np.asarray(o.pose)
                        for o in outs])
        gt = seq.poses[list(frames)[1:]]
        robots.append({"ate_m": ate_rmse(est, gt),
                       "lost": int(sum(bool(o.lost) for o in outs)),
                       "frames": len(outs)})

    backend = session.backend
    candidates = backend.loop_candidates(LOOPS["radius"], LOOPS["min_gap"])
    decided = []
    verify = mapping.verify_loop

    def recorded_verify(si, sj, cam_, key, **kw):
        rel, ok, n = verify(si, sj, cam_, key, **kw)
        decided.append([None, None, bool(ok), int(n)])
        return rel, ok, n

    mapping.verify_loop = recorded_verify
    try:
        pairs = [tuple(map(int, p)) for p in candidates
                 if int(p[0]) in backend.snapshots
                 and int(p[1]) in backend.snapshots]
        closures = session.close_loops(**LOOPS)
    finally:
        mapping.verify_loop = verify
    for d, p in zip(decided, pairs):
        d[0], d[1] = p

    g = backend.graph
    err_before = keyframe_error(session.poses(), g, seq)
    # the cost at the graph's own poses: a step's chi2 is taken before its
    # update
    _, chi2_before = mapping.optimize_graph(g, mesh, iterations=1,
                                            cg_iters=1)
    chi2 = session.optimize(**SOLVE)
    err_after = keyframe_error(session.poses(), backend.graph, seq)
    print(json.dumps({
        "frames": n_frames, "robot_frames": n_robot, "robots": robots,
        "keyframes": session.keyframe_counts(),
        "nodes": int(g.n_nodes), "edges": int(g.n_edges),
        "candidates": len(candidates), "decided": decided,
        "closures": closures, "cross_robot_edges": session.cross_robot_edges(),
        "chi2_before": float(chi2_before), "chi2": chi2,
        "err_before_max_m": float(err_before.max()),
        "err_before_mean_m": float(err_before.mean()),
        "err_after_max_m": float(err_after.max()),
        "err_after_mean_m": float(err_after.mean())}), flush=True)


if __name__ == "__main__":
    main()
