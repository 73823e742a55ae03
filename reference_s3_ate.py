"""ATE of the JAX package's System (visfs_tpu) on the CPU at the reference
bench's phase 4 ("mapping-s3", bench.py:187-262): SensorStrategy 3 (stereo,
laser and wheel, with submap building) over the 120-frame 640x480 textured
square loop (seed 1, speed 2.0, 180-beam scans), wheel rows fed in one batch
before each frame.  The reference figure beside which PERF.md sets
visfs_tpu_torch's phase s3 on the card (chip_smoke.py).

    JAX_PLATFORMS=cpu python reference_s3_ate.py [--frames 120]

Prints one JSON line: ATE over frames 2.. (as bench.py and chip_smoke.py
compute it), lost frames among them, the fewest inliers, and the live
submap slots with their range-data counts at the end.

    JAX_PLATFORMS=cpu python reference_s3_ate.py --strategy 4
        [--range-limit 3]

runs the same loop at SensorStrategy 4 (stereo with the laser terms in the
BA and wheel rows), the figure beside chip_smoke.py's phase s4; with
--range-limit, LocalMap/NumRangeDataLimit set to it (3 is phase small's
fusion_params).  --nudge-seeds K adds K free runs, each nudging every
float32 array of the state by one ulp, up or down at random (seed k),
before every frame from frame --nudge-from (default 1, the first after
the bootstrap frame) on, as reference_laser_noise.py's free runs do: the
spread float-level noise alone gives the ATE (one more JSON line, the ATE,
lost frames and frame-1 error of each run).  frame1_err_m is the
translation error of frame 1's pose against the ground truth.
--submaps-out PATH saves the unperturbed run's submaps (an npz of the
ActiveSubmaps2D fields), which ``python tools/torch_s3_ate.py --device cpu
--probe-submaps PATH`` holds to chip_smoke.py's map probes.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--strategy", type=int, default=3, choices=(3, 4))
    ap.add_argument("--range-limit", type=int, default=None)
    ap.add_argument("--nudge-seeds", type=int, default=0)
    ap.add_argument("--nudge-from", type=int, default=1)
    ap.add_argument("--submaps-out")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bench import _params
    from visfs_tpu.io.sim import ate_rmse, cached_textured_sequence
    from visfs_tpu.slam.system import System

    seq = cached_textured_sequence(n_frames=args.frames, width=640,
                                   height=480, motion="square", seed=1,
                                   speed=2.0, with_laser=True, n_beams=180)
    cam = seq.camera
    params = dict(_params(640), **{"System/SensorStrategy": args.strategy})
    if args.range_limit is not None:
        params["LocalMap/NumRangeDataLimit"] = args.range_limit

    def nudge(state, rng):
        def one(x):
            a = np.asarray(x)
            if a.dtype != np.float32:
                return jnp.asarray(a)
            up = rng.integers(0, 2, a.shape).astype(bool)
            return jnp.asarray(np.where(
                up, np.nextafter(a, np.float32(np.inf)),
                np.nextafter(a, np.float32(-np.inf))).astype(np.float32))
        return jax.tree_util.tree_map(one, state)

    def run(rng=None):
        s = System(params, scan_capacity=256)  # bench.py:199-206
        s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(cam.baseline), width=cam.width, height=cam.height)
        wheel = seq.wheel_odom
        odom_i = 0
        outs = []
        for i in range(args.frames):
            j = odom_i
            while j < len(wheel) and wheel[j][0] <= seq.stamps[i] + 1e-9:
                j += 1
            if j > odom_i:
                rows = wheel[odom_i:j]
                s.input_wheel_odometry_batch(rows[:, 0], rows[:, 1:7])
                odom_i = j
            if rng is not None and i >= args.nudge_from:
                s.state = nudge(s.state, rng)
            s.input_primary_sensor_data(float(seq.stamps[i]), seq.left[i],
                                        seq.right[i], scan=seq.laser_scans[i])
            outs.append(s.output_odometry_info())
        return s, outs

    def frame1_err(outs):
        return float(np.linalg.norm(np.asarray(outs[1].pose)[:3, 3]
                                    - seq.poses[1][:3, 3]))

    s, outs = run()
    err1 = frame1_err(outs)
    outs = outs[2:]
    est = np.stack([np.asarray(o.pose) for o in outs])
    sub = jax.device_get(s.state.laser.submaps)
    if args.submaps_out:
        np.savez(args.submaps_out, **{f: np.asarray(getattr(sub, f))
                                      for f in sub._fields})
    print(json.dumps({
        "strategy": args.strategy,
        "range_limit": args.range_limit, "frames": len(outs),
        "ate_m": ate_rmse(est, seq.poses[2:2 + len(est)]),
        "lost": int(sum(bool(o.lost) for o in outs)),
        "min_inliers": int(min(int(o.n_inliers) for o in outs)),
        "frame1_err_m": err1,
        "slot_valid": np.asarray(sub.slot_valid).tolist(),
        "num_range_data": np.asarray(sub.num_range_data).tolist()}),
        flush=True)
    if args.nudge_seeds:
        runs = []
        for seed in range(args.nudge_seeds):
            _, o = run(np.random.default_rng(seed))
            est = np.stack([np.asarray(x.pose) for x in o[2:]])
            runs.append({"seed": seed,
                         "ate_m": ate_rmse(est, seq.poses[2:2 + len(est)]),
                         "lost": int(sum(bool(x.lost) for x in o[2:])),
                         "frame1_err_m": frame1_err(o)})
        print(json.dumps({"strategy": args.strategy,
                          "range_limit": args.range_limit,
                          "nudge_from": args.nudge_from,
                          "nudged_runs": runs}), flush=True)


if __name__ == "__main__":
    main()
