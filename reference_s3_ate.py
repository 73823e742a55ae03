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
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from bench import _params
    from visfs_tpu.io.sim import ate_rmse, cached_textured_sequence
    from visfs_tpu.slam.system import System

    seq = cached_textured_sequence(n_frames=args.frames, width=640,
                                   height=480, motion="square", seed=1,
                                   speed=2.0, with_laser=True, n_beams=180)
    cam = seq.camera
    s = System(dict(_params(640), **{"System/SensorStrategy": 3}),
               scan_capacity=256)  # bench.py:199-206
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
        s.input_primary_sensor_data(float(seq.stamps[i]), seq.left[i],
                                    seq.right[i], scan=seq.laser_scans[i])
        outs.append(s.output_odometry_info())
    outs = outs[2:]
    est = np.stack([np.asarray(o.pose) for o in outs])
    sub = jax.device_get(s.state.laser.submaps)
    print(json.dumps({
        "strategy": 3, "frames": len(outs),
        "ate_m": ate_rmse(est, seq.poses[2:2 + len(est)]),
        "lost": int(sum(bool(o.lost) for o in outs)),
        "min_inliers": int(min(int(o.n_inliers) for o in outs)),
        "slot_valid": np.asarray(sub.slot_valid).tolist(),
        "num_range_data": np.asarray(sub.num_range_data).tolist()}),
        flush=True)


if __name__ == "__main__":
    main()
