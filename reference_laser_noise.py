"""How far float-level noise moves the JAX package's System (visfs_tpu) on
the CPU at SensorStrategy 4 (laser and wheel) and 5 (laser only), at the
operating point of chip_smoke.py's phase small: the 8-frame 160x120
textured square loop (seed 0, speed 2.0, 180-beam scans), bench.py's
parameters at 160 px with 40 features, a submap every 3 scans, wheel rows
at strategy 4 and none at 5.

    JAX_PLATFORMS=cpu python reference_laser_noise.py [--seeds 4]

Each seed nudges every float32 array of the state by one ulp, up or down at
random, and
  - stepped: steps each frame i >= 1 once from the unperturbed run's state
    before i, nudged;
  - free: runs frames 1.. from the state before frame 1, nudged again
    before every frame.
Prints one JSON line a strategy: the unperturbed run's ATE, and per frame
the largest translation gap (m) to the unperturbed run over the seeds, the
unperturbed run's (inliers, lost) and the distinct (inliers, lost) of the
stepped frames over the seeds.  A frame whose stepped outcomes fall on both
sides of Estimator/MinInliers is lost or kept by the rounding alone.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bench import _params
    from visfs_tpu.io.sim import ate_rmse, cached_textured_sequence
    from visfs_tpu.slam.system import System

    seq = cached_textured_sequence(n_frames=8, width=160, height=120,
                                   motion="square", seed=0, speed=2.0,
                                   with_laser=True, n_beams=180)
    cam = seq.camera
    n = len(seq.stamps)
    odom = seq.wheel_odom
    starts = [0]
    for i in range(n):
        j = starts[-1]
        while j < len(odom) and odom[j][0] <= seq.stamps[i] + 1e-9:
            j += 1
        starts.append(j)

    def copy(state):
        # the step donates its state's buffers: keep copies
        return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True),
                                      state)

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

    for strategy in (4, 5):
        p = dict(_params(160), **{"Tracker/MaxFeatures": 40,
                                  "LocalMap/NumRangeDataLimit": 3,
                                  "System/SensorStrategy": strategy})
        s = System(p, scan_capacity=256)
        s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(cam.baseline), width=cam.width, height=cam.height)

        def feed(i):
            a, b = starts[i], starts[i + 1]
            if strategy == 4 and b > a:
                rows = np.asarray(odom[a:b])
                s.input_wheel_odometry_batch(rows[:, 0], rows[:, 1:7])
            s.input_primary_sensor_data(float(seq.stamps[i]), seq.left[i],
                                        seq.right[i], scan=seq.laser_scans[i])

        def t(out):
            return np.asarray(out.pose, np.float64)[:3, 3]

        before, base = [], []
        for i in range(n):
            before.append(copy(s.state))
            feed(i)
            base += s.drain_outputs()
        stepped = np.zeros(n - 1)
        free = np.zeros(n - 1)
        outcomes = [set() for _ in range(n - 1)]
        for seed in range(args.seeds):
            rng = np.random.default_rng(seed)
            for i in range(1, n):
                s.state = nudge(before[i], rng)
                feed(i)
                out = s.drain_outputs()[-1]
                gap = np.abs(t(out) - t(base[i])).max()
                stepped[i - 1] = max(stepped[i - 1], gap)
                outcomes[i - 1].add((int(out.n_inliers), bool(out.lost)))
            s.state = copy(before[1])
            for i in range(1, n):
                s.state = nudge(s.state, rng)
                feed(i)
            for i, out in enumerate(s.drain_outputs(), start=1):
                gap = np.abs(t(out) - t(base[i])).max()
                free[i - 1] = max(free[i - 1], gap)
        print(json.dumps({
            "strategy": strategy, "wheel_rows": strategy == 4,
            "seeds": args.seeds,
            "ate_m": ate_rmse(np.stack([np.asarray(o.pose) for o in base]),
                              seq.poses),
            "stepped_gap_m": [float(g) for g in stepped],
            "free_gap_m": [float(g) for g in free],
            "min_inliers": s.cfg.estimator_min_inliers,
            "outcomes": [[int(o.n_inliers), bool(o.lost)] for o in base],
            "stepped_outcomes": [sorted(o) for o in outcomes]}),
            flush=True)


if __name__ == "__main__":
    main()
