"""ATE of the JAX package's System (visfs_tpu) on the CPU at the three
operating points of chip_smoke.py's phases mapping, loc_cull and rgbd: the
reference figures beside which PERF.md sets visfs_tpu_torch's runs of them
on the card.

  mapping   configs/sim_mapping.yaml's visfs block (SensorStrategy 3, CLAHE
            on) over phase s3's 120-frame 640x480 loop (seed 1, speed 2.0,
            180-beam scans, wheel rows fed in one batch before each frame),
            System(scan_capacity=256, submap_extent_cells=256);
  loc_cull  configs/sim_localization.yaml's visfs block (FlowBack off) with
            Tracker/CullByFundationMatrix true and FundationPixelError 2.0,
            over the 300-frame 640x480 bench loop (seed 0, speed 2.0);
  rgbd      the bench's parameters (bench.py:57-72) with SensorStrategy 1,
            fed the left images and the ray-cast depth of the same loop;
each over its loop's first FRAMES frames (80, as chip_smoke.py runs them).

    JAX_PLATFORMS=cpu python reference_modes_ate.py [--frames 80]
        [--points mapping loc_cull rgbd]

Needs yaml.  Prints one JSON line per point: ATE over frames 2.. (as
chip_smoke.py computes it), lost frames among them, the fewest inliers.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CULL = {"Tracker/CullByFundationMatrix": True,
        "Tracker/FundationPixelError": 2.0}  # tests/test_fundamental.py:80


def visfs_block(name):
    import yaml

    with open(os.path.join(ROOT, "configs", name)) as f:
        return yaml.safe_load(f)["visfs"]


def run(System, seq, params, frames, depth=False, fusion=False, **kw):
    cam = seq.camera
    s = System(params, **kw)
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    wheel, odom_i, outs = seq.wheel_odom, 0, []
    for i in range(frames):
        scan = None
        if fusion:
            j = odom_i
            while j < len(wheel) and wheel[j][0] <= seq.stamps[i] + 1e-9:
                j += 1
            if j > odom_i:
                rows = wheel[odom_i:j]
                s.input_wheel_odometry_batch(rows[:, 0], rows[:, 1:7])
                odom_i = j
            scan = seq.laser_scans[i]
        right = seq.depth[i] if depth else seq.right[i]
        s.input_primary_sensor_data(float(seq.stamps[i]), seq.left[i], right,
                                    scan=scan)
        outs.append(s.output_odometry_info())
    return outs[2:]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--points", nargs="+",
                    default=["mapping", "loc_cull", "rgbd"])
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from bench import _params
    from visfs_tpu.io.sim import ate_rmse, cached_textured_sequence
    from visfs_tpu.slam.system import System

    n = args.frames
    for point in args.points:
        if point == "mapping":
            seq = cached_textured_sequence(
                n_frames=120, width=640, height=480, motion="square", seed=1,
                speed=2.0, with_laser=True, n_beams=180)
            outs = run(System, seq, visfs_block("sim_mapping.yaml"), n,
                       fusion=True, scan_capacity=256,
                       submap_extent_cells=256)
        else:
            seq = cached_textured_sequence(
                n_frames=300, width=640, height=480, motion="square", seed=0,
                speed=2.0, with_depth=True)
            if point == "loc_cull":
                params = dict(visfs_block("sim_localization.yaml"), **CULL)
            else:
                params = dict(_params(640), **{"System/SensorStrategy": 1})
            outs = run(System, seq, params, n, depth=point == "rgbd")
        est = np.stack([np.asarray(o.pose) for o in outs])
        print(json.dumps({
            "point": point, "frames": len(outs),
            "ate_m": ate_rmse(est, seq.poses[2:2 + len(est)]),
            "lost": int(sum(bool(o.lost) for o in outs)),
            "min_inliers": int(min(int(o.n_inliers) for o in outs))}),
            flush=True)


if __name__ == "__main__":
    main()
