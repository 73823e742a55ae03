"""How far visfs_tpu_torch's FleetSystem (the vmapped step) runs from a
System of each stream's seed over the same frames: tests/test_torch_fleet_
streams.py's scene (160x120, its PARAMS, stream b from frame b), free
running.

    python tools/torch_fleet_gap.py [--device cpu] [--frames 8] [--streams 2]

Prints one JSON line: over all streams and frames, the largest translation
gap (m), yaw gap (rad) and inlier difference, and whether every lost flag
agrees.  The script imports no JAX.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import bench_params  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--streams", type=int, default=2)
    args = ap.parse_args()

    from visfs_tpu_torch.io.sim import cached_textured_sequence
    from visfs_tpu_torch.slam.fleet import FleetSystem
    from visfs_tpu_torch.slam.system import System

    # tests/test_torch_system.py's PARAMS: the bench's at 160x120 with 40
    # features, as chip_smoke.py's phase small runs them
    params = dict(bench_params(160), **{"Tracker/MaxFeatures": 40})
    t, b = args.frames, args.streams
    seq = cached_textured_sequence(n_frames=t + b - 1, width=160, height=120,
                                   motion="square", seed=0, speed=2.0,
                                   device=args.device)
    cam = seq.camera

    def init(s):
        s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(cam.baseline), width=cam.width, height=cam.height)

    def lane(a):
        return np.stack([a[k:k + t] for k in range(b)], axis=1)

    fleet = FleetSystem(params, n_streams=b, device=args.device)
    init(fleet)
    outs = fleet.run_sequences(lane(seq.stamps), lane(seq.left),
                               lane(seq.right))
    gap = dict(max_dt_m=0.0, max_dyaw_rad=0.0, max_d_inliers=0,
               lost_flags_agree=True)
    for k in range(b):
        single = System(params, device=args.device, seed=k)
        init(single)
        ref = single.run_sequence(seq.stamps[k:k + t], seq.left[k:k + t],
                                  seq.right[k:k + t])
        for o, r in zip(outs, ref):
            p, q = o.pose[k], r.pose
            yaw = (np.arctan2(p[1, 0], p[0, 0])
                   - np.arctan2(q[1, 0], q[0, 0]))
            gap["max_dt_m"] = max(gap["max_dt_m"],
                                  float(np.abs(p[:3, 3] - q[:3, 3]).max()))
            gap["max_dyaw_rad"] = max(gap["max_dyaw_rad"], float(abs(yaw)))
            gap["max_d_inliers"] = max(
                gap["max_d_inliers"],
                abs(int(o.n_inliers[k]) - int(r.n_inliers)))
            gap["lost_flags_agree"] &= bool(o.lost[k]) == bool(r.lost)
    print(json.dumps(dict(gap, device=args.device, frames=t, streams=b)))


if __name__ == "__main__":
    main()
