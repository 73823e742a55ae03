"""ATE of visfs_tpu_torch's System at the reference bench's phase 4
(bench.py:187-262), as chip_smoke.py's phase s3 drives it (its parameters,
render and feeder), on the CPU or the card and on its own render or on the
frames of a sequence npz.

    python tools/torch_s3_ate.py [--device cpu] [--frames-npz PATH]

--frames-npz takes a cached sequence of either package's simulator (the
arrays left, right, stamps, poses, wheel_odom and laser_scans; e.g. the
file that ``JAX_PLATFORMS=cpu python reference_s3_ate.py`` leaves in
$VISFS_SIM_CACHE), so the port runs over the reference's own render.  The
script imports no JAX.  Prints one JSON line: ATE over frames 2.., lost
frames among them, the fewest inliers and the submap slots' counts.
"""

import argparse
import json
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (S3_RENDER, S3_SCAN_CAPACITY, WIDTH,  # noqa: E402
                        make_system, s3_params, wheel_and_scan_feeder)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames-npz")
    args = ap.parse_args()

    import torch

    from visfs_tpu_torch.io.sim import (ate_rmse, cached_textured_sequence,
                                        default_camera)
    from visfs_tpu_torch.slam.system import System

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    if args.frames_npz:
        z = np.load(args.frames_npz)
        left = z["left"].astype(np.float32)
        seq = types.SimpleNamespace(
            left=left, right=z["right"].astype(np.float32),
            stamps=z["stamps"], poses=z["poses"], wheel_odom=z["wheel_odom"],
            laser_scans=z["laser_scans"],
            camera=default_camera(left.shape[2], left.shape[1], args.device))
    else:
        seq = cached_textured_sequence(device=args.device, **S3_RENDER)
    s = make_system(System, seq.camera, s3_params(WIDTH), args.device,
                    scan_capacity=S3_SCAN_CAPACITY)
    feed = wheel_and_scan_feeder(s, seq, seq.left, seq.right)
    for i in range(len(seq.stamps)):
        feed(i)
    outs = s.drain_outputs()[2:]
    est = np.stack([o.pose for o in outs])
    sub = s.state.laser.submaps
    print(json.dumps({
        "strategy": 3, "device": args.device, "frames": len(outs),
        "frames_from": args.frames_npz or "own render",
        "ate_m": ate_rmse(est, seq.poses[2:2 + len(est)]),
        "lost": int(sum(bool(o.lost) for o in outs)),
        "min_inliers": int(min(int(o.n_inliers) for o in outs)),
        "slot_valid": sub.slot_valid.tolist(),
        "num_range_data": sub.num_range_data.tolist()}), flush=True)


if __name__ == "__main__":
    main()
