"""ATE of visfs_tpu_torch's System at the reference bench's phase 4
(bench.py:187-262), as chip_smoke.py's phase s3 drives it (its parameters,
render and feeder), on the CPU or the card and on its own render or on the
frames of a sequence npz.

    python tools/torch_s3_ate.py [--device cpu] [--frames-npz PATH]
        [--strategy 4]

--frames-npz takes a cached sequence of either package's simulator (the
arrays left, right, stamps, poses, wheel_odom and laser_scans; e.g. the
file that ``JAX_PLATFORMS=cpu python reference_s3_ate.py`` leaves in
$VISFS_SIM_CACHE), so the port runs over the reference's own render.  The
script imports no JAX.  Prints one JSON line: ATE over frames 2.., lost
frames among them, the fewest inliers, frame 1's translation error against
the ground truth, the submap slots' counts and the map probes of
chip_smoke.py's map gate that fail.
--strategy 4 runs the loop at SensorStrategy 4 (chip_smoke.py's phase s4;
reference_s3_ate.py --strategy 4 is the JAX package's run of it).
--nudge-seeds K adds K free runs, each nudging every float32 tensor of the
state by one ulp, up or down at random (seed k), before every frame from
frame --nudge-from (default 1) on, as reference_s3_ate.py's nudged runs
do (one more JSON line: the ATE, lost frames and frame-1 error of each).
--probe-submaps PATH prints chip_smoke.py's map probes on the submaps that
``reference_s3_ate.py --submaps-out PATH`` saved, and runs nothing else.
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
    ap.add_argument("--strategy", type=int, default=3, choices=(3, 4))
    ap.add_argument("--nudge-seeds", type=int, default=0)
    ap.add_argument("--nudge-from", type=int, default=1)
    ap.add_argument("--probe-submaps")
    args = ap.parse_args()

    import torch

    from visfs_tpu_torch.io.sim import (ate_rmse, cached_textured_sequence,
                                        default_camera)
    from visfs_tpu_torch.multichip import map_probes
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
    if args.probe_submaps:
        from visfs_tpu_torch.slam import state as state_mod

        saved = types.SimpleNamespace(**np.load(args.probe_submaps))
        sub = state_mod._convert(
            state_mod.ActiveSubmaps2D, saved,
            lambda x: state_mod._to_torch(x, args.device))
        rows, bad = map_probes(sub, seq.room)
        print(json.dumps({"submaps_from": args.probe_submaps,
                          "map_probes": rows, "map_probes_failing": bad}),
              flush=True)
        return
    params = dict(s3_params(WIDTH),
                  **{"System/SensorStrategy": args.strategy})

    def nudge(x, gen):
        """x with every float32 tensor one ulp up or down at random."""
        if isinstance(x, torch.Tensor):
            if x.dtype != torch.float32:
                return x
            up = torch.randint(0, 2, x.shape, generator=gen).bool()
            inf = torch.full_like(x, float("inf"))
            return torch.nextafter(x, torch.where(up.to(x.device), inf, -inf))
        if isinstance(x, tuple):
            parts = [nudge(v, gen) for v in x]
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        return x

    def run(gen=None):
        s = make_system(System, seq.camera, params, args.device,
                        scan_capacity=S3_SCAN_CAPACITY)
        if gen is not None:  # after the frame's wheel rows, before its step
            step, frame = s.input_primary_sensor_data, [0]

            def nudged_step(*a, **kw):
                if frame[0] >= args.nudge_from:
                    s.state = nudge(s.state, gen)
                frame[0] += 1
                return step(*a, **kw)

            s.input_primary_sensor_data = nudged_step
        feed = wheel_and_scan_feeder(s, seq, seq.left, seq.right)
        for i in range(len(seq.stamps)):
            feed(i)
        outs = s.drain_outputs()
        err1 = float(np.linalg.norm(outs[1].pose[:3, 3] - seq.poses[1][:3, 3]))
        est = np.stack([o.pose for o in outs[2:]])
        return s, outs[2:], err1, ate_rmse(est, seq.poses[2:2 + len(est)])

    s, outs, err1, ate = run()
    sub = s.state.laser.submaps
    room = getattr(seq, "room", None)
    print(json.dumps({
        "strategy": args.strategy, "device": args.device, "frames": len(outs),
        "frames_from": args.frames_npz or "own render", "ate_m": ate,
        "lost": int(sum(bool(o.lost) for o in outs)),
        "min_inliers": int(min(int(o.n_inliers) for o in outs)),
        "frame1_err_m": err1,
        "slot_valid": sub.slot_valid.tolist(),
        "num_range_data": sub.num_range_data.tolist(),
        "map_probes_failing": (None if room is None
                               else map_probes(sub, room)[1])}), flush=True)
    if args.nudge_seeds:
        runs = []
        for seed in range(args.nudge_seeds):
            _, o, e1, a = run(torch.Generator().manual_seed(seed))
            runs.append({"seed": seed, "ate_m": a,
                         "lost": int(sum(bool(x.lost) for x in o)),
                         "frame1_err_m": e1})
        print(json.dumps({"strategy": args.strategy, "device": args.device,
                          "nudge_from": args.nudge_from,
                          "nudged_runs": runs}), flush=True)


if __name__ == "__main__":
    main()
