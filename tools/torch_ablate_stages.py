"""Amortized per-stage time of visfs_tpu_torch's step (the twin of
tools/ablate_stages.py).

Each stage function that the fused ``vo_step`` calls (slam/system.py:
``track_stage``, ``prepare_stage``, ``ba_stage``, ``finalize_stage``) is
dispatched K times back to back on fixed inputs (the state after frame 29
of the 640x480 textured square loop) with one synchronisation at the end,
and so is the fused ``vo_step``.  Per call it reports the device span (CUDA
events around the K calls, over K; the host clock on the CPU) and the host
dispatch time (the host clock around the K calls before the
synchronisation, over K).  Where the two are close the stage is
host-dispatch bound: the device waits for the host, and the span is the
dispatch; tools/torch_op_profile.py gives the kernel time inside it.

    python tools/torch_ablate_stages.py [reps] [--s3] [--device cpu]
        [--width 640]

--s3 runs SensorStrategy 3 (stereo, laser, wheel: bench phase 4's
parameters, 256 scan points) on the seed-1 loop with 180-beam scans;
default is the stereo bench point (strategy 0).  Prints a table, one JSON
line a stage and, on the card, the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PARAMS = {
    "Tracker/MaxFeatures": 120,
    "Tracker/MinDistance": 40,
    "Tracker/QualityLevel": 0.05,
    "LocalMap/MapSize": 5,
    "Optimizer/Iterations": 20,
    "Estimator/Force3DoF": True,
    "Estimator/ToleranceTranslation": 0.40,
}
WARM_FRAMES = 30


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def bench_system(device, width, s3, frames):
    """The bench point's System (bench phase 4's at s3) on the first
    ``frames`` frames of its 300-frame textured loop: (sequence, System,
    left and right tensors, feed(i) of frame i with its wheel rows and
    scan at s3)."""
    import torch

    from visfs_tpu_torch.io.sim import cached_textured_sequence
    from visfs_tpu_torch.slam.system import System

    cache = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "build", "sim_cache")
    seq = cached_textured_sequence(
        cache_dir=cache, n_frames=300, width=width, height=width * 3 // 4,
        motion="square", seed=1 if s3 else 0, speed=2.0, with_laser=s3,
        n_beams=180, device=device)
    cam = seq.camera
    params = dict(PARAMS, **({"System/SensorStrategy": 3} if s3 else {}))
    params["Tracker/MinDistance"] = max(12, 40 * width // 640)
    sys_ = System(params, device=device, scan_capacity=256)
    sys_.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
              float(cam.baseline), width=cam.width, height=cam.height)
    lefts = [torch.as_tensor(f, device=device) for f in seq.left[:frames]]
    rights = [torch.as_tensor(f, device=device) for f in seq.right[:frames]]
    odom_i = 0

    def feed(i):
        nonlocal odom_i
        if s3:
            j = odom_i
            while seq.wheel_odom[j][0] <= seq.stamps[i] + 1e-9:
                j += 1
            rows = seq.wheel_odom[odom_i:j]
            sys_.input_wheel_odometry_batch(rows[:, 0], rows[:, 1:7])
            odom_i = j
        sys_.input_primary_sensor_data(
            float(seq.stamps[i]), lefts[i], rights[i],
            scan=seq.laser_scans[i] if s3 else None)

    return seq, sys_, lefts, rights, feed


def amortized(fn, reps, device):
    """(device ms, host dispatch ms) per call of fn over reps calls."""
    import torch

    fn()  # warm (allocator, kernel caches)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    if cuda:
        e1.record()
        torch.cuda.synchronize()
        dev = e0.elapsed_time(e1)
    else:
        dev = host * 1e3
    return dev / reps, host * 1e3 / reps


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reps", nargs="?", type=int, default=30)
    ap.add_argument("--s3", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=640)
    a = ap.parse_args()
    s3, device, reps, width = a.s3, a.device, a.reps, a.width

    import torch

    from visfs_tpu_torch.slam import system as S

    seq, sys_, lefts, rights, feed = bench_system(device, width, s3,
                                                  WARM_FRAMES + 1)
    cam = seq.camera
    for i in range(WARM_FRAMES):
        feed(i)
    sys_.drain_outputs()

    i = WARM_FRAMES
    st, left, right = sys_.state, lefts[i], rights[i]
    stamp = torch.full((), float(seq.stamps[i]), dtype=torch.float32,
                       device=device)
    scan = {}
    if s3:
        pts, msk, tms = sys_._scan_inputs(seq.laser_scans[i], None)
        scan = dict(scan_points=pts, scan_mask=msk, scan_times=tms)
    cfg, lk, h = sys_.settings, sys_.lk_params, sys_._cfg_hash
    ts = S.track_stage(st, left, right, stamp, cam, cfg, lk, h)
    problem, ctx = S.prepare_stage(st, ts, stamp, cam, cfg, *scan.values())
    res_ba = S.ba_stage(problem, cfg)

    rows = [
        ("track (CLAHE+pyramids+LK K1 x2+GFTT+triang)",
         lambda: S.track_stage(st, left, right, stamp, cam, cfg, lk, h)),
        ("prepare (PnP RANSAC + window insert"
         + (" + laser + wheel)" if s3 else ")"),
         lambda: S.prepare_stage(st, ts, stamp, cam, cfg, *scan.values())),
        ("local bundle (Schur GN/LM, 2x10 it)",
         lambda: S.ba_stage(problem, cfg)),
        ("finalize (fusion+marginalize"
         + ("+submap insert)" if s3 else "+feedback)"),
         lambda: S.finalize_stage(st, ts, ctx, res_ba, stamp, cam, cfg)),
    ]
    results = [(name, *amortized(fn, reps, device)) for name, fn in rows]
    fused = amortized(lambda: S.vo_step(st, left, right, stamp, cam, cfg,
                                        lk, h, **scan), reps, device)

    mode = "strategy-3 mapping" if s3 else "stereo (strategy 0)"
    smi = card_line() if device == "cuda" else "cpu"
    print(f"\n[{mode}] {reps} calls each on {device} ({smi})")
    print(f"{'stage':<52}{'span ms':>10}{'host ms':>10}")
    for name, dev, host in results:
        print(f"{name:<52}{dev:>10.2f}{host:>10.2f}")
    print(f"{'sum of stages':<52}{sum(r[1] for r in results):>10.2f}"
          f"{sum(r[2] for r in results):>10.2f}")
    print(f"{'fused vo_step':<52}{fused[0]:>10.2f}{fused[1]:>10.2f}")
    for name, dev, host in results + [("fused vo_step", *fused)]:
        print(json.dumps({"tool": "torch_ablate_stages", "mode": mode,
                          "stage": name, "device_span_ms": dev,
                          "host_ms": host, "width": width,
                          "reps": reps, "device": device, "card": smi}))


if __name__ == "__main__":
    main()
