"""Kernel profile of visfs_tpu_torch's fused step (the twin of
tools/op_profile.py, on torch.profiler).

N sustained frames of the 640x480 textured square loop (after 5 untraced
frames) run under ``utils.timer.device_trace``'s torch.profiler with the
program's span recorder on, each frame's result taken one frame behind
(``output_odometry_info``), as a node takes them.  Every device operation is
put under the stage span of ``vo_step`` (``slam.system.STAGES``) that held
the start of the host operation that launched it (``utils.timer.device_ops``
and ``attribute``).  Prints per frame: the kernels, the kernel time and the
host time (the span's own) of each stage and of the whole step; the host
time of ``system.input`` (the feed) and ``system.output`` (the take: the
copy and the wait for the card); each frame's latency from its feed to its
result on the host (its two spans joined by the frame id), median and
largest; the wall time, the device's busy share (kernel time over wall
time), the device's idle time by the span that launched the operation
ending each gap (``utils.timer.idle_by_span``), and the kernels that take
the most time.

    python tools/torch_op_profile.py [n_frames] [--s3] [--device cpu]
        [--width 640]

--s3 runs SensorStrategy 3 (bench phase 4: wheel rows and 180-beam scans,
256 scan points) on the seed-1 loop.  On the CPU the trace holds no
kernels; the run then only checks the tool.
"""

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools.torch_ablate_stages import bench_system  # noqa: E402

WARM_FRAMES = 5


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("frames", nargs="?", type=int, default=20)
    ap.add_argument("--s3", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=640)
    a = ap.parse_args()

    import torch

    from visfs_tpu_torch.slam.system import STAGES
    from visfs_tpu_torch.utils import timer

    n = a.frames
    total = WARM_FRAMES + n
    _, sys_, _, _, feed = bench_system(a.device, a.width, a.s3, total)

    for i in range(WARM_FRAMES):
        feed(i)
    sys_.drain_outputs()

    cuda = a.device == "cuda"
    timer.enable()
    try:
        with tempfile.TemporaryDirectory() as log_dir:
            with timer.device_trace(log_dir) as prof:
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(WARM_FRAMES, total):
                    feed(i)
                    if i > WARM_FRAMES:
                        sys_.output_odometry_info()
                sys_.output_odometry_info()
                if cuda:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
    finally:
        timer.disable()
    spans = timer.drain()

    ops = timer.device_ops(prof)
    per_stage = timer.attribute(ops, spans, STAGES)
    outside = per_stage.pop("other")
    own = timer.self_ns(spans)
    host_ms = collections.Counter()
    for sp in spans:
        host_ms[sp.name] += own[sp.id] * 1e-6
    feed_ms = sum((sp.end_ns - sp.start_ns) * 1e-6 for sp in spans
                  if sp.name == "system.input")
    latency = sorted(t * 1e-6 for t in timer.latency_ns(
        spans, "system.input", "system.output").values())
    idle = timer.idle_by_span(ops, spans)
    k_all = len(ops)
    us_all = sum(e - s for _, s, e, _ in ops) / 1e3
    by_name = collections.Counter()
    count = collections.Counter()
    for _, s, e, name in ops:
        by_name[name] += (e - s) / 1e3
        count[name] += 1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if cuda else "cpu"
    mode = "strategy-3 mapping" if a.s3 else "stereo (strategy 0)"
    print(f"\n[{mode}] {n} frames on {a.device} ({smi}), per frame:")
    print(f"{'range':<16}{'kernels':>10}{'kernel ms':>12}{'host ms':>10}")
    for name, (k, sec) in per_stage.items():
        print(f"{name:<16}{k / n:>10.1f}{sec * 1e3 / n:>12.3f}"
              f"{host_ms[name] / n:>10.3f}")
    print(f"{'outside stages':<16}{outside[0] / n:>10.1f}"
          f"{outside[1] * 1e3 / n:>12.3f}")
    print(f"{'whole step':<16}{k_all / n:>10.1f}{us_all / 1e3 / n:>12.3f}"
          f"{sum(host_ms[name] for name in STAGES) / n:>10.3f}")
    print(f"system.input {feed_ms / n:.3f} ms a frame (own "
          f"{host_ms['system.input'] / n:.3f}), system.output "
          f"{host_ms['system.output'] / n:.3f} ms a take")
    if latency:
        print(f"feed to result on the host: median "
              f"{statistics.median(latency):.3f} ms, largest "
              f"{latency[-1]:.3f} ms over {len(latency)} frames")
    busy = us_all / 1e6 / wall if wall > 0 else 0.0
    print(f"wall {wall / n * 1e3:.2f} ms a frame under the profiler, "
          f"device busy share {busy:.4f}")
    if idle:
        print("device idle ms a frame, by the span that launched the "
              "operation ending each gap:")
        for name, sec in sorted(idle.items(), key=lambda kv: -kv[1]):
            print(f"  {sec * 1e3 / n:8.3f}  {name}")
    print("kernels taking the most time (ms a frame, launches a frame):")
    for name, us in by_name.most_common(12):
        print(f"  {us / 1e3 / n:8.3f} {count[name] / n:7.1f}  {name[:90]}")
    print(json.dumps({
        "tool": "torch_op_profile", "mode": mode, "frames": n,
        "device": a.device, "card": smi, "width": a.width,
        "stages": {k: {"kernels": v[0] / n, "kernel_ms": v[1] * 1e3 / n,
                       "host_ms": host_ms[k] / n}
                   for k, v in per_stage.items()},
        "input_ms": feed_ms / n, "output_ms": host_ms["system.output"] / n,
        "latency_ms": {"median": statistics.median(latency),
                       "max": latency[-1]} if latency else None,
        "idle_ms_by_span": {k: v * 1e3 / n for k, v in idle.items()},
        "outside_stages": {"kernels": outside[0] / n,
                           "kernel_ms": outside[1] * 1e3 / n},
        "kernels_per_frame": k_all / n, "kernel_ms_per_frame":
            us_all / 1e3 / n, "wall_ms_per_frame": wall / n * 1e3,
        "busy_share": busy}))


if __name__ == "__main__":
    main()
