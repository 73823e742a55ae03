"""Kernel profile of visfs_tpu_torch's fused step (the twin of
tools/op_profile.py, on torch.profiler).

N sustained frames of the 640x480 textured square loop (after 5 untraced
frames) run under ``utils.timer.device_trace``'s torch.profiler with the
step's four stage functions (slam/system.py: ``track_stage``,
``prepare_stage``, ``ba_stage``, ``finalize_stage``) wrapped in
``record_function`` ranges.  Every CUDA kernel is attributed to the range
whose host code launched it (the profiler's correlation of a launch with
the op around it).  Prints per frame: the kernels and the kernel time of
each stage and of the whole step, the wall time, the device's busy share
(kernel time over wall time), and the kernels that take the most time.

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
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools.torch_ablate_stages import bench_system  # noqa: E402

STAGES = ("track_stage", "prepare_stage", "ba_stage", "finalize_stage")
WARM_FRAMES = 5


def kernels_under(ev):
    """(kernel count, kernel us) launched under a profiler CPU event."""
    n, us = len(ev.kernels), sum(k.duration for k in ev.kernels)
    for c in ev.cpu_children:
        cn, cus = kernels_under(c)
        n, us = n + cn, us + cus
    return n, us


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("frames", nargs="?", type=int, default=20)
    ap.add_argument("--s3", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=640)
    a = ap.parse_args()

    import torch
    from torch.autograd import DeviceType

    from visfs_tpu_torch.slam import system as S
    from visfs_tpu_torch.utils.timer import device_trace

    n = a.frames
    total = WARM_FRAMES + n
    _, sys_, _, _, feed = bench_system(a.device, a.width, a.s3, total)

    for i in range(WARM_FRAMES):
        feed(i)
    sys_.drain_outputs()

    originals = {name: getattr(S, name) for name in STAGES}

    def ranged(name, fn):
        def wrapper(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return wrapper

    for name, fn in originals.items():
        setattr(S, name, ranged(name, fn))
    cuda = a.device == "cuda"
    try:
        with tempfile.TemporaryDirectory() as log_dir:
            with device_trace(log_dir) as prof:
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(WARM_FRAMES, total):
                    feed(i)
                if cuda:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(S, name, fn)
    sys_.drain_outputs()

    events = prof.events()
    per_stage = collections.OrderedDict((s, [0, 0.0]) for s in STAGES)
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.name in per_stage:
            k, us = kernels_under(ev)
            per_stage[ev.name][0] += k
            per_stage[ev.name][1] += us
    # the stage ranges also appear on the device's timeline (their GPU user
    # annotations): those are spans, not kernels
    kernels = [ev for ev in events if ev.device_type == DeviceType.CUDA
               and ev.name not in per_stage]
    k_all = len(kernels)
    us_all = sum(ev.time_range.elapsed_us() for ev in kernels)
    by_name = collections.Counter()
    count = collections.Counter()
    for ev in kernels:
        by_name[ev.name] += ev.time_range.elapsed_us()
        count[ev.name] += 1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if cuda else "cpu"
    mode = "strategy-3 mapping" if a.s3 else "stereo (strategy 0)"
    print(f"\n[{mode}] {n} frames on {a.device} ({smi}), per frame:")
    print(f"{'range':<16}{'kernels':>10}{'kernel ms':>12}")
    for name, (k, us) in per_stage.items():
        print(f"{name:<16}{k / n:>10.1f}{us / 1e3 / n:>12.3f}")
    k_st = sum(v[0] for v in per_stage.values())
    us_st = sum(v[1] for v in per_stage.values())
    print(f"{'outside stages':<16}{(k_all - k_st) / n:>10.1f}"
          f"{(us_all - us_st) / 1e3 / n:>12.3f}")
    print(f"{'whole step':<16}{k_all / n:>10.1f}{us_all / 1e3 / n:>12.3f}")
    busy = us_all / 1e6 / wall if wall > 0 else 0.0
    print(f"wall {wall / n * 1e3:.2f} ms a frame under the profiler, "
          f"device busy share {busy:.4f}")
    print("kernels taking the most time (ms a frame, launches a frame):")
    for name, us in by_name.most_common(12):
        print(f"  {us / 1e3 / n:8.3f} {count[name] / n:7.1f}  {name[:90]}")
    print(json.dumps({
        "tool": "torch_op_profile", "mode": mode, "frames": n,
        "device": a.device, "card": smi, "width": a.width,
        "stages": {k: {"kernels": v[0] / n, "kernel_ms": v[1] / 1e3 / n}
                   for k, v in per_stage.items()},
        "outside_stages": {"kernels": (k_all - k_st) / n,
                           "kernel_ms": (us_all - us_st) / 1e3 / n},
        "kernels_per_frame": k_all / n, "kernel_ms_per_frame":
            us_all / 1e3 / n, "wall_ms_per_frame": wall / n * 1e3,
        "busy_share": busy}))


if __name__ == "__main__":
    main()
