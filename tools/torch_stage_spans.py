"""Stage spans of a benchmark cell: the program's span recorder read over the
benchmark's window and its profiled slice.

    python tools/torch_stage_spans.py --workload vo_bench.fleet256 --seed 7
        [--seconds 51] [--ab 3 --ab-seconds 30]
        [--device cpu --streams 2 --width 160]

The cell's fleet (``benchmark.harness.Fleet``: the lap, the streams and the
seed of a ``benchmark.run`` run) goes through the benchmark's pipeline: its
warm-up frames, then a window of ``--seconds`` with the recorder on, each
fleet frame fed and the one before it taken, then the traffic's profiled
slice under ``torch.profiler`` with the recorder on.  From the window, per
fleet frame: the host ms of each stage span of ``vo_step`` (its own time),
of ``fleet.input`` and its own time, of ``fleet.output``, a fleet frame's
latency from its feed to its result on the host (its ``fleet.input`` and
``fleet.output`` joined by the frame id), and the harness's timing of the
same call from outside (as ``fleet_dispatch_ms`` reads it).  From the
slice, per fleet frame: the device ms and operations under each stage span
and outside them ("other"; ``utils.timer.attribute``: the innermost stage
span holding the start of the host operation that launched each), the
operations and device ms as the benchmark counts them (``step_kernels``,
``device_kernel_ms``), ``device_idle_share``, the slice's idle gaps by the
span that launched the operation ending each (``idle_by_span``), the
device operations that take the most time and the stages that launched
the five largest.  Then the sum checks: ``fleet.input`` against the
outside timing, the stages and "other" against the device time, and each
operation's start against its launch (the two clocks).  The stages and
the own time of ``fleet.input`` sum to its duration by construction.

With ``--ab K``, 2K windows of ``--ab-seconds`` come first, after the
warm-up and before anything is profiled, the recorder off and on in turns
(off, on, on, off, ...): stream-frames per second each.  They come before
the slice, which leaves millions of Python objects to the garbage
collector (a full collection of them takes seconds).

Prints one JSON line.  Runs on the card unless given ``--device cpu``
(with ``--streams`` and ``--width`` for a small run; the CPU has no device
operations).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def window(fl, seconds):
    """The benchmark's measured window (``harness.run_cell``): returns
    (outside timing of each feed, s; fleet frames taken; window s).  The
    frame still in flight is taken after the window closes."""
    t0 = time.perf_counter()
    dispatch = [fl.feed()]
    taken = 0
    while True:
        dispatch.append(fl.feed())
        fl.take()
        taken += 1
        t_end = time.perf_counter()
        if t_end - t0 >= seconds:
            break
    return dispatch, taken, t_end - t0


def ab_windows(fl, pairs, seconds, sync):
    """2 ``pairs`` windows, the recorder off and on in turns (off, on, on,
    off, ...): stream-frames per second of each, by state."""
    from visfs_tpu_torch.utils import timer

    rates = {"off": [], "on": []}
    for k in range(2 * pairs):
        on = k % 4 in (1, 2)
        if on:
            timer.enable()
        _, n, s = window(fl, seconds)
        timer.disable()
        timer.drain()
        fl.take()
        sync()
        rates["on" if on else "off"].append(n * fl.B / s)
    return rates


def host_readings(spans, dispatch):
    """Means a fleet frame, ms, of the window's spans."""
    from visfs_tpu_torch.slam.system import STAGES
    from visfs_tpu_torch.utils import timer

    own = timer.self_ns(spans)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    out = {f"{name}_host_ms": _mean([own[s.id] * 1e-6 for s in
                                     by_name.get(name, [])])
           for name in STAGES}
    inputs = by_name.get("fleet.input", [])
    out["fleet.input_ms"] = _mean([(s.end_ns - s.start_ns) * 1e-6
                                   for s in inputs])
    out["fleet.input_own_ms"] = _mean([own[s.id] * 1e-6 for s in inputs])
    out["output_wait_ms"] = _mean([(s.end_ns - s.start_ns) * 1e-6
                                   for s in by_name.get("fleet.output", [])])
    latency = timer.latency_ns(spans, "fleet.input", "fleet.output")
    out["frame_latency_ms"] = _mean([t * 1e-6 for t in latency.values()])
    out["fleet_dispatch_ms"] = 1e3 * _mean(dispatch)
    out["frames"] = len(inputs)
    return out


def slice_readings(fl, frames, sync, cuda, window_frames, window_s):
    """The profiled slice (``benchmark.trace.profile_slice``'s pipeline)
    with the recorder on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from visfs_tpu_torch.slam.system import STAGES
    from visfs_tpu_torch.utils import timer

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    timer.enable()
    with profile(activities=acts) as prof:
        h0 = time.perf_counter()
        fl.feed()
        for _ in range(frames - 1):
            fl.feed()
            fl.take()
        fl.take()
        sync()
        slice_s = time.perf_counter() - h0
    timer.disable()
    spans = timer.drain()
    # as benchmark/trace.py counts them: every CUDA event of the trace
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernel_s = sum(e.time_range.end - e.time_range.start for e in dev) * 1e-6
    ops = timer.device_ops(prof)
    split = timer.attribute(ops, spans, STAGES)
    own = timer.self_ns(spans)
    host_s = {name: 0.0 for name in split}
    for s in spans:
        if s.name in host_s:
            host_s[s.name] += own[s.id] * 1e-9
    by_op = {}
    for _, s, e, name in ops:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    # the stages that own the five largest operations' device time
    owners = {name: {st: t for st, (_, t) in timer.attribute(
        [op for op in ops if op[3] == name], spans, STAGES).items() if t}
        for name, _ in top[:5]}
    early = [s - launch for launch, s, _, _ in ops
             if launch is not None and s < launch]
    out = {
        "step_kernels": len(dev) / frames,
        "device_kernel_ms": 1e3 * kernel_s / frames,
        "device_idle_share": (100.0 * (1.0 - kernel_s / frames
                                       * window_frames / window_s)
                              if dev else None),
        "ops_traced": len(ops) / frames,
        "slice_s": slice_s,
        "breakdown": {
            "stages": {name: {"kernels": n, "device_s": t,
                              "host_s": host_s[name]}
                       for name, (n, t) in split.items()},
            "idle_by_span": timer.idle_by_span(ops, spans),
            "device_ops": [[n, t] for n, t in top],
        },
        "top_ops_by_stage": owners,
        "ops_unlinked": sum(launch is None for launch, _, _, _ in ops),
        "ops_before_launch": len(early),
        "ops_before_launch_max_us": (-min(early) / 1e3 if early else 0.0),
    }
    for name, (n, t) in split.items():
        key = name.split(".")[-1]
        out[f"{key}_device_ms"] = 1e3 * t / frames
        out[f"{key}_device_ops"] = n / frames
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="vo_bench.fleet256")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--ab", type=int, default=0)
    ap.add_argument("--ab-seconds", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--streams", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    a = ap.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    os.environ["OMP_NUM_THREADS"] = "1"
    from benchmark import harness
    from benchmark.run import pin_cores

    cores = pin_cores()
    import torch

    from visfs_tpu_torch.utils import timer

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell.load(bench, a.workload, ROOT)
    if a.width:
        cfg = cell.config
        cfg["width"], cfg["height"] = a.width, a.width * 3 // 4
        cfg["parameters"]["Tracker/MinDistance"] = max(12,
                                                       40 * a.width // 640)
    cuda = a.device == "cuda"
    fl = harness.Fleet(cell, a.seed, a.device, streams=a.streams)

    def sync():
        if cuda:
            torch.cuda.synchronize(fl.device)

    tr = cell.traffic
    for _ in range(tr["warmup_frames"]):
        fl.feed()
        fl.take()
    sync()
    rates = ab_windows(fl, a.ab, a.ab_seconds, sync) if a.ab else None
    timer.enable()
    dispatch, taken, window_s = window(fl, a.seconds)
    timer.disable()
    spans = timer.drain()
    fl.take()
    sync()
    out = {"tool": "torch_stage_spans", "workload": a.workload,
           "seed": a.seed, "streams": fl.B, "device": a.device,
           "card": harness.power_limit() if cuda else "cpu",
           "cores": cores, "window_s": window_s, "taken": taken,
           "stream_frames_per_s": taken * fl.B / window_s}
    out.update(host_readings(spans, dispatch))
    out.update(slice_readings(fl, tr["profile_frames"], sync, cuda, taken,
                              window_s))
    if out["fleet.input_ms"]:
        out["input_over_dispatch"] = (out["fleet.input_ms"]
                                      / out["fleet_dispatch_ms"])
    stages = out["breakdown"]["stages"]
    if out["device_kernel_ms"]:
        out["device_split_over_total"] = (
            1e3 * sum(v["device_s"] for v in stages.values())
            / tr["profile_frames"] / out["device_kernel_ms"])
    if rates:
        out["ab"] = rates
        out["ab_median_on_over_off"] = (statistics.median(rates["on"])
                                        / statistics.median(rates["off"]))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
