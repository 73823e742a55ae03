"""The traced slice: a few fleet frames under ``torch.profiler`` after the
window has closed, reduced to what the per-layer readers need.

The profiler multiplies the host's time per operation, so no host-clock
figure comes from the slice: the readers take those from the unprofiled
window and only device times and counts from the slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

# The name of K1's pyramid kernel in csrc/lk_level.cu.
K1_KERNEL = "lk_pyr_kernel"


@dataclasses.dataclass
class Slice:
    frames: int
    kernels: int  # device operations in the slice
    kernel_s: float  # their summed device time
    k1_s: float  # K1's device time
    k1_launches: int
    busy_s: float  # union of the device operations' intervals
    window_s: float  # the slice's length on the host clock
    breakdown: dict


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read."""

    dispatch_s: list  # host seconds in input_primary_sensor_data, a frame
    window_s: float  # the unprofiled window's length
    frames: int  # fleet frames taken in it
    prof: Optional[Slice]
    counts: list  # per fed frame: (n_features [B], n_new [B])
    config: dict
    levels: int
    win: int


def _union_s(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _host_op_at(cpu_ops, t):
    """The innermost host operation running at time t (µs): its name."""
    best = None
    for s, e, name in cpu_ops:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "host idle"


def profile_slice(fl, frames: int, sync) -> Slice:
    """Run ``frames`` fleet frames of ``fl`` (a harness.Fleet) under the
    profiler, the pipeline as in the window, and reduce the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        fl.feed()
        for _ in range(frames - 1):
            fl.feed()
            fl.take()
        fl.take()
        sync()
        window_s = time.perf_counter() - h0
    dev, cpu = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        else:
            cpu.append((tr.start, tr.end, e.name))
    dev.sort()
    cpu.sort()
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    k1 = [(s, e) for s, e, name in dev if K1_KERNEL in name]
    gaps = []
    end = None
    for s, e, _ in dev:
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = [[_host_op_at(cpu, at), gap * 1e-6] for gap, at in gaps[:10]]
    return Slice(
        frames=frames, kernels=len(dev),
        kernel_s=sum(e - s for s, e, _ in dev) * 1e-6,
        k1_s=sum(e - s for s, e in k1) * 1e-6, k1_launches=len(k1),
        busy_s=_union_s([(s, e) for s, e, _ in dev]) * 1e-6,
        window_s=window_s,
        breakdown={"device_ops": [[n, t] for n, t in top_ops],
                   "idle_gaps": idle})
