"""Stage timers and device profiling hooks (torch port of
visfs_tpu.utils.timer; the reference's UTimer, utilite/src/Timer.cpp).

A stage's wall time includes its device work only once the device has
finished it, so the timer waits for the device (``torch.cuda.synchronize``)
before reading the clock when asked to; heavier profiling goes through a
``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


def _wait(sync) -> None:
    """Wait for the device work behind ``sync``: a tensor or nested
    tuples/lists/NamedTuples of them (the devices of its CUDA tensors; CPU
    tensors are ready already)."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)

    visit(sync)
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Stopwatch that can wait for device work; accumulates per-tag stats."""

    def __init__(self, logger=None):
        self._t0 = time.perf_counter()
        self._stats: Dict[str, List[float]] = {}
        self._logger = logger

    def restart(self):
        self._t0 = time.perf_counter()

    def elapsed(self, tag: str = "", sync: Optional[object] = None) -> float:
        """Seconds since start/restart, after waiting for the device work
        behind ``sync`` when given (UTimer::elapsed, Timer.cpp:213-218);
        restarts the watch."""
        if sync is not None:
            _wait(sync)
        dt = time.perf_counter() - self._t0
        if tag:
            self._stats.setdefault(tag, []).append(dt)
            if self._logger:
                self._logger.warning("%s: %.3f ms", tag, dt * 1e3)
        self._t0 = time.perf_counter()
        return dt

    @contextlib.contextmanager
    def stage(self, tag: str, sync_out=None):
        """Time the block under ``tag``; the block may set ``holder["sync"]``
        to the output to wait for (default sync_out)."""
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            out = holder.get("sync", sync_out)
            if out is not None:
                _wait(out)
            self._stats.setdefault(tag, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {tag: {"count": len(xs), "mean_ms": 1e3 * sum(xs) / len(xs),
                      "max_ms": 1e3 * max(xs), "total_s": sum(xs)}
                for tag, xs in self._stats.items()}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler trace of the block (CPU, and CUDA where there is a
    card), written to log_dir as a Chrome trace; yields the profiler, whose
    ``events()`` the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     log_dir)) as prof:
        yield prof


def memory_usage_mb() -> float:
    """Process RSS in MiB (UProcessInfo::getMemoryUsage,
    utilite/src/ProcessInfo.cpp:11-30); 0.0 where /proc is not there."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def device_memory_stats() -> dict:
    """torch.cuda.memory_stats() of each CUDA device, keyed "cuda:i"; empty
    without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
