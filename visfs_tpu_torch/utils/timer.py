"""Stage timers, the program's span recorder and device profiling hooks
(torch port of visfs_tpu.utils.timer; the reference's UTimer,
utilite/src/Timer.cpp).

A stage's wall time includes its device work only once the device has
finished it, so the timer waits for the device (``torch.cuda.synchronize``)
before reading the clock when asked to; heavier profiling goes through a
``torch.profiler`` trace.

The span recorder (``span``, ``enable``, ``disable``, ``drain``) keeps host
spans at the layer boundaries of the step, off by default.  A span's times
come from ``time.time_ns()``, the clock of a ``torch.profiler`` trace's
events (``kineto_results.trace_start_ns()`` plus an event's offset), so a
trace's device operations can be put under the span that launched them
(``device_ops``, ``span_lookup``, ``attribute``, ``idle_by_span``), and a
frame's spans joined by its id (``latency_ns``).  The
spans live on the host only: they add no event to the device's timeline.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from bisect import bisect_right
from typing import NamedTuple, Optional

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
    """Stopwatch that can wait for device work."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def elapsed(self, sync: Optional[object] = None) -> float:
        """Seconds since start or the last call, after waiting for the
        device work behind ``sync`` when given (UTimer::elapsed,
        Timer.cpp:213-218); restarts the watch."""
        if sync is not None:
            _wait(sync)
        dt = time.perf_counter() - self._t0
        self._t0 = time.perf_counter()
        return dt


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


# --- host spans --------------------------------------------------------------

# Spans the ring holds; the oldest go first when it is full.
CAPACITY = 1 << 16


class Span(NamedTuple):
    """A closed span: ``parent`` is the id of the innermost span open on the
    same thread when it opened (None at the top), ``frame`` the frame id
    given to it or to its nearest ancestor that was given one."""

    id: int
    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    parent: Optional[int]
    frame: Optional[int]


class _OpenSpan:
    __slots__ = ("_rec", "_name", "_frame", "_id", "_parent", "_start")

    def __init__(self, rec: "SpanRecorder", name: str, frame):
        self._rec, self._name, self._frame = rec, name, frame

    def __enter__(self):
        stack = self._rec._stack()
        parent = stack[-1] if stack else None
        self._parent = None if parent is None else parent._id
        if self._frame is None and parent is not None:
            self._frame = parent._frame
        self._id = next(self._rec._ids)
        stack.append(self)
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._rec._stack().pop()
        self._rec._keep(Span(self._id, self._name, self._start, end,
                             self._parent, self._frame))
        return False


class SpanRecorder:
    """Host spans in a bounded ring, off until ``enable()``.  Each thread
    keeps its own stack of open spans, so a span's parent is the innermost
    span open on its own thread."""

    def __init__(self, capacity: int = CAPACITY):
        self.enabled = False
        self._ring = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()

    def span(self, name: str, frame: Optional[int] = None):
        """A context manager that records ``name`` around its block; while
        the recorder is off, one shared no-op."""
        if not self.enabled:
            return _NOOP
        return _OpenSpan(self, name, frame)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def drain(self) -> list:
        """The closed spans in the order they closed; empties the ring."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, s: Span) -> None:
        with self._lock:
            self._ring.append(s)


_NOOP = contextlib.nullcontext()
RECORDER = SpanRecorder()
span = RECORDER.span
enable = RECORDER.enable
disable = RECORDER.disable
drain = RECORDER.drain


# --- device operations under spans ---------------------------------------------

def device_ops(prof) -> list:
    """The device operations of a finished ``torch.profiler`` trace, in
    start order: (launch_ns, start_ns, end_ns, name), each time on the
    spans' clock.  ``launch_ns`` is the start of the host operation that
    launched it (the profiler links the two by a correlation id), None where
    the trace holds no such operation.  An operation linked to no host
    operation takes the start of the runtime call that shares its own
    correlation id (``cudaLaunchKernel``, ``cudaMemcpyAsync``)."""
    from torch.autograd import DeviceType

    op_start, call_start = {}, {}
    dev = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU:
            starts = (op_start if ev.linked_correlation_id() == 0
                      else call_start)
            starts.setdefault(ev.correlation_id(), ev.start_ns())
        elif ev.device_type() == DeviceType.CUDA:
            dev.append((ev.linked_correlation_id(), ev.correlation_id(),
                        ev.start_ns(), ev.end_ns(), ev.name()))
    return sorted(((op_start.get(linked) if linked else call_start.get(corr),
                    s, e, name) for linked, corr, s, e, name in dev),
                  key=lambda op: op[1])


def span_lookup(spans):
    """A function of a time (ns) giving the innermost of ``spans`` that
    holds it, or None: of the spans open at that instant, the one opened
    last (spans on one thread nest)."""
    points = sorted({s.start_ns for s in spans} | {s.end_ns for s in spans})
    owners = []
    for t in points:  # the segment [t, next point)
        holding = [s for s in spans if s.start_ns <= t < s.end_ns]
        owners.append(max(holding, key=lambda s: s.id) if holding else None)

    def at(t_ns):
        i = bisect_right(points, t_ns) - 1
        return owners[i] if i >= 0 else None

    return at


def attribute(ops, spans, names) -> dict:
    """Device operations (``device_ops``' tuples) by the span named in
    ``names`` that holds the start of the host operation that launched
    each: {name: [operations, device seconds]}, and "other" for those that
    fall in no such span."""
    at = span_lookup([s for s in spans if s.name in names])
    out = {name: [0, 0.0] for name in (*names, "other")}
    for launch, start, end, _ in ops:
        owner = None if launch is None else at(launch)
        slot = out["other" if owner is None else owner.name]
        slot[0] += 1
        slot[1] += (end - start) * 1e-9
    return out


def idle_by_span(ops, spans) -> dict:
    """The device's idle gaps between ``ops`` (``device_ops``' tuples, in
    start order), in seconds, summed by the innermost span that held the
    launch of the operation that closes each gap: what the host was doing
    when it issued the work the device waited for.  Both sides of that
    lookup are on the host's clock, so a device clock offset from it moves
    no gap.  "no span" for gaps closed by an operation launched outside
    every span or linked to no host operation."""
    at = span_lookup(spans)
    out = {}
    end = None
    for launch, start, stop, _ in ops:
        if end is not None and start > end:
            owner = None if launch is None else at(launch)
            key = "no span" if owner is None else owner.name
            out[key] = out.get(key, 0.0) + (start - end) * 1e-9
        end = stop if end is None else max(end, stop)
    return out


def latency_ns(spans, first: str, last: str) -> dict:
    """Per frame id, the time from the start of its ``first`` span to the
    end of its ``last`` span (say, a frame's feed to its result on the
    host), for the frames that have both."""
    starts = {s.frame: s.start_ns for s in spans if s.name == first}
    return {s.frame: s.end_ns - starts[s.frame] for s in spans
            if s.name == last and s.frame in starts}


def self_ns(spans) -> dict:
    """Each span's own time: its duration less its children's, by id."""
    own = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return own
