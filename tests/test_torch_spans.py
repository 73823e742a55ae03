"""The span recorder of visfs_tpu_torch.utils.timer and the spans the port
records at its layer boundaries, on the CPU.

Off, ``span`` is one shared no-op and a fleet frame leaves nothing to
drain.  On, a fleet frame records ``fleet.input`` (its frame id from the
FleetSystem's counter) over the four stage spans of ``vo_step``, in order,
nested in time, with its frame id, and each take one ``fleet.output``;
``System`` records the same under ``system.input``, on its fused and its
profiled path.  The outputs are bit-equal
with the recorder on and off.  Spans of two threads keep their own parents.
A span's clock is the profiler's: an ``aten::mm`` inside a span lies inside
it on the trace's time base.  The attribution of device operations to spans
(``attribute``, ``idle_by_span``, ``self_ns``, ``latency_ns``) is checked
on synthetic spans and operations, the idle gaps also with the device's
clock offset from the host's.  The scene and parameters are
tests/test_torch_fleet_streams.py's (160x120, 2 streams).  JAX is not used
here."""

import threading

import numpy as np
import pytest
import torch

from visfs_tpu_torch.io.sim import cached_textured_sequence
from visfs_tpu_torch.slam.fleet import FleetSystem
from visfs_tpu_torch.slam.system import STAGES, System
from visfs_tpu_torch.utils import timer
from visfs_tpu_torch.utils.timer import Span

torch.set_num_threads(1)

B = 2
FRAMES = 2
PARAMS = {
    "Tracker/MaxFeatures": 40,
    "Tracker/MinDistance": 12,
    "Tracker/QualityLevel": 0.05,
    "LocalMap/MapSize": 5,
    "Optimizer/Iterations": 20,
    "Estimator/Force3DoF": True,
    "Estimator/ToleranceTranslation": 0.40,
}


@pytest.fixture(scope="module")
def seq():
    return cached_textured_sequence(n_frames=FRAMES + B - 1, width=160,
                                    height=120, motion="square", seed=0,
                                    speed=2.0, device="cpu")


@pytest.fixture(autouse=True)
def _recorder_off():
    timer.disable()
    timer.drain()
    yield
    timer.disable()
    timer.drain()


def _init(s, cam):
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)


def _run_fleet(seq):
    """FRAMES fleet frames, each taken one frame behind, as a fleet server
    publishes them; returns the outputs."""
    f = FleetSystem(PARAMS, n_streams=B, device="cpu")
    _init(f, seq.camera)
    outs = []
    for i in range(FRAMES):
        idx = [i, i + 1]
        f.input_primary_sensor_data(seq.stamps[idx], seq.left[idx],
                                    seq.right[idx])
        if i:
            outs.append(f.output_odometry_info())
    outs.append(f.output_odometry_info())
    return outs


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id),
                  key=lambda s: s.start_ns)


def _check_frame(spans, top_name, frame):
    tops = [s for s in spans if s.name == top_name and s.frame == frame]
    assert len(tops) == 1
    top = tops[0]
    assert top.parent is None
    kids = _children(spans, top)
    assert tuple(k.name for k in kids) == STAGES
    assert all(k.frame == frame for k in kids)
    bounds = [top.start_ns]
    for k in kids:
        assert k.start_ns >= bounds[-1] and k.end_ns >= k.start_ns
        bounds.append(k.end_ns)
    assert bounds[-1] <= top.end_ns
    own = timer.self_ns(spans)[top.id]
    assert own + sum(k.end_ns - k.start_ns for k in kids) == (
        top.end_ns - top.start_ns)


def test_off_is_one_shared_noop(seq):
    assert timer.span("a") is timer.span("b", 3)
    with timer.span("a") as s:
        assert s is None
    _run_fleet(seq)
    assert timer.drain() == []


def test_fleet_spans_and_outputs_unchanged(seq):
    off = _run_fleet(seq)
    timer.enable()
    on = _run_fleet(seq)
    timer.disable()
    spans = timer.drain()
    for a, b in zip(off, on):
        for name in a._fields:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)
    frames = sorted({s.frame for s in spans if s.name == "fleet.input"})
    assert len(frames) == FRAMES and frames == list(
        range(frames[0], frames[0] + FRAMES))
    for frame in frames:
        _check_frame(spans, "fleet.input", frame)
    outs = [s for s in spans if s.name == "fleet.output"]
    assert [s.frame for s in outs] == frames
    assert all(s.parent is None for s in outs)
    assert len(spans) == FRAMES * (2 + len(STAGES))
    # a fleet frame's result is taken after it was fed
    first_in = {s.frame: s for s in spans if s.name == "fleet.input"}
    assert all(o.start_ns >= first_in[o.frame].end_ns for o in outs)


def test_system_spans(seq):
    s = System(PARAMS, device="cpu")
    _init(s, seq.camera)
    timer.enable()
    for i in range(FRAMES):
        s.input_primary_sensor_data(float(seq.stamps[i]), seq.left[i],
                                    seq.right[i])
    s.output_odometry_info()
    timer.disable()
    spans = timer.drain()
    for frame in range(FRAMES):
        _check_frame(spans, "system.input", frame)
    outs = [x for x in spans if x.name == "system.output"]
    assert [x.frame for x in outs] == [0]
    assert len(s.drain_outputs()) == FRAMES - 1


def test_profiled_system_spans(seq):
    s = System(PARAMS, device="cpu", profile_stages=True)
    _init(s, seq.camera)
    timer.enable()
    for i in range(FRAMES):
        s.input_primary_sensor_data(float(seq.stamps[i]), seq.left[i],
                                    seq.right[i])
    timer.disable()
    spans = timer.drain()
    for frame in range(FRAMES):
        _check_frame(spans, "system.input", frame)
    assert all(o.time_total > 0 for o in s.drain_outputs())


def test_threads_keep_their_own_parents():
    barrier = threading.Barrier(2)

    def work(tag):
        with timer.span(f"outer.{tag}", frame=tag):
            barrier.wait(timeout=10)
            with timer.span(f"inner.{tag}"):
                barrier.wait(timeout=10)

    timer.enable()
    threads = [threading.Thread(target=work, args=(k,)) for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = {s.name: s for s in timer.drain()}
    assert len(spans) == 4
    for k in (1, 2):
        inner, outer = spans[f"inner.{k}"], spans[f"outer.{k}"]
        assert inner.parent == outer.id and outer.parent is None
        assert inner.frame == outer.frame == k


def test_ring_is_bounded():
    rec = timer.SpanRecorder(capacity=4)
    rec.enable()
    for i in range(10):
        with rec.span(f"s{i}"):
            pass
    assert [s.name for s in rec.drain()] == ["s6", "s7", "s8", "s9"]
    assert rec.drain() == []


def test_spans_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    timer.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.span("mm"):
            x @ x
    (s,) = timer.drain()
    base = prof.profiler.kineto_results.trace_start_ns()
    mms = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(mms) == 1
    start = base + mms[0].time_range.start * 1000
    end = base + mms[0].time_range.end * 1000
    slack = 50_000  # ns
    assert s.start_ns - slack <= start <= end <= s.end_ns + slack


def _span(i, name, start, end, parent=None, frame=0):
    return Span(i, name, start, end, parent, frame)


# A fleet frame on a synthetic clock (ns): fleet.input over the four stages,
# then fleet.output.
SYNTH = [
    _span(0, "fleet.input", 0, 1000),
    _span(1, "step.track", 100, 200, 0),
    _span(2, "step.prepare", 200, 500, 0),
    _span(3, "step.ba", 500, 900, 0),
    _span(4, "step.finalize", 900, 950, 0),
    _span(5, "fleet.output", 1100, 1300),
]


def test_attribution_by_launch():
    ops = [  # (launch, start, end, name)
        (50, 60, 70, "copy in"),  # in fleet.input, outside every stage
        (150, 300, 310, "lk"),  # launched in track, ran during prepare
        (250, 320, 340, "gemm"),
        (600, 640, 700, "gemm"),
        (899, 905, 915, "gemv"),  # the last instant of ba
        (900, 930, 940, "add"),  # the first instant of finalize
        (1150, 1160, 1180, "stack"),  # fleet.output
        (None, 1190, 1195, "memset"),  # no host event in the trace
        (2000, 2010, 2020, "snapshot"),  # after every span
    ]
    got = timer.attribute(ops, SYNTH, STAGES)
    assert set(got) == set(STAGES) | {"other"}
    assert got["step.track"] == [1, pytest.approx(10e-9)]
    assert got["step.prepare"] == [1, pytest.approx(20e-9)]
    assert got["step.ba"] == [2, pytest.approx(70e-9)]
    assert got["step.finalize"] == [1, pytest.approx(10e-9)]
    assert got["other"] == [4, pytest.approx(45e-9)]
    # every operation lands in one bucket: the stages and "other" sum to
    # the whole
    assert sum(n for n, _ in got.values()) == len(ops)
    assert sum(t for _, t in got.values()) == pytest.approx(
        sum(e - s for _, s, e, _ in ops) * 1e-9)


@pytest.mark.parametrize("offset", [0, -260, 6200])
def test_idle_by_span(offset):
    """Each gap goes to the span that held the launch of the operation
    closing it; a device clock offset from the host's moves nothing."""
    ops = [(50, 60, 100, "a"),  # in fleet.input
           (300, 310, 400, "b"),  # gap 100-310 closed from prepare
           (320, 330, 380, "c"),  # inside b: no gap
           (650, 700, 750, "d"),  # gap 400-700 closed from ba
           (1150, 1200, 1210, "e"),  # gap 750-1200 closed from fleet.output
           (None, 1250, 1260, "f"),  # gap 1210-1250: no host event
           (2000, 2010, 2020, "g")]  # gap 1260-2010 closed from no span
    ops = [(launch, s + offset, e + offset, name)
           for launch, s, e, name in ops]
    got = timer.idle_by_span(ops, SYNTH)
    assert got == {"step.prepare": pytest.approx(210e-9),
                   "step.ba": pytest.approx(300e-9),
                   "fleet.output": pytest.approx(450e-9),
                   "no span": pytest.approx(790e-9)}


def test_self_time_sums_to_the_parent():
    own = timer.self_ns(SYNTH)
    assert own[0] == 1000 - (100 + 300 + 400 + 50)
    assert own[0] + sum(own[i] for i in range(1, 5)) == 1000
    assert own[5] == 200


def test_latency_joins_a_frames_spans():
    later = [_span(6, "fleet.input", 2000, 2600, frame=1),
             _span(7, "fleet.output", 2700, 2750, frame=1),
             _span(8, "fleet.input", 3000, 3500, frame=2)]  # not yet taken
    got = timer.latency_ns(SYNTH + later, "fleet.input", "fleet.output")
    assert got == {0: 1300, 1: 750}
