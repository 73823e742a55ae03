"""The port's native runtime (visfs_tpu_torch.runtime, its own copy of
runtime.cc built with g++ at first use into build/visfs_tpu_torch/) against
the JAX package's library: the reference's own runtime cases run on the
port's library, and the same push sequences through both libraries give
identical synced stamps, ids, payloads and stats (latency excepted).
SystemRuntime drives the port's System on "cpu" end to end, and feeds
wheel rows while the worker steps a strategy-2 System: every row pushed
must reach the odometry buffer (a push hands its rows to the step; a push
that wrote the state itself would be overwritten by a step that was
running when it arrived), no push waits for the step in flight, and rows
pushed far ahead of their frames give the serial feed's outputs."""

import pathlib
import threading
import time

import numpy as np
import pytest
import torch

import visfs_tpu.runtime as jrt
import visfs_tpu_torch.runtime as trt
from visfs_tpu_torch.ops.kernels import _build

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def img(v, h=24, w=32):
    return np.full((h, w), float(v), np.float32)


class TestSync:
    def test_exact_stamp_match(self):
        rt = trt.PipelineRuntime(24, 32, capacity=8, slop_s=0.005)
        rt.push_left(1.0, img(1))
        assert rt.poll() is None  # right missing
        rt.push_right(1.0, img(2))
        out = rt.poll()
        assert out is not None
        stamp, fid, left, right, scan = out
        assert stamp == 1.0 and fid == 0
        np.testing.assert_array_equal(left, img(1))
        np.testing.assert_array_equal(right, img(2))
        assert scan is None
        rt.close()

    def test_slop_matching_and_unmatched_drop(self):
        rt = trt.PipelineRuntime(24, 32, capacity=8, slop_s=0.01)
        rt.push_left(1.0, img(1))
        rt.push_right(1.004, img(2))  # within slop
        out = rt.poll()
        assert out is not None and out[0] == 1.0
        rt.push_left(2.0, img(3))
        rt.push_right(2.5, img(4))
        assert rt.poll() is None
        assert rt.stats()["dropped_unmatched"] >= 1
        rt.close()

    def test_scan_stream(self):
        rt = trt.PipelineRuntime(24, 32, slop_s=0.01, with_scan=True)
        rt.push_left(1.0, img(1))
        rt.push_right(1.0, img(2))
        assert rt.poll() is None  # waiting on scan
        pts = np.arange(15, dtype=np.float32).reshape(5, 3)
        rt.push_scan(1.002, pts)
        out = rt.poll()
        assert out is not None
        np.testing.assert_array_equal(out[4], pts)
        rt.close()

    def test_overflow_drops_oldest(self):
        rt = trt.PipelineRuntime(24, 32, capacity=2, slop_s=0.001)
        for i in range(5):
            rt.push_left(float(i), img(i))
            rt.push_right(float(i), img(i))
        assert rt.queue_depth() <= 2
        assert rt.stats()["dropped_overflow"] >= 1
        rt.close()


def test_callback_drains_queue():
    rt = trt.PipelineRuntime(24, 32, capacity=16, slop_s=0.001)
    got = []
    rt.start(lambda stamp, l, r, s: got.append((stamp, l.mean())))
    for i in range(6):
        rt.push_left(float(i), img(i))
        rt.push_right(float(i), img(i + 10))
    deadline = time.time() + 5.0
    while len(got) < 6 and time.time() < deadline:
        time.sleep(0.01)
    rt.stop()
    assert len(got) == 6
    assert [g[0] for g in got] == [float(i) for i in range(6)]
    rt.close()


def _sequence(kind):
    """(capacity, slop, with_scan, pushes): pushes are (stream, stamp,
    value) in order; each kind exercises one branch of the sync policy."""
    rng = np.random.default_rng(len(kind))
    if kind == "jittered":  # right within slop, a few rights dropped
        pushes = []
        for i in range(12):
            pushes.append(("left", i * 0.1, i))
            if i % 5 != 3:
                pushes.append(("right", i * 0.1 + rng.uniform(-4e-3, 4e-3),
                               100 + i))
        return 8, 0.005, False, pushes
    if kind == "reordered":  # right first, a left late past the next frame
        pushes = []
        for i in range(10):
            pushes.append(("right", i * 0.1, 100 + i))
            if i % 3 == 1:
                continue
            pushes.append(("left", i * 0.1, i))
            if i % 3 == 2:
                pushes.append(("left", (i - 1) * 0.1, i - 1))
        return 8, 0.01, False, pushes
    if kind == "overflow":  # tiny queues
        pushes = [(s, i * 0.05, i) for i in range(9)
                  for s in ("left", "right")]
        return 3, 0.001, False, pushes
    if kind == "scan":  # three streams, one scan missing
        pushes = []
        for i in range(8):
            pushes.append(("left", i * 0.1, i))
            pushes.append(("right", i * 0.1, 100 + i))
            if i != 4:
                pushes.append(("scan", i * 0.1 + 2e-3, 200 + i))
        return 8, 0.01, True, pushes
    raise ValueError(kind)


def _drive(mod, kind):
    capacity, slop, with_scan, pushes = _sequence(kind)
    rt = mod.PipelineRuntime(6, 8, capacity=capacity, slop_s=slop,
                             with_scan=with_scan, max_scan_points=16)
    polled = []
    for stream, stamp, v in pushes:
        if stream == "scan":
            rt.push_scan(stamp, np.full((v % 7 + 1, 3), v, np.float32))
        else:
            getattr(rt, f"push_{stream}")(stamp, img(v, 6, 8))
        if v % 4 == 0:  # drain now and then, as a consumer would
            polled.append(rt.poll())
    while True:
        out = rt.poll()
        if out is None:
            break
        polled.append(out)
    stats = rt.stats()
    depth = rt.queue_depth()
    rt.close()
    del stats["last_latency_ms"]
    return [p for p in polled if p is not None], stats, depth


@pytest.mark.parametrize("kind", ["jittered", "reordered", "overflow",
                                  "scan"])
def test_same_pushes_same_frames_as_the_reference_library(kind):
    ref, ref_stats, ref_depth = _drive(jrt, kind)
    port, port_stats, port_depth = _drive(trt, kind)
    assert port_stats == ref_stats and port_depth == ref_depth
    assert len(port) == len(ref) and len(ref) > 0
    for a, b in zip(port, ref):
        assert a[0] == b[0] and a[1] == b[1]  # stamp, id
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
        if b[4] is None:
            assert a[4] is None
        else:
            np.testing.assert_array_equal(a[4], b[4])


def test_library_builds_into_the_build_dir_and_a_failed_build_raises(
        tmp_path):
    trt.load_library()
    built = list(_build.BUILD_DIR.glob(f"lib{trt.LIB_NAME}_*.so"))
    assert built, "no runtime library under build/visfs_tpu_torch/"
    pkg = REPO / "visfs_tpu_torch"
    assert not list(pkg.rglob("*.so")), "a library inside the package"
    (tmp_path / "broken.cc").write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.load_library("visfs_broken_test", ("broken.cc",),
                            src_dir=tmp_path, compiler="g++")


def _system(params, seq, **kw):
    from visfs_tpu_torch.slam.system import System

    cam = seq.camera
    s = System(params, device="cpu", **kw)
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    return s


def _collect(srt, n, deadline_s=120.0):
    outs = []
    deadline = time.time() + deadline_s
    while len(outs) < n and time.time() < deadline:
        o = srt.output()
        if o is not None:
            outs.append(o)
        else:
            time.sleep(0.02)
    return outs


def test_system_runtime_end_to_end_on_cpu():
    from visfs_tpu_torch.io.sim import generate_sequence

    seq = generate_sequence(n_frames=5, width=160, height=120, n_points=300,
                            seed=41, device="cpu")
    sys_ = _system({"Tracker/MaxFeatures": 60, "Tracker/MinDistance": 10},
                   seq)
    srt = trt.SystemRuntime(sys_, capacity=8, slop_s=0.02)
    srt.start()
    try:
        for i in range(len(seq.stamps)):
            srt.push_left(float(seq.stamps[i]), seq.left[i])
            srt.push_right(float(seq.stamps[i]), seq.right[i])
        outs = _collect(srt, len(seq.stamps))
    finally:
        srt.stop()
    assert len(outs) == len(seq.stamps)
    assert srt.stats()["processed"] == len(seq.stamps)
    assert [float(o.stamp) for o in outs] == pytest.approx(
        [float(t) for t in seq.stamps])
    assert not bool(outs[-1].lost)


S2_PARAMS = {"Tracker/MaxFeatures": 60, "Tracker/MinDistance": 10,
             "System/SensorStrategy": 2}


def _s2_sequence(n_frames):
    from visfs_tpu_torch.io.sim import generate_sequence

    return generate_sequence(n_frames=n_frames, width=160, height=120,
                             n_points=300, seed=41, device="cpu")


def test_wheel_rows_pushed_during_steps_all_reach_the_buffer():
    """Strategy 2: the transport's thread (here the main thread) pushes a
    wheel row every few milliseconds while the runtime's worker steps; the
    odometry buffer's head must count every row."""
    n_frames = 6
    seq = _s2_sequence(n_frames)
    sys_ = _system(S2_PARAMS, seq)
    srt = trt.SystemRuntime(sys_, capacity=8, slop_s=0.02)
    srt.start()
    odom = seq.wheel_odom
    pushed = 0
    try:
        for i in range(n_frames):
            srt.push_left(float(seq.stamps[i]), seq.left[i])
            srt.push_right(float(seq.stamps[i]), seq.right[i])
        # rows keep arriving while the frames above are stepped
        t_end = time.time() + 60.0
        while srt.stats()["processed"] < n_frames and time.time() < t_end:
            row = odom[pushed % len(odom)]
            srt.push_odometry(float(row[0]), row[1:7])
            pushed += 1
            time.sleep(0.002)
        outs = _collect(srt, n_frames)
    finally:
        srt.stop()
    assert len(outs) == n_frames
    assert pushed >= 2  # rows really arrived during steps
    assert int(sys_.state.odom.head) == pushed


def test_paced_wheel_pushes_from_another_thread_never_wait_for_a_step():
    """A transport's thread pushes a wheel row every 10 ms (100 Hz) while
    the main thread feeds frames and the runtime's worker steps them: every
    row reaches the buffer, and no push waits for the step in flight (the
    longest push takes under half the median step)."""
    n_frames = 6
    seq = _s2_sequence(n_frames)
    sys_ = _system(S2_PARAMS, seq)
    steps, pushes = [], []
    step = sys_.input_primary_sensor_data

    def timed_step(*args, **kwargs):
        t0 = time.perf_counter()
        step(*args, **kwargs)
        steps.append(time.perf_counter() - t0)

    sys_.input_primary_sensor_data = timed_step
    srt = trt.SystemRuntime(sys_, capacity=8, slop_s=0.02)
    odom = seq.wheel_odom
    stop = threading.Event()

    def pusher():
        t_next = time.perf_counter()
        while not stop.is_set():
            row = odom[len(pushes) % len(odom)]
            t0 = time.perf_counter()
            srt.push_odometry(float(row[0]), row[1:7])
            pushes.append(time.perf_counter() - t0)
            t_next += 0.01
            time.sleep(max(0.0, t_next - time.perf_counter()))

    thread = threading.Thread(target=pusher)
    srt.start()
    thread.start()
    try:
        for i in range(n_frames):
            srt.push_left(float(seq.stamps[i]), seq.left[i])
            srt.push_right(float(seq.stamps[i]), seq.right[i])
        outs = _collect(srt, n_frames)
    finally:
        stop.set()
        thread.join()
        srt.stop()
    assert len(outs) == n_frames and len(steps) == n_frames
    assert len(pushes) >= n_frames
    assert int(sys_.state.odom.head) == len(pushes)
    assert max(pushes) < 0.5 * float(np.median(steps)), (
        max(pushes), np.median(steps))


def test_rows_pushed_ahead_of_their_frames_give_the_serial_feed():
    """Every wheel row of an 8-frame sequence (71, more than the 64-row
    ring holds) is pushed before the frames reach the runtime: each step
    applies the rows stamped up to its frame and keeps the later ones
    back, so the outputs are bit-equal to run_sequence's serial feed (rows
    up to a frame, then the frame)."""
    n_frames = 8
    seq = _s2_sequence(n_frames)
    odom = np.asarray(seq.wheel_odom)
    assert len(odom) > 64
    serial = _system(S2_PARAMS, seq).run_sequence(
        seq.stamps, seq.left, seq.right, wheel_odom=odom)
    sys_ = _system(S2_PARAMS, seq)
    srt = trt.SystemRuntime(sys_, capacity=n_frames + 2, slop_s=0.02)
    for row in odom:
        srt.push_odometry(float(row[0]), row[1:7])
    srt.start()
    try:
        for i in range(n_frames):
            srt.push_left(float(seq.stamps[i]), seq.left[i])
            srt.push_right(float(seq.stamps[i]), seq.right[i])
        outs = _collect(srt, n_frames)
    finally:
        srt.stop()
    assert not srt.errors and len(outs) == n_frames
    for a, b in zip(outs, serial):
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
    assert int(sys_.state.odom.head) == len(odom)
