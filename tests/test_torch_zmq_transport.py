"""The port's ZeroMQ transport and replay process
(visfs_tpu_torch.io.zmq_transport, python -m visfs_tpu_torch.io.zmq_replay)
against the JAX package's: the wire format's bytes equal, the live
two-process run of the port's adapter (native runtime, System on "cpu")
against the port's replay with drops and reordering, two of the reference's
hostile streams (heavy drop, late camera info), the published bodies plain
JSON (numpy and Python scalars, no tensor), and ADVICE.md:3: the
reference's ``published`` grows with every message, the port's keeps the
newest PUBLISHED_MAXLEN a topic."""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from visfs_tpu.io import zmq_transport as jzt
from visfs_tpu_torch.io import zmq_transport as tzt
from visfs_tpu_torch.io.adapter import (PUBLISHED_MAXLEN, VISFSAdapter,
                                        load_operating_point)
from visfs_tpu_torch.io.sim import generate_sequence

zmq = pytest.importorskip("zmq")

torch.set_num_threads(1)

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
REPO = str(pathlib.Path(__file__).resolve().parent.parent)


@pytest.mark.parametrize("topic,header,payload", [
    ("camera_info/left", {"width": 160, "height": 120, "fx": 128.0,
                          "fy": 128.0, "cx": 80.0, "cy": 60.0}, None),
    ("tf", {"frames": {"camera_link": {"parent": "base_link",
                                       "xyz": [0, 0, 0.3],
                                       "rpy": [0, 0, 0]}}}, None),
    ("left/image", {"stamp": 0.1, "shape": [3, 4], "dtype": "|u1"},
     np.arange(12, dtype=np.uint8).reshape(3, 4)),
    ("laser_scan", {"stamp": 0.2, "shape": [5, 3], "dtype": "<f4"},
     np.linspace(-1, 1, 15, dtype=np.float32).reshape(5, 3)[:, ::-1]),
    ("eos", {}, None),
])
def test_encode_bytes_equal_the_reference(topic, header, payload):
    ref = jzt._encode(topic, header, payload)
    port = tzt._encode(topic, header, payload)
    assert port == ref
    if payload is not None:
        np.testing.assert_array_equal(
            tzt._decode_array(header, port[2]), payload)


def _sequence(n_frames, seed):
    seq = generate_sequence(n_frames=n_frames, width=160, height=120,
                            n_points=150, seed=seed, device="cpu")
    return (np.clip(np.asarray(seq.left), 0, 255).astype(np.uint8),
            np.clip(np.asarray(seq.right), 0, 255).astype(np.uint8),
            np.asarray(seq.stamps), seq.camera)


def _run_live(tmp_path, seq_arrays, replay_args, deadline_s=120.0):
    """The port's adapter stack against a live replay subprocess of the
    port; also a SUB socket on the adapter's PUB endpoint, so the wire
    bodies of what it publishes are read back.  Returns (published,
    replay stats, adapter, transport, wire bodies by topic)."""
    left, right, stamps, camera = seq_arrays
    data = tmp_path / "seq.npz"
    frames = {"camera_link": {"parent": "base_link", "xyz": [0, 0, 0.3],
                              "rpy": [0, 0, 0]}}
    np.savez(data, left=left, right=right,
             stamps=np.asarray(stamps, np.float64),
             fx=float(camera.fx), fy=float(camera.fy),
             cx=float(camera.cx), cy=float(camera.cy),
             baseline=float(camera.baseline), frames=json.dumps(frames))
    endpoint = f"ipc://{tmp_path}/visfs_stream"
    out_endpoint = f"ipc://{tmp_path}/visfs_odom"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "visfs_tpu_torch.io.zmq_replay",
         "--data", str(data), "--endpoint", endpoint] + replay_args,
        stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
    tr = sub = None
    try:
        tr = tzt.ZmqTransport(endpoint, out_endpoint)
        sub = zmq.Context.instance().socket(zmq.SUB)
        sub.connect(out_endpoint)
        sub.setsockopt(zmq.SUBSCRIBE, b"")
        op = load_operating_point(CONFIGS / "sim_localization.yaml")
        op.visfs["Tracker/MaxFeatures"] = 60
        op.visfs["Optimizer/Iterations"] = 4
        op.node["base_line"] = 0.0  # force fallback to CameraInfo tx
        op.node["queue_size"] = 64  # deep enough to absorb the replay
        ad = VISFSAdapter(op, tr, use_native_runtime=True, device="cpu")
        ad.start()
        published = 0
        deadline = time.monotonic() + deadline_s
        while not tr.eos and time.monotonic() < deadline:
            tr.spin(20)
            published += ad.spin_once()
        t_end = time.monotonic() + 60.0
        while time.monotonic() < t_end:
            tr.spin(5)
            n = ad.spin_once()
            published += n
            if n == 0 and ad._rt.rt.queue_depth() == 0 \
                    and ad._rt.stats()["processed"] \
                    == ad._rt.stats()["synced"]:
                break
        ad.stop()
        published += ad.spin_once()
        assert tr.eos, "never saw end-of-stream marker"
        wire = {}
        while sub.poll(200):
            topic, body = sub.recv_multipart()[:2]
            wire.setdefault(topic.decode(), []).append(json.loads(body))
        stats = json.loads(proc.stdout.readline())
        assert proc.wait(timeout=30) == 0
        return published, stats, ad, tr, wire
    finally:
        if sub is not None:
            sub.close(0)
        if proc.poll() is None:
            proc.kill()


# frames a live run streams (the reference's tests stream 40; the port's
# eager step on the CPU makes each frame cost ~0.3 s here)
LIVE_FRAMES = 24


def test_live_stream_bring_up_to_publish(tmp_path):
    """Baseline hostile stream: 5% drops + 15% L/R reordering."""
    n_frames = LIVE_FRAMES
    arrays = _sequence(n_frames, seed=5)
    published, stats, ad, tr, wire = _run_live(
        tmp_path, arrays,
        ["--hz", "40", "--drop", "0.05", "--swap", "0.15",
         "--preroll-s", "1.0", "--seed", "7"])
    try:
        cam = arrays[3]
        info_l, info_r = ad.camera_info
        assert info_l.fx == pytest.approx(float(cam.fx))
        assert info_r.baseline == pytest.approx(float(cam.baseline),
                                                rel=1e-5)
        T = tr.lookup_transform("base_link", "camera_link")
        assert T is not None and T[2, 3] == pytest.approx(0.3)
        assert stats["dropped"]["left"] + stats["dropped"]["right"] > 0
        assert stats["swapped"] > 0
        assert n_frames // 2 <= published <= n_frames
        odoms = tr.published["odom"]
        assert len(odoms) == published
        assert np.isfinite(np.asarray(odoms[-1].position)).all()
        # the wire bodies are plain JSON of the messages, never a repr
        assert len(wire.get("odom", [])) > 0
        for topic in ("odom", "odom_info"):
            for body in wire[topic]:
                assert "repr" not in body, body
        assert set(wire["odom"][-1]) >= {"stamp", "position",
                                         "orientation_wxyz", "valid"}
        assert wire["odom"][-1]["position"] == pytest.approx(
            np.asarray(odoms[-1].position).tolist())
        assert "inliers" in wire["odom_info"][-1]
    finally:
        tr.close()


@pytest.mark.parametrize("case", ["heavy_drop", "late_camera_info"])
def test_hostile_stream(tmp_path, case):
    """Two of the reference's hostile streams (tests/test_zmq_transport.py
    TestHostileStream): >= 30 % per-side loss, where the sync must pair
    what survives and publish no junk; and camera info appearing seconds
    after the subscriber connects, where bring-up keeps waiting."""
    arrays = _sequence(LIVE_FRAMES, seed=5)
    if case == "heavy_drop":
        args = ["--hz", "40", "--drop", "0.35", "--swap", "0.1",
                "--preroll-s", "1.0", "--seed", "11"]
    else:
        args = ["--hz", "40", "--drop", "0.0", "--swap", "0.0",
                "--preroll-s", "1.0", "--info-delay-s", "4.0", "--seed", "3"]
    published, stats, ad, tr, _ = _run_live(tmp_path, arrays, args)
    try:
        n = len(arrays[2])
        if case == "heavy_drop":
            dropped = stats["dropped"]["left"] + stats["dropped"]["right"]
            assert dropped >= 0.2 * 2 * n, stats
            assert published >= n // 5, (published, stats)
            for o in tr.published["odom"]:
                if o.valid:
                    assert np.isfinite(np.asarray(o.position)).all()
        else:
            info_l, _ = ad.camera_info
            assert info_l.fx == pytest.approx(float(arrays[3].fx))
            assert published >= n // 2, (published, stats)
    finally:
        tr.close()


def test_published_is_bounded(tmp_path):
    """ADVICE.md:3 (the ZeroMQ half): the reference keeps every message a
    topic, the port the newest PUBLISHED_MAXLEN."""
    n = PUBLISHED_MAXLEN + 25
    ref = jzt.ZmqTransport(f"ipc://{tmp_path}/none_a")
    port = tzt.ZmqTransport(f"ipc://{tmp_path}/none_b")
    try:
        for i in range(n):
            ref.publish("odom", {"i": i})
            port.publish("odom", {"i": i})
        assert len(ref.published["odom"]) == n
        assert len(port.published["odom"]) == PUBLISHED_MAXLEN
        assert port.published["odom"][-1] == {"i": n - 1}
        assert port.published["odom"][0] == {"i": n - PUBLISHED_MAXLEN}
    finally:
        ref.close()
        port.close()


def _wire_body(mod, tmp_path, tag, message):
    """The body ``mod.ZmqTransport.publish`` puts on the wire for
    ``message`` (published until a SUB socket has joined)."""
    out = f"ipc://{tmp_path}/{tag}_out"
    tr = mod.ZmqTransport(f"ipc://{tmp_path}/{tag}_in", out)
    sub = zmq.Context.instance().socket(zmq.SUB)
    try:
        sub.connect(out)
        sub.setsockopt(zmq.SUBSCRIBE, b"")
        for _ in range(100):
            tr.publish("odom", message)
            if sub.poll(50):
                return json.loads(sub.recv_multipart()[1])
        raise AssertionError("nothing arrived on the wire")
    finally:
        sub.close(0)
        tr.close()


def test_wire_body_of_a_published_odometry(tmp_path):
    """The reference's dict() of the Odometry dataclass raises, so it puts
    the message's repr on the wire; the port its fields as JSON (numpy
    arrays as lists, no tensor)."""
    from visfs_tpu.io import interface as jif
    from visfs_tpu_torch.io import interface as tif

    kw = dict(stamp=0.5, position=np.array([1.0, 2.0, 0.0]),
              orientation_wxyz=np.array([1.0, 0.0, 0.0, 0.0]),
              pose_covariance=np.eye(6) * 1e-3,
              linear_velocity=np.zeros(3), angular_velocity=np.zeros(3),
              valid=True)
    ref = _wire_body(jzt, tmp_path, "ref", jif.Odometry(**kw))
    port = _wire_body(tzt, tmp_path, "port", tif.Odometry(**kw))
    assert list(ref) == ["repr"]
    assert port["position"] == [1.0, 2.0, 0.0] and port["valid"] is True
    assert np.asarray(port["pose_covariance"]).shape == (6, 6)
