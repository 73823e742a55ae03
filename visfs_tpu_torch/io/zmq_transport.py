"""Live ZeroMQ transport for VISFSAdapter: a real two-process topic stream
(torch port of visfs_tpu.io.zmq_transport; the same wire format).

The reference node consumes live ROS topics (image_transport subscribers +
message_filters sync, Interface/ROS/src/InterfaceROS.cpp:92-120) fed by
rosbag replay (README.md:44-56).  This module is the equivalent live
middleware for environments without a ROS daemon: a PUB/SUB pair over TCP
(or IPC) carrying camera infos, a static frame tree, stereo frames, wheel
odometry and laser scans — asynchronous, lossy, and out-of-order by
construction — plus a replay publisher (``zmq_replay.py``, run as a separate
process) that paces a recorded sequence in real time with configurable
drops and reordering.

``ZmqTransport`` implements the four-method duck-typed Transport contract
of ``io.adapter`` (wait_for_camera_info / lookup_transform / subscribe /
publish), so ``VISFSAdapter`` runs unmodified against it — the bring-up
recipe (CameraInfo wait loop, tf lookup, param overrides, native
approx-sync runtime) is exercised against a genuinely live stream instead
of the in-repo StaticTransport.

Wire format (multipart): ``[topic, json header, raw payload?]``.
  camera_info/left|right : header {width,height,fx,fy,cx,cy,tx}
  tf                     : header {frames: {child: {xyz, rpy}}}
  left/image, right/image: header {stamp, shape, dtype}; payload = pixels
  wheel_odom             : header {stamp, pose6, velocity6}
  laser_scan             : header {stamp, shape, dtype}; payload = [K,3] f32
  odom, odom_info        : engine -> world (header = message dict)
  eos                    : end of stream marker

``published`` keeps the last ``adapter.PUBLISHED_MAXLEN`` messages a topic
(the reference keeps every one, which a live run of hours never drains).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import numpy as np


def _encode(topic: str, header: Dict[str, Any], payload=None):
    parts = [topic.encode(), json.dumps(header).encode()]
    if payload is not None:
        parts.append(np.ascontiguousarray(payload).tobytes())
    return parts


def _decode_array(header: Dict[str, Any], raw: bytes) -> np.ndarray:
    return np.frombuffer(raw, dtype=np.dtype(header["dtype"])).reshape(
        header["shape"])


class ZmqTransport:
    """SUB-in / PUB-out transport speaking the wire format above.

    sub_endpoint: where sensor topics arrive (connect; replay pub binds).
    pub_endpoint: where odom/odom_info go out (bind; world connects).

    Single-threaded: messages are pumped by ``spin(timeout_ms)`` (and by
    ``wait_for_camera_info`` during bring-up).  Callbacks registered via
    ``subscribe`` run on the pumping thread, exactly like rospy's
    single-threaded spinner.
    """

    static = False

    def __init__(self, sub_endpoint: str, pub_endpoint: Optional[str] = None):
        import zmq

        self._ctx = zmq.Context.instance()
        self._sub = self._ctx.socket(zmq.SUB)
        self._sub.connect(sub_endpoint)
        self._sub.setsockopt(zmq.SUBSCRIBE, b"")
        self._pub = None
        if pub_endpoint:
            self._pub = self._ctx.socket(zmq.PUB)
            self._pub.bind(pub_endpoint)
        self._infos: Dict[str, Any] = {}
        self._frames_table: Dict[str, Any] = {}
        self._subs: Dict[str, Any] = {}
        self.published: Dict[str, collections.deque] = {}
        self.eos = False

    # -- Transport contract ----------------------------------------------
    def wait_for_camera_info(self, side: str, timeout_s: float = 3.0):
        deadline = time.monotonic() + timeout_s
        while side not in self._infos and time.monotonic() < deadline:
            self._pump(50)
        return self._infos.get(side)

    def lookup_transform(self, parent: str, child: str):
        del parent
        from .adapter import static_frame_transform

        return static_frame_transform(self._frames_table, child)

    def subscribe(self, topic: str, callback) -> None:
        self._subs[topic] = callback

    def publish(self, topic: str, message) -> None:
        from .adapter import keep_published

        keep_published(self.published, topic, message)
        if self._pub is not None:
            try:
                # Odometry and OdomInfo are dataclasses: the reference's
                # dict() of them fails, so its wire body is their repr
                body = (dataclasses.asdict(message)
                        if dataclasses.is_dataclass(message)
                        else message._asdict() if hasattr(message, "_asdict")
                        else dict(message))
                body = {k: (v.tolist() if isinstance(v, np.ndarray) else
                            float(v) if isinstance(v, (np.floating,)) else
                            int(v) if isinstance(v, (np.integer,)) else v)
                        for k, v in body.items()}
            except Exception:
                body = {"repr": repr(message)}
            try:
                parts = _encode(topic, body)
            except TypeError:
                # A field survived the ndarray/scalar conversion but is not
                # JSON-serializable (e.g. a tensor or a list of numpy
                # scalars) — wire publishing is best-effort like the body
                # conversion; never crash the adapter's spin loop.
                parts = _encode(topic, {"repr": repr(body)})
            self._pub.send_multipart(parts)

    # -- pumping -----------------------------------------------------------
    def spin(self, timeout_ms: int = 10) -> int:
        """Receive and dispatch pending messages; returns count handled."""
        return self._pump(timeout_ms)

    def _pump(self, timeout_ms: int) -> int:
        import zmq

        n = 0
        deadline = time.monotonic() + timeout_ms / 1e3
        while True:
            budget = max(0, int((deadline - time.monotonic()) * 1e3))
            if not self._sub.poll(budget):
                return n
            parts = self._sub.recv_multipart()
            self._dispatch(parts)
            n += 1

    def _dispatch(self, parts) -> None:
        from .adapter import CameraInfo

        topic = parts[0].decode()
        header = json.loads(parts[1].decode()) if len(parts) > 1 else {}
        if topic.startswith("camera_info/"):
            side = topic.split("/", 1)[1]
            self._infos[side] = CameraInfo(
                width=int(header["width"]), height=int(header["height"]),
                fx=float(header["fx"]), fy=float(header["fy"]),
                cx=float(header["cx"]), cy=float(header["cy"]),
                tx=float(header.get("tx", 0.0)),
            )
        elif topic == "tf":
            self._frames_table.update(header.get("frames", {}))
        elif topic == "eos":
            self.eos = True
        elif topic in ("left/image", "right/image"):
            cb = self._subs.get(topic)
            if cb is not None:
                img = _decode_array(header, parts[2]).astype(np.float32)
                cb(float(header["stamp"]), img)
        elif topic == "wheel_odom":
            cb = self._subs.get(topic)
            if cb is not None:
                cb(float(header["stamp"]),
                   np.asarray(header["pose6"], np.float32),
                   np.asarray(header["velocity6"], np.float32)
                   if header.get("velocity6") is not None else None)
        elif topic == "laser_scan":
            cb = self._subs.get(topic)
            if cb is not None:
                cb(float(header["stamp"]), _decode_array(header, parts[2]))

    def close(self) -> None:
        self._sub.close(0)
        if self._pub is not None:
            self._pub.close(0)
