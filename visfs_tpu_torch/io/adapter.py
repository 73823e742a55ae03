"""Middleware bring-up adapter: transport-agnostic VISFSInterfaceROS (torch
port of visfs_tpu.io.adapter, over the port's System and runtime).

Re-design of the reference ROS node's construction sequence
(Interface/ROS/src/InterfaceROS.cpp:18-155) against a duck-typed
``Transport`` instead of roslaunch/ros::NodeHandle, so the same bring-up
recipe runs under ROS1/ROS2 shims, a replay harness, or the in-repo fake
transport used by the tests:

  1. load the operating point (node options + VISFS parameter overrides —
     the launch-file equivalent, ``configs/*.yaml``);
  2. block until a left/right CameraInfo pair is available
     (InterfaceROS.cpp:52-58 waitForMessage loop, 3 s retry);
  3. look up static robot<-camera / robot<-laser extrinsics from the
     transform tree (InterfaceROS.cpp:67-83 tf lookups);
  4. apply parameter overrides with typed parse + MinInliers>=8 floor
     (InterfaceROS.cpp:125-155 parametersInit);
  5. construct + init the System with intrinsics/baseline/extrinsics
     (InterfaceROS.cpp:87-89) and hand sensor streams to the native
     approx/exact-sync runtime (the message_filters Synchronizer
     equivalent, InterfaceROS.cpp:96-120 —
     visfs_tpu_torch/runtime/runtime.cc);
  6. publish Odometry + OdomInfo per frame (InterfaceROS.cpp:122-123
     advertise, publishMessage).

The transport must provide:
  wait_for_camera_info(side: str, timeout_s: float) -> CameraInfo | None
  lookup_transform(parent: str, child: str) -> [4,4] array | None
  subscribe(topic: str, callback) -> None
  publish(topic: str, message) -> None
No ROS types leak into the engine; CameraInfo is the small dataclass below.

The System runs on ``device`` ("cuda" unless the caller asks for "cpu").
With the native runtime its worker thread steps the System on host numpy
frames while the transport's thread pushes wheel rows; a push never
waits for the step, which applies the rows pushed before it
(``slam/system.py``).  ``use_native_runtime=False`` is
the exact-stamp gather path, the caller's explicit choice as in the
reference: the native path never falls back to it, and a runtime library
that does not build raises.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

import logging

from ..config import config_from_parameters
from ..core import lie

log = logging.getLogger("visfs.adapter")


@dataclasses.dataclass
class CameraInfo:
    """sensor_msgs/CameraInfo essentials (image_geometry PinholeCameraModel
    reads fx/fy/cx/cy from the projection matrix P — fromCameraInfo at
    InterfaceROS.cpp:59-61)."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    # P[0,3] = -fx * baseline on the right camera of a calibrated pair.
    tx: float = 0.0

    @property
    def baseline(self) -> float:
        return -self.tx / self.fx if self.fx else 0.0


@dataclasses.dataclass
class OperatingPoint:
    """Parsed launch-file equivalent (configs/*.yaml)."""

    node: Dict[str, Any]
    visfs: Dict[str, Any]
    frames: Dict[str, Any]

    @property
    def subscribe_wheel_odom(self) -> bool:
        return bool(self.node.get("subscribe_wheel_odom", False))

    @property
    def subscribe_laser_scan(self) -> bool:
        return bool(self.node.get("subscribe_laser_scan", False))


def load_operating_point(path: str | os.PathLike) -> OperatingPoint:
    """Load a configs/*.yaml operating point; VISFS keys are validated
    against the parameter registry (unknown keys raise, like the rosparam
    scan in InterfaceROS.cpp:125-155 only accepts registered names)."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    visfs = dict(doc.get("visfs") or {})
    # Validate eagerly so a typo'd launch key fails at load, not bring-up.
    config_from_parameters(visfs)
    return OperatingPoint(
        node=dict(doc.get("node") or {}),
        visfs=visfs,
        frames=dict(doc.get("frames") or {}),
    )


def static_frame_transform(frames: Mapping[str, Any], child: str):
    """[4,4] parent<-child transform from an operating point's ``frames``
    table (the static_transform_publisher lines of simMapping.launch:5-8)."""
    entry = frames.get(child)
    if entry is None:
        return None
    roll, pitch, yaw = (torch.tensor(float(v), dtype=torch.float32)
                        for v in entry.get("rpy", (0, 0, 0)))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = lie.rpy_to_mat(roll, pitch, yaw).numpy()
    T[:3, 3] = np.asarray(entry.get("xyz", (0, 0, 0)), np.float32)
    return T


# messages a topic that a live transport's ``published`` keeps (the newest;
# the reference keeps every one, which a live run of hours never drains)
PUBLISHED_MAXLEN = 1024


def keep_published(published: Dict[str, collections.deque], topic: str,
                   message) -> None:
    """Append ``message`` to ``published[topic]``, which keeps the newest
    PUBLISHED_MAXLEN."""
    published.setdefault(
        topic, collections.deque(maxlen=PUBLISHED_MAXLEN)).append(message)


class StaticTransport:
    """In-process transport: camera infos and frame tree known up front.

    Serves replay/datasets (io.dataset readers) and the tests; a ROS shim
    implements the same four methods against real topics.
    """

    static = True  # infos either exist now or never will (no wait loop)

    def __init__(self, camera_info_left: CameraInfo,
                 camera_info_right: CameraInfo,
                 frames: Optional[Mapping[str, Any]] = None):
        self._infos = {"left": camera_info_left, "right": camera_info_right}
        self._frames = dict(frames or {})
        self._subs: Dict[str, Any] = {}
        self.published: Dict[str, list] = {}

    def wait_for_camera_info(self, side: str, timeout_s: float = 3.0):
        return self._infos.get(side)

    def lookup_transform(self, parent: str, child: str):
        del parent
        return static_frame_transform(self._frames, child)

    def subscribe(self, topic: str, callback) -> None:
        self._subs[topic] = callback

    def publish(self, topic: str, message) -> None:
        self.published.setdefault(topic, []).append(message)

    # Test-side: inject a message into a subscribed topic.
    def inject(self, topic: str, *args) -> None:
        self._subs[topic](*args)


class VISFSAdapter:
    """The node object: owns a System + native sync runtime, bridges a
    transport.  Mirrors class VISFSInterfaceROS (InterfaceROS.h:30)."""

    def __init__(self, operating_point: OperatingPoint, transport,
                 system_cls=None, use_native_runtime: bool = True,
                 device="cuda"):
        from ..slam.system import System

        self.op = operating_point
        self.transport = transport
        node = operating_point.node

        # 2. CameraInfo wait loop (InterfaceROS.cpp:52-58).
        info_l = info_r = None
        while info_l is None or info_r is None:
            info_l = transport.wait_for_camera_info("left", 3.0)
            info_r = transport.wait_for_camera_info("right", 3.0)
            if info_l is None or info_r is None:
                log.info("Wait for camera model ......")
                # Live transports keep retrying like the reference's
                # waitForMessage loop; static ones can never succeed later.
                if getattr(transport, "static", False):
                    raise TimeoutError(
                        "camera info unavailable on a static transport")
        self.camera_info = (info_l, info_r)

        # 3. Extrinsics from the transform tree (InterfaceROS.cpp:67-83).
        robot = node.get("robot_frame_id", "base_link")
        t_rc = transport.lookup_transform(
            robot, node.get("camera_frame_id", "camera_link"))
        t_rl = transport.lookup_transform(
            robot, node.get("laser_frame_id", "sick_laser_link"))
        if t_rc is None:
            log.error("no robot<-camera transform; using identity")

        # 4. Parameter overrides (InterfaceROS.cpp:125-155; the MinInliers
        # floor lives in config_from_parameters).
        cfg_params = dict(operating_point.visfs)
        baseline = float(node.get("base_line", 0.0)) or info_r.baseline

        # 5. System construction + init (InterfaceROS.cpp:87-89).
        self.system = (system_cls or System)(cfg_params, device=device)
        self.system.init(
            info_l.fx, info_l.fy, info_l.cx, info_l.cy, baseline,
            width=info_l.width, height=info_l.height,
            fxr=info_r.fx, fyr=info_r.fy, cxr=info_r.cx, cyr=info_r.cy,
            transform_camera_to_robot=t_rc,
            transform_laser_to_robot=t_rl,
        )

        # Native approx/exact sync runtime in place of message_filters
        # (InterfaceROS.cpp:96-120).  slop 0 => exact-sync policy.
        self._rt = None
        if use_native_runtime:
            from ..runtime import SystemRuntime

            slop = 0.01 if node.get("approx_sync", True) else 0.0
            self._rt = SystemRuntime(
                self.system, capacity=int(node.get("queue_size", 10)),
                slop_s=slop,
            )

        # Subscriptions (InterfaceROS.cpp:92-120).
        transport.subscribe("left/image", self._on_left)
        transport.subscribe("right/image", self._on_right)
        if operating_point.subscribe_wheel_odom:
            transport.subscribe("wheel_odom", self._on_wheel_odom)
        if operating_point.subscribe_laser_scan:
            transport.subscribe("laser_scan", self._on_scan)
        self._prev_stamp: Optional[float] = None
        self._pending: Dict[float, Dict[str, Any]] = {}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._rt is not None:
            self._rt.start()

    def stop(self) -> None:
        if self._rt is not None:
            self._rt.stop()

    # -- sensor callbacks -------------------------------------------------
    def _on_left(self, stamp: float, image) -> None:
        if self._rt is not None:
            self._rt.push_left(stamp, np.asarray(image, np.float32))
        else:
            self._gather(stamp, "left", image)

    def _on_right(self, stamp: float, image) -> None:
        if self._rt is not None:
            self._rt.push_right(stamp, np.asarray(image, np.float32))
        else:
            self._gather(stamp, "right", image)

    def _on_scan(self, stamp: float, points) -> None:
        if self._rt is not None:
            self._rt.push_scan(stamp, np.asarray(points, np.float32))
        else:
            self._gather(stamp, "scan", points)

    def _on_wheel_odom(self, stamp: float, pose6, velocity6=None) -> None:
        self.system.input_wheel_odometry(stamp, pose6, velocity6)

    def _gather(self, stamp, kind, payload) -> None:
        # Exact-stamp fallback sync when the native runtime is disabled.
        slot = self._pending.setdefault(stamp, {})
        slot[kind] = payload
        need_scan = self.op.subscribe_laser_scan
        if "left" in slot and "right" in slot and (
                not need_scan or "scan" in slot):
            del self._pending[stamp]
            self.system.input_primary_sensor_data(
                stamp, slot["left"], slot["right"], scan=slot.get("scan"))

    # -- publication (InterfaceROS.cpp publishMessage) --------------------
    def spin_once(self) -> int:
        """Drain finished frames, publish odom + odom_info; returns the
        number of frames published."""
        from .interface import frame_output_to_messages

        n = 0
        while True:
            out = self.system.output_odometry_info()
            if out is None:
                return n
            odom, info = frame_output_to_messages(out, self._prev_stamp)
            self._prev_stamp = float(out.stamp)
            self.transport.publish("odom", odom)
            self.transport.publish("odom_info", info)
            n += 1
