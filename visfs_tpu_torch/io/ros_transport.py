"""rospy Transport binding: VISFSAdapter on live ROS 1 topics (torch port of
visfs_tpu.io.ros_transport).

The literal L5 surface of the reference (Interface/ROS/src/InterfaceROS.cpp
:52-155, InterfaceROSNode.cpp:3): camera-info bring-up via
``rospy.wait_for_message``, extrinsics via tf2, stereo/odom/laser
subscribers, and nav_msgs/Odometry publication (+tf broadcast).  This maps
the reference node's ROS plumbing onto the engine's four-method duck-typed
Transport contract (io/adapter.py), so ``VISFSAdapter`` — which already
carries the full bring-up recipe, parameter overrides, and the native
approx-sync runtime — runs unmodified on a live ROS graph:

    import rospy
    from visfs_tpu_torch.io.adapter import VISFSAdapter, load_operating_point
    from visfs_tpu_torch.io.ros_transport import RospyTransport

    rospy.init_node("visfs")
    op = load_operating_point("configs/sim_mapping.yaml")
    tr = RospyTransport(op.node)
    ad = VISFSAdapter(op, tr)
    ad.start()
    rate = rospy.Rate(1000)            # reference output poll rate
    while not rospy.is_shutdown():     # (InterfaceROSNode.cpp:7-15)
        ad.spin_once()
        rate.sleep()

Message mapping (MsgConversion.cpp equivalents live in io/interface.py):
  left/image, right/image  <- sensor_msgs/Image (mono8/mono16/32FC1)
  wheel_odom               <- nav_msgs/Odometry (pose + twist)
  laser_scan               <- sensor_msgs/LaserScan (via
                              laser_scan_to_points; de-skew times kept)
  odom                     -> nav_msgs/Odometry + optional tf
  odom_info                -> diagnostics as a JSON std_msgs/String
                              (rtabmap_ros/OdomInfo is not a core msg; the
                              reference publishes it only for rtabmapviz)

This module imports rospy lazily so the package needs no ROS install; the
environment here has no ROS daemon, so the binding ships exercised by the
fake-rospy wiring test (tests/test_torch_ros_transport.py) rather than a
live roscore.  ``published`` keeps the last ``adapter.PUBLISHED_MAXLEN``
messages a topic (the reference keeps every one: a leak over a live run of
hours).
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Any, Dict, Optional

import numpy as np


def _quat_to_mat(w, x, y, z):
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def _image_to_array(msg) -> np.ndarray:
    """sensor_msgs/Image -> [H, W] float32 grayscale (MsgConversion.cpp:
    60-77 decodes to MONO8; we accept the common mono encodings)."""
    h, w = int(msg.height), int(msg.width)
    enc = msg.encoding.lower()
    if enc in ("mono8", "8uc1"):
        arr = np.frombuffer(msg.data, np.uint8).reshape(h, msg.step)[:, :w]
    elif enc in ("mono16", "16uc1"):
        arr = np.frombuffer(msg.data, np.uint16).reshape(
            h, msg.step // 2)[:, :w].astype(np.float32) / 256.0
    elif enc == "32fc1":
        arr = np.frombuffer(msg.data, np.float32).reshape(
            h, msg.step // 4)[:, :w]
    elif enc in ("bgr8", "rgb8"):
        raw = np.frombuffer(msg.data, np.uint8).reshape(h, msg.step)
        pix = raw[:, : 3 * w].reshape(h, w, 3).astype(np.float32)
        # BT.601 luma; channel order irrelevant at these weights' accuracy
        # for gray-world SLAM features
        arr = 0.299 * pix[..., 2 if enc == "bgr8" else 0] \
            + 0.587 * pix[..., 1] \
            + 0.114 * pix[..., 0 if enc == "bgr8" else 2]
    else:
        raise ValueError(f"unsupported image encoding: {msg.encoding}")
    return np.ascontiguousarray(arr, np.float32)


class RospyTransport:
    """Transport contract implementation over rospy (ROS 1).

    node_config keys used (same names as the yaml operating points):
      left_image_topic / right_image_topic (default stereo remaps),
      left_camera_info_topic / right_camera_info_topic,
      wheel_odom_topic, laser_scan_topic, odom_topic,
      odom_frame_id, base_frame_id, publish_tf, queue_size.
    """

    static = False

    def __init__(self, node_config: Optional[Dict[str, Any]] = None):
        import rospy  # lazy: no ROS needed unless this transport is used

        self._rospy = rospy
        cfg = dict(node_config or {})
        self.cfg = cfg
        self._topics = {
            "left/image": cfg.get("left_image_topic", "left/image_rect"),
            "right/image": cfg.get("right_image_topic", "right/image_rect"),
            "wheel_odom": cfg.get("wheel_odom_topic", "wheel_odom"),
            "laser_scan": cfg.get("laser_scan_topic", "scan"),
        }
        self._info_topics = {
            "left": cfg.get("left_camera_info_topic", "left/camera_info"),
            "right": cfg.get("right_camera_info_topic", "right/camera_info"),
        }
        self._queue = int(cfg.get("queue_size", 10))
        self._subs = []
        self._pub_odom = None
        self._pub_info = None
        self._tf_broadcaster = None
        self._tf_buffer = None
        self._tf_listener = None
        self.published: Dict[str, collections.deque] = {}

    # -- Transport contract ----------------------------------------------
    def wait_for_camera_info(self, side: str, timeout_s: float = 3.0):
        from sensor_msgs.msg import CameraInfo as RosCameraInfo

        from .adapter import CameraInfo

        try:
            msg = self._rospy.wait_for_message(
                self._info_topics[side], RosCameraInfo, timeout=timeout_s
            )
        except Exception:  # rospy.ROSException on timeout
            return None
        # image_geometry reads fx/fy/cx/cy and -fx*baseline from P
        # (InterfaceROS.cpp:59-64).
        P = np.asarray(msg.P, np.float64).reshape(3, 4)
        return CameraInfo(
            width=int(msg.width), height=int(msg.height),
            fx=float(P[0, 0]), fy=float(P[1, 1]),
            cx=float(P[0, 2]), cy=float(P[1, 2]),
            tx=float(P[0, 3]),
        )

    def lookup_transform(self, parent: str, child: str):
        import tf2_ros

        if self._tf_buffer is None:
            self._tf_buffer = tf2_ros.Buffer()
            self._tf_listener = tf2_ros.TransformListener(self._tf_buffer)
        try:
            ts = self._tf_buffer.lookup_transform(
                parent, child, self._rospy.Time(0),
                self._rospy.Duration(3.0),
            )
        except Exception:
            return None
        t = ts.transform.translation
        q = ts.transform.rotation
        T = np.eye(4)
        T[:3, :3] = _quat_to_mat(q.w, q.x, q.y, q.z)
        T[:3, 3] = (t.x, t.y, t.z)
        return T

    def subscribe(self, topic: str, callback) -> None:
        from nav_msgs.msg import Odometry as RosOdometry
        from sensor_msgs.msg import Image, LaserScan

        ros_topic = self._topics[topic]
        if topic in ("left/image", "right/image"):

            def cb(msg, callback=callback):
                callback(msg.header.stamp.to_sec(), _image_to_array(msg))

            self._subs.append(self._rospy.Subscriber(
                ros_topic, Image, cb, queue_size=self._queue))
        elif topic == "wheel_odom":

            def cb(msg, callback=callback):
                p = msg.pose.pose.position
                q = msg.pose.pose.orientation
                R = _quat_to_mat(q.w, q.x, q.y, q.z)
                # xyzrpy pose6 (the engine's wheel-odometry convention)
                sy = np.hypot(R[0, 0], R[1, 0])
                rpy = (np.arctan2(R[2, 1], R[2, 2]),
                       np.arctan2(-R[2, 0], sy),
                       np.arctan2(R[1, 0], R[0, 0]))
                pose6 = np.array([p.x, p.y, p.z, *rpy], np.float32)
                tw = msg.twist.twist
                vel6 = np.array([tw.linear.x, tw.linear.y, tw.linear.z,
                                 tw.angular.x, tw.angular.y, tw.angular.z],
                                np.float32)
                callback(msg.header.stamp.to_sec(), pose6, vel6)

            self._subs.append(self._rospy.Subscriber(
                ros_topic, RosOdometry, cb, queue_size=100))
        elif topic == "laser_scan":
            from .interface import laser_scan_to_points

            def cb(msg, callback=callback):
                cloud = laser_scan_to_points(
                    msg.ranges, msg.angle_min, msg.angle_increment,
                    msg.range_min, msg.range_max,
                    msg.header.stamp.to_sec(),
                    time_increment=msg.time_increment,
                    intensities=msg.intensities,
                )
                callback(cloud.time, cloud.points)

            self._subs.append(self._rospy.Subscriber(
                ros_topic, LaserScan, cb, queue_size=self._queue))
        else:
            raise ValueError(f"unknown engine topic: {topic}")

    def publish(self, topic: str, message) -> None:
        from .adapter import keep_published

        keep_published(self.published, topic, message)
        if topic == "odom":
            self._publish_odom(message)
        elif topic == "odom_info":
            self._publish_info(message)

    # -- publication helpers ----------------------------------------------
    def _publish_odom(self, odom) -> None:
        from geometry_msgs.msg import TransformStamped
        from nav_msgs.msg import Odometry as RosOdometry

        rospy = self._rospy
        if self._pub_odom is None:
            self._pub_odom = rospy.Publisher(
                self.cfg.get("odom_topic", "odom"), RosOdometry,
                queue_size=50)
        msg = RosOdometry()
        msg.header.stamp = rospy.Time.from_sec(float(odom.stamp))
        msg.header.frame_id = self.cfg.get("odom_frame_id", "odom")
        msg.child_frame_id = self.cfg.get("base_frame_id", "base_link")
        p = np.asarray(odom.position, float)
        q = np.asarray(odom.orientation_wxyz, float)
        msg.pose.pose.position.x, msg.pose.pose.position.y, \
            msg.pose.pose.position.z = p
        msg.pose.pose.orientation.w = q[0]
        msg.pose.pose.orientation.x = q[1]
        msg.pose.pose.orientation.y = q[2]
        msg.pose.pose.orientation.z = q[3]
        msg.pose.covariance = list(
            np.asarray(odom.pose_covariance, float).reshape(-1))
        lv = np.asarray(odom.linear_velocity, float)
        av = np.asarray(odom.angular_velocity, float)
        msg.twist.twist.linear.x, msg.twist.twist.linear.y, \
            msg.twist.twist.linear.z = lv
        msg.twist.twist.angular.x, msg.twist.twist.angular.y, \
            msg.twist.twist.angular.z = av
        self._pub_odom.publish(msg)

        if bool(self.cfg.get("publish_tf", False)) and odom.valid:
            import tf2_ros

            if self._tf_broadcaster is None:
                self._tf_broadcaster = tf2_ros.TransformBroadcaster()
            ts = TransformStamped()
            ts.header = msg.header
            ts.child_frame_id = msg.child_frame_id
            ts.transform.translation.x, ts.transform.translation.y, \
                ts.transform.translation.z = p
            ts.transform.rotation.w = q[0]
            ts.transform.rotation.x = q[1]
            ts.transform.rotation.y = q[2]
            ts.transform.rotation.z = q[3]
            self._tf_broadcaster.sendTransform(ts)

    def _publish_info(self, info) -> None:
        from std_msgs.msg import String

        if self._pub_info is None:
            self._pub_info = self._rospy.Publisher(
                self.cfg.get("odom_info_topic", "odom_info"), String,
                queue_size=50)
        body = dataclasses.asdict(info) if dataclasses.is_dataclass(info) \
            else dict(info)
        body = {k: (float(v) if isinstance(v, (np.floating, float))
                    else int(v) if isinstance(v, (np.integer, bool, int))
                    else v)
                for k, v in body.items()}
        self._pub_info.publish(String(data=json.dumps(body)))

    def close(self) -> None:
        for s in self._subs:
            try:
                s.unregister()
            except Exception:  # noqa: BLE001
                pass
        self._subs.clear()
