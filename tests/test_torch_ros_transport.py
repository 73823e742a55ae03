"""The port's rospy binding (visfs_tpu_torch.io.ros_transport) against the
JAX package's, on a fake in-process rospy (no ROS daemon exists here): the
reference's wiring test run through the port's adapter and System on
"cpu" (camera-info bring-up, tf lookup, image/odometry messages into the
engine, Odometry, OdomInfo and tf out); _image_to_array equal to the
reference's on every mono and colour encoding it decodes, and the same
error on one it does not; and ADVICE.md:3: the reference's ``published``
keeps every message, the port's the newest PUBLISHED_MAXLEN a topic.  The
fake is tests/test_ros_transport.py's."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from visfs_tpu.io import ros_transport as jros
from visfs_tpu_torch.io import ros_transport as tros
from visfs_tpu_torch.io.adapter import PUBLISHED_MAXLEN

torch.set_num_threads(1)


class _Stamp:
    def __init__(self, t):
        self._t = float(t)

    def to_sec(self):
        return self._t


class _Header:
    def __init__(self, t=0.0):
        self.stamp = _Stamp(t)
        self.frame_id = ""


class _Obj:
    """Attribute bag (geometry_msgs-style nested messages)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _fake_ros(monkeypatch, published, camera_info_P):
    """Install fake rospy + msg modules; returns the subscriber registry."""
    subs = {}

    rospy = types.ModuleType("rospy")

    class _Sub:
        def __init__(self, topic, _type, cb, queue_size=10):
            subs[topic] = cb

        def unregister(self):
            pass

    class _Pub:
        def __init__(self, topic, _type, queue_size=10):
            self.topic = topic

        def publish(self, msg):
            published.setdefault(self.topic, []).append(msg)

    class _Time:
        def __init__(self, t=0.0):
            self.t = t

        @staticmethod
        def from_sec(t):
            return _Time(t)

    rospy.Subscriber = _Sub
    rospy.Publisher = _Pub
    rospy.Time = _Time
    rospy.Duration = lambda s: s

    def wait_for_message(topic, _type, timeout=None):
        side = "left" if "left" in topic else "right"
        msg = _Obj(width=160, height=120, P=camera_info_P[side])
        return msg

    rospy.wait_for_message = wait_for_message

    sensor_msgs = types.ModuleType("sensor_msgs")
    sensor_msgs_msg = types.ModuleType("sensor_msgs.msg")

    class Image:  # noqa: D401 — placeholder message classes
        pass

    class LaserScan:
        pass

    class CameraInfo:
        pass

    sensor_msgs_msg.Image = Image
    sensor_msgs_msg.LaserScan = LaserScan
    sensor_msgs_msg.CameraInfo = CameraInfo

    nav_msgs = types.ModuleType("nav_msgs")
    nav_msgs_msg = types.ModuleType("nav_msgs.msg")

    class RosOdometry:
        def __init__(self):
            self.header = _Header()
            self.child_frame_id = ""
            self.pose = _Obj(
                pose=_Obj(position=_Obj(x=0, y=0, z=0),
                          orientation=_Obj(w=1, x=0, y=0, z=0)),
                covariance=[0.0] * 36,
            )
            self.twist = _Obj(
                twist=_Obj(linear=_Obj(x=0, y=0, z=0),
                           angular=_Obj(x=0, y=0, z=0)),
            )

        # instances are also used as incoming messages in the test
    nav_msgs_msg.Odometry = RosOdometry

    std_msgs = types.ModuleType("std_msgs")
    std_msgs_msg = types.ModuleType("std_msgs.msg")

    class String:
        def __init__(self, data=""):
            self.data = data

    std_msgs_msg.String = String

    geometry_msgs = types.ModuleType("geometry_msgs")
    geometry_msgs_msg = types.ModuleType("geometry_msgs.msg")

    class TransformStamped:
        def __init__(self):
            self.header = _Header()
            self.child_frame_id = ""
            self.transform = _Obj(
                translation=_Obj(x=0, y=0, z=0),
                rotation=_Obj(w=1, x=0, y=0, z=0),
            )

    geometry_msgs_msg.TransformStamped = TransformStamped

    tf2_ros = types.ModuleType("tf2_ros")

    class Buffer:
        def lookup_transform(self, parent, child, _t, _d=None):
            ts = TransformStamped()
            if child == "camera_link":
                ts.transform.translation.z = 0.3
            return ts

    tf2_ros.Buffer = Buffer
    tf2_ros.TransformListener = lambda buf: None
    tf2_ros.TransformBroadcaster = lambda: _Obj(
        sendTransform=lambda ts: published.setdefault("tf", []).append(ts))

    for name, mod in [
        ("rospy", rospy), ("sensor_msgs", sensor_msgs),
        ("sensor_msgs.msg", sensor_msgs_msg), ("nav_msgs", nav_msgs),
        ("nav_msgs.msg", nav_msgs_msg), ("std_msgs", std_msgs),
        ("std_msgs.msg", std_msgs_msg), ("geometry_msgs", geometry_msgs),
        ("geometry_msgs.msg", geometry_msgs_msg), ("tf2_ros", tf2_ros),
    ]:
        monkeypatch.setitem(sys.modules, name, mod)
    return subs


def _mono8(img, t):
    h, w = img.shape
    return _Obj(height=h, width=w, encoding="mono8", step=w,
                data=img.astype(np.uint8).tobytes(), header=_Header(t))


def _mono8(img, t):
    h, w = img.shape
    return _Obj(height=h, width=w, encoding="mono8", step=w,
                data=img.astype(np.uint8).tobytes(), header=_Header(t))


def test_adapter_runs_on_fake_rospy(monkeypatch):
    from visfs_tpu_torch.io.adapter import OperatingPoint, VISFSAdapter
    from visfs_tpu_torch.io.sim import generate_sequence

    seq = generate_sequence(n_frames=8, width=160, height=120,
                            n_points=150, seed=5, device="cpu")
    cam = seq.camera
    fx, fy, cx, cy, b = (float(cam.fx), float(cam.fy), float(cam.cx),
                         float(cam.cy), float(cam.baseline))
    P = {
        "left": [fx, 0, cx, 0, 0, fy, cy, 0, 0, 0, 1, 0],
        "right": [fx, 0, cx, -fx * b, 0, fy, cy, 0, 0, 0, 1, 0],
    }
    published = {}
    subs = _fake_ros(monkeypatch, published, P)

    tr = tros.RospyTransport({"publish_tf": True, "wheel_odom_topic": "wo"})
    info = tr.wait_for_camera_info("right")
    assert info.fx == pytest.approx(fx)
    assert info.tx == pytest.approx(-fx * b)
    T = tr.lookup_transform("base_link", "camera_link")
    assert T is not None and T[2, 3] == pytest.approx(0.3)

    op = OperatingPoint(
        node={"base_line": 0.0, "queue_size": 16,
              "subscribe_wheel_odom": True},
        visfs={"Tracker/MaxFeatures": 60, "Tracker/MinDistance": 10,
               "Optimizer/Iterations": 4},
        frames={},
    )
    ad = VISFSAdapter(op, tr, use_native_runtime=False, device="cpu")
    assert "left/image_rect" in subs and "right/image_rect" in subs
    assert "wo" in subs

    # a wheel Odometry message through the fake wire into the buffer
    from nav_msgs.msg import Odometry as RosOdometry

    wheel = RosOdometry()
    wheel.header = _Header(0.05)
    wheel.pose.pose.position.x = 0.25
    wheel.pose.pose.orientation.w = np.cos(0.1)
    wheel.pose.pose.orientation.z = np.sin(0.1)
    subs["wo"](wheel)
    odom = ad.system.state.odom
    assert int(odom.head) == 1
    np.testing.assert_allclose(odom.pose[0].numpy(),
                               [0.25, 0, 0, 0, 0, 0.2], atol=1e-6)

    for i in range(6):
        t = float(seq.stamps[i])
        subs["left/image_rect"](_mono8(np.clip(seq.left[i], 0, 255), t))
        subs["right/image_rect"](_mono8(np.clip(seq.right[i], 0, 255), t))
        ad.spin_once()
    ad.spin_once()
    assert len(published["odom"]) >= 4, published.keys()
    msg = published["odom"][-1]
    assert msg.header.frame_id == "odom"
    assert np.isfinite([msg.pose.pose.position.x,
                        msg.pose.pose.position.y]).all()
    body = json.loads(published["odom_info"][-1].data)
    assert "inliers" in body and "lost" in body
    assert published.get("tf"), "publish_tf produced no transforms"


def _image(enc, h=3, w=4, pad=0):
    rng = np.random.default_rng(len(enc))
    if enc in ("mono8", "8UC1"):
        px = rng.integers(0, 256, (h, w + pad), np.uint8)
    elif enc in ("mono16", "16UC1"):
        px = rng.integers(0, 65536, (h, w + pad), np.uint16)
    elif enc == "32FC1":
        px = rng.normal(size=(h, w + pad)).astype(np.float32)
    else:
        px = rng.integers(0, 256, (h, 3 * w + pad), np.uint8)
    return _Obj(height=h, width=w, encoding=enc,
                step=px.shape[1] * px.itemsize, data=px.tobytes(),
                header=_Header(0))


@pytest.mark.parametrize("enc", ["mono8", "8UC1", "mono16", "16UC1", "32FC1",
                                 "bgr8", "rgb8"])
@pytest.mark.parametrize("pad", [0, 4])
def test_image_to_array_equals_the_reference(enc, pad):
    m = _image(enc, pad=pad)
    ref = jros._image_to_array(m)
    port = tros._image_to_array(m)
    assert port.dtype == np.float32 and port.shape == (3, 4)
    np.testing.assert_array_equal(port, ref)


def test_unsupported_encoding_raises():
    m = _Obj(height=1, width=1, encoding="yuv422", step=2, data=b"ab",
             header=_Header(0))
    for mod in (jros, tros):
        with pytest.raises(ValueError, match="unsupported"):
            mod._image_to_array(m)


def test_published_is_bounded(monkeypatch):
    """ADVICE.md:3: over a long live run the reference's ``published``
    grows with every message; the port's keeps the newest
    PUBLISHED_MAXLEN a topic."""
    _fake_ros(monkeypatch, {}, {"left": [0] * 12, "right": [0] * 12})
    n = PUBLISHED_MAXLEN + 25
    ref, port = jros.RospyTransport({}), tros.RospyTransport({})
    for i in range(n):
        ref.publish("diagnostics", i)
        port.publish("diagnostics", i)
    assert len(ref.published["diagnostics"]) == n
    assert list(port.published["diagnostics"]) == list(
        range(n - PUBLISHED_MAXLEN, n))
