"""Odometry publication structures (torch port of visfs_tpu.io.interface;
Interface/ROS equivalent, ROS-free).

The reference's VISFSInterfaceROS publishes nav_msgs/Odometry and
rtabmap_ros/OdomInfo from the per-frame results (InterfaceROS.cpp:225-323,
MsgConversion.cpp:93-120), with a BAD_COVARIANCE null odometry when tracking
is lost (:291-312).  The same payloads as plain dataclasses, for any
middleware binding, from the port's FrameOutput (numpy fields, as
``System.output_odometry_info`` returns them, or tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.lie import mat_to_quat

BAD_COVARIANCE = 9999.0


@dataclasses.dataclass
class Odometry:
    """nav_msgs/Odometry equivalent."""

    stamp: float
    position: np.ndarray  # [3]
    orientation_wxyz: np.ndarray  # [4]
    pose_covariance: np.ndarray  # [6, 6]
    linear_velocity: np.ndarray  # [3]
    angular_velocity: np.ndarray  # [3]
    valid: bool


@dataclasses.dataclass
class OdomInfo:
    """rtabmap_ros/OdomInfo equivalent diagnostics."""

    stamp: float
    lost: bool
    matches: int
    inliers: int
    features: int
    new_features: int
    keyframe: bool
    ba_chi2: float
    ba_ok: bool
    interval: float
    # Per-stage wall times in seconds (EstimateInfo's timing fields,
    # Signature.h:62-73, published in OdomInfo, MsgConversion.cpp:104-106):
    # nonzero with System(profile_stages=True), 0 from the fused step.
    time_tracking: float = 0.0
    time_estimation: float = 0.0
    local_bundle_time: float = 0.0
    time_total: float = 0.0


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def frame_output_to_messages(out, prev_stamp: Optional[float] = None):
    """A FrameOutput as (Odometry, OdomInfo).  Lost frames publish null
    odometry with BAD_COVARIANCE diagonals (InterfaceROS.cpp:291-312)."""
    pose = _np(out.pose)
    lost = bool(out.lost)
    stamp = float(out.stamp)
    vel = _np(out.velocity)
    if lost:
        odom = Odometry(stamp=stamp, position=np.zeros(3),
                        orientation_wxyz=np.array([1.0, 0, 0, 0]),
                        pose_covariance=np.eye(6) * BAD_COVARIANCE,
                        linear_velocity=np.zeros(3),
                        angular_velocity=np.zeros(3), valid=False)
    else:
        q = mat_to_quat(torch.from_numpy(np.array(pose[:3, :3])))
        odom = Odometry(stamp=stamp, position=pose[:3, 3].copy(),
                        orientation_wxyz=q.numpy(),
                        pose_covariance=_np(out.covariance),
                        linear_velocity=vel[:3].copy(),
                        angular_velocity=vel[3:].copy(), valid=True)
    info = OdomInfo(
        stamp=stamp, lost=lost, matches=int(out.n_matches),
        inliers=int(out.n_inliers), features=int(out.n_features),
        new_features=int(out.n_new), keyframe=bool(out.keyframe),
        ba_chi2=float(out.ba_chi2), ba_ok=bool(out.ba_ok),
        interval=(stamp - prev_stamp) if prev_stamp is not None else 0.0,
        time_tracking=float(out.time_tracking),
        time_estimation=float(out.time_estimation),
        local_bundle_time=float(out.local_bundle_time),
        time_total=float(out.time_total))
    return odom, info


@dataclasses.dataclass
class TimedPointCloud:
    """TimedPointCloudWithIntensities equivalent
    (Sensor/PointCloud.h:73-79)."""

    points: np.ndarray  # [N, 3] sensor-frame hits
    times: np.ndarray  # [N] per-point time offsets (<= 0, newest = 0)
    intensities: np.ndarray  # [N]
    time: float  # acquisition time of the newest point
    origin: np.ndarray  # [3]


def laser_scan_to_points(ranges, angle_min, angle_increment, range_min,
                         range_max, stamp, time_increment=0.0,
                         intensities=None):
    """Planar laser scan -> timed point cloud (MsgConversion::
    laserScanToTimedPointCloudWithIntensities, MsgConversion.cpp:156-197):
    range-gated polar-to-cartesian around +Z, per-point times shifted so the
    newest point is 0, the cloud stamped at the last valid return."""
    ranges = np.asarray(ranges, np.float64)
    n = len(ranges)
    angles = angle_min + angle_increment * np.arange(n)
    valid = (ranges >= range_min) & (ranges <= range_max)
    r = ranges[valid]
    a = angles[valid]
    pts = np.stack([r * np.cos(a), r * np.sin(a), np.zeros_like(r)], axis=-1)
    times = (time_increment * np.arange(n))[valid]
    if intensities is not None and len(intensities) == n:
        inten = np.asarray(intensities, np.float32)[valid]
    else:
        inten = np.zeros(len(r), np.float32)
    stamp_out = float(stamp)
    if len(times):
        duration = float(times[-1])
        stamp_out += duration
        times = times - duration
    return TimedPointCloud(points=pts.astype(np.float32),
                           times=times.astype(np.float32), intensities=inten,
                           time=stamp_out, origin=np.zeros(3, np.float32))
