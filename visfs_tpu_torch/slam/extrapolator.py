"""Motion-prior extrapolator over a wheel-odometry ring buffer (torch port
of visfs_tpu.slam.extrapolator).

For pure stereo the prior is the last visual velocity
(extrapolateFromVelocity); with wheel odometry the aligned wheel pose comes
from the two buffered samples nearest the image stamp (predictAlignPose).
"""

from __future__ import annotations

import torch

from ..core.lie import mat_inv_se3, xyzrpy_to_mat
from .state import OdomBuffer


def add_odometry(buf: OdomBuffer, stamp, pose6, vel6) -> OdomBuffer:
    """Push one wheel-odometry sample (Extrapolator::addOdometry)."""
    slot = torch.arange(buf.stamp.shape[0], device=buf.stamp.device) \
        == buf.head % buf.stamp.shape[0]

    def put(a, v):
        return torch.where(slot.reshape((-1,) + (1,) * (a.dim() - 1)), v, a)

    return OdomBuffer(stamp=put(buf.stamp, stamp), pose=put(buf.pose, pose6),
                      velocity=put(buf.velocity, vel6),
                      valid=buf.valid | slot, head=buf.head + 1)


def add_odometry_batch(odom: OdomBuffer, rows) -> OdomBuffer:
    """Push the valid rows of ``rows`` [K, 14] = (stamp, pose6, vel6,
    valid) into the ring buffer in order, equivalent to one add_odometry
    per valid row (the reference's scan of them): each slot takes the last
    valid row that lands on it (a scatter-max of row numbers,
    deterministic), head moves by the count."""
    C = odom.stamp.shape[0]
    valid = rows[:, 13] > 0.5
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    slot = torch.remainder(odom.head.to(torch.int64) + rank, C)
    slot = torch.where(valid, slot, torch.full_like(slot, C))
    order = torch.arange(rows.shape[0], device=rows.device)
    winner = torch.full((C + 1,), -1, dtype=torch.int64, device=rows.device)
    winner.scatter_reduce_(0, slot, order, reduce="amax")
    winner = winner[:C]
    took = winner >= 0
    src = rows[torch.clamp(winner, min=0)]

    def put(a, v):
        return torch.where(took.reshape((-1,) + (1,) * (a.dim() - 1)), v, a)

    return odom._replace(
        stamp=put(odom.stamp, src[:, 0]), pose=put(odom.pose, src[:, 1:7]),
        velocity=put(odom.velocity, src[:, 7:13]), valid=odom.valid | took,
        head=odom.head + torch.sum(valid).to(odom.head.dtype))


def acc_motion_model(delta_t, direction, base6, v1_6, v2_6):
    """Constant-acceleration xyzrpy prediction (accMotionModel,
    Extrapolator.cpp:124-170).  Off every path, as in the reference: both
    of its call sites there are commented out (Extrapolator.cpp:218,252).
    direction True = second-last -> last; False integrates backwards with
    negated v2/acceleration."""
    acc = v2_6 - v1_6
    half = 0.5 * delta_t
    fwd = base6 + v1_6 * delta_t + acc * half
    bwd = base6 - v2_6 * delta_t - acc * half
    return torch.where(torch.as_tensor(direction, device=fwd.device), fwd,
                       bwd)


def predict_align_pose(buf: OdomBuffer, stamp, wheel_freq: int):
    """Aligned global wheel pose at ``stamp`` -> (pose6, valid), with the
    reference's timing sanity gates (Extrapolator.cpp:203-219)."""
    inf = torch.full_like(buf.stamp, float("inf"))
    score = torch.where(buf.valid, torch.abs(buf.stamp - stamp), inf)
    best = torch.argmin(score)
    idx = torch.arange(score.shape[0], device=score.device)
    second = torch.argmin(torch.where(idx == best, inf, score))
    have_two = torch.sum(buf.valid) >= 2

    pick = torch.stack([best, second])  # a 1-d index: no host read
    tb, ts = buf.stamp[pick].unbind(0)
    pb, ps = buf.pose[pick].unbind(0)
    t_last = torch.maximum(tb, ts)
    t_second = torch.minimum(tb, ts)
    p_last = torch.where(tb >= ts, pb, ps)
    p_second = torch.where(tb >= ts, ps, pb)

    interval = 1.0 / wheel_freq
    inside = (t_second <= stamp) & (stamp <= t_last)
    beyond = t_last < stamp
    gap_ok_inside = (t_last - t_second) <= 2.0 * interval + 1e-6
    gap_ok_beyond = (stamp - t_last) <= interval + 1e-6

    gap = t_last - t_second
    safe = torch.where(torch.abs(gap) < 1e-9, torch.ones_like(gap), gap)
    pose6 = p_second + (p_last - p_second) / safe * (stamp - t_second)
    valid = have_two & ((inside & gap_ok_inside)
                        | (beyond & gap_ok_beyond & gap_ok_inside))
    return pose6, valid


def extrapolate_pose(buf: OdomBuffer, stamp, prev_stamp, velocity6,
                     velocity_valid, prev_wheel6, prev_wheel_valid,
                     sensor_strategy: int, wheel_freq: int):
    """Extrapolator::extrapolatorPose -> (guess_delta [4,4], wheel_pose
    [4,4], wheel_pose_valid, new_prev_wheel6, new_prev_wheel_valid)."""
    dt = stamp - prev_stamp
    vel_delta6 = torch.where(velocity_valid & (prev_stamp > 0.0),
                             velocity6 * dt, torch.zeros_like(velocity6))
    vel_delta = xyzrpy_to_mat(*vel_delta6.unbind(0))
    if sensor_strategy < 2:
        eye = torch.eye(4, dtype=vel_delta.dtype, device=vel_delta.device)
        return (vel_delta, eye, torch.zeros_like(prev_wheel_valid),
                prev_wheel6, prev_wheel_valid)

    pose6, ok = predict_align_pose(buf, stamp, wheel_freq)
    wheel_pose = xyzrpy_to_mat(*pose6.unbind(0))
    prev_mat = xyzrpy_to_mat(*prev_wheel6.unbind(0))
    delta_wheel = mat_inv_se3(prev_mat) @ wheel_pose
    eye = torch.eye(4, dtype=wheel_pose.dtype, device=wheel_pose.device)
    guess = torch.where(ok & prev_wheel_valid, delta_wheel,
                        torch.where(ok, eye, vel_delta))
    return (guess, wheel_pose, ok, torch.where(ok, pose6, prev_wheel6),
            ok | prev_wheel_valid)
