"""Laser scan pretreatment (torch port of visfs_tpu.slam.laser, the
Estimator::laserPretreatment equivalent, corelib/src/Estimator.cpp:116-164).

Transforms the scan into the robot frame, drops returns below the minimum
range and turns returns beyond the maximum range into misses at
``missing_data_ray_length``.  With per-point times and a velocity, the
points are de-skewed as the reference package does: the times quantize into
NumSubDivisionPreScan buckets, and each bucket's points move into the
scan-stamp robot frame through the constant-velocity model
``E(t) = exp(v * t)`` (t <= 0, newest point at 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lie import mat_apply, xyzrpy_to_mat


class PretreatedScan(NamedTuple):
    origin: torch.Tensor  # [3] sensor origin in the robot frame
    returns: torch.Tensor  # [K, 3] robot-frame hit points
    returns_mask: torch.Tensor  # [K]
    misses: torch.Tensor  # [K, 3] robot-frame missing-echo endpoints
    misses_mask: torch.Tensor  # [K]


def pretreat(points, mask, t_laser_to_robot, min_range, max_range,
             missing_data_ray_length, times=None, velocity6=None,
             n_subdivisions: int = 1) -> PretreatedScan:
    """points: [K, 3] laser-frame; mask: [K]; t_laser_to_robot: [4, 4].

    times: optional [K] per-point offsets in seconds (<= 0, newest = 0);
    velocity6: optional [6] robot velocity (x, y, z, roll, pitch, yaw)/s;
    n_subdivisions: the de-skew bucket count (1 disables it).
    """
    origin = t_laser_to_robot[:3, 3]
    p = mat_apply(t_laser_to_robot, points)

    if times is not None and velocity6 is not None and n_subdivisions > 1:
        big = torch.full_like(times, 1e9)
        t_min = torch.amin(torch.where(mask, times, big))
        t_max = torch.amax(torch.where(mask, times, -big))
        span = torch.clamp(t_max - t_min, min=1e-9)
        bucket = torch.clamp(((times - t_min) / span * n_subdivisions)
                             .to(torch.int32), 0, n_subdivisions - 1)
        # a bucket's time is its end (Estimator.cpp:129 re-stamps each part
        # at its last point)
        tb = t_min + (torch.arange(1, n_subdivisions + 1, dtype=p.dtype,
                                   device=p.device) / n_subdivisions) * span
        Eb = xyzrpy_to_mat(*(velocity6[None, :] * tb[:, None]).unbind(-1))
        T = Eb[bucket.long()]  # [K, 4, 4]
        p = (T[:, :3, :3] @ p[:, :, None])[:, :, 0] + T[:, :3, 3]

    delta = p - origin
    rng = torch.sqrt(torch.sum(delta * delta, dim=-1))
    ok = mask & (rng >= min_range)
    is_return = ok & (rng <= max_range)
    is_miss = ok & (rng > max_range)
    safe_rng = torch.clamp(rng, min=1e-6)
    miss_pts = origin + (missing_data_ray_length / safe_rng)[:, None] * delta
    zero = torch.zeros_like(p)
    return PretreatedScan(
        origin=origin,
        returns=torch.where(is_return[:, None], p, zero),
        returns_mask=is_return,
        misses=torch.where(is_miss[:, None], miss_pts, zero),
        misses_mask=is_miss)
