"""Synthetic textured stereo sequences with exact ground truth (torch port of
the textured generator in visfs_tpu.io.sim).

A closed rectangular room (walls, floor, ceiling) plus pillars, all with
multi-octave value-noise textures, is ray-cast through the stereo rig on the
given device; exposure drift, pixel noise and wheel odometry come from the
same numpy random stream, drawn in the reference's call order, so a seed
gives the reference's sequence.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from ..core.camera import StereoCamera, make_stereo_camera
from ..core.lie import xyzrpy_to_mat


class SimSequence(NamedTuple):
    left: np.ndarray  # [T, H, W] float32 images in [0, 255]
    right: np.ndarray  # [T, H, W]
    stamps: np.ndarray  # [T]
    poses: np.ndarray  # [T, 4, 4] ground-truth robot poses Twr
    wheel_odom: np.ndarray  # [T_odom, 8]: (stamp, x, y, z, r, p, yaw, valid)
    camera: StereoCamera


def default_camera(width=320, height=240, device="cpu"):
    return make_stereo_camera(
        fx=0.8 * width, fy=0.8 * width, cx=width / 2, cy=height / 2,
        baseline=0.12, width=width, height=height, device=device)


# (world cell size m, weight, sharp): sharp = nearest-neighbour mosaic.
_TEX_OCTAVES = ((1.1, 0.34, False), (0.33, 0.33, False), (0.13, 0.33, True))
_T_MIN = 0.25  # nearest plane hit distance along the ray (m)


class _Plane(NamedTuple):
    p0: np.ndarray
    n: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    u0: float
    u1: float
    v0: float
    v1: float
    grid: np.ndarray  # [S, S] base noise grid


def _bounded_plane(rng, p0, n, e1, e2, u01, v01) -> _Plane:
    return _Plane(
        p0=np.asarray(p0, np.float64), n=np.asarray(n, np.float64),
        e1=np.asarray(e1, np.float64), e2=np.asarray(e2, np.float64),
        u0=u01[0], u1=u01[1], v0=v01[0], v1=v01[1],
        grid=rng.uniform(0.0, 1.0, (64, 64)),
    )


def _make_world(rng, room, z_floor, z_ceil, n_pillars, traj_xy):
    """Walls, floor, ceiling and pillar faces (reference RNG call order)."""
    x0, x1, y0, y1 = room
    planes = [
        _bounded_plane(rng, (x1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, 0, 1),
                       (y0, y1), (z_floor, z_ceil)),
        _bounded_plane(rng, (x0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                       (y0, y1), (z_floor, z_ceil)),
        _bounded_plane(rng, (0, y1, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1),
                       (x0, x1), (z_floor, z_ceil)),
        _bounded_plane(rng, (0, y0, 0), (0, 1, 0), (1, 0, 0), (0, 0, 1),
                       (x0, x1), (z_floor, z_ceil)),
        _bounded_plane(rng, (0, 0, z_floor), (0, 0, 1), (1, 0, 0), (0, 1, 0),
                       (x0, x1), (y0, y1)),
        _bounded_plane(rng, (0, 0, z_ceil), (0, 0, -1), (1, 0, 0), (0, 1, 0),
                       (x0, x1), (y0, y1)),
    ]
    n_found, tries = 0, 0
    while n_found < n_pillars and tries < 200:
        tries += 1
        cx = rng.uniform(x0 + 2.0, x1 - 2.0)
        cy = rng.uniform(y0 + 1.5, y1 - 1.5)
        w = rng.uniform(0.4, 0.9)
        h = rng.uniform(0.4, 0.9)
        d = np.hypot(traj_xy[:, 0] - cx, traj_xy[:, 1] - cy)
        if d.min() < 1.2 + max(w, h):
            continue
        n_found += 1
        bx0, bx1 = cx - w / 2, cx + w / 2
        by0, by1 = cy - h / 2, cy + h / 2
        planes += [
            _bounded_plane(rng, (bx1, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                           (by0, by1), (z_floor, z_ceil)),
            _bounded_plane(rng, (bx0, 0, 0), (-1, 0, 0), (0, 1, 0), (0, 0, 1),
                           (by0, by1), (z_floor, z_ceil)),
            _bounded_plane(rng, (0, by1, 0), (0, 1, 0), (1, 0, 0), (0, 0, 1),
                           (bx0, bx1), (z_floor, z_ceil)),
            _bounded_plane(rng, (0, by0, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1),
                           (bx0, bx1), (z_floor, z_ceil)),
        ]
    return planes


def _mm(a, b):
    """[P, 3] @ [3, K] with the three products summed left to right."""
    return (a[:, 0:1] * b[0] + a[:, 1:2] * b[1]) + a[:, 2:3] * b[2]


def _fma(a, b, c):
    """a * b + c rounded once (a fused multiply-add), as the reference's
    compiled renderer evaluates it: texture cells are discontinuous in the
    hit coordinates, so a second rounding would flip whole cells."""
    return (a.double() * b.double() + c.double()).float()


def _render_views(planes, origins, rots, fx, fy, cx, cy, width: int,
                  height: int, device):
    """Ray-cast V views on ``device`` -> images [V, H, W] in [0, 1] (float32
    renders, returned as float64 numpy like the reference's)."""
    f32 = dict(dtype=torch.float32, device=device)

    def stack(attr):
        return torch.tensor(np.stack([getattr(p, attr) for p in planes]),
                            **f32)

    p0, nrm, e1, e2 = stack("p0"), stack("n"), stack("e1"), stack("e2")
    uvb = torch.tensor(np.stack([[p.u0, p.u1, p.v0, p.v1] for p in planes]),
                       **f32)
    grids = torch.tensor(np.stack([p.grid for p in planes]), **f32)
    S = grids.shape[1]
    flat_grids = grids.reshape(-1)
    us = (torch.arange(width, **f32) - float(np.float32(cx))) \
        / float(np.float32(fx))
    vs = (torch.arange(height, **f32) - float(np.float32(cy))) \
        / float(np.float32(fy))
    d_img = torch.stack([us[None, :].expand(height, width).reshape(-1),
                         vs[:, None].expand(height, width).reshape(-1),
                         torch.ones(width * height, **f32)], dim=-1)
    o_all = torch.tensor(origins, **f32)
    r_all = torch.tensor(rots, **f32)
    out = np.empty((len(origins), height, width), np.float64)
    for v in range(len(origins)):
        o = o_all[v]
        d_w = _mm(d_img, r_all[v].T)  # [P, 3]
        denom = _mm(d_w, nrm.T)  # [P, K]
        t_num = torch.sum((p0 - o) * nrm, dim=1)
        nz = torch.abs(denom) > 1e-12
        t = torch.where(nz, t_num / denom, torch.full_like(denom, -1.0))
        uu = _fma(t, _mm(d_w, e1.T), torch.sum((o - p0) * e1, dim=1))
        vv = _fma(t, _mm(d_w, e2.T), torch.sum((o - p0) * e2, dim=1))
        valid = (nz & (t > _T_MIN) & (uu >= uvb[:, 0]) & (uu <= uvb[:, 1])
                 & (vv >= uvb[:, 2]) & (vv <= uvb[:, 3]))
        tv = torch.where(valid, t, torch.full_like(t, float("inf")))
        best = torch.argmin(tv, dim=1)
        best_t = torch.gather(tv, 1, best[:, None])[:, 0]
        uu_w = torch.gather(uu, 1, best[:, None])[:, 0]
        vv_w = torch.gather(vv, 1, best[:, None])[:, 0]
        base = best * (S * S)

        def pick(a, b):
            return flat_grids[base + torch.remainder(a, S) * S
                              + torch.remainder(b, S)]

        tex = torch.zeros_like(uu_w)
        for cell, wgt, sharp in _TEX_OCTAVES:
            gu = uu_w / cell
            gv = vv_w / cell
            iu = torch.floor(gu)
            iv = torch.floor(gv)
            iu_i, iv_i = iu.to(torch.int64), iv.to(torch.int64)
            if sharp:
                tex = tex + wgt * pick(iu_i, iv_i)
            else:
                fu = gu - iu
                fv = gv - iv
                tex = tex + wgt * (
                    (pick(iu_i, iv_i) * (1 - fu) + pick(iu_i + 1, iv_i) * fu)
                    * (1 - fv)
                    + (pick(iu_i, iv_i + 1) * (1 - fu)
                       + pick(iu_i + 1, iv_i + 1) * fu) * fv)
        img = torch.where(torch.isfinite(best_t), tex, torch.zeros_like(tex))
        out[v] = img.reshape(height, width).cpu().numpy()
    return out


def _square_path(room, margin=4.0, corner_radius=1.5):
    """Rounded-rectangle loop inset `margin` from the room walls:
    (perimeter length, s -> (x, y, yaw_unwrapped))."""
    x0, x1, y0, y1 = room
    ax0, ax1 = x0 + margin, x1 - margin
    ay0, ay1 = y0 + margin, y1 - margin
    r = corner_radius
    lw = (ax1 - ax0) - 2 * r
    lh = (ay1 - ay0) - 2 * r
    arc = 0.5 * np.pi * r
    pieces = [
        ("s", lw, ((ax0 + r, ay0), (1.0, 0.0), 0.0)),
        ("a", arc, ((ax1 - r, ay0 + r), -0.5 * np.pi, 0.0)),
        ("s", lh, ((ax1, ay0 + r), (0.0, 1.0), 0.5 * np.pi)),
        ("a", arc, ((ax1 - r, ay1 - r), 0.0, 0.5 * np.pi)),
        ("s", lw, ((ax1 - r, ay1), (-1.0, 0.0), np.pi)),
        ("a", arc, ((ax0 + r, ay1 - r), 0.5 * np.pi, np.pi)),
        ("s", lh, ((ax0, ay1 - r), (0.0, -1.0), 1.5 * np.pi)),
        ("a", arc, ((ax0 + r, ay0 + r), np.pi, 1.5 * np.pi)),
    ]
    total = sum(p[1] for p in pieces)

    def point(s):
        laps, s = divmod(s, total)
        yaw_base = laps * 2.0 * np.pi
        for kind, length, data in pieces:
            last = kind is pieces[-1][0] and data is pieces[-1][2]
            if s <= length or last:
                s = min(s, length)
                if kind == "s":
                    (sx, sy), (dx, dy), yaw = data
                    return (sx + dx * s, sy + dy * s, yaw_base + yaw)
                (ccx, ccy), ang0, yaw0 = data
                dang = s / corner_radius
                a = ang0 + dang
                return (ccx + corner_radius * np.cos(a),
                        ccy + corner_radius * np.sin(a),
                        yaw_base + yaw0 + dang)
            s -= length
        raise AssertionError("unreachable: s beyond the last piece")

    return total, point


def _trajectory(motion, n_frames, fps, room, loops=1.0, speed=None):
    """Per-frame (x, y, yaw_unwrapped) arrays for each motion profile."""
    ts = np.arange(n_frames) / fps
    if motion == "forward":
        return 0.35 * ts, np.zeros(n_frames), np.zeros(n_frames)
    if motion == "yaw":
        return np.zeros(n_frames), np.zeros(n_frames), 0.25 * ts
    if motion == "arc":
        return 0.35 * ts, 0.04 * ts * ts, 0.08 * ts
    if motion == "square":
        total, point = _square_path(room)
        if speed is None:
            speed = loops * total / max(ts[-1], 1e-9)
        xyy = np.array([point(speed * t) for t in ts])
        return xyy[:, 0], xyy[:, 1], xyy[:, 2]
    raise ValueError(f"unknown motion {motion!r}")


def _wheel_odom_from_traj(xs, ys, yaws, n_frames, fps, odom_rate, rng,
                          drift_xy=0.0, drift_yaw=0.0):
    """Wheel odometry samples with random-walk drift."""
    n_odom = int(np.ceil((n_frames - 1) / fps * odom_rate)) + 2
    odom = np.zeros((n_odom, 8), dtype=np.float64)
    dt = 1.0 / odom_rate
    dx = dy = dyaw = 0.0
    for k in range(n_odom):
        t = k * dt
        tf = min(t * fps, n_frames - 1)
        i0 = int(np.floor(tf))
        i1 = min(i0 + 1, n_frames - 1)
        a = tf - i0
        x = (1 - a) * xs[i0] + a * xs[i1] + dx
        y = (1 - a) * ys[i0] + a * ys[i1] + dy
        yaw = (1 - a) * yaws[i0] + a * yaws[i1] + dyaw
        odom[k] = [t, x, y, 0.0, 0.0, 0.0, yaw, 1.0]
        if drift_xy > 0:
            dx += rng.normal(scale=drift_xy * np.sqrt(dt))
            dy += rng.normal(scale=drift_xy * np.sqrt(dt))
        if drift_yaw > 0:
            dyaw += rng.normal(scale=drift_yaw * np.sqrt(dt))
    return odom


def generate_textured_sequence(
    n_frames: int = 300, width: int = 320, height: int = 240,
    motion: str = "square", seed: int = 0, fps: float = 10.0,
    odom_rate: float = 100.0, odom_drift_xy: float = 0.01,
    odom_drift_yaw: float = 0.002, room: tuple = (-3.0, 18.0, -8.0, 8.0),
    z_floor: float = -0.6, z_ceil: float = 1.4, n_pillars: int = 6,
    pixel_noise: float = 2.0, exposure_drift: float = 0.02,
    loops: float = 1.0, speed: float | None = None, device="cpu",
) -> SimSequence:
    """Render a textured closed-room sequence (ray cast on ``device``)."""
    rng = np.random.default_rng(seed)
    cam = default_camera(width, height)
    xs, ys, yaws = _trajectory(motion, n_frames, fps, room, loops, speed)
    # Odometry starts at identity: shift the world so pose 0 is the origin.
    x_off, y_off = float(xs[0]), float(ys[0])
    if x_off or y_off:
        if abs(yaws[0]) >= 1e-9:
            raise ValueError("trajectory must start with yaw 0")
        xs, ys = xs - x_off, ys - y_off
        room = (room[0] - x_off, room[1] - x_off, room[2] - y_off,
                room[3] - y_off)
    six = torch.tensor(np.stack([xs, ys, np.zeros_like(xs),
                                 np.zeros_like(xs), np.zeros_like(xs), yaws],
                                -1), dtype=torch.float32)
    poses = xyzrpy_to_mat(*six.unbind(-1)).numpy().astype(np.float32)
    planes = _make_world(rng, room, z_floor, z_ceil, n_pillars,
                         np.stack([xs, ys], -1))

    t_ri = cam.t_ri.numpy().astype(np.float64)
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    baseline = float(cam.baseline)
    origins = np.empty((n_frames, 2, 3), np.float64)
    rots = np.empty((n_frames, 3, 3), np.float64)
    for i in range(n_frames):
        t_wi = poses[i].astype(np.float64) @ t_ri
        rots[i] = t_wi[:3, :3]
        origins[i, 0] = t_wi[:3, 3]
        origins[i, 1] = t_wi[:3, 3] + rots[i] @ np.array([baseline, 0.0, 0.0])
    imgs = _render_views(planes, origins.reshape(-1, 3),
                         np.repeat(rots, 2, axis=0), fx, fy, cx, cy, width,
                         height, device)

    gain, bias = 1.0, 0.0
    lefts, rights = [], []
    for i in range(n_frames):
        for img, dst in ((imgs[2 * i], lefts), (imgs[2 * i + 1], rights)):
            out = (img * 175.0 + 35.0) * gain + bias
            if pixel_noise > 0:
                out = out + rng.normal(scale=pixel_noise, size=out.shape)
            dst.append(np.clip(out, 0.0, 255.0).astype(np.float32))
        if exposure_drift > 0:
            gain = float(np.clip(gain * np.exp(
                rng.normal(scale=exposure_drift)), 0.6, 1.6))
            bias = float(np.clip(bias + rng.normal(scale=exposure_drift * 40),
                                 -25.0, 25.0))

    stamps = np.arange(n_frames, dtype=np.float64) / fps
    odom = _wheel_odom_from_traj(xs, ys, yaws, n_frames, fps, odom_rate, rng,
                                 drift_xy=odom_drift_xy,
                                 drift_yaw=odom_drift_yaw)
    return SimSequence(left=np.stack(lefts), right=np.stack(rights),
                       stamps=stamps, poses=poses, wheel_odom=odom,
                       camera=cam)


_SIM_CACHE_TAG = "visfs_tpu_torch-sim-1"


def cached_textured_sequence(cache_dir=None, **kwargs) -> SimSequence:
    """generate_textured_sequence quantized to 8 bits (as a camera emits),
    with an npz cache under ``cache_dir`` (default $VISFS_SIM_CACHE or the
    temp dir).  ``device`` selects where the ray cast runs and is not part
    of the cache key."""
    device = kwargs.pop("device", "cpu")
    key = json.dumps({**kwargs, "_tag": _SIM_CACHE_TAG}, sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:20]
    cache_dir = cache_dir or os.environ.get(
        "VISFS_SIM_CACHE", os.path.join(tempfile.gettempdir(),
                                        "visfs_sim_cache"))
    path = os.path.join(cache_dir, f"torch_seq_{digest}.npz")
    cam = default_camera(kwargs.get("width", 320), kwargs.get("height", 240))
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return SimSequence(
                left=z["left"].astype(np.float32),
                right=z["right"].astype(np.float32), stamps=z["stamps"],
                poses=z["poses"], wheel_odom=z["wheel_odom"], camera=cam)
    seq = generate_textured_sequence(device=device, **kwargs)
    left = np.clip(seq.left, 0, 255).astype(np.uint8)
    right = np.clip(seq.right, 0, 255).astype(np.uint8)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, left=left, right=right, stamps=seq.stamps,
                        poses=seq.poses, wheel_odom=seq.wheel_odom)
    os.replace(tmp, path)
    return seq._replace(left=left.astype(np.float32),
                        right=right.astype(np.float32))


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Absolute trajectory error RMSE over translations (no alignment: both
    trajectories start at identity)."""
    d = est_poses[:, :3, 3] - gt_poses[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))
