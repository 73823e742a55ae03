"""Synthetic stereo sequences with exact ground truth (torch port of
visfs_tpu.io.sim).

Two generators.  ``generate_sequence`` renders a rigid 3D "starfield" of
Gaussian splats through the stereo rig on the host (numpy), with a splatted
depth map (``with_depth``, the RGBD input) and 2D scans of a rectangular
room (``with_laser``).  ``generate_textured_sequence`` ray-casts a closed
rectangular room (walls, floor, ceiling) plus pillars, all with multi-octave
value-noise textures, through the stereo rig on the given device, with the
left view's z-depth where a ray hits (``with_depth``).  Exposure drift,
pixel noise, wheel odometry and the scans come from the same numpy random
stream, drawn in the reference's call order, so a seed gives the
reference's sequence.
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
    laser_scans: np.ndarray | None = None  # [T, n_beams, 3] robot frame
    room: tuple | None = None  # (x0, x1, y0, y1) walls, with laser scans
    points: np.ndarray | None = None  # [M, 3] starfield world points
    depth: np.ndarray | None = None  # [T, H, W] left z-depth (m), 0 = none


def default_camera(width=320, height=240, device="cuda"):
    return make_stereo_camera(
        fx=0.8 * width, fy=0.8 * width, cx=width / 2, cy=height / 2,
        baseline=0.12, width=width, height=height, device=device)


# --- the starfield (numpy on the host, as the reference renders it) -------

_SPLAT_RAD = 3
_Z_NEAR = 0.25  # projections nearer than this along the optical axis drop


def _drawn(u, v, z, width, height, rad=_SPLAT_RAD):
    """Whether a splat of radius rad at (u, v), depth z, is drawn."""
    return z > _Z_NEAR and rad <= u < width - rad and rad <= v < height - rad


def _render(points_cam, intensities, width, height, splat_sigma=0.9):
    """Gaussian splats at the projections (u, v, z) [M, 3], in [0, 255]."""
    img = np.zeros((height, width), dtype=np.float32)
    rad = _SPLAT_RAD
    for (u, v, z), inten in zip(points_cam, intensities):
        if not _drawn(u, v, z, width, height):
            continue
        iu, iv = int(u), int(v)
        ys = np.arange(iv - rad, iv + rad + 1)
        xs = np.arange(iu - rad, iu + rad + 1)
        gy = np.exp(-((ys - v) ** 2) / (2 * splat_sigma ** 2))
        gx = np.exp(-((xs - u) ** 2) / (2 * splat_sigma ** 2))
        img[np.ix_(ys, xs)] += inten * np.outer(gy, gx)
    return np.clip(img, 0.0, 255.0)


def _render_depth(points_cam, width, height, rad=_SPLAT_RAD):
    """z written on the (2 rad + 1)^2 square around each projection, the
    nearest winning; 0 where no splat lands."""
    depth = np.zeros((height, width), dtype=np.float32)
    for u, v, z in points_cam:
        if not _drawn(u, v, z, width, height, rad):
            continue
        iu, iv = int(u), int(v)
        patch = depth[iv - rad:iv + rad + 1, iu - rad:iu + rad + 1]
        patch[(patch == 0) | (patch > z)] = z
    return depth


def _poses_from_xyyaw(xs, ys, yaws):
    """[T, 4, 4] float32 planar poses from float32-rounded (x, y, yaw)."""
    zero = np.zeros_like(np.asarray(xs, np.float64))
    six = torch.tensor(np.stack([xs, ys, zero, zero, zero, yaws], -1),
                       dtype=torch.float32)
    return xyzrpy_to_mat(*six.unbind(-1)).numpy().astype(np.float32)


def generate_sequence(
    n_frames: int = 30, n_points: int = 600, width: int = 320,
    height: int = 240, motion: str = "arc", seed: int = 0,
    fps: float = 10.0, odom_rate: float = 100.0, odom_noise: float = 0.0,
    with_laser: bool = False, n_beams: int = 180,
    room: tuple = (-3.0, 18.0, -8.0, 8.0), laser_noise: float = 0.0,
    with_depth: bool = False, device="cuda",
) -> SimSequence:
    """A stereo sequence of a robot moving through a starfield of n_points
    splats; motion 'arc' (forward and turning), 'forward' or 'yaw'
    (rotation in place).  The camera lives on ``device``; the rendering,
    odometry and scans are numpy.  with_depth adds the left view's splatted
    depth, with_laser an n_beams scan a frame of the walls of ``room``."""
    rng = np.random.default_rng(seed)
    cam = default_camera(width, height, device)
    points = np.stack([rng.uniform(1.0, 14.0, n_points),
                       rng.uniform(-7.0, 7.0, n_points),
                       rng.uniform(-2.5, 2.5, n_points)],
                      axis=-1).astype(np.float32)
    intensities = rng.uniform(90.0, 230.0, n_points).astype(np.float32)

    t = np.arange(n_frames) / fps
    if motion == "forward":
        xs, ys, yaws = 0.35 * t, 0.0 * t, 0.0 * t
    elif motion == "yaw":
        xs, ys, yaws = 0.0 * t, 0.0 * t, 0.25 * t
    else:  # arc
        xs, ys, yaws = 0.35 * t, 0.08 * t * t * 0.5, 0.08 * t
    poses = _poses_from_xyyaw(xs, ys, yaws)

    t_ir = cam.t_ir.cpu().numpy()
    baseline = float(cam.baseline)
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    lefts, rights, depths = [], [], []
    for i in range(n_frames):
        t_rw = np.linalg.inv(poses[i])  # world -> robot
        p_robot = (t_rw[:3, :3] @ points.T).T + t_rw[:3, 3]
        p_img = (t_ir[:3, :3] @ p_robot.T).T + t_ir[:3, 3]
        z = p_img[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            ul = p_img[:, 0] / z * fx + cx
            vl = p_img[:, 1] / z * fy + cy
            ur = (p_img[:, 0] - baseline) / z * fx + cx
        left_uvz = np.stack([ul, vl, z], -1)
        lefts.append(_render(left_uvz, intensities, width, height))
        rights.append(_render(np.stack([ur, vl, z], -1), intensities, width,
                              height))
        if with_depth:
            depths.append(_render_depth(left_uvz, width, height))

    stamps = np.arange(n_frames, dtype=np.float64) / fps
    # Wheel odometry: (x, y, yaw) interpolated linearly between frames.
    n_odom = int(np.ceil(n_frames / fps * odom_rate)) + 2
    odom = np.zeros((n_odom, 8), dtype=np.float64)

    def xyyaw(T):
        return np.array([T[0, 3], T[1, 3], np.arctan2(T[1, 0], T[0, 0])])

    for k in range(n_odom):
        tk = k / odom_rate
        tf = min(tk * fps, n_frames - 1)
        i0 = int(np.floor(tf))
        i1 = min(i0 + 1, n_frames - 1)
        a = tf - i0
        s = (1 - a) * xyyaw(poses[i0]) + a * xyyaw(poses[i1])
        if odom_noise > 0:
            s += rng.normal(scale=odom_noise, size=3)
        odom[k] = [tk, s[0], s[1], 0.0, 0.0, 0.0, s[2], 1.0]

    laser_scans = None
    if with_laser:
        laser_scans = np.stack([
            _scan_world(poses[i], room, (), n_beams, rng, laser_noise)
            for i in range(n_frames)])
    return SimSequence(
        left=np.stack(lefts), right=np.stack(rights), stamps=stamps,
        poses=poses, wheel_odom=odom, camera=cam, laser_scans=laser_scans,
        room=room if with_laser else None, points=points,
        depth=np.stack(depths) if with_depth else None)


# --- the textured room -------------------------------------------------------

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
    """Walls, floor, ceiling and pillar faces (reference RNG call order),
    and the pillars' AABBs (x0, x1, y0, y1) for the laser."""
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
    pillars = []
    tries = 0
    while len(pillars) < n_pillars and tries < 200:
        tries += 1
        cx = rng.uniform(x0 + 2.0, x1 - 2.0)
        cy = rng.uniform(y0 + 1.5, y1 - 1.5)
        w = rng.uniform(0.4, 0.9)
        h = rng.uniform(0.4, 0.9)
        d = np.hypot(traj_xy[:, 0] - cx, traj_xy[:, 1] - cy)
        if d.min() < 1.2 + max(w, h):
            continue
        bx0, bx1 = cx - w / 2, cx + w / 2
        by0, by1 = cy - h / 2, cy + h / 2
        pillars.append((bx0, bx1, by0, by1))
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
    return planes, pillars


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
    """Ray-cast V views on ``device`` -> (images [V, H, W] in [0, 1], z-depth
    [V, H, W], 0 where no plane is hit): float32 renders, returned as
    float64 numpy like the reference's.  The pixel directions have z = 1,
    so a hit's ray parameter is its depth."""
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
    deps = np.empty((len(origins), height, width), np.float64)
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

        # Each octave's value x_k, then the weighted sum, rounded where the
        # reference's compiled program fuses a product into a sum (a
        # difference of an ulp moves an 8-bit pixel where it lies near a
        # level): a = fma(g10, fu, g00 (1 - fu)), likewise b, x = fma(a,
        # 1 - fv, b fv); tex = fma(w0, x0, w1 x1), then fma(w_k, x_k, tex).
        tex = None
        for k, (cell, wgt, sharp) in enumerate(_TEX_OCTAVES):
            # The constant cell size divides as a product with its float32
            # reciprocal there; a true quotient differs by an ulp, and the
            # floor turns that into another texture cell.
            recip = float(np.float32(1.0) / np.float32(cell))
            gu = uu_w * recip
            gv = vv_w * recip
            iu = torch.floor(gu)
            iv = torch.floor(gv)
            iu_i, iv_i = iu.to(torch.int64), iv.to(torch.int64)
            if sharp:
                x = pick(iu_i, iv_i)
            else:
                fu, fv = gu - iu, gv - iv
                a = _fma(pick(iu_i + 1, iv_i), fu, pick(iu_i, iv_i) * (1 - fu))
                b = _fma(pick(iu_i + 1, iv_i + 1), fu,
                         pick(iu_i, iv_i + 1) * (1 - fu))
                x = _fma(a, 1 - fv, b * fv)
            w = torch.full_like(x, float(np.float32(wgt)))
            if k == 0:
                first = (w, x)
            elif k == 1:
                tex = _fma(*first, w * x)
            else:
                tex = _fma(w, x, tex)
        hit = torch.isfinite(best_t)
        img = torch.where(hit, tex, torch.zeros_like(tex))
        dep = torch.where(hit, best_t, torch.zeros_like(best_t))
        out[v] = img.reshape(height, width).cpu().numpy()
        deps[v] = dep.reshape(height, width).cpu().numpy()
    return out, deps


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


def _scan_world(pose, room, pillars, n_beams, rng, noise=0.0):
    """2D laser scan of the room walls + pillar AABBs (robot frame), in
    numpy as the reference computes it."""
    x0, x1, y0, y1 = room
    px, py = pose[0, 3], pose[1, 3]
    yaw = np.arctan2(pose[1, 0], pose[0, 0])
    angles = np.linspace(-np.pi, np.pi, n_beams, endpoint=False)
    world_ang = angles + yaw
    dx = np.cos(world_ang)
    dy = np.sin(world_ang)
    with np.errstate(divide="ignore", invalid="ignore"):
        tx = np.where(dx > 0, (x1 - px) / dx,
                      np.where(dx < 0, (x0 - px) / dx, np.inf))
        ty = np.where(dy > 0, (y1 - py) / dy,
                      np.where(dy < 0, (y0 - py) / dy, np.inf))
        t = np.minimum(tx, ty)
        for (bx0, bx1, by0, by1) in pillars:
            t1x = (bx0 - px) / np.where(dx == 0, 1e-12, dx)
            t2x = (bx1 - px) / np.where(dx == 0, 1e-12, dx)
            t1y = (by0 - py) / np.where(dy == 0, 1e-12, dy)
            t2y = (by1 - py) / np.where(dy == 0, 1e-12, dy)
            tnear = np.maximum(np.minimum(t1x, t2x), np.minimum(t1y, t2y))
            tfar = np.minimum(np.maximum(t1x, t2x), np.maximum(t1y, t2y))
            hit = (tnear <= tfar) & (tnear > 0)
            t = np.where(hit, np.minimum(t, tnear), t)
    if noise > 0:
        t = t + rng.normal(scale=noise, size=t.shape)
    rx = t * np.cos(angles)
    ry = t * np.sin(angles)
    return np.stack([rx, ry, np.zeros_like(rx)], axis=-1).astype(np.float32)


def _room_views(rng, cam, n_frames, fps, room, z_floor, z_ceil, n_pillars,
                motion, loops, speed):
    """The textured room's trajectory (shifted so pose 0 is the origin), its
    planes and pillars (drawn from rng) and each frame's two view origins
    and rotations: (xs, ys, yaws, room, poses, planes, pillars, origins
    [T, 2, 3], rots [T, 3, 3])."""
    xs, ys, yaws = _trajectory(motion, n_frames, fps, room, loops, speed)
    # Odometry starts at identity: shift the world so pose 0 is the origin.
    x_off, y_off = float(xs[0]), float(ys[0])
    if x_off or y_off:
        if abs(yaws[0]) >= 1e-9:
            raise ValueError("trajectory must start with yaw 0")
        xs, ys = xs - x_off, ys - y_off
        room = (room[0] - x_off, room[1] - x_off, room[2] - y_off,
                room[3] - y_off)
    poses = _poses_from_xyyaw(xs, ys, yaws)
    planes, pillars = _make_world(rng, room, z_floor, z_ceil, n_pillars,
                                  np.stack([xs, ys], -1))

    t_ri = cam.t_ri.cpu().numpy().astype(np.float64)
    baseline = float(cam.baseline)
    origins = np.empty((n_frames, 2, 3), np.float64)
    rots = np.empty((n_frames, 3, 3), np.float64)
    for i in range(n_frames):
        t_wi = poses[i].astype(np.float64) @ t_ri
        rots[i] = t_wi[:3, :3]
        origins[i, 0] = t_wi[:3, 3]
        origins[i, 1] = t_wi[:3, 3] + rots[i] @ np.array([baseline, 0.0, 0.0])
    return xs, ys, yaws, room, poses, planes, pillars, origins, rots


def render_textured_views(
    frames, n_frames: int = 300, width: int = 320, height: int = 240,
    motion: str = "square", seed: int = 0, fps: float = 10.0,
    room: tuple = (-3.0, 18.0, -8.0, 8.0), z_floor: float = -0.6,
    z_ceil: float = 1.4, n_pillars: int = 6, loops: float = 1.0,
    speed: float | None = None, with_laser: bool = False, n_beams: int = 180,
    laser_noise: float = 0.0, device="cuda",
):
    """The ray casts and scans of generate_textured_sequence's frames
    ``frames`` on ``device``, before exposure, pixel noise and quantization
    (host numpy, the same on every device): (views [F, 2, H, W] in [0, 1]
    as float64 of the float32 render, left z-depth [F, H, W], scans [F,
    n_beams, 3] or None).  Noisy scans draw from the stream after the
    images' noise, so laser_noise must be 0."""
    if with_laser and laser_noise:
        raise ValueError("render_textured_views: laser_noise must be 0")
    rng = np.random.default_rng(seed)
    cam = default_camera(width, height, device)
    _, _, _, room, poses, planes, pillars, origins, rots = _room_views(
        rng, cam, n_frames, fps, room, z_floor, z_ceil, n_pillars, motion,
        loops, speed)
    frames = list(frames)
    imgs, deps = _render_views(planes, origins[frames].reshape(-1, 3),
                               np.repeat(rots[frames], 2, axis=0),
                               float(cam.fx), float(cam.fy), float(cam.cx),
                               float(cam.cy), width, height, device)
    scans = None
    if with_laser:
        scans = np.stack([_scan_world(poses[i], room, pillars, n_beams, rng)
                          for i in frames])
    return (imgs.reshape(len(frames), 2, height, width),
            deps[0::2].astype(np.float32), scans)


def generate_textured_sequence(
    n_frames: int = 300, width: int = 320, height: int = 240,
    motion: str = "square", seed: int = 0, fps: float = 10.0,
    odom_rate: float = 100.0, odom_drift_xy: float = 0.01,
    odom_drift_yaw: float = 0.002, room: tuple = (-3.0, 18.0, -8.0, 8.0),
    z_floor: float = -0.6, z_ceil: float = 1.4, n_pillars: int = 6,
    pixel_noise: float = 2.0, exposure_drift: float = 0.02,
    loops: float = 1.0, speed: float | None = None, with_laser: bool = False,
    n_beams: int = 180, laser_noise: float = 0.0, with_depth: bool = False,
    device="cuda",
) -> SimSequence:
    """Render a textured closed-room sequence (ray cast on ``device``, where
    the returned camera lives too); with_laser adds an n_beams 2D scan a
    frame of the walls and pillars, drawn after the wheel odometry;
    with_depth the left view's z-depth (float32 m, 0 where no plane is
    hit)."""
    rng = np.random.default_rng(seed)
    cam = default_camera(width, height, device)
    xs, ys, yaws, room, poses, planes, pillars, origins, rots = _room_views(
        rng, cam, n_frames, fps, room, z_floor, z_ceil, n_pillars, motion,
        loops, speed)
    imgs, deps = _render_views(planes, origins.reshape(-1, 3),
                               np.repeat(rots, 2, axis=0), float(cam.fx),
                               float(cam.fy), float(cam.cx), float(cam.cy),
                               width, height, device)

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
    laser_scans = None
    if with_laser:
        laser_scans = np.stack([
            _scan_world(poses[i], room, pillars, n_beams, rng, laser_noise)
            for i in range(n_frames)])
    return SimSequence(left=np.stack(lefts), right=np.stack(rights),
                       stamps=stamps, poses=poses, wheel_odom=odom,
                       camera=cam, laser_scans=laser_scans,
                       room=room if with_laser else None,
                       points=np.zeros((0, 3), np.float32),
                       depth=(deps[0::2].astype(np.float32) if with_depth
                              else None))


_SIM_CACHE_TAG = "visfs_tpu_torch-sim-3"  # 3: depth (and the VGA rounding)


def sim_cache_file(cache_dir=None, **kwargs) -> str:
    """The npz file of cached_textured_sequence's cache (under
    ``cache_dir``, default $VISFS_SIM_CACHE or the temp dir) that holds
    these arguments' sequence (``device`` aside); it need not exist yet."""
    kwargs.pop("device", None)
    key = json.dumps({**kwargs, "_tag": _SIM_CACHE_TAG}, sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:20]
    cache_dir = cache_dir or os.environ.get(
        "VISFS_SIM_CACHE", os.path.join(tempfile.gettempdir(),
                                        "visfs_sim_cache"))
    return os.path.join(cache_dir, f"torch_seq_{digest}.npz")


def cached_textured_sequence(cache_dir=None, **kwargs) -> SimSequence:
    """generate_textured_sequence quantized to 8 bits (as a camera emits),
    with an npz cache (sim_cache_file).  ``device`` (default "cuda")
    selects where the ray cast runs and the camera lives, and is not part
    of the cache key."""
    device = kwargs.pop("device", "cuda")
    path = sim_cache_file(cache_dir, **kwargs)
    cam = default_camera(kwargs.get("width", 320), kwargs.get("height", 240),
                         device)
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return SimSequence(
                left=z["left"].astype(np.float32),
                right=z["right"].astype(np.float32), stamps=z["stamps"],
                poses=z["poses"], wheel_odom=z["wheel_odom"], camera=cam,
                laser_scans=z["laser_scans"] if "laser_scans" in z else None,
                room=tuple(z["room"]) if "room" in z else None,
                points=z["points"],
                depth=z["depth"] if "depth" in z else None)
    seq = generate_textured_sequence(device=device, **kwargs)
    left = np.clip(seq.left, 0, 255).astype(np.uint8)
    right = np.clip(seq.right, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    extra = {} if seq.laser_scans is None else dict(
        laser_scans=seq.laser_scans, room=np.asarray(seq.room))
    if seq.depth is not None:  # float32 metres, not quantized
        extra["depth"] = seq.depth
    # uncompressed: compressing a VGA sequence with its depth takes seconds,
    # and the cache serves one run's phases
    np.savez(tmp, left=left, right=right, stamps=seq.stamps,
             poses=seq.poses, wheel_odom=seq.wheel_odom, points=seq.points,
             **extra)
    os.replace(tmp, path)
    return seq._replace(left=left.astype(np.float32),
                        right=right.astype(np.float32))


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Absolute trajectory error RMSE over translations (no alignment: both
    trajectories start at identity)."""
    d = est_poses[:, :3, 3] - gt_poses[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))
