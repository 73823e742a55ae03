"""The benchmark's scene: one closed lap of the reference bench's textured
square loop, and the trajectory error against its ground truth.

A frozen copy of ``visfs_tpu_torch.io.sim``'s textured-room generator (the
world from the numpy stream, the ray cast in float32 with its rounding
rules, the rounded-rectangle path) and of its ``ate_rmse``, so that a later
change to the port's simulator cannot move the yardstick.  It imports
nothing of the port: ``benchmark/tests/test_bench_scene.py`` holds its
noise-free views bit-equal to ``io.sim``'s at a small size.

What differs from ``generate_textured_sequence`` is what makes the loop a
lap that a stream can run round without end: the frame count and the speed
are chosen so that the path closes on a whole frame, and the exposure walk
is a bridge that ends where it began.  The pixel noise and the exposure are
drawn on the device from the run's seed, so a new seed needs no render.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import NamedTuple

import numpy as np
import torch

_TEX_OCTAVES = ((1.1, 0.34, False), (0.33, 0.33, False), (0.13, 0.33, True))
_T_MIN = 0.25  # nearest plane hit distance along the ray (m)
# Bumped whenever the render's arithmetic changes, so a stale cache misses.
_CACHE_TAG = "benchmark-scene-1"


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    width: int
    height: int


def camera(width: int, height: int) -> Camera:
    """The simulator's default stereo rig at this size."""
    return Camera(0.8 * width, 0.8 * width, width / 2, height / 2, 0.12,
                  int(width), int(height))


# image (x right, y down, z forward) -> robot (x forward, y left, z up)
T_RI = np.array([[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                 [0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])


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
    """Walls, floor, ceiling and pillar faces, in the simulator's RNG call
    order."""
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
    pillars = 0
    tries = 0
    while pillars < n_pillars and tries < 200:
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
        pillars += 1
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
    """a * b + c rounded once, by way of float64 (the simulator's rule: the
    texture cells are discontinuous in the hit coordinates)."""
    return (a.double() * b.double() + c.double()).float()


def render_views(planes, origins, rots, cam: Camera, device) -> torch.Tensor:
    """Ray-cast V views -> float32 images [V, H, W] in [0, 1] on
    ``device`` (0 where no plane is hit)."""
    f32 = dict(dtype=torch.float32, device=device)
    width, height = cam.width, cam.height

    def stack(attr):
        return torch.tensor(np.stack([getattr(p, attr) for p in planes]),
                            **f32)

    p0, nrm, e1, e2 = stack("p0"), stack("n"), stack("e1"), stack("e2")
    uvb = torch.tensor(np.stack([[p.u0, p.u1, p.v0, p.v1] for p in planes]),
                       **f32)
    grids = torch.tensor(np.stack([p.grid for p in planes]), **f32)
    S = grids.shape[1]
    flat_grids = grids.reshape(-1)
    us = (torch.arange(width, **f32) - float(np.float32(cam.cx))) \
        / float(np.float32(cam.fx))
    vs = (torch.arange(height, **f32) - float(np.float32(cam.cy))) \
        / float(np.float32(cam.fy))
    d_img = torch.stack([us[None, :].expand(height, width).reshape(-1),
                         vs[:, None].expand(height, width).reshape(-1),
                         torch.ones(width * height, **f32)], dim=-1)
    o_all = torch.tensor(origins, **f32)
    r_all = torch.tensor(rots, **f32)
    out = torch.empty((len(origins), height, width), **f32)
    for v in range(len(origins)):
        o = o_all[v]
        d_w = _mm(d_img, r_all[v].T)
        denom = _mm(d_w, nrm.T)
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

        tex = None
        for k, (cell, wgt, sharp) in enumerate(_TEX_OCTAVES):
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
        out[v] = torch.where(hit, tex, torch.zeros_like(tex)).reshape(
            height, width)
    return out


def _square_path(room, margin=4.0, corner_radius=1.5):
    """Rounded-rectangle loop inset ``margin`` from the room walls:
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


def straight_starts(room, n_frames: int, speed: float, fps: float,
                    lead: int) -> np.ndarray:
    """The lap frames that lie on a straight piece of the path with at
    least ``lead`` more frames of it ahead: where a stream can start, with
    no motion prior yet, and have one before its first corner."""
    x0, x1, y0, y1 = room
    r, margin = 1.5, 4.0
    lw = (x1 - x0 - 2 * margin) - 2 * r
    lh = (y1 - y0 - 2 * margin) - 2 * r
    arc = 0.5 * np.pi * r
    step = speed / fps
    straights, s0 = [], 0.0
    for length in (lw, lh, lw, lh):  # each followed by a quarter circle
        straights.append((s0, s0 + length))
        s0 += length + arc
    frames = [k for k in range(n_frames)
              if any(a <= k * step and (k + lead) * step <= b
                     for a, b in straights)]
    return np.asarray(frames)


def lap_frames(room, step: float) -> tuple:
    """(frames, speed at 10 fps) of a lap of the square path at about
    ``step`` metres a frame that closes on a whole frame."""
    total, _ = _square_path(room)
    n = int(round(total / step))
    return n, total * 10.0 / n


def _poses_from_xyyaw(xs, ys, yaws):
    """[T, 4, 4] float32 planar poses from float32 (x, y, yaw), with the
    simulator's float32 arithmetic (roll = pitch = 0)."""
    x, y, yaw = (torch.tensor(np.asarray(a, np.float64), dtype=torch.float32)
                 for a in (xs, ys, yaws))
    zero = torch.zeros_like(x)
    cr, sr = torch.cos(zero), torch.sin(zero)
    cp, sp = torch.cos(zero), torch.sin(zero)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    R = torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                    dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                    dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1)], dim=-2)
    T = torch.zeros((len(x), 4, 4), dtype=torch.float32)
    T[:, :3, :3] = R
    T[:, :3, 3] = torch.stack([x, y, zero], dim=-1)
    T[:, 3, 3] = 1.0
    return T.numpy()


class Lap(NamedTuple):
    poses: np.ndarray  # [T, 4, 4] float32 ground-truth robot poses Twr
    planes: list
    origins: np.ndarray  # [T, 2, 3] left and right view origins
    rots: np.ndarray  # [T, 3, 3]
    camera: Camera


def lap_geometry(n_frames, speed, width, height, world_seed=0,
                 room=(-3.0, 18.0, -8.0, 8.0), z_floor=-0.6, z_ceil=1.4,
                 n_pillars=6, fps=10.0) -> Lap:
    """The square loop's trajectory (shifted so pose 0 is the origin), the
    world drawn from ``world_seed`` and each frame's two view origins."""
    cam = camera(width, height)
    ts = np.arange(n_frames) / fps
    _, point = _square_path(room)
    xyy = np.array([point(speed * t) for t in ts])
    xs, ys, yaws = xyy[:, 0], xyy[:, 1], xyy[:, 2]
    x_off, y_off = float(xs[0]), float(ys[0])
    xs, ys = xs - x_off, ys - y_off
    room = (room[0] - x_off, room[1] - x_off, room[2] - y_off,
            room[3] - y_off)
    poses = _poses_from_xyyaw(xs, ys, yaws)
    rng = np.random.default_rng(world_seed)
    planes = _make_world(rng, room, z_floor, z_ceil, n_pillars,
                         np.stack([xs, ys], -1))
    origins = np.empty((n_frames, 2, 3), np.float64)
    rots = np.empty((n_frames, 3, 3), np.float64)
    for i in range(n_frames):
        t_wi = poses[i].astype(np.float64) @ T_RI
        rots[i] = t_wi[:3, :3]
        origins[i, 0] = t_wi[:3, 3]
        origins[i, 1] = t_wi[:3, 3] + rots[i] @ np.array([cam.baseline, 0, 0])
    return Lap(poses, planes, origins, rots, cam)


def lap_views(lap: Lap, device, cache_dir: str | None = None,
              key: dict | None = None) -> torch.Tensor:
    """The lap's noise-free views [T, 2, H, W] (float32 in [0, 1]) on
    ``device``; with ``cache_dir``, read from (or rendered once into) a
    file there named by the hash of ``key``."""
    T = len(lap.poses)
    cam = lap.camera
    path = None
    if cache_dir is not None:
        blob = json.dumps({**(key or {}), "_tag": _CACHE_TAG}, sort_keys=True)
        path = os.path.join(cache_dir, "views_" + hashlib.sha256(
            blob.encode()).hexdigest()[:20] + ".npy")
        if os.path.exists(path):
            return torch.from_numpy(np.load(path)).to(device)
    views = render_views(lap.planes, lap.origins.reshape(-1, 3),
                         np.repeat(lap.rots, 2, axis=0), cam, device)
    views = views.reshape(T, 2, cam.height, cam.width)
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp.npy"
        np.save(tmp, views.cpu().numpy())
        os.replace(tmp, path)
    return views


def ray_depth(lap: Lap, frames, side: int, uv) -> torch.Tensor:
    """The true depth (m along the camera's z) of pixels uv [N, 2] (x, y)
    in view ``side`` (0 left, 1 right) of lap frames [N], by casting each
    pixel's ray against the world's planes in float64 (inf where no plane
    is hit)."""
    dev = uv.device
    f64 = dict(dtype=torch.float64, device=dev)
    planes = lap.planes

    def stack(attr):
        return torch.tensor(np.stack([getattr(p, attr) for p in planes]),
                            **f64)

    p0, nrm, e1, e2 = stack("p0"), stack("n"), stack("e1"), stack("e2")
    uvb = torch.tensor([[p.u0, p.u1, p.v0, p.v1] for p in planes], **f64)
    cam = lap.camera
    fr = torch.as_tensor(frames, device=dev).long()
    o = torch.as_tensor(lap.origins, **f64)[fr, side]  # [N, 3]
    rot = torch.as_tensor(lap.rots, **f64)[fr]  # [N, 3, 3]
    uv = uv.to(torch.float64)
    d_img = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                         (uv[:, 1] - cam.cy) / cam.fy,
                         torch.ones_like(uv[:, 0])], -1)
    d_w = torch.einsum("nij,nj->ni", rot, d_img)  # z component of d_img 1
    denom = d_w @ nrm.T  # [N, P]
    t_num = torch.einsum("pk,pk->p", p0, nrm)[None] - o @ nrm.T
    nz = denom.abs() > 1e-12
    t = torch.where(nz, t_num / torch.where(nz, denom, torch.ones_like(
        denom)), torch.full_like(denom, -1.0))
    rel = o[:, None, :] - p0[None]  # [N, P, 3]
    uu = t * (d_w @ e1.T) + torch.einsum("npk,pk->np", rel, e1)
    vv = t * (d_w @ e2.T) + torch.einsum("npk,pk->np", rel, e2)
    valid = (nz & (t > _T_MIN) & (uu >= uvb[:, 0]) & (uu <= uvb[:, 1])
             & (vv >= uvb[:, 2]) & (vv <= uvb[:, 3]))
    return torch.where(valid, t, torch.full_like(t, float("inf"))).amin(1)


def project(lap: Lap, frames, side: int, points) -> torch.Tensor:
    """World points [N, 3] in view ``side`` of lap frames [N]: pixels [N,
    2] and depth [N] (float64)."""
    dev = points.device
    fr = torch.as_tensor(frames, device=dev).long()
    o = torch.as_tensor(lap.origins, dtype=torch.float64, device=dev)[fr,
                                                                    side]
    rot = torch.as_tensor(lap.rots, dtype=torch.float64, device=dev)[fr]
    p = torch.einsum("nji,nj->ni", rot, points.to(torch.float64) - o)
    cam = lap.camera
    z = p[:, 2]
    return torch.stack([cam.fx * p[:, 0] / z + cam.cx,
                        cam.fy * p[:, 1] / z + cam.cy], -1), z


def unproject(lap: Lap, frames, side: int, uv, depth) -> torch.Tensor:
    """Pixels uv [N, 2] at depth [N] in view ``side`` of lap frames [N]:
    world points [N, 3] (float64)."""
    dev = uv.device
    fr = torch.as_tensor(frames, device=dev).long()
    o = torch.as_tensor(lap.origins, dtype=torch.float64, device=dev)[fr,
                                                                    side]
    rot = torch.as_tensor(lap.rots, dtype=torch.float64, device=dev)[fr]
    cam = lap.camera
    uv = uv.to(torch.float64)
    z = depth.to(torch.float64)
    p = torch.stack([(uv[:, 0] - cam.cx) / cam.fx * z,
                     (uv[:, 1] - cam.cy) / cam.fy * z, z], -1)
    return o + torch.einsum("nij,nj->ni", rot, p)


def _bridge(gen, n, scale, device):
    """A random walk of n steps of N(0, scale) that returns to 0: the value
    before each step, starting at 0 (the steps less their mean)."""
    steps = torch.randn(n, generator=gen, device=device,
                        dtype=torch.float64) * scale
    steps = steps - steps.mean()
    return torch.cat([torch.zeros(1, dtype=torch.float64, device=device),
                      torch.cumsum(steps, 0)[:-1]])


def lap_images(views: torch.Tensor, seed: int, pixel_noise: float,
               exposure_drift: float) -> torch.Tensor:
    """The camera's images of the lap for ``seed`` [T, 2, H, W] float32 in
    [0, 255]: the simulator's (view * 175 + 35) * gain + bias + noise,
    clipped, with the gain's log and the bias random-walk bridges drawn on
    the views' device (gain kept in [0.6, 1.6], bias in [-25, 25])."""
    device = views.device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    T = views.shape[0]
    gain = torch.clamp(torch.exp(_bridge(gen, T, exposure_drift, device)),
                       0.6, 1.6).float()
    bias = torch.clamp(_bridge(gen, T, exposure_drift * 40, device),
                       -25.0, 25.0).float()
    out = torch.empty_like(views)
    for i in range(T):
        noise = torch.randn(views.shape[1:], generator=gen, device=device)
        out[i] = torch.clamp((views[i] * 175.0 + 35.0) * gain[i] + bias[i]
                             + noise * pixel_noise, 0.0, 255.0)
    return out


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Absolute trajectory error RMSE over translations (no alignment: both
    trajectories start at identity)."""
    d = est_poses[:, :3, 3] - gt_poses[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def _relative(poses: np.ndarray) -> np.ndarray:
    """Poses relative to the first: P0^-1 P_i (float64)."""
    p = poses.astype(np.float64)
    return np.linalg.inv(p[0])[None] @ p


def span_ate(est_poses: np.ndarray, gt_poses: np.ndarray, span: int) -> float:
    """The largest ``ate_rmse`` over spans of ``span`` frames, each span's
    trajectories taken relative to its first pose: spans start every
    ``span // 2`` frames, so that they overlap by half and every two
    neighbouring frames share one, and a last span ends at the last frame
    (one span of every frame where there are no more).  Drift is judged
    per span, so a run that reaches more frames is not failed for the
    distance it covers."""
    n = len(est_poses)
    if n <= span:
        starts, length = [0], n
    else:
        starts, length = list(range(0, n - span + 1, max(1, span // 2))), span
        if starts[-1] != n - span:
            starts.append(n - span)
    return max(ate_rmse(_relative(est_poses[s:s + length]),
                        _relative(gt_poses[s:s + length])) for s in starts)
