"""Pinhole stereo camera model (torch port of visfs_tpu.core.camera).

The fixed image->robot axis permutation R_ri = [[0,0,1],[-1,0,0],[0,-1,0]]
maps camera axes (x right, y down, z forward) into robot axes (x forward,
y left, z up), as in the reference GeometricCamera constructor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import mat_inv_se3


def image_to_robot_transform(dtype=torch.float32, device=None):
    T = torch.eye(4, dtype=dtype, device=device)
    T[:3, :3] = torch.tensor(
        [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], dtype=dtype,
        device=device)
    return T


class StereoCamera(NamedTuple):
    """Rectified pinhole stereo pair; intrinsics are 0-d float32 tensors on
    the camera's device, t_ri the 4x4 image->robot transform and t_ir its
    inverse (kept so the step does not rebuild it)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    fxr: torch.Tensor
    fyr: torch.Tensor
    cxr: torch.Tensor
    cyr: torch.Tensor
    baseline: torch.Tensor
    t_ri: torch.Tensor
    t_ir: torch.Tensor
    width: int
    height: int

    @property
    def bf(self):
        return self.baseline * self.fx


def make_stereo_camera(fx, fy, cx, cy, baseline, *, fxr=None, fyr=None,
                       cxr=None, cyr=None, t_camera_to_robot=None, width=640,
                       height=480, dtype=torch.float32,
                       device="cuda") -> StereoCamera:
    """Build a StereoCamera on ``device``; mirrors System::init."""
    def f(v):
        return torch.as_tensor(v, dtype=dtype).to(device)

    t_ri = image_to_robot_transform(dtype, device)
    if t_camera_to_robot is not None:
        t_ri = f(t_camera_to_robot) @ t_ri
    return StereoCamera(
        fx=f(fx), fy=f(fy), cx=f(cx), cy=f(cy),
        fxr=f(fxr if fxr is not None else fx),
        fyr=f(fyr if fyr is not None else fy),
        cxr=f(cxr if cxr is not None else cx),
        cyr=f(cyr if cyr is not None else cy),
        baseline=f(baseline), t_ri=t_ri, t_ir=mat_inv_se3(t_ri),
        width=int(width), height=int(height),
    )


def project(cam: StereoCamera, p_img):
    """Image-frame 3D points [..., 3] -> left pixels (u, v)."""
    z = p_img[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = p_img[..., 0] * inv_z * cam.fx + cam.cx
    v = p_img[..., 1] * inv_z * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: StereoCamera, p_img):
    """-> (uL, vL, uR) with uR = uL - bf/z (OptimizeTypeDefine.h:180-187)."""
    z = p_img[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = p_img[..., 0] * inv_z * cam.fx + cam.cx
    v = p_img[..., 1] * inv_z * cam.fy + cam.cy
    return torch.stack([u, v, u - cam.bf * inv_z], dim=-1)


def disparity_to_3d(cam: StereoCamera, uv, disparity):
    """Left pixel + disparity -> image-frame 3D point; NaN where invalid
    (projectDisparityTo3D, MultiviewGeometry.cpp:78-92)."""
    denom = disparity + (cam.cxr - cam.cx)
    valid = (disparity > 0.0) & (cam.baseline > 0.0) \
        & (torch.abs(denom) > 1e-9)
    W = cam.baseline / torch.where(valid, denom, torch.ones_like(denom))
    p = torch.stack([(uv[..., 0] - cam.cx) * W, (uv[..., 1] - cam.cy) * W,
                     cam.fx * W], dim=-1)
    nan = torch.full_like(p, float("nan"))
    return torch.where(valid[..., None], p, nan), valid


def triangulate_stereo(cam: StereoCamera, uv_left, uv_right, min_depth: float,
                       max_depth: float):
    """Batched stereo triangulation -> ([N,3] robot-frame points, [N] valid)
    with the reference's depth gates (generateKeyPoints3DStereo)."""
    p_img, valid = disparity_to_3d(cam, uv_left,
                                   uv_left[..., 0] - uv_right[..., 0])
    z = p_img[..., 2]
    if min_depth >= 0.0:
        valid = valid & (z > min_depth)
    if max_depth > 0.0:
        valid = valid & (z <= max_depth)
    valid = valid & torch.all(torch.isfinite(p_img), dim=-1)
    p_safe = torch.where(valid[..., None], p_img, torch.zeros_like(p_img))
    p_robot = (cam.t_ri[:3, :3] @ p_safe[..., :, None])[..., 0] \
        + cam.t_ri[:3, 3]
    return torch.where(valid[..., None], p_robot,
                       torch.full_like(p_robot, float("nan"))), valid
