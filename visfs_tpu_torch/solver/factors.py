"""Bundle-adjustment factors: residuals and Jacobians (torch port of
visfs_tpu.solver.factors).

Poses are inverse camera poses Tcw as (q, t), updated on the 6-dim tangent
as ``t += dt; q = deltaQ(dw) * q``.  Every function broadcasts over leading
dimensions, so the solver evaluates all [L, P] stereo edges at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lie import (delta_q, quat_conj, quat_mul, quat_normalize,
                        quat_rotate, quat_to_mat, skew)


class StereoIntrinsics(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    bf: torch.Tensor  # baseline * fx


def apply_tangent(q, t, delta):
    """Tangent-space pose update: t += dt, q = deltaQ(dw) * q."""
    return (quat_normalize(quat_mul(delta_q(delta[..., 3:6]), q)),
            t + delta[..., 0:3])


def _safe_inv_z(z):
    """1/z clamped away from the camera plane (protects masked slots)."""
    sign = torch.where(z < 0.0, -torch.ones_like(z), torch.ones_like(z))
    return sign / torch.clamp(torch.abs(z), min=1e-3)


def project_stereo_point(pc, intr: StereoIntrinsics):
    """Camera-frame point(s) [..., 3] -> (uL, vL, uR)."""
    inv_z = _safe_inv_z(pc[..., 2])
    u = pc[..., 0] * inv_z * intr.fx + intr.cx
    v = pc[..., 1] * inv_z * intr.fy + intr.cy
    return torch.stack([u, v, u - intr.bf * inv_z], dim=-1)


def stereo_residual(pose_q, pose_t, pw, obs, intr: StereoIntrinsics):
    """obs - project(Tcw * Pw); [..., 3]."""
    return obs - project_stereo_point(quat_rotate(pose_q, pw) + pose_t, intr)


def stereo_jacobians(pose_q, pose_t, pw, intr: StereoIntrinsics):
    """Analytic Jacobians of the stereo residual: (J_pose [..., 3, 6] wrt
    (dt, dw), J_point [..., 3, 3] wrt Pw).  dpc/d(dw) = -skew(R Pw), exact
    for the left-quaternion update."""
    R = quat_to_mat(pose_q)
    rp = (R @ pw[..., :, None])[..., 0]
    pc = rp + pose_t
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = _safe_inv_z(z)
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(z)
    fx, fy, bf = intr.fx, intr.fy, intr.bf
    dproj = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1),
        torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1),
        torch.stack([fx * inv_z, zero, -fx * x * inv_z2 + bf * inv_z2],
                    dim=-1),
    ], dim=-2)
    J_point = -dproj @ R
    J_pose = torch.cat([-dproj, dproj @ skew(rp)], dim=-1)
    return J_pose, J_point


def pose_link_residual(q1, t1, q2, t2, meas_q, meas_t):
    """EdgePoseConstraint residual (OptimizeTypeDefine.cpp:35-50); [..., 6]."""
    e_t = quat_rotate(q1, quat_rotate(quat_conj(q2), -t2)) + t1 - meas_t
    e_q = 2.0 * quat_mul(quat_mul(quat_conj(meas_q), q1),
                         quat_conj(q2))[..., 1:4]
    return torch.cat([e_t, e_q], dim=-1)


def _left_mat(q):
    """L(q) with L(q) p = q * p (no positify)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([torch.stack([w, -x, -y, -z], -1),
                        torch.stack([x, w, -z, y], -1),
                        torch.stack([y, z, w, -x], -1),
                        torch.stack([z, -y, x, w], -1)], -2)


def _right_mat(q):
    """R(q) with R(q) p = p * q (no positify)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([torch.stack([w, -x, -y, -z], -1),
                        torch.stack([x, w, z, -y], -1),
                        torch.stack([y, -z, w, x], -1),
                        torch.stack([z, y, -x, w], -1)], -2)


def pose_link_jacobians(q1, t1, q2, t2, meas_q, meas_t):
    """Jacobians of the link residual wrt the two pose tangents at the zero
    tangent ([..., 6, 6] each), in closed form (the reference takes them by
    forward-mode autodiff; the quaternion normalization has zero derivative
    there for unit quaternions)."""
    R1 = quat_to_mat(q1)
    R21 = R1 @ torch.swapaxes(quat_to_mat(q2), -1, -2)  # R1 R2^T
    a = quat_rotate(q1, quat_rotate(quat_conj(q2), -t2))
    eye = torch.eye(3, dtype=t1.dtype, device=t1.device).expand(R1.shape)
    B = quat_mul(quat_mul(quat_conj(meas_q), q1), quat_conj(q2))
    dq1 = (_left_mat(quat_conj(meas_q)) @ _right_mat(
        quat_mul(q1, quat_conj(q2))))[..., 1:4, 1:4]
    dq2 = -_left_mat(B)[..., 1:4, 1:4]
    zero = torch.zeros_like(R1)
    J1 = torch.cat([torch.cat([eye, -skew(a)], -1),
                    torch.cat([zero, dq1], -1)], -2)
    J2 = torch.cat([torch.cat([-R21, -R21 @ skew(t2)], -1),
                    torch.cat([zero, dq2], -1)], -2)
    return J1, J2


def huber_weight(chi2, delta: float):
    """GN IRLS weight of g2o's RobustKernelHuber: min(1, delta/sqrt(chi2));
    delta <= 0 disables the kernel."""
    if delta <= 0.0:
        return torch.ones_like(chi2)
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi2 > delta * delta, delta / e, torch.ones_like(e))


def inv3x3(m):
    """Batched closed-form 3x3 inverse (adjugate / determinant)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det,
                                torch.ones_like(det))
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def solve6x6_spd(H, g):
    """Batched 6x6 SPD solve via the 3x3-block Schur complement."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    Ai = inv3x3(A)
    AiB = Ai @ B
    S = D - torch.swapaxes(B, -1, -2) @ AiB
    Si = inv3x3(S)
    g1 = g[..., :3, None]
    g2 = g[..., 3:, None]
    y2 = Si @ (g2 - torch.swapaxes(AiB, -1, -2) @ g1)
    y1 = Ai @ g1 - AiB @ y2
    return torch.cat([y1, y2], dim=-2)[..., 0]
