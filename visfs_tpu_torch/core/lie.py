"""SO(3)/SE(3) Lie-group primitives (torch port of visfs_tpu.core.lie).

Quaternions are ``[w, x, y, z]`` (Hamilton convention); rigid transforms are
``(q, t)`` pairs or 4x4 homogeneous matrices.  Every function is
shape-polymorphic over leading dimensions and keeps the input dtype.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


# ---------------------------------------------------------------------------
# Quaternion algebra  (q = [w, x, y, z])
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_mul(a, b):
    """Hamilton product a*b (batched on leading dims)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_inv(q):
    """Inverse of a (near-)unit quaternion."""
    return quat_conj(q) / torch.clamp(
        torch.sum(q * q, dim=-1, keepdim=True), min=_EPS)


def quat_normalize(q):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_positify(q):
    """Flip sign so w >= 0, then normalize (Math.h:308-317)."""
    return quat_normalize(torch.where(q[..., 0:1] < 0.0, -q, q))


def quat_rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q."""
    qv = q[..., 1:4]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v, dim=-1)
    uuv = torch.linalg.cross(qv, uv, dim=-1)
    return v + 2.0 * (q[..., 0:1] * uv + uuv)


def delta_q(omega):
    """Small-rotation quaternion (1, omega/2), unnormalized
    (Math.h:277-287)."""
    one = torch.ones(omega.shape[:-1] + (1,), dtype=omega.dtype,
                     device=omega.device)
    return torch.cat([one, 0.5 * omega], dim=-1)


def skew(v):
    """3-vector -> 3x3 skew-symmetric matrix (Math.h:294-301)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3_like(v):
    return torch.eye(3, dtype=v.dtype, device=v.device).expand(
        v.shape[:-1] + (3, 3))


def quat_left(q):
    """4x4 left-multiplication operator, positified first (Math.h:324-334)."""
    pq = quat_positify(q)
    w, v = pq[..., 0], pq[..., 1:4]
    top = torch.cat([w[..., None, None], -v[..., None, :]], dim=-1)
    bottom = torch.cat(
        [v[..., :, None], w[..., None, None] * _eye3_like(v) + skew(v)],
        dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_right(q):
    """4x4 right-multiplication operator, positified first (Math.h:336-345)."""
    pq = quat_positify(q)
    w, v = pq[..., 0], pq[..., 1:4]
    top = torch.cat([w[..., None, None], -v[..., None, :]], dim=-1)
    bottom = torch.cat(
        [v[..., :, None], w[..., None, None] * _eye3_like(v) - skew(v)],
        dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_to_mat(q):
    """Unit quaternion -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        dim=-2,
    )


def mat_to_quat(m):
    """Rotation matrix -> unit quaternion (Shepperd's method, branch-free)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    q1 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], -1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], -1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], -1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)  # [..., 4, 4]
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], -1)
    idx = torch.argmax(scores, dim=-1)  # first maximum, like jnp.argmax
    q = torch.take_along_dim(cand, idx[..., None, None].expand(
        idx.shape + (1, 4)), dim=-2)[..., 0, :]
    return quat_positify(q)


# ---------------------------------------------------------------------------
# SO(3) exp / log
# ---------------------------------------------------------------------------

def so3_exp(w):
    """Axis-angle 3-vector -> rotation matrix (Math.h:347-369)."""
    d2 = torch.sum(w * w, dim=-1)
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    W = skew(w)
    W2 = W @ W
    small = d < 1e-5
    d_safe = torch.where(small, torch.ones_like(d), d)
    d2_safe = torch.where(small, torch.ones_like(d2), d2)
    a = torch.where(small, torch.ones_like(d), torch.sin(d_safe) / d_safe)
    b = torch.where(small, torch.full_like(d, 0.5),
                    (1.0 - torch.cos(d_safe)) / d2_safe)
    return _eye3_like(w) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    """Rotation matrix -> axis-angle 3-vector (Math.h:371-386)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = 0.5 * torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    costheta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(costheta)
    s = torch.sin(theta)
    tiny = torch.abs(s) < 1e-5
    scale = torch.where(tiny, torch.ones_like(s),
                        theta / torch.where(tiny, torch.ones_like(s), s))
    return w * scale[..., None]


# ---------------------------------------------------------------------------
# SE(3): (q, t) pairs and 4x4 matrices
# ---------------------------------------------------------------------------

def se3_identity(dtype=torch.float32, device=None):
    return (quat_identity(dtype, device),
            torch.zeros(3, dtype=dtype, device=device))


def _homogeneous(R, t):
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bot = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        top.shape[:-2] + (1, 4))
    return torch.cat([top, bot], dim=-2)


def se3_matrix(q, t):
    """(q, t) -> 4x4 homogeneous transform."""
    return _homogeneous(quat_to_mat(q), t)


def se3_from_matrix(T):
    return mat_to_quat(T[..., :3, :3]), T[..., :3, 3]


def se3_mul(a, b):
    """Compose (qa,ta) * (qb,tb)."""
    qa, ta = a
    qb, tb = b
    return quat_mul(qa, qb), quat_rotate(qa, tb) + ta


def se3_inv(a):
    q, t = a
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def se3_apply(a, p):
    q, t = a
    return quat_rotate(q, p) + t


def mat_inv_se3(T):
    """Fast inverse of a rigid 4x4 transform."""
    Rt = torch.swapaxes(T[..., :3, :3], -1, -2)
    ti = -(Rt @ T[..., :3, 3:4])[..., 0]
    return _homogeneous(Rt, ti)


def mat_apply(T, p):
    """Apply 4x4 transform to 3-point(s)."""
    return (T[..., :3, :3] @ p[..., :, None])[..., 0] + T[..., :3, 3]


# ---------------------------------------------------------------------------
# RPY euler conventions (pcl::getTransformation compatible: R = Rz Ry Rx)
# ---------------------------------------------------------------------------

def rpy_to_mat(roll, pitch, yaw):
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr,
                         cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr,
                         sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def mat_to_rpy(R):
    """Rotation matrix -> (roll, pitch, yaw) with
    R = Rz(yaw) Ry(pitch) Rx(roll)."""
    pitch = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


def xyzrpy_to_mat(x, y, z, roll, pitch, yaw):
    """pcl::getTransformation equivalent."""
    return _homogeneous(rpy_to_mat(roll, pitch, yaw),
                        torch.stack([x, y, z], dim=-1))


def mat_to_xyzrpy(T):
    """pcl::getTranslationAndEulerAngles -> (x, y, z, roll, pitch, yaw)."""
    roll, pitch, yaw = mat_to_rpy(T[..., :3, :3])
    return T[..., 0, 3], T[..., 1, 3], T[..., 2, 3], roll, pitch, yaw


def pose_update(q, t, delta):
    """BA pose update (OptimizeTypeDefine.cpp:7-14): t += dt;
    q = deltaQ(dw) * q; normalize.  delta: [..., 6] = (dt, dw)."""
    return (quat_normalize(quat_mul(delta_q(delta[..., 3:6]), q)),
            t + delta[..., 0:3])


def flatten_3dof(T):
    """Zero z/roll/pitch of a 4x4 pose (Estimator.cpp:368-375, Force3DoF)."""
    x, y, _, _, _, yaw = mat_to_xyzrpy(T)
    zero = torch.zeros_like(x)
    return xyzrpy_to_mat(x, y, zero, zero, zero, yaw)
