"""Occupied-space (laser scan-match) factor (torch port of
visfs_tpu.solver.occupied_space).

The residual of one scan point is the bicubic-interpolated correspondence
cost of the matching submap at the point's world position under the newest
pose (the reference's ceres::BiCubicInterpolator factor,
corelib/src/Optimizer/ceres/OccupiedSpace2dFactor.cpp:11-96).  With the BA
pose Tcw (world->camera) and a robot-frame scan point Pr,
    P_world = Tcw^-1 * T_ir * Pr,
and the grid is read at
    row = (max_x - P.x)/res - 0.5, col = (max_y - P.y)/res - 0.5
(out-of-grid taps read kMaxCorrespondenceCost).

The reference takes the pose-tangent Jacobian by ``jax.value_and_grad``;
here it is in closed form: the cubic weights' derivatives give the cost's
gradient in (row, col), and the tangent update (t += dt, q = deltaQ(dw) q)
moves the world point by dP/ddt = -R^T and dP/ddw = R^T [P_img - t]x,
R = R(q).  tests/test_torch_laser.py holds it against both the reference's
autodiff and torch.func.
"""

from __future__ import annotations

import torch

from ..core.lie import fma, quat_conj, quat_normalize, quat_to_mat, skew
from ..map2d.probability_values import MAX_CORRESPONDENCE_COST

def _cubic_weights(t):
    """Catmull-Rom (cubic convolution, a = -0.5) weights of 4 taps,
    [..., 4] (ceres::CubicHermiteSpline with central differences)."""
    t2 = t * t
    t3 = t2 * t
    return torch.stack([-0.5 * t3 + t2 - 0.5 * t,
                        1.5 * t3 - 2.5 * t2 + 1.0,
                        -1.5 * t3 + 2.0 * t2 + 0.5 * t,
                        0.5 * t3 - 0.5 * t2], dim=-1)


def _cubic_weights_grad(t):
    """d/dt of _cubic_weights, [..., 4]."""
    t2 = t * t
    return torch.stack([-1.5 * t2 + 2.0 * t - 0.5, 4.5 * t2 - 5.0 * t,
                        -4.5 * t2 + 4.0 * t + 0.5, 1.5 * t2 - t], dim=-1)


def _patch(cost_grid, rr, cc):
    """The 4x4 taps around (rr, cc) [...]: (patch [..., 4, 4], fr, fc)."""
    H, W = cost_grid.shape
    r0 = torch.floor(rr)
    c0 = torch.floor(cc)
    offs = torch.arange(-1, 3, device=rr.device)
    rows = r0.long()[..., None] + offs  # [..., 4]
    cols = c0.long()[..., None] + offs
    inb = (((rows >= 0) & (rows < H))[..., :, None]
           & ((cols >= 0) & (cols < W))[..., None, :])
    patch = cost_grid[torch.clamp(rows, 0, H - 1)[..., :, None],
                      torch.clamp(cols, 0, W - 1)[..., None, :]]
    patch = torch.where(inb, patch,
                        torch.full_like(patch, MAX_CORRESPONDENCE_COST))
    return patch, rr - r0, cc - c0


def _bilinear_form(wr, patch, wc):
    """wr @ patch @ wc over the leading dims."""
    return ((wr[..., None, :] @ patch) @ wc[..., :, None])[..., 0, 0]


def bicubic_cost(cost_grid, rr, cc):
    """Bicubic sample of the [H, W] cost grid at continuous (row, col),
    elementwise over rr/cc of any (equal) shape."""
    patch, fr, fc = _patch(cost_grid, rr, cc)
    return _bilinear_form(_cubic_weights(fr), patch, _cubic_weights(fc))


def _cross_fused(a, b):
    """a x b with each component's two products rounded once."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)),
                        fma(a0, b1, -(a1 * b0))], dim=-1)


def _world_points(pose_q, pose_t, p_robot, t_ir):
    """(P_img, P_world) [K, 3] of robot-frame points under Tcw.  The
    rotation is lie.quat_rotate's formula with the reference's compiled
    roundings (fused cross products and w*uv + uuv): the grid coordinates
    scale the point by 1/resolution, so an ulp of the point is ~1e-6 of
    cost."""
    p_img = (t_ir[:3, :3] @ p_robot[..., None])[..., 0] + t_ir[:3, 3]
    qi = quat_conj(pose_q)
    v = p_img - pose_t
    u = qi[1:4].expand_as(v)
    uv = _cross_fused(u, v)
    return p_img, v + 2.0 * fma(qi[0].expand_as(uv), uv, _cross_fused(u, uv))


def occupied_space_residual(pose_q, pose_t, p_robot, cost_grid, resolution,
                            max_x, max_y, t_ir):
    """Residuals of scan points [..., 3] under pose Tcw = (pose_q, pose_t)."""
    p_world = _world_points(pose_q, pose_t, p_robot, t_ir)[1]
    rr = (max_x - p_world[..., 0]) / resolution - 0.5
    cc = (max_y - p_world[..., 1]) / resolution - 0.5
    return bicubic_cost(cost_grid, rr, cc)


def occupied_space_terms(pose_q, pose_t, points_robot, points_mask,
                         cost_grid, resolution, max_x, max_y, t_ir,
                         info_weight):
    """Residuals + pose-tangent Jacobians for all scan points.

    Returns (r [K], J [K, 6], w [K]); J is wrt the BA tangent update
    (t += dt, q = deltaQ(dw) q) of the newest pose, the reference's
    (dt, dw) order, taken where the reference takes it: at the zero update,
    whose q is normalized."""
    pose_q = quat_normalize(pose_q)
    p_img, p_world = _world_points(pose_q, pose_t, points_robot, t_ir)
    rr = (max_x - p_world[:, 0]) / resolution - 0.5
    cc = (max_y - p_world[:, 1]) / resolution - 0.5
    patch, fr, fc = _patch(cost_grid, rr, cc)
    wr, wc = _cubic_weights(fr), _cubic_weights(fc)
    r = _bilinear_form(wr, patch, wc)
    dr_drr = _bilinear_form(_cubic_weights_grad(fr), patch, wc)
    dr_dcc = _bilinear_form(wr, patch, _cubic_weights_grad(fc))
    # dr/dP_world = -(dr/drr, dr/dcc, 0) / res
    zero = torch.zeros_like(dr_drr)
    g = -torch.stack([dr_drr, dr_dcc, zero], dim=-1) / resolution  # [K, 3]
    rt = quat_to_mat(pose_q).transpose(-1, -2)  # R^T
    dp_ddt = -rt  # [3, 3]
    dp_ddw = rt @ skew(p_img - pose_t)  # [K, 3, 3]
    J = torch.cat([g @ dp_ddt, (g[:, None, :] @ dp_ddw)[:, 0]], dim=-1)
    mask = points_mask[:, None]
    w = info_weight * points_mask.to(r.dtype)
    return (torch.where(points_mask, r, torch.zeros_like(r)),
            torch.where(mask, J, torch.zeros_like(J)), w)
