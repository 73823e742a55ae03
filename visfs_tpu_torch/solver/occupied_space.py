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

The pose-tangent Jacobian is taken as the reference takes it, by
differentiating the residual through the tangent update (t += dt, q =
deltaQ(dw) q) with ``torch.autograd`` where the reference uses
``jax.value_and_grad``, so it rounds as the reference's does.  A closed
form (dP/ddt = -R^T, dP/ddw = R^T [P_img - t]x) is exact where the
autodiff leaves float32 residues: at an axis-aligned pose its three
out-of-plane columns are exactly 0 where the autodiff's are not.  On a
frame with no odometry link those columns are all that the Hessian holds
in the out-of-plane dofs, so the Levenberg-Marquardt step there is huge
(then dropped whole by the step guard) or 0 (a planar step), and the pose
after the BA differs by centimetres (tests/test_torch_laser.py::
test_first_laser_frame_matches_reference).  tests/test_torch_laser.py
holds the Jacobian against the reference's autodiff.
"""

from __future__ import annotations

import torch

from ..core.lie import fma, quat_conj
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
    """(P_img, P_world) [K, 3] of robot-frame points under Tcw (one pose,
    or one a point: pose_q [K, 4], pose_t [K, 3]).  The
    rotation is lie.quat_rotate's formula with the reference's compiled
    roundings (fused cross products and w*uv + uuv): the grid coordinates
    scale the point by 1/resolution, so an ulp of the point is ~1e-6 of
    cost."""
    p_img = (t_ir[:3, :3] @ p_robot[..., None])[..., 0] + t_ir[:3, 3]
    qi = quat_conj(pose_q)
    v = p_img - pose_t
    u = qi[..., 1:4].expand_as(v)
    uv = _cross_fused(u, v)
    return p_img, v + 2.0 * fma(qi[..., :1].expand_as(uv), uv,
                                _cross_fused(u, uv))


def occupied_space_residual(pose_q, pose_t, p_robot, cost_grid, resolution,
                            max_x, max_y, t_ir):
    """Residuals of scan points [..., 3] under pose Tcw = (pose_q, pose_t)."""
    p_world = _world_points(pose_q, pose_t, p_robot, t_ir)[1]
    rr = (max_x - p_world[..., 0]) / resolution - 0.5
    cc = (max_y - p_world[..., 1]) / resolution - 0.5
    return bicubic_cost(cost_grid, rr, cc)


def occupied_space_terms(pose_q, pose_t, points_robot, points_mask,
                         cost_grid, resolution, max_x, max_y, t_ir,
                         info_weight, jacobian=True):
    """Residuals + pose-tangent Jacobians for all scan points.

    Returns (r [K], J [K, 6], w [K]); J is wrt the BA tangent update
    (t += dt, q = deltaQ(dw) q) of the newest pose, the reference's
    (dt, dw) order, by autodiff at the zero update as the reference takes
    it: each point its own zero update, so the gradient of the residuals'
    sum holds each point's Jacobian in its row.  With jacobian=False, J is
    None and r the same (the cost alone needs no backward pass)."""
    from .factors import apply_tangent

    with torch.enable_grad():
        delta = torch.zeros((points_robot.shape[0], 6), dtype=pose_t.dtype,
                            device=pose_t.device, requires_grad=jacobian)
        q, t = apply_tangent(pose_q, pose_t, delta)
        r = occupied_space_residual(q, t, points_robot, cost_grid,
                                    resolution, max_x, max_y, t_ir)
        J = torch.autograd.grad(r.sum(), delta)[0] if jacobian else None
    r = torch.where(points_mask, r.detach(), torch.zeros_like(r))
    w = info_weight * points_mask.to(r.dtype)
    if J is not None:
        J = torch.where(points_mask[:, None], J, torch.zeros_like(J))
    return r, J, w
