"""Sliding-window local bundle adjustment: masked dense Schur GN/LM solver
(torch port of visfs_tpu.solver.ba, without the laser terms).

Poses are ``P`` window slots of inverse camera poses Tcw, landmarks ``L``
table slots of world points; stereo edges live on the dense [L, P] grid,
wheel-odometry links between consecutive slots.  Landmarks are eliminated
on 3x3 blocks (Schur complement), the [6P, 6P] pose system is solved by
Cholesky.  Two passes of iterations/2 LM steps; between them, edges with
chi2 > robustKernelDelta are demoted and reported as outliers.  Every
branch on data is a ``torch.where``, so the solver never syncs the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .factors import (StereoIntrinsics, apply_tangent, huber_weight, inv3x3,
                      pose_link_jacobians, pose_link_residual,
                      stereo_jacobians, stereo_residual)

# Landmark update larger than this is rejected (g2o write-back gate).
_MAX_POINT_MOTION = 5.0
# Abort threshold for diverged optimization (Optimizer.cpp:276).
_MAX_CHI2 = 1.0e12
# Per-pose tangent step larger than this (m/rad) is dropped.
_MAX_POSE_STEP = 2.0


class BAProblem(NamedTuple):
    """Masked, fixed-shape local BA problem."""

    pose_q: torch.Tensor  # [P, 4] Tcw rotation (w,x,y,z)
    pose_t: torch.Tensor  # [P, 3] Tcw translation
    pose_valid: torch.Tensor  # [P] bool
    pose_fixed: torch.Tensor  # [P] bool — held constant (root, invalid)
    lm_pos: torch.Tensor  # [L, 3] world-frame landmark positions
    lm_valid: torch.Tensor  # [L] bool
    lm_fixed: torch.Tensor  # [L] bool — STABLE features: constant in BA
    obs: torch.Tensor  # [L, P, 3] (uL, vL, uR) measurements
    obs_mask: torch.Tensor  # [L, P] bool
    link_q: torch.Tensor  # [P-1, 4] measured Tc_i c_{i+1} rotation
    link_t: torch.Tensor  # [P-1, 3]
    link_mask: torch.Tensor  # [P-1] bool
    intr: StereoIntrinsics


@dataclasses.dataclass(frozen=True)
class BASettings:
    """Static solver configuration (the Optimizer/* parameter group)."""

    iterations: int = 10
    pixel_variance: float = 1.5
    odometry_covariance: float = 5e-5
    robust_delta: float = 8.0
    use_levenberg: bool = True  # Optimizer/TrustRegion: 0=LM 1=GN
    init_lambda: float = 1e-4


class BAResult(NamedTuple):
    pose_q: torch.Tensor
    pose_t: torch.Tensor
    lm_pos: torch.Tensor
    outliers: torch.Tensor  # [L, P] bool — demoted visual edges
    chi2: torch.Tensor  # final robust chi2
    ok: torch.Tensor  # bool — optimization healthy (no NaN/divergence)


def _stereo_terms(problem: BAProblem, lm_pos, pose_q, pose_t, active_mask,
                  settings: BASettings):
    """(r [L,P,3], w [L,P] info * robust weight, chi2 [L,P])."""
    r = stereo_residual(pose_q[None], pose_t[None], lm_pos[:, None],
                        problem.obs, problem.intr)
    w_pix = 1.0 / settings.pixel_variance
    chi2 = w_pix * torch.sum(r * r, dim=-1)
    w = w_pix * huber_weight(chi2, settings.robust_delta) * active_mask
    return r, w, chi2


def _link_terms(problem: BAProblem, pose_q, pose_t):
    return (pose_q[:-1], pose_t[:-1], pose_q[1:], pose_t[1:], problem.link_q,
            problem.link_t)


def _robust_chi2_total(problem: BAProblem, lm_pos, pose_q, pose_t,
                       active_mask, settings: BASettings):
    """activeRobustChi2: huberized stereo chi2 + link chi2."""
    _, _, chi2 = _stereo_terms(problem, lm_pos, pose_q, pose_t, active_mask,
                               settings)
    d = settings.robust_delta
    if d > 0.0:
        rho = torch.where(
            chi2 > d * d,
            2.0 * d * torch.sqrt(torch.clamp(chi2, min=1e-12)) - d * d, chi2)
    else:
        rho = chi2
    total = torch.sum(rho * active_mask)
    r_link = pose_link_residual(*_link_terms(problem, pose_q, pose_t))
    link_chi2 = (1.0 / settings.odometry_covariance) * torch.sum(
        r_link * r_link, dim=-1)
    return total + torch.sum(link_chi2 * problem.link_mask)


def _gn_normal_equations(problem: BAProblem, lm_pos, pose_q, pose_t,
                         active_mask, settings: BASettings):
    """(H_pp [6P,6P], g_p [6P], V [L,3,3], g_l [L,3], W [L,3,6P],
    lm_free [L])."""
    P = pose_q.shape[0]
    L = lm_pos.shape[0]
    r, w, _ = _stereo_terms(problem, lm_pos, pose_q, pose_t, active_mask,
                            settings)
    Jp, Jl = stereo_jacobians(pose_q[None], pose_t[None], lm_pos[:, None],
                              problem.intr)  # [L,P,3,6], [L,P,3,3]
    wJp = w[..., None, None] * Jp
    wJl = w[..., None, None] * Jl
    U = torch.einsum("lpki,lpkj->pij", wJp, Jp)  # [P,6,6]
    g_p = -torch.einsum("lpki,lpk->pi", wJp, r).reshape(6 * P)
    V = torch.einsum("lpki,lpkj->lij", wJl, Jl)  # [L,3,3]
    g_l = -torch.einsum("lpki,lpk->li", wJl, r)  # [L,3]
    W = torch.einsum("lpki,lpkj->lipj", wJl, Jp).reshape(L, 3, 6 * P)

    # Pose-pose Hessian as [P,6,P,6]: stereo diagonal + odometry links.
    H = torch.zeros((P, 6, P, 6), dtype=pose_t.dtype, device=pose_t.device)
    ar = torch.arange(P, device=pose_t.device)
    H[ar, :, ar, :] = U
    links = _link_terms(problem, pose_q, pose_t)
    r_link = pose_link_residual(*links)
    J1, J2 = pose_link_jacobians(*links)
    w_odo = ((1.0 / settings.odometry_covariance)
             * problem.link_mask.to(pose_t.dtype))[:, None, None]
    wJ1 = w_odo * J1
    wJ2 = w_odo * J2
    lo, hi = ar[:-1], ar[1:]
    H12 = torch.swapaxes(wJ1, -1, -2) @ J2
    H[lo, :, lo, :] += torch.swapaxes(wJ1, -1, -2) @ J1
    H[hi, :, hi, :] += torch.swapaxes(wJ2, -1, -2) @ J2
    H[lo, :, hi, :] += H12
    H[hi, :, lo, :] += torch.swapaxes(H12, -1, -2)
    g_links = torch.zeros((P, 6), dtype=pose_t.dtype, device=pose_t.device)
    g_links[lo] -= (torch.swapaxes(wJ1, -1, -2) @ r_link[..., None])[..., 0]
    g_links[hi] -= (torch.swapaxes(wJ2, -1, -2) @ r_link[..., None])[..., 0]

    n_obs = torch.sum(active_mask, dim=1)
    lm_free = problem.lm_valid & ~problem.lm_fixed & (n_obs >= 1)
    return (H.reshape(6 * P, 6 * P), g_p + g_links.reshape(6 * P), V, g_l, W,
            lm_free)


def _solve_schur(H, g_p, V, g_l, W, lm_free, pose_free_mask, lam,
                 use_lm: bool):
    """Schur-marginalize landmarks, solve poses, back-substitute."""
    P6 = H.shape[0]
    eye3 = torch.eye(3, dtype=H.dtype, device=H.device)
    damp = lam if use_lm else torch.zeros_like(lam)
    Hd = H + damp * torch.diag_embed(torch.diagonal(H)) \
        + 1e-8 * torch.eye(P6, dtype=H.dtype, device=H.device)
    Vd = V + damp * eye3 * torch.diagonal(V, dim1=-2, dim2=-1)[:, None, :] \
        + 1e-8 * eye3

    free = lm_free.to(H.dtype)
    V_inv = inv3x3(torch.where(lm_free[:, None, None], Vd, eye3))
    WtVi = torch.einsum("laj,lab->ljb", W, V_inv * free[:, None, None])
    S = Hd - torch.einsum("ljb,lbk->jk", WtVi, W)
    g_s = g_p - torch.einsum("ljb,lb->j", WtVi, g_l)

    m = pose_free_mask.to(H.dtype)
    S = S * m[:, None] * m[None, :] + torch.diag_embed(1.0 - m)
    g_s = g_s * m
    # Cholesky + two triangular solves: no info check, so no host sync; a
    # failed factorization (info != 0) gives a zero step, as the
    # reference's NaN solve does.
    chol, info = torch.linalg.cholesky_ex(S)
    y = torch.linalg.solve_triangular(chol, g_s[:, None], upper=False)
    dx_p = torch.linalg.solve_triangular(chol.mT, y, upper=True)[:, 0]
    good = torch.isfinite(dx_p) & (info == 0)
    dx_p = torch.where(good, dx_p, torch.zeros_like(dx_p)) * m

    rhs = g_l - torch.einsum("lak,k->la", W, dx_p)
    dx_l = torch.einsum("lab,lb->la", V_inv, rhs) * free[:, None]
    return dx_p, dx_l


def _apply_updates(pose_q, pose_t, lm_pos, dx_p, dx_l, pose_fixed):
    P = pose_q.shape[0]
    deltas = dx_p.reshape(P, 6)
    deltas = torch.where(pose_fixed[:, None], torch.zeros_like(deltas),
                         deltas)
    step_norm = torch.linalg.vector_norm(deltas, dim=-1)
    deltas = torch.where((step_norm < _MAX_POSE_STEP)[:, None], deltas,
                         torch.zeros_like(deltas))
    new_q, new_t = apply_tangent(pose_q, pose_t, deltas)
    motion = torch.linalg.vector_norm(dx_l, dim=-1)
    dx_l = torch.where((motion < _MAX_POINT_MOTION)[:, None], dx_l,
                       torch.zeros_like(dx_l))
    return new_q, new_t, lm_pos + dx_l


def _optimize_pass(problem: BAProblem, pose_q, pose_t, lm_pos, active_mask,
                   settings: BASettings, num_iters: int):
    """``num_iters`` LM/GN iterations with a fixed active-edge mask."""
    pose_free = ~problem.pose_fixed & problem.pose_valid
    pose_free_mask = torch.repeat_interleave(pose_free, 6)
    use_lm = settings.use_levenberg
    chi2_cur = _robust_chi2_total(problem, lm_pos, pose_q, pose_t,
                                  active_mask, settings)
    lam = torch.full((), settings.init_lambda, dtype=pose_t.dtype,
                     device=pose_t.device)
    for _ in range(num_iters):
        H, g_p, V, g_l, W, lm_free = _gn_normal_equations(
            problem, lm_pos, pose_q, pose_t, active_mask, settings)
        dx_p, dx_l = _solve_schur(H, g_p, V, g_l, W, lm_free, pose_free_mask,
                                  lam, use_lm)
        cand_q, cand_t, cand_lm = _apply_updates(pose_q, pose_t, lm_pos, dx_p,
                                                 dx_l, problem.pose_fixed)
        chi2_new = _robust_chi2_total(problem, cand_lm, cand_q, cand_t,
                                      active_mask, settings)
        # STRICT decrease; plain GN always steps.
        if use_lm:
            accept = torch.isfinite(chi2_new) & (chi2_new < chi2_cur)
        else:
            accept = torch.ones_like(chi2_new, dtype=torch.bool)
        pose_q = torch.where(accept, cand_q, pose_q)
        pose_t = torch.where(accept, cand_t, pose_t)
        lm_pos = torch.where(accept, cand_lm, lm_pos)
        chi2_cur = torch.where(accept, chi2_new, chi2_cur)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), lam * 4.0)
    return pose_q, pose_t, lm_pos


def local_optimize(problem: BAProblem, settings: BASettings) -> BAResult:
    """Two-pass sliding-window BA (Optimizer::localOptimize equivalent)."""
    half = max(settings.iterations // 2, 1)
    base_mask = problem.obs_mask & problem.lm_valid[:, None] \
        & problem.pose_valid[None, :]
    active = base_mask.to(problem.pose_t.dtype)

    q1, t1, l1 = _optimize_pass(problem, problem.pose_q, problem.pose_t,
                                problem.lm_pos, active, settings, half)
    _, _, chi2 = _stereo_terms(problem, l1, q1, t1, active, settings)
    chi2_mid = _robust_chi2_total(problem, l1, q1, t1, active, settings)
    diverged1 = ~torch.isfinite(chi2_mid) | (chi2_mid > _MAX_CHI2)

    if settings.robust_delta > 0.0:
        outliers = base_mask & (chi2 > settings.robust_delta)
        active2 = (base_mask & ~outliers).to(active.dtype)
        q2, t2, l2 = _optimize_pass(problem, q1, t1, l1, active2, settings,
                                    half)
    else:
        outliers = torch.zeros_like(base_mask)
        active2 = active
        q2, t2, l2 = q1, t1, l1

    chi2_end = _robust_chi2_total(problem, l2, q2, t2, active2, settings)
    diverged2 = ~torch.isfinite(chi2_end) | (chi2_end > _MAX_CHI2)
    ok = ~(diverged1 | diverged2)
    return BAResult(torch.where(ok, q2, problem.pose_q),
                    torch.where(ok, t2, problem.pose_t),
                    torch.where(ok, l2, problem.lm_pos), outliers, chi2_end,
                    ok)
