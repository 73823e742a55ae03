"""Batched 3D->2D PnP RANSAC motion estimation (torch port of
visfs_tpu.ops.pnp).

``K`` hypotheses run at once as a leading batch dimension: hypothesis 0 is
the motion guess, the others closed-form EPnP solves (or GN fits from a
perturbed prior, PnPFlags 0) on random subsets drawn by Gumbel top-k from
the threefry key, each polished by subset Gauss-Newton and scored by inlier
count tie-broken by mean inlier error.  A fixed IRLS loop with the
variance-adaptive threshold replaces refineModel.  Poses are
camera-from-world (q, t) with the BA solver's left-quaternion update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core import prng
from ..core.lie import mat_to_quat, quat_rotate, quat_to_mat, skew
from ..solver.factors import apply_tangent, solve6x6_spd


@dataclasses.dataclass(frozen=True)
class PnPSettings:
    iterations: int = 50  # Estimator/PnPIterations: hypothesis count
    reproj_error: float = 2.0  # Estimator/PnPReprojError (pixels)
    min_inliers: int = 12  # Estimator/MinInliers
    refine_iterations: int = 5  # Estimator/RefineIterations
    refine_sigma: float = 3.0  # solvePnPRansac default _refineSigma
    gn_iterations: int = 6  # inner GN iterations per hypothesis fit
    refine_steps_per_round: int = 3  # IRLS steps per refineModel round
    perturbation: float = 0.05  # hypothesis start jitter (m / rad)
    flags: int = 1  # Estimator/PnPFlags: 0 iterative, >= 1 EPnP
    epnp_subset: int = 6  # subset size for closed-form hypotheses


class PnPResult(NamedTuple):
    q: torch.Tensor  # [4] camera-from-world rotation
    t: torch.Tensor  # [3]
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor
    ok: torch.Tensor  # bool — n_inliers >= min_inliers
    mean_err: torch.Tensor


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _norm(x, dim=-1, keepdim=False):
    return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)


def _project(q, t, pw, fx, fy, cx, cy):
    """q [..., 4], t [..., 3], pw [N, 3] -> (uv [..., N, 2], pc)."""
    pc = quat_rotate(q[..., None, :], pw) + t[..., None, :]
    zc = pc[..., 2]
    z = torch.where(torch.abs(zc) < 1e-6, torch.full_like(zc, 1e-6), zc)
    return torch.stack([pc[..., 0] / z * fx + cx, pc[..., 1] / z * fy + cy],
                       dim=-1), pc


def _reproj_errors(q, t, pw, uv, fx, fy, cx, cy):
    pred, pc = _project(q, t, pw, fx, fy, cx, cy)
    err = _norm(pred - uv)
    return torch.where(pc[..., 2] <= 0.05, torch.full_like(err, 1e6), err)


def _gn_refine(q, t, pw, uv, weights, fx, fy, cx, cy, n_iters: int):
    """Pose-only Gauss-Newton on weighted points (batched on q's leading
    dims; weights [..., N])."""
    for _ in range(n_iters):
        R = quat_to_mat(q)
        rp = (R[..., None, :, :] @ pw[..., :, None])[..., 0]  # [..., N, 3]
        pc = rp + t[..., None, :]
        zc = pc[..., 2]
        z = torch.where(torch.abs(zc) < 1e-6, torch.full_like(zc, 1e-6), zc)
        inv_z = 1.0 / z
        pred = torch.stack([pc[..., 0] * inv_z * fx + cx,
                            pc[..., 1] * inv_z * fy + cy], dim=-1)
        r = uv - pred
        zero = torch.zeros_like(inv_z)
        dproj = torch.stack([
            torch.stack([fx * inv_z, zero, -fx * pc[..., 0] * inv_z * inv_z],
                        -1),
            torch.stack([zero, fy * inv_z, -fy * pc[..., 1] * inv_z * inv_z],
                        -1)], dim=-2)  # [..., N, 2, 3]
        J = torch.cat([-dproj, dproj @ skew(rp)], dim=-1)  # [..., N, 2, 6]
        Jw = J * weights[..., :, None, None]
        H = torch.einsum("...nki,...nkj->...ij", Jw, J) + 1e-6 * _eye(6, t)
        g = -torch.einsum("...nki,...nk->...i", Jw, r)
        delta = solve6x6_spd(H, g)
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        q, t = apply_tangent(q, t, delta)
    return q, t


def sym_eigh_3x3(A):
    """Closed-form eigendecomposition of symmetric 3x3 matrices [..., 3, 3]:
    (eigenvalues ascending [..., 3], eigenvectors as columns [..., 3, 3]).
    Degenerate inputs fall back to the identity basis."""
    eye = _eye(3, A)
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(torch.linalg.det(B) / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    evals = torch.stack([e_lo, e_mid, e_hi], dim=-1)
    ex, ey = eye[0], eye[1]

    def eigvec(lam):
        M = A - lam[..., None, None] * eye
        cands = torch.stack([torch.linalg.cross(M[..., 0, :], M[..., 1, :]),
                             torch.linalg.cross(M[..., 0, :], M[..., 2, :]),
                             torch.linalg.cross(M[..., 1, :], M[..., 2, :])],
                            dim=-2)
        norms = _norm(cands)
        best = torch.argmax(norms, dim=-1)
        v = torch.take_along_dim(cands, best[..., None, None].expand(
            best.shape + (1, 3)), dim=-2)[..., 0, :]
        ok = torch.amax(norms, dim=-1) > 1e-20
        v = torch.where(ok[..., None], v, ex)
        return v / _norm(v, keepdim=True), ok

    v_hi, ok_hi = eigvec(e_hi)
    v_lo, ok_lo = eigvec(e_lo)
    v_lo = v_lo - v_hi * torch.sum(v_hi * v_lo, dim=-1, keepdim=True)
    n_lo = _norm(v_lo, keepdim=True)
    alt = torch.linalg.cross(v_hi, torch.where(
        torch.abs(v_hi[..., 0:1]) < 0.9, ex, ey))
    v_lo = torch.where(n_lo > 1e-6, v_lo / torch.clamp(n_lo, min=1e-20),
                       alt / _norm(alt, keepdim=True))
    v_mid = torch.linalg.cross(v_hi, v_lo)
    iso = p2 <= 1e-12 * (q * q + 1e-30)
    degen = iso | (~ok_hi & ~ok_lo)
    V = torch.where(degen[..., None, None], eye,
                    torch.stack([v_lo, v_mid, v_hi], dim=-1))
    evals = torch.where(iso[..., None], q[..., None].expand(evals.shape),
                        evals)
    return evals, V


def _smallest_two_eigvecs(A, iters: int = 6, second: bool = True):
    """Two smallest eigenvectors of symmetric PSD [..., n, n] matrices by
    shifted inverse iteration with deflation."""
    n = A.shape[-1]
    eye = _eye(n, A)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    eps = 1e-6 * (tr / n) + 1e-12
    lu, piv, _ = torch.linalg.lu_factor_ex(A + eps[..., None, None] * eye)

    def run(x0, deflate):
        x = x0.expand(A.shape[:-1]).clone()
        for _ in range(iters):
            y = torch.linalg.lu_solve(lu, piv, x[..., None])[..., 0]
            y = y - deflate * torch.sum(deflate * y, dim=-1, keepdim=True)
            x = y / torch.clamp(_norm(y, keepdim=True), min=1e-20)
        return x

    base = torch.ones(n, dtype=A.dtype, device=A.device) / torch.sqrt(
        torch.full((), n, dtype=A.dtype, device=A.device))
    v1 = run(base + 0.5 * eye[0], torch.zeros_like(base))
    if not second:
        return v1, v1
    return v1, run(base - 0.5 * eye[1], v1)


def _horn_quat(S, iters: int = 16):
    """Optimal rotation quaternion from the correlation S = sum w a b^T
    (b ~= R a): the top eigenvector of Horn's 4x4 N by power iteration."""
    s = [[S[..., i, j] for j in range(3)] for i in range(3)]
    tr = s[0][0] + s[1][1] + s[2][2]
    rows = [
        [tr, s[1][2] - s[2][1], s[2][0] - s[0][2], s[0][1] - s[1][0]],
        [s[1][2] - s[2][1], s[0][0] - s[1][1] - s[2][2], s[0][1] + s[1][0],
         s[2][0] + s[0][2]],
        [s[2][0] - s[0][2], s[0][1] + s[1][0], s[1][1] - s[0][0] - s[2][2],
         s[1][2] + s[2][1]],
        [s[0][1] - s[1][0], s[2][0] + s[0][2], s[1][2] + s[2][1],
         s[2][2] - s[0][0] - s[1][1]],
    ]
    N = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    c = torch.sqrt(torch.sum(N * N, dim=(-2, -1))) + 1e-6
    Ns = N + c[..., None, None] * _eye(4, S)
    q0 = torch.cat([torch.ones(1, dtype=S.dtype, device=S.device),
                    torch.full((3,), 0.1, dtype=S.dtype, device=S.device)])
    q = (q0 / _norm(q0, keepdim=True)).expand(S.shape[:-2] + (4,))
    for _ in range(iters):
        y = (Ns @ q[..., None])[..., 0]
        q = y / torch.clamp(_norm(y, keepdim=True), min=1e-20)
    return torch.where(q[..., 0:1] < 0, -q, q)


def _procrustes_pose(pw, pc, w):
    """Weighted rigid fit pc ~= R @ pw + t (Horn's closed form);
    pw [N, 3], pc [..., N, 3], w [..., N]."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    mu_w = torch.sum(pw * w[..., None], dim=-2) / wsum
    mu_c = torch.sum(pc * w[..., None], dim=-2) / wsum
    S = torch.einsum("...n,...ni,...nj->...ij", w, pw - mu_w[..., None, :],
                     pc - mu_c[..., None, :])
    R = quat_to_mat(_horn_quat(S))
    t = mu_c - (R @ mu_w[..., None])[..., 0]
    return R, t


def _epnp_core(ctrl_w, alpha, pw, uv, w, fx, fy, cx, cy, n2: bool = True):
    """EPnP given world control points [..., nc, 3] and barycentric
    coordinates [..., N, nc]; beta cases N=1 (and N=2), weighted
    Procrustes, the better case by weighted reprojection wins."""
    nc = ctrl_w.shape[-2]
    npt = pw.shape[0]
    batch = alpha.shape[:-2]
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    un = uv[:, 0] - cx
    vn = uv[:, 1] - cy
    sw = torch.sqrt(w)[..., None]
    zeros = torch.zeros_like(alpha)
    mu = torch.stack([alpha * fx, zeros, alpha * (-un)[:, None]], -1)
    mv = torch.stack([zeros, alpha * fy, alpha * (-vn)[:, None]], -1)
    M = torch.cat([mu.reshape(batch + (npt, 3 * nc)) * sw,
                   mv.reshape(batch + (npt, 3 * nc)) * sw], dim=-2)
    e1, e2 = _smallest_two_eigvecs(M.mT @ M, second=n2)
    v1 = e1.reshape(batch + (nc, 3))
    v2 = e2.reshape(batch + (nc, 3))

    ii, jj = torch.triu_indices(nc, nc, offset=1, device=alpha.device)
    dw = ctrl_w[..., ii, :] - ctrl_w[..., jj, :]
    dv1 = v1[..., ii, :] - v1[..., jj, :]
    dv2 = v2[..., ii, :] - v2[..., jj, :]
    rho = torch.sum(dw * dw, dim=-1)

    def finish(ctrl_c):
        pc = alpha @ ctrl_c  # [..., N, 3]
        zmean = torch.sum(pc[..., 2] * w, dim=-1) / wsum
        pc = torch.where((zmean < 0)[..., None, None], -pc, pc)
        R, t = _procrustes_pose(pw, pc, w)
        q = mat_to_quat(R)
        errs = _reproj_errors(q, t, pw, uv, fx, fy, cx, cy)
        err = torch.sum(torch.where(w > 0, errs, torch.zeros_like(errs)),
                        dim=-1) / wsum
        return q, t, err

    b1 = torch.sum(_norm(dv1) * torch.sqrt(rho), dim=-1) / torch.clamp(
        torch.sum(torch.sum(dv1 * dv1, dim=-1), dim=-1), min=1e-12)
    qa, ta, ea = finish(b1[..., None, None] * v1)
    if not n2:
        return qa, ta, ea

    L = torch.stack([torch.sum(dv1 * dv1, dim=-1),
                     2.0 * torch.sum(dv1 * dv2, dim=-1),
                     torch.sum(dv2 * dv2, dim=-1)], dim=-1)
    LtL = L.mT @ L + 1e-9 * _eye(3, L)
    y = torch.linalg.solve_ex(LtL, (L.mT @ rho[..., None]))[0][..., 0]
    b1_2 = torch.sqrt(torch.abs(y[..., 0]))
    b2_2 = torch.sqrt(torch.abs(y[..., 2])) * torch.sign(y[..., 1]) \
        * torch.sign(y[..., 0])
    qb, tb, eb = finish(b1_2[..., None, None] * v1 + b2_2[..., None, None]
                        * v2)
    better_b = eb < ea
    return (torch.where(better_b[..., None], qb, qa),
            torch.where(better_b[..., None], tb, ta),
            torch.where(better_b, eb, ea))


def _sanitize(q, t, err):
    finite = torch.all(torch.isfinite(q), dim=-1) & torch.all(
        torch.isfinite(t), dim=-1) & torch.isfinite(err)
    qid = _eye(4, q)[0]
    return (torch.where(finite[..., None], q, qid),
            torch.where(finite[..., None], t, torch.zeros_like(t)),
            torch.where(finite, err, torch.full_like(err, 1e9)))


def epnp_pose(pw, uv, w, fx, fy, cx, cy, full: bool = True):
    """Weighted EPnP: camera-from-world (q, t, mean weighted reprojection
    error) with no prior; batched over w's leading dims.  Degenerate input
    returns the identity with err 1e9.  full=False is the per-hypothesis
    variant (4 control points, beta case N=1 only)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    c0 = torch.sum(pw * w[..., None], dim=-2) / wsum
    d = pw - c0[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", w, d, d) / wsum[..., None]
    eval3, evec3 = sym_eigh_3x3(cov)
    scale = torch.sqrt(torch.maximum(eval3, 1e-6 * eval3[..., 2:3] + 1e-10))
    axes = evec3 * scale[..., None, :]  # columns = (c_i - c0)

    ctrl4 = torch.cat([c0[..., None, :], c0[..., None, :] + axes.mT], dim=-2)
    beta4 = torch.linalg.solve_ex(axes, d.mT)[0].mT
    alpha4 = torch.cat([1.0 - torch.sum(beta4, -1, keepdim=True), beta4], -1)
    q4, t4, e4 = _epnp_core(ctrl4, alpha4, pw, uv, w, fx, fy, cx, cy,
                            n2=full)
    if not full:
        return _sanitize(q4, t4, e4)

    ax2 = axes[..., :, 1:]  # [..., 3, 2] in-plane axes
    ctrl3 = torch.cat([c0[..., None, :], c0[..., None, :] + ax2.mT], dim=-2)
    A = ax2.mT @ ax2 + 1e-12 * _eye(2, ax2)
    beta3 = torch.linalg.solve_ex(A, ax2.mT @ d.mT)[0].mT
    alpha3 = torch.cat([1.0 - torch.sum(beta3, -1, keepdim=True), beta3], -1)
    q3, t3, e3 = _epnp_core(ctrl3, alpha3, pw, uv, w, fx, fy, cx, cy)
    planar = e3 < e4
    return _sanitize(torch.where(planar[..., None], q3, q4),
                     torch.where(planar[..., None], t3, t4),
                     torch.where(planar, e3, e4))


def solve_pnp_ransac(pw, uv, match_mask, q0, t0, fx, fy, cx, cy, key,
                     settings: PnPSettings = PnPSettings()) -> PnPResult:
    """Camera-from-world pose from 3D-2D correspondences: pw [N, 3],
    uv [N, 2], match_mask [N], (q0, t0) the guess, key a threefry key."""
    N = pw.shape[0]
    K = settings.iterations
    dtype = t0.dtype
    maskf = match_mask.to(dtype)
    reproj = settings.reproj_error

    def score(qh, th):
        errs = _reproj_errors(qh, th, pw, uv, fx, fy, cx, cy)
        inl = (errs <= reproj) & match_mask
        n = torch.sum(inl, dim=-1)
        mean_e = torch.sum(torch.where(inl, errs, torch.zeros_like(errs)),
                           dim=-1) / torch.clamp(n, min=1)
        return n.to(dtype) - 0.5 * mean_e / reproj

    # Hypotheses: random subsets without replacement via Gumbel top-k.
    keys = prng.split(key)
    n_sub = settings.epnp_subset if settings.flags >= 1 else 4
    g = prng.gumbel(keys[0], (K, N))
    ranked = torch.where(match_mask[None, :], g, torch.full_like(g, -math.inf))
    subset_idx = torch.sort(ranked, dim=-1, descending=True,
                            stable=True)[1][:, :n_sub]
    perturb = prng.normal(keys[1], (K, 6)) * settings.perturbation
    not_first = torch.arange(K, device=pw.device)[:, None] > 0
    perturb = torch.where(not_first, perturb, torch.zeros_like(perturb))

    sub_w = torch.zeros((K, N), dtype=dtype, device=pw.device).scatter(
        1, subset_idx, 1.0) * maskf
    qp, tp = apply_tangent(q0.expand(K, 4), t0.expand(K, 3), perturb)
    if settings.flags >= 1:
        qe, te, ee = epnp_pose(pw, uv, sub_w, fx, fy, cx, cy, full=False)
        use_prior = (ee >= 1e8)[:, None]
        qh = torch.where(use_prior, qp, qe)
        th = torch.where(use_prior, tp, te)
    else:
        qh, th = qp, tp
    qh, th = _gn_refine(qh, th, pw, uv, sub_w, fx, fy, cx, cy,
                        settings.gn_iterations)

    # Hypothesis 0 also scored as the pure guess.
    qs = torch.cat([q0[None], qh])
    ts = torch.cat([t0[None], th])
    scores = torch.cat([score(q0, t0)[None], score(qh, th)])
    if settings.flags >= 1:
        qg, tg, eg = epnp_pose(pw, uv, maskf, fx, fy, cx, cy)
        qg2, tg2 = _gn_refine(qg, tg, pw, uv, maskf, fx, fy, cx, cy,
                              settings.gn_iterations)
        scoreg = torch.where(eg >= 1e8, torch.full_like(eg, -1.0),
                             score(qg2, tg2))
        qs = torch.cat([qs, qg2[None]])
        ts = torch.cat([ts, tg2[None]])
        scores = torch.cat([scores, scoreg[None]])
    best = torch.argmax(scores)[None]  # a 1-d index: no host read
    q, t = qs[best][0], ts[best][0]

    # Refinement: IRLS with the variance-adaptive threshold.
    thresh = torch.full((), reproj, dtype=dtype, device=pw.device)
    for _ in range(settings.refine_steps_per_round
                   * settings.refine_iterations):
        errs = _reproj_errors(q, t, pw, uv, fx, fy, cx, cy)
        w = ((errs <= thresh) & match_mask).to(dtype)
        q2, t2 = _gn_refine(q, t, pw, uv, w, fx, fy, cx, cy, 1)
        errs2 = _reproj_errors(q2, t2, pw, uv, fx, fy, cx, cy)
        inl2 = (errs2 <= thresh) & match_mask
        n2 = torch.sum(inl2)
        zero = torch.zeros_like(errs2)
        mean = torch.sum(torch.where(inl2, errs2, zero)) / torch.clamp(n2,
                                                                        min=1)
        var = torch.sum(torch.where(inl2, (errs2 - mean) ** 2, zero)) \
            / torch.clamp(n2 - 1, min=1)
        new_thresh = torch.clamp(settings.refine_sigma * torch.sqrt(var),
                                 max=reproj)
        keep = n2 >= settings.min_inliers
        q = torch.where(keep, q2, q)
        t = torch.where(keep, t2, t)
        thresh = torch.where(keep, new_thresh, thresh)

    errs = _reproj_errors(q, t, pw, uv, fx, fy, cx, cy)
    inliers = (errs <= reproj) & match_mask
    n_inliers = torch.sum(inliers)
    mean_err = torch.sum(torch.where(inliers, errs, torch.zeros_like(errs))) \
        / torch.clamp(n_inliers, min=1)
    return PnPResult(q=q, t=t, inliers=inliers, n_inliers=n_inliers,
                     ok=n_inliers >= settings.min_inliers, mean_err=mean_err)
