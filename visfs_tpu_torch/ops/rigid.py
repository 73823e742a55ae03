"""Rigid 3D-3D alignment: weighted Kabsch and RANSAC (torch port of
visfs_tpu.ops.rigid).

The reference solves Kabsch with ``jnp.linalg.svd`` and ``det`` on the
3x3 covariance; on CUDA ``torch.linalg.svd`` waits for the host.  The port
takes the same rotation from Horn's quaternion form instead: the optimal
proper rotation is the top eigenvector of the 4x4 symmetric matrix N built
linearly from the covariance, which is Kabsch with its reflection fix.  The
eigenvector comes from repeated squaring of N shifted to be positive
semi-definite (no data-dependent loop, no host sync), in float64, so a
minimal 3-point set (rank-2 covariance, a gap of 2 sigma_2 between N's top
two eigenvalues) converges as well as a general one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import prng
from ..core.lie import quat_to_mat

# Squarings of the shifted N: its top two eigenvalues differ by at least
# ~0.7 sigma_2 / sigma_1 relative, so 2**24 powers leave the second
# eigenvector's share below e**-16 down to sigma_2 / sigma_1 ~ 1.5e-6.
_SQUARINGS = 24


class RigidResult(NamedTuple):
    rotation: torch.Tensor  # [3, 3] R with a ~= R @ b + t
    translation: torch.Tensor  # [3]
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # int
    ok: torch.Tensor  # bool


def _horn_matrix(H):
    """Horn's symmetric 4x4 N [..., 4, 4] of the covariance H = sum w b a^T
    (a ~= R b): its top eigenvector is R's quaternion."""
    s = [[H[..., i, j] for j in range(3)] for i in range(3)]
    rows = [
        [s[0][0] + s[1][1] + s[2][2], s[1][2] - s[2][1], s[2][0] - s[0][2],
         s[0][1] - s[1][0]],
        [s[1][2] - s[2][1], s[0][0] - s[1][1] - s[2][2], s[0][1] + s[1][0],
         s[2][0] + s[0][2]],
        [s[2][0] - s[0][2], s[0][1] + s[1][0], s[1][1] - s[0][0] - s[2][2],
         s[1][2] + s[2][1]],
        [s[0][1] - s[1][0], s[2][0] + s[0][2], s[1][2] + s[2][1],
         s[2][2] - s[0][0] - s[1][1]],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _top_eigvec4(N):
    """Unit top eigenvector (w >= 0) of symmetric [..., 4, 4] N with trace
    0.  Its eigenvalues lie within +-sqrt(3)|H|_F = +-sqrt(3/4)|N|_F, so N
    + c I with c = |N|_F is positive semi-definite with the same top
    eigenvector; squaring it (normalized by the trace) converges to the
    projector on that eigenvector.  A zero N gives the identity rotation,
    as the reference's SVD of a zero covariance does."""
    eye = torch.eye(4, dtype=N.dtype, device=N.device)
    c = torch.sqrt(torch.sum(N * N, dim=(-2, -1)))
    M = N + (c[..., None, None] + 1e-30) * eye
    for _ in range(_SQUARINGS):
        M = M @ M
        M = M / (M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
                 + M[..., 3, 3])[..., None, None]
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    col = torch.argmax(diag, dim=-1)  # the first maximum
    v = torch.take_along_dim(M, col[..., None, None].expand(
        col.shape + (4, 1)), dim=-1)[..., 0]
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-300)
    return torch.where(v[..., 0:1] < 0, -v, v)


def kabsch(p_a, p_b, w):
    """Weighted least-squares rigid transform: argmin sum w |a - (R b + t)|^2.

    p_a, p_b: [N, 3] (or batched [..., N, 3]); w: [..., N] non-negative
    weights.  Returns (R [..., 3, 3], t [..., 3]).  Degenerate weight sets
    (sum ~ 0, collinear points) give a finite but meaningless transform;
    callers gate on the inlier count."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    mu_a = torch.einsum("...n,...ni->...i", w, p_a) / wsum
    mu_b = torch.einsum("...n,...ni->...i", w, p_b) / wsum
    ca = p_a - mu_a[..., None, :]
    cb = p_b - mu_b[..., None, :]
    H = torch.einsum("...n,...ni,...nj->...ij", w, cb, ca)  # b -> a
    q = _top_eigvec4(_horn_matrix(H.double())).to(p_a.dtype)
    R = quat_to_mat(q)
    t = mu_a - (R @ mu_b[..., None])[..., 0]
    return R, t


def _residuals(p_a, p_b, R, t):
    """|a - (R b + t)| [..., N] for batched (R, t)."""
    return torch.linalg.vector_norm(
        p_a - (p_b @ R.mT + t[..., None, :]), dim=-1)


def estimate_rigid_3d(p_a, p_b, mask, key, n_hypotheses: int = 32,
                      inlier_threshold: float = 0.15,
                      min_inliers: int = 6, refine_iterations: int = 3,
                      point_sigma=None) -> RigidResult:
    """RANSAC rigid alignment of matched 3D point sets.

    p_a/p_b: [N, 3] corresponding points, mask: [N] valid matches, key a
    threefry key.  Minimal 3-point Kabsch hypotheses (subsets by Gumbel
    top-3) scored by 3D inlier count, then ``refine_iterations`` refits on
    the inlier set.  point_sigma: optional [N] per-match 1-sigma 3D
    uncertainty; the gate becomes max(inlier_threshold, 3 sigma), subsets
    lean to certain points and the refit is inverse-variance weighted."""
    N = p_a.shape[0]
    dtype = p_a.dtype
    maskf = mask.to(dtype)
    if point_sigma is None:
        thresh = torch.full((N,), inlier_threshold, dtype=dtype,
                            device=p_a.device)
        conf = torch.zeros((N,), dtype=dtype, device=p_a.device)
        wref = maskf
    else:
        thresh = torch.clamp(3.0 * point_sigma, min=inlier_threshold)
        conf = -torch.log(torch.clamp(point_sigma, min=1e-4))
        wref = maskf / torch.clamp(point_sigma, min=1e-4) ** 2

    g = prng.gumbel(key, (n_hypotheses, N))
    scores = torch.where(mask[None, :], g + conf[None, :],
                         torch.full_like(g, -torch.inf))
    # lax.top_k order: ties to the lower index
    subsets = torch.sort(scores, dim=-1, descending=True,
                         stable=True)[1][:, :3]
    w = torch.zeros((n_hypotheses, N), dtype=dtype,
                    device=p_a.device).scatter(1, subsets, 1.0) * maskf
    Rs, ts = kabsch(p_a, p_b, w)
    counts = torch.sum((_residuals(p_a, p_b, Rs, ts) <= thresh) & mask,
                       dim=-1)
    best = torch.argmax(counts).reshape(1)  # a 1-d index: no host read
    R = torch.index_select(Rs, 0, best)[0]
    t = torch.index_select(ts, 0, best)[0]

    for _ in range(refine_iterations):
        inl = (_residuals(p_a, p_b, R, t) <= thresh) & mask
        R2, t2 = kabsch(p_a, p_b, inl.to(dtype) * wref)
        keep = torch.sum(inl) >= 3
        R = torch.where(keep, R2, R)
        t = torch.where(keep, t2, t)
    inliers = (_residuals(p_a, p_b, R, t) <= thresh) & mask
    n_inl = torch.sum(inliers)
    finite = torch.all(torch.isfinite(R)) & torch.all(torch.isfinite(t))
    return RigidResult(rotation=R, translation=t, inliers=inliers,
                       n_inliers=n_inl, ok=finite & (n_inl >= min_inliers))
