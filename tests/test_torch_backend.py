"""visfs_tpu_torch PnP RANSAC, BA factors and local BA against visfs_tpu on
the same numpy-seeded problems.

Tolerances: PnP on the same threefry key — inlier mask equal, pose atol
1e-4; local_optimize on one BAProblem — poses and landmarks atol 1e-4,
outlier flags equal; factor Jacobians atol 1e-4 relative to entries of
order 1e2 (float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.core import lie as jlie
from visfs_tpu.ops import pnp as jpnp
from visfs_tpu.solver import ba as jba
from visfs_tpu.solver import factors as jfac
from visfs_tpu_torch.core import prng
from visfs_tpu_torch.ops import pnp as tpnp
from visfs_tpu_torch.solver import ba as tba
from visfs_tpu_torch.solver import factors as tfac

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

FX, FY, CX, CY = 400.0, 400.0, 320.0, 240.0


def _t(a):
    return torch.from_numpy(np.array(a))


# --- PnP --------------------------------------------------------------------

def pnp_problem(seed, n=80, n_outliers=12, n_masked=10):
    rng = np.random.default_rng(seed)
    pw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(3, 10, n)], -1).astype(np.float32)
    d = (rng.normal(size=6) * 0.08).astype(np.float32)
    q, t = (np.asarray(x) for x in jlie.pose_update(
        jlie.quat_identity(), jnp.zeros(3), jnp.asarray(d)))
    pc = np.asarray(jlie.quat_rotate(jnp.asarray(q), jnp.asarray(pw))) + t
    uv = np.stack([pc[:, 0] / pc[:, 2] * FX + CX,
                   pc[:, 1] / pc[:, 2] * FY + CY], -1).astype(np.float32)
    uv += rng.normal(scale=0.3, size=uv.shape).astype(np.float32)
    bad = rng.choice(n, n_outliers, replace=False)
    uv[bad] += rng.uniform(15, 40, (n_outliers, 2)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[rng.choice(n, n_masked, replace=False)] = False
    q0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    t0 = np.zeros(3, np.float32)
    return pw, uv, mask, q0, t0


@pytest.fixture(scope="module", params=[0, 1], ids=["seed0", "seed1"])
def pnp_pair(request):
    seed = request.param
    args = pnp_problem(seed)
    key = 100 + seed
    ref = jax.jit(lambda *a: jpnp.solve_pnp_ransac(
        *a, FX, FY, CX, CY, jax.random.PRNGKey(key), jpnp.PnPSettings()))(
        *args)
    port = tpnp.solve_pnp_ransac(
        *(_t(a) for a in args), torch.tensor(FX), torch.tensor(FY),
        torch.tensor(CX), torch.tensor(CY), prng.PRNGKey(key),
        tpnp.PnPSettings())
    return ref, port


def test_pnp_inliers_equal(pnp_pair):
    ref, port = pnp_pair
    np.testing.assert_array_equal(port.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert int(port.n_inliers) == int(ref.n_inliers) >= 40
    assert bool(port.ok) == bool(ref.ok)


def test_pnp_pose_matches(pnp_pair):
    ref, port = pnp_pair
    np.testing.assert_allclose(port.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(port.q.numpy(), np.asarray(ref.q), atol=1e-4)
    np.testing.assert_allclose(float(port.mean_err), float(ref.mean_err),
                               atol=1e-4)


def test_epnp_and_eigh_match():
    pw, uv, mask, _, _ = pnp_problem(3, n_outliers=0, n_masked=0)
    w = mask.astype(np.float32)
    ref = jax.jit(lambda a, b, c: (
        jpnp.epnp_pose(a, b, c, FX, FY, CX, CY),
        jpnp.sym_eigh_3x3(jnp.cov(a.T))))(pw, uv, w)
    port_pose = tpnp.epnp_pose(_t(pw), _t(uv), _t(w), FX, FY, CX, CY)
    port_eig = tpnp.sym_eigh_3x3(torch.from_numpy(
        np.cov(pw.T).astype(np.float32)))
    for r, p in zip(ref[0], port_pose):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-4)
    np.testing.assert_allclose(port_eig[0].numpy(), np.asarray(ref[1][0]),
                               rtol=1e-5)
    # eigenvectors up to sign
    np.testing.assert_allclose(np.abs(port_eig[1].numpy()),
                               np.abs(np.asarray(ref[1][1])), atol=1e-5)


# --- BA ---------------------------------------------------------------------

P, L = 6, 60


def ba_problem(seed):
    """A forward-moving camera observing a wall of points (Tcw poses), with
    pixel noise, perturbed initial poses/landmarks, outlier edges, a fixed
    root and STABLE landmarks."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, bf = 400.0, 400.0, 320.0, 240.0, 40.0
    q_cw, t_cw = [], []
    for i in range(P):
        ang = 0.01 * i
        q_wc = np.array([np.cos(ang / 2), 0, np.sin(ang / 2), 0], np.float32)
        t_wc = np.array([0.02 * i, 0.0, 0.1 * i], np.float32)
        qi, ti = jlie.se3_inv((jnp.asarray(q_wc), jnp.asarray(t_wc)))
        q_cw.append(np.asarray(qi))
        t_cw.append(np.asarray(ti))
    q_cw, t_cw = np.stack(q_cw), np.stack(t_cw)
    lm = np.stack([rng.uniform(-2.5, 2.5, L), rng.uniform(-1.8, 1.8, L),
                   rng.uniform(3.0, 8.0, L)], -1).astype(np.float32)
    pc = np.asarray(jlie.quat_rotate(jnp.asarray(q_cw)[None],
                                     jnp.asarray(lm)[:, None])) + t_cw[None]
    u = pc[..., 0] / pc[..., 2] * fx + cx
    v = pc[..., 1] / pc[..., 2] * fy + cy
    obs = np.stack([u, v, u - bf / pc[..., 2]], -1).astype(np.float32)
    obs += rng.normal(scale=0.5, size=obs.shape).astype(np.float32)
    bad = rng.choice(L, 5, replace=False)
    obs[bad, P - 1, :2] += 40.0
    obs_mask = rng.uniform(size=(L, P)) > 0.1
    pq, pt = [q_cw[0]], [t_cw[0]]
    for i in range(1, P):
        d = (rng.normal(size=6) * 0.02).astype(np.float32)
        a, b = jfac.apply_tangent(jnp.asarray(q_cw[i]), jnp.asarray(t_cw[i]),
                                  jnp.asarray(d))
        pq.append(np.asarray(a))
        pt.append(np.asarray(b))
    lm0 = lm + rng.normal(scale=0.05, size=lm.shape).astype(np.float32)
    pose_valid = np.ones(P, bool)
    pose_fixed = np.zeros(P, bool)
    pose_fixed[P - 2] = True
    lm_valid = np.ones(L, bool)
    lm_valid[:3] = False
    lm_fixed = np.zeros(L, bool)
    lm_fixed[3:9] = True
    return dict(
        pose_q=np.stack(pq), pose_t=np.stack(pt), pose_valid=pose_valid,
        pose_fixed=pose_fixed, lm_pos=lm0, lm_valid=lm_valid,
        lm_fixed=lm_fixed, obs=obs, obs_mask=obs_mask,
        link_q=np.tile(np.array([1.0, 0, 0, 0], np.float32), (P - 1, 1)),
        link_t=np.zeros((P - 1, 3), np.float32),
        link_mask=np.zeros(P - 1, bool),
    ), (fx, fy, cx, cy, bf)


@pytest.fixture(scope="module")
def ba_pair():
    arrays, intr = ba_problem(5)
    settings = dict(iterations=20, pixel_variance=1.5, robust_delta=8.0)
    jprob = jba.BAProblem(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        intr=jfac.StereoIntrinsics(*(jnp.float32(x) for x in intr)))
    ref = jax.jit(lambda p: jba.local_optimize(
        p, jba.BASettings(**settings)))(jprob)
    tprob = tba.BAProblem(
        **{k: _t(v) for k, v in arrays.items()},
        intr=tfac.StereoIntrinsics(*(torch.tensor(x) for x in intr)))
    port = tba.local_optimize(tprob, tba.BASettings(**settings))
    return ref, port


def test_ba_poses_match(ba_pair):
    ref, port = ba_pair
    assert bool(port.ok) and bool(ref.ok)
    np.testing.assert_allclose(port.pose_t.numpy(), np.asarray(ref.pose_t),
                               atol=1e-4)
    np.testing.assert_allclose(port.pose_q.numpy(), np.asarray(ref.pose_q),
                               atol=1e-4)


def test_ba_landmarks_match(ba_pair):
    ref, port = ba_pair
    np.testing.assert_allclose(port.lm_pos.numpy(), np.asarray(ref.lm_pos),
                               atol=1e-4)


def test_ba_outliers_equal(ba_pair):
    ref, port = ba_pair
    np.testing.assert_array_equal(port.outliers.numpy(),
                                  np.asarray(ref.outliers))
    assert port.outliers.sum() >= 3
    np.testing.assert_allclose(float(port.chi2), float(ref.chi2), rtol=1e-4)


def test_factor_jacobians_and_solves_match():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.normal(size=(5, 4)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    mq = rng.normal(size=(5, 4)).astype(np.float32)
    mq /= np.linalg.norm(mq, axis=1, keepdims=True)
    t, t2, mt = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3))
    pw = np.stack([rng.uniform(-2, 2, 5), rng.uniform(-2, 2, 5),
                   rng.uniform(2, 9, 5)], -1).astype(np.float32)
    A = rng.normal(size=(5, 6, 6)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    g = rng.normal(size=(5, 6)).astype(np.float32)
    intr = (400.0, 410.0, 320.0, 240.0, 40.0)
    jint = jfac.StereoIntrinsics(*(jnp.float32(x) for x in intr))
    tint = tfac.StereoIntrinsics(*(torch.tensor(x) for x in intr))
    ref = jax.jit(lambda *a: (
        jax.vmap(jfac.pose_link_jacobians)(*a[:6]),
        jax.vmap(jfac.stereo_jacobians, in_axes=(0, 0, 0, None))(
            a[0], a[1], a[6], jint),
        jfac.solve6x6_spd(a[7], a[8]), jfac.inv3x3(a[7][:, :3, :3]),
        jfac.huber_weight(jnp.abs(a[8]) * 20.0, 8.0)))(
        q, t, q2, t2, mq, mt, pw, H, g)
    port = (tfac.pose_link_jacobians(*(_t(a) for a in (q, t, q2, t2, mq, mt))),
            tfac.stereo_jacobians(_t(q), _t(t), _t(pw), tint),
            tfac.solve6x6_spd(_t(H), _t(g)),
            tfac.inv3x3(_t(H)[:, :3, :3]),
            tfac.huber_weight(_t(np.abs(g) * 20.0), 8.0))
    flat_r = jax.tree_util.tree_leaves(ref)
    flat_p = [x for grp in port for x in (grp if isinstance(grp, tuple)
                                           else (grp,))]
    for r, p in zip(flat_r, flat_p):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-5)
