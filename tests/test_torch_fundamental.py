"""visfs_tpu_torch.ops.fundamental against visfs_tpu.ops.fundamental.

The port never calls eigh or svd (their CUDA versions synchronise with the
host): the null vector of each hypothesis's 9x9 normal matrix comes from
shifted inverse iteration and the rank-2 projection from the closed-form
3x3 eigensolver.  Tolerances: _normalize and sampson_distance rtol 1e-5;
the null vector against numpy.linalg.eigh (float64) within 1e-4 up to sign;
the rank-2 projection against the SVD's within 1e-5.  The cull on
tests/test_fundamental.py's scenes and keys: identical inlier masks, and
each hypothesis's F equal to the reference's up to scale and sign within
1e-3 relative where the sample determines F (the float64 normal matrix's
second-smallest eigenvalue above 3e-5 of its largest).  Below that the null
space is near two-dimensional and the reference's own float32 eigh leaves
the float64 solution by up to 1.5e-2, so F follows the rounding there: on
test_separates_outliers' scene the reference, run eagerly as that test runs
it, scores a degenerate sample (second eigenvalue 1.6e-8 of the largest)
with all 100 inliers, as it does not when jitted; the masks agree all the
same.  The reference runs jitted here, as the tracker runs it."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.ops import fundamental as jf
from visfs_tpu_torch.core import prng
from visfs_tpu_torch.ops import fundamental as tf

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_fundamental import make_scene  # noqa: E402

torch.set_num_threads(1)

# tests/test_fundamental.py's cases: (outliers, mask prefix, key,
# threshold, hypotheses)
CASES = {"separates_outliers": (20, None, 0, 1.5, 64),
         "epipolar_constraint": (0, None, 1, 1.0, 32),
         "mask_respected": (0, 60, 2, 1.0, 32)}
WELL_POSED = 3e-5
# jitted, as the tracker runs it (and one compile a case, not one an op)
_cull_jit = jax.jit(jf.cull_with_fundamental,
                    static_argnames=("threshold", "hypotheses"))


def _scene(name):
    outliers, prefix, key, thr, hyp = CASES[name]
    p1, p2, gt_out = make_scene(np.random.default_rng(42), outliers=outliers)
    mask = np.ones(p1.shape[0], bool)
    if prefix:
        mask[prefix:] = False
    return (np.asarray(p1), np.asarray(p2), mask, gt_out, key, thr, hyp)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_normalize_matches_reference():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 640, (90, 2)).astype(np.float32)
    mask = rng.uniform(size=90) > 0.3
    pn_r, T_r = jax.jit(jf._normalize)(jnp.asarray(pts), jnp.asarray(mask))
    pn, T = tf._normalize(_t(pts), _t(mask))
    np.testing.assert_allclose(pn.numpy(), np.asarray(pn_r), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(T.numpy(), np.asarray(T_r), rtol=1e-5)


def test_sampson_distance_matches_reference():
    p1, p2, _, _, _, _, _ = _scene("separates_outliers")
    F = np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jf.sampson_distance)(jnp.asarray(F), p1, p2))
    out = tf.sampson_distance(_t(F), _t(p1), _t(p2))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    # batched over hypotheses
    Fs = np.stack([F, 2 * F.T])
    out2 = tf.sampson_distance(_t(Fs), _t(p1), _t(p2))
    np.testing.assert_allclose(out2[0].numpy(), out.numpy(), rtol=1e-6)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_null_vector_matches_eigh(seed):
    """The sync-free null vector of A^T A for 16 batched 8-row selections A
    [8, 9] (rank 8, a one-dimensional null space) against numpy's float64
    eigh of the same float32 matrix, up to sign."""
    from visfs_tpu_torch.ops.pnp import _smallest_two_eigvecs

    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.normal(size=(16, 8, 9)))
    M = (A.transpose(-1, -2) @ A).float()
    f, _ = _smallest_two_eigvecs(M, second=False)
    for k in range(16):
        _, V = np.linalg.eigh(M[k].double().numpy())
        ref = V[:, 0] * np.sign(V[:, 0] @ f[k].double().numpy())
        np.testing.assert_allclose(f[k].numpy(), ref, atol=1e-4)


def test_rank2_projection_matches_svd():
    rng = np.random.default_rng(11)
    F = rng.normal(size=(32, 3, 3))
    F /= np.linalg.norm(F, axis=(1, 2), keepdims=True)
    U, S, Vt = np.linalg.svd(F)
    S[:, 2] = 0.0
    ref = (U * S[:, None, :]) @ Vt
    Ft = torch.from_numpy(F).float()
    from visfs_tpu_torch.ops.pnp import sym_eigh_3x3

    _, V = sym_eigh_3x3(Ft.transpose(-1, -2) @ Ft)
    v3 = V[..., :, 0:1]
    out = Ft - (Ft @ v3) @ v3.transpose(-1, -2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert np.abs(np.linalg.det(out.double().numpy())).max() < 1e-6


def _reference_hypotheses(p1, p2, mask, key, hyp):
    """The reference cull's per-hypothesis normalized F, jitted as the
    tracker runs it (visfs_tpu/ops/fundamental.py:81-103)."""
    n = p1.shape[0]

    def fits(p1, p2, mask, key):
        p1n, _ = jf._normalize(p1, mask)
        p2n, _ = jf._normalize(p2, mask)
        g = jax.random.gumbel(key, (hyp, n), dtype=p1.dtype)
        _, sel = jax.lax.top_k(jnp.where(mask[None], g, -jnp.inf), 8)

        def fit(s):
            w = jnp.zeros(n, p1.dtype).at[s].set(1.0) * mask
            return jf._eight_point(p1n, p2n, w)
        return jax.vmap(fit)(sel), sel
    Fn, sel = jax.jit(fits)(p1, p2, jnp.asarray(mask),
                            jax.random.PRNGKey(key))
    return np.asarray(Fn), np.asarray(sel)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cull_matches_reference(name):
    p1, p2, mask, gt_out, key, thr, hyp = _scene(name)
    inl_r, _ = _cull_jit(p1, p2, jnp.asarray(mask), jax.random.PRNGKey(key),
                         threshold=thr, hypotheses=hyp)
    inl, F = tf.cull_with_fundamental(_t(p1), _t(p2), _t(mask),
                                      prng.PRNGKey(key), threshold=thr,
                                      hypotheses=hyp)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_r))
    assert F.shape == (3, 3) and bool(torch.isfinite(F).all())
    # the reference's own assertions on the port's output
    assert not inl.numpy()[~mask].any()
    if name == "separates_outliers":
        assert not inl.numpy()[gt_out].any()
        assert inl.numpy()[~gt_out].mean() > 0.9
    if name == "epipolar_constraint":
        d = tf.sampson_distance(F, _t(p1), _t(p2)).numpy()
        assert np.median(d) < 0.5


@pytest.mark.parametrize("name", sorted(CASES))
def test_hypotheses_match_reference(name):
    """Each hypothesis's sample and, where the sample determines F, its
    normalized F up to scale and sign within 1e-3 relative."""
    p1, p2, mask, _, key, _, hyp = _scene(name)
    Fn_r, sel_r = _reference_hypotheses(p1, p2, mask, key, hyp)
    t1, t2, tm = _t(p1), _t(p2), _t(mask)
    p1n, _ = tf._normalize(t1, tm)
    p2n, _ = tf._normalize(t2, tm)
    n = p1.shape[0]
    g = prng.gumbel(prng.PRNGKey(key), (hyp, n))
    sel = torch.topk(torch.where(tm[None], g, torch.full_like(g, -np.inf)),
                     8, dim=1).indices
    assert [set(a) for a in sel.tolist()] == [set(a) for a in
                                              sel_r.tolist()]
    w = torch.zeros((hyp, n)).scatter(1, sel, 1.0) * tm
    Fn = tf._eight_point(p1n, p2n, w).numpy()
    A = _normal_rows_of(p1n.double(), p2n.double())
    checked = 0
    for k in range(hyp):
        Ak = A * w[k].double().numpy()[:, None]
        ev = np.linalg.eigvalsh(Ak.T @ Ak)
        if ev[1] < WELL_POSED * ev[-1]:
            continue
        a = Fn_r[k] / np.linalg.norm(Fn_r[k])
        b = Fn[k] / np.linalg.norm(Fn[k])
        b = b * np.sign(np.sum(a * b))
        assert np.abs(a - b).max() <= 1e-3 * np.abs(a).max(), k
        checked += 1
    assert checked >= 1


def _normal_rows_of(p1n, p2n):
    x1, y1 = p1n[:, 0].numpy(), p1n[:, 1].numpy()
    x2, y2 = p2n[:, 0].numpy(), p2n[:, 1].numpy()
    return np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     np.ones_like(x1)], axis=-1)


def test_mask_respected():
    p1, p2, mask, _, key, thr, hyp = _scene("mask_respected")
    inl, _ = tf.cull_with_fundamental(_t(p1), _t(p2), _t(mask),
                                      prng.PRNGKey(key), threshold=thr,
                                      hypotheses=hyp)
    assert not inl.numpy()[60:].any()
    assert inl.numpy()[:60].mean() > 0.9
    # no valid correspondence (the tracker's first frame): no inlier
    inl0, _ = tf.cull_with_fundamental(
        _t(p1), _t(p2), torch.zeros(len(mask), dtype=torch.bool),
        prng.PRNGKey(key))
    assert not bool(inl0.any())


def test_chip_smoke_scene_matches_reference_scene():
    """chip_smoke.py's phase cull draws tests/test_fundamental.py's scene
    from its own copy of make_scene (the card's script imports no JAX):
    the same arrays, bit for bit, for the same seed."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import fundamental_scene

    for outliers in (0, 20):
        ref = make_scene(np.random.default_rng(42), outliers=outliers)
        got = fundamental_scene(np.random.default_rng(42), outliers=outliers)
        for a, b in zip(ref, got):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)
