"""visfs_tpu_torch.ops.rigid and ops.image.extract_patch_bilinear against
visfs_tpu's on the same seeded inputs.

The port's Kabsch takes the rotation from Horn's quaternion form (no SVD:
on CUDA it would wait for the host), which is Kabsch with the reflection
fix.  Tolerances: R and t within 1e-4 where the weighted covariance's
sigma_2 / sigma_1 > 1e-3 (there the rotation is determined; below it the
reference's float32 SVD itself is unstable, and with zero weights or
collinear points both return a finite but meaningless transform, which is
only checked to be a rotation).  estimate_rigid_3d on
tests/test_mapping.py's two scenes and keys: identical inlier masks and ok,
R and t within 1e-4.  extract_patch_bilinear within 1e-4 levels on an
8-bit-level image, centres at the border included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.core.lie import xyzrpy_to_mat
from visfs_tpu.ops import image as jimage
from visfs_tpu.ops import rigid as jrigid
from visfs_tpu_torch.core import prng
from visfs_tpu_torch.ops import image as timage
from visfs_tpu_torch.ops import rigid as trigid

torch.set_num_threads(1)

_kabsch_jit = jax.jit(jrigid.kabsch)
_rigid_jit = jax.jit(jrigid.estimate_rigid_3d,
                     static_argnames=("n_hypotheses", "min_inliers"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rotation(rng):
    a = rng.normal(size=3)
    return np.asarray(xyzrpy_to_mat(*[jnp.float32(v) for v in
                                      (*rng.normal(size=3), *a)]))


def kabsch_case(name):
    """(p_a, p_b, w) float32 for a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 3 if name.startswith("three") else 24
    T = _rotation(rng)
    p_b = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    p_a = p_b @ T[:3, :3].T + T[:3, 3] \
        + rng.normal(scale=0.01, size=(n, 3))
    w = rng.uniform(0.2, 1.0, n)
    if name == "reflection":
        p_a[:, 2] *= -1.0  # a mirror image: the best proper rotation
    if name == "masked":
        w[rng.choice(n, n // 2, replace=False)] = 0.0
    if name == "zero_weights":
        w[:] = 0.0
    if name == "collinear":
        p_b = np.outer(rng.uniform(-2, 2, n), [0.3, -0.5, 0.8])
        p_a = p_b @ T[:3, :3].T + T[:3, 3]
    return (p_a.astype(np.float32), p_b.astype(np.float32),
            w.astype(np.float32))


def sigma_ratio(p_a, p_b, w):
    """sigma_2 / sigma_1 of the weighted covariance (float64)."""
    w = w.astype(np.float64)
    ws = max(w.sum(), 1e-9)
    ca = p_a - (w[:, None] * p_a).sum(0) / ws
    cb = p_b - (w[:, None] * p_b).sum(0) / ws
    s = np.linalg.svd(np.einsum("n,ni,nj->ij", w, cb, ca), compute_uv=False)
    return s[1] / max(s[0], 1e-30)


KABSCH_CASES = ["general", "general_b", "three_a", "three_b", "three_c",
                "reflection", "masked", "zero_weights", "collinear"]


@pytest.mark.parametrize("name", KABSCH_CASES)
def test_kabsch_matches_reference(name):
    p_a, p_b, w = kabsch_case(name)
    R_r, t_r = (np.asarray(x) for x in _kabsch_jit(p_a, p_b, w))
    R, t = trigid.kabsch(_t(p_a), _t(p_b), _t(w))
    R, t = R.numpy(), t.numpy()
    assert np.all(np.isfinite(R)) and np.all(np.isfinite(t))
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(R) - 1.0) < 1e-5
    determined = sigma_ratio(p_a, p_b, w) > 1e-3
    assert determined == (name not in ("zero_weights", "collinear"))
    if determined:
        np.testing.assert_allclose(R, R_r, atol=1e-4)
        np.testing.assert_allclose(t, t_r, atol=1e-4)


def test_kabsch_batched_matches_one_by_one():
    cases = [kabsch_case(n) for n in ("three_a", "three_b", "three_c")]
    p_a, p_b, _ = cases[0]
    w = np.stack([c[2] for c in cases])
    R, t = trigid.kabsch(_t(p_a), _t(p_b), _t(w))
    for k in range(3):
        R1, t1 = trigid.kabsch(_t(p_a), _t(p_b), _t(w[k]))
        np.testing.assert_allclose(R[k].numpy(), R1.numpy(), atol=1e-6)
        np.testing.assert_allclose(t[k].numpy(), t1.numpy(), atol=1e-6)


def rigid_scene(name):
    """tests/test_mapping.py:192-230's scenes: (p_a, p_b, mask, key,
    min_inliers)."""
    if name == "outliers":
        rng = np.random.default_rng(7)
        T = np.asarray(xyzrpy_to_mat(*[jnp.float32(v) for v in
                                       (0.4, -0.2, 0.1, 0.1, -0.2, 1.2)]))
        p_j = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
        p_i = (p_j @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        bad = rng.choice(40, 12, replace=False)
        p_i[bad] += rng.uniform(1, 3, (12, 3)).astype(np.float32)
        return p_i, p_j, np.ones(40, bool), 0, 6
    rng = np.random.default_rng(8)
    a = rng.uniform(-2, 2, (30, 3)).astype(np.float32)
    b = rng.uniform(-2, 2, (30, 3)).astype(np.float32)
    return a, b, np.ones(30, bool), 1, 8


@pytest.mark.parametrize("name", ["outliers", "noise"])
def test_estimate_rigid_3d_matches_reference(name):
    p_a, p_b, mask, key, min_inl = rigid_scene(name)
    ref = _rigid_jit(p_a, p_b, mask, jax.random.PRNGKey(key),
                     min_inliers=min_inl)
    port = trigid.estimate_rigid_3d(_t(p_a), _t(p_b), _t(mask),
                                    prng.PRNGKey(key), min_inliers=min_inl)
    np.testing.assert_array_equal(port.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert bool(port.ok) == bool(ref.ok) == (name == "outliers")
    assert int(port.n_inliers) == int(ref.n_inliers)
    if name == "outliers":
        np.testing.assert_allclose(port.rotation.numpy(),
                                   np.asarray(ref.rotation), atol=1e-4)
        np.testing.assert_allclose(port.translation.numpy(),
                                   np.asarray(ref.translation), atol=1e-4)


_patch_jit = {s: jax.jit(jax.vmap(
    lambda img, c, s=s: jimage.extract_patch_bilinear(img, c, s),
    in_axes=(None, 0))) for s in (8, 24, 48)}


@pytest.mark.parametrize("size", [8, 24, 48])
def test_extract_patch_bilinear_matches_reference(size):
    rng = np.random.default_rng(size)
    h, w = 60, 80
    img = np.round(rng.uniform(0, 255, (h, w))).astype(np.float32)
    inner = rng.uniform([0, 0], [w, h], (40, 2))
    border = np.array([[-3.2, 5.5], [w + 2.7, h - 1.2], [0.4, -6.0],
                       [w - 0.3, h + 4.1], [size / 2 + 0.25, 30.5],
                       [w - size / 2 - 1.75, h - size / 2 - 1.5]])
    c = np.concatenate([inner, border]).astype(np.float32)
    ref = np.asarray(_patch_jit[size](img, c))
    out = timage.extract_patch_bilinear(_t(img), _t(c), size).numpy()
    assert out.shape == (len(c), size, size)
    np.testing.assert_allclose(out, ref, atol=1e-4)
