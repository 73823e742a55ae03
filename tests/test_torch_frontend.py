"""visfs_tpu_torch GFTT detection and the textured simulator against
visfs_tpu on the same inputs.

GFTT: the same point set (and scores to rtol 1e-4).  Simulator: the same
ground-truth poses and wheel odometry (exactly), and after 8-bit
quantisation at least 99.9 % of pixels equal with none off by more than 1
(float32 renders whose sums are ordered alike)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.io import sim as jsim
from visfs_tpu.ops import gftt as jgftt
from visfs_tpu_torch.io import sim as tsim
from visfs_tpu_torch.ops import gftt as tgftt

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

SIM_KW = dict(n_frames=6, width=160, height=120, motion="square", seed=0,
              speed=2.0)


@pytest.fixture(scope="module")
def sims():
    return (jsim.generate_textured_sequence(**SIM_KW),
            tsim.generate_textured_sequence(**SIM_KW))


def test_sim_poses_and_odometry_equal(sims):
    ref, port = sims
    np.testing.assert_array_equal(port.poses, ref.poses)
    np.testing.assert_array_equal(port.stamps, ref.stamps)
    np.testing.assert_array_equal(port.wheel_odom, ref.wheel_odom)


@pytest.mark.parametrize("side", ["left", "right"])
def test_sim_pixels_match_after_quantisation(sims, side):
    ref, port = sims
    a = np.clip(getattr(ref, side), 0, 255).astype(np.uint8).astype(int)
    b = np.clip(getattr(port, side), 0, 255).astype(np.uint8).astype(int)
    assert a.shape == b.shape == (6, 120, 160)
    d = np.abs(a - b)
    assert (d == 0).mean() >= 0.999
    assert d.max() <= 1


def test_sim_cache_and_ate(tmp_path):
    kw = dict(SIM_KW, n_frames=3)
    first = tsim.cached_textured_sequence(cache_dir=str(tmp_path), **kw)
    again = tsim.cached_textured_sequence(cache_dir=str(tmp_path), **kw)
    assert len(list(tmp_path.iterdir())) == 1
    np.testing.assert_array_equal(first.left, again.left)
    assert np.all(first.left == np.floor(first.left))  # 8-bit values
    est = first.poses.copy()
    est[:, 0, 3] += 0.1
    assert tsim.ate_rmse(est, first.poses) == pytest.approx(
        jsim.ate_rmse(est, first.poses))
    assert tsim.ate_rmse(est, first.poses) == pytest.approx(0.1, rel=1e-6)


@pytest.fixture(scope="module")
def gftt_pair(sims):
    img = np.clip(sims[0].left[2], 0, 255).astype(np.uint8).astype(
        np.float32)
    rng = np.random.default_rng(2)
    existing = rng.uniform(10, 150, (40, 2)).astype(np.float32)
    existing[:, 1] = np.clip(existing[:, 1], 10, 110)
    ex_mask = rng.uniform(size=40) > 0.5
    blocked = rng.uniform(10, 110, (16, 2)).astype(np.float32)
    bl_mask = rng.uniform(size=16) > 0.5
    args = (img, existing, ex_mask, blocked, bl_mask)
    ref = jax.jit(lambda a, b, c, d, e: jgftt.gftt_detect(
        a, 40, 0.05, 12, existing_pts=b, existing_mask=c, blocked_pts=d,
        blocked_mask=e))(*args)
    port = tgftt.gftt_detect(*(torch.from_numpy(np.array(a))
                               for a in args[:1]), 40, 0.05, 12,
                             existing_pts=torch.from_numpy(existing),
                             existing_mask=torch.from_numpy(ex_mask),
                             blocked_pts=torch.from_numpy(blocked),
                             blocked_mask=torch.from_numpy(bl_mask))
    return ref, port


def test_gftt_same_point_set(gftt_pair):
    ref, port = gftt_pair
    rv = np.asarray(ref.valid)
    pv = port.valid.numpy()
    assert rv.sum() == pv.sum() >= 10
    rp = {tuple(p) for p in np.asarray(ref.points)[rv]}
    pp = {tuple(p) for p in port.points.numpy()[pv]}
    assert rp == pp


def test_gftt_scores_and_order_match(gftt_pair):
    ref, port = gftt_pair
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(port.valid.numpy(), rv)
    np.testing.assert_array_equal(port.points.numpy()[rv],
                                  np.asarray(ref.points)[rv])
    np.testing.assert_allclose(port.scores.numpy()[rv],
                               np.asarray(ref.scores)[rv], rtol=1e-4)


def test_min_eig_score_matches(sims):
    img = sims[0].left[0]
    ref = np.asarray(jax.jit(jgftt.min_eig_score)(jnp.asarray(img)))
    port = tgftt.min_eig_score(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-2)
