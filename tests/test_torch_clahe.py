"""visfs_tpu_torch.ops.image.clahe and in_bounds against visfs_tpu's.

CLAHE's histograms are adds of 1.0 (exact below 2^24; a tile holds 4,800
pixels at 640x480), so they agree exactly; the clip, the excess and the
cumsum CDF are float reductions whose order may differ from XLA's, and the
interpolation is rounded as the reference's compiled program rounds it
(constant divisors as reciprocal products, each tap pair as one fused
multiply-add).  Bound stated: the look-up tables and the output within 1e-4
levels (0 measured on this CPU), output float32 in [0, 255].  in_bounds is
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.io.sim import cached_textured_sequence
from visfs_tpu.ops import image as jim
from visfs_tpu_torch.ops import image as tim

torch.set_num_threads(1)

BOUND = 1e-4  # levels


def _reference_luts(img, grid=8, n_bins=256):
    """The reference clahe's body up to its look-up tables
    (visfs_tpu/ops/image.py:171-186)."""
    h, w = img.shape
    th, tw = h // grid, w // grid
    tiles = img.reshape(grid, th, grid, tw).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(grid * grid, th * tw)
    bins = jnp.clip(tiles.astype(jnp.int32), 0, n_bins - 1)
    hist = jax.vmap(lambda b: jnp.zeros(n_bins, jnp.float32).at[b].add(
        1.0))(bins)
    clip = 3.0 * (th * tw) / n_bins
    excess = jnp.sum(jnp.maximum(hist - clip, 0.0), axis=1, keepdims=True)
    hist = jnp.minimum(hist, clip) + excess / n_bins
    cdf = jnp.cumsum(hist, axis=1)
    cdf = cdf / cdf[:, -1:]
    return (cdf * (n_bins - 1)).reshape(grid, grid, n_bins)


NAMES = ("dark250x190", "noise160x120", "noise640", "textured160",
         "textured640")


@pytest.fixture(scope="module")
def images():
    seq = cached_textured_sequence(n_frames=2, width=640, height=480,
                                   motion="square", seed=0, speed=2.0)
    rng = np.random.default_rng(0)
    noise = np.floor(np.clip(rng.normal(120, 40, (480, 640)), 0, 255))
    return {"textured640": seq.left[1],
            "textured160": np.ascontiguousarray(seq.left[1][::4, ::4]),
            "noise640": noise.astype(np.float32),
            "noise160x120": noise[:120, :160].astype(np.float32),
            "dark250x190": np.clip(seq.left[0][:190, :250] * 0.3, 0,
                                   255).astype(np.float32)}


@pytest.mark.parametrize("name", NAMES)
def test_clahe_matches_reference(images, name):
    img = images[name]
    ref = np.asarray(jax.jit(jim.clahe)(jnp.asarray(img)))
    out = tim.clahe(torch.from_numpy(img))
    assert out.dtype == torch.float32 and tuple(out.shape) == img.shape
    d = float(np.abs(out.numpy() - ref).max())
    assert d <= BOUND, d
    assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0


@pytest.mark.parametrize("name", ["textured640", "noise160x120"])
def test_clahe_luts_match_reference(images, name):
    img = images[name]
    ref = np.asarray(jax.jit(_reference_luts)(jnp.asarray(img)))
    lut = tim.clahe_luts(torch.from_numpy(img)).numpy()
    assert lut.shape == ref.shape == (8, 8, 256)
    assert float(np.abs(lut - ref).max()) <= BOUND


def test_clahe_equalizes_a_dark_image(images):
    img = torch.from_numpy(images["dark250x190"])
    out = tim.clahe(img)
    assert float(out.std()) > 1.5 * float(img.std())


def test_in_bounds_matches_reference():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-5, 170, (500, 2)).astype(np.float32)
    pts[:4] = [[0, 0], [160, 10], [159.999, 119.999], [3, 120]]
    for margin in (0.0, 3.0, 10.5):
        ref = np.asarray(jim.in_bounds(jnp.asarray(pts), 160, 120, margin))
        out = tim.in_bounds(torch.from_numpy(pts), 160, 120, margin)
        np.testing.assert_array_equal(out.numpy(), ref)
