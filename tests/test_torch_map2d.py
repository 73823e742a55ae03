"""visfs_tpu_torch.map2d against visfs_tpu.map2d on the same inputs.

Tolerances: the probability tables bit-equal; grid conversions, cropping
and lookups equal; ray cell sets identical, the slots whose K
(``traverse_q``: the axis-0 crossings before a slot) lies within 1e-5 of an
integer counted and included (those ties flip a cell unless the port
rounds the reference's fused multiply-adds once, as it does); scan
insertion into one grid and into the two-slot active submaps cells
bit-equal, with identical known boxes, slot_valid, finished,
num_range_data and corners, over a run of scans that crosses the submap
rotation.  The reference's calls are jitted into a few programs (the
compile canary in tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.io import sim as jsim
from visfs_tpu.map2d import grid2d as jg
from visfs_tpu.map2d import probability_values as jpv
from visfs_tpu.map2d import raycast as jr
from visfs_tpu.map2d import submap as js
from visfs_tpu_torch.map2d import grid2d as tg
from visfs_tpu_torch.map2d import probability_values as tpv
from visfs_tpu_torch.map2d import raycast as tr
from visfs_tpu_torch.map2d import submap as ts

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

T = torch.from_numpy


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# probability_values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hit,miss", [(0.55, 0.49), (0.7, 0.4), (0.9, 0.1)])
def test_update_tables_bit_equal(hit, miss):
    jh, jm = jpv.hit_miss_tables(hit, miss)
    th, tm = tpv.hit_miss_tables(hit, miss, "cpu")
    assert th.dtype == tm.dtype == torch.int32
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh).astype(np.int32))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm).astype(np.int32))


def test_cost_and_probability_tables_bit_equal():
    np.testing.assert_array_equal(tpv.value_to_correspondence_cost_table(),
                                  jpv.value_to_correspondence_cost_table())
    np.testing.assert_array_equal(tpv.value_to_probability_table(),
                                  jpv.value_to_probability_table())
    np.testing.assert_array_equal(
        tpv.cost_table("cpu").numpy(),
        np.asarray(jnp.asarray(jpv.value_to_correspondence_cost_table(),
                               jnp.float32)))
    for odds in (0.3, jpv.odds(0.55), jpv.odds(0.9)):
        np.testing.assert_array_equal(
            tpv.compute_lookup_table_to_apply_odds(odds),
            jpv.compute_lookup_table_to_apply_odds(odds))


def test_codec_conversions_equal():
    i = np.arange(2 * 32768)
    np.testing.assert_array_equal(
        tpv.probability_value_to_correspondence_cost_value(i),
        jpv.probability_value_to_correspondence_cost_value(i))
    np.testing.assert_array_equal(
        tpv.correspondence_cost_value_to_probability_value(i),
        jpv.correspondence_cost_value_to_probability_value(i))
    p = np.linspace(-0.2, 1.2, 1001)
    np.testing.assert_array_equal(tpv.probability_to_value(p),
                                  jpv.probability_to_value(p))
    np.testing.assert_array_equal(tpv.correspondence_cost_to_value(p),
                                  jpv.correspondence_cost_to_value(p))


# ---------------------------------------------------------------------------
# grid2d
# ---------------------------------------------------------------------------

LIMIT_ARGS = [(2.0, 8.0, 14.0, 14, 8), (0.05, 10.0, 10.0, 400, 400),
              (0.1, 3.2, 3.2, 64, 64)]


@pytest.mark.parametrize("args", LIMIT_ARGS)
def test_cell_index_and_contains_equal(args):
    jl = jg.make_limits(*args)
    tl = tg.make_limits(*args, device="cpu")
    rng = np.random.default_rng(0)
    span = args[0] * max(args[3], args[4])
    pts = rng.uniform(-span, span, (500, 2)).astype(np.float32)
    # the Boost GetCellIndex points, and points on cell boundaries
    pts = np.concatenate([pts, np.float32(
        [[7, 13], [7, -13], [-7, 13], [-7, -13], [0.5, 0.5], [1.5, 1.5],
         [0.5, -0.5], [-0.5, 0.5], [-0.5, -0.5], [0, 0], [2, 2]])])
    ji = np.asarray(jg.cell_index(jl, jnp.asarray(pts)))
    ti = tg.cell_index(tl, T(pts))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tg.contains(tl, ti).numpy(),
                                  np.asarray(jg.contains(jl, jnp.asarray(ji))))


@pytest.fixture(scope="module")
def painted():
    """A 400x400 grid with a random probability block (the Boost cropping
    case) and a few scattered cells, on both sides."""
    rng = np.random.default_rng(0)
    args = (0.05, 10.0, 10.0, 400, 400)
    aa, bb = np.meshgrid(np.arange(100, 300), np.arange(120, 260),
                         indexing="ij")
    idx = np.stack([aa.ravel(), bb.ravel()], -1).astype(np.int32)
    idx = np.concatenate([idx, np.int32([[5, 390], [399, 0], [-3, 7],
                                         [450, 450]])])
    probs = rng.uniform(jpv.MIN_PROBABILITY, jpv.MAX_PROBABILITY,
                        idx.shape[0])
    jgrid = jg.set_probability(jg.init_grid(jg.make_limits(*args)),
                               jnp.asarray(idx), probs)
    tgrid = tg.set_probability(tg.init_grid(tg.make_limits(*args,
                                                           device="cpu")),
                               T(idx), probs)
    return jgrid, tgrid, rng


def test_set_probability_and_cropping_equal(painted):
    jgrid, tgrid, _ = painted
    np.testing.assert_array_equal(tgrid.cells.numpy(),
                                  np.asarray(jgrid.cells).astype(np.int32))
    np.testing.assert_array_equal(tgrid.known_min.numpy(),
                                  np.asarray(jgrid.known_min))
    np.testing.assert_array_equal(tgrid.known_max.numpy(),
                                  np.asarray(jgrid.known_max))
    for a, b in zip(tg.compute_cropped_limits(tgrid),
                    jg.compute_cropped_limits(jgrid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    empty = [tg.compute_cropped_limits(tg.init_grid(tg.make_limits(
        0.05, 1.0, 1.0, 8, 8, device="cpu")))]
    assert [v.tolist() for v in empty[0]] == [[0, 0], [1, 1]]


def test_lookups_and_image_equal(painted):
    jgrid, tgrid, rng = painted
    idx = rng.integers(-20, 420, (2000, 2)).astype(np.int32)
    jct = jnp.asarray(jpv.value_to_correspondence_cost_table(), jnp.float32)
    tct = tpv.cost_table("cpu")
    for jf, tf in ((jg.correspondence_cost, tg.correspondence_cost),
                   (jg.probability, tg.probability)):
        np.testing.assert_array_equal(
            tf(tgrid, T(idx), tct).numpy(),
            np.asarray(jf(jgrid, jnp.asarray(idx), jct)))
    np.testing.assert_array_equal(tg.grid_to_image(tgrid, tct).numpy(),
                                  np.asarray(jg.grid_to_image(jgrid, jct)))


def test_apply_lookup_table_marker_discipline_equal():
    """The Boost ApplyOdds sequence on both sides: one update per sweep
    until finish_update, cells and the applied flag equal each step."""
    args = (1.0, 1.0, 1.0, 2, 2)
    jgrid = jg.init_grid(jg.make_limits(*args))
    tgrid = tg.init_grid(tg.make_limits(*args, device="cpu"))
    tables = {p: jpv.compute_lookup_table_to_apply_correspondence_cost_odds(
        jpv.odds(p)) for p in (0.9, 0.1, 0.42)}
    steps = [([1, 0], 0.9), ([0, 1], 0.1), ([1, 1], 0.42), ([1, 1], 0.9),
             (None, None), ([1, 1], 0.9), ([5, 0], 0.9)]
    for i, p in steps:
        if i is None:
            jgrid, tgrid = jg.finish_update(jgrid), tg.finish_update(tgrid)
        else:
            jgrid, jok = jg.apply_lookup_table(jgrid, jnp.asarray(i),
                                               jnp.asarray(tables[p]))
            tgrid, tok = tg.apply_lookup_table(
                tgrid, torch.tensor(i, dtype=torch.int32),
                T(tables[p].astype(np.int32)))
            assert bool(tok) == bool(jok)
        np.testing.assert_array_equal(tgrid.cells.numpy(),
                                      np.asarray(jgrid.cells))
        np.testing.assert_array_equal(tgrid.known_max.numpy(),
                                      np.asarray(jgrid.known_max))


# ---------------------------------------------------------------------------
# raycast: traverse_q / ray_cells
# ---------------------------------------------------------------------------

_ray_cells = jax.jit(jr.ray_cells, static_argnums=(3,))


def _k_values(q0, q1, samples):
    """K of every slot (float64), as traverse_q defines it."""
    d = q1 - q0
    a = np.abs(d)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(a > 1e-12, 1.0 / np.maximum(a, 1e-12), np.inf)
        frac = q0 - np.floor(q0)
        t0 = np.where(a > 1e-12, np.where(d > 0, 1 - frac, frac) * inv,
                      np.inf)
        s = np.arange(samples)[None, :]
        return ((t0[:, 1:2] - t0[:, 0:1]) + (s - 1.0) * inv[:, 1:2]) \
            / (inv[:, 0:1] + inv[:, 1:2])


def _compare_rays(limits_args, begins, ends, samples):
    """(slots that differ, valid slots whose K is within 1e-5 of an
    integer, valid slots)."""
    jl = jg.make_limits(*limits_args)
    tl = tg.make_limits(*limits_args, device="cpu")
    ji, jv = _ray_cells(jl, jnp.asarray(begins), jnp.asarray(ends), samples)
    ti, tv = tr.ray_cells(tl, T(begins), T(ends), samples)
    ji, jv = np.asarray(ji), np.asarray(jv)
    ti, tv = ti.numpy(), tv.numpy()
    differ = (tv != jv) | (jv & np.any(ti != ji, axis=-1))
    res, mx, my = limits_args[:3]
    q0 = np.stack([(my - begins[:, 1]) / res, (mx - begins[:, 0]) / res], -1)
    q1 = np.stack([(my - ends[:, 1]) / res, (mx - ends[:, 0]) / res], -1)
    K = _k_values(q0.astype(np.float64), q1.astype(np.float64), samples)
    near = np.abs(K - np.round(K)) < 1e-5
    return int(differ.sum()), int((jv & near).sum()), int(jv.sum())


BOOST_LIMITS = (1.0, 16.0, 16.0, 32, 32)
BOOST_RAYS = [([0.5, 0.5], [0.9, 0.9]), ([0.5, 0.5], [0.5, 8.5]),
              ([0.5, 0.5], [8.5, 8.5])]


@pytest.mark.parametrize("samples", [128, 4096])
def test_ray_cells_boost_cases_identical(samples):
    """tests/test_map2d.py's ray cases: the single cell, the axis-aligned and
    diagonal rays, and the 10 random rays of the dense-coverage check."""
    rng = np.random.default_rng(3)
    rand = [(rng.uniform(2, 14, 2), rng.uniform(2, 14, 2))
            for _ in range(10)]
    rays = BOOST_RAYS + rand
    begins = np.float32([b for b, _ in rays])
    ends = np.float32([e for _, e in rays])
    differ, ties, total = _compare_rays(BOOST_LIMITS, begins, ends, samples)
    assert total > 0
    assert differ == 0
    assert ties > 0  # the diagonal ray crosses grid corners


def test_ray_cells_random_rays_identical():
    """256 seeded rays of up to 12 m on a 256x256, 0.05 m grid at the
    bench's 520 samples, some leaving the grid, zero-length and
    axis-aligned ones among them, and 64 from a grid corner (a submap's
    first scan starts on one) at 3-degree beam angles, 5 m long (the
    missing-echo length)."""
    rng = np.random.default_rng(7)
    limits = (0.05, 6.4, 6.4, 256, 256)
    begins = rng.uniform(-3, 3, (256, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 256)
    lengths = rng.uniform(0.0, 12.0, 256)
    begins[192:] = 0.0
    ang[192:] = np.deg2rad(3.0 * np.arange(64))
    lengths[192:] = 5.0
    ends = (begins + np.stack([np.cos(ang), np.sin(ang)], -1)
            * lengths[:, None]).astype(np.float32)
    ends[:8] = begins[:8]  # zero-length rays
    ends[8:16, 0] = begins[8:16, 0]  # axis-aligned rays
    differ, ties, total = _compare_rays(limits, begins, ends, 520)
    assert total > 10000
    assert differ == 0
    assert ties > 0


def test_traverse_q_emitted_equal_on_grid_corners():
    """Rays through exact cell corners and along grid lines (the tie cases
    of the walk) give the same slots on both sides."""
    q0 = np.float32([[0.5, 0.5], [0.0, 0.0], [2.0, 0.5], [0.25, 3.0],
                     [7.5, 7.5], [1.0, 1.0]])
    q1 = np.float32([[4.5, 4.5], [5.0, 5.0], [2.0, 9.5], [6.25, 3.0],
                     [0.5, 0.5], [1.0, 1.0]])
    ji, je = jax.jit(jr.traverse_q, static_argnums=(2,))(
        jnp.asarray(q0), jnp.asarray(q1), 24)
    ti, te = tr.traverse_q(T(q0), T(q1), 24)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# insertion
# ---------------------------------------------------------------------------

def _scan_run(n, seed=5):
    """n scans of a room's walls and pillars from a drive through it:
    (origins [n, 2], hits [n, K, 2], hit masks, misses [n, K, 2], miss
    masks) in world coordinates, some hits beyond 5 m turned into misses."""
    rng = np.random.default_rng(seed)
    room = (-4.0, 5.0, -3.0, 3.5)
    pillars = [(1.0, 1.6, 0.4, 1.1), (-2.5, -2.0, -2.0, -1.2)]
    hits, hmask, misses, mmask, origins = [], [], [], [], []
    for i in range(n):
        x, y, yaw = -1.0 + 0.3 * i, -0.5 + 0.1 * i, 0.2 * i
        pose = np.eye(4, dtype=np.float32)
        pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)],
                        [np.sin(yaw), np.cos(yaw)]]
        pose[:2, 3] = [x, y]
        pts = jsim._scan_world(pose, room, pillars, 120, rng, 0.01)
        world = pts[:, :2] @ pose[:2, :2].T + pose[:2, 3]
        r = np.linalg.norm(pts[:, :2], axis=-1)
        far = r > 5.0
        miss = pose[:2, 3] + (world - pose[:2, 3]) * (5.0 / np.maximum(
            r, 1e-6))[:, None]
        keep = rng.uniform(size=len(r)) > 0.05
        origins.append(pose[:2, 3])
        hits.append(np.where(far[:, None], 0.0, world))
        hmask.append(~far & keep)
        misses.append(np.where(far[:, None], miss, 0.0))
        mmask.append(far & keep)
    f32 = np.float32
    return (np.asarray(origins, f32), np.asarray(hits, f32),
            np.asarray(hmask), np.asarray(misses, f32), np.asarray(mmask))


@pytest.fixture(scope="module")
def scans():
    return _scan_run(8)


def test_insert_range_data_bit_equal(scans):
    origins, hits, hmask, misses, mmask = scans
    args = (0.05, 4.0, 4.0, 160, 160)
    jgrid = jg.init_grid(jg.make_limits(*args))
    tgrid = tg.init_grid(tg.make_limits(*args, device="cpu"))
    jh, jm = jpv.hit_miss_tables(0.55, 0.49)
    th, tm = tpv.hit_miss_tables(0.55, 0.49, "cpu")
    for i in range(len(origins)):
        jgrid = jr.insert_range_data(
            jgrid, jnp.asarray(origins[i]), jnp.asarray(hits[i]),
            jnp.asarray(hmask[i]), jnp.asarray(misses[i]),
            jnp.asarray(mmask[i]), jh, jm, samples=240)
        tgrid = tr.insert_range_data(
            tgrid, T(origins[i]), T(hits[i]), T(hmask[i]), T(misses[i]),
            T(mmask[i]), th, tm, samples=240)
        np.testing.assert_array_equal(tgrid.cells.numpy(),
                                      np.asarray(jgrid.cells))
        np.testing.assert_array_equal(tgrid.known_min.numpy(),
                                      np.asarray(jgrid.known_min))
        np.testing.assert_array_equal(tgrid.known_max.numpy(),
                                      np.asarray(jgrid.known_max))
    assert int((tgrid.cells != 0).sum()) > 1000


def test_insert_range_data_active_bit_equal(scans):
    """8 scans at num_range_data_limit 3: a second submap starts at scan 3,
    the first is finished at 6 and dropped when the third starts."""
    origins, hits, hmask, misses, mmask = scans
    jsub = js.init_active_submaps(0.05, 96)
    tsub = ts.init_active_submaps(0.05, 96, "cpu")
    jh, jm = jpv.hit_miss_tables(0.55, 0.49)
    th, tm = tpv.hit_miss_tables(0.55, 0.49, "cpu")
    seen_finished = False
    for i in range(len(origins)):
        jsub = js.insert_range_data_active(
            jsub, jnp.asarray(origins[i]), jnp.asarray(hits[i]),
            jnp.asarray(hmask[i]), jnp.asarray(misses[i]),
            jnp.asarray(mmask[i]), jh, jm, num_range_data_limit=3,
            samples=200)
        tsub = ts.insert_range_data_active(
            tsub, T(origins[i]), T(hits[i]), T(hmask[i]), T(misses[i]),
            T(mmask[i]), th, tm, num_range_data_limit=3, samples=200)
        for f in ("cells", "known_min", "known_max", "num_range_data",
                  "slot_valid", "finished"):
            np.testing.assert_array_equal(_np(getattr(tsub, f)),
                                          np.asarray(getattr(jsub, f)),
                                          err_msg=f"scan {i}: {f}")
        np.testing.assert_array_equal(tsub.max_xy.numpy(),
                                      np.asarray(jsub.max_xy))
        np.testing.assert_array_equal(tsub.origin.numpy(),
                                      np.asarray(jsub.origin))
        seen_finished |= bool(tsub.finished[0])
        jgrid, tgrid = js.matching_grid(jsub), ts.matching_grid(tsub)
        np.testing.assert_array_equal(tgrid.cells.numpy(),
                                      np.asarray(jgrid.cells))
        assert float(tgrid.limits.max_x) == float(jgrid.limits.max_x)
        assert bool(ts.has_matching_submap(tsub)) == bool(
            js.has_matching_submap(jsub))
    assert seen_finished
    assert tsub.num_range_data.tolist() == [5, 2]
