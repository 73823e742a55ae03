"""Vectorized ray rasterization + probability-grid scan insertion (torch port
of visfs_tpu.map2d.raycast).

Replaces RayToPixelMask's per-ray subpixel Bresenham walk
(corelib/src/Map/2d/RayToPixelMask.cpp:145-251) and the
ProbabilityGridRangeDataInserter2D sweep (ProbabilityGridRangeDataInserter2D
.cpp:40-89) with fixed-budget batched tensor ops:

  * every ray is walked in closed form over ``samples`` slots
    (``traverse_q``: one [R, S] elementwise pass, no loop over samples);
  * the reference's update-marker discipline — each cell updated at most
    once per sweep, hits before misses — is one scatter-max of an update
    class plane followed by a dense table apply (``_apply_sweep``);
  * cells outside the grid are dropped (static extent replaces growLimits).
"""

from __future__ import annotations

import torch

from ..core.lie import fma
from .grid2d import Grid2D, cell_index, contains, finish_update

I32 = torch.int32


def ray_cells(limits, origins, ends, samples: int):
    """Exact cells crossed by rays origin->end (Amanatides-Woo traversal).

    origins, ends: [R, 2] world points.  Returns ([R, S, 2] cell indices,
    [R, S] validity), S = samples the static step budget.
    """
    # continuous cell coordinates q = (max - p)/res, cell = floor(q)
    q0 = torch.stack([(limits.max_y - origins[:, 1]) / limits.resolution,
                      (limits.max_x - origins[:, 0]) / limits.resolution],
                     dim=-1)
    q1 = torch.stack([(limits.max_y - ends[:, 1]) / limits.resolution,
                      (limits.max_x - ends[:, 0]) / limits.resolution],
                     dim=-1)
    idx, emitted = traverse_q(q0, q1, samples)
    return idx, emitted & contains(limits, idx)


def traverse_q(q0, q1, samples: int):
    """Supercover traversal in continuous cell coordinates.

    q0, q1: [R, 2] start/end in cell units (cell = floor(q)).  Returns
    ([R, S, 2] int32 cell indices, [R, S] emitted); callers add their own
    grid-bounds check.

    After i grid-line crossings the walk is at cell0 + (step0*k0,
    step1*(i-k0)), where k0 counts the axis-0 crossings among the i
    earliest of the two progressions t0(k) = t0ax0 + k*dt0 and
    t1(m) = t0ax1 + m*dt1 (a tie goes to axis 0):
    k0(i) = clamp(floor((t0ax1 - t0ax0 + (i-1)*dt1)/(dt0 + dt1)) + 1, 0, i).
    """
    d = q1 - q0
    fl = torch.floor(q0)
    cell0 = fl.to(I32)  # [R, 2]
    step = torch.where(d > 0, 1, -1).to(I32)
    abs_d = torch.abs(d)
    alive = abs_d > 1e-12  # [R, 2]
    inf = torch.full_like(d, float("inf"))
    inv_d = torch.where(alive, 1.0 / torch.clamp(abs_d, min=1e-12), inf)
    frac = q0 - fl
    dist0 = torch.where(d > 0, 1.0 - frac, frac)
    t0ax = torch.where(alive, dist0 * inv_d, inf)  # [R, 2]
    dt = inv_d

    s_idx = torch.arange(samples, dtype=I32, device=q0.device)[None, :]
    s_f = s_idx.to(q0.dtype)
    num = fma(s_f - 1.0, dt[:, 1:2], t0ax[:, 1:2] - t0ax[:, 0:1])
    den = dt[:, 0:1] + dt[:, 1:2]
    K = num / den  # [R, S]; inf/NaN where an axis is degenerate
    K = torch.clamp(torch.where(torch.isfinite(K), K,
                                torch.full_like(K, -1.0)), -1.0,
                    float(samples))
    k0 = torch.minimum(torch.clamp(torch.floor(K).to(I32) + 1, min=0), s_idx)
    k0 = torch.where(~alive[:, 0:1], torch.zeros_like(k0),
                     torch.where(~alive[:, 1:2], s_idx.expand_as(k0), k0))
    k1 = s_idx - k0
    idx = cell0[:, None, :] + torch.stack(
        [step[:, 0:1] * k0, step[:, 1:2] * k1], dim=-1)  # [R, S, 2]

    # K and the crossing times are rounded once where the reference's
    # compiled walk fuses them (lie.fma): a ray through a grid corner or
    # ending on a grid line otherwise moves a cell (every submap's first
    # scan starts on a corner; tests/test_torch_map2d.py).
    # Slot i > 0 is emitted iff its crossing (the later of the last taken
    # crossing on each axis) happens before the ray end (t < 1).
    ninf = torch.full_like(K, float("-inf"))
    last0 = torch.where(k0 >= 1, fma(k0.to(q0.dtype) - 1.0, dt[:, 0:1],
                                      t0ax[:, 0:1]), ninf)
    last1 = torch.where(k1 >= 1, fma(k1.to(q0.dtype) - 1.0, dt[:, 1:2],
                                      t0ax[:, 1:2]), ninf)
    emitted = (s_idx == 0) | (torch.maximum(last0, last1) < 1.0)
    return idx, emitted


def class_plane(flat_idx, valid, is_hit, size: int):
    """The update-class plane [size] int32 of one sweep: 2 where a hit
    lands, else 1 where a miss does, else 0.  One scatter-max (amax is
    deterministic); invalid candidates go to a last slot that is sliced
    off (the reference's mode="drop")."""
    cls = torch.where(is_hit, 2, 1).to(I32)
    plane = torch.zeros(size + 1, dtype=I32, device=cls.device)
    target = torch.where(valid, flat_idx.long(),
                         torch.full_like(flat_idx, size, dtype=torch.long))
    plane.scatter_reduce_(0, target, cls, reduce="amax")
    return plane[:size]


def _apply_sweep(cells, flat_idx, valid, is_hit, hit_table, miss_table):
    """One insertion sweep: every candidate cell updated at most once, hits
    taking precedence over misses (ProbabilityGrid.cpp:142-153), as a
    scatter-max of the class plane and a dense table apply.

    cells: [HW] int32; flat_idx/valid/is_hit: [N] candidates; *_table:
    [32768] int32 marker-tagged update tables.  Returns (new_cells,
    updated_plane [HW] bool)."""
    plane = class_plane(flat_idx, valid, is_hit, cells.shape[0])
    old = cells.long()
    new_cells = torch.where(plane == 2, hit_table[old],
                            torch.where(plane == 1, miss_table[old], cells))
    return new_cells, plane > 0


def known_box(upd, known_min, known_max):
    """Grow known-cells boxes over the updated cells: upd [..., Y, X] bool,
    known_min/known_max [..., 2] int32 (a, b) -> the grown boxes."""
    rows = torch.any(upd, dim=-1)  # [..., Y] over idx_b
    cols = torch.any(upd, dim=-2)  # [..., X] over idx_a
    rr = torch.arange(rows.shape[-1], dtype=I32, device=upd.device)
    cc = torch.arange(cols.shape[-1], dtype=I32, device=upd.device)
    big = torch.iinfo(torch.int32).max

    def lo(mask, r):
        return torch.amin(torch.where(mask, r, torch.full_like(r, big)),
                          dim=-1)

    def hi(mask, r):
        return torch.amax(torch.where(mask, r, torch.full_like(r, -1)),
                          dim=-1)

    any_upd = torch.any(rows, dim=-1)[..., None]
    kmin = torch.where(any_upd, torch.minimum(
        known_min, torch.stack([lo(cols, cc), lo(rows, rr)], dim=-1)),
        known_min)
    kmax = torch.where(any_upd, torch.maximum(
        known_max, torch.stack([hi(cols, cc), hi(rows, rr)], dim=-1)),
        known_max)
    return kmin, kmax


def insert_range_data(grid: Grid2D, origin, hits, hits_mask, misses,
                      misses_mask, hit_table, miss_table, samples: int = 128,
                      insert_free_space: bool = True) -> Grid2D:
    """ProbabilityGridRangeDataInserter2D::insert equivalent (one sweep):
    origin [2], hits [H, 2] + mask, misses [M, 2] + mask (world)."""
    limits = grid.limits
    nx = limits.num_x

    def flatten(idx):
        return idx[..., 1].long() * nx + idx[..., 0].long()

    # Candidates in precedence order: hits, free-space rays to the hits,
    # missing-echo rays.
    hit_idx = cell_index(limits, hits)
    hit_ok = hits_mask & contains(limits, hit_idx)
    cand_idx, cand_ok = [flatten(hit_idx)], [hit_ok]
    cand_hit = [torch.ones_like(hit_ok)]
    if insert_free_space:
        for ends, emask in ((hits, hits_mask), (misses, misses_mask)):
            ridx, rvalid = ray_cells(limits, origin[None, :].expand_as(ends),
                                     ends, samples)
            rvalid = (rvalid & emask[:, None]).reshape(-1)
            cand_idx.append(flatten(ridx).reshape(-1))
            cand_ok.append(rvalid)
            cand_hit.append(torch.zeros_like(rvalid))

    cells_flat, updated = _apply_sweep(
        grid.cells.reshape(-1), torch.cat(cand_idx), torch.cat(cand_ok),
        torch.cat(cand_hit), hit_table, miss_table)
    new_grid = finish_update(grid._replace(
        cells=cells_flat.reshape(grid.cells.shape)))
    kmin, kmax = known_box(updated.reshape(grid.cells.shape),
                           new_grid.known_min, new_grid.known_max)
    return new_grid._replace(known_min=kmin, known_max=kmax)
