"""2D occupancy grid with cartographer-style geometry, static-shape tensors
(torch port of visfs_tpu.map2d.grid2d).

Mirrors MapLimits / Grid2D / ProbabilityGrid (corelib/include/Map/2d/
MapLimits.h, Grid2d.h, ProbabilityGrid.h):

  * world->cell: idx_a = lround((max_y - p.y)/res - 0.5),
                 idx_b = lround((max_x - p.x)/res - 0.5)  (flipped axes,
                 MapLimits.h:153-175); cells stored as a [num_y, num_x]
                 tensor indexed [idx_b, idx_a] (flat numX * idx_b + idx_a,
                 Grid2d.h:92-94);
  * cells hold the probability_values codec's uint16 values (0 unknown,
    1..32767 costs, +32768 the update marker) as **int32**: torch has no
    indexing, scatter or gather for uint16 on CUDA.  Every value fits, the
    arithmetic is the same, and ``slam.state.state_from_numpy`` /
    ``state_to_numpy`` convert exactly at the numpy boundary;
  * dynamic growth (Grid2d.cpp:34-65) is replaced by a pre-allocated static
    extent; out-of-range updates are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import probability_values as pv

I32 = torch.int32
_BIG = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class MapLimits:
    """Grid geometry; cell counts are Python ints (static shapes)."""

    resolution: torch.Tensor  # scalar f32
    max_x: torch.Tensor  # upper corner x (scalar)
    max_y: torch.Tensor  # upper corner y
    num_x: int
    num_y: int

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)


class Grid2D(NamedTuple):
    limits: MapLimits
    cells: torch.Tensor  # [num_y, num_x] int32 correspondence-cost values
    # known-cells bounding box (min_a, min_b, max_a, max_b), inclusive;
    # empty iff min > max.
    known_min: torch.Tensor  # [2] int32
    known_max: torch.Tensor  # [2] int32


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_limits(resolution, max_x, max_y, num_x: int, num_y: int,
                device="cuda") -> MapLimits:
    return MapLimits(resolution=_f32(resolution, device),
                     max_x=_f32(max_x, device), max_y=_f32(max_y, device),
                     num_x=int(num_x), num_y=int(num_y))


def cell_index(limits: MapLimits, points):
    """World [..., 2] -> cell index [..., 2] = (idx_a, idx_b), exactly
    MapLimits::getCellIndex (idx_a counts from max_y down, idx_b from
    max_x down; torch.round rounds half to even as jnp.round does)."""
    a = torch.round((limits.max_y - points[..., 1]) / limits.resolution
                    - 0.5).to(I32)
    b = torch.round((limits.max_x - points[..., 0]) / limits.resolution
                    - 0.5).to(I32)
    return torch.stack([a, b], dim=-1)


def cell_center(limits: MapLimits, index):
    """Cell index [..., 2] -> world center (MapLimits::getCellCenter)."""
    x = limits.max_x - limits.resolution * (index[..., 1] + 0.5)
    y = limits.max_y - limits.resolution * (index[..., 0] + 0.5)
    return torch.stack([x, y], dim=-1)


def contains(limits: MapLimits, index):
    """MapLimits::contains — idx_a < num_x, idx_b < num_y (sic, flipped)."""
    return ((index[..., 0] >= 0) & (index[..., 1] >= 0)
            & (index[..., 0] < limits.num_x) & (index[..., 1] < limits.num_y))


def init_grid(limits: MapLimits) -> Grid2D:
    dev = limits.resolution.device
    return Grid2D(
        limits=limits,
        cells=torch.full((limits.num_y, limits.num_x), pv.UNKNOWN_VALUE,
                         dtype=I32, device=dev),
        known_min=torch.tensor([limits.num_x, limits.num_y], dtype=I32,
                               device=dev),
        known_max=torch.tensor([-1, -1], dtype=I32, device=dev),
    )


def _wrap(index, limits: MapLimits):
    """[..., 2] indices with negative entries counted from the end, as the
    reference's array indexing reads and writes them (a = -1 is column
    num_x - 1), before its out-of-range drop or clamp."""
    a, b = index[..., 0], index[..., 1]
    return torch.stack([torch.where(a < 0, a + limits.num_x, a),
                        torch.where(b < 0, b + limits.num_y, b)], dim=-1)


def _flat(limits: MapLimits, index):
    """Flat cell offsets of [..., 2] indices as the reference's scatter
    writes them (negative entries wrapped once); still out of the grid ->
    HW, a slot past the grid that callers slice off."""
    index = _wrap(index, limits)
    flat = index[..., 1].long() * limits.num_x + index[..., 0].long()
    return torch.where(contains(limits, index), flat,
                       torch.full_like(flat, limits.num_x * limits.num_y))


def _cell_value(grid: Grid2D, index):
    """Raw values at [..., 2] indices (row = idx_b, col = idx_a), clamped
    into the grid."""
    a = torch.clamp(index[..., 0], 0, grid.limits.num_x - 1).long()
    b = torch.clamp(index[..., 1], 0, grid.limits.num_y - 1).long()
    return grid.cells[b, a]


def _cell_value_wrapped(grid: Grid2D, index):
    """Raw values as the reference's plain indexing reads them: negative
    entries wrapped once, then clamped into the grid."""
    return _cell_value(grid, _wrap(index, grid.limits))


def is_known(grid: Grid2D, index):
    return contains(grid.limits, index) & (
        _cell_value(grid, index) != pv.UNKNOWN_VALUE)


def correspondence_cost(grid: Grid2D, index, cost_table):
    """Grid2D::getCorrespondenceCost with out-of-grid -> max cost."""
    cost = cost_table[_cell_value(grid, index).long()]
    return torch.where(contains(grid.limits, index), cost,
                       torch.full_like(cost, pv.MAX_CORRESPONDENCE_COST))


def probability(grid: Grid2D, index, cost_table):
    """ProbabilityGrid::getProbability (out-of-grid -> kMinProbability)."""
    p = 1.0 - correspondence_cost(grid, index, cost_table)
    return torch.where(contains(grid.limits, index), p,
                       torch.full_like(p, pv.MIN_PROBABILITY))


def set_probability(grid: Grid2D, index, prob):
    """ProbabilityGrid::setProbability at [..., 2] indices (batched; the
    codec runs in numpy on the given probabilities)."""
    value = pv.correspondence_cost_to_value(
        pv.probability_to_correspondence_cost(np.asarray(prob)))
    lim = grid.limits
    hw = lim.num_x * lim.num_y
    plane = torch.cat([grid.cells.reshape(-1),
                       grid.cells.new_zeros(1)])
    flat = _flat(lim, index).reshape(-1)
    plane[flat] = torch.as_tensor(value, dtype=I32, device=flat.device
                                  ).reshape(-1).expand(flat.shape[0])
    cells = plane[:hw].reshape(lim.num_y, lim.num_x)
    return _extend_known(grid._replace(cells=cells), index)


def _extend_known(grid: Grid2D, index):
    inb = contains(grid.limits, index)[..., None]
    idx = index.to(I32)
    idx_min = torch.amin(torch.where(inb, idx, torch.full_like(idx, _BIG))
                         .reshape(-1, 2), dim=0)
    idx_max = torch.amax(torch.where(inb, idx, torch.full_like(idx, -1))
                         .reshape(-1, 2), dim=0)
    return grid._replace(known_min=torch.minimum(grid.known_min, idx_min),
                         known_max=torch.maximum(grid.known_max, idx_max))


def apply_lookup_table(grid: Grid2D, index, table):
    """ProbabilityGrid::applyLookUpTable for a single [2] cell index.

    Honors the update-marker discipline: a cell already >= kUpdateMarker is
    not updated again until finish_update (ProbabilityGrid.cpp:142-153).
    Returns (grid, applied: bool).
    """
    lim = grid.limits
    inb = contains(lim, index)
    old = _cell_value_wrapped(grid, index)
    fresh = inb & (old < pv.UPDATE_MARKER)
    # a marked value reads the table's last entry (clamped), then is kept
    new = table[torch.clamp(old.long(), max=table.shape[0] - 1)]
    flat = _flat(lim, index[None, :])
    plane = torch.cat([grid.cells.reshape(-1), grid.cells.new_zeros(1)])
    plane[flat] = torch.where(fresh, new, old).reshape(1)
    cells = plane[:lim.num_x * lim.num_y].reshape(lim.num_y, lim.num_x)
    grid = _extend_known(grid._replace(cells=cells), index[None, :])
    return grid, fresh


def finish_update(grid: Grid2D) -> Grid2D:
    """Clear any update markers (Grid2D::finishUpdate)."""
    c = grid.cells
    return grid._replace(cells=torch.where(c >= pv.UPDATE_MARKER,
                                           c - pv.UPDATE_MARKER, c))


def compute_cropped_limits(grid: Grid2D):
    """(offset [2], (num_a, num_b)) of the known-cells box
    (Grid2D::computeCroppedLimits); empty grid -> ((0,0), (1,1))."""
    empty = torch.any(grid.known_max < grid.known_min)
    offset = torch.where(empty, torch.zeros_like(grid.known_min),
                         grid.known_min)
    size = torch.where(empty, torch.ones_like(grid.known_min),
                       grid.known_max - grid.known_min + 1)
    return offset, size


def grid_to_image(grid: Grid2D, cost_table):
    """Render correspondence costs to a [num_y, num_x] uint8 image (the
    intended row-major version of the reference's grid2Image)."""
    img = torch.ceil(cost_table[grid.cells.long()] * 255.0)
    return torch.clamp(img, 0, 255).to(torch.uint8)
