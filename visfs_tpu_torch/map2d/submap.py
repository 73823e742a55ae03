"""Submap2D / ActiveSubmaps2D: cartographer-style two-submap rotation (torch
port of visfs_tpu.map2d.submap).

Mirrors corelib/src/Map/2d/Submap2D.cpp:88-174 with static shapes: at most
two live submaps; a new one starts when the newest reaches
``num_range_data_limit`` insertions; the oldest is finished (frozen) at 2x
the limit and dropped when a third would start.  Both slots share one
static square extent, so the per-slot state is stacked tensors, the
rotation is computed always and selected with ``torch.where`` (no branch on
device data), and both slots are inserted in one batched sweep.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import probability_values as pv
from .grid2d import Grid2D, MapLimits
from ..core.lie import fma
from .raycast import class_plane, known_box, traverse_q

I32 = torch.int32


class ActiveSubmaps2D(NamedTuple):
    # Two submap slots; slot 0 = older (matching submap), slot 1 = newer.
    cells: torch.Tensor  # [2, E, E] int32 (uint16 codec values)
    resolution: torch.Tensor  # scalar f32
    max_xy: torch.Tensor  # [2, 2] per-slot upper corner (x, y)
    known_min: torch.Tensor  # [2, 2] int32
    known_max: torch.Tensor  # [2, 2] int32
    origin: torch.Tensor  # [2, 3] submap origin (x, y, yaw)
    num_range_data: torch.Tensor  # [2] int32
    slot_valid: torch.Tensor  # [2] bool
    finished: torch.Tensor  # [2] bool

    @property
    def extent(self) -> int:
        return self.cells.shape[-1]


def grid_slot(s: ActiveSubmaps2D, i: int) -> Grid2D:
    """Slot i (a Python int) as a Grid2D view."""
    E = s.extent
    limits = MapLimits(resolution=s.resolution, max_x=s.max_xy[i, 0],
                       max_y=s.max_xy[i, 1], num_x=E, num_y=E)
    return Grid2D(limits=limits, cells=s.cells[i], known_min=s.known_min[i],
                  known_max=s.known_max[i])


def init_active_submaps(resolution: float, extent_cells: int = 256,
                        device="cuda") -> ActiveSubmaps2D:
    """Empty two-slot state pre-allocated at extent_cells^2."""
    E = extent_cells

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ActiveSubmaps2D(
        cells=torch.full((2, E, E), pv.UNKNOWN_VALUE, dtype=I32,
                         device=device),
        resolution=torch.tensor(resolution, dtype=torch.float32,
                                device=device),
        max_xy=z(2, 2),
        known_min=torch.full((2, 2), E, dtype=I32, device=device),
        known_max=torch.full((2, 2), -1, dtype=I32, device=device),
        origin=z(2, 3), num_range_data=z(2, dtype=I32),
        slot_valid=z(2, dtype=torch.bool), finished=z(2, dtype=torch.bool))


def _add_submap(s: ActiveSubmaps2D, origin) -> ActiveSubmaps2D:
    """The state after a new submap starts at ``origin``: slot 1 moves to
    slot 0 when it was live (dropping the old slot 0), the new submap takes
    slot 1 (Submap2D.cpp:163-174).  New values come from device fills, not
    host tensors: a host-to-device copy would wait for the device."""
    E = s.extent
    had1 = s.slot_valid[1]
    zero = torch.zeros_like(origin[0])
    # origin + 0.5 * E * res rounded once, as the reference's compiled
    # rotation evaluates it
    half = torch.full_like(zero, 0.5 * E)
    corner = fma(half, s.resolution, origin[:2])

    def rot(x, newv):
        first = torch.where(had1, x[1], x[0])
        return torch.stack([first, newv.to(x.dtype).expand_as(x[1])])

    return s._replace(
        cells=rot(s.cells, torch.full_like(zero, pv.UNKNOWN_VALUE)),
        max_xy=rot(s.max_xy, corner),
        known_min=rot(s.known_min, torch.full_like(zero, E)),
        known_max=rot(s.known_max, torch.full_like(zero, -1)),
        origin=rot(s.origin, torch.stack([origin[0], origin[1], zero])),
        num_range_data=rot(s.num_range_data, zero),
        # slot 0 is live iff slot 1 was
        slot_valid=torch.stack([had1, torch.ones_like(had1)]),
        finished=rot(s.finished, zero))


def insert_range_data_active(submaps: ActiveSubmaps2D, origin, hits,
                             hits_mask, misses, misses_mask, hit_table,
                             miss_table, num_range_data_limit: int,
                             samples: int = 128,
                             insert_free_space: bool = True
                             ) -> ActiveSubmaps2D:
    """ActiveSubmaps2D::insertRangeData (Submap2D.cpp:112-126): origin [2]
    world sensor origin, hits [H, 2] + mask, misses [M, 2] + mask.

    Rotation: with no submaps, or the newest at the limit, a submap starts
    at the current origin; then the scan goes into every live, unfinished
    submap; the oldest is finished at 2x the limit."""
    E = submaps.extent
    res = submaps.resolution
    newest_full = submaps.slot_valid[1] & (
        submaps.num_range_data[1] >= num_range_data_limit)
    need_add = (~submaps.slot_valid[0] & ~submaps.slot_valid[1]) \
        | newest_full
    added = _add_submap(submaps, origin)
    submaps = ActiveSubmaps2D(*[torch.where(need_add, a, b)
                                for a, b in zip(added, submaps)])

    # Both slots in one batched sweep.
    HW = E * E
    do = submaps.slot_valid & ~submaps.finished  # [2]
    max_xy = submaps.max_xy  # [2, 2] (x, y) upper corners

    def q_of(points):
        """World [N, 2] -> per-slot continuous cell coords [2, N, 2]."""
        return torch.stack(
            [(max_xy[:, None, 1] - points[None, :, 1]) / res,
             (max_xy[:, None, 0] - points[None, :, 0]) / res], dim=-1)

    def flat_ok(idx):
        """Cell index [..., 2] -> (flat [...], in-grid [...])."""
        ok = ((idx[..., 0] >= 0) & (idx[..., 1] >= 0)
              & (idx[..., 0] < E) & (idx[..., 1] < E))
        return idx[..., 1].long() * E + idx[..., 0].long(), ok

    # hits: round(q - 0.5) is the cell index (grid2d.cell_index)
    hq = q_of(hits)  # [2, H, 2]
    hflat, hok = flat_ok(torch.round(hq - 0.5).to(I32))
    cand_flat, cand_ok = [hflat], [hok & hits_mask[None, :]]
    cand_hit = [torch.ones_like(hok)]
    if insert_free_space:
        R = hits.shape[0] + misses.shape[0]
        oq = q_of(origin[None, :])[:, 0]  # [2, 2]
        endq = torch.cat([hq, q_of(misses)], dim=1)  # [2, R, 2]
        q0 = oq[:, None, :].expand(2, R, 2).reshape(2 * R, 2)
        ridx, remit = traverse_q(q0, endq.reshape(2 * R, 2), samples)
        rflat, rok = flat_ok(ridx.reshape(2, R, samples, 2))
        rmask = torch.cat([hits_mask, misses_mask])[None, :, None]
        rok = rok & remit.reshape(2, R, samples) & rmask
        cand_flat.append(rflat.reshape(2, -1))
        cand_ok.append(rok.reshape(2, -1))
        cand_hit.append(torch.zeros_like(cand_ok[-1]))

    flat = torch.cat(cand_flat, dim=1)  # [2, N]
    ok = torch.cat(cand_ok, dim=1) & do[:, None]
    is_hit = torch.cat(cand_hit, dim=1)
    gflat = flat + torch.arange(2, device=flat.device)[:, None] * HW
    plane = class_plane(gflat.reshape(-1), ok.reshape(-1),
                        is_hit.reshape(-1), 2 * HW)

    # One combined-table gather: class 0 -> identity, 1 -> miss, 2 -> hit,
    # then finish_update inline (strip the update markers).
    ident = torch.arange(pv.K_VALUE_COUNT, dtype=I32, device=flat.device)
    ctab = torch.cat([ident, miss_table, hit_table])
    old = submaps.cells.reshape(-1).long()
    newc = ctab[plane.long() * pv.K_VALUE_COUNT + old]
    newc = torch.where(newc >= pv.UPDATE_MARKER, newc - pv.UPDATE_MARKER,
                       newc)
    kmin, kmax = known_box((plane > 0).reshape(2, E, E), submaps.known_min,
                           submaps.known_max)
    num = submaps.num_range_data + do.to(I32)
    finish0 = submaps.slot_valid[0] & (num[0] >= 2 * num_range_data_limit)
    return submaps._replace(
        cells=newc.reshape(2, E, E), known_min=kmin, known_max=kmax,
        num_range_data=num,
        finished=torch.stack([submaps.finished[0] | finish0,
                              submaps.finished[1]]))


def matching_grid(submaps: ActiveSubmaps2D) -> Grid2D:
    """The submap used for scan matching: the oldest live slot
    (LocalMap.cpp:343-360), selected with torch.where."""
    first = submaps.slot_valid[0]

    def pick(x):
        return torch.where(first, x[0], x[1])

    E = submaps.extent
    max_xy = pick(submaps.max_xy)
    limits = MapLimits(resolution=submaps.resolution, max_x=max_xy[0],
                       max_y=max_xy[1], num_x=E, num_y=E)
    return Grid2D(limits=limits, cells=pick(submaps.cells),
                  known_min=pick(submaps.known_min),
                  known_max=pick(submaps.known_max))


def has_matching_submap(submaps: ActiveSubmaps2D):
    return submaps.slot_valid[0] | submaps.slot_valid[1]
