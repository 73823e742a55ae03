"""Faults planted underneath the timed path, each of which the comparison
has to find: ``correct`` comes out false.  The CPU tests plant them at a
small size (``tests/test_bench_faults.py``); ``control.py --faults`` plants
them at a cell's own size on the card.

Each fault wraps ``visfs_tpu_torch.slam.fleet.fleet_step`` (the vmapped
step the window drives) or the tracker's reverse-flow track under it, for
as long as the ``planted`` block lasts.
"""

from __future__ import annotations

import contextlib

import torch
import torch.utils._pytree as pytree

ROW_STRIDE = 10  # the tenth of the rows a partial fault touches


def _state_unchanged(real, cell, calls, states, *args):
    _, out = real(states, *args)
    return states, out


def _half_batch(real, cell, calls, states, lefts, rights, stamps, *args):
    """The first half of the streams is stepped, the rest take its
    results."""
    h = lefts.shape[0] // 2
    first = pytree.tree_map(lambda x: None if x is None else x[:h], states)
    new, out = real(first, lefts[:h], rights[:h], stamps[:h], *args)

    def both(x):
        return None if x is None else torch.cat([x, x])

    return (pytree.tree_map(both, new),
            type(out)(*[both(f) if isinstance(f, torch.Tensor) else f
                        for f in out]))


def _track_ends_shifted(real, cell, calls, *args):
    """A tenth of the feature rows' newest track ends moved 0.5 px."""
    new, out = real(*args)
    f = new.features
    uv = f.uv.clone()
    uv[:, ::ROW_STRIDE, -1] += 0.5
    return new._replace(features=f._replace(uv=uv)), out


def _poses_moved_late(real, cell, calls, *args):
    """Every other frame's poses moved 1 m along x, only on the frames
    after the window's first span."""
    new, out = real(*args)
    tr = cell.traffic
    first = tr["warmup_frames"] + tr["check"]["span_frames"]
    if len(calls) > first and len(calls) % 2 == 0:
        pose = out.pose.clone()
        pose[:, 0, 3] += 1.0
        out = out._replace(pose=pose)
    return new, out


def _poses_jump(real, cell, calls, *args):
    """From the window's frame ``span`` on, every pose 1 m along x: one
    jump, where spans laid end to end from the window's first frame would
    meet."""
    new, out = real(*args)
    tr = cell.traffic
    if len(calls) > tr["warmup_frames"] + tr["check"]["span_frames"]:
        pose = out.pose.clone()
        pose[:, 0, 3] += 1.0
        out = out._replace(pose=pose)
    return new, out


def _landmarks_moved(real, cell, calls, *args):
    """Every landmark 10 % farther from its stream's robot, the poses left
    as the step made them."""
    new, out = real(*args)
    f = new.features
    centre = out.pose[:, None, :3, 3].to(f.pw.dtype)
    return new._replace(features=f._replace(
        pw=centre + 1.1 * (f.pw - centre))), out


STEP_FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_batch": _half_batch,
    "track_ends_shifted": _track_ends_shifted,
    "poses_moved_late": _poses_moved_late,
    "poses_jump": _poses_jump,
    "landmarks_moved": _landmarks_moved,
}


def _reverse_skipped(real, pyr_from, pyr_to, pts_from, pts_init, valid,
                     params, fb_threshold=1.5):
    """The forward track alone: status true for every in-bounds track."""
    from visfs_tpu_torch.ops.lk import lk_track_pyr

    return lk_track_pyr(pyr_from, pyr_to, pts_from, pts_init, valid, params)


def _good_dropped(real, *args, **kw):
    """A tenth of the tracks dropped whatever their status."""
    res = real(*args, **kw)
    keep = torch.arange(res.status.shape[-1],
                        device=res.status.device) % ROW_STRIDE != 0
    return res._replace(status=res.status & keep)


TRACK_FAULTS = {
    "reverse_skipped": _reverse_skipped,
    "good_dropped": _good_dropped,
}

NAMES = tuple(STEP_FAULTS) + tuple(TRACK_FAULTS)
# Faults that act only after the window's first span: read with a window
# as long as a run's.
LATE = ("poses_moved_late", "poses_jump")


@contextlib.contextmanager
def planted(name: str, cell):
    """Plant fault ``name`` for the block's length (the cell gives the
    window's frame counts)."""
    if name in STEP_FAULTS:
        import visfs_tpu_torch.slam.fleet as module
        attr, fault = "fleet_step", STEP_FAULTS[name]
    else:
        import visfs_tpu_torch.slam.tracker as module
        attr, fault = "lk_track_bidirectional_pyr", TRACK_FAULTS[name]
    real = getattr(module, attr)
    calls = []

    def wrapped(*args, **kw):
        if name in STEP_FAULTS:
            calls.append(1)
            return fault(real, cell, calls, *args, **kw)
        return fault(real, *args, **kw)

    setattr(module, attr, wrapped)
    try:
        yield
    finally:
        setattr(module, attr, real)
