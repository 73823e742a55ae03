"""Checkpoint / resume of the engine state (torch port of
visfs_tpu.io.checkpoint).

The reference serializes its VOState pytree with orbax; the port writes the
same state, fetched to numpy in the reference's dtypes by
``slam.state.state_to_numpy`` (laser state included), into one ``.npz``
keyed by each leaf's path, and restores it against a template from
``init_state`` with the same static configuration: every leaf comes back
bit-equal on the template's device.  ``save_system`` keeps the reference's
``config.json`` (``config_to_parameters``, the same bytes for the same
parameters) and ``save_mapping`` its ``.npz`` layout key for key, so a
mapping file that either package writes, the other restores.

Paths: ``save_mapping`` and ``restore_mapping`` both append ``.npz`` when
the path lacks it, which is what ``np.savez`` writes (the reference's
restore replaces the suffix instead, so a ``map.ckpt`` it saved does not
restore; a ``.npz`` path behaves as in the reference).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from ..config import config_to_parameters
from ..slam.state import (KeyframeGraph, KeyframeSnapshot, graph_from_numpy,
                          graph_to_numpy, snapshot_from_numpy,
                          snapshot_to_numpy, state_from_numpy, state_to_numpy)


def _flatten(tree, prefix: str, out: dict) -> None:
    """numpy leaves of nested NamedTuples / tuples into out[path]."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            _flatten(getattr(tree, f), f"{prefix}{f}/", out)
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _unflatten(template, prefix: str, arrays):
    """The template's structure with its tensor leaves replaced by
    arrays[path] (numpy)."""
    if template is None:
        return None
    if hasattr(template, "_fields"):
        return type(template)(**{
            f: _unflatten(getattr(template, f), f"{prefix}{f}/", arrays)
            for f in template._fields})
    if isinstance(template, tuple):
        return tuple(_unflatten(v, f"{prefix}{i}/", arrays)
                     for i, v in enumerate(template))
    key = prefix[:-1]
    if key not in arrays:
        raise ValueError(f"checkpoint lacks the leaf {key!r}")
    a = arrays[key]
    if tuple(a.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape {a.shape}, the "
                         f"template {tuple(template.shape)}")
    return a


def _npz(path) -> Path:
    path = str(path)
    return Path(path if path.endswith(".npz") else path + ".npz")


def save_state(path: str | os.PathLike, state) -> None:
    """Serialize a VOState to ``path`` (one .npz; the suffix is added when
    missing)."""
    path = _npz(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays: dict = {}
    _flatten(state_to_numpy(state), "", arrays)
    np.savez(path, **arrays)


def restore_state(path: str | os.PathLike, template):
    """Restore a VOState saved by save_state onto the template's device.

    template: a VOState of the same static configuration (e.g. from
    init_state) giving the structure and the shapes."""
    device = template.pose_t.device
    with np.load(_npz(path)) as d:
        arrays = {k: d[k] for k in d.files}
    return state_from_numpy(_unflatten(template, "", arrays), device)


def save_system(path: str | os.PathLike, system) -> None:
    """Checkpoint a slam.system.System: state + config snapshot (the
    state as ``System.state`` reads it, under its lock, with every wheel
    row pushed so far)."""
    path = Path(path)
    save_state(path / "state.npz", system.state)
    (path / "config.json").write_text(
        json.dumps(config_to_parameters(system.cfg), indent=2)
    )


def restore_system(path: str | os.PathLike, system) -> None:
    """Restore a System checkpointed with save_system (config must match;
    the System must be init()-ed with the same camera and capacities).
    The state is replaced under the System's lock, as one assignment:
    wheel rows pushed before the restore are dropped with the old state."""
    path = Path(path)
    saved_cfg = json.loads((path / "config.json").read_text())
    if saved_cfg != config_to_parameters(system.cfg):
        raise ValueError(
            "checkpoint config does not match the System configuration"
        )
    template = system.state
    if template is None:
        raise RuntimeError("restore_system: call System.init() first")
    system.state = restore_state(path / "state.npz", template)


def save_mapping(path: str | os.PathLike, backend) -> None:
    """Checkpoint a slam.mapping.MappingBackend: the keyframe graph, the
    per-keyframe appearance snapshots, and the session bookkeeping
    (per-robot odometry-chain tails, decided loop pairs), as one .npz in
    the reference's layout (snapshots stacked along a leading node axis)."""
    path = _npz(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    g = graph_to_numpy(backend.graph)
    payload = {f"graph_{k}": np.asarray(v) for k, v in g._asdict().items()}
    snap_ids = sorted(backend.snapshots)
    payload["snap_ids"] = np.asarray(snap_ids, np.int64)
    if snap_ids:
        snaps = [snapshot_to_numpy(backend.snapshots[i]) for i in snap_ids]
        for field in KeyframeSnapshot._fields:
            payload[f"snap_{field}"] = np.stack(
                [np.asarray(getattr(s, field)) for s in snaps]
            )
    payload["last_node"] = np.asarray(
        sorted(backend._last_node.items()), np.int64
    ).reshape(-1, 2)
    payload["decided"] = np.asarray(
        sorted(backend._decided_pairs), np.int64
    ).reshape(-1, 2)
    payload["odom_info"] = np.asarray(backend.odom_info, np.float64)
    np.savez(path, **payload)


def restore_mapping(path: str | os.PathLike, backend) -> None:
    """Restore a MappingBackend checkpointed with save_mapping (by either
    package) onto the backend's device.  The backend must be constructed
    with the same node/edge capacities."""
    device = backend.graph.pose_t.device
    with np.load(_npz(path)) as d:
        graph = graph_from_numpy(KeyframeGraph(**{
            f: d[f"graph_{f}"] for f in KeyframeGraph._fields}), device)
        if graph.pose_q.shape != backend.graph.pose_q.shape \
                or graph.edge_i.shape != backend.graph.edge_i.shape:
            raise ValueError(
                "checkpoint graph capacity does not match backend")
        snapshots = {
            int(node_id): snapshot_from_numpy(KeyframeSnapshot(
                **{f: d[f"snap_{f}"][j] for f in KeyframeSnapshot._fields}),
                device)
            for j, node_id in enumerate(d["snap_ids"])}
        last_node = {int(r): int(n) for r, n in d["last_node"]}
        decided = {(int(i), int(j)) for i, j in d["decided"]}
        odom_info = float(d["odom_info"])
    backend.graph = graph
    backend.snapshots = snapshots
    backend._last_node = last_node
    backend._decided_pairs = decided
    backend.odom_info = odom_info
