"""Fixed-capacity masked state for the fused per-frame step (torch port of
visfs_tpu.slam.state).

The NamedTuples carry the reference's field names and dtypes (int32 ids and
counters, bool masks, float32 values; the PRNG key is two uint32 words held
in int64; the occupancy cells and update tables' uint16 values in int32).
``state_from_numpy`` / ``state_to_numpy`` convert to and from a reference
``VOState`` fetched to numpy, laser state included, so both engines can be
handed the same mid-sequence state; ``graph_*`` and ``snapshot_*`` do the
same for the mapping back-end's KeyframeGraph and KeyframeSnapshot.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import prng
from ..map2d import probability_values as pv
from ..map2d.submap import ActiveSubmaps2D, init_active_submaps

F32 = torch.float32
I32 = torch.int32


class FeatureTable(NamedTuple):
    fid: torch.Tensor  # [F] int32 global feature id, -1 = free slot
    valid: torch.Tensor  # [F] bool
    uv: torch.Tensor  # [F, W, 2] left-image pixel observations
    uv_right: torch.Tensor  # [F, W, 2] right-image pixels
    depth: torch.Tensor  # [F, W] image-frame z per observation
    obs_mask: torch.Tensor  # [F, W] bool
    pw: torch.Tensor  # [F, 3] world-frame position
    stable: torch.Tensor  # [F] bool — STABLE (fixed in BA) vs NEW_ADDED
    track_cnt: torch.Tensor  # [F] int32 consecutive-track count
    start_frame: torch.Tensor  # [F] int32 first-observation signature id
    end_frame: torch.Tensor  # [F] int32 last-observation signature id

    @property
    def capacity(self):
        return self.fid.shape[0]

    @property
    def window(self):
        return self.uv.shape[1]


class WindowState(NamedTuple):
    frame_id: torch.Tensor  # [W] int32 signature ids, -1 = empty
    valid: torch.Tensor  # [W] bool
    pose_q: torch.Tensor  # [W, 4] Twr rotation
    pose_t: torch.Tensor  # [W, 3] Twr translation
    wheel_q: torch.Tensor  # [W, 4] wheel-odometry global pose
    wheel_t: torch.Tensor  # [W, 3]
    wheel_valid: torch.Tensor  # [W] bool
    stamp: torch.Tensor  # [W] f32 seconds


class KeyframeCounters(NamedTuple):
    new_feature_count: torch.Tensor  # int32
    signature_count: torch.Tensor  # int32
    parallax_count: torch.Tensor  # f32
    translation_count: torch.Tensor  # [3] f32


class OdomBuffer(NamedTuple):
    """Ring buffer of timestamped wheel odometry (stamp, pose, velocity)."""

    stamp: torch.Tensor  # [C] f32
    pose: torch.Tensor  # [C, 6] (x, y, z, roll, pitch, yaw)
    velocity: torch.Tensor  # [C, 6]
    valid: torch.Tensor  # [C] bool
    head: torch.Tensor  # int32 next write slot


class LaserState(NamedTuple):
    """Laser fusion state (strategies >= 3): active submaps + tables."""

    submaps: ActiveSubmaps2D
    hit_table: torch.Tensor  # [32768] int32 (uint16 values)
    miss_table: torch.Tensor
    cost_table: torch.Tensor  # [65536] f32 value -> correspondence cost
    t_laser_robot: torch.Tensor  # [4, 4] laser -> robot extrinsic


class VOState(NamedTuple):
    features: FeatureTable
    window: WindowState
    counters: KeyframeCounters
    odom: OdomBuffer
    prev_left: torch.Tensor  # [H, W] previous left image
    prev_right: torch.Tensor  # [H, W]
    has_prev: torch.Tensor  # bool
    pose_q: torch.Tensor  # [4] current global robot pose Twr
    pose_t: torch.Tensor  # [3]
    prev_wheel_q: torch.Tensor  # [4]
    prev_wheel_t: torch.Tensor  # [3]
    prev_wheel_valid: torch.Tensor  # bool
    velocity: torch.Tensor  # [6] xyzrpy/s guess velocity
    velocity_valid: torch.Tensor  # bool
    prev_stamp: torch.Tensor  # f32
    next_fid: torch.Tensor  # int32
    frame_count: torch.Tensor  # int32
    keyframe: torch.Tensor  # bool — last frame's keySignature_ decision
    lost: torch.Tensor  # bool
    blocked_uv: torch.Tensor  # [B, 2] blocked-word positions
    blocked_valid: torch.Tensor  # [B] bool
    rng_key: torch.Tensor  # [2] int64 holding the uint32 threefry key
    laser: LaserState | None = None  # strategies >= 3
    # Previous left image's LK pyramid: per level (padded image, gx, gy).
    prev_pyr: tuple = ()


class FrameOutput(NamedTuple):
    """Per-frame odometry + diagnostics (TrackInfo/EstimateInfo)."""

    pose: torch.Tensor  # [4, 4] global robot pose Twr
    transform: torch.Tensor  # [4, 4] frame-to-frame delta
    lost: torch.Tensor
    n_features: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    n_new: torch.Tensor
    keyframe: torch.Tensor
    ba_chi2: torch.Tensor
    ba_ok: torch.Tensor
    velocity: torch.Tensor  # [6] xyzrpy/s
    stamp: torch.Tensor
    covariance: torch.Tensor  # [6, 6]
    # Per-stage wall times in seconds (EstimateInfo's timing fields,
    # Signature.h:62-73): measured around the synced stages with
    # System(profile_stages=True), 0.0 in the fused step (its stages have
    # no host-visible boundary).
    time_tracking: float = 0.0
    time_estimation: float = 0.0
    local_bundle_time: float = 0.0
    time_total: float = 0.0


class KeyframeGraph(NamedTuple):
    """The mapping back-end's fixed-capacity keyframe pose graph."""

    pose_q: torch.Tensor  # [N, 4] Twr rotations
    pose_t: torch.Tensor  # [N, 3]
    stamp: torch.Tensor  # [N]
    robot: torch.Tensor  # [N] int32 owning robot (multi-robot sessions)
    valid: torch.Tensor  # [N] bool
    n_nodes: torch.Tensor  # int32
    edge_i: torch.Tensor  # [E] int32
    edge_j: torch.Tensor  # [E] int32
    edge_q: torch.Tensor  # [E, 4] measured T_ri_rj rotation
    edge_t: torch.Tensor  # [E, 3]
    edge_info: torch.Tensor  # [E]
    edge_valid: torch.Tensor  # [E] bool
    n_edges: torch.Tensor  # int32


class KeyframeSnapshot(NamedTuple):
    """Per-keyframe appearance record for loop verification."""

    uv: torch.Tensor  # [M, 2] left-image pixels
    p_robot: torch.Tensor  # [M, 3] robot-frame 3D points
    patch: torch.Tensor  # [M, S*S*scales] zero-mean unit-norm patches
    valid: torch.Tensor  # [M] bool


def init_feature_table(capacity: int, window: int, device) -> FeatureTable:
    def z(*shape, dtype=F32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FeatureTable(
        fid=torch.full((capacity,), -1, dtype=I32, device=device),
        valid=z(capacity, dtype=torch.bool),
        uv=z(capacity, window, 2), uv_right=z(capacity, window, 2),
        depth=z(capacity, window),
        obs_mask=z(capacity, window, dtype=torch.bool),
        pw=z(capacity, 3), stable=z(capacity, dtype=torch.bool),
        track_cnt=z(capacity, dtype=I32), start_frame=z(capacity, dtype=I32),
        end_frame=z(capacity, dtype=I32),
    )


def _unit_quats(n: int, device):
    q = torch.zeros((n, 4), dtype=F32, device=device)
    q[:, 0] = 1.0
    return q


def init_window(window: int, device) -> WindowState:
    return WindowState(
        frame_id=torch.full((window,), -1, dtype=I32, device=device),
        valid=torch.zeros(window, dtype=torch.bool, device=device),
        pose_q=_unit_quats(window, device),
        pose_t=torch.zeros((window, 3), dtype=F32, device=device),
        wheel_q=_unit_quats(window, device),
        wheel_t=torch.zeros((window, 3), dtype=F32, device=device),
        wheel_valid=torch.zeros(window, dtype=torch.bool, device=device),
        stamp=torch.zeros(window, dtype=F32, device=device),
    )


def init_laser_state(resolution: float, extent_cells: int,
                     hit_probability: float, miss_probability: float,
                     t_laser_robot=None, *, device) -> LaserState:
    hit, miss = pv.hit_miss_tables(hit_probability, miss_probability, device)
    t = (torch.eye(4, dtype=F32, device=device) if t_laser_robot is None
         else torch.as_tensor(np.asarray(t_laser_robot), dtype=F32,
                              device=device))
    return LaserState(
        submaps=init_active_submaps(resolution, extent_cells, device),
        hit_table=hit, miss_table=miss, cost_table=pv.cost_table(device),
        t_laser_robot=t)


def init_pyramid_state(height: int, width: int, pad: int, max_level: int,
                       device) -> tuple:
    """Zero-filled carried LK pyramid shaped like ops.lk.build_lk_pyramid
    (levels padded by ``pad`` = ops.lk.lk_pad)."""
    levels = []
    h, w = height, width
    for _ in range(max_level + 1):
        levels.append(tuple(
            torch.zeros((h + 2 * pad, w + 2 * pad), dtype=F32, device=device)
            for _ in range(3)))
        h, w = (h + 1) // 2, (w + 1) // 2
    return tuple(levels)


def init_state(height: int, width: int, capacity: int, window: int, *,
               device, odom_capacity: int = 64, blocked_capacity: int = 64,
               seed: int = 0, laser: LaserState | None = None,
               lk_pad: int = 12, lk_max_level: int = 3) -> VOState:
    def z(*shape, dtype=F32):
        return torch.zeros(shape, dtype=dtype, device=device)

    b = torch.bool
    return VOState(
        features=init_feature_table(capacity, window, device),
        window=init_window(window, device),
        counters=KeyframeCounters(
            new_feature_count=z(dtype=I32), signature_count=z(dtype=I32),
            parallax_count=z(), translation_count=z(3)),
        odom=OdomBuffer(stamp=z(odom_capacity), pose=z(odom_capacity, 6),
                        velocity=z(odom_capacity, 6),
                        valid=z(odom_capacity, dtype=b), head=z(dtype=I32)),
        prev_left=z(height, width), prev_right=z(height, width),
        has_prev=z(dtype=b),
        pose_q=_unit_quats(1, device)[0], pose_t=z(3),
        prev_wheel_q=_unit_quats(1, device)[0], prev_wheel_t=z(3),
        prev_wheel_valid=z(dtype=b), velocity=z(6), velocity_valid=z(dtype=b),
        prev_stamp=z(), next_fid=z(dtype=I32), frame_count=z(dtype=I32),
        keyframe=torch.ones((), dtype=b, device=device),  # starts true
        lost=z(dtype=b),
        blocked_uv=z(blocked_capacity, 2),
        blocked_valid=z(blocked_capacity, dtype=b),
        rng_key=prng.PRNGKey(seed, device=device),
        laser=laser,
        prev_pyr=init_pyramid_state(height, width, lk_pad, lk_max_level,
                                    device),
    )


# ---------------------------------------------------------------------------
# numpy <-> torch converters (the reference state fetched with device_get)
# ---------------------------------------------------------------------------

_NP_TO_TORCH = {np.dtype(np.float32): F32, np.dtype(np.float64): F32,
                np.dtype(np.int32): I32, np.dtype(np.bool_): torch.bool,
                np.dtype(np.uint32): torch.int64,
                np.dtype(np.uint16): I32}


def _to_torch(x, device):
    a = np.asarray(x)
    dtype = _NP_TO_TORCH.get(a.dtype)
    if dtype is None:
        raise TypeError(f"state_from_numpy: unsupported dtype {a.dtype}")
    return torch.tensor(a.astype(np.int64) if a.dtype == np.uint32 else a,
                        dtype=dtype, device=device)


def _to_numpy(t):
    a = t.detach().cpu().numpy()
    return a.astype(np.uint32) if t.dtype == torch.int64 else a


def _to_uint16(t):
    """int32 codec values back to the reference's uint16 (exact)."""
    return t.detach().cpu().numpy().astype(np.uint16)


def _convert(cls, src, leaf):
    return cls(**{f: (None if getattr(src, f) is None
                      else leaf(getattr(src, f)))
                  for f in cls._fields})


def _laser_from_numpy(la, device):
    if la is None:
        return None

    def leaf(x):
        return _to_torch(x, device)

    return LaserState(submaps=_convert(ActiveSubmaps2D, la.submaps, leaf),
                      hit_table=leaf(la.hit_table),
                      miss_table=leaf(la.miss_table),
                      cost_table=leaf(la.cost_table),
                      t_laser_robot=leaf(la.t_laser_robot))


def _laser_to_numpy(la):
    if la is None:
        return None
    sub = _convert(ActiveSubmaps2D, la.submaps, _to_numpy)
    return LaserState(submaps=sub._replace(cells=_to_uint16(la.submaps.cells)),
                      hit_table=_to_uint16(la.hit_table),
                      miss_table=_to_uint16(la.miss_table),
                      cost_table=_to_numpy(la.cost_table),
                      t_laser_robot=_to_numpy(la.t_laser_robot))


_NESTED = ("features", "window", "counters", "odom", "laser", "prev_pyr")


def state_from_numpy(s, device) -> VOState:
    """Port VOState (on ``device``) from a reference VOState whose leaves are
    numpy arrays (``jax.device_get(state)``), laser state included."""

    def leaf(x):
        return _to_torch(x, device)

    return VOState(
        features=_convert(FeatureTable, s.features, leaf),
        window=_convert(WindowState, s.window, leaf),
        counters=_convert(KeyframeCounters, s.counters, leaf),
        odom=_convert(OdomBuffer, s.odom, leaf),
        **{f: leaf(getattr(s, f)) for f in VOState._fields
           if f not in _NESTED},
        laser=_laser_from_numpy(getattr(s, "laser", None), device),
        prev_pyr=tuple(tuple(leaf(p) for p in lv) for lv in s.prev_pyr),
    )


def state_to_numpy(s: VOState) -> VOState:
    """The same state with numpy leaves in the reference's dtypes (the
    PRNG key back to uint32, cells and update tables to uint16)."""
    return VOState(
        features=_convert(FeatureTable, s.features, _to_numpy),
        window=_convert(WindowState, s.window, _to_numpy),
        counters=_convert(KeyframeCounters, s.counters, _to_numpy),
        odom=_convert(OdomBuffer, s.odom, _to_numpy),
        **{f: _to_numpy(getattr(s, f)) for f in VOState._fields
           if f not in _NESTED},
        laser=_laser_to_numpy(s.laser),
        prev_pyr=tuple(tuple(_to_numpy(p) for p in lv) for lv in s.prev_pyr),
    )


def graph_from_numpy(g, device) -> KeyframeGraph:
    """Port KeyframeGraph (on ``device``) from a reference KeyframeGraph
    with numpy leaves."""
    return _convert(KeyframeGraph, g, lambda x: _to_torch(x, device))


def graph_to_numpy(g: KeyframeGraph) -> KeyframeGraph:
    """The same graph with numpy leaves in the reference's dtypes."""
    return _convert(KeyframeGraph, g, _to_numpy)


def snapshot_from_numpy(s, device) -> KeyframeSnapshot:
    """Port KeyframeSnapshot (on ``device``) from a reference snapshot with
    numpy leaves."""
    return _convert(KeyframeSnapshot, s, lambda x: _to_torch(x, device))


def snapshot_to_numpy(s: KeyframeSnapshot) -> KeyframeSnapshot:
    """The same snapshot with numpy leaves."""
    return _convert(KeyframeSnapshot, s, _to_numpy)
