"""FleetSystem: B independent VO streams in one vmapped step (torch port of
visfs_tpu.slam.fleet).

``fleet_step`` is ``torch.func.vmap`` of the port's fused ``vo_step`` over
the tensor leaves of a stacked ``VOState``: the vmapped function IS the
single-stream step, so a stream's results agree with a ``System`` of the
same seed up to the reassociation of the batched reductions.  The camera,
the settings and the LK parameters are shared (one configuration for the
fleet).  The step's two LK tracks are the pyramid entries' custom ops
(``ops.kernels.pyramid.pyramid_op``), whose batching rule stacks the
streams and launches the kernel once with a stream axis: a fleet frame is
2 launches of K1 for all B streams, as the reference's vmapped
``pallas_call`` gains a batch axis in its grid.

Strategies 0-2 only, as in the reference: at 3-5 the step holds the laser
state and its submap updates, which the reference keeps out of its vmap.
``dp_fleet_step`` runs one stream per rank of a ``parallel.mesh.Mesh``
instead (``torch.distributed``), each rank the plain ``vo_step`` on its own
stream at any strategy, and gathers the frame outputs into [B] on every
rank, as the reference's single controller sees them from its ``dp`` mesh.

With the span recorder on (``utils.timer.enable``) a fleet frame records
``fleet.input`` around ``input_primary_sensor_data``, with a frame id from
the FleetSystem's own counter, over ``vo_step``'s four stage spans, and
``fleet.output`` around the take of its result (the stack, the copy to the
host and the wait for the card).
"""

from __future__ import annotations

import collections
import itertools
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as _pytree

from ..config import VISFSConfig, config_from_parameters
from ..core.camera import StereoCamera, make_stereo_camera
from ..ops.lk import LKParams, lk_pad
from ..parallel.mesh import gather_stacked
from ..utils.timer import span
from . import extrapolator as extr
from .state import FrameOutput, VOState, init_state
from .system import _build_settings, build_cfg_hash, vo_step

# The tensor fields of FrameOutput (its time_* fields are host floats).
_OUT_FIELDS = FrameOutput._fields[:13]


def _tensor_fields(out: FrameOutput) -> tuple:
    return tuple(getattr(out, f) for f in _OUT_FIELDS)


def fleet_step(states: VOState, lefts, rights, stamps, cam: StereoCamera,
               cfg_est, lk_params: LKParams, cfg_hash: tuple):
    """One frame of every stream: ``torch.func.vmap`` of ``vo_step`` over
    the leading [B] axis of states, lefts/rights [B, H, W] and stamps [B].
    Returns (new states, FrameOutput with [B] fields)."""

    leaves, spec = _pytree.tree_flatten(states)
    out_spec = []

    def one(tensors, left, right, stamp):
        new_state, out = vo_step(_unflatten(tensors, leaves, spec), left,
                                 right, stamp, cam, cfg_est, lk_params,
                                 cfg_hash)
        new_leaves, new_spec = _pytree.tree_flatten(new_state)
        out_spec.append((new_leaves, new_spec))
        return _tensors(new_leaves), _tensor_fields(out)

    new_tensors, fields = torch.func.vmap(one)(_tensors(leaves), lefts,
                                               rights, stamps)
    new_leaves, new_spec = out_spec[0]
    return (_unflatten(new_tensors, new_leaves, new_spec),
            FrameOutput(*fields))


# vmap maps tensors only: a state's None leaves (the laser state at
# strategies 0-2) are taken out around it and put back after.

def _tensors(leaves) -> list:
    return [x for x in leaves if x is not None]


def _unflatten(tensors, leaves, spec):
    it = iter(tensors)
    return _pytree.tree_unflatten(
        [None if x is None else next(it) for x in leaves], spec)


def _push_odometry_fleet(states: VOState, stamps, pose6, vel6, valid):
    """Push one wheel-odometry sample per stream, masked by ``valid`` [B]
    (a stream without a sample keeps its ring buffer)."""

    def push(odom, stamp, p6, v6, ok):
        new = extr.add_odometry(odom, stamp, p6, v6)
        return type(odom)(*[torch.where(ok, a, b)
                            for a, b in zip(new, odom)])

    return states._replace(odom=torch.func.vmap(push)(
        states.odom, stamps, pose6, vel6, valid))


def _stack_states(states):
    """A VOState whose tensor leaves are the streams' stacked on axis 0."""
    return _pytree.tree_map(
        lambda *xs: None if xs[0] is None else torch.stack(xs), *states)


def stream_state(states: VOState, i: int) -> VOState:
    """Stream i of a stacked VOState."""
    return _pytree.tree_map(lambda x: None if x is None else x[i], states)


class FleetSystem:
    """Host-side engine for B lockstep VO streams on one device (the
    reference's FleetSystem API): every input and output carries a leading
    [B] axis.

    Streams are independent: each has its own state (features, window,
    odometry buffer, RNG) seeded ``seed + i``.  ``device`` "cuda" (the
    default) runs the step on the card, "cpu" through the kernels' plain
    versions; a CUDA device without CUDA raises.  ``lk_params`` comes from
    the config with ``backend="pallas"`` (K1), as ``System``'s does;
    replace it before ``init`` for another LK formulation."""

    def __init__(self, parameters=None, n_streams: int = 8, *,
                 device="cuda", feature_capacity_factor: int = 3,
                 seed: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FleetSystem: device 'cuda' requested but "
                               "CUDA is not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"FleetSystem: unsupported device "
                             f"{self.device}")
        self.cfg: VISFSConfig = (
            parameters if isinstance(parameters, VISFSConfig)
            else config_from_parameters(parameters))
        if self.cfg.system_sensor_strategy not in range(3):
            raise NotImplementedError(
                "FleetSystem supports strategies 0-2: the laser strategies "
                "keep their submaps out of the vmapped step; use "
                "dp_fleet_step (one stream per rank, every strategy) or "
                "separate System instances")
        self.n_streams = int(n_streams)
        self.settings = _build_settings(self.cfg)
        self.lk_params = LKParams.from_config(self.cfg)
        self._cfg_hash = build_cfg_hash(self.cfg)
        self._capacity_factor = feature_capacity_factor
        self._seed = seed
        self.camera: Optional[StereoCamera] = None
        self.states: Optional[VOState] = None  # leading [B] axis throughout
        self._results = collections.deque()  # (frame id, FrameOutput)
        self._frame_ids = itertools.count()  # the spans' frame ids

    def init(self, fx, fy, cx, cy, baseline, *, width, height, fxr=None,
             fyr=None, cxr=None, cyr=None, transform_camera_to_robot=None):
        """The shared camera and B fresh states, stream i seeded
        seed + i."""
        self.camera = make_stereo_camera(
            fx, fy, cx, cy, baseline, fxr=fxr, fyr=fyr, cxr=cxr, cyr=cyr,
            t_camera_to_robot=transform_camera_to_robot, width=width,
            height=height, device=self.device)
        self.states = _stack_states([
            init_state(height, width,
                       capacity=int(self._capacity_factor
                                    * self.cfg.tracker_max_features),
                       window=self.cfg.local_map_map_size + 1,
                       device=self.device, seed=self._seed + i,
                       lk_pad=lk_pad(self.lk_params),
                       lk_max_level=self.lk_params.max_level)
            for i in range(self.n_streams)])
        self._results.clear()

    def _to_device(self, a):
        """A host array on the device as float32 without waiting for it
        (pinned, copied with non_blocking; a tensor is moved as it is)."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32).contiguous()
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def input_primary_sensor_data(self, stamps, lefts, rights):
        """Feed one frame per stream: stamps [B], lefts/rights [B, H, W];
        the [B]-batched result is queued on the device."""
        if self.states is None:
            raise RuntimeError("call init() first")
        frame = next(self._frame_ids)
        with span("fleet.input", frame):
            self.states, out = fleet_step(
                self.states, self._to_device(lefts), self._to_device(rights),
                self._to_device(stamps), self.camera, self.settings,
                self.lk_params, self._cfg_hash)
            self._results.append((frame, out))

    def input_wheel_odometry(self, stamps, pose6, velocity6=None,
                             valid=None):
        """Push one odometry sample per stream: stamps [B], pose6 [B, 6],
        optional velocity6 [B, 6]; valid [B] masks the streams with no
        sample this tick (their ring buffers are left untouched)."""
        if self.states is None:
            raise RuntimeError("call init() first")
        b = self.n_streams
        rows = np.zeros((b, 14), np.float32)  # stamp, pose6, vel6, valid
        rows[:, 0] = np.asarray(stamps, np.float32).reshape(b)
        rows[:, 1:7] = np.asarray(pose6, np.float32).reshape(b, 6)
        if velocity6 is not None:
            rows[:, 7:13] = np.asarray(velocity6, np.float32).reshape(b, 6)
        rows[:, 13] = (1.0 if valid is None
                       else np.asarray(valid, bool).reshape(b))
        dev = self._to_device(rows)
        self.states = _push_odometry_fleet(self.states, dev[:, 0],
                                           dev[:, 1:7], dev[:, 7:13],
                                           dev[:, 13] > 0.5)

    def output_odometry_info(self):
        """Pop the oldest finished fleet result (a FrameOutput of [B]
        numpy fields), or None."""
        if not self._results:
            return None
        frame, out = self._results.popleft()
        with span("fleet.output", frame):
            return fleet_outputs_to_numpy([out])[0]

    def drain_outputs(self):
        """Fetch every queued fleet result, one transfer per field."""
        outs = [out for _, out in self._results]
        self._results.clear()
        return fleet_outputs_to_numpy(outs)

    def run_sequences(self, stamps, lefts, rights, wheel_odom=None):
        """Feed whole sequences: stamps [T, B], lefts/rights [T, B, H, W].

        wheel_odom: optional [K, B, 8] rows of (stamp, x..yaw, valid) fed
        in timestamp order ahead of each frame, as the ROS callbacks would.
        Returns the T [B]-batched FrameOutputs."""
        odom_i = 0
        for i in range(len(stamps)):
            if wheel_odom is not None:
                while (odom_i < len(wheel_odom)
                       and float(np.min(wheel_odom[odom_i][:, 0]))
                       <= float(np.max(stamps[i])) + 1e-9):
                    row = np.asarray(wheel_odom[odom_i])
                    self.input_wheel_odometry(row[:, 0], row[:, 1:7],
                                              valid=row[:, 7] > 0.5)
                    odom_i += 1
            self.input_primary_sensor_data(stamps[i], lefts[i], rights[i])
        return self.drain_outputs()


def fleet_outputs_to_numpy(outs):
    """Device FrameOutputs with [B] fields as numpy, one transfer per
    field."""
    if not outs:
        return []
    fields = [torch.stack([getattr(o, f) for o in outs]).cpu().numpy()
              for f in _OUT_FIELDS]
    return [FrameOutput(*[a[i] for a in fields]) for i in range(len(outs))]


# --- one stream per rank --------------------------------------------------

def dp_fleet_step(mesh, state: VOState, left, right, stamp,
                  cam: StereoCamera, cfg_est, lk_params: LKParams,
                  cfg_hash: tuple, scan_points=None, scan_mask=None,
                  scan_times=None):
    """Cross-rank fleet: this rank's stream, one per rank of ``mesh`` (a
    ``parallel.mesh.Mesh`` with axis "dp"; None or a group of None is this
    process alone).  The rank runs the plain single-stream ``vo_step`` on
    its own state, at any sensor strategy (scan_points [K, 3], scan_mask
    [K] and scan_times [K] at 3-5).  Returns (this rank's new state, the
    FrameOutput of every rank with [B] fields in rank order)."""
    if mesh is not None and mesh.axis != "dp":
        raise ValueError(f"dp_fleet_step: a mesh with axis 'dp', got "
                         f"{mesh.axis!r}")
    kw = {}
    if scan_points is not None:
        if scan_times is None:
            scan_times = torch.zeros(scan_mask.shape, dtype=torch.float32,
                                     device=scan_mask.device)
        kw = dict(scan_points=scan_points, scan_mask=scan_mask,
                  scan_times=scan_times)
    new_state, out = vo_step(state, left, right, stamp, cam, cfg_est,
                             lk_params, cfg_hash, **kw)
    fields = gather_stacked(_tensor_fields(out),
                            None if mesh is None else mesh.group)
    return new_state, FrameOutput(*fields)
