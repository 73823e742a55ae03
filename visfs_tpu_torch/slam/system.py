"""System: the top-level engine — one fused step per frame (torch port of
visfs_tpu.slam.system, SensorStrategies 0-5).

``vo_step`` runs track -> prepare -> BA -> finalize on the device given to
``System``.  The step keeps the reference's shape discipline: fixed shapes,
no ``.item()``, no boolean-mask indexing and no Python branch on tensor
data, so it never waits for the device and can later be captured in a CUDA
graph.  Results stay on the device until ``output_odometry_info`` or
``drain_outputs`` fetches them.  ``System(profile_stages=True)`` runs the
same four stage functions with a device synchronisation after each, and
fills FrameOutput's ``time_*`` fields from the host clock (the reference's
per-thread stage timers); the fused step leaves them 0.

Host API (reference System.h:30-53): ``init``, ``input_primary_sensor_data``
(the stereo pair, or at SensorStrategy 1 the image and its depth map in
metres; with a laser scan at strategies >= 3), ``input_wheel_odometry``,
``input_wheel_odometry_batch``, ``output_odometry_info``, ``drain_outputs``,
``run_sequence``.  Scans and wheel rows arrive as numpy every frame; they
are padded and masked on the host and copied through pinned memory with
``non_blocking=True``, so feeding them does not wait for the device either;
numpy images take the same way, tensors are used as they are.

Threads: the native runtime's worker (``visfs_tpu_torch.runtime``) steps
the System while a transport's thread pushes wheel rows.  A push only
appends its host rows to a pending list under a short lock, so it never
waits for the step in flight.  The step, under the state lock, applies the
pending rows stamped at or before its frame, in push order, and leaves the
later ones pending: it sees the rows a serial feed (rows up to a frame,
then the frame) gives it, however far the pushing thread runs ahead, and
rows for later frames do not push the ones it needs out of the 64-row
ring.  Reading ``System.state`` applies every pending row, so it holds
every row pushed so far; assigning it (a restore) drops them.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import VISFSConfig, config_from_parameters
from ..core.camera import StereoCamera, make_stereo_camera
from ..core import prng
from ..core.lie import mat_to_quat, mat_to_xyzrpy, se3_matrix
from ..ops.image import clahe
from ..ops.lk import LKParams, lk_pad
from ..ops.pnp import PnPSettings
from ..solver import ba as ba_mod
from ..solver.ba import BASettings
from ..utils.timer import StageTimer
from . import extrapolator as extr
from .estimator import (EstimatorSettings, estimator_finalize,
                        estimator_prepare, marginalize)
from .mapping import snapshot_features
from .state import FrameOutput, VOState, init_laser_state, init_state
from .tracker import carried_pyramid, tracker_step


def build_cfg_hash(cfg: VISFSConfig) -> tuple:
    """Static tracker/system extras of the step."""
    return (cfg.tracker_max_features, cfg.tracker_quality_level,
            cfg.tracker_min_distance, cfg.tracker_flow_back,
            cfg.tracker_min_depth, cfg.tracker_max_depth, cfg.system_clahe,
            cfg.system_wheel_odometry_freq,
            cfg.tracker_cull_by_fundation_matrix,
            cfg.tracker_fundation_pixel_error)


def _build_settings(cfg: VISFSConfig) -> EstimatorSettings:
    return EstimatorSettings(
        sensor_strategy=cfg.system_sensor_strategy,
        min_inliers=cfg.estimator_min_inliers,
        pnp=PnPSettings(
            iterations=cfg.estimator_pnp_iterations,
            reproj_error=cfg.estimator_pnp_reproj_error,
            min_inliers=cfg.estimator_min_inliers,
            refine_iterations=cfg.estimator_refine_iterations,
            flags=cfg.estimator_pnp_flags,
        ),
        ba=BASettings(
            iterations=cfg.optimizer_iterations,
            pixel_variance=cfg.optimizer_pixel_variance,
            odometry_covariance=cfg.optimizer_odometry_covariance,
            robust_delta=cfg.optimizer_robust_kernel_delta,
            use_levenberg=(cfg.optimizer_trust_region == 0),
        ),
        tolerance_translation=cfg.estimator_tolerance_translation,
        force_3dof=cfg.estimator_force_3dof,
        map_size=cfg.local_map_map_size,
        max_features=cfg.tracker_max_features,
        min_parallax=cfg.local_map_min_parallax,
        min_translation=cfg.local_map_min_translation,
        min_laser_range=cfg.estimator_min_laser_range,
        max_laser_range=cfg.estimator_max_laser_range,
        missing_data_ray_length=cfg.estimator_missing_data_ray_length,
        laser_covariance=cfg.optimizer_laser_covariance,
        # the active submaps are owned by LocalMap and use its group
        # (LocalMap.cpp:44)
        num_range_data=cfg.local_map_num_range_data_limit,
        insert_free_space=cfg.local_map_insert_free_space,
        num_subdivisions=cfg.estimator_num_sub_division_pre_scan,
    )


def _check_supported(cfg: VISFSConfig):
    if cfg.system_sensor_strategy not in range(6):
        raise NotImplementedError(
            "SensorStrategy is 0 (stereo), 1 (RGBD), 2 (stereo and wheel) or "
            f"3-5 (with the laser), got {cfg.system_sensor_strategy}")


class TrackStage(NamedTuple):
    """The front-end stage's output: everything the back-end stages use."""

    trk: object  # tracker.TrackerOutput
    window: object  # WindowState after marginalization
    guess: torch.Tensor  # [4, 4] motion prior
    wheel_pose: torch.Tensor  # [4, 4]
    wheel_ok: torch.Tensor
    key: torch.Tensor  # the next carried rng key
    subkey: torch.Tensor  # the estimator's RANSAC key
    left: torch.Tensor  # post-CLAHE images (prev_* of the next frame)
    right: torch.Tensor


def track_stage(state: VOState, left, right, stamp, cam: StereoCamera,
                cfg_est: EstimatorSettings, lk_params: LKParams,
                cfg_hash: tuple) -> TrackStage:
    """Front end (the reference's Tracker thread, Tracker.cpp:167-419):
    CLAHE, the window slide, the motion prior, tracking."""
    (max_features, quality_level, min_distance, flow_back, min_depth,
     max_depth, use_clahe, wheel_freq, cull_fund, fund_thresh) = cfg_hash
    if use_clahe:
        # At SensorStrategy 1 `right` is the depth map and the reference
        # equalizes it too (visfs_tpu/slam/system.py:133-134); matched.
        left, right = clahe(left), clahe(right)

    # Slide the window (previous frame's keyframe decision), motion prior.
    features, window = marginalize(state.features, state.window,
                                   state.keyframe)
    prev_wheel6 = torch.cat([state.prev_wheel_t, torch.stack(mat_to_xyzrpy(
        se3_matrix(state.prev_wheel_q, state.prev_wheel_t))[3:])])
    guess, wheel_pose, wheel_ok, _, _ = extr.extrapolate_pose(
        state.odom, stamp, state.prev_stamp, state.velocity,
        state.velocity_valid, prev_wheel6, state.prev_wheel_valid,
        cfg_est.sensor_strategy, wheel_freq)
    key, subkey, trk_key = prng.split(state.rng_key, 3)

    h, w = state.prev_left.shape
    trk = tracker_step(
        features, state.prev_left, state.prev_right, left, right,
        state.has_prev, guess, state.blocked_uv, state.blocked_valid,
        state.next_fid, state.frame_count, cam,
        max_features=max_features, quality_level=quality_level,
        min_distance=min_distance, min_inliers=cfg_est.min_inliers,
        flow_back=flow_back, min_depth=min_depth, max_depth=max_depth,
        lk_params=lk_params, rgbd=cfg_est.sensor_strategy == 1,
        cull_fundamental=cull_fund, fundamental_threshold=fund_thresh,
        rng_key=trk_key,
        prev_pyr=carried_pyramid(state.prev_pyr, h, w, lk_params))
    return TrackStage(trk=trk, window=window, guess=guess,
                      wheel_pose=wheel_pose, wheel_ok=wheel_ok, key=key,
                      subkey=subkey, left=left, right=right)


def prepare_stage(state: VOState, ts: TrackStage, stamp, cam: StereoCamera,
                  cfg_est: EstimatorSettings, scan_points=None,
                  scan_mask=None, scan_times=None):
    """Back-end problem assembly (Estimator.cpp:166-252): (BA problem,
    estimator context)."""
    return estimator_prepare(
        state._replace(window=ts.window), ts.trk, stamp, ts.wheel_pose,
        ts.wheel_ok, ts.guess, cam, cfg_est, ts.subkey,
        scan_points=scan_points, scan_mask=scan_mask, scan_times=scan_times)


def ba_stage(problem, cfg_est: EstimatorSettings):
    """The local bundle adjustment."""
    return ba_mod.local_optimize(problem, cfg_est.ba)


def finalize_stage(state: VOState, ts: TrackStage, ctx, res_ba, stamp,
                   cam: StereoCamera, cfg_est: EstimatorSettings):
    """Post-BA fusion and state assembly (Estimator.cpp:275-449):
    (new VOState, FrameOutput)."""
    est = estimator_finalize(state, ctx, res_ba, stamp, cam, cfg_est)
    trk, wheel_pose, wheel_ok = ts.trk, ts.wheel_pose, ts.wheel_ok
    new_state = VOState(
        features=est.features, window=est.window, counters=est.counters,
        odom=state.odom, prev_left=ts.left, prev_right=ts.right,
        has_prev=torch.ones_like(state.has_prev),
        pose_q=est.pose_q, pose_t=est.pose_t,
        prev_wheel_q=torch.where(wheel_ok, mat_to_quat(wheel_pose[:3, :3]),
                                 state.prev_wheel_q),
        prev_wheel_t=torch.where(wheel_ok, wheel_pose[:3, 3],
                                 state.prev_wheel_t),
        prev_wheel_valid=wheel_ok | state.prev_wheel_valid,
        velocity=est.velocity6, velocity_valid=est.velocity_valid,
        prev_stamp=stamp, next_fid=trk.next_fid,
        frame_count=state.frame_count + 1, keyframe=est.keyframe,
        lost=est.lost, blocked_uv=est.blocked_uv,
        blocked_valid=est.blocked_valid, rng_key=ts.key, laser=est.laser,
        prev_pyr=trk.left_pyr,
    )
    out = FrameOutput(
        pose=se3_matrix(est.pose_q, est.pose_t), transform=est.transform,
        lost=est.lost, n_features=torch.sum(est.features.obs_mask[:, -1]),
        n_matches=est.n_matches, n_inliers=est.n_inliers, n_new=trk.n_new,
        keyframe=est.keyframe, ba_chi2=est.ba_chi2, ba_ok=est.ba_ok,
        velocity=est.velocity6, stamp=stamp, covariance=est.covariance,
    )
    return new_state, out


def vo_step(state: VOState, left, right, stamp, cam: StereoCamera,
            cfg_est: EstimatorSettings, lk_params: LKParams,
            cfg_hash: tuple, scan_points=None, scan_mask=None,
            scan_times=None):
    """The fused step: track -> prepare -> BA -> finalize; scan_points [K,
    3] laser-frame, scan_mask [K] and scan_times [K] at strategies >= 3.
    Returns (new VOState, FrameOutput)."""
    ts = track_stage(state, left, right, stamp, cam, cfg_est, lk_params,
                     cfg_hash)
    problem, ctx = prepare_stage(state, ts, stamp, cam, cfg_est, scan_points,
                                 scan_mask, scan_times)
    res_ba = ba_stage(problem, cfg_est)
    return finalize_stage(state, ts, ctx, res_ba, stamp, cam, cfg_est)


def _outputs_to_numpy(outs):
    """Fetch a list of device FrameOutputs with one transfer per field."""
    if not outs:
        return []
    fields = [torch.stack([getattr(o, f) for o in outs]).cpu().numpy()
              if isinstance(getattr(outs[0], f), torch.Tensor)
              else np.asarray([getattr(o, f) for o in outs], np.float32)
              for f in FrameOutput._fields]
    return [FrameOutput(*[a[i] for a in fields]) for i in range(len(outs))]


def _padded_odometry(rows: np.ndarray) -> np.ndarray:
    """Wheel rows [K, 14] padded with masked rows to a multiple of 16, so
    the batch's shape stays stable from frame to frame."""
    out = np.zeros((-(-len(rows) // 16) * 16, 14), np.float32)
    out[:len(rows)] = rows
    return out


class System:
    """Host-side engine owning the device state (reference System.h API).

    ``device`` "cuda" (the default) runs the step on the card through the
    CUDA kernels, "cpu" through their plain versions.  A CUDA device on a
    machine without CUDA raises; nothing falls back to the CPU.

    ``lk_params`` comes from the config with ``backend="pallas"`` (K1 per
    level); replace it before ``init`` to run another LK formulation, e.g.
    ``dataclasses.replace(s.lk_params, backend="jnp", iter_mode="xcorr")``
    for the correlation-form level with K2.
    """

    def __init__(self, parameters=None, *, device="cuda",
                 feature_capacity_factor: int = 3, seed: int = 0,
                 scan_capacity: int = 512, submap_extent_cells: int = 256,
                 profile_stages: bool = False):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("System: device 'cuda' requested but CUDA is "
                               "not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"System: unsupported device {self.device}")
        self.cfg: VISFSConfig = (
            parameters if isinstance(parameters, VISFSConfig)
            else config_from_parameters(parameters))
        _check_supported(self.cfg)
        self.settings = _build_settings(self.cfg)
        self.lk_params = LKParams.from_config(self.cfg)
        self._cfg_hash = build_cfg_hash(self.cfg)
        self._capacity_factor = feature_capacity_factor
        self._seed = seed
        self._scan_capacity = scan_capacity
        self._submap_extent = submap_extent_cells
        self.camera: Optional[StereoCamera] = None
        self._state: Optional[VOState] = None
        self._results = collections.deque()
        # held by the step and by every read or write of ``state``
        self._state_lock = threading.Lock()
        # host wheel rows [K, 14] not yet in the state, in push order
        self._pending_odom = []
        self._pending_lock = threading.Lock()
        # profile_stages: the four stages with a device synchronisation
        # after each, FrameOutput's time_* fields from the host clock (a
        # diagnostic; the fused step waits for nothing and leaves them 0).
        self.profile_stages = profile_stages

    @property
    def state(self) -> Optional[VOState]:
        """The device state, with every wheel row pushed so far applied."""
        with self._state_lock:
            self._apply_pending_odometry()
            return self._state

    @state.setter
    def state(self, value: Optional[VOState]):
        with self._state_lock:
            with self._pending_lock:
                self._pending_odom = []
            self._state = value

    def _apply_pending_odometry(self, upto: Optional[np.float32] = None):
        """Push the pending wheel rows stamped at or before ``upto`` (every
        one with None) into the state in one batch, in push order; the
        later ones stay pending, ahead of the rows pushed meanwhile.  The
        caller holds the state lock."""
        with self._pending_lock:
            pending, self._pending_odom = self._pending_odom, []
        if not pending:
            return
        rows = np.concatenate(pending)
        if upto is not None:
            now = rows[:, 0] <= upto
            if not now.all():
                with self._pending_lock:
                    self._pending_odom.insert(0, rows[~now])
                rows = rows[now]
        if len(rows):
            self._state = self._state._replace(odom=extr.add_odometry_batch(
                self._state.odom, self._to_device(_padded_odometry(rows))))

    def init(self, fx, fy, cx, cy, baseline, *, width, height, fxr=None,
             fyr=None, cxr=None, cyr=None, transform_camera_to_robot=None,
             transform_laser_to_robot=None):
        """Camera intrinsics/extrinsics, the laser extrinsic (strategies >=
        3) and a fresh state (System.cpp:83-99)."""
        self.camera = make_stereo_camera(
            fx, fy, cx, cy, baseline, fxr=fxr, fyr=fyr, cxr=cxr, cyr=cyr,
            t_camera_to_robot=transform_camera_to_robot, width=width,
            height=height, device=self.device)
        laser = None
        if self.cfg.system_sensor_strategy >= 3:
            # The raycast sample budget covers the longest ray: a ray of
            # range R crosses at most ~2R/resolution cells, and nothing
            # beyond the submap extent lands in the grid.
            res = self.cfg.local_map_map_resolution
            need = int(2.0 * max(self.cfg.estimator_max_laser_range,
                                 self.cfg.estimator_missing_data_ray_length)
                       / max(res, 1e-6)) + 8
            self.settings = dataclasses.replace(
                self.settings,
                raycast_samples=min(need, 2 * self._submap_extent + 8))
            laser = init_laser_state(
                resolution=res, extent_cells=self._submap_extent,
                hit_probability=self.cfg.local_map_hit_probability,
                miss_probability=self.cfg.local_map_miss_probability,
                t_laser_robot=transform_laser_to_robot, device=self.device)
        self.state = init_state(
            height, width,
            capacity=int(self._capacity_factor
                         * self.cfg.tracker_max_features),
            window=self.cfg.local_map_map_size + 1, device=self.device,
            seed=self._seed, laser=laser, lk_pad=lk_pad(self.lk_params),
            lk_max_level=self.lk_params.max_level)
        self._results.clear()

    def _as_image(self, img):
        """A tensor as it is (on the System's device); a host array through
        pinned memory without waiting for the device."""
        if isinstance(img, torch.Tensor):
            return torch.as_tensor(img, dtype=torch.float32,
                                   device=self.device).contiguous()
        return self._to_device(np.ascontiguousarray(img, np.float32))

    def _to_device(self, a: np.ndarray):
        """A host array on the device: pinned and copied without waiting
        (the caching host allocator reuses a pinned block only after its
        copy has finished)."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _scan_inputs(self, scan, scan_times):
        """The scan padded and masked to scan_capacity on the host, on the
        device: (points [K, 3], mask [K], times [K]).  Without times the
        de-skew degenerates to the identity."""
        K = self._scan_capacity
        buf = np.zeros((K, 5), np.float32)  # x, y, z, mask, time
        if scan is not None:
            pts = np.asarray(scan, np.float32)[:K]
            buf[:len(pts), :3] = pts
            buf[:len(pts), 3] = 1.0
            if scan_times is not None:
                st = np.asarray(scan_times, np.float32)[:K]
                buf[:len(st), 4] = st
        dev = self._to_device(buf)
        return dev[:, :3], dev[:, 3] > 0.5, dev[:, 4]

    def input_primary_sensor_data(self, stamp: float, left, right,
                                  scan=None, scan_times=None):
        """Feed one stereo frame, at SensorStrategy 1 the image and its
        depth map in metres as ``right`` (+ at strategies >= 3 an optional
        [K, 3] laser-frame scan and [K] per-point time offsets for the
        de-skew, <= 0 with the newest point at 0); the result is queued on
        the device."""
        if self._state is None:
            raise RuntimeError("call init() first")
        stamp_t = torch.full((), float(stamp), dtype=torch.float32,
                             device=self.device)
        scan_args = {}
        if self.cfg.system_sensor_strategy >= 3:
            pts, msk, tms = self._scan_inputs(scan, scan_times)
            scan_args = dict(scan_points=pts, scan_mask=msk, scan_times=tms)
        args = (self._as_image(left), self._as_image(right), stamp_t)
        with self._state_lock:
            self._apply_pending_odometry(upto=np.float32(stamp))
            if self.profile_stages:
                out = self._step_profiled(*args, **scan_args)
            else:
                self._state, out = vo_step(self._state, *args, self.camera,
                                           self.settings, self.lk_params,
                                           self._cfg_hash, **scan_args)
            self._results.append(out)

    def _step_profiled(self, left, right, stamp, scan_points=None,
                       scan_mask=None, scan_times=None):
        """The step's four stages, each waited for, with their host wall
        times (s) in the output's time_* fields.  ``stamp`` lies on the
        System's device, so waiting for it waits for all the device's
        work."""
        cam, cfg = self.camera, self.settings
        timer = StageTimer()
        timer.elapsed(sync=stamp)  # the earlier frames' work is not timed
        ts = track_stage(self._state, left, right, stamp, cam, cfg,
                         self.lk_params, self._cfg_hash)
        t_track = timer.elapsed(sync=stamp)
        problem, ctx = prepare_stage(self._state, ts, stamp, cam, cfg,
                                     scan_points, scan_mask, scan_times)
        t_prepare = timer.elapsed(sync=stamp)
        res_ba = ba_stage(problem, cfg)
        t_ba = timer.elapsed(sync=stamp)
        self._state, out = finalize_stage(self._state, ts, ctx, res_ba,
                                          stamp, cam, cfg)
        t_estimation = t_prepare + t_ba + timer.elapsed(sync=stamp)
        return out._replace(time_tracking=np.float32(t_track),
                            time_estimation=np.float32(t_estimation),
                            local_bundle_time=np.float32(t_ba),
                            time_total=np.float32(t_track + t_estimation))

    def input_wheel_odometry(self, stamp: float, pose6, velocity6=None):
        """One wheel-odometry sample (x, y, z, roll, pitch, yaw) at stamp."""
        self.input_wheel_odometry_batch(
            [stamp], np.reshape(pose6, (1, 6)),
            None if velocity6 is None else np.reshape(velocity6, (1, 6)))

    def input_wheel_odometry_batch(self, stamps, pose6, velocity6=None):
        """Push K samples ([K], [K, 6], optional [K, 6]), equivalent to K
        input_wheel_odometry calls in order.  It waits for no step: the rows
        reach the state, in one copy and a few device ops, at the first
        step of a frame stamped at or after them or at a read of
        ``state``."""
        if self._state is None:
            raise RuntimeError("call init() first")
        stamps = np.asarray(stamps, np.float32).reshape(-1)
        K = len(stamps)
        if K == 0:
            return
        rows = np.zeros((K, 14), np.float32)
        rows[:, 0] = stamps
        rows[:, 1:7] = np.asarray(pose6, np.float32).reshape(K, 6)
        if velocity6 is not None:
            rows[:, 7:13] = np.asarray(velocity6, np.float32).reshape(K, 6)
        rows[:, 13] = 1.0
        with self._pending_lock:
            self._pending_odom.append(rows)

    def output_odometry_info(self):
        """Pop the oldest finished frame result (numpy fields), or None."""
        if self._results:
            return _outputs_to_numpy([self._results.popleft()])[0]
        return None

    def keyframe_snapshot(self, max_kp: int = 64, patch_size: int = 8,
                          scales: tuple = (1, 3, 6)):
        """Appearance snapshot of the latest processed frame's features for
        loop verification (slam/mapping.py ``verify_loop``), on the
        System's device."""
        state = self.state
        if state is None:
            raise RuntimeError("call init() first")
        return snapshot_features(state.features, state.prev_left,
                                 self.camera, max_kp=max_kp,
                                 patch_size=patch_size, scales=scales)

    def drain_outputs(self):
        """Fetch every queued frame result (popped one by one, so a result
        the worker appends meanwhile is kept for the next call)."""
        outs = []
        while self._results:
            outs.append(self._results.popleft())
        return _outputs_to_numpy(outs)

    def run_sequence(self, stamps, lefts, rights, wheel_odom=None,
                     scans=None, scan_times=None):
        """Feed a whole sequence; return every frame's output.

        wheel_odom: optional [K, 8] rows (stamp, x, y, z, roll, pitch, yaw,
        valid); the rows up to each frame's stamp go in before it, as the
        ROS callbacks would interleave them.  scans / scan_times: optional
        per-frame [K_i, 3] laser-frame points and [K_i] time offsets."""
        odom_i = 0
        for i in range(len(stamps)):
            if wheel_odom is not None:
                j = odom_i
                while (j < len(wheel_odom)
                       and wheel_odom[j][0] <= stamps[i] + 1e-9):
                    j += 1
                if j > odom_i:
                    rows = np.asarray(wheel_odom[odom_i:j])
                    self.input_wheel_odometry_batch(rows[:, 0], rows[:, 1:7])
                    odom_i = j
            self.input_primary_sensor_data(
                float(stamps[i]), lefts[i], rights[i],
                scan=None if scans is None else scans[i],
                scan_times=None if scan_times is None else scan_times[i])
        return self.drain_outputs()
