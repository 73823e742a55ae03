"""System: the top-level engine — one fused step per frame (torch port of
visfs_tpu.slam.system, SensorStrategy 0).

``vo_step`` runs track -> prepare -> BA -> finalize on the device given to
``System``.  The step keeps the reference's shape discipline: fixed shapes,
no ``.item()``, no boolean-mask indexing and no Python branch on tensor
data, so it never waits for the device and can later be captured in a CUDA
graph.  Results stay on the device until ``output_odometry_info`` or
``drain_outputs`` fetches them.

Host API (reference System.h:30-53): ``init``, ``input_primary_sensor_data``,
``output_odometry_info``, ``drain_outputs``, ``run_sequence``.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from visfs_tpu.config import VISFSConfig, config_from_parameters

from ..core.camera import StereoCamera, make_stereo_camera
from ..core import prng
from ..core.lie import mat_to_quat, mat_to_xyzrpy, se3_matrix
from ..ops.lk import LKParams, lk_pad
from ..ops.pnp import PnPSettings
from ..solver import ba as ba_mod
from ..solver.ba import BASettings
from . import extrapolator as extr
from .estimator import (EstimatorSettings, estimator_finalize,
                        estimator_prepare, marginalize)
from .state import FrameOutput, VOState, init_state
from .tracker import carried_pyramid, tracker_step


def build_cfg_hash(cfg: VISFSConfig) -> tuple:
    """Static tracker/system extras of the step."""
    return (cfg.tracker_max_features, cfg.tracker_quality_level,
            cfg.tracker_min_distance, cfg.tracker_flow_back,
            cfg.tracker_min_depth, cfg.tracker_max_depth,
            cfg.system_wheel_odometry_freq)


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
    )


def _check_supported(cfg: VISFSConfig):
    if cfg.system_sensor_strategy != 0:
        raise NotImplementedError(
            "visfs_tpu_torch ports SensorStrategy 0 (stereo) only, got "
            f"{cfg.system_sensor_strategy}")
    if cfg.system_clahe:
        raise NotImplementedError("System/CLAHE is not ported")
    if cfg.tracker_cull_by_fundation_matrix:
        raise NotImplementedError(
            "Tracker/CullByFundationMatrix is not ported")


def vo_step(state: VOState, left, right, stamp, cam: StereoCamera,
            cfg_est: EstimatorSettings, lk_params: LKParams,
            cfg_hash: tuple):
    """The fused step: track -> prepare -> BA -> finalize.
    Returns (new VOState, FrameOutput)."""
    (max_features, quality_level, min_distance, flow_back, min_depth,
     max_depth, wheel_freq) = cfg_hash

    # Slide the window (previous frame's keyframe decision), motion prior.
    features, window = marginalize(state.features, state.window,
                                   state.keyframe)
    prev_wheel6 = torch.cat([state.prev_wheel_t, torch.stack(mat_to_xyzrpy(
        se3_matrix(state.prev_wheel_q, state.prev_wheel_t))[3:])])
    guess, wheel_pose, wheel_ok, _, _ = extr.extrapolate_pose(
        state.odom, stamp, state.prev_stamp, state.velocity,
        state.velocity_valid, prev_wheel6, state.prev_wheel_valid,
        cfg_est.sensor_strategy, wheel_freq)
    keys = prng.split(state.rng_key, 3)
    key, subkey = keys[0], keys[1]

    h, w = state.prev_left.shape
    trk = tracker_step(
        features, state.prev_left, state.prev_right, left, right,
        state.has_prev, guess, state.blocked_uv, state.blocked_valid,
        state.next_fid, state.frame_count, cam,
        max_features=max_features, quality_level=quality_level,
        min_distance=min_distance, min_inliers=cfg_est.min_inliers,
        flow_back=flow_back, min_depth=min_depth, max_depth=max_depth,
        lk_params=lk_params,
        prev_pyr=carried_pyramid(state.prev_pyr, h, w, lk_params),
    )
    problem, ctx = estimator_prepare(
        state._replace(window=window), trk, stamp, wheel_pose, wheel_ok,
        guess, cam, cfg_est, subkey)
    res_ba = ba_mod.local_optimize(problem, cfg_est.ba)
    est = estimator_finalize(state, ctx, res_ba, stamp, cam, cfg_est)

    new_state = VOState(
        features=est.features, window=est.window, counters=est.counters,
        odom=state.odom, prev_left=left, prev_right=right,
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
        blocked_valid=est.blocked_valid, rng_key=key, laser=None,
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


def _outputs_to_numpy(outs):
    """Fetch a list of device FrameOutputs with one transfer per field."""
    if not outs:
        return []
    fields = [torch.stack([getattr(o, f) for o in outs]).cpu().numpy()
              for f in FrameOutput._fields]
    return [FrameOutput(*[a[i] for a in fields]) for i in range(len(outs))]


class System:
    """Host-side engine owning the device state (reference System.h API).

    ``device`` is required: "cuda" runs the step on the card through the
    CUDA kernels, "cpu" through their plain versions.  A CUDA device on a
    machine without CUDA raises; nothing falls back to the CPU.
    """

    def __init__(self, parameters=None, *, device,
                 feature_capacity_factor: int = 3, seed: int = 0,
                 profile_stages: bool = False):
        if profile_stages:
            raise NotImplementedError("profile_stages is not ported")
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
        self.camera: Optional[StereoCamera] = None
        self.state: Optional[VOState] = None
        self._results = collections.deque()

    def init(self, fx, fy, cx, cy, baseline, *, width, height, fxr=None,
             fyr=None, cxr=None, cyr=None, transform_camera_to_robot=None):
        """Camera intrinsics/extrinsics and a fresh state
        (System.cpp:83-99)."""
        self.camera = make_stereo_camera(
            fx, fy, cx, cy, baseline, fxr=fxr, fyr=fyr, cxr=cxr, cyr=cyr,
            t_camera_to_robot=transform_camera_to_robot, width=width,
            height=height, device=self.device)
        self.state = init_state(
            height, width,
            capacity=int(self._capacity_factor
                         * self.cfg.tracker_max_features),
            window=self.cfg.local_map_map_size + 1, device=self.device,
            seed=self._seed, lk_pad=lk_pad(self.lk_params),
            lk_max_level=self.lk_params.max_level)
        self._results.clear()

    def _as_image(self, img):
        return torch.as_tensor(img, dtype=torch.float32,
                               device=self.device).contiguous()

    def input_primary_sensor_data(self, stamp: float, left, right):
        """Feed one stereo frame; the result is queued on the device."""
        if self.state is None:
            raise RuntimeError("call init() first")
        stamp_t = torch.full((), float(stamp), dtype=torch.float32,
                             device=self.device)
        self.state, out = vo_step(
            self.state, self._as_image(left), self._as_image(right), stamp_t,
            self.camera, self.settings, self.lk_params, self._cfg_hash)
        self._results.append(out)

    def output_odometry_info(self):
        """Pop the oldest finished frame result (numpy fields), or None."""
        if self._results:
            return _outputs_to_numpy([self._results.popleft()])[0]
        return None

    def drain_outputs(self):
        """Fetch every queued frame result."""
        outs = list(self._results)
        self._results.clear()
        return _outputs_to_numpy(outs)

    def run_sequence(self, stamps, lefts, rights):
        """Feed a whole sequence; return every frame's output."""
        for i in range(len(stamps)):
            self.input_primary_sensor_data(float(stamps[i]), lefts[i],
                                           rights[i])
        return self.drain_outputs()
