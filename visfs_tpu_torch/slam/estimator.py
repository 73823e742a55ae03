"""Back-end estimator stage (torch port of visfs_tpu.slam.estimator, for
SensorStrategy 0; the laser blocks are not ported).

Initial transform from PnP RANSAC (or the wheel delta, strategy >= 2),
window insertion and the keyframe decision, BA problem assembly, the
post-BA inlier re-gate, the wheel-tolerance override, Force3DoF, LocalMap
write-back with outlier-edge removal and error-vertex blocking, and the
velocity guess.  ``marginalize`` slides the window at the start of the
next step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..core.camera import StereoCamera
from ..core.lie import (flatten_3dof, mat_apply, mat_inv_se3, mat_to_quat,
                        mat_to_xyzrpy, se3_matrix)
from ..ops import pnp
from ..solver import ba
from ..solver.factors import StereoIntrinsics
from .state import I32, FeatureTable, KeyframeCounters, VOState, WindowState
from .tracker import TrackerOutput

_BAD_COVARIANCE = 9999.0


@dataclasses.dataclass(frozen=True)
class EstimatorSettings:
    sensor_strategy: int = 0
    min_inliers: int = 12
    pnp: pnp.PnPSettings = pnp.PnPSettings()
    ba: ba.BASettings = ba.BASettings()
    tolerance_translation: float = 0.32
    force_3dof: bool = False
    map_size: int = 5  # LocalMap/MapSize (window = map_size + 1)
    max_features: int = 300
    min_parallax: float = 60.0
    min_translation: float = 0.5


class EstimatorContext(NamedTuple):
    """What estimator_prepare computes for estimator_finalize."""

    features: FeatureTable
    window: WindowState
    counters: KeyframeCounters
    keyframe: torch.Tensor
    transform: torch.Tensor  # [4,4] pre-BA initial transform
    transform_ok: torch.Tensor
    inlier_mask: torch.Tensor
    run_ba: torch.Tensor
    map_available: torch.Tensor
    lm_ba: torch.Tensor
    bootstrap: torch.Tensor
    sig_pose: torch.Tensor
    pose_mat: torch.Tensor
    prev_wheel_mat: torch.Tensor
    wheel_pose_eff: torch.Tensor
    wheel_valid_eff: torch.Tensor
    n_matches: torch.Tensor


class EstimatorResult(NamedTuple):
    features: FeatureTable
    window: WindowState
    counters: KeyframeCounters
    pose_q: torch.Tensor
    pose_t: torch.Tensor
    transform: torch.Tensor  # [4,4] accepted frame delta
    keyframe: torch.Tensor
    lost: torch.Tensor
    velocity6: torch.Tensor
    velocity_valid: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    ba_chi2: torch.Tensor
    ba_ok: torch.Tensor
    blocked_uv: torch.Tensor
    blocked_valid: torch.Tensor
    covariance: torch.Tensor


def keyframe_update(c: KeyframeCounters, n_new, transform, transform_ok,
                    parallax_mean, max_features: int, min_translation: float,
                    min_parallax: float):
    """Keyframe decision + counter update (LocalMap.cpp:95-126); the
    translation test compares the SQUARED accumulated norm with
    MinTranslation, as the reference does."""
    new_feature_count = c.new_feature_count + n_new.to(I32)
    signature_count = c.signature_count + 1
    t_abs = torch.abs(transform[:3, 3])
    translation_count = c.translation_count + torch.where(
        transform_ok, t_abs, torch.zeros_like(t_abs))
    parallax_count = c.parallax_count + parallax_mean
    keyframe = ((new_feature_count > 0.2 * max_features)
                | ((signature_count > 10) & (torch.sum(
                    translation_count * translation_count) > min_translation))
                | (parallax_count >= min_parallax))
    counters = KeyframeCounters(
        new_feature_count=torch.where(
            keyframe, torch.zeros_like(new_feature_count), new_feature_count),
        signature_count=torch.where(
            keyframe, torch.zeros_like(signature_count), signature_count),
        parallax_count=torch.where(keyframe, torch.zeros_like(parallax_count),
                              parallax_count),
        translation_count=torch.where(keyframe,
                                 torch.zeros_like(translation_count),
                                 translation_count),
    )
    return keyframe, counters


def _twr_to_tcw(pose_q, pose_t, t_ri):
    """Window poses Twr -> inverse camera poses Tcw."""
    Tcw = mat_inv_se3(se3_matrix(pose_q, pose_t) @ t_ri)
    return mat_to_quat(Tcw[..., :3, :3]), Tcw[..., :3, 3]


def _tcw_to_twr(q, t, t_ir):
    """Inverse camera poses back to robot poses."""
    return mat_inv_se3(se3_matrix(q, t)) @ t_ir


def _set_row(a, i: int, value):
    a = a.clone()
    a[i] = value
    return a


def estimator_prepare(state: VOState, trk: TrackerOutput, stamp, wheel_pose,
                      wheel_valid, guess_delta, cam: StereoCamera,
                      cfg: EstimatorSettings, rng_key
                      ) -> Tuple[ba.BAProblem, EstimatorContext]:
    W = trk.features.window
    cur, prev = W - 1, W - 2
    features = trk.features
    window = state.window
    dtype = state.pose_t.dtype
    dev = state.pose_t.device
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    zero4 = torch.zeros((4, 4), dtype=dtype, device=dev)
    frame_id = state.frame_count
    wheel_strategy = cfg.sensor_strategy >= 2

    pose_mat = se3_matrix(state.pose_q, state.pose_t)
    prev_wheel_mat = se3_matrix(state.prev_wheel_q, state.prev_wheel_t)

    # 1. Initial transform (Estimator.cpp:176-200).
    finite_prev = torch.all(torch.isfinite(trk.prev_p_robot), dim=-1)
    match_mask = trk.temporal_mask & finite_prev
    n_matches = torch.sum(match_mask)
    prev_p_robot = torch.where(finite_prev[:, None], trk.prev_p_robot,
                               torch.zeros_like(trk.prev_p_robot))

    use_wheel = wheel_valid & wheel_strategy
    wheel_delta = torch.where(state.prev_wheel_valid,
                         mat_inv_se3(prev_wheel_mat) @ wheel_pose, eye4)

    guess_cam = mat_inv_se3(guess_delta @ cam.t_ri)
    res_pnp = pnp.solve_pnp_ransac(
        prev_p_robot, trk.temporal_uv, match_mask,
        mat_to_quat(guess_cam[:3, :3]), guess_cam[:3, 3],
        cam.fx, cam.fy, cam.cx, cam.cy, rng_key, cfg.pnp)
    pnp_transform = mat_inv_se3(cam.t_ri @ se3_matrix(res_pnp.q, res_pnp.t))
    pnp_valid = res_pnp.ok & (n_matches >= cfg.min_inliers)

    transform = torch.where(use_wheel, wheel_delta,
                       torch.where(pnp_valid, pnp_transform, zero4))
    inlier_mask = torch.where(use_wheel, match_mask,
                              res_pnp.inliers & match_mask)
    transform_ok = use_wheel | pnp_valid

    bootstrap = ~torch.any(state.window.valid)
    sig_pose = torch.where(transform_ok, pose_mat @ transform, pose_mat)
    wheel_pose_eff = torch.where(
        wheel_valid, wheel_pose,
        torch.where(transform_ok & wheel_strategy, prev_wheel_mat @ transform,
               zero4))
    wheel_valid_eff = wheel_valid | (transform_ok & wheel_strategy
                                     & state.prev_wheel_valid)

    # 2. Window insertion + keyframe decision (LocalMap::insertSignature).
    inserted = transform_ok | bootstrap
    window = WindowState(
        frame_id=_set_row(window.frame_id, cur,
                          torch.where(inserted, frame_id,
                                 torch.full_like(frame_id, -1))),
        valid=_set_row(window.valid, cur, inserted),
        pose_q=_set_row(window.pose_q, cur, mat_to_quat(sig_pose[:3, :3])),
        pose_t=_set_row(window.pose_t, cur, sig_pose[:3, 3]),
        wheel_q=_set_row(window.wheel_q, cur,
                         mat_to_quat(wheel_pose_eff[:3, :3])),
        wheel_t=_set_row(window.wheel_t, cur, wheel_pose_eff[:3, 3]),
        wheel_valid=_set_row(window.wheel_valid, cur, wheel_valid_eff),
        stamp=_set_row(window.stamp, cur, stamp),
    )

    # New features: stored robot-frame points -> world (LocalMap.cpp:76).
    is_new = features.valid & (features.start_frame == frame_id)
    features = features._replace(pw=torch.where(
        is_new[:, None], mat_apply(sig_pose, features.pw), features.pw))
    obs_count = torch.sum(features.obs_mask, dim=1)
    features = features._replace(
        stable=features.stable | (features.valid & (obs_count > cfg.map_size)))

    prev_uv = features.uv[:, prev]
    dpix = torch.linalg.vector_norm(trk.temporal_uv - prev_uv, dim=-1)
    n_par = torch.clamp(torch.sum(trk.temporal_mask), min=1)
    parallax_mean = torch.sum(torch.where(trk.temporal_mask, dpix,
                                          torch.zeros_like(dpix))) / n_par
    keyframe, counters = keyframe_update(
        state.counters, trk.n_new, transform, transform_ok, parallax_mean,
        cfg.max_features, cfg.min_translation, cfg.min_parallax)

    # 3. Local BA problem (Estimator.cpp:215-315).
    map_available = (torch.sum(window.valid) >= 2) & (
        torch.sum(features.valid) >= cfg.min_inliers)
    run_ba = transform_ok & (torch.sum(inlier_mask) > cfg.min_inliers) \
        & map_available

    tcw_q, tcw_t = _twr_to_tcw(window.pose_q, window.pose_t, cam.t_ri)
    w_mat = se3_matrix(window.wheel_q, window.wheel_t)
    link_mat = cam.t_ir @ (mat_inv_se3(w_mat[:-1]) @ w_mat[1:]) @ cam.t_ri
    link_mask = (window.wheel_valid[:-1] & window.wheel_valid[1:]
                 & window.valid[:-1] & window.valid[1:] & wheel_strategy)

    lm_ba = features.valid & (obs_count >= 2)
    bf = cam.bf
    depth = features.depth
    disparity = torch.where(depth > 1e-6, bf / torch.clamp(depth, min=1e-6),
                            torch.zeros_like(depth))
    obs3 = torch.stack([features.uv[..., 0], features.uv[..., 1],
                        features.uv[..., 0] - disparity], dim=-1)
    pose_fixed = ~window.valid | (torch.arange(W, device=dev) == W - 2)
    problem = ba.BAProblem(
        pose_q=tcw_q, pose_t=tcw_t, pose_valid=window.valid,
        pose_fixed=pose_fixed, lm_pos=features.pw, lm_valid=lm_ba,
        lm_fixed=features.stable, obs=obs3,
        obs_mask=features.obs_mask & lm_ba[:, None],
        link_q=mat_to_quat(link_mat[..., :3, :3]), link_t=link_mat[..., :3, 3],
        link_mask=link_mask,
        intr=StereoIntrinsics(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                              bf=bf),
    )
    ctx = EstimatorContext(
        features=features, window=window, counters=counters,
        keyframe=keyframe, transform=transform, transform_ok=transform_ok,
        inlier_mask=inlier_mask, run_ba=run_ba, map_available=map_available,
        lm_ba=lm_ba, bootstrap=bootstrap, sig_pose=sig_pose,
        pose_mat=pose_mat, prev_wheel_mat=prev_wheel_mat,
        wheel_pose_eff=wheel_pose_eff, wheel_valid_eff=wheel_valid_eff,
        n_matches=n_matches,
    )
    return problem, ctx


def estimator_finalize(state: VOState, ctx: EstimatorContext,
                       res_ba: ba.BAResult, stamp, cam: StereoCamera,
                       cfg: EstimatorSettings) -> EstimatorResult:
    features = ctx.features
    window = ctx.window
    W = window.valid.shape[0]
    cur, prev = W - 1, W - 2
    dtype = state.pose_t.dtype
    dev = state.pose_t.device
    zero4 = torch.zeros((4, 4), dtype=dtype, device=dev)
    pose_mat = ctx.pose_mat
    transform = ctx.transform
    transform_ok = ctx.transform_ok
    run_ba = ctx.run_ba
    ba_ok = res_ba.ok & run_ba

    # Post-BA: drop features with outlier edges (Estimator.cpp:277-289).
    feat_outlier = torch.any(res_ba.outliers, dim=1) & run_ba
    inlier_mask = ctx.inlier_mask & ~feat_outlier
    n_inliers = torch.sum(inlier_mask)
    enough = n_inliers >= cfg.min_inliers
    use_ba = ba_ok & enough

    opt_twr = _tcw_to_twr(res_ba.pose_q, res_ba.pose_t, cam.t_ir)
    current_global = torch.where(use_ba, opt_twr[cur], pose_mat @ transform)
    transform = torch.where(use_ba, mat_inv_se3(opt_twr[prev]) @ opt_twr[cur],
                       torch.where(ba_ok & ~enough, zero4, transform))
    transform_ok = transform_ok & ~(ba_ok & ~enough)

    # 4. Wheel tolerance override (Estimator.cpp:325-366).
    if cfg.sensor_strategy >= 2:
        wheel_branch = (ctx.wheel_valid_eff & state.prev_wheel_valid
                        & ctx.map_available)
        d_wheel = mat_inv_se3(ctx.prev_wheel_mat) @ ctx.wheel_pose_eff
        wx, wy = d_wheel[0, 3], d_wheel[1, 3]
        dx, dy = wx - transform[0, 3], wy - transform[1, 3]
        denom = wx * wx + wy * wy
        wheel_moving = torch.abs(denom) > 1e-12
        exceed = (dx * dx + dy * dy) / torch.where(
            wheel_moving, denom, torch.ones_like(denom)) \
            > cfg.tolerance_translation
        override = wheel_branch & ((wheel_moving & exceed) | ~wheel_moving)
        transform = torch.where(override, d_wheel, transform)
        current_global = torch.where(override, pose_mat @ d_wheel,
                                     current_global)
        transform_ok = transform_ok | override

    # 5. Force3DoF (Estimator.cpp:368-375).
    if cfg.force_3dof:
        current_global = flatten_3dof(current_global)
        transform = flatten_3dof(transform)

    # 6. LocalMap write-back (updateLocalMap).
    do_update = ba_ok & torch.all(window.valid) & transform_ok
    new_q = mat_to_quat(current_global[:3, :3])
    new_t = current_global[:3, 3]
    opt_q = _set_row(mat_to_quat(opt_twr[..., :3, :3]), cur, new_q)
    opt_t = _set_row(opt_twr[..., :3, 3], cur, new_t)
    pose_q = torch.where(do_update, opt_q, window.pose_q)
    pose_t = torch.where(do_update, opt_t, window.pose_t)
    window = window._replace(
        pose_q=_set_row(pose_q, cur, torch.where(transform_ok, new_q,
                                            window.pose_q[cur])),
        pose_t=_set_row(pose_t, cur, torch.where(transform_ok, new_t,
                                            window.pose_t[cur])),
    )
    lm_update = do_update & ctx.lm_ba & ~features.stable
    features = features._replace(pw=torch.where(lm_update[:, None],
                                                res_ba.lm_pos, features.pw))

    # Outlier-edge removal + error-vertex blocking (LocalMap.cpp:191-226).
    rm_obs = res_ba.outliers & do_update
    obs_mask2 = features.obs_mask & ~rm_obs
    obs_count2 = torch.sum(obs_mask2, dim=1)
    if W >= 3:
        third_newest_id = window.frame_id[W - 3]
    else:
        third_newest_id = torch.full((), -1, dtype=I32, device=dev)
    error_feature = (features.valid & (obs_count2 == 0) & ~features.stable
                     & (features.start_frame < third_newest_id)
                     & torch.any(rm_obs, dim=1))
    # Blocked words sit at their LAST observed position.
    last_col = (W - 1) - torch.argmax(
        torch.flip(features.obs_mask, dims=[1]).to(torch.uint8), dim=1)
    last_col = torch.where(torch.any(features.obs_mask, dim=1), last_col,
                           torch.zeros_like(last_col))
    last_uv = torch.take_along_dim(
        features.uv, last_col[:, None, None].expand(-1, 1, 2), dim=1)[:, 0]
    B = state.blocked_uv.shape[0]
    blk_score = torch.where(error_feature, 1.0, float("-inf"))
    k = min(B, blk_score.shape[0])
    blk_idx = torch.sort(blk_score, descending=True, stable=True)[1][:k]
    blocked_valid = error_feature[blk_idx]
    blocked_uv = last_uv[blk_idx]
    if k < B:
        blocked_valid = torch.cat([blocked_valid,
                                   blocked_valid.new_zeros(B - k)])
        blocked_uv = torch.cat([blocked_uv, blocked_uv.new_zeros((B - k, 2))])
    features = features._replace(
        obs_mask=obs_mask2, valid=features.valid & ~error_feature,
        track_cnt=torch.where(error_feature, torch.zeros_like(
            features.track_cnt), features.track_cnt))

    # 7. Outputs + carried scalars (Estimator.cpp:397-447).
    lost = ~transform_ok
    dt = stamp - state.prev_stamp
    vel6 = torch.stack(mat_to_xyzrpy(transform)) / torch.clamp(dt, min=1e-6)
    velocity6 = torch.where(lost, torch.zeros_like(vel6), vel6)
    covariance = torch.eye(6, dtype=dtype, device=dev) * torch.where(
        lost, _BAD_COVARIANCE, 1.0)
    return EstimatorResult(
        features=features, window=window, counters=ctx.counters,
        pose_q=torch.where(lost, state.pose_q, new_q),
        pose_t=torch.where(lost, state.pose_t, new_t),
        transform=torch.where(transform_ok, transform, zero4),
        keyframe=ctx.keyframe, lost=lost, velocity6=velocity6,
        velocity_valid=~lost & (dt > 0), n_matches=ctx.n_matches,
        n_inliers=n_inliers, ba_chi2=res_ba.chi2, ba_ok=ba_ok,
        blocked_uv=blocked_uv, blocked_valid=blocked_valid,
        covariance=covariance,
    )


def marginalize(features: FeatureTable, window: WindowState, keyframe
                ) -> Tuple[FeatureTable, WindowState]:
    """Slide the window before a new frame (LocalMap::removeSignature): a
    full window drops the oldest slot on a keyframe, else the second
    newest; a non-full window shifts left.  Slot W-1 comes out empty."""
    W = window.valid.shape[0]
    dev = window.valid.device
    full = torch.all(window.valid)
    shift = torch.arange(1, W + 1, device=dev) % W
    ar = torch.arange(W, device=dev)
    drop2 = torch.where(ar == W - 2, W - 1, torch.where(ar == W - 1, 0, ar))
    perm = torch.where(full & ~keyframe, drop2, shift)[:W - 1]
    unit_q = torch.eye(4, dtype=window.pose_q.dtype, device=dev)[:1]

    def g(x, fill=None):
        """Slots perm, then an empty slot W-1 (zeros, or ``fill``)."""
        last = torch.zeros_like(x[:1]) if fill is None else fill
        return torch.cat([torch.index_select(x, 0, perm), last])

    window2 = WindowState(
        frame_id=g(window.frame_id, torch.full_like(window.frame_id[:1], -1)),
        valid=g(window.valid), pose_q=g(window.pose_q, unit_q),
        pose_t=g(window.pose_t), wheel_q=g(window.wheel_q, unit_q),
        wheel_t=g(window.wheel_t), wheel_valid=g(window.wheel_valid),
        stamp=g(window.stamp))

    def gc(x):
        return torch.cat([torch.index_select(x, 1, perm),
                          torch.zeros_like(x[:, :1])], dim=1)

    obs = gc(features.obs_mask)
    features2 = features._replace(uv=gc(features.uv),
                                  uv_right=gc(features.uv_right),
                                  depth=gc(features.depth), obs_mask=obs)

    # Feature cleanup (LocalMap.cpp:152-162).
    obs_count = torch.sum(obs, dim=1)
    oldest_id = torch.amin(torch.where(
        window2.valid, window2.frame_id,
        torch.full_like(window2.frame_id, torch.iinfo(torch.int32).max)))
    dead = features2.valid & (obs_count == 0) & (
        features2.stable | (features2.end_frame < oldest_id))
    features2 = features2._replace(
        valid=features2.valid & ~dead,
        track_cnt=torch.where(dead, torch.zeros_like(features2.track_cnt),
                              features2.track_cnt))
    return features2, window2
