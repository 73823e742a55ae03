"""Front-end tracker stage: feature lifecycle per frame, fully batched
(torch port of visfs_tpu.slam.tracker).

Temporal LK from the previous left image with a projected initial guess and
a 1.5 px reverse-flow gate, lost-tracking detection, GFTT top-up, stereo LK
with a 0.5 px reverse gate and triangulation, and the feature-table write.
At stage entry the newest occupied observation column is W-2; the current
frame writes column W-1.  Live tracks are compacted with a stable argsort
and the reference's dropping scatters become writes into a spare row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.camera import StereoCamera, triangulate_stereo
from ..core.lie import mat_apply, mat_inv_se3
from ..ops.gftt import gftt_detect
from ..ops.lk import (LKParams, LKPyramid, build_lk_pyramid, lk_pad,
                      lk_track_bidirectional_pyr, lk_track_pyr)
from .state import I32, FeatureTable


class TrackerOutput(NamedTuple):
    features: FeatureTable  # table with current-frame observations written
    left_pyr: tuple  # ((img, gx, gy) per level) — carried to the next frame
    temporal_mask: torch.Tensor  # [F] tracked from prev frame (pre-stereo)
    temporal_uv: torch.Tensor  # [F, 2] current-frame uv of temporal matches
    prev_p_robot: torch.Tensor  # [F, 3] prev-frame robot-frame 3D points
    n_tracked: torch.Tensor
    n_new: torch.Tensor
    track_lost: torch.Tensor  # bool
    next_fid: torch.Tensor


def backproject(cam: StereoCamera, uv, depth):
    """Pixels + image-frame depth -> robot-frame 3D points."""
    z = depth
    x = (uv[..., 0] - cam.cx) / cam.fx * z
    y = (uv[..., 1] - cam.cy) / cam.fy * z
    return mat_apply(cam.t_ri, torch.stack([x, y, z], dim=-1))


def _scatter_rows(n: int, idx, values):
    """zeros([n, ...]) with rows idx (unique) set to values."""
    out = values.new_zeros((n,) + values.shape[1:])
    out[idx] = values
    return out


def tracker_step(features: FeatureTable, prev_left, prev_right, left, right,
                 has_prev, guess_delta, blocked_uv, blocked_valid, next_fid,
                 frame_id, cam: StereoCamera, *, max_features: int,
                 quality_level: float, min_distance: int, min_inliers: int,
                 flow_back: bool, min_depth: float, max_depth: float,
                 lk_params: LKParams, rgbd: bool = False,
                 cull_fundamental: bool = False, prev_pyr=None
                 ) -> TrackerOutput:
    if rgbd:
        raise NotImplementedError("tracker_step: the RGBD front end "
                                  "(SensorStrategy 1) is not ported")
    if cull_fundamental:
        raise NotImplementedError("tracker_step: Tracker/"
                                  "CullByFundationMatrix is not ported")
    Fcap = features.capacity
    W = features.window
    prev_col, cur_col = W - 2, W - 1
    dev = left.device

    if prev_pyr is None:
        prev_pyr = build_lk_pyramid(prev_left, lk_params)
    left_pyr = build_lk_pyramid(left, lk_params)
    right_pyr = build_lk_pyramid(right, lk_params)

    # 1. Temporal tracking prev -> cur, compacted to live features.
    M = max_features
    prev_mask = features.valid & features.obs_mask[:, prev_col] & has_prev
    comp_idx = torch.argsort((~prev_mask).to(torch.uint8), stable=True)[:M]
    comp_live = prev_mask[comp_idx]
    prev_uv_c = features.uv[comp_idx, prev_col]
    prev_depth_c = features.depth[comp_idx, prev_col]
    p_prev_robot_c = backproject(cam, prev_uv_c, prev_depth_c)

    # Projected initial guess (Tracker.cpp:237-252).
    p_cur_img = mat_apply(cam.t_ir @ mat_inv_se3(guess_delta), p_prev_robot_c)
    zc = p_cur_img[:, 2]
    z = torch.where(torch.abs(zc) < 1e-6, torch.full_like(zc, 1e-6), zc)
    guess_uv = torch.stack([p_cur_img[:, 0] / z * cam.fx + cam.cx,
                            p_cur_img[:, 1] / z * cam.fy + cam.cy], dim=-1)
    good_guess = (zc > 0.05) & torch.all(torch.isfinite(guess_uv), dim=-1)
    init_uv_c = torch.where(good_guess[:, None], guess_uv, prev_uv_c)

    if flow_back:
        trk_c = lk_track_bidirectional_pyr(prev_pyr, left_pyr, prev_uv_c,
                                           init_uv_c, comp_live, lk_params,
                                           fb_threshold=1.5)
    else:
        trk_c = lk_track_pyr(prev_pyr, left_pyr, prev_uv_c, init_uv_c,
                             comp_live, lk_params)

    pts = trk_c.points
    inb_c = ((pts[:, 0] >= 0) & (pts[:, 0] < cam.width)
             & (pts[:, 1] >= 0) & (pts[:, 1] < cam.height))
    tm_c = trk_c.status & inb_c & comp_live
    n_tracked = torch.sum(tm_c)
    track_lost = has_prev & (n_tracked < min_inliers)
    tm_c = tm_c & ~track_lost
    n_tracked = torch.sum(tm_c)

    temporal_uv = _scatter_rows(Fcap, comp_idx, pts)
    temporal_mask = _scatter_rows(Fcap, comp_idx, tm_c)
    p_prev_robot = _scatter_rows(Fcap, comp_idx, p_prev_robot_c)

    # 2. Re-detection top-up (budget = MaxFeatures - survivors).
    det = gftt_detect(left, max_features, quality_level, min_distance,
                      existing_pts=temporal_uv, existing_mask=temporal_mask,
                      blocked_pts=blocked_uv, blocked_mask=blocked_valid)
    budget = torch.clamp(max_features - n_tracked, min=0)
    rank = torch.arange(det.points.shape[0], device=dev)
    new_uv = det.points
    new_cand = det.valid & (rank < budget)

    # 3. Stereo LK matching + triangulation.
    all_uv = torch.cat([pts, new_uv], dim=0)  # [2M]
    all_mask = torch.cat([tm_c, new_cand], dim=0)
    if flow_back:
        st = lk_track_bidirectional_pyr(left_pyr, right_pyr, all_uv, all_uv,
                                        all_mask, lk_params, fb_threshold=0.5)
    else:
        st = lk_track_pyr(left_pyr, right_pyr, all_uv, all_uv, all_mask,
                          lk_params)
    sp = st.points
    st_inb = ((sp[:, 0] >= 0) & (sp[:, 0] < cam.width)
              & (sp[:, 1] >= 0) & (sp[:, 1] < cam.height))
    stereo_ok = st.status & st_inb & all_mask
    p3d_robot, tri_ok = triangulate_stereo(cam, all_uv, sp, min_depth,
                                           max_depth)
    cur_ok = stereo_ok & tri_ok
    p_safe = torch.where(cur_ok[:, None], p3d_robot,
                         torch.zeros_like(p3d_robot))
    p_img_z = torch.where(cur_ok, mat_apply(cam.t_ir, p_safe)[:, 2],
                          torch.zeros_like(sp[:, 0]))

    trk_ok = _scatter_rows(Fcap, comp_idx, cur_ok[:M])
    trk_uvr = _scatter_rows(Fcap, comp_idx, sp[:M])
    trk_depth = _scatter_rows(Fcap, comp_idx, p_img_z[:M])
    new_ok = cur_ok[M:]

    # 4. Surviving tracks' current observations into column W-1.
    f = features
    uv = f.uv.clone()
    uv[:, cur_col] = torch.where(trk_ok[:, None], temporal_uv,
                                 torch.zeros_like(temporal_uv))
    uvr = f.uv_right.clone()
    uvr[:, cur_col] = torch.where(trk_ok[:, None], trk_uvr,
                                  torch.zeros_like(trk_uvr))
    depth = f.depth.clone()
    depth[:, cur_col] = torch.where(trk_ok, trk_depth,
                                    torch.zeros_like(trk_depth))
    obs = f.obs_mask.clone()
    obs[:, cur_col] = trk_ok
    end_frame = torch.where(trk_ok, frame_id, f.end_frame)
    track_cnt = torch.where(trk_ok, f.track_cnt + 1,
                            torch.zeros_like(f.track_cnt))

    # 5. Allocate free slots (ascending) for accepted new features; a
    # candidate without a slot writes into the spare row Fcap, dropped.
    free = ~f.valid
    n_free = torch.sum(free)
    slot_rank = torch.arange(Fcap, device=dev)
    slot_order = torch.argsort(torch.where(free, slot_rank, Fcap + slot_rank))
    acc_rank = torch.cumsum(new_ok.to(I32), dim=0) - 1
    has_slot = new_ok & (acc_rank < n_free)
    target = torch.where(has_slot, slot_order[torch.clamp(acc_rank, 0,
                                                          Fcap - 1)],
                         torch.full_like(slot_order[:M], Fcap))
    n_new = torch.sum(has_slot)
    new_fids = torch.where(has_slot, next_fid + acc_rank,
                           torch.full_like(acc_rank, -1)).to(I32)

    def put(a, values):
        """a with rows `target` set to values (spare row dropped)."""
        ext = torch.cat([a, a[:1]], dim=0)
        ext[target] = values.to(a.dtype)
        return ext[:Fcap]

    def put_col(a, values):
        ext = torch.cat([a, a[:1]], dim=0)
        ext[target, cur_col] = values.to(a.dtype)
        return ext[:Fcap]

    new_obs = torch.zeros((M, W), dtype=torch.bool, device=dev)
    new_obs[:, cur_col] = has_slot
    frame_fill = torch.full((M,), 0, dtype=I32, device=dev) + frame_id
    new_features = FeatureTable(
        fid=put(f.fid, new_fids), valid=put(f.valid, has_slot),
        uv=put_col(uv, new_uv), uv_right=put_col(uvr, sp[M:]),
        depth=put_col(depth, p_img_z[M:]), obs_mask=put(obs, new_obs),
        pw=put(f.pw, p3d_robot[M:]),
        stable=put(f.stable, torch.zeros(M, dtype=torch.bool, device=dev)),
        track_cnt=put(track_cnt, torch.ones(M, dtype=I32, device=dev)),
        start_frame=put(f.start_frame, frame_fill),
        end_frame=put(end_frame, frame_fill),
    )
    return TrackerOutput(
        features=new_features,
        left_pyr=tuple((left_pyr.levels[i], left_pyr.gx[i], left_pyr.gy[i])
                       for i in range(len(left_pyr.levels))),
        temporal_mask=temporal_mask, temporal_uv=temporal_uv,
        prev_p_robot=p_prev_robot, n_tracked=n_tracked, n_new=n_new,
        track_lost=track_lost, next_fid=next_fid + n_new.to(I32),
    )


def carried_pyramid(prev_pyr: tuple, height: int, width: int,
                    params: LKParams) -> LKPyramid:
    """LKPyramid view of the state's carried ((img, gx, gy) per level)."""
    return LKPyramid(levels=tuple(lv[0] for lv in prev_pyr),
                     gx=tuple(lv[1] for lv in prev_pyr),
                     gy=tuple(lv[2] for lv in prev_pyr),
                     height=height, width=width, pad=lk_pad(params))
