"""The comparison that decides ``correct``: what the window's fleet frames
produced, held against the plain reference (``reference.py``) and the
scene's ground truth (``scene.py``).

Numbers, each against the cell's limit (``limits/<cell>.json``), over the
checked streams and every frame of the window:

* ``track_step_p90_px``, ``track_step_p99_px`` — K1's temporal track ends
  that the program kept: how far the reference's full-resolution
  Lucas-Kanade step would still move them (previous left image to this
  one).  Percentiles and not the largest: a track that ran out of
  iterations keeps status true within the reverse-flow gate and sits off
  the fixed point by design, in any sound run;
* ``stereo_step_p90_px``, ``stereo_step_p99_px`` — the same for K1's stereo
  track ends (left to right);
* ``track_back_fail_share``, ``stereo_back_fail_share`` — of the tracks
  the program kept, the share whose reverse track, run by the reference
  from the program's end and seeded at the track's start, ends farther
  than the reverse-flow gate plus a margin from the start (the gates of
  the configuration's FlowBack: 1.5 px temporal, 0.5 px stereo);
* ``good_dropped_share`` — of the temporal tracks the program attempted
  (the previous frame's observations), the share it dropped that the
  reference keeps with room: the reference tracks each again from its
  start, guessed where the scene's geometry puts it, both ways and then
  left to right, and finds every gate held within half its threshold and
  the depth inside the configuration's range;
* ``pose_gap_p90_m`` — the estimator's pose: the distance between the
  program's pose and the optimum of its robust stereo terms over its
  stereo track ends and landmarks, found again by the reference, over the
  frames whose pose is the window BA's;
* ``landmark_off_share`` — the landmarks of those frames: the share whose
  stereo disparity (fx baseline / depth) in the program's camera lies
  farther than ``LANDMARK_OFF_PX`` from the disparity of the point where
  the scene's ray through its left observation meets the world.  A share
  of a tail and not a percentile: the render samples the texture's sharp
  edges at pixel centres, so a sound stereo match lies some tenths of a
  pixel from the geometric disparity, and a percentile reads that floor;
* ``span_ate_m`` — every stream's trajectory in the window against the
  ground truth: the bench's ATE over spans of fixed length that overlap by
  half, the last ending at the window's last frame, the largest;
* ``lost_frames`` — stream-frames of the window reported lost.

``control`` puts the reference, computed in bfloat16, in the program's
place (its tracks, its kept and dropped sets, its landmarks' depths and
its poses), and has to come out not correct.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import reference, scene

FRAMES_A_BATCH = 4  # window frames whose images the reference takes at once
LANDMARK_OFF_PX = 1.5  # disparity error (px) beyond which a landmark is off


class Record(NamedTuple):
    """What a run hands the comparison."""

    images: torch.Tensor  # [T, 2, H, W] the lap's images as fed
    lap: scene.Lap  # the lap's ground truth and geometry
    offsets: np.ndarray  # [B] each stream's start frame on the lap
    ref: dict  # the configuration's "reference" block: LK and gates
    poses: np.ndarray  # [N, B, 4, 4] every stepped frame's poses
    lost: np.ndarray  # [N, B] bool
    ba_used: np.ndarray  # [N, B] bool: the pose is the window BA's
    window_frames: range  # the frames of N stepped in the window
    checked: np.ndarray  # [S] the streams the reference follows
    snaps: list  # the checked streams' tables, frame window.start - 1 on
    span: int

    @property
    def camera(self):
        c = self.lap.camera
        return (c.fx, c.fy, c.cx, c.cy, c.baseline)


class Tracks(NamedTuple):
    """One batch of frames' tracks on the checked streams, flattened; an
    image index ``i`` is frame ``i // S``'s stream ``i % S``."""

    t_idx: torch.Tensor  # [A] image of each attempted temporal track
    t_from: torch.Tensor  # [A, 2] its start (previous left image)
    t_kept: torch.Tensor  # [A] bool
    t_to: torch.Tensor  # [A, 2] its end where kept
    s_idx: torch.Tensor  # [K] image of each kept stereo track
    s_left: torch.Tensor  # [K, 2]
    s_right: torch.Tensor  # [K, 2]


def _lap_frame(rec: Record, n, streams) -> np.ndarray:
    return (rec.offsets[streams] + n) % len(rec.lap.poses)


def _lk_kw(rec: Record) -> dict:
    r = rec.ref
    return {"iterations": r["iterations"], "eps": r["eps"],
            "min_eig": r["min_eig"]}


class _Batch(NamedTuple):
    frames: list  # window frame numbers n
    ks: list  # their positions in rec.snaps less 1
    prev: torch.Tensor  # [S * len(frames)] lap frame of the previous image
    cur: torch.Tensor  # [S * len(frames)] lap frame of this image


def _batches(rec: Record):
    frames = list(rec.window_frames)
    for i in range(0, len(frames), FRAMES_A_BATCH):
        part = frames[i:i + FRAMES_A_BATCH]
        cur = np.concatenate([_lap_frame(rec, n, rec.checked) for n in part])
        prev = np.concatenate([_lap_frame(rec, n - 1, rec.checked)
                               for n in part])
        yield _Batch(part, list(range(i, i + len(part))),
                     torch.as_tensor(prev), torch.as_tensor(cur))


def _images(rec: Record, lap_frames, side: int):
    return rec.images[lap_frames.to(rec.images.device), side]


def _flat(snaps: list, key: str, col=None):
    x = torch.cat([s[key] for s in snaps])
    return x if col is None else x[:, :, col]


def program_tracks(rec: Record, b: _Batch) -> Tracks:
    """The program's tracks: attempted are the previous frame's newest
    observations, kept those with an observation in this frame."""
    prev = [rec.snaps[k] for k in b.ks]
    cur = [rec.snaps[k + 1] for k in b.ks]
    attempted = _flat(prev, "obs", 1)
    seen = _flat(cur, "obs", 1)
    img = torch.arange(len(attempted), device=attempted.device)[:, None] \
        .expand(attempted.shape)
    kept = seen[attempted]
    return Tracks(
        t_idx=img[attempted], t_from=_flat(prev, "uv", 1)[attempted],
        t_kept=kept, t_to=_flat(cur, "uv", 1)[attempted],
        s_idx=img[seen], s_left=_flat(cur, "uv", 1)[seen],
        s_right=_flat(cur, "uvr")[seen])


def _guess(rec: Record, b: _Batch, idx, pts):
    """Where the scene's geometry puts pts (previous left image of image
    idx) in this frame's left image; pts where the ray meets nothing."""
    prev, cur = b.prev.to(pts.device)[idx], b.cur.to(pts.device)[idx]
    z = scene.ray_depth(rec.lap, prev, 0, pts)
    hit = torch.isfinite(z)
    world = scene.unproject(rec.lap, prev, 0, pts,
                            torch.where(hit, z, torch.ones_like(z)))
    uv, zc = scene.project(rec.lap, cur, 0, world)
    ok = hit & (zc > 0.05) & torch.all(torch.isfinite(uv), -1)
    return torch.where(ok[:, None], uv, pts.to(torch.float64))


def _pyrs(rec: Record, b: _Batch, dtype):
    """(temporal forward, temporal back, stereo forward, stereo back)
    pyramids of the batch's images."""
    r = rec.ref
    left_prev = _images(rec, b.prev, 0)
    left, right = _images(rec, b.cur, 0), _images(rec, b.cur, 1)
    kw = dict(win=r["win"], levels=r["levels"], dtype=dtype)
    return (reference.PyrImages(left_prev, left, **kw),
            reference.PyrImages(left, left_prev, **kw),
            reference.PyrImages(left, right, **kw),
            reference.PyrImages(right, left, **kw))


def control_tracks(rec: Record, b: _Batch, program: Tracks) -> Tracks:
    """The reference in bfloat16 in the program's place: it tracks the
    program's attempted starts (from the geometry's guess) both ways and
    keeps what its gate keeps, and tracks the program's stereo left points
    both ways from where they are."""
    r = rec.ref
    t_fwd, t_back, s_fwd, s_back = _pyrs(rec, b, torch.bfloat16)
    kw = _lk_kw(rec)
    guess = _guess(rec, b, program.t_idx, program.t_from)
    t_to, t_ok, _ = reference.bidirectional(
        t_fwd, t_back, program.t_from, guess, program.t_idx,
        r["gate_temporal_px"], **kw)
    s_to, s_ok, _ = reference.bidirectional(
        s_fwd, s_back, program.s_left, program.s_left, program.s_idx,
        r["gate_stereo_px"], **kw)
    return Tracks(t_idx=program.t_idx, t_from=program.t_from, t_kept=t_ok,
                  t_to=t_to, s_idx=program.s_idx[s_ok],
                  s_left=program.s_left[s_ok], s_right=s_to[s_ok])


def _finite(d: torch.Tensor) -> torch.Tensor:
    """d on the host, 1e9 where it is not finite."""
    return torch.where(torch.isfinite(d), d, torch.full_like(d, 1e9)).cpu()


def _step_norms(pyr: reference.PyrImages, pf, pt, idx) -> torch.Tensor:
    """The full-resolution step's length at each track end (1e9 where it
    is not finite)."""
    if len(pf) == 0:
        return torch.zeros(0, dtype=torch.float64)
    st = reference.lk_step(pyr.levels[0], pf.double(), pt.double(), idx)
    return _finite(torch.linalg.norm(st, dim=-1))


def _good(rec: Record, b: _Batch, pyrs, idx, pf) -> torch.Tensor:
    """[N] bool: the reference keeps the track with room: both ways within
    half of each gate, and a depth inside the configuration's range."""
    r = rec.ref
    kw = _lk_kw(rec)
    t_fwd, t_back, s_fwd, s_back = pyrs
    guess = _guess(rec, b, idx, pf)
    pt, t_ok, _ = reference.bidirectional(
        t_fwd, t_back, pf, guess, idx, r["gate_temporal_px"] / 2, **kw)
    ps, s_ok, _ = reference.bidirectional(
        s_fwd, s_back, pt, pt, idx, r["gate_stereo_px"] / 2, **kw)
    c = rec.lap.camera
    z = reference.stereo_depth(pt, ps[:, 0], c.fx, c.baseline)
    depth_ok = (z > r["min_depth_m"] * 1.1) & (z < r["max_depth_m"] / 1.1)
    return t_ok & s_ok & depth_ok


def track_parts(rec: Record, control: bool) -> dict:
    """Per kept track, its step and its reverse distance, and the counts
    of attempted and good dropped tracks."""
    out = {k: [] for k in ("temporal", "stereo", "temporal_back",
                           "stereo_back")}
    attempted = good_dropped = 0
    kw = _lk_kw(rec)
    for b in _batches(rec):
        tr = program_tracks(rec, b)
        if control:
            tr = control_tracks(rec, b, tr)
        pyrs = _pyrs(rec, b, torch.float64)
        t_fwd, t_back, s_fwd, s_back = pyrs
        k = tr.t_kept
        out["temporal"].append(_step_norms(t_fwd, tr.t_from[k], tr.t_to[k],
                                           tr.t_idx[k]))
        out["stereo"].append(_step_norms(s_fwd, tr.s_left, tr.s_right,
                                         tr.s_idx))
        if rec.ref["flow_back"]:
            out["temporal_back"].append(_finite(reference.reverse_distance(
                t_back, tr.t_from[k], tr.t_to[k], tr.t_idx[k], **kw)))
            out["stereo_back"].append(_finite(reference.reverse_distance(
                s_back, tr.s_left, tr.s_right, tr.s_idx, **kw)))
        dropped = ~k
        attempted += len(k)
        if dropped.any():
            good_dropped += int(_good(rec, b, pyrs, tr.t_idx[dropped],
                                      tr.t_from[dropped]).sum())
        del pyrs, t_fwd, t_back, s_fwd, s_back
    got = {key: (torch.cat(v) if v else torch.zeros(0, dtype=torch.float64))
           for key, v in out.items()}
    got["attempted"] = attempted
    got["good_dropped"] = good_dropped
    return got


def _judged(rec: Record, k: int):
    """The checked streams of window frame k whose pose is the window
    BA's with a full window: (mask [S], snapshot)."""
    n = rec.window_frames[k]
    snap = rec.snaps[k + 1]
    dev = snap["pw"].device
    ok = torch.as_tensor(~rec.lost[n, rec.checked]
                         & rec.ba_used[n, rec.checked],
                         device=dev) & snap["window_full"]
    return ok, snap


def pose_parts(rec: Record, control: bool) -> dict:
    """Per judged frame, the pose's distance to the optimum the reference
    finds again from it, and per landmark of those frames its disparity's
    error against the scene."""
    gaps, depth = [], []
    c = rec.lap.camera
    for k, n in enumerate(rec.window_frames):
        ok, snap = _judged(rec, k)
        if not ok.any():
            continue
        dev = ok.device
        mask = snap["obs"][:, :, 1] & snap["landmark"]
        uv = snap["uv"][:, :, 1]
        obs = torch.cat([uv, snap["uvr"][:, :, :1]], -1)
        T = torch.as_tensor(rec.poses[n, rec.checked], device=dev)
        if control:
            T = reference.refine_planar_pose(T, snap["pw"], obs, mask,
                                             rec.camera, dtype=torch.bfloat16)
        ref = reference.refine_planar_pose(T, snap["pw"], obs, mask,
                                           rec.camera)
        gap = torch.linalg.norm(ref[:, :2, 3] - T[:, :2, 3].double(), dim=-1)
        enough = (mask.sum(-1) >= 6) & ok
        gaps.append(gap[enough].cpu())

        sel = mask & ok[:, None]
        s_of = torch.arange(len(ok), device=dev)[:, None].expand(mask.shape)
        s_of = s_of[sel]
        lap_frames = torch.as_tensor(_lap_frame(rec, n, rec.checked),
                                     device=dev)[s_of]
        truth = scene.ray_depth(rec.lap, lap_frames, 0, uv[sel])
        if control:
            z = reference.stereo_depth(uv[sel], obs[sel][:, 2], c.fx,
                                       c.baseline, dtype=torch.bfloat16)
        else:
            z = reference.camera_depth(T[s_of], snap["pw"][sel])
        bf = c.fx * c.baseline
        depth.append(_finite(torch.abs(bf / z - bf / truth)))
    cat = (lambda v: torch.cat(v) if v
           else torch.zeros(0, dtype=torch.float64))
    return {"pose": cat(gaps), "landmark_disparity": cat(depth)}


def _span_ate(rec: Record) -> float:
    worst = 0.0
    w = np.arange(rec.window_frames.start, rec.window_frames.stop)
    for s in range(rec.lost.shape[1]):
        gt = rec.lap.poses[_lap_frame(rec, w, s)]
        worst = max(worst, scene.span_ate(rec.poses[w, s], gt, rec.span))
    return worst


def quantile(x: torch.Tensor, q: float) -> float:
    """The q-quantile (0 for no values)."""
    return float(np.quantile(x.cpu().numpy(), q)) if len(x) else 0.0


def share(x: torch.Tensor, above: float) -> float:
    """The share of x over ``above`` (0 for no values)."""
    return float((x > above).double().mean()) if len(x) else 0.0


def parts(rec: Record, control: bool = False) -> dict:
    """The values behind the numbers (of the program, or of the
    control)."""
    return {**track_parts(rec, control), **pose_parts(rec, control)}


def numbers(rec: Record, control: bool = False, got=None) -> dict:
    """The compared numbers of a run (of the control with ``control``),
    from ``parts`` (``got``, worked out here when not given)."""
    got = parts(rec, control) if got is None else got
    r = rec.ref
    return {
        "track_step_p90_px": quantile(got["temporal"], 0.9),
        "track_step_p99_px": quantile(got["temporal"], 0.99),
        "stereo_step_p90_px": quantile(got["stereo"], 0.9),
        "stereo_step_p99_px": quantile(got["stereo"], 0.99),
        "track_back_fail_share": share(
            got["temporal_back"],
            r["gate_temporal_px"] + r["back_margin_px"]),
        "stereo_back_fail_share": share(
            got["stereo_back"], r["gate_stereo_px"] + r["back_margin_px"]),
        "good_dropped_share": got["good_dropped"] / max(got["attempted"], 1),
        "pose_gap_p90_m": quantile(got["pose"], 0.9),
        "landmark_off_share": share(got["landmark_disparity"],
                                    LANDMARK_OFF_PX),
        "span_ate_m": _span_ate(rec),
        "lost_frames": int(rec.lost[list(rec.window_frames)].sum()),
    }


def judge(values: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit], ...]): correct when every number is
    at most its limit."""
    rows = [[k, values[k], limits[k]] for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
