"""The port's multi-card entry: one robot a rank (the twin of the JAX
package's ``__graft_entry__.dryrun_multichip``), at full width.

    python -m visfs_tpu_torch.multichip --world N [--device cuda|cpu]
        [--width 640 --height 480] [--frames 40] [--robot-frames 240/N]

The parent builds K1, K3 and K4 (on the card), renders the three scenes
into the sim cache unless they are there (chip_smoke.py's renders), then
spawns N ranks on a free localhost port: one card a rank over NCCL, each
rank calling ``torch.cuda.set_device(rank)`` before it builds any state,
or with ``--device cpu`` gloo ranks on the CPU.  The ranks run, in the
dryrun's order:

  a. ``dp_fleet_step`` at SensorStrategy 0: the bench parameters on the
     300-frame bench loop, rank r the stream at frame (r * 7) mod 260 with
     seed r (bench.py phase 3's offsets), F frames; frames 0-1, then a
     timed loop over 2..F-1;
  b. ``dp_fleet_step`` at SensorStrategy 3: configs/sim_mapping.yaml's
     block (its MinDistance scaled to the width) on the 120-frame laser
     loop with its scans and wheel rows, rank r from frame
     r * (120 - F) // max(1, N - 1), the same loop;
  c. ``FleetMapping``: N robots on the two-lap seed-11 loop, robot r from
     its true pose at frame r * (240 // N), robot-frames frames each, then
     ``close_loops(2.5, 8, 10)`` and ``optimize(10, 60)``; rank 0 also runs
     the port's ``MultiRobotMapping`` fed in the fleet's lockstep order;
  d. the landmark-sharded BA and the edge-sharded pose graph on the
     dryrun's problems, each against the one-rank solve on the same card.

Gates (the parent holds them and prints one JSON report line; exit 1 when
one fails): in a and b each row of the gathered outputs bit-equal to a
single ``System`` of that seed over the same frames on the same card, every
rank's gathered outputs identical, exactly 2 ``lk_pyramid`` launches a
timed frame and 0 of every other kernel entry, 0 host syncs in the timed
loop (on the card), each rank's ATE <= 0.15 m and 0 lost over frames 2..;
in b also phase s3's map gate on each rank's submaps.  In c the keyframe
counts, node poses, edge lists and accepted closures identical to
``MultiRobotMapping``'s, and its poses and chi2 after ``optimize`` bit for
bit; on every rank two sharded solves of the fleet's graph bit-equal, two
one-rank solves of it bit-equal, and the sharded solve bit-equal to the
one-rank solve, poses and chi2 (every solve in PyTorch's default mode: a
rank makes its edges' terms in the CPU einsum's order whatever the
shard's size, K4, ``ops/kernels/edge_products.py``; the sharded solve
adds the gathered per-edge terms in the one-rank order, and each pose's
terms in one fixed order, K3); their gaps in m and rad are printed
beside; >= 1 cross-robot closure when N >= 2, every rank holding the
same graph, 0 host syncs in one ``verify_loop`` and in one solve (on the
card; no verify_loop call fails it).  In d the edge-sharded pose graph's
poses and chi2 bit-equal to the one-rank solve's; the landmark-sharded
BA, which psums partial sums as the reference does, poses within 1e-5
and landmarks within 2.1e-4 m of the one-rank solve
(tests/test_torch_distributed.py's bounds); ok, every rank the same.
Printed, not gated: the aggregate fps of a and b, the gather's device ms a
frame (CUDA events around ``gather_stacked``), the close-and-solve seconds.

On the CPU the kernels' plain versions run and count nothing, so the
launch gate counts the calls of the LK entries instead, and host syncs and
device times are not measured.  There is no fallback: ``--device cuda``
without enough cards raises, and so does a rank whose bring-up fails.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import multiprocessing
import os
import queue as queue_mod
import socket
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

from .ops.kernels import _build

# bench.py phase 3: the streams start at (k * 7) mod (300 - 40)
BENCH_FRAMES, FLEET_SPAN = 300, 260
S3_FRAMES = 120
BACKEND_FRAMES = 240
ATE_GATE = 0.15
S3_SYSTEM = dict(scan_capacity=256, submap_extent_cells=256)  # phase s3's
BACKEND_SESSION = dict(max_nodes=128, max_edges=512, snapshot_kp=48)
BACKEND_LOOPS = dict(radius=2.5, min_gap=8, min_inliers=10)
BACKEND_SOLVE = dict(iterations=10, cg_iters=60)
SOLVER_POSE_BOUND = 1e-5  # d, the BA: tests/test_torch_distributed.py's
LANDMARK_BOUND = 2.1e-4
# the kernel entries, K1's and K2's, with the counter each wrapper keeps
ENTRIES = {"lk_pyramid": ("lk_level", "PYR_LAUNCHES"),
           "lk_level": ("lk_level", "LAUNCHES"),
           "lk_xcorr_pyramid": ("lk_xcorr", "PYR_LAUNCHES"),
           "lk_xcorr_iterate": ("lk_xcorr", "LAUNCHES")}
ON_THE_PATH = {"lk_pyramid": 2}  # launches a frame; 0 of every other entry
# what the ranks may take, and the process group's collective timeout (the
# ranks wait in a collective while rank 0 runs section c's reference)
RANK_TIMEOUT_S = 3000.0


def scenes(width, height):
    """The three scenes (io.sim.cached_textured_sequence's arguments, as
    chip_smoke.py renders them, so its cache serves them): its bench loop
    (with depth, as there), phase s3's laser loop and phase backend's
    two-lap loop."""
    size = dict(width=width, height=height, motion="square")
    return dict(
        bench=dict(size, n_frames=BENCH_FRAMES, seed=0, speed=2.0,
                   with_depth=True),
        s3=dict(size, n_frames=S3_FRAMES, seed=1, speed=2.0,
                with_laser=True, n_beams=180),
        backend=dict(size, n_frames=BACKEND_FRAMES, seed=11, loops=2.0,
                     room=(-3.0, 13.0, -6.0, 6.0)))


def bench_params(width):
    """The simMapping operating point of the reference bench (bench.py)."""
    return {"Tracker/MaxFeatures": 120,
            "Tracker/MinDistance": max(12, 40 * width // 640),
            "Tracker/QualityLevel": 0.05, "LocalMap/MapSize": 5,
            "Optimizer/Iterations": 20, "Estimator/Force3DoF": True,
            "Estimator/ToleranceTranslation": 0.40}


def mapping_params(width):
    """configs/sim_mapping.yaml's block, its MinDistance scaled to the
    width (verbatim at 640)."""
    from .operating_points import SIM_MAPPING

    return dict(SIM_MAPPING, **{"Tracker/MinDistance":
                                max(12, 40 * width // 640)})


def stream_offsets(world, frames):
    """Sections a's, b's and c's start frame of each rank's stream."""
    return ([(r * 7) % FLEET_SPAN for r in range(world)],
            [r * (S3_FRAMES - frames) // max(1, world - 1)
             for r in range(world)],
            [r * (BACKEND_FRAMES // world) for r in range(world)])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _init(session, cam):
    session.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                 float(cam.baseline), width=cam.width, height=cam.height)


def rel_gap(a, b):
    """(max |dt| m, rotation angle rad) between two 4x4 transforms; the
    angle from |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2), which holds its
    precision near 0 where the trace's arccos does not."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2.0 * np.sqrt(2.0))
    return (float(np.abs(a[:3, 3] - b[:3, 3]).max()),
            float(2.0 * np.arcsin(min(d, 1.0))))


def words_differing(a, b):
    """The 32-bit words in which two float32 arrays differ (inf when their
    shapes do): 0 is bit-equal, signed zeros and NaN payloads included."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    if a.shape != b.shape:
        return float("inf")
    return int((a.view(np.int32) != b.view(np.int32)).sum())


def solve_words(a, b):
    """words_differing over two solves' (graph, chi2): pose_q, pose_t and
    chi2."""
    (ga, ca), (gb, cb) = a, b
    return sum(words_differing(x.cpu(), y.cpu()) for x, y in (
        (ga.pose_q, gb.pose_q), (ga.pose_t, gb.pose_t), (ca, cb)))


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f"))


# --- what a rank measures --------------------------------------------------

@contextlib.contextmanager
def launch_counts(dev):
    """Yields a dict filled on exit with each kernel entry's launches (on
    the card: the wrappers' counters, set to 0 on entry) or, on the CPU,
    where the plain versions count nothing, the calls of ops.lk's LK
    entries."""
    from .ops import lk as lk_ops
    from .ops.kernels import lk_level, lk_xcorr

    mods = {"lk_level": lk_level, "lk_xcorr": lk_xcorr}
    counts = {}
    if dev.type == "cuda":
        for mod, counter in ENTRIES.values():
            setattr(mods[mod], counter, 0)
        yield counts
        counts.update({name: getattr(mods[mod], counter)
                       for name, (mod, counter) in ENTRIES.items()})
        return
    calls = dict.fromkeys(ENTRIES, 0)
    real = {name: getattr(lk_ops, name) for name in ENTRIES
            if hasattr(lk_ops, name)}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for name, fn in real.items():
        setattr(lk_ops, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(lk_ops, name, fn)
    counts.update(calls)


@contextlib.contextmanager
def host_syncs(dev):
    """Yields a list filled on exit with the host syncs made inside (the
    warnings of torch.cuda.set_sync_debug_mode("warn")); None on the CPU,
    where there is no device to wait for."""
    if dev.type != "cuda":
        yield None
        return
    found = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(0)
    found.extend(str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message))


@contextlib.contextmanager
def timed_gathers(dev):
    """Yields a list filled on exit with each ``gather_stacked`` call's ms
    inside dp_fleet_step: device ms between CUDA events around it on the
    card (the collective and its wait for the slowest rank), None on the
    CPU."""
    from .slam import fleet as fleet_mod

    real, marks = fleet_mod.gather_stacked, []

    def timed(tensors, group):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = real(tensors, group)
        e1.record()
        marks.append((e0, e1))
        return out

    ms = []
    if dev.type == "cuda":
        fleet_mod.gather_stacked = timed
    try:
        yield ms
    finally:
        fleet_mod.gather_stacked = real
    _sync(dev)
    ms.extend(a.elapsed_time(b) for a, b in marks)


def wheel_batches(seq, offset, frames):
    """Per frame of a stream from ``offset``, the wheel rows stamped after
    the frame before it, up to its own stamp (None when there are none):
    bench.py's feed, the first batch starting after frame offset - 1."""
    odom = np.asarray(seq.wheel_odom, np.float32)
    at = 0 if offset == 0 else int(np.searchsorted(
        odom[:, 0], seq.stamps[offset - 1] + 1e-9, side="right"))
    out = []
    for i in range(offset, offset + frames):
        end = int(np.searchsorted(odom[:, 0], seq.stamps[i] + 1e-9,
                                  side="right"))
        out.append(odom[at:end] if end > at else None)
        at = max(at, end)
    return out


def run_stream(mesh, dev, seq, params, seed, offset, frames, system_kw,
               laser):
    """This rank's stream through dp_fleet_step (a System of ``seed`` as
    its state holder and feeder), frames 0-1 then a timed loop over
    2..frames-1, then a single System of the same seed over the same frames
    on the same card.  Returns the rank's section report."""
    import torch.distributed as dist

    from .io.sim import ate_rmse
    from .slam.fleet import dp_fleet_step, fleet_outputs_to_numpy
    from .slam.state import FrameOutput
    from .slam.system import System

    idx = range(offset, offset + frames)
    lefts = [torch.as_tensor(seq.left[i], device=dev) for i in idx]
    rights = [torch.as_tensor(seq.right[i], device=dev) for i in idx]
    rows = wheel_batches(seq, offset, frames) if laser else [None] * frames
    scans = [seq.laser_scans[i] if laser else None for i in idx]
    s = System(params, device=dev, seed=seed, **system_kw)
    _init(s, seq.camera)
    outs = []

    def step(i):
        if rows[i] is not None:
            s.input_wheel_odometry_batch(rows[i][:, 0], rows[i][:, 1:7])
        kw = {}
        if laser:
            pts, msk, tms = s._scan_inputs(scans[i], None)
            kw = dict(scan_points=pts, scan_mask=msk, scan_times=tms)
        stamp = torch.full((), float(seq.stamps[offset + i]),
                           dtype=torch.float32, device=dev)
        s.state, out = dp_fleet_step(mesh, s.state, lefts[i], rights[i],
                                     stamp, s.camera, s.settings,
                                     s.lk_params, s._cfg_hash, **kw)
        outs.append(out)

    for i in range(2):
        step(i)
    _sync(dev)
    dist.barrier(mesh.group)
    with launch_counts(dev) as launches, timed_gathers(dev) as gathers:
        with host_syncs(dev) as syncs:
            t0 = time.perf_counter()
            for i in range(2, frames):
                step(i)
        _sync(dev)
        elapsed = time.perf_counter() - t0
    got = fleet_outputs_to_numpy(outs)
    rank = dist.get_rank(mesh.group)

    single = System(params, device=dev, seed=seed, **system_kw)
    _init(single, seq.camera)
    for i in range(frames):
        if rows[i] is not None:
            single.input_wheel_odometry_batch(rows[i][:, 0], rows[i][:, 1:7])
        single.input_primary_sensor_data(float(seq.stamps[offset + i]),
                                         lefts[i], rights[i], scan=scans[i])
    want = single.drain_outputs()
    fields = FrameOutput._fields[:13]
    first_diff = next(
        (f"frame {i} field {f}: {getattr(g, f)[rank]!r} against "
         f"{getattr(w, f)!r}" for i, (g, w) in enumerate(zip(got, want))
         for f in fields if not same(getattr(g, f)[rank], getattr(w, f))),
        None)
    gt = np.asarray(seq.poses[offset:offset + frames], np.float64)
    gt = np.linalg.inv(gt[0]) @ gt
    pose = np.stack([g.pose[rank] for g in got])
    lost = np.stack([g.lost[rank] for g in got])[2:]
    report = dict(
        offset=offset, seed=seed, frames=frames, elapsed_s=elapsed,
        launches=launches, syncs=None if syncs is None else len(syncs),
        sync_messages=sorted(set(syncs or []))[:3],
        gather_ms=(float(np.mean(gathers)) if gathers else None),
        bit_equal=first_diff is None and len(want) == frames,
        first_diff=first_diff, ate=ate_rmse(pose[2:], gt[2:]),
        lost=int(lost.sum()),
        outputs={f: np.stack([getattr(g, f) for g in got]) for f in fields})
    if laser:
        rows_, bad = map_probes(s.state.laser.submaps, seq.room,
                                seq.poses[offset])
        report.update(map_rows=rows_, map_failures=bad)
    return report


def map_probes(submaps, room, start=None):
    """Phase s3's map gate on the matching grid (tests/test_laser_fusion.py:
    135-165) in a stream's own frame: (printed rows, failures).  The wall
    probes are the test's three and the four walls level with the matching
    submap's origin, taken in the scene's frame and carried into the
    stream's by ``start`` (its first pose in the scene; identity: the
    scene's own start); the free-space probes are (0.5, 0) ahead of the
    stream's start and that origin.  Probability > 0.5 within a 3x3
    neighbourhood of every wall probe inside the grid (at least one), < 0.5
    at the free ones."""
    from .map2d import grid2d
    from .map2d import probability_values as pv
    from .map2d.submap import matching_grid

    if not bool(submaps.slot_valid.any()):
        return [], ["no live submap slot"]
    grid = matching_grid(submaps)
    dev = grid.cells.device
    ct = pv.cost_table(dev)
    t_start = np.eye(4) if start is None else np.asarray(start, np.float64)
    to_stream = np.linalg.inv(t_start)
    first = bool(submaps.slot_valid[0])
    ox, oy = submaps.origin[0 if first else 1, :2].tolist()
    wx, wy = (t_start @ np.array([ox, oy, 0.0, 1.0]))[:2]
    x0, x1, y0, y1 = room
    walls = dict.fromkeys([(x0, 0.0), (0.0, y0), (0.0, y1), (x0, wy),
                           (x1, wy), (wx, y0), (wx, y1)])
    nbhd = torch.tensor([(da, db) for da in (-1, 0, 1) for db in (-1, 0, 1)],
                        device=dev)

    def cell(pt):
        return grid2d.cell_index(grid.limits, torch.tensor(
            pt, dtype=torch.float32, device=dev))

    rows, bad = [], []
    for pw in walls:
        pt = tuple((to_stream @ np.array([pw[0], pw[1], 0.0, 1.0]))[:2])
        idx = cell(pt)
        if not bool(grid2d.contains(grid.limits, idx)):
            continue
        best = float(grid2d.probability(grid, idx + nbhd, ct).max())
        rows.append(f"wall {pt[0]:.2f},{pt[1]:.2f} {best:.3f}")
        if not best > 0.5:
            bad.append(rows[-1])
    if not rows:
        bad.append("no wall probe inside the matching grid")
    for pt in dict.fromkeys([(0.5, 0.0), (ox, oy)]):
        idx = cell(pt)
        p = float(grid2d.probability(grid, idx, ct))
        inside = bool(grid2d.contains(grid.limits, idx))
        rows.append(f"free {pt[0]:.2f},{pt[1]:.2f} {p:.3f}"
                    + ("" if inside else " (outside)"))
        if not p < 0.5:
            bad.append(rows[-1])
    return rows, bad


def graph_edges(g):
    n = int(g.n_edges)
    return list(zip(g.edge_i[:n].tolist(), g.edge_j[:n].tolist()))


def session_result(session, close, solve, extra=None):
    """What both mapping sessions are held on: keyframes, the node poses
    and the edges before the closures, the closures, the solve."""
    out = dict(keyframes=session.keyframe_counts(), graph=session.poses(),
               edges_before=graph_edges(session.backend.graph))
    t0 = time.perf_counter()
    out["added"] = close()
    out["close_s"] = time.perf_counter() - t0
    out["edges"] = graph_edges(session.backend.graph)
    g = session.backend.graph
    n_e = int(g.n_edges)
    out["measurements"] = torch.cat(
        [g.edge_q[:n_e], g.edge_t[:n_e], g.edge_info[:n_e, None]],
        dim=1).cpu().numpy()
    out["cross"] = session.cross_robot_edges()
    if extra is not None:
        out.update(extra())
    t0 = time.perf_counter()
    out["chi2"] = solve()
    out["solve_s"] = time.perf_counter() - t0
    out["optimized"] = session.poses()
    g = session.backend.graph
    out["optimized_qt"] = [g.pose_q.cpu().numpy(), g.pose_t.cpu().numpy()]
    return out


def graph_gap(a, b):
    """(max |dt| m, max angle rad) between two graphs' node poses."""
    from .core.lie import se3_matrix

    n = int(a.n_nodes)
    pa = se3_matrix(a.pose_q[:n], a.pose_t[:n]).cpu().numpy()
    pb = se3_matrix(b.pose_q[:n], b.pose_t[:n]).cpu().numpy()
    gaps = [rel_gap(x, y) for x, y in zip(pa, pb)]
    return (max((g[0] for g in gaps), default=0.0),
            max((g[1] for g in gaps), default=0.0))


def run_mapping(group, dev, seq, params, robot_frames):
    """Section c on this rank: FleetMapping, one robot a rank; on rank 0
    also the one-process MultiRobotMapping fed in the same lockstep order
    (robot 0's frame k, then robot 1's, ...), its Systems of the fleet's
    seeds."""
    import torch.distributed as dist

    from .parallel.mesh import fleet_mesh
    from .slam import mapping
    from .slam.multi_robot import FleetMapping, MultiRobotMapping
    from .slam.system import System

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    offs = stream_offsets(world, 0)[2]
    starts = [seq.poses[o] for o in offs]
    fm = FleetMapping(params, fleet_mesh(group), start_poses=starts,
                      device=dev, **BACKEND_SESSION)
    _init(fm, seq.camera)
    with launch_counts(dev) as launches:
        t0 = time.perf_counter()
        for k in range(robot_frames):
            at = [o + k for o in offs]
            fm.step(seq.stamps[at], seq.left[at], seq.right[at])
        _sync(dev)
        vo_s = time.perf_counter() - t0
    calls, verify = [], mapping.verify_loop

    def recorded(*a, **kw):
        out = verify(*a, **kw)
        calls.append((a, kw))
        return out

    def close():
        mapping.verify_loop = recorded
        try:
            return fm.close_loops(**BACKEND_LOOPS)
        finally:
            mapping.verify_loop = verify

    def probes():
        """Host syncs in one verify_loop call and in one sharded solve
        (every rank takes part in its collectives); the words in which that
        solve differs from a second sharded solve and from the one-rank
        solve of the same graph on this card, and two one-rank solves from
        each other (poses and chi2), with the gaps in m and rad."""
        found = {}
        if calls:
            with host_syncs(dev) as syncs:
                verify(*calls[0][0], **calls[0][1])
            _sync(dev)
            found["verify_syncs"] = syncs
        graph = fm.backend.graph
        with host_syncs(dev) as syncs:
            sharded = mapping.optimize_graph(graph, fm.backend.mesh,
                                             **BACKEND_SOLVE)
        _sync(dev)
        found = {k: None if v is None else len(v)
                 for k, v in dict(found, solve_syncs=syncs).items()}
        again = mapping.optimize_graph(graph, fm.backend.mesh,
                                       **BACKEND_SOLVE)
        one = [mapping.optimize_graph(graph, None, **BACKEND_SOLVE)
               for _ in range(2)]
        found.update(sharded_words=solve_words(sharded, one[0]),
                     sharded_repeat_words=solve_words(sharded, again),
                     one_rank_repeat_words=solve_words(*one),
                     sharded_gap=graph_gap(sharded[0], one[0][0]))
        return found

    out = session_result(fm, close,
                         lambda: fm.optimize(**BACKEND_SOLVE), probes)
    out.update(offsets=offs, frames=robot_frames, vo_s=vo_s,
               launches=launches, verified=len(calls))
    if rank == 0:
        mr = MultiRobotMapping(params, world, start_poses=starts, device=dev,
                               **BACKEND_SESSION)
        mr.systems = [System(params, device=dev, seed=r)
                      for r in range(world)]
        _init(mr, seq.camera)
        for k in range(robot_frames):
            for r, o in enumerate(offs):
                mr.input_primary_sensor_data(
                    r, float(seq.stamps[o + k]), seq.left[o + k],
                    seq.right[o + k])
        mr.finish()
        out["reference"] = session_result(
            mr, lambda: mr.close_loops(**BACKEND_LOOPS),
            lambda: mr.optimize(**BACKEND_SOLVE))
    return out


def solver_problems(world, dev):
    """The dryrun's landmark-sharded BA problem (6 poses, 8 landmarks a
    rank) and its edge-sharded pose graph (16 poses, 2 edges a rank)."""
    from .parallel import pose_graph
    from .solver import ba
    from .solver.factors import StereoIntrinsics, project_stereo_point

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    n_pose, n_lm = 6, 8 * world
    intr = StereoIntrinsics(*(t(v) for v in (80.0, 80.0, 48.0, 32.0, 8.0)))
    lm = t(np.stack([np.random.default_rng(2).uniform(-1, 1, n_lm),
                     np.random.default_rng(3).uniform(-1, 1, n_lm),
                     np.random.default_rng(4).uniform(3, 6, n_lm)], -1))
    obs = project_stereo_point(lm, intr)[:, None, :].expand(n_lm, n_pose, 3)
    qid = np.zeros((n_pose, 4), np.float32)
    qid[:, 0] = 1.0
    pose_t = np.zeros((n_pose, 3), np.float32)
    pose_t[:, 2] = 0.01 * np.arange(n_pose)
    link_q = np.zeros((n_pose - 1, 4), np.float32)
    link_q[:, 0] = 1.0
    fixed = np.zeros(n_pose, bool)
    fixed[0] = True
    problem = ba.BAProblem(
        pose_q=t(qid), pose_t=t(pose_t),
        pose_valid=t(np.ones(n_pose, bool), torch.bool),
        pose_fixed=t(fixed, torch.bool), lm_pos=lm,
        lm_valid=t(np.ones(n_lm, bool), torch.bool),
        lm_fixed=t(np.zeros(n_lm, bool), torch.bool), obs=obs.contiguous(),
        obs_mask=t(np.ones((n_lm, n_pose), bool), torch.bool),
        link_q=t(link_q), link_t=t(np.zeros((n_pose - 1, 3), np.float32)),
        link_mask=t(np.zeros(n_pose - 1, bool), torch.bool), intr=intr)
    n, e = 16, 2 * world
    gq = np.zeros((n, 4), np.float32)
    gq[:, 0] = 1.0
    gt = np.zeros((n, 3), np.float32)
    gt[:, 0] = 0.1 * np.arange(n)
    ei = np.arange(e, dtype=np.int32) % (n - 1)
    eq = np.zeros((e, 4), np.float32)
    eq[:, 0] = 1.0
    et = np.zeros((e, 3), np.float32)
    et[:, 0] = -0.1
    gfixed = np.zeros(n, bool)
    gfixed[0] = True
    graph = pose_graph.PoseGraph(
        pose_q=t(gq), pose_t=t(gt), pose_fixed=t(gfixed, torch.bool),
        edge_i=t(ei, torch.int32), edge_j=t(ei + 1, torch.int32),
        edge_q=t(eq), edge_t=t(et), edge_info=t(np.ones(e, np.float32)),
        edge_mask=t(np.ones(e, bool), torch.bool))
    return problem, graph


def run_solvers(group, dev):
    """Section d: each sharded solve and the one-rank solve on this card."""
    import torch.distributed as dist

    from .parallel import distributed_ba, pose_graph
    from .parallel.mesh import edge_mesh, landmark_mesh
    from .solver import ba

    problem, graph = solver_problems(dist.get_world_size(group), dev)
    settings = ba.BASettings(iterations=2)
    out = {}
    for name, g in (("sharded", group), ("one_rank", None)):
        q, t, chi2 = pose_graph.optimize(graph, edge_mesh(g), iterations=2,
                                         cg_iters=8)
        res = distributed_ba.distributed_local_optimize(
            problem, settings, landmark_mesh(g))
        out[name] = {k: v.cpu().numpy() for k, v in dict(
            graph_q=q, graph_t=t, graph_chi2=chi2, ba_q=res.pose_q,
            ba_t=res.pose_t, ba_lm=res.lm_pos, ba_outliers=res.outliers,
            ba_chi2=res.chi2, ba_ok=res.ok).items()}
    return out


def rank_main(rank, world, port, cfg, queue):
    """One rank: its card (set before any state is built), the process
    group, sections a-d; its report, or the error it raised, goes on the
    queue."""
    import torch.distributed as dist

    from .io.sim import cached_textured_sequence
    from .parallel.mesh import fleet_mesh, initialize_multihost

    torch.set_num_threads(1)
    try:
        cuda = cfg["device"] == "cuda"
        if cuda:
            torch.cuda.set_device(rank)
            dev = torch.device("cuda", rank)
        else:
            dev = torch.device("cpu")
        initialize_multihost(f"tcp://127.0.0.1:{port}", world, rank,
                             backend="nccl" if cuda else "gloo",
                             timeout_s=RANK_TIMEOUT_S,
                             device_id=dev if cuda else None)
        group = dist.group.WORLD
        mesh = fleet_mesh(group)
        seqs = {name: cached_textured_sequence(
            cache_dir=cfg["cache_dir"], device=str(dev), **kw)
            for name, kw in scenes(cfg["width"], cfg["height"]).items()}
        offs_a, offs_b, _ = stream_offsets(world, cfg["frames"])
        out = dict(rank=rank, device=str(dev), card=(
            torch.cuda.get_device_name(dev) if cuda else None))
        out["a"] = run_stream(mesh, dev, seqs["bench"],
                              bench_params(cfg["width"]), rank, offs_a[rank],
                              cfg["frames"], {}, laser=False)
        out["b"] = run_stream(mesh, dev, seqs["s3"],
                              mapping_params(cfg["width"]), rank,
                              offs_b[rank], cfg["frames"], S3_SYSTEM,
                              laser=True)
        out["c"] = run_mapping(group, dev, seqs["backend"],
                               bench_params(cfg["width"]),
                               cfg["robot_frames"])
        out["d"] = run_solvers(group, dev)
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException as e:  # noqa: BLE001 — reported, then re-raised
        queue.put((rank, f"{type(e).__name__}: {e}\n"
                         f"{traceback.format_exc()}"))
        raise


def spawn_ranks(world, cfg):
    """Run rank_main on ``world`` spawned processes; returns their reports
    by rank.  A rank that raises, dies or outlasts RANK_TIMEOUT_S raises
    here, and every rank still running is killed."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, cfg, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    reports, failed = {}, True
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(reports) < world:
            try:
                rank, out = queue.get(timeout=5.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in reports]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       "report")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"the ranks ran past {RANK_TIMEOUT_S} s")
                continue
            if isinstance(out, str):
                raise RuntimeError(f"rank {rank}: {out}")
            reports[rank] = out
        failed = False
    finally:
        for p in procs:  # the others may wait in a collective: no grace
            p.join(timeout=0 if failed else 60)
            if p.is_alive():
                p.kill()
                p.join()
    return reports


# --- the parent: the gates and the report ------------------------------------

def _stream_gates(ranks, world, counted):
    """Section a's or b's gates and numbers from the ranks' reports."""
    timed = ranks[0]["frames"] - 2
    gates = {
        "rows bit-equal to single Systems": all(r["bit_equal"]
                                                for r in ranks),
        "gathered outputs identical on every rank": all(
            same(r["outputs"][f], ranks[0]["outputs"][f])
            for r in ranks for f in ranks[0]["outputs"]),
        f"2 lk_pyramid {counted} a frame, 0 of every other entry": all(
            r["launches"].get(name, 0) == ON_THE_PATH.get(name, 0) * timed
            for r in ranks for name in ENTRIES),
        f"ATE <= {ATE_GATE} m": all(r["ate"] <= ATE_GATE for r in ranks),
        "0 lost": all(r["lost"] == 0 for r in ranks),
    }
    if ranks[0]["syncs"] is not None:
        gates["0 host syncs in the timed loop"] = all(r["syncs"] == 0
                                                      for r in ranks)
    if "map_failures" in ranks[0]:
        gates["the map gate"] = all(not r["map_failures"] for r in ranks)
    elapsed = max(r["elapsed_s"] for r in ranks)
    gather = [r["gather_ms"] for r in ranks]
    numbers = dict(
        offsets=[r["offset"] for r in ranks], timed_frames=timed,
        elapsed_s=elapsed, fps_aggregate=world * timed / elapsed,
        gather_device_ms_per_frame=(None if gather[0] is None
                                    else float(np.mean(gather))),
        ate=[r["ate"] for r in ranks], lost=[r["lost"] for r in ranks],
        launches=[r["launches"] for r in ranks],
        syncs=[r["syncs"] for r in ranks],
        first_diff=[r["first_diff"] for r in ranks if r["first_diff"]],
        sync_messages=[m for r in ranks for m in r["sync_messages"]])
    if "map_rows" in ranks[0]:
        numbers["map"] = [r["map_rows"] for r in ranks]
        numbers["map_failures"] = [r["map_failures"] for r in ranks]
    return gates, numbers


def _mapping_gates(ranks, world):
    ref = ranks[0]["reference"]
    gaps, words = [], []
    for r in ranks:
        words.append(sum(words_differing(a, b) for a, b in zip(
            r["optimized_qt"], ref["optimized_qt"]))
            + words_differing(r["chi2"], ref["chi2"]))
        got = r["optimized"]
        if len(got) != len(ref["optimized"]):
            gaps.append((np.inf, np.inf))
            continue
        g = [rel_gap(a, b) for a, b in zip(got, ref["optimized"])]
        gaps.append((max((x[0] for x in g), default=0.0),
                     max((x[1] for x in g), default=0.0)))
    gates = {
        "keyframes, nodes, edges and closures identical to "
        "MultiRobotMapping's": all(
            r["keyframes"] == ref["keyframes"]
            and same(r["graph"], ref["graph"])
            and r["edges_before"] == ref["edges_before"]
            and r["added"] == ref["added"] and r["edges"] == ref["edges"]
            and r["cross"] == ref["cross"] for r in ranks),
        "poses and chi2 after optimize bit-equal to MultiRobotMapping's":
        all(w == 0 for w in words),
        "two sharded solves bit-equal, two one-rank solves bit-equal": all(
            r["sharded_repeat_words"] == 0
            and r["one_rank_repeat_words"] == 0 for r in ranks),
        "the sharded solve bit-equal to the one-rank solve": all(
            r["sharded_words"] == 0 for r in ranks),
        "every rank holds the same graph": all(
            same(r["optimized"], ranks[0]["optimized"])
            and r["edges"] == ranks[0]["edges"] for r in ranks),
        "chi2 finite": all(np.isfinite(r["chi2"]) for r in ranks),
    }
    if world >= 2:
        gates[">= 1 cross-robot closure"] = all(r["cross"] >= 1
                                                for r in ranks)
    if ranks[0]["solve_syncs"] is not None:
        gates["0 host syncs in one verify_loop and in one solve"] = all(
            r.get("verify_syncs") == 0 and r["solve_syncs"] == 0
            for r in ranks)
    meas = [r["measurements"] for r in ranks]
    numbers = dict(
        closure_measurements_gap=max(
            (float(np.abs(m - ref["measurements"]).max()) if m.shape
             == ref["measurements"].shape else float("inf")) for m in meas),
        sharded_vs_one_rank_solve=[max(r["sharded_gap"][i] for r in ranks)
                                   for i in range(2)],
        sharded_vs_one_rank_words=[r["sharded_words"] for r in ranks],
        sharded_solve_repeat_words=[r["sharded_repeat_words"]
                                    for r in ranks],
        one_rank_solve_repeat_words=[r["one_rank_repeat_words"]
                                     for r in ranks],
        words_differing_from_multi_robot_mapping=words,
        offsets=ranks[0]["offsets"], frames_a_robot=ranks[0]["frames"],
        keyframes=ranks[0]["keyframes"], reference_keyframes=ref[
            "keyframes"], closures=ranks[0]["added"],
        cross_robot=ranks[0]["cross"], verified=ranks[0]["verified"],
        chi2=ranks[0]["chi2"], reference_chi2=ref["chi2"],
        max_pose_gap_m=max(g[0] for g in gaps),
        max_pose_gap_rad=max(g[1] for g in gaps),
        vo_s=max(r["vo_s"] for r in ranks),
        close_s=max(r["close_s"] for r in ranks),
        solve_s=max(r["solve_s"] for r in ranks),
        launches=[r["launches"] for r in ranks],
        verify_syncs=[r.get("verify_syncs") for r in ranks],
        solve_syncs=[r["solve_syncs"] for r in ranks])
    numbers["close_and_solve_s"] = numbers["close_s"] + numbers["solve_s"]
    return gates, numbers


def _solver_gates(ranks):
    gap = {k: max(float(np.abs(r["sharded"][k] - r["one_rank"][k]).max())
                  for r in ranks)
           for k in ("graph_q", "graph_t", "ba_q", "ba_t", "ba_lm")}
    graph_words = [sum(words_differing(r["sharded"][k], r["one_rank"][k])
                       for k in ("graph_q", "graph_t", "graph_chi2"))
                   for r in ranks]
    gates = {
        "the pose graph's poses and chi2 bit-equal to the one-rank solve's":
        all(w == 0 for w in graph_words),
        f"the BA's poses within {SOLVER_POSE_BOUND} of the one-rank solve":
        all(gap[k] <= SOLVER_POSE_BOUND for k in ("ba_q", "ba_t")),
        f"landmarks within {LANDMARK_BOUND} m": gap["ba_lm"]
        <= LANDMARK_BOUND,
        "ok, outliers identical, chi2 finite": all(
            bool(r["sharded"]["ba_ok"]) and same(
                r["sharded"]["ba_outliers"], r["one_rank"]["ba_outliers"])
            and np.isfinite(r["sharded"]["graph_chi2"])
            and np.isfinite(r["sharded"]["ba_chi2"]) for r in ranks),
        "every rank the same": all(
            same(r["sharded"][k], ranks[0]["sharded"][k])
            for r in ranks for k in ranks[0]["sharded"]),
    }
    return gates, dict({f"max_gap_{k}": v for k, v in gap.items()},
                       graph_words_differing=graph_words)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()


def run(world, device="cuda", width=640, height=480, frames=40,
        robot_frames=None, cache_dir=None):
    """Bring up ``world`` ranks and run sections a-d, printing a line a
    section; returns the report (its "ok" says whether every gate
    held)."""
    from .io.sim import cached_textured_sequence, sim_cache_file
    from .ops.kernels import edge_products, lk_level, segment_sum

    log = functools.partial(print, flush=True)
    if world < 1:
        raise ValueError(f"multichip: a world of {world}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multichip: device 'cuda' requested but CUDA "
                               "is not available")
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"multichip: {world} ranks need {world} "
                               f"cards, {torch.cuda.device_count()} visible")
    elif device != "cpu":
        raise ValueError(f"multichip: unsupported device {device!r}")
    if not 3 <= frames <= S3_FRAMES:
        raise ValueError(f"multichip: --frames {frames} outside [3, "
                         f"{S3_FRAMES}]")
    robot_frames = robot_frames or BACKEND_FRAMES // world
    if not 1 <= robot_frames <= BACKEND_FRAMES // world:
        raise ValueError(f"multichip: --robot-frames {robot_frames} outside "
                         f"[1, {BACKEND_FRAMES // world}]")
    cache_dir = str(cache_dir or _build.BUILD_DIR.parent / "sim_cache")
    t0 = time.perf_counter()
    if device == "cuda":  # once here, not once a rank
        for kernel in (lk_level, segment_sum, edge_products):
            kernel.build()
    for kw in scenes(width, height).values():
        if not os.path.exists(sim_cache_file(cache_dir, **kw)):
            cached_textured_sequence(cache_dir=cache_dir, device=device, **kw)
    log(f"multichip: K1, K3 and K4 built and the scenes in the cache in "
        f"{time.perf_counter() - t0:.1f} s; {world} rank(s) on {device} "
        f"({'NCCL, one card a rank' if device == 'cuda' else 'gloo'}), "
        f"{width}x{height}, {frames} frames in a and b, {robot_frames} a "
        "robot in c")
    cfg = dict(device=device, width=width, height=height, frames=frames,
               robot_frames=robot_frames, cache_dir=cache_dir)
    t0 = time.perf_counter()
    reports = spawn_ranks(world, cfg)
    ranks = [reports[r] for r in range(world)]
    counted = "launches" if device == "cuda" else "calls"
    sections = {}
    for name, (gates, numbers) in (
            ("a", _stream_gates([r["a"] for r in ranks], world,
                                counted)),
            ("b", _stream_gates([r["b"] for r in ranks], world,
                                counted)),
            ("c", _mapping_gates([r["c"] for r in ranks], world)),
            ("d", _solver_gates([r["d"] for r in ranks]))):
        sections[name] = dict(gates=gates, **numbers)
        log(f"multichip {name}: " + "; ".join(
            f"{g} {'held' if ok else 'FAILED'}" for g, ok in gates.items()))
        log(f"multichip {name} numbers: " + json.dumps(
            {k: v for k, v in numbers.items() if k not in ("map",)},
            default=float))
    for r, m in enumerate(sections["b"].get("map", [])):
        log(f"multichip b map, rank {r}: " + "; ".join(m))
    k1 = sum(s["launches"][r]["lk_pyramid"] for s in (
        sections["a"], sections["b"], sections["c"]) for r in range(world))
    report = dict(
        world=world, device=device,
        backend="nccl" if device == "cuda" else "gloo",
        cards=[r["card"] for r in ranks], width=width, height=height,
        seconds=time.perf_counter() - t0, k1_pyramid_launches=k1,
        sections=sections, ok=all(all(s["gates"].values())
                                  for s in sections.values()))
    if device == "cuda":
        report["nvidia_smi"] = nvidia_smi()
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, required=True,
                    help="ranks: one card each on cuda")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL, one card a rank; cpu: gloo ranks")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--frames", type=int, default=40,
                    help="frames a stream in sections a and b")
    ap.add_argument("--robot-frames", type=int, default=None,
                    help="frames a robot in section c (240 / world)")
    ap.add_argument("--cache-dir", default=None,
                    help="the sim cache (build/sim_cache)")
    args = ap.parse_args(argv)
    report = run(args.world, args.device, args.width, args.height,
                 args.frames, args.robot_frames, args.cache_dir)
    print(json.dumps(report, default=float))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
