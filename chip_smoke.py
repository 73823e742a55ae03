"""Smoke run of visfs_tpu_torch on one NVIDIA GPU: build, kernels, main paths.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero without the final
``ok`` line):
  1. device   — require CUDA (no CPU fallback), print the card's name and
                power limit, turn TF32 off;
  2. build    — compile the CUDA kernels from visfs_tpu_torch/csrc (K1, K2,
                K3, the pose graph's fixed-order per-pose sum, and K4, its
                per-edge products in one order), one nvcc per source, all
                started together; ptxas registers/spills;
  3. k1       — the LK kernel (K1) against its plain PyTorch versions on
                a 640x480 textured pair, N = 120 and N = 240 features:
                its one-level entry on each of the four pyramid levels
                (flow within 0.05 px, ok identical, min_eig rtol 1e-3),
                and its pyramid entry, one bidirectional track over all
                levels per launch (points within 0.05 px, status
                identical, err rtol 1e-3), and one-way (FlowBack off, as
                configs/sim_localization.yaml runs it) at N = 200 and 400,
                the temporal and stereo tracks at its 200 features, with
                the same gates; the kernel's device time per launch
                (median of a torch.profiler trace), the CUDA-event time of
                a wrapper call and of the plain version, and the bound of
                each launch; and the device time of one step (the
                one-level entry at level 0 with eps = 0, run for 1 and for
                30 steps); and with the fleet's stream axis: 8 streams
                (bench.py phase 3's offsets, each its own frame pair) of
                N = 120 and 240 in one launch, bidirectional: one launch
                through the op under torch.func.vmap, bit-equal to 8
                single launches and to the direct batched launch, the
                plain version's gates per stream, device time beside one
                stream's launch, the bound the sum of the streams' work;
  4. k2       — the xcorr loop kernel (K2) against its plain versions on
                the same pair and points: its one-level entry on the maps
                and scalars of the real jnp level setup, all four levels
                (flow within 2e-3 px, inactive features bit-equal to
                flow_in), and its pyramid entry, one bidirectional track in
                correlation form over all levels per launch, setup and maps
                included (points within 0.01 px, status identical, err
                rtol 1e-3); times and bounds as for k1, a probe of the
                pyramid entry with eps = 1e9 (one step a running level:
                the setup-plus-maps share of the launch), and the time of
                a grouped float32 conv2d computing the level-0 maps (a
                yardstick of the map stage; the port never calls it); and
                k1's 8-stream rows (gate 0.01 px);
  5. main     — the stereo VO main path: System(bench parameters,
                device="cuda") over the first MAIN_FRAMES (120) frames of
                the 300-frame 640x480 textured square loop rendered on the
                card (with its depth, for phase rgbd), frames 0-1 then a
                timed loop over frames 2-119; gate ATE <=
                0.15 m, 0 lost, 2 launches of K1's pyramid entry (the
                temporal and the stereo track), 0 of its one-level entry
                and 0 of either K2 entry per frame, 0 host syncs; fps and a
                stage split; then (profile) frames 2-11 of a fresh System
                with profile_stages=True, each step as four synced stages,
                the medians of the time_* fields printed, not gated;
  6. xcorr    — the loop's first 24 frames with lk_params backend="jnp",
                iter_mode="xcorr" (the jnp level in correlation form): the
                same gates with 2 launches of K2's pyramid entry, 0 of its
                one-level entry and 0 of either K1 entry per frame;
  6b. fleet   — bench phase 3 (bench.py:160-187): FleetSystem(bench
                parameters, 8 streams) on "cuda", 8 frames a stream from
                offsets (k * 7) mod 260 of the main loop, frames 0-1 then
                a timed loop over 2-7: exactly 2 K1 pyramid launches a
                fleet frame for all 8 streams and 0 of every other entry,
                0 host syncs, each stream's ATE <= 0.15 m and 0 lost; a
                second pass bit-equal; streams 0 and 7 against Systems of
                seeds 0 and 7, each frame stepped from the fleet's stream
                state (1e-3 m, 1e-3 rad, identical lost flags); printed:
                stream 0's System free running (the vmapped reductions
                reassociate, and 8 frames amplify it), the aggregate fps
                and its ratio to main's, kernels and kernel time a fleet
                frame (profiler) beside one stream's;
  7. s3       — the reference bench's phase 4 (bench.py:187-262) at full
                width: SensorStrategy 3 (stereo, laser, wheel, submap
                building) over the first S3_LOOP_FRAMES (60) frames of the
                120-frame 640x480 textured square loop (seed 1, 180-beam
                scans) rendered on the card, two 256x256 submap slots, 256
                scan points, 520 raycast samples; each frame's wheel rows in
                one batch before the frame and its scan; frames 0-1 then a
                timed loop over frames 2-59; gate
                ATE <= 0.15 m, 0 lost, 2 launches of K1's pyramid entry and
                0 of every other kernel entry per frame, 0 host syncs, and
                the map (a live slot; the matching grid occupied within a
                3x3 neighbourhood of every wall probe inside it, free at the
                free-space probes); fps, a stage split, the submap
                insertion's device time per call (profiler) and the kernels
                a frame at strategies 0 and 3 (profiler);
  7b. s4     — phase s3's point at SensorStrategy 4 (the laser's
                occupied-space terms in the BA, wheel rows, the submaps)
                over the whole 120-frame loop, free running: ATE <=
                S4_ATE_BOUND (the JAX package's one-ulp band, which
                straddles 0.15 m), 0 lost, 0 host
                syncs, 2 launches of K1's pyramid entry a frame and 0 of
                every other entry, finite poses, and phase s3's map probes
                but the one the JAX package's own map fails here
                (S4_MAP_EXEMPT); the JAX package's figures printed.  It
                runs in a process of its own (`chip_smoke.py --s4
                CACHE_DIR`) beside phases 11 to 12b, as phase dp does;
  8. mapping  — configs/sim_mapping.yaml's visfs block verbatim
                (SensorStrategy 3 with CLAHE, NumRangeDataLimit 60,
                MaxLaserRange 30) over the first 24 frames of phase s3's
                sequence and feed, with phase s3's gates;
  9. loc_cull — configs/sim_localization.yaml's visfs block verbatim
                (FlowBack off, 200 features) with Tracker/
                CullByFundationMatrix and FundationPixelError 2.0 over the
                main loop's first 24 frames: ATE <= 0.15 m, 0 lost,
                exactly 2 one-way launches of K1's pyramid entry a frame
                and 0 of every other entry, 0 host syncs (the cull's
                sync-free eigensolvers); the features the cull rejects
                each frame printed;
 10. rgbd     — the bench parameters with SensorStrategy 1, fed the left
                images and the ray-cast depth of the main loop's first 24
                frames: ATE <= 0.15 m, 0 lost, exactly 1 (bidirectional)
                launch of K1's pyramid entry a frame (the temporal track;
                depth replaces the stereo track) and 0 of every other
                entry, 0 host syncs;
 11. small    — the System on "cuda" and "cpu" over 6 frames at 160x120 (the
                "cpu" runs in a process of their own, `chip_smoke.py
                --small-cpu CACHE_DIR PATH`, beside the "cuda" runs), at
                K1 (the System's default), xcorr, and the reference System's
                own LK configuration (backend="jnp", direct iteration),
                SensorStrategy 1 on the ray-cast depth, CLAHE, and
                configs/sim_localization.yaml's block (its MinDistance
                scaled to the width) without and with the cull: per frame
                translation within 1e-3 m, yaw within 1e-3 rad, inliers
                within 1, identical lost flags.  The same free running at
                strategies 2 (wheel rows) and 3 (wheel rows and scans;
                also with CLAHE), and at 3 then identical slot_valid,
                num_range_data and finished, max_xy within 1e-4 m, at most
                0.1 % of the known cells different.  Free running,
                float-level noise moves the reference itself by
                centimetres at strategy 4 and decimetres at 5
                (reference_laser_noise.py), so there each frame is stepped
                on "cuda" from the "cpu" run's state: at 4 (wheel rows and
                scans) held as 3 is; at 5 (scans, no wheel rows: PnP and
                the laser-only BA) inliers within 1 and identical lost
                flags (where they differ, "cuda"'s (inliers, lost) must be
                that of a "cpu" step under one of 16 random one-ulp nudges
                of its state, and what follows is held against the first
                such step, tests/test_torch_s5_edge.py), the BA problems
                within 1e-3 m and 1e-3 rad and their cost grids identical,
                the "cpu" problem solved in float64 on both devices within
                1e-3 m and 1e-3 rad, the "cpu" step's submap insertion
                replayed on "cuda" within the submap gates, slots, counts
                and finished flags identical; the float32 gaps (the step's,
                the same problem solved on both devices, the "cpu" solve
                under one ulp of the problem) and the cells printed.  Then
                clahe itself on "cuda" against "cpu" on one 640x480 frame,
                within 1e-3 levels;
 12. cull     — cull_with_fundamental on "cuda" against "cpu" on
                tests/test_fundamental.py's outlier scene and key (seed 42,
                20 gross outliers of 120, key 0, threshold 1.5, 64
                hypotheses): identical inlier masks, every gross outlier
                rejected;
 12b. render — the CUDA render held against the CPU render: frames 0, 1
                and the last of the bench loop (with depth), phase s3's
                laser loop (with scans) and phase backend's loop, both
                views ray-cast on "cuda" and "cpu"; the differing pixels,
                depths and beams and the largest |d| printed;
 13. backend  — the mapping back-end: MultiRobotMapping with two robots
                (bench parameters, one System each, K1) on a 240-frame
                640x480 textured square loop (seed 11, two laps), robot 0
                over frames 0-59 of the first lap, robot 1 over frames
                120-179 of the second from its true start pose there,
                close_loops(radius 2.5, min_gap 8, min_inliers 10) and
                optimize(10 steps, 60 CG iterations): each robot's VO ATE
                <= 0.15 m and 0 lost, exactly 2 launches of K1's pyramid
                entry a frame and 0 of every other entry, >= 3 keyframes a
                robot, >= 1 cross-robot closure (the JAX package finds 7
                here), 0 host syncs in one verify_loop call and in one
                pose-graph solve, chi2 finite and lower after the solve,
                the keyframe error after it within 0.15 m; every decided
                pair's verify_loop on "cpu" from the same snapshots and
                keys (ok identical, inliers within 1, rel within 1e-3 m
                and 1e-3 rad) and the solve on "cpu" (poses within 1e-4 m
                and 1e-4 rad); every solve in PyTorch's default mode, the
                sync probe's, the profiled one and MultiRobotMapping.
                optimize's bit-equal, with exactly 10 x (60 + 3) launches
                of K3 and as many of K4 in optimize; keyframes,
                candidates, closures, chi2 and the keyframe error before
                and after, the times and kernels (profiler) of
                close_loops, one verify_loop and optimize (beside the
                solve's kernels before K4) printed.  Then K3 against its
                plain version at the solve's shapes (the first
                Gauss-Newton step's terms of the session's graph, [E, 2,
                6] and [E, 2, 6, 6]): bit-equal to index_add_ on "cpu"
                (tolerance 0), its gap to index_add_ on "cuda" (atomic
                order) printed, its device time, the plain version's, one
                index_add_'s and the bound; and K4 on that step's inputs
                (its gradient, blocks and the CG's matvec): bit-equal to
                its order oracle on "cpu" (tolerance 0), each block of
                256, 128 and 64 rows launched alone bit-equal to the
                whole launch's rows (tolerance 0), the words differing
                from the einsums on "cpu" (0 expected) and the largest
                difference from the einsums on "cuda" (cuBLAS) printed,
                its device time, the plain version's, the einsums' and
                the bound.  K3's and K4's device times come from one
                fresh process (chip_smoke.py --solve-device-us PATH).
 14. node     — the node (the robot's way of running the system, the
                reference's ROS node): configs/sim_mapping.yaml's whole
                operating point (node block: approx sync, queue 10, slop
                0.01; visfs block) through VISFSAdapter with the native
                sync runtime over a StaticTransport on "cuda", the frame
                tree the sequence's own (identity) extrinsics, the baseline
                from the camera info; the first 24 frames of phase s3's
                sequence injected from the main thread as host numpy in
                stamp order (wheel rows, scan, left, right) with
                back-pressure (the next frame only while the synced queue
                holds fewer than 9), spin_once draining, the runtime's C++
                worker stepping the System: ATE <= 0.15 m and 0 lost over
                frames 2-23, phase s3's map gate, exactly 2 launches of K1's
                pyramid entry a frame and 0 of every other entry, synced =
                processed = 24 and nothing dropped, 24 odom and odom_info
                published, the odometry buffer's head equal to the wheel
                rows injected, 0 host syncs in one input of host numpy
                frames, wheel rows and scan (a probe System), save_system ->
                restore_system into a fresh System and 5 more frames on
                both bit-equal, render_frame and render_submap shapes; fps,
                the enqueue-to-publish latency p50/p99 and the runtime's
                last_latency_ms printed.  Phase backend also saves its
                session's back-end (save_mapping), restores it into a fresh
                MappingBackend and solves both graphs once in the default
                mode: bit-equal.
 15. dp       — the port's multi-card entry (visfs_tpu_torch.multichip, the
                twin of __graft_entry__.dryrun_multichip) at min(4, cards)
                ranks over NCCL, one card a rank, spawned as `python -m
                visfs_tpu_torch.multichip --world N` spawns them, at
                640x480: dp_fleet_step at strategy 0 (the bench loop) and
                at 3 (configs/sim_mapping.yaml's block on phase s3's
                sequence, scans and wheel rows), DP_FRAMES frames a stream,
                each row bit-equal to a single System of its seed on the
                same card, the gathered outputs identical on every rank,
                exactly 2 launches of K1's pyramid entry a timed frame and 0
                of every other entry, 0 host syncs, ATE <= 0.15 m and 0
                lost, phase s3's map gate at 3; FleetMapping over phase
                backend's scene, DP_ROBOT_FRAMES frames a robot, held
                against MultiRobotMapping (keyframes, nodes, edges and
                closures identical, poses and chi2 after optimize
                bit-equal, two sharded solves and two one-rank solves each
                bit-equal and the sharded solve bit-equal to the one-rank
                solve, all in the default mode, >= 1 cross-robot closure
                with 2 ranks or more, 0 host syncs in one verify_loop and
                one solve); the dryrun's edge-sharded pose graph bit-equal
                to the one-rank solve and its landmark-sharded BA within
                1e-5 (landmarks 2.1e-4 m) of it; the aggregate
                fps, the gather's device ms a frame and the close-and-solve
                seconds printed.  Its K1 launches join the kernels line's.
                It runs beside phases 11 to 12b and phase s4 (its ranks are
                processes of their own and phases 11 to 12b time nothing),
                so its fps and seconds are taken with them running.
Each phase's seconds are printed, and the profiler traces each kernel row
took (a trace may come back without its device records).  The kernels JSON
line, the nvidia-smi line and the final {"ok": true, "device": ...} line
close the output.

A kernel's "ms" (device time), "plain_ms" and "bound_ms" in the kernels
line are one frame's worth of its launches: for each of K1 and K2, its
path's two pyramid launches, one at N = 120 plus one at N = 240; for K3,
one solve's: 10 x 62 launches at [N, 6] and 10 at [N, 6, 6], with its
"library_ms" one index_add_ over the 2E endpoints a launch; for K4, one
solve's: 10 gradient, 10 blocks and 10 x 61 matvec launches at E = 512,
with its "library_ms" the einsums each launch replaces (torch.einsum on
the card, cuBLAS) and its bound the live edges' Jacobians, residuals or
gathered x, every weight and the output, once each.  The k1
and k2 lines also give one frame's worth of each one-level entry (16
launches: the (N, level) cases, each twice).  A bound counts the bytes the
launch's inputs need once each: the pixels of the patches K1 samples and
the map taps K2's one-level entry looks up along the plain version's
trajectory on the same inputs (not the whole planes or maps), the vectors
and the outputs; and the operations of the steps the features ran.  A
pyramid launch reads six planes a level (from, to and the gradients of both
pyramids): its bound counts each plane's pixels once, the union of what
both directions read in it (K1: the setup and step patches; K2: the setup
patches and the `to` pixels under the map taps its steps look up), the
setup of the features whose level result the track uses (the active ones,
and every feature at the forward level 0, whose min_eig is err), K2's map
taps that its steps look up (not the whole maps the kernel builds), the
steps, and each vector and output once.
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

N_FRAMES = 300
# The depths below were cut for the script's time: at main 2.16 fps (an
# H100 at 700 W) the whole script took 827.3 s, and over 1,200 s on a
# slower host; the slowest host seen ran main at 1.33 fps.
# Phase main drives the loop's first MAIN_FRAMES frames (its first two
# corners, 24 m of the 39.4 m lap), 300 until then.
MAIN_FRAMES = 120
S3_FRAMES = 120  # bench.py phase 4 (VISFS_BENCH_S3_FRAMES default)
# Phase s3 drives the first S3_LOOP_FRAMES frames of that loop (its first
# straight and corner), S3_FRAMES until then; phase s4 keeps S3_FRAMES,
# where the JAX package's band it is held to was taken.
S3_LOOP_FRAMES = 60
S3_SCAN_CAPACITY = 256
# Phase s4 is phase s3's point at strategy 4.  Frame 1 has no wheel link,
# so the laser terms alone fill the Hessian's out-of-plane dofs, which the
# reference's autodiff leaves at float32 residues: its step there is huge,
# the step guard drops it, and frame 1 stays at frame 0's pose, 0.200 m
# from the truth (the port takes the Jacobian the same way).  From there
# one ulp of the state moves the ATE: the JAX package on the CPU 0.1445 m
# unperturbed and 0.1460-0.1692 m over 16 runs nudged by one ulp before
# every frame from frame 1 (reference_s3_ate.py --strategy 4
# --nudge-seeds 16), 12 of them above bench.py's 0.15 m.  So the ATE is
# held to the top of that band and ~6 mm, S4_ATE_BOUND, which the port's
# former closed-form Jacobian (0.1843 m on the CPU, 0.1848 m on the card)
# failed; and the map to phase s3's probes but the far wall level with the
# matching submap's origin, which the JAX package's own map fails here
# (0.100; reference_s3_ate.py --strategy 4 --submaps-out, then
# tools/torch_s3_ate.py --probe-submaps).
S4_ATE_BOUND = 0.175
S4_MAP_EXEMPT = ("wall 15.50,",)
S4_REFERENCE = ("ATE 0.1445 m, 0 lost of 118; 0.1460-0.1692 m with one ulp "
                "of its state nudged (16 seeds); the far-wall probe failing")
WIDTH, HEIGHT = 640, 480
S3_RENDER = dict(n_frames=S3_FRAMES, width=WIDTH, height=HEIGHT,
                 motion="square", seed=1, speed=2.0, with_laser=True,
                 n_beams=180)  # bench.py:199-204
ATE_GATE = 0.15
# NVIDIA H100 SXM, published dense peaks (NVIDIA data sheet, no sparsity):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Arithmetic per unit of work, counted from the kernels' sources.  K1: a
# bilinear sample is 4 multiplies + 3 adds; the setup samples 3 planes and
# adds 3 products to G per sample (27), a step samples `to` and adds the
# difference's 2 products (12).  K2: ~40 per feature-step (clamps, floors,
# 2 four-tap lookups, G^-1 b, the update and the eps test); its pyramid
# entry's setup samples 3 planes and adds 5 products (G, c1, c2) per sample
# (31), and a map tap (a, b) that a step looks up takes 2 FMAs (C1 and C2)
# per (p, q).
K1_SETUP_FLOPS_PER_SAMPLE = 27
K1_STEP_FLOPS_PER_SAMPLE = 12
K2_STEP_FLOPS = 40
K2_SETUP_FLOPS_PER_SAMPLE = 31
K2_MAP_FLOPS_PER_TERM = 4
XCORR = dict(backend="jnp", iter_mode="xcorr")
CULL = {"Tracker/CullByFundationMatrix": True,
        "Tracker/FundationPixelError": 2.0}  # tests/test_fundamental.py:80
# phase xcorr's depth (the main loop's first frames): 80 since phase fleet
# joined (with it at 120 the whole script took 948.5 s of its 1,200 s), 60
# since phase dp joined, 40 since phase s4 joined (with these four depths
# cut the script took 649.7 s at main 1.89 fps; given back, with xcorr at
# 60, the modes and the node at 80 and the fleet at 24, it took 1,303.8 s
# of its 1,200 s on a slower host, main at 1.33 fps), 24 with MAIN_FRAMES
XCORR_FRAMES = 24
# phases mapping, loc_cull, rgbd and node: 80 since phase backend joined
# (with them at 120 the whole script took 865 s of its 1,200 s on an H100),
# 40 since phase s4 joined (the script's time, as XCORR_FRAMES), 24 with
# MAIN_FRAMES
MODE_FRAMES = 24
CLAHE_BOUND = 1e-3  # levels, clahe on "cuda" against "cpu"
# phase small, strategy 5: the one-ulp nudged "cpu" steps tried on a frame
# whose lost flags differ
WITNESS_SEEDS = 16
# bench.py phase 3 (bench.py:160-187): B streams, the streams starting at
# (k * 7) mod (frames - 40) of the loop; FLEET_FRAMES frames a stream, 24
# of bench.py's 40 since phase dp joined (with 40 and phase dp the script
# would outrun its 1,200 s on a slower host), 12 since phase s4 joined (the
# script's time, as XCORR_FRAMES), 8 since K4 joined phase backend (at 12 the
# phase took 80.6 s and the script 1,062.9 s on an H100 whose host ran main
# at 1.59 fps)
FLEET_B = 8
BENCH_FLEET_FRAMES = 40
FLEET_FRAMES = 8
FLEET_COMPARED = (0, 7)  # the streams held against single Systems
# each timed loop's fps by label, for phase fleet's ratio to main's
LOOP_FPS = {}
# phase dp: frames a stream in its sections a and b, frames a robot in c
# (at 24 and 60 the phase took 132-141 s; on one card section c needs no
# cross-robot closure, and 30 frames still give it loop candidates); 8 and
# 24 since phase s4 joined (the script's time, as XCORR_FRAMES)
DP_FRAMES = 8
DP_ROBOT_FRAMES = 24


def bench_params(width):
    """The simMapping operating point of the reference bench (bench.py),
    as the multi-card entry has it."""
    from visfs_tpu_torch.multichip import bench_params as params

    return params(width)


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=20):
    """Median CUDA-event time of fn() over reps launches (after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_device_ms(fn, kernel, reps=20, tries=6):
    """(ms, traces): the median device time of one launch of the CUDA
    kernel whose name holds ``kernel``, from a torch.profiler trace of reps
    calls of fn (kernel time alone: CUDA events around a call also count
    the wrapper's host dispatch, which is longer than these kernels), and
    the traces it took.  A trace may come back without its device records
    (three in a row have); it is taken again after a second's pause, up to
    ``tries`` times.  ms is None when no trace shows the kernel on the
    device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for n in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if us:
            return float(np.median(us)) / 1e3, n
        print(f"profiler: a trace without {kernel} on the device, taken "
              f"again", flush=True)
        time.sleep(1.0)
    return None, tries


# (kernel row, profiler traces it took), for the closing "profiler traces"
# line
TRACES = []


def timed_kernel(label, call, kernel):
    """(kernel ms, call ms): the kernel's device time per launch, and the
    CUDA-event time of one wrapper call (launch and host dispatch)."""
    call_ms = cuda_time_ms(call)
    ms, traces = kernel_device_ms(call, kernel)
    TRACES.append((label, traces))
    if ms is None:
        fail(f"{label}: the profiler trace shows no {kernel} on the device "
             f"in {traces} traces")
    return ms, call_ms


def nbytes(*tensors):
    """The bytes of the tensors, each distinct one once."""
    distinct = {t.data_ptr(): t for t in tensors}
    return sum(t.numel() * t.element_size() for t in distinct.values())


def block_pixels(shape, ix, iy, size, keep):
    """The pixels of an [H, W] plane inside the size x size blocks at
    corners (ix, iy) of the features in keep: an [H, W] bool mask."""
    import torch

    h, w = shape
    taps = torch.arange(size, device=ix.device)
    rows = (iy[keep][:, None] + taps)[:, :, None].expand(-1, -1, size)
    cols = (ix[keep][:, None] + taps)[:, None, :].expand(-1, size, -1)
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    mask = torch.zeros(shape, dtype=torch.bool, device=ix.device)
    mask[rows[inside], cols[inside]] = True
    return mask


def window_pixels(shape, cx, cy, win, keep):
    """The pixels of an [H, W] plane that K1's bilinear win x win patches
    centred at (cx, cy) read for the features in keep ((win+1)^2 each, the
    corner clipped as the kernel clips it): an [H, W] bool mask."""
    import torch

    h, w = shape
    half = win // 2
    ix = torch.clamp(torch.floor(cx - half).long(), 0, w - win - 2)
    iy = torch.clamp(torch.floor(cy - half).long(), 0, h - win - 2)
    return block_pixels(shape, ix, iy, win + 1, keep)


def map_taps(n, a, trail):
    """The taps of K2's [N, A, A] maps that its four-tap lookups read along
    the plain loop's trail (rows floor(offy) + {0, 1}, columns floor(offx) +
    {0, 1}, index A skipped): an [N, A, A] bool mask."""
    import torch

    mask = torch.zeros((n, a, a), dtype=torch.bool, device=trail[0][2].device)
    for offx, offy, run in trail:
        idx = run.nonzero()[:, 0]
        ia = torch.floor(offy[idx]).long()
        ib = torch.floor(offx[idx]).long()
        for da in (0, 1):
            for db in (0, 1):
                mask[idx, torch.clamp(ia + da, max=a - 1),
                     torch.clamp(ib + db, max=a - 1)] = True
    return mask


def bound(n_bytes, flops):
    """(bytes time ms, operations time ms): the least time for the work."""
    return n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3


def frame_totals(rows, times):
    """One frame's sums over a phase's rows (each case ``times`` times) and
    which bound dominates them."""
    tot = {k: times * sum(r[k] for r in rows)
           for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bytes_ms",
                     "ops_ms")}
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                       else "operations")
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return tot


def make_system(System, cam, params, device, lk=None, **kw):
    s = System(params, device=device, **kw)
    if lk:
        s.lk_params = dataclasses.replace(s.lk_params, **lk)
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    return s


def level_inputs(seq, n=240):
    """Pyramids of frames 0 and 1 and n GFTT corners of frame 0."""
    import torch

    from visfs_tpu_torch.ops.gftt import gftt_detect
    from visfs_tpu_torch.ops.lk import LKParams, build_lk_pyramid

    params = LKParams()
    img0 = torch.as_tensor(seq.left[0], device="cuda")
    img1 = torch.as_tensor(seq.left[1], device="cuda")
    pyr0 = build_lk_pyramid(img0, params)
    pyr1 = build_lk_pyramid(img1, params)
    det = gftt_detect(img0, n, 0.01, 10)
    if int(det.valid.sum()) < n:
        fail(f"levels: only {int(det.valid.sum())} corners for N = {n}")
    return params, pyr0, pyr1, det.points


def k1_work(records, win):
    """(bytes, FLOPs) of K1 level runs.  A record is one level in one
    direction: planes (from, to, gx, gy) [H, W], pts [N, 2] at the level's
    scale, setup [N] bool (the features whose G the run needs), steps [N]
    and the step trail of level_steps.  Bytes: per distinct plane, the
    union of the pixels that the records' patches read in it (the setup
    patches in from, gx and gy; the step patches in to).  FLOPs: the setup
    of the setup features and the steps the features ran."""
    import torch

    masks = {}

    def read(plane, mask):
        key = plane.data_ptr()
        masks[key] = masks[key] | mask if key in masks else mask

    area = win * win
    flops = 0
    for r in records:
        img_from, img_to, gx, gy = r["planes"]
        shape = img_from.shape
        src = window_pixels(shape, r["pts"][:, 0], r["pts"][:, 1], win,
                            r["setup"])
        for plane in (img_from, gx, gy):
            read(plane, src)
        dst = torch.zeros(shape, dtype=torch.bool, device=src.device)
        for cx, cy, run in r["trail"]:
            dst |= window_pixels(shape, cx, cy, win, run)
        read(img_to, dst)
        flops += (int(r["setup"].sum()) * area * K1_SETUP_FLOPS_PER_SAMPLE
                  + int(r["steps"].sum()) * area * K1_STEP_FLOPS_PER_SAMPLE)
    return 4 * sum(int(m.sum()) for m in masks.values()), flops


def xcorr_work(records, win):
    """(bytes, FLOPs, running feature-levels, map taps looked up) of K2
    pyramid level runs.  A record is one level in one direction as
    lk_xcorr_pyramid_reference records it, with used [N] bool added (the
    features whose G the run needs).  Bytes: per distinct plane, the union
    of the pixels that the records read in it: the setup taps in from, gx
    and gy ((win+1)^2 at the first nonzero tent tap), and in `to` the
    pixels under the map taps the steps look up ((win+1)^2 at the region's
    corner + floor(offset), inside the plane).  FLOPs: the setup of the
    setup features, the map taps the steps look up (map_taps; not the whole
    maps, which the kernel builds but the function does not need), the
    steps."""
    import torch

    masks = {}

    def read(plane, mask):
        key = plane.data_ptr()
        masks[key] = masks[key] | mask if key in masks else mask

    area = win * win
    flops = running = taps = 0
    for r in records:
        img_from, img_to, gx, gy = r["planes"]
        h, w = img_from.shape
        pts, half = r["pts"], win // 2
        x0 = torch.clamp(pts[:, 0] - half, 0.0, w - win - 1.0)
        y0 = torch.clamp(pts[:, 1] - half, 0.0, h - win - 1.0)
        six = torch.clamp(torch.floor(x0).long(), 0, w - win - 2)
        siy = torch.clamp(torch.floor(y0).long(), 0, h - win - 2)
        src = block_pixels((h, w), six + torch.floor(x0 - six).long(),
                           siy + torch.floor(y0 - siy).long(), win + 1,
                           r["used"])
        for plane in (img_from, gx, gy):
            read(plane, src)
        origin = r["setup"].origin.long()
        dst = torch.zeros((h, w), dtype=torch.bool, device=src.device)
        for offx, offy, run in r["trail"]:
            dst |= block_pixels(
                (h, w), origin[:, 0] + torch.floor(offx).long(),
                origin[:, 1] + torch.floor(offy).long(), win + 1, run)
        read(img_to, dst)
        n_taps = int(map_taps(len(pts), r["args"][0].shape[-1],
                              r["trail"]).sum())
        running += int(r["args"][10].sum())
        taps += n_taps
        flops += (int(r["used"].sum()) * area * K2_SETUP_FLOPS_PER_SAMPLE
                  + n_taps * area * K2_MAP_FLOPS_PER_TERM
                  + int(r["steps"].sum()) * K2_STEP_FLOPS)
    return (4 * sum(int(m.sum()) for m in masks.values()), flops, running,
            taps)


def phase_k1(seq, lk_mod):
    """K1's two entries against their plain versions at the main path's
    shapes; returns one frame's totals of the pyramid entry."""
    import torch

    params, pyr0, pyr1, points = level_inputs(seq)
    dev = points.device
    kw = dict(win=params.win_size, iterations=params.iterations,
              eps=params.eps, min_eig_threshold=params.min_eig_threshold)
    rows = []
    for n in (120, 240):
        pts = points[:n].contiguous()
        active = torch.ones(n, dtype=torch.float32, device=dev)
        flow = torch.zeros((n, 2), dtype=torch.float32, device=dev)
        for level in range(params.max_level, -1, -1):
            pts_l = (pts / 2.0 ** level + pyr0.pad).contiguous()
            args = (pyr0.levels[level], pyr1.levels[level], pyr0.gx[level],
                    pyr0.gy[level], pts_l, flow.contiguous(), active)
            fk, okk, ek = lk_mod.lk_level_cuda(*args, **kw)
            trail = []
            fp, okp, ep, steps = lk_mod.level_steps(*args, **kw, trail=trail)
            torch.cuda.synchronize()
            err = float((fk - fp).abs().max())
            if not err <= 0.05:
                fail(f"k1 N={n} level {level}: flow max|d| {err:.4g} px")
            if not torch.equal(okk, okp):
                fail(f"k1 N={n} level {level}: ok differs in "
                     f"{int((okk != okp).sum())} features")
            np.testing.assert_allclose(ek.cpu().numpy(), ep.cpu().numpy(),
                                       rtol=1e-3, atol=1e-6)
            ms, call_ms = timed_kernel(
                f"k1 N={n} level {level}",
                lambda: lk_mod.lk_level_cuda(*args, **kw), "lk_level_kernel")
            plain_ms = cuda_time_ms(
                lambda: lk_mod.lk_level_reference(*args, **kw), reps=5)
            n_steps = int(steps.sum())
            # bytes: the level's pixels (ok and min_eig are outputs for
            # every feature, so every feature's setup counts), the vectors
            # and the outputs
            pix_bytes, flops = k1_work(
                [dict(planes=args[:4], pts=pts_l, steps=steps, trail=trail,
                      setup=torch.ones(n, dtype=torch.bool, device=dev))],
                params.win_size)
            n_bytes = pix_bytes + nbytes(*args[4:], fk, okk, ek)
            bytes_ms, ops_ms = bound(n_bytes, flops)
            rows.append(dict(n=n, level=level,
                             plane=list(pyr0.levels[level].shape),
                             max_abs_err=err, ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms,
                             bound_ms=max(bytes_ms, ops_ms),
                             bytes_ms=bytes_ms, ops_ms=ops_ms, bytes=n_bytes,
                             steps=n_steps, max_steps=int(steps.max()),
                             n_ok=int(okp.sum())))
            active = (okp > 0).to(torch.float32) * active
            flow = fp * 2.0 if level > 0 else fp
    for r in rows:
        print("k1 " + json.dumps(r), flush=True)
    tot = frame_totals(rows, 2)
    print(f"k1 level entry: flow max|d| {tot['max_abs_err']:.3g} px over 8 "
          f"(N, level) cases, ok identical; one frame's 16 launches: kernel "
          f"{tot['ms']:.4f} ms, calls {tot['call_ms']:.3f} ms (plain "
          f"{tot['plain_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.5f} ms by {tot['bound_by']})", flush=True)

    # the latency of one step: the one-level entry at level 0, N = 240,
    # with eps = 0, so that every ok feature runs exactly `iterations` steps
    probe = (pyr0.levels[0], pyr1.levels[0], pyr0.gx[0], pyr0.gy[0],
             (points + pyr0.pad).contiguous(),
             torch.zeros((240, 2), dtype=torch.float32, device=dev),
             torch.ones(240, dtype=torch.float32, device=dev))
    lat = {}
    for iters in (1, params.iterations):
        skw = dict(kw, iterations=iters, eps=0.0)
        lat[iters] = timed_kernel(
            f"k1 step probe {iters}",
            lambda: lk_mod.lk_level_cuda(*probe, **skw), "lk_level_kernel")[0]
    step_us = (lat[params.iterations] - lat[1]) * 1e3 / (params.iterations - 1)
    print(f"k1 step latency (level 0, N = 240, eps = 0): "
          f"{lat[1] * 1e3:.2f} us at 1 step, "
          f"{lat[params.iterations] * 1e3:.2f} us at {params.iterations}: "
          f"{step_us:.3f} us per step", flush=True)

    # the pyramid entry: one bidirectional track of N features per launch,
    # seeded at the points themselves (as the stereo track is)
    ptot = k1_pyramid_rows(lk_mod, pyr0, pyr1, points, (120, 240), kw,
                           params.max_level, True)
    # one-way, as FlowBack off runs it (configs/sim_localization.yaml, 200
    # features: the temporal track at N = 200, the stereo track at 400)
    _, pyr0, pyr1, points = level_inputs(seq, 400)
    k1_pyramid_rows(lk_mod, pyr0, pyr1, points, (200, 400), kw,
                    params.max_level, False)
    # the fleet's launch: B streams' tracks in one launch
    batched_pyramid_rows("k1", lk_mod, "lk_pyramid", "lk_pyr_kernel", seq,
                         params, 0.05, k1_records)
    return ptot


def k1_pyramid_rows(lk_mod, pyr0, pyr1, points, sizes, kw, max_level,
                    bidirectional):
    """K1's pyramid entry against its plain version, one track of N
    features per launch for N in sizes, seeded at the points: points within
    0.05 px, status identical, err rtol 1e-3; device, call, plain and bound
    times.  Prints the rows and one frame's totals (one launch a size);
    returns the totals."""
    import torch

    dev = points.device
    pkw = dict(kw, max_level=max_level, bidirectional=bidirectional,
               fb_threshold=1.5)
    way = "bidirectional" if bidirectional else "one-way"
    pyr_rows = []
    for n in sizes:
        pts = points[:n].contiguous()
        args = (pyr0, pyr1, pts, pts,
                torch.ones(n, dtype=torch.bool, device=dev))
        pk, sk, ek = lk_mod.lk_pyramid_cuda(*args, **pkw)
        levels = []
        pp, sp, ep = lk_mod.lk_pyramid_reference(*args, **pkw, levels=levels)
        torch.cuda.synchronize()
        err = float((pk - pp).abs().max())
        if not err <= 0.05:
            fail(f"k1 pyramid {way} N={n}: points max|d| {err:.4g} px")
        if not torch.equal(sk, sp):
            fail(f"k1 pyramid {way} N={n}: status differs in "
                 f"{int((sk != sp).sum())} features")
        np.testing.assert_allclose(ek.cpu().numpy(), ep.cpu().numpy(),
                                   rtol=1e-3, atol=1e-6)
        ms, call_ms = timed_kernel(
            f"k1 pyramid {way} N={n}",
            lambda: lk_mod.lk_pyramid_cuda(*args, **pkw), "lk_pyr_kernel")
        plain_ms = cuda_time_ms(
            lambda: lk_mod.lk_pyramid_reference(*args, **pkw), reps=3)
        # bytes: each plane's pixels once over both directions, the setup
        # of the active features (and of all at the forward level 0, for
        # err), the vectors and outputs once; max_chain_steps: the most
        # steps one feature runs over its levels and directions, the chain
        # of the slowest block
        fwd0 = max_level
        pix_bytes, flops = k1_work(
            [dict(lv, setup=lv["active"] | (k == fwd0))
             for k, lv in enumerate(levels)], kw["win"])
        n_bytes = pix_bytes + nbytes(*args[2:], pk, sk, ek)
        bytes_ms, ops_ms = bound(n_bytes, flops)
        pyr_rows.append(dict(n=n, entry="pyramid", direction=way,
                             levels=len(levels),
                             max_abs_err=err, ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms,
                             bound_ms=max(bytes_ms, ops_ms),
                             bytes_ms=bytes_ms, ops_ms=ops_ms, bytes=n_bytes,
                             steps=sum(int(lv["steps"].sum())
                                       for lv in levels),
                             max_chain_steps=int(sum(
                                 lv["steps"] for lv in levels).max()),
                             n_status=int(sp.sum())))
    for r in pyr_rows:
        print("k1 " + json.dumps(r), flush=True)
    ptot = frame_totals(pyr_rows, 1)
    print(f"k1 pyramid entry, {way}: points max|d| "
          f"{ptot['max_abs_err']:.3g} px at N = "
          f"{' and '.join(map(str, sizes))}, status identical; one frame's "
          f"{len(sizes)} launches: kernel {ptot['ms']:.4f} ms, calls "
          f"{ptot['call_ms']:.3f} ms (plain {ptot['plain_ms']:.3f} ms, bound "
          f"{ptot['bound_ms']:.5f} ms by {ptot['bound_by']})", flush=True)
    return ptot


def phase_k2(seq, k2_mod):
    """K2's two entries against their plain versions at the xcorr path's
    shapes; returns one frame's totals of the pyramid entry."""
    import torch

    from visfs_tpu_torch.ops.lk import LKParams, level_setup, xcorr_inputs

    lk, pyr0, pyr1, points = level_inputs(seq)
    params = LKParams(**XCORR)
    dev = points.device
    rows = []
    for n in (120, 240):
        pts = points[:n].contiguous()
        # every 7th feature inactive at entry: it must keep its flow_in
        active = torch.arange(n, device=dev) % 7 != 0
        flow = torch.zeros((n, 2), dtype=torch.float32, device=dev)
        for level in range(lk.max_level, -1, -1):
            pts_l = pts / 2.0 ** level + pyr0.pad
            s = level_setup(pyr0.levels[level], pyr1.levels[level],
                            pyr0.gx[level], pyr0.gy[level], pts_l, flow,
                            params)
            args, kw = xcorr_inputs(s, pts_l, flow, active, params)
            fk = k2_mod.lk_xcorr_iterate_cuda(*args, **kw)
            trail = []
            fp, steps = k2_mod.xcorr_steps(*args, **kw, trail=trail)
            torch.cuda.synchronize()
            err = float((fk - fp).abs().max())
            if not err <= 2e-3:
                fail(f"k2 N={n} level {level}: flow max|d| {err:.4g} px")
            idle = ~args[10]
            if not torch.equal(fk[idle], args[9][idle]):
                fail(f"k2 N={n} level {level}: an inactive feature moved")
            ms, call_ms = timed_kernel(
                f"k2 N={n} level {level}",
                lambda: k2_mod.lk_xcorr_iterate_cuda(*args, **kw),
                "lk_xcorr_kernel")
            plain_ms = cuda_time_ms(
                lambda: k2_mod.lk_xcorr_iterate_reference(*args, **kw),
                reps=5)
            n_steps = int(steps.sum())
            # bytes: the map taps the lookups read (C1 and C2), the seven
            # scalars of the active features, flow_in, active and the output
            n_active = int(args[10].sum())
            n_bytes = (4 * 2 * int(map_taps(n, args[0].shape[-1], trail).sum())
                       + 4 * 7 * n_active + nbytes(args[9], args[10], fk))
            bytes_ms, ops_ms = bound(n_bytes, n_steps * K2_STEP_FLOPS)
            rows.append(dict(n=n, level=level, maps=list(args[0].shape),
                             max_abs_err=err, ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms,
                             bound_ms=max(bytes_ms, ops_ms),
                             bytes_ms=bytes_ms, ops_ms=ops_ms, bytes=n_bytes,
                             steps=n_steps, n_active=n_active,
                             n_inactive=int(idle.sum())))
            active = args[10]
            flow = fp * 2.0 if level > 0 else fp
    for r in rows:
        print("k2 " + json.dumps(r), flush=True)
    tot = frame_totals(rows, 2)
    print(f"k2 level entry: flow max|d| {tot['max_abs_err']:.3g} px over 8 "
          f"(N, level) cases, inactive features bit-equal; one frame's 16 "
          f"launches: kernel {tot['ms']:.4f} ms, calls {tot['call_ms']:.3f} "
          f"ms (plain {tot['plain_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.5f} ms by {tot['bound_by']})", flush=True)

    # the pyramid entry: one bidirectional track of N features per launch,
    # seeded at the points themselves (as the stereo track is)
    pkw = dict(win=params.win_size, max_level=params.max_level,
               iterations=params.iterations, eps=params.eps,
               min_eig_threshold=params.min_eig_threshold,
               bidirectional=True, fb_threshold=1.5)
    pyr_rows = []
    for n in (120, 240):
        pts = points[:n].contiguous()
        args = (pyr0, pyr1, pts, pts,
                torch.ones(n, dtype=torch.bool, device=dev))
        pk, sk, ek = k2_mod.lk_xcorr_pyramid_cuda(*args, **pkw)
        levels = []
        pp, sp, ep = k2_mod.lk_xcorr_pyramid_reference(*args, **pkw,
                                                       levels=levels)
        torch.cuda.synchronize()
        err = float((pk - pp).abs().max())
        if not err <= 0.01:
            fail(f"k2 pyramid N={n}: points max|d| {err:.4g} px")
        if not torch.equal(sk, sp):
            fail(f"k2 pyramid N={n}: status differs in "
                 f"{int((sk != sp).sum())} features")
        np.testing.assert_allclose(ek.cpu().numpy(), ep.cpu().numpy(),
                                   rtol=1e-3, atol=1e-6)
        ms, call_ms = timed_kernel(
            f"k2 pyramid N={n}",
            lambda: k2_mod.lk_xcorr_pyramid_cuda(*args, **pkw),
            "lk_xcorr_pyr_kernel")
        probe_ms = timed_kernel(
            f"k2 pyramid probe N={n}",
            lambda: k2_mod.lk_xcorr_pyramid_cuda(*args, **dict(pkw, eps=1e9)),
            "lk_xcorr_pyr_kernel")[0]
        plain_ms = cuda_time_ms(
            lambda: k2_mod.lk_xcorr_pyramid_reference(*args, **pkw), reps=3)
        # bytes: each plane's pixels once over both directions, the setup
        # of the active features (and of all at the forward level 0, for
        # err), the vectors and outputs once
        fwd0 = params.max_level
        pix_bytes, flops, running, taps = xcorr_work(
            [dict(lv, used=lv["active"] | (k == fwd0))
             for k, lv in enumerate(levels)], params.win_size)
        a = levels[0]["args"][0].shape[-1]
        n_bytes = pix_bytes + nbytes(*args[2:], pk, sk, ek)
        bytes_ms, ops_ms = bound(n_bytes, flops)
        pyr_rows.append(dict(n=n, entry="pyramid", levels=len(levels),
                             max_abs_err=err, ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms,
                             bound_ms=max(bytes_ms, ops_ms),
                             bytes_ms=bytes_ms, ops_ms=ops_ms, bytes=n_bytes,
                             flops=flops, running_levels=running,
                             map_taps=taps, map_entries_built=running * a * a,
                             steps=sum(int(lv["steps"].sum())
                                       for lv in levels),
                             max_chain_steps=int(sum(
                                 lv["steps"] for lv in levels).max()),
                             probe_ms=probe_ms,
                             setup_maps_share=probe_ms / ms,
                             n_status=int(sp.sum())))
    for r in pyr_rows:
        print("k2 " + json.dumps(r), flush=True)
    ptot = frame_totals(pyr_rows, 1)
    print(f"k2 pyramid entry: points max|d| {ptot['max_abs_err']:.3g} px at "
          f"N = 120 and 240, status identical; one frame's 2 launches: "
          f"kernel {ptot['ms']:.4f} ms, calls {ptot['call_ms']:.3f} ms "
          f"(plain {ptot['plain_ms']:.3f} ms, bound {ptot['bound_ms']:.5f} ms "
          f"by {ptot['bound_by']}); with eps = 1e9 (setup and maps, one step "
          f"a running level) "
          f"{sum(r['probe_ms'] for r in pyr_rows):.4f} ms; the steps look up "
          f"{sum(r['map_taps'] for r in pyr_rows)} of the "
          f"{sum(r['map_entries_built'] for r in pyr_rows)} map entries "
          f"built", flush=True)
    maps_yardstick(levels[fwd0], params.win_size)  # the N = 240 track's
    batched_pyramid_rows("k2", k2_mod, "lk_xcorr_pyramid",
                         "lk_xcorr_pyr_kernel", seq, params, 0.01,
                         xcorr_records)
    return ptot


def k1_records(levels, max_level, win):
    """(bytes, FLOPs) of one K1 pyramid track's level records (k1_work;
    the setup of the active features, and of all at the forward level 0,
    whose min_eig is err)."""
    return k1_work([dict(lv, setup=lv["active"] | (k == max_level))
                    for k, lv in enumerate(levels)], win)


def xcorr_records(levels, max_level, win):
    """(bytes, FLOPs) of one K2 pyramid track's level records
    (xcorr_work, with the same setup features as k1_records)."""
    return xcorr_work([dict(lv, used=lv["active"] | (k == max_level))
                       for k, lv in enumerate(levels)], win)[:2]


def fleet_offsets(n_frames):
    """bench.py:171's stream offsets: (k * 7) mod (frames - 40)."""
    return [(k * 7) % max(n_frames - BENCH_FLEET_FRAMES, 1)
            for k in range(FLEET_B)]


def stack_pyramids(pyrs):
    """The streams' pyramids as one with [B, H, W] planes (the kernels'
    stream-axis layout)."""
    from visfs_tpu_torch.ops.kernels.pyramid import Pyramid

    return Pyramid(*(tuple(torch_stack(t) for t in zip(*field))
                     for field in zip(*[(p.levels, p.gx, p.gy)
                                        for p in pyrs])),
                   pyrs[0].height, pyrs[0].width, pyrs[0].pad)


def torch_stack(tensors):
    import torch

    return torch.stack(tensors).contiguous()


def batched_pyramid_rows(tag, mod, entry, kernel, seq, params, tol,
                         records):
    """A pyramid entry with the fleet's stream axis: FLEET_B streams, each
    its own frame pair (o, o + 1) of the bench loop at bench.py's offsets
    and N GFTT corners of frame o, N = 120 and 240, bidirectional, in one
    launch.  Gates: one launch through the op under torch.func.vmap, which
    equals the direct batched launch; bit-equal to B single launches;
    against the plain version stream by stream, points within ``tol`` px,
    status identical, err rtol 1e-3.  Device, call, plain (CUDA events
    around the gate's plain calls, one a stream) and bound times, the bound
    the sum of each stream's work (``records``)."""
    import torch

    from visfs_tpu_torch.ops.gftt import gftt_detect
    from visfs_tpu_torch.ops.lk import build_lk_pyramid

    cuda_fn = getattr(mod, f"{entry}_cuda")
    plain_fn = getattr(mod, f"{entry}_reference")
    streams = []
    for o in fleet_offsets(len(seq.left)):
        img0 = torch.as_tensor(seq.left[o], device="cuda")
        img1 = torch.as_tensor(seq.left[o + 1], device="cuda")
        det = gftt_detect(img0, 240, 0.01, 10)
        if int(det.valid.sum()) < 240:
            fail(f"{tag} batched: only {int(det.valid.sum())} corners in "
                 f"frame {o}")
        streams.append((build_lk_pyramid(img0, params),
                        build_lk_pyramid(img1, params), det.points))
    pkw = dict(win=params.win_size, max_level=params.max_level,
               iterations=params.iterations, eps=params.eps,
               min_eig_threshold=params.min_eig_threshold,
               bidirectional=True, fb_threshold=1.5)
    pyr_from = stack_pyramids([st[0] for st in streams])
    pyr_to = stack_pyramids([st[1] for st in streams])
    rows = []
    for n in (120, 240):
        per = [(st[0], st[1], st[2][:n].contiguous(), st[2][:n].contiguous(),
                torch.ones(n, dtype=torch.bool, device="cuda"))
               for st in streams]
        pts = torch.stack([a[2] for a in per])
        valid = torch.stack([a[4] for a in per])
        args = (pyr_from, pyr_to, pts, pts, valid)
        before = mod.PYR_LAUNCHES
        vm = vmapped_entry(getattr(mod, entry), args, pkw)
        vm_launches = mod.PYR_LAUNCHES - before
        bk = cuda_fn(*args, **pkw)
        singles = [cuda_fn(*a, **pkw) for a in per]
        work, plains, plain_ms = [0, 0], [], 0.0
        for a in per:
            levels = []
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            plains.append(plain_fn(*a, **pkw, levels=levels))
            e1.record()
            e1.synchronize()
            plain_ms += e0.elapsed_time(e1)
            b, f = records(levels, params.max_level, params.win_size)
            work[0] += b + nbytes(*a[2:])
            work[1] += f
        torch.cuda.synchronize()
        label = f"{tag} batched B={FLEET_B} N={n}"
        if vm_launches != 1:
            fail(f"{label}: {vm_launches} launches under vmap, expected 1")
        if not all(torch.equal(x, y) for x, y in zip(vm, bk)):
            fail(f"{label}: the vmapped call differs from the direct launch")
        for b, one in enumerate(singles):
            if not all(torch.equal(x[b], y) for x, y in zip(bk, one)):
                fail(f"{label}: stream {b} differs from its single launch")
        err = max(float((bk[0][b] - p[0]).abs().max())
                  for b, p in enumerate(plains))
        if not err <= tol:
            fail(f"{label}: points max|d| {err:.4g} px")
        for b, p in enumerate(plains):
            if not torch.equal(bk[1][b], p[1]):
                fail(f"{label}: stream {b} status differs in "
                     f"{int((bk[1][b] != p[1]).sum())} features")
            np.testing.assert_allclose(bk[2][b].cpu().numpy(),
                                       p[2].cpu().numpy(), rtol=1e-3,
                                       atol=1e-6)
        ms, call_ms = timed_kernel(label, lambda: cuda_fn(*args, **pkw),
                                   kernel)
        single_ms = timed_kernel(f"{label} single",
                                 lambda: cuda_fn(*per[0], **pkw), kernel)[0]
        out_bytes = nbytes(*bk)
        bytes_ms, ops_ms = bound(work[0] + out_bytes, work[1])
        rows.append(dict(n=n, streams=FLEET_B, entry=entry,
                         max_abs_err=err, ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms, single_stream_ms=single_ms,
                         bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                         ops_ms=ops_ms, bytes=work[0] + out_bytes,
                         n_status=int(bk[1].sum())))
    for r in rows:
        print(f"{tag} " + json.dumps(r), flush=True)
    tot = frame_totals(rows, 1)
    print(f"{tag} batched pyramid entry, {FLEET_B} streams a launch: points "
          f"max|d| {tot['max_abs_err']:.3g} px at N = 120 and 240, status "
          f"identical, bit-equal to {FLEET_B} single launches, 1 launch "
          f"under vmap; a fleet frame's 2 launches: kernel {tot['ms']:.4f} "
          f"ms (one stream's launches "
          f"{sum(r['single_stream_ms'] for r in rows):.4f} ms), calls "
          f"{tot['call_ms']:.3f} ms (plain {tot['plain_ms']:.3f} ms, "
          f"bound {tot['bound_ms']:.5f} ms by {tot['bound_by']})", flush=True)
    return tot


def vmapped_entry(entry, args, pkw):
    """A pyramid entry under torch.func.vmap over the streams of stacked
    arguments, as the fleet's step calls it."""
    import torch

    from visfs_tpu_torch.ops.kernels.pyramid import Pyramid

    pyr_from, pyr_to = args[:2]
    size = pyr_from[3:]

    def one(planes_from, planes_to, pts, init, valid):
        return entry(Pyramid(*planes_from, *size), Pyramid(*planes_to, *size),
                     pts, init, valid, **pkw)

    return torch.func.vmap(one)(tuple(pyr_from[:3]), tuple(pyr_to[:3]),
                                *args[2:])


def maps_yardstick(level, win):
    """Time one grouped float32 conv2d (TF32 off) that computes the maps of
    one level: the forward level 0's regions [1, N, R, R] against the (gx,
    gy) patches [2N, 1, win, win] of the same N = 240 features.  A yardstick
    of the pyramid entry's map stage; the port never calls it."""
    import torch
    import torch.nn.functional as F

    from visfs_tpu_torch.ops.lk import _xcorr_maps

    s = level["setup"]
    n = s.region.shape[0]
    weight = torch.stack([s.gx, s.gy], dim=1).reshape(2 * n, 1, win, win)
    region = s.region[None].contiguous()
    out = F.conv2d(region, weight, groups=n)[0]  # [2N, A, A]
    c1, c2 = _xcorr_maps(s.region, s.gx, s.gy, win)
    diff = float(torch.maximum((out[0::2] - c1).abs().max(),
                               (out[1::2] - c2).abs().max()))
    ms = cuda_time_ms(lambda: F.conv2d(region, weight, groups=n))
    print(f"k2 map stage yardstick: grouped conv2d (cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}) of {n} regions "
          f"{list(s.region.shape[1:])} against 2 x {n} patches "
          f"[{win}, {win}] -> maps {list(c1.shape)} x 2: {ms * 1e3:.2f} us "
          f"per call (CUDA events), max|d| {diff:.3g} from _xcorr_maps "
          f"(largest entry {float(c1.abs().max()):.3g})", flush=True)


def start_loop(seq, System, lk, params=None, frames=None, depth=False):
    """The first ``frames`` frames of the loop on the card (the right image,
    or with depth the ray-cast depth) and a System (params, default the
    bench's, lk_params replaced by lk) stepped through frames 0-1."""
    import torch

    n = frames or len(seq.left)
    lefts = [torch.as_tensor(f, device="cuda") for f in seq.left[:n]]
    rights = [torch.as_tensor(f, device="cuda")
              for f in (seq.depth if depth else seq.right)[:n]]
    torch.cuda.synchronize()
    sys_ = make_system(System, seq.camera, params or bench_params(WIDTH),
                       "cuda", lk)
    for i in range(2):
        sys_.input_primary_sensor_data(float(seq.stamps[i]), lefts[i],
                                       rights[i])
    sys_.drain_outputs()
    torch.cuda.synchronize()
    return sys_, lefts, rights


def timed_steps(sys_, seq, lefts, rights, feed=None, spans=()):
    """Step frames 2.. of seq through sys_ under the stage probe: CUDA
    events and host clocks around every tracker_step and the whole step of
    every frame (event records do not wait for the device), host syncs
    caught as warnings.  feed(i) feeds frame i (default: the stereo pair);
    spans: (name, module, attribute) of more functions whose device spans
    are timed with events the same way.  Returns (elapsed s, medians per
    frame, the sync messages)."""
    import torch

    import visfs_tpu_torch.slam.system as sysmod

    if feed is None:
        def feed(i):
            sys_.input_primary_sensor_data(float(seq.stamps[i]), lefts[i],
                                           rights[i])

    marks = {}
    patched = []

    def timed(name, fn):
        def wrapper(*a, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            h0 = time.perf_counter()
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            marks.setdefault(name, []).append(
                (e0, e1, time.perf_counter() - h0))
            return out
        return wrapper

    step_marks = []
    for name, mod, attr in (("tracker", sysmod, "tracker_step"),) + spans:
        patched.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timed(name, getattr(mod, attr)))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            for i in range(2, len(lefts)):
                s0, s1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                s0.record()
                feed(i)
                s1.record()
                step_marks.append((s0, s1))
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)
    n = len(step_marks)

    def device_ms(ms):
        return float(np.median([a.elapsed_time(b) for a, b, *_ in ms]))

    stages = dict(
        tracker_host_ms=float(np.median([m[2] for m in marks["tracker"]])
                              * 1e3),
        tracker_device_ms=device_ms(marks["tracker"]))
    for name, _, _ in spans:
        stages[f"{name}_device_ms"] = device_ms(marks[name])
    stages.update(step_device_ms=device_ms(step_marks),
                  frame_wall_ms=elapsed / n * 1e3)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    return elapsed, stages, syncs


def phase_loop(label, seq, System, lk, expect, ate_rmse, params=None,
               frames=MAIN_FRAMES, depth=False, one_way=None):
    """The first ``frames`` frames of the loop on the card (params default
    the bench's; depth feeds the ray-cast depth as the right image).
    expect: {(kernel module, launch counter name): launches per frame};
    every count is set to 0 just before the timed loop and read just after
    it.  one_way: the K1 pyramid calls a frame that must be one-way (none
    bidirectional), when given.  Returns the launches and the System."""
    import torch

    import visfs_tpu_torch.ops.lk as lk_ops
    import visfs_tpu_torch.slam.tracker as tracker_mod

    sys_, lefts, rights = start_loop(seq, System, lk, params, frames, depth)
    entry, ways = lk_ops.lk_pyramid, []
    cull, culled = tracker_mod.cull_with_fundamental, []

    def recorded(*a, **kw):
        ways.append(kw["bidirectional"])
        return entry(*a, **kw)

    def counted_cull(p1, p2, mask, *a, **kw):
        inl, f = cull(p1, p2, mask, *a, **kw)
        culled.append((mask & ~inl).sum())  # on the device: no sync
        return inl, f

    for mod, counter in expect:
        setattr(mod, counter, 0)
    lk_ops.lk_pyramid = recorded
    tracker_mod.cull_with_fundamental = counted_cull
    try:
        elapsed, stages, syncs = timed_steps(sys_, seq, lefts, rights)
    finally:
        lk_ops.lk_pyramid = entry
        tracker_mod.cull_with_fundamental = cull
    launches = {key: getattr(*key) for key in expect}
    outs = sys_.drain_outputs()
    n = frames - 2
    fps = n / elapsed
    LOOP_FPS[label] = fps
    est = np.stack([o.pose for o in outs])
    if not np.all(np.isfinite(est)) or est.shape != (n, 4, 4):
        fail(f"{label}: poses not finite [{n}, 4, 4]: {est.shape}")
    ate = ate_rmse(est, seq.poses[2:2 + len(est)])
    lost = int(sum(bool(o.lost) for o in outs))
    counts = ", ".join(f"{mod.__name__.rsplit('.', 1)[-1]}.{counter} {c} "
                       f"({c / n:g}/frame)"
                       for (mod, counter), c in launches.items())
    print(f"{label}: {fps:.2f} fps over {n} frames ({elapsed:.2f} s), ATE "
          f"{ate:.4f} m, lost {lost}/{len(outs)}, fewest inliers "
          f"{min(int(o.n_inliers) for o in outs)}, {counts}, K1 pyramid "
          f"calls {len(ways)} ({sum(not w for w in ways)} one-way), host "
          f"syncs in loop {len(syncs)}", flush=True)
    print(f"{label} stages (medians per frame): " + json.dumps(stages),
          flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"{label}: sync: {msg[:200]}", flush=True)
    if culled:
        per_frame = torch.stack(culled).cpu().tolist()
        print(f"{label}: the cull rejects per frame (of the tracked "
              f"features): {' '.join(map(str, per_frame))}; total "
              f"{sum(per_frame)} over {len(per_frame)} calls", flush=True)
    if not ate <= ATE_GATE:
        fail(f"{label}: ATE {ate:.4f} m > {ATE_GATE}")
    if lost:
        fail(f"{label}: {lost} lost frames")
    if syncs:
        fail(f"{label}: {len(syncs)} host syncs in the loop")
    for (mod, counter), per_frame in expect.items():
        if launches[mod, counter] != per_frame * n:
            fail(f"{label}: {mod.__name__}.{counter} is "
                 f"{launches[mod, counter]}, expected {per_frame * n}")
    if one_way is not None and (len(ways) != one_way * n or any(ways)):
        fail(f"{label}: {len(ways)} K1 pyramid calls, "
             f"{sum(ways)} bidirectional; expected {one_way * n} one-way")
    return launches, sys_


def phase_profile(seq, System, frames=10):
    """The main path with System(profile_stages=True): frames 0-1 fused,
    then ``frames`` frames each run as four synced stages; prints the
    median of each time_* field (ms).  Printed, not gated: the syncs make
    these the stages' own times, not the fused step's."""
    sys_, lefts, rights = start_loop(seq, System, None, frames=frames + 2)
    sys_.profile_stages = True
    for i in range(2, frames + 2):
        sys_.input_primary_sensor_data(float(seq.stamps[i]), lefts[i],
                                       rights[i])
    outs = sys_.drain_outputs()
    split = {f: float(np.median([float(getattr(o, f)) for o in outs]) * 1e3)
             for f in ("time_tracking", "time_estimation",
                       "local_bundle_time", "time_total")}
    print(f"main profile_stages (medians over {len(outs)} frames, ms, "
          f"synced stages): " + json.dumps(split), flush=True)
    if len(outs) != frames or any(bool(o.lost) for o in outs):
        fail(f"main profile_stages: {len(outs)} frames, lost "
             f"{[bool(o.lost) for o in outs]}")


def phase_fleet(seq, System, expect, ate_rmse):
    """Bench phase 3 on the card: FleetSystem(bench parameters, 8 streams)
    over FLEET_FRAMES frames a stream from bench.py's offsets, frames 0-1
    then a timed loop over the rest.  expect: {(kernel module, launch
    counter): launches per fleet frame}, every count set to 0 just before
    the loop and read just after it.  Gates: the launches, 0 host syncs, each
    stream's ATE <= 0.15 m (against its ground truth from its own start)
    and 0 lost over frames 2..; a second pass bit-equal to the timed one;
    streams 0 and 7 against single Systems of seeds 0 and 7 on "cuda", each
    frame stepped from the fleet's stream state (per frame 1e-3 m, 1e-3
    rad, identical lost flags).  Printed: stream 0's System free running
    over the same frames, the aggregate fps and its ratio to main's, and
    the kernels and kernel time a frame (profiler, the next two frames) of
    the fleet and of that free-running System."""
    import torch

    from visfs_tpu_torch.slam.fleet import FleetSystem, stream_state

    offs = fleet_offsets(len(seq.left))
    n = FLEET_FRAMES + 2  # and the two profiled frames
    lefts = [torch.stack([torch.as_tensor(seq.left[o + i], device="cuda")
                          for o in offs]) for i in range(n)]
    rights = [torch.stack([torch.as_tensor(seq.right[o + i], device="cuda")
                           for o in offs]) for i in range(n)]
    stamps = [torch.tensor([float(seq.stamps[o + i]) for o in offs],
                           dtype=torch.float32, device="cuda")
              for i in range(n)]
    torch.cuda.synchronize()
    cam = seq.camera
    fleet = FleetSystem(bench_params(WIDTH), n_streams=FLEET_B,
                        device="cuda")
    fleet.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(cam.baseline), width=cam.width, height=cam.height)
    for i in range(2):
        fleet.input_primary_sensor_data(stamps[i], lefts[i], rights[i])
    torch.cuda.synchronize()
    for mod, counter in expect:
        setattr(mod, counter, 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            for i in range(2, FLEET_FRAMES):
                fleet.input_primary_sensor_data(stamps[i], lefts[i],
                                                rights[i])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {key: getattr(*key) for key in expect}
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    outs = fleet.drain_outputs()
    kernels, kernel_ms = device_kernels(lambda: [
        fleet.input_primary_sensor_data(stamps[i], lefts[i], rights[i])
        for i in (FLEET_FRAMES, FLEET_FRAMES + 1)])
    timed = FLEET_FRAMES - 2
    agg = timed * FLEET_B / elapsed
    main_fps = LOOP_FPS.get("main")
    pose = np.stack([o.pose for o in outs])  # [T, B, 4, 4]
    if pose.shape != (FLEET_FRAMES, FLEET_B, 4, 4) or not np.all(
            np.isfinite(pose)):
        fail(f"fleet: poses not finite [{FLEET_FRAMES}, {FLEET_B}, 4, 4]: "
             f"{pose.shape}")
    lost = np.stack([o.lost for o in outs])[2:]
    ates = []
    for b, o in enumerate(offs):
        gt = seq.poses[o:o + FLEET_FRAMES]
        gt = np.linalg.inv(gt[0]) @ gt
        ates.append(ate_rmse(pose[2:, b], gt[2:]))
    counts = ", ".join(f"{mod.__name__.rsplit('.', 1)[-1]}.{counter} {c} "
                       f"({c / timed:g}/frame)"
                       for (mod, counter), c in launches.items())
    print(f"fleet: {FLEET_B} streams x {timed} frames in {elapsed:.2f} s: "
          f"{agg:.2f} fps aggregate"
          + (f" = {agg / main_fps:.2f}x main's {main_fps:.2f} fps"
             if main_fps else "")
          + f"; stream ATE {' '.join(f'{a:.4f}' for a in ates)} m, lost "
          f"{int(lost.sum())}/{lost.size}, {counts}, host syncs in loop "
          f"{len(syncs)}", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"fleet: sync: {msg[:200]}", flush=True)
    if syncs:
        fail(f"fleet: {len(syncs)} host syncs in the loop")
    for (mod, counter), per_frame in expect.items():
        if launches[mod, counter] != per_frame * timed:
            fail(f"fleet: {mod.__name__}.{counter} is "
                 f"{launches[mod, counter]}, expected {per_frame * timed}")
    if lost.any():
        fail(f"fleet: {int(lost.sum())} lost stream-frames")
    if not max(ates) <= ATE_GATE:
        fail(f"fleet: a stream's ATE {max(ates):.4f} m > {ATE_GATE}")

    # streams against single Systems.  The vmapped step's batched
    # reductions add in another order than the single step's, and over 40
    # frames the PnP and BA decisions amplify that (ROADMAP queue 3): each
    # frame is held from the same state, the free run is printed.  A
    # second pass records the states (and shows the fleet deterministic).
    again = FleetSystem(bench_params(WIDTH), n_streams=FLEET_B,
                        device="cuda")
    again.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(cam.baseline), width=cam.width, height=cam.height)
    before = []
    for i in range(FLEET_FRAMES):
        before.append({b: map_tensors(stream_state(again.states, b),
                                      lambda t: t.clone())
                       for b in FLEET_COMPARED})
        again.input_primary_sensor_data(stamps[i], lefts[i], rights[i])
    outs2 = again.drain_outputs()
    same = all(np.array_equal(getattr(a, f), getattr(c, f))
               for a, c in zip(outs, outs2) for f in ("pose", "n_inliers"))
    print(f"fleet: a second pass {'equals' if same else 'DIFFERS from'} "
          f"the timed one bit for bit", flush=True)
    if not same:
        fail("fleet: two passes over the same frames differ")
    for b in FLEET_COMPARED:
        o = offs[b]
        single = make_system(System, cam, bench_params(WIDTH), "cuda",
                             seed=b)
        stepped = []
        for i in range(FLEET_FRAMES):
            single.state = before[i][b]
            single.input_primary_sensor_data(float(seq.stamps[o + i]),
                                             lefts[i][b], rights[i][b])
            stepped.append(single.output_odometry_info())
        refs = [("stepped", stepped)]
        if b == FLEET_COMPARED[0]:
            free = make_system(System, cam, bench_params(WIDTH), "cuda",
                               seed=b)
            for i in range(FLEET_FRAMES):
                free.input_primary_sensor_data(float(seq.stamps[o + i]),
                                               lefts[i][b], rights[i][b])
            refs.append(("free running", free.drain_outputs()))
            single_kernels = device_kernels(lambda: [
                free.input_primary_sensor_data(
                    float(seq.stamps[o + i]), lefts[i][b], rights[i][b])
                for i in (FLEET_FRAMES, FLEET_FRAMES + 1)])
        gap = {}
        for name, ref in refs:
            g = [rel_gap(outs[i].pose[b], ref[i].pose)
                 for i in range(FLEET_FRAMES)]
            gap[name] = (max(x[0] for x in g), max(x[1] for x in g),
                         max(abs(int(outs[i].n_inliers[b])
                                 - int(ref[i].n_inliers))
                             for i in range(FLEET_FRAMES)),
                         all(bool(outs[i].lost[b]) == bool(ref[i].lost)
                             for i in range(FLEET_FRAMES)))
        print(f"fleet stream {b} (frames {o}-{o + FLEET_FRAMES - 1}) "
              f"against a System of seed {b} on cuda, "
              + "; ".join(f"{name}: max |dt| {t:.3g} m, max angle {r:.3g} "
                          f"rad, inliers within {d}, lost flags "
                          f"{'identical' if same_lost else 'DIFFER'}"
                          for name, (t, r, d, same_lost) in gap.items()),
              flush=True)
        t, r, d, same_lost = gap["stepped"]
        if not (t <= 1e-3 and r <= 1e-3 and same_lost):
            fail(f"fleet stream {b}, each frame from the fleet's state: "
                 f"{t:.3g} m, {r:.3g} rad, lost flags identical "
                 f"{same_lost}")
    wall_ms = elapsed / timed * 1e3
    print(f"fleet kernels a fleet frame (torch.profiler, frames "
          f"{FLEET_FRAMES}-{FLEET_FRAMES + 1}): {kernels / 2:.0f} "
          f"({kernel_ms / 2:.2f} ms of kernel time, {wall_ms:.1f} ms of "
          f"loop wall a frame: busy share {kernel_ms / 2 / wall_ms:.3f}); "
          f"one stream's System: {single_kernels[0] / 2:.0f} "
          f"({single_kernels[1] / 2:.2f} ms)", flush=True)


def s3_params(width):
    """Bench phase 4's parameters (bench.py:199-205)."""
    return dict(bench_params(width), **{"System/SensorStrategy": 3})


def s4_params(width):
    """Phase s4: phase s3's point at SensorStrategy 4 (the laser's
    occupied-space terms in the BA, wheel rows, the submaps)."""
    return dict(s3_params(width), **{"System/SensorStrategy": 4})


def s4_process(cache_dir):
    """Phase s4 in a process of its own (``chip_smoke.py --s4 CACHE_DIR``):
    phase_s3 at strategy 4 with its gates, K1's counts its own."""
    import torch

    from visfs_tpu_torch.io.sim import ate_rmse, cached_textured_sequence
    from visfs_tpu_torch.ops.kernels import lk_level as k1_mod
    from visfs_tpu_torch.ops.kernels import lk_xcorr as k2_mod
    from visfs_tpu_torch.slam.system import System

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    expect = {(k1_mod, "PYR_LAUNCHES"): 2, (k1_mod, "LAUNCHES"): 0,
              (k2_mod, "PYR_LAUNCHES"): 0, (k2_mod, "LAUNCHES"): 0}
    phase_s3(System, cached_textured_sequence, cache_dir, expect, ate_rmse,
             label="s4", params=s4_params(WIDTH), probes=False,
             ate_gate=S4_ATE_BOUND, map_exempt=S4_MAP_EXEMPT,
             reference=S4_REFERENCE)


def phase_s4(cache_dir):
    """Runs s4_process and prints its output once it has ended; fails if
    it exits with another code than 0."""
    log = os.path.join(os.path.dirname(cache_dir), "phase_s4.log")
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--s4", cache_dir], stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            rc = proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log) as f:
        text = f.read()
    print(text, end="" if text.endswith("\n") else "\n", flush=True)
    if rc != 0:
        fail(f"s4: its process exited with code {rc}")


def wheel_and_scan_feeder(sys_, seq, lefts, rights, wheel=True, scans=True,
                          row=0):
    """feed(i): frame i's wheel rows up to its stamp in one batch (from
    wheel row ``row`` on), then the frame with its scan (bench.py:221-234)."""
    pos = [row]
    odom = seq.wheel_odom

    def feed(i):
        j = pos[0]
        while wheel and j < len(odom) and odom[j][0] <= seq.stamps[i] + 1e-9:
            j += 1
        if j > pos[0]:
            rows = odom[pos[0]:j]
            sys_.input_wheel_odometry_batch(rows[:, 0], rows[:, 1:7])
            pos[0] = j
        sys_.input_primary_sensor_data(
            float(seq.stamps[i]), lefts[i], rights[i],
            scan=seq.laser_scans[i] if scans else None)
    return feed


def device_ms_per_call(fn, reps=10):
    """(device ms, kernels) per call of fn: every CUDA kernel of a
    torch.profiler trace of reps calls, summed, over reps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return sum(us) / reps / 1e3, len(us) / reps


def map_gate(submaps, room, label, exempt=()):
    """The map's gates on the matching grid (tests/test_laser_fusion.py:
    135-165; visfs_tpu_torch.multichip.map_probes at the scene's own
    start): a live slot, probability > 0.5 within a 3x3 neighbourhood of
    every wall probe inside the grid, < 0.5 at the free-space probes.  The
    wall probes are the test's three and the four walls level with the
    matching submap's origin; the free-space probes the test's (0.5, 0) and
    that origin.  At least one wall probe must lie inside.  A failing probe
    whose row starts with one of ``exempt`` is printed, not gated: the JAX
    package's own map fails it at that point."""
    from visfs_tpu_torch.multichip import map_probes

    rows, bad = map_probes(submaps, room)
    waived = [b for b in bad if b.startswith(tuple(exempt))]
    bad = [b for b in bad if b not in waived]
    print(f"{label} map: slots {submaps.slot_valid.tolist()}, range data "
          f"{submaps.num_range_data.tolist()}, finished "
          f"{submaps.finished.tolist()}; matching grid probes: "
          + "; ".join(rows) + (f"; failing where the JAX package's map "
                               f"fails too: {waived}" if waived else ""),
          flush=True)
    if not bool(submaps.slot_valid.any()):
        fail(f"{label}: no live submap slot")
    if bad:
        fail(f"{label}: map probes failed: {bad}")


def phase_s3(System, cached_textured_sequence, cache_dir, expect, ate_rmse,
             label="s3", params=None, probes=True, frames=S3_FRAMES,
             ate_gate=ATE_GATE, map_exempt=(), reference=None):
    """Bench phase 4 on the card: SensorStrategy 3 over the 120-frame
    640x480 loop with wheel rows and scans (params default bench phase 4's;
    phase mapping passes configs/sim_mapping.yaml's block, phase s4 the
    same loop at strategy 4) or its first ``frames``.  expect as for
    phase_loop.  probes: the insertion's device time and the kernels a
    frame at strategies 0 and 3.  ate_gate and map_exempt: the ATE's limit
    and the map probes not gated (phase s4 passes its own: S4_ATE_BOUND
    says why).  reference: the JAX package's figures at this point,
    printed beside the result."""
    import torch

    import visfs_tpu_torch.slam.estimator as est_mod
    import visfs_tpu_torch.slam.system as sysmod

    t0 = time.perf_counter()
    seq = cached_textured_sequence(cache_dir=cache_dir, device="cuda",
                                   **S3_RENDER)
    print(f"{label} sim: {S3_FRAMES} frames {WIDTH}x{HEIGHT} with "
          f"{seq.laser_scans.shape[1]}-beam scans in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lefts = [torch.as_tensor(f, device="cuda") for f in seq.left[:frames]]
    rights = [torch.as_tensor(f, device="cuda") for f in seq.right[:frames]]
    sys_ = make_system(System, seq.camera, params or s3_params(WIDTH),
                       "cuda", scan_capacity=S3_SCAN_CAPACITY,
                       submap_extent_cells=256)
    sub0 = sys_.state.laser.submaps
    print(f"{label} sizes: submap slots {list(sub0.cells.shape)}, scan "
          f"capacity {S3_SCAN_CAPACITY}, raycast samples "
          f"{sys_.settings.raycast_samples}, CLAHE {sys_.cfg.system_clahe}",
          flush=True)
    feed = wheel_and_scan_feeder(sys_, seq, lefts, rights)
    for i in range(2):
        feed(i)
    sys_.drain_outputs()
    torch.cuda.synchronize()

    # the last insertion's arguments, for the device-time probe below
    insert = est_mod.insert_range_data_active
    last = {}

    def keep_args(*a, **kw):
        last.update(a=a, kw=kw)
        return insert(*a, **kw)

    est_mod.insert_range_data_active = keep_args
    for mod, counter in expect:
        setattr(mod, counter, 0)
    try:
        elapsed, stages, syncs = timed_steps(
            sys_, seq, lefts, rights, feed=feed,
            spans=(("prepare", sysmod, "estimator_prepare"),
                   ("ba", sysmod.ba_mod, "local_optimize"),
                   ("finalize", sysmod, "estimator_finalize"),
                   ("insert", est_mod, "insert_range_data_active")))
    finally:
        est_mod.insert_range_data_active = insert
    launches = {key: getattr(*key) for key in expect}
    outs = sys_.drain_outputs()
    n = frames - 2
    fps = n / elapsed
    LOOP_FPS[label] = fps
    est = np.stack([o.pose for o in outs])
    if not np.all(np.isfinite(est)) or est.shape != (n, 4, 4):
        fail(f"{label}: poses not finite [{n}, 4, 4]: {est.shape}")
    ate = ate_rmse(est, seq.poses[2:2 + len(est)])
    lost = int(sum(bool(o.lost) for o in outs))
    counts = ", ".join(f"{mod.__name__.rsplit('.', 1)[-1]}.{counter} {c} "
                       f"({c / n:g}/frame)"
                       for (mod, counter), c in launches.items())
    print(f"{label}: {fps:.2f} fps over {n} frames ({elapsed:.2f} s), ATE "
          f"{ate:.4f} m, lost {lost}/{len(outs)}, fewest inliers "
          f"{min(int(o.n_inliers) for o in outs)}, {counts}, host syncs in "
          f"loop {len(syncs)}", flush=True)
    if reference:
        print(f"{label}: the JAX package here on the CPU: {reference} (a "
              f"comparison, not a gate)", flush=True)
    print(f"{label} stages (medians per frame): " + json.dumps(stages),
          flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"{label}: sync: {msg[:200]}", flush=True)
    if probes:
        ins_ms, ins_kernels = device_ms_per_call(
            lambda: insert(*last["a"], **last["kw"]))
        print(f"{label} submap insertion (the last frame's inputs): "
              f"{ins_ms:.4f} ms of device time per call in {ins_kernels:g} "
              f"kernels (torch.profiler)", flush=True)
    map_gate(sys_.state.laser.submaps, seq.room, label, exempt=map_exempt)
    if not ate <= ate_gate:
        fail(f"{label}: ATE {ate:.4f} m > {ate_gate}")
    if lost:
        fail(f"{label}: {lost} lost frames")
    if syncs:
        fail(f"{label}: {len(syncs)} host syncs in the loop")
    for (mod, counter), per_frame in expect.items():
        if launches[mod, counter] != per_frame * n:
            fail(f"{label}: {mod.__name__}.{counter} is "
                 f"{launches[mod, counter]}, expected {per_frame * n}")
    if probes:
        kernels_per_frame(System, seq, lefts, rights)
    return launches


def kernels_per_frame(System, seq, lefts, rights, warm=4, frames=2):
    """Device kernels and kernel time a frame at strategies 0 and 3 on the
    s3 loop's frames: a fresh System each, frames 0..warm-1 untraced, the
    next ``frames`` under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    per = {}
    for strategy in (0, 3):
        p = dict(s3_params(WIDTH), **{"System/SensorStrategy": strategy})
        s = make_system(System, seq.camera, p, "cuda",
                        scan_capacity=S3_SCAN_CAPACITY)
        feed = wheel_and_scan_feeder(s, seq, lefts, rights,
                                     wheel=strategy >= 2,
                                     scans=strategy >= 3)
        for i in range(warm):
            feed(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(warm, warm + frames):
                feed(i)
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        per[strategy] = (len(us) / frames, sum(us) / frames / 1e3)
    print(f"s3 kernels a frame (torch.profiler, frames {warm}-"
          f"{warm + frames - 1}): strategy 0 {per[0][0]:.0f} ({per[0][1]:.2f} "
          f"ms of kernel time), strategy 3 {per[3][0]:.0f} ({per[3][1]:.2f} "
          f"ms); strategy 3 adds {per[3][0] - per[0][0]:.0f}", flush=True)


def compare_runs(label, cuda_outs, cpu_outs):
    """Per frame, the System on "cuda" against "cpu": translation within
    1e-3 m, yaw within 1e-3 rad, inliers within 1, identical lost flags."""
    worst_t = worst_yaw = 0.0
    for i, (a, b) in enumerate(zip(cuda_outs, cpu_outs)):
        dt = float(np.abs(a.pose[:3, 3] - b.pose[:3, 3]).max())
        dyaw = abs(float(np.arctan2(a.pose[1, 0], a.pose[0, 0])
                         - np.arctan2(b.pose[1, 0], b.pose[0, 0])))
        worst_t, worst_yaw = max(worst_t, dt), max(worst_yaw, dyaw)
        if dt > 1e-3 or dyaw > 1e-3 or bool(a.lost) != bool(b.lost) \
                or abs(int(a.n_inliers) - int(b.n_inliers)) > 1:
            fail(f"small {label}: frame {i} cuda vs cpu: dt {dt:.3g} m, "
                 f"dyaw {dyaw:.3g}, inliers {int(a.n_inliers)}/"
                 f"{int(b.n_inliers)}, lost {bool(a.lost)}/{bool(b.lost)}")
    if len(cuda_outs) != len(cpu_outs):
        fail(f"small {label}: {len(cuda_outs)} cuda against "
             f"{len(cpu_outs)} cpu frames")
    return f"max |dt| {worst_t:.3g} m, max |dyaw| {worst_yaw:.3g} rad"


def compare_submaps(label, a, b):
    """The submaps of the "cuda" and "cpu" runs: identical slot_valid,
    num_range_data and finished, max_xy within 1e-4 m, at most 0.1 % of
    the known cells (known in either) different."""
    for f in ("slot_valid", "num_range_data", "finished"):
        if not np.array_equal(getattr(a, f).cpu().numpy(),
                              getattr(b, f).cpu().numpy()):
            fail(f"small {label}: {f} {getattr(a, f).tolist()} cuda, "
                 f"{getattr(b, f).tolist()} cpu")
    dxy = float((a.max_xy.cpu() - b.max_xy.cpu()).abs().max())
    if not dxy <= 1e-4:
        fail(f"small {label}: max_xy differs by {dxy:.3g} m")
    ca, cb = a.cells.cpu(), b.cells.cpu()
    known = int(((ca != 0) | (cb != 0)).sum())
    differ = int((ca != cb).sum())
    if differ > 1e-3 * known:
        fail(f"small {label}: {differ} of {known} known cells differ")
    return (f"submaps identical in slots, counts and finished, max_xy "
            f"within {dxy:.3g} m, {differ} of {known} known cells differ")


# phase small's depth: at LocalMap/NumRangeDataLimit 3, 6 frames start a
# second submap (frame 3) and finish the first (frame 5)
SMALL_FRAMES = 6
# the intra-op threads of phase small's "cpu" process, which runs beside
# the parent's "cuda" runs and phase dp's ranks on the host's cores
SMALL_CPU_THREADS = 4


def small_sequence(cache_dir, device):
    from visfs_tpu_torch.io.sim import cached_textured_sequence

    return cached_textured_sequence(cache_dir=cache_dir,
                                    n_frames=SMALL_FRAMES, width=160,
                                    height=120, motion="square", seed=0,
                                    speed=2.0, with_laser=True, n_beams=180,
                                    with_depth=True, device=device)


def small_runs(seq):
    """Phase small's runs that each device makes on its own, in order:
    (label, lk, params, System keywords, run_sequence keywords)."""
    from visfs_tpu_torch.operating_points import SIM_LOCALIZATION

    params = bench_params(160)
    params["Tracker/MaxFeatures"] = 40
    # configs/sim_localization.yaml's block, its MinDistance (the default,
    # 40 px at 640x480) scaled to the width as bench_params scales it:
    # at 40 px a 160x120 frame keeps too few corners and every frame is lost
    loc = dict(SIM_LOCALIZATION, **{"Tracker/MinDistance": 12})
    for label, lk, p, right in (
            ("k1", None, params, seq.right),
            ("xcorr", XCORR, params, seq.right),
            ("direct", dict(backend="jnp"), params, seq.right),
            ("strategy 1 (RGBD)", None,
             dict(params, **{"System/SensorStrategy": 1}), seq.depth),
            ("CLAHE", None, dict(params, **{"System/CLAHE": True}),
             seq.right),
            ("sim_localization", None, loc, seq.right),
            ("sim_localization + cull", None, dict(loc, **CULL),
             seq.right)):
        yield label, lk, p, {}, dict(rights=right)
    # strategies 2 and 3 with wheel rows, scans at 3, free running (3 also
    # with CLAHE); a submap rotates every 3 scans, so SMALL_FRAMES start a
    # second one and finish the first
    for strategy, extra in ((2, {}), (3, {}), (3, {"System/CLAHE": True})):
        yield (f"strategy {strategy}" + (" CLAHE" if extra else ""), None,
               dict(fusion_params(params, strategy), **extra),
               dict(scan_capacity=S3_SCAN_CAPACITY),
               dict(rights=seq.right, wheel_odom=seq.wheel_odom,
                    scans=seq.laser_scans if strategy == 3 else None))


def small_run(System, seq, device, run):
    """One of small_runs on ``device``: each frame's pose, lost flag and
    inliers, and with scans the submaps on "cpu"."""
    import types

    label, lk, p, sys_kw, run_kw = run
    s = make_system(System, seq.camera, p, device, lk, **sys_kw)
    outs = [types.SimpleNamespace(pose=np.asarray(o.pose), lost=bool(o.lost),
                                  n_inliers=int(o.n_inliers))
            for o in s.run_sequence(seq.stamps, seq.left, **run_kw)]
    if run_kw.get("scans") is None:
        return outs, None
    sub = s.state.laser.submaps
    return outs, types.SimpleNamespace(**{
        f: getattr(sub, f).cpu() for f in ("slot_valid", "num_range_data",
                                          "finished", "max_xy", "cells")})


def small_cpu(cache_dir, path):
    """Phase small's "cpu" process: every run of small_runs on "cpu",
    saved to ``path`` by label."""
    import torch

    from visfs_tpu_torch.slam.system import System

    torch.set_num_threads(SMALL_CPU_THREADS)
    seq = small_sequence(cache_dir, "cpu")
    torch.save({run[0]: small_run(System, seq, "cpu", run)
                for run in small_runs(seq)}, path)


def phase_small(System, cache_dir):
    """The System on "cuda" against "cpu" at 160x120 over SMALL_FRAMES
    frames: each run of small_runs on both (the "cpu" side in a process
    of its own, started first), then strategies 4 and 5 stepped."""
    import torch

    seq = small_sequence(cache_dir, "cuda")  # the cache the child reads
    path = os.path.join(os.path.dirname(cache_dir), "small_cpu_runs.pt")
    if os.path.exists(path):
        os.unlink(path)
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--small-cpu", cache_dir, path])
    try:
        runs = [(run, small_run(System, seq, "cuda", run))
                for run in small_runs(seq)]
        # strategies 4 (wheel rows) and 5 (none: its own path, PnP and the
        # laser-only BA) with scans.  Free running, float-level noise moves
        # the reference itself by centimetres at 4 and decimetres at 5
        # (reference_laser_noise.py), so each frame is stepped on "cuda"
        # from the "cpu" run's state.
        params = dict(bench_params(160), **{"Tracker/MaxFeatures": 40})
        stepped_fusion(System, seq, fusion_params(params, 4), "strategy 4",
                       wheel=True)
        stepped_fusion(System, seq, fusion_params(params, 5), "strategy 5",
                       wheel=False)
        rc = child.wait()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if rc != 0:
        fail(f"small: the cpu process exited with code {rc}")
    cpu = torch.load(path, weights_only=False)
    for (label, _, _, _, run_kw), (outs, sub) in runs:
        line = compare_runs(label, outs, cpu[label][0])
        if sub is not None:
            line += "; " + compare_submaps(label, sub, cpu[label][1])
        free = (", free running" if run_kw.get("wheel_odom") is not None
                else "")
        print(f"small {label}: cuda vs cpu over {SMALL_FRAMES} frames at "
              f"160x120{free}: {line}", flush=True)


def phase_clahe(seq):
    """clahe on "cuda" against "cpu" on one 640x480 frame: max |d| within
    CLAHE_BOUND levels (the histograms are exact on both; the CDF is a
    cumsum whose order the devices may choose differently)."""
    import torch

    from visfs_tpu_torch.ops.image import clahe

    img = torch.as_tensor(seq.left[1])
    a = clahe(img.cuda()).cpu()
    b = clahe(img)
    d = float((a - b).abs().max())
    print(f"small clahe: cuda vs cpu on one {WIDTH}x{HEIGHT} frame: max|d| "
          f"{d:.3g} levels, {int((a != b).sum())} pixels differ", flush=True)
    if not d <= CLAHE_BOUND:
        fail(f"small clahe: cuda vs cpu max|d| {d:.3g} > {CLAHE_BOUND}")


def fundamental_scene(rng, n=120, outliers=20):
    """Two views of a 3D scene with known epipolar geometry and gross
    outliers: (p1, p2 [n, 2] float32 pixels, outlier mask [n]), as
    tests/test_fundamental.py's make_scene draws them from rng."""
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 10, n)], -1)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    t = np.array([0.3, 0.05, 0.1])
    ang = 0.05
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])

    def proj(P):
        return np.stack([P[:, 0] / P[:, 2] * fx + cx,
                         P[:, 1] / P[:, 2] * fy + cy], -1)

    p1 = proj(pts)
    p2 = proj((R @ pts.T).T + t)
    gt_out = np.zeros(n, bool)
    bad = rng.choice(n, size=outliers, replace=False)
    p2[bad] += rng.uniform(15, 60, size=(outliers, 2))
    gt_out[bad] = True
    return p1.astype(np.float32), p2.astype(np.float32), gt_out


def phase_cull():
    """cull_with_fundamental on "cuda" against "cpu" on
    tests/test_fundamental.py::test_separates_outliers' scene and key (seed
    42, 20 gross outliers of 120, key 0, threshold 1.5, 64 hypotheses):
    identical inlier masks, every gross outlier rejected."""
    import torch

    from visfs_tpu_torch.core import prng
    from visfs_tpu_torch.ops.fundamental import cull_with_fundamental

    p1, p2, gt_out = fundamental_scene(np.random.default_rng(42))
    got = {}
    for dev in ("cuda", "cpu"):
        inl, f = cull_with_fundamental(
            torch.as_tensor(p1, device=dev), torch.as_tensor(p2, device=dev),
            torch.ones(len(p1), dtype=torch.bool, device=dev),
            prng.PRNGKey(0, device=dev), threshold=1.5, hypotheses=64)
        f = f.cpu().double()
        got[dev] = inl.cpu().numpy(), f / f.norm()
    (mask, fa), (mask_cpu, fb) = got["cuda"], got["cpu"]
    df = float(torch.minimum((fa - fb).abs().max(), (fa + fb).abs().max()))
    print(f"cull: cuda vs cpu on the outlier scene: masks "
          f"{'identical' if np.array_equal(mask, mask_cpu) else 'differ'}, "
          f"{int((~mask).sum())} of {len(mask)} rejected ({int(gt_out.sum())}"
          f" gross outliers, {int((~mask & gt_out).sum())} of them), F up to "
          f"scale and sign within {df:.3g}", flush=True)
    if not np.array_equal(mask, mask_cpu):
        fail("cull: cuda and cpu inlier masks differ")
    if mask[gt_out].any():
        fail(f"cull: {int(mask[gt_out].sum())} gross outliers kept")


# Phase backend: tests/test_multi_robot.py:112-180's two-robot session at
# the bench's width and parameters.  BACKEND_FRAMES is 240 where the
# reference test has 160: at 640x480 its corners turn 0.18 rad a frame and
# the JAX package's own VO loses 7 frames a robot there (reference_backend.py
# --frames 160); at 240 (0.12 rad, the bench loop's corner rate) it tracks.
BACKEND_FRAMES = 240
# Each robot drives the first BACKEND_ROBOT_FRAMES frames of its lap (robot
# 0 frames 0-59, robot 1 frames 120-179 from its true pose at frame 120):
# the same scene and corner rate (its loops=2.0 ties the corner rate to
# the scene's frames, so the scene stays whole) at half of the VO
# frames, since phase s4 joined (the script's time).
BACKEND_ROBOT_FRAMES = 60
BACKEND_RENDER = dict(n_frames=BACKEND_FRAMES, width=WIDTH, height=HEIGHT,
                      motion="square", seed=11, loops=2.0,
                      room=(-3.0, 13.0, -6.0, 6.0))
BACKEND_SESSION = dict(max_nodes=128, max_edges=512, snapshot_kp=48)
BACKEND_LOOPS = dict(radius=2.5, min_gap=8, min_inliers=10)
BACKEND_SOLVE = dict(iterations=10, cg_iters=60)
# The JAX package at this point finds 7 cross-robot closures (of 16
# candidates; reference_backend.py --robot-frames 60, CPU; 9 over the whole
# laps): the port must find at least one.
REFERENCE_CROSS_EDGES = 7
# card against CPU: verify_loop's rel, optimize_graph's poses
VERIFY_REL_BOUND = 1e-3
GRAPH_POSE_BOUND = 1e-4
# one solve of this graph before the per-edge products went through K4 (the
# einsums): its kernels and kernel time under torch.profiler on an NVIDIA
# H100 80GB HBM3 at 700 W, over four runs of this phase
SOLVE_BEFORE_K4 = "28,284-28,386 kernels, 44.27-44.63 ms of kernel time"
# K4's blocks held against the whole launch's rows: the rows of a shard of
# 2, 4 and 8 ranks of the session's 512 edge slots
K4_BLOCKS = (256, 128, 64)


def device_kernels(fn):
    """(kernels, their device ms) of one call of fn under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return len(us), sum(us) / 1e3


def sync_probe(fn):
    """(fn(), the host syncs it made, its device ms by CUDA events, its
    wall ms to the device's end): the syncs caught as warnings under
    torch.cuda.set_sync_debug_mode("warn")."""
    import torch

    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            h0 = time.perf_counter()
            e0.record()
            out = fn()
            e1.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - h0) * 1e3
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    return out, syncs, e0.elapsed_time(e1), wall


def keyframe_error(poses, graph, seq):
    """Planar error (m) of each keyframe against the ground truth at its
    stamp (tests/test_multi_robot.py:160-172)."""
    n = len(poses)
    stamps = graph.stamp[:n].cpu().numpy()
    idx = np.clip(np.searchsorted(seq.stamps, stamps - 1e-6), 0,
                  len(seq.stamps) - 1)
    return np.linalg.norm(poses[:, :2, 3] - seq.poses[idx][:, :2, 3],
                          axis=-1)


def rel_gap(a, b):
    """(max |dt| m, rotation angle rad) between two 4x4 transforms
    (visfs_tpu_torch.multichip's)."""
    from visfs_tpu_torch.multichip import rel_gap as gap

    return gap(a, b)


def phase_backend(cached_textured_sequence, cache_dir, ate_rmse, expect):
    """The mapping back-end on the card: MultiRobotMapping (two robots, one
    System each, K1 on every frame) -> close_loops -> optimize, with
    verify_loop and optimize_graph also run on "cpu" from the same inputs.
    expect: {(kernel module, launch counter): launches per frame} over the
    VO loop, every count set to 0 just before it and read just after."""
    import torch

    from visfs_tpu_torch.core.camera import make_stereo_camera
    from visfs_tpu_torch.core.lie import se3_matrix
    from visfs_tpu_torch.io import checkpoint
    from visfs_tpu_torch.ops.kernels import edge_products as k4_mod
    from visfs_tpu_torch.ops.kernels import segment_sum as k3_mod
    from visfs_tpu_torch.slam import mapping
    from visfs_tpu_torch.slam.multi_robot import MultiRobotMapping

    seq = cached_textured_sequence(cache_dir=cache_dir, device="cuda",
                                   **BACKEND_RENDER)
    lap = BACKEND_FRAMES // 2
    robot_frames = (range(0, BACKEND_ROBOT_FRAMES),
                    range(lap, lap + BACKEND_ROBOT_FRAMES))
    n_vo = 2 * BACKEND_ROBOT_FRAMES
    lefts = [torch.as_tensor(f, device="cuda") for f in seq.left]
    rights = [torch.as_tensor(f, device="cuda") for f in seq.right]
    cam = seq.camera
    session = MultiRobotMapping(
        bench_params(WIDTH), 2, start_poses=[np.eye(4, dtype=np.float32),
                                             seq.poses[lap]],
        device="cuda", **BACKEND_SESSION)
    session.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                 float(cam.baseline), width=cam.width, height=cam.height)
    vo = {0: [], 1: []}  # the outputs the harvest pops, per robot
    for r, s in enumerate(session.systems):
        def recorded(pop=s.output_odometry_info, r=r):
            out = pop()
            if out is not None:
                vo[r].append(out)
            return out
        s.output_odometry_info = recorded
    torch.cuda.synchronize()
    for mod, counter in expect:
        setattr(mod, counter, 0)
    t0 = time.perf_counter()
    for r, frames in enumerate(robot_frames):
        for k in frames:
            session.input_primary_sensor_data(r, float(seq.stamps[k]),
                                              lefts[k], rights[k])
    session.finish()
    torch.cuda.synchronize()
    vo_s = time.perf_counter() - t0
    launches = {key: getattr(*key) for key in expect}

    robots = []
    for r, frames in enumerate(robot_frames):
        outs = vo[r][1:]  # after the bootstrap frame
        est = np.stack([session.start_poses[r] @ o.pose for o in outs])
        robots.append((ate_rmse(est, seq.poses[list(frames)[1:]]),
                       int(sum(bool(o.lost) for o in outs)), len(outs)))
    counts = session.keyframe_counts()
    backend = session.backend
    print(f"backend: VO {n_vo} frames in {vo_s:.2f} s "
          f"({n_vo / vo_s:.2f} fps, harvest and snapshots "
          f"included); robot ATE / lost: "
          + ", ".join(f"{a:.4f} m / {lost} of {n}" for a, lost, n in robots)
          + f"; keyframes {counts}; "
          + ", ".join(f"{mod.__name__.rsplit('.', 1)[-1]}.{counter} {c}"
                      for (mod, counter), c in launches.items()), flush=True)
    for r, (ate, lost, _) in enumerate(robots):
        if not ate <= ATE_GATE:
            fail(f"backend: robot {r} ATE {ate:.4f} m > {ATE_GATE}")
        if lost:
            fail(f"backend: robot {r} lost {lost} frames")
    for (mod, counter), per_frame in expect.items():
        if launches[mod, counter] != per_frame * n_vo:
            fail(f"backend: {mod.__name__}.{counter} is "
                 f"{launches[mod, counter]}, expected "
                 f"{per_frame * n_vo}")
    if min(counts) < 3:
        fail(f"backend: keyframes {counts}, fewer than 3 a robot")

    # close_loops, each verify_loop call recorded for the cpu comparison
    node_of = {id(snap): node for node, snap in backend.snapshots.items()}
    calls, verify = [], mapping.verify_loop

    def recorded_verify(si, sj, cam_, key, **kw):
        out = verify(si, sj, cam_, key, **kw)
        calls.append(((node_of[id(si)], node_of[id(sj)]), si, sj, key, kw,
                      out))
        return out

    candidates = len(backend.loop_candidates(BACKEND_LOOPS["radius"],
                                             BACKEND_LOOPS["min_gap"]))
    mapping.verify_loop = recorded_verify
    try:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        closures = session.close_loops(**BACKEND_LOOPS)
        e1.record()
        torch.cuda.synchronize()
        close_ms = ((time.perf_counter() - t0) * 1e3, e0.elapsed_time(e1))
    finally:
        mapping.verify_loop = verify
    cross = session.cross_robot_edges()
    decided = [(pair, bool(out[1]), int(out[2]))
               for pair, _, _, _, _, out in calls]
    print(f"backend: close_loops {close_ms[0]:.1f} ms wall, "
          f"{close_ms[1]:.1f} ms device span; {candidates} candidates, "
          f"{len(calls)} verified, {closures} closures, {cross} "
          f"cross-robot; decided (pair, ok, inliers): {decided}", flush=True)
    if REFERENCE_CROSS_EDGES and cross < 1:
        fail(f"backend: no cross-robot closure (the JAX package finds "
             f"{REFERENCE_CROSS_EDGES} here)")
    if not calls:
        fail("backend: close_loops verified no candidate")

    # one verify_loop call: host syncs, device time, kernels
    _, si, sj, key, kw, first = calls[0]
    again, syncs, v_dev, v_wall = sync_probe(
        lambda: verify(si, sj, session.camera, key, **kw))
    v_kernels, v_kms = device_kernels(
        lambda: verify(si, sj, session.camera, key, **kw))
    same = all(torch.equal(a, b) for a, b in zip(again, first))
    print(f"backend: one verify_loop {v_wall:.1f} ms wall, {v_dev:.2f} ms "
          f"device span, {v_kernels} kernels ({v_kms:.2f} ms of kernel "
          f"time, profiler), host syncs {len(syncs)}; the repeat "
          f"{'equals' if same else 'differs from'} close_loops' call",
          flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"backend: verify_loop sync: {msg[:200]}", flush=True)
    if syncs:
        fail(f"backend: {len(syncs)} host syncs in one verify_loop call")

    # card against cpu: every decided pair from the same snapshots and keys
    cpu_cam = make_stereo_camera(float(cam.fx), float(cam.fy),
                                 float(cam.cx), float(cam.cy),
                                 float(cam.baseline), width=cam.width,
                                 height=cam.height, device="cpu")
    worst = [0.0, 0.0, 0]
    for pair, si, sj, key, kw, (rel, ok, n) in calls:
        rel_c, ok_c, n_c = verify(
            mapping.KeyframeSnapshot(*(x.cpu() for x in si)),
            mapping.KeyframeSnapshot(*(x.cpu() for x in sj)), cpu_cam,
            key.cpu(), **kw)
        dt, dang = rel_gap(rel.cpu().numpy(), rel_c.numpy())
        dn = abs(int(n) - int(n_c))
        if bool(ok):
            worst = [max(worst[0], dt), max(worst[1], dang), worst[2]]
        worst[2] = max(worst[2], dn)
        if bool(ok) != bool(ok_c) or dn > 1 or (bool(ok) and (
                dt > VERIFY_REL_BOUND or dang > VERIFY_REL_BOUND)):
            fail(f"backend: verify_loop {pair} cuda vs cpu: ok "
                 f"{bool(ok)}/{bool(ok_c)}, inliers {int(n)}/{int(n_c)}, "
                 f"rel {dt:.3g} m, {dang:.3g} rad")
    print(f"backend: verify_loop cuda vs cpu on {len(calls)} pairs: ok "
          f"identical, inliers within {worst[2]}, accepted rel within "
          f"{worst[0]:.3g} m and {worst[1]:.3g} rad", flush=True)

    # optimize: the error before and after, chi2, syncs in one solve, the
    # same solve on cpu
    # every solve in PyTorch's default mode: the pose graph's per-edge
    # products (K4) and per-pose sums (K3) each in one fixed order, so each
    # solve of g0 gives one answer
    if torch.are_deterministic_algorithms_enabled():
        fail("backend: deterministic algorithms are on")
    g0 = backend.graph
    err0 = keyframe_error(session.poses(), g0, seq)
    chi2_0 = float(mapping.optimize_graph(g0, None, iterations=1,
                                          cg_iters=1)[1])
    (g_probe, chi2_probe), syncs, o_dev, o_wall = sync_probe(
        lambda: mapping.optimize_graph(g0, None, **BACKEND_SOLVE))
    profiled = []
    o_kernels, o_kms = device_kernels(
        lambda: profiled.append(mapping.optimize_graph(g0, None,
                                                       **BACKEND_SOLVE)))
    k3_mod.LAUNCHES = k4_mod.LAUNCHES = 0
    t0 = time.perf_counter()
    chi2 = session.optimize(**BACKEND_SOLVE)
    solve_wall = (time.perf_counter() - t0) * 1e3
    k3_launches, k4_launches = k3_mod.LAUNCHES, k4_mod.LAUNCHES
    # a Gauss-Newton step: the gradient, the blocks, the CG's first
    # residual and cg_iters matvecs, each one launch of either kernel
    k_expect = BACKEND_SOLVE["iterations"] * (BACKEND_SOLVE["cg_iters"] + 3)
    unequal = [f"{name} {f}" for name, g in (("profiled", profiled[0][0]),
                                             ("optimize", backend.graph))
               for f in ("pose_q", "pose_t")
               if not torch.equal(getattr(g, f), getattr(g_probe, f))]
    print(f"backend: three default-mode solves of the graph (the sync probe, "
          f"the profiled one, MultiRobotMapping.optimize): "
          f"{'bit-equal' if not unequal else f'differ in {unequal}'}, chi2 "
          f"{float(chi2_probe):.9g} / {float(profiled[0][1]):.9g} / "
          f"{chi2:.9g}; in optimize segment_sum.LAUNCHES {k3_launches}, "
          f"edge_products.LAUNCHES {k4_launches} (expected {k_expect} "
          f"each); deterministic algorithms "
          f"{torch.are_deterministic_algorithms_enabled()}", flush=True)
    if unequal or float(chi2_probe) != chi2:
        fail(f"backend: two default-mode solves of one graph differ "
             f"({unequal})")
    for name, n_launches in (("segment_sum", k3_launches),
                             ("edge_products", k4_launches)):
        if n_launches != k_expect:
            fail(f"backend: {name} launched {n_launches} times in "
                 f"optimize, expected {k_expect}")
    mapping_resumed(checkpoint, mapping, backend, g0, cache_dir)
    err1 = keyframe_error(session.poses(), backend.graph, seq)
    g_cpu, _ = mapping.optimize_graph(
        mapping.KeyframeGraph(*(x.cpu() for x in g0)), None, **BACKEND_SOLVE)
    n = int(g0.n_nodes)
    card = se3_matrix(g_probe.pose_q[:n], g_probe.pose_t[:n]).cpu()
    host = se3_matrix(g_cpu.pose_q[:n], g_cpu.pose_t[:n])
    gaps = [rel_gap(a.numpy(), b.numpy()) for a, b in zip(card, host)]
    g_dt, g_dang = max(g[0] for g in gaps), max(g[1] for g in gaps)
    g_words = sum(int((getattr(g_probe, f).cpu().view(torch.int32)
                       != getattr(g_cpu, f).view(torch.int32)).sum())
                  for f in ("pose_q", "pose_t"))
    held = (err1.max() <= 1.05 * err0.max() + 1e-3
            and err1.mean() <= 1.02 * err0.mean() + 1e-3)
    print(f"backend: optimize {solve_wall:.1f} ms wall (one solve: "
          f"{o_wall:.1f} ms wall, {o_dev:.2f} ms device span, {o_kernels} "
          f"kernels, {o_kms:.2f} ms of kernel time, host syncs "
          f"{len(syncs)}; before K4: {SOLVE_BEFORE_K4}); chi2 "
          f"{chi2_0:.6g} -> {chi2:.6g}; keyframe error "
          f"max {err0.max():.4f} -> {err1.max():.4f} m, mean "
          f"{err0.mean():.4f} -> {err1.mean():.4f} m (the reference test's "
          f"bounds {'held' if held else 'not held'}; the JAX package here: "
          f"not held, reference_backend.py); optimize_graph cuda vs cpu "
          f"within {g_dt:.3g} m and {g_dang:.3g} rad ({g_words} words of "
          f"the poses differ)", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"backend: optimize sync: {msg[:200]}", flush=True)
    if syncs:
        fail(f"backend: {len(syncs)} host syncs in one pose-graph solve")
    if not (np.isfinite(chi2) and chi2 < chi2_0):
        fail(f"backend: chi2 {chi2_0:.6g} -> {chi2:.6g}")
    if not np.all(np.isfinite(err1)) or not err1.max() <= ATE_GATE:
        fail(f"backend: keyframe error after optimize {err1.max():.4f} m "
             f"> {ATE_GATE}")
    if g_dt > GRAPH_POSE_BOUND or g_dang > GRAPH_POSE_BOUND:
        fail(f"backend: optimize_graph cuda vs cpu {g_dt:.3g} m, "
             f"{g_dang:.3g} rad")
    return (launches, k3_launches, k4_launches,
            solve_kernels(mapping, k3_mod, k4_mod, g0))


def solve_kernels(mapping, k3_mod, k4_mod, g0):
    """K3 and K4 against their plain versions at the shapes phase backend's
    solve gives them: the inputs of the first Gauss-Newton step of g0 as
    the solve hands them over (one iteration of one CG step: K3's first
    call at each shape, K4's gradient and blocks, and its last matvec, the
    CG step's, whose x is not 0).  Their device times come from one fresh
    process.  Returns (K3's one-solve totals, K4's)."""
    from visfs_tpu_torch.parallel import pose_graph

    k3_seen, k4_seen = {}, {}
    real = {name: getattr(pose_graph, name) for name in (
        "segment_sum", "edge_gradient", "edge_blocks", "edge_matvec")}

    def keep_sum(terms, seg, n):
        k3_seen.setdefault(tuple(terms.shape[2:]), (terms, seg, n))
        return real["segment_sum"](terms, seg, n)

    def keep(entry):
        def call(*args):
            k4_seen[entry] = args
            return real[f"edge_{entry}"](*args)
        return call

    pose_graph.segment_sum = keep_sum
    for entry in k4_mod.ENTRIES:
        setattr(pose_graph, f"edge_{entry}", keep(entry))
    try:
        mapping.optimize_graph(g0, None, iterations=1, cg_iters=1)
    finally:
        for name, fn in real.items():
            setattr(pose_graph, name, fn)
    device_us = solve_device_us_fresh(k3_seen, k4_seen)
    return (phase_k3(k3_mod, k3_seen, device_us["k3"]),
            phase_k4(k4_mod, k4_seen, device_us["k4"]))


def phase_k3(k3_mod, seen, device_us):
    """K3, the pose graph's fixed-order per-pose sum, against its plain
    version on the terms of the solve's first Gauss-Newton step (shape ->
    (terms, layout, n): the gradient and each CG matvec [E, 2, 6], the
    preconditioner blocks [E, 2, 6, 6]).  The kernel on "cuda" against the
    plain version (index_add_, which adds in order on the CPU) on the same
    terms copied to "cpu": bit-equal (tolerance 0); against the plain
    version on "cuda" (index_add_ in atomic order): printed.  Returns one
    solve's worth (BACKEND_SOLVE: iterations x (cg_iters + 2) launches at
    [N, 6] and iterations at [N, 6, 6]) of the device ms, the plain
    version's and one index_add_ call's (the library call: all 2E
    endpoints, atomic order) CUDA-event ms, and the bound: each walked
    term, its row index, the run starts and the output once, one add per
    walked term and column."""
    import torch

    rows = {}
    for shape, (terms, seg, n) in sorted(seen.items()):
        label = f"k3 [{n}, {', '.join(map(str, shape))}]"
        out = k3_mod.segment_sum_cuda(terms, seg, n)
        host = k3_mod.segment_sum_reference(
            terms.cpu(), k3_mod.Segments(*(x.cpu() for x in seg)), n)
        err = float((out.cpu() - host).abs().max())
        bit_equal = torch.equal(out.cpu().view(torch.int32),
                                host.view(torch.int32))
        atomic = float((k3_mod.segment_sum_reference(terms, seg, n)
                        - out).abs().max())
        call_ms = cuda_time_ms(lambda: k3_mod.segment_sum_cuda(terms, seg, n))
        ms, how = device_us[shape], "profiler, a fresh process"
        if ms is None:
            ms, how = call_ms, ("CUDA events around a call: the fresh "
                                "process's traces held no launch")
        else:
            ms /= 1e3
        plain_ms = cuda_time_ms(
            lambda: k3_mod.segment_sum_reference(terms, seg, n))
        e, cols = terms.shape[0], terms[0, 0].numel()
        flat = terms.reshape(2 * e, cols)
        keys = torch.stack((seg.i, seg.j), 1).reshape(-1)
        acc = torch.zeros((n, cols), dtype=terms.dtype, device=terms.device)
        library_ms = cuda_time_ms(lambda: acc.index_add_(0, keys, flat))
        walked = int(seg.start[-1])
        bytes_ms, ops_ms = bound(
            walked * cols * 4 + walked * 8 + (n + 1) * 8 + n * cols * 4,
            walked * cols)
        rows[shape] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bytes_ms=bytes_ms,
                           ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                           max_abs_err=err)
        print(f"{label}: {e} edges, {walked} endpoints walked, largest run "
              f"{int((seg.start[1:] - seg.start[:-1]).max())}; kernel "
              f"{ms * 1e3:.2f} us device ({how}; call {call_ms:.3f} ms), "
              f"plain "
              f"{plain_ms:.3f} ms, one index_add_ {library_ms:.3f} ms, "
              f"bound {max(bytes_ms, ops_ms) * 1e3:.4f} us "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}); "
              f"against the plain version on cpu max |d| {err:.3g} "
              f"({'bit-equal' if bit_equal else 'NOT bit-equal'}), on cuda "
              f"(atomic order) {atomic:.3g}", flush=True)
        if not bit_equal:
            fail(f"{label}: the kernel is not bit-equal to its plain version "
                 f"on cpu (max |d| {err:.3g})")
    if set(rows) != {(6,), (6, 6)}:
        fail(f"k3: the solve's scatters have shapes {sorted(rows)}")
    per_solve = {(6,): BACKEND_SOLVE["iterations"]
                 * (BACKEND_SOLVE["cg_iters"] + 2),
                 (6, 6): BACKEND_SOLVE["iterations"]}
    return solve_totals("k3", rows, per_solve)


def solve_totals(label, rows, per_solve):
    """One solve's worth of a kernel's rows (each row times its launches in
    a solve), which bound dominates, the largest error; printed."""
    tot = {k: sum(per_solve[key] * r[k] for key, r in rows.items())
           for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                     "bytes_ms", "ops_ms")}
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                       else "operations")
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    print(f"{label}: one solve ({sum(per_solve.values())} launches): "
          + json.dumps({k: tot[k] for k in ("ms", "call_ms", "plain_ms",
                                            "library_ms", "bound_ms")}),
          flush=True)
    return tot


def k4_work(entry, args):
    """(bytes, operations) that K4's entry needs on these inputs: w for
    every edge; Ji and Jj, and r (gradient) or the gathered x rows and the
    two indices (matvec), for the live edges (weight not 0: a dead edge's
    terms are +0 whatever its Jacobians); the output once.  Operations a
    live edge: gradient 6 + 2 x 6 x 12 = 150, blocks 2 x (36 + 36 x 12) =
    936, matvec the gradient's and y (2 x 6 x 12 + 6) = 300."""
    w = args[0]
    e, live = w.shape[0], int((w != 0).sum())
    if entry == "blocks":
        return 4 * e + live * 2 * 36 * 4 + e * 72 * 4, live * 936
    per_live = 2 * 36 * 4 + (6 * 4 if entry == "gradient"
                             else 2 * 6 * 4 + 2 * 8)
    return (4 * e + live * per_live + e * 12 * 4,
            live * (150 if entry == "gradient" else 300))


def phase_k4(k4_mod, seen, device_us):
    """K4, the pose graph's per-edge products, at the shapes of the solve's
    first Gauss-Newton step (entry -> its inputs).  The kernel on "cuda"
    against the order oracle on the same inputs copied to "cpu": bit-equal
    (tolerance 0); against the plain version (the einsums) on "cpu": the
    differing bits printed (0 where the CPU's einsum adds as the oracle
    does); each block of K4_BLOCKS rows (a shard of 2, 4 and 8 ranks)
    launched alone against the same rows of the whole launch: bit-equal
    (tolerance 0); against the plain version on "cuda" (cuBLAS): the
    largest difference printed.  Returns one solve's worth (BACKEND_SOLVE:
    iterations gradient and blocks launches, iterations x (cg_iters + 1)
    matvecs) of the device ms, the call, the plain version's and the
    library call's CUDA-event ms (the einsums the solve made before, on the
    card, without the stack), and the bound (k4_work)."""
    import torch

    def bits(x):
        return x.contiguous().view(torch.int32)

    def einsums(entry, w, Ji, Jj, *rest):
        if entry == "blocks":
            return (torch.einsum("e,eki,ekj->eij", w, Ji, Ji),
                    torch.einsum("e,eki,ekj->eij", w, Jj, Jj))
        if entry == "gradient":
            (v,) = rest
        else:
            x, ei, ej = rest
            v = torch.einsum("eki,ei->ek", Ji, x[ei]) \
                + torch.einsum("eki,ei->ek", Jj, x[ej])
        return (torch.einsum("e,eki,ek->ei", w, Ji, v),
                torch.einsum("e,eki,ek->ei", w, Jj, v))

    rows = {}
    for entry in k4_mod.ENTRIES:
        args = seen[entry]
        e = args[0].shape[0]
        label = f"k4 {entry} [{e}, 2{', 6' * (2 if entry == 'blocks' else 1)}]"
        out = k4_mod.edge_products_cuda(entry, *args)
        host_args = tuple(a.cpu() for a in args)
        oracle = k4_mod.edge_products_oracle(entry, *host_args)
        plain_cpu = k4_mod.edge_products_reference(entry, *host_args)
        plain_cuda = k4_mod.edge_products_reference(entry, *args)
        got = out.cpu()
        err = float((got - oracle).abs().max())
        oracle_bits = int((bits(got) != bits(oracle)).sum())
        cpu_bits = int((bits(got) != bits(plain_cpu)).sum())
        cublas = float((plain_cuda - out).abs().max())
        block_bits = {}
        for size in K4_BLOCKS:
            n_diff = 0
            for lo in range(0, e, size):
                part = tuple(a if k == 3 and entry == "matvec"
                             else a[lo:lo + size] for k, a in enumerate(args))
                n_diff += int((bits(k4_mod.edge_products_cuda(entry, *part))
                               != bits(out[lo:lo + size])).sum())
            block_bits[size] = n_diff
        call_ms = cuda_time_ms(lambda: k4_mod.edge_products_cuda(entry,
                                                                 *args))
        ms, how = device_us[entry], "profiler, a fresh process"
        if ms is None:
            ms, how = call_ms, ("CUDA events around a call: the fresh "
                                "process's traces held no launch")
        else:
            ms /= 1e3
        plain_ms = cuda_time_ms(
            lambda: k4_mod.edge_products_reference(entry, *args))
        library_ms = cuda_time_ms(lambda: einsums(entry, *args))
        n_bytes, ops = k4_work(entry, args)
        bytes_ms, ops_ms = bound(n_bytes, ops)
        rows[entry] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bytes_ms=bytes_ms,
                           ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                           max_abs_err=err)
        print(f"{label}: {int((args[0] != 0).sum())} live edges of {e}; "
              f"kernel {ms * 1e3:.2f} us device ({how}; call "
              f"{call_ms:.3f} ms), plain {plain_ms:.3f} ms, the einsums "
              f"{library_ms:.3f} ms, bound "
              f"{max(bytes_ms, ops_ms) * 1e3:.4f} us "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}); "
              f"against the order oracle on cpu {oracle_bits} words differ "
              f"(max |d| {err:.3g}), the plain version on cpu {cpu_bits} "
              f"words; blocks of "
              + ", ".join(f"{size} rows {n} words" for size, n
                          in block_bits.items())
              + f" differ from the whole launch's rows; the plain version "
              f"on cuda (cuBLAS) max |d| {cublas:.3g}", flush=True)
        if oracle_bits:
            fail(f"{label}: the kernel is not bit-equal to the order oracle "
                 f"on cpu ({oracle_bits} words, max |d| {err:.3g})")
        if any(block_bits.values()):
            fail(f"{label}: a block's launch differs from the whole "
                 f"launch's rows ({block_bits})")
    it, cg = BACKEND_SOLVE["iterations"], BACKEND_SOLVE["cg_iters"]
    return solve_totals("k4", rows, {"gradient": it, "blocks": it,
                                     "matvec": it * (cg + 1)})


def solve_device_us_fresh(k3_seen, k4_seen):
    """K3's and K4's device us a launch on phase backend's inputs ({"k3":
    shape -> us, "k4": entry -> us}), from torch.profiler traces in a fresh
    process (``chip_smoke.py --solve-device-us PATH``, the inputs saved
    under build/): late in this script a trace of K3's launches has come
    back with no device record, where a fresh process's hold them.  None
    where no trace shows the kernel."""
    import torch

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "solve_kernel_inputs.pt")
    torch.save({"k3": {shape: (terms.cpu(), tuple(x.cpu() for x in seg), n)
                       for shape, (terms, seg, n) in k3_seen.items()},
                "k4": {entry: tuple(a.cpu() for a in args)
                       for entry, args in k4_seen.items()}}, path)
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--solve-device-us", path], capture_output=True,
                         text=True, timeout=300)
    if run.returncode != 0:
        fail(f"k3/k4: the timing process exited {run.returncode}: "
             f"{run.stderr[-2000:]}")
    found = json.loads(run.stdout.strip().splitlines()[-1])
    return {"k3": {shape: found["k3"][str(list(shape))] for shape in k3_seen},
            "k4": {entry: found["k4"][entry] for entry in k4_seen}}


def solve_device_us(path):
    """The fresh process of solve_device_us_fresh: prints one JSON object,
    {"k3": str(list(shape)) -> K3's median device us a launch, "k4": entry
    -> K4's} (None where no trace shows the kernel)."""
    import torch

    from visfs_tpu_torch.ops.kernels import edge_products as k4_mod
    from visfs_tpu_torch.ops.kernels import segment_sum as k3_mod

    saved = torch.load(path)
    out = {"k3": {}, "k4": {}}
    for shape, (terms, seg, n) in saved["k3"].items():
        terms = terms.cuda()
        seg = k3_mod.Segments(*(x.cuda() for x in seg))
        ms, _ = kernel_device_ms(
            lambda: k3_mod.segment_sum_cuda(terms, seg, n),
            "segment_sum_kernel")
        out["k3"][str(list(shape))] = None if ms is None else ms * 1e3
    for entry, args in saved["k4"].items():
        args = tuple(a.cuda() for a in args)
        ms, _ = kernel_device_ms(
            lambda: k4_mod.edge_products_cuda(entry, *args),
            "edge_products_kernel")
        out["k4"][entry] = None if ms is None else ms * 1e3
    print(json.dumps(out), flush=True)


def phase_render(cache_dir):
    """The CUDA render held against the CPU render (bit-equal to the
    reference's, tests/test_torch_sim_starfield.py): the first two and the
    last frame of each scene the card phases render (the bench loop with
    its depth, phase s3's laser loop, phase backend's two-lap loop), both
    views ray-cast on "cuda" and on "cpu" before exposure, noise and
    quantization; the pixels, depths and scan beams that differ and the
    largest |d| printed (images in [0, 1]; x 175 is 8-bit levels)."""
    from visfs_tpu_torch.io.sim import render_textured_views

    scenes = (("bench", dict(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT,
                             motion="square", seed=0, speed=2.0)),
              ("s3", S3_RENDER), ("backend", BACKEND_RENDER))
    found = {}
    for name, kw in scenes:
        frames = (0, 1, kw["n_frames"] - 1)
        card, host = (render_textured_views(frames, device=dev, **kw)
                      for dev in ("cuda", "cpu"))
        parts = []
        for what, a, b in zip(("images", "depth", "scans"), card, host):
            if a is None:
                continue
            diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
            found[name, what] = (int((diff > 0).sum()), float(diff.max()))
            parts.append(f"{what} {found[name, what][0]} of {diff.size} "
                         f"differ, max |d| {found[name, what][1]:.3g}")
        print(f"render {name} frames {frames} cuda vs cpu: "
              + "; ".join(parts), flush=True)
    return found


def phase_dp(cache_dir):
    """The multi-card entry at min(4, cards) ranks over NCCL (its gates
    are the phase's); returns the K1 pyramid launches of its ranks'
    paths."""
    import torch

    from visfs_tpu_torch import multichip

    world = min(4, torch.cuda.device_count())
    report = multichip.run(world, "cuda", WIDTH, HEIGHT, frames=DP_FRAMES,
                           robot_frames=DP_ROBOT_FRAMES,
                           cache_dir=cache_dir)
    a, b, c = (report["sections"][k] for k in "abc")
    print(f"dp: world {world} over {report['backend']} on "
          f"{report['cards']} in {report['seconds']:.1f} s; aggregate fps "
          f"a {a['fps_aggregate']:.2f}, b {b['fps_aggregate']:.2f}; gather "
          f"device ms a frame a {a['gather_device_ms_per_frame']:.3f}, b "
          f"{b['gather_device_ms_per_frame']:.3f}; close-and-solve "
          f"{c['close_and_solve_s']:.2f} s; K1 pyramid launches "
          f"{report['k1_pyramid_launches']}", flush=True)
    failed = [f"{name}: {gate}" for name, sec in report["sections"].items()
              for gate, ok in sec["gates"].items() if not ok]
    if failed:
        fail(f"dp: {failed}")
    return report["k1_pyramid_launches"]


def mapping_resumed(checkpoint, mapping, backend, g0, cache_dir):
    """Checkpoint/resume of the session's back-end: ``backend`` (its graph
    g0 before the solve, its snapshots and bookkeeping) through
    save_mapping into a fresh MappingBackend by restore_mapping, then one
    solve of each graph in PyTorch's default mode: bit-equal."""
    import torch

    ckpt = os.path.join(os.path.dirname(cache_dir), "node_ckpt",
                        "backend_mapping.npz")
    saved = backend.graph
    backend.graph = g0
    try:
        checkpoint.save_mapping(ckpt, backend)
    finally:
        backend.graph = saved
    restored = mapping.MappingBackend(
        None, max_nodes=BACKEND_SESSION["max_nodes"],
        max_edges=BACKEND_SESSION["max_edges"], device="cuda")
    checkpoint.restore_mapping(ckpt, restored)
    unequal = [f for f in mapping.KeyframeGraph._fields
               if not torch.equal(getattr(restored.graph, f),
                                  getattr(g0, f))]
    unequal += [f"snapshot {k}" for k in sorted(backend.snapshots)
                if k not in restored.snapshots or not all(
                    torch.equal(a, b) for a, b in zip(
                        restored.snapshots[k], backend.snapshots[k]))]
    g_a, chi2_a = mapping.optimize_graph(g0, None, **BACKEND_SOLVE)
    chi2_b = restored.optimize(**BACKEND_SOLVE)
    solved = [f for f in mapping.KeyframeGraph._fields
              if not torch.equal(getattr(restored.graph, f),
                                 getattr(g_a, f))]
    print(f"backend: save_mapping -> restore_mapping: graph and "
          f"{len(restored.snapshots)} snapshots "
          f"{'bit-equal' if not unequal else f'differ: {unequal}'}; one "
          f"solve each (default mode): "
          f"{'bit-equal' if not solved else f'differs in {solved}'}, chi2 "
          f"{float(chi2_a):.9g} / {chi2_b:.9g}", flush=True)
    if unequal or solved or float(chi2_a) != chi2_b:
        fail(f"backend: the restored mapping is not bit-equal "
             f"({unequal}, {solved})")


# phase node: the frames stepped directly on the node's System and on its
# restored copy after the run (phase s3's sequence has 120)
NODE_RESUMED = 5
# phase node's main thread drains outputs and waits for queue space at 50
# Hz: no wheel push blocks it, and a poll every 1 ms takes the GIL from the
# worker's eager step (on an H100 host the node ran 1.07 fps beside phase
# mapping's 1.87 with it)
NODE_POLL_S = 0.02


def node_adapter(seq, op, transport, use_native_runtime):
    """A VISFSAdapter on "cuda" over ``transport`` with phase s3's System
    sizes."""
    from visfs_tpu_torch.io.adapter import VISFSAdapter
    from visfs_tpu_torch.slam.system import System

    def system_cls(params, device):
        return System(params, device=device, scan_capacity=S3_SCAN_CAPACITY,
                      submap_extent_cells=256)

    return VISFSAdapter(op, transport, system_cls=system_cls,
                        use_native_runtime=use_native_runtime, device="cuda")


def phase_node(cached_textured_sequence, cache_dir, ate_rmse, expect):
    """The node on the card: configs/sim_mapping.yaml's whole operating
    point (node block: approx sync, queue 10, slop 0.01; visfs block:
    strategy 3 with CLAHE) through VISFSAdapter(use_native_runtime=True)
    over a StaticTransport, its frame tree the sequence's own extrinsics
    (identity) and its baseline the right camera info's (base_line 0, as
    tests/test_zmq_transport.py runs it).  Phase s3's 640x480 sequence
    (seed 1, 180-beam scans, 10 wheel rows a frame), its first MODE_FRAMES
    frames injected from the main thread as host numpy in stamp order
    (wheel rows, scan, left, right), the next frame only while the synced
    queue holds fewer than capacity - 1, spin_once draining between; the
    runtime's C++ worker steps the System meanwhile, so wheel rows for
    later stamps arrive while steps run.  Gates: ATE and lost over frames
    2.., phase s3's map gate, exactly ``expect`` launches a frame (counts
    set to 0 just before the run, read after stop()), synced = processed =
    frames, nothing dropped, an odom and an odom_info a frame, the
    odometry buffer's head equal to the rows injected, 0 host syncs in one
    frame's feed of host numpy (a probe System: its wheel rows, the frames
    and the scan), the System
    saved and restored into a fresh one and both stepped on the next
    NODE_RESUMED frames bit-equal, render_frame and render_submap shapes.
    Printed: fps, the enqueue-to-publish latency p50/p99 (host clock: the
    right image's injection to its odom publish), the runtime's
    last_latency_ms."""
    import torch

    from visfs_tpu_torch.io import checkpoint
    from visfs_tpu_torch.io.adapter import CameraInfo, StaticTransport
    from visfs_tpu_torch.operating_points import operating_point
    from visfs_tpu_torch.slam.monitor import render_frame, render_submap

    seq = cached_textured_sequence(cache_dir=cache_dir, device="cuda",
                                   **S3_RENDER)
    n = MODE_FRAMES
    cam = seq.camera
    fx, fy, cx, cy = (float(cam.fx), float(cam.fy), float(cam.cx),
                      float(cam.cy))
    infos = (CameraInfo(cam.width, cam.height, fx, fy, cx, cy),
             CameraInfo(cam.width, cam.height, fx, fy, cx, cy,
                        tx=-fx * float(cam.baseline)))
    op = operating_point("sim_mapping")
    op.node["base_line"] = 0.0
    op.frames = {c: {"parent": "base_link", "xyz": [0.0, 0.0, 0.0],
                     "rpy": [0.0, 0.0, 0.0]}
                 for c in ("camera_link", "sick_laser_link")}

    # numpy frames enter without a host sync (a probe System: frame 0,
    # then frame 1's wheel rows and frame under the sync check)
    probe = node_adapter(seq, op, StaticTransport(*infos, frames=op.frames),
                         False).system
    feed = wheel_and_scan_feeder(probe, seq, seq.left, seq.right)
    feed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        feed(1)
    except RuntimeError as e:
        fail(f"node: a host sync feeding numpy frames: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    probe.drain_outputs()
    del probe

    tr = StaticTransport(*infos, frames=op.frames)
    published_at = {}
    publish = tr.publish

    def timed_publish(topic, message):  # keyed by the float32 stamp
        if topic == "odom":
            published_at[float(message.stamp)] = time.perf_counter()
        publish(topic, message)

    tr.publish = timed_publish
    ad = node_adapter(seq, op, tr, True)
    sys_ = ad.system
    capacity = int(op.node["queue_size"])
    slop = 0.01 if op.node.get("approx_sync", True) else 0.0
    print(f"node: VISFSAdapter on {sys_.device}, native runtime queue "
          f"{capacity}, slop {slop} s; strategy "
          f"{sys_.cfg.system_sensor_strategy}, CLAHE {sys_.cfg.system_clahe}"
          f", baseline {float(sys_.camera.baseline):.4f} m from the camera "
          f"info; {n} frames {WIDTH}x{HEIGHT}", flush=True)
    injected_at, rows, done = {}, 0, 0
    odom = seq.wheel_odom
    for mod, counter in expect:
        setattr(mod, counter, 0)
    t0 = time.perf_counter()
    ad.start()
    try:
        for i in range(n):
            while ad._rt.rt.queue_depth() >= capacity - 1 \
                    and not ad._rt.errors:
                done += ad.spin_once()
                time.sleep(NODE_POLL_S)
            t = float(seq.stamps[i])
            while rows < len(odom) and odom[rows][0] <= t + 1e-9:
                tr.inject("wheel_odom", float(odom[rows][0]),
                          odom[rows][1:7])
                rows += 1
            tr.inject("laser_scan", t, seq.laser_scans[i])
            tr.inject("left/image", t, seq.left[i])
            injected_at[float(np.float32(t))] = time.perf_counter()
            tr.inject("right/image", t, seq.right[i])
            done += ad.spin_once()
        deadline = time.perf_counter() + 300.0
        while done < n and time.perf_counter() < deadline \
                and not ad._rt.errors:
            done += ad.spin_once()
            time.sleep(NODE_POLL_S)
    finally:
        ad.stop()
    if ad._rt.errors:
        fail(f"node: {len(ad._rt.errors)} steps raised on the runtime's "
             f"worker, the first: {ad._rt.errors[0]!r}")
    elapsed = max(published_at.values(), default=t0) - t0
    launches = {key: getattr(*key) for key in expect}
    stats = ad._rt.stats()
    head = int(sys_.state.odom.head)
    odoms, infos_out = tr.published.get("odom", []), \
        tr.published.get("odom_info", [])
    lat = np.array([published_at[t] - injected_at[t]
                    for t in injected_at if t in published_at]) * 1e3
    est = np.stack([np.eye(4)] * len(odoms)).astype(np.float32)
    for k, o in enumerate(odoms):
        est[k, :3, 3] = o.position
    ate = ate_rmse(est[2:], seq.poses[2:len(odoms)]) \
        if len(odoms) > 2 else float("inf")
    lost = sum(bool(m.lost) for m in infos_out[2:])
    counts = ", ".join(f"{mod.__name__.rsplit('.', 1)[-1]}.{counter} {c} "
                       f"({c / n:g}/frame)"
                       for (mod, counter), c in launches.items())
    print(f"node: {len(odoms)} odom / {len(infos_out)} odom_info published "
          f"in {elapsed:.2f} s ({n / max(elapsed, 1e-9):.2f} fps), ATE "
          f"{ate:.4f} m over frames 2-{n - 1}, lost {lost}, {counts}; "
          f"enqueue-to-publish latency p50 {np.percentile(lat, 50):.1f} ms, "
          f"p99 {np.percentile(lat, 99):.1f} ms, max {lat.max():.1f} ms "
          f"(host clock, {len(lat)} frames); runtime stats "
          + json.dumps(stats) + f"; wheel rows injected {rows}, odometry "
          f"head {head}", flush=True)
    map_gate(sys_.state.laser.submaps, seq.room, "node")
    if not ate <= ATE_GATE:
        fail(f"node: ATE {ate:.4f} m > {ATE_GATE}")
    if lost:
        fail(f"node: {lost} lost frames")
    for (mod, counter), per_frame in expect.items():
        if launches[mod, counter] != per_frame * n:
            fail(f"node: {mod.__name__}.{counter} is "
                 f"{launches[mod, counter]}, expected {per_frame * n}")
    if not (stats["synced"] == stats["processed"] == n
            and stats["dropped_unmatched"] == stats["dropped_overflow"] == 0
            and len(odoms) == len(infos_out) == n):
        fail(f"node: runtime stats {stats}, {len(odoms)} odom and "
             f"{len(infos_out)} odom_info published, expected {n}")
    if head != rows:
        fail(f"node: odometry head {head}, {rows} wheel rows injected")

    # checkpoint/resume: the node's System saved, restored into a fresh
    # System of the same parameters, both stepped on the next frames
    path = os.path.join(os.path.dirname(cache_dir), "node_ckpt", "system")
    checkpoint.save_system(path, sys_)
    fresh = node_adapter(seq, op, StaticTransport(*infos, frames=op.frames),
                         False).system
    checkpoint.restore_system(path, fresh)
    outs = []
    for s_ in (sys_, fresh):
        feed = wheel_and_scan_feeder(s_, seq, seq.left, seq.right, row=rows)
        for i in range(n, n + NODE_RESUMED):
            feed(i)
        outs.append(s_.drain_outputs())
    differ = sorted({f for a, b in zip(*outs) for f in a._fields
                     if not np.array_equal(np.asarray(getattr(a, f)),
                                           np.asarray(getattr(b, f)))})
    print(f"node: save_system -> restore_system -> {NODE_RESUMED} frames on "
          f"both: outputs {'bit-equal' if not differ else f'differ in {differ}'}"
          f", last pose gap "
          f"{float(np.abs(outs[0][-1].pose - outs[1][-1].pose).max()):.3g}",
          flush=True)
    if differ or len(outs[0]) != NODE_RESUMED:
        fail(f"node: the restored System's outputs differ in {differ}")

    canvas = render_frame(sys_.state, seq.left[n + NODE_RESUMED - 1],
                          seq.right[n + NODE_RESUMED - 1])
    sub = render_submap(sys_.state)
    print(f"node: render_frame {canvas.shape} {canvas.dtype}, render_submap "
          f"{None if sub is None else (sub.shape, str(sub.dtype))}",
          flush=True)
    if canvas.shape != (HEIGHT, 2 * WIDTH, 3) or sub is None \
            or sub.shape != (256, 256):
        fail("node: the monitor's renders have the wrong shapes")
    return launches


def fusion_params(params, strategy):
    return dict(params, **{"System/SensorStrategy": strategy,
                           "LocalMap/NumRangeDataLimit": 3})


def stepped_fusion(System, seq, p, label, wheel):
    """Each frame stepped on "cuda" from the "cpu" run's state, with
    scans.  With wheel rows (strategy 4) the step is held as compare_runs
    and compare_submaps hold it.  Without (strategy 5) the laser-only BA
    leaves z, roll and pitch unobserved and its float32 steps follow the
    rounding noise (reference_laser_noise.py: one ulp of its state moves
    the reference's step by up to centimetres), so the step is held on
    what that noise does not decide: lost flags and inliers, the BA problem
    each side builds, that problem solved in float64 on both devices, the
    submap insertion replayed on "cuda" with the "cpu" step's inputs,
    and the submaps' slots, counts and finished flags.  The float32 gaps are
    printed with their parts: the same problem solved in float32 on both
    devices, and on "cpu" under one ulp of the problem.  Where the lost
    flags differ, the "cpu" step is taken again from its state under
    WITNESS_SEEDS random one-ulp nudges: "cuda"'s (inliers, lost) must be
    one of theirs, and the step is held, in all of the above, against the
    first nudged "cpu" step with that outcome."""
    import torch

    import visfs_tpu_torch.slam.estimator as est_mod
    import visfs_tpu_torch.solver.ba as ba_mod

    devs = gpu, cpu = "cuda", "cpu"
    sys_ = {dev: make_system(System, seq.camera, p, dev,
                             scan_capacity=S3_SCAN_CAPACITY)
            for dev in devs}
    feeds = {dev: wheel_and_scan_feeder(s, seq, seq.left, seq.right,
                                        wheel=wheel)
             for dev, s in sys_.items()}
    optimize, insert = ba_mod.local_optimize, est_mod.insert_range_data_active
    seen, side = {}, [None]

    def keep_ba(problem, settings):
        res = optimize(problem, settings)
        seen[side[0], "ba"] = (problem, settings, res)
        return res

    def keep_insert(*a, **kw):
        out = insert(*a, **kw)
        seen[side[0], "insert"] = (a, kw, out)
        return out

    def outcome(out):
        return int(out.n_inliers), bool(out.lost)

    def witness(i, before, want):
        """The state after the first nudged "cpu" step of frame i (from
        before) whose outcome is want; fails if none of WITNESS_SEEDS is."""
        after, got = sys_[cpu].state, []
        side[0] = "nudged"
        try:
            for seed in range(WITNESS_SEEDS):
                sys_[cpu].state = nudged(before, seed)
                feeds[cpu](i)
                got.append(outcome(sys_[cpu].drain_outputs()[-1]))
                if got[-1] == want:
                    return sys_[cpu].state, got
        finally:
            sys_[cpu].state = after
        fail(f"small {label}: frame {i} {gpu} (inliers, lost) {want}, none "
             f"of {WITNESS_SEEDS} one-ulp nudged {cpu} steps gives it: "
             f"{sorted(set(got))}")

    outs = {dev: [] for dev in devs}
    worst = {"problem": 0.0, "f64": 0.0, "f32": 0.0, "ulp": 0.0}
    cells, edges = [], []
    if not wheel:
        ba_mod.local_optimize = keep_ba
        est_mod.insert_range_data_active = keep_insert
    try:
        for i in range(len(seq.stamps)):
            before = sys_[cpu].state
            sys_[gpu].state = tensors_to(before, gpu)
            for dev in devs:
                side[0] = dev
                feeds[dev](i)
                outs[dev] += sys_[dev].drain_outputs()
            if wheel:
                continue
            a, b = outcome(outs[gpu][-1]), outcome(outs[cpu][-1])
            if abs(a[0] - b[0]) > 1:
                fail(f"small {label}: frame {i} inliers {a[0]}/{b[0]}")
            ref, held = cpu, sys_[cpu].state
            if a[1] != b[1]:
                ref = "nudged"
                held, got = witness(i, before, a)
                edges.append(f"frame {i} {gpu} {a} {cpu} {b}, {cpu} nudged "
                             f"{' '.join(map(str, got))}")
            # the cost grid is the state's submap cells looked up in its
            # cost table, before the step: held against the unnudged step
            prob_gpu = seen[gpu, "ba"][0]
            if not torch.equal(prob_gpu.laser.cost_grid.cpu(),
                               seen[cpu, "ba"][0].laser.cost_grid.cpu()):
                fail(f"small {label}: frame {i} cost grids differ")
            prob, settings, res = seen[ref, "ba"]
            valid = prob.pose_valid
            worst["problem"] = max(worst["problem"], pose_gap(
                f"{label}: frame {i} BA problem", prob_gpu, prob, valid))
            r64 = [optimize(tensors_to(prob, dev, torch.float64), settings)
                   for dev in devs]
            worst["f64"] = max(worst["f64"], pose_gap(
                f"{label}: frame {i} float64 BA", *r64, valid))
            r32 = optimize(tensors_to(prob, gpu), settings)
            worst["f32"] = max(worst["f32"], pose_gap(
                "", r32, res, valid, gate=False))
            r_ulp = optimize(nudged(prob), settings)
            worst["ulp"] = max(worst["ulp"], pose_gap(
                "", r_ulp, res, valid, gate=False))
            args, kw, sub = seen[ref, "insert"]
            compare_submaps(f"{label}: frame {i} insertion replayed",
                            insert(*tensors_to(args, gpu), **kw), sub)
            for f in ("slot_valid", "num_range_data", "finished"):
                x = getattr(sys_[gpu].state.laser.submaps, f).cpu()
                y = getattr(held.laser.submaps, f).cpu()
                if not torch.equal(x, y):
                    fail(f"small {label}: frame {i} {f} {x.tolist()} / "
                         f"{y.tolist()}")
            ca = sys_[gpu].state.laser.submaps.cells.cpu()
            cells.append(int((ca != held.laser.submaps.cells.cpu()).sum()))
    finally:
        ba_mod.local_optimize = optimize
        est_mod.insert_range_data_active = insert
    if wheel:
        line = compare_runs(f"{label} (stepped from the cpu state)",
                            outs[gpu], outs[cpu]) + "; " + compare_submaps(
            label, sys_[gpu].state.laser.submaps,
            sys_[cpu].state.laser.submaps)
    else:
        gaps = [float(np.abs(x.pose[:3, 3] - y.pose[:3, 3]).max())
                for x, y in zip(outs[gpu], outs[cpu])]
        line = (f"inliers within 1, lost flags identical or (frames where "
                f"they differ, (inliers, lost), each held against the first "
                f"one-ulp nudged {cpu} step with {gpu}'s outcome: "
                f"{'; '.join(edges) or 'none'}); BA problems within "
                f"{worst['problem']:.3g}, float64 BA within "
                f"{worst['f64']:.3g}, insertions replayed within the "
                f"submap gates, slots, counts and finished identical "
                f"(held); not held, float32 noise: the step's translation "
                f"gap per frame {' '.join(f'{g:.2g}' for g in gaps)} m, "
                f"the same problem in float32 on both devices up to "
                f"{worst['f32']:.3g}, on {cpu} under one ulp of the problem "
                f"up to {worst['ulp']:.3g}, cells different per frame "
                f"{' '.join(map(str, cells))}")
    print(f"small {label}: each frame stepped on {gpu} from the {cpu} run's "
          f"state: {line}", flush=True)


def pose_gap(label, a, b, valid, gate=True):
    """The largest translation (m) and rotation (rad) gap between the
    valid poses of two BA problems or results; fails beyond 1e-3 of
    either when gate.  Returns the larger."""
    import torch

    v = valid.cpu()
    qa, qb = a.pose_q.cpu().double()[v], b.pose_q.cpu().double()[v]
    dt = float((a.pose_t.cpu().double()[v] - b.pose_t.cpu().double()[v])
               .abs().max())
    dot = torch.abs((qa / qa.norm(dim=-1, keepdim=True)
                     * (qb / qb.norm(dim=-1, keepdim=True))).sum(-1))
    dr = float((2.0 * torch.acos(torch.clamp(dot, max=1.0))).max())
    if gate and (not dt <= 1e-3 or not dr <= 1e-3):
        fail(f"small {label}: translation {dt:.3g} m, rotation {dr:.3g} "
             f"rad apart")
    return max(dt, dr)


def nudged(x, seed=None):
    """x (a BAProblem, a VOState) with every float32 tensor one ulp away:
    up, or up or down at random from seed."""
    import torch

    g = None if seed is None else torch.Generator().manual_seed(seed)

    def one(t):
        if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32):
            return t
        up = torch.nextafter(t, torch.full_like(t, float("inf")))
        if g is None:
            return up
        down = torch.nextafter(t, torch.full_like(t, float("-inf")))
        pick = torch.randint(0, 2, t.shape, generator=g).bool()
        return torch.where(pick.to(t.device), up, down)
    return map_tensors(x, one)


def map_tensors(x, fn):
    """fn over every tensor of nested NamedTuples and tuples."""
    import torch

    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(map_tensors(v, fn) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(map_tensors(v, fn) for v in x)
    return x


def tensors_to(x, device, float_dtype=None):
    """x (a VOState, a BAProblem, an argument tuple) on device, its
    floating tensors in float_dtype where given."""
    def one(t):
        if float_dtype is not None and t.is_floating_point():
            return t.to(device, float_dtype)
        return t.to(device)
    return map_tensors(x, one)


def kernel_entry(name, source, replaces, launches, tot):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"],
            "library_ms": tot.get("library_ms")}


def main():
    if sys.argv[1:2] == ["--solve-device-us"]:
        return solve_device_us(sys.argv[2])
    if sys.argv[1:2] == ["--small-cpu"]:
        return small_cpu(*sys.argv[2:4])
    if sys.argv[1:2] == ["--s4"]:
        return s4_process(sys.argv[2])
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    try:
        from visfs_tpu_torch.io.sim import (ate_rmse,
                                            cached_textured_sequence)
        from visfs_tpu_torch.ops.kernels import _build
        from visfs_tpu_torch.ops.kernels import edge_products as k4_mod
        from visfs_tpu_torch.ops.kernels import lk_level as k1_mod
        from visfs_tpu_torch.ops.kernels import lk_xcorr as k2_mod
        from visfs_tpu_torch.ops.kernels import segment_sum as k3_mod
        from visfs_tpu_torch.slam.system import System
    except ImportError as e:
        fail(f"visfs_tpu_torch is not importable here: {e}")
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "visfs_tpu" or m.startswith("visfs_tpu.")]
    if bad:
        fail(f"the port imported {sorted(bad)[:5]}")

    t0 = time.perf_counter()
    kernel_mods = (k1_mod, k2_mod, k3_mod, k4_mod)
    with concurrent.futures.ThreadPoolExecutor(len(kernel_mods)) as pool:
        builds = [pool.submit(m.build) for m in kernel_mods]
        for f in builds:
            f.result()
    for lib, src in (("visfs_lk_level", "lk_level.cu"),
                     (k2_mod.LIB_NAME, "lk_xcorr.cu"),
                     (k3_mod.LIB_NAME, "segment_sum.cu"),
                     (k4_mod.LIB_NAME, "edge_products.cu")):
        log, build_s = _build.build_info(lib)
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln
                 or "spill" in ln]
        print(f"build: {src} in {build_s:.1f} s; ptxas: {' | '.join(ptxas)}",
              flush=True)
    print(f"build: the four libraries loaded {time.perf_counter() - t0:.1f} "
          f"s after the parallel start", flush=True)

    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "sim_cache")
    t0 = time.perf_counter()
    seq = cached_textured_sequence(
        cache_dir=cache_dir, n_frames=N_FRAMES, width=WIDTH, height=HEIGHT,
        motion="square", seed=0, speed=2.0, with_depth=True, device="cuda")
    print(f"sim: {N_FRAMES} frames {WIDTH}x{HEIGHT} with depth in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    from visfs_tpu_torch.operating_points import (SIM_LOCALIZATION,
                                                  SIM_MAPPING)
    k1_pyr, k1_level, k2_pyr, k2_level = (
        (k1_mod, "PYR_LAUNCHES"), (k1_mod, "LAUNCHES"),
        (k2_mod, "PYR_LAUNCHES"), (k2_mod, "LAUNCHES"))
    on_k1 = {k1_pyr: 2, k1_level: 0, k2_pyr: 0, k2_level: 0}
    times = {}

    def timed_phase(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        times[name] = round(time.perf_counter() - t, 1)
        print(f"phase {name}: {times[name]} s "
              f"({time.perf_counter() - t_start:.1f} s in all)", flush=True)
        return out

    k1_tot = timed_phase("k1", phase_k1, seq, k1_mod)
    k2_tot = timed_phase("k2", phase_k2, seq, k2_mod)
    main_launches, _ = timed_phase("main", phase_loop, "main", seq, System,
                                   None, on_k1, ate_rmse)
    timed_phase("profile", phase_profile, seq, System)
    xcorr_launches, _ = timed_phase(
        "xcorr", phase_loop, "xcorr", seq, System, XCORR,
        {k1_pyr: 0, k1_level: 0, k2_pyr: 2, k2_level: 0}, ate_rmse,
        frames=XCORR_FRAMES)
    timed_phase("fleet", phase_fleet, seq, System, on_k1, ate_rmse)
    timed_phase("s3", phase_s3, System, cached_textured_sequence, cache_dir,
                on_k1, ate_rmse, frames=S3_LOOP_FRAMES)
    timed_phase("mapping", phase_s3, System, cached_textured_sequence,
                cache_dir, on_k1, ate_rmse, label="mapping",
                params=SIM_MAPPING, probes=False, frames=MODE_FRAMES)
    timed_phase("loc_cull", phase_loop, "loc_cull", seq, System, None,
                on_k1, ate_rmse, params=dict(SIM_LOCALIZATION, **CULL),
                frames=MODE_FRAMES, one_way=2)
    timed_phase("rgbd", phase_loop, "rgbd", seq, System, None,
                {k1_pyr: 1, k1_level: 0, k2_pyr: 0, k2_level: 0}, ate_rmse,
                params=dict(bench_params(WIDTH),
                            **{"System/SensorStrategy": 1}),
                frames=MODE_FRAMES, depth=True)
    # Phases s4 and dp run in processes of their own (s4's its own, dp's
    # its ranks) beside phases small to render, which time nothing, on the
    # host's other cores (their fps and seconds are taken beside them).
    # A phase that fails there exits once s4 and dp have ended; their own
    # failures are raised by result().
    with concurrent.futures.ThreadPoolExecutor(2) as beside:
        s4 = beside.submit(timed_phase, "s4", phase_s4, cache_dir)
        dp = beside.submit(timed_phase, "dp", phase_dp, cache_dir)
        timed_phase("small", phase_small, System, cache_dir)
        timed_phase("clahe", phase_clahe, seq)
        timed_phase("cull", phase_cull)
        timed_phase("render", phase_render, cache_dir)
        s4.result()
        dp_launches = dp.result()
    _, k3_launches, k4_launches, (k3_tot, k4_tot) = timed_phase(
        "backend", phase_backend, cached_textured_sequence, cache_dir,
        ate_rmse, on_k1)
    timed_phase("node", phase_node, cached_textured_sequence, cache_dir,
                ate_rmse, on_k1)
    print("phase times (s): " + json.dumps(times), flush=True)
    tries = [n for _, n in TRACES]
    print(f"profiler traces: {len(TRACES)} kernel rows, traces per row "
          + json.dumps({n: tries.count(n) for n in sorted(set(tries))})
          + "; rows that took more than one: "
          + (", ".join(f"{label} ({n})" for label, n in TRACES if n > 1)
             or "none"), flush=True)

    print(json.dumps({"kernels": [
        kernel_entry("lk_pyramid", "visfs_tpu_torch/csrc/lk_level.cu",
                     "visfs_tpu/ops/pallas/lk_kernel.py:138",
                     main_launches[k1_pyr] + dp_launches, k1_tot),
        kernel_entry("lk_xcorr_pyramid", "visfs_tpu_torch/csrc/lk_xcorr.cu",
                     "visfs_tpu/ops/pallas/lk_xcorr.py:96",
                     xcorr_launches[k2_pyr], k2_tot),
        kernel_entry("segment_sum", "visfs_tpu_torch/csrc/segment_sum.cu",
                     "visfs_tpu/parallel/pose_graph.py:93",
                     k3_launches, k3_tot),
        kernel_entry("edge_products", "visfs_tpu_torch/csrc/edge_products.cu",
                     "visfs_tpu/parallel/pose_graph.py:90",
                     k4_launches, k4_tot)]}), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s at main "
          f"{LOOP_FPS['main']:.2f} fps", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
