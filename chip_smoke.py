"""Smoke run of visfs_tpu_torch on one NVIDIA GPU: build, kernels, main paths.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero without the final
``ok`` line):
  1. device   — require CUDA (no CPU fallback), print the card's name and
                power limit, turn TF32 off;
  2. build    — compile the CUDA kernels from visfs_tpu_torch/csrc, one nvcc
                per source, all started together; ptxas registers/spills;
  3. k1       — the LK level kernel (K1) against its plain PyTorch version
                on the four pyramid levels of a 640x480 textured pair,
                N = 120 and N = 240 features: flow within 0.05 px, ok
                identical, min_eig rtol 1e-3; the kernel's device time per
                launch (median of a torch.profiler trace), the CUDA-event
                time of a wrapper call and of the plain version, and the
                bound of each launch;
  4. k2       — the xcorr loop kernel (K2) against its plain version on the
                maps and scalars of the real jnp level setup of the same
                pair and points, all four levels: flow within 2e-3 px,
                inactive features bit-equal to flow_in; times and bounds
                as for k1;
  5. main     — the stereo VO main path: System(bench parameters,
                device="cuda") over the 300-frame 640x480 textured square
                loop rendered on the card, frames 0-1 then a timed loop over
                frames 2-299; gate ATE <= 0.15 m, 0 lost, 16 K1 and 0 K2
                launches per frame, 0 host syncs; fps and a stage split;
  6. xcorr    — the same loop with lk_params backend="jnp",
                iter_mode="xcorr" (the jnp level, loop in K2): the same
                gates with 16 K2 and 0 K1 launches per frame;
  7. small    — the System on "cuda" and "cpu" over 8 frames at 160x120, at
                K1 (the System's default), xcorr, and the reference System's
                own LK configuration (backend="jnp", direct iteration): per
                frame translation within 1e-3 m, yaw within 1e-3 rad,
                inliers within 1, identical lost flags.
The kernels JSON line, the nvidia-smi line and the final
{"ok": true, "device": ...} line close the output.

A kernel's "ms" (device time), "plain_ms" and "bound_ms" in the kernels
line are one frame's worth of its launches: the (N, level) cases of its
phase, each twice (the forward and reverse pass at that size), 16 launches
in all.  A bound counts the bytes the launch's inputs need once each: the
pixels of the patches K1 samples and the map taps K2 looks up along the
plain version's trajectory on the same inputs (not the whole planes or
maps), the vectors and the outputs; and the operations of the steps the
features ran.
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
WIDTH, HEIGHT = 640, 480
ATE_GATE = 0.15
# NVIDIA H100 SXM, published dense peaks (NVIDIA data sheet, no sparsity):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Arithmetic per unit of work, counted from the kernels' sources.  K1: a
# bilinear sample is 4 multiplies + 3 adds; the setup samples 3 planes and
# adds 3 products to G per sample (27), a step samples `to` and adds the
# difference's 2 products (12).  K2: ~40 per feature-step (clamps, floors,
# 2 four-tap lookups, G^-1 b, the update and the eps test).
K1_SETUP_FLOPS_PER_SAMPLE = 27
K1_STEP_FLOPS_PER_SAMPLE = 12
K2_STEP_FLOPS = 40
XCORR = dict(backend="jnp", iter_mode="xcorr")


def bench_params(width):
    """The simMapping operating point of the reference bench (bench.py)."""
    return {
        "Tracker/MaxFeatures": 120,
        "Tracker/MinDistance": max(12, 40 * width // 640),
        "Tracker/QualityLevel": 0.05,
        "LocalMap/MapSize": 5,
        "Optimizer/Iterations": 20,
        "Estimator/Force3DoF": True,
        "Estimator/ToleranceTranslation": 0.40,
    }


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


def kernel_device_ms(fn, kernel, reps=20, tries=3):
    """Median device time of one launch of the CUDA kernel whose name holds
    ``kernel``, from a torch.profiler trace of reps calls of fn (kernel
    time alone: CUDA events around a call also count the wrapper's host
    dispatch, which is longer than these kernels).  A trace may come back
    without its device records; it is taken again, up to ``tries`` times.
    None when no trace shows the kernel on the device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if us:
            return float(np.median(us)) / 1e3
    return None


def timed_kernel(label, call, kernel):
    """(kernel ms, call ms): the kernel's device time per launch, and the
    CUDA-event time of one wrapper call (launch and host dispatch)."""
    call_ms = cuda_time_ms(call)
    ms = kernel_device_ms(call, kernel)
    if ms is None:
        fail(f"{label}: the profiler trace shows no {kernel} on the device")
    return ms, call_ms


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def window_pixels(shape, cx, cy, win, keep):
    """The pixels of an [H, W] plane that K1's bilinear win x win patches
    centred at (cx, cy) read for the features in keep ((win+1)^2 each, the
    corner clipped as the kernel clips it): an [H, W] bool mask."""
    import torch

    h, w = shape
    half = win // 2
    ix = torch.clamp(torch.floor(cx[keep] - half).long(), 0, w - win - 2)
    iy = torch.clamp(torch.floor(cy[keep] - half).long(), 0, h - win - 2)
    taps = torch.arange(win + 1, device=cx.device)
    mask = torch.zeros(shape, dtype=torch.bool, device=cx.device)
    mask[(iy[:, None] + taps)[:, :, None],
         (ix[:, None] + taps)[:, None, :]] = True
    return mask


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


def frame_totals(rows):
    """One frame's sums over a phase's rows (each case twice) and which
    bound dominates them."""
    tot = {k: 2 * sum(r[k] for r in rows)
           for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bytes_ms",
                     "ops_ms")}
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                       else "operations")
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return tot


def make_system(System, cam, params, device, lk=None):
    s = System(params, device=device)
    if lk:
        s.lk_params = dataclasses.replace(s.lk_params, **lk)
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    return s


def level_inputs(seq):
    """Pyramids of frames 0 and 1 and 240 GFTT corners of frame 0."""
    import torch

    from visfs_tpu_torch.ops.gftt import gftt_detect
    from visfs_tpu_torch.ops.lk import LKParams, build_lk_pyramid

    params = LKParams()
    img0 = torch.as_tensor(seq.left[0], device="cuda")
    img1 = torch.as_tensor(seq.left[1], device="cuda")
    pyr0 = build_lk_pyramid(img0, params)
    pyr1 = build_lk_pyramid(img1, params)
    det = gftt_detect(img0, 240, 0.01, 10)
    if int(det.valid.sum()) < 240:
        fail(f"levels: only {int(det.valid.sum())} corners for N = 240")
    return params, pyr0, pyr1, det.points


def phase_k1(seq, lk_mod):
    """K1 against its plain version at the main path's shapes."""
    import torch

    params, pyr0, pyr1, points = level_inputs(seq)
    dev = points.device
    kw = dict(win=params.win_size, iterations=params.iterations,
              eps=params.eps, min_eig_threshold=params.min_eig_threshold)
    area = params.win_size ** 2
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
            # bytes: the patches' pixels of from, gx and gy (every feature:
            # ok and min_eig are outputs), the union of the `to` patches the
            # steps sample, the vectors and the outputs
            shape, win = pyr0.levels[level].shape, params.win_size
            src = window_pixels(shape, pts_l[:, 0], pts_l[:, 1], win,
                                torch.ones(n, dtype=torch.bool, device=dev))
            dst = torch.zeros(shape, dtype=torch.bool, device=dev)
            for cx, cy, run in trail:
                dst |= window_pixels(shape, cx, cy, win, run)
            n_bytes = (4 * (3 * int(src.sum()) + int(dst.sum()))
                       + nbytes(*args[4:], fk, okk, ek))
            bytes_ms, ops_ms = bound(
                n_bytes,
                n * area * K1_SETUP_FLOPS_PER_SAMPLE
                + n_steps * area * K1_STEP_FLOPS_PER_SAMPLE)
            rows.append(dict(n=n, level=level,
                             plane=list(pyr0.levels[level].shape),
                             max_abs_err=err, ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms,
                             bound_ms=max(bytes_ms, ops_ms),
                             bytes_ms=bytes_ms, ops_ms=ops_ms, bytes=n_bytes,
                             steps=n_steps, n_ok=int(okp.sum())))
            active = (okp > 0).to(torch.float32) * active
            flow = fp * 2.0 if level > 0 else fp
    for r in rows:
        print("k1 " + json.dumps(r), flush=True)
    tot = frame_totals(rows)
    print(f"k1: flow max|d| {tot['max_abs_err']:.3g} px over 8 (N, level) "
          f"cases, ok identical; one frame's 16 launches: kernel "
          f"{tot['ms']:.4f} ms, calls {tot['call_ms']:.3f} ms (plain "
          f"{tot['plain_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.5f} ms by {tot['bound_by']})", flush=True)
    return tot


def phase_k2(seq, k2_mod):
    """K2 against its plain version on the jnp level's real inputs."""
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
    tot = frame_totals(rows)
    print(f"k2: flow max|d| {tot['max_abs_err']:.3g} px over 8 (N, level) "
          f"cases, inactive features bit-equal; one frame's 16 launches: "
          f"kernel {tot['ms']:.4f} ms, calls {tot['call_ms']:.3f} ms (plain "
          f"{tot['plain_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.5f} ms by {tot['bound_by']})", flush=True)
    return tot


def phase_loop(label, seq, System, lk, expect, ate_rmse):
    """The 300-frame bench loop on the card.  expect: {kernel module:
    launches per frame}; every count is set to 0 just before the timed
    loop and read just after it."""
    import torch

    import visfs_tpu_torch.slam.system as sysmod

    lefts = [torch.as_tensor(f, device="cuda") for f in seq.left]
    rights = [torch.as_tensor(f, device="cuda") for f in seq.right]
    torch.cuda.synchronize()
    sys_ = make_system(System, seq.camera, bench_params(WIDTH), "cuda", lk)
    sys_.input_primary_sensor_data(float(seq.stamps[0]), lefts[0], rights[0])
    sys_.input_primary_sensor_data(float(seq.stamps[1]), lefts[1], rights[1])
    sys_.drain_outputs()
    torch.cuda.synchronize()

    # Stage probe: CUDA events and host clocks around tracker_step and the
    # whole step of every frame (event records do not wait for the device).
    trk_marks, step_marks = [], []
    tracker_step = sysmod.tracker_step

    def timed_tracker_step(*a, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        h0 = time.perf_counter()
        e0.record()
        out = tracker_step(*a, **kw)
        e1.record()
        trk_marks.append((e0, e1, time.perf_counter() - h0))
        return out

    sysmod.tracker_step = timed_tracker_step
    for mod in expect:
        mod.LAUNCHES = 0
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            for i in range(2, N_FRAMES):
                s0, s1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                s0.record()
                sys_.input_primary_sensor_data(float(seq.stamps[i]),
                                               lefts[i], rights[i])
                s1.record()
                step_marks.append((s0, s1))
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        sysmod.tracker_step = tracker_step
    launches = {mod: mod.LAUNCHES for mod in expect}
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    outs = sys_.drain_outputs()
    n = N_FRAMES - 2
    fps = n / elapsed
    est = np.stack([o.pose for o in outs])
    if not np.all(np.isfinite(est)) or est.shape != (n, 4, 4):
        fail(f"{label}: poses not finite [{n}, 4, 4]: {est.shape}")
    ate = ate_rmse(est, seq.poses[2:2 + len(est)])
    lost = int(sum(bool(o.lost) for o in outs))
    counts = ", ".join(f"{mod.__name__.rsplit('.', 1)[-1]} launches "
                       f"{c} ({c / n:g}/frame)" for mod, c in launches.items())
    print(f"{label}: {fps:.2f} fps over {n} frames ({elapsed:.2f} s), ATE "
          f"{ate:.4f} m, lost {lost}/{len(outs)}, {counts}, host syncs in "
          f"loop {len(syncs)}", flush=True)
    stages = dict(
        tracker_host_ms=float(np.median([m[2] for m in trk_marks]) * 1e3),
        tracker_device_ms=float(np.median([a.elapsed_time(b)
                                           for a, b, _ in trk_marks])),
        step_device_ms=float(np.median([a.elapsed_time(b)
                                        for a, b in step_marks])),
        frame_wall_ms=elapsed / n * 1e3)
    print(f"{label} stages (medians per frame): " + json.dumps(stages),
          flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"{label}: sync: {msg[:200]}", flush=True)
    if not ate <= ATE_GATE:
        fail(f"{label}: ATE {ate:.4f} m > {ATE_GATE}")
    if lost:
        fail(f"{label}: {lost} lost frames")
    if syncs:
        fail(f"{label}: {len(syncs)} host syncs in the loop")
    for mod, per_frame in expect.items():
        if launches[mod] != per_frame * n:
            fail(f"{label}: {launches[mod]} launches of {mod.__name__}, "
                 f"expected {per_frame * n}")
    return launches


def phase_small(System, cached_textured_sequence, cache_dir):
    seq = cached_textured_sequence(cache_dir=cache_dir, n_frames=8,
                                   width=160, height=120, motion="square",
                                   seed=0, speed=2.0, device="cuda")
    params = bench_params(160)
    params["Tracker/MaxFeatures"] = 40
    for label, lk in (("k1", None), ("xcorr", XCORR),
                      ("direct", dict(backend="jnp"))):
        runs = {}
        for dev in ("cuda", "cpu"):
            s = make_system(System, seq.camera, params, dev, lk)
            runs[dev] = s.run_sequence(seq.stamps, seq.left, seq.right)
        worst_t = worst_yaw = 0.0
        for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
            dt = float(np.abs(a.pose[:3, 3] - b.pose[:3, 3]).max())
            dyaw = abs(float(np.arctan2(a.pose[1, 0], a.pose[0, 0])
                             - np.arctan2(b.pose[1, 0], b.pose[0, 0])))
            worst_t, worst_yaw = max(worst_t, dt), max(worst_yaw, dyaw)
            if dt > 1e-3 or dyaw > 1e-3 or bool(a.lost) != bool(b.lost) \
                    or abs(int(a.n_inliers) - int(b.n_inliers)) > 1:
                fail(f"small {label}: frame {i} cuda vs cpu: dt {dt:.3g} m, "
                     f"dyaw {dyaw:.3g}, inliers {int(a.n_inliers)}/"
                     f"{int(b.n_inliers)}, lost {bool(a.lost)}/"
                     f"{bool(b.lost)}")
        print(f"small {label}: cuda vs cpu over 8 frames at 160x120: max "
              f"|dt| {worst_t:.3g} m, max |dyaw| {worst_yaw:.3g} rad",
              flush=True)


def kernel_entry(name, source, replaces, launches, tot):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": tot["bound_by"], "library_ms": None}


def main():
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
        from visfs_tpu_torch.ops.kernels import lk_level as k1_mod
        from visfs_tpu_torch.ops.kernels import lk_xcorr as k2_mod
        from visfs_tpu_torch.slam.system import System
    except ImportError as e:
        fail(f"visfs_tpu_torch is not importable here: {e}")
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "visfs_tpu" or m.startswith("visfs_tpu.")]
    if bad:
        fail(f"the port imported {sorted(bad)[:5]}")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(m.build) for m in (k1_mod, k2_mod)]
        for f in builds:
            f.result()
    for lib, src in (("visfs_lk_level", "lk_level.cu"),
                     (k2_mod.LIB_NAME, "lk_xcorr.cu")):
        log, build_s = _build.build_info(lib)
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln
                 or "spill" in ln]
        print(f"build: {src} in {build_s:.1f} s; ptxas: {' | '.join(ptxas)}",
              flush=True)
    print(f"build: both libraries loaded {time.perf_counter() - t0:.1f} s "
          f"after the parallel start", flush=True)

    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "sim_cache")
    t0 = time.perf_counter()
    seq = cached_textured_sequence(
        cache_dir=cache_dir, n_frames=N_FRAMES, width=WIDTH, height=HEIGHT,
        motion="square", seed=0, speed=2.0, device="cuda")
    print(f"sim: {N_FRAMES} frames {WIDTH}x{HEIGHT} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    k1_tot = phase_k1(seq, k1_mod)
    k2_tot = phase_k2(seq, k2_mod)
    main_launches = phase_loop("main", seq, System, None,
                               {k1_mod: 16, k2_mod: 0}, ate_rmse)
    xcorr_launches = phase_loop("xcorr", seq, System, XCORR,
                                {k1_mod: 0, k2_mod: 16}, ate_rmse)
    phase_small(System, cached_textured_sequence, cache_dir)

    print(json.dumps({"kernels": [
        kernel_entry("lk_level", "visfs_tpu_torch/csrc/lk_level.cu",
                     "visfs_tpu/ops/pallas/lk_kernel.py:138",
                     main_launches[k1_mod], k1_tot),
        kernel_entry("lk_xcorr_iterate", "visfs_tpu_torch/csrc/lk_xcorr.cu",
                     "visfs_tpu/ops/pallas/lk_xcorr.py:96",
                     xcorr_launches[k2_mod], k2_tot)]}), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
