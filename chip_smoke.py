"""Smoke run of visfs_tpu_torch on one NVIDIA GPU: build, kernels, main paths.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero without the final
``ok`` line):
  1. device   — require CUDA (no CPU fallback), print the card's name and
                power limit, turn TF32 off;
  2. build    — compile the CUDA kernels from visfs_tpu_torch/csrc, one nvcc
                per source, all started together; ptxas registers/spills;
  3. k1       — the LK kernel (K1) against its plain PyTorch versions on
                a 640x480 textured pair, N = 120 and N = 240 features:
                its one-level entry on each of the four pyramid levels
                (flow within 0.05 px, ok identical, min_eig rtol 1e-3),
                and its pyramid entry, one bidirectional track over all
                levels per launch (points within 0.05 px, status
                identical, err rtol 1e-3); the kernel's device time per
                launch (median of a torch.profiler trace), the CUDA-event
                time of a wrapper call and of the plain version, and the
                bound of each launch; and the device time of one step
                (the one-level entry at level 0 with eps = 0, run for 1
                and for 30 steps);
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
                yardstick of the map stage; the port never calls it);
  5. main     — the stereo VO main path: System(bench parameters,
                device="cuda") over the 300-frame 640x480 textured square
                loop rendered on the card, frames 0-1 then a timed loop over
                frames 2-299; gate ATE <= 0.15 m, 0 lost, 2 launches of
                K1's pyramid entry (the temporal and the stereo track), 0
                of its one-level entry and 0 of either K2 entry per frame,
                0 host syncs; fps and a stage split;
  6. xcorr    — the same loop with lk_params backend="jnp",
                iter_mode="xcorr" (the jnp level in correlation form): the
                same gates with 2 launches of K2's pyramid entry, 0 of its
                one-level entry and 0 of either K1 entry per frame;
  7. small    — the System on "cuda" and "cpu" over 8 frames at 160x120, at
                K1 (the System's default), xcorr, and the reference System's
                own LK configuration (backend="jnp", direct iteration): per
                frame translation within 1e-3 m, yaw within 1e-3 rad,
                inliers within 1, identical lost flags.
The kernels JSON line, the nvidia-smi line and the final
{"ok": true, "device": ...} line close the output.

A kernel's "ms" (device time), "plain_ms" and "bound_ms" in the kernels
line are one frame's worth of its launches: for each of K1 and K2, its
path's two pyramid launches, one at N = 120 plus one at N = 240.  The k1
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
    pkw = dict(kw, max_level=params.max_level, bidirectional=True,
               fb_threshold=1.5)
    pyr_rows = []
    for n in (120, 240):
        pts = points[:n].contiguous()
        args = (pyr0, pyr1, pts, pts,
                torch.ones(n, dtype=torch.bool, device=dev))
        pk, sk, ek = lk_mod.lk_pyramid_cuda(*args, **pkw)
        levels = []
        pp, sp, ep = lk_mod.lk_pyramid_reference(*args, **pkw, levels=levels)
        torch.cuda.synchronize()
        err = float((pk - pp).abs().max())
        if not err <= 0.05:
            fail(f"k1 pyramid N={n}: points max|d| {err:.4g} px")
        if not torch.equal(sk, sp):
            fail(f"k1 pyramid N={n}: status differs in "
                 f"{int((sk != sp).sum())} features")
        np.testing.assert_allclose(ek.cpu().numpy(), ep.cpu().numpy(),
                                   rtol=1e-3, atol=1e-6)
        ms, call_ms = timed_kernel(
            f"k1 pyramid N={n}", lambda: lk_mod.lk_pyramid_cuda(*args, **pkw),
            "lk_pyr_kernel")
        plain_ms = cuda_time_ms(
            lambda: lk_mod.lk_pyramid_reference(*args, **pkw), reps=3)
        # bytes: each plane's pixels once over both directions, the setup
        # of the active features (and of all at the forward level 0, for
        # err), the vectors and outputs once; max_chain_steps: the most
        # steps one feature runs over its levels and directions, the chain
        # of the slowest block
        fwd0 = params.max_level
        pix_bytes, flops = k1_work(
            [dict(lv, setup=lv["active"] | (k == fwd0))
             for k, lv in enumerate(levels)], params.win_size)
        n_bytes = pix_bytes + nbytes(*args[2:], pk, sk, ek)
        bytes_ms, ops_ms = bound(n_bytes, flops)
        pyr_rows.append(dict(n=n, entry="pyramid", levels=len(levels),
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
    print(f"k1 pyramid entry: points max|d| {ptot['max_abs_err']:.3g} px at "
          f"N = 120 and 240, status identical; one frame's 2 launches: "
          f"kernel {ptot['ms']:.4f} ms, calls {ptot['call_ms']:.3f} ms "
          f"(plain {ptot['plain_ms']:.3f} ms, bound {ptot['bound_ms']:.5f} ms "
          f"by {ptot['bound_by']})", flush=True)
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
    return ptot


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


def start_loop(seq, System, lk):
    """The bench loop's frames on the card and a System (bench parameters,
    lk_params replaced by lk) stepped through frames 0-1."""
    import torch

    lefts = [torch.as_tensor(f, device="cuda") for f in seq.left]
    rights = [torch.as_tensor(f, device="cuda") for f in seq.right]
    torch.cuda.synchronize()
    sys_ = make_system(System, seq.camera, bench_params(WIDTH), "cuda", lk)
    for i in range(2):
        sys_.input_primary_sensor_data(float(seq.stamps[i]), lefts[i],
                                       rights[i])
    sys_.drain_outputs()
    torch.cuda.synchronize()
    return sys_, lefts, rights


def timed_steps(sys_, seq, lefts, rights):
    """Step frames 2.. of seq through sys_ under the stage probe: CUDA
    events and host clocks around every tracker_step and the whole step of
    every frame (event records do not wait for the device), host syncs
    caught as warnings.  Returns (elapsed s, medians per frame, the sync
    messages)."""
    import torch

    import visfs_tpu_torch.slam.system as sysmod

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
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            for i in range(2, len(lefts)):
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
    n = len(step_marks)
    stages = dict(
        tracker_host_ms=float(np.median([m[2] for m in trk_marks]) * 1e3),
        tracker_device_ms=float(np.median([a.elapsed_time(b)
                                           for a, b, _ in trk_marks])),
        step_device_ms=float(np.median([a.elapsed_time(b)
                                        for a, b in step_marks])),
        frame_wall_ms=elapsed / n * 1e3)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    return elapsed, stages, syncs


def phase_loop(label, seq, System, lk, expect, ate_rmse):
    """The 300-frame bench loop on the card.  expect: {(kernel module,
    launch counter name): launches per frame}; every count is set to 0 just
    before the timed loop and read just after it."""
    sys_, lefts, rights = start_loop(seq, System, lk)
    for mod, counter in expect:
        setattr(mod, counter, 0)
    elapsed, stages, syncs = timed_steps(sys_, seq, lefts, rights)
    launches = {key: getattr(*key) for key in expect}
    outs = sys_.drain_outputs()
    n = N_FRAMES - 2
    fps = n / elapsed
    est = np.stack([o.pose for o in outs])
    if not np.all(np.isfinite(est)) or est.shape != (n, 4, 4):
        fail(f"{label}: poses not finite [{n}, 4, 4]: {est.shape}")
    ate = ate_rmse(est, seq.poses[2:2 + len(est)])
    lost = int(sum(bool(o.lost) for o in outs))
    counts = ", ".join(f"{mod.__name__.rsplit('.', 1)[-1]}.{counter} {c} "
                       f"({c / n:g}/frame)"
                       for (mod, counter), c in launches.items())
    print(f"{label}: {fps:.2f} fps over {n} frames ({elapsed:.2f} s), ATE "
          f"{ate:.4f} m, lost {lost}/{len(outs)}, {counts}, host syncs in "
          f"loop {len(syncs)}", flush=True)
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
    for (mod, counter), per_frame in expect.items():
        if launches[mod, counter] != per_frame * n:
            fail(f"{label}: {mod.__name__}.{counter} is "
                 f"{launches[mod, counter]}, expected {per_frame * n}")
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
    k1_pyr, k1_level, k2_pyr, k2_level = (
        (k1_mod, "PYR_LAUNCHES"), (k1_mod, "LAUNCHES"),
        (k2_mod, "PYR_LAUNCHES"), (k2_mod, "LAUNCHES"))
    main_launches = phase_loop(
        "main", seq, System, None,
        {k1_pyr: 2, k1_level: 0, k2_pyr: 0, k2_level: 0}, ate_rmse)
    xcorr_launches = phase_loop(
        "xcorr", seq, System, XCORR,
        {k1_pyr: 0, k1_level: 0, k2_pyr: 2, k2_level: 0}, ate_rmse)
    phase_small(System, cached_textured_sequence, cache_dir)

    print(json.dumps({"kernels": [
        kernel_entry("lk_pyramid", "visfs_tpu_torch/csrc/lk_level.cu",
                     "visfs_tpu/ops/pallas/lk_kernel.py:138",
                     main_launches[k1_pyr], k1_tot),
        kernel_entry("lk_xcorr_pyramid", "visfs_tpu_torch/csrc/lk_xcorr.cu",
                     "visfs_tpu/ops/pallas/lk_xcorr.py:96",
                     xcorr_launches[k2_pyr], k2_tot)]}), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
