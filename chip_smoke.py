"""Smoke run of visfs_tpu_torch on one NVIDIA GPU: build, kernels, main path.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero without the final
``ok`` line):
  1. device   — require CUDA (no CPU fallback), print the card's name and
                power limit, turn TF32 off;
  2. build    — compile the CUDA kernels from visfs_tpu_torch/csrc with nvcc;
  3. k1       — the LK level kernel against its plain PyTorch version on the
                four pyramid levels of a 640x480 textured pair, N = 120 and
                N = 240 features: flow within 0.05 px, ok identical, min_eig
                rtol 1e-3; CUDA-event median times of both;
  4. main     — the stereo VO main path: System(bench parameters,
                device="cuda") over the 300-frame 640x480 textured square
                loop rendered on the card, frames 0-1 then a timed loop over
                frames 2-299; gate ATE <= 0.15 m, 0 lost, 16 kernel launches
                per frame; fps and the host syncs counted in the loop;
  5. small    — the same System on "cuda" and "cpu" over 8 frames at
                160x120: per-frame translation within 1e-3 m, yaw within
                1e-3 rad, inliers within 1, identical lost flags.
The kernels JSON line, the nvidia-smi line and the final
{"ok": true, "device": ...} line close the output.
"""

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


def make_system(System, cam, params, device):
    s = System(params, device=device)
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    return s


def phase_k1(seq, lk_mod):
    """K1 against its plain version at the main path's shapes."""
    import torch

    from visfs_tpu_torch.ops.gftt import gftt_detect
    from visfs_tpu_torch.ops.lk import LKParams, build_lk_pyramid

    params = LKParams()
    img0 = torch.as_tensor(seq.left[0], device="cuda")
    img1 = torch.as_tensor(seq.left[1], device="cuda")
    dev = img0.device
    pyr0 = build_lk_pyramid(img0, params)
    pyr1 = build_lk_pyramid(img1, params)
    det = gftt_detect(img0, 240, 0.01, 10)
    if int(det.valid.sum()) < 240:
        fail(f"k1: only {int(det.valid.sum())} corners for N = 240")
    kw = dict(win=params.win_size, iterations=params.iterations,
              eps=params.eps, min_eig_threshold=params.min_eig_threshold)
    rows, max_err = [], 0.0
    frame_ms = frame_plain_ms = 0.0
    for n in (120, 240):
        pts = det.points[:n].contiguous()
        active = torch.ones(n, dtype=torch.float32, device=dev)
        flow = torch.zeros((n, 2), dtype=torch.float32, device=dev)
        for level in range(params.max_level, -1, -1):
            pts_l = (pts / 2.0 ** level + pyr0.pad).contiguous()
            args = (pyr0.levels[level], pyr1.levels[level], pyr0.gx[level],
                    pyr0.gy[level], pts_l, flow.contiguous(), active)
            fk, okk, ek = lk_mod.lk_level_cuda(*args, **kw)
            fp, okp, ep = lk_mod.lk_level_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((fk - fp).abs().max())
            if not err <= 0.05:
                fail(f"k1 N={n} level {level}: flow max|d| {err:.4g} px")
            if not torch.equal(okk, okp):
                fail(f"k1 N={n} level {level}: ok differs in "
                     f"{int((okk != okp).sum())} features")
            np.testing.assert_allclose(ek.cpu().numpy(), ep.cpu().numpy(),
                                       rtol=1e-3, atol=1e-6)
            ms = cuda_time_ms(lambda: lk_mod.lk_level_cuda(*args, **kw))
            plain_ms = cuda_time_ms(
                lambda: lk_mod.lk_level_reference(*args, **kw), reps=5)
            frame_ms += 2 * ms  # forward and reverse pass of this size
            frame_plain_ms += 2 * plain_ms
            max_err = max(max_err, err)
            rows.append(dict(n=n, level=level,
                             plane=list(pyr0.levels[level].shape),
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             n_ok=int(okp.sum())))
            active = (okp > 0).to(torch.float32) * active
            flow = fp * 2.0 if level > 0 else fp
    for r in rows:
        print("k1 " + json.dumps(r), flush=True)
    print(f"k1: flow max|d| {max_err:.3g} px over 8 (N, level) cases, ok "
          f"identical; one frame's 16 launches ~ {frame_ms:.3f} ms "
          f"(plain {frame_plain_ms:.3f} ms)", flush=True)
    return max_err, frame_ms, frame_plain_ms


def phase_main(seq, System, lk_mod, ate_rmse):
    import torch

    lefts = [torch.as_tensor(f, device="cuda") for f in seq.left]
    rights = [torch.as_tensor(f, device="cuda") for f in seq.right]
    torch.cuda.synchronize()
    sys_ = make_system(System, seq.camera, bench_params(WIDTH), "cuda")
    sys_.input_primary_sensor_data(float(seq.stamps[0]), lefts[0], rights[0])
    sys_.input_primary_sensor_data(float(seq.stamps[1]), lefts[1], rights[1])
    sys_.drain_outputs()
    torch.cuda.synchronize()

    lk_mod.LAUNCHES = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        for i in range(2, N_FRAMES):
            sys_.input_primary_sensor_data(float(seq.stamps[i]), lefts[i],
                                           rights[i])
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = lk_mod.LAUNCHES
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    outs = sys_.drain_outputs()
    fps = (N_FRAMES - 2) / elapsed
    est = np.stack([o.pose for o in outs])
    if not np.all(np.isfinite(est)) or est.shape != (N_FRAMES - 2, 4, 4):
        fail(f"main: poses not finite [{N_FRAMES - 2}, 4, 4]: {est.shape}")
    ate = ate_rmse(est, seq.poses[2:2 + len(est)])
    lost = int(sum(bool(o.lost) for o in outs))
    per_frame = launches / (N_FRAMES - 2)
    print(f"main: {fps:.2f} fps over {N_FRAMES - 2} frames ({elapsed:.2f} s),"
          f" ATE {ate:.4f} m, lost {lost}/{len(outs)}, K1 launches "
          f"{launches} ({per_frame:g}/frame), host syncs in loop "
          f"{len(syncs)}", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"main: sync: {msg[:200]}", flush=True)
    if not ate <= ATE_GATE:
        fail(f"main: ATE {ate:.4f} m > {ATE_GATE}")
    if lost:
        fail(f"main: {lost} lost frames")
    if launches != 16 * (N_FRAMES - 2):
        fail(f"main: {launches} K1 launches, expected {16 * (N_FRAMES - 2)}")
    return launches


def phase_small(System, cached_textured_sequence, cache_dir):
    seq = cached_textured_sequence(cache_dir=cache_dir, n_frames=8,
                                   width=160, height=120, motion="square",
                                   seed=0, speed=2.0, device="cuda")
    params = bench_params(160)
    params["Tracker/MaxFeatures"] = 40
    runs = {}
    for dev in ("cuda", "cpu"):
        s = make_system(System, seq.camera, params, dev)
        runs[dev] = s.run_sequence(seq.stamps, seq.left, seq.right)
    worst_t = worst_yaw = 0.0
    for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        dt = float(np.abs(a.pose[:3, 3] - b.pose[:3, 3]).max())
        dyaw = abs(float(np.arctan2(a.pose[1, 0], a.pose[0, 0])
                         - np.arctan2(b.pose[1, 0], b.pose[0, 0])))
        worst_t, worst_yaw = max(worst_t, dt), max(worst_yaw, dyaw)
        if dt > 1e-3 or dyaw > 1e-3 or bool(a.lost) != bool(b.lost) \
                or abs(int(a.n_inliers) - int(b.n_inliers)) > 1:
            fail(f"small: frame {i} cuda vs cpu: dt {dt:.3g} m, dyaw "
                 f"{dyaw:.3g}, inliers {int(a.n_inliers)}/"
                 f"{int(b.n_inliers)}, lost {bool(a.lost)}/{bool(b.lost)}")
    print(f"small: cuda vs cpu over 8 frames at 160x120: max |dt| "
          f"{worst_t:.3g} m, max |dyaw| {worst_yaw:.3g} rad", flush=True)


def main():
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
        from visfs_tpu_torch.ops.kernels import lk_level as lk_mod
        from visfs_tpu_torch.slam.system import System
    except ImportError as e:
        fail(f"visfs_tpu_torch is not importable here: {e}")
    if "jax" in sys.modules:
        fail("jax was imported")

    t0 = time.perf_counter()
    lk_mod.build()
    log, build_s = _build.build_info("visfs_lk_level")
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln
             or "spill" in ln]
    print(f"build: lk_level.cu in {build_s:.1f} s (load "
          f"{time.perf_counter() - t0:.1f} s); ptxas: {' | '.join(ptxas)}",
          flush=True)

    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "sim_cache")
    t0 = time.perf_counter()
    seq = cached_textured_sequence(
        cache_dir=cache_dir, n_frames=N_FRAMES, width=WIDTH, height=HEIGHT,
        motion="square", seed=0, speed=2.0, device="cuda")
    print(f"sim: {N_FRAMES} frames {WIDTH}x{HEIGHT} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    max_err, k1_ms, k1_plain_ms = phase_k1(seq, lk_mod)
    launches = phase_main(seq, System, lk_mod, ate_rmse)
    phase_small(System, cached_textured_sequence, cache_dir)

    print(json.dumps({"kernels": [{
        "name": "lk_level", "route": "cuda",
        "source": "visfs_tpu_torch/csrc/lk_level.cu",
        "replaces": "visfs_tpu/ops/pallas/lk_kernel.py:138",
        "launches": launches, "max_abs_err": max_err, "ms": k1_ms,
        "plain_ms": k1_plain_ms}]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
