"""Micro-benchmarks of the LK front end of visfs_tpu_torch (the twin of
tools/lk_microbench.py).

Every benchmark chains its calls (each consumes the previous call's
output, as the reference tool does) and times the chain with CUDA events
recorded around it (the host clock on the CPU), so the per-call figure is
the device span of a dependent sequence of calls; the host's dispatch time
for the same calls is printed beside it.  The reference subtracts a
measured fetch latency instead; events need no correction.

    python tools/torch_lk_microbench.py [--what all|xcorr|lk|step]
        [--reps 100] [--device cpu] [--width 640]

xcorr: the correlation maps of one level (``ops.kernels.jnp_level``'s
``xcorr_maps``, what K2's plain version builds) against a grouped conv2d
of the same maps, N = 240 features, margins 10 and 4.
lk:    pyramids of three 640x480 images plus a bidirectional temporal
track (N = 120) and stereo track (N = 240), for each LK formulation of the
port: K1 (``backend="pallas"``, one launch a track on the card), the jnp
level in correlation form (K2's pyramid entry) and the jnp level's direct
iteration (plain PyTorch).
step:  ``tracker_step`` on a fixed state of the bench loop (frame 30), and
the sustained System step over frames 3-39 of the loop (the bench point
of tools/torch_ablate_stages.py).
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def chain_time(step, carry, reps, device):
    """(span ms, host ms) per call of ``reps`` chained calls of step."""
    import torch

    cuda = device == "cuda"
    c = step(carry)  # warm
    if cuda:
        torch.cuda.synchronize()
    spans, hosts = [], []
    for _ in range(3):
        c = carry
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            c = step(c)
        hosts.append((time.perf_counter() - t0) / reps * 1e3)
        if cuda:
            e1.record()
            torch.cuda.synchronize()
            spans.append(e0.elapsed_time(e1) / reps)
        else:
            spans.append(hosts[-1])
    return float(sorted(spans)[1]), float(sorted(hosts)[1])


def report(what, label, span, host, device, smi):
    print(f"{label}: {span:.3f} ms a call (device span), host dispatch "
          f"{host:.3f} ms")
    print(json.dumps({"tool": "torch_lk_microbench", "what": what,
                      "case": label, "span_ms": span, "host_ms": host,
                      "device": device, "card": smi}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--what", default="all")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=640)
    args = ap.parse_args()

    import dataclasses

    import torch
    import torch.nn.functional as F

    dev = args.device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if dev == "cuda" else "cpu"
    print(f"device: {dev} ({smi})")
    gen = torch.Generator(device="cpu").manual_seed(0)
    N, win = 240, 21

    if args.what in ("all", "xcorr"):
        from visfs_tpu_torch.ops.kernels.jnp_level import xcorr_maps

        for margin in (10, 4):
            R = win + 1 + 2 * margin
            region = torch.randn((N, R, R), generator=gen).to(dev)
            gx = torch.randn((N, win, win), generator=gen).to(dev)
            gy = torch.randn((N, win, win), generator=gen).to(dev)
            weight = torch.stack([gx, gy], 1).reshape(2 * N, 1, win, win)

            def maps(carry):
                c1, c2 = xcorr_maps(region + carry * 1e-20, gx, gy, win)
                return carry + c1[0, 0, 0] * 0.0 + c2[0, 0, 0] * 0.0 + 1.0

            def conv(carry):
                reg = (region + carry * 1e-20).repeat_interleave(2, 0)
                out = F.conv2d(reg[None], weight, groups=2 * N)[0]
                return carry + out[0, 0, 0] * 0.0 + 1.0

            zero = torch.zeros((), device=dev)
            for mode, fn in (("xcorr_maps", maps), ("conv2d", conv)):
                span, host = chain_time(fn, zero, args.reps, dev)
                report("xcorr", f"xcorr maps margin={margin} R={R} "
                       f"A={R - win + 1} [{mode}]", span, host, dev, smi)

    if args.what in ("all", "lk"):
        from visfs_tpu_torch.ops.image import gaussian5
        from visfs_tpu_torch.ops.lk import (LKParams, build_lk_pyramid,
                                            lk_track_bidirectional_pyr)

        W = args.width
        H = W * 3 // 4
        base = (torch.rand((H, W), generator=gen) * 255).to(dev)
        img0 = gaussian5(base)
        img1 = torch.roll(img0, (2, 3), (0, 1))
        imgr = torch.roll(img0, (0, -10), (0, 1))
        lo = torch.tensor([30.0, 30.0])
        span_xy = torch.tensor([W - 60.0, H - 60.0])
        ptsT = (torch.rand((120, 2), generator=gen) * span_xy + lo).to(dev)
        ptsS = (torch.rand((240, 2), generator=gen) * span_xy + lo).to(dev)
        onesT = torch.ones(120, dtype=torch.bool, device=dev)
        onesS = torch.ones(240, dtype=torch.bool, device=dev)
        # the plain direct iteration dispatches thousands of small kernels
        # a call: a tenth of the repetitions
        for label, kw, reps in (
                ("K1 pallas", dict(backend="pallas"), args.reps),
                ("jnp xcorr (K2)", dict(backend="jnp", iter_mode="xcorr"),
                 args.reps),
                ("jnp direct", dict(backend="jnp"), max(args.reps // 10, 2))):
            p = dataclasses.replace(LKParams(), **kw)

            def both(carry, p=p):
                p0 = build_lk_pyramid(img0 + carry * 1e-20, p)
                p1 = build_lk_pyramid(img1, p)
                pr = build_lk_pyramid(imgr, p)
                t = lk_track_bidirectional_pyr(p0, p1, ptsT, ptsT, onesT, p,
                                               1.5)
                s = lk_track_bidirectional_pyr(p1, pr, ptsS, ptsS, onesS, p,
                                               0.5)
                return carry + t.points[0, 0] * 0.0 + s.points[0, 0] * 0.0 \
                    + 1.0

            span, host = chain_time(both, torch.zeros((), device=dev), reps,
                                    dev)
            report("lk", f"lk pyr+temporal(120)+stereo(240) bidir "
                   f"[{label}]", span, host, dev, smi)

    if args.what in ("all", "step"):
        from tools.torch_ablate_stages import bench_system
        from visfs_tpu_torch.slam import system as S

        seq, s, lefts, rights, feed = bench_system(dev, args.width, False,
                                                   40)
        cam = seq.camera
        for i in range(30):
            feed(i)
        s.drain_outputs()
        st, i = s.state, 30
        stamp = torch.full((), float(seq.stamps[i]), device=dev)

        def tracker(carry):
            out = S.track_stage(st, lefts[i] + carry * 1e-20, rights[i],
                                stamp, cam, s.settings, s.lk_params,
                                s._cfg_hash)
            return carry + out.trk.n_new.to(carry.dtype) * 0.0 + 1.0

        span, host = chain_time(tracker, torch.zeros((), device=dev),
                                max(args.reps // 10, 3), dev)
        report("step", "track_stage (tracker_step + its window slide and "
               "motion prior) at frame 30", span, host, dev, smi)
        # the sustained step: frames 3..39 from a fresh System
        _, s2, _, _, feed2 = bench_system(dev, args.width, False, 40)
        for k in range(3):
            feed2(k)
        s2.drain_outputs()
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(3, 40):
            feed2(k)
        outs = s2.drain_outputs()
        dt = (time.perf_counter() - t0) / len(outs) * 1e3
        print(f"vo_step sustained: {dt:.3f} ms/frame ({1e3 / dt:.2f} fps, "
              f"wall, frames 3-39)")
        print(json.dumps({"tool": "torch_lk_microbench", "what": "step",
                          "case": "vo_step sustained", "wall_ms": dt,
                          "device": dev, "card": smi}))


if __name__ == "__main__":
    main()
