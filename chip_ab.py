"""Time the front end of two trees of the repo in turns, on one NVIDIA GPU,
with chip_smoke.py's stage probe, on the K1 path or the xcorr path.

    python3 chip_ab.py ROOT_A ROOT_B [--frames 80] [--lk k1|xcorr]

Each turn is a process of its own that imports visfs_tpu_torch from its
ROOT and everything else from this checkout's chip_smoke.py: the bench
parameters, the 640x480 bench loop's first ``--frames`` frames, the
System's start over frames 0-1 (``start_loop``) and the probe over the
rest (``timed_steps``: host clock and CUDA events around every
``tracker_step``, CUDA events around every step).  So both trees run the
same probe on the same frames.  ``--lk k1`` (the default) runs the
System's own LK path (K1); ``--lk xcorr`` replaces its lk_params with
backend="jnp", iter_mode="xcorr" (chip_smoke.XCORR), the path through K2.
The turns run A, B, B, A; each prints one JSON line: the root, the path, the
medians per frame, the frame wall, the launch counts per frame of that
tree's wrappers of the path's kernel (whichever of ``PYR_LAUNCHES`` and
``LAUNCHES`` the tree has), and the device time of one bidirectional track
of the path (``track_device``: every kernel, copy and fill that one
``lk_track_bidirectional_pyr`` call puts on the card, summed, at N = 120 and
N = 240 on chip_smoke.py's bench pair), so that a tree whose track is many
launches and one whose track is one launch compare on the same work.  To
compare two commits, unpack one (``git archive``) into a git-ignored
directory of the checkout.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def track_device(lk, seq, reps=20, tries=3):
    """{n: (device ms, device events) per call} of one bidirectional track
    of the path's LK at N = 120 and 240 on chip_smoke.level_inputs: the
    summed durations of every device event (kernels, copies, fills) in a
    torch.profiler trace of reps calls, over reps.  A trace that comes back
    without device records is taken again, up to ``tries`` times."""
    import chip_smoke
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from visfs_tpu_torch.ops.lk import LKParams, lk_track_bidirectional_pyr

    _, pyr0, pyr1, points = chip_smoke.level_inputs(seq)
    params = (LKParams(**chip_smoke.XCORR) if lk == "xcorr"
              else LKParams(backend="pallas"))
    out = {}
    for n in (120, 240):
        pts = points[:n].contiguous()
        valid = torch.ones(n, dtype=torch.bool, device=pts.device)

        def call():
            lk_track_bidirectional_pyr(pyr0, pyr1, pts, pts, valid, params)

        call()
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    call()
                torch.cuda.synchronize()
            dev = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            if dev:
                break
        else:
            chip_smoke.fail(f"chip_ab: no device records for N = {n}")
        out[n] = (sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3,
                  len(dev) / reps)
    return out


def turn(root, frames, lk):
    # this checkout's chip_smoke first (ROOT may hold another one), then
    # ROOT's package ahead of this checkout's
    import chip_smoke

    sys.path.insert(0, os.path.abspath(root))
    import torch

    from visfs_tpu_torch.io.sim import cached_textured_sequence
    from visfs_tpu_torch.ops.kernels import lk_level, lk_xcorr
    from visfs_tpu_torch.slam.system import System

    if not torch.cuda.is_available():
        chip_smoke.fail("chip_ab: torch.cuda.is_available() is false")
    seq = cached_textured_sequence(
        cache_dir=os.path.join(HERE, "build", "sim_cache"), n_frames=frames,
        width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT, motion="square",
        seed=0, speed=2.0, device="cuda")
    kernel = lk_xcorr if lk == "xcorr" else lk_level
    sys_, lefts, rights = chip_smoke.start_loop(
        seq, System, chip_smoke.XCORR if lk == "xcorr" else None)
    counters = [c for c in ("PYR_LAUNCHES", "LAUNCHES")
                if hasattr(kernel, c)]
    for c in counters:
        setattr(kernel, c, 0)
    _, stages, _ = chip_smoke.timed_steps(sys_, seq, lefts, rights)
    n = frames - 2
    name = kernel.__name__.rsplit(".", 1)[-1]
    launches = {f"{name}.{c}": getattr(kernel, c) / n for c in counters}
    track = track_device(lk, seq)
    print(json.dumps(dict(
        root=root, lk=lk, frames=n, **stages, launches_per_frame=launches,
        track_device_ms={k: v[0] for k, v in track.items()},
        track_device_events={k: v[1] for k, v in track.items()})),
        flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--lk", choices=("k1", "xcorr"), default="k1")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        turn(args.roots[0], args.frames, args.lk)
        return
    a, b = args.roots
    for root in (a, b, b, a):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        root, root, "--frames", str(args.frames), "--lk",
                        args.lk], check=True, timeout=900)


if __name__ == "__main__":
    main()
