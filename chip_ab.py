"""Time the K1 path's front end of two trees of the repo in turns, on one
NVIDIA GPU, with chip_smoke.py's stage probe.

    python3 chip_ab.py ROOT_A ROOT_B [--frames 80]

Each turn is a process of its own that imports visfs_tpu_torch from its
ROOT and everything else from this checkout's chip_smoke.py: the bench
parameters, the 640x480 bench loop's first ``--frames`` frames, the
System's start over frames 0-1 (``start_loop``) and the probe over the
rest (``timed_steps``: host clock and CUDA events around every
``tracker_step``, CUDA events around every step).  So both trees run the
same probe on the same frames.  The turns run A, B, B, A; each prints one
JSON line: the root, the medians per frame, the frame wall and the K1
launch counts per frame of that tree's wrapper.  To compare two commits,
unpack one (``git archive``) into a git-ignored directory of the checkout.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def turn(root, frames):
    # this checkout's chip_smoke first (ROOT may hold another one), then
    # ROOT's package ahead of this checkout's
    import chip_smoke

    sys.path.insert(0, os.path.abspath(root))
    import torch

    from visfs_tpu_torch.io.sim import cached_textured_sequence
    from visfs_tpu_torch.ops.kernels import lk_level as k1
    from visfs_tpu_torch.slam.system import System

    if not torch.cuda.is_available():
        chip_smoke.fail("chip_ab: torch.cuda.is_available() is false")
    seq = cached_textured_sequence(
        cache_dir=os.path.join(HERE, "build", "sim_cache"), n_frames=frames,
        width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT, motion="square",
        seed=0, speed=2.0, device="cuda")
    sys_, lefts, rights = chip_smoke.start_loop(seq, System, None)
    counters = [c for c in ("PYR_LAUNCHES", "LAUNCHES") if hasattr(k1, c)]
    for c in counters:
        setattr(k1, c, 0)
    _, stages, _ = chip_smoke.timed_steps(sys_, seq, lefts, rights)
    n = frames - 2
    print(json.dumps(dict(root=root, frames=n, **stages,
                          k1_launches_per_frame={c: getattr(k1, c) / n
                                                 for c in counters})),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        turn(args.roots[0], args.frames)
        return
    a, b = args.roots
    for root in (a, b, b, a):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        root, root, "--frames", str(args.frames)],
                       check=True, timeout=900)


if __name__ == "__main__":
    main()
