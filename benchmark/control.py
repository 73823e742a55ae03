"""Readings for the limits: the program's compared numbers and the
control's, seed by seed, in one process.

    python3 -m benchmark.control --workload vo_bench.fleet256 \
        --seeds 11,12,13 --seconds 51 [--control-seeds 3] \
        [--faults all --fault-seconds 10] [--out PATH]

Each seed is a run of the cell at its own size (a window of ``--seconds``,
every stream, the comparison on the checked streams); the control is the
reference computed in bfloat16, put in the program's place (its tracks,
its kept and dropped sets, its landmarks' depths and its poses), read on
the first ``--control-seeds`` seeds.  With ``--faults``, each named fault
of ``faults.py`` (``all``: every one) is planted under a run of its own on
the first seed, with a window of ``--fault-seconds`` (``--seconds`` for
those that act only after the window's first span).  Prints one JSON
line a run: the numbers and the distributions behind them.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


def _quantiles(x) -> dict:
    x = np.asarray(x, np.float64)
    if len(x) == 0:
        return {}
    return {"n": int(len(x)), "median": float(np.median(x)),
            "p90": float(np.quantile(x, 0.9)),
            "p99": float(np.quantile(x, 0.99)), "max": float(x.max()),
            "rms": float(np.sqrt(np.mean(x * x)))}


def readings(cell, seed: int, seconds: float, device, with_control=True,
             **kw) -> dict:
    """The program's numbers of one run, and with ``with_control`` the
    control's, with the distributions of the track steps and pose gaps."""
    from benchmark import check, harness

    res = harness.run_cell(cell, seed, seconds, False, device,
                           keep_record=True, **kw)
    rec = res["record"]
    out = {"seed": seed, "frames": len(rec.window_frames),
           "failed": res["failed"], "attempted": res["attempted"],
           "check_s": res["check_s"],
           "rate": res["metrics"]["stream_frames_per_s"]["value"]}
    sides = (("program", False), ("control", True))
    for side, control in sides[:2 if with_control else 1]:
        got = check.parts(rec, control)
        ok, rows = check.judge(check.numbers(rec, control, got), cell.limits)
        out[side] = {"correct": ok, "numbers": {k: v for k, v, _ in rows},
                     "detail": {k: (_quantiles(v) if torch.is_tensor(v)
                                    else v) for k, v in got.items()}}
    return out


def fault_readings(cell, name: str, seed: int, seconds: float, device,
                   **kw) -> dict:
    """The numbers of one run with fault ``name`` planted."""
    from benchmark import faults, harness

    with faults.planted(name, cell):
        res = harness.run_cell(cell, seed, seconds, False, device, **kw)
    return {"fault": name, "seed": seed, "correct": res["correct"],
            "failed": res["failed"], "attempted": res["attempted"],
            "numbers": {k: v for k, v, _ in res["compared"]}}


def main(argv=None) -> int:
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds, the first, also read the "
                         "control")
    ap.add_argument("--faults", default="",
                    help="comma-separated faults.py names, or all")
    ap.add_argument("--fault-seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = harness.Cell.load(harness.load_json(root / "BENCHMARK.json"),
                             args.workload, root)
    from benchmark import faults, run

    cores = run.pin_cores()
    print(f"control: cores {cores}", file=sys.stderr)
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    names = (faults.NAMES if args.faults == "all"
             else [n for n in args.faults.split(",") if n])

    def emit(got):
        line = json.dumps(got)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for name in names:
        emit(fault_readings(cell, name, seeds[0], args.seconds
                            if name in faults.LATE else args.fault_seconds,
                            "cuda"))
    for i, seed in enumerate(seeds):
        emit(readings(cell, seed, args.seconds, "cuda",
                      with_control=i < args.control_seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
