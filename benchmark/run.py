"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload vo_bench.fleet256 --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout, on a machine with the cards the cell asks for.
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (a profiled slice after the
window).  The last line of standard output is one JSON object; the numbers
the comparison read, each beside its limit, are the last lines of standard
error and the result's last key.  Exits non-zero, printing no result, where
CUDA is missing or has fewer cards than the cell asks for, where the
port is not this checkout's, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

# Top-level modules that no part of a run may load (compared whole: the
# port, visfs_tpu_torch, shares the JAX package's prefix).
FORBIDDEN = ("jax", "jaxlib", "flax", "visfs_tpu")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# Cores the run keeps to: the last of those it may use (the first takes
# most of the machine's interrupts).  The host's side of the step is one
# thread launching kernels; held on fixed cores it is not moved between
# them through the window.
PINNED_CORES = 2


def pin_cores() -> list:
    """Keep this process, and every thread it starts from now on, on the
    last ``PINNED_CORES`` cores it may use; returns them."""
    cores = sorted(os.sched_getaffinity(0))[-PINNED_CORES:]
    os.sched_setaffinity(0, cores)
    return cores


def _fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    # Build and kernel caches stay inside the checkout, at fixed paths.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    # The host's side of the step is one thread launching kernels: no pool
    # of CPU threads competes with it for the cores.
    os.environ["OMP_NUM_THREADS"] = "1"
    cores = pin_cores()
    from benchmark import harness

    bench = harness.load_json(root / "BENCHMARK.json")
    cell = harness.Cell.load(bench, args.workload, root)
    chips = {w["name"]: w for w in bench["workloads"]}[args.workload]["chips"]

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        return _fail("CUDA is not available", 2)
    if torch.cuda.device_count() < chips:
        return _fail(f"{chips} cards needed, {torch.cuda.device_count()} "
                     "found", 2)
    try:
        import visfs_tpu_torch
    except ImportError as e:
        return _fail(f"the program is missing: {e}", 2)
    pkg = Path(visfs_tpu_torch.__file__).resolve()
    if not pkg.is_relative_to(root.resolve()):
        return _fail(f"visfs_tpu_torch comes from {pkg}, not this checkout",
                     2)

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        return _fail(f"forbidden modules loaded: {found}", 3)
    compared = result.pop("compared")
    parts = ", ".join(f"{k} {v:.2f} s"
                      for k, v in result.pop("setup_parts").items())
    print(f"set-up: {parts}; the comparison took {result['check_s']:.1f} s;"
          f" cores {cores}", file=sys.stderr)
    for name, value, limit in compared:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    if "power_limit" in result["device"]:
        print(f"card: {result['device']['power_limit']}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["compared"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in compared}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
