"""Wheel rows lost to the step: the JAX package's SystemRuntime against
visfs_tpu_torch's, on the CPU.

A strategy-2 System (stereo and wheel) behind each package's native
runtime: the main thread pushes 6 frames of a 160x120 starfield into the
runtime, then pushes a wheel row every 2 ms (as a transport's thread
would) until the runtime's worker has stepped every frame.  A push that
writes ``System.state`` itself while a step runs is overwritten when the
step assigns the state, and in the JAX package a push that reads the
state while the step holds it donated raises; the odometry buffer's head
counts the rows that survived.  The port runs twice: as it is (a push
hands its rows to the next step) and with a push that writes the state
itself without the step's lock, the reference's design.

    JAX_PLATFORMS=cpu python tools/wheel_race.py [--frames 6] [--seed 41]
        [--deadline 120]

Prints one JSON line a run: frames the runtime processed and frames that
came out, rows pushed, pushes that raised (and the first error), the head,
rows lost.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PARAMS = {"Tracker/MaxFeatures": 60, "Tracker/MinDistance": 10,
          "System/SensorStrategy": 2}


def race(system, runtime_cls, seq, n_frames, deadline_s, period_s=0.002):
    """(rows pushed, pushes that raised, the first error, odometry head,
    frames the runtime processed, frames that came out) after feeding
    ``system`` through ``runtime_cls`` with wheel rows pushed while it
    steps (until every frame is processed or ``deadline_s``)."""
    srt = runtime_cls(system, capacity=max(8, n_frames + 2), slop_s=0.02)
    srt.start()
    pushed, raised, first = 0, 0, None
    odom = seq.wheel_odom
    try:
        for i in range(n_frames):
            srt.push_left(float(seq.stamps[i]), seq.left[i])
            srt.push_right(float(seq.stamps[i]), seq.right[i])
        t_end = time.time() + deadline_s
        while srt.stats()["processed"] < n_frames and time.time() < t_end:
            row = odom[pushed % len(odom)]
            pushed += 1
            try:
                srt.push_odometry(float(row[0]), row[1:7])
            except Exception as e:  # noqa: BLE001 — counted and reported
                raised += 1
                first = first or f"{type(e).__name__}: {str(e)[:120]}"
            time.sleep(period_s)
    finally:
        srt.stop()
    outs = 0
    while system.output_odometry_info() is not None:
        outs += 1
    return (pushed, raised, first, int(system.state.odom.head),
            srt.stats()["processed"], outs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--seed", type=int, default=41)
    ap.add_argument("--deadline", type=float, default=120.0,
                    help="seconds to wait for the worker to step every "
                         "frame")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(1)
    import visfs_tpu.runtime as jrt
    import visfs_tpu_torch.runtime as trt
    from visfs_tpu.io.sim import generate_sequence
    from visfs_tpu.slam.system import System as JSystem
    from visfs_tpu_torch.slam.system import System

    seq = generate_sequence(n_frames=args.frames, width=160, height=120,
                            n_points=300, seed=args.seed)
    cam = seq.camera

    def build(cls, **kw):
        s = cls(PARAMS, **kw)
        s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(cam.baseline), width=cam.width, height=cam.height)
        return s

    # the reference compiles its step at the first frame: warm the cache
    warm = build(JSystem)
    warm.input_wheel_odometry(0.0, seq.wheel_odom[0][1:7])
    warm.input_primary_sensor_data(float(seq.stamps[0]), seq.left[0],
                                   seq.right[0])
    warm.drain_outputs()

    runs = [("visfs_tpu", lambda: build(JSystem), jrt.SystemRuntime),
            ("visfs_tpu_torch", lambda: build(System, device="cpu"),
             trt.SystemRuntime)]

    class DirectPush(System):
        """A push that writes the state at once, from the pushing thread
        and without the state lock, as the reference's does."""

        def input_wheel_odometry_batch(self, stamps, pose6, velocity6=None):
            super().input_wheel_odometry_batch(stamps, pose6, velocity6)
            self._apply_pending_odometry()

    runs.append(("visfs_tpu_torch with a push that writes the state",
                 lambda: build(DirectPush, device="cpu"), trt.SystemRuntime))
    for name, make, rt_cls in runs:
        t0 = time.perf_counter()
        pushed, raised, first, head, processed, outs = race(
            make(), rt_cls, seq, args.frames, args.deadline)
        print(json.dumps({"package": name, "frames": args.frames,
                          "frames_processed": processed,
                          "frames_out": outs,
                          "rows_pushed": pushed, "pushes_raised": raised,
                          "odometry_head": head,
                          "rows_lost": pushed - head, "first_error": first,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
