"""Replay publisher: paces a recorded stereo sequence over ZeroMQ (torch
port of visfs_tpu.io.zmq_replay; the same wire format and options).

The live half of the two-process integration test (the rosbag-play
equivalent of the reference's operating mode, README.md:44-56): binds a
PUB socket, keeps broadcasting camera infos + the static frame tree (PUB/
SUB slow-joiner handling, like latched ROS topics), then streams left/
right frames at a configurable rate with optional per-side drops and
out-of-order delivery, finishing with an ``eos`` marker.  Stats go to
stdout as one JSON line so the test can assert on what was actually sent.

Run as a module in its own process:
    python -m visfs_tpu_torch.io.zmq_replay --data seq.npz --endpoint tcp://... \
        --hz 60 --drop 0.05 --swap 0.2 [--preroll-s 0.5] [--seed 7]

seq.npz fields: left/right [T,H,W] (any numeric dtype), stamps [T],
fx, fy, cx, cy, baseline scalars, and optional frames (json str).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .zmq_transport import _encode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--endpoint", required=True)
    ap.add_argument("--hz", type=float, default=60.0)
    ap.add_argument("--drop", type=float, default=0.0,
                    help="independent per-side frame drop probability")
    ap.add_argument("--swap", type=float, default=0.0,
                    help="probability a frame's L/R are sent right-first "
                         "and delayed past the next frame (out-of-order)")
    ap.add_argument("--preroll-s", type=float, default=0.5,
                    help="camera-info broadcast time before streaming")
    ap.add_argument("--seed", type=int, default=0)
    # Hostile-stream knobs (transport stress tests):
    ap.add_argument("--stall-at", type=int, default=-1,
                    help="frame index before which the stream stalls")
    ap.add_argument("--stall-s", type=float, default=0.0,
                    help="bursty stall duration in seconds")
    ap.add_argument("--blackout-from", type=int, default=-1,
                    help="first frame of a total loss-of-stream window "
                         "(both sides dropped; stamps keep advancing)")
    ap.add_argument("--blackout-to", type=int, default=-1,
                    help="first frame after the blackout window")
    ap.add_argument("--info-delay-s", type=float, default=0.0,
                    help="delay before camera-info/tf broadcasting starts "
                         "(late-camera-info bring-up)")
    args = ap.parse_args(argv)

    import zmq

    d = np.load(args.data, allow_pickle=False)
    left, right, stamps = d["left"], d["right"], d["stamps"]
    frames_tbl = json.loads(str(d["frames"])) if "frames" in d else {}
    rng = np.random.default_rng(args.seed)

    ctx = zmq.Context.instance()
    pub = ctx.socket(zmq.PUB)
    pub.bind(args.endpoint)

    info = {
        "width": int(left.shape[2]), "height": int(left.shape[1]),
        "fx": float(d["fx"]), "fy": float(d["fy"]),
        "cx": float(d["cx"]), "cy": float(d["cy"]),
    }
    info_r = dict(info, tx=-float(d["baseline"]) * info["fx"])

    def latched():
        pub.send_multipart(_encode("camera_info/left", info))
        pub.send_multipart(_encode("camera_info/right", info_r))
        pub.send_multipart(_encode("tf", {"frames": frames_tbl}))

    if args.info_delay_s > 0:
        # Late camera-info: stay silent first — subscribers' bring-up wait
        # loops must survive an initially info-less wire.
        time.sleep(args.info_delay_s)
    t_end = time.monotonic() + args.preroll_s
    while time.monotonic() < t_end:
        latched()
        time.sleep(0.05)

    period = 1.0 / args.hz
    sent = {"left": 0, "right": 0}
    dropped = {"left": 0, "right": 0}
    swapped = 0
    blacked_out = 0
    deferred = []  # messages delayed past the next frame slot
    t0 = time.monotonic()
    for i in range(len(stamps)):
        if i == args.stall_at and args.stall_s > 0:
            time.sleep(args.stall_s)  # bursty multi-second stall
            t0 += args.stall_s
        # pace in real time
        lag = t0 + i * period - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        latched()  # keep re-broadcasting so late joiners still bring up
        for m in deferred:
            pub.send_multipart(m)
        deferred = []
        if args.blackout_from <= i < args.blackout_to:
            blacked_out += 1
            continue  # total loss of stream; stamps keep advancing
        stamp = float(stamps[i])
        msgs = []
        for side, img in (("left", left[i]), ("right", right[i])):
            if rng.random() < args.drop:
                dropped[side] += 1
                continue
            hdr = {"stamp": stamp, "shape": list(img.shape),
                   "dtype": img.dtype.str}
            msgs.append((side, _encode(f"{side}/image", hdr, img)))
            sent[side] += 1
        if len(msgs) == 2 and rng.random() < args.swap:
            # right goes now, left arrives after the NEXT frame's messages
            swapped += 1
            pub.send_multipart(msgs[1][1])
            deferred.append(msgs[0][1])
        else:
            for _, m in msgs:
                pub.send_multipart(m)
    for m in deferred:
        pub.send_multipart(m)
    # give SUB a moment to drain, then mark end of stream
    time.sleep(0.2)
    pub.send_multipart(_encode("eos", {}))
    time.sleep(0.2)
    print(json.dumps({"sent": sent, "dropped": dropped, "swapped": swapped,
                      "blacked_out": blacked_out,
                      "frames": int(len(stamps))}))
    pub.close(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
