"""ATE of the JAX package's System (visfs_tpu) on the CPU over the textured
bench loop, at the System's own LK configuration (direct iteration) and in
correlation form (iter_mode="xcorr", backend="jnp-xcorr").  These are the
reference figures beside which PERF.md sets visfs_tpu_torch's two LK paths
on the card (chip_smoke.py phases main and xcorr).

    JAX_PLATFORMS=cpu python reference_lk_ate.py [--frames 300]

Prints one JSON line per LK configuration: ATE over frames 2.. (as
chip_smoke.py computes it), lost frames among them, and the fewest inliers.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MODES = {"direct": {},
         "xcorr": {"iter_mode": "xcorr", "backend": "jnp-xcorr"}}
PARAMS = {  # the bench's simMapping operating point (bench.py:57-72)
    "Tracker/MaxFeatures": 120,
    "Tracker/MinDistance": 40,
    "Tracker/QualityLevel": 0.05,
    "LocalMap/MapSize": 5,
    "Optimizer/Iterations": 20,
    "Estimator/Force3DoF": True,
    "Estimator/ToleranceTranslation": 0.40,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from visfs_tpu.io.sim import ate_rmse, cached_textured_sequence
    from visfs_tpu.slam.system import System

    seq = cached_textured_sequence(n_frames=args.frames, width=640,
                                   height=480, motion="square", seed=0,
                                   speed=2.0)
    cam = seq.camera
    for mode, lk in MODES.items():
        s = System(PARAMS)
        s.lk_params = s.lk_params._replace(**lk)
        s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(cam.baseline), width=cam.width, height=cam.height)
        outs = s.run_sequence(seq.stamps, seq.left, seq.right)[2:]
        est = np.stack([np.asarray(o.pose) for o in outs])
        print(json.dumps({
            "mode": mode, "frames": len(outs),
            "ate_m": ate_rmse(est, seq.poses[2:2 + len(est)]),
            "lost": int(sum(bool(o.lost) for o in outs)),
            "min_inliers": int(min(int(o.n_inliers) for o in outs))}),
            flush=True)


if __name__ == "__main__":
    main()
