"""The edge frame of chip_smoke.py's phase small at SensorStrategy 5 (the
8-frame 160x120 textured square loop, seed 0, 180-beam scans, bench.py's
parameters at 160 px with 40 features, a submap every 3 scans, no wheel
rows): one ulp of the state decides whether frame 3 is lost, in the JAX
package as in the port.

Frame 3's temporal track keeps 13 or 12 features, and the PnP then counts
12 or 11 inliers, either side of Estimator/MinInliers (12).  Which follows
one feature whose motion-prior guess lies outside the image: its pyramidal
LK track from there ends about 20 px apart for guesses one ulp apart.  So
chip_smoke.py holds the "cuda" step of such a frame against a "cpu" step,
from the state nudged by one ulp, that has the same outcome.  Here, from
the port's CPU state before frame 3, stepped with the state nudged by one
ulp before frames 1 and 2 (PATH_SEEDS; the laser BA's Hessian holds only
float32 residues in the out-of-plane dofs on these frames, so which side
of the edge frame 3 falls on moves with them):
  - the reference System, stepped from the same one-ulp nudged states as
    the port, gives the port's (inliers, lost) at each;
  - the reference's own pyramidal LK (its Pallas kernel, interpret mode) on
    the port's frame-3 track inputs keeps a feature at its guess and loses
    it one ulp away, or the reverse: the JAX package's lost flag there is
    the rounding's too.  At the guesses themselves the port's K1 (its plain
    version on the CPU) keeps the features the reference keeps."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.io.sim import cached_textured_sequence
from visfs_tpu.ops import lk as jlk
from visfs_tpu.slam.system import System as JSystem
from visfs_tpu_torch.ops import lk as tlk
from visfs_tpu_torch.slam import tracker as tracker_mod
from visfs_tpu_torch.slam.state import state_to_numpy
from visfs_tpu_torch.slam.system import System

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (S3_SCAN_CAPACITY, bench_params,  # noqa: E402
                        fusion_params, nudged)

torch.set_num_threads(1)

EDGE = 3  # the frame
SEEDS = 4  # one-ulp nudges of the state before it
# frame: the seed of its one-ulp nudge on the way (of seeds 1000k + frame,
# k < 8, the first path whose frame 3 shows both witnesses)
PATH_SEEDS = {1: 5001, 2: 5002}


def _outcome(s, seq, i):
    s.input_primary_sensor_data(float(seq.stamps[i]), seq.left[i],
                                seq.right[i], scan=seq.laser_scans[i])
    out = s.drain_outputs()[-1]
    return int(out.n_inliers), bool(out.lost)


@pytest.fixture(scope="module")
def edge():
    seq = cached_textured_sequence(n_frames=8, width=160, height=120,
                                   motion="square", seed=0, speed=2.0,
                                   with_laser=True, n_beams=180)
    cam = seq.camera
    p = fusion_params(dict(bench_params(160), **{"Tracker/MaxFeatures": 40}),
                      5)
    port = System(p, device="cpu", scan_capacity=S3_SCAN_CAPACITY)
    ref = JSystem(p, scan_capacity=S3_SCAN_CAPACITY)
    ref.lk_params = ref.lk_params._replace(backend="pallas")
    for s in (port, ref):
        s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(cam.baseline), width=cam.width, height=cam.height)
    for i in range(EDGE):
        if i in PATH_SEEDS:
            port.state = nudged(port.state, PATH_SEEDS[i])
        _outcome(port, seq, i)
    before = port.state
    # the frame's temporal track (the tracker's first bidirectional call)
    track, calls = tracker_mod.lk_track_bidirectional_pyr, []

    def keep(*a, **kw):
        calls.append(a)
        return track(*a, **kw)

    tracker_mod.lk_track_bidirectional_pyr = keep
    try:
        _outcome(port, seq, EDGE)
    finally:
        tracker_mod.lk_track_bidirectional_pyr = track
    treedef = jax.tree_util.tree_structure(ref.state)
    outcomes = {"port": [], "ref": []}
    for seed in range(SEEDS):
        state = nudged(before, seed)
        port.state = state
        outcomes["port"].append(_outcome(port, seq, EDGE))
        ref.state = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(np.array(x)) for x in
            jax.tree_util.tree_leaves(tuple(state_to_numpy(state)))])
        outcomes["ref"].append(_outcome(ref, seq, EDGE))
    return dict(outcomes=outcomes, track=calls[0],
                min_inliers=port.cfg.estimator_min_inliers)


def test_nudged_steps_match_reference(edge):
    assert edge["outcomes"]["port"] == edge["outcomes"]["ref"]


def _ulp_inits(init, live):
    """The guesses, and their x one ulp up and one ulp down: [3N, 2]."""
    x = init[:, 0]
    up = init.clone()
    up[:, 0] = torch.nextafter(x, torch.full_like(x, float("inf")))
    down = init.clone()
    down[:, 0] = torch.nextafter(x, torch.full_like(x, float("-inf")))
    return torch.cat([init, up, down]), live.repeat(3)


def test_reference_lk_flips_within_one_ulp(edge):
    prev_pyr, left_pyr, prev_uv, init_uv, live, params = edge["track"]
    inits, lives = _ulp_inits(init_uv, live)
    froms = prev_uv.repeat(3, 1)
    jp = jlk.LKParams(win_size=params.win_size, max_level=params.max_level,
                      iterations=params.iterations, eps=params.eps,
                      min_eig_threshold=params.min_eig_threshold,
                      backend="pallas")

    def pyramid(p):
        return jlk.LKPyramid(*(tuple(jnp.asarray(x.numpy()) for x in f)
                               for f in p[:3]), *p[3:])

    jprev, jleft = pyramid(prev_pyr), pyramid(left_pyr)
    ref = jax.jit(lambda a, b, c: jlk.lk_track_bidirectional_pyr(
        jprev, jleft, a, b, c, jp, fb_threshold=1.5))(
        jnp.asarray(froms.numpy()), jnp.asarray(inits.numpy()),
        jnp.asarray(lives.numpy()))
    kept = np.asarray(ref.status).reshape(3, -1)
    n = int(live.sum())
    # one ulp of a guess decides whether the reference keeps some feature
    flips = np.flatnonzero(live.numpy() & ((kept[0] != kept[1])
                                           | (kept[0] != kept[2])))
    assert len(flips) >= 1, f"no feature of {n} flips within one ulp"
    # at the guesses themselves the port keeps what the reference keeps
    port = tlk.lk_track_bidirectional_pyr(prev_pyr, left_pyr, prev_uv,
                                          init_uv, live, params,
                                          fb_threshold=1.5)
    np.testing.assert_array_equal(port.status.numpy(), kept[0])
