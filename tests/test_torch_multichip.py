"""The port's multi-card entry (visfs_tpu_torch.multichip) on the CPU, and
its dp_fleet_step against the JAX package's on the dryrun's own case.

  * ``python -m visfs_tpu_torch.multichip --world 2 --device cpu --width
    160 --height 120 --frames 4 --robot-frames 8``: two gloo ranks run the
    entry's sections a-d (dp_fleet_step at strategies 0 and 3, FleetMapping
    against MultiRobotMapping, the sharded solvers against the one-rank
    solve) and every gate of its report holds (the entry states them).
  * __graft_entry__.dryrun_multichip's tiny case (its _tiny_setup's
    config and sizes: 64x96, 24 features, the jnp LK level in correlation
    form): the JAX package's dp_fleet_step on 2 of the 8 virtual CPU
    devices against the port's on two gloo ranks
    (tests/_torch_dist_worker.py), from the same state (the ranks' through
    state_from_numpy) on the same numpy-seeded images, three frames: the
    dryrun's random pair, then a textured plane seen 4 px apart by the two
    cameras, then moved 1 px.  Gates: inliers and lost flags equal, each
    stream's pose within 3e-5 m (the one-step bound of the port's mode
    slices, tests/torch_mode_slice.py).

One JAX compile (the dp step, shared by the three frames)."""

import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from visfs_tpu_torch.slam.state import state_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import _torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
TIMEOUT_S = 400
POSE_BOUND = 3e-5
# __graft_entry__._tiny_config's parameters
TINY = {"Tracker/MaxFeatures": 24, "Tracker/MinDistance": 10,
        "Tracker/FlowWinSize": 9, "Tracker/FlowMaxLevel": 1,
        "Estimator/PnPIterations": 8, "Optimizer/Iterations": 4}


@pytest.fixture(scope="module")
def entry():
    """The entry at world 2 on the CPU, started (the sim cache the port's
    CPU tests share)."""
    cache = os.environ.get("VISFS_SIM_CACHE", os.path.join(
        tempfile.gettempdir(), "visfs_sim_cache"))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "visfs_tpu_torch.multichip", "--world",
         str(WORLD), "--device", "cpu", "--width", "160", "--height", "120",
         "--frames", "4", "--robot-frames", "8", "--cache-dir", cache],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def report(entry, tiny_runs):
    """The entry's report; the JAX case (tiny_runs) runs while it works."""
    try:
        out, err = entry.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        entry.kill()
        out, err = entry.communicate()
    lines = out.strip().splitlines()
    assert lines, err[-3000:]
    rep = json.loads(lines[-1])
    rep["returncode"] = entry.returncode
    rep["log"] = out
    return rep


@pytest.mark.parametrize("section", "abcd")
def test_entry_section_gates_hold(report, section):
    gates = report["sections"][section]["gates"]
    assert gates and all(gates.values()), (gates, report["log"][-4000:])


def test_entry_runs_the_dp_path(report):
    assert report["returncode"] == 0 and report["ok"]
    assert (report["world"], report["device"], report["backend"]) == (
        WORLD, "cpu", "gloo")
    a, b, c = (report["sections"][k] for k in "abc")
    assert a["offsets"] == [0, 7] and b["offsets"] == [0, 116]
    assert c["offsets"] == [0, 120] and c["cross_robot"] >= 1
    # 2 K1 pyramid calls a timed frame a rank in a and b, a frame in c
    assert report["k1_pyramid_launches"] == WORLD * (2 * 2 + 2 * 2 + 2 * 8)
    # nothing of the card is reported from a CPU run
    assert a["gather_device_ms_per_frame"] is None
    assert a["syncs"] == [None, None]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _frames(h, w):
    """Three frames of [B, H, W] images and [B] stamps: the dryrun's random
    pair (rng 1), then each stream's textured plane, the right view 4 px
    over, the next frame moved 1 px."""
    rng = np.random.default_rng(1)
    first = tuple(rng.uniform(0, 255, (WORLD, h, w)).astype(np.float32)
                  for _ in range(2)) + (np.full(WORLD, 0.1, np.float32),)
    base = rng.uniform(0, 255, (WORLD, h, w)).astype(np.float32)
    plane = (base, np.roll(base, -4, axis=2), np.full(WORLD, 0.2,
                                                      np.float32))
    moved = (np.roll(base, 1, axis=2), np.roll(base, -3, axis=2),
             np.full(WORLD, 0.3, np.float32))
    return [first, plane, moved]


def _to_jax_state(np_state):
    """A port state_to_numpy result as the JAX package's VOState type."""
    from visfs_tpu.slam import state as js

    def conv(cls, src):
        return cls(**{f: getattr(src, f) for f in cls._fields})

    return js.VOState(
        features=conv(js.FeatureTable, np_state.features),
        window=conv(js.WindowState, np_state.window),
        counters=conv(js.KeyframeCounters, np_state.counters),
        odom=conv(js.OdomBuffer, np_state.odom),
        **{f: getattr(np_state, f) for f in js.VOState._fields
           if f not in ("features", "window", "counters", "odom")})


def _tiny_setup():
    """__graft_entry__._tiny_setup's camera, settings, LK parameters and
    state sizes, with no eager JAX op: the camera and the state are the
    port's (handed to the JAX package as numpy), so the dp step is the one
    program the JAX package compiles.  Returns (the JAX package's camera,
    settings, LKParams and config hash, the starting state as the port's
    numpy state, the ranks' setup)."""
    from __graft_entry__ import _tiny_config
    from visfs_tpu.config import config_from_parameters
    from visfs_tpu.core.camera import StereoCamera
    from visfs_tpu.ops.lk import LKParams
    from visfs_tpu.slam.system import _build_settings, build_cfg_hash
    from visfs_tpu_torch.core.camera import make_stereo_camera
    from visfs_tpu_torch.ops.lk import LKParams as TLKParams
    from visfs_tpu_torch.ops.lk import lk_pad
    from visfs_tpu_torch.slam.state import init_state

    cfg = _tiny_config()
    assert cfg == config_from_parameters(TINY)
    lk = LKParams(win_size=cfg.tracker_flow_win_size,
                  max_level=cfg.tracker_flow_max_level,
                  iterations=cfg.tracker_flow_iterations,
                  eps=cfg.tracker_flow_eps)
    lk_kw = dict(win_size=lk.win_size, max_level=lk.max_level,
                 iterations=lk.iterations, eps=lk.eps,
                 min_eig_threshold=lk.min_eig_threshold, backend=lk.backend,
                 iter_mode=lk.iter_mode)
    camera = dict(fx=80.0, fy=80.0, cx=48.0, cy=32.0, baseline=0.1,
                  width=96, height=64)
    tcam = make_stereo_camera(**camera, device="cpu")
    cam = StereoCamera(*(getattr(tcam, f) if f in ("width", "height")
                         else getattr(tcam, f).numpy()
                         for f in StereoCamera._fields))
    state = state_to_numpy(init_state(
        camera["height"], camera["width"],
        capacity=2 * cfg.tracker_max_features,
        window=cfg.local_map_map_size + 1, device="cpu", seed=0,
        lk_pad=lk_pad(TLKParams(**lk_kw)), lk_max_level=lk.max_level))
    setup = dict(params=TINY, lk=lk_kw, camera=camera, state=state)
    return cam, _build_settings(cfg), lk, build_cfg_hash(cfg), state, setup


@pytest.fixture(scope="module")
def tiny_runs():
    """(the port's two ranks' gathered outputs per frame, the JAX dp step's
    outputs per frame); the JAX program compiles while the ranks work."""
    from visfs_tpu.slam.fleet import dp_fleet_step

    cam, settings, lk, cfg_hash, state, setup = _tiny_setup()
    frames = _frames(setup["camera"]["height"], setup["camera"]["width"])
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=worker.tiny_dp_worker,
                         args=(r, WORLD, port, setup, frames, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
        # numpy in, numpy out: every frame's call hits the one program
        states = jax.tree_util.tree_map(
            lambda x: np.stack([x] * WORLD), _to_jax_state(state))
        ref = []
        for left, right, stamp in frames:
            states, out = jax.device_get(dp_fleet_step(
                mesh, states, left, right, stamp, cam, settings, lk,
                cfg_hash))
            ref.append(out)
        ranks = dict(queue.get(timeout=TIMEOUT_S) for _ in range(WORLD))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    for r, out in ranks.items():
        assert isinstance(out, list), f"rank {r}: {out}"
    return ranks, ref


@pytest.mark.parametrize("frame", range(3))
@pytest.mark.parametrize("rank", range(WORLD))
def test_port_dp_step_matches_jax_dp_step(tiny_runs, rank, frame):
    ranks, ref = tiny_runs
    got, want = ranks[rank][frame], ref[frame]
    for stream in range(WORLD):
        assert int(got["n_inliers"][stream]) == int(
            want.n_inliers[stream])
        assert bool(got["lost"][stream]) == bool(want.lost[stream])
        np.testing.assert_allclose(got["pose"][stream][:3, 3],
                                   np.asarray(want.pose[stream])[:3, 3],
                                   atol=POSE_BOUND)


def test_tiny_case_tracks_the_plane(tiny_runs):
    """The last frame is tracked: both streams keep inliers and are not
    lost, in both packages."""
    ranks, ref = tiny_runs
    last = ranks[0][-1]
    assert int(last["n_inliers"].min()) >= 6
    assert not last["lost"].any()
    assert not np.asarray(ref[-1].lost).any()
