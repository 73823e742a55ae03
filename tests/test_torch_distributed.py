"""visfs_tpu_torch's sharded solvers on torch.distributed: two gloo ranks on
the CPU (spawned processes, a free localhost port, a timeout of their own)
against the one-process port and against the JAX package on its 8-device
virtual mesh.

  * the edge-sharded pose_graph.optimize on tests/test_distributed.py's
    build_pose_graph problem;
  * distributed_local_optimize and distributed_gn_step on
    tests/test_ba.py's contaminated synthetic_problem (8 gross outliers),
    its landmarks padded to 64 (a multiple of both meshes).

Tolerances: poses and the graph's q and t within 1e-5 of the one-process
port (the graph's q, t and chi2 bit-equal to it) and 1e-4 of the JAX
package; identical outlier sets and ok.  The
landmarks within 5e-4 m of both: back-substitution (dx_l = V^-1 (g_l -
W dx_p)) carries the pose step's last-ulp differences, which the shards'
summation order sets, into the points 3-8 m deep amplified ~100x (2.1e-4
m seen; the reference's own 8-way split is held at 1e-3 against its
one-device solver, tests/test_distributed.py).  Both ranks return the
same result.  initialize_multihost raises on bad explicit arguments and
returns False when nothing names a cluster."""

import multiprocessing
import os
import socket
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from visfs_tpu.parallel import distributed_ba as jdba
from visfs_tpu.parallel import pose_graph as jpg
from visfs_tpu.solver import ba as jba
from visfs_tpu_torch.parallel.mesh import initialize_multihost

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_worker as worker  # noqa: E402
from test_ba import synthetic_problem  # noqa: E402
from test_distributed import build_pose_graph, pad_to_64  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
TIMEOUT_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _arrays(nt):
    return {k: np.array(v) for k, v in nt._asdict().items()
            if k not in ("intr", "laser")}


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(42)
    graph, _, _ = build_pose_graph(rng)
    problem, _, _, _, _ = synthetic_problem(
        rng, noise_px=0.4, pose_noise=0.02, lm_noise=0.05, n_outliers=8)
    problem = pad_to_64(problem)
    ba_arrays = dict(_arrays(problem),
                     intr=[float(x) for x in problem.intr])
    return graph, problem, _arrays(graph), ba_arrays


@pytest.fixture(scope="module")
def runs(problems):
    """(two ranks' results, the one-process port's, the JAX package's on its
    8-device meshes), each a dict of numpy arrays."""
    graph, problem, g_arrays, p_arrays = problems
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=worker.worker,
                         args=(r, WORLD, port, g_arrays, p_arrays, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ranks = dict(queue.get(timeout=TIMEOUT_S) for _ in range(WORLD))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert all(not p.is_alive() for p in procs)
    for r, out in ranks.items():
        assert isinstance(out, dict), f"rank {r}: {out}"
    single = worker.solve(None, g_arrays, p_arrays)

    devs = np.array(jax.devices()[:8])
    q, t, chi2 = jpg.optimize(graph, JMesh(devs, ("edges",)),
                              **worker.GRAPH_SOLVE)
    settings = jba.BASettings(**worker.BA_SETTINGS)
    res = jdba.distributed_local_optimize(problem, settings,
                                          JMesh(devs, ("lm",)))
    gq, gt, glm = jdba.distributed_gn_step(problem, settings,
                                           JMesh(devs, ("lm",)), lam=0.0)
    ref = {k: np.asarray(v) for k, v in dict(
        graph_q=q, graph_t=t, graph_chi2=chi2, ba_q=res.pose_q,
        ba_t=res.pose_t, ba_lm=res.lm_pos, ba_outliers=res.outliers,
        ba_chi2=res.chi2, ba_ok=res.ok, gn_q=gq, gn_t=gt,
        gn_lm=glm).items()}
    return ranks, single, ref


FLOATS = ("graph_q", "graph_t", "ba_q", "ba_t", "gn_q", "gn_t")
LANDMARKS = ("ba_lm", "gn_lm")
LANDMARK_TOL = 5e-4


def test_ranks_agree(runs):
    ranks = runs[0]
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("key", FLOATS)
def test_sharded_matches_one_process(runs, key):
    ranks, single, _ = runs
    np.testing.assert_allclose(ranks[0][key], single[key], atol=1e-5)


@pytest.mark.parametrize("key", ("graph_q", "graph_t", "graph_chi2"))
def test_sharded_pose_graph_bit_equal_to_one_process(runs, key):
    """The ranks add the gathered per-edge terms in the one-process solve's
    order, so the sharded pose graph (closures give poses 3 edges) equals
    the one-process solve bit for bit."""
    ranks, single, _ = runs
    np.testing.assert_array_equal(ranks[0][key], single[key])


@pytest.mark.parametrize("key", FLOATS)
def test_sharded_matches_jax_mesh(runs, key):
    ranks, _, ref = runs
    np.testing.assert_allclose(ranks[0][key], ref[key], atol=1e-4)


@pytest.mark.parametrize("key", LANDMARKS)
def test_sharded_landmarks_match(runs, key):
    ranks, single, ref = runs
    np.testing.assert_allclose(ranks[0][key], single[key],
                               atol=LANDMARK_TOL)
    np.testing.assert_allclose(ranks[0][key], ref[key], atol=LANDMARK_TOL)


def test_outliers_ok_and_chi2(runs):
    ranks, single, ref = runs
    out = ranks[0]
    np.testing.assert_array_equal(out["ba_outliers"], single["ba_outliers"])
    np.testing.assert_array_equal(out["ba_outliers"], ref["ba_outliers"])
    assert out["ba_outliers"].sum() >= 8
    assert bool(out["ba_ok"]) == bool(single["ba_ok"]) == bool(ref["ba_ok"])
    assert bool(out["ba_ok"])
    np.testing.assert_allclose(out["ba_chi2"], ref["ba_chi2"], rtol=1e-3)
    np.testing.assert_allclose(out["graph_chi2"], single["graph_chi2"],
                               rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("kw", [
    dict(world_size=2, rank=1),
    dict(init_method="tcp://127.0.0.1:1", world_size=2, rank=2),
    dict(init_method="tcp://127.0.0.1:1", world_size=0, rank=0),
    dict(init_method="localhost:1", world_size=1, rank=0),
], ids=["no_address", "rank_out_of_world", "empty_world", "no_scheme"])
def test_initialize_multihost_raises_on_bad_explicit_args(kw):
    with pytest.raises(ValueError):
        initialize_multihost(**kw)


def test_initialize_multihost_without_cluster(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost() is False
