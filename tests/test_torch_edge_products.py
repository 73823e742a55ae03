"""K4, the pose graph's per-edge products (visfs_tpu_torch.ops.kernels.
edge_products), on the CPU: its plain version (the solve's einsums), its
order oracle (the CUDA kernel's order as elementwise float32 ops) and its
dispatch.

Inputs: the solve's own per-edge terms (``_edge_terms``) of
tests/test_torch_pose_graph.py's graphs (tests/test_distributed.py's
32-pose circle with three closures, 40 edge slots; tests/test_mapping.py's
drifting square loop in a MappingBackend of 512 edge slots) and of
tools/torch_pose_graph_probe.py's graph (128 nodes, 512 edge slots, the
backend cell's capacity), with x for the matvec drawn by numpy from a seed.
Blocks are the contiguous shards of 2, 4 and 8 ranks (parallel.mesh.shard).

Tolerances: 0 (bit for bit) between the oracle and the plain version and
between a block's plain version and the whole's rows: both compute each
element with the same rounded products and adds in the same order.  The
JAX package's einsums (visfs_tpu/parallel/pose_graph.py:90-111) on the
same inputs within rtol 1e-5 and 1e-5 of the largest element: XLA's dot
may add in another order."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu_torch.ops.kernels import edge_products as k4
from visfs_tpu_torch.parallel import pose_graph as tpg
from visfs_tpu_torch.slam import mapping as tmap

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
from test_distributed import build_pose_graph  # noqa: E402
from test_mapping import square_loop_trajectory  # noqa: E402
from torch_pose_graph_probe import probe_graph  # noqa: E402

torch.set_num_threads(1)

GRAPHS = ("circle", "square", "probe")
SPLITS = (1, 2, 4, 8)


def _circle():
    g, _, _ = build_pose_graph(np.random.default_rng(42))
    return tpg.PoseGraph(*(torch.from_numpy(np.array(x)) for x in g))


def _square():
    gt, est = square_loop_trajectory(drift=0.015, seed=3)
    backend = tmap.MappingBackend(None, max_nodes=64, max_edges=512,
                                  device="cpu")
    for k in range(len(est)):
        backend.add_keyframe(est[k], float(k))
    n = len(est)
    for j in (n - 1, n // 2):
        backend.add_loop_closure(0, j, np.linalg.inv(gt[0]) @ gt[j],
                                 info=1e5)
    g = backend.graph
    return tpg.PoseGraph(g.pose_q, g.pose_t, ~g.valid, g.edge_i, g.edge_j,
                         g.edge_q, g.edge_t, g.edge_info, g.edge_valid)


@pytest.fixture(scope="module")
def terms():
    """graph name -> {entry: the entry's inputs (w, Ji, Jj, ...)}: the
    first Gauss-Newton step's terms of the graph."""
    out = {}
    for name, make in (("circle", _circle), ("square", _square),
                       ("probe", lambda: probe_graph("cpu"))):
        g, _ = tpg._shard_edges(make(), None)
        r, Ji, Jj, w, _ = tpg._edge_terms(g, g.pose_q, g.pose_t, 1.0)
        x = torch.from_numpy(np.random.default_rng(len(name)).normal(
            size=(g.pose_q.shape[0], 6)).astype(np.float32))
        out[name] = {"gradient": (w, Ji, Jj, r), "blocks": (w, Ji, Jj),
                     "matvec": (w, Ji, Jj, x, g.edge_i, g.edge_j)}
    return out


def _bits(x):
    return x.contiguous().view(torch.int32)


def _blocks(entry, args, parts):
    """(first row, inputs) of each of ``parts`` contiguous blocks of the
    edges (the matvec's x, the poses' values, whole)."""
    e = args[0].shape[0]
    assert e % parts == 0
    per = e // parts
    whole = {3} if entry == "matvec" else set()
    for lo in range(0, e, per):
        yield lo, tuple(a if k in whole else a[lo:lo + per]
                        for k, a in enumerate(args))


def test_the_graphs_have_what_the_products_see(terms):
    """Masked slots (weight 0), closures (weights of 1e5 beside 1e4 and
    100) and Huber-scaled weights are in the inputs."""
    for name in GRAPHS:
        w = terms[name]["gradient"][0]
        assert bool((w == 0).any()), name
        assert len(torch.unique(w[w > 0])) >= 2, name


@pytest.mark.parametrize("parts", SPLITS)
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("entry", k4.ENTRIES)
def test_oracle_bit_equal_to_plain_version(entry, graph, parts, terms):
    """On the whole edge set and on each block of 2, 4 and 8: the order
    oracle is the einsums' bits."""
    for _, args in _blocks(entry, terms[graph][entry], parts):
        plain = k4.edge_products_reference(entry, *args)
        oracle = k4.edge_products_oracle(entry, *args)
        assert plain.dtype == oracle.dtype == torch.float32
        assert torch.equal(_bits(oracle), _bits(plain))


@pytest.mark.parametrize("parts", SPLITS[1:])
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("entry", k4.ENTRIES)
def test_plain_version_over_a_block_is_the_wholes_rows(entry, graph, parts,
                                                       terms):
    """The einsums of a block of edges give the same bits as the same rows
    of the whole graph's: on the CPU the products do not depend on the
    batch."""
    args = terms[graph][entry]
    whole = k4.edge_products_reference(entry, *args)
    for lo, part in _blocks(entry, args, parts):
        got = k4.edge_products_reference(entry, *part)
        assert torch.equal(_bits(got), _bits(whole[lo:lo + got.shape[0]]))


@pytest.mark.parametrize("entry", k4.ENTRIES)
def test_plain_version_follows_the_reference_einsums(entry, terms):
    """The JAX package's einsums (pose_graph.py:90-91, 97-98, 107-111) on
    the probe graph's inputs, from side and to side."""
    args = [a.numpy() for a in terms["probe"][entry]]
    w, Ji, Jj = (jnp.asarray(a) for a in args[:3])
    if entry == "blocks":
        ref = [jnp.einsum("e,eki,ekj->eij", w, J, J) for J in (Ji, Jj)]
    else:
        if entry == "gradient":
            v = jnp.asarray(args[3])
        else:
            x, ei, ej = jnp.asarray(args[3]), args[4], args[5]
            v = jnp.einsum("eki,ei->ek", Ji, x[ei]) \
                + jnp.einsum("eki,ei->ek", Jj, x[ej])
        ref = [jnp.einsum("e,eki,ek->ei", w, J, v) for J in (Ji, Jj)]
    ref = np.stack([np.asarray(a) for a in ref], 1)
    got = k4.edge_products(entry, *terms["probe"][entry]).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("entry", k4.ENTRIES)
def test_cpu_tensors_take_the_plain_version(entry, terms):
    """The wrapper runs the einsums for CPU tensors and counts no launch."""
    args = terms["circle"][entry]
    before = k4.LAUNCHES
    got = k4.edge_products(entry, *args)
    assert k4.LAUNCHES == before
    assert torch.equal(_bits(got),
                       _bits(k4.edge_products_reference(entry, *args)))


def test_named_entries_are_the_dispatcher(terms):
    t = terms["probe"]
    for got, entry in ((k4.edge_gradient(*t["gradient"]), "gradient"),
                       (k4.edge_blocks(*t["blocks"]), "blocks"),
                       (k4.edge_matvec(*t["matvec"]), "matvec")):
        assert torch.equal(_bits(got),
                           _bits(k4.edge_products(entry, *t[entry])))


@pytest.mark.parametrize("entry", k4.ENTRIES)
def test_other_devices_raise(entry, terms):
    """A tensor on another device (meta) raises; there is no fallback."""
    args = tuple(a.to("meta") for a in terms["circle"][entry])
    with pytest.raises(ValueError, match="unsupported device"):
        k4.edge_products(entry, *args)


def test_the_cuda_entry_raises_without_a_card(terms):
    """edge_products_cuda without CUDA raises (this sandbox's case), and so
    does a CPU tensor handed to it on a machine with a card."""
    with pytest.raises((RuntimeError, ValueError)):
        k4.edge_products_cuda("blocks", *terms["circle"]["blocks"])


def test_bad_inputs_raise(terms):
    w, Ji, Jj, r = terms["circle"]["gradient"]
    with pytest.raises(ValueError, match="unknown entry"):
        k4.edge_products("hessian", w, Ji, Jj)
    with pytest.raises(TypeError):
        k4.edge_products("gradient", w, Ji, Jj)
    with pytest.raises(ValueError, match="shape"):
        k4.edge_products("gradient", w, Ji, Jj, r[:-1])
