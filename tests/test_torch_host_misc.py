"""The port's small host-side pieces against the JAX package's: the logger
(visfs_tpu_torch.utils.logging, levels and the rotating file sink) and the
off-path remainders extrapolator.acc_motion_model (within 1e-6 on seeded
inputs), grid2d.cell_center (within 1e-6) and grid2d.is_known (exact).  And
every module of the port's host side imports without JAX, visfs_tpu, yaml,
zmq or rospy (the card's machine has none of them)."""

import logging
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.map2d import grid2d as jgrid
from visfs_tpu.map2d import probability_values as jpv
from visfs_tpu.slam import extrapolator as jextr
from visfs_tpu.utils import logging as jlog
from visfs_tpu_torch.map2d import grid2d as tgrid
from visfs_tpu_torch.slam import extrapolator as textr
from visfs_tpu_torch.utils import logging as tlog

torch.set_num_threads(1)


@pytest.mark.parametrize("level", [0, 1, 2, 3, 5, 9])
def test_logger_levels_and_file_sink_match_the_reference(tmp_path, level):
    loggers = {}
    for tag, mod in (("ref", jlog), ("port", tlog)):
        folder = tmp_path / tag
        lg = mod.make_logger(level=level, folder=str(folder),
                             name=f"visfs_test_{tag}_{level}")
        lg.debug("d")
        lg.info("i")
        lg.warning("w")
        lg.error("e")
        lg.critical("c")
        for h in lg.handlers:
            h.flush()
        lines = (folder / "visfs.log").read_text().splitlines()
        # strip the time stamp and the logger's name
        loggers[tag] = (lg.level, [ln.split("]", 1)[1].split("]", 2)[0::2]
                                   for ln in lines],
                        [type(h).__name__ for h in lg.handlers])
        handler = lg.handlers[0]
        assert handler.maxBytes == 50 * 1024 * 1024
        assert handler.backupCount == 10
    assert loggers["port"] == loggers["ref"]


def test_logger_falls_back_to_the_console(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")  # a file where the folder should be
    for mod in (jlog, tlog):
        lg = mod.make_logger(level=1, folder=str(blocker / "logs"),
                             name=f"visfs_test_console_{mod.__name__}")
        assert [type(h) for h in lg.handlers] == [logging.StreamHandler]
        assert lg.propagate is False


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_acc_motion_model_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    dt = np.float32(rng.uniform(0.0, 0.2))
    base, v1, v2 = (rng.normal(size=6).astype(np.float32) for _ in range(3))
    for direction in (True, False):
        ref = np.asarray(jextr.acc_motion_model(
            jnp.float32(dt), direction, jnp.asarray(base), jnp.asarray(v1),
            jnp.asarray(v2)))
        port = textr.acc_motion_model(
            torch.tensor(dt), direction, torch.from_numpy(base),
            torch.from_numpy(v1), torch.from_numpy(v2)).numpy()
        np.testing.assert_allclose(port, ref, atol=1e-6, rtol=0)


def _grids(seed):
    rng = np.random.default_rng(seed)
    n = 40
    cells = np.full((n, n), jpv.UNKNOWN_VALUE, np.uint16)
    known = rng.uniform(size=(n, n)) < 0.3
    cells[known] = rng.integers(1, 32768, known.sum()).astype(np.uint16)
    res, max_x, max_y = 0.05, float(rng.uniform(-2, 2)), \
        float(rng.uniform(-2, 2))
    jg = jgrid.Grid2D(limits=jgrid.make_limits(res, max_x, max_y, n, n),
                      cells=jnp.asarray(cells),
                      known_min=jnp.asarray([0, 0], jnp.int32),
                      known_max=jnp.asarray([n - 1, n - 1], jnp.int32))
    tg = tgrid.Grid2D(limits=tgrid.make_limits(res, max_x, max_y, n, n,
                                               device="cpu"),
                      cells=torch.from_numpy(cells.astype(np.int32)),
                      known_min=torch.tensor([0, 0], dtype=torch.int32),
                      known_max=torch.tensor([n - 1, n - 1],
                                             dtype=torch.int32))
    idx = rng.integers(-5, n + 5, (200, 2)).astype(np.int32)
    return jg, tg, idx


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_center_and_is_known_match_the_reference(seed):
    jg, tg, idx = _grids(seed)
    ref_c = np.asarray(jgrid.cell_center(jg.limits, jnp.asarray(idx)))
    port_c = tgrid.cell_center(tg.limits, torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(port_c, ref_c, atol=1e-6, rtol=0)
    ref_k = np.asarray(jgrid.is_known(jg, jnp.asarray(idx)))
    port_k = tgrid.is_known(tg, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(port_k, ref_k)
    assert ref_k.any() and not ref_k.all()


def test_host_side_modules_import_no_jax_yaml_zmq_or_rospy():
    code = ("import sys\n"
            "import visfs_tpu_torch.io.adapter\n"
            "import visfs_tpu_torch.io.checkpoint\n"
            "import visfs_tpu_torch.io.zmq_transport\n"
            "import visfs_tpu_torch.io.zmq_replay\n"
            "import visfs_tpu_torch.io.ros_transport\n"
            "import visfs_tpu_torch.runtime\n"
            "import visfs_tpu_torch.slam.monitor\n"
            "import visfs_tpu_torch.utils.logging\n"
            "import visfs_tpu_torch.operating_points as o\n"
            "o.operating_point('sim_mapping')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'visfs_tpu', 'yaml', 'zmq', 'rospy')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
