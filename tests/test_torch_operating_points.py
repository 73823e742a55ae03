"""The port's operating-point literals (visfs_tpu_torch.operating_points,
the visfs:, node: and frames: blocks) against the repo's configs/*.yaml,
key for key, and the modules this
slice added imported without JAX, visfs_tpu or yaml (the card's machine may
have none of them)."""

import os
import subprocess
import sys

import pytest

from visfs_tpu_torch import operating_points as ops
from visfs_tpu_torch.config import config_from_parameters

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


@pytest.mark.parametrize("name,literal", [
    ("sim_mapping.yaml", "SIM_MAPPING"),
    ("sim_localization.yaml", "SIM_LOCALIZATION")])
def test_literal_equals_the_config_file(name, literal):
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(CONFIGS, name)) as f:
        block = yaml.safe_load(f)["visfs"]
    lit = getattr(ops, literal)
    assert list(lit) == list(block)
    for k, v in block.items():
        assert type(lit[k]) is type(v) and lit[k] == v, k
    config_from_parameters(lit)  # every key known to the port's registry


@pytest.mark.parametrize("name,block,literal", [
    ("sim_mapping.yaml", "node", "SIM_MAPPING_NODE"),
    ("sim_mapping.yaml", "frames", "SIM_MAPPING_FRAMES"),
    ("sim_localization.yaml", "node", "SIM_LOCALIZATION_NODE"),
    ("sim_localization.yaml", "frames", "SIM_LOCALIZATION_FRAMES")])
def test_node_and_frames_literals_equal_the_config_file(name, block,
                                                        literal):
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(CONFIGS, name)) as f:
        doc = yaml.safe_load(f).get(block) or {}
    lit = getattr(ops, literal)
    assert list(lit) == list(doc)
    for k, v in doc.items():
        assert type(lit[k]) is type(v) and lit[k] == v, k


def test_operating_point_assembles_fresh_copies():
    op = ops.operating_point("sim_mapping")
    assert op.subscribe_wheel_odom and op.subscribe_laser_scan
    op.node["base_line"] = 0.0
    op.frames["camera_link"]["xyz"][2] = 0.0
    again = ops.operating_point("sim_mapping")
    assert again.node["base_line"] == 0.0502569
    assert again.frames["camera_link"]["xyz"] == [0.0, 0.0, 0.68]
    assert again.visfs == ops.SIM_MAPPING


def test_mapping_point_is_strategy_3_with_clahe():
    cfg = config_from_parameters(ops.SIM_MAPPING)
    assert cfg.system_sensor_strategy == 3 and cfg.system_clahe
    assert cfg.local_map_num_range_data_limit == 60
    assert cfg.estimator_max_laser_range == 30.0
    loc = config_from_parameters(ops.SIM_LOCALIZATION)
    assert not loc.tracker_flow_back and loc.tracker_max_features == 200


def test_new_modules_import_no_jax_and_no_yaml():
    code = ("import sys\n"
            "import visfs_tpu_torch.operating_points\n"
            "import visfs_tpu_torch.ops.fundamental\n"
            "import visfs_tpu_torch.ops.image\n"
            "import visfs_tpu_torch.io.sim, visfs_tpu_torch.io.interface\n"
            "import visfs_tpu_torch.io.dataset\n"
            "import visfs_tpu_torch.utils.timer\n"
            "import visfs_tpu_torch.slam.system\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'visfs_tpu', 'yaml')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
