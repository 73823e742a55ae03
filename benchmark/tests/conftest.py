"""Small cells for the benchmark's CPU tests: the real configurations and
traffic at a size the CPU steps in seconds."""

import copy

import pytest
import torch

from benchmark import harness


def small_cell(name: str, width: int = 160, check_streams: int = 2):
    """Cell ``name`` of BENCHMARK.json at width x 3/4 width (MinDistance
    scaled as bench.py scales it), the comparison on ``check_streams``
    streams and spans of 4 frames."""
    cell = harness.Cell.load(harness.load_json(
        harness.ROOT.parent / "BENCHMARK.json"), name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["width"], cell.config["height"] = width, width * 3 // 4
    cell.config["parameters"]["Tracker/MinDistance"] = max(
        12, 40 * width // 640)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["check"]["streams"] = check_streams
    cell.traffic["check"]["span_frames"] = 4
    cell.traffic["profile_frames"] = 1
    return cell


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
