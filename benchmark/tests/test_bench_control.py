"""The control: the plain reference computed in bfloat16, put in the
program's place, has to come out not correct (on the CPU at a size a test
run holds; on the card at the cells' own size, by ``benchmark.control``)."""

from benchmark import control

from .conftest import small_cell

SEED = 2 ** 31 + 303


def test_control_fails_the_track_numbers_the_program_passes():
    cell = small_cell("vo_bench.fleet256", width=320)
    got = control.readings(cell, SEED, 1.0, "cpu", streams=2, min_frames=4)
    assert got["frames"] >= 4
    assert not got["control"]["correct"]
    for name in ("track_step_p90_px", "stereo_step_p90_px"):
        limit = cell.limits[name]
        assert got["program"]["numbers"][name] <= limit, got["program"]
        assert got["control"]["numbers"][name] > limit, got["control"]
