"""A whole run of a cell on the CPU at a small size, the chip's check
skipped, with the timed path broken underneath (``benchmark/faults.py``):
``correct`` has to come out false for each fault, through the numbers
that are there to catch it (a one-card cell has no exchange between cards
to leave out)."""

import pytest

from benchmark import faults, harness

from .conftest import small_cell

SEED = 2 ** 31 + 101
SECONDS = 1.0
FRAMES = 6  # window frames: past the faults' first frames whatever the CPU
SPAN = 2

# The numbers each fault has to fail (it may fail others too).
CAUGHT_BY = {
    "state_unchanged": ["lost_frames"],
    "half_batch": ["track_step_p90_px"],
    "track_ends_shifted": ["track_step_p99_px", "stereo_step_p99_px"],
    "poses_moved_late": ["span_ate_m"],
    "poses_jump": ["span_ate_m"],
    "landmarks_moved": ["landmark_off_share"],
    "reverse_skipped": ["track_back_fail_share"],
    "good_dropped": ["good_dropped_share"],
}


def _cell():
    cell = small_cell("vo_bench.fleet256", width=320)
    cell.traffic["check"]["span_frames"] = SPAN
    return cell


def _run(cell):
    res = harness.run_cell(cell, SEED, SECONDS, False, "cpu", streams=2,
                           min_frames=FRAMES)
    return res["correct"], {k: (v, lim) for k, v, lim in res["compared"]}


@pytest.fixture(scope="module")
def sound():
    cell = _cell()
    return cell, _run(cell)


def test_every_fault_has_its_numbers():
    assert set(CAUGHT_BY) == set(faults.NAMES)


def test_sound_run_is_correct(sound):
    ok, got = sound[1]
    assert ok, got
    # the window reaches past the faults' first frames, and the pose and
    # landmark numbers have frames to judge
    assert got["pose_gap_p90_m"][0] > 0


@pytest.mark.parametrize("name", faults.NAMES)
def test_fault_is_not_correct(name, sound):
    cell = sound[0]
    with faults.planted(name, cell):
        ok, got = _run(cell)
    assert not ok
    for number in CAUGHT_BY[name]:
        value, limit = got[number]
        assert value > limit, (number, value, limit)
        assert sound[1][1][number][0] <= limit, (number, sound[1][1][number])
