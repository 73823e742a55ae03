"""SensorStrategy 5, laser only (PnP's initial transform, the BA
scan-matching the newest pose with the visual observations dropped, no
wheel rows: with them it would compute what strategy 4 does):
visfs_tpu_torch's System against visfs_tpu's over the
reference's own 8 frames at 160x120 (tests/torch_fusion_slice.py).  Per
frame: translation 1e-3 m, yaw 1e-3 rad, inliers within 1, identical lost
flags.  The submaps: identical slot_valid, num_range_data and finished,
max_xy within 1e-4 m, at most 0.1 % of the known cells different."""

import pytest
import torch

from torch_fusion_slice import (N_FRAMES, check_ate, check_frame,
                                check_submaps, fusion_run)

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

STRATEGY = 5
__all__ = ["fusion_run"]


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_frame_matches_reference(fusion_run, frame):
    check_frame(fusion_run, frame)


def test_ate_matches_reference(fusion_run):
    check_ate(fusion_run)


def test_submaps_match_reference(fusion_run):
    check_submaps(fusion_run)
