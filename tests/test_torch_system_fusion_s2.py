"""SensorStrategy 2, stereo and wheel odometry (the wheel delta as the
initial transform, odometry links in the BA, the tolerance override):
visfs_tpu_torch's System against visfs_tpu's over the reference's own 8
frames at 160x120 (tests/torch_fusion_slice.py).  Per frame: translation
1e-3 m, yaw 1e-3 rad, inliers within 1, identical lost flags."""

import pytest
import torch

from torch_fusion_slice import (N_FRAMES, check_ate, check_frame,
                                fusion_run)

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

STRATEGY = 2
__all__ = ["fusion_run"]


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_frame_matches_reference(fusion_run, frame):
    check_frame(fusion_run, frame)


def test_ate_matches_reference(fusion_run):
    check_ate(fusion_run)
