"""Peaks of the card and the least work of K1, from the cell's shapes.

The peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity), as ``chip_smoke.py`` uses them: 3.35 TB/s of HBM bandwidth and
67 TFLOP/s in float32 outside the tensor cores.  They assume the card's full
700 W; the run prints the card's power limit beside the share.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# chip_smoke.py: a bilinear sample is 4 multiplies + 3 adds; K1's setup
# samples 3 planes (from, gx, gy) and adds 3 products to G per sample, a
# step samples `to` and adds the difference's 2 products.
K1_SETUP_FLOPS_PER_SAMPLE = 27
K1_STEP_FLOPS_PER_SAMPLE = 12


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time for the work: the larger of its bytes over the
    bandwidth and its operations over the float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def k1_least_flops(n_features: int, n_new: int, levels: int, win: int,
                   bidirectional: bool) -> int:
    """A lower bound on one stream-frame's K1 operations.

    Every feature the frame keeps at its newest observation passed the
    stereo track; every one of those that is not new this frame passed the
    temporal track too.  A track that ends with status true ran, at each of
    the ``levels`` levels and in each direction it runs (two with the
    reverse-flow check), the setup of its window and at least one step.
    Tracks that failed, and the steps beyond the first, are not counted,
    so any implementation of K1 does at least this much."""
    tracks = 2 * n_features - n_new
    directions = 2 if bidirectional else 1
    per_level = win * win * (K1_SETUP_FLOPS_PER_SAMPLE
                             + K1_STEP_FLOPS_PER_SAMPLE)
    return tracks * directions * levels * per_level
