"""K1's least work and the card's bound (roofline.py), by hand."""

from benchmark import roofline


def test_k1_least_flops_by_hand():
    # 100 features kept, 10 of them new: 100 stereo + 90 temporal tracks;
    # both ways, 4 levels, a 21 x 21 window, setup (27) and one step (12)
    # a sample: 190 x 2 x 4 x 441 x 39
    assert roofline.k1_least_flops(100, 10, 4, 21, True) == 26_142_480
    assert roofline.k1_least_flops(100, 10, 4, 21, False) == 13_071_240
    assert roofline.k1_least_flops(0, 0, 4, 21, True) == 0


def test_bound_is_the_larger_of_bytes_and_flops():
    assert roofline.bound_s(3.35e12, 0.0) == 1.0
    assert roofline.bound_s(0.0, 67e12) == 1.0
    assert roofline.bound_s(3.35e9, 67e12) == 1.0
