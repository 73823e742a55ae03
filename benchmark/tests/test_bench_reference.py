"""The plain reference's pyramidal track and its reverse-flow check, on
images whose answer is known: a smooth texture shifted by a fractional
offset."""

import torch

from benchmark import reference

SHIFT = (3.3, -1.7)


def _texture(h=96, w=128, seed=0):
    gen = torch.Generator().manual_seed(seed)
    coarse = torch.rand(1, 1, h // 8, w // 8, generator=gen,
                        dtype=torch.float64)
    img = torch.nn.functional.interpolate(coarse, size=(h, w),
                                          mode="bicubic", align_corners=True)
    return img[0, 0] * 200 + 20


def _shifted(img, dx, dy):
    """img sampled at (x - dx, y - dy): the texture moved by (dx, dy)."""
    h, w = img.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    grid = torch.stack([(xs - dx) / (w - 1) * 2 - 1,
                        (ys - dy) / (h - 1) * 2 - 1], -1)
    return torch.nn.functional.grid_sample(
        img[None, None], grid[None], mode="bicubic", align_corners=True,
        padding_mode="border")[0, 0]


def _pair():
    a = _texture()
    return a[None], _shifted(a, *SHIFT)[None]


def test_pyramidal_track_finds_the_shift():
    a, b = _pair()
    pts = torch.tensor([[40.0, 40.0], [64.5, 50.25], [90.0, 60.0]],
                       dtype=torch.float64)
    idx = torch.zeros(3, dtype=torch.long)
    pyr = reference.PyrImages(a, b, win=21, levels=4)
    end, ok = reference.pyr_track(pyr, pts, pts, idx)
    assert ok.all()
    torch.testing.assert_close(end - pts, torch.tensor(SHIFT).double()
                               .expand(3, 2), rtol=0, atol=0.05)
    # the end is a fixed point of the full-resolution step
    step = reference.lk_step(pyr.levels[0], pts, end, idx)
    assert float(step.norm(dim=-1).max()) < 0.02


def test_reverse_distance_at_a_right_and_a_wrong_end():
    a, b = _pair()
    pts = torch.tensor([[50.0, 45.0], [70.0, 55.0]], dtype=torch.float64)
    idx = torch.zeros(2, dtype=torch.long)
    fwd = reference.PyrImages(a, b, win=21, levels=4)
    back = reference.PyrImages(b, a, win=21, levels=4)
    end, ok, dist = reference.bidirectional(fwd, back, pts, pts, idx, 0.5)
    assert ok.all() and float(dist.max()) < 0.1
    wrong = end + torch.tensor([[4.0, 0.0], [0.0, -4.0]], dtype=torch.float64)
    assert float(reference.reverse_distance(back, pts, wrong, idx).min()) \
        > 1.5


def test_window_beyond_the_plane_stops_at_its_edge():
    img = torch.arange(20 * 30, dtype=torch.float64).reshape(1, 20, 30)
    plane = reference.Plane(img, 0)
    idx = torch.zeros(2, dtype=torch.long)
    far = torch.tensor([[100.25, 5.25], [200.25, 5.25]], dtype=torch.float64)
    a, b = plane.patches(far, idx, 5)
    assert torch.equal(a, b)
    # the corner is clipped to the last one the window fits behind
    want = plane.patches(torch.tensor([[25.25, 5.25]], dtype=torch.float64),
                         idx[:1], 5)[0]
    torch.testing.assert_close(a[:, :], want, rtol=0, atol=1e-9)


def test_stereo_depth_in_bfloat16_loses_the_disparity():
    uv = torch.tensor([[301.3, 10.0]], dtype=torch.float64)
    ur = torch.tensor([296.9], dtype=torch.float64)
    z64 = reference.stereo_depth(uv, ur, 512.0, 0.12)
    z16 = reference.stereo_depth(uv, ur, 512.0, 0.12, dtype=torch.bfloat16)
    assert abs(float(z64) - 512 * 0.12 / 4.4) < 1e-9
    assert abs(float(z16) - float(z64)) / float(z64) > 0.05
