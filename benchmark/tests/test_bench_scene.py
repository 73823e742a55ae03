"""The benchmark's frozen copy of the simulator (scene.py) against the
port's own (visfs_tpu_torch.io.sim), and the lap's closure."""

import numpy as np
import torch

from benchmark import scene

ROOM = (-3.0, 18.0, -8.0, 8.0)


def test_lap_closes_on_a_whole_frame():
    n, speed = scene.lap_frames(ROOM, 0.2)
    assert n == 197
    assert abs(speed - 2.0013) < 1e-3
    _, point = scene._square_path(ROOM)
    end = np.array(point(speed * n / 10.0))
    start = np.array(point(0.0))
    np.testing.assert_allclose(end[:2], start[:2], atol=1e-9)
    assert abs(end[2] - start[2] - 2 * np.pi) < 1e-9
    lap = scene.lap_geometry(n, speed, 64, 48)
    steps = np.linalg.norm(np.diff(np.concatenate(
        [lap.poses[:, :2, 3], lap.poses[:1, :2, 3]]), axis=0), axis=1)
    # every frame, the wrap from the last to the first included, moves
    # about 0.2 m (chords of the corners a little less)
    assert steps.max() < 0.2002 and steps.min() > 0.19


def test_views_bit_equal_to_the_port_simulator():
    from visfs_tpu_torch.io.sim import render_textured_views

    n, speed = scene.lap_frames(ROOM, 0.2)
    frames = [0, 57, 196]
    lap = scene.lap_geometry(n, speed, 80, 60)
    views = scene.render_views(
        lap.planes, lap.origins[frames].reshape(-1, 3),
        np.repeat(lap.rots[frames], 2, axis=0), lap.camera, "cpu")
    want, _, _ = render_textured_views(frames, n_frames=n, width=80,
                                       height=60, speed=speed, device="cpu")
    assert np.array_equal(views.double().numpy().reshape(want.shape), want)


def test_poses_equal_to_the_port_simulator():
    from visfs_tpu_torch.io.sim import generate_textured_sequence

    n, speed = scene.lap_frames(ROOM, 0.2)
    lap = scene.lap_geometry(n, speed, 32, 24)
    seq = generate_textured_sequence(n_frames=n, width=32, height=24,
                                     speed=speed, pixel_noise=0.0,
                                     exposure_drift=0.0, device="cpu")
    assert np.array_equal(lap.poses, seq.poses)


def test_exposure_bridge_ends_where_it_began():
    gen = torch.Generator().manual_seed(2 ** 31 + 7)
    walk = scene._bridge(gen, 197, 0.02, "cpu")
    assert walk[0] == 0
    steps = torch.diff(torch.cat([walk, walk[:1]]))
    assert abs(float(steps.sum())) < 1e-12


def test_lap_images_repeat_per_seed_and_differ_across_seeds():
    views = torch.rand(3, 2, 6, 8)
    a = scene.lap_images(views, 5, 2.0, 0.02)
    b = scene.lap_images(views, 5, 2.0, 0.02)
    c = scene.lap_images(views, 6, 2.0, 0.02)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0 and float(a.max()) <= 255


def test_span_ate():
    gt = np.tile(np.eye(4), (10, 1, 1))
    gt[:, 0, 3] = np.arange(10) * 0.2
    est = gt.copy()
    assert scene.span_ate(est, gt, 4) == 0.0
    est[5, 1, 3] += 0.3  # frame 5 lies in the span 4-7
    want = np.sqrt(0.3 ** 2 / 4)
    assert abs(scene.span_ate(est, gt, 4) - want) < 1e-12
    # fewer frames than a span: one span of all of them
    assert abs(scene.span_ate(est[:6], gt[:6], 40)
               - np.sqrt(0.3 ** 2 / 6)) < 1e-12
    assert scene.ate_rmse(est, gt) == np.sqrt(0.3 ** 2 / 10)


def test_span_ate_sees_a_jump_where_spans_end_to_end_would_meet():
    gt = np.tile(np.eye(4), (10, 1, 1))
    gt[:, 0, 3] = np.arange(10) * 0.2
    est = gt.copy()
    est[4:, 0, 3] += 1.0  # spans 0-3 and 4-7 laid end to end see nothing
    # the span 2-5 holds frames 4 and 5 one metre off
    assert abs(scene.span_ate(est, gt, 4) - np.sqrt(2 / 4)) < 1e-12


def test_span_ate_judges_the_last_frames():
    gt = np.tile(np.eye(4), (10, 1, 1))
    gt[:, 0, 3] = np.arange(10) * 0.2
    est = gt.copy()
    est[9, 1, 3] += 0.3  # past the last whole span from frame 0
    assert abs(scene.span_ate(est, gt, 4) - np.sqrt(0.3 ** 2 / 4)) < 1e-12


def test_ray_depth_meets_a_plane_and_projects_back():
    n, speed = scene.lap_frames(ROOM, 0.2)
    lap = scene.lap_geometry(n, speed, 80, 60)
    gen = torch.Generator().manual_seed(3)
    uv = torch.rand(64, 2, generator=gen, dtype=torch.float64) \
        * torch.tensor([80.0, 60.0], dtype=torch.float64)
    frames = torch.randint(0, n, (64,), generator=gen)
    for side in (0, 1):
        z = scene.ray_depth(lap, frames, side, uv)
        assert torch.all(torch.isfinite(z)) and torch.all(z > 0.25)
        world = scene.unproject(lap, frames, side, uv, z)
        back, zb = scene.project(lap, frames, side, world)
        # the rotations are float32 poses' (orthonormal to ~1e-7)
        torch.testing.assert_close(back, uv, rtol=0, atol=1e-5)
        torch.testing.assert_close(zb, z, rtol=1e-6, atol=0)
        # the point lies on one of the world's planes, inside its bounds
        on = torch.zeros(64, dtype=torch.bool)
        for p in lap.planes:
            rel = world - torch.as_tensor(p.p0)
            d = rel @ torch.as_tensor(p.n)
            u = rel @ torch.as_tensor(p.e1)
            v = rel @ torch.as_tensor(p.e2)
            on |= ((d.abs() < 1e-9) & (u >= p.u0 - 1e-9)
                   & (u <= p.u1 + 1e-9) & (v >= p.v0 - 1e-9)
                   & (v <= p.v1 + 1e-9))
        assert torch.all(on)
