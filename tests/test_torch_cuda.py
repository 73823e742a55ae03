"""Card-only tests of visfs_tpu_torch: the CUDA kernel against its plain
PyTorch version (also with the fleet's stream axis), and the step on "cuda"
against the step on "cpu".

This file imports no JAX (the card's machine has none).  Each test skips
without a GPU.  On the card, run it without the JAX conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda

Tolerances: K1 flow (or, through its pyramid entry, points) 0.05 px, ok
(status) identical, min_eig (err) rtol 1e-3 (the repo's LK tolerances,
tests/test_lk_pallas.py); K2 flow 2e-3 px (the xcorr
same-formulation tolerance, tests/test_lk_pallas.py:104-106), inactive
features bit-equal; K2's pyramid entry points 0.01 px (the pyramidal
tolerance of tests/test_torch_xcorr.py), status identical, err rtol 1e-3;
the step per frame translation 1e-3 m, yaw 1e-3 rad, inliers within 1,
identical lost flags; at SensorStrategy 3 also the submaps' slots, counts
and finished flags identical, max_xy within 1e-4 m and at most 0.1 % of
the known cells different; K3 and K4 (the pose graph's per-pose sum and
per-edge products) bit-equal to their plain version and order oracle on
the CPU (tolerance 0: each adds in one fixed order by design)."""

import dataclasses

import numpy as np
import pytest
import torch

from visfs_tpu_torch.io.sim import generate_textured_sequence
from visfs_tpu_torch.ops.kernels import lk_level as k1
from visfs_tpu_torch.ops.kernels import lk_xcorr as k2
from visfs_tpu_torch.ops.lk import LKParams, build_lk_pyramid
from visfs_tpu_torch.slam.system import System

pytestmark = pytest.mark.cuda


def _require_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.fixture(scope="module")
def seq():
    _require_gpu()
    return generate_textured_sequence(n_frames=6, width=160, height=120,
                                      seed=0, speed=2.0, device="cuda")


@pytest.mark.parametrize("level", [0, 2])
def test_k1_cuda_kernel_matches_plain_version(seq, level):
    _require_gpu()
    p = LKParams()
    pyr0 = build_lk_pyramid(torch.from_numpy(seq.left[0]).cuda(), p)
    pyr1 = build_lk_pyramid(torch.from_numpy(seq.left[1]).cuda(), p)
    rng = np.random.default_rng(level)
    n = 64
    pts = torch.from_numpy(rng.uniform(10, [150, 110], (n, 2)).astype(
        np.float32)).cuda() / 2.0 ** level + pyr0.pad
    flow = torch.from_numpy(rng.normal(0, 1, (n, 2)).astype(
        np.float32)).cuda()
    active = torch.from_numpy((rng.uniform(size=n) > 0.2).astype(
        np.float32)).cuda()
    args = (pyr0.levels[level], pyr1.levels[level], pyr0.gx[level],
            pyr0.gy[level], pts.contiguous(), flow, active)
    kw = dict(win=p.win_size, iterations=p.iterations, eps=p.eps,
              min_eig_threshold=p.min_eig_threshold)
    before = k1.LAUNCHES
    fk, okk, ek = k1.lk_level(*args, **kw)
    fp, okp, ep = k1.lk_level_reference(*args, **kw)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    np.testing.assert_allclose(fk.cpu().numpy(), fp.cpu().numpy(), atol=0.05)
    np.testing.assert_array_equal(okk.cpu().numpy(), okp.cpu().numpy())
    np.testing.assert_allclose(ek.cpu().numpy(), ep.cpu().numpy(), rtol=1e-3,
                               atol=1e-6)
    inactive = active.cpu().numpy() == 0
    np.testing.assert_array_equal(fk.cpu().numpy()[inactive],
                                  flow.cpu().numpy()[inactive])


@pytest.fixture(scope="module")
def bench_pair():
    """Pyramids of frames 0 and 1 of the 640x480 bench loop and 240 GFTT
    corners of frame 0 (chip_smoke.py's k1 inputs)."""
    _require_gpu()
    from visfs_tpu_torch.ops.gftt import gftt_detect

    pair = generate_textured_sequence(n_frames=2, width=640, height=480,
                                      seed=0, speed=2.0, device="cuda")
    p = LKParams()
    img0, img1 = (torch.from_numpy(f).cuda() for f in pair.left[:2])
    det = gftt_detect(img0, 240, 0.01, 10)
    assert int(det.valid.sum()) == 240
    return build_lk_pyramid(img0, p), build_lk_pyramid(img1, p), det.points


def _k1_pyramid_case(bench_pair, n, bidirectional):
    pyr0, pyr1, points = bench_pair
    p = LKParams()
    pts = points[:n].contiguous()
    rng = np.random.default_rng(n)
    init = pts + torch.from_numpy(rng.normal(0, 1.0, (n, 2)).astype(
        np.float32)).cuda()
    valid = torch.from_numpy(rng.uniform(size=n) > 0.1).cuda()
    kw = dict(win=p.win_size, max_level=p.max_level,
              iterations=p.iterations, eps=p.eps,
              min_eig_threshold=p.min_eig_threshold,
              bidirectional=bidirectional, fb_threshold=1.5)
    before = (k1.PYR_LAUNCHES, k1.LAUNCHES)
    pk, sk, ek = k1.lk_pyramid(pyr0, pyr1, pts, init, valid, **kw)
    pp, sp, ep = k1.lk_pyramid_reference(pyr0, pyr1, pts, init, valid, **kw)
    torch.cuda.synchronize()
    assert (k1.PYR_LAUNCHES, k1.LAUNCHES) == (before[0] + 1, before[1])
    np.testing.assert_allclose(pk.cpu().numpy(), pp.cpu().numpy(), atol=0.05)
    np.testing.assert_array_equal(sk.cpu().numpy(), sp.cpu().numpy())
    assert int(sp.sum()) >= n // 2
    np.testing.assert_allclose(ek.cpu().numpy(), ep.cpu().numpy(), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("n", [120, 240])
def test_k1_pyramid_kernel_matches_plain_version(bench_pair, n):
    _require_gpu()
    _k1_pyramid_case(bench_pair, n, True)


@pytest.mark.parametrize("n", [120, 240])
def test_k1_pyramid_one_way_matches_plain_version(bench_pair, n):
    # FlowBack off (configs/sim_localization.yaml): no reverse track
    _require_gpu()
    _k1_pyramid_case(bench_pair, n, False)


def _k2_pyramid_case(bench_pair, n, bidirectional):
    pyr0, pyr1, points = bench_pair
    p = LKParams(iter_mode="xcorr")
    pts = points[:n].contiguous()
    rng = np.random.default_rng(n + 1)
    init = pts + torch.from_numpy(rng.normal(0, 1.0, (n, 2)).astype(
        np.float32)).cuda()
    valid = torch.from_numpy(rng.uniform(size=n) > 0.1).cuda()
    kw = dict(win=p.win_size, max_level=p.max_level,
              iterations=p.iterations, eps=p.eps,
              min_eig_threshold=p.min_eig_threshold,
              bidirectional=bidirectional, fb_threshold=1.5)
    before = (k2.PYR_LAUNCHES, k2.LAUNCHES)
    pk, sk, ek = k2.lk_xcorr_pyramid(pyr0, pyr1, pts, init, valid, **kw)
    pp, sp, ep = k2.lk_xcorr_pyramid_reference(pyr0, pyr1, pts, init, valid,
                                               **kw)
    torch.cuda.synchronize()
    assert (k2.PYR_LAUNCHES, k2.LAUNCHES) == (before[0] + 1, before[1])
    np.testing.assert_allclose(pk.cpu().numpy(), pp.cpu().numpy(), atol=0.01)
    np.testing.assert_array_equal(sk.cpu().numpy(), sp.cpu().numpy())
    assert int(sp.sum()) >= n // 2
    np.testing.assert_allclose(ek.cpu().numpy(), ep.cpu().numpy(), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("n", [120, 240])
def test_k2_pyramid_kernel_matches_plain_version(bench_pair, n):
    _require_gpu()
    _k2_pyramid_case(bench_pair, n, True)


@pytest.mark.parametrize("n", [120, 240])
def test_k2_pyramid_one_way_matches_plain_version(bench_pair, n):
    _require_gpu()
    _k2_pyramid_case(bench_pair, n, False)


@pytest.mark.parametrize("entry", ["lk_pyramid", "lk_xcorr_pyramid"])
def test_batched_pyramid_launch_matches_singles_and_plain(bench_pair, entry):
    """The stream axis: 3 streams (the bench pair, the pair swapped, the
    pair with the second image shifted) of 120 features in one launch
    under torch.func.vmap, bit-equal to one launch a stream, and against
    the plain version with the single-launch tolerances."""
    _require_gpu()
    from visfs_tpu_torch.ops.kernels.pyramid import Pyramid

    mod = k1 if entry == "lk_pyramid" else k2
    tol = 0.05 if entry == "lk_pyramid" else 0.01
    pyr0, pyr1, points = bench_pair
    p = LKParams()
    shifted = build_lk_pyramid(torch.roll(pyr1.levels[0][
        pyr1.pad:-pyr1.pad, pyr1.pad:-pyr1.pad], (2, 3), (0, 1))
        .contiguous(), p)
    pairs = [(pyr0, pyr1), (pyr1, pyr0), (pyr0, shifted)]
    n = 120
    pts = points[:n].contiguous()
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    kw = dict(win=p.win_size, max_level=p.max_level,
              iterations=p.iterations, eps=p.eps,
              min_eig_threshold=p.min_eig_threshold, bidirectional=True,
              fb_threshold=1.5)

    def planes(pyrs):
        return tuple(tuple(torch.stack(t) for t in zip(*f)) for f in zip(
            *[(q.levels, q.gx, q.gy) for q in pyrs]))

    size = (pyr0.height, pyr0.width, pyr0.pad)

    def one(pf, pt, x, v):
        return getattr(mod, entry)(Pyramid(*pf, *size), Pyramid(*pt, *size),
                                   x, x, v, **kw)

    before = mod.PYR_LAUNCHES
    got = torch.func.vmap(one)(planes([a for a, _ in pairs]),
                               planes([b for _, b in pairs]),
                               pts.expand(3, n, 2).contiguous(),
                               valid.expand(3, n).contiguous())
    torch.cuda.synchronize()
    assert mod.PYR_LAUNCHES == before + 1
    cuda_fn = getattr(mod, f"{entry}_cuda")
    plain_fn = getattr(mod, f"{entry}_reference")
    for i, (a, b) in enumerate(pairs):
        single = cuda_fn(a, b, pts, pts, valid, **kw)
        plain = plain_fn(a, b, pts, pts, valid, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, single):
            assert torch.equal(g[i], w)
        np.testing.assert_allclose(got[0][i].cpu().numpy(),
                                   plain[0].cpu().numpy(), atol=tol)
        np.testing.assert_array_equal(got[1][i].cpu().numpy(),
                                      plain[1].cpu().numpy())
        np.testing.assert_allclose(got[2][i].cpu().numpy(),
                                   plain[2].cpu().numpy(), rtol=1e-3,
                                   atol=1e-6)


def test_k2_cuda_kernel_matches_plain_version():
    _require_gpu()
    rng = np.random.default_rng(7)
    n, a = 64, 22

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).cuda()

    # maps of a locally linear LK problem, b = G (target - off) + noise: most
    # features converge in a few steps, those whose target lies beyond the
    # clamped offsets run to the cap
    g11, g22 = rng.uniform(1e3, 3e3, n), rng.uniform(1e3, 3e3, n)
    g12 = rng.uniform(-300, 300, n)
    det = g11 * g22 - g12 * g12
    ex = rng.uniform(-2, 23, (n, 1, 1)) - np.arange(a)[None, None, :]
    ey = rng.uniform(-2, 23, (n, 1, 1)) - np.arange(a)[None, :, None]
    cc1, cc2 = rng.normal(0, 500, n), rng.normal(0, 500, n)
    C1 = cc1[:, None, None] - (g11[:, None, None] * ex
                               + g12[:, None, None] * ey)
    C2 = cc2[:, None, None] - (g12[:, None, None] * ex
                               + g22[:, None, None] * ey)
    base = rng.uniform(8, 12, (n, 2))
    args = (f32(C1 + rng.normal(0, 20, C1.shape)),
            f32(C2 + rng.normal(0, 20, C2.shape)), f32(cc1), f32(cc2),
            f32(g22 / det), f32(-g12 / det), f32(g11 / det), f32(base[:, 0]),
            f32(base[:, 1]), f32(rng.normal(0, 1, (n, 2))),
            torch.from_numpy(rng.uniform(size=n) > 0.2).cuda())
    kw = dict(iterations=30, eps=0.01, max_off=float(a - 2))
    before = k2.LAUNCHES
    fk = k2.lk_xcorr_iterate(*args, **kw)
    fp, steps = k2.xcorr_steps(*args, **kw)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    steps = steps.cpu().numpy()
    assert (steps < 30).sum() > n // 2 and (steps == 30).any()
    np.testing.assert_allclose(fk.cpu().numpy(), fp.cpu().numpy(), atol=2e-3)
    inactive = ~args[10].cpu().numpy()
    np.testing.assert_array_equal(fk.cpu().numpy()[inactive],
                                  args[9].cpu().numpy()[inactive])


@pytest.mark.parametrize("lk", [{}, dict(backend="jnp", iter_mode="xcorr")],
                         ids=["k1", "xcorr"])
def test_step_on_cuda_matches_cpu(seq, lk):
    _require_gpu()
    params = {"Tracker/MaxFeatures": 40, "Tracker/MinDistance": 12,
              "Tracker/QualityLevel": 0.05, "Optimizer/Iterations": 20,
              "Estimator/Force3DoF": True}
    cam = seq.camera
    outs = {}
    for dev in ("cuda", "cpu"):
        s = System(params, device=dev)
        s.lk_params = dataclasses.replace(s.lk_params, **lk)
        s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(cam.baseline), width=cam.width, height=cam.height)
        outs[dev] = s.run_sequence(seq.stamps, seq.left, seq.right)
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(a.pose[:3, 3], b.pose[:3, 3], atol=1e-3)
        yaw = [np.arctan2(o.pose[1, 0], o.pose[0, 0]) for o in (a, b)]
        assert abs(yaw[0] - yaw[1]) <= 1e-3
        assert abs(int(a.n_inliers) - int(b.n_inliers)) <= 1
        assert bool(a.lost) == bool(b.lost)


def test_strategy3_step_on_cuda_matches_cpu():
    """SensorStrategy 3 (stereo, wheel rows, scans, submap building) on
    "cuda" against "cpu" over 6 frames at 160x120: the per-frame pose
    tolerances above, and the submaps' slots, counts and finished flags
    identical, max_xy within 1e-4 m, at most 0.1 % of the known cells
    different."""
    _require_gpu()
    laser_seq = generate_textured_sequence(
        n_frames=6, width=160, height=120, seed=0, speed=2.0,
        with_laser=True, n_beams=180, device="cuda")
    params = {"Tracker/MaxFeatures": 40, "Tracker/MinDistance": 12,
              "Tracker/QualityLevel": 0.05, "Optimizer/Iterations": 20,
              "Estimator/Force3DoF": True, "System/SensorStrategy": 3,
              "LocalMap/NumRangeDataLimit": 2}
    cam = laser_seq.camera
    outs, subs = {}, {}
    for dev in ("cuda", "cpu"):
        s = System(params, device=dev, scan_capacity=256)
        s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(cam.baseline), width=cam.width, height=cam.height)
        outs[dev] = s.run_sequence(laser_seq.stamps, laser_seq.left,
                                   laser_seq.right,
                                   wheel_odom=laser_seq.wheel_odom,
                                   scans=laser_seq.laser_scans)
        subs[dev] = s.state.laser.submaps
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(a.pose[:3, 3], b.pose[:3, 3], atol=1e-3)
        yaw = [np.arctan2(o.pose[1, 0], o.pose[0, 0]) for o in (a, b)]
        assert abs(yaw[0] - yaw[1]) <= 1e-3
        assert abs(int(a.n_inliers) - int(b.n_inliers)) <= 1
        assert bool(a.lost) == bool(b.lost)
    a, b = subs["cuda"], subs["cpu"]
    for f in ("slot_valid", "num_range_data", "finished"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f))
    assert float((a.max_xy.cpu() - b.max_xy).abs().max()) <= 1e-4
    known = int(((a.cells.cpu() != 0) | (b.cells != 0)).sum())
    assert known > 0
    assert int((a.cells.cpu() != b.cells).sum()) <= 1e-3 * known


class _NoHostSync:
    """A block that raises on any host sync on the card."""

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        return False


def test_kabsch_on_cuda_has_no_host_sync():
    """48 minimal 3-point Kabsch solves and a 24-point one on "cuda" with
    no host sync, within 1e-5 of "cpu"."""
    _require_gpu()
    from visfs_tpu_torch.ops.rigid import kabsch

    rng = np.random.default_rng(0)
    p_b = rng.uniform(-2, 2, (24, 3)).astype(np.float32)
    a = rng.normal(size=3)
    c, s = np.cos(a[0]), np.sin(a[0])
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    p_a = (p_b @ R.T + a).astype(np.float32)
    w = np.zeros((49, 24), np.float32)
    for k in range(48):
        w[k, rng.choice(24, 3, replace=False)] = 1.0
    w[48] = 1.0
    args = [torch.from_numpy(x) for x in (p_a, p_b, w)]
    on_card = [x.cuda() for x in args]  # a copy from pageable memory syncs
    with _NoHostSync():
        R_c, t_c = kabsch(*on_card)
    R_p, t_p = kabsch(*args)
    np.testing.assert_allclose(R_c.cpu().numpy(), R_p.numpy(), atol=1e-5)
    np.testing.assert_allclose(t_c.cpu().numpy(), t_p.numpy(), atol=1e-5)
    np.testing.assert_allclose(R_c[48].cpu().numpy(), R, atol=1e-4)


def _circle_graph(n=32, seed=0):
    """tests/test_distributed.py's build_pose_graph in the port's own
    terms: a circle of camera poses with odometry edges, three loop
    closures, every pose but the anchor perturbed."""
    from visfs_tpu_torch.core import lie
    from visfs_tpu_torch.parallel.pose_graph import PoseGraph

    ang = torch.tensor(2 * np.pi * np.arange(n) / n, dtype=torch.float32)
    zero = torch.zeros_like(ang)
    q = lie.quat_positify(torch.stack([torch.cos(ang / 2), zero, zero,
                                       torch.sin(ang / 2)], -1))
    t = torch.stack([3 * torch.cos(ang), 3 * torch.sin(ang), zero], -1)
    pairs = [(i, i + 1) for i in range(n - 1)] + [
        (0, n - 1), (0, n // 2), (n // 4, 3 * n // 4)]
    ei = torch.tensor([p[0] for p in pairs])
    ej = torch.tensor([p[1] for p in pairs])
    mq, mt = lie.se3_mul((q[ei], t[ei]), lie.se3_inv((q[ej], t[ej])))
    noise = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, 6)).astype(np.float32) * 0.05)
    noise[0] = 0
    pq, pt = lie.pose_update(q, t, noise)
    return PoseGraph(pose_q=pq, pose_t=pt,
                     pose_fixed=torch.arange(n) == 0,
                     edge_i=ei.int(), edge_j=ej.int(), edge_q=mq, edge_t=mt,
                     edge_info=torch.full((len(pairs),), 100.0),
                     edge_mask=torch.ones(len(pairs), dtype=torch.bool))


def test_pose_graph_optimize_on_cuda_has_no_host_sync():
    """pose_graph.optimize (10 Gauss-Newton steps of 60 CG iterations) on
    "cuda" with no host sync, within 1e-4 of "cpu"."""
    _require_gpu()
    from visfs_tpu_torch.parallel import pose_graph

    g = _circle_graph()
    on_card = pose_graph.PoseGraph(*(x.cuda() for x in g))
    with _NoHostSync():
        q_c, t_c, chi2_c = pose_graph.optimize(on_card, iterations=10,
                                               cg_iters=60)
    q_p, t_p, chi2_p = pose_graph.optimize(g, iterations=10, cg_iters=60)
    np.testing.assert_allclose(q_c.cpu().numpy(), q_p.numpy(), atol=1e-4)
    np.testing.assert_allclose(t_c.cpu().numpy(), t_p.numpy(), atol=1e-4)
    assert torch.equal(t_c[0].cpu(), g.pose_t[0])
    assert float(chi2_c) < 1e-3


def _graph_with_closures(device):
    """A drifting square loop of 40 keyframes in a MappingBackend of 64
    nodes and 512 edge slots (most of them masked), with two loop closures
    (end to start, middle to start): pose 0 has 3 edges, poses have edges
    on both sides."""
    from visfs_tpu_torch.slam.mapping import MappingBackend

    rng = np.random.default_rng(3)
    n, side = 40, 10
    gt, est = [], []
    drift = np.eye(4)
    for k in range(n):
        leg, s = divmod(k, side)
        yaw = 0.5 * np.pi * leg
        x, y = [(s, 0), (side, s), (side - s, side), (0, side - s)][leg]
        T = np.eye(4)
        T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        T[:2, 3] = (0.5 * x, 0.5 * y)
        gt.append(T)
        if k:
            step = np.linalg.inv(gt[k - 1]) @ T
            step[:2, 3] += rng.normal(0, 0.015, 2)
            drift = drift @ step
        est.append(drift.copy())
    backend = MappingBackend(None, max_nodes=64, max_edges=512,
                             device=device)
    for k in range(n):
        backend.add_keyframe(est[k].astype(np.float32), float(k))
    for j in (n - 1, n // 2):
        backend.add_loop_closure(0, j, (np.linalg.inv(gt[0]) @ gt[j]).astype(
            np.float32), info=1e5)
    return backend.graph


@pytest.mark.parametrize("shape", [(6,), (6, 6)])
def test_segment_sum_kernel_bit_equal_to_plain_version(shape):
    """K3 (the pose graph's fixed-order per-pose sum) on a graph with
    closures and masked edges: bit-equal to its plain version on the CPU
    (index_add_ in order), one launch counted; tolerance 0."""
    _require_gpu()
    from visfs_tpu_torch.ops.kernels import segment_sum as k3

    g = _graph_with_closures("cuda")
    n = g.pose_q.shape[0]
    seg = k3.segments(g.edge_i, g.edge_j, g.edge_valid, n)
    rng = np.random.default_rng(len(shape))
    w = g.edge_valid.float().cpu().reshape((-1, 1) + (1,) * len(shape))
    terms = torch.from_numpy(rng.normal(
        size=(g.edge_i.shape[0], 2) + shape).astype(np.float32)) * w
    before = k3.LAUNCHES
    out = k3.segment_sum(terms.cuda(), seg, n)
    assert k3.LAUNCHES == before + 1
    host = k3.segment_sum_reference(
        terms, k3.Segments(*(x.cpu() for x in seg)), n)
    assert torch.equal(out.cpu().view(torch.int32), host.view(torch.int32))


@pytest.mark.parametrize("entry", ["gradient", "blocks", "matvec"])
def test_edge_products_kernel_bit_equal_to_order_oracle(entry):
    """K4 (the pose graph's per-edge products) on the first Gauss-Newton
    step's terms of a graph with closures and 512 edge slots, most masked:
    bit-equal to the order oracle on the same inputs copied to the CPU, one
    launch counted; each 128-row block (a 4-rank shard) launched alone
    bit-equal to the same rows of the whole launch; tolerance 0."""
    _require_gpu()
    from visfs_tpu_torch.ops.kernels import edge_products as k4
    from visfs_tpu_torch.parallel import pose_graph

    kg = _graph_with_closures("cuda")
    g, _ = pose_graph._shard_edges(pose_graph.PoseGraph(
        kg.pose_q, kg.pose_t, ~kg.valid, kg.edge_i, kg.edge_j, kg.edge_q,
        kg.edge_t, kg.edge_info, kg.edge_valid), None)
    r, Ji, Jj, w, _ = pose_graph._edge_terms(g, g.pose_q, g.pose_t, 1.0)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(g.pose_q.shape[0], 6)).astype(np.float32)).cuda()
    args = {"gradient": (w, Ji, Jj, r), "blocks": (w, Ji, Jj),
            "matvec": (w, Ji, Jj, x, g.edge_i, g.edge_j)}[entry]
    before = k4.LAUNCHES
    out = k4.edge_products(entry, *args)
    assert k4.LAUNCHES == before + 1
    host = k4.edge_products_oracle(entry, *(a.cpu() for a in args))
    assert torch.equal(out.cpu().view(torch.int32), host.view(torch.int32))
    e = w.shape[0]
    for lo in range(0, e, 128):
        part = tuple(a if k == 3 and entry == "matvec" else a[lo:lo + 128]
                     for k, a in enumerate(args))
        got = k4.edge_products(entry, *part)
        assert torch.equal(got.view(torch.int32),
                           out[lo:lo + 128].view(torch.int32))


def test_edge_products_matvec_index_outside_the_poses_gives_nan():
    """K4's matvec with an edge index outside [0, N) (which PyTorch's
    gather would refuse): that edge's terms NaN, the others as the order
    oracle's, with no host sync."""
    _require_gpu()
    from visfs_tpu_torch.ops.kernels import edge_products as k4

    rng = np.random.default_rng(9)
    e, n = 8, 5

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    w, Ji, Jj, x = f32(e).abs(), f32(e, 6, 6), f32(e, 6, 6), f32(n, 6)
    ei = torch.from_numpy(rng.integers(0, n, e))
    ej = torch.from_numpy(rng.integers(0, n, e))
    bad_i, bad_j = ei.clone(), ej.clone()
    bad_i[2], bad_j[5] = n, -1
    on_card = [t.cuda() for t in (w, Ji, Jj, x, bad_i, bad_j)]
    with _NoHostSync():
        out = k4.edge_matvec(*on_card)
    out = out.cpu()
    assert bool(torch.isnan(out[[2, 5]]).all())
    keep = [k for k in range(e) if k not in (2, 5)]
    want = k4.edge_products_oracle("matvec", w, Ji, Jj, x, ei, ej)
    assert torch.equal(out[keep].view(torch.int32),
                       want[keep].view(torch.int32))


def test_optimize_graph_default_mode_solves_are_bit_equal():
    """Two optimize_graph solves of one graph with closures on "cuda", with
    PyTorch's deterministic algorithms off before and after: bit-equal,
    with no host sync, each per-edge product through K4 and each per-pose
    sum through K3 (iterations x (cg_iters + 3) launches each); within 1e-4
    of the solve on "cpu"."""
    _require_gpu()
    from visfs_tpu_torch.slam.mapping import KeyframeGraph, optimize_graph

    assert not torch.are_deterministic_algorithms_enabled()
    from visfs_tpu_torch.ops.kernels import edge_products as k4
    from visfs_tpu_torch.ops.kernels import segment_sum as k3

    g = _graph_with_closures("cuda")
    with _NoHostSync():
        before = k4.LAUNCHES, k3.LAUNCHES
        a, chi2_a = optimize_graph(g, None, iterations=10, cg_iters=60)
        launches = k4.LAUNCHES - before[0], k3.LAUNCHES - before[1]
        b, chi2_b = optimize_graph(g, None, iterations=10, cg_iters=60)
    assert not torch.are_deterministic_algorithms_enabled()
    assert launches == (10 * (60 + 3), 10 * (60 + 3))  # K4, K3
    for f in KeyframeGraph._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(chi2_a, chi2_b)
    host, _ = optimize_graph(KeyframeGraph(*(x.cpu() for x in g)), None,
                             iterations=10, cg_iters=60)
    np.testing.assert_allclose(a.pose_t.cpu().numpy(), host.pose_t.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(a.pose_q.cpu().numpy(), host.pose_q.numpy(),
                               atol=1e-4)


def test_verify_loop_on_cuda_has_no_host_sync(seq):
    """verify_loop on two keyframe snapshots of the System on "cuda" with no
    host sync; on "cpu" from the same snapshots and key: identical ok,
    n_inliers within 1, rel within 1e-3 m and 1e-3 rad."""
    _require_gpu()
    from visfs_tpu_torch.core import prng
    from visfs_tpu_torch.core.camera import make_stereo_camera
    from visfs_tpu_torch.slam.mapping import KeyframeSnapshot, verify_loop

    params = {"Tracker/MaxFeatures": 60, "Tracker/MinDistance": 12,
              "Tracker/QualityLevel": 0.05, "Optimizer/Iterations": 20,
              "Estimator/Force3DoF": True}
    cam = seq.camera
    s = System(params, device="cuda")
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    snaps = []
    for k in range(4):
        s.input_primary_sensor_data(float(seq.stamps[k]), seq.left[k],
                                    seq.right[k])
        snaps.append(s.keyframe_snapshot(max_kp=48))
    cpu_cam = make_stereo_camera(float(cam.fx), float(cam.fy),
                                 float(cam.cx), float(cam.cy),
                                 float(cam.baseline), width=cam.width,
                                 height=cam.height, device="cpu")
    key = prng.PRNGKey(0, "cuda")
    with _NoHostSync():
        rel_c, ok_c, n_c = verify_loop(snaps[1], snaps[3], s.camera, key)
    rel_p, ok_p, n_p = verify_loop(
        KeyframeSnapshot(*(x.cpu() for x in snaps[1])),
        KeyframeSnapshot(*(x.cpu() for x in snaps[3])), cpu_cam,
        key.cpu())
    assert bool(ok_c) == bool(ok_p)
    assert bool(ok_c) and abs(int(n_c) - int(n_p)) <= 1
    rel_c, rel_p = rel_c.cpu().double().numpy(), rel_p.double().numpy()
    assert np.abs(rel_c[:3, 3] - rel_p[:3, 3]).max() <= 1e-3
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2)
    d = np.linalg.norm(rel_c[:3, :3] - rel_p[:3, :3]) / (2 * np.sqrt(2))
    assert 2 * np.arcsin(min(d, 1.0)) <= 1e-3


def _small_system(seq, params, device="cuda"):
    cam = seq.camera
    s = System(params, device=device)
    s.init(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.baseline), width=cam.width, height=cam.height)
    return s


def test_numpy_frames_enter_without_a_host_sync(seq):
    """Host numpy images (as the native runtime's worker hands them over)
    reach the device through pinned memory: no host sync, and the step
    bit-equal to the one fed the same frames as CUDA tensors."""
    _require_gpu()
    params = {"Tracker/MaxFeatures": 60, "Tracker/MinDistance": 12,
              "Tracker/QualityLevel": 0.05}
    a, b = _small_system(seq, params), _small_system(seq, params)
    for k in range(2):
        b.input_primary_sensor_data(float(seq.stamps[k]),
                                    torch.from_numpy(seq.left[k]).cuda(),
                                    torch.from_numpy(seq.right[k]).cuda())
    a.input_primary_sensor_data(float(seq.stamps[0]), seq.left[0],
                                seq.right[0])
    torch.cuda.synchronize()
    with _NoHostSync():
        a.input_primary_sensor_data(float(seq.stamps[1]),
                                    np.ascontiguousarray(seq.left[1]),
                                    np.ascontiguousarray(seq.right[1]))
    for oa, ob in zip(a.drain_outputs(), b.drain_outputs()):
        np.testing.assert_array_equal(oa.pose, ob.pose)
        assert int(oa.n_inliers) == int(ob.n_inliers)


def test_system_runtime_on_cuda_keeps_every_wheel_row(seq):
    """SystemRuntime's worker steps a strategy-2 System on "cuda" while the
    main thread pushes a wheel row every 2 ms: every frame comes out and
    the odometry buffer's head counts every row pushed."""
    _require_gpu()
    import time

    from visfs_tpu_torch.runtime import SystemRuntime

    params = {"Tracker/MaxFeatures": 60, "Tracker/MinDistance": 12,
              "Tracker/QualityLevel": 0.05, "System/SensorStrategy": 2}
    s = _small_system(seq, params)
    srt = SystemRuntime(s, capacity=8, slop_s=0.02)
    srt.start()
    n, pushed, outs = len(seq.stamps), 0, []
    try:
        for k in range(n):
            srt.push_left(float(seq.stamps[k]), seq.left[k])
            srt.push_right(float(seq.stamps[k]), seq.right[k])
        deadline = time.time() + 120
        while len(outs) < n and time.time() < deadline:
            row = seq.wheel_odom[pushed % len(seq.wheel_odom)]
            srt.push_odometry(float(row[0]), row[1:7])
            pushed += 1
            o = srt.output()
            if o is not None:
                outs.append(o)
            time.sleep(0.002)
    finally:
        srt.stop()
    assert len(outs) == n and srt.stats()["processed"] == n
    assert int(s.state.odom.head) == pushed


# --- more than one card ------------------------------------------------------

def _require_gpus(n):
    _require_gpu()
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA GPUs, {torch.cuda.device_count()} "
                    "visible")


def test_k1_pyramid_on_a_second_card_equals_the_first(bench_pair):
    """K1's pyramid entry on tensors of cuda:1 while cuda:0 is the current
    device launches on cuda:1 (the wrapper's device guard) and equals the
    same call on cuda:0 bit for bit."""
    _require_gpus(2)
    pyr0, pyr1, points = bench_pair
    p, n = LKParams(), 240
    rng = np.random.default_rng(n)
    pts = points[:n].contiguous()
    init = pts + torch.from_numpy(rng.normal(0, 1.0, (n, 2)).astype(
        np.float32)).to(pts.device)
    valid = torch.from_numpy(rng.uniform(size=n) > 0.1).to(pts.device)
    kw = dict(win=p.win_size, max_level=p.max_level,
              iterations=p.iterations, eps=p.eps,
              min_eig_threshold=p.min_eig_threshold, bidirectional=True,
              fb_threshold=1.5)

    def on(dev, pyr):
        return pyr._replace(**{f: tuple(t.to(dev) for t in getattr(pyr, f))
                               for f in ("levels", "gx", "gy")})

    with torch.cuda.device(0):
        want = k1.lk_pyramid(on("cuda:0", pyr0), on("cuda:0", pyr1),
                             pts.to("cuda:0"), init.to("cuda:0"),
                             valid.to("cuda:0"), **kw)
        before = k1.PYR_LAUNCHES
        got = k1.lk_pyramid(on("cuda:1", pyr0), on("cuda:1", pyr1),
                            pts.to("cuda:1"), init.to("cuda:1"),
                            valid.to("cuda:1"), **kw)
        assert k1.PYR_LAUNCHES == before + 1
    for dev in (0, 1):
        torch.cuda.synchronize(dev)
    for a, b in zip(got, want):
        assert a.device == torch.device("cuda", 1)
        assert torch.equal(a.cpu(), b.cpu())


def test_multichip_entry_over_nccl_holds_its_gates():
    """The multi-card entry at two ranks over NCCL, one card each (set
    before any state), at a small size: dp_fleet_step's rows bit-equal to
    single Systems at strategies 0 and 3, FleetMapping against
    MultiRobotMapping, the sharded solvers; every gate of its report
    holds."""
    _require_gpus(2)
    from visfs_tpu_torch import multichip

    report = multichip.run(2, "cuda", 160, 120, frames=4, robot_frames=8)
    failed = [f"{name}: {gate}" for name, sec in report["sections"].items()
              for gate, ok in sec["gates"].items() if not ok]
    assert report["ok"] and not failed, failed
