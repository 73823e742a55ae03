"""visfs_tpu_torch laser pretreatment, occupied-space factor and laser BA
against visfs_tpu on the same numpy-seeded inputs.

Tolerances: pretreat with and without de-skew 1e-6 m, identical masks;
bicubic_cost and the residual 1e-6; occupied_space_terms' Jacobian within
1e-4 relative (of its largest entry) of the reference's
``jax.value_and_grad`` and of ``torch.func`` on the port's own residual;
one local_optimize with LaserData, poses within 1e-4; strategy 4's first
frame (no wheel link, an axis-aligned pose), poses within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.core import lie as jlie
from visfs_tpu.slam import laser as jlaser
from visfs_tpu.solver import ba as jba
from visfs_tpu.solver import factors as jfac
from visfs_tpu.solver import occupied_space as josp
from visfs_tpu_torch.core.camera import make_stereo_camera
from visfs_tpu_torch.slam import laser as tlaser
from visfs_tpu_torch.solver import ba as tba
from visfs_tpu_torch.solver import factors as tfac
from visfs_tpu_torch.solver import occupied_space as tosp

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

T = torch.from_numpy
K = 96


def _t_laser_robot():
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.1), np.sin(0.1)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = [0.2, -0.05, 0.3]
    return m


@pytest.fixture(scope="module")
def scan():
    rng = np.random.default_rng(0)
    ang = np.linspace(-np.pi, np.pi, K, endpoint=False)
    r = rng.uniform(0.02, 40.0, K)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang),
                    rng.normal(scale=0.02, size=K)], -1).astype(np.float32)
    mask = rng.uniform(size=K) > 0.1
    times = np.linspace(-0.1, 0.0, K).astype(np.float32)
    vel = np.float32([0.5, -0.1, 0.0, 0.0, 0.0, 1.2])
    return pts, mask, times, vel


_pretreat = jax.jit(jlaser.pretreat, static_argnames=("n_subdivisions",))


@pytest.mark.parametrize("mode", ["plain", "deskew", "deskew_zero_v"])
def test_pretreat_matches_reference(scan, mode):
    pts, mask, times, vel = scan
    if mode == "deskew_zero_v":
        vel = np.zeros(6, np.float32)
    kw = {} if mode == "plain" else dict(n_subdivisions=5)
    targs = (T(pts), T(mask), T(_t_laser_robot()), 0.1, 30.0, 5.0)
    jargs = tuple(jnp.asarray(a) for a in (pts, mask, _t_laser_robot())) \
        + (0.1, 30.0, 5.0)
    if mode == "plain":
        ref = _pretreat(*jargs)
        port = tlaser.pretreat(*targs)
    else:
        ref = _pretreat(*jargs, times=jnp.asarray(times),
                        velocity6=jnp.asarray(vel), **kw)
        port = tlaser.pretreat(*targs, times=T(times), velocity6=T(vel),
                               **kw)
    for f in ("returns_mask", "misses_mask"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert port.returns_mask.sum() > 40 and port.misses_mask.sum() > 5
    for f in ("origin", "returns", "misses"):
        np.testing.assert_allclose(getattr(port, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-6)


# --- the occupied-space factor ---------------------------------------------

E = 64
RES = 0.1


def _cost_grid():
    """A room whose walls (and a pillar) are occupied, correspondence costs
    in [0.1, 0.9] smoothed over a few cells, unknown outside."""
    yy, xx = np.mgrid[0:E, 0:E].astype(np.float32)
    d = np.minimum.reduce([np.abs(xx - 8), np.abs(xx - 55), np.abs(yy - 6),
                           np.abs(yy - 58),
                           np.hypot(xx - 30, yy - 22) - 2.0])
    cost = 0.9 - 0.8 * np.exp(-0.5 * (d / 1.5) ** 2)
    return np.clip(cost, 0.1, 0.9).astype(np.float32)


@pytest.fixture(scope="module")
def grid():
    return _cost_grid()


_bicubic = jax.jit(jax.vmap(josp.bicubic_cost, in_axes=(None, 0, 0)))


def test_bicubic_cost_matches_reference(grid):
    rng = np.random.default_rng(1)
    rr = rng.uniform(-3.0, E + 2.0, 2000).astype(np.float32)
    cc = rng.uniform(-3.0, E + 2.0, 2000).astype(np.float32)
    rr[:10] = np.arange(10) + 20.0  # on grid nodes
    ref = np.asarray(_bicubic(jnp.asarray(grid), jnp.asarray(rr),
                              jnp.asarray(cc)))
    port = tosp.bicubic_cost(T(grid), T(rr), T(cc)).numpy()
    np.testing.assert_allclose(port, ref, atol=1e-6)


def _pose_and_points(seed, yaw=0.3, origin=(0.4, -0.3)):
    """A Tcw pose (world -> camera through the default rig's t_ir) and
    robot-frame points near the grid's walls."""
    rng = np.random.default_rng(seed)
    cam = make_stereo_camera(100.0, 100.0, 80.0, 60.0, 0.12, width=160,
                             height=120, device="cpu")
    t_ir = cam.t_ir.numpy()
    twr = np.eye(4, dtype=np.float32)
    twr[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    twr[:3, 3] = [origin[0], origin[1], 0.0]
    tcw = np.linalg.inv(twr @ np.linalg.inv(t_ir)).astype(np.float32)
    q = np.array(jlie.mat_to_quat(jnp.asarray(tcw[:3, :3])))
    ang = rng.uniform(-np.pi, np.pi, K)
    rad = rng.uniform(0.5, 3.0, K)
    pr = np.stack([rad * np.cos(ang), rad * np.sin(ang), np.zeros(K)],
                  -1).astype(np.float32)
    mask = rng.uniform(size=K) > 0.1
    return q, tcw[:3, 3].astype(np.float32), pr, mask, t_ir


# the grid's corner: row = (max_x - x)/res - 0.5, col = (max_y - y)/res - 0.5
MAX_X, MAX_Y = 3.2, 3.3

_terms = jax.jit(josp.occupied_space_terms)


@pytest.fixture(scope="module")
def terms(grid):
    q, t, pr, mask, t_ir = _pose_and_points(2)
    args = (q, t, pr, mask, grid, np.float32(RES), np.float32(MAX_X),
            np.float32(MAX_Y), t_ir, np.float32(10.0))
    ref = _terms(*(jnp.asarray(a) for a in args))
    port = tosp.occupied_space_terms(*(torch.as_tensor(np.array(a))
                                       for a in args))
    return args, ref, port


def test_occupied_space_residual_and_weight_match(terms):
    args, ref, port = terms
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]),
                               atol=1e-6)
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(ref[2]))
    q, t, pr, mask, grid = args[:5]
    single = tosp.occupied_space_residual(
        T(q), T(t), T(pr), T(grid), *(torch.as_tensor(a) for a in args[5:9]))
    jsingle = jax.jit(jax.vmap(josp.occupied_space_residual,
                               in_axes=(None, None, 0) + (None,) * 5))(
        *(jnp.asarray(a) for a in args[:3] + args[4:9]))
    np.testing.assert_allclose(single.numpy(), np.asarray(jsingle),
                               atol=1e-6)


def test_occupied_space_jacobian_matches_autodiff(terms):
    args, ref, port = terms
    jr = np.asarray(ref[1])
    scale = np.abs(jr).max()
    assert scale > 1e-2
    np.testing.assert_allclose(port[1].numpy(), jr, rtol=1e-4,
                               atol=1e-4 * scale)
    # and against torch.func on the port's own residual
    q, t, pr, mask = (torch.as_tensor(a) for a in args[:4])
    rest = [torch.as_tensor(a) for a in args[4:9]]

    def res(delta, p):
        qq, tt = tfac.apply_tangent(q, t, delta)
        return tosp.occupied_space_residual(qq, tt, p, *rest)

    J = torch.func.vmap(torch.func.grad(res), in_dims=(None, 0))(
        torch.zeros(6), pr)
    J = torch.where(mask[:, None], J, torch.zeros_like(J))
    np.testing.assert_allclose(port[1].numpy(), J.numpy(), rtol=1e-4,
                               atol=1e-4 * scale)


# --- local_optimize with LaserData ------------------------------------------

P, L = 6, 12


@pytest.fixture(scope="module")
def laser_ba(grid):
    """Strategy 4's problem shape: no visual edges, wheel links between the
    window's poses, the newest pose off by a few cm and scan-matched."""
    q, t, pr, mask, t_ir = _pose_and_points(3)
    rng = np.random.default_rng(4)
    pq = np.tile(q, (P, 1)).astype(np.float32)
    pt = np.stack([t + np.float32([0.0, 0.0, -0.05 * (P - 1 - i)])
                   for i in range(P)]).astype(np.float32)
    link = [jlie.se3_mul(jlie.se3_inv((jnp.asarray(pq[i]),
                                       jnp.asarray(pt[i]))),
                         (jnp.asarray(pq[i + 1]), jnp.asarray(pt[i + 1])))
            for i in range(P - 1)]
    d = np.float32([0.03, -0.02, 0.01, 0.0, 0.015, 0.0])
    a, b = jfac.apply_tangent(jnp.asarray(pq[-1]), jnp.asarray(pt[-1]),
                              jnp.asarray(d))
    pq[-1], pt[-1] = np.asarray(a), np.asarray(b)
    pose_fixed = np.zeros(P, bool)
    pose_fixed[P - 2] = True
    arrays = dict(
        pose_q=pq, pose_t=pt, pose_valid=np.ones(P, bool),
        pose_fixed=pose_fixed,
        lm_pos=rng.uniform(-2, 2, (L, 3)).astype(np.float32),
        lm_valid=np.ones(L, bool), lm_fixed=np.zeros(L, bool),
        obs=np.zeros((L, P, 3), np.float32),
        obs_mask=np.zeros((L, P), bool),
        link_q=np.stack([np.asarray(x[0]) for x in link]).astype(np.float32),
        link_t=np.stack([np.asarray(x[1]) for x in link]).astype(np.float32),
        link_mask=np.ones(P - 1, bool))
    laser = dict(points=pr, mask=mask, cost_grid=grid,
                 resolution=np.float32(RES), max_x=np.float32(MAX_X),
                 max_y=np.float32(MAX_Y), t_ir=t_ir, info=np.float32(10.0))
    intr = (100.0, 100.0, 80.0, 60.0, 12.0)
    settings = dict(iterations=10, pixel_variance=1.5, robust_delta=8.0,
                    odometry_covariance=5e-3)
    jprob = jba.BAProblem(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        intr=jfac.StereoIntrinsics(*(jnp.float32(x) for x in intr)),
        laser=jba.LaserData(**{k: jnp.asarray(v) for k, v in laser.items()}))
    ref = jax.jit(lambda p: jba.local_optimize(
        p, jba.BASettings(**settings)))(jprob)
    tprob = tba.BAProblem(
        **{k: T(np.array(v)) for k, v in arrays.items()},
        intr=tfac.StereoIntrinsics(*(torch.tensor(x) for x in intr)),
        laser=tba.LaserData(**{k: torch.as_tensor(v)
                               for k, v in laser.items()}))
    port = tba.local_optimize(tprob, tba.BASettings(**settings))
    return arrays, ref, port


def test_laser_ba_poses_match(laser_ba):
    arrays, ref, port = laser_ba
    assert bool(port.ok) and bool(ref.ok)
    np.testing.assert_allclose(port.pose_t.numpy(), np.asarray(ref.pose_t),
                               atol=1e-4)
    np.testing.assert_allclose(port.pose_q.numpy(), np.asarray(ref.pose_q),
                               atol=1e-4)
    np.testing.assert_allclose(float(port.chi2), float(ref.chi2), rtol=1e-4)
    # the scan match moved the newest pose
    assert np.abs(port.pose_t.numpy()[-1] - arrays["pose_t"][-1]).max() \
        > 1e-3


@pytest.fixture(scope="module")
def first_laser_frame(grid):
    """Strategy 4's first frame after the bootstrap: the window's two poses
    where the bootstrap left the robot (yaw 0, so the camera's axes lie on
    the robot's), the first fixed, no wheel link yet, the scan matched
    from there.  The laser terms alone fill the newest pose's block of the
    Hessian, and its out-of-plane columns (camera y, rotations about x and
    z) are 0 in exact arithmetic: float32 residues of the Jacobian decide
    the step there."""
    q, t, pr, mask, t_ir = _pose_and_points(5, yaw=0.0, origin=(0.3, 0.2))
    rng = np.random.default_rng(6)
    arrays = dict(
        pose_q=np.tile(q, (2, 1)).astype(np.float32),
        pose_t=np.tile(t, (2, 1)).astype(np.float32),
        pose_valid=np.ones(2, bool), pose_fixed=np.array([True, False]),
        lm_pos=rng.uniform(-2, 2, (L, 3)).astype(np.float32),
        lm_valid=np.ones(L, bool), lm_fixed=np.zeros(L, bool),
        obs=np.zeros((L, 2, 3), np.float32),
        obs_mask=np.zeros((L, 2), bool),
        link_q=np.float32([[1.0, 0.0, 0.0, 0.0]]),
        link_t=np.zeros((1, 3), np.float32), link_mask=np.zeros(1, bool))
    laser = dict(points=pr, mask=mask, cost_grid=grid,
                 resolution=np.float32(RES), max_x=np.float32(MAX_X),
                 max_y=np.float32(MAX_Y), t_ir=t_ir, info=np.float32(10.0))
    intr = (100.0, 100.0, 80.0, 60.0, 12.0)
    settings = dict(iterations=20, pixel_variance=1.5, robust_delta=8.0,
                    odometry_covariance=5e-5)
    jprob = jba.BAProblem(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        intr=jfac.StereoIntrinsics(*(jnp.float32(x) for x in intr)),
        laser=jba.LaserData(**{k: jnp.asarray(v) for k, v in laser.items()}))
    ref = jax.jit(lambda p: jba.local_optimize(
        p, jba.BASettings(**settings)))(jprob)
    tprob = tba.BAProblem(
        **{k: T(np.array(v)) for k, v in arrays.items()},
        intr=tfac.StereoIntrinsics(*(torch.tensor(x) for x in intr)),
        laser=tba.LaserData(**{k: torch.as_tensor(v)
                               for k, v in laser.items()}))
    port = tba.local_optimize(tprob, tba.BASettings(**settings))
    return arrays, laser, ref, port


def test_first_laser_frame_matches_reference(first_laser_frame):
    """The reference's autodiff leaves float32 residues in the out-of-plane
    columns of the Jacobian, and so does the port's; with a closed form
    (exact zeros there) the port's step left the pose 0.106 m from the
    reference's, which the guard holds in place.  Poses within 1e-6."""
    arrays, laser, ref, port = first_laser_frame
    args = [laser[k] for k in ("points", "mask", "cost_grid", "resolution",
                               "max_x", "max_y", "t_ir", "info")]
    pose = (arrays["pose_q"][-1], arrays["pose_t"][-1])
    _, jj, _ = _terms(*(jnp.asarray(a) for a in pose + tuple(args)))
    _, tj, _ = tosp.occupied_space_terms(*(torch.as_tensor(np.array(a))
                                           for a in pose + tuple(args)))
    out_of_plane = [1, 3, 5]
    jj, tj = np.asarray(jj), tj.numpy()
    scale = np.abs(jj).max()
    print(f"out-of-plane Jacobian columns, largest |J|: reference "
          f"{np.abs(jj[:, out_of_plane]).max():.3g}, port "
          f"{np.abs(tj[:, out_of_plane]).max():.3g}, of {scale:.3g}")
    assert np.abs(jj[:, out_of_plane]).max() < 1e-6 * scale
    assert bool(port.ok) and bool(ref.ok)
    print(f"newest pose moved: reference "
          f"{np.abs(np.asarray(ref.pose_t)[-1] - pose[1]).max():.3g} m, "
          f"port {np.abs(port.pose_t.numpy()[-1] - pose[1]).max():.3g} m")
    np.testing.assert_allclose(port.pose_t.numpy(), np.asarray(ref.pose_t),
                               atol=1e-6)
    np.testing.assert_allclose(port.pose_q.numpy(), np.asarray(ref.pose_q),
                               atol=1e-6)
