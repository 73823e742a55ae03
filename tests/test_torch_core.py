"""visfs_tpu_torch.core (lie, camera, prng) against visfs_tpu on the same
numpy-seeded inputs.  Tolerances: lie and camera atol 1e-5 (float32 with
other summation orders); prng bits exactly, floats atol 1e-6 (the log /
log1p of the two libraries differ by an ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visfs_tpu.core import camera as jcam
from visfs_tpu.core import lie as jlie
from visfs_tpu_torch.core import camera as tcam
from visfs_tpu_torch.core import lie as tlie
from visfs_tpu_torch.core import prng

# One intra-op thread: the suite runs several pytest workers on shared
# cores, and torch's thread pool under that contention slows the port's
# many small CPU ops by an order of magnitude.
torch.set_num_threads(1)

N = 16


def _inputs():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.normal(size=(N, 4)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    return dict(
        q=q, q2=q2, qraw=rng.normal(size=(N, 4)).astype(np.float32),
        v=rng.normal(size=(N, 3)).astype(np.float32),
        w=(rng.normal(size=(N, 3)) * 0.7).astype(np.float32),
        wsmall=(rng.normal(size=(N, 3)) * 1e-7).astype(np.float32),
        t=rng.normal(size=(N, 3)).astype(np.float32),
        rpy=rng.uniform(-1.2, 1.2, size=(N, 3)).astype(np.float32),
        delta=(rng.normal(size=(N, 6)) * 0.1).astype(np.float32),
    )


def _lie_outputs(L, x):
    cat = jnp.concatenate if L is jlie else torch.cat
    stack = jnp.stack if L is jlie else torch.stack
    R = L.quat_to_mat(x["q"])
    T = L.se3_matrix(x["q"], x["t"])
    Trpy = L.xyzrpy_to_mat(x["t"][:, 0], x["t"][:, 1], x["t"][:, 2],
                           x["rpy"][:, 0], x["rpy"][:, 1], x["rpy"][:, 2])
    pq, pt = L.pose_update(x["q"], x["t"], x["delta"])
    mq, mt = L.se3_mul((x["q"], x["t"]), (x["q2"], x["v"]))
    iq, it = L.se3_inv((x["q"], x["t"]))
    return {
        "quat_mul": L.quat_mul(x["q"], x["q2"]),
        "quat_conj": L.quat_conj(x["q"]),
        "quat_inv": L.quat_inv(x["qraw"]),
        "quat_normalize": L.quat_normalize(x["qraw"]),
        "quat_positify": L.quat_positify(x["qraw"]),
        "quat_rotate": L.quat_rotate(x["q"], x["v"]),
        "delta_q": L.delta_q(x["w"]),
        "skew": L.skew(x["v"]),
        "quat_left": L.quat_left(x["qraw"]),
        "quat_right": L.quat_right(x["qraw"]),
        "quat_to_mat": R,
        "mat_to_quat": L.mat_to_quat(R),
        "so3_exp": L.so3_exp(x["w"]),
        "so3_exp_small": L.so3_exp(x["wsmall"]),
        "so3_log": L.so3_log(L.so3_exp(x["w"])),
        "se3_matrix": T,
        "se3_from_matrix_t": L.se3_from_matrix(T)[1],
        "se3_mul": cat([mq, mt], -1),
        "se3_inv": cat([iq, it], -1),
        "se3_apply": L.se3_apply((x["q"], x["t"]), x["v"]),
        "mat_inv_se3": L.mat_inv_se3(T),
        "mat_apply": L.mat_apply(T, x["v"]),
        "rpy_to_mat": L.rpy_to_mat(x["rpy"][:, 0], x["rpy"][:, 1],
                                   x["rpy"][:, 2]),
        "mat_to_rpy": stack(L.mat_to_rpy(Trpy[..., :3, :3]), -1),
        "xyzrpy_to_mat": Trpy,
        "mat_to_xyzrpy": stack(L.mat_to_xyzrpy(Trpy), -1),
        "pose_update": cat([pq, pt], -1),
        "flatten_3dof": L.flatten_3dof(Trpy),
    }


@pytest.fixture(scope="module")
def lie_pairs():
    x = _inputs()
    ref = jax.jit(lambda xj: _lie_outputs(jlie, xj))(
        {k: jnp.asarray(v) for k, v in x.items()})
    port = _lie_outputs(tlie, {k: torch.from_numpy(v) for k, v in x.items()})
    return {k: (np.asarray(ref[k]), port[k].numpy()) for k in ref}


LIE_FUNCTIONS = ["quat_mul", "quat_conj", "quat_inv", "quat_normalize",
                 "quat_positify", "quat_rotate", "delta_q", "skew",
                 "quat_left", "quat_right", "quat_to_mat", "mat_to_quat",
                 "so3_exp", "so3_exp_small", "so3_log", "se3_matrix",
                 "se3_from_matrix_t", "se3_mul", "se3_inv", "se3_apply",
                 "mat_inv_se3", "mat_apply", "rpy_to_mat", "mat_to_rpy",
                 "xyzrpy_to_mat", "mat_to_xyzrpy", "pose_update",
                 "flatten_3dof"]


@pytest.mark.parametrize("name", LIE_FUNCTIONS)
def test_lie_matches_reference(lie_pairs, name):
    ref, port = lie_pairs[name]
    assert port.dtype == np.float32
    np.testing.assert_allclose(port, ref, atol=1e-5, err_msg=name)


def _camera_outputs(C, cam, p_img, uvl, uvr):
    p_robot, ok = C.triangulate_stereo(cam, uvl, uvr, 0.2, 10.0)
    return {"project": C.project(cam, p_img),
            "project_stereo": C.project_stereo(cam, p_img),
            "t_ri": cam.t_ri, "t_ir": cam.t_ir, "bf": cam.bf,
            "triangulated": p_robot, "tri_ok": ok}


def test_camera_matches_reference():
    rng = np.random.default_rng(3)
    extr = np.eye(4, dtype=np.float32)
    extr[:3, 3] = [0.1, -0.05, 0.3]
    args = dict(fxr=301.0, cxr=161.0, t_camera_to_robot=extr, width=320,
                height=240)
    p_img = np.stack([rng.uniform(-2, 2, 32), rng.uniform(-1, 1, 32),
                      rng.uniform(0.5, 12, 32)], -1).astype(np.float32)
    uvl = rng.uniform(20, 300, (32, 2)).astype(np.float32)
    uvr = uvl - np.stack([rng.uniform(-1, 40, 32), np.zeros(32)],
                         -1).astype(np.float32)
    jc = jcam.make_stereo_camera(300.0, 302.0, 160.0, 120.0, 0.12, **args)
    ref = jax.jit(lambda a, b, c: _camera_outputs(jcam, jc, a, b, c))(
        p_img, uvl, uvr)
    tc = tcam.make_stereo_camera(300.0, 302.0, 160.0, 120.0, 0.12, **args,
                                 device="cpu")
    port = _camera_outputs(tcam, tc, torch.from_numpy(p_img),
                           torch.from_numpy(uvl), torch.from_numpy(uvr))
    for k in ref:
        r, p = np.asarray(ref[k]), port[k].numpy()
        if r.dtype == bool:
            np.testing.assert_array_equal(p, r, err_msg=k)
        else:
            np.testing.assert_allclose(p, r, atol=1e-5, equal_nan=True,
                                       err_msg=k)
    assert tc.width == 320 and tc.height == 240


def _key_words(k):
    return np.asarray(jax.random.key_data(k)
                      if jnp.issubdtype(k.dtype, jax.dtypes.prng_key) else k)


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_prng_split_bits_equal(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _key_words(jk).astype(np.int64))
    for _ in range(4):  # the step's chain: split(key, 3) -> key, subkey, trk
        js = jax.random.split(jk, 3)
        ts = prng.split(tk, 3)
        np.testing.assert_array_equal(ts.numpy(),
                                      _key_words(js).astype(np.int64))
        jk, tk = js[0], ts[0]


@pytest.fixture(scope="module")
def draws():
    key = jax.random.PRNGKey(42)
    ref = jax.jit(lambda k: (
        jax.random.uniform(k, (50, 120), dtype=jnp.float32),
        jax.random.gumbel(jax.random.split(k)[0], (50, 120),
                          dtype=jnp.float32),
        jax.random.normal(jax.random.split(k)[1], (50, 6),
                          dtype=jnp.float32)))(key)
    tk = prng.PRNGKey(42)
    ts = prng.split(tk)
    port = (prng.uniform(tk, (50, 120)), prng.gumbel(ts[0], (50, 120)),
            prng.normal(ts[1], (50, 6)))
    return [np.asarray(r) for r in ref], [p.numpy() for p in port]


def test_prng_uniform_bits_equal(draws):
    np.testing.assert_array_equal(draws[1][0], draws[0][0])


def test_prng_gumbel_matches(draws):
    np.testing.assert_allclose(draws[1][1], draws[0][1], atol=1e-6, rtol=0)


def test_prng_normal_matches(draws):
    np.testing.assert_allclose(draws[1][2], draws[0][2], atol=1e-6, rtol=0)
