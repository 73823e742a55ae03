"""Threefry-2x32 counter-based PRNG, bit-exact with ``jax.random``.

The reference threads a ``jax.random`` key through the step (VOState
rng_key; the PnP RANSAC draws Gumbel subsets and normal perturbations from
it).  Reproducing the same bits makes the port's RANSAC comparable with the
reference frame by frame.  Only what the slice draws is here: ``PRNGKey``,
``split``, ``uniform``, ``gumbel`` and ``normal`` for float32, with the
counter layout of ``jax_threefry_partitionable=True`` (the default of
jax >= 0.5): element i of a draw of shape S hashes the 64-bit counter i
(row-major index into S) split as (hi, lo) 32-bit words.

A key is an int64 tensor [2] holding two uint32 words (torch's uint32
support is partial, so words live in int64 and every add is masked).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of counter words (x1, x2) under key
    (k1, k2); all int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a seed in [0, 2**32)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=device)


def _hash_iota(key, shape):
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    hi = torch.zeros_like(lo)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1.reshape(shape), b2.reshape(shape)


def split(key, num: int = 2) -> torch.Tensor:
    """jax.random.split: [num, 2] new keys."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def _random_bits32(key, shape):
    b1, b2 = _hash_iota(key, tuple(shape))
    return b1 ^ b2


def uniform(key, shape, minval=0.0, maxval=1.0, dtype=torch.float32):
    """jax.random.uniform in float32: 23 random mantissa bits in [1, 2),
    shifted to [0, 1), scaled to [minval, maxval)."""
    if dtype != torch.float32:
        raise NotImplementedError("uniform: only float32 is ported")
    bits = _random_bits32(key, shape)
    # (mantissa | 1.0's exponent) as float32, minus 1.0, is mantissa *
    # 2^-23 exactly; computed so, with no bitcast (a dtype view has no
    # batching rule under torch.func.vmap in every torch release)
    floats = (bits >> 9).to(torch.float32) * (2.0 ** -23)
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape, dtype=torch.float32):
    """jax.random.gumbel (mode "low"): -log(-log(u)), u in [tiny, 1)."""
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0, dtype)))


# Giles' single-precision erfinv polynomial, as XLA lowers chlo.erf_inv.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _fma_f32(a, b, c):
    """round_f32(a*b + c) with one rounding, like a fused multiply-add:
    the float64 product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def erfinv_f32(x):
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.full_like(x, _ERFINV_LT5[0]),
                    torch.full_like(x, _ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.full_like(x, a), torch.full_like(x, b))
        p = _fma_f32(p, w, c)
    inf = torch.full_like(x, float("inf"))
    return torch.where(torch.abs(x) == 1.0, torch.copysign(inf, x), p * x)


def normal(key, shape, dtype=torch.float32):
    """jax.random.normal: sqrt(2) * erfinv(u), u in (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, dtype)
    return np.float32(np.sqrt(2)).item() * erfinv_f32(u)
