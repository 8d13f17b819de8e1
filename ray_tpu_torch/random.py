"""Threefry-2x32 random numbers, bit for bit as ``jax.random`` makes them.

The serving path samples with ``jax.random`` keys (``_request_key`` and
``_sample_one`` in ``models/generate.py``): a request's tokens are a pure
function of its seed and positions, which is what recompute-preemption and
resume rest on. This module repeats the parts of ``jax.random`` those use,
with the reference's settings: the threefry2x32 implementation and
``jax_threefry_partitionable`` on (random bits are
``threefry_2x32(key, iota_2x32_shape(shape))``, ``split`` folds like it),
and "low" gumbel mode. ``normal`` (the RL policies' initialisers and SAC's
reparameterised draws) repeats XLA's erfinv polynomial on the same uniform
bits.

A key is an explicit int64 tensor ``[..., 2]`` holding two uint32 words
(jax's ``key_data``); leading dims are a batch of keys, as under ``vmap``.
There is no global state. uint32 arithmetic runs on int64 tensors masked to
32 bits, so the same code gives the same bits on the CPU and on CUDA.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 hash of counts ``(x0, x1)`` under key words
    ``(k0, k1)``: 20 rounds, a key injection every 4 (jax's
    ``_threefry2x32_lowering``). All four broadcast; uint32 values in int64
    tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, *, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.key(seed)``'s data for a 32-bit seed (jax's default,
    64-bit mode off): ``[0, seed mod 2**32]``, on ``device`` (default
    ``cuda``)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def _words(x: IntLike, like: torch.Tensor) -> torch.Tensor:
    """An integer (or int tensor) as uint32 words in int64 on ``like``'s
    device; negative values wrap as jax's int32 -> uint32 conversion."""
    return torch.as_tensor(x, device=like.device).to(torch.int64) & _M32


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counts ``(0, data)``, i.e.
    ``threefry_2x32(key, threefry_seed(data))``. ``key`` [..., 2] and
    ``data`` broadcast over the batch dims."""
    d = _words(data, key)
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b0, b1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> [num, 2] (the fold-like split of
    the partitionable mode: key ``i`` hashes the counts ``(0, i)``)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: [*batch, *shape] uint32
    words in int64, element ``i`` (row-major) hashing the counts
    ``(i >> 32, i & 0xffffffff)`` and xoring the two output words."""
    shape = tuple(shape)
    batch = key.shape[:-1]
    n = math.prod(shape)
    flat = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    k = key.reshape(*batch, *([1] * len(shape)), 2)
    b0, b1 = threefry2x32(k[..., 0], k[..., 1], flat >> 32, flat & _M32)
    return b0 ^ b1


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled to [minval, maxval) and clipped
    below at ``minval``, all in f32."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, (floats - 1.0) * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, "low" mode:
    ``-log(-log(uniform(tiny, 1)))``."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis (the
    gumbel-max trick, first index on ties). The key's batch dims, if any,
    lead the logits' shape: each batch row draws with its own key, as
    ``vmap(categorical)`` does."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, got "
                        f"{logits.dtype}")
    noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits, dim=-1)


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"): one
# degree-8 polynomial in w = -log1p(-x^2) - 2.5 where w < 5, another in
# sqrt(w) - 3 beyond; jax.random.normal goes through it (chlo.erf_inv).
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, as plain torch ops: the same polynomials
    in the same order, and +-inf at +-1. Not bit for bit: XLA's CPU code
    fuses the Horner steps into FMAs and has its own ``log1p``. On 1.2M
    draws of ``normal`` the two were at most 3 ulp apart (4.7% of draws
    differ at all); torch's own ``erfinv`` was up to 91 ulp off."""
    w = -torch.log1p(-x * x)
    central = w < 5.0

    def horner(coeffs, t):
        p = torch.full_like(t, coeffs[0])
        for c in coeffs[1:]:
            p = p * t + c
        return p

    # Each element gets its branch's polynomial, as XLA's select of the
    # coefficients gives it.
    p = torch.where(central, horner(_ERFINV_CENTRAL, w - 2.5),
                    horner(_ERFINV_TAIL, torch.sqrt(w) - 3.0))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with ``u``
    uniform in (nextafter(-1, 0), 1), the same bits as jax's."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return float(np.float32(math.sqrt(2.0))) * erfinv(u)
