"""``jax.random``'s threefry2x32 keys and normals, reproduced on torch tensors.

The JAX package's default text encoders draw their weights with
``jax.random.fold_in(jax.random.PRNGKey(seed), token_id)`` and
``jax.random.normal(key, (n,))``. This module gives the same key words and the
same random bits on any device, for a whole batch of keys at once:

- the 32-bit words are carried in int64 and masked with ``0xFFFFFFFF`` after
  every sum, since CUDA tensors have no unsigned 32-bit arithmetic to rely on;
- the bits follow ``jax_threefry_partitionable=True``, the default of jax
  0.9.0: element ``i`` of a ``(n,)`` draw hashes the counter pair ``(0, i)``
  and keeps the XOR of the two output words;
- a normal is ``sqrt(2) * erfinv(u)`` of a uniform ``u`` in ``(-1, 1)`` built
  from the top 23 bits, as ``jax.random.normal`` builds it. ``erfinv`` is
  XLA's float32 polynomial (Giles), its steps fused as XLA fuses them (each
  ``p * w + c`` rounded once): ``torch.erfinv`` differs from it by up to
  1.5e-5. ``log1p`` is torch's, which may differ from XLA's in the last bit,
  so a normal agrees with ``jax.random.normal`` to within about 2 ulp of its
  magnitude, not bit for bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch._compile import device_constant

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's ErfInv32 coefficients (Giles, "Approximating the erfinv function"), for w < 5 and w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor, x2: Tensor) -> Tuple[Tensor, Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x1, x2)`` under the key words ``(k1, k2)``.

    All four are int64 tensors holding values in ``[0, 2**32)`` and broadcast
    together; the two output words are too.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + k1) & _MASK, (x2 + k2) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def prng_key(seed: int, device=None) -> Tensor:
    """``jax.random.PRNGKey(seed)``'s key words for a 32-bit seed: ``[0, seed]`` as int64 of shape ``(2,)``."""
    return device_constant([0, seed & _MASK], torch.device(device if device is not None else "cpu"), torch.int64)


def fold_in(key: Tensor, data: Tensor) -> Tensor:
    """``jax.random.fold_in(key, d)`` for every ``d`` of ``data`` at once: ``(*data.shape, 2)`` key words.

    ``data`` is taken modulo ``2**32``, as ``jnp.uint32(d)`` takes it.
    """
    d = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: Tensor, n: int) -> Tensor:
    """32 random bits ``(*keys.shape[:-1], n)`` per key, as ``jax.random.bits(key, (n,))`` draws them."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(counts), counts)
    return b0 ^ b1


def _erfinv_xla(x: Tensor) -> Tensor:
    """XLA's float32 ErfInv polynomial on ``(-1, 1)``; each Horner step ``p * w + c`` rounded once, as an FMA."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = lambda i: torch.where(small, _ERFINV_SMALL[i], _ERFINV_LARGE[i]).double()  # noqa: E731
    p = coef(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = (coef(i) + p * w).float().double()
    return p.float() * x


def normal(keys: Tensor, n: int) -> Tensor:
    """Standard normals ``(*keys.shape[:-1], n)`` in float32, as ``jax.random.normal(key, (n,))`` draws them per key."""
    bits = random_bits(keys, n)
    # (bits >> 9) | bits of 1.0f is a float32 in [1, 2); the int32 view of a word below 2**31 is the word itself
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), -(1.0 - 2.0**-24), dtype=torch.float32, device=keys.device)  # float32's nextafter(-1, 0)
    u = torch.maximum(lo, f * 2.0 + lo)  # (1 - lo) rounds to 2.0 in float32, as in jax.random.uniform
    return torch.full((), math.sqrt(2), dtype=torch.float32, device=keys.device) * _erfinv_xla(u)


def normal_rows(seed: int, ids: Tensor, n: int) -> Tensor:
    """``jax.random.normal(fold_in(PRNGKey(seed), i), (n,))`` for each id ``i`` of ``ids``: ``(*ids.shape, n)``."""
    return normal(fold_in(prng_key(seed, ids.device), ids), n)


__all__ = ["fold_in", "normal", "normal_rows", "prng_key", "random_bits", "threefry2x32"]
