"""Counter-based PRNG in torch integer ops: JAX's threefry key chain.

The serving engine keys every sampled token by ``fold_in(fold_in(
PRNGKey(seed), gen), pos)`` (``dataplane/sampling.py``). For a port's
sampled stream to equal the JAX engine's, the keys, the random bits and
the uniforms drawn from them must be JAX's bit for bit. This module
rebuilds that chain from the Threefry-2x32 hash (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011) as JAX defines it:

* ``PRNGKey(s)`` of an int32 seed is the key pair ``(0, s)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``, taken as the new
  pair;
* ``split(k, n)`` (partitionable route): key ``i`` is
  ``threefry2x32(k, (hi32(i), lo32(i)))``;
* ``random_bits(k, (V,))`` on the partitionable route (JAX's
  ``jax_threefry_partitionable``, on by default): element ``i`` is
  ``y0 ^ y1`` of ``threefry2x32(k, (hi32(i), lo32(i)))``;
* ``uniform`` puts the top 23 bits into the mantissa of a float in
  ``[1, 2)``, subtracts 1, adds ``tiny`` and clamps at ``tiny``;
* ``gumbel`` ("low" mode) is ``-log(-log(u))``, and ``categorical`` is
  the first maximum of ``gumbel + logits``.

Unsigned 32-bit words live in int64 tensors (torch's uint32 support is
partial, and ``>>`` on int32 is arithmetic): every add, shift and rotate
is masked back to 32 bits, so no intermediate ever leaves ``[0, 2^32)``
before its mask (a 32-bit word shifted left by at most 31 fits an
int64). Every function takes ``[...]``-shaped key halves and broadcasts.

The bits and the uniforms are exact integer and IEEE operations, equal
on every backend. ``log`` is not: the CPU's and the card's ``log`` may
differ from XLA's by an ulp, so gumbels are held to a stated ulp bound
and drawn tokens compared on a grid (``tests/test_torch_sampling.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal, the uniform's lower bound.
_TINY = float(torch.finfo(torch.float32).tiny)

Key = Tuple[torch.Tensor, torch.Tensor]


def _u32(x) -> torch.Tensor:
    """An int tensor's low 32 bits as a non-negative int64 word."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x)
    return x.to(torch.int64) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x: Key) -> Key:
    """The Threefry-2x32 hash of the count pair ``x`` under the key pair
    ``key`` (20 rounds, five key injections), JAX's
    ``_threefry2x32_lowering``. Inputs are 32-bit words in int64 tensors;
    the outputs are too."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x[0] + ks[0]) & _M32
    x1 = (x[1] + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: torch.Tensor) -> Key:
    """``jax.random.PRNGKey`` of int32 seeds: the pair ``(0, seed)``."""
    k1 = _u32(seed)
    return torch.zeros_like(k1), k1


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in``: hash the count pair ``(0, data)`` under
    ``key``; the two output words are the new key."""
    d = _u32(data)
    return threefry2x32(key, (torch.zeros_like(d), d))


def split(key: Key, n: int) -> Key:
    """``jax.random.split(key, n)`` (partitionable route): key ``i`` is
    the hash's two words on the count pair ``(hi32(i), lo32(i))``.
    Returns ``[..., n]`` halves for ``[...]`` keys."""
    k0, k1 = key
    counts = torch.arange(n, dtype=torch.int64, device=k0.device)
    return threefry2x32((k0[..., None], k1[..., None]),
                        (counts >> 32, counts & _M32))


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (32-bit, partitionable route):
    ``[..., n]`` words for ``[...]`` keys, element ``i`` the xor of the
    hash's two words on the count pair ``(hi32(i), lo32(i))``."""
    k0, k1 = key
    counts = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32((k0[..., None], k1[..., None]),
                          (counts >> 32, counts & _M32))
    return y0 ^ y1


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1)`` of 32-bit words, as
    JAX's ``_uniform`` computes it: mantissa bits into ``[1, 2)``, minus
    1, times ``1 - tiny`` (1.0 in float32), plus ``tiny``, at least
    ``tiny``."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # The product by 1.0 is exact, so it is left out.
    return torch.clamp_min(f + _TINY, _TINY)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from 32-bit words (JAX's "low" mode)."""
    return -torch.log(-torch.log(uniform(bits)))


def gumbel_rows(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` for each of ``[...]`` keys:
    ``[..., n]`` float32."""
    return gumbel(random_bits(key, n))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` row by row: the
    first maximum of ``gumbel + logits`` (int64 ``[...]``)."""
    return torch.argmax(gumbel_rows(key, logits.shape[-1]) + logits, -1)
