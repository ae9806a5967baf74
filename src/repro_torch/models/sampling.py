"""The reference's sampler in plain torch: JAX's threefry-2x32 PRNG, as
far as ``jax.random.categorical(fold_in(fold_in(key, uid), pos),
logits)`` needs it, so that a tempered serve of the port draws the same
tokens as the JAX engine for the same (seed, request uid, position).

Follows ``jax._src.prng`` / ``jax._src.random`` (JAX 0.9, with
``jax_threefry_partitionable`` on, its default):

* a key is the pair of uint32 words ``(k1, k2)``; ``prng_key(seed)`` is
  ``(0, seed)`` for a 32-bit seed, as ``jax.random.PRNGKey``;
* ``fold_in(key, d)`` hashes the count pair ``(0, d)`` under ``key``;
* ``random_bits(key, n)`` hashes the counters ``(0, i)``, ``i < n``, and
  returns ``bits1 ^ bits2`` (the partitionable layout);
* ``uniform`` keeps the top 23 bits as a mantissa of exponent 0,
  subtracts 1 and clamps at ``tiny``; ``gumbel`` (mode "low") is
  ``-log(-log(u))``; ``categorical`` is the argmax of gumbel + logits.

Keys are int64 tensors whose last axis holds ``(k1, k2)``; every uint32
word lives in an int64 masked to 32 bits, so the same elementwise ops
run on the CPU and on the card and draw identical bits on both. Nothing
here reads a device value on the host: a draw is a fixed sequence of
elementwise kernels.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)
_ONE_BITS = 0x3F800000          # float32 1.0


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The threefry-2x32 hash (20 rounds) of the count pairs ``(x0, x1)``
    under the key ``(k1, k2)``; all four broadcast together -> the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` -> int64 [2]."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed must fit in 32 bits, got {seed}")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``key`` [..., 2], ``data`` an
    integer tensor (or int) broadcasting with ``key[..., 0]`` -> keys
    [..., 2]. ``data`` is taken modulo 2**32, as JAX's uint32 cast."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o0, o1], -1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per entry: ``key`` [..., 2] -> int64 [..., n] in
    [0, 2**32), as ``jax.random.bits(key, (n,), uint32)`` for each key."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(count), count)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """float32 [..., n] in [tiny, 1), as ``jax.random.uniform(key, (n,),
    minval=tiny)`` (the draw ``gumbel`` makes)."""
    mant = (random_bits(key, n) >> 9) | _ONE_BITS
    u = mant.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(u + _TINY, _TINY)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel noise [..., n], ``jax.random.gumbel`` mode "low"."""
    return -torch.log(-torch.log(uniform(key, n)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` [..., V] under its own key
    [..., 2] -> int64 [...]: ``jax.random.categorical`` (the Gumbel-max
    trick, first index on ties)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
