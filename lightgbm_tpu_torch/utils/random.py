"""The counter-based random numbers of the JAX package's samplers.

The JAX package draws its bagging masks and its GOSS keep decisions with
``jax.random`` (threefry2x32, with ``jax_threefry_partitionable`` on).
This module reproduces those draws bit for bit in PyTorch, so that the
port keeps exactly the rows the JAX package keeps from the same seeds:

* a key is a pair of 32-bit words; the key of seed ``s`` is ``(0, s)``
  (:func:`prng_key`);
* element ``i`` of a draw feeds the counter ``(i >> 32, i & 0xFFFFFFFF)``
  through :func:`threefry2x32` under the key;
* :func:`split` row ``j`` is the output pair of counter ``j``;
* :func:`bits` is the two output words XORed;
* :func:`uniform` takes the top 23 bits of :func:`bits` as the mantissa
  of a float in [1, 2), minus 1.

Keys stay on the host as Python ints (a split is two counters); a draw
runs on the caller's device.  torch's ``uint32`` lacks most arithmetic
on CUDA, so the words are held in ``int64`` and masked to 32 bits after
every add and rotate.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..device import DeviceLike

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011; the JAX
    ``threefry_2x32``) of the counter words ``x0``, ``x1`` (int64
    tensors of values below 2^32) under ``key``; returns the two output
    words, int64 below 2^32."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """The key of ``seed`` (``jax.random.PRNGKey``): ``(0, seed)`` for a
    seed below 2^32; a wider seed puts its high word first."""
    seed = int(seed)
    return ((seed >> 32) & _MASK, seed & _MASK)


def _counters(n: int, device: DeviceLike):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _MASK


def split(key: Key, num: int = 2) -> List[Key]:
    """``num`` new keys from ``key`` (``jax.random.split``)."""
    hi, lo = _counters(num, "cpu")
    y0, y1 = threefry2x32(key, hi, lo)
    return [(int(a), int(b)) for a, b in zip(y0.tolist(), y1.tolist())]


def bits(key: Key, n: int, device: DeviceLike = None) -> torch.Tensor:
    """[n] random 32-bit words as int64 in [0, 2^32) on ``device``
    (``jax.random.bits(key, (n,), uint32)``)."""
    y0, y1 = threefry2x32(key, *_counters(n, device))
    return y0 ^ y1


def uniform(key: Key, n: int, device: DeviceLike = None) -> torch.Tensor:
    """[n] f32 uniforms in [0, 1) on ``device``
    (``jax.random.uniform(key, (n,))``)."""
    one = ((bits(key, n, device) >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(one.view(torch.float32) - 1.0, 0.0)


ROW_BUCKET_BITS = 5


def bucket_rows(n: int, bits: int = ROW_BUCKET_BITS) -> int:
    """The JAX package's row bucket of ``n`` rows (its
    ``utils/compile_cache.bucket_rows``): the next multiple of
    ``2^(bitlen(n-1) - bits)`` at or above ``n``.  The JAX package pads
    its training rows up to it under ``row_buckets``, and its bagging
    and GOSS draws cover the padded rows; the port keeps no padded rows
    but draws as many words, so that its draws equal the JAX package's."""
    n = int(n)
    if n <= 1:
        return max(n, 0)
    step = 1 << max((n - 1).bit_length() - int(bits), 0)
    return -(-n // step) * step
