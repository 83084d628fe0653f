"""JAX's counter-based random stream (threefry2x32), bit for bit, in torch.

The relational ops of the JAX package draw their row masks from
``jax.random`` (``sample``, ``sample_by``, ``random_split``): one threefry
hash of each row's index under the seed's key. With
``jax_threefry_partitionable`` on (the default of current JAX) element i of
a draw of shape (n,) is ``threefry2x32(key, (0, i))``, the two output words
xor-ed, so the first n draws of any longer shape are the draws of shape
(n,): a table padded to another row count gets the same draws on its rows.
This module computes the same words, so a seeded split keeps the same rows
as the reference on the CPU and on the card.

PyTorch has few uint32 ops, so the words are uint32 values held in int64 and
masked after each add and shift (as ``ops/hashing._mul32`` does); the hash
needs no product. ``PRNGKey`` forms the key as JAX does with 64-bit ints off
(the reference's setting): the seed wrapped to 32 bits, high word 0.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PRNGKey", "bernoulli", "random_bits", "uniform"]

_U32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as two uint32 words (host integers):
    with 64-bit ints off JAX converts the seed to int32 first, so the high
    word is 0 and the low word the seed modulo 2^32."""
    return 0, int(seed) & _U32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _U32


def threefry2x32(key: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 hash (20 rounds) of the word pairs (x0, x1), uint32
    values in int64 tensors, under ``key``; returns the two output words."""
    k0, k1 = (int(k) & _U32 for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def _numel(shape) -> tuple[tuple[int, ...], int]:
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (int(shape),)
    return shape, int(np.prod(shape, dtype=np.int64))


def random_bits(key: tuple[int, int], shape, device) -> torch.Tensor:
    """32 random bits an element (uint32 in int64), element i of the flat
    shape the xor of the hash's words for the counter pair (hi(i), lo(i))."""
    shape, n = _numel(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, i >> 32, i & _U32)
    return (b0 ^ b1).reshape(shape)


def uniform(key: tuple[int, int], shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1), the top 23
    bits of each word as the mantissa of a float in [1, 2), less 1."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def bernoulli(key: tuple[int, int], p: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` with ``p``
    rounded to float32."""
    return uniform(key, shape, device) < float(np.float32(p))
