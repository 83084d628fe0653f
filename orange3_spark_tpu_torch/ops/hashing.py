"""Feature hashing on the device — the Criteo-scale categorical path.

Raw categorical codes go to the device as one [N, C] array (4 bytes a
cell, no per-cell host work), and the murmur3 32-bit finalizer runs there
as a handful of vector integer ops before the embedding gather that
consumes the indices.

PyTorch has few uint32 ops, so the hash works on uint32 values held in
int64. A 32-bit product h * c (h, c < 2^32) can pass 2^63, so it is taken
in two halves of c, h * c_lo + ((h * c_hi) mod 2^16) * 2^16, each under
2^49: nothing overflows, and the result is the uint32 product bit for bit.
``hash_columns_np`` is the numpy twin the host-side plan builder uses; the
two must agree bitwise, or a step would update the wrong table rows.

``n_dims`` must be a power of two so the bucket map is a bit-mask.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

__all__ = ["STRING_CODE_MASK", "column_salts", "hash_columns",
           "hash_columns_np", "salts_tensor", "strings_to_u32", "to_index"]

_U32 = 0xFFFFFFFF
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35


def _check_dims(n_dims: int) -> None:
    if n_dims < 1 or n_dims & (n_dims - 1):
        raise ValueError(f"n_dims must be a power of two, got {n_dims}")


def column_salts(n_columns: int, seed: int = 0) -> np.ndarray:
    """Per-column uint32 salts: the same raw code in different columns lands
    in different buckets (a salt is xor-ed into the code)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=n_columns, dtype=np.uint32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for uint32 values h held in int64, without
    overflowing int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def to_index(x: torch.Tensor) -> torch.Tensor:
    """A float tensor as int32 the way XLA converts it (the JAX package's
    ``.astype(jnp.int32)`` of a float column): toward zero, NaN to 0,
    saturating at the int32 limits (+-inf too). PyTorch's own conversion
    gives INT_MIN for NaN and out-of-range values on the CPU and is
    undefined for them on CUDA, so every float key or code of the port
    becomes an index through this."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-2.0**31, 2.0**31).to(torch.int64)
    return x.clamp(-(2**31), 2**31 - 1).to(torch.int32)


def hash_columns(cats: torch.Tensor, salts, n_dims: int) -> torch.Tensor:
    """[N, C] integer categorical codes -> [N, C] int32 bucket indices in
    [0, n_dims). ``cats`` may be any integer dtype or float32 holding exact
    integers (the CSV parser yields float32; ints < 2^24 are exact).
    ``salts``: [C] uint32 (numpy) or the int64 tensor of ``salts_tensor``.

    A float code converts to int32 as XLA converts it in the reference's
    device hash, and as CUDA does: toward zero, NaN to 0, saturating at the
    int32 range (the CPU's plain conversion gives INT_MIN for all three)."""
    _check_dims(n_dims)
    if not isinstance(salts, torch.Tensor):
        salts = salts_tensor(salts, cats.device)
    c = to_index(cats) if cats.is_floating_point() else cats.to(torch.int32)
    h = c.to(torch.int64) & _U32   # negatives wrap to uint32
    h = h ^ salts[None, :]
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    return (h & (n_dims - 1)).to(torch.int32)


def salts_tensor(salts: np.ndarray, device) -> torch.Tensor:
    """uint32 salts as the int64 tensor ``hash_columns`` xors in."""
    return torch.as_tensor(np.asarray(salts, np.uint32).astype(np.int64),
                           device=device)


def hash_columns_np(cats: np.ndarray, salts: np.ndarray, n_dims: int) -> np.ndarray:
    """Host twin of ``hash_columns``: the same buckets, bit for bit. It
    works in place on its one uint32 copy of the codes (uint32 products
    wrap mod 2^32 in numpy), the hot loop of a packed cache's encode."""
    _check_dims(n_dims)
    h = np.asarray(cats).astype(np.int32).view(np.uint32)   # a fresh copy
    h ^= np.asarray(salts, np.uint32)[None, :]
    h ^= h >> np.uint32(16)
    h *= np.uint32(_M1)
    h ^= h >> np.uint32(13)
    h *= np.uint32(_M2)
    h ^= h >> np.uint32(16)
    h &= np.uint32(n_dims - 1)
    return h.view(np.int32)


#: String codes are masked to 24 bits, so they survive a float32 round trip
#: exactly (float32 has a 24-bit mantissa): the chunk pipeline carries
#: categorical codes in one f32 array. The native parser's categorical mode
#: (``native/fastcsv.cpp``, ``fcsv_set_categorical``) applies the same crc32
#: and mask, so the host and native on-ramps give the same codes.
STRING_CODE_MASK = 0x00FFFFFF


def strings_to_u32(arr) -> np.ndarray:
    """Stable uint32 codes for string categories (real Criteo's hex
    strings): ``crc32 & STRING_CODE_MASK`` of each value's UTF-8 bytes
    (Python's ``hash()`` is salted per process, useless for checkpoints).
    One crc32 a distinct value, so the cost follows the cardinality."""
    arr = np.asarray(arr)
    uniq, inv = np.unique(arr, return_inverse=True)
    codes = np.fromiter((zlib.crc32(str(u).encode()) & STRING_CODE_MASK for u in uniq),
                        dtype=np.uint32, count=len(uniq))
    return codes[inv].reshape(arr.shape)
