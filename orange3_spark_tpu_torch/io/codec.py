"""Compressed chunk codec — the precision of the chunk cache, the disk
spill and the host-to-device copies.

A cached Criteo chunk in float32 is 41 columns × 4 bytes a row. Most of
that is waste: the label is 0 or 1, the hashed indices need
log2(n_dims) bits, and the dense numerics survive bfloat16. This module
holds the primitives of the compressed layouts; ``models/hashed_linear``
owns the chunk layout built from them, and the step widens the chunk on
the device, so the math stays float32.

Three cache dtypes, resolved once at fit entry:

* ``'f32'``    — float32 chunks as parsed, bit for bit.
* ``'bf16'``   — the dense block stored bfloat16 (round to nearest even,
  relative error at most 2^-8); the label stored uint8 where it is an
  exact class id; categorical codes stay float32.
* ``'packed'`` — bf16 plus lossless bit packing: the categorical columns
  are hashed on the host and their indices stored at ``bit_width(n_dims)``
  bits, and the sparse optimizer's plan arrays at their static widths.

bfloat16 on the host: numpy has no bfloat16, so the encode works on the
bits (``bf16_bits_np``): the float32 word rounded to its upper 16 bits,
to nearest, ties to even, carried as uint16 wherever numpy holds it (the
spill, the field specs). NaN keeps its sign and becomes the quiet NaN
0x7FC0 / 0xFFC0, as the JAX package's encode writes it. The device
widens with ``bf16_to_f32``, exactly.

Bit-packing layouts (static shifts and masks, decoded on the device):

* per-row: ``[N, C]`` values at ``b`` bits -> ``[N, ceil(C*b/32)]`` u32
  words. Row-aligned, so a chunk's rows stay rows.
* flat: ``[n]`` values at ``b`` bits -> ``flat_words(n, b)`` u32 words in
  planes of 16/8/4/2/1 bits (``_planes``), so no field crosses a word.

PyTorch has no full uint32 arithmetic and its int32 ``>>`` is arithmetic,
so words travel as int32 (their bits unchanged) and are unpacked in int64,
where every shift is logical.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

__all__ = [
    "CACHE_DTYPES", "SpillCorruptionError", "resolve_cache_dtype",
    "force_cache_dtype", "bf16_bits_np", "bf16_to_f32", "bit_width",
    "pack_rows_np", "unpack_rows", "pack_flat_np", "flat_words", "unpack_flat",
]

CACHE_DTYPES = ("f32", "bf16", "packed")
_U32 = 0xFFFFFFFF


class SpillCorruptionError(RuntimeError):
    """A spill record failed its integrity check (CRC mismatch, a truncated
    tail). Raised by ``io.streaming.DiskChunkCache`` naming the record
    ordinal, so a corrupted record never decodes into a replay. Version-2
    spill files carry a CRC32 per record; ``OTPU_RESILIENCE=0`` skips the
    check, and files of versions 0 and 1 have none to check."""


def resolve_cache_dtype(value: str, session=None) -> str:
    """The cache dtype of a fit, resolved once at its entry.

    ``OTPU_CACHE_DTYPE``, when set, overrides the parameter (``=f32``
    restores float32 chunks whatever the caller asked for). ``'auto'`` is
    the session's ``default_cache_dtype`` ('packed')."""
    env = os.environ.get("OTPU_CACHE_DTYPE", "")
    if env:
        value = env
    if value == "auto":
        if session is None:
            from orange3_spark_tpu_torch.core.session import TorchSession

            session = TorchSession.active()
        value = session.default_cache_dtype
    if value not in CACHE_DTYPES:
        raise ValueError(
            f"cache_dtype must be one of {CACHE_DTYPES} or 'auto', got {value!r}")
    return value


@contextlib.contextmanager
def force_cache_dtype(value: str):
    """Pin the resolver for one A/B arm: the environment override outranks
    the parameter, so an arm pins itself through it, and the ambient value
    comes back afterwards."""
    old = os.environ.get("OTPU_CACHE_DTYPE")
    os.environ["OTPU_CACHE_DTYPE"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("OTPU_CACHE_DTYPE", None)
        else:
            os.environ["OTPU_CACHE_DTYPE"] = old


def bf16_bits_np(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16), rounded to nearest, ties to even.
    Overflow rounds to infinity, subnormals round like any other value and
    NaN becomes the quiet NaN of its sign (0x7FC0 / 0xFFC0)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) >> np.uint32(16)
    nan = np.isnan(np.ascontiguousarray(x, np.float32))
    if nan.any():
        r = np.where(nan, np.where(u >> np.uint32(31) != 0, np.uint32(0xFFC0),
                                   np.uint32(0x7FC0)), r)
    return r.astype(np.uint16)


def bf16_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """bfloat16 bits (a 16-bit integer tensor) -> float32, exactly."""
    return bits.view(torch.bfloat16).to(torch.float32)


def bit_width(n_values: int) -> int:
    """Bits needed to hold values ``0 .. n_values-1`` (at least 1)."""
    return max(1, int(n_values - 1).bit_length())


def _check_bits(bits: int) -> int:
    if not 1 <= bits <= 31:
        raise ValueError(f"pack bit width must be in [1, 31], got {bits}")
    return (1 << bits) - 1


def pack_rows_np(vals: np.ndarray, bits: int) -> np.ndarray:
    """Host per-row pack: ``[N, C]`` unsigned values at ``bits`` bits each
    -> ``[N, ceil(C*bits/32)]`` u32 words. High bits beyond ``bits`` are
    dropped: callers pack statically bounded values."""
    mask = np.uint32(_check_bits(bits))
    # column-major while packing, so each column and word is contiguous
    vals = np.asarray(vals).astype(np.uint32).T.copy()
    vals &= mask
    C, N = vals.shape
    W = -(-(C * bits) // 32)
    words = np.zeros((W, N), np.uint32)
    for c in range(C):
        bitpos = c * bits
        w0, off = bitpos // 32, bitpos % 32
        words[w0] |= vals[c] << np.uint32(off)
        if off + bits > 32:
            words[w0 + 1] |= vals[c] >> np.uint32(32 - off)
    return np.ascontiguousarray(words.T)


def _as_u32_int64(words: torch.Tensor) -> torch.Tensor:
    """u32 words held in any 32-bit integer dtype -> int64 in [0, 2^32)."""
    return words.to(torch.int64) & _U32


def unpack_rows(packed: torch.Tensor, bits: int, n_cols: int) -> torch.Tensor:
    """Device inverse of ``pack_rows_np``: ``[N, W]`` words (int32 or
    uint32 bits) -> ``[N, n_cols]`` int32. Column c starts at bit c·bits:
    one gather of each column's first word, one of the next word (for the
    fields that cross into it), two shifts and a mask, over all columns
    at once. The index and shift vectors are made on the device, so the
    decode copies nothing from the host and can be captured in a graph."""
    mask = _check_bits(bits)
    N, W = packed.shape
    if n_cols == 0:
        return torch.zeros((N, 0), dtype=torch.int32, device=packed.device)
    w = _as_u32_int64(packed)
    bitpos = torch.arange(n_cols, dtype=torch.int64, device=packed.device) * bits
    w0, off = bitpos // 32, bitpos % 32
    w1 = torch.clamp(w0 + 1, max=W - 1)
    lo = w.index_select(1, w0) >> off
    # the next word's low bits land at 32 - off >= bits for a field that
    # does not cross, so the mask drops them; masking to 31 bits first
    # keeps the shifted value inside int64
    hi = (w.index_select(1, w1) & 0x7FFFFFFF) << (32 - off)
    return ((lo | hi) & mask).to(torch.int32)


def _planes(bits: int) -> tuple:
    """A bit width as plane widths from {16, 8, 4, 2, 1}: within a plane
    every field sits in one u32 word. Fewer planes beat an exact bit count
    (each plane is a pass at decode): a width may round up by at most 2
    bits when that removes a plane (23 stores as 16 + 8)."""
    best = None
    for m in range(32):                        # subsets of {16, 8, 4, 2, 1}
        sizes = tuple(s for i, s in enumerate((16, 8, 4, 2, 1)) if m & (1 << i))
        total = sum(sizes)
        if bits <= total <= bits + 2:
            key = (len(sizes), total)
            if best is None or key < best[0]:
                best = (key, sizes)
    return best[1]


def pack_flat_np(vals: np.ndarray, bits: int) -> np.ndarray:
    """Host flat pack: ``[n]`` unsigned values at ``bits`` bits each ->
    ``flat_words(n, bits)`` u32 words. A value's bits split over the
    ``_planes``; the plane of width s holds 32/s consecutive values' s-bit
    fields per word. ``bits=1`` is a bit array."""
    mask = np.uint32(_check_bits(bits))
    vals = np.asarray(vals).astype(np.uint32) & mask
    n = vals.shape[0]
    n_pad = -(-n // 32) * 32
    if n_pad != n:
        vals = np.concatenate([vals, np.zeros(n_pad - n, np.uint32)])
    parts = []
    bit_ofs = 0
    for s in _planes(bits):
        k = 32 // s
        f = ((vals >> np.uint32(bit_ofs)) & np.uint32((1 << s) - 1)).reshape(-1, k)
        w = np.zeros(f.shape[0], np.uint32)
        for pos in range(k):
            w |= f[:, pos] << np.uint32(pos * s)
        parts.append(w)
        bit_ofs += s
    return np.concatenate(parts) if parts else np.zeros((0,), np.uint32)


def flat_words(n: int, bits: int) -> int:
    """u32 words ``pack_flat_np`` emits for ``n`` values at ``bits`` bits."""
    return -(-n // 32) * sum(_planes(bits))


def unpack_flat(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Device inverse of ``pack_flat_np``: ``[flat_words(n, bits)]`` words
    -> ``[n]`` int32, one broadcast shift and mask per plane."""
    _check_bits(bits)
    planes = _planes(bits)
    w_all = _as_u32_int64(packed)
    n_pad = (packed.shape[0] // sum(planes)) * 32
    acc = None
    word_ofs = bit_ofs = 0
    for s in planes:
        k = 32 // s
        nw = n_pad // k
        w = w_all[word_ofs:word_ofs + nw]
        shifts = torch.arange(k, dtype=torch.int64, device=packed.device) * s
        part = ((w[:, None] >> shifts[None, :]) & ((1 << s) - 1)).reshape(n_pad) << bit_ofs
        acc = part if acc is None else acc | part
        word_ofs += nw
        bit_ofs += s
    return acc[:n].to(torch.int32)
