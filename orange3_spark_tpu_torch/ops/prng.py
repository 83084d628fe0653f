"""JAX's counter-based random stream (threefry2x32) and its draws, in torch.

The JAX package draws every seeded fit and every random row mask from
``jax.random``: the forest's Poisson bootstrap and feature masks, GBT's
subsample, ALS's and the MLP's initial weights, FM's factors, KMeans'
device init, CrossValidator's fold ids, and the relational ops' ``sample``,
``sample_by``, ``random_split`` and ``train_test_split``. This module forms
each draw as ``jax/_src/random.py`` does, with ``jax_threefry_partitionable``
on (the default of current JAX): element i of a draw of shape s is
``threefry2x32(key, (hi(i), lo(i)))`` for i its flat index, the two output
words xor-ed, so the first n draws of any longer shape are the draws of
shape (n,): a table padded to another row count gets the same draws on its
rows, and a seed gives the reference's model.

Keys are host integers, a pair of uint32 words: ``PRNGKey`` forms it as JAX
does with 64-bit ints off (the seed wrapped to 32 bits, high word 0), and
``split`` derives keys on the host (numpy) without waiting for the device.
Only the draws touch the device. On a CUDA tensor the words come from the
``threefry_bits`` kernel of ``csrc/prng.cu`` and Poisson counts from its
``poisson_knuth`` kernel; on the CPU from the plain versions here
(``threefry2x32``: uint32 values held in int64 and masked after each add
and shift; ``poisson_reference``: Knuth's loop over the whole batch). A
failed build or launch raises.

Which draws are bitwise the reference's: ``split``, ``random_bits``,
``uniform`` (the bounded form's fused multiply-add taken as one float64
product and sum, rounded once), ``bernoulli``, ``randint``, ``categorical``,
``poisson`` (its ``log`` is ``torch.log`` / the kernel's ``logf``, which
gave JAX's counts on every lane tested) and
``gumbel`` (its logs are XLA's float32 ``log``, written out). ``normal``
writes out XLA's float32 ``erf_inv`` polynomial, each step in FMA form,
over XLA's ``log1p``: within 2 ulp of JAX's (about 2 draws in 100,000
differ at all).
These are plain tensor ops, the same bits on the CPU and the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import numpy as np
import torch

from orange3_spark_tpu_torch.core.fmath import sqrt32
from orange3_spark_tpu_torch.ops import cuda_build

__all__ = ["GUMBEL_BUCKETS", "PRNGKey", "bernoulli", "categorical", "categorical_gumbel",
           "categorical_gumbel_reference", "gumbel", "gumbel_bucket", "gumbel_bucket_table",
           "gumbel_values", "normal", "poisson",
           "poisson_knuth", "poisson_reference", "randint", "random_bits", "split",
           "threefry2x32", "threefry_bits", "threefry_bits_reference", "uniform"]

_U32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the wrapper of ``poisson_knuth`` hands the kernel each tree's split
#: chain for as many iterations as a count runs past with probability
#: below this (``chain_table_size``); a lane past the table splits on in
#: the thread
CHAIN_PAST_P = 1e-9
#: rows of one tree a block of ``poisson_knuth`` owns (shorter tiles lose
#: more lane-slots to each tile's tail, also where they fill a short grid:
#: probes/poisson_knuth_ab.py --tiles)
KNUTH_TILE_ROWS = 8192
_F32_TINY = float(np.finfo(np.float32).tiny)
# XLA's float32 exp on the CPU (Cephes' expf): the clamp, log2(e), ln 2 in
# two parts (C1 + C2), p0..p5
_EXP_LO, _EXP_HI = 88.3762626647949, 88.72283935546875
_EXP_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3, 4.1665795894E-2,
          1.6666665459E-1, 5.0000001201E-1)
# XLA's float32 log on the CPU (Cephes' logf, as Eigen's plog): p0..p8, q1, q2
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# XLA's log1p for |x| < sqrt(2) - 1 (Cephes): x - x²/2 + x³·N(x)/D(x)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# XLA's float32 erf_inv (ErfInv32): the coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as two uint32 words (host integers):
    with 64-bit ints off JAX converts the seed to int32 first, so the high
    word is 0 and the low word the seed modulo 2^32."""
    return 0, int(seed) & _U32


# ------------------------------------------------------------ the hash
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


def _hash_np(k0, k1, x0, x1):
    """``threefry2x32`` on numpy uint32 arrays (keys may be arrays too,
    broadcast against the counters); numpy's uint32 adds wrap."""
    k0, k1, x0, x1 = (np.asarray(a, dtype=np.uint32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)``: key j is the hash of the counter pair
    (0, j) under ``key`` (host integers, no device work)."""
    j = np.arange(num, dtype=np.uint32)
    y0, y1 = _hash_np(key[0], key[1], np.zeros_like(j), j)
    return [(int(a), int(b)) for a, b in zip(y0, y1)]


def _split_chains(keys: list[tuple[int, int]], n: int):
    """The first ``n`` subkeys of each key's chain ``rng, sub = split(rng)``
    (u32[T, n, 2]) and each chain's key after them (u32[T, 2]): the plain
    version of the library's ``knuth_chain_table``."""
    r0 = np.array([k[0] for k in keys], dtype=np.uint32)
    r1 = np.array([k[1] for k in keys], dtype=np.uint32)
    T = r0.shape[0]
    table = np.empty((T, n, 2), dtype=np.uint32)
    lo = np.repeat(np.array([0, 1], dtype=np.uint32)[None], T, 0)     # [T, 2]
    for j in range(n):
        y0, y1 = _hash_np(r0[:, None], r1[:, None], np.zeros_like(lo), lo)
        table[:, j, 0], table[:, j, 1] = y0[:, 1], y1[:, 1]
        r0, r1 = y0[:, 0], y1[:, 0]
    return table, np.stack([r0, r1], axis=1)


def _numel(shape) -> tuple[tuple[int, ...], int]:
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (int(shape),)
    return shape, int(np.prod(shape, dtype=np.int64))


# ------------------------------------------------------------ the kernels
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("prng")
    if lib.threefry_bits_launch.argtypes is None:
        p, i, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
        lib.threefry_bits_launch.argtypes = [u, u, ll, p, i, p]
        lib.threefry_bits_launch.restype = i
        lib.poisson_knuth_launch.argtypes = [p, p, i, ll, ll, ctypes.c_float, i, p, p, i, p]
        lib.poisson_knuth_launch.restype = i
        lib.knuth_chain_table.argtypes = [p, ll, i, p]
        lib.knuth_chain_table.restype = i
        lib.categorical_gumbel_launch.argtypes = [u, u, p, ll, ll, ll, p, p, p, i, p]
        lib.categorical_gumbel_launch.restype = i
        lib.gumbel_values_launch.argtypes = [p, i, p]
        lib.gumbel_values_launch.restype = i
        lib.prng_error_string.argtypes = [i]
        lib.prng_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(name: str, *args, dev) -> None:
    lib = _lib()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    here = index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(index):
        stream = torch._C._cuda_getCurrentRawStream(index)
        err = getattr(lib, f"{name}_launch")(*args, _sms(index), stream)
    if err != 0:
        msg = lib.prng_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")


def threefry_bits_reference(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """The plain version of ``threefry_bits``: the words as int32 bit
    patterns, from ``threefry2x32`` over int64 tensors."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, i >> 32, i & _U32)
    return (b0 ^ b1).to(torch.int32)


def threefry_bits(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """Element i (i < n) of the draw under ``key``: the xor of the hash's
    words for the counter pair (hi(i), lo(i)), as an int32 bit pattern
    (i32[n]). A CUDA device launches the kernel, the CPU the plain
    version."""
    device = torch.device(device)
    if device.type != "cuda":
        return threefry_bits_reference(key, n, device)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        _launch("threefry_bits", int(key[0]) & _U32, int(key[1]) & _U32, n,
                out.data_ptr(), dev=device)
        threefry_bits.launches += 1
    return out


#: kernel launches (one a call); counted where the kernel launches and
#: nowhere else
threefry_bits.launches = 0


def _uniform01(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) from bit patterns: the top 23 bits as the mantissa of a float
    in [1, 2), less 1 (exact)."""
    f = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    return f.view(torch.float32) - 1.0


# ------------------------------------------------------------ the draws
def random_bits(key: tuple[int, int], shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: 32 random bits an element,
    as uint32 values in int64."""
    shape, n = _numel(shape)
    return (threefry_bits(key, n, device).to(torch.int64) & _U32).reshape(shape)


def uniform(key: tuple[int, int], shape, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: f32 in
    [minval, maxval). JAX forms ``floats * (maxval - minval) + minval`` with
    the bounds rounded to float32 first, and XLA contracts it into a fused
    multiply-add: here the float64 product (exact) and sum, rounded once;
    then ``max(minval, ·)``."""
    shape, n = _numel(shape)
    floats = _uniform01(threefry_bits(key, n, device))
    lo, hi = np.float32(minval), np.float32(maxval)
    if lo == 0.0 and hi == 1.0:     # floats * 1 + 0: the floats themselves
        return floats.reshape(shape)
    span = float(hi - lo)
    out = (floats.to(torch.float64) * span + float(lo)).to(torch.float32)
    return torch.clamp_min(out, float(lo)).reshape(shape)


def bernoulli(key: tuple[int, int], p: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` with ``p``
    rounded to float32."""
    return uniform(key, shape, device) < float(np.float32(p))


def randint(key: tuple[int, int], shape, minval: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two words
    an element from ``split(key)``, ``(hi % span) · (2^32 % span) + lo %
    span`` in JAX's uint32 arithmetic (each product and sum wrapping),
    modulo span, plus minval. maxval <= minval gives minval."""
    shape, n = _numel(shape)
    i32 = np.iinfo(np.int32)
    out_of_range = maxval > i32.max
    lo_v = min(max(int(minval), i32.min), i32.max)
    hi_v = min(max(int(maxval), i32.min), i32.max)
    span = (hi_v - lo_v) & _U32
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & _U32
    k1, k2 = split(key)
    higher = threefry_bits(k1, n, device).to(torch.int64) & _U32
    lower = threefry_bits(k2, n, device).to(torch.int64) & _U32
    if span == 0:       # the full 2^32 range: XLA's x % 0 is x, so lower
        offset = lower
    else:
        mult = (1 << 16) % span
        mult = ((mult * mult) & _U32) % span
        offset = (((higher % span) * mult) & _U32) + lower % span
        offset = (offset & _U32) % span
    val = (offset + lo_v) & _U32
    return torch.where(val > i32.max, val - (1 << 32), val).to(torch.int32).reshape(shape)


def _fma32(a, b, c) -> torch.Tensor:
    """float32 a·b + c rounded once (float64 product, exact, and sum); a
    Python float operand is a float32 constant."""
    def wide(v):
        return v.to(torch.float64) if torch.is_tensor(v) else float(np.float32(v))
    return (wide(a) * wide(b) + wide(c)).to(torch.float32)


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` as it runs on the CPU (the reference's device
    here): Cephes' logf, the mantissa in [√½, √2) and a degree-8
    polynomial, every multiply-add fused as LLVM contracts it; 0 and a
    denormal give -inf (XLA flushes denormals), +inf gives +inf, a negative
    or NaN input NaN. Bitwise ``jnp.log`` on the CPU, on either device
    (torch's own log differs from it in ~10 % of values)."""
    xi = torch.clamp_min(x, float(np.finfo(np.float32).tiny))
    bits = xi.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)    # in [0.5, 1)
    low = m < float(np.float32(0.707106781186547524))
    e = e - low.to(torch.float32)
    t = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = t * t
    x3 = x2 * t
    P = _LOG_P
    t64, x3_64 = t.to(torch.float64), x3.to(torch.float64)     # widened once (exact)
    y = _fma32(_fma32(t64, P[0], P[1]), t64, P[2])
    y1 = _fma32(_fma32(t64, P[3], P[4]), t64, P[5])
    y2 = _fma32(_fma32(t64, P[6], P[7]), t64, P[8])
    y = _fma32(_fma32(_fma32(y, x3_64, y1), x3_64, y2), x3_64, float(np.float32(_LOG_Q1)) * e)
    t = (t - 0.5 * x2) + y
    out = _fma32(_LOG_Q2, e, t)
    out = torch.where((x >= 0) & (x < float(np.finfo(np.float32).tiny)), -math.inf, out)
    out = torch.where(x == math.inf, math.inf, out)
    return torch.where((x < 0) | torch.isnan(x), math.nan, out)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: for |x| below √2 - 1 the rational form x -
    x²/2 + x³·N(x)/D(x) (Horner with fused multiply-adds), else XLA's log
    of 1 + x. Bitwise ``jnp.log1p`` on the CPU."""
    xs = x * x
    num, den = (torch.full_like(x, float(np.float32(c[0]))) for c in (_LOG1P_NUM, _LOG1P_DEN))
    for a, b in zip(_LOG1P_NUM[1:], _LOG1P_DEN[1:]):
        num, den = _fma32(num, x, a), _fma32(den, x, b)
    small = x + _fma32(-0.5, xs, (x * xs) * (num / den))
    return torch.where(x.abs() < float(np.float32(0.41421356237309504880)), small,
                       _xla_log(x + 1.0))


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``exp`` as it runs on the CPU: Cephes' expf, every
    multiply-add fused (``_fma32``'s form). x is clamped to [-88.376...,
    88.722...], n = min(floor(x·log2(e) + 0.5), 127), r = x - n·ln 2 in two
    parts, a degree-5 polynomial p with y = p·r² + r + 1, then y·2^n; a
    result below float32's smallest normal is 0 (XLA flushes denormals),
    x above the clamp gives +inf, NaN stays NaN. Bitwise ``jnp.exp`` on the
    CPU, on either device (torch's own exp differs from it in ~10 % of
    values)."""
    hi = float(np.float32(_EXP_HI))
    xc = torch.clamp(x, float(np.float32(-_EXP_LO)), hi)
    n = torch.clamp_max(torch.floor(_fma32(xc, _EXP_LOG2E, 0.5)), 127.0)
    r = _fma32(n, -_EXP_C1, xc)
    r = _fma32(n, -_EXP_C2, r)
    r64 = r.to(torch.float64)                                  # widened once (exact)
    y = torch.full_like(r, float(np.float32(_EXP_P[0])))
    for p in _EXP_P[1:]:
        y = _fma32(y, r64, p)
    y = _fma32(y, r * r, r64) + 1.0
    out = y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = torch.where(out.abs() < _F32_TINY, 0.0, out)
    out = torch.where(x > hi, math.inf, out)
    return torch.where(torch.isnan(x), x, out)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: w = -log1p(-x²) (XLA's log1p); w - 2.5 (w < 5) or √w - 3;
    a degree-8 polynomial in w, each step a fused multiply-add; times x;
    ±1 maps to ±inf (x times XLA's MaxValue, +inf for a float)."""
    w = -_xla_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt32(w) - 3.0)
    p = torch.where(lt, float(np.float32(_ERFINV_LT5[0])),
                    float(np.float32(_ERFINV_GE5[0]))).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, float(np.float32(a)), float(np.float32(b))).to(torch.float64)
        p = _fma32(p, w, c)
    out = p * x
    big = x * math.inf
    return torch.where(x.abs() == 1.0, big, out)


def normal(key: tuple[int, int], shape, device) -> torch.Tensor:
    """``jax.random.normal(key, shape)``: √2 · erf_inv(u), u uniform on
    [nextafter(-1, 0), 1); within 2 ulp of JAX's."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, device, lo, 1.0)
    return float(np.float32(math.sqrt(2.0))) * _erf_inv(u)


def gumbel(key: tuple[int, int], shape, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (mode "low"): -log(-log(u)), u
    uniform on [tiny, 1)."""
    return -_xla_log(-_xla_log(uniform(key, shape, device, _F32_TINY, 1.0)))


def categorical(key: tuple[int, int], logits: torch.Tensor, axis: int = -1,
                shape=None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis, shape)`` with
    replacement: the argmax of a gumbel plus the logits (the first index on
    a tie, as ``jnp.argmax``). Without ``shape`` the gumbel has the logits'
    shape. With ``shape`` the logits are one row of V (f32[V], or [1, V]
    along the last axis) and the draw is JAX's gumbel of shape (*shape, V):
    element (r, v), r the flat index into ``shape``, is the word at r·V +
    v (past 2^32 at real sizes, hence the hi and lo counter words). A CUDA
    device launches ``categorical_gumbel`` (one pass, only the int32
    [*shape] result written), the CPU runs its plain version
    (``categorical_gumbel_reference``)."""
    if shape is None:
        g = gumbel(key, tuple(logits.shape), logits.device)
        return torch.argmax(g + logits, dim=axis)
    V = logits.shape[axis]
    if logits.numel() != V or axis not in (-1, logits.ndim - 1):
        raise ValueError("categorical(shape=...): the logits must be one row of V along the "
                         f"last axis, got shape {tuple(logits.shape)} and axis {axis}")
    shape, n = _numel(shape)
    row = logits.reshape(V).to(torch.float32).contiguous()
    if row.device.type == "cuda":
        return categorical_gumbel(key, row, n).reshape(shape)
    return categorical_gumbel_reference(key, row, n).reshape(shape)


#: elements (rows x V) of one block of ``categorical_gumbel_reference``
CATEGORICAL_BLOCK = 1 << 22


def _uniform_tiny(bits: torch.Tensor) -> torch.Tensor:
    """``uniform``'s float32 on [tiny, 1) from bit patterns (gumbel's)."""
    span = float(np.float32(1.0) - np.float32(_F32_TINY))
    out = (_uniform01(bits).to(torch.float64) * span + _F32_TINY).to(torch.float32)
    return torch.clamp_min(out, _F32_TINY)


def categorical_gumbel_reference(key: tuple[int, int], logits: torch.Tensor, n: int,
                                 first_row: int = 0) -> torch.Tensor:
    """The plain version of ``categorical_gumbel``: i32[n], row r the
    argmax over v of -log(-log(u)) + logits[v], u JAX's uniform on [tiny,
    1) of the word at r·V + v under ``key`` (the logs ``_xla_log``'s form),
    for the rows r from ``first_row`` on (a window of a longer draw).
    Taken a block of rows at a time (``CATEGORICAL_BLOCK`` elements), so it
    never holds the whole [n, V] draw."""
    V = logits.shape[0]
    dev = logits.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    rows = max(1, CATEGORICAL_BLOCK // max(V, 1))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        i = torch.arange((first_row + r0) * V, (first_row + r1) * V, dtype=torch.int64,
                         device=dev)
        b0, b1 = threefry2x32(key, i >> 32, i & _U32)
        g = -_xla_log(-_xla_log(_uniform_tiny((b0 ^ b1).to(torch.int32))))
        out[r0:r1] = torch.argmax(g.reshape(r1 - r0, V) + logits, dim=1).to(torch.int32)
    return out


def categorical_gumbel(key: tuple[int, int], logits: torch.Tensor, n: int,
                       first_row: int = 0) -> torch.Tensor:
    """i32[n]: draws ``first_row`` .. ``first_row + n - 1`` of JAX's
    categorical over one row of V float32 ``logits``, draw r's gumbel words
    at r·V + v under ``key``. A CUDA tensor launches the kernel of
    ``csrc/prng.cu`` (a warp a draw; an element whose gumbel bound,
    ``gumbel_bucket_table``, leaves it below the draw's best skips the logs;
    bitwise the plain version); a CPU tensor runs the plain version."""
    if logits.device.type != "cuda":
        return categorical_gumbel_reference(key, logits, n, first_row)
    if logits.dtype != torch.float32 or logits.ndim != 1 or not logits.is_contiguous():
        raise ValueError("categorical_gumbel: logits must be a contiguous float32 [V] tensor, "
                         f"got {logits.dtype} {tuple(logits.shape)}")
    out = torch.empty(n, dtype=torch.int32, device=logits.device)
    if n and logits.shape[0]:
        _launch_categorical(key, logits, first_row, out)
        categorical_gumbel.launches += 1
    return out


def _launch_categorical(key: tuple[int, int], logits: torch.Tensor, first_row: int,
                        out: torch.Tensor, counts: torch.Tensor | None = None) -> None:
    """One launch of ``categorical_gumbel`` into ``out`` (i32[n]; uncounted:
    the wrapper counts). ``counts`` (i64[2] on the card) launches the
    measurement build instead, which adds the elements it evaluated and its
    evaluation passes there."""
    _launch("categorical_gumbel", int(key[0]) & _U32, int(key[1]) & _U32, logits.data_ptr(),
            logits.shape[0], out.shape[0], int(first_row),
            gumbel_bucket_table(logits.device).data_ptr(), out.data_ptr(),
            None if counts is None else counts.data_ptr(), dev=logits.device)


#: buckets of ``gumbel_bucket``: codes 0 .. 2944
GUMBEL_BUCKETS = 2945


def gumbel_bucket(bits: torch.Tensor) -> torch.Tensor:
    """i64 bucket of each word (int32 bit patterns), the kernel's map: k =
    2^23 - m for m the word's top 23 bits (k in 1 .. 2^23, exact in
    float32), coded by k's exponent and its 7 bits below the leading one,
    (exponent - 127)·128 + those bits. Non-increasing in m: the buckets are
    narrow where the gumbel rises steeply, as u -> 1."""
    k = (((bits.to(torch.int64) & _U32) ^ _U32) >> 9) + 1
    return (k.to(torch.float32).view(torch.int32) >> 16).to(torch.int64) - 0x3F80


@functools.cache
def _bucket_table(device: torch.device) -> torch.Tensor:
    m = torch.arange(1 << 23, dtype=torch.int32, device=device)
    bits = m << 9
    g = -_xla_log(-_xla_log(_uniform_tiny(bits)))
    table = torch.full((GUMBEL_BUCKETS,), -math.inf, dtype=torch.float32, device=device)
    return table.scatter_reduce_(0, gumbel_bucket(bits), g, "amax")


def gumbel_bucket_table(device) -> torch.Tensor:
    """f32[GUMBEL_BUCKETS] on ``device``: each bucket's largest gumbel
    ``-log(-log(u))`` over every one of the 2^23 uniforms JAX draws whose
    word falls in it (the plain ``_xla_log`` form; an unused code holds
    -inf). Built once a process and device, in a few ms on the card. The
    kernel's own gumbel (single-rounding FMAs) gives the same values
    (``gumbel_values`` checks it on the card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _bucket_table(device)


def gumbel_values(device) -> torch.Tensor:
    """f32[2^23]: the kernel's own gumbel of every uniform (m's at m), from
    ``csrc/prng.cu``'s check export on the CUDA ``device``, for holding
    ``gumbel_bucket_table`` to it. Not on any draw's path, not counted."""
    device = torch.device(device)
    out = torch.empty(1 << 23, dtype=torch.float32, device=device)
    _launch("gumbel_values", out.data_ptr(), dev=device)
    return out


#: kernel launches (one a call); counted where the kernel launches and
#: nowhere else
categorical_gumbel.launches = 0


def _check_lam(lam: float) -> np.float32:
    lam32 = np.float32(lam)
    if not lam32 < 10:
        raise NotImplementedError(
            f"poisson(lam={lam}): only Knuth's branch (lam < 10) is ported; JAX's "
            "transformed rejection for lam >= 10 is listed in ROADMAP.md (queue 1, item 4)")
    return lam32


def poisson_reference(keys: list[tuple[int, int]], lam: float, n: int, device) -> torch.Tensor:
    """The plain version of ``poisson_knuth``: JAX's Knuth loop over the
    whole batch (i32[T, n], row t under ``keys[t]``): each iteration splits
    every chain, adds one to each lane still above -lam, and adds the log of
    a fresh uniform; it ends when no lane is (one host read an iteration).
    The words come from the plain threefry. The log is XLA's form on the
    CPU (bitwise ``jnp.log`` there, and run-to-run steady, which torch's
    CPU log is not) and ``torch.log`` on CUDA, which the kernel's full-
    precision ``logf`` matches."""
    lam32 = _check_lam(lam)
    log = torch.log if torch.device(device).type == "cuda" else _xla_log
    T = len(keys)
    count = torch.zeros((T, n), dtype=torch.int32, device=device)
    if lam32 == 0 or n == 0 or T == 0:
        return count
    neg = torch.tensor(-lam32, dtype=torch.float32, device=device)
    log_prod = torch.zeros((T, n), dtype=torch.float32, device=device)
    rngs = list(keys)
    while bool((log_prod > neg).any()):
        count += (log_prod > neg).to(torch.int32)
        subs = []
        for t in range(T):
            rngs[t], sub = split(rngs[t])
            subs.append(sub)
        u = torch.stack([_uniform01(threefry_bits_reference(s, n, device)) for s in subs])
        log_prod = log_prod + log(u)
    return count - 1


def poisson_knuth(keys: list[tuple[int, int]], lam: float, n: int, device) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.poisson(k, lam, (n,)))(keys)``
    (i32[T, n]; lam < 10, Knuth's branch; lam == 0 gives 0). A CUDA device
    launches ``poisson_knuth`` (a block a tile of one tree's rows, a thread
    a live lane, refilled from the tile as lanes stop; the chains' first
    ``chain_table_size(lam)`` subkeys from a table built on the host), the
    CPU runs the plain version."""
    device = torch.device(device)
    if device.type != "cuda":
        return poisson_reference(keys, lam, n, device)
    lam32 = _check_lam(lam)
    T = len(keys)
    if lam32 == 0 or n == 0 or T == 0:
        return torch.zeros((T, n), dtype=torch.int32, device=device)
    J = chain_table_size(lam32)
    out = torch.empty((T, n), dtype=torch.int32, device=device)
    _launch_knuth(_knuth_table(keys, J, device), lam32, out, J)
    poisson_knuth.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def chain_table_size(lam: float) -> int:
    """Subkeys of each chain ``poisson_knuth``'s table holds at ``lam``: the
    least J >= 1 with P(Poisson(lam) >= J) < ``CHAIN_PAST_P`` (a count of J
    needs J + 1 iterations, one past the table; cached: tens of microseconds
    of Python a lam)."""
    lam = float(lam)
    J = 1
    while _poisson_tail(lam, J) >= CHAIN_PAST_P:
        J += 1
    return J


def _poisson_tail(lam: float, J: int) -> float:
    """P(Poisson(lam) >= J), summed from J up in float64."""
    term = math.exp(J * math.log(lam) - lam - math.lgamma(J + 1))
    total, k = 0.0, J
    while term > 1e-30 * max(total, 1e-300):
        total += term
        k += 1
        term *= lam / k
    return total


def _knuth_table(keys: list[tuple[int, int]], J: int, device) -> torch.Tensor:
    """The kernel's table on the CUDA ``device``: the chains' first ``J``
    subkeys (u32[T, J, 2]), then each chain's key after them (u32[T, 2]), as
    int32 words, from the library's host function ``knuth_chain_table``
    (``_split_chains``' words, without ~3 ms of numpy calls a draw)."""
    T = len(keys)
    flat = np.array([int(w) & _U32 for k in keys for w in k], dtype=np.uint32)
    words = np.empty(T * (J + 1) * 2, dtype=np.uint32)
    err = _lib().knuth_chain_table(flat.ctypes.data, T, J, words.ctypes.data)
    if err != 0:
        raise ValueError(f"knuth_chain_table(T={T}, J={J}) refused: cudaError {err}")
    return torch.from_numpy(words.view(np.int32)).to(device)


def _launch_knuth(packed: torch.Tensor, lam32, out: torch.Tensor, J: int,
                  slots: torch.Tensor | None = None) -> None:
    """One launch of ``poisson_knuth`` into ``out`` (i32[T, n]) from
    ``_knuth_table(keys, J)``'s words (uncounted: the wrapper counts).
    ``slots`` (i64[2] on the card) launches the measurement build instead,
    which adds its warp-iterations and lane-iterations there."""
    T, n = out.shape
    _launch("poisson_knuth", packed.data_ptr(), packed.data_ptr() + 4 * T * J * 2, J, T, n,
            float(lam32), KNUTH_TILE_ROWS, out.data_ptr(),
            None if slots is None else slots.data_ptr(), dev=out.device)


#: kernel launches (one a call on CUDA); counted where the kernel launches
#: and nowhere else
poisson_knuth.launches = 0


def poisson(key: tuple[int, int], lam: float, shape, device) -> torch.Tensor:
    """``jax.random.poisson(key, lam, shape)`` (int32), lam < 10."""
    shape, n = _numel(shape)
    return poisson_knuth([key], lam, n, device)[0].reshape(shape)
