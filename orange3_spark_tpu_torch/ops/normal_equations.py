"""The per-entity normal equations of an ALS half-step.

The JAX package builds each entity's A·x = b by XLA segment sums
(``orange3_spark_tpu/models/als.py:112-130``, in ``_solve_side``):
per-rating outer products of the other side's factor rows, summed chunk by
chunk into [n_entities, k·k]. No Pallas kernel is involved. Ported
literally, that is an ``index_add_``, which on CUDA adds with float atomics
in an order that changes from run to run, and which writes and reads back
every outer product. Here a CUDA tensor reaches the hand-written Hopper
kernel of ``csrc/normal_equations.cu`` (one block per entity, no float
atomics, nothing materialised) and a CPU tensor the plain version. There is
no switch between them: the device of the tensors decides, and a failed
build or launch raises.

Both take the ratings stable-sorted by this side's entity (``sort_side``):
the other side's id and the original position of each rating (i32), its
three weights (f32: ``aw`` for A, ``bw`` for b, ``cw`` for the count) and
the segment offsets (i64[E + 1]). The kernel's sums equal the plain
version's on the CPU bit for bit: both add a segment's terms in the
original rating order, a partial sum per reference chunk (``pos //
chunk``) added to the running total, each product and add rounded on its
own.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from orange3_spark_tpu_torch.ops import cuda_build
from orange3_spark_tpu_torch.ops.segment_sum import _check, _range


def sort_side(idx, other_idx, aw, bw, cw, n_entities: int, n_other: int):
    """The ratings of one side in the layout the normal equations take:
    stable-sorted by ``idx`` (this side's entity of each rating). Returns
    ``(oid, pos, aw, bw, cw, offsets)``: the other side's id (clamped into
    range, as the reference's gather clamps) and the original position of
    each sorted rating (i32), its weights, and the segment offsets
    (i64[n_entities + 1]). A rating whose entity is out of range sorts
    past ``offsets[-1]`` and counts for no entity, as the reference's
    segment sum drops it. Runs on the tensors' device without waiting for
    it."""
    dev = idx.device
    idx = idx.to(torch.int32)
    key = torch.where((idx >= 0) & (idx < n_entities), idx, n_entities)
    s_key, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        s_key, torch.arange(n_entities + 1, dtype=torch.int32, device=dev))
    oid = other_idx.to(torch.int32).clamp(0, n_other - 1).index_select(0, order)
    return (oid.to(torch.int32), order.to(torch.int32), aw.index_select(0, order),
            bw.index_select(0, order), cw.index_select(0, order), offsets)


def chunk_terms(factors, oid, pos, aw, bw, cw, offsets, chunk: int):
    """The reference's chunks of one side's sorted ratings, back in their
    original order: for each chunk of ``chunk`` ratings, yields
    ``(ent, outer, rhs)``, the entity of each rating (i64; ``E`` for a
    rating of no entity), its terms of A, ``(V_i * V_j) * aw`` as
    f32[n, k·k], and its terms of b and the count, ``[V_i * bw, cw]`` as
    f32[n, k + 1]. Every outer product of the chunk is materialised."""
    dev = factors.device
    M, k = oid.shape[0], factors.shape[1]
    E = offsets.shape[0] - 1
    n_live = int(offsets[-1])
    # entity of each sorted rating; E (a dropped row) past the segments
    ent = torch.full((M,), E, dtype=torch.int64, device=dev)
    ent[:n_live] = torch.repeat_interleave(
        torch.arange(E, device=dev), offsets[1:] - offsets[:-1], output_size=n_live)
    where = pos.to(torch.int64)

    def original(x):
        out = torch.empty_like(x)
        out[where] = x
        return out

    ent, oid, aw, bw, cw = (original(x) for x in (ent, oid.to(torch.int64), aw, bw, cw))
    for c0 in range(0, M, chunk):
        sl = slice(c0, min(c0 + chunk, M))
        V = factors.index_select(0, oid[sl])
        outer = (V[:, :, None] * V[:, None, :]) * aw[sl, None, None]
        yield ent[sl], outer.reshape(-1, k * k), torch.cat([V * bw[sl, None], cw[sl, None]],
                                                           dim=1)


def normal_equations_sorted_reference(factors, oid, pos, aw, bw, cw, offsets,
                                      chunk: int):
    """Plain PyTorch version: the reference's algorithm. Each chunk's
    terms (``chunk_terms``) are ``index_add_``ed into zeros, which is added
    to the running sums (``A = A + segment_sum(chunk)``). On the CPU
    ``index_add_`` adds in index order. Returns (A f32[E, k, k],
    b f32[E, k], cnt f32[E])."""
    dev, k = factors.device, factors.shape[1]
    E = offsets.shape[0] - 1
    A = torch.zeros((E + 1, k * k), dtype=torch.float32, device=dev)
    bc = torch.zeros((E + 1, k + 1), dtype=torch.float32, device=dev)
    for ent, outer, rhs in chunk_terms(factors, oid, pos, aw, bw, cw, offsets, chunk):
        A = A + torch.zeros_like(A).index_add_(0, ent, outer)
        bc = bc + torch.zeros_like(bc).index_add_(0, ent, rhs)
    return A[:E].reshape(E, k, k), bc[:E, :k].contiguous(), bc[:E, k].contiguous()


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("normal_equations")
    if lib.normal_equations_sorted_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.normal_equations_sorted_launch.argtypes = [p, i, p, p, p, p, p, p, ll, ll, i,
                                                       p, p, p, p]
        lib.normal_equations_sorted_launch.restype = i
        lib.normal_equations_max_rank.argtypes = []
        lib.normal_equations_max_rank.restype = i
        lib.normal_equations_error_string.argtypes = [i]
        lib.normal_equations_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def max_rank() -> int:
    """The largest rank the kernel takes (builds the kernel on first use)."""
    return _lib().normal_equations_max_rank()


def normal_equations_sorted(factors, oid, pos, aw, bw, cw, offsets, chunk: int):
    """The normal equations of every entity of one side: for the ratings
    of its segment ``[offsets[e], offsets[e + 1])`` (stable-sorted by
    entity, as ``sort_side`` gives them), ``A[e] = Σ (V_i V_j)·aw``,
    ``b[e] = Σ V_i·bw`` and ``cnt[e] = Σ cw``, with ``V`` the row of
    ``factors`` (f32[n_other, k]) at ``oid``, summed per reference chunk
    of ``chunk`` ratings (``pos // chunk``). Returns (A f32[E, k, k],
    b f32[E, k], cnt f32[E]); an entity with no rating gets zeros. On CUDA
    one launch that never waits for the device; on the CPU the plain
    version."""
    dev = factors.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"normal_equations_sorted: no kernel for device {dev}")
    if factors.ndim != 2:
        raise ValueError(f"normal_equations_sorted: factors must be [n, k], got "
                         f"{list(factors.shape)}")
    n_other, k = factors.shape
    M, E = oid.shape[0], offsets.shape[0] - 1
    name = "normal_equations_sorted"
    _check(name, "factors", factors, dev, (torch.float32,), (n_other, k))
    for what, x in (("oid", oid), ("pos", pos)):
        _check(name, what, x, dev, (torch.int32,), (M,))
    for what, x in (("aw", aw), ("bw", bw), ("cw", cw)):
        _check(name, what, x, dev, (torch.float32,), (M,))
    _check(name, "offsets", offsets, dev, (torch.int64,), (E + 1,))
    if E < 1 or M >= 1 << 31 or chunk < 1 or n_other < 1:
        raise ValueError(f"normal_equations_sorted: needs at least one entity, fewer "
                         f"than 2^31 ratings, a chunk >= 1 and a factor row; got E {E}, "
                         f"M {M}, chunk {chunk}, {n_other} rows")
    if dev.type == "cpu":
        return normal_equations_sorted_reference(factors, oid, pos, aw, bw, cw, offsets,
                                                 chunk)
    lib = _lib()
    if k > max_rank():
        raise ValueError(f"normal_equations_sorted: rank {k} above the kernel's "
                         f"{max_rank()}")
    A = torch.empty((E, k, k), dtype=torch.float32, device=dev)
    b = torch.empty((E, k), dtype=torch.float32, device=dev)
    cnt = torch.empty((E,), dtype=torch.float32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with _range("normal_equations_sorted"), (
            contextlib.nullcontext() if index == torch.cuda.current_device()
            else torch.cuda.device(index)):
        err = lib.normal_equations_sorted_launch(
            factors.data_ptr(), k, oid.data_ptr(), pos.data_ptr(), aw.data_ptr(),
            bw.data_ptr(), cw.data_ptr(), offsets.data_ptr(), E, M, min(chunk, max(M, 1)),
            A.data_ptr(), b.data_ptr(), cnt.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        msg = lib.normal_equations_error_string(err).decode()
        raise RuntimeError(f"normal_equations_sorted kernel launch failed: {msg} "
                           f"(cudaError {err})")
    normal_equations_sorted.launches += 1
    return A, b, cnt


#: kernel launches (one a call); counted where the kernel launches and
#: nowhere else
normal_equations_sorted.launches = 0
