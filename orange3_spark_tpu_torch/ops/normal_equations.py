"""The per-entity normal equations of an ALS half-step.

The JAX package builds each entity's A·x = b by XLA segment sums
(``orange3_spark_tpu/models/als.py:112-130``, in ``_solve_side``):
per-rating outer products of the other side's factor rows, summed chunk by
chunk into [n_entities, k·k]. No Pallas kernel is involved. Ported
literally, that is an ``index_add_``, which on CUDA adds with float atomics
in an order that changes from run to run, and which writes and reads back
every outer product. Here a CUDA tensor reaches the hand-written Hopper
kernel of ``csrc/normal_equations.cu`` (register tiles of outputs, the
rows staged through a ``cp.async`` ring, no float atomics, nothing
materialised) and a CPU tensor the plain version. There is no switch
between them: the device of the tensors decides, and a failed build or
launch raises.

Both take one side's ratings in the layout ``sort_side`` makes once a fit
(``SideLayout``): stable-sorted by this side's entity, 12 bytes a rating
for explicit feedback. ``key`` (i32) is the other side's id with bit 31
set where the reference chunk (``pos // chunk``, ``pos`` the rating's
original position) changes inside the entity's segment; ``aw`` and ``bw``
(f32) weigh A and b; ``cw`` weighs the count and is carried only for
implicit feedback (None: the count's weight is ``aw``, as explicit
feedback's is). Segment offsets (i64[E + 1]) bound each entity's ratings;
the kernel's work list (``units``) is made beside them.

The kernel's sums equal the plain version's on the CPU bit for bit: both
add a segment's terms in the original rating order, a partial sum per
reference chunk added to the running total from +0.0, each product and add
rounded on its own. A segment longer than ``SPLIT_MIN`` ratings is cut
where its chunk changes: each piece's partial is summed by its own group of
lanes, and the last piece to finish adds the partials in chunk order.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from orange3_spark_tpu_torch.ops import cuda_build
from orange3_spark_tpu_torch.ops.segment_sum import _check, _range

#: a segment longer than this many ratings is cut at its chunk changes
#: into pieces summed in parallel (``sort_side``)
SPLIT_MIN = 2048
#: at most this many segments are cut, the longest first
SPLIT_MAX = 4096
#: the most bytes of piece partials a launch keeps (the longest segments'
#: pieces first; the wrapper sums a segment past it whole)
SCRATCH_BYTES = 256 << 20
#: bit 31 of ``key``: the reference chunk changes at this rating
CHUNK_BIT = -(1 << 31)


class SideLayout(NamedTuple):
    """One side's ratings sorted by entity, for the normal equations.

    ``key``, ``aw``, ``bw``, ``cw`` (None for explicit feedback) and
    ``offsets`` as the module says. ``units`` (i32[U, 6]) is the kernel's
    work list: (first sorted rating, ratings, entity, split id, piece,
    unweighted): first the pieces of the cut segments (split id s = 0, 1,
    ... by falling length, piece j in chunk order), then one unit an entity
    by falling segment length (piece -1; split id -1 unless its segment is
    cut); unweighted is 1 where every rating of the unit has aw == cw ==
    1.0. ``split_first`` (i32[S + 1] on the device, and as host ints in
    ``split_first_host``) is where each cut segment's pieces start in the
    piece count."""
    key: torch.Tensor
    aw: torch.Tensor
    bw: torch.Tensor
    cw: torch.Tensor | None
    offsets: torch.Tensor
    units: torch.Tensor
    split_first: torch.Tensor
    split_first_host: tuple


def sort_side(idx, other_idx, aw, bw, cw, n_entities: int, n_other: int,
              chunk: int) -> SideLayout:
    """The ratings of one side in the layout the normal equations take:
    stable-sorted by ``idx`` (this side's entity of each rating), each
    rating's ``key`` (the other side's id, clamped into range as the
    reference's gather clamps, with ``CHUNK_BIT`` where ``pos // chunk``
    changes inside a segment), its weights and the segment offsets
    (i64[n_entities + 1]). ``cw`` None: the count's weight is ``aw``. A
    rating whose entity is out of range sorts past ``offsets[-1]`` and
    counts for no entity, as the reference's segment sum drops it. The
    work list reads two small vectors from the device (the cut segments
    and their piece counts); the rest runs on the tensors' device."""
    if chunk < 1:
        raise ValueError(f"sort_side: chunk must be >= 1, got {chunk}")
    dev = idx.device
    idx = idx.to(torch.int32)
    M = idx.shape[0]
    key = torch.where((idx >= 0) & (idx < n_entities), idx, n_entities)
    s_key, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        s_key, torch.arange(n_entities + 1, dtype=torch.int32, device=dev))
    oid = other_idx.to(torch.int32).clamp(0, n_other - 1).index_select(0, order)
    flag = torch.zeros(M, dtype=torch.bool, device=dev)
    c = order // chunk
    flag[1:] = (s_key[1:] == s_key[:-1]) & (c[1:] != c[:-1])
    oid = torch.where(flag, oid.bitwise_or(CHUNK_BIT), oid)
    aw, bw = aw.index_select(0, order), bw.index_select(0, order)
    cw = None if cw is None else cw.index_select(0, order)
    weighted = aw != 1.0 if cw is None else (aw != 1.0) | (cw != 1.0)
    units, split_first, first_host = _work_units(flag, weighted, offsets)
    return SideLayout(oid, aw, bw, cw, offsets, units, split_first, first_host)


def _work_units(flag, weighted, offsets):
    """The kernel's work list of a layout (``SideLayout.units``): the
    segments longer than ``SPLIT_MIN`` with more than one chunk (at most
    ``SPLIT_MAX``, the longest first) cut at their chunk changes, then one
    unit an entity, longest segment first, so that the lanes of a warp
    work on segments of about one length."""
    dev = flag.device
    E = offsets.shape[0] - 1
    start, end = offsets[:-1], offsets[1:]
    length = end - start
    # flags before each position; a segment's first rating has none
    before = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(flag, 0)])
    pieces = torch.where(length > 0, before[end] - before[start] + 1, 0)
    by_length = torch.sort(length, descending=True, stable=True).indices
    cut = ((length > SPLIT_MIN) & (pieces > 1)).index_select(0, by_length)
    split_ent = by_length[torch.nonzero(cut).flatten()[:SPLIT_MAX]]
    n_pieces = pieces.index_select(0, split_ent)
    first_host = (0, *torch.cumsum(n_pieces, 0).tolist())
    S, P = len(first_host) - 1, first_host[-1]
    split_first = torch.tensor(first_host, dtype=torch.int32, device=dev)
    sid = torch.full((E,), -1, dtype=torch.int64, device=dev)
    sid[split_ent] = torch.arange(S, device=dev)
    # pieces: the j-th starts at the segment's j-th chunk change
    s_rep = torch.repeat_interleave(torch.arange(S, device=dev), n_pieces, output_size=P)
    j = torch.arange(P, device=dev) - split_first.long()[s_rep]
    ent = split_ent[s_rep]
    s0 = start[ent]
    at = torch.searchsorted(before, before[s0] + j) - 1
    p0 = torch.where(j == 0, s0, at)
    p1 = torch.where(j == n_pieces[s_rep] - 1, end[ent], p0.roll(-1))
    u0 = torch.cat([p0, start[by_length]])
    u1 = torch.cat([p1, end[by_length]])
    weighted_before = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                                 torch.cumsum(weighted, 0)])
    cols = [u0, u1 - u0, torch.cat([ent, by_length]), torch.cat([s_rep, sid[by_length]]),
            torch.cat([j, torch.full((E,), -1, dtype=torch.int64, device=dev)]),
            (weighted_before[u1] == weighted_before[u0]).to(torch.int64)]
    return torch.stack(cols, dim=1).to(torch.int32), split_first, first_host


def _chunk_pieces(layout: SideLayout):
    """Each live sorted rating's entity (i64) and piece: the count of chunk
    changes before it in its segment."""
    off = layout.offsets
    E, n_live = off.shape[0] - 1, int(off[-1])
    ent = torch.repeat_interleave(torch.arange(E, device=off.device), off[1:] - off[:-1],
                                  output_size=n_live)
    changes = torch.cumsum(layout.key[:n_live] < 0, 0)
    # a segment's first rating is no change, so its count is those before it
    return ent, changes - changes[off[:-1][ent]]


def chunk_terms(factors, layout: SideLayout, batch: int):
    """The reference's chunks of one side's sorted ratings, by piece: for
    piece j = 0, 1, ... (every segment's j-th reference chunk, in rating
    order) yields ``(j, ent, outer, rhs)`` for at most ``batch`` of its
    ratings at a time: the entity of each rating, its terms of A,
    ``(V_i * V_j) * aw`` as f32[n, k·k], and its terms of b and the count,
    ``[V_i * bw, cw]`` as f32[n, k + 1]. Every outer product of a batch is
    materialised."""
    k = factors.shape[1]
    ent, piece = _chunk_pieces(layout)
    order = torch.sort(piece, stable=True).indices
    counts = torch.bincount(piece).tolist()
    oid = layout.key & 0x7FFFFFFF
    cw = layout.aw if layout.cw is None else layout.cw
    p0 = 0
    for j, n in enumerate(counts):
        for b0 in range(p0, p0 + n, batch):
            sel = order[b0:min(b0 + batch, p0 + n)]
            V = factors.index_select(0, oid.index_select(0, sel))
            aw, bw = layout.aw.index_select(0, sel), layout.bw.index_select(0, sel)
            outer = (V[:, :, None] * V[:, None, :]) * aw[:, None, None]
            yield j, ent.index_select(0, sel), outer.reshape(-1, k * k), torch.cat(
                [V * bw[:, None], cw.index_select(0, sel)[:, None]], dim=1)
        p0 += n


def normal_equations_sorted_reference(factors, layout: SideLayout, batch: int | None = None):
    """Plain PyTorch version: the reference's algorithm. Each reference
    chunk's terms (``chunk_terms``: every segment's j-th chunk together,
    ``batch`` ratings at a time, by default as many as 256 MB of outer
    products hold, at most 2^18) are ``index_add_``ed into zeros, which is
    added to the running sums (``A = A + segment_sum(chunk)``). On the CPU
    ``index_add_`` adds in index order, so each partial sum runs in rating
    order, whatever the batch. Returns (A f32[E, k, k], b f32[E, k],
    cnt f32[E])."""
    dev, k = factors.device, factors.shape[1]
    if batch is None:
        batch = max(1, min(1 << 18, (1 << 28) // (4 * k * k)))
    E = layout.offsets.shape[0] - 1
    A = torch.zeros((E + 1, k * k), dtype=torch.float32, device=dev)
    bc = torch.zeros((E + 1, k + 1), dtype=torch.float32, device=dev)
    pA, pbc, at = torch.zeros_like(A), torch.zeros_like(bc), 0
    for j, ent, outer, rhs in chunk_terms(factors, layout, batch):
        if j != at:                  # piece `at` is whole: add its partials
            A, bc, at = A + pA, bc + pbc, j
            pA, pbc = torch.zeros_like(A), torch.zeros_like(bc)
        pA.index_add_(0, ent, outer)
        pbc.index_add_(0, ent, rhs)
    A, bc = A + pA, bc + pbc
    return A[:E].reshape(E, k, k), bc[:E, :k].contiguous(), bc[:E, k].contiguous()


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("normal_equations")
    if lib.normal_equations_sorted_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.normal_equations_sorted_launch.argtypes = [p, i, p, p, p, p, p, ll, p, i, p, p,
                                                       p, p, p, p]
        lib.normal_equations_sorted_launch.restype = i
        lib.normal_equations_max_rank.argtypes = []
        lib.normal_equations_max_rank.restype = i
        lib.normal_equations_piece_floats.argtypes = [i]
        lib.normal_equations_piece_floats.restype = ll
        lib.normal_equations_slices.argtypes = [i]
        lib.normal_equations_slices.restype = i
        lib.normal_equations_blocks_per_sm.argtypes = [i]
        lib.normal_equations_blocks_per_sm.restype = i
        lib.normal_equations_error_string.argtypes = [i]
        lib.normal_equations_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def max_rank() -> int:
    """The largest rank the kernel takes (builds the kernel on first use)."""
    return _lib().normal_equations_max_rank()


def blocks_per_sm(k: int) -> int:
    """The kernel's blocks an SM holds at rank ``k`` (its occupancy; builds
    the kernel on first use)."""
    n = _lib().normal_equations_blocks_per_sm(k)
    if n < 0:
        raise RuntimeError(f"normal_equations_sorted occupancy query failed (cudaError {-n})")
    return n


def _split_used(layout: SideLayout, piece_bytes: int) -> int:
    """How many of the cut segments a launch sums by pieces: the longest
    ones whose partials fit ``SCRATCH_BYTES``."""
    first = layout.split_first_host
    n = 0
    while n + 1 < len(first) and first[n + 1] * piece_bytes <= SCRATCH_BYTES:
        n += 1
    return n


def normal_equations_sorted(factors, layout: SideLayout):
    """The normal equations of every entity of one side: for the ratings
    of its segment ``[offsets[e], offsets[e + 1])`` of ``layout``
    (``sort_side``), ``A[e] = Σ (V_i V_j)·aw``, ``b[e] = Σ V_i·bw`` and
    ``cnt[e] = Σ cw``, with ``V`` the row of ``factors`` (f32[n_other, k])
    at the rating's other-side id, summed per reference chunk. Returns
    (A f32[E, k, k], b f32[E, k], cnt f32[E]); an entity with no rating
    gets zeros. On CUDA one launch that never waits for the device; on the
    CPU the plain version."""
    dev = factors.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"normal_equations_sorted: no kernel for device {dev}")
    if factors.ndim != 2:
        raise ValueError(f"normal_equations_sorted: factors must be [n, k], got "
                         f"{list(factors.shape)}")
    n_other, k = factors.shape
    key, aw, bw, cw, offsets, units, split_first, _ = layout
    M, E, U = key.shape[0], offsets.shape[0] - 1, units.shape[0]
    name = "normal_equations_sorted"
    _check(name, "factors", factors, dev, (torch.float32,), (n_other, k))
    _check(name, "key", key, dev, (torch.int32,), (M,))
    for what, x in (("aw", aw), ("bw", bw)) + ((("cw", cw),) if cw is not None else ()):
        _check(name, what, x, dev, (torch.float32,), (M,))
    _check(name, "offsets", offsets, dev, (torch.int64,), (E + 1,))
    _check(name, "units", units, dev, (torch.int32,), (U, 6))
    _check(name, "split_first", split_first, dev, (torch.int32,),
           (len(layout.split_first_host),))
    if E < 1 or M >= 1 << 31 or n_other < 1 or U < E:
        raise ValueError(f"normal_equations_sorted: needs at least one entity, fewer "
                         f"than 2^31 ratings, a factor row and a unit an entity; got E {E}, "
                         f"M {M}, {n_other} rows, {U} units")
    if dev.type == "cpu":
        return normal_equations_sorted_reference(factors, layout)
    lib = _lib()
    if k > max_rank():
        raise ValueError(f"normal_equations_sorted: rank {k} above the kernel's "
                         f"{max_rank()}")
    if factors.data_ptr() % 16:
        raise ValueError("normal_equations_sorted: factors must start on a 16-byte boundary")
    piece_floats = lib.normal_equations_piece_floats(k)
    n_split = _split_used(layout, 4 * piece_floats)
    n_pieces = layout.split_first_host[n_split]
    A = torch.empty((E, k, k), dtype=torch.float32, device=dev)
    b = torch.empty((E, k), dtype=torch.float32, device=dev)
    cnt = torch.empty((E,), dtype=torch.float32, device=dev)
    scratch = torch.empty((max(n_pieces, 1) * piece_floats,), dtype=torch.float32,
                          device=dev)
    counters = torch.empty((max(n_split, 1) * lib.normal_equations_slices(k),),
                           dtype=torch.int32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with _range("normal_equations_sorted"), (
            contextlib.nullcontext() if index == torch.cuda.current_device()
            else torch.cuda.device(index)):
        err = lib.normal_equations_sorted_launch(
            factors.data_ptr(), k, key.data_ptr(), aw.data_ptr(), bw.data_ptr(),
            None if cw is None else cw.data_ptr(), units.data_ptr(), U,
            split_first.data_ptr(), n_split, scratch.data_ptr(), counters.data_ptr(),
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
