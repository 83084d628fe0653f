"""Deterministic segment sums of sorted rows, and the touched-row update of
the hashed embedding built on them.

The JAX package sums a step's per-occurrence gradients by segment with XLA
(``orange3_spark_tpu/optim/sparse.py``, ``_segment_sums``) and, in the
'sort' lowering of ``sparse_embedding_update`` (``:477-511``), gathers the
touched rows, applies the lazy decay and the rule and scatters them back;
no Pallas kernel is involved. In PyTorch the plain form of the sum is an
``index_add_``, which on the CPU adds in index order and on CUDA with float
atomics in an order that changes from run to run, so two fits on the card
would not agree bitwise and a resumed fit could not equal an uninterrupted
one. Here a CUDA tensor reaches a hand-written Hopper kernel of
``csrc/segment_sum.cu`` (no float atomics: each sum in an order fixed by the
data) and a CPU tensor the plain version. There is no switch between them:
the device of the tensors decides, and a failed build or launch raises.

* ``segment_sum_sorted`` (plain version ``segment_sum_sorted_reference``):
  per-segment sums of sorted rows. The dense table gradient of the 'adam'
  rule and the 'plan' lowering call it.
* ``segment_update_sorted`` (plain version
  ``segment_update_sorted_reference``): the whole touched-row update of the
  'sort' lowering after its sort, in place, in one launch: each segment's
  gradient sum (gathered through the sort order, each occurrence's
  gradient times its pair's value in a value-weighted fit), the lazy
  decay, the rule, and the write-back of the live rows only.

Which sums equal the CPU's bit for bit: a segment of at most ``walk_max()``
rows (the kernel's ``kWalkMax``, 32) is added by one thread in sorted order
from +0.0, the order of the CPU's ``index_add_``. A longer one is spread
over the whole card: the tile holding each 32-row chunk (cut at multiples
of 32 of the row index) sums the segment's rows there in a fixed warp
tree, and one warp adds the segment's chunk partials in a fixed order (its
lanes' strided partials, then the same tree): in the sum, in the tile that
holds the segment's last row, once the earlier tiles have published
theirs; in the update, in a second launch over the segments the first
listed. That order depends on the segment's rows alone: the same in both
kernels and in every launch, deterministic but within float32 rounding of
the CPU's sum. The rounded sums (``round_to``) add every segment in index
order, long ones by one thread. Segment ids past ``n_slots`` are dropped
by the kernel (the plain version raises on them).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from orange3_spark_tpu_torch.ops import cuda_build

#: the rules of ``segment_update_sorted`` (in the order of the kernel's
#: rule index) and their slots (f32 [D, k] beside the table, in the order
#: the kernel takes them)
RULE_SLOTS = {"sgd": (), "adagrad": ("acc",), "ftrl": ("z", "n")}


#: the sums' types of ``round_to`` by the kernel's index (0: float32)
ROUND_TO = {None: 0, torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _rounded_sums(g_sorted, seg, n_slots: int, round_to) -> torch.Tensor:
    """Each segment's rows added in index order from +0.0, each add's
    float32 result rounded to ``round_to``: one pass a row position, the
    p-th rows of all segments at once (each segment once a pass)."""
    M = seg.shape[0]
    out = torch.zeros((n_slots,) + tuple(g_sorted.shape[1:]), dtype=torch.float32,
                      device=g_sorted.device)
    if M == 0:
        return out
    seg = seg.to(torch.int64)
    rows = torch.arange(M, device=seg.device)
    head = torch.ones(M, dtype=torch.bool, device=seg.device)
    head[1:] = seg[1:] != seg[:-1]
    pos = rows - torch.cummax(torch.where(head, rows, 0), 0).values
    by_pos = torch.argsort(pos, stable=True)
    ends = torch.cumsum(torch.bincount(pos), 0).tolist()
    start = 0
    for end in ends:
        take = by_pos[start:end]
        s = seg.index_select(0, take)
        out.index_copy_(0, s, (out.index_select(0, s) + g_sorted.index_select(0, take))
                        .to(round_to).to(torch.float32))
        start = end
    return out


def segment_sum_sorted_reference(g_sorted, seg, n_slots: int, *, skip_last=None,
                                 round_to=None) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into zeros, which on the CPU
    adds a segment's rows in index order. Where ``skip_last`` is true the
    last segment's slot holds +0.0, as the kernel leaves it. ``round_to``
    (bf16 or f16): each add's result rounded to it, in index order."""
    if ROUND_TO[round_to]:
        out = _rounded_sums(g_sorted, seg, n_slots, round_to)
    else:
        out = torch.zeros((n_slots,) + tuple(g_sorted.shape[1:]), dtype=g_sorted.dtype,
                          device=g_sorted.device)
        out.index_add_(0, seg, g_sorted)
    if skip_last is not None:
        last = seg[-1:].to(torch.int64)
        flag = skip_last.reshape((1,) * out.ndim)
        out.index_copy_(0, last, torch.where(flag, 0.0, out.index_select(0, last)))
    return out


def segment_update_sorted_reference(kind: str, s_idx, order, C: int, dl, emb, slots: dict,
                                    t, step, lr: float, decay: float, reg: float,
                                    l1: float, *, use_decay: bool, vals=None,
                                    segment_sum=segment_sum_sorted_reference):
    """Plain PyTorch version of ``segment_update_sorted``: the 'sort'
    lowering's chain after the sort. The segments by a cumsum of the key
    boundaries; each occurrence's gradient ``dl[order // C]`` (times
    ``vals[order]`` with per-pair values: ``vals`` f32[M] in the original
    occurrence order); the sums
    (the dead sentinel's last segment skipped) by ``segment_sum``; the row
    of each segment by a scatter; slots past the live segments repeat the
    last live one (the same row and value written twice: no host sync);
    the rows gathered, decayed and updated by the rule; ``index_copy_``
    back. Updates ``emb``, ``slots`` and ``t`` in place and returns them.

    ``segment_sum`` takes ``segment_sum_sorted_reference``'s arguments.
    Given ``segment_sum_sorted`` on CUDA tensors, this is the op-by-op chain
    the fused kernel replaced: the rule as torch ops, the sums by the
    standalone kernel (whose tile and walk code the fused kernel shares)."""
    from orange3_spark_tpu_torch.optim.sparse import _touched_rows_update

    D = emb.shape[0]
    U = min(s_idx.shape[0], D) + 1
    start = torch.ones_like(s_idx, dtype=torch.bool)
    torch.ne(s_idx[1:], s_idx[:-1], out=start[1:])
    seg = torch.cumsum(start, 0) - 1
    g = dl.index_select(0, order // C)
    if vals is not None:
        g = g * vals.index_select(0, order)[:, None]
    sums = segment_sum(g, seg, U, skip_last=s_idx[-1:] >= D)
    # the row of each segment: every occurrence of a segment writes the
    # same value, so the scatter is deterministic with duplicates
    uniq = torch.zeros(U, dtype=s_idx.dtype, device=s_idx.device).scatter_(0, seg, s_idx)
    n_live = (start & (s_idx < D)).sum()
    src = torch.minimum(torch.arange(U, device=s_idx.device), n_live - 1)
    rid = uniq.index_select(0, src).to(torch.int64)
    p_rows, slot_rows = _touched_rows_update(
        kind, emb, t, slots, sums.index_select(0, src), rid, lr, decay, reg, l1, step,
        use_decay=use_decay)
    emb.index_copy_(0, rid, p_rows)
    for n, v in slot_rows.items():
        slots[n].index_copy_(0, rid, v)
    if use_decay:
        t.index_copy_(0, rid, (step + 1).to(t.dtype).expand(U))
    return emb, t, slots


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("segment_sum")
    if lib.segment_sum_sorted_launch.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.segment_sum_sorted_launch.argtypes = [p, p, i, p, ll, i, ll, i, p, p, i, p]
        lib.segment_sum_sorted_launch.restype = i
        lib.segment_update_sorted_launch.argtypes = (
            [p, p, ll, i, p, p, i, ll, p, p, p, p, p, i, i] + [f] * 7 + [p, i, p])
        lib.segment_update_sorted_launch.restype = i
        lib.segment_sum_scratch_bytes.argtypes = [ll, i, i, i]
        lib.segment_sum_scratch_bytes.restype = ll
        lib.segment_update_scratch_bytes.argtypes = [ll, i]
        lib.segment_update_scratch_bytes.restype = ll
        lib.segment_sum_error_string.argtypes = [i]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        lib.segment_tile_rows.argtypes = [i, i]
        lib.segment_tile_rows.restype = i
        lib.segment_sum_walk_max.argtypes = []
        lib.segment_sum_walk_max.restype = i
    return lib


@functools.cache
def walk_max() -> int:
    """Rows a segment may have and still be summed in the CPU's order: the
    kernel's ``kWalkMax`` (builds the kernel on first use)."""
    return _lib().segment_sum_walk_max()


def _scratch(nbytes: int, dev) -> torch.Tensor:
    """The kernels' scratch, ``nbytes`` as the library sizes it: the
    counters and a word a tile (the launch zeroes them), then two partials
    a 32-row chunk and column and, for the update, the list of its long
    segments (the float sums); or the counters and the long-segment list
    (the rounded sums)."""
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _range(name: str):
    """A ``record_function`` range when a torch profiler is recording, else
    none (the range costs the host two dispatcher calls a launch)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _launch(name: str, *args, dev) -> None:
    """Launches on the current stream of ``dev``, making ``dev`` the current
    device for the call only when it is not."""
    lib = _lib()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    here = index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(index):
        stream = torch._C._cuda_getCurrentRawStream(index)
        err = getattr(lib, f"{name}_launch")(*args, _sms(index), stream)
    if err != 0:
        msg = lib.segment_sum_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")


def _check(name: str, what: str, x, dev, dtypes, shape) -> None:
    if (x.device != dev or x.dtype not in dtypes or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        want = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name}: {what} must be a contiguous {want} {list(shape)} tensor "
                         f"on {dev}, got {x.dtype} {list(x.shape)} on {x.device}")


def _segment_sum_cuda(g_sorted, seg, n_slots: int, skip_last, round_to):
    dev = g_sorted.device
    if g_sorted.dtype != torch.float32 or g_sorted.ndim != 2 or not g_sorted.is_contiguous():
        raise ValueError(f"segment_sum_sorted: g_sorted must be a contiguous float32 "
                         f"[M, k] tensor, got {g_sorted.dtype} {tuple(g_sorted.shape)}")
    M, k = g_sorted.shape
    _check("segment_sum_sorted", "seg", seg, dev, (torch.int32, torch.int64), (M,))
    if skip_last is not None:
        _check("segment_sum_sorted", "skip_last", skip_last.reshape(-1), dev, (torch.bool,),
               (1,))
    out = torch.empty((n_slots, k), dtype=torch.float32, device=dev)
    if M == 0 or k == 0 or n_slots == 0:
        return out.zero_()
    rt = ROUND_TO[round_to]
    scratch = _scratch(_lib().segment_sum_scratch_bytes(M, k, seg.element_size(), rt), dev)
    _launch("segment_sum_sorted", g_sorted.data_ptr(), seg.data_ptr(), seg.element_size(),
            None if skip_last is None else skip_last.data_ptr(), M, k, n_slots, rt,
            out.data_ptr(), scratch.data_ptr(), dev=dev)
    segment_sum_sorted.launches += 1
    return out


def segment_sum_sorted(g_sorted, seg, n_slots: int, *, skip_last=None,
                       round_to=None) -> torch.Tensor:
    """Per-segment sums of sorted rows: f32[n_slots, k], slot ``j`` the sum
    of the rows of ``g_sorted`` (f32[M, k], in stable-sorted order) whose
    ``seg`` (i32 or i64[M], non-decreasing from 0; i32 moves half the
    bytes) is ``j``; a slot with no row holds +0.0. ``skip_last``: one bool
    on the tensors' device, read there; when true the last segment (the
    dead sentinel's, which sorts last) is not summed and its slot holds
    +0.0. ``round_to`` (torch.bfloat16 or torch.float16; None or float32
    for none): each add's result is rounded to that type, as a sum held in
    it adds, every segment in index order (bitwise the plain version's,
    long segments too). Runs on the tensors' device, without waiting for
    it, so a captured graph can hold the launch."""
    if round_to not in ROUND_TO:
        raise ValueError(f"segment_sum_sorted: round_to must be one of {tuple(ROUND_TO)}, "
                         f"got {round_to!r}")
    if g_sorted.device.type == "cpu":
        return segment_sum_sorted_reference(g_sorted, seg, n_slots, skip_last=skip_last,
                                            round_to=round_to)
    if g_sorted.device.type == "cuda":
        with _range("segment_sum_sorted"):
            return _segment_sum_cuda(g_sorted, seg, n_slots, skip_last, round_to)
    raise ValueError(f"segment_sum_sorted: no kernel for device {g_sorted.device}")


#: kernel launches (one a call); counted where the kernel launches and
#: nowhere else
segment_sum_sorted.launches = 0


def _check_update(kind, s_idx, order, C, dl, emb, slots, t, step, vals, dev):
    name = "segment_update_sorted"
    if kind not in RULE_SLOTS:
        raise ValueError(f"{name}: kind must be one of {tuple(RULE_SLOTS)}, got {kind!r}")
    if sorted(slots) != sorted(RULE_SLOTS[kind]):
        raise ValueError(f"{name}: rule {kind!r} keeps the slots {RULE_SLOTS[kind]}, "
                         f"got {sorted(slots)}")
    if emb.ndim != 2 or dl.ndim != 2:
        raise ValueError(f"{name}: emb and dl must be [rows, k] tensors, got "
                         f"{list(emb.shape)} and {list(dl.shape)}")
    (D, k), N = emb.shape, dl.shape[0]
    M = N * C
    _check(name, "s_idx", s_idx, dev, (torch.int32,), (M,))
    _check(name, "order", order, dev, (torch.int64,), (M,))
    _check(name, "dl", dl, dev, (torch.float32,), (N, k))
    _check(name, "emb", emb, dev, (torch.float32,), (D, k))
    for n in RULE_SLOTS[kind]:
        _check(name, f"slots[{n!r}]", slots[n], dev, (torch.float32,), (D, k))
    _check(name, "t", t, dev, (torch.int32,), (D,))
    _check(name, "step", step, dev, (torch.int32,), ())
    if vals is not None:
        _check(name, "vals", vals, dev, (torch.float32,), (M,))
    if M >= 1 << 31:
        raise ValueError(f"{name}: at most 2^31 - 1 occurrences, got {M}")


def segment_update_sorted(kind: str, s_idx, order, C: int, dl, emb, slots: dict, t, step,
                          lr: float, decay: float, reg: float, l1: float, *,
                          use_decay: bool, vals=None):
    """The touched-row update of the 'sort' lowering after its sort, in
    place: for each segment of the stably sorted keys ``s_idx`` (i32[M];
    dead occurrences hold the sentinel ``D = emb.shape[0]`` and sort last)
    whose key ``r`` is a live row, the sum of ``dl[order[i] // C]``
    (``order`` the sort order, i64[M]; ``dl`` f32[N, k] with N·C = M) over
    its occurrences, each times ``vals[order[i]]`` when per-pair values are
    given (``vals`` f32[M] in the original occurrence order; the product
    rounded once, before the sum), then ``emb[r] * decay^(step + 1 - t[r])`` (with
    ``use_decay``), the rule ``kind`` on ``emb[r]`` and ``slots`` (adagrad
    ``acc``, ftrl ``z`` and ``n``: f32[D, k]) and ``t[r] = step + 1``.
    ``step`` is the device int32 step counter. Rows no occurrence touches
    are neither read nor written. Returns (emb, t, slots). On CUDA two
    launches (the tiles, then the long segments' sums) that never wait for
    the device, so a captured graph can hold them; on the CPU the plain
    version."""
    dev = emb.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_update_sorted: no kernel for device {dev}")
    _check_update(kind, s_idx, order, C, dl, emb, slots, t, step, vals, dev)
    if dev.type == "cpu":
        return segment_update_sorted_reference(kind, s_idx, order, C, dl, emb, slots, t, step,
                                               lr, decay, reg, l1, use_decay=use_decay,
                                               vals=vals)
    from orange3_spark_tpu_torch.optim.sparse import ADAGRAD_EPS, FTRL_BETA

    M = s_idx.shape[0]
    if M == 0:
        return emb, t, slots
    s0, s1 = ([slots[n].data_ptr() for n in RULE_SLOTS[kind]] + [None, None])[:2]
    # the CUDA chain divides a tensor by a Python float as a multiply by
    # its float reciprocal; 2·reg is a Python float cast to float32
    f32 = np.float32
    inv_lr = float(f32(1.0) / f32(lr))
    with _range("segment_update_sorted"):
        scratch = _scratch(_lib().segment_update_scratch_bytes(M, emb.shape[1]), dev)
        _launch("segment_update_sorted", s_idx.data_ptr(), order.data_ptr(), M, C,
                dl.data_ptr(), None if vals is None else vals.data_ptr(), emb.shape[1],
                emb.shape[0], emb.data_ptr(), s0, s1,
                t.data_ptr(), step.data_ptr(), list(RULE_SLOTS).index(kind), int(use_decay), lr,
                inv_lr, decay, ADAGRAD_EPS, FTRL_BETA, l1, 2.0 * reg, scratch.data_ptr(),
                dev=dev)
    segment_update_sorted.launches += 1
    return emb, t, slots


#: kernel launches (one a call); counted where the kernel launches and
#: nowhere else
segment_update_sorted.launches = 0
