"""Deterministic segment sums of sorted rows — the touched-row update's dedup.

The JAX package sums a step's per-occurrence gradients by segment with XLA
(``orange3_spark_tpu/optim/sparse.py``, ``_segment_sums``); no Pallas kernel
is involved. In PyTorch the plain form is an ``index_add_``, which on the
CPU adds in index order and on CUDA with float atomics in an order that
changes from run to run, so two fits on the card would not agree bitwise
and a resumed fit could not equal an uninterrupted one. Here a CUDA tensor
reaches the hand-written Hopper kernel ``csrc/segment_sum.cu`` (no float
atomics: each sum in an order fixed by the data) and a CPU tensor the plain
version, ``segment_sum_sorted_reference``. There is no switch between them:
the device of the tensors decides, and a failed build or launch raises.

Which sums equal the CPU's bit for bit: a segment of at most
``walk_max()`` rows (the kernel's ``kWalkMax``, 32) is added by one thread
in sorted order from +0.0, the order of the CPU's ``index_add_``. A longer
one is added by one block (strided partials, then a fixed tree),
deterministic but within float32 rounding of the CPU's sum. Segment ids
past ``n_slots`` are dropped by the kernel (the plain version raises on
them).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from orange3_spark_tpu_torch.ops import cuda_build

#: blocks of the long-segment pass: two per SM of an H100 (1024 threads each)
_LONG_BLOCKS_PER_SM = 2


def segment_sum_sorted_reference(g_sorted, seg, n_slots: int, *,
                                 skip_last=None) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into zeros, which on the CPU
    adds a segment's rows in index order. Where ``skip_last`` is true the
    last segment's slot holds +0.0, as the kernel leaves it."""
    out = torch.zeros((n_slots,) + tuple(g_sorted.shape[1:]), dtype=g_sorted.dtype,
                      device=g_sorted.device)
    out.index_add_(0, seg, g_sorted)
    if skip_last is not None:
        last = seg[-1:]
        flag = skip_last.reshape((1,) * out.ndim)
        out.index_copy_(0, last, torch.where(flag, 0.0, out.index_select(0, last)))
    return out


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("segment_sum")
    fn = lib.segment_sum_sorted_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.segment_sum_error_string.argtypes = [ctypes.c_int]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        lib.segment_sum_walk_max.argtypes = []
        lib.segment_sum_walk_max.restype = ctypes.c_int
    return lib


@functools.cache
def walk_max() -> int:
    """Rows a segment may have and still be summed in the CPU's order: the
    kernel's ``kWalkMax`` (builds the kernel on first use)."""
    return _lib().segment_sum_walk_max()


def _segment_sum_cuda(g_sorted, seg, n_slots: int, skip_last):
    dev = g_sorted.device
    if g_sorted.dtype != torch.float32 or g_sorted.ndim != 2 or not g_sorted.is_contiguous():
        raise ValueError(f"segment_sum_sorted: g_sorted must be a contiguous float32 "
                         f"[M, k] tensor, got {g_sorted.dtype} {tuple(g_sorted.shape)}")
    M, k = g_sorted.shape
    if (seg.device != dev or seg.dtype not in (torch.int32, torch.int64)
            or seg.shape != (M,) or not seg.is_contiguous()):
        raise ValueError(
            f"segment_sum_sorted: seg must be a contiguous int32 or int64 [{M}] "
            f"tensor on {dev}, got {seg.dtype} {tuple(seg.shape)} on {seg.device}")
    if skip_last is not None and (skip_last.device != dev or skip_last.dtype != torch.bool
                                  or skip_last.numel() != 1):
        raise ValueError(
            f"segment_sum_sorted: skip_last must be one bool on {dev}, got "
            f"{skip_last.dtype} {tuple(skip_last.shape)} on {skip_last.device}")
    out = torch.empty((n_slots, k), dtype=torch.float32, device=dev)
    if M == 0 or k == 0 or n_slots == 0:
        return out.zero_()
    wmax = walk_max()
    long_starts = torch.empty(M // (wmax + 1) + 1, dtype=torch.int64, device=dev)
    n_long = torch.empty(1, dtype=torch.int32, device=dev)
    long_blocks = 0
    if M > wmax:
        long_blocks = (_LONG_BLOCKS_PER_SM
                       * torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_sum_sorted_launch(
            g_sorted.data_ptr(), seg.data_ptr(), seg.element_size(),
            None if skip_last is None else skip_last.data_ptr(), M, k, n_slots,
            out.data_ptr(),
            long_starts.data_ptr(), n_long.data_ptr(), long_blocks, stream)
    if err != 0:
        msg = lib.segment_sum_error_string(err).decode()
        raise RuntimeError(f"segment_sum_sorted kernel launch failed: {msg} "
                           f"(cudaError {err})")
    segment_sum_sorted.launches += 1
    return out


def segment_sum_sorted(g_sorted, seg, n_slots: int, *, skip_last=None) -> torch.Tensor:
    """Per-segment sums of sorted rows: f32[n_slots, k], slot ``j`` the sum
    of the rows of ``g_sorted`` (f32[M, k], in stable-sorted order) whose
    ``seg`` (i32 or i64[M], non-decreasing from 0) is ``j``; a slot with no
    row holds +0.0. ``skip_last``: one bool on the tensors' device, read
    there; when true the last segment (the dead sentinel's, which sorts
    last) is not summed and its slot holds +0.0. Runs on the tensors'
    device, without waiting for it, so a captured graph can hold the
    launch."""
    if g_sorted.device.type == "cpu":
        return segment_sum_sorted_reference(g_sorted, seg, n_slots, skip_last=skip_last)
    if g_sorted.device.type == "cuda":
        with torch.profiler.record_function("segment_sum_sorted"):
            return _segment_sum_cuda(g_sorted, seg, n_slots, skip_last)
    raise ValueError(f"segment_sum_sorted: no kernel for device {g_sorted.device}")


#: kernel launches (one a call); counted where the kernel launches and
#: nowhere else
segment_sum_sorted.launches = 0
