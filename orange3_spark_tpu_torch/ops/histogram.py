"""Node×bin histogram accumulation — the tree-induction hot loop.

Port of ``orange3_spark_tpu/ops/histogram.py``. The JAX package reaches a
Pallas TPU kernel there (``_hist_pallas``); here a CUDA tensor reaches the
hand-written Hopper kernel ``csrc/histogram.cu`` and a CPU tensor its plain
PyTorch version, ``node_histograms_reference``. There is no switch between
them: the device of the tensors decides, and a failed build or launch
raises. The kernel's source note says what bounds it and how its design
deals with that.

Trees are an explicit batch axis: ``B`` i32[N, d] is shared by the trees,
``S`` f32[T, N, s] and ``pos`` i32[T, N] are per tree, and the result is
f32[T, d, nodes·n_bins, s]. A single tree passes ``S`` f32[N, s] and
``pos`` i32[N] and gets f32[d, nodes·n_bins, s], the JAX signature.
"""

from __future__ import annotations

import ctypes

import torch

from orange3_spark_tpu_torch.ops import cuda_build

_THREADS = 512              # kThreads of csrc/histogram.cu
_SMEM_BUDGET = 48 * 1024    # bytes of one block's shared histogram
_MIN_ROWS_PER_TILE = 1024
_BLOCKS_PER_SM = 4          # a 48 KB histogram leaves room for 4 per SM


def node_histograms_reference(B, S, pos, *, nodes: int, n_bins: int):
    """Plain PyTorch version: one ``index_add_`` per (tree, feature), over
    the flattened (bin, stat) cells (the 1-D form is the fast one on the
    CPU, where it adds row by row in fp32)."""
    single = S.ndim == 2
    if single:
        S, pos = S[None], pos[None]
    T, _, s = S.shape
    d = B.shape[1]
    H = torch.zeros((T, d, nodes * n_bins * s), dtype=torch.float32,
                    device=S.device)
    stat = torch.arange(s, device=S.device)
    for t in range(T):
        base = pos[t].long() * (n_bins * s)
        St = S[t].reshape(-1)
        for j in range(d):
            cell = (base + B[:, j] * s)[:, None] + stat       # [N, s]
            H[t, j].index_add_(0, cell.view(-1), St)
    H = H.view(T, d, nodes * n_bins, s)
    return H[0] if single else H


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("histogram")
    fn = lib.node_histograms_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.node_histograms_error_string.argtypes = [ctypes.c_int]
        lib.node_histograms_error_string.restype = ctypes.c_char_p
    return lib


def launch_shape(N: int, d: int, s: int, T: int, nodes: int, n_bins: int,
                 n_sms: int) -> tuple[int, int]:
    """(features per block, row tiles) of one launch."""
    feature_bytes = (nodes * n_bins * s + 1) * 4
    group = max(1, min(d, _THREADS, _SMEM_BUDGET // feature_bytes))
    n_groups = -(-d // group)
    # at most one wave of blocks: a second, part-filled wave would double
    # the launch's time
    row_tiles = max(1, min(-(-N // _MIN_ROWS_PER_TILE),
                           _BLOCKS_PER_SM * n_sms // (n_groups * T)))
    return group, row_tiles


def _node_histograms_cuda(B, S, pos, *, nodes: int, n_bins: int):
    T, N, s = S.shape
    d = B.shape[1]
    dev = S.device
    for name, x, dtype in (("B", B, torch.int32), ("S", S, torch.float32),
                           ("pos", pos, torch.int32)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"node_histograms: {name} must be a contiguous {dtype} tensor "
                f"on {dev}, got {x.dtype} on {x.device} "
                f"(contiguous={x.is_contiguous()})")
    if B.ndim != 2 or B.shape[0] != N or tuple(pos.shape) != (T, N):
        raise ValueError(
            f"node_histograms: shapes B{tuple(B.shape)} S{tuple(S.shape)} "
            f"pos{tuple(pos.shape)} do not agree")
    H = torch.zeros((T, d, nodes * n_bins, s), dtype=torch.float32, device=dev)
    if N == 0 or d == 0 or s == 0:
        return H
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    group, row_tiles = launch_shape(N, d, s, T, nodes, n_bins, n_sms)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.node_histograms_launch(
            B.data_ptr(), S.data_ptr(), pos.data_ptr(), H.data_ptr(),
            N, d, s, T, nodes, n_bins, group, row_tiles, stream)
    if err != 0:
        msg = lib.node_histograms_error_string(err).decode()
        raise RuntimeError(f"node_histograms kernel launch failed: {msg} "
                           f"(cudaError {err})")
    node_histograms.launches += 1
    return H


def node_histograms(B, S, pos, *, nodes: int, n_bins: int):
    """Per-(feature, node, bin) stat sums.

    B: i32[N, d] binned features; S: f32[N, s] or f32[T, N, s] per-row stats
    (zero on dead rows); pos: i32[N] or i32[T, N] node index of each row
    within the current level. Returns f32[d, nodes*n_bins, s], or
    f32[T, d, nodes*n_bins, s] for a batch of trees.
    """
    single = S.ndim == 2
    if single:
        S, pos = S[None], pos[None]
    if S.device.type == "cpu":
        H = node_histograms_reference(B, S, pos, nodes=nodes, n_bins=n_bins)
    elif S.device.type == "cuda":
        H = _node_histograms_cuda(B, S, pos, nodes=nodes, n_bins=n_bins)
    else:
        raise ValueError(f"node_histograms: no kernel for device {S.device}")
    return H[0] if single else H


#: kernel launches; counted where the kernel launches and nowhere else
node_histograms.launches = 0
