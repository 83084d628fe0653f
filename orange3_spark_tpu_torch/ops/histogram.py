"""Node×bin histogram accumulation — the tree-induction hot loop.

Port of ``orange3_spark_tpu/ops/histogram.py``. The JAX package reaches a
Pallas TPU kernel there (``_hist_pallas``); here a CUDA tensor reaches the
hand-written Hopper kernel ``csrc/histogram.cu`` and a CPU tensor its plain
PyTorch version, ``node_histograms_reference``. There is no switch between
them: the device of the tensors decides, and a failed build or launch
raises. The kernel's source note says what bounds it and how its design
deals with that.

Trees are an explicit batch axis: ``B`` u8 or i32[N, d] is shared by the
trees, ``S`` f32[T, N, s] and ``pos`` i32[T, N] are per tree, and the result
is f32[T, d, nodes·n_bins, s]. A single tree passes ``S`` f32[N, s] and
``pos`` i32[N] and gets f32[d, nodes·n_bins, s], the JAX signature.

``features`` (bool or f32 [T, d], or [d] for one tree) restricts the work
to each tree's kept features (a random forest's per-level masks); the other
features' histograms are zero. Feature 0 is always built: split finding
reads each node's weight from its totals.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from orange3_spark_tpu_torch.ops import cuda_build

# Plan of csrc/histogram.cu's launch. Shared memory per block: 227 KB at
# most; an SM shares 228 KB among its blocks and keeps 1 KB of each.
_THREADS = 512              # a block's threads where two blocks share an SM
_THREADS_ALONE = 1024       # where one block has the SM: as many warps
_SMEM_BLOCK = 232_448
_SMEM_SM = 233_472
_SMEM_RESERVED = 1024
_TILE_ROWS = (1024, 512, 256, 128, 64, 32)   # multiples of 16: B tiles stay 16-byte aligned
_STAGES = (4, 3, 2)                           # tiles in the bulk-copy ring
_MAX_STATS = 4                          # kMaxStats: stats a row per launch
_COUNTERS = 176   # Layout.counters: live rows of 32 warps, 5 mbarriers, to 16 bytes


class LaunchShape(NamedTuple):
    group: int           # features per block
    tile_rows: int       # rows per staged tile
    stages: int          # tiles in the ring (stages - 1 load ahead)
    blocks_per_sm: int   # blocks the plan fits on one SM
    threads: int         # threads per block
    row_blocks: int      # blocks per (tree, feature group)
    smem_bytes: int      # dynamic shared memory per block


def _round16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(d: int, s: int, nodes: int, n_bins: int, b_bytes: int,
               group: int, tile_rows: int, stages: int) -> int:
    """Shared memory of one block: ``Layout`` of csrc/histogram.cu."""
    cstride = (nodes * n_bins) | 1
    fstride = (s * cstride) | 1
    stage = (_round16(tile_rows * d * b_bytes) + _round16(tile_rows * s * 4) + 32
             + _round16(tile_rows * 4) + 32)
    entries = tile_rows * (4 if s <= 3 else 8) * 4
    return (_round16(group * fstride * 4) + _round16(group * 4) + _COUNTERS
            + stages * stage + entries)


def launch_shape(N: int, d: int, s: int, T: int, nodes: int, n_bins: int,
                 n_sms: int, b_bytes: int = 1) -> LaunchShape:
    """The launch of one call, a pure function of its sizes.

    Features per block: all d if their histograms fit beside the smallest
    ring (and d <= 512, a thread each), else the fewest groups that do. Two
    blocks of 512 threads per SM where that fits in half an SM, else one of
    1024. Then the largest tile (a row a thread at most) that fits in a ring
    of two, then as many stages (up to four) as fit. Row blocks fill one
    wave: at most blocks_per_sm·n_sms blocks in all.
    """
    def fits(group, tile_rows, stages, budget):
        return smem_bytes(d, s, nodes, n_bins, b_bytes, group, tile_rows,
                          stages) <= budget

    smallest = _TILE_ROWS[-1]
    for n_groups in range(-(-d // _THREADS), d + 1):   # a thread per kept feature at least
        group = -(-d // n_groups)
        if fits(group, smallest, 2, _SMEM_BLOCK):
            break
    else:
        raise ValueError(
            f"node_histograms: one feature's histogram ({nodes} nodes x "
            f"{n_bins} bins x {s} stats) does not fit in shared memory")
    half = _SMEM_SM // 2 - _SMEM_RESERVED
    blocks_per_sm, budget = ((2, half) if fits(group, smallest, 2, half)
                             else (1, _SMEM_BLOCK))
    threads = _THREADS if blocks_per_sm == 2 else _THREADS_ALONE
    # the largest tile (a row a thread at most) in a ring of two, then as
    # many stages as fit
    tile_rows = next(tr for tr in _TILE_ROWS
                     if tr <= threads and fits(group, tr, 2, budget))
    stages = next(st for st in _STAGES if fits(group, tile_rows, st, budget))
    n_groups = -(-d // group)
    row_blocks = max(1, min(-(-N // tile_rows), blocks_per_sm * n_sms // (n_groups * T)))
    return LaunchShape(group, tile_rows, stages, blocks_per_sm, threads, row_blocks,
                       smem_bytes(d, s, nodes, n_bins, b_bytes, group, tile_rows, stages))


def kept_features(features, T: int, d: int):
    """bool [T, d]: the features a call builds (``features`` > 0, and
    feature 0 always)."""
    keep = features.reshape(T, d) > 0
    keep[:, 0] = True
    return keep


def node_histograms_reference(B, S, pos, *, nodes: int, n_bins: int,
                              features=None):
    """Plain PyTorch version: one ``index_add_`` per (tree, kept feature),
    over the flattened (bin, stat) cells (the 1-D form is the fast one on
    the CPU, where it adds row by row). B is widened before any
    arithmetic, so uint8 bins cannot wrap. H has S's dtype: with float64
    stats it is the double-precision sum the kernel's fixed point is
    checked against."""
    single = S.ndim == 2
    if single:
        S, pos = S[None], pos[None]
    T, _, s = S.shape
    d = B.shape[1]
    keep = (torch.ones((T, d), dtype=torch.bool) if features is None
            else kept_features(features, T, d).cpu())
    H = torch.zeros((T, d, nodes * n_bins * s), dtype=S.dtype, device=S.device)
    stat = torch.arange(s, device=S.device)
    for t in range(T):
        base = pos[t].long() * (n_bins * s)
        St = S[t].reshape(-1)
        for j in range(d):
            if keep[t, j]:
                cell = (base + B[:, j].long() * s)[:, None] + stat   # [N, s]
                H[t, j].index_add_(0, cell.view(-1), St)
    H = H.view(T, d, nodes * n_bins, s)
    return H[0] if single else H


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("histogram")
    fn = lib.node_histograms_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_longlong] + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.node_histograms_error_string.argtypes = [ctypes.c_int]
        lib.node_histograms_error_string.restype = ctypes.c_char_p
    return lib


def _node_histograms_cuda(B, S, pos, *, nodes: int, n_bins: int, features=None):
    T, N, s = S.shape
    d = B.shape[1]
    dev = S.device
    for name, x, dtypes in (("B", B, (torch.uint8, torch.int32)),
                            ("S", S, (torch.float32,)), ("pos", pos, (torch.int32,))):
        if x.device != dev or x.dtype not in dtypes or not x.is_contiguous():
            raise ValueError(
                f"node_histograms: {name} must be a contiguous "
                f"{' or '.join(map(str, dtypes))} tensor on {dev}, got {x.dtype} "
                f"on {x.device} (contiguous={x.is_contiguous()})")
    if B.ndim != 2 or B.shape[0] != N or tuple(pos.shape) != (T, N):
        raise ValueError(
            f"node_histograms: shapes B{tuple(B.shape)} S{tuple(S.shape)} "
            f"pos{tuple(pos.shape)} do not agree")
    if features is not None and features.numel() != T * d:
        raise ValueError(f"node_histograms: features must be [T, d] = [{T}, {d}], "
                         f"got {tuple(features.shape)}")
    if N == 0 or d == 0 or s == 0:
        return torch.zeros((T, d, nodes * n_bins, s), dtype=torch.float32, device=dev)
    # the kernel's bulk copies move whole 16-byte lines of each input
    B, S, pos = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (B, S, pos))
    feat = n_feat = None
    if features is not None:
        keep = kept_features(features.to(dev), T, d)
        n_feat = keep.sum(1, dtype=torch.int32)
        # each tree's kept features first, in ascending order
        feat = torch.argsort((~keep).to(torch.int8), dim=1, stable=True).to(torch.int32)
    # max|S| of each stat, the scale of its fixed point (NaN or inf if a
    # stat is not finite): one pass over S
    smax = torch.linalg.vector_norm(S, ord=float("inf"), dim=(0, 1))
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _lib()
    # the kernel is compiled for up to _MAX_STATS stats a row; more (gini
    # with many classes) go through it in chunks of stats
    parts = []
    for c0 in range(0, s, _MAX_STATS):
        Sc = S if s <= _MAX_STATS else S[..., c0:c0 + _MAX_STATS].contiguous()
        sc = Sc.shape[2]
        smax_c = smax[c0:c0 + sc].contiguous()
        shape = launch_shape(N, d, sc, T, nodes, n_bins, n_sms, B.element_size())
        acc = torch.zeros((T, d, nodes * n_bins, sc), dtype=torch.int64, device=dev)
        H = torch.empty((T, d, nodes * n_bins, sc), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.node_histograms_launch(
                B.data_ptr(), B.element_size(), Sc.data_ptr(), pos.data_ptr(),
                None if feat is None else feat.data_ptr(),
                None if n_feat is None else n_feat.data_ptr(),
                smax_c.data_ptr(), acc.data_ptr(), H.data_ptr(), N, d, sc, T, nodes,
                n_bins, shape.group, shape.tile_rows, shape.stages,
                shape.row_blocks, shape.threads, stream)
        if err != 0:
            msg = lib.node_histograms_error_string(err).decode()
            raise RuntimeError(f"node_histograms kernel launch failed: {msg} "
                               f"(cudaError {err})")
        node_histograms.launches += 1
        parts.append(H)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=3)


def node_histograms(B, S, pos, *, nodes: int, n_bins: int, features=None):
    """Per-(feature, node, bin) stat sums.

    B: u8 or i32[N, d] binned features; S: f32[N, s] or f32[T, N, s] per-row
    stats (zero on dead rows); pos: i32[N] or i32[T, N] node index of each
    row within the current level; features: optional bool or f32 [d] or
    [T, d] mask of the features to build (feature 0 is always built).
    Returns f32[d, nodes*n_bins, s], or
    f32[T, d, nodes*n_bins, s] for a batch of trees.
    """
    single = S.ndim == 2
    if single:
        S, pos = S[None], pos[None]
    if S.device.type == "cpu":
        H = node_histograms_reference(B, S, pos, nodes=nodes, n_bins=n_bins,
                                      features=features)
    elif S.device.type == "cuda":
        # a profiler range, so a trace can sum all the device work of a call
        with torch.profiler.record_function("node_histograms"):
            H = _node_histograms_cuda(B, S, pos, nodes=nodes, n_bins=n_bins,
                                      features=features)
    else:
        raise ValueError(f"node_histograms: no kernel for device {S.device}")
    return H[0] if single else H


#: kernel launches (one a call, or one per four stats where s > 4);
#: counted where the kernel launches and nowhere else
node_histograms.launches = 0
