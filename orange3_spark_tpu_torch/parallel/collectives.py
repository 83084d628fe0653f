"""treeAggregate over ranks: the distributed reduction backbone.

Port of ``orange3_spark_tpu/parallel/collectives.py``. There, a jitted
computation over rows sharded ``P('data')`` gets its all-reduce from GSPMD,
and ``tree_aggregate`` is ``shard_map`` + ``psum``. Here one process is one
rank (``core/session.World``) and every reduction over ranks is explicit:

* **a fixed left fold in rank order.** Each rank computes its partial; an
  ``all_gather`` hands every rank every partial, and each rank adds them as
  ``acc = p0; acc = acc + p1; ...``. ``all_reduce(SUM)`` is not used: its
  order is the backend's. So every rank holds the same bits, a world of one
  rank is bitwise the one-process path (nothing is gathered or added), and
  a rerun is bitwise.
* **host tensors.** The 'gloo' backend runs collectives on the CPU (its
  CUDA support covers only broadcast and all_reduce). A CUDA tensor is
  copied into a pinned host buffer, gathered there, and the result copied
  back (``gather_host`` / ``to_device``), explicitly, both ways.
* **one gather for many tensors.** ``gather_packed`` moves several
  tensors of 4-byte elements (float32 and int32, their bits) in one flat
  buffer, so a step pays one collective's latency for all of them.

``collective_stats`` keeps this process's running totals of the calls, the
bytes and the seconds spent in staging and in the backend; a fit reads them
at its epoch boundaries (``stage_times['epoch_collectives']``), so a span of
epochs' collective share is the difference of two readings.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import torch

from orange3_spark_tpu_torch.ops.stats import weighted_moments

__all__ = ["collective_stats", "data_parallel_sum", "distributed_gramian", "fold",
           "gather_host", "gather_packed", "reset_collective_stats", "to_device",
           "tree_aggregate", "world_fold"]

_STATS_LOCK = threading.Lock()
_STATS_KEYS = ("calls", "bytes", "stage_s", "gloo_s")
_STATS = dict.fromkeys(_STATS_KEYS, 0)


def collective_stats() -> dict:
    """This process's collectives since the last reset, as running totals:
    ``calls`` (gathers), ``bytes`` (sent by this rank), ``stage_s`` (copies
    device <-> pinned host, both ways) and ``gloo_s`` (the backend's
    all_gather, waiting for the slowest rank included)."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_collective_stats() -> None:
    with _STATS_LOCK:
        _STATS.update(dict.fromkeys(_STATS_KEYS, 0))


def _note(calls: int = 0, bytes: int = 0, stage_s: float = 0.0, gloo_s: float = 0.0) -> None:
    with _STATS_LOCK:
        for k, v in zip(_STATS_KEYS, (calls, bytes, stage_s, gloo_s)):
            _STATS[k] += v


def _group_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def gather_host(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on each), as host tensors in
    rank order within ``group``. A CUDA tensor is staged through a pinned
    host buffer first (the copy waits for the device)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)               # waits for the stream: t's producer is done
    else:
        host = t.contiguous()
    t1 = time.perf_counter()
    parts = [torch.empty_like(host) for _ in range(_group_size(group))]
    dist.all_gather(parts, host, group=group)
    t2 = time.perf_counter()
    _note(calls=1, bytes=host.numel() * host.element_size(), stage_s=t1 - t0, gloo_s=t2 - t1)
    return parts


def to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host result back on ``device`` (through a pinned buffer on CUDA)."""
    if device.type != "cuda":
        return host
    t0 = time.perf_counter()
    out = host.pin_memory().to(device, non_blocking=True)
    _note(stage_s=time.perf_counter() - t0)
    return out


def fold(parts: list[torch.Tensor]) -> torch.Tensor:
    """The rank-order left fold ``((p0 + p1) + p2) + ...``."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def world_fold(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` by the rank-order fold, on
    ``t``'s device; ``t`` itself where the group is None (one rank)."""
    if group is None:
        return t
    return to_device(fold(gather_host(t, group)), t.device)


def gather_packed(tensors: list[torch.Tensor], group) -> list[list[torch.Tensor]]:
    """Every rank's ``tensors`` (float32 or int32; the same shapes on each
    rank) through ONE all_gather of a flat buffer of their 4-byte words.
    Returns, per rank in group order, the list of its tensors, on the host."""
    if any(t.element_size() != 4 for t in tensors):
        raise ValueError("gather_packed moves 4-byte elements only")
    flat = torch.cat([t.reshape(-1).view(torch.int32) for t in tensors])
    out = []
    for part in gather_host(flat, group):
        got, off = [], 0
        for t in tensors:
            n = t.numel()
            got.append(part[off:off + n].view(t.dtype).view(t.shape))
            off += n
        out.append(got)
    return out


def _data_group(session):
    """The data group of ``session``, else of the active session's world
    (None for a world of one rank)."""
    from orange3_spark_tpu_torch.core.session import TorchSession

    world = session.world if session is not None else TorchSession.current_world()
    return world.data_group


def tree_aggregate(seq_op: Callable[..., Any], *arrays, session=None):
    """Per-rank map + rank-order fold — MLlib ``treeAggregate(zero, seqOp,
    combOp)``. ``seq_op`` receives this rank's rows of each array and returns
    a tensor or a tuple of tensors of partial sums; each is folded over the
    session's data group and returned the same on every rank. Ranks of one
    model group hold the same rows, so the fold runs over the data group."""
    partial = seq_op(*arrays)
    group = _data_group(session)
    if isinstance(partial, torch.Tensor):
        return world_fold(partial, group)
    return tuple(world_fold(p, group) for p in partial)


def data_parallel_sum(values, session=None):
    """Sum row-split arrays over all rows of all ranks: a tuple of the
    column sums, the same on every rank."""
    return tree_aggregate(lambda *xs: tuple(x.sum(dim=0) for x in xs), *values,
                          session=session)


def distributed_gramian(X: torch.Tensor, W: torch.Tensor, center: bool = True,
                        session=None):
    """Weighted Gramian  Xᶜᵀ diag(W) Xᶜ  of the rows of every rank, with
    Xᶜ = X - mean when ``center`` (the weighted column means). The building
    block of PCA. Returns (G [d, d], mean [d], total_weight []). A world of
    one rank is one product (no collective); otherwise the moments and the
    Gramian are each one rank-order fold: (Σw, Σw·x) first, then the
    centred Gramian's partials."""
    group = _data_group(session)
    if group is None:
        mean, _, tot = weighted_moments(X, W)
        Xc = X - mean if center else X
        return (Xc * W[:, None]).T @ Xc, mean, tot
    from orange3_spark_tpu_torch.ops.stats import EPS_TOTAL_WEIGHT

    d = X.shape[1]
    first = world_fold(torch.cat([W.sum().reshape(1), (X * W[:, None]).sum(dim=0)]), group)
    tot = torch.clamp_min(first[0], EPS_TOTAL_WEIGHT)
    mean = first[1:] / tot
    Xc = X - mean if center else X
    G = world_fold((Xc * W[:, None]).T @ Xc, group)
    return G.reshape(d, d), mean, tot
