"""Multi-process ingest — the cluster half of ``spark.read``.

Port of ``orange3_spark_tpu/io/multihost.py``. Spark splits input files
across executors and each reads its own slice; here every rank parses its
own row block with the same one-process readers. The JAX package then
assembles one global array from the processes' blocks
(``jax.make_array_from_process_local_data``); the port keeps each block on
its rank's device, and the ranks' lockstep chunks, concatenated in rank
order, are the global chunk (``parallel/collectives.py`` folds over them).

Blocks are assigned by the DATA index of a rank (``core/session.World``),
so the ranks of one model group read the same block. The functions below
take the world of the active session unless given one.

``io.streaming.sharded_csv_chunk_source`` builds the per-rank blocks
(slice + zero-weight lockstep padding) so they arrive pre-validated;
hand-made blocks that break the equal-rows contract raise the typed
:class:`RaggedHostBlockError` below.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["RaggedHostBlockError", "put_sharded", "process_row_slice",
           "lockstep_rows", "shard_paths", "shard_row_groups"]


class RaggedHostBlockError(ValueError):
    """A rank's row block breaks the lockstep contract: the ranks of a data
    group must contribute the same row count to every global chunk.

    Raised by :func:`put_sharded` before the block reaches the device. The
    usual cause is a ragged LAST block — the file's row count doesn't divide
    evenly across the ranks. The fix is the weight-mask pad convention: pad
    every rank's block to the common row target (``lockstep_rows``) with dead
    rows carrying sample weight ``w=0``, which the weighted estimators
    ignore exactly.
    """


def _world(world=None):
    from orange3_spark_tpu_torch.core.session import TorchSession

    return world if world is not None else TorchSession.current_world()


def _data_coords(world=None) -> tuple[int, int]:
    """(data index, data parallelism) of this rank."""
    w = _world(world)
    return w.data_index, w.data_parallelism


def _peer_rows(n: int, world) -> list[int]:
    """Every data-group rank's row count, in rank order (one all_gather)."""
    group = world.data_group
    if group is None:
        return [n]
    from orange3_spark_tpu_torch.parallel.collectives import gather_host

    return [int(p.item()) for p in gather_host(torch.tensor([n], dtype=torch.int64), group)]


def put_sharded(local: np.ndarray, session=None, *, force_global: bool = False):
    """A rank's host block -> a tensor on the rank's device.

    One rank: the copy (zero extra cost). In a gang (or with
    ``force_global``), the block is first validated against the lockstep
    contract: the rank's rows must be at least one, and every rank of its
    data group must contribute the same count (one small all_gather), else
    :class:`RaggedHostBlockError`. The global chunk is then the data group's
    blocks concatenated in rank order, the JAX package's assembly order."""
    from orange3_spark_tpu_torch.core.session import TorchSession

    session = session or TorchSession.active()
    world = session.world
    t = torch.from_numpy(np.ascontiguousarray(local))
    if world.data_parallelism == 1 and not force_global:
        return t.to(session.device)
    n = int(np.shape(local)[0]) if np.ndim(local) else 0
    rows = _peer_rows(n, world)
    if n == 0 or len(set(rows)) > 1:
        raise RaggedHostBlockError(
            f"ragged host block: rank {world.rank}/{world.size} (data index "
            f"{world.data_index}) contributed {n} local rows; the data group's ranks "
            f"contributed {rows}. Every rank must contribute the same local row "
            "count — pad the last block to the common per-rank target "
            "(lockstep_rows) with the table's weight-mask semantics (dead rows, w=0) "
            "before put_sharded.")
    return t.to(session.device)


def process_row_slice(n_total: int, world=None) -> slice:
    """Contiguous row range THIS rank should read from a shared file.

    Spark's input-split assignment, reduced to arithmetic: near-equal blocks
    by data index (earlier indices take the remainder)."""
    pi, pc = _data_coords(world)
    base, rem = divmod(n_total, pc)
    start = pi * base + min(pi, rem)
    return slice(start, start + base + (1 if pi < rem else 0))


def lockstep_rows(n_total: int, world=None) -> int:
    """Rows EVERY rank must emit per epoch for ``n_total`` shared rows: the
    largest ``process_row_slice`` block. Ranks holding a smaller slice pad
    the difference with dead ``w=0`` rows (the weight-mask pad convention)
    so all gang members run identical chunk schedules — the lockstep
    contract the rank-order folds require."""
    _, pc = _data_coords(world)
    base, rem = divmod(n_total, pc)
    return base + (1 if rem else 0)


def shard_paths(paths, world=None) -> list[str]:
    """File-per-executor splitting: the subset of ``paths`` this rank reads
    (round-robin by data index — balanced when file sizes are)."""
    pi, pc = _data_coords(world)
    return [p for j, p in enumerate(sorted(paths)) if j % pc == pi]


def shard_row_groups(path: str, world=None) -> list[int]:
    """SINGLE-file parquet splitting: the row-group indices THIS rank should
    stream — Spark's parquet input splits, reduced to arithmetic.
    Contiguous ranges (not round-robin) so each rank's reads stay
    sequential on disk. Pass the result to
    ``io.streaming.parquet_raw_chunk_source(..., row_groups=...)``."""
    import pyarrow.parquet as pq

    sl = process_row_slice(pq.read_metadata(path).num_row_groups, world)
    return list(range(sl.start, sl.stop))
