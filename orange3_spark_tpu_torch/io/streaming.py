"""Out-of-core streaming: chunk sources, prefetch and the device chunk cache.

The chunk pipeline of a streaming fit:

    native fastcsv chunk (C++ threads, f32 row-major)
      -> pinned host copy -> device (on a copy stream, prefetch thread)
      -> one update step per chunk on the device

Every chunk is padded to the same row count, so the step sees one shape for
the whole stream, and the host prepares chunk t+1 while the device runs
step t. This module holds the host side of that pipeline: re-iterable
sources, rechunking and padding, the prefetch thread and the budgeted
cache that keeps epoch 1's device chunks for the replay epochs.
"""

from __future__ import annotations

import warnings
from typing import Callable, Iterator

import numpy as np
import torch

from orange3_spark_tpu_torch.exec.pipeline import PipelineStats, prefetch_iter

# (X [n, d], y [n] or None) or (X, y, w) — sources may carry row weights
Chunk = tuple


def csv_raw_chunk_source(
    path: str, *, chunk_rows: int = 1 << 20, delimiter: str = ",",
    header: bool = True, n_threads: int = 0, categorical_cols: tuple = (),
) -> Callable[[], Iterator[np.ndarray]]:
    """Re-iterable source of RAW [n, ncols] f32 chunks — no host-side label
    split, so the parser's buffer goes to the device as it is. Pair with an
    estimator's ``label_in_chunk`` mode, which slices the label column on
    the device. ``categorical_cols`` marks string columns for parse-time
    crc32 hashing (io/native.py). Returns a zero-argument callable: every
    epoch restarts the stream."""
    from orange3_spark_tpu_torch.io.native import NativeCsvReader

    def open_stream() -> Iterator[np.ndarray]:
        with NativeCsvReader(path, delimiter=delimiter, header=header,
                             n_threads=n_threads,
                             categorical_cols=categorical_cols) as r:
            yield from r.chunks(chunk_rows)

    return open_stream


def prefetch_map(fn: Callable, items: Iterator, *, depth: int = 2,
                 stats_into: PipelineStats | None = None) -> Iterator:
    """Run ``fn`` over ``items`` on a daemon thread, yielding results in
    order through a bounded queue — with ``fn`` = pad + host-to-device copy
    the host prepares chunk t+1 while the device runs step t. Worker
    exceptions re-raise at the consuming ``next()``; closing the generator
    early stops the worker. A delegate of ``exec.pipeline``."""
    return prefetch_iter(fn, items, depth=depth, stats_into=stats_into)


def array_chunk_source(X: np.ndarray, y: np.ndarray | None = None,
                       w: np.ndarray | None = None, *,
                       chunk_rows: int = 1 << 16) -> Callable[[], Iterator[Chunk]]:
    """Chunk an in-memory array (testing / small data)."""

    def open_stream() -> Iterator[Chunk]:
        for s in range(0, len(X), chunk_rows):
            e = min(s + chunk_rows, len(X))
            yield (X[s:e],
                   None if y is None else y[s:e],
                   None if w is None else w[s:e])

    return open_stream


class _DeviceCache:
    """Epoch-1 device batch cache with one budget/degrade rule: batches
    accumulate until ``budget`` bytes. With ``may_exclude_tail > 0`` (an
    owner that excludes that many trailing batches after ingest — the
    hashed estimator's holdout tail), a batch that would overflow is not
    cached, and neither is any later one, so misses form a contiguous
    suffix of the offers (the cached list stays a gap-free prefix of the
    stream, or replay would reorder it), and the run is provisionally
    ``degraded``. ``forgive_tail(k)`` clears the misses when they all sit
    inside the excluded last-k offers. Misses are tracked by offer ordinal,
    never by object identity. ``settle()``, called once ingest and
    exclusion are done, drops the whole cache if a miss survives: a partial
    replay would reorder or double-count batches. A miss older than the
    excludable tail can never be forgiven, so the cache drops the moment
    that is known, freeing the device memory for the rest of the ingest."""

    def __init__(self, enabled: bool, budget: int, *, may_exclude_tail: int = 0):
        self.enabled = enabled
        self.budget = budget
        self.may_exclude_tail = may_exclude_tail
        self.batches: list = []
        self.nbytes = 0
        self.degraded = False
        self.offered = 0
        self.first_miss: int | None = None

    def _drop(self) -> None:
        self.enabled = False
        self.batches = []
        self.nbytes = 0
        self.first_miss = None

    def offer(self, batch: tuple) -> None:
        if not self.enabled:
            return
        self.offered += 1
        sz = self._size(batch)
        if self.first_miss is None and self.nbytes + sz <= self.budget:
            self.batches.append(batch)
            self.nbytes += sz
            return
        if self.first_miss is None:
            self.first_miss = self.offered - 1
        self.degraded = True
        if self.offered - self.first_miss > self.may_exclude_tail:
            self._drop()   # the miss can no longer be forgiven

    def forgive_tail(self, k: int) -> None:
        """The last ``k`` offers were excluded from training (holdout):
        misses wholly inside that tail never needed replaying."""
        if self.first_miss is not None and self.first_miss >= self.offered - k:
            self.first_miss = None
            self.degraded = False

    @staticmethod
    def _size(batch) -> int:
        """Device bytes of a batch: its tensors, the plan dict's included."""
        if isinstance(batch, torch.Tensor):
            return batch.numel() * batch.element_size()
        if isinstance(batch, dict):
            return sum(_DeviceCache._size(v) for v in batch.values())
        if isinstance(batch, (tuple, list)):
            return sum(_DeviceCache._size(v) for v in batch)
        return 0

    def exclude(self, drop_ids: set) -> None:
        """Remove cached batches whose first element's id() is in
        ``drop_ids`` (alive in the caller's hands, so identity is sound
        here), keeping ``nbytes`` accurate."""
        kept = []
        for b in self.batches:
            if id(b[0]) in drop_ids:
                self.nbytes -= self._size(b)
            else:
                kept.append(b)
        self.batches = kept

    def settle(self) -> None:
        """End of ingest: a cache still missing batches cannot replay, so it
        drops whole and stays ``degraded``; a complete cache stays live."""
        if self.first_miss is not None:
            self.degraded = True
            self._drop()


def warn_cache_overflow(cache_device_bytes: int, epochs_left: int,
                        detail: str = "") -> None:
    """The cache-overflow warning: every later epoch re-runs the source."""
    warnings.warn(
        f"device chunk cache overflowed cache_device_bytes="
        f"{cache_device_bytes}: each of the remaining {epochs_left} "
        f"epochs will re-run the source end to end (for a CSV source, a "
        f"full re-parse per epoch). {detail}".rstrip(),
        RuntimeWarning, stacklevel=3)


def _rechunk(stream: Iterator[Chunk], rows: int) -> Iterator[tuple]:
    """Normalize a stream of (X, y[, w]) chunks of any sizes into batches of
    EXACTLY ``rows`` rows (the final one may be short). Row weights must be
    non-negative: w == 0 marks dead rows everywhere downstream."""
    bx, by, bw = [], [], []
    have = 0
    any_y = any_w = False

    def flush(upto):
        nonlocal bx, by, bw, have
        X = np.concatenate(bx) if len(bx) > 1 else bx[0]
        y = (np.concatenate(by) if len(by) > 1 else by[0]) if any_y else None
        w = (np.concatenate(bw) if len(bw) > 1 else bw[0]) if any_w else None
        out = (X[:upto],
               None if y is None else y[:upto],
               None if w is None else w[:upto])
        rest_x = X[upto:]
        rest_y = None if y is None else y[upto:]
        rest_w = None if w is None else w[upto:]
        bx = [rest_x] if len(rest_x) else []
        by = [rest_y] if (rest_y is not None and len(rest_y)) else []
        bw = [rest_w] if (rest_w is not None and len(rest_w)) else []
        have = len(rest_x)
        return out

    for chunk in stream:
        X, y, w = (tuple(chunk) + (None, None))[:3]
        bx.append(X)
        if y is not None:
            by.append(y)
            any_y = True
        if w is not None:
            if len(w) and np.min(w) < 0:
                raise ValueError(
                    "negative row weights are not supported (weights mean "
                    "row multiplicity/importance; w == 0 marks dead rows)")
            bw.append(w)
            any_w = True
        have += len(X)
        while have >= rows:
            yield flush(rows)
    if have:
        yield flush(have)


def _pad_chunk(X_np, y_np, w_np, pad_rows: int, n_features: int):
    """Pad a chunk to EXACTLY pad_rows (padding rows carry w=0); full chunks
    pass through without a copy."""
    n = X_np.shape[0]
    if n == pad_rows:
        Xp = np.ascontiguousarray(X_np, dtype=np.float32)
        yp = (np.zeros((n,), np.float32) if y_np is None
              else np.ascontiguousarray(y_np, dtype=np.float32))
        wp = (np.ones((n,), np.float32) if w_np is None
              else np.ascontiguousarray(w_np, dtype=np.float32))
    else:
        Xp = np.zeros((pad_rows, n_features), np.float32)
        Xp[:n] = X_np
        yp = np.zeros((pad_rows,), np.float32)
        if y_np is not None:
            yp[:n] = y_np
        wp = np.zeros((pad_rows,), np.float32)
        wp[:n] = 1.0 if w_np is None else w_np
    return Xp, yp, wp
