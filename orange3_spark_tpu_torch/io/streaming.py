"""Out-of-core streaming: chunk sources, prefetch and the device chunk cache.

The chunk pipeline of a streaming fit:

    native fastcsv chunk (C++ threads, f32 row-major)
      -> pad, encode (io/codec.py), spill (prefetch thread)
      -> pinned host copy -> device (on a copy stream, prefetch thread)
      -> one update step per chunk on the device

Every chunk is padded to the same row count, so the step sees one shape for
the whole stream, and the host prepares chunk t+1 while the device runs
step t. This module holds the host side of that pipeline: re-iterable
sources (CSV through the native parser, parquet a row group at a time,
in-memory arrays), rechunking and padding, the prefetch thread, the
budgeted cache that keeps epoch 1's device chunks for the replay epochs,
and the disk spill that replays them when the cache overflows; for a gang
of ranks, ``sharded_csv_chunk_source`` (each rank's row block in lockstep
chunks) and the parquet sources' ``shard=True``. It also
holds ``StreamingLinearEstimator`` (MLlib's out-of-core linear learner:
logistic, squared or squared-hinge loss, adam over epochs of chunks,
returning the in-memory estimators' model classes) and the streaming half
of the feature pipeline (BASELINE config 5): the one-pass feature
statistics of the scalers', imputer's and PCA's ``fit_stream``
(``stream_feature_stats``), streamed scoring to parquet (``score_stream``)
and ``StreamingKMeans``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import struct
import time
import uuid
import warnings
import weakref
import zlib
from typing import Callable, Iterator

import numpy as np
import torch

from orange3_spark_tpu_torch.exec.pipeline import PipelineStats, prefetch_iter
from orange3_spark_tpu_torch.io.codec import SpillCorruptionError
from orange3_spark_tpu_torch.models.base import Estimator, Params
from orange3_spark_tpu_torch.obs import prof
from orange3_spark_tpu_torch.obs.report import RunReport
from orange3_spark_tpu_torch.obs.trace import refreshed_enabled as obs_enabled
from orange3_spark_tpu_torch.obs.trace import span, span_iter, traced
from orange3_spark_tpu_torch.utils.graphs import EpochReplay, capture_graph

# (X [n, d], y [n] or None) or (X, y, w) — sources may carry row weights
Chunk = tuple


def csv_chunk_source(
    path: str, class_col: str = "", *, chunk_rows: int = 1 << 20,
    delimiter: str = ",", header: bool = True, n_threads: int = 0,
) -> Callable[[], Iterator[Chunk]]:
    """Re-iterable source of ``(X [n, d] f32, y [n] f32 | None)`` chunks over a
    CSV file through the native parser, the ``class_col`` column split off as
    the label (a name the header does not hold raises). Returns a
    zero-argument callable: every epoch restarts the stream."""
    from orange3_spark_tpu_torch.io.native import NativeCsvReader

    def open_stream() -> Iterator[Chunk]:
        with NativeCsvReader(path, delimiter=delimiter, header=header,
                             n_threads=n_threads) as r:
            if class_col:
                if class_col not in r.colnames:
                    raise ValueError(f"class_col {class_col!r} not in {r.colnames}")
                ci = r.colnames.index(class_col)
                keep = [j for j in range(r.ncols) if j != ci]
                for c in r.chunks(chunk_rows):
                    yield np.ascontiguousarray(c[:, keep]), c[:, ci]
            else:
                for c in r.chunks(chunk_rows):
                    yield c, None

    return open_stream


def _parquet_groups(path: str, row_groups, shard: bool, world=None):
    """The row groups a parquet source reads: ``row_groups`` as given (None:
    all). ``shard=True`` without ``row_groups`` picks this rank's contiguous
    share (``io/multihost.shard_row_groups``), except under the
    ``OTPU_MULTIHOST=0`` kill-switch, where it reads the whole file.
    Row-group splitting has no lockstep padding: the caller owns group
    balance across ranks (a rank whose stream ends early leaves its peers
    in a collective until the backend's timeout or the launcher's wall
    budget)."""
    if row_groups is not None:
        return list(row_groups)
    if shard:
        from orange3_spark_tpu_torch.io.multihost import shard_row_groups
        from orange3_spark_tpu_torch.utils import knobs

        if knobs.get_bool("OTPU_MULTIHOST"):
            return shard_row_groups(path, world)
    return None


def sharded_csv_chunk_source(
    path, class_col: str = "", *, shard_total_rows: int | None = None,
    chunk_rows: int = 1 << 20, delimiter: str = ",", header: bool = True,
    n_threads: int = 0, world=None,
) -> Callable[[], Iterator[Chunk]]:
    """Per-rank CSV ingest for multi-process fits.

    Single shared file: every rank streams only its contiguous
    ``io.multihost.process_row_slice(shard_total_rows)`` row block (the
    parse STOPS at the block's end, so rows past it are never decoded),
    then re-chunks the block into an emission schedule that is IDENTICAL
    on every gang member: ``ceil(lockstep_rows/chunk_rows)`` chunks, all
    of ``chunk_rows`` rows but the last. A rank holding fewer rows than the
    common per-rank target tops up with dead rows (features 0, label 0,
    weight 0 — the weight-mask pad convention ``put_sharded`` names), so
    all ranks run the same chunk schedule and the rank-order folds stay in
    lockstep. ``world`` (default: the active session's) assigns the block
    by its data index.

    ``path`` may also be a LIST of paths: file-per-executor splitting via
    ``io.multihost.shard_paths`` (round-robin; ``shard_total_rows`` is
    ignored). In that mode the caller owns row-count balance across ranks:
    a rank whose stream ends early leaves its peers in a collective until
    the backend's timeout or the launcher's wall budget.

    Under ``OTPU_MULTIHOST=0`` (the kill-switch) the single-path form IS
    ``csv_chunk_source`` — the pre-multihost stream, bitwise. With the
    switch on in a single rank over a file holding exactly
    ``shard_total_rows`` rows, the emitted chunks are the parser's own
    buffers unchanged (same values, zero extra copies).

    Yields ``(X, y, w)`` triples (``array_chunk_source``'s form): ``w`` is
    ``None`` on pure-data chunks and a 0-mask tail on padded ones."""
    from orange3_spark_tpu_torch.io.multihost import (
        lockstep_rows, process_row_slice, shard_paths,
    )
    from orange3_spark_tpu_torch.utils import knobs

    if isinstance(path, (list, tuple)):
        multi = knobs.get_bool("OTPU_MULTIHOST")
        paths = shard_paths(path, world) if multi else sorted(str(p) for p in path)

        def open_paths() -> Iterator[Chunk]:
            for p in paths:
                yield from csv_chunk_source(p, class_col, chunk_rows=chunk_rows,
                                            delimiter=delimiter, header=header,
                                            n_threads=n_threads)()

        return open_paths

    if not knobs.get_bool("OTPU_MULTIHOST"):
        return csv_chunk_source(path, class_col, chunk_rows=chunk_rows,
                                delimiter=delimiter, header=header, n_threads=n_threads)
    if shard_total_rows is None:
        raise ValueError(
            "sharded_csv_chunk_source over a single shared file needs "
            "shard_total_rows (the file's exact row count) to assign rank row blocks")
    n_total = int(shard_total_rows)
    has_y = bool(class_col)
    inner = csv_chunk_source(path, class_col, chunk_rows=chunk_rows, delimiter=delimiter,
                             header=header, n_threads=n_threads)

    def open_stream() -> Iterator[Chunk]:
        sl = process_row_slice(n_total, world)
        target = lockstep_rows(n_total, world)
        if target == 0:
            return
        k = -(-target // chunk_rows)
        sizes = [chunk_rows] * (k - 1) + [target - chunk_rows * (k - 1)]
        pend: list[tuple] = []      # sliced (X, y, w) pieces pending emit
        pend_n = 0

        def take(n_take: int) -> Chunk:
            nonlocal pend_n
            pieces, got = [], 0
            while got < n_take:
                X, y, w = pend[0]
                need = n_take - got
                if len(X) <= need:
                    pend.pop(0)
                    pieces.append((X, y, w))
                    got += len(X)
                else:
                    pieces.append((X[:need], None if y is None else y[:need],
                                   None if w is None else w[:need]))
                    pend[0] = (X[need:], None if y is None else y[need:],
                               None if w is None else w[need:])
                    got = n_take
            pend_n -= n_take
            if len(pieces) == 1:
                return pieces[0]
            Xo = np.concatenate([q[0] for q in pieces])
            yo = np.concatenate([q[1] for q in pieces]) if has_y else None
            if all(q[2] is None for q in pieces):
                wo = None
            else:
                wo = np.concatenate([np.ones(len(q[0]), np.float32) if q[2] is None else q[2]
                                     for q in pieces])
            return Xo, yo, wo

        pos = have = si = 0
        n_feat = None
        it = inner()
        try:
            for c in it:
                X, y = c[0], c[1]
                base, n = pos, len(X)
                pos += n
                if n_feat is None:
                    n_feat = X.shape[1]
                lo, hi = max(sl.start, base), min(sl.stop, base + n)
                if hi > lo:
                    pend.append((X[lo - base:hi - base],
                                 None if y is None else y[lo - base:hi - base], None))
                    pend_n += hi - lo
                    have += hi - lo
                    while si < len(sizes) and pend_n >= sizes[si]:
                        yield take(sizes[si])
                        si += 1
                if pos >= sl.stop:
                    break       # our block is done — stop parsing
        finally:
            it.close()
        if have < sl.stop - sl.start:
            raise ValueError(
                f"sharded_csv_chunk_source: {path!r} exhausted at row {pos} — "
                f"shard_total_rows={n_total} overstates the file, rank block {sl} "
                f"holds only {have} rows")
        dead = target - have
        if dead:
            if n_feat is None:
                raise ValueError(
                    f"sharded_csv_chunk_source: {path!r} holds no data rows — cannot "
                    "shape the lockstep dead-row padding")
            pend.append((np.zeros((dead, n_feat), np.float32),
                         np.zeros((dead,), np.float32) if has_y else None,
                         np.zeros((dead,), np.float32)))
            pend_n += dead
        while si < len(sizes) and pend_n >= sizes[si]:
            yield take(sizes[si])
            si += 1

    return open_stream


def parquet_chunk_source(
    path: str, class_col: str = "", *, chunk_rows: int = 1 << 20,
    columns: tuple | None = None, row_groups: tuple | None = None,
    shard: bool = False, world=None,
) -> Callable[[], Iterator[Chunk]]:
    """Re-iterable source of ``(X [n, d] f32, y [n] f32 | None)`` chunks over a
    parquet file, read a row group at a time (``pyarrow.ParquetFile.
    iter_batches``), so host memory stays bounded by the row group however
    large the file is. ``class_col`` is split off as the label; ``columns``
    picks and orders the columns; ``row_groups`` restricts the stream to
    those group indices, and ``shard=True`` to this rank's share of them
    (``_parquet_groups``). pyarrow is imported when the stream opens."""

    def open_stream() -> Iterator[Chunk]:
        import pyarrow.parquet as pq

        groups = _parquet_groups(path, row_groups, shard, world)

        pf = pq.ParquetFile(path)
        try:
            names = list(columns) if columns else [f.name for f in pf.schema_arrow]
            ci = -1
            if class_col:
                if class_col not in names:
                    raise ValueError(f"class_col {class_col!r} not in {names}")
                ci = names.index(class_col)
            for batch in pf.iter_batches(batch_size=chunk_rows, columns=names,
                                         row_groups=groups):
                cols = [batch.column(j).to_numpy(zero_copy_only=False)
                        .astype(np.float32, copy=False)
                        for j in range(batch.num_columns)]
                y = cols.pop(ci) if ci >= 0 else None
                yield np.column_stack(cols), y
        finally:
            pf.close()

    return open_stream


def parquet_raw_chunk_source(
    path: str, *, chunk_rows: int = 1 << 20, columns: tuple | None = None,
    row_groups: tuple | None = None, shard: bool = False, world=None,
) -> Callable[[], Iterator[np.ndarray]]:
    """Parquet twin of ``csv_raw_chunk_source``: RAW [n, ncols] f32 chunks,
    no host-side label split, for an estimator's ``label_in_chunk`` mode;
    a row group at a time, like ``parquet_chunk_source``."""

    def open_stream() -> Iterator[np.ndarray]:
        import pyarrow.parquet as pq

        groups = _parquet_groups(path, row_groups, shard, world)

        pf = pq.ParquetFile(path)
        try:
            for batch in pf.iter_batches(batch_size=chunk_rows,
                                         columns=list(columns) if columns else None,
                                         row_groups=groups):
                yield np.column_stack([batch.column(j).to_numpy(zero_copy_only=False)
                                       .astype(np.float32, copy=False)
                                       for j in range(batch.num_columns)])
        finally:
            pf.close()

    return open_stream


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


#: per-process ledger-entry numbering for _DeviceCache instances
_CACHE_LEDGER_SEQ = itertools.count()


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
    that is known, freeing the device memory for the rest of the ingest.

    The memory-pressure brownout ladder (resilience/overload.py; level 0,
    inert, unless a pressure source is configured) reads its level at
    every offer: 1 admits only to half the budget, 2 admits nothing more
    (the miss machinery then routes the replay to the spill or the
    re-streamed source), 3 drops the cache at once, freeing the device
    memory it holds. The cache's bytes are the ledger entry
    ``cache_chunks`` (obs/prof.py), kept current at every change and
    released when the cache dies."""

    def __init__(self, enabled: bool, budget: int, *, may_exclude_tail: int = 0):
        self.enabled = enabled
        self.budget = budget
        self.may_exclude_tail = may_exclude_tail
        self.batches: list = []
        self.nbytes = 0
        self.degraded = False
        self.offered = 0
        self.first_miss: int | None = None
        # the GC-safe deferred release: a finalizer must not take the
        # ledger lock
        self.ledger_key = f"chunk_cache-{next(_CACHE_LEDGER_SEQ)}"
        weakref.finalize(self, prof.ledger_release_on_gc, "cache_chunks", self.ledger_key)

    def _ledger_sync(self) -> None:
        prof.ledger_set("cache_chunks", self.ledger_key, self.nbytes)

    def _drop(self) -> None:
        self.enabled = False
        self.batches = []
        self.nbytes = 0
        self.first_miss = None
        self._ledger_sync()

    def offer(self, batch: tuple) -> None:
        if not self.enabled:
            return
        self.offered += 1
        from orange3_spark_tpu_torch.resilience.overload import brownout_level

        lvl = brownout_level()
        if lvl >= 3:
            self.degraded = True
            self._drop()
            return
        budget = self.budget // 2 if lvl == 1 else self.budget
        sz = self._size(batch)
        if lvl < 2 and self.first_miss is None and self.nbytes + sz <= budget:
            self.batches.append(batch)
            self.nbytes += sz
            self._ledger_sync()
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
        self._ledger_sync()

    def settle(self) -> None:
        """End of ingest: a cache still missing batches cannot replay, so it
        drops whole and stays ``degraded``; a complete cache stays live."""
        if self.first_miss is not None:
            self.degraded = True
            self._drop()


def _resilience_enabled() -> bool:
    """``OTPU_RESILIENCE=0`` skips the spill's CRC check (read per call)."""
    return os.environ.get("OTPU_RESILIENCE", "1") != "0"


def _storage_dtype(name) -> np.dtype:
    """A spill field's numpy dtype; the name "bfloat16" (what the JAX
    package writes for a bf16 field) is its 16 bits, read as uint16."""
    return np.dtype(np.uint16) if str(name) == "bfloat16" else np.dtype(name)


def _spill_cleanup(f, path: str, named: list) -> None:
    """Module-level so the finalizer holds no reference to the cache: close
    the file (which frees an unlinked inode) and unlink a named spill an
    aborted fit left behind."""
    try:
        f.close()
    except OSError:
        pass
    if named and named[0]:
        try:
            os.unlink(path)
        except OSError:
            pass


class DiskChunkCache:
    """Epoch-1 disk spill of padded (and encoded) chunks: when a many-epoch
    fit outgrows the device cache, the later epochs replay these records
    at disk bandwidth instead of re-parsing the CSV.

    Format (version 2): the magic ``OTPUSPL1``, a u32 header length and a
    JSON header (shapes and dtype names), padded to 8 bytes; then records
    of fixed size, each a little-endian u32 live-row count, a u32 CRC32 of
    the record's bytes after those eight, and the fields' raw bytes in
    order, each field 8-byte aligned. Version 1 has zeros where the CRC
    is (the same offsets); version 0 is headerless float32 fields back to
    back, with no live-row counts. ``attach`` reads all three, as the JAX
    package writes them. ``read`` checks a version-2 record's CRC once
    (``OTPU_RESILIENCE=0`` skips it) and raises ``SpillCorruptionError``
    naming the record; ``finalize`` and ``attach`` refuse a file that is
    not a whole number of records.

    One writer (the prefetch thread), then ``finalize()`` turns it into a
    read-only memmap. By default the file is unlinked as soon as it is
    opened, so a crashed fit leaves nothing on disk; a finalizer closes
    the file (and unlinks a ``keep_file=True`` spill) if the object dies
    without ``delete()``."""

    MAGIC = b"OTPUSPL1"

    def __init__(self, dir_path: str, shapes: tuple, dtypes: tuple | None = None,
                 *, keep_file: bool = False):
        self.shapes = [tuple(s) for s in shapes]
        self.dtypes = ([np.dtype(np.float32)] * len(self.shapes) if dtypes is None
                       else [_storage_dtype(d) for d in dtypes])
        if len(self.dtypes) != len(self.shapes):
            raise ValueError("one dtype per field")
        self._init_layout()
        self._version = 2
        os.makedirs(dir_path, exist_ok=True)
        self.path = os.path.join(dir_path, f"spill_{uuid.uuid4().hex}.otpu")
        self._f = open(self.path, "w+b")
        header = json.dumps({"version": 2, "shapes": self.shapes,
                             "dtypes": [dt.name for dt in self.dtypes]}).encode()
        head = self.MAGIC + struct.pack("<I", len(header)) + header
        head += b"\0" * (-len(head) % 8)
        self._f.write(head)
        self._data_start = len(head)
        self._named = [bool(keep_file)]
        if not keep_file:
            os.unlink(self.path)
        self._finalizer = weakref.finalize(self, _spill_cleanup, self._f, self.path,
                                           self._named)
        self.n_valid: list[int] = []
        self._mm: np.memmap | None = None
        self._crc_ok: set[int] = set()

    def _init_layout(self, header_words: int = 8) -> None:
        """Field offsets: after ``header_words`` bytes (the live-row count
        and the CRC), each field at the next 8-byte boundary; version 0
        packs the fields back to back from offset 0."""
        self._field_bytes = [int(np.prod(s)) * dt.itemsize
                             for s, dt in zip(self.shapes, self.dtypes)]
        #: bytes of one record's arrays, what a device copy of it costs
        self.payload_bytes = sum(self._field_bytes)
        self._offsets, ofs = [], header_words
        for nb in self._field_bytes:
            self._offsets.append(ofs)
            ofs += -(-nb // 8) * 8 if header_words else nb
        self.record_bytes = ofs

    @classmethod
    def attach(cls, path: str, shapes: tuple | None = None,
               dtypes: tuple | None = None) -> "DiskChunkCache":
        """Open an existing spill file read-only. Versions 1 and 2 describe
        themselves; a headerless (version 0) file needs ``shapes`` (float32
        unless ``dtypes`` says otherwise) and reads every record as full."""
        obj = cls.__new__(cls)
        obj._f = open(path, "rb")
        obj.path = path
        obj._named = [False]
        obj._finalizer = weakref.finalize(obj, _spill_cleanup, obj._f, path, obj._named)
        obj._mm = None
        obj._crc_ok = set()
        if obj._f.read(len(cls.MAGIC)) == cls.MAGIC:
            (hlen,) = struct.unpack("<I", obj._f.read(4))
            layout = json.loads(obj._f.read(hlen))
            obj.shapes = [tuple(s) for s in layout["shapes"]]
            obj.dtypes = [_storage_dtype(d) for d in layout["dtypes"]]
            obj._init_layout()
            head = len(cls.MAGIC) + 4 + hlen
            obj._data_start = head + (-head % 8)
            obj._version = int(layout.get("version", 1))
        else:
            if shapes is None:
                raise ValueError("headerless (version-0) spill files need shapes=")
            obj.shapes = [tuple(s) for s in shapes]
            obj.dtypes = ([np.dtype(np.float32)] * len(obj.shapes) if dtypes is None
                          else [_storage_dtype(d) for d in dtypes])
            obj._init_layout(header_words=0)
            obj._data_start = 0
            obj._version = 0
        n_bytes = os.path.getsize(path) - obj._data_start
        n_rec = n_bytes // obj.record_bytes if obj.record_bytes else 0
        if obj._version >= 1 and obj.record_bytes and n_bytes % obj.record_bytes:
            raise SpillCorruptionError(
                f"spill file {path!r} is truncated: {n_bytes} data bytes is not a "
                f"whole number of {obj.record_bytes}-byte records — record {n_rec} "
                f"(of {n_rec + 1} started) was cut mid-write")
        obj._mm = np.memmap(obj._f, dtype=np.uint8, mode="r", offset=obj._data_start,
                            shape=(n_rec, obj.record_bytes))
        if obj._version >= 1:
            obj.n_valid = [int(v) for v in
                           np.asarray(obj._mm[:, :4]).copy().view("<u4")[:, 0]]
        else:
            obj.n_valid = [obj.shapes[0][0]] * n_rec
        return obj

    def append(self, arrays: tuple, n_valid: int) -> None:
        """Write one record (on the prefetch thread, sequentially)."""
        arrs = []
        for a, shape, dt in zip(arrays, self.shapes, self.dtypes):
            a = np.ascontiguousarray(a, dtype=dt)
            if a.shape != shape:
                raise ValueError(f"spill record shape {a.shape} != {shape}")
            arrs.append(a)
        # the CRC covers every byte after the 8-byte record header, the
        # alignment zeros included, so it lands in that header first
        crc, written = 0, 8
        for a, ofs, nb in zip(arrs, self._offsets, self._field_bytes):
            if ofs > written:
                crc = zlib.crc32(b"\0" * (ofs - written), crc)
            crc = zlib.crc32(a, crc)
            written = ofs + nb
        if self.record_bytes > written:
            crc = zlib.crc32(b"\0" * (self.record_bytes - written), crc)
        # write-side fault injection (resilience/faults.py spill_corrupt):
        # the CRC above covers the TRUE bytes, so a flipped byte trips the
        # read-side check exactly like real silent corruption would
        from orange3_spark_tpu_torch.resilience.faults import active_fault_spec

        spec = active_fault_spec()
        action = spec.take_spill_corrupt(len(self.n_valid)) if spec is not None else None
        rec_start = self._f.tell()
        self._f.write(struct.pack("<II", int(n_valid), crc & 0xFFFFFFFF))
        written = 8
        for a, ofs, nb in zip(arrs, self._offsets, self._field_bytes):
            if ofs > written:
                self._f.write(b"\0" * (ofs - written))
            a.tofile(self._f)
            written = ofs + nb
        if self.record_bytes > written:
            self._f.write(b"\0" * (self.record_bytes - written))
        if action == "flip":
            end = self._f.tell()
            pos = rec_start + self._offsets[0]
            self._f.seek(pos)
            b = self._f.read(1)
            self._f.seek(pos)
            self._f.write(bytes([b[0] ^ 0x01]))
            self._f.seek(end)
        elif action == "truncate":
            # a crash mid-write: only half the record reaches disk (the
            # bookkeeping below still counts it, as the dead writer's
            # in-memory state did) — caught by finalize/attach
            self._f.truncate(rec_start + self.record_bytes // 2)
            self._f.seek(rec_start + self.record_bytes // 2)
        self.n_valid.append(int(n_valid))

    @property
    def n_records(self) -> int:
        return len(self.n_valid)

    def finalize(self) -> None:
        """End of writing: check the file holds every record, then map it."""
        if self._mm is None and self._f is not None and self.n_valid:
            self._f.flush()
            expected = self._data_start + self.n_records * self.record_bytes
            actual = os.fstat(self._f.fileno()).st_size
            if actual != expected:
                raise SpillCorruptionError(
                    f"spill file {self.path!r} holds {actual} bytes where {expected} "
                    f"were written ({self.n_records} records x {self.record_bytes} B): "
                    f"record {max(0, (actual - self._data_start) // self.record_bytes)}"
                    " was truncated mid-write")
            self._mm = np.memmap(self._f, dtype=np.uint8, mode="r",
                                 offset=self._data_start,
                                 shape=(self.n_records, self.record_bytes))

    def read(self, i: int) -> tuple[tuple, int]:
        """Record ``i`` as typed views into the memmap, and its live-row
        count. A version-2 record's CRC is checked on its first read (the
        file does not change after ``finalize``)."""
        rec = self._mm[i]
        if self._version >= 2 and i not in self._crc_ok and _resilience_enabled():
            stored = int(np.asarray(rec[4:8]).copy().view("<u4")[0])
            computed = zlib.crc32(rec[8:]) & 0xFFFFFFFF
            if stored != computed:
                from orange3_spark_tpu_torch.obs.flight import auto_dump
                from orange3_spark_tpu_torch.utils.profiling import record_crc_failure

                record_crc_failure()
                err = SpillCorruptionError(
                    f"spill record {i} of {self.n_records} in {self.path!r} failed "
                    f"CRC verification (stored 0x{stored:08x} != computed "
                    f"0x{computed:08x}): the record was corrupted on disk. Delete the "
                    "spill and re-run the fit (OTPU_RESILIENCE=0 skips verification).")
                # black box (obs/flight.py): the replay's spans, registry,
                # knobs and stacks at the corruption, before the raise
                # unwinds the fit
                auto_dump("spill_corruption", err)
                raise err
            self._crc_ok.add(i)
        out = tuple(rec[ofs:ofs + nb].view(dt).reshape(shape)
                    for shape, dt, ofs, nb in zip(self.shapes, self.dtypes,
                                                  self._offsets, self._field_bytes))
        return out, self.n_valid[i]

    def delete(self) -> None:
        """Release the file (a ``keep_file`` spill is unlinked too)."""
        self._mm = None
        if self._f is not None:
            self._f = None
            self._finalizer()


def warn_cache_overflow(cache_device_bytes: int, epochs_left: int,
                        detail: str = "") -> None:
    """The cache-overflow warning: every later epoch re-runs the source."""
    warnings.warn(
        f"device chunk cache overflowed cache_device_bytes="
        f"{cache_device_bytes}: each of the remaining {epochs_left} "
        f"epochs will re-run the source end to end (for a CSV source, a "
        f"full re-parse per epoch). {detail}".rstrip(),
        RuntimeWarning, stacklevel=3)


def resolve_epoch_checkpointing(params, checkpointer) -> int:
    """The rule for ``checkpoint_every_epochs``: the epoch cadence is live
    only with a checkpointer, a positive K, and outside the
    ``OTPU_RESILIENCE=0`` kill-switch. Returns K, or 0 (the per-step
    ``maybe_save`` cadence)."""
    from orange3_spark_tpu_torch.resilience.faults import resilience_enabled

    k = getattr(params, "checkpoint_every_epochs", 0)
    return k if (checkpointer is not None and k > 0 and resilience_enabled()) else 0


def epoch_boundary_snapshot(checkpointer, every_epochs: int, epoch: int, defer: bool,
                            n_steps: int, resume_from: int, snapshot, meta) -> None:
    """One epoch-boundary save decision for every streaming epoch path
    (live stream, cache replay, disk replay); ``run_epoch_replay`` holds
    the fused replay's own. A deferred fit's step-free ingest pass trains
    no epoch; a fast-forwarded epoch (``n_steps <= resume_from``) rewrites
    nothing."""
    trained = epoch + 1 - (1 if defer else 0)
    if (every_epochs and trained > 0 and trained % every_epochs == 0
            and n_steps > resume_from):
        checkpointer.save(n_steps, snapshot(), meta=meta)


def run_epoch_replay(n_replay: int, spe: int, n_steps: int, resume_from: int,
                     checkpointer, dispatch_epochs, snapshot, ckpt_meta,
                     epochs_per_dispatch: int = 1, every_epochs: int = 0):
    """The per-epoch replay protocol: fast-forward whole checkpointed
    epochs without running them, run the rest in groups of
    ``epochs_per_dispatch`` epochs, bound the dispatch queue (period 2:
    one running, one queued) and snapshot at epoch boundaries, every
    ``every_epochs`` epochs or, without it, every
    ``checkpointer.every_steps`` steps rounded to whole epochs. A group
    never crosses a snapshot boundary (it is clamped), so the cadence is
    the same at every group size and a snapshot resumes under any. The
    snapshot is taken between dispatches, after the wait that
    ``snapshot()`` makes for the device.

    Each save is preceded by ``check_finite_training`` on the last loss.
    ``dispatch_epochs(k)`` runs k epochs and returns a tensor to wait on;
    ``snapshot()`` returns the state to save. Returns ``(n_steps, last,
    n_dispatched)``: ``last`` is None when every epoch was fast-forwarded
    (resume at completion)."""
    from orange3_spark_tpu_torch.resilience.numerics import check_finite_training
    from orange3_spark_tpu_torch.utils.dispatch import bound_dispatch

    save_every = ((every_epochs or max(1, checkpointer.every_steps // spe))
                  if checkpointer is not None else 0)
    group = max(1, int(epochs_per_dispatch))
    last = None
    n_disp = 0
    rep = 0
    while rep < n_replay:
        if n_steps + spe <= resume_from:
            n_steps += spe          # a checkpointed epoch: skipped, not run
            rep += 1
            continue
        k = min(group, n_replay - rep)
        if save_every:
            # snapshots land between dispatches: a group spanning a
            # boundary would skip it
            k = min(k, save_every - (rep % save_every))
        last = dispatch_epochs(k)
        n_steps += k * spe
        rep += k
        n_disp += 1
        bound_dispatch(n_disp, last, period=2)
        if save_every and rep % save_every == 0:
            # the non-finite guard before the save: NaN state is never
            # checkpointed (epoch: the 0-based trained epoch just ended)
            check_finite_training(last, epoch=n_steps // spe - 1, chunk=n_steps)
            checkpointer.save(n_steps, snapshot(), meta=ckpt_meta)
    return n_steps, last, n_disp


def replay_epochs(replay, last: Callable, n_replay: int, spe: int, n_steps: int, *,
                  capture: bool, granularity: str, epochs_per_dispatch: int = 1,
                  resume_from: int = 0, checkpointer=None, snapshot=None, ckpt_meta=None,
                  every_epochs: int = 0):
    """The epochs after the first over the cached chunks (``spe`` of them),
    as one replay: ``replay`` (the hashed fit's ``_Replay``, which the
    dense fit shares, or ``_KMeansReplay``) captured when ``capture`` (on
    CUDA), then run whole ('all': one call) or by ``run_epoch_replay``
    ('epoch': groups of ``epochs_per_dispatch``, snapshots at epoch
    boundaries). ``last()`` gives what the last epoch leaves to wait on
    (its loss). The replays' device seconds feed the live fit's goodput
    as device compute. Returns ``(n_steps, last, capture_s)``; when a
    snapshot already holds every replay epoch nothing runs and ``last``
    and ``capture_s`` are None."""
    from orange3_spark_tpu_torch.utils.profiling import count_dispatch

    if n_steps + n_replay * spe <= resume_from:
        return n_steps + n_replay * spe, None, None     # the snapshot covers them
    t0 = time.perf_counter()
    if capture:
        replay.capture()
    capture_s = time.perf_counter() - t0
    if granularity == "epoch":
        def dispatch_epochs(k):
            replay.run(k)
            return last()

        n_steps, out, _ = run_epoch_replay(
            n_replay, spe, n_steps, resume_from, checkpointer, dispatch_epochs, snapshot,
            ckpt_meta, epochs_per_dispatch=epochs_per_dispatch, every_epochs=every_epochs)
    else:
        replay.run(n_replay)
        count_dispatch()          # one call: no loop to bound
        n_steps, out = n_steps + n_replay * spe, last()
    # the captured replays' device seconds (their events', read once they
    # end) are the live fit's device compute; the rest of the window,
    # the host's launches included, is framework
    prof.note_sync(replay.device_seconds())
    return n_steps, out, capture_s


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
        if y is not None:
            by.append(y)
            any_y = True
        if w is not None:
            if len(w) and np.min(w) < 0:
                raise ValueError(
                    "negative row weights are not supported (weights mean "
                    "row multiplicity/importance; w == 0 marks dead rows)")
            if not any_w:
                # pending rows that came without weights weigh 1 (a sharded
                # source weighs only its padded chunks)
                bw = [np.ones(len(b), np.float32) for b in bx]
            bw.append(w)
            any_w = True
        elif any_w:
            bw.append(np.ones(len(X), np.float32))
        bx.append(X)
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


# ------------------------------------------------- the dense streaming fit

@dataclasses.dataclass(frozen=True)
class StreamingLinearParams(Params):
    """The JAX package's ``StreamingLinearParams``, field for field (a
    checkpoint's params round-trip between the two packages)."""

    loss: str = "logistic"       # 'logistic' | 'squared' | 'squared_hinge'
    n_classes: int = 2           # k for logistic
    epochs: int = 1
    step_size: float = 0.01
    reg_param: float = 0.0       # L2
    chunk_rows: int = 1 << 18    # padded device batch per step
    seed: int = 0
    # epoch 1 only ingests (pad, encode, cache, spill) and the replay
    # carries all ``epochs`` passes: the same step sequence, the same bits.
    # Needs cache_device; with a checkpointer only under
    # replay_granularity='epoch'
    defer_epoch1: bool = False
    # 'all': every replay epoch in one call (one captured epoch replayed
    # back to back); 'epoch': ``epochs_per_dispatch`` epochs a call, with
    # epoch-boundary snapshots between calls (``run_epoch_replay``)
    replay_granularity: str = "all"   # 'all' | 'epoch'
    epochs_per_dispatch: int = 1
    # with a checkpointer, K > 0 snapshots every K trained epochs instead
    # of every ``checkpointer.every_steps`` steps (inert under
    # OTPU_RESILIENCE=0)
    checkpoint_every_epochs: int = 0
    # cache / spill precision (io/codec.py, resolved once at fit entry):
    # 'f32', or 'bf16' (the features as bfloat16: half the device, disk and
    # copy bytes, widened to float32 in the step); 'packed' and 'auto'
    # resolve to bf16 here (the dense fit has no integer columns to pack)
    cache_dtype: str = "f32"     # 'f32' | 'bf16' | 'packed' | 'auto'


def check_replay_granularity(value: str) -> None:
    """Reject a misspelt granularity at fit entry: every comparison is an
    exact string match, so 'epochs' would silently behave as 'all' and
    silently drop the defer + checkpointer composition asked for."""
    if value not in ("all", "epoch"):
        raise ValueError(f"replay_granularity must be 'all' or 'epoch', got {value!r}")


def _stream_step(theta: dict, opt_state: dict, X, y, w, reg: float, lr: float, *,
                 loss_kind: str, group=None):
    """One adam step of the streaming fit on one padded chunk: (theta,
    opt_state, loss), new tensors.

    The reference differentiates ``_linear._make_objective(loss_kind,
    fit_intercept=True)`` with the column scale all ones:
    ``(1/Σw)·Σ wᵢ·lossᵢ + ½·reg·Σcoef²`` with ``Σw`` floored at
    ``EPS_TOTAL_WEIGHT`` and the intercept unregularized. Its gradient,
    written out: G = ∂lossᵢ/∂z · (wᵢ·(1/Σw)) (``per_row_loss_grad``, the
    reference's autodiff at z = 0 included), ``Xᵀ G + reg·coef`` and
    ``Σ G``. The update is optax's ``adam(1.0)`` scaled by ``lr``
    (``optim/sparse.adam_update``). A bf16-cached X (a bfloat16 tensor) is
    widened here, exactly. Nothing waits for the device.

    ``group``: the data group of a gang (None for one rank). The chunk is
    then this rank's part of the global chunk: ``Σw`` is folded over the
    ranks (``parallel/collectives.world_fold``) before ``G`` is formed, as
    the reference's ``w.sum()`` over sharded rows is, and ``Xᵀ G``, ``Σ G``
    and the loss's ``Σ wᵢ·lossᵢ`` are folded in one gather after it. The
    folds wait for the device.

    The step's sums over rows (the logits' dot products, ``Σw``, ``Xᵀ G``,
    ``Σ G``, the loss) run in float64 and are rounded to float32 once, in
    one process as in a gang. A product of two float32 values is exact in
    float64, and the order of a float64 sum moves it by far less than a
    float32 ulp, so however a step's rows are split (one process, or a
    gang's ranks folded in rank order) its float32 result is the same but
    for the rare sum that lies at a float32 rounding boundary, where the
    last bit may differ. In float32 the fit's trajectory carries the order
    of its sums: bench's multihost geometry (192 adam steps) amplifies a
    6e-8 difference after one epoch to 2.5e-2 after sixteen. This departs
    from the reference, whose step sums in float32."""
    from orange3_spark_tpu_torch.models._linear import per_row_loss_and_grad
    from orange3_spark_tpu_torch.ops.stats import EPS_TOTAL_WEIGHT
    from orange3_spark_tpu_torch.optim.sparse import adam_update
    from orange3_spark_tpu_torch.parallel.collectives import world_fold

    f32, f64 = torch.float32, torch.float64
    X64 = X.to(f64)
    coef, intercept = theta["coef"], theta["intercept"]
    w64 = w.to(f64)
    sum_w = torch.clamp_min(world_fold(w64.sum(), group).to(f32), EPS_TOTAL_WEIGHT)
    logits = (X64 @ coef.to(f64)).to(f32) + intercept
    rows, G = per_row_loss_and_grad(loss_kind, logits, y, w * (1.0 / sum_w))
    G64 = G.to(f64)
    dk, k = coef.numel(), coef.shape[1]
    tot = world_fold(torch.cat([(X64.T @ G64).reshape(-1), G64.sum(dim=0),
                                (rows.to(f64) * w64).sum().reshape(1)]), group).to(f32)
    data_loss, g_coef, g_int = tot[-1], tot[:dk].view(coef.shape), tot[dk:dk + k]
    loss = data_loss / sum_w + 0.5 * reg * (coef * coef).sum()
    grads = {"coef": g_coef + reg * coef, "intercept": g_int}
    theta, opt_state = adam_update(theta, grads, opt_state, lr)
    return theta, opt_state, loss


def _stream_step_into(theta: dict, opt_state: dict, chunk: tuple, reg: float, lr: float,
                      loss_kind: str, group=None) -> torch.Tensor:
    """``_stream_step`` on a device chunk ``(X, y, w)``, written back into
    ``theta`` and ``opt_state`` in place (a captured replay reads and writes
    them at fixed addresses). Returns the loss (a device scalar)."""
    from orange3_spark_tpu_torch.models.hashed_linear import _write_back

    new_theta, new_opt, loss = _stream_step(theta, opt_state, *chunk, reg, lr,
                                            loss_kind=loss_kind, group=group)
    _write_back(theta, new_theta)
    _write_back(opt_state, new_opt)
    return loss


class StreamingLinearEstimator(Estimator):
    """Minibatch-over-chunks trainer producing the standard model classes:
    ``fit_stream(source, n_features=...)`` returns a LogisticRegressionModel,
    LinearRegressionModel or LinearSVCModel as ``loss`` says.

    Schedules (``fit_stream``): every epoch re-streams the source (the
    default); ``cache_device`` keeps epoch 1's device chunks and replays the
    later epochs from them, on CUDA one epoch captured as a CUDA graph and
    replayed (when the cache holds at most half of ``cache_device_bytes``,
    the reference's gate for its stacked copy; else chunk by chunk from the
    cache); past ``cache_device_bytes`` with ``cache_spill_dir`` the later
    epochs read epoch 1's disk spill, and without it re-run the source
    with a warning; ``defer_epoch1`` makes epoch 1 ingest only. Every
    schedule runs the same steps in the same order, so their results are
    equal bit for bit. A ``checkpointer`` snapshots (per step, or at epoch
    boundaries with ``checkpoint_every_epochs``) and a restarted fit
    resumes from the snapshot to the same bits."""

    ParamsCls = StreamingLinearParams
    params: StreamingLinearParams
    gang_fold = True            # each step folds its sums over the ranks

    def _fit(self, table):
        """Estimator protocol: an in-memory table streamed in chunks."""
        from orange3_spark_tpu_torch.models.base import infer_class_values

        X, Y, W = table.to_numpy()
        y = Y[:, 0] if Y is not None else None
        class_values = infer_class_values(table) if self.params.loss == "logistic" else None
        return self.fit_stream(array_chunk_source(X, y, W, chunk_rows=self.params.chunk_rows),
                               n_features=X.shape[1], session=table.session,
                               class_values=class_values)

    @traced("fit", model="streaming_linear")
    def fit_stream(self, source: Callable[[], Iterator[Chunk]], *, n_features: int,
                   session=None, class_values: tuple | None = None, checkpointer=None,
                   cache_device: bool = False, cache_device_bytes: int = 8 << 30,
                   cache_spill_dir: str | None = None, stage_times: dict | None = None):
        """Fit over a re-iterable source of ``(X, y[, w])`` chunks.

        checkpointer: a ``utils/fault.StreamCheckpointer``. The fit resumes
          from its snapshot (this package's or the JAX package's, for the
          same params), skipping the steps it holds, snapshots every
          ``every_steps`` steps or every ``checkpoint_every_epochs`` trained
          epochs (never NaN state: ``check_finite_training`` runs first),
          and deletes the snapshot when it returns.
        cache_device: keep epoch 1's device chunks (as ``cache_dtype`` says)
          and replay them; ``cache_device_bytes`` bounds them and
          ``cache_spill_dir`` gives the overflow its disk spill
          (``DiskChunkCache``, released when the fit returns).
        stage_times: receives 'epoch_s' (one wall an epoch; the fused replay
          one wall), 'epoch_collectives' (``collective_stats()`` at the end
          of each of those walls), 'n_steps', 'replay_source' ('fused', 'fused_epoch',
          'hbm', 'disk', 'stream' or None), 'retries' (transient reads
          retried), 'cache_bytes' and 'graph_capture_s'.
        """
        from orange3_spark_tpu_torch.core.session import TorchSession
        from orange3_spark_tpu_torch.interop import streaming_linear_fit_state
        from orange3_spark_tpu_torch.io.codec import bf16_bits_np, resolve_cache_dtype
        from orange3_spark_tpu_torch.models.hashed_linear import (
            _HostToDevice, _load_into, _Replay,
        )
        from orange3_spark_tpu_torch.optim.sparse import init_adam_state
        from orange3_spark_tpu_torch.parallel.collectives import collective_stats
        from orange3_spark_tpu_torch.resilience.numerics import check_finite_training
        from orange3_spark_tpu_torch.resilience.retry import resilient_source
        from orange3_spark_tpu_torch.utils.dispatch import bound_dispatch

        p = self.params
        check_replay_granularity(p.replay_granularity)
        # the run report rides the OTPU_OBS kill-switch; the goodput
        # accountant (obs/prof.py) is None under OTPU_PROF=0
        report = (RunReport("fit_stream", estimator=type(self).__name__,
                            loss=p.loss, epochs=p.epochs)
                  if obs_enabled() else None)
        acc = prof.begin_fit()
        pipe_stats = PipelineStats()
        # the source chokepoint: fault injection and bounded retries of
        # transient reads (on the prefetch thread)
        source = resilient_source(source, stats=pipe_stats)
        session = session or TorchSession.active()
        dev = session.device
        # a gang's data group: each step folds its sums over the ranks, and
        # a replay epoch then runs eagerly (a CUDA graph cannot hold a gloo
        # collective, and each step waits for its fold anyway)
        group = session.world.data_group
        if p.loss == "logistic":
            if class_values is not None:
                k = max(2, len(class_values))
                # one probability column a class value: pad the list to k
                if len(class_values) < k:
                    class_values = tuple(class_values) + tuple(
                        f"__class_{i}__" for i in range(len(class_values), k))
            else:
                k = p.n_classes
        else:
            k = 1
        theta = {"coef": torch.zeros((n_features, k), dtype=torch.float32, device=dev),
                 "intercept": torch.zeros((k,), dtype=torch.float32, device=dev)}
        opt_state = init_adam_state(theta)
        resume_from = 0
        ckpt_meta = {"params": p.to_dict(), "n_features": n_features, "k": k}
        ckpt_epochs = resolve_epoch_checkpointing(p, checkpointer)
        if checkpointer is not None:
            step0, saved = checkpointer.load(expect_meta=ckpt_meta)
            if saved is not None:
                saved = streaming_linear_fit_state(saved)
                _load_into(theta, saved["theta"])
                _load_into(opt_state, saved["opt_state"])
                resume_from = step0
        pad_rows = session.pad_rows(p.chunk_rows)
        reg = float(np.float32(p.reg_param))
        lr = float(np.float32(p.step_size))
        n_steps = 0
        last_loss = None
        # defer: epoch 1 is ingest only and the loop runs one more pass, so
        # the replay carries all p.epochs passes. With a checkpointer only
        # at epoch granularity (snapshots between replay calls)
        ckpt_epoch_ok = p.replay_granularity == "epoch"
        defer = (p.defer_epoch1 and cache_device and p.epochs > 0
                 and (checkpointer is None or ckpt_epoch_ok)
                 and (resume_from == 0 or ckpt_epoch_ok))
        n_replay = p.epochs - 1 + (1 if defer else 0)
        cache = _DeviceCache(cache_device and (p.epochs > 1 or defer), cache_device_bytes)
        # bf16 halves the cached, spilled and copied X; the step widens it
        cache_bf16 = resolve_cache_dtype(p.cache_dtype, session) != "f32"
        spill: DiskChunkCache | None = None
        if cache_device and cache_spill_dir is not None and (p.epochs > 1 or defer):
            spill = DiskChunkCache(
                cache_spill_dir, ((pad_rows, n_features), (pad_rows,), (pad_rows,)),
                ("bfloat16" if cache_bf16 else np.float32, np.float32, np.float32))
        spill_active = [False]      # read by the prefetch thread
        use_disk = False
        h2d = _HostToDevice(dev)

        def put(Xp, yp, wp):
            """(X, y, w) on the device (a bf16 X as a bfloat16 tensor), and
            the copies' event."""
            out = [h2d.put(Xp), h2d.put(yp), h2d.put(wp)]
            event = h2d.done()
            if cache_bf16:
                out[0] = out[0].view(torch.bfloat16)
            return tuple(out), event

        def to_device(chunk):
            """Prefetch-thread side: pad, encode, spill, copy; the chunk's
            largest label rides along for the range check."""
            X_np, y_np, w_np = chunk
            Xp, yp, wp = _pad_chunk(X_np, y_np, w_np, pad_rows, n_features)
            if cache_bf16:
                Xp = bf16_bits_np(Xp)      # encoded once: spill, cache and copy
            if spill_active[0]:
                spill.append((Xp, yp, wp), X_np.shape[0])
            y_max = (int(np.max(y_np)) if p.loss == "logistic" and y_np is not None
                     and len(y_np) else None)
            dev_chunk, event = put(Xp, yp, wp)
            return (dev_chunk, y_max), event

        def staged(fn, items):
            for out, event in prefetch_map(fn, items, depth=2, stats_into=pipe_stats):
                yield h2d.ready(out, event)

        def read_record(i):
            arrs, _n = spill.read(i)
            return put(*arrs)

        def snapshot():
            return {"theta": theta, "opt_state": opt_state}

        def step(th, op, chunk):
            return _stream_step_into(th, op, chunk, reg, lr, p.loss, group)

        def run_step(chunk):
            nonlocal n_steps, last_loss
            with span("chunk", n_steps):
                last_loss = step(theta, opt_state, chunk)
                n_steps += 1
                bound_dispatch(n_steps, last_loss)   # the dispatch queue's cap
            if checkpointer is not None and not ckpt_epochs:
                checkpointer.maybe_save(n_steps, snapshot(), meta=ckpt_meta)

        def epoch_snapshot(epoch):
            # the non-finite guard BEFORE the save: a divergent epoch raises
            # typed and never checkpoints NaN state
            check_finite_training(last_loss, theta, epoch=epoch, chunk=n_steps,
                                  estimator="StreamingLinearEstimator")
            epoch_boundary_snapshot(checkpointer, ckpt_epochs, epoch, defer, n_steps,
                                    resume_from, snapshot, ckpt_meta)

        epoch_walls: list = []
        epoch_collectives: list = []

        def close_epoch(wall):
            epoch_walls.append(wall)
            epoch_collectives.append(collective_stats())

        replay_source = None
        graph_capture_s = None
        try:
            for epoch in span_iter("epoch", range(p.epochs + (1 if defer else 0))):
                t_epoch = time.perf_counter()
                if epoch > 0 and cache.enabled:
                    replay_source = "hbm"
                    for chunk in cache.batches:          # no host work at all
                        if n_steps < resume_from:
                            n_steps += 1
                            continue
                        run_step(chunk)
                    epoch_snapshot(epoch)
                    close_epoch(time.perf_counter() - t_epoch)
                    continue
                if epoch > 0 and use_disk:
                    # off the disk spill: read + copy, no parse; checkpointed
                    # records are skipped unread
                    replay_source = "disk"
                    skip = min(max(resume_from - n_steps, 0), spill.n_records)
                    n_steps += skip
                    for chunk in staged(read_record, iter(range(skip, spill.n_records))):
                        run_step(chunk)
                    epoch_snapshot(epoch)
                    close_epoch(time.perf_counter() - t_epoch)
                    continue
                if epoch > 0:
                    replay_source = "stream"
                spill_active[0] = epoch == 0 and spill is not None
                for chunk, y_max in staged(to_device, _rechunk(source(), pad_rows)):
                    if n_steps < resume_from and not (
                            epoch == 0 and (cache.enabled or spill is not None or defer)):
                        # checkpointed: fast-forward. Not while the cache or
                        # the spill is built (their chunks are kept even when
                        # the step is skipped), nor in a deferred ingest
                        # pass, which runs no step to count
                        n_steps += 1
                        continue
                    if y_max is not None and y_max >= k:
                        raise ValueError(
                            f"label {y_max} out of range for k={k} classes; set "
                            "n_classes= (or pass class_values=) to the true class count")
                    if epoch == 0:
                        cache.offer(chunk)
                    if epoch == 0 and defer:
                        continue            # ingest only: no step
                    if n_steps < resume_from:
                        n_steps += 1        # fast-forward past checkpointed steps
                        continue
                    run_step(chunk)
                spill_active[0] = False
                epoch_snapshot(epoch)
                if epoch == 0:
                    if spill is not None:
                        spill.finalize()
                    # no excludable tail here: an over-budget offer latched
                    # the overflow where it happened
                    cache.settle()
                    if cache.degraded and (p.epochs > 1 or defer):
                        use_disk = spill is not None and spill.n_records > 0
                        if not use_disk:
                            warn_cache_overflow(cache_device_bytes, n_replay)
                if stage_times is not None:
                    session.synchronize()
                close_epoch(time.perf_counter() - t_epoch)
                if (epoch == 0 and n_replay > 0 and cache.enabled and cache.batches
                        and ((checkpointer is None and resume_from == 0) or ckpt_epoch_ok)
                        # the reference's gate for its stacked copy of the cache
                        and 2 * cache.nbytes <= cache_device_bytes
                        # whole epochs are the fused replay's resume grain; a
                        # snapshot off an epoch boundary replays chunk by chunk
                        and resume_from % len(cache.batches) == 0):
                    t_rep = time.perf_counter()
                    replay = _Replay(theta, opt_state, cache.batches, step)
                    n_steps, last, graph_capture_s = replay_epochs(
                        replay, lambda: replay.losses[-1], n_replay, len(cache.batches),
                        n_steps, capture=dev.type == "cuda" and group is None,
                        granularity=p.replay_granularity,
                        epochs_per_dispatch=p.epochs_per_dispatch, resume_from=resume_from,
                        checkpointer=checkpointer, snapshot=snapshot, ckpt_meta=ckpt_meta,
                        every_epochs=ckpt_epochs)
                    if last is not None:
                        last_loss = last
                    if graph_capture_s is not None:
                        replay_source = ("fused_epoch" if p.replay_granularity == "epoch"
                                         else "fused")
                        if stage_times is not None:
                            session.synchronize()
                        close_epoch(time.perf_counter() - t_rep)
                    del replay
                    break
        finally:
            if spill is not None:
                spill.delete()
        # the fused replay leaves the loop before another guard: a final
        # check, of theta too (a last-step divergence shows only there)
        check_finite_training(last_loss, theta, epoch=p.epochs - 1, chunk=n_steps,
                              final=True, estimator="StreamingLinearEstimator")
        model = self._wrap_model(theta, k, class_values)
        model.n_steps_ = n_steps
        model.final_loss_ = float(last_loss) if last_loss is not None else None
        prof.attach_fit_report(report, acc, cache_key=cache.ledger_key)
        if report is not None:
            report.stage_times.update(n_steps=n_steps, replay_source=replay_source)
            model.run_report_ = report.finish()
        if stage_times is not None:
            stage_times.update(epoch_s=epoch_walls, epoch_collectives=epoch_collectives,
                               n_steps=n_steps,
                               replay_source=replay_source, retries=pipe_stats.retries,
                               cache_bytes=cache.nbytes, cache_chunks=len(cache.batches),
                               cache_dtype="bf16" if cache_bf16 else "f32",
                               graph_capture_s=graph_capture_s)
        if checkpointer is not None:
            # a finished fit's snapshot must not fast-forward a later fit
            checkpointer.delete()
        return model

    def _wrap_model(self, theta: dict, k: int, class_values=None):
        p = self.params
        if p.loss == "logistic":
            from orange3_spark_tpu_torch.models.logistic_regression import (
                LogisticRegressionModel, LogisticRegressionParams,
            )

            return LogisticRegressionModel(
                LogisticRegressionParams(), theta["coef"], theta["intercept"],
                class_values or tuple(str(i) for i in range(k)))
        if p.loss == "squared":
            from orange3_spark_tpu_torch.models.linear_regression import (
                LinearRegressionModel, LinearRegressionParams,
            )

            return LinearRegressionModel(LinearRegressionParams(), theta["coef"][:, 0],
                                         theta["intercept"][0])
        from orange3_spark_tpu_torch.models.linear_svc import LinearSVCModel, LinearSVCParams

        return LinearSVCModel(LinearSVCParams(), theta["coef"], theta["intercept"],
                              class_values or ("0", "1"))


# ------------------------------------------------- feature statistics pass
_F32_MAX = float(np.finfo(np.float32).max)


def _device_put(h2d, chunk_np: tuple):
    """(device tensors of ``chunk_np``, the copies' event), on the
    prefetch thread (``models/hashed_linear._HostToDevice``)."""
    return tuple(h2d.put(a) for a in chunk_np), h2d.done()


def _feature_stats_step(acc: dict, X, w, *, gramian: bool) -> None:
    """Fold one padded chunk into the running per-column stats, in place
    (and the weighted Gramian when asked: one product per chunk). Moments
    accumulate on Z = X - shift (shift ≈ the data's column means, taken
    from the first chunk): the single-pass identity var = E[z²] - E[z]² is
    catastrophically cancellative in f32 when mean² ≫ var (epoch
    timestamps: mean ~1.5e9, std ~1e5 keep ZERO variance bits unshifted),
    and near-zero-mean Z restores them. min/max stay on the raw X."""
    live = (w > 0)[:, None]
    Z = X - acc["shift"][None, :]
    wZ = Z * w[:, None]
    acc["n"] += w.sum()
    acc["s"] += wZ.sum(dim=0)
    acc["ss"] += (wZ * Z).sum(dim=0)
    torch.minimum(acc["mn"], torch.where(live, X, _F32_MAX).amin(dim=0), out=acc["mn"])
    torch.maximum(acc["mx"], torch.where(live, X, -_F32_MAX).amax(dim=0), out=acc["mx"])
    if gramian:
        acc["g"] += Z.T @ wZ


def _observed(X, w, mv: float):
    miss = torch.isnan(X) if np.isnan(mv) else (X == mv)
    return (~miss) & (w > 0)[:, None]


def _feature_stats_step_missing(acc: dict, X, w, mv: float) -> None:
    """The missing-aware fold (the streaming Imputer fit): per-CELL
    observation masks, so a missing cell drops out of that column's
    count/sum/min/max without killing the row for other columns. Same
    shifted accumulation as ``_feature_stats_step``."""
    obs = _observed(X, w, mv)
    Z = torch.where(obs, X - acc["shift"][None, :], 0.0)
    wobs = torch.where(obs, w[:, None], 0.0)
    wZ = Z * wobs
    acc["n"] += wobs.sum(dim=0)
    acc["s"] += wZ.sum(dim=0)
    acc["ss"] += (wZ * Z).sum(dim=0)
    torch.minimum(acc["mn"], torch.where(obs, X, _F32_MAX).amin(dim=0), out=acc["mn"])
    torch.maximum(acc["mx"], torch.where(obs, X, -_F32_MAX).amax(dim=0), out=acc["mx"])


def _first_chunk_shift(X, w):
    """Weighted column means of the first chunk, the accumulation shift
    (any vector near the data's location works; an all-dead chunk -> 0)."""
    tot = w.sum()
    s = (X * w[:, None]).sum(dim=0)
    return torch.where(tot > 0, s / torch.clamp_min(tot, 1e-12), 0.0)


def _first_chunk_shift_missing(X, w, mv: float):
    """Missing-aware shift: per-column observed means (a NaN missing value
    would poison the plain shift, a sentinel like -999 drag it off)."""
    obs = _observed(X, w, mv)
    wobs = torch.where(obs, w[:, None], 0.0)
    tot = wobs.sum(dim=0)
    s = (torch.where(obs, X, 0.0) * wobs).sum(dim=0)
    return torch.where(tot > 0, s / torch.clamp_min(tot, 1e-12), 0.0)


def stream_feature_stats(source: Callable[[], Iterator[Chunk]], *, session=None,
                         chunk_rows: int = 1 << 18, gramian: bool = False,
                         missing_value: float | None = None,
                         stage_times: dict | None = None) -> dict:
    """Single-pass per-column statistics over a chunk stream: the
    out-of-core fit of the feature transformers and PCA (BASELINE config 5,
    the taxi pipeline).

    One in-place fold per chunk into f32 accumulators on the device
    (``gramian=True`` adds one [chunk, d]ᵀ @ [chunk, d] product per chunk);
    the pad and host-to-device copy of chunk t+1 overlap the fold of chunk
    t (``prefetch_map``); accumulation is shifted by the first chunk's
    column means (see ``_feature_stats_step``). Returns host values:
    ``count`` (total weight), ``mean``, ``var`` (population, as
    ``ops.stats.weighted_moments``), ``min``/``max`` over live rows, and
    with ``gramian=True`` the population ``cov`` (E[(x-μ)(x-μ)ᵀ]) and the
    raw ``second_moment`` (E[x·xᵀ]).

    ``missing_value`` (NaN or a sentinel float) switches to per-CELL
    observation masks (the streaming Imputer fit); ``count`` is then a
    per-column array. Incompatible with ``gramian``.

    ``stage_times`` receives ``overlap_pct`` (the measured host-prep /
    device-fold overlap) and ``dispatches`` (folds run)."""
    if missing_value is not None and gramian:
        raise ValueError("gramian=True and missing_value are incompatible")
    from orange3_spark_tpu_torch.core.session import TorchSession
    from orange3_spark_tpu_torch.models.hashed_linear import _HostToDevice
    from orange3_spark_tpu_torch.resilience.retry import resilient_source
    from orange3_spark_tpu_torch.utils.dispatch import bound_dispatch

    session = session or TorchSession.builder_get_or_create()
    session.require_fold("stream_feature_stats")
    pad_rows = session.pad_rows(chunk_rows)
    h2d = _HostToDevice(session.device)

    def prep(chunk):
        X_np, _, w_np = chunk
        Xp, _, wp = _pad_chunk(X_np, None, w_np, pad_rows, X_np.shape[1])
        return _device_put(h2d, (Xp, wp))

    acc = None
    pstats = PipelineStats()
    # transient source-read faults: bounded retries on the prefetch thread
    source = resilient_source(source, stats=pstats)
    n_folds = 0
    for step, (chunk, event) in enumerate(
            prefetch_map(prep, _rechunk(source(), pad_rows), depth=2, stats_into=pstats)):
        Xd, wd = _HostToDevice.ready(chunk, event)
        if acc is None:
            d = Xd.shape[1]
            dev = Xd.device
            shift = (_first_chunk_shift_missing(Xd, wd, missing_value)
                     if missing_value is not None else _first_chunk_shift(Xd, wd))
            acc = {
                "shift": shift,
                "n": torch.zeros((d,) if missing_value is not None else (),
                                 dtype=torch.float32, device=dev),
                "s": torch.zeros((d,), dtype=torch.float32, device=dev),
                "ss": torch.zeros((d,), dtype=torch.float32, device=dev),
                "mn": torch.full((d,), _F32_MAX, dtype=torch.float32, device=dev),
                "mx": torch.full((d,), -_F32_MAX, dtype=torch.float32, device=dev),
                **({"g": torch.zeros((d, d), dtype=torch.float32, device=dev)}
                   if gramian else {}),
            }
        if missing_value is not None:
            _feature_stats_step_missing(acc, Xd, wd, missing_value)
        else:
            _feature_stats_step(acc, Xd, wd, gramian=gramian)
        n_folds = step + 1
        bound_dispatch(n_folds, acc["n"], period=8)
    if acc is None:
        raise ValueError("stream produced no chunks")
    if stage_times is not None:
        stage_times["overlap_pct"] = round(pstats.overlap_pct, 1)
        stage_times["dispatches"] = n_folds
    host = {k: v.cpu().numpy() for k, v in acc.items()}
    # a scalar total weight normally, a per-column observed weight under
    # missing_value: the same formulas broadcast over both
    n_raw = np.asarray(host["n"], np.float64)
    n = np.maximum(n_raw, 1e-12)
    shift = np.asarray(host["shift"], np.float64)
    mean_z = np.asarray(host["s"], np.float64) / n
    var = np.maximum(np.asarray(host["ss"], np.float64) / n - mean_z ** 2, 0.0)
    mean = shift + mean_z
    mn, mx = host["mn"], host["mx"]
    if n.ndim:
        # missing mode: an all-missing column has no mean, fill 0 (the
        # in-memory Imputer's convention); min/max too, not the ±FLT_MAX
        # accumulator sentinels
        dead = n_raw <= 0
        mean[dead] = 0.0
        var[dead] = 0.0
        mn, mx = mn.copy(), mx.copy()
        mn[dead] = 0.0
        mx[dead] = 0.0
    out = {
        # the UNCLAMPED weight: an all-missing column / empty stream reports 0
        "count": float(n_raw) if n_raw.ndim == 0 else n_raw.astype(np.float32),
        "mean": mean.astype(np.float32),
        "var": var.astype(np.float32),
        "min": mn,
        "max": mx,
    }
    if gramian:
        # Gz/n = E[z zᵀ]; the centered cov is shift-invariant:
        #   cov = E[z zᵀ] - μz μzᵀ
        # and the raw second moment restores the shift:
        #   E[x xᵀ] = E[z zᵀ] + c μzᵀ + μz cᵀ + c cᵀ
        Ezz = np.asarray(host["g"], np.float64) / n
        out["cov"] = (Ezz - np.outer(mean_z, mean_z)).astype(np.float32)
        out["second_moment"] = (Ezz + np.outer(shift, mean_z) + np.outer(mean_z, shift)
                                + np.outer(shift, shift)).astype(np.float32)
    return out


def score_stream(score_fn, source: Callable[[], Iterator[Chunk]], out_path: str, *,
                 session=None, chunk_rows: int = 1 << 18,
                 feature_names: tuple | None = None,
                 prediction_col: str = "prediction",
                 include_features: bool = True,
                 row_group_rows: int | None = None) -> int:
    """Streaming ``model.transform(df).write.parquet(path)``: score a chunk
    stream and write the results one parquet row group at a time, so host
    memory stays bounded by the chunk size at any output scale.

    ``score_fn(X_device) -> [n] or [n, k]`` per padded chunk (a fitted
    model's prediction head); each chunk's scores are trimmed of padding
    (and of rows whose weight is 0) and appended through one
    ``pyarrow.ParquetWriter``; the copy of chunk t+1 to the device overlaps
    the scoring of chunk t. Columns: the features (``feature_names`` or
    ``f0..``; none with ``include_features=False``), the label when the
    source carries one, and ``prediction_col`` (``_0.._k-1`` suffixes for
    [n, k] scores). Returns the row count written; the file appears
    atomically (tmp + rename)."""
    import pyarrow as pa
    from pyarrow import parquet as pq

    from orange3_spark_tpu_torch.core.session import TorchSession
    from orange3_spark_tpu_torch.models.hashed_linear import _HostToDevice
    from orange3_spark_tpu_torch.resilience.retry import resilient_source
    from orange3_spark_tpu_torch.utils.dispatch import bound_dispatch

    if feature_names and not include_features:
        raise ValueError("feature_names conflicts with include_features=False")
    session = session or TorchSession.builder_get_or_create()
    source = resilient_source(source)
    pad_rows = session.pad_rows(chunk_rows)
    h2d = _HostToDevice(session.device)

    def prep(chunk):
        X_np, y_np, w_np = chunk
        Xp, _, _ = _pad_chunk(X_np, None, None, pad_rows, X_np.shape[1])
        (Xd,), event = _device_put(h2d, (Xp,))
        return Xd, event, X_np, y_np, w_np, len(X_np)

    writer = None
    names: list = []
    tmp = f"{out_path}.tmp{os.getpid()}"
    total = 0
    ok = False
    label_in_schema = False
    try:
        for step, (Xd, event, X_np, y_np, w_np, n) in enumerate(prefetch_map(
                prep, _rechunk(source(), pad_rows), depth=2)):
            Xd = _HostToDevice.ready(Xd, event)
            scores_d = score_fn(Xd)
            bound_dispatch(step + 1, scores_d, period=8)
            scores = scores_d.cpu().numpy()[:n]
            if w_np is not None:          # masked rows stay out of the output
                live = np.asarray(w_np) > 0
                X_np, scores = X_np[live], scores[live]
                y_np = None if y_np is None else y_np[live]
                n = len(X_np)
            if writer is not None and (y_np is None) == label_in_schema:
                # the first chunk fixes the parquet schema
                raise ValueError(
                    f"chunk {step} is {'un' if y_np is None else ''}labeled "
                    f"but the schema-defining first chunk was "
                    f"{'' if label_in_schema else 'un'}labeled — a stream's "
                    "label presence must be uniform across chunks")
            if writer is None:
                d = X_np.shape[1]
                names = (list(feature_names) if feature_names
                         else [f"f{j}" for j in range(d)] if include_features else [])
                if include_features and len(names) != d:
                    raise ValueError(f"{len(names)} feature_names for {d} columns")
                label_in_schema = y_np is not None
                if y_np is not None:
                    names.append("label")
                if scores.ndim == 2:
                    names += [f"{prediction_col}_{j}" for j in range(scores.shape[1])]
                else:
                    names.append(prediction_col)
                writer = pq.ParquetWriter(
                    tmp, pa.schema([pa.field(c, pa.float32()) for c in names]))
            if n == 0:
                continue   # fully masked chunk: the schema exists, nothing to write
            cols = [X_np[:, j] for j in range(X_np.shape[1])] if include_features else []
            if y_np is not None:
                cols.append(np.asarray(y_np, np.float32))
            if scores.ndim == 2:
                cols += [scores[:, j] for j in range(scores.shape[1])]
            else:
                cols.append(scores)
            table = pa.table([pa.array(np.asarray(c, np.float32)) for c in cols],
                             names=names)
            writer.write_table(table, row_group_size=row_group_rows or n)
            total += n
        if writer is None:
            raise ValueError("stream produced no chunks")
        ok = True
    finally:
        if writer is not None:
            writer.close()
        if not ok:
            try:
                os.unlink(tmp)   # no orphans from a failed run
            except OSError:
                pass
    os.replace(tmp, out_path)
    return total


# ------------------------------------------------------- streaming KMeans

@dataclasses.dataclass(frozen=True)
class StreamingKMeansParams(Params):
    k: int = 8
    epochs: int = 1
    chunk_rows: int = 1 << 18
    decay: float = 1.0           # MLlib StreamingKMeans decayFactor
    seed: int = 0
    # Defer epoch-1 updates into the replay: pass 0 seeds the centers and
    # ingests into the cache/spill with no update, then the replay carries
    # all ``epochs`` passes. Identical to the default schedule except for
    # batches streamed BEFORE the first live chunk seeded the centers
    # ("pre-seed" batches): the default's epoch 1 skips their update while
    # its replay epochs step them (a no-op for centers, a decay tick for
    # counts); under defer every pass is a replay pass, so pre-seed batches
    # get ``epochs`` decay ticks instead of ``epochs - 1``.
    defer_epoch1: bool = False
    # 'all': every replay pass in one call (one captured epoch replayed
    # ``epochs - 1`` times); 'epoch': ``epochs_per_dispatch`` epochs a call
    # through ``run_epoch_replay``
    replay_granularity: str = "all"   # 'all' | 'epoch'
    epochs_per_dispatch: int = 1


def _kmeans_stream_step(centers, counts, X, w, decay: float, k: int):
    """One aggregated mini-batch update (Sculley 2010 / MLlib
    StreamingKMeans), in place: per-center sums from this chunk fold into
    the running counts with decay. Returns the chunk's cost (a device
    scalar)."""
    from orange3_spark_tpu_torch.models.kmeans import _assign

    assign, cost = _assign(X, centers, w)
    onehot = (assign[:, None] == torch.arange(k, dtype=torch.int32, device=X.device)
              ).to(torch.float32) * w[:, None]
    n_i = onehot.sum(dim=0)                       # [k]
    sum_i = onehot.T @ X                          # [k, d]
    new_counts = decay * counts + n_i
    new_centers = torch.where(
        n_i[:, None] > 0,
        centers + (sum_i - n_i[:, None] * centers)
        / torch.clamp_min(new_counts, 1e-12)[:, None],
        centers)
    centers.copy_(new_centers)
    counts.copy_(new_counts)
    return cost


class _KMeansReplay(EpochReplay):
    """Replay epochs over the cached epoch-1 chunks: one step a chunk, in
    order, on centers and counts updated in place. On CUDA ``capture()``
    records one epoch as a CUDA graph (every step's kernels, reading the
    chunks where they lie in the cache) and ``run(n)`` replays it n times
    (the fit's ``models/hashed_linear._Replay`` recipe); uncaptured (the
    CPU) ``run`` runs the same steps one by one. A failed capture raises."""

    def __init__(self, centers, counts, chunks: list, decay: float, k: int):
        super().__init__()
        self.centers, self.counts, self.chunks = centers, counts, chunks
        self.decay, self.k = decay, k

    def _epoch(self) -> None:
        for Xd, wd, _pre_seed in self.chunks:
            _kmeans_stream_step(self.centers, self.counts, Xd, wd, self.decay, self.k)

    def capture(self) -> None:
        X0, w0, _ = self.chunks[0]
        self.graph, _, _ = capture_graph(
            self._epoch, self.centers.device,
            warm=lambda: _kmeans_stream_step(self.centers.clone(), self.counts.clone(),
                                             X0, w0, self.decay, self.k))


class StreamingKMeans(Estimator):
    """Out-of-core KMeans over a chunk stream (the NYC-Taxi path), MLlib's
    StreamingKMeans role: aggregated mini-batch center updates with a decay
    factor, returning the standard KMeansModel.

    Schedules (``fit_stream``): every epoch re-streams the source (the
    default); ``cache_device`` keeps epoch 1's device chunks and replays
    epochs 2+ from them (one captured CUDA graph an epoch on the card);
    past ``cache_device_bytes`` with ``cache_spill_dir`` the replay reads
    epoch 1's disk spill; ``defer_epoch1`` makes pass 0 ingest-only;
    ``replay_granularity`` picks one call or one call per
    ``epochs_per_dispatch`` epochs for the cached replay."""

    ParamsCls = StreamingKMeansParams
    params: StreamingKMeansParams

    def _fit(self, table):
        X, _, W = table.to_numpy()
        return self.fit_stream(array_chunk_source(X, None, W, chunk_rows=self.params.chunk_rows),
                               n_features=X.shape[1], session=table.session)

    @traced("fit", model="streaming_kmeans")
    def fit_stream(self, source: Callable[[], Iterator[Chunk]], *, n_features: int,
                   session=None, cache_device: bool = False,
                   cache_device_bytes: int = 8 << 30,
                   cache_spill_dir: str | None = None):
        from orange3_spark_tpu_torch.core.session import TorchSession
        from orange3_spark_tpu_torch.models.kmeans import (
            KMeansModel, KMeansParams, kmeanspp_seed,
        )
        from orange3_spark_tpu_torch.resilience.numerics import check_finite_training
        from orange3_spark_tpu_torch.resilience.retry import resilient_source
        from orange3_spark_tpu_torch.utils.dispatch import bound_dispatch

        (session or TorchSession.active()).require_fold(type(self).__name__)
        p = self.params
        if p.replay_granularity not in ("all", "epoch"):
            raise ValueError(f"replay_granularity must be 'all' or 'epoch', "
                             f"got {p.replay_granularity!r}")
        report = (RunReport("fit_stream", estimator=type(self).__name__,
                            k=p.k, epochs=p.epochs)
                  if obs_enabled() else None)
        # goodput accountant (obs/prof.py), fed by the dispatch and
        # prefetch chokepoints; None under OTPU_PROF=0
        acc = prof.begin_fit()
        source = resilient_source(source)
        session = session or TorchSession.active()
        dev = session.device
        pad_rows = session.pad_rows(p.chunk_rows)
        rng = np.random.default_rng(p.seed)
        centers = None
        counts = torch.zeros((p.k,), dtype=torch.float32, device=dev)
        n_steps = 0
        # defer: pass 0 seeds + ingests only; the loop runs one extra pass
        # and the replay carries all p.epochs update passes
        defer = p.defer_epoch1 and cache_device and p.epochs > 0
        n_replay = p.epochs - 1 + (1 if defer else 0)
        cache = _DeviceCache(cache_device and (p.epochs > 1 or defer), cache_device_bytes)
        spill: DiskChunkCache | None = None
        if cache_device and cache_spill_dir is not None and (p.epochs > 1 or defer):
            spill = DiskChunkCache(cache_spill_dir, ((pad_rows, n_features), (pad_rows,)))
        use_disk = False

        def step(Xd, wd):
            nonlocal n_steps
            with span("chunk", n_steps):
                cost = _kmeans_stream_step(centers, counts, Xd, wd, p.decay, p.k)
                n_steps += 1
                bound_dispatch(n_steps, cost)   # queue cap (utils/dispatch.py)

        for epoch in span_iter("epoch", range(p.epochs + (1 if defer else 0))):
            if epoch > 0 and use_disk:
                # epochs 2+ from the disk spill: the read and copy of record
                # t+1 overlap the device step on record t
                def _rec(i):
                    arrs, _n = spill.read(i)
                    return (torch.from_numpy(np.array(arrs[0])).to(dev),
                            torch.from_numpy(np.array(arrs[1])).to(dev))

                for Xd, wd in prefetch_map(_rec, iter(range(spill.n_records)), depth=2):
                    step(Xd, wd)
                check_finite_training(None, centers, epoch=epoch, chunk=n_steps,
                                      estimator="StreamingKMeans")
                continue
            for X_np, _, w_np in _rechunk(source(), pad_rows):
                n = X_np.shape[0]
                pre_seed = False
                if centers is None:
                    # kmeans++ seeding on (a capped sample of) the first live chunk
                    live = (np.arange(n) if w_np is None
                            else np.flatnonzero(np.asarray(w_np) > 0))
                    if len(live) < 1:
                        # no live rows to seed from: the batch is skipped THIS
                        # epoch but still enters the cache/spill (streamed
                        # epochs 2+ would step it)
                        pre_seed = True
                        if not cache.enabled and spill is None:
                            continue
                    else:
                        if len(live) > 8192:
                            live = rng.choice(live, 8192, replace=False)
                        centers = torch.from_numpy(kmeanspp_seed(
                            np.asarray(X_np, np.float32)[live], p.k, rng)).to(dev)
                Xp, _, wp = _pad_chunk(X_np, None, w_np, pad_rows, n_features)
                if epoch == 0 and spill is not None:
                    spill.append((Xp, wp), n)
                Xd = torch.from_numpy(Xp).to(dev)
                wd = torch.from_numpy(wp).to(dev)
                if epoch == 0:
                    cache.offer((Xd, wd, pre_seed))
                if pre_seed or (epoch == 0 and defer):
                    continue        # defer: the ingest-only pass
                step(Xd, wd)
            if epoch > 0 and centers is not None:
                check_finite_training(None, centers, epoch=epoch, chunk=n_steps,
                                      estimator="StreamingKMeans")
            if epoch == 0:
                if centers is None:
                    raise ValueError("stream produced no live rows")
                if spill is not None:
                    spill.finalize()
                if cache.degraded and (p.epochs > 1 or defer):
                    use_disk = spill is not None and spill.n_records > 0
                    if not use_disk:
                        warn_cache_overflow(cache_device_bytes, n_replay)
            if epoch == 0 and n_replay > 0 and cache.enabled and cache.batches:
                # the remaining passes replay the cache: one captured epoch
                # on the card, read in place (no stacked copy)
                replay = _KMeansReplay(centers, counts, cache.batches, p.decay, p.k)
                n_steps, _, _ = replay_epochs(
                    replay, lambda: centers, n_replay, len(cache.batches), n_steps,
                    capture=dev.type == "cuda", granularity=p.replay_granularity,
                    epochs_per_dispatch=p.epochs_per_dispatch)
                break
        if spill is not None:
            spill.delete()
        # one final non-finite guard (typed divergence, not NaN centers)
        check_finite_training(None, centers, epoch=p.epochs - 1, chunk=n_steps, final=True,
                              estimator="StreamingKMeans")
        model = KMeansModel(KMeansParams(k=p.k), centers)
        model.n_iter_ = n_steps
        prof.attach_fit_report(report, acc, cache_key=cache.ledger_key)
        if report is not None:
            report.stage_times["n_steps"] = n_steps
            model.run_report_ = report.finish()
        # training_cost_ stays None: a per-chunk cost is NOT the full-data
        # trainingCost the attribute means (use model.compute_cost(table))
        return model
