"""Out-of-core streaming: chunk sources, prefetch and the device chunk cache.

The chunk pipeline of a streaming fit:

    native fastcsv chunk (C++ threads, f32 row-major)
      -> pad, encode (io/codec.py), spill (prefetch thread)
      -> pinned host copy -> device (on a copy stream, prefetch thread)
      -> one update step per chunk on the device

Every chunk is padded to the same row count, so the step sees one shape for
the whole stream, and the host prepares chunk t+1 while the device runs
step t. This module holds the host side of that pipeline: re-iterable
sources, rechunking and padding, the prefetch thread, the budgeted cache
that keeps epoch 1's device chunks for the replay epochs, and the disk
spill that replays them when the cache overflows.
"""

from __future__ import annotations

import json
import os
import struct
import uuid
import warnings
import weakref
import zlib
from typing import Callable, Iterator

import numpy as np
import torch

from orange3_spark_tpu_torch.exec.pipeline import PipelineStats, prefetch_iter
from orange3_spark_tpu_torch.io.codec import SpillCorruptionError

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
        self._f.write(struct.pack("<II", int(n_valid), crc & 0xFFFFFFFF))
        written = 8
        for a, ofs, nb in zip(arrs, self._offsets, self._field_bytes):
            if ofs > written:
                self._f.write(b"\0" * (ofs - written))
            a.tofile(self._f)
            written = ofs + nb
        if self.record_bytes > written:
            self._f.write(b"\0" * (self.record_bytes - written))
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
                raise SpillCorruptionError(
                    f"spill record {i} of {self.n_records} in {self.path!r} failed "
                    f"CRC verification (stored 0x{stored:08x} != computed "
                    f"0x{computed:08x}): the record was corrupted on disk. Delete the "
                    "spill and re-run the fit (OTPU_RESILIENCE=0 skips verification).")
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
