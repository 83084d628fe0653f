"""Append-only request/label log + bounded-window label joiner.

The continuous-learning loop (``online/``) trains on what the fleet
actually served, so the serving tap appends every scored request chunk —
and every later-arriving label chunk — to one append-only record stream
a background trainer tails. The format is the ``OTPUSPL1`` spill
family's (io/streaming.py DiskChunkCache): a magic + 8-byte-padded JSON
header, then self-delimiting records, every field 8-byte aligned, a
per-record CRC32 over the payload. Differences forced by the workload:

* records are VARIABLE length (request chunks carry ``[n, n_cols]``
  features, label chunks carry ``[n]`` targets), so each record leads
  with its own fixed 32-byte header;
* the file is tailed while being appended: the reader treats a partial
  trailing record as "end of stream so far" (a crash mid-append loses at
  most that record), while a CRC mismatch on a COMPLETE record raises a
  typed :class:`RequestLogCorruptionError` naming the ordinal — the
  silent alternative is a trainer learning from bit-flipped features.

Record layout (little-endian, 32-byte header)::

    u32 kind          0 = request chunk, 1 = label chunk
    u32 n_rows
    u32 n_cols        label records: 1
    u32 payload_len   bytes of f32 payload that follow the header
    u64 req_id        id of the chunk (labels join on it)
    u32 crc32         CRC32 of the payload bytes
    u32 reserved      zero (the v1->v2 spill lesson: leave room)
    payload           n_rows*n_cols f32, zero-padded to 8-byte alignment

**Label joining** is deterministic and bounded: a request chunk waits in
the join window (``OTPU_ONLINE_JOIN_WINDOW`` chunks) for the label chunk
carrying its ``req_id``. Outcomes are typed and counted
(``otpu_online_labels_total{outcome=}``): ``joined`` (features+labels
emitted to the trainer), ``late`` (the label arrived after its request
was evicted from the window), ``orphan`` (a label whose ``req_id`` was
never logged — a feedback-pipeline bug surfaced, not swallowed).
"""

from __future__ import annotations

import os
import struct
import threading
import zlib

import numpy as np

from orange3_spark_tpu_torch.obs.registry import REGISTRY

__all__ = [
    "LabelJoiner",
    "RequestLog",
    "RequestLogCorruptionError",
]

MAGIC = b"OTPURQL1"
_HEADER = struct.Struct("<IIIIQII")          # kind,rows,cols,len,id,crc,rsvd
KIND_REQUEST = 0
KIND_LABEL = 1

_M_LABELS = REGISTRY.counter(
    "otpu_online_labels_total",
    "label-join outcomes in the online request log (joined/late/orphan)")


class RequestLogCorruptionError(RuntimeError):
    """A complete request-log record failed its CRC (or carries an
    impossible geometry). Names the record ordinal and byte offset —
    the trainer must stop, not learn from bit-flipped features."""

    def __init__(self, *, ordinal: int, offset: int, path: str,
                 detail: str = ""):
        self.ordinal = ordinal
        self.offset = offset
        self.path = path
        super().__init__(
            f"request log {path!r} record {ordinal} (byte offset "
            f"{offset}) failed integrity verification"
            f"{': ' + detail if detail else ''}. The log is append-only; "
            "truncate to the last good record or start a fresh log.")


def _pad8(n: int) -> int:
    return (8 - n % 8) % 8


class RequestLog:
    """Append-only CRC'd record stream of served requests + labels.

    ``append_request``/``append_label`` are thread-safe (one lock, one
    write+flush per record — the tap rides the serving path, so the
    record is prepared outside the lock). ``read_from(byte_offset)``
    yields complete records from that offset and returns; the trainer
    re-calls it to tail. The byte offset it reports per record is the
    offset of the NEXT record — exactly what a resume checkpoint
    stores."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._next_req_id = 0
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        import json

        header = json.dumps({"version": 1, "fields": "var"}).encode()
        pre = MAGIC + struct.pack("<Q", len(header)) + header
        pre += b"\0" * _pad8(len(pre))
        # append mode: an existing log is resumed, never truncated
        self._f = open(path, "ab")
        if self._f.tell() == 0:
            self._f.write(pre)
            self._f.flush()
        self.data_start = len(pre)

    # ----------------------------------------------------------- append
    def _append(self, kind: int, req_id: int, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr, np.float32)
        if arr.ndim == 1:
            arr = arr[:, None]
        payload = arr.tobytes()
        rec = _HEADER.pack(kind, arr.shape[0], arr.shape[1], len(payload),
                           req_id, zlib.crc32(payload), 0)
        blob = rec + payload + b"\0" * _pad8(len(payload))
        with self._lock:
            self._f.write(blob)
            self._f.flush()

    def append_request(self, X: np.ndarray, *,
                       req_id: int | None = None) -> int:
        """Log one served request chunk; returns its req_id (auto-
        assigned monotonically unless given)."""
        with self._lock:
            if req_id is None:
                req_id = self._next_req_id
            self._next_req_id = max(self._next_req_id, req_id + 1)
        self._append(KIND_REQUEST, req_id, np.asarray(X))
        return req_id

    def append_label(self, req_id: int, y: np.ndarray) -> None:
        self._append(KIND_LABEL, int(req_id), np.asarray(y))

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass

    @property
    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    # ------------------------------------------------------------- read
    def read_from(self, offset: int = 0, *, verify: bool | None = None):
        """Yield ``(next_offset, ordinal, kind, req_id, array)`` for every
        COMPLETE record at/after byte ``offset`` (0 = first record). A
        partial trailing record ends the scan (appender mid-write); a
        corrupt complete record raises typed. ``verify=None`` follows the
        resilience kill-switch (the spill-CRC convention)."""
        if verify is None:
            from orange3_spark_tpu_torch.resilience.faults import (
                resilience_enabled,
            )

            verify = resilience_enabled()
        offset = max(int(offset), self.data_start)
        with open(self.path, "rb") as f:
            f.seek(0, os.SEEK_END)
            end = f.tell()
            f.seek(offset)
            ordinal = 0
            while offset + _HEADER.size <= end:
                hdr = f.read(_HEADER.size)
                if len(hdr) < _HEADER.size:
                    return
                kind, rows, cols, plen, req_id, crc, _rsvd = \
                    _HEADER.unpack(hdr)
                body = plen + _pad8(plen)
                if offset + _HEADER.size + body > end:
                    return                      # partial tail: stop here
                payload = f.read(plen)
                f.seek(_pad8(plen), os.SEEK_CUR)
                if verify:
                    if (kind not in (KIND_REQUEST, KIND_LABEL)
                            or rows * cols * 4 != plen):
                        raise RequestLogCorruptionError(
                            ordinal=ordinal, offset=offset, path=self.path,
                            detail=f"impossible geometry kind={kind} "
                                   f"rows={rows} cols={cols} len={plen}")
                    if zlib.crc32(payload) != crc:
                        raise RequestLogCorruptionError(
                            ordinal=ordinal, offset=offset, path=self.path,
                            detail="payload CRC mismatch")
                arr = np.frombuffer(payload, np.float32).reshape(rows, cols)
                offset += _HEADER.size + body
                yield offset, ordinal, kind, req_id, arr
                ordinal += 1


class LabelJoiner:
    """Deterministic bounded-window join of label chunks onto request
    chunks (module doc). Feed records in log order via :meth:`offer`;
    joined ``(X, y)`` example chunks come back. State (pending window +
    outcome counts) pickles with the trainer checkpoint, so a resumed
    trainer joins exactly as the killed one would have."""

    def __init__(self, window: int):
        self.window = max(1, int(window))
        self.pending: dict[int, np.ndarray] = {}   # req_id -> X (ordered)
        self.evicted: set[int] = set()
        self.counts = {"joined": 0, "late": 0, "orphan": 0}

    def offer(self, kind: int, req_id: int, arr: np.ndarray):
        """Returns ``(X, y)`` when this record completes a join, else
        None."""
        if kind == KIND_REQUEST:
            self.pending[req_id] = arr
            while len(self.pending) > self.window:
                old = next(iter(self.pending))
                del self.pending[old]
                self.evicted.add(old)
            return None
        X = self.pending.pop(req_id, None)
        if X is None:
            outcome = "late" if req_id in self.evicted else "orphan"
            self.evicted.discard(req_id)
            self.counts[outcome] += 1
            _M_LABELS.inc(1, outcome=outcome)
            return None
        y = arr[:, 0]
        if y.shape[0] != X.shape[0]:
            # a label chunk that joins but disagrees on rows is feedback-
            # pipeline corruption, not a window artifact — typed orphan
            self.counts["orphan"] += 1
            _M_LABELS.inc(1, outcome="orphan")
            return None
        self.counts["joined"] += 1
        _M_LABELS.inc(1, outcome="joined")
        return X, y

    def state(self) -> dict:
        return {"pending": dict(self.pending),
                "evicted": set(self.evicted),
                "counts": dict(self.counts)}

    def load_state(self, state: dict) -> None:
        self.pending = dict(state["pending"])
        self.evicted = set(state["evicted"])
        self.counts = dict(state["counts"])
