"""Fleet data-plane fast path: pooled connections, UDS, SHM wire.

The plain wire pays a fresh TCP handshake plus a full npy
serialize/deserialize per predict.  This module holds the three
transport upgrades the fast path is built from — all behind the
``OTPU_FLEET_FASTWIRE`` kill-switch (0 = the old wire, bitwise):

* **ConnPool** — a small per-replica pool of idle keep-alive
  ``HTTPConnection`` objects.  The client reuses a pooled socket when
  one is available (``otpu_fleet_conn_reused_total``) and opens fresh
  otherwise (``otpu_fleet_conn_opened_total``).  A *reused* socket that
  the replica closed behind our back fails the first send — that is a
  stale-socket artifact, not a replica failure, so the client retries
  ONCE on a fresh connection (``otpu_fleet_conn_stale_retries_total``)
  before any error surfaces to the router/breaker.

* **UDS transport** (``OTPU_FLEET_UDS=1``) — loopback replicas also
  bind an ``AF_UNIX`` socket at :func:`uds_socket_path` under the fleet
  run dir (dir 0700, socket 0600 — the filesystem is the ACL) and the
  client prefers it when the socket file exists: no TCP handshake, no
  TIME_WAIT churn.

* **SHM tensor wire** (``OTPU_FLEET_SHM=1``) — request/response arrays
  ride ``multiprocessing.shared_memory`` segments; the HTTP body shrinks
  to a JSON descriptor (segment name, dtype, shape, CRC32, nbytes).
  Segment lifecycle is belt-and-braces: the receiver unlinks after
  copying out, the sender unlinks again in ``finally`` (double unlink is
  harmless), and a ``weakref.finalize`` backstop unlinks on GC so an
  aborted dispatch can never orphan a segment.  Any SHM failure raises
  the typed :class:`ShmWireError` and the caller falls back to the npy
  body for that request (``otpu_fleet_shm_fallbacks_total``).

Nothing here imports torch — the wire stays import-light on purpose.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import tempfile
import threading
import weakref
import zlib
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer

import numpy as np

from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

#: content type of an SHM descriptor body (vs ``application/x-npy``)
SHM_CONTENT_TYPE = "application/x-otpu-shm"

_M_CONN_OPENED = REGISTRY.counter(
    "otpu_fleet_conn_opened_total",
    "fleet RPC connections opened (pool miss or stale-retry), by replica")
_M_CONN_REUSED = REGISTRY.counter(
    "otpu_fleet_conn_reused_total",
    "fleet RPC requests served over a pooled keep-alive connection")
_M_CONN_STALE = REGISTRY.counter(
    "otpu_fleet_conn_stale_retries_total",
    "reused sockets found stale at send time and retried once on a "
    "fresh connection (never a breaker trip)")
_M_SHM_BYTES = REGISTRY.counter(
    "otpu_fleet_shm_bytes_total",
    "array bytes carried over shared-memory segments instead of the "
    "npy HTTP body")
_M_SHM_FALLBACKS = REGISTRY.counter(
    "otpu_fleet_shm_fallbacks_total",
    "predicts that fell back from the SHM wire to the npy body after a "
    "typed SHM failure")


def fastwire_enabled() -> bool:
    return knobs.get_bool("OTPU_FLEET_FASTWIRE")


def shm_enabled() -> bool:
    return fastwire_enabled() and knobs.get_bool("OTPU_FLEET_SHM")


def shm_worthwhile(nbytes: int) -> bool:
    """SHM only pays above a payload floor: under it, the segment
    create/map/unlink syscalls cost more than the socket copies they
    avoid (measured crossover ~4 MiB on loopback; tests set the knob to
    0 to force the SHM path for parity pins)."""
    return nbytes >= knobs.get_int("OTPU_FLEET_SHM_MIN_BYTES")


def uds_enabled() -> bool:
    return fastwire_enabled() and knobs.get_bool("OTPU_FLEET_UDS")


class ShmWireError(RuntimeError):
    """Typed SHM wire failure (segment missing, CRC mismatch, no /dev/shm):
    the caller falls back to the npy body for this request."""


# --------------------------------------------------------------- run dir
def run_dir(create: bool = True) -> str:
    """The fleet run dir holding UDS socket files: OTPU_FLEET_RUN_DIR or
    ``otpu-fleet-<uid>`` under the system tmp dir, created 0700 (the
    socket files inside are 0600 — see _bind_uds)."""
    d = knobs.get_str("OTPU_FLEET_RUN_DIR")
    if not d:
        uid = os.getuid() if hasattr(os, "getuid") else 0
        d = os.path.join(tempfile.gettempdir(), f"otpu-fleet-{uid}")
    if create:
        os.makedirs(d, mode=0o700, exist_ok=True)
        try:
            os.chmod(d, 0o700)
        except OSError:
            pass
    return d


def uds_socket_path(port: int, create_dir: bool = True) -> str:
    """Socket file for the replica that owns TCP ``port`` — the port
    number doubles as the stable per-replica identity, so the client can
    derive the path from the (host, port) it already holds."""
    return os.path.join(run_dir(create=create_dir), f"rpc-{port}.sock")


def _is_loopback(host: str) -> bool:
    return host in ("127.0.0.1", "localhost", "::1")


def uds_available(host: str, port: int) -> bool:
    """Prefer UDS only when enabled, local, and the replica actually
    bound its socket (a missing file means an old replica or UDS off on
    the server side — fall through to TCP, never error)."""
    if not uds_enabled() or not _is_loopback(host):
        return False
    try:
        return os.path.exists(uds_socket_path(port, create_dir=False))
    except OSError:
        return False


class _UnixHTTPConnection(HTTPConnection):
    """HTTPConnection over an AF_UNIX socket file (HTTP/1.1 framing is
    transport-agnostic; only connect() changes)."""

    def __init__(self, path: str, timeout=None):
        super().__init__("localhost", timeout=timeout)
        self._uds_path = path

    def connect(self):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if self.timeout is not None:
            sock.settimeout(self.timeout)
        sock.connect(self._uds_path)
        self.sock = sock


class _UnixThreadingHTTPServer(ThreadingHTTPServer):
    """AF_UNIX ThreadingHTTPServer bound at uds_socket_path(port) — only
    reachable through the 0600 socket file under the 0700 run dir, so it
    is strictly narrower than the loopback TCP listener."""

    address_family = socket.AF_UNIX
    allow_reuse_address = False

    def server_bind(self):
        # the TCP base resolves a (host, port) server_address via
        # getfqdn; an AF_UNIX address is just the path
        path = self.server_address
        try:
            os.unlink(path)               # stale file from a killed owner
        except FileNotFoundError:
            pass
        self.socket.bind(path)
        os.chmod(path, 0o600)
        self.server_name = path
        self.server_port = 0

    def get_request(self):
        request, _addr = self.socket.accept()
        # BaseHTTPRequestHandler formats client_address[0] into log
        # lines; AF_UNIX accept returns '' — give it a stable shape
        return request, ("uds", 0)


def bind_uds_server(port: int, handler_cls, runtime) -> ThreadingHTTPServer:
    """Bind the replica's companion UDS listener (same handler class and
    runtime as the TCP one). Raises OSError if the run dir is unusable."""
    srv = _UnixThreadingHTTPServer(uds_socket_path(port), handler_cls)
    srv._otpu_runtime = runtime
    return srv


def unlink_uds_socket(port: int) -> None:
    """Remove a replica's socket file — the supervisor calls this after
    SIGKILL (the dead process cannot) and servers call it on shutdown."""
    try:
        os.unlink(uds_socket_path(port, create_dir=False))
    except OSError:
        pass


# --------------------------------------------------------- connection pool
class ConnPool:
    """Idle keep-alive connections for ONE replica, keyed by transport
    ("tcp" | "uds") so a UDS toggle mid-run cannot hand back the wrong
    socket kind. Bounded: releases beyond the cap close the connection."""

    def __init__(self, name: str = "replica"):
        self.name = name
        self._lock = threading.Lock()
        self._idle: list[tuple[str, HTTPConnection]] = []
        # monotonically growing — the digest reads them for reuse%
        self.opened = 0
        self.reused = 0
        self.stale_retries = 0

    def _cap(self) -> int:
        return max(1, knobs.get_int("OTPU_FLEET_POOL_CONNS"))

    def acquire(self, transport: str) -> HTTPConnection | None:
        """Pop an idle connection of the right transport; wrong-transport
        idles are closed (stale config, not worth keeping)."""
        with self._lock:
            while self._idle:
                t, conn = self._idle.pop()
                if t == transport:
                    self.reused += 1
                    _M_CONN_REUSED.inc(1, replica=self.name)
                    return conn
                _close_quiet(conn)
        return None

    def note_opened(self) -> None:
        with self._lock:
            self.opened += 1
        _M_CONN_OPENED.inc(1, replica=self.name)

    def note_stale(self) -> None:
        with self._lock:
            self.stale_retries += 1
        _M_CONN_STALE.inc(1, replica=self.name)

    def release(self, transport: str, conn: HTTPConnection) -> None:
        with self._lock:
            if len(self._idle) < self._cap():
                self._idle.append((transport, conn))
                return
        _close_quiet(conn)

    def close_all(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for _t, conn in idle:
            _close_quiet(conn)

    def stats(self) -> dict:
        with self._lock:
            opened, reused = self.opened, self.reused
            stale, idle = self.stale_retries, len(self._idle)
        total = opened + reused
        return {"opened": opened, "reused": reused,
                "stale_retries": stale, "idle": idle,
                "reuse_pct": round(100.0 * reused / total, 1)
                if total else 0.0}


def _close_quiet(conn) -> None:
    try:
        conn.close()
    except Exception:  # noqa: BLE001 — teardown only
        pass


# ------------------------------------------------------------ SHM codec
_SEQ = itertools.count()
_TRACKER_LOCK = threading.Lock()
#: response segments a replica created and handed to the client; the
#: client unlinks after reading, this bounded deque is the backstop for
#: clients that died mid-read (oldest unlinked once the cap is hit)
_RESPONSE_SEGMENTS: list["ShmSegment"] = []
_RESPONSE_CAP = 64


def _unlink_quiet(name: str) -> None:
    try:
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(name=name)
        seg.close()
        seg.unlink()
    except Exception:  # noqa: BLE001 — already gone is the common case
        pass


class ShmSegment:
    """Creator-side handle: the finalizer is the leak backstop (fires on
    GC even if every explicit cleanup path was skipped) and is lock-free
    on purpose — finalizers run during GC and must never take locks."""

    def __init__(self, nbytes: int):
        from multiprocessing import shared_memory

        # 'otpu-t': the JAX package's segments are 'otpu-<pid>-<seq>', so
        # the two packages in one process never pick the same name
        self._shm = shared_memory.SharedMemory(
            create=True, size=max(1, nbytes),
            name=f"otpu-t{os.getpid()}-{next(_SEQ)}")
        self.name = self._shm.name
        self._finalizer = weakref.finalize(self, _unlink_quiet, self.name)

    @property
    def buf(self):
        return self._shm.buf

    def cleanup(self) -> None:
        """Close + unlink, idempotent; double-unlink (receiver already
        unlinked) is expected and silent."""
        self._finalizer.detach()
        try:
            self._shm.close()
        except Exception:  # noqa: BLE001
            pass
        _unlink_quiet(self.name)


#: full-CRC bound: beyond this the checksum covers head + tail windows
#: only — zlib.crc32 runs ~1.5 GB/s, so checksumming whole multi-MB
#: tensors twice per hop would cost more than the socket copies the SHM
#: wire exists to avoid. Truncation, wrong-segment and torn-header
#: corruption all land in the windows; both ends use _crc below, so the
#: scheme is symmetric by construction.
_CRC_FULL_BYTES = 1 << 18
_CRC_WINDOW = 1 << 16


def _crc(buf) -> int:
    n = len(buf)
    if n <= _CRC_FULL_BYTES:
        return zlib.crc32(buf)
    head = zlib.crc32(buf[:_CRC_WINDOW])
    return zlib.crc32(buf[n - _CRC_WINDOW:], head) ^ (n & 0xFFFFFFFF)


def dump_shm(arr: np.ndarray) -> tuple[bytes, ShmSegment]:
    """Write ``arr`` into a fresh segment; returns (descriptor JSON body,
    segment handle). The caller owns the handle and must ``cleanup()`` in
    a finally. Raises ShmWireError when SHM is unusable on this host."""
    arr = np.ascontiguousarray(arr)
    try:
        seg = ShmSegment(arr.nbytes)
        view = np.ndarray(arr.shape, dtype=arr.dtype, buffer=seg.buf)
        view[...] = arr
        crc = _crc(seg.buf[:arr.nbytes]) if arr.nbytes else 0
    except ShmWireError:
        raise
    except Exception as e:  # noqa: BLE001 — no /dev/shm, perms, ENOSPC
        raise ShmWireError(f"shm create failed: {e}") from e
    _M_SHM_BYTES.inc(arr.nbytes)
    desc = {"segment": seg.name, "dtype": arr.dtype.str,
            "shape": list(arr.shape), "crc32": crc, "nbytes": arr.nbytes}
    return json.dumps(desc).encode("utf-8"), seg


def load_shm(body: bytes) -> np.ndarray:
    """Copy the array out of the descriptor's segment, verify the CRC,
    and unlink (receiver-unlinks is the primary lifecycle; the sender's
    finally/finalizer double-unlink silently). Typed ShmWireError on any
    failure so the peer can fall back to npy."""
    from multiprocessing import shared_memory

    try:
        desc = json.loads(body.decode("utf-8"))
        name = desc["segment"]
        dtype = np.dtype(desc["dtype"])
        shape = tuple(int(s) for s in desc["shape"])
        nbytes = int(desc["nbytes"])
    except Exception as e:  # noqa: BLE001
        raise ShmWireError(f"bad shm descriptor: {e}") from e
    try:
        seg = shared_memory.SharedMemory(name=name)
    except Exception as e:  # noqa: BLE001 — sender died / already gone
        raise ShmWireError(f"shm segment {name!r} unavailable: {e}") from e
    try:
        if (_crc(seg.buf[:nbytes]) if nbytes else 0) != desc["crc32"]:
            raise ShmWireError(f"shm segment {name!r} CRC mismatch")
        out = np.ndarray(shape, dtype=dtype,
                         buffer=seg.buf[:nbytes]).copy()
    finally:
        try:
            seg.close()
        except Exception:  # noqa: BLE001
            pass
        _unlink_quiet(name)
    return out


def track_response_segment(seg: ShmSegment) -> None:
    """Replica-side: keep the response segment alive until the client
    reads it; the bounded tracker unlinks the oldest beyond the cap so a
    vanished client cannot accumulate orphans."""
    evicted = []
    with _TRACKER_LOCK:
        _RESPONSE_SEGMENTS.append(seg)
        while len(_RESPONSE_SEGMENTS) > _RESPONSE_CAP:
            evicted.append(_RESPONSE_SEGMENTS.pop(0))
    for old in evicted:
        old.cleanup()


def orphan_segments(prefix: str = "otpu-") -> list[str]:
    """Name-sweep /dev/shm for live otpu segments — the leak-guard test
    asserts this is empty after an aborted dispatch."""
    shm_dir = "/dev/shm"
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return []
    return sorted(n for n in names if n.startswith(prefix))


def shm_stats() -> dict:
    """Digest view of the SHM wire on this process."""
    with _TRACKER_LOCK:
        live = len(_RESPONSE_SEGMENTS)
    return {"bytes_total": _M_SHM_BYTES.value(),
            "fallbacks": _M_SHM_FALLBACKS.value(),
            "live_response_segments": live}


def note_shm_fallback() -> None:
    _M_SHM_FALLBACKS.inc()
