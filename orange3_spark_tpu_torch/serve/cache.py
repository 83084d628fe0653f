"""Executable cache — captured-once programs for the serving path.

A port of the JAX package's AOT executable cache. There an entry is an
XLA executable from ``jit(fn).lower(abstract_args).compile()``; here it is
a CUDA graph captured for one bucket shape with its static input and
output buffers (serve/context.py builds it; on the CPU, where there are no
graphs, the same function applied to the padded bucket). The cache makes
the built program a first-class entry:

* built at WARMUP time (``ServingContext.warmup``), so no request pays a
  capture;
* keyed explicitly on (model fingerprint, kind, bucket shape, dtype,
  device) by the caller (serve/context.py owns key construction);
* LRU-bounded (``max_entries``) — retired models' graphs, and the static
  buffers and memory pools they hold, fall out instead of accumulating
  for the life of the process;
* counted: hits/misses/evictions/build-seconds tick the process-wide
  ``utils.profiling`` serve aggregate, the source of the serving bench's
  ``bucket_hits``/``aot_hits`` fields; ``device_bytes()`` reports what the
  cached entries hold on the device;
* named in the device-memory ledger (obs/prof.py): every cached program
  is a ``serve_executables`` entry of those bytes, released when it leaves
  the cache (eviction, a marker's forced eviction, or ``clear``).
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Callable

from orange3_spark_tpu_torch.obs import prof
from orange3_spark_tpu_torch.utils.profiling import record_serve

_MISSING = object()
#: countless LRU placeholder for keys that own no executable (pad-path
#: buckets, failed builds); never returned as a build product
_PAD_MARKER = "pad-marker"


def _ledger_name(key) -> str:
    """Stable short ledger-entry name for one cache key (keys are long
    tuples carrying fingerprints and devices — the crc names the entry,
    the bytes are what a post-mortem reads)."""
    return f"exe-{zlib.crc32(repr(key).encode()) & 0xFFFFFFFF:08x}"


def _entry_device_bytes(entry) -> int:
    """Device bytes of one cached build product: a captured graph reports
    its static buffers and its memory pool (``device_bytes``, measured
    around the capture); anything else counts 0."""
    objs = entry if isinstance(entry, (tuple, list)) else (entry,)
    return sum(int(getattr(obj, "device_bytes", 0) or 0) for obj in objs)


def _build_resilient(key, build):
    """One build with the resilience wrap: fault injection inside the
    attempt (so a retried attempt consumes the injected budget) and
    bounded transient-error retries around it. ``retry_call`` is a plain
    single attempt under the kill-switch."""
    from orange3_spark_tpu_torch.resilience.faults import active_fault_spec
    from orange3_spark_tpu_torch.resilience.retry import retry_call

    def attempt():
        spec = active_fault_spec()
        if spec is not None:
            spec.maybe_fail_aot_build(key)
        return build()

    return retry_call(attempt, cause="aot_build")


class ExecutableCache:
    """Thread-safe LRU of captured graphs (or any build product).

    ``get_or_build(key, build)`` returns the cached entry or runs
    ``build()`` — serialized PER KEY: two threads racing the same first
    request pay one capture (the second waits on the first's future),
    while hits and builds for OTHER keys proceed concurrently. The lock
    only guards the bookkeeping dicts, never a build — a cold model
    warming up cannot head-of-line-block an already-warmed model's hits.

    ``on_evict(key)`` (optional) fires outside the lock for every entry
    the LRU drops — the owning context uses it to release per-model /
    per-graph pins whose executables are all gone.

    Builds retry transient failures with bounded backoff
    (resilience/retry.py): a transient failure during a warmup build costs
    a retry instead of blacklisting the model for the process lifetime.
    Fail-fast under ``OTPU_RESILIENCE=0``; the ``aot_build`` fault kind
    injects the transient failure deterministically for tests/bench.
    """

    def __init__(self, max_entries: int = 64,
                 on_evict: Callable[[Any], None] | None = None):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self.on_evict = on_evict
        self._lock = threading.RLock()
        self._entries: OrderedDict[Any, Any] = OrderedDict()
        self._building: dict[Any, Future] = {}
        self._bytes: dict[Any, int] = {}      # key -> device bytes held

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def device_bytes(self) -> int:
        """Device bytes the cached entries hold (static buffers and graph
        memory pools)."""
        with self._lock:
            return sum(self._bytes.values())

    def _drop_locked(self, keys) -> None:
        # ledger releases inside the cache lock: they serialize with a
        # concurrent build's set of the same key (lock order cache ->
        # ledger), so a late set never re-creates an evicted entry
        for k in keys:
            self._bytes.pop(k, None)
            prof.ledger_release("serve_executables", _ledger_name(k))

    def get_or_build(self, key, build: Callable[[], Any]):
        with self._lock:
            entry = self._entries.get(key, _MISSING)
            if entry is not _MISSING and entry is not _PAD_MARKER:
                self._entries.move_to_end(key)
                record_serve(aot_hits=1)
                return entry
            # a _PAD_MARKER here is a failed build's LRU placeholder
            # (see _blacklist/mark): it keeps the eviction bookkeeping
            # honest but must NOT satisfy a build — a breaker's
            # half-open probe re-attempts the build through this path,
            # and the real entry then replaces the marker in place
            fut = self._building.get(key)
            if fut is None:
                fut = self._building[key] = Future()
                owner = True
            else:
                owner = False
        if not owner:
            # someone else is building this key: wait for IT alone; the
            # shared build counts once (their miss), we count a hit
            entry = fut.result()
            record_serve(aot_hits=1)
            return entry
        t0 = time.perf_counter()
        try:
            entry = _build_resilient(key, build)
        except BaseException as e:
            with self._lock:
                del self._building[key]
            fut.set_exception(e)
            raise
        dt = time.perf_counter() - t0
        evicted = []
        nbytes = _entry_device_bytes(entry)
        with self._lock:
            record_serve(aot_misses=1, aot_compile_s=dt)
            self._entries[key] = entry
            self._bytes[key] = nbytes
            prof.ledger_set("serve_executables", _ledger_name(key), nbytes)
            del self._building[key]
            while len(self._entries) > self.max_entries:
                evicted.append(self._entries.popitem(last=False)[0])
            if evicted:
                record_serve(aot_evictions=len(evicted))
            self._drop_locked(evicted)
        fut.set_result(entry)
        if self.on_evict is not None:
            for k in evicted:
                self.on_evict(k)
        return entry

    def mark(self, key) -> None:
        """Insert a countless marker entry: pad-path buckets own no graph
        (the model's raw predict runs on the padded table), but a marker
        gives them LRU presence so ``on_evict`` pruning covers pad-served
        models too. No aot hit/miss ticks — nothing was built here;
        evictions it forces still count (real entries may fall)."""
        evicted = []
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return
            self._entries[key] = _PAD_MARKER
            while len(self._entries) > self.max_entries:
                evicted.append(self._entries.popitem(last=False)[0])
            if evicted:
                record_serve(aot_evictions=len(evicted))
            self._drop_locked(evicted)
        if self.on_evict is not None:
            for k in evicted:
                self.on_evict(k)

    def clear(self) -> None:
        with self._lock:
            dropped = list(self._entries)
            self._entries.clear()
            self._drop_locked(dropped)
        if self.on_evict is not None:
            # same contract as LRU eviction: every dropped key fires, so
            # the owning context releases its per-model/per-graph pins
            # instead of holding them for the context's lifetime
            for k in dropped:
                self.on_evict(k)
