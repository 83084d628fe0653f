"""Goodput & memory attribution plane.

A copy of the JAX package's ``obs/prof.py`` on PyTorch. It answers
**where a fit's time and the device memory went**. Three coupled pieces,
one kill-switch (``OTPU_PROF=0``: no accounting, no ledger ticks, deep
capture refused):

* **Step-time decomposition** (:class:`GoodputAccountant`) — an
  always-on, low-overhead accountant fed by the exec chokepoints:
  ``PipelinedExecutor`` queue waits (input), the ``bound_dispatch``
  periodic wait (the one place the host observes device pace),
  explicit barriers (epoch walls) and the host encode/plan seconds. Each
  fit's wall decomposes into five disjoint fractions —
  ``device_compute`` / ``input_wait`` / ``host_encode`` / ``sync_wait``
  / ``framework`` — that sum to 1.0 by construction (``framework`` is
  the measured residual: Python step-issue overhead, seeding, report
  building). Per epoch the bottleneck is classified input-bound vs
  compute-bound vs sync-bound with hysteresis (``OTPU_PROF_HYST``) so a
  fit oscillating at a boundary never flaps. Exposed as
  ``otpu_goodput_fraction{stage=}`` gauges and a ``goodput`` section in
  every fit's ``RunReport``.

  Attribution semantics (the host's view of an asynchronous device):
  queue waits are *input*; the periodic dispatch wait is *device compute*
  (the host only observes the device by blocking on it, and the
  periodic wait blocks exactly while the device drains queued steps; so
  do the launches of a replay of captured CUDA graphs once they fill the
  card's queue, and the wait after it); explicit
  barriers (an epoch's closing synchronize) are *synchronization*;
  encode/plan seconds run on the prefetch thread, so only the part that
  could not hide behind device work — ``min(encode_s, input_wait)`` — is
  charged as *host_encode* (the rest was free).

* **Device-memory ledger** (:class:`DeviceMemoryLedger`) — a registry
  of named device-resident allocations: ``_DeviceCache`` chunks
  (codec-aware bytes, the owner ``cache_chunks``), model/optimizer
  state (``model_state``) and the serving ``ExecutableCache`` entries
  (``serve_executables``: a captured graph's static buffers and memory
  pool). Live bytes per owner ride ``otpu_device_bytes{owner=}``;
  per-fit peak watermarks land in the report's ``device_memory``
  section; :meth:`reconcile` compares the ledger total against the CUDA
  caching allocator (``torch.cuda.memory_stats``: allocated and reserved
  bytes) — the delta is *reported*, never asserted (the allocator also
  holds what the ledger does not name: temporaries, results the caller
  kept, library workspaces).

* **On-demand deep capture** (:func:`capture`) — ``POST
  /debug/profile?duration_ms=`` on the obs server (loopback only,
  rate-limited by ``OTPU_PROF_RATE_S`` → 429, serialized → 409) runs
  ``torch.profiler`` (CPU and CUDA activities) plus a
  goodput+ledger+registry snapshot into one atomic artifact directory
  under ``OTPU_PROF_DIR`` (``capture-<ns>-<reason>/`` with
  ``snapshot.json`` + ``torch_trace/trace.json``, a Chrome trace; written
  into a ``.tmp`` sibling and renamed, so a reader never sees a
  half-written capture). ``utils.profiling.profile_trace`` routes through
  the same serialized + rate-limited + atomic path (:func:`trace_capture`).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import threading
import time

from orange3_spark_tpu_torch.obs import trace as _trace
from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

__all__ = [
    "BOTTLENECKS",
    "CaptureBusyError",
    "CaptureDisabledError",
    "CaptureRateLimitedError",
    "DeviceMemoryLedger",
    "GoodputAccountant",
    "LEDGER",
    "PROF_SCHEMA_VERSION",
    "STAGES",
    "attach_fit_report",
    "begin_fit",
    "capture",
    "capture_snapshot",
    "current",
    "end_fit",
    "force_disabled",
    "force_enabled",
    "last_goodput",
    "ledger_release",
    "ledger_set",
    "note_input_wait",
    "note_sync",
    "prof_enabled",
    "refreshed_enabled",
    "reset_rate_limit",
    "trace_capture",
]

log = logging.getLogger("orange3_spark_tpu_torch")

PROF_SCHEMA_VERSION = 1

#: the five disjoint wall fractions, in reporting order
STAGES = ("device_compute", "input_wait", "host_encode", "sync_wait",
          "framework")

#: stage -> bottleneck label. host_encode counts toward input_bound
#: (exposed encode IS input-pipeline slowness — the fix is the same:
#: feed the device faster); framework classifies as its own label, so a
#: compile/python-dominated run is never mislabeled as one of the
#: measured waits it dwarfs.
BOTTLENECKS = {
    "input_wait": "input_bound",
    "host_encode": "input_bound",
    "device_compute": "compute_bound",
    "sync_wait": "sync_bound",
    "framework": "framework_bound",
}

_M_GOODPUT = REGISTRY.gauge(
    "otpu_goodput_fraction",
    "per-stage fraction of the last finished fit's wall "
    "(device_compute/input_wait/host_encode/sync_wait/framework)")
_M_DEVICE_BYTES = REGISTRY.gauge(
    "otpu_device_bytes",
    "live device-resident bytes per ledger owner (cache_chunks / "
    "model_state / serve_executables / replay_plans)")
_M_CAPTURES = REGISTRY.counter(
    "otpu_prof_captures_total",
    "deep-profile capture attempts, by outcome "
    "(ok/busy/rate_limited/error)")


def prof_enabled() -> bool:
    """The ``OTPU_PROF`` kill-switch, re-resolved per call (the
    OTPU_DONATE convention: chokepoints re-read, never a cached latch).
    Called once per fit entry / ledger mutation / capture — never inside
    the per-step hot path (that path gates on :func:`current` being
    None, a bare contextvar read)."""
    return knobs.get_bool("OTPU_PROF")


# Alias so chokepoints read the same way as trace.refreshed_enabled().
refreshed_enabled = prof_enabled


@contextlib.contextmanager
def _force(value: str):
    """Env-backed temporary OTPU_PROF override (A/B arms)."""
    prev = os.environ.get("OTPU_PROF")
    os.environ["OTPU_PROF"] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("OTPU_PROF", None)
        else:
            os.environ["OTPU_PROF"] = prev


def force_disabled():
    """Temporarily disable the prof plane (an A/B's off arm)."""
    return _force("0")


def force_enabled():
    """Temporarily force the prof plane ON (the on arm must measure real
    accounting even under an ambient OTPU_PROF=0)."""
    return _force("1")


# ===================================================== goodput accounting
class GoodputAccountant:
    """One fit's wall-time decomposition. Created at fit entry
    (:func:`begin_fit`), fed by the exec chokepoints through the
    module-level :func:`note_sync` / :func:`note_input_wait` hooks (a
    contextvar lookup — no knob read on the hot path), closed by
    :meth:`finish`.

    The measured buckets are *host-thread blocked seconds* and are
    disjoint by construction (the host thread can only block in one place at
    a time); ``host_encode`` is carved out of ``input_wait`` at result
    time (``min(encode_s, input_wait_raw)`` — encode hidden behind
    device work cost the fit nothing); ``framework`` is the residual.
    Fractions therefore sum to 1.0 (within ±0.02 after rounding)."""

    def __init__(self, kind: str = "fit", hysteresis: float | None = None):
        self.kind = kind
        self.hysteresis = float(
            hysteresis if hysteresis is not None
            else knobs.get_float("OTPU_PROF_HYST"))
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        # cumulative host-thread blocked seconds
        self._dev = 0.0          # periodic dispatch syncs (device pace)
        self._sync = 0.0         # explicit barriers
        self._wait = 0.0         # prefetch queue waits
        self._encode = 0.0       # external cumulative feed (prefetch thread)
        # per-epoch classification state
        self._mark = (0.0, 0.0, 0.0, 0.0, self._t0)
        self.epochs: list[dict] = []
        self.bottleneck: str | None = None
        self._wm = LEDGER.watermark()
        # the watermark dict is walked on EVERY ledger mutation: an
        # accountant abandoned by an ABORTED fit (no finish, no
        # end_fit) must still close its watermark when it dies — the
        # next begin_fit drops the contextvar's ref, GC does the rest.
        # Deferred (lock-free) close: GC finalizers must never take the
        # ledger lock. The callback holds no reference back to this
        # accountant, so the finalizer cannot keep it alive.
        import weakref

        weakref.finalize(self, LEDGER.defer_watermark_close,
                         self._wm._key)
        self._result: dict | None = None

    # ------------------------------------------------------------- feeds
    def add(self, stage: str, seconds: float) -> None:
        """Accumulate host-blocked seconds into one measured bucket."""
        if seconds <= 0.0:
            return
        with self._lock:
            if stage == "device_compute":
                self._dev += seconds
            elif stage == "sync_wait":
                self._sync += seconds
            elif stage == "input_wait":
                self._wait += seconds
            else:
                raise ValueError(
                    f"goodput: unknown measured stage {stage!r} "
                    f"(framework/host_encode are derived, not fed)")

    def feed_encode(self, encode_s: float) -> None:
        """Set the CUMULATIVE encode/plan seconds (prefetch-thread work,
        read off PipelineStats at epoch boundaries / finish)."""
        with self._lock:
            self._encode = max(self._encode, float(encode_s))

    # -------------------------------------------------------- epoch feed
    @staticmethod
    def _decompose(wall, dev, sync, wait, encode):
        """(seconds per stage, disjoint, clamped to wall)."""
        host_encode = min(max(encode, 0.0), max(wait, 0.0))
        input_wait = max(wait - host_encode, 0.0)
        measured = dev + sync + input_wait + host_encode
        if wall > 0 and measured > wall:
            # overlapping/duplicated measurement can only ever overshoot
            # by noise; scale down so the buckets stay a partition
            scale = wall / measured
            dev, sync = dev * scale, sync * scale
            input_wait, host_encode = (input_wait * scale,
                                       host_encode * scale)
            measured = wall
        return {
            "device_compute": dev,
            "input_wait": input_wait,
            "host_encode": host_encode,
            "sync_wait": sync,
            "framework": max(wall - measured, 0.0),
        }

    def _classify(self, fractions: dict) -> str:
        """Hysteresis classifier over the SUMMED label fractions: the
        incumbent keeps the title unless a challenger's fraction beats
        it by ``hysteresis`` (absolute). A fresh accountant (no
        incumbent) takes the plain argmax; nothing measured at all
        (wall 0) reads framework_bound."""
        cands: dict[str, float] = {}
        for stage, label in BOTTLENECKS.items():
            cands[label] = cands.get(label, 0.0) + fractions.get(stage,
                                                                 0.0)
        best = max(cands, key=cands.get)
        if cands[best] <= 0.0:
            return "framework_bound"
        if self.bottleneck is None or self.bottleneck not in cands:
            return best
        if cands[best] > cands[self.bottleneck] + self.hysteresis:
            return best
        return self.bottleneck

    def epoch_boundary(self, epoch: int, *,
                       encode_s: float | None = None) -> dict:
        """Close one epoch's window: per-epoch stage deltas, classify
        with hysteresis, record. Emits a ``bottleneck`` instant on
        CHANGE only (the timeline shows regime shifts, not every
        epoch)."""
        if encode_s is not None:
            self.feed_encode(encode_s)
        now = time.perf_counter()
        with self._lock:
            dev0, sync0, wait0, enc0, t0 = self._mark
            wall = max(now - t0, 0.0)
            secs = self._decompose(wall, self._dev - dev0,
                                   self._sync - sync0,
                                   self._wait - wait0,
                                   self._encode - enc0)
            self._mark = (self._dev, self._sync, self._wait,
                          self._encode, now)
        fracs = {s: (v / wall if wall > 0 else 0.0)
                 for s, v in secs.items()}
        prev = self.bottleneck
        label = self._classify(fracs)
        self.bottleneck = label
        entry = {"epoch": int(epoch), "bottleneck": label,
                 "wall_s": round(wall, 6),
                 "fractions": {s: round(f, 4) for s, f in fracs.items()}}
        self.epochs.append(entry)
        if label != prev and prev is not None:
            _trace.instant("bottleneck", epoch=int(epoch), was=prev,
                           now=label)
        return entry

    # ------------------------------------------------------------ result
    def finish(self, *, encode_s: float | None = None,
               wall_s: float | None = None) -> dict:
        """Freeze the decomposition (idempotent — first call wins), set
        the ``otpu_goodput_fraction`` gauges, publish as the process's
        :func:`last_goodput`."""
        global _last_goodput
        if self._result is not None:
            return self._result
        if encode_s is not None:
            self.feed_encode(encode_s)
        wall = (float(wall_s) if wall_s is not None
                else time.perf_counter() - self._t0)
        with self._lock:
            secs = self._decompose(wall, self._dev, self._sync,
                                   self._wait, self._encode)
        # fractions off UNROUNDED seconds, then rounded: the residual
        # construction makes them sum to 1.0 exactly, rounding moves the
        # sum by < 5 * 5e-5 — comfortably inside ±0.02
        fracs = {s: round(v / wall, 4) if wall > 0 else 0.0
                 for s, v in secs.items()}
        if self.bottleneck is None:
            self.bottleneck = self._classify(fracs)
        self._result = {
            "schema": PROF_SCHEMA_VERSION,
            "kind": self.kind,
            "wall_s": round(wall, 6),
            "fractions": fracs,
            "seconds": {s: round(v, 6) for s, v in secs.items()},
            "bottleneck": self.bottleneck,
            "epochs": list(self.epochs),
            "peak_device_bytes": self._wm.close(),
        }
        for s, f in fracs.items():
            _M_GOODPUT.set(f, stage=s)
        _last_goodput = self._result
        return self._result


#: the current fit's accountant on this thread of control (contextvars:
#: the dispatch hook reads it lock-free; None = prof off or no fit live)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "otpu_prof_accountant", default=None)
_last_goodput: dict | None = None


def current() -> GoodputAccountant | None:
    return _CURRENT.get()


def begin_fit(kind: str = "fit") -> GoodputAccountant | None:
    """Fit-entry chokepoint: a live accountant under ``OTPU_PROF``,
    None under the kill-switch (every downstream hook then no-ops on a
    bare contextvar read). Always (re)sets
    the contextvar, so an earlier fit that aborted mid-flight cannot
    leave its stale accountant collecting this fit's waits."""
    if not prof_enabled():
        _CURRENT.set(None)
        return None
    acc = GoodputAccountant(kind)
    # plain set, NOT a reset token: fits never nest, and a token chain
    # would keep every abandoned (aborted-fit) accountant alive through
    # its predecessor reference — defeating the watermark finalizer
    _CURRENT.set(acc)
    return acc


def end_fit(acc: GoodputAccountant | None) -> None:
    """Clear the contextvar (finish() may run before or after). An
    accountant abandoned without finish() (an aborted fit) closes its
    ledger watermark here — the watermark dict is
    iterated on EVERY ledger mutation, so a leak is a per-process
    slowdown, not just bookkeeping."""
    if acc is None:
        return
    if acc._result is None:
        acc._wm.close()
    if _CURRENT.get() is acc:
        _CURRENT.set(None)


def note_sync(seconds: float, *, barrier: bool = False) -> None:
    """The ``bound_dispatch`` / explicit-barrier hook: charge host
    seconds blocked on the device. Periodic syncs are device pace
    (``device_compute``); explicit barriers (``barrier=True``) are
    ``sync_wait``. A bare contextvar read when no fit is live."""
    acc = _CURRENT.get()
    if acc is not None:
        acc.add("sync_wait" if barrier else "device_compute", seconds)


def note_input_wait(seconds: float) -> None:
    """The ``PipelinedExecutor`` consumer hook: host seconds blocked
    on the prefetch queue."""
    acc = _CURRENT.get()
    if acc is not None:
        acc.add("input_wait", seconds)


def last_goodput() -> dict | None:
    """The most recent finished fit's decomposition (what a serving
    process's deep capture reports when no fit is live)."""
    return _last_goodput


# ===================================================== device-memory ledger
class DeviceMemoryLedger:
    """Named device-resident allocations: ``set(owner, name, nbytes)`` /
    ``release(owner, name)``, live bytes per owner on
    ``otpu_device_bytes{owner=}``, a running peak, per-fit peaks via
    :meth:`watermark`, and best-effort reconciliation against the CUDA
    caching allocator. Thread-safe; every mutation is a no-op under
    ``OTPU_PROF=0`` (release always applies, so a mid-process kill-
    switch flip cannot strand entries)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, str], int] = {}
        self._total = 0
        self._peak = 0
        self._watermarks: dict[int, "DeviceMemoryLedger._Watermark"] = {}
        self._wm_seq = 0
        # GC-finalizer inbox: weakref.finalize callbacks run
        # synchronously on whatever thread triggered cyclic GC — which
        # can be a thread ALREADY inside this ledger's (non-reentrant)
        # lock, since the methods allocate while holding it. Finalizers
        # therefore only append here (deque.append is atomic, no lock)
        # and every ledger operation drains the inbox at lock entry.
        import collections

        self._pending: "collections.deque" = collections.deque()

    # ------------------------------------------- finalizer-safe deferral
    def defer_release(self, owner: str, name: str) -> None:
        """Release an entry from a GC-finalizer context: lock-free
        enqueue, applied by the next ledger operation."""
        self._pending.append(("release", owner, name))

    def defer_watermark_close(self, key: int) -> None:
        self._pending.append(("wm", key, None))

    def _drain_pending_locked(self) -> None:
        touched: set[str] = set()
        while self._pending:
            try:
                kind, a, b = self._pending.popleft()
            except IndexError:
                break
            if kind == "release":
                prev = self._entries.pop((a, b), None)
                if prev is not None:
                    self._total -= prev
                    touched.add(a)
            else:
                self._watermarks.pop(a, None)
        for owner in touched:
            owner_total = sum(v for (o, _n), v in self._entries.items()
                              if o == owner)
            _M_DEVICE_BYTES.set(owner_total, owner=owner)

    class _Watermark:
        """Max ledger total observed since creation (a fit's peak)."""

        def __init__(self, ledger: "DeviceMemoryLedger", key: int,
                     start: int):
            self._ledger = ledger
            self._key = key
            self.high = start

        def peak(self) -> int:
            return self.high

        def close(self) -> int:
            with self._ledger._lock:
                self._ledger._watermarks.pop(self._key, None)
            return self.high

    def watermark(self) -> "DeviceMemoryLedger._Watermark":
        with self._lock:
            self._drain_pending_locked()
            self._wm_seq += 1
            wm = self._Watermark(self, self._wm_seq, self._total)
            self._watermarks[self._wm_seq] = wm
            return wm

    # -------------------------------------------------------- mutations
    # The gauge writes happen INSIDE the ledger lock: published outside
    # it, two racing mutations of one owner could land their .set calls
    # out of order and pin phantom bytes on the gauge until the owner
    # next moves.
    # Lock order is ledger -> metric; nothing takes them the other way.
    def set(self, owner: str, name: str, nbytes: int) -> None:
        if not prof_enabled():
            return
        nbytes = max(int(nbytes), 0)
        with self._lock:
            self._drain_pending_locked()
            key = (owner, name)
            self._total += nbytes - self._entries.get(key, 0)
            self._entries[key] = nbytes
            self._peak = max(self._peak, self._total)
            for wm in self._watermarks.values():
                wm.high = max(wm.high, self._total)
            owner_total = sum(v for (o, _n), v in self._entries.items()
                              if o == owner)
            _M_DEVICE_BYTES.set(owner_total, owner=owner)

    def release(self, owner: str, name: str) -> None:
        with self._lock:
            self._drain_pending_locked()
            prev = self._entries.pop((owner, name), None)
            if prev is None:
                return
            self._total -= prev
            owner_total = sum(v for (o, _n), v in self._entries.items()
                              if o == owner)
            _M_DEVICE_BYTES.set(owner_total, owner=owner)

    # ------------------------------------------------------------- views
    def get(self, owner: str, name: str) -> int | None:
        with self._lock:
            self._drain_pending_locked()
            return self._entries.get((owner, name))

    def owner_bytes(self) -> dict[str, int]:
        out: dict[str, int] = {}
        with self._lock:
            self._drain_pending_locked()
            for (owner, _name), v in self._entries.items():
                out[owner] = out.get(owner, 0) + v
        return dict(sorted(out.items()))

    def total(self) -> int:
        with self._lock:
            self._drain_pending_locked()
            return self._total

    def peak(self) -> int:
        with self._lock:
            return self._peak

    def snapshot(self, max_entries: int = 64) -> dict:
        """The ledger table (flight bundles, reports, captures): per-
        owner totals plus the largest entries by name — an OOM-adjacent
        post-mortem finally names the tenant."""
        with self._lock:
            self._drain_pending_locked()
            # ONE lock hold for entries + owners + total: a snapshot
            # racing mutators must stay internally consistent (owner
            # sums == total == entry sums), or a post-mortem reader
            # chases phantom leaks
            entries = sorted(
                ({"owner": o, "name": n, "bytes": v}
                 for (o, n), v in self._entries.items()),
                key=lambda e: -e["bytes"])
            owners: dict[str, int] = {}
            for (owner, _name), v in self._entries.items():
                owners[owner] = owners.get(owner, 0) + v
            total, peak = self._total, self._peak
        dropped = max(len(entries) - max_entries, 0)
        out = {
            "prof_schema": PROF_SCHEMA_VERSION,
            "owners": dict(sorted(owners.items())),
            "total_bytes": total,
            "peak_bytes": peak,
            "entries": entries[:max_entries],
        }
        if dropped:
            out["entries_truncated"] = dropped
        return out

    def reconcile(self) -> dict:
        """Ledger total vs the CUDA caching allocator of the current device
        (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
        ``reserved_bytes.all.current``) — the DELTA is reported, never
        asserted: the allocator also holds temporaries, results the
        caller kept and library workspaces. With no CUDA device in use
        (the CPU, or CUDA never initialised) there is no allocator to
        read: ``allocator`` and the byte fields are None."""
        out: dict = {"ledger_bytes": self.total(),
                     "allocator": None,
                     "allocated_bytes": None,
                     "reserved_bytes": None,
                     "delta_vs_allocated_bytes": None}
        try:
            import torch

            if torch.cuda.is_available() and torch.cuda.is_initialized():
                dev = torch.cuda.current_device()
                stats = torch.cuda.memory_stats(dev)
                alloc = int(stats.get("allocated_bytes.all.current", 0))
                out["allocator"] = f"cuda:{dev}"
                out["allocated_bytes"] = alloc
                out["reserved_bytes"] = int(
                    stats.get("reserved_bytes.all.current", 0))
                out["delta_vs_allocated_bytes"] = alloc - out["ledger_bytes"]
        except Exception:  # noqa: BLE001 - reconciliation is best-effort
            pass
        return out

    def clear(self) -> None:
        """Tests only: forget every entry (gauges re-zero per owner)."""
        with self._lock:
            self._drain_pending_locked()
            owners = {o for (o, _n) in self._entries}
            self._entries.clear()
            self._total = 0
            self._peak = 0
            for o in owners:
                _M_DEVICE_BYTES.set(0, owner=o)


#: the process-wide ledger every subsystem registers into
LEDGER = DeviceMemoryLedger()


class _LedgerGuard:
    """Frame-scoped release guard (see :func:`ledger_guard`)."""

    __slots__ = ("__weakref__", "finalizer")


def ledger_guard(owner: str, name: str) -> _LedgerGuard:
    """An object whose death releases the named ledger entry — bind it
    to the owning stack frame so an exception path cannot strand the
    entry (release is idempotent: an explicit release first makes the
    guard's firing a no-op). ``guard.finalizer.detach()`` hands
    ownership elsewhere (e.g. to a model's own finalizer) when the
    happy path wants the entry to outlive the frame. The finalizer body
    is the LOCK-FREE deferred release: cyclic GC may run it on a thread
    already holding the ledger lock."""
    import weakref

    g = _LedgerGuard()
    g.finalizer = weakref.finalize(g, LEDGER.defer_release, owner, name)
    return g


def ledger_release_on_gc(owner: str, name: str) -> None:
    """Finalizer-safe release for ``weakref.finalize`` callbacks: only
    a lock-free enqueue (see ``DeviceMemoryLedger.defer_release``) —
    a finalizer that took the ledger lock could self-deadlock the
    thread whose in-lock allocation triggered the GC pass."""
    LEDGER.defer_release(owner, name)


def tree_device_bytes(tree) -> int:
    """Total bytes of a tree's tensor leaves (nested dicts, lists and
    tuples): ``numel() * element_size()`` a leaf, the ledger's sizing rule
    (a view counts its own elements, never its storage, so two views of
    one buffer are not counted as the buffer twice over each)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_device_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_device_bytes(v) for v in tree)
    return 0


def ledger_set(owner: str, name: str, nbytes: int) -> None:
    LEDGER.set(owner, name, nbytes)


def ledger_release(owner: str, name: str) -> None:
    LEDGER.release(owner, name)


def attach_fit_report(report, acc: GoodputAccountant | None, *,
                      encode_s: float | None = None,
                      cache_key: str | None = None) -> None:
    """Fit-end chokepoint: freeze the accountant, attach the ``goodput``
    and ``device_memory`` sections to the RunReport (absent — not null —
    under the kill-switch). ``cache_key`` names the fit's own
    ``cache_chunks`` ledger entry so a caller can cross-check it against
    the ``cache_bytes`` stage key without ambiguity from other live
    caches."""
    if acc is None:
        return
    result = acc.finish(encode_s=encode_s)
    dm = LEDGER.snapshot()
    dm["peak_bytes_fit"] = result["peak_device_bytes"]
    dm["reconciliation"] = LEDGER.reconcile()
    if cache_key is not None:
        dm["cache_entry_bytes"] = LEDGER.get("cache_chunks", cache_key)
    if report is not None:
        report.goodput = result
        report.device_memory = dm
    end_fit(acc)


# ========================================================== deep capture
class CaptureDisabledError(RuntimeError):
    """Deep capture refused: the prof plane is off (``OTPU_PROF=0``)."""


class CaptureBusyError(RuntimeError):
    """A deep capture is already running — captures are serialized (one
    profiler session at a time; the endpoint answers 409)."""


class CaptureRateLimitedError(RuntimeError):
    """Inside the ``OTPU_PROF_RATE_S`` window since the last capture
    (the endpoint answers 429)."""


_capture_lock = threading.Lock()
_rate_lock = threading.Lock()
_last_capture = 0.0            # monotonic; 0 = never


def reset_rate_limit() -> None:
    """Tests: forget the last capture time."""
    global _last_capture
    with _rate_lock:
        _last_capture = 0.0


def _claim_rate_slot() -> tuple[float, float]:
    """Claim the rate slot BEFORE the (slow) capture — two concurrent
    requests produce one capture; returns ``(previous stamp, claimed
    stamp)`` so a failed capture can hand the slot back."""
    global _last_capture
    min_gap = float(knobs.get_float("OTPU_PROF_RATE_S"))
    now = time.monotonic()
    with _rate_lock:
        if _last_capture and now - _last_capture < min_gap:
            _M_CAPTURES.inc(1, outcome="rate_limited")
            raise CaptureRateLimitedError(
                f"deep capture rate-limited: last capture "
                f"{now - _last_capture:.1f}s ago "
                f"(OTPU_PROF_RATE_S={min_gap})")
        prev, _last_capture = _last_capture, now
    return prev, now


def _release_rate_slot(prev: float, claimed_at: float) -> None:
    global _last_capture
    with _rate_lock:
        if _last_capture == claimed_at:
            _last_capture = prev


@contextlib.contextmanager
def _capture_session():
    """The shared serialize + rate-slot + outcome accounting EVERY deep
    capture runs under (one definition, so :func:`capture` and
    :func:`trace_capture` cannot drift): non-blocking lock → busy
    (409-class), rate window → rate_limited (429-class), a failing
    capture hands its claimed slot back and ticks ``error``, a clean
    one ticks ``ok``. The body owns only the artifact work."""
    if not _capture_lock.acquire(blocking=False):
        _M_CAPTURES.inc(1, outcome="busy")
        raise CaptureBusyError(
            "a deep capture is already running (captures serialize — "
            "one profiler session at a time)")
    try:
        prev, claimed_at = _claim_rate_slot()
        try:
            yield
        except BaseException:
            # one transiently-failed capture must not silence the
            # whole rate window (the flight recorder's convention)
            _release_rate_slot(prev, claimed_at)
            _M_CAPTURES.inc(1, outcome="error")
            raise
        _M_CAPTURES.inc(1, outcome="ok")
    finally:
        _capture_lock.release()


def capture_snapshot(reason: str, duration_ms: float | None = None,
                     **extra) -> dict:
    """The JSON half of a deep capture: the last goodput decomposition,
    the ledger table + reconciliation, the full registry and the
    resolved knob table — everything a profile needs for context."""
    snap = {
        "prof_schema": PROF_SCHEMA_VERSION,
        "written_at": time.time(),
        "pid": os.getpid(),
        "reason": reason,
        "duration_ms": duration_ms,
        "goodput": last_goodput(),
        "ledger": LEDGER.snapshot(),
        "reconciliation": LEDGER.reconcile(),
        "registry": REGISTRY.snapshot(),
        "knobs": knobs.resolved(),
    }
    if extra:
        snap["extra"] = extra
    return snap


#: the Chrome trace a capture writes, under its ``torch_trace/`` directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def _torch_trace(out_dir: str):
    """``torch.profiler`` over the body with the CPU activity, and the CUDA
    one when a CUDA device exists, exported as a Chrome trace into
    ``out_dir``. Spans of obs/trace.py open ``record_function`` ranges
    while it records, so they land on the same timeline."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
    finally:
        # written when the body raised too: a failing body is the one
        # most worth a profile
        if prof is not None:
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))


def capture(duration_ms: float | None = None, *, reason: str = "manual",
            body=None) -> dict:
    """One serialized, rate-limited deep capture into an atomic artifact
    dir. ``duration_ms`` holds the profiler open that long (clamped
    to ``OTPU_PROF_MAX_MS``) — the serving shape, capturing whatever the
    process runs meanwhile; ``body`` (a callable) is traced instead when
    given (the tool shape). Returns ``{"path", "reason", "duration_ms",
    "snapshot"}``."""
    if not prof_enabled():
        raise CaptureDisabledError(
            "deep capture disabled (OTPU_PROF=0)")
    with _capture_session():
        max_ms = float(knobs.get_float("OTPU_PROF_MAX_MS"))
        if duration_ms is not None:
            duration_ms = min(max(float(duration_ms), 0.0), max_ms)
        directory = knobs.get_str("OTPU_PROF_DIR")
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:48]
        final = os.path.join(directory,
                             f"capture-{time.time_ns()}-{safe}")
        tmp = f"{final}.tmp-{os.getpid()}"
        try:
            os.makedirs(tmp, exist_ok=True)
            _trace.instant("profile_capture", reason=reason,
                           duration_ms=duration_ms)
            traced_err = None
            try:
                # a profiler that fails to start or to export degrades the
                # capture to the snapshot alone, with the error noted
                with _torch_trace(os.path.join(tmp, "torch_trace")):
                    if body is not None:
                        body()
                    elif duration_ms:
                        time.sleep(duration_ms / 1e3)
            except Exception as e:  # noqa: BLE001 - snapshot still lands
                traced_err = f"{type(e).__name__}: {e}"
            snap = capture_snapshot(reason, duration_ms)
            if traced_err:
                snap["trace_error"] = traced_err
            with open(os.path.join(tmp, "snapshot.json"), "w") as f:
                json.dump(snap, f, default=str)
            os.rename(tmp, final)   # atomic publish: never a torn capture
        except BaseException:
            # a failed write must leave no .tmp litter retention never
            # prunes; the session hands the rate slot back
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return {"path": final, "reason": reason,
                "duration_ms": duration_ms, "snapshot": snap}


def _merge_move(src: str, dst: str) -> None:
    """Move a completed capture tree into place: plain rename when the
    destination is fresh; merge dirs recursively otherwise (files
    overwrite via ``os.replace`` — e.g. a repeat run's snapshot.json)."""
    if not os.path.exists(dst):
        os.rename(src, dst)
        return
    if os.path.isdir(src) and os.path.isdir(dst):
        for name in os.listdir(src):
            _merge_move(os.path.join(src, name), os.path.join(dst, name))
        os.rmdir(src)
    else:
        os.replace(src, dst)


@contextlib.contextmanager
def trace_capture(log_dir: str):
    """The ``utils.profiling.profile_trace`` back end: the same
    serialized + rate-limited capture machinery, writing into the
    CALLER's directory atomically (trace into a ``.tmp`` sibling,
    rename/merge on exit) and dropping a ``snapshot.json`` beside the
    profile's ``trace.json``. Under ``OTPU_PROF=0`` this is a bare
    profiler around the body."""
    if not prof_enabled():
        with _torch_trace(log_dir):
            yield
        return
    body_err: BaseException | None = None
    with _capture_session():
        tmp = f"{log_dir.rstrip(os.sep)}.tmp-{os.getpid()}"
        try:
            os.makedirs(tmp, exist_ok=True)
            _trace.instant("profile_capture", reason="profile_trace")
            try:
                with _torch_trace(tmp):
                    yield
            except BaseException as e:  # noqa: BLE001 - re-raised below
                # the profiler's exit already wrote the trace — a failing
                # body is the capture you MOST want a profile of, so
                # PUBLISH the artifact (error noted in the snapshot),
                # then re-raise the body's exception AFTER the session
                # closed clean (outcome stays ok)
                body_err = e
            snap = capture_snapshot("profile_trace")
            if body_err is not None:
                snap["body_error"] = (f"{type(body_err).__name__}: "
                                      f"{body_err}")
            with open(os.path.join(tmp, "snapshot.json"), "w") as f:
                json.dump(snap, f, default=str)
            # publish: one rename when the caller's dir is fresh; repeat
            # runs into the SAME dir merge (trace.json and snapshot.json
            # replaced). Either way nothing lands until the capture ended
            _merge_move(tmp, log_dir)
        except BaseException:
            # the CAPTURE itself failed (profiler refused, full disk,
            # unmovable dir): no artifact landed — leave no .tmp
            # litter; the session hands the rate slot back
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
            raise
    if body_err is not None:
        raise body_err
