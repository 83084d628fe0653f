"""Anomaly flight recorder — the black box that dumps itself on failure.

A copy of the JAX package's ``obs/flight.py``; bundles keep its schema 1,
so the JAX package's stdlib ``tools/flight_view.py`` renders a bundle of
this package. When one of the typed anomalies fires
(``DispatchWedgedError``, ``OverloadShedError``,
``NumericalDivergenceError``, ``SpillCorruptionError``), the state that
explains it — the recent span timeline, which spans were still OPEN on
which thread, breaker states, admission/micro-batch queue depths, the
brownout level, the device-memory ledger with the CUDA allocator's view,
the resolved knob table and every thread's Python stack — is gone by the
time anyone attaches a debugger. This module freezes all of it into ONE
versioned JSON bundle at the raise site.

* :func:`auto_dump` — the raise-site hook: rate-limited
  (``OTPU_FLIGHT_RATE_S`` between automatic bundles — an overload storm
  must not turn the recorder into its own IO storm), never raises (a
  failing black box must not mask the anomaly it records), inert under
  ``OTPU_FLIGHT=0`` and under the obs master switch ``OTPU_OBS=0``.
* :func:`dump` — the manual pull (``ServingContext.dump_flight()``, the
  ``/debug/flight`` endpoint): same bundle, no rate limit.
* Bundles land in ``OTPU_FLIGHT_DIR`` as ``flight-<ns>-<reason>.json``,
  written atomically (tmp + rename: a reader never sees torn JSON), and
  the directory keeps at most ``OTPU_FLIGHT_MAX`` bundles (oldest
  deleted) — a misbehaving week cannot fill a disk.

Bundle schema (``flight_schema`` = 1):
``reason`` / ``error`` / ``trace_id`` identify the anomaly; ``events``
(the last-N ring events, Chrome-ish dicts) + ``open_spans`` give the
timeline; ``registry`` is the full metrics snapshot; ``breakers`` /
``admission`` / ``mb_queue_depth`` / ``brownout_level`` / ``sheds`` give
the control-plane state; ``device_memory`` is the ledger table (obs/prof.py)
with its reconciliation against the CUDA caching allocator; ``knobs`` is
the resolved env-knob table; ``stacks`` holds every thread's Python frames
via ``sys._current_frames()``.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback

from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

__all__ = [
    "FLIGHT_SCHEMA_VERSION",
    "auto_dump",
    "bundles_written",
    "collect_bundle",
    "dump",
    "flight_enabled",
    "thread_stacks",
]

log = logging.getLogger("orange3_spark_tpu_torch")

FLIGHT_SCHEMA_VERSION = 1

#: ring events included in a bundle (the newest; the full ring can be
#: 65536 events — a bundle wants the recent past, not a 40 MB artifact)
MAX_BUNDLE_EVENTS = 512

_M_BUNDLES = REGISTRY.counter(
    "otpu_flight_bundles_total",
    "anomaly flight bundles written, by reason")

_rate_lock = threading.Lock()
_last_auto_dump = 0.0          # monotonic; 0 = never


def flight_enabled() -> bool:
    """Both switches: the obs master (``OTPU_OBS``) and the recorder's own
    kill-switch (``OTPU_FLIGHT``). Re-resolved per call — an operator can
    silence a dump storm live."""
    from orange3_spark_tpu_torch.obs import trace

    return trace.refreshed_enabled() and knobs.get_bool("OTPU_FLIGHT")


def bundles_written() -> int:
    """Total flight bundles this process has written (all reasons)."""
    return int(_M_BUNDLES.total())


def thread_stacks() -> dict:
    """Every thread's current Python stack, keyed ``"<name> (<ident>)"``
    — ``sys._current_frames()`` reaches threads blocked in C calls (the
    abandoned dispatch waiter parked in the runtime shows up here, which
    is exactly the thread a wedge post-mortem needs)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, 'unknown')} ({ident})"
        out[key] = [ln.rstrip("\n")
                    for ln in traceback.format_stack(frame)]
    return out


def _control_plane(context=None) -> dict:
    """Breakers, admission/mb queue depths, brownout — best-effort (each
    piece guarded: a half-torn serving context must not kill the dump)."""
    out: dict = {"breakers": {}, "admission": None, "mb_queue_depth": None,
                 "brownout_level": None, "sheds": None}
    try:
        from orange3_spark_tpu_torch.resilience.overload import (
            current_brownout_level, shed_total, wedge_breaker,
        )

        out["breakers"]["dispatch"] = wedge_breaker().state()
        out["brownout_level"] = current_brownout_level()
        out["sheds"] = shed_total()
    except Exception:  # noqa: BLE001 - diagnostics only
        pass
    try:
        if context is None:
            from orange3_spark_tpu_torch.serve.context import (
                active_serving_context,
            )

            context = active_serving_context()
        if context is not None:
            out["breakers"].update(context.breaker_states())
            adm = getattr(context, "admission", None)
            if adm is not None:
                out["admission"] = {"inflight": adm.inflight,
                                    "queue_depth": adm.queue_depth,
                                    "max_inflight": adm.max_inflight,
                                    "max_queue": adm.max_queue}
            mb = getattr(context, "micro_batcher", None)
            if mb is not None:
                d = mb.diagnostics()    # the batcher's own accessor —
                #                         queue depth + worker liveness
                out["mb_queue_depth"] = d.get("queue_depth")
                out["mb"] = d
    except Exception:  # noqa: BLE001 - diagnostics only
        pass
    try:
        # weighted-fair tenancy (serve/tenancy.py): who was over quota
        # when the incident froze — present only once a tenant exists,
        # so tenant-less bundles keep their exact pre-tenancy shape
        from orange3_spark_tpu_torch.serve.tenancy import tenant_shed_counts

        tenants: dict = {}
        adm = getattr(context, "admission", None) if context else None
        if adm is not None:
            table = adm.tenancy_snapshot()
            if table:
                tenants["fair_share"] = table
        sheds = tenant_shed_counts()
        if sheds:
            tenants["sheds"] = sheds
        if tenants:
            out["tenants"] = tenants
    except Exception:  # noqa: BLE001 - diagnostics only
        pass
    return out


def _event_dict(ev) -> dict:
    ph, name, t_ns, dur_ns, ident, args, trace_id, span_id, parent_id = ev
    d = {"ph": ph, "name": name, "ts_us": round(t_ns / 1e3, 3),
         "thread": ident}
    if ph == "X":
        d["dur_us"] = round(dur_ns / 1e3, 3)
    if args:
        d["args"] = dict(args)
    if trace_id is not None:
        d["trace_id"] = trace_id
        if span_id is not None:
            d["span_id"] = span_id
        if parent_id is not None:
            d["parent_id"] = parent_id
    return d


def collect_bundle(reason: str, error: BaseException | None = None,
                   context=None, **extra) -> dict:
    """Assemble the bundle dict (no IO). Safe to call concurrently with
    active span recording and registry ticks: the ring snapshot copies
    slot references (each slot an immutable tuple) and the registry
    snapshot copies under per-metric locks — no torn reads either way."""
    from orange3_spark_tpu_torch.obs import trace
    from orange3_spark_tpu_torch.obs.context import current_trace_id

    events = [_event_dict(e) for e in trace.events()[-MAX_BUNDLE_EVENTS:]]
    trace_id = getattr(error, "trace_id", None) or current_trace_id()
    bundle = {
        "flight_schema": FLIGHT_SCHEMA_VERSION,
        "written_at": time.time(),
        "pid": os.getpid(),
        "reason": reason,
        "trace_id": trace_id,
        "error": ({"type": type(error).__name__, "message": str(error)}
                  if error is not None else None),
        "events": events,
        "open_spans": trace.open_spans(),
        "slow_traces": trace.slowest_traces(5),
        "registry": REGISTRY.snapshot(),
        "knobs": knobs.resolved(),
        "stacks": thread_stacks(),
    }
    try:
        # device-memory ledger table (obs/prof.py): an OOM-adjacent
        # brownout post-mortem names the tenant; the reconciliation reads
        # the CUDA caching allocator. Best-effort, one lock, no IO
        from orange3_spark_tpu_torch.obs.prof import LEDGER

        dm = LEDGER.snapshot()
        dm["reconciliation"] = LEDGER.reconcile()
        bundle["device_memory"] = dm
    except Exception:  # noqa: BLE001 - diagnostics only
        pass
    bundle.update(_control_plane(context))
    if extra:
        bundle["extra"] = extra
    return bundle


def _flight_dir() -> str:
    return knobs.get_str("OTPU_FLIGHT_DIR")


def _prune(directory: str, keep: int, prefix: str = "flight") -> None:
    names = sorted(n for n in os.listdir(directory)
                   if n.startswith(prefix + "-") and n.endswith(".json"))
    for n in names[:max(0, len(names) - keep)]:
        try:
            os.remove(os.path.join(directory, n))
        except OSError:
            pass


def debug_bundle(context=None) -> dict:
    """The ``GET /debug/flight`` body of the obs server: collect one bundle NOW — the manual black-box pull, no
    rate limit, the operator asked — write it, and return it with its
    ``path`` so the caller sees where it landed."""
    bundle = collect_bundle("debug_endpoint", context=context)
    path = dump("debug_endpoint", bundle=bundle)
    bundle["path"] = path
    return bundle


def dump(reason: str, error: BaseException | None = None, *,
         context=None, path: str | None = None, bundle: dict | None = None,
         prefix: str = "flight", **extra) -> str | None:
    """Write one flight bundle NOW; returns its path (None when the
    recorder is disabled). The manual entry point — no rate limit.
    Atomic write (tmp + ``os.replace``): a concurrent reader always sees
    complete, valid JSON. ``bundle`` reuses an already-collected bundle
    (the /debug/flight endpoint collects once, returns AND writes it).
    ``prefix`` names the bundle family (``flight-*``); retention counts
    one family at a time."""
    if not flight_enabled():
        return None
    if bundle is None:
        bundle = collect_bundle(reason, error, context, **extra)
    in_flight_dir = path is None
    if in_flight_dir:
        directory = _flight_dir()
        os.makedirs(directory, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:48]
        path = os.path.join(
            directory, f"{prefix}-{time.time_ns()}-{safe}.json")
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(bundle, f, default=str)
        os.replace(tmp, path)
    except BaseException:
        # a failed write (full disk — exactly auto_dump's swallowed
        # case) must not leave orphan .tmp files retention never prunes
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _M_BUNDLES.inc(1, reason=reason)
    if in_flight_dir:        # retention applies to OUR directory only —
        #                      an explicit path is the caller's business
        keep = int(knobs.get_int("OTPU_FLIGHT_MAX"))
        if keep > 0:
            _prune(os.path.dirname(path) or ".", keep, prefix)
    return path


def auto_dump(reason: str, error: BaseException | None = None,
              context=None, **extra) -> str | None:
    """The raise-site hook: rate-limited :func:`dump` that NEVER raises —
    an anomaly's flight bundle is best-effort evidence, and a full disk
    or unwritable ``OTPU_FLIGHT_DIR`` must not mask the typed error the
    caller is about to deliver. Returns the path, or None (disabled,
    rate-limited, or write failed)."""
    global _last_auto_dump
    try:
        if not flight_enabled():
            return None
        min_gap = float(knobs.get_float("OTPU_FLIGHT_RATE_S"))
        now = time.monotonic()
        with _rate_lock:
            if _last_auto_dump and now - _last_auto_dump < min_gap:
                return None
            # claim the slot BEFORE the (slow) write: two concurrent
            # anomalies produce one bundle, not a pile-up
            prev, _last_auto_dump = _last_auto_dump, now
        try:
            return dump(reason, error, context=context, **extra)
        except Exception as e:  # noqa: BLE001 - must not mask the anomaly
            log.warning("flight: bundle write failed for %s (%s: %s); "
                        "the anomaly itself is unaffected",
                        reason, type(e).__name__, e)
            # release the claimed slot: one transiently-full disk must
            # not silence the whole incident window's bundles
            with _rate_lock:
                if _last_auto_dump == now:
                    _last_auto_dump = prev
            return None
    except Exception:  # noqa: BLE001 - never raise from a raise site
        return None


def reset_rate_limit() -> None:
    """Tests: forget the last automatic dump time."""
    global _last_auto_dump
    with _rate_lock:
        _last_auto_dump = 0.0
