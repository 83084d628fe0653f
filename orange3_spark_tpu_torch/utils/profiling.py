"""Counters of the serving and resilience layers, and profiling hooks.

A copy of the JAX package's ``utils/profiling.py``:

* ``profile_trace(dir)`` — a ``torch.profiler`` trace (CPU and CUDA
  activities) of the body into ``dir`` as a Chrome trace, through the deep
  capture path of obs/prof.py (serialized, rate-limited, written
  atomically, with a ``snapshot.json`` beside it). Spans of obs/trace.py
  open ``record_function`` ranges while it records, so the fit/epoch/
  chunk/dispatch structure lines up against the CUDA kernels.
* ``timed`` — structured per-call wall-clock logging: a
  ``timed:<label>`` span, the ``otpu_timed_seconds`` histogram and the
  JAX package's log line, byte for byte.
* counter shims — ``exec_counters()`` / ``serve_counters()`` /
  ``resilience_counters()``, field-compatible with the JAX package's
  dicts, as views over the typed ``obs.registry`` metrics;
* the CUDA-graph capture count (``count_graph_capture`` /
  ``graph_capture_count``) in place of the JAX package's XLA compile
  count (its ``jax.monitoring`` listener): a captured graph is this
  package's counterpart of a compiled XLA executable. The serving builds
  and the fit's replay (``_Replay``) tick it.

The spill's CRC check ticks ``record_crc_failure``; the dispatch watchdog
ticks ``record_wedge``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from functools import wraps

from orange3_spark_tpu_torch.obs import trace as _trace
from orange3_spark_tpu_torch.obs.registry import REGISTRY

log = logging.getLogger("orange3_spark_tpu_torch")

# ------------------------------------------------------- exec/ metrics
# one registry metric per legacy field; the shim dicts below are views
_M_DISPATCHES = REGISTRY.counter(
    "otpu_dispatches_total",
    "device programs dispatched (ticked by utils.dispatch.bound_dispatch "
    "and the one-shot fused-scan sites)")
_M_PREFETCH_ITEMS = REGISTRY.counter(
    "otpu_prefetch_items_total",
    "chunks through PipelinedExecutor streams")
_M_PREFETCH_PREP_S = REGISTRY.counter(
    "otpu_prefetch_prep_seconds_total",
    "producer busy seconds (parse/pad/device_put) on prefetch threads")
_M_PREFETCH_WAIT_S = REGISTRY.counter(
    "otpu_prefetch_wait_seconds_total",
    "consumer seconds blocked waiting on the prefetch queue")
_M_PREFETCH_RETRIES = REGISTRY.counter(
    "otpu_prefetch_retries_total",
    "transient source reads retried on prefetch threads (resilience/)")

_EXEC_FIELDS = {
    "dispatches": (_M_DISPATCHES, int),
    "prefetch_items": (_M_PREFETCH_ITEMS, int),
    "prefetch_prep_s": (_M_PREFETCH_PREP_S, float),
    "prefetch_wait_s": (_M_PREFETCH_WAIT_S, float),
    "prefetch_retries": (_M_PREFETCH_RETRIES, int),
}


def count_dispatch(n: int = 1) -> None:
    """Tick the process-wide device-dispatch counter."""
    _M_DISPATCHES.inc(n)


def record_pipeline(stats) -> None:
    """Fold one finished ``PipelineStats`` into the process aggregate."""
    _M_PREFETCH_ITEMS.inc(stats.items)
    _M_PREFETCH_PREP_S.inc(stats.prep_s)
    _M_PREFETCH_WAIT_S.inc(stats.wait_s)
    _M_PREFETCH_RETRIES.inc(stats.retries)


def exec_counters() -> dict:
    """Snapshot of the exec counters, plus the derived ``overlap_pct``
    (share of total producer time hidden behind consumer compute across
    every recorded pipeline — see ``exec.pipeline.PipelineStats``)."""
    out = {k: cast(m.total()) for k, (m, cast) in _EXEC_FIELDS.items()}
    prep = out["prefetch_prep_s"]
    out["overlap_pct"] = (
        100.0 * min(max(1.0 - out["prefetch_wait_s"] / prep, 0.0), 1.0)
        if prep > 0 else 0.0
    )
    return out


def reset_exec_counters() -> None:
    """Zero the counters (benches bracket their timed window with this)."""
    for m, _ in _EXEC_FIELDS.values():
        m.reset()


# ------------------------------------------------------- serve/ metrics
# Process-wide aggregates for the serving subsystem (serve/): the AOT
# executable cache ticks hits/misses/evictions and accumulates compile
# seconds; the bucketing layer ticks bucket_hits vs bucket_misses — per
# DEVICE DISPATCH, so coalesced requests sharing one merged dispatch tick
# once — and the padding overhead; the micro-batcher reports its merge
# factor (requests per dispatched batch).
_SERVE_FIELDS = {
    "aot_hits": (REGISTRY.counter(
        "otpu_serve_aot_hits_total",
        "executables served from the in-process AOT cache"), int),
    "aot_misses": (REGISTRY.counter(
        "otpu_serve_aot_misses_total",
        "lower+compile paid (first touch / evicted)"), int),
    "aot_evictions": (REGISTRY.counter(
        "otpu_serve_aot_evictions_total",
        "LRU evictions from the executable cache"), int),
    "aot_compile_s": (REGISTRY.counter(
        "otpu_serve_aot_compile_seconds_total",
        "seconds inside lower().compile()"), float),
    "bucket_hits": (REGISTRY.counter(
        "otpu_serve_bucket_hits_total",
        "dispatches that landed on an already-seen bucket"), int),
    "bucket_misses": (REGISTRY.counter(
        "otpu_serve_bucket_misses_total",
        "dispatches that were a bucket's first touch"), int),
    "request_rows": (REGISTRY.counter(
        "otpu_serve_request_rows_total",
        "logical rows requested through serve/"), int),
    "padded_rows": (REGISTRY.counter(
        "otpu_serve_padded_rows_total",
        "total rows dispatched (incl. bucket padding)"), int),
    "mb_requests": (REGISTRY.counter(
        "otpu_serve_mb_requests_total",
        "predict() calls through the micro-batcher"), int),
    "mb_batches": (REGISTRY.counter(
        "otpu_serve_mb_batches_total",
        "coalesced device dispatches the micro-batcher issued"), int),
    "graph_replays": (REGISTRY.counter(
        "otpu_serve_graph_replays_total",
        "bucketed dispatches served by replaying a captured CUDA graph"), int),
    "build_failures": (REGISTRY.counter(
        "otpu_serve_build_failures_total",
        "serving builds (graph captures) that failed and opened a breaker"), int),
}


def record_serve(**deltas) -> None:
    """Fold counter deltas into the process-wide serve aggregate. Unknown
    keys raise immediately WITH the registered set — a typo'd counter name
    must fail loudly at the call site, not as a bare KeyError from a hot
    path's stack."""
    for k, v in deltas.items():
        field = _SERVE_FIELDS.get(k)
        if field is None:
            raise KeyError(
                f"record_serve: unknown serve counter {k!r}; registered "
                f"counters: {sorted(_SERVE_FIELDS)}")
        field[0].inc(v)


def serve_counters() -> dict:
    """Snapshot of the serve counters plus derived ratios: ``pad_overhead``
    (dispatched/requested rows — 1.0 means zero padding waste) and
    ``mb_merge_factor`` (requests per micro-batch dispatch).

    Cross-FIELD atomicity note: each metric locks independently (the
    per-metric-locking design, obs/registry.py), so a snapshot taken
    concurrently with a multi-counter tick (e.g. the micro-batcher's
    requests+batches pair) can momentarily tear by one event — derived
    ratios here are monitoring-grade, not transactional. The old shared
    _exec_lock made snapshots atomic at the price of serializing every
    subsystem's hot-path ticks on one lock."""
    out = {k: cast(m.total()) for k, (m, cast) in _SERVE_FIELDS.items()}
    out["pad_overhead"] = (
        out["padded_rows"] / out["request_rows"]
        if out["request_rows"] else None
    )
    out["mb_merge_factor"] = (
        out["mb_requests"] / out["mb_batches"] if out["mb_batches"] else None
    )
    return out


def reset_serve_counters() -> None:
    for m, _ in _SERVE_FIELDS.values():
        m.reset()


# --------------------------------------------------- resilience/ metrics
# The fault injectors tick faults_injected per kind (label), the retry
# policy ticks retries per CAUSE ('source' = chunk-source reads,
# 'aot_build' = serving executable builds) plus the backoff seconds it
# cost, the dispatch watchdog ticks wedges, and the spill CRC verifier
# ticks crc_failures. Each event also lands as an instant on the obs
# trace timeline, so an injected-fault run's retries/wedges appear in the
# exported Chrome trace next to the spans they interrupted.
_M_RETRIES = REGISTRY.counter(
    "otpu_retries_total", "transient-failure retries, by cause")
_M_RETRY_WAIT_S = REGISTRY.counter(
    "otpu_retry_wait_seconds_total", "total backoff slept")
_M_FAULTS = REGISTRY.counter(
    "otpu_faults_injected_total", "fault-injector firings, by kind")
_M_WEDGES = REGISTRY.counter(
    "otpu_wedges_total", "DispatchWedgedError raised by the watchdog")
_M_CRC_FAILURES = REGISTRY.counter(
    "otpu_spill_crc_failures_total",
    "spill records failing CRC verification")


def record_retry(cause: str, wait_s: float = 0.0) -> None:
    if not isinstance(cause, str) or not cause:
        raise TypeError(
            f"record_retry: cause must be a non-empty label string "
            f"(e.g. 'source', 'aot_build'), got {cause!r}")
    _M_RETRIES.inc(1, cause=cause)
    _M_RETRY_WAIT_S.inc(wait_s)
    _trace.instant("retry", cause=cause, wait_s=round(wait_s, 6))


def record_wedge() -> None:
    _M_WEDGES.inc()
    _trace.instant("wedge")


def record_fault(kind: str) -> None:
    _M_FAULTS.inc(1, kind=kind)
    _trace.instant("fault", kind=kind)


def record_crc_failure() -> None:
    _M_CRC_FAILURES.inc()
    _trace.instant("crc_failure")


def resilience_counters() -> dict:
    """Snapshot: the flat counters plus per-cause/per-kind breakdowns."""
    return {
        "faults_injected": int(_M_FAULTS.total()),
        "retries": int(_M_RETRIES.total()),
        "retry_wait_s": float(_M_RETRY_WAIT_S.total()),
        "wedges": int(_M_WEDGES.total()),
        "crc_failures": int(_M_CRC_FAILURES.total()),
        "retries_by_cause": {k: int(v) for k, v
                             in _M_RETRIES.per_label("cause").items()},
        "faults_by_kind": {k: int(v) for k, v
                           in _M_FAULTS.per_label("kind").items()},
    }


def reset_resilience_counters() -> None:
    for m in (_M_FAULTS, _M_RETRIES, _M_RETRY_WAIT_S, _M_WEDGES,
              _M_CRC_FAILURES):
        m.reset()


# ------------------------------------------------ CUDA graph captures
# One process-wide count of CUDA graph captures: the serving path's bucket
# builds and the fit's replay capture. The serving bench's
# ``graph_captures`` field reads it (the JAX package's ``recompiles``).
_M_GRAPH_CAPTURES = REGISTRY.counter(
    "otpu_cuda_graph_captures_total", "CUDA graphs captured")


def count_graph_capture(n: int = 1) -> None:
    """Tick the capture count (called once per finished capture)."""
    _M_GRAPH_CAPTURES.inc(n)


def graph_capture_count() -> int:
    """CUDA graphs captured in this process so far."""
    return int(_M_GRAPH_CAPTURES.total())


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Device+host profile of the body into ``log_dir`` (a Chrome trace,
    ``trace.json``: chrome://tracing or Perfetto). Routes through the
    deep-capture path (obs/prof.py): serialized with every other capture
    (a second concurrent profile raises ``CaptureBusyError``), rate-limited
    by ``OTPU_PROF_RATE_S``, written ATOMICALLY (the trace lands in a tmp
    sibling, renamed complete) with a ``snapshot.json`` (goodput + ledger
    + registry + knobs) beside it. ``OTPU_PROF=0`` leaves a bare profiler
    around the body."""
    from orange3_spark_tpu_torch.obs.prof import trace_capture

    with trace_capture(log_dir):
        yield


_M_TIMED_S = REGISTRY.histogram(
    "otpu_timed_seconds", "wall seconds of @timed-decorated calls")


def timed(fn=None, *, name: str | None = None):
    """Decorator: log wall-clock (+ rows/sec when an argument is a table).

    Also spans the call (``timed:<label>`` in obs trace dumps) and
    observes ``otpu_timed_seconds{label=...}``; the log line is the JAX
    package's, byte for byte. The wall is the host's: a caller that wants
    the device's time synchronizes inside the call."""

    def deco(f):
        label = name or f.__qualname__

        @wraps(f)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            with _trace.span(f"timed:{label}"):
                out = f(*args, **kwargs)
            dt = time.perf_counter() - t0
            _M_TIMED_S.observe(dt, label=label)
            extra = ""
            for a in args:
                n = getattr(a, "n_rows", None)
                if isinstance(n, int):
                    extra = f" ({n / max(dt, 1e-9):,.0f} rows/s)"
                    break
            log.info("%s: %.3fs%s", label, dt, extra)
            return out

        return wrapper

    return deco(fn) if fn is not None else deco
