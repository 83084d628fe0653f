"""Trace-context propagation — Dapper-style request identity end-to-end.

Spans alone answer "what regions ran"; they cannot answer "which
REQUEST was that" — a micro-batched predict's submit, coalesced flush and
device dispatch land as unrelated events on three threads, and a typed
failure in production names no request at all. This module is the missing
identity layer:

* every routed serve call gets a **trace id** at ``route()`` /
  ``served_array()`` entry; every fit gets a **run id** at its
  ``fit_stream`` entry (the ``@traced("fit")`` chokepoint);
* the id rides a ``contextvars.ContextVar`` through the caller's whole
  request path — admission slots, the micro-batcher submit, the bucketed
  dispatch — and is explicitly adopted by worker threads that continue a
  request's work on another stack (the prefetch producer via
  :func:`adopt`; the micro-batcher carries per-request ids on the queued
  requests themselves, since one flush serves many traces);
* every span recorded while a context is active carries
  ``trace_id``/``span_id``/``parent_id`` (obs/trace.py), and the typed
  anomalies (``OverloadShedError``, ``MicroBatchTimeoutError``,
  ``DispatchWedgedError``, ``NumericalDivergenceError``) carry the trace
  id of the request they killed;
* **tail-biased retention**: under load, recording every fast-OK serve
  trace would wash the ring with the traces nobody debugs. With
  ``OTPU_TRACE_SAMPLE < 1`` a serve trace is sampled by a deterministic
  per-trace-id coin; an UNSAMPLED trace buffers its spans on the context
  and flushes them into the ring only if the request turned out
  interesting — it erred, was shed (:func:`flag_current_trace`), or ran
  slower than ``OTPU_TRACE_SLOW_MS`` — so slow/shed/erroring traces stay
  WHOLE in the ring while fast-OK ones pay one dropped list. Fit run
  contexts never sample (one fit is never ring-washing volume).

The scope is inert (shared no-op) under ``OTPU_OBS=0`` — zero allocation,
no contextvar writes.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
import zlib

from contextvars import ContextVar

from orange3_spark_tpu_torch.utils import knobs

__all__ = [
    "TraceContext",
    "adopt",
    "current_trace",
    "current_trace_id",
    "flag_current_trace",
    "new_trace_id",
    "propagated_scope",
    "trace_scope",
]

#: the active TraceContext for this thread/task (workers inherit nothing —
#: they must adopt() the owning request's context explicitly)
_CTX: ContextVar["TraceContext | None"] = ContextVar(
    "otpu_trace_ctx", default=None)

_ids = itertools.count(1)


def new_trace_id(kind: str) -> str:
    """Process-unique, kind-prefixed id: ``serve-<pid>-<n>`` — readable in
    a Perfetto args pane and greppable in a flight bundle."""
    return f"{kind}-{os.getpid():x}-{next(_ids):06x}"


class TraceContext:
    """One request's (or one fit's) identity + retention state."""

    __slots__ = ("trace_id", "kind", "buffer", "flagged", "t0_ns")

    def __init__(self, trace_id: str, kind: str, sampled: bool):
        self.trace_id = trace_id
        self.kind = kind
        # None = record straight to the ring; a list = tail-retention
        # buffer (flushed on flag/error/slow, dropped otherwise)
        self.buffer: list | None = None if sampled else []
        self.flagged = False
        self.t0_ns = time.perf_counter_ns()

    def flag(self) -> None:
        """Mark this trace interesting: its buffered spans (if any) will
        flush into the ring at scope exit regardless of latency."""
        self.flagged = True


def current_trace() -> TraceContext | None:
    return _CTX.get()


def current_trace_id() -> str | None:
    """The active trace/run id, or None — what typed errors and flight
    bundles stamp themselves with."""
    ctx = _CTX.get()
    return ctx.trace_id if ctx is not None else None


def flag_current_trace() -> None:
    """Anomaly chokepoints (sheds, wedges, divergence) call this so an
    unsampled trace that hit one is retained whole."""
    ctx = _CTX.get()
    if ctx is not None:
        ctx.flag()


def _sampled(trace_id: str, sample: bool) -> bool:
    if not sample:
        return True
    rate = float(knobs.get_float("OTPU_TRACE_SAMPLE"))
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    # deterministic per-id coin (the fault-injection crc32 convention):
    # the same trace id samples the same way in a test and a subprocess
    return zlib.crc32(trace_id.encode()) / 0xFFFFFFFF < rate


class _NullScope:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullScope()


class _Scope:
    __slots__ = ("ctx", "_token")

    def __init__(self, ctx: TraceContext):
        self.ctx = ctx
        self._token = None

    def __enter__(self) -> TraceContext:
        self._token = _CTX.set(self.ctx)
        return self.ctx

    def __exit__(self, exc_type, exc, tb) -> bool:
        _CTX.reset(self._token)
        ctx = self.ctx
        buf = ctx.buffer
        if buf is not None:
            # tail-biased retention: keep the whole trace when it erred,
            # was flagged (shed/wedge), or ran slow; drop it otherwise
            slow_ns = float(knobs.get_float("OTPU_TRACE_SLOW_MS")) * 1e6
            if (ctx.flagged or exc_type is not None
                    or time.perf_counter_ns() - ctx.t0_ns >= slow_ns):
                from orange3_spark_tpu_torch.obs import trace

                trace.flush_buffered(buf)
            buf.clear()
        return False


def trace_scope(kind: str = "serve", *, reuse: bool = False,
                sample: bool = False):
    """Bind a fresh trace context over a block. ``reuse=True`` keeps an
    already-active context instead of nesting a new identity (a fit
    bracketed by ``Estimator.fit`` must not mint two run ids);
    ``sample=True`` applies the ``OTPU_TRACE_SAMPLE`` tail-retention coin
    (serve requests — fits always record). No-op under ``OTPU_OBS=0``."""
    from orange3_spark_tpu_torch.obs import trace

    if not trace.enabled():
        return _NULL
    if reuse and _CTX.get() is not None:
        return _NULL
    trace_id = new_trace_id(kind)
    return _Scope(TraceContext(trace_id, kind, _sampled(trace_id, sample)))


def propagated_scope(trace_id: str | None, kind: str = "serve"):
    """Adopt a trace id minted in ANOTHER process — the fleet RPC header
    (``X-OTPU-Trace``, fleet/rpc.py): the replica's serve/dispatch spans
    then carry the router-minted identity, so one trace spans
    router → replica → device dispatch across the process boundary.
    Propagated requests never tail-sample (the router already owns the
    retention decision for the trace; a replica dropping its half would
    leave every exported cross-process trace dangling). No-op under
    ``OTPU_OBS=0`` or with no id to adopt."""
    from orange3_spark_tpu_torch.obs import trace

    if not trace_id or not trace.enabled():
        return _NULL
    return _Scope(TraceContext(trace_id, kind, sampled=True))


@contextlib.contextmanager
def adopt(ctx: TraceContext | None):
    """Worker threads continuing a request's work on another stack (the
    prefetch producer) adopt the owning context so their spans carry the
    same trace id. None adopts nothing (plain passthrough)."""
    if ctx is None:
        yield
        return
    token = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(token)
