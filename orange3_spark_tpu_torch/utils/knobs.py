"""Registry of the ``OTPU_*`` environment knobs this package reads.

A copy of the JAX package's knob table, cut to the knobs the ported
modules read (the serving path, the resilience and observability layers it
stands on, the chunk cache and the sparse optimizer), with the same names,
types and defaults. Every knob declares its name, type, default, owning
subsystem and a one-line doc; call sites resolve through the typed getters
below.

Types: ``flag`` = "0" disables, anything else (or unset) enables;
``str``/``int``/``float`` parse with fallback to the declared default on
malformed values (an operator typo must never crash a fit).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

__all__ = [
    "KNOBS",
    "Knob",
    "get_bool",
    "get_float",
    "get_int",
    "get_raw",
    "get_str",
]


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    type: str            # 'flag' | 'str' | 'int' | 'float'
    default: Any
    subsystem: str
    doc: str


_ALL = [
    # ------------------------------------------------------------- io/
    Knob("OTPU_CACHE_DTYPE", "str", "", "io",
         "Chunk-cache codec override: f32 | bf16 | packed "
         "(outranks the params' cache_dtype; f32 = legacy bitwise)."),
    # ----------------------------------------------------------- optim/
    Knob("OTPU_SPARSE_UPDATE", "flag", "1", "optim",
         "Sparse touched-row optimizer kill-switch; 0 resolves sparse_* "
         "rules to their dense twins at fit entry."),
    # ------------------------------------------------------ resilience/
    Knob("OTPU_RESILIENCE", "flag", "1", "resilience",
         "Resilience kill-switch; 0 restores fail-fast everywhere while "
         "fault injection stays live."),
    Knob("OTPU_FAULT_SPEC", "str", "", "resilience",
         "Fault-injection spec grammar (docs/resilience.md), e.g. "
         "'source_io:every=7,fails=2'."),
    Knob("OTPU_DISPATCH_BUDGET_S", "float", 0.0, "resilience",
         "Watchdog budget for the periodic dispatch sync; 0 = unbounded "
         "waits (a long compile must never be misread as a wedge)."),
    Knob("OTPU_RETRY_ATTEMPTS", "int", 4, "resilience",
         "Total attempts per transient failure (1 first + N-1 retries)."),
    Knob("OTPU_RETRY_BASE_S", "float", 0.05, "resilience",
         "Exponential-backoff base delay."),
    Knob("OTPU_RETRY_MAX_S", "float", 2.0, "resilience",
         "Backoff delay ceiling."),
    Knob("OTPU_RETRY_MULTIPLIER", "float", 2.0, "resilience",
         "Backoff growth factor per retry."),
    Knob("OTPU_RETRY_JITTER", "float", 0.25, "resilience",
         "Deterministic-jitter fraction added to each delay."),
    Knob("OTPU_MB_DEADLINE_S", "float", 30.0, "resilience",
         "Hard deadline on micro-batched futures; a dead/wedged coalescer "
         "raises MicroBatchTimeoutError instead of hanging the caller."),
    Knob("OTPU_ADMISSION_MAX_INFLIGHT", "int", 64, "resilience",
         "Serving admission bound: dispatches concurrently in flight; "
         "0 = unbounded (legacy)."),
    Knob("OTPU_ADMISSION_MAX_QUEUE", "int", 256, "resilience",
         "Callers allowed to wait on admission before excess requests "
         "shed with OverloadShedError."),
    Knob("OTPU_ADMISSION_DEADLINE_S", "float", 0.0, "resilience",
         "Default per-request deadline budget: shed when projected queue "
         "wait exceeds it (0 = no deadline; request_deadline() overrides "
         "per thread)."),
    Knob("OTPU_ADMISSION_SERVICE_MS", "float", 0.0, "resilience",
         "Seed/floor for the admission controller's EWMA service-time "
         "estimate (a cold start must not admit a burst on a zero "
         "estimate)."),
    Knob("OTPU_BREAKER_THRESHOLD", "int", 1, "resilience",
         "Consecutive failures that open a circuit breaker (serving "
         "build failures arrive post-retry, so 1 preserves the old "
         "blacklist economics)."),
    Knob("OTPU_BREAKER_COOLDOWN_S", "float", 5.0, "resilience",
         "Open-breaker cooldown before a half-open probe is admitted "
         "(seeded-jittered per open)."),
    Knob("OTPU_BREAKER_PROBES", "int", 1, "resilience",
         "Half-open probe successes required to close a breaker."),
    Knob("OTPU_MB_ADAPT", "flag", "1", "resilience",
         "Adaptive micro-batch coalescing kill-switch; 0 pins the "
         "configured max_wait_ms/max_batch."),
    Knob("OTPU_MB_MAX_WAIT_MS", "float", 20.0, "resilience",
         "Ceiling the adaptive coalescer may grow max_wait_ms to under "
         "sustained queue depth."),
    # ----------------------------------------------------------- serve/
    Knob("OTPU_TENANCY", "flag", "1", "serve",
         "Multi-tenant weighted-fair serving kill-switch; 0 = no tenant "
         "header rides the wire and admission ignores tenant scopes "
         "(the anonymous single-tenant fleet, bitwise)."),
    Knob("OTPU_TENANT_SPEC", "str", "", "serve",
         "Per-tenant quota grammar, ';'-separated "
         "'name:weight=4[,max_inflight=8,deadline_s=0.5]' items "
         "(malformed raises naming the item); unlisted tenants get "
         "OTPU_TENANT_DEFAULT_WEIGHT."),
    Knob("OTPU_TENANT_DEFAULT_WEIGHT", "int", 1, "serve",
         "Weight assigned to tenants absent from OTPU_TENANT_SPEC "
         "(weighted-fair shares are weight / sum of active weights)."),
    Knob("OTPU_TENANT_RATE", "float", 0.0, "serve",
         "Per-weight-unit token-bucket refill rate (requests/s): a "
         "tenant refills at weight x rate and sheds typed on an empty "
         "bucket; 0 = buckets inert (share caps + DRR only)."),
    Knob("OTPU_TENANT_BURST", "int", 8, "serve",
         "Token-bucket capacity per weight unit (the burst a tenant may "
         "spend ahead of its refill rate when OTPU_TENANT_RATE > 0)."),
    # ----------------------------------------------------------- online/
    Knob("OTPU_ONLINE", "flag", "1", "online",
         "Continuous train-while-serve kill-switch; 0 = the serving tap, "
         "incremental trainer and guarded promotion loop are all inert "
         "(the pre-online serving path, bitwise)."),
    # ------------------------------------------------------------- obs/
    Knob("OTPU_OBS", "flag", "1", "obs",
         "Observability master switch; 0 = spans no-op, the telemetry "
         "endpoint never binds, the registry still serves the legacy "
         "counter shims."),
    Knob("OTPU_OBS_TRACE_CAP", "int", 65536, "obs",
         "Span ring-buffer capacity (oldest events overwrite past it)."),
    Knob("OTPU_TRACE_SAMPLE", "float", 1.0, "obs",
         "Fraction of fast-OK serve traces retained in the ring "
         "(deterministic per-trace-id coin); slow, shed and erroring "
         "traces are always kept whole (tail-biased retention)."),
    Knob("OTPU_TRACE_SLOW_MS", "float", 250.0, "obs",
         "Latency above which an unsampled serve trace is retained "
         "anyway (the tail the ring exists to explain)."),
]

KNOBS: dict[str, Knob] = {k.name: k for k in _ALL}

def get_raw(name: str) -> str | None:
    """The raw env string for a REGISTERED knob (KeyError otherwise)."""
    KNOBS[name]
    return os.environ.get(name)


def get_bool(name: str) -> bool:
    """Flag semantics: "0" disables, anything else (or unset-with-truthy-
    default) enables."""
    knob = KNOBS[name]
    v = os.environ.get(name)
    if v is None:
        return str(knob.default) != "0"
    return v != "0"


def get_str(name: str) -> str:
    knob = KNOBS[name]
    v = os.environ.get(name)
    return v if v not in (None, "") else (knob.default or "")


def _num(name: str, cast):
    knob = KNOBS[name]
    v = os.environ.get(name)
    if v in (None, ""):
        return knob.default
    try:
        return cast(float(v)) if cast is int else cast(v)
    except (TypeError, ValueError):
        return knob.default


def get_int(name: str) -> int | None:
    return _num(name, int)


def get_float(name: str) -> float | None:
    return _num(name, float)
