"""Registry of the ``OTPU_*`` environment knobs this package reads.

A copy of the JAX package's knob table, cut to the knobs the ported
modules read (the serving path, the resilience and observability layers it
stands on, the chunk cache, the sparse optimizer, the serving fleet, its
telemetry, the online loop and the multi-process training gang), with the same names,
types, defaults and help text (``knob_table_md`` renders each row as the
JAX package does). Every knob declares its name, type, default, owning
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
    "knob_table_md",
    "resolved",
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
    Knob("OTPU_MEM_BUDGET_MB", "float", 0.0, "resilience",
         "Host-RSS budget the brownout watermarks read against "
         "(0 = brownout inert unless a mem_pressure fault is injected)."),
    Knob("OTPU_MEM_WATERMARKS", "str", "0.75,0.88,0.96", "resilience",
         "Brownout ladder fractions: shrink chunk admission / force "
         "spill / degrade the HBM replay cache."),
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
    Knob("OTPU_WORKFLOW_SERVE", "flag", "1", "serve",
         "Whole-workflow fused serving kill-switch; 0 = a ServedWorkflow "
         "request walks its stages through the per-model serving path "
         "(K dispatches), bitwise the pre-workflow behavior."),
    Knob("OTPU_WORKFLOW_MAX_STAGES", "int", 64, "serve",
         "Stage-count ceiling for fusing a workflow DAG into one AOT "
         "executable; a DAG past it serves stage-by-stage (an XLA program "
         "over hundreds of stages compiles pathologically)."),
    # -------------------------------------------------------- parallel/
    Knob("OTPU_MULTIHOST", "flag", "1", "parallel",
         "Multi-process data/model-parallel training kill-switch; 0 = "
         "partitioners and sharded sources are inert facades over the "
         "current single-process path (bitwise)."),
    Knob("OTPU_MULTIHOST_PROCS", "int", 0, "parallel",
         "Training processes a MultihostLauncher gang spawns (and the "
         "bench's simulated-host count in fallback mode); 0 = auto "
         "(2 for the launcher, 4 for bench --config multihost)."),
    Knob("OTPU_MULTIHOST_COORD_PORT", "int", 0, "parallel",
         "torch.distributed TCPStore port the gang rendezvouses on; "
         "0 = a fresh FileStore file under the launcher's log dir per "
         "gang launch."),
    Knob("OTPU_MULTIHOST_RESTARTS", "int", 2, "parallel",
         "Gang restarts the launcher attempts after a lost host before "
         "raising HostLostError (each restart resumes every rank from "
         "the aligned epoch-boundary checkpoint)."),
    Knob("OTPU_MULTIHOST_WALL_S", "float", 600.0, "parallel",
         "Wall budget per gang attempt; a gang still running past it is "
         "treated as wedged and counts as a lost host (typed, not a "
         "hang — the watchdog pattern)."),
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
    Knob("OTPU_OBS_PORT", "int", None, "obs",
         "Bind the /metrics + /healthz telemetry server on this port when "
         "a ServingContext activates (0 = ephemeral port); unset = no "
         "server."),
    Knob("OTPU_OBS_STALE_S", "float", 60.0, "obs",
         "/healthz degrades to 503 when the liveness heartbeat is older "
         "than this many seconds."),
    Knob("OTPU_OBS_TRACE_CAP", "int", 65536, "obs",
         "Span ring-buffer capacity (oldest events overwrite past it)."),
    Knob("OTPU_TRACE_SAMPLE", "float", 1.0, "obs",
         "Fraction of fast-OK serve traces retained in the ring "
         "(deterministic per-trace-id coin); slow, shed and erroring "
         "traces are always kept whole (tail-biased retention)."),
    Knob("OTPU_TRACE_SLOW_MS", "float", 250.0, "obs",
         "Latency above which an unsampled serve trace is retained "
         "anyway (the tail the ring exists to explain)."),
    Knob("OTPU_PROF", "flag", "1", "obs",
         "Goodput & memory-attribution plane kill-switch; 0 restores the "
         "pre-prof behavior bitwise: no goodput accounting, no device-"
         "memory ledger ticks, deep capture refused (503)."),
    Knob("OTPU_PROF_DIR", "str", "/tmp/otpu_prof", "obs",
         "Directory on-demand deep-profile capture artifacts "
         "(capture-<ns>-<reason>/ dirs) are written to, atomically."),
    Knob("OTPU_PROF_RATE_S", "float", 60.0, "obs",
         "Min seconds between deep-profile captures (the /debug/profile "
         "endpoint answers 429 inside the window; captures are also "
         "serialized — one at a time, 409 while one runs)."),
    Knob("OTPU_PROF_MAX_MS", "float", 10000.0, "obs",
         "Ceiling on the duration_ms a /debug/profile capture may hold "
         "the jax profiler open (longer requests are clamped)."),
    Knob("OTPU_PROF_HYST", "float", 0.1, "obs",
         "Bottleneck-classifier hysteresis: a challenger stage must beat "
         "the incumbent's wall fraction by this margin before an epoch's "
         "classification flips (no flapping at the boundary)."),
    Knob("OTPU_FLIGHT", "flag", "1", "obs",
         "Anomaly flight-recorder kill-switch; 0 = typed anomalies write "
         "no bundles (OTPU_OBS=0 disables it too)."),
    Knob("OTPU_FLIGHT_DIR", "str", "/tmp/otpu_flight", "obs",
         "Directory automatic and manual flight bundles are written to."),
    Knob("OTPU_FLIGHT_MAX", "int", 16, "obs",
         "Max flight bundles kept in OTPU_FLIGHT_DIR (oldest deleted)."),
    Knob("OTPU_FLIGHT_RATE_S", "float", 60.0, "obs",
         "Min seconds between AUTOMATIC flight bundles (an anomaly storm "
         "must not become an IO storm); manual dumps are unlimited."),
    # ---------------------------------------------- fleet/, online/, SLOs
    Knob("OTPU_FLEET", "flag", "1", "fleet",
         "Serving-fleet kill-switch; 0 = FleetFrontend serves on the "
         "single-process path exactly (no replica subprocesses spawn, "
         "predict() is the raw in-process call)."),
    Knob("OTPU_FLEET_REPLICAS", "int", 4, "fleet",
         "Replica subprocesses a ReplicaManager/FleetFrontend spawns by "
         "default (bench.py --config fleet uses it for the N-replica "
         "scaling arm)."),
    Knob("OTPU_FLEET_PORT_BASE", "int", 0, "fleet",
         "First replica RPC port (replica i binds base+i); 0 = pick a "
         "free ephemeral port per replica."),
    Knob("OTPU_FLEET_HEDGE_MS", "float", 30.0, "fleet",
         "Floor on the router's tail-hedging delay: a second copy of an "
         "idempotent predict is issued to a different replica once the "
         "primary has been outstanding this long (raised by the "
         "EWMA-p95 estimate; 0 keeps the pure percentile schedule)."),
    Knob("OTPU_FLEET_HEDGE_PCTL", "float", 95.0, "fleet",
         "Latency percentile the hedge delay derives from (EWMA "
         "mean + z(pctl) * EWMA stddev of observed request latency)."),
    Knob("OTPU_FLEET_TIMEOUT_S", "float", 30.0, "fleet",
         "Default per-request connect/read deadline on the fleet RPC "
         "client (an explicit deadline or request_deadline() scope "
         "outranks it)."),
    Knob("OTPU_DRAIN_S", "float", 5.0, "fleet",
         "Graceful-drain budget: a draining replica (SIGTERM or POST "
         "/drain) finishes in-flight requests up to this many seconds "
         "before exiting."),
    Knob("OTPU_ROLLOUT_CANARY", "int", 4, "fleet",
         "Canary predicts the rollout sends through each freshly-flipped "
         "replica; a failure trips the rollout breaker and rolls the "
         "fleet back to the previous version."),
    Knob("OTPU_ROLLOUT_TIMEOUT_S", "float", 60.0, "fleet",
         "Per-replica budget for one rollout step (reload + warm + "
         "readiness re-poll) before the rollout aborts and rolls back."),
    Knob("OTPU_FLEET_FASTWIRE", "flag", "1", "fleet",
         "Fleet data-plane fast-path kill-switch; 0 = the wire "
         "bitwise (one fresh TCP connection + npy body per request, no "
         "pooling, no SHM, no cross-caller coalescing)."),
    Knob("OTPU_FLEET_POOL_CONNS", "int", 8, "fleet",
         "Idle keep-alive connections a FleetClient pool retains per "
         "replica (excess connections close on release)."),
    Knob("OTPU_FLEET_SHM", "flag", "1", "fleet",
         "Shared-memory zero-copy tensor wire for loopback replicas; "
         "0 = arrays always ride the npy HTTP body (any SHM failure "
         "also falls back there, typed, per request)."),
    Knob("OTPU_FLEET_SHM_MIN_BYTES", "int", 1 << 22, "fleet",
         "Payload floor for the SHM wire: arrays smaller than this ride "
         "the npy body even with OTPU_FLEET_SHM=1 — below ~4 MiB the "
         "segment create/map/unlink syscalls cost more than the socket "
         "copies they avoid (0 = always use SHM, the parity-test "
         "setting)."),
    Knob("OTPU_FLEET_UDS", "flag", "0", "fleet",
         "Unix-domain-socket RPC transport for loopback replicas; the "
         "replica binds a 0600 socket under the fleet run dir next to "
         "its TCP port and the client prefers it when the socket file "
         "exists."),
    Knob("OTPU_FLEET_RUN_DIR", "str", "", "fleet",
         "Directory holding per-fleet runtime state (UDS socket files); "
         "empty = otpu-fleet-<uid> under the system temp dir, created "
         "0700."),
    Knob("OTPU_FLEET_COALESCE", "flag", "1", "fleet",
         "Router-side cross-caller coalescing: concurrent same-shape "
         "predicts from different callers merge into one wire dispatch "
         "before replica selection; 0 = every caller dispatches alone."),
    Knob("OTPU_FLEET_COALESCE_WAIT_MS", "float", 0.0, "fleet",
         "Extra bounded wait a coalescer leader lingers to accumulate "
         "more members before dispatching (0 = merge only what is "
         "already queued)."),
    Knob("OTPU_FLEET_COALESCE_ROWS", "int", 4096, "fleet",
         "Row cap on one coalesced wire dispatch (ladder-clamped merge "
         "size: matches the default serving-ladder max bucket)."),
    Knob("OTPU_AUTOSCALE", "flag", "1", "fleet",
         "Digest-driven elastic autoscaling kill-switch; 0 = no "
         "Autoscaler ever scales (the fixed-size fleet, bitwise)."),
    Knob("OTPU_AUTOSCALE_MIN", "int", 1, "fleet",
         "Replica floor the autoscaler never drains below."),
    Knob("OTPU_AUTOSCALE_MAX", "int", 8, "fleet",
         "Replica ceiling the autoscaler never grows past."),
    Knob("OTPU_AUTOSCALE_UP_X", "float", 2.0, "fleet",
         "Scale-up hysteresis band: grow one replica when per-replica "
         "load pressure (queue depth + in-flight per up replica, plus "
         "any shed delta or brownout) is at or above this."),
    Knob("OTPU_AUTOSCALE_DOWN_X", "float", 0.5, "fleet",
         "Scale-down hysteresis band: drain one replica when per-replica "
         "load pressure is at or below this with no sheds in the "
         "window (the bands never overlap: DOWN_X < UP_X enforced)."),
    Knob("OTPU_AUTOSCALE_COOLDOWN_S", "float", 10.0, "fleet",
         "Minimum seconds between scale decisions (deterministic on the "
         "injected clock — no wall-clock randomness)."),
    Knob("OTPU_FLEET_INPROC", "int", 0, "fleet",
         "In-process multi-device replica mode: N > 0 serves through N "
         "device-pinned lanes in THIS process (no sockets, no "
         "serialization) behind the same router/breaker/hedge paths; "
         "0 = subprocess replicas."),
    Knob("OTPU_ONLINE_PUBLISH_S", "float", 30.0, "online",
         "Guarded-promotion cadence: seconds between publish cycles of "
         "the online loop's background publisher thread."),
    Knob("OTPU_ONLINE_JOIN_WINDOW", "int", 4096, "online",
         "Label-join window: unlabeled requests held for their label "
         "before eviction (a label arriving later counts as 'late')."),
    Knob("OTPU_ONLINE_CHUNK_ROWS", "int", 1024, "online",
         "Joined examples per incremental-trainer device step."),
    Knob("OTPU_ONLINE_MIN_EXAMPLES", "int", 512, "online",
         "Joined examples the trainer must consume before a candidate "
         "may enter the promotion gate ladder."),
    Knob("OTPU_ONLINE_DRIFT_Z", "float", 6.0, "online",
         "Drift gate: max normalized per-feature mean shift (z-score) of "
         "recent tapped traffic vs the serving model's training stats."),
    Knob("OTPU_ONLINE_HOLDOUT_DROP", "float", 0.02, "online",
         "Drift gate: max holdout-metric regression (AUC, falling back "
         "to accuracy) the candidate may show vs the serving model."),
    Knob("OTPU_ONLINE_SHADOW_SAMPLE", "float", 0.25, "online",
         "Shadow gate: fraction of logged request chunks the candidate "
         "re-scores (deterministic per-ordinal coin)."),
    Knob("OTPU_ONLINE_SHADOW_DISAGREE", "float", 0.25, "online",
         "Shadow gate: max fraction of shadow-scored rows whose "
         "predicted class disagrees with the serving model."),
    Knob("OTPU_ONLINE_CKPT_STEPS", "int", 8, "online",
         "Trainer steps per epoch-boundary checkpoint (a SIGKILL'd "
         "trainer resumes from the last one without re-reading the "
         "consumed log prefix)."),
    Knob("OTPU_FLEETOBS", "flag", "1", "obs",
         "Fleet telemetry-plane kill-switch; 0 restores the plain "
         "fleet exactly (no collector scrapes, no router serve spans, no "
         "SLO samples, no fleet bundles)."),
    Knob("OTPU_FLEETOBS_SCRAPE_S", "float", 2.0, "obs",
         "FleetCollector scrape cadence: seconds between /metrics pulls "
         "from each replica (deterministically jittered ±10% so fleet "
         "scrapes decorrelate)."),
    Knob("OTPU_FLEETOBS_STALE_X", "float", 3.0, "obs",
         "Staleness multiplier: a replica whose last successful scrape is "
         "older than STALE_X * SCRAPE_S gets its fleet series stale-"
         "flagged instead of silently frozen."),
    Knob("OTPU_SLO_SPEC", "str",
         "availability:target=99.0;latency:target=99.0,p99_ms=1000", "obs",
         "Declarative SLO specs, ';'-separated name:key=val,... items; "
         "target= is the good-request percent, p99_ms= makes it a "
         "latency SLO (a request slower than the bound burns budget)."),
    Knob("OTPU_SLO_WINDOW_FAST_S", "float", 60.0, "obs",
         "Fast (paging) burn-rate window in seconds; the confirming "
         "short window is 1/12 of it (SRE-workbook multi-window rule)."),
    Knob("OTPU_SLO_WINDOW_SLOW_S", "float", 600.0, "obs",
         "Slow (ticket) burn-rate window in seconds; the confirming "
         "short window is 1/12 of it."),
    Knob("OTPU_SLO_BURN_FAST", "float", 14.4, "obs",
         "Burn-rate threshold for the fast rule: alert when the error "
         "budget burns this many times faster than uniform in BOTH the "
         "fast window and its short confirm window."),
    Knob("OTPU_SLO_BURN_SLOW", "float", 6.0, "obs",
         "Burn-rate threshold for the slow rule (same two-window shape "
         "over the slow window)."),
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


def resolved() -> dict:
    """Every knob's current resolved value (typed getters, so malformed
    env values show as their declared defaults — what the code acts on).
    The flight recorder embeds this table in every bundle."""
    getters = {"flag": get_bool, "int": get_int, "float": get_float,
               "str": get_str}
    return {k.name: getters[k.type](k.name) for k in KNOBS.values()}


def knob_table_md() -> str:
    """The markdown knob-reference table, in the JAX package's rendering
    (one row a knob, sorted by subsystem then name)."""
    lines = [
        "| knob | type | default | subsystem | effect |",
        "|---|---|---|---|---|",
    ]
    for k in sorted(KNOBS.values(), key=lambda k: (k.subsystem, k.name)):
        default = "–" if k.default is None else str(k.default)
        lines.append(
            f"| `{k.name}` | {k.type} | `{default}` | {k.subsystem} "
            f"| {k.doc} |")
    return "\n".join(lines) + "\n"
