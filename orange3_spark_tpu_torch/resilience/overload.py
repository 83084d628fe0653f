"""Overload protection & graceful degradation.

A copy of the JAX package's ``resilience/overload.py``. The process-wide
dispatch breaker (``wedge_breaker``) guards the dispatch watchdog
(resilience/watchdog.py); the first shed of an overload spell writes a
flight bundle (obs/flight.py).

The paper's Spark substrate survives overload by elastic cluster
scheduling — a swamped executor just makes the stage slower. A
single-process accelerator runtime has no scheduler to lean on: unbounded queues
turn a traffic spike into unbounded p99, a process-lifetime blacklist is
the only serving failure ladder, and an over-budget fit dies on OOM.

This module is the missing control plane, four pieces:

* **AdmissionController** — bounded in-flight serving work with optional
  per-request deadline budgets. A request whose PROJECTED queue wait
  (queue depth x EWMA service time / parallelism) exceeds its deadline is
  shed *immediately* with a typed :class:`OverloadShedError` carrying the
  queue depth and wait estimate — never parked behind a queue it cannot
  clear. Deadlines resolve explicit arg > :func:`request_deadline`
  thread-local > ``OTPU_ADMISSION_DEADLINE_S`` (0 = none).
* **CircuitBreaker** — closed -> open -> half-open with a seeded probe
  cadence. Replaces the serving ``_unservable`` first-failure
  process-lifetime blacklist: a transient bad spell stops costing work (open = fast-fail),
  but a recovered backend is re-admitted automatically (half-open probe
  succeeds -> closed). Under ``OTPU_RESILIENCE=0`` the breaker IS the
  legacy latch: the first failure opens it and it never half-opens.
* **AdaptiveCoalescer** — the micro-batcher's wait/merge dial: sustained
  queue depth grows ``max_wait_ms`` and the merge target (never past the
  bucket ladder's top rung / ``OTPU_MB_MAX_WAIT_MS``), an idle queue
  shrinks both back to their configured base.
* **BrownoutMonitor** (:func:`brownout_level`) — memory-pressure
  watermarks over host RSS (``OTPU_MEM_BUDGET_MB``) and the injected
  ``mem_pressure`` fault fraction. The level feeds the ``_DeviceCache``
  brownout ladder during fits: 1 = shrink chunk admission (half the HBM
  budget), 2 = stop admitting (force the disk spill / re-stream path),
  3 = degrade the HBM replay cache entirely — a typed, measured degrade
  instead of an opaque OOM.

Everything is deterministic-testable through the ``overload`` and
``mem_pressure`` fault injectors (resilience/faults.py) and inert under
the ``OTPU_RESILIENCE=0`` kill-switch (legacy unbounded queues, the
first-failure latch, fixed micro-batch wait, no brownout). Breaker
state, queue depth, shed counts and the brownout level all export
through the obs registry (``otpu_shed_total{reason=}``,
``otpu_breaker_state{name=}``, ``otpu_admission_inflight``,
``otpu_brownout_level``) and ``/healthz`` reports the brownout level.
"""

from __future__ import annotations

import logging
import math
import threading
import time
import zlib
from contextlib import contextmanager

from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.resilience.faults import (
    active_fault_spec,
    resilience_enabled,
)

__all__ = [
    "AdaptiveCoalescer",
    "AdmissionController",
    "CircuitBreaker",
    "OverloadShedError",
    "brownout_level",
    "current_brownout_level",
    "host_rss_bytes",
    "maybe_injected_service_delay",
    "memory_pressure_fraction",
    "request_deadline",
    "reset_wedge_breaker",
    "shed_total",
    "wedge_breaker",
]

log = logging.getLogger("orange3_spark_tpu_torch")

_M_SHED = REGISTRY.counter(
    "otpu_shed_total",
    "requests shed by admission control, by reason")
_M_INFLIGHT = REGISTRY.gauge(
    "otpu_admission_inflight",
    "serving dispatches currently holding an admission slot")
_M_QUEUE_DEPTH = REGISTRY.gauge(
    "otpu_admission_queue_depth",
    "callers waiting on an admission slot")
_M_BREAKER_STATE = REGISTRY.gauge(
    "otpu_breaker_state",
    "circuit-breaker state by name (0=closed, 1=half-open, 2=open)")
_M_MB_ADAPT = REGISTRY.gauge(
    "otpu_mb_adapt_factor",
    "adaptive micro-batch wait/merge growth factor (1.0 = base)")
_M_BROWNOUT = REGISTRY.gauge(
    "otpu_brownout_level",
    "memory-pressure brownout level (0=normal, 1=shrink chunk admission, "
    "2=force spill, 3=degrade HBM replay cache)")


# --------------------------------------------------------------- shedding
class OverloadShedError(RuntimeError):
    """A serving request was shed by admission control instead of being
    queued past its deadline (or past the hard queue bound). Carries the
    live evidence — ``queue_depth``, ``inflight``, ``est_wait_s``,
    ``deadline_s``, the request's ``trace_id`` (obs/context.py) and a
    ``diagnostics`` dict (breaker states when the owning context provides
    them) — so a shed in production logs is self-explaining."""

    def __init__(self, *, reason: str, queue_depth: int, inflight: int,
                 est_wait_s: float, deadline_s: float | None,
                 diagnostics: dict | None = None,
                 trace_id: str | None = None):
        self.reason = reason
        self.queue_depth = queue_depth
        self.inflight = inflight
        self.est_wait_s = est_wait_s
        self.deadline_s = deadline_s
        self.diagnostics = diagnostics or {}
        self.trace_id = trace_id
        dl = (f"{deadline_s:.3g}s deadline" if deadline_s is not None
              else "no deadline")
        extra = (f"; {self.diagnostics}" if self.diagnostics else "")
        if trace_id:
            extra = f" [trace {trace_id}]" + extra
        super().__init__(
            f"request shed ({reason}): projected queue wait "
            f"{est_wait_s:.3g}s vs {dl} at queue depth {queue_depth} "
            f"with {inflight} in flight{extra}. Raise "
            "OTPU_ADMISSION_MAX_INFLIGHT / the request deadline to admit "
            "more, or OTPU_RESILIENCE=0 to restore legacy unbounded "
            "queueing."
        )


def _record_shed(reason: str) -> None:
    _M_SHED.inc(1, reason=reason)
    from orange3_spark_tpu_torch.obs import trace as _trace

    _trace.instant("shed", reason=reason)


def shed_total() -> int:
    """Total requests shed by admission control (all reasons)."""
    return int(_M_SHED.total())


# per-thread request deadline budget (the caller-facing knob an endpoint
# wrapper sets around its predicts); explicit args and this both outrank
# the OTPU_ADMISSION_DEADLINE_S process default
_TLS = threading.local()


@contextmanager
def request_deadline(seconds: float | None):
    """Scope a per-request deadline budget over a block of serve calls::

        with request_deadline(0.050):
            model.predict(batch)    # shed if projected wait > 50 ms

    ``None`` restores "no per-request deadline" inside an outer scope."""
    prev = getattr(_TLS, "deadline_s", None)
    _TLS.deadline_s = seconds
    try:
        yield
    finally:
        _TLS.deadline_s = prev


def _ambient_deadline_s() -> float | None:
    d = getattr(_TLS, "deadline_s", None)
    if d is not None:
        return float(d)
    from orange3_spark_tpu_torch.utils import knobs

    d = float(knobs.get_float("OTPU_ADMISSION_DEADLINE_S"))
    return d if d > 0 else None


# ---------------------------------------------------- admission control
class AdmissionController:
    """Bounded in-flight serving work + projected-wait shedding.

    ``slot()`` brackets one device dispatch: at most ``max_inflight``
    callers hold a slot; a caller that would wait past its deadline (or
    that finds ``max_queue`` callers already waiting) is shed with a
    typed :class:`OverloadShedError` instead of queueing. ``check_queue``
    is the slotless variant the micro-batcher's ``submit`` uses against
    its own queue depth. Service time is an EWMA fed by every released
    slot (``observe_service``), seeded/floored by
    ``OTPU_ADMISSION_SERVICE_MS`` so the first burst after a cold start
    is not admitted on a zero estimate. A no-op (legacy unbounded) under
    ``OTPU_RESILIENCE=0`` or ``max_inflight <= 0``."""

    def __init__(self, *, max_inflight: int | None = None,
                 max_queue: int | None = None,
                 clock=time.monotonic):
        from orange3_spark_tpu_torch.utils import knobs

        self.max_inflight = int(
            max_inflight if max_inflight is not None
            else knobs.get_int("OTPU_ADMISSION_MAX_INFLIGHT"))
        self.max_queue = int(
            max_queue if max_queue is not None
            else knobs.get_int("OTPU_ADMISSION_MAX_QUEUE"))
        self._clock = clock
        self._cv = threading.Condition()
        self._inflight = 0
        self._waiters = 0
        self._ewma_s = 0.0
        # the owning context may attach a richer diagnostics provider
        # (breaker states) that shed errors carry
        self.diagnostics_hook = None
        # weighted-fair tenancy state (serve/tenancy.py), built lazily on
        # the first tenant-scoped acquire; None = anonymous single-tenant
        # admission, bitwise the pre-tenancy behavior
        self._fair_share = None

    # ------------------------------------------------------------ state
    def enabled(self) -> bool:
        return resilience_enabled() and self.max_inflight > 0

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def queue_depth(self) -> int:
        return self._waiters

    def observe_service(self, dt_s: float) -> None:
        """Fold one completed dispatch's wall seconds into the EWMA."""
        with self._cv:
            self._ewma_s = (dt_s if self._ewma_s == 0.0
                            else 0.8 * self._ewma_s + 0.2 * dt_s)

    def service_estimate_s(self) -> float:
        from orange3_spark_tpu_torch.utils import knobs

        floor = float(knobs.get_float("OTPU_ADMISSION_SERVICE_MS")) / 1e3
        return max(self._ewma_s, floor)

    def estimate_wait_s(self, queue_depth: int,
                        parallelism: int | None = None) -> float:
        """Projected wait for a request arriving behind ``queue_depth``
        others: depth x EWMA service / parallelism (default: the
        in-flight bound; the single-worker micro-batcher passes 1). An
        estimate for shedding decisions, not a promise."""
        par = parallelism if parallelism is not None else self.max_inflight
        return queue_depth * self.service_estimate_s() / max(par, 1)

    def _diag(self) -> dict:
        hook = self.diagnostics_hook
        if hook is None:
            return {}
        try:
            return dict(hook())
        except Exception:  # noqa: BLE001 - diagnostics must never mask
            return {}

    def _shed(self, reason: str, queue_depth: int, est: float,
              deadline_s: float | None):
        from orange3_spark_tpu_torch.obs.context import (
            current_trace_id, flag_current_trace,
        )

        _record_shed(reason)
        # tail retention keeps the shed trace whole in the ring. The
        # flight-recorder dump happens at the PUBLIC entry points
        # (_dump_shed), outside the admission condition variable —
        # slot() sheds from inside `with self._cv:`, and a bundle write
        # (stacks + registry + disk IO) under that lock would stall
        # every other caller at exactly the moment of peak overload.
        flag_current_trace()
        raise OverloadShedError(
            reason=reason, queue_depth=queue_depth, inflight=self._inflight,
            est_wait_s=est, deadline_s=deadline_s, diagnostics=self._diag(),
            trace_id=current_trace_id())

    def _shed_tenant(self, tenant: str, reason: str, usage: float,
                     quota: float, d: float | None):
        """Typed per-tenant quota shed (cv held — same discipline as
        ``_shed``: the flight dump happens outside, in ``slot``)."""
        from orange3_spark_tpu_torch.obs.context import (
            current_trace_id, flag_current_trace,
        )
        from orange3_spark_tpu_torch.serve.tenancy import (
            TenantQuotaShedError, _record_tenant_shed,
        )

        _record_shed(reason)
        _record_tenant_shed(tenant, reason)
        flag_current_trace()
        raise TenantQuotaShedError(
            tenant=tenant, reason=reason, usage=usage, quota=quota,
            queue_depth=self._waiters, inflight=self._inflight,
            est_wait_s=self.estimate_wait_s(self._waiters),
            deadline_s=d, diagnostics=self._diag(),
            trace_id=current_trace_id())

    def _fair(self):
        """The weighted-fair tenancy state, (re)built when the
        ``OTPU_TENANT_SPEC`` arm changes (bench A/B flips it live).
        Callers hold the returned object for one acquire/release pair so
        a mid-flight rebuild never mismatches grant and release."""
        from orange3_spark_tpu_torch.serve.tenancy import TenantFairShare
        from orange3_spark_tpu_torch.utils import knobs

        raw = knobs.get_str("OTPU_TENANT_SPEC")
        fair = self._fair_share
        if fair is None or fair.spec_raw != raw:
            fair = TenantFairShare(clock=self._clock)
            self._fair_share = fair
        return fair

    def tenancy_snapshot(self) -> dict:
        """Live per-tenant fairness table ({} until a tenant-scoped
        request arrives) — the /fleetz and fleet_top surface."""
        fair = self._fair_share
        return fair.snapshot() if fair is not None else {}

    @staticmethod
    def _dump_shed(err: "OverloadShedError") -> None:
        """Black box (obs/flight.py): the first shed of an overload spell
        freezes queue depths/breakers/stacks; the rate limit keeps a shed
        storm from becoming an IO storm. Called with NO locks held."""
        from orange3_spark_tpu_torch.obs.flight import auto_dump

        auto_dump("overload_shed", err)

    # ------------------------------------------------------- entrypoints
    def check_queue(self, queue_depth: int,
                    deadline_s: float | None = None,
                    parallelism: int = 1) -> None:
        """Slotless admission check against an EXTERNAL queue (the
        micro-batcher's — drained by ONE worker, hence the default
        parallelism of 1): sheds when the projected wait exceeds the
        request's deadline, or when the queue itself is past
        ``max_queue``. No-op when disabled or no deadline applies (the
        queue's own bound then sheds to direct dispatch, legacy-style —
        deadline-free callers must see no new exception type)."""
        if not self.enabled():
            return
        d = deadline_s if deadline_s is not None else _ambient_deadline_s()
        if d is None or math.isinf(d):
            return
        try:
            if queue_depth >= self.max_queue:
                self._shed("queue_full", queue_depth,
                           self.estimate_wait_s(queue_depth, parallelism), d)
            est = self.estimate_wait_s(queue_depth, parallelism)
            if est > d:
                self._shed("projected_wait", queue_depth, est, d)
        except OverloadShedError as e:
            self._dump_shed(e)
            raise

    @contextmanager
    def slot(self, deadline_s: float | None = None):
        """Hold one in-flight slot around a device dispatch. Sheds
        immediately on a hopeless projected wait, sheds on deadline
        expiry while waiting, and NEVER leaves a caller parked forever
        when a deadline applies."""
        if not self.enabled():
            yield
            return
        from orange3_spark_tpu_torch.serve.tenancy import (
            current_tenant, tenancy_enabled,
        )

        tenant = current_tenant() if tenancy_enabled() else None
        fair = self._fair() if tenant is not None else None
        d = deadline_s if deadline_s is not None else _ambient_deadline_s()
        if d is None and fair is not None:
            # the tenant's declared default deadline applies only when
            # neither the call nor the ambient scope set one
            d = fair.tenant_deadline_s(tenant)
        if d is not None and math.isinf(d):
            d = None    # request_deadline(inf): admitted work (the mb
            #             worker) waits for a slot but is never shed
        try:
            self._acquire(d, tenant=tenant, fair=fair)
        except OverloadShedError as e:
            # the raise already released self._cv — the flight dump's
            # stack/registry/disk work must never run under it
            self._dump_shed(e)
            raise
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe_service(time.perf_counter() - t0)
            with self._cv:
                self._inflight -= 1
                _M_INFLIGHT.set(self._inflight)
                if self._fair_share is not None:
                    # tenant-gated waiters sit behind a DRR grant check:
                    # a single notify could wake a waiter the DRR head
                    # is NOT, which re-waits and swallows the wakeup —
                    # wake everyone and let may_grant() pick
                    if fair is not None:
                        fair.release(tenant)
                    self._cv.notify_all()
                else:
                    self._cv.notify()

    def _acquire(self, d: float | None, *, tenant: str | None = None,
                 fair=None) -> None:
        with self._cv:
            if fair is not None:
                quota = fair.try_admit(
                    tenant, max_inflight=self.max_inflight,
                    max_queue=self.max_queue)
                if quota is not None:
                    reason, usage, cap = quota
                    self._shed_tenant(tenant, reason, usage, cap, d)
            depth = self._waiters
            backlog = depth + max(self._inflight - self.max_inflight + 1, 0)
            # both sheds apply only to deadline-carrying requests — a
            # deadline-free legacy caller (and the mb worker flushing
            # ALREADY-admitted requests) must never see a new exception
            # type; it waits, bounded by the slot holders' progress
            if d is not None and depth >= self.max_queue:
                self._shed("queue_full", depth,
                           self.estimate_wait_s(depth), d)
            if d is not None and self._inflight >= self.max_inflight:
                est = self.estimate_wait_s(backlog)
                if est > d:
                    self._shed("projected_wait", depth, est, d)
            self._waiters += 1
            _M_QUEUE_DEPTH.set(self._waiters)
            if fair is not None:
                fair.note_waiting(tenant, +1)
            t_deadline = (self._clock() + d) if d is not None else None
            try:
                # the DRR gate only runs when a slot is actually free
                # (`or` short-circuits) and only against WAITING tenants,
                # so some waiter always passes — no gate deadlock
                while (self._inflight >= self.max_inflight
                       or (fair is not None
                           and not fair.may_grant(tenant))):
                    remaining = (t_deadline - self._clock()
                                 if t_deadline is not None else None)
                    if remaining is not None and remaining <= 0:
                        # we may have CONSUMED a release's single
                        # notify() to get here — pass it on, or another
                        # waiter (e.g. the deadline-free mb worker)
                        # sleeps forever on a slot that is actually free
                        if self._fair_share is not None:
                            self._cv.notify_all()
                        else:
                            self._cv.notify()
                        self._shed("deadline", self._waiters - 1,
                                   self.estimate_wait_s(self._waiters), d)
                    self._cv.wait(timeout=remaining)
            finally:
                self._waiters -= 1
                _M_QUEUE_DEPTH.set(self._waiters)
                if fair is not None:
                    fair.note_waiting(tenant, -1)
            self._inflight += 1
            _M_INFLIGHT.set(self._inflight)
            if fair is not None:
                fair.granted(tenant)


# ----------------------------------------------------- circuit breaker
_BREAKER_STATES = {"closed": 0, "half-open": 1, "open": 2}


class CircuitBreaker:
    """closed -> open -> half-open failure gate with a seeded probe
    cadence (docs/resilience.md).

    ``allow()`` answers "may this attempt proceed?": closed = yes;
    open = no until the cooldown elapses, at which point ONE probe is
    admitted (half-open); a probe success (``record_success``) after
    ``probe_successes`` closes the breaker, a probe failure re-opens it
    with the next cooldown. The cooldown carries deterministic seeded
    jitter (crc32 of (seed, open count) — the retry-policy convention)
    so fleet probes decorrelate while tests stay exactly pinnable.

    Under ``OTPU_RESILIENCE=0`` (read per call) the breaker reproduces
    the legacy first-failure process-lifetime latch: one failure opens
    it and ``allow()`` never half-opens."""

    def __init__(self, name: str = "", *,
                 failure_threshold: int | None = None,
                 cooldown_s: float | None = None,
                 probe_successes: int | None = None,
                 jitter: float = 0.25, seed: int = 0,
                 clock=time.monotonic):
        from orange3_spark_tpu_torch.utils import knobs

        self.name = name
        self.failure_threshold = int(
            failure_threshold if failure_threshold is not None
            else knobs.get_int("OTPU_BREAKER_THRESHOLD"))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else knobs.get_float("OTPU_BREAKER_COOLDOWN_S"))
        self.probe_successes = int(
            probe_successes if probe_successes is not None
            else knobs.get_int("OTPU_BREAKER_PROBES"))
        self.jitter = jitter
        self.seed = seed
        self.clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consec_failures = 0
        self._opened_at = 0.0
        self._open_count = 0
        self._probe_inflight = False
        self._probe_started_at = 0.0
        self._probe_ok = 0

    # ----------------------------------------------------------- plumbing
    def _set_state(self, state: str) -> None:
        self._state = state
        if self.name:
            _M_BREAKER_STATE.set(_BREAKER_STATES[state], name=self.name)

    def _current_cooldown_s(self) -> float:
        d = self.cooldown_s
        if self.jitter > 0:
            u = zlib.crc32(
                f"{self.seed}:{self._open_count}".encode()) / 0xFFFFFFFF
            d *= 1.0 + self.jitter * u
        return d

    def state(self) -> str:
        """'closed' | 'open' | 'half-open' (open reads as half-open once
        its cooldown has elapsed and a probe could be admitted)."""
        with self._lock:
            if (self._state == "open" and resilience_enabled()
                    and self.clock() - self._opened_at
                    >= self._current_cooldown_s()):
                return "half-open"
            return self._state

    # --------------------------------------------------------- the gate
    def allow(self) -> bool:
        with self._lock:
            if self._state == "closed":
                return True
            if not resilience_enabled():
                return False            # legacy latch: never re-admit
            if self._state == "open":
                if (self.clock() - self._opened_at
                        < self._current_cooldown_s()):
                    return False
                self._set_state("half-open")
                self._probe_inflight = True
                self._probe_started_at = self.clock()
                self._probe_ok = 0
                return True
            # half-open: one probe at a time — but a probe whose attempt
            # aborted before reaching record_success/record_failure (a
            # shed mid-path, a dead worker) must not wedge the breaker
            # half-open forever, so a stale probe's claim expires after
            # one cooldown and the next caller takes it over
            if (self._probe_inflight
                    and self.clock() - self._probe_started_at
                    < self._current_cooldown_s()):
                return False
            self._probe_inflight = True
            self._probe_started_at = self.clock()
            return True

    def record_success(self) -> None:
        with self._lock:
            if self._state == "half-open":
                self._probe_inflight = False
                self._probe_ok += 1
                if self._probe_ok >= self.probe_successes:
                    self._set_state("closed")
                    self._consec_failures = 0
            elif self._state == "closed":
                self._consec_failures = 0

    def record_failure(self) -> None:
        with self._lock:
            now = self.clock()
            if not resilience_enabled():
                # legacy: first failure latches for the process lifetime
                self._set_state("open")
                self._opened_at = now
                return
            if self._state == "half-open":
                self._probe_inflight = False
                self._open_count += 1
                self._set_state("open")
                self._opened_at = now
                return
            self._consec_failures += 1
            if (self._state == "closed"
                    and self._consec_failures >= self.failure_threshold):
                self._open_count += 1
                self._set_state("open")
                self._opened_at = now


# process-wide breaker guarding repeated DispatchWedgedErrors: once a
# budgeted sync wedges, later guarded syncs fast-fail (typed, ~0 s)
# instead of each burning the full watchdog budget, until a half-open
# probe sync completes and re-admits the backend
_wedge_breaker: CircuitBreaker | None = None
_wedge_lock = threading.Lock()


def wedge_breaker() -> CircuitBreaker:
    global _wedge_breaker
    if _wedge_breaker is None:
        with _wedge_lock:
            if _wedge_breaker is None:
                _wedge_breaker = CircuitBreaker("dispatch")
    return _wedge_breaker


def reset_wedge_breaker() -> None:
    """Drop the process-wide dispatch breaker (tests / post-mortem)."""
    global _wedge_breaker
    with _wedge_lock:
        _wedge_breaker = None


# ------------------------------------------------- adaptive coalescing
class AdaptiveCoalescer:
    """The micro-batcher's load-adaptive wait/merge dial.

    One growth factor drives both knobs: sustained queue depth
    (``update(depth)`` with depth >= ``high_depth`` after a flush)
    doubles it, an empty queue halves it back toward 1.0. The effective
    wait is ``base_wait * factor`` capped at ``OTPU_MB_MAX_WAIT_MS``;
    the effective merge target is ``base_batch * factor`` capped at the
    bucket ladder's top rung (``batch_cap``) — adaptivity can never
    merge past a shape the ladder compiles. Fixed base values under
    ``OTPU_RESILIENCE=0`` / ``OTPU_MB_ADAPT=0`` (read per call)."""

    def __init__(self, base_wait_s: float, base_batch: int,
                 batch_cap: int | None = None, *, high_depth: int = 4,
                 growth: float = 2.0, max_wait_s: float | None = None):
        from orange3_spark_tpu_torch.utils import knobs

        self.base_wait_s = base_wait_s
        self.base_batch = base_batch
        self.batch_cap = int(batch_cap if batch_cap is not None
                             else base_batch)
        self.high_depth = high_depth
        self.growth = growth
        cap = (max_wait_s if max_wait_s is not None
               else float(knobs.get_float("OTPU_MB_MAX_WAIT_MS")) / 1e3)
        self.max_wait_s = max(cap, base_wait_s)
        self._max_factor = (self.max_wait_s / base_wait_s
                            if base_wait_s > 0 else 1.0)
        self._factor = 1.0

    def enabled(self) -> bool:
        from orange3_spark_tpu_torch.utils import knobs

        return resilience_enabled() and knobs.get_bool("OTPU_MB_ADAPT")

    @property
    def factor(self) -> float:
        return self._factor

    def current_wait_s(self) -> float:
        if not self.enabled():
            return self.base_wait_s
        return min(self.base_wait_s * self._factor, self.max_wait_s)

    def current_batch(self) -> int:
        if not self.enabled():
            return self.base_batch
        return min(int(self.base_batch * self._factor), self.batch_cap)

    def update(self, queue_depth: int) -> None:
        """Post-flush feedback: the queue depth the flush left behind."""
        if not self.enabled():
            return
        if queue_depth >= self.high_depth:
            self._factor = min(self._factor * self.growth, self._max_factor)
        elif queue_depth == 0:
            self._factor = max(self._factor / self.growth, 1.0)
        _M_MB_ADAPT.set(self._factor)


# ------------------------------------------------ injected service load
def maybe_injected_service_delay() -> None:
    """The ``overload`` fault injector's consumption point: serving
    dispatch paths call this so an injected per-dispatch service delay
    builds a deterministic queue for admission-control tests/bench.
    Injection is live regardless of the kill-switch (the resilience
    convention: injectors drive the tests, mitigations ride the
    switch)."""
    spec = active_fault_spec()
    if spec is None:
        return
    d = spec.take_overload_delay()
    if d:
        time.sleep(d)


# ------------------------------------------------- memory-pressure brownout
def host_rss_bytes() -> int:
    """This process's resident set size. /proc on linux; the ru_maxrss
    high-water mark elsewhere (conservative: brownout then considers the
    worst the process has been, which is the safe direction)."""
    try:
        with open("/proc/self/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # noqa: BLE001 - no RSS source on this platform
        return 0


def _watermarks() -> tuple[float, float, float]:
    from orange3_spark_tpu_torch.utils import knobs

    raw = knobs.get_str("OTPU_MEM_WATERMARKS")
    try:
        parts = [float(p) for p in raw.split(",")]
        if len(parts) == 3 and 0 < parts[0] <= parts[1] <= parts[2]:
            return parts[0], parts[1], parts[2]
    except ValueError:
        pass
    return 0.75, 0.88, 0.96


_BROWNOUT_ACTIONS = {
    1: "shrinking HBM chunk admission to half budget",
    2: "forcing new chunks to the spill/stream path",
    3: "degrading the HBM replay cache",
}
_last_brownout_level = 0
_brownout_lock = threading.Lock()


def memory_pressure_fraction(consume: bool = True) -> float | None:
    """Current memory-pressure fraction: the injected ``mem_pressure``
    fault fraction when one is active, else host RSS over the
    ``OTPU_MEM_BUDGET_MB`` budget. None = no pressure source configured
    (watermarks inert — the common case costs two cheap checks).
    ``consume=False`` = a side observer (/healthz): never advances the
    injector's ``after=`` budget."""
    spec = active_fault_spec()
    if spec is not None:
        frac = spec.mem_pressure_frac(consume=consume)
        if frac is not None:
            return frac
    from orange3_spark_tpu_torch.utils import knobs

    budget_mb = float(knobs.get_float("OTPU_MEM_BUDGET_MB"))
    if budget_mb <= 0:
        return None
    return host_rss_bytes() / (budget_mb * 1024 * 1024)


def brownout_level(consume: bool = True) -> int:
    """The brownout ladder rung the current memory pressure lands on:
    0 normal, 1 shrink chunk admission, 2 force spill, 3 degrade the
    HBM replay cache. 0 whenever no pressure source is configured or
    the kill-switch is on (legacy: fits die on OOM instead). Level
    transitions land on the obs timeline and the
    ``otpu_brownout_level`` gauge, and warn once per escalation.
    ``consume=False`` (health scrapes) never advances an injected
    spec's ``after=`` budget."""
    global _last_brownout_level
    frac = memory_pressure_fraction(consume=consume)
    if frac is None or not resilience_enabled():
        level = 0
    else:
        w1, w2, w3 = _watermarks()
        level = 3 if frac >= w3 else 2 if frac >= w2 else \
            1 if frac >= w1 else 0
    if level != _last_brownout_level:
        with _brownout_lock:
            prev, _last_brownout_level = _last_brownout_level, level
        if level != prev:
            _M_BROWNOUT.set(level)
            from orange3_spark_tpu_torch.obs import trace as _trace

            _trace.instant("brownout", level=level,
                           frac=round(frac or 0.0, 4))
            if level > prev:
                log.warning(
                    "memory pressure %.0f%%: brownout level %d (%s); "
                    "OTPU_MEM_WATERMARKS tunes the ladder, "
                    "OTPU_RESILIENCE=0 disables it",
                    100.0 * (frac or 0.0), level,
                    _BROWNOUT_ACTIONS.get(level, "recovering"))
    return level


def current_brownout_level() -> int:
    """The last level :func:`brownout_level` computed (no re-read) —
    the /healthz report field."""
    return _last_brownout_level
