"""Health-aware hedged routing over the replica pool.

The front-end half of the fleet: one ``FleetRouter`` holds an endpoint
table (stable ids + ports from the supervisor), polls each replica's
``/readyz``, and routes every predict with the four tail-tolerance
mechanics every serving system converges on (Dean & Barroso, "The Tail
at Scale"):

* **least-inflight selection** — among ready, admitted, non-open-breaker
  replicas, the one with the fewest of THIS router's requests currently
  outstanding (ties break on the lowest id, so tests pin exact choices);
* **per-replica circuit breakers** — connect failures / read deadlines /
  HTTP 5xx feed a ``resilience.overload.CircuitBreaker`` per endpoint:
  a dead replica stops costing connect timeouts (open = excluded), and
  a restarted one re-admits itself through the half-open probe;
* **retry-with-replica-exclusion** — predicts are idempotent, so a
  failed attempt retries on a *different* replica (the failed one
  excluded for this request) until the pool is exhausted, at which point
  the LAST typed error (or ``NoReplicaAvailableError``) surfaces;
* **deterministic tail hedging** — a second copy of the request is
  issued to a different replica once the primary has been outstanding
  longer than the hedge delay: ``max(OTPU_FLEET_HEDGE_MS, EWMA-p95)``
  where the p95 estimate is ``ewma_mean + z(OTPU_FLEET_HEDGE_PCTL) *
  ewma_std`` over observed request latencies (:class:`HedgeSchedule` —
  pure arithmetic, pinned on a fake clock in tests/test_torch_fleet.py).
  First response wins; the loser is cancelled by closing its connection.

Every mechanism ticks an ``otpu_fleet_*`` registry metric
(the obs registry), and every request carries a
router-minted trace id that the replica adopts and echoes —
``otpu_fleet_trace_propagated_total / otpu_fleet_requests_total`` is the
cross-process trace-coverage ratio a healthy fleet holds at 1.0.
"""

from __future__ import annotations

import collections
import concurrent.futures
import math
import statistics
import threading
import time

import numpy as np

from orange3_spark_tpu_torch.fleet import fastwire
from orange3_spark_tpu_torch.fleet.rpc import (
    TRACE_HEADER,
    FleetClient,
    NoReplicaAvailableError,
    ReplicaDrainingError,
    ReplicaOverloadedError,
    ReplicaUnavailableError,
)
from orange3_spark_tpu_torch.obs.context import new_trace_id
from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.resilience.overload import (
    CircuitBreaker,
    OverloadShedError,
)
from orange3_spark_tpu_torch.serve.tenancy import (
    TenantQuotaShedError,
    current_tenant,
    tenancy_enabled,
)
from orange3_spark_tpu_torch.utils import knobs

__all__ = ["FleetCoalescer", "FleetRouter", "HedgeSchedule",
           "ReplicaEndpoint"]

_M_REQS = REGISTRY.counter(
    "otpu_fleet_requests_total", "predicts entering the fleet router")
_M_HEDGES = REGISTRY.counter(
    "otpu_fleet_hedges_total",
    "hedge copies issued after the tail-hedging delay")
_M_HEDGE_WINS = REGISTRY.counter(
    "otpu_fleet_hedge_wins_total",
    "requests whose hedge copy answered before the primary")
_M_FAILOVERS = REGISTRY.counter(
    "otpu_fleet_failovers_total",
    "attempts retried on a different replica, by reason")
_M_INFLIGHT = REGISTRY.gauge(
    "otpu_fleet_inflight",
    "router requests outstanding per replica")
_M_PROPAGATED = REGISTRY.counter(
    "otpu_fleet_trace_propagated_total",
    "responses whose replica echoed the router-minted trace id")
_M_CO_MEMBERS = REGISTRY.counter(
    "otpu_fleet_coalesce_members_total",
    "caller predicts that rode a coalesced wire dispatch")
_M_CO_DISPATCHES = REGISTRY.counter(
    "otpu_fleet_coalesce_dispatches_total",
    "wire dispatches the coalescer issued (members/dispatches is the "
    "cross-caller merge factor)")
_M_CO_SHEDS = REGISTRY.counter(
    "otpu_fleet_coalesce_sheds_total",
    "coalesced members shed typed because their deadline expired while "
    "queued (siblings still dispatch)")


class HedgeSchedule:
    """The deterministic tail-hedging delay: ``max(floor, EWMA-p95)``.

    Latency observations feed an exponentially-weighted mean/variance
    pair (West's EWMA update); the p-th percentile estimate is the
    normal-tail read-off ``mean + z(p) * std``. Everything is pure
    arithmetic on the observed values — no wall clock, no randomness —
    so tests pin exact delays, and two routers fed the same latency
    stream hedge identically."""

    def __init__(self, *, floor_ms: float | None = None,
                 pctl: float | None = None, alpha: float = 0.2):
        self.floor_s = float(
            floor_ms if floor_ms is not None
            else knobs.get_float("OTPU_FLEET_HEDGE_MS")) / 1e3
        self.pctl = float(pctl if pctl is not None
                          else knobs.get_float("OTPU_FLEET_HEDGE_PCTL"))
        self.alpha = alpha
        self._z = statistics.NormalDist().inv_cdf(
            min(max(self.pctl / 100.0, 0.5), 0.9999))
        self._lock = threading.Lock()
        self._n = 0
        self._mean = 0.0
        self._var = 0.0

    def observe(self, dt_s: float) -> None:
        """Fold one completed request's wall seconds into the EWMA."""
        with self._lock:
            if self._n == 0:
                self._mean, self._var = float(dt_s), 0.0
            else:
                d = float(dt_s) - self._mean
                incr = self.alpha * d
                self._mean += incr
                self._var = (1.0 - self.alpha) * (self._var + d * incr)
            self._n += 1

    def p_estimate_s(self) -> float:
        """The EWMA-p95 (well, p-``pctl``) latency estimate; 0 before
        the first observation."""
        with self._lock:
            if self._n == 0:
                return 0.0
            return self._mean + self._z * self._var ** 0.5

    def hedge_delay_s(self) -> float:
        return max(self.floor_s, self.p_estimate_s())


class _HedgeCancelled(Exception):
    """Internal: this request's connection was closed ON PURPOSE because
    the other hedge copy won — never a replica failure."""


class ReplicaEndpoint:
    """One replica as the router sees it: client + breaker + live state."""

    def __init__(self, replica_id: int, host: str, port: int, *,
                 client=None, breaker: CircuitBreaker | None = None):
        self.replica_id = replica_id
        self.name = f"replica-{replica_id}"
        self.client = client or FleetClient(host, port, name=self.name)
        self.breaker = breaker or CircuitBreaker(f"fleet:{self.name}")
        self.inflight = 0
        self.ready = False             # last /readyz verdict (or success)
        self.draining = False
        self.admitted = True           # rollout's per-replica gate
        self.version: str | None = None
        self.dag: str | None = None    # workflow bundle identity (/readyz)

    def state(self) -> str:
        if not self.admitted:
            return "held"
        if self.draining:
            return "draining"
        if self.breaker.state() == "open":
            return "open"
        return "ready" if self.ready else "unready"


class FleetRouter:
    """See module docstring. ``endpoints`` is a list of ``(id, host,
    port)`` (``ReplicaManager.endpoints()``) or prebuilt
    :class:`ReplicaEndpoint` objects (tests inject fake clients that
    way). ``hedging=False`` disables the tail hedge (an
    unhedged A/B arm); ``client_factory`` builds clients for tuple
    endpoints."""

    def __init__(self, endpoints, *, hedging: bool = True,
                 schedule: HedgeSchedule | None = None,
                 health_poll_s: float = 0.25,
                 client_factory=None, slo=None):
        factory = client_factory or (
            lambda host, port, name: FleetClient(host, port, name=name))
        self.endpoints: list[ReplicaEndpoint] = []
        for ep in endpoints:
            if isinstance(ep, ReplicaEndpoint):
                self.endpoints.append(ep)
            else:
                rid, host, port = ep
                self.endpoints.append(ReplicaEndpoint(
                    rid, host, port,
                    client=factory(host, port, f"replica-{rid}")))
        self.hedging = hedging
        self.schedule = schedule or HedgeSchedule()
        # fleet telemetry (obs/fleetobs.py): every predict outcome feeds
        # the SLO burn-rate engine when one is attached — gated, like the
        # router-side serve span, on OTPU_FLEETOBS (read per request)
        self.slo = slo
        self.health_poll_s = health_poll_s
        self._lock = threading.Lock()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(4, 4 * len(self.endpoints)),
            thread_name_prefix="otpu-fleet-router")
        self._poller: threading.Thread | None = None
        self._stop = threading.Event()
        self.coalescer = FleetCoalescer(self)

    # ------------------------------------------------------------- health
    def refresh(self, timeout_s: float = 0.5) -> dict[int, bool]:
        """One synchronous /readyz sweep (tests, rollout, cold start)."""
        out = {}
        for ep in self.endpoints:
            ok, body = ep.client.ready(timeout_s=timeout_s)
            ep.ready = ok
            ep.draining = bool(body.get("draining"))
            if body.get("version"):
                ep.version = body["version"]
            if "dag" in body:
                ep.dag = body["dag"]
            out[ep.replica_id] = ok
        return out

    def start_health_poller(self) -> "FleetRouter":
        if self._poller is None:
            self._stop.clear()
            self._poller = threading.Thread(
                target=self._poll_loop, daemon=True,
                name="otpu-fleet-health")
            self._poller.start()
        return self

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.refresh()
            except Exception:  # noqa: BLE001 - polling must never die
                pass
            self._stop.wait(self.health_poll_s)

    def set_admitted(self, replica_id: int, admitted: bool) -> None:
        """The rollout's per-replica traffic gate (drain one, roll it,
        re-admit it)."""
        for ep in self.endpoints:
            if ep.replica_id == replica_id:
                ep.admitted = bool(admitted)
                return
        raise KeyError(replica_id)

    def endpoint(self, replica_id: int) -> ReplicaEndpoint:
        for ep in self.endpoints:
            if ep.replica_id == replica_id:
                return ep
        raise KeyError(replica_id)

    # ------------------------------------------------------- elastic table
    def add_endpoint(self, replica_id: int, host: str, port: int, *,
                     client=None) -> ReplicaEndpoint:
        """Atomically grow the routing table (the autoscaler's scale-up
        half). The new endpoint starts unpolled (``ready=False``) —
        ``_pick``'s cold-start ordering keeps it behind warm replicas
        until /readyz (poller or next refresh) flips it."""
        ep = ReplicaEndpoint(replica_id, host, port, client=client)
        with self._lock:
            if any(e.replica_id == replica_id for e in self.endpoints):
                raise KeyError(
                    f"replica {replica_id} is already in the table")
            self.endpoints.append(ep)
        return ep

    def remove_endpoint(self, replica_id: int) -> ReplicaEndpoint:
        """Atomically shrink the routing table (the autoscaler's
        scale-down half): no pick made after this returns can choose the
        endpoint, while calls already on it run to completion — remove
        FIRST, drain the replica AFTER, and only then close the returned
        endpoint's client (closing earlier would abort the very
        in-flight work scale-down promises never to kill)."""
        with self._lock:
            for i, ep in enumerate(self.endpoints):
                if ep.replica_id == replica_id:
                    self.endpoints.pop(i)
                    return ep
        raise KeyError(replica_id)

    def states(self) -> dict[str, str]:
        return {ep.name: ep.state() for ep in self.endpoints}

    def close(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=2.0)
            self._poller = None
        self._pool.shutdown(wait=False)
        for ep in self.endpoints:
            close = getattr(ep.client, "close", None)
            if close is not None:       # fakes without a pool are fine
                close()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- selection
    def _pick(self, excluded: set) -> ReplicaEndpoint | None:
        """Least-inflight over ready+admitted+breaker-allowed replicas;
        falls back to unpolled-but-admitted ones (cold start) before
        giving up. ``allow()`` is consulted LAST and only on the chosen
        endpoint — it consumes the half-open probe slot."""
        with self._lock:
            ranked = sorted(
                (ep for ep in self.endpoints
                 if ep.replica_id not in excluded and ep.admitted
                 and not ep.draining
                 and ep.breaker.state() != "open"),
                key=lambda ep: (not ep.ready, ep.inflight, ep.replica_id))
        for ep in ranked:
            if ep.breaker.allow():
                return ep
        return None

    # ------------------------------------------------------------- calling
    def _call(self, ep: ReplicaEndpoint, X, trace_id: str,
              timeout_s: float | None, conn_slot: list | None = None,
              cancel_event: threading.Event | None = None,
              weight: int = 1, member_traces: list | None = None,
              tenant: str | None = None):
        # member_traces/tenant are forwarded only when set, so fake
        # clients with the pre-coalescer predict() signature keep
        # working untouched. The tenant rides as an EXPLICIT argument,
        # not thread-local ambience: this may run on a hedge-pool or
        # coalescer-leader thread that never entered the caller's scope
        kw = {"member_traces": member_traces} if member_traces else {}
        if tenant is not None:
            kw["tenant"] = tenant
        with self._lock:
            ep.inflight += 1
            _M_INFLIGHT.set(ep.inflight, replica=ep.name)
        t0 = time.perf_counter()
        try:
            out, headers = ep.client.predict(
                X, trace_id=trace_id, timeout_s=timeout_s,
                conn_slot=conn_slot, **kw)
        except ReplicaDrainingError:
            # graceful refusal: not a breaker failure — the replica is
            # healthy, it just wants no NEW work; stop routing to it
            # until /readyz clears the drain flag
            with self._lock:
                ep.draining = True
                ep.ready = False
            raise
        except ReplicaUnavailableError:
            if cancel_event is not None and cancel_event.is_set():
                # WE closed this connection because the other hedge copy
                # won — the replica did nothing wrong; poisoning its
                # breaker here would open healthy replicas under exactly
                # the load hedging exists to absorb
                raise _HedgeCancelled from None
            ep.breaker.record_failure()
            with self._lock:
                ep.ready = False
            raise
        finally:
            with self._lock:
                ep.inflight -= 1
                _M_INFLIGHT.set(ep.inflight, replica=ep.name)
        dt = time.perf_counter() - t0
        self.schedule.observe(dt)
        ep.breaker.record_success()
        with self._lock:
            ep.ready = True
            if headers.get("X-OTPU-Version"):
                ep.version = headers["X-OTPU-Version"]
        if headers.get(TRACE_HEADER) == trace_id:
            # the replica's serving path carried OUR id end-to-end — the
            # cross-process propagation a healthy fleet holds at 1.0.
            # A coalesced dispatch counts once per MEMBER (weight): N
            # callers entered the router, one wire echo covers them all
            _M_PROPAGATED.inc(weight)
        return np.asarray(out)

    def _hedged_call(self, primary: ReplicaEndpoint, X, trace_id: str,
                     timeout_s: float | None, excluded: set,
                     weight: int = 1, member_traces: list | None = None,
                     tenant: str | None = None):
        """Primary + (after the hedge delay) one hedge to a different
        replica; first success wins, the loser's connection is closed.
        Raises only when BOTH copies failed (primary's error surfaces;
        both replicas land in ``excluded`` for the outer failover
        loop)."""
        slots: dict = {}
        cancels: dict = {}

        def run(ep):
            slot: list = []
            slots[ep.replica_id] = slot
            cancels[ep.replica_id] = cancel = threading.Event()
            return self._call(ep, X, trace_id, timeout_s, conn_slot=slot,
                              cancel_event=cancel, weight=weight,
                              member_traces=member_traces, tenant=tenant)

        def cancel_others(winner_fut):
            # mark the loser cancelled FIRST so its _call classifies the
            # forced close as _HedgeCancelled (never a breaker failure),
            # then close its socket
            for lf, lep in futs.items():
                if lf is not winner_fut and not lf.done():
                    ev = cancels.get(lep.replica_id)
                    if ev is not None:
                        ev.set()
                    for conn in slots.get(lep.replica_id, ()):
                        try:
                            conn.close()
                        except Exception:  # noqa: BLE001
                            pass
                    lf.cancel()

        futs = {self._pool.submit(run, primary): primary}
        done, _ = concurrent.futures.wait(
            futs, timeout=self.schedule.hedge_delay_s())
        hedge = None
        if not done:
            hedge = self._pick(excluded | {primary.replica_id})
            if hedge is not None:
                _M_HEDGES.inc()
                futs[self._pool.submit(run, hedge)] = hedge
        errors: dict = {}
        pending = set(futs)
        while pending:
            done, pending = concurrent.futures.wait(
                pending,
                return_when=concurrent.futures.FIRST_COMPLETED)
            for fut in done:
                ep = futs[fut]
                try:
                    out = fut.result()
                except (ReplicaUnavailableError,
                        ReplicaDrainingError) as e:
                    errors[ep.replica_id] = e
                    continue
                except (ReplicaOverloadedError, TenantQuotaShedError):
                    # the replica shed OUR request typed (nearly-expired
                    # deadline, or its tenant over quota): waiting out
                    # the sibling copy (or retrying) would only finish
                    # after the caller gave up — and a quota shed would
                    # shed again anywhere — cancel the sibling and
                    # surface the shed
                    cancel_others(fut)
                    raise
                cancel_others(fut)
                if hedge is not None and ep is hedge:
                    _M_HEDGE_WINS.inc()
                return out
        # both copies failed: exclude both, surface the primary's error
        excluded.update(errors)
        raise errors.get(primary.replica_id,
                         next(iter(errors.values())))

    # ------------------------------------------------------------- predict
    def predict(self, X, *, deadline_s: float | None = None,
                hedge: bool | None = None) -> np.ndarray:
        """Route one idempotent predict through the fleet. Typed errors
        only: ``ReplicaUnavailableError`` when every failover attempt
        failed, ``NoReplicaAvailableError`` when there was nowhere to
        send it — never a hang (every wait is deadline-bounded).

        With the fleet telemetry plane on (``OTPU_FLEETOBS``, default),
        the request runs under a router-side ``serve`` span carrying the
        minted trace id — the router half the cross-process trace
        assembler stitches to the replica's spans — and its outcome +
        latency feed the attached SLO engine. ``OTPU_FLEETOBS=0`` takes
        the bare fleet path: no scope, no span, no sample."""
        trace_id = new_trace_id("fleet")
        _M_REQS.inc()
        use_hedge = self.hedging if hedge is None else hedge
        # the tenant identity is captured HERE, on the caller's thread —
        # every hop below may run on pool threads that never saw the
        # caller's tenant_scope()
        tenant = current_tenant() if tenancy_enabled() else None
        from orange3_spark_tpu_torch.obs.fleetobs import fleetobs_enabled

        if not fleetobs_enabled():
            return self._submit(X, trace_id, deadline_s, use_hedge,
                                tenant)
        from orange3_spark_tpu_torch.obs import trace as _trace
        from orange3_spark_tpu_torch.obs.context import propagated_scope

        span_kw = {"tenant": tenant} if tenant is not None else {}
        t0 = time.perf_counter()
        ok = False
        try:
            with propagated_scope(trace_id, "fleet"):
                with _trace.span("serve", kind="fleet", **span_kw):
                    out = self._submit(X, trace_id, deadline_s,
                                       use_hedge, tenant)
            ok = True
            return out
        finally:
            if self.slo is not None:
                self.slo.record(ok, time.perf_counter() - t0)

    def _submit(self, X, trace_id: str, deadline_s: float | None,
                use_hedge: bool,
                tenant: str | None = None) -> np.ndarray:
        if self.coalescer.enabled():
            return self.coalescer.submit(X, trace_id, deadline_s,
                                         use_hedge, tenant=tenant)
        return self._route(X, trace_id, deadline_s, use_hedge,
                           tenant=tenant)

    def _route(self, X, trace_id: str, deadline_s: float | None,
               use_hedge: bool, weight: int = 1,
               member_traces: list | None = None,
               tenant: str | None = None) -> np.ndarray:
        excluded: set = set()
        last_err: Exception | None = None
        for _attempt in range(max(2 * len(self.endpoints), 2)):
            ep = self._pick(excluded)
            if ep is None:
                break
            try:
                if use_hedge and len(self.endpoints) > 1:
                    return self._hedged_call(ep, X, trace_id, deadline_s,
                                             excluded, weight=weight,
                                             member_traces=member_traces,
                                             tenant=tenant)
                return self._call(ep, X, trace_id, deadline_s,
                                  weight=weight,
                                  member_traces=member_traces,
                                  tenant=tenant)
            except (ReplicaOverloadedError, TenantQuotaShedError):
                # typed shed under the caller's own propagated deadline
                # (or its tenant's quota): failing over would produce an
                # answer after the caller gave up — and a quota shed
                # follows the tenant, not the replica — surface it, no
                # retry, no breaker
                raise
            except ReplicaDrainingError as e:
                _M_FAILOVERS.inc(1, reason="draining")
                excluded.add(ep.replica_id)
                last_err = e
            except ReplicaUnavailableError as e:
                _M_FAILOVERS.inc(1, reason=e.reason)
                excluded.add(ep.replica_id)
                last_err = e
        if last_err is not None:
            raise last_err
        raise NoReplicaAvailableError(self.states(), trace_id=trace_id)


# ------------------------------------------------------- cross-caller merge
def _merge_key(X: np.ndarray):
    """Members merge only when a row-concatenation is meaningful: 2-D,
    same column count, same dtype. Anything else dispatches alone."""
    if X.ndim != 2:
        return None
    return (X.shape[1], str(X.dtype))


class _Member:
    """One caller's predict riding a coalesced dispatch: a tiny future
    (event + result/error slot) the leader scatters back into."""

    __slots__ = ("X", "n", "trace_id", "deadline_s", "tenant",
                 "enqueued", "event", "result", "error")

    def __init__(self, X: np.ndarray, trace_id: str,
                 deadline_s: float | None, tenant: str | None = None):
        self.X = X
        self.n = int(X.shape[0]) if X.ndim >= 1 else 1
        self.trace_id = trace_id
        self.deadline_s = deadline_s
        self.tenant = tenant
        self.enqueued = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None

    def remaining_s(self, now: float) -> float | None:
        if self.deadline_s is None or not math.isfinite(self.deadline_s):
            return None
        return self.deadline_s - (now - self.enqueued)

    def finish(self, result) -> None:
        self.result = result
        self.event.set()

    def fail(self, error: Exception) -> None:
        self.error = error
        self.event.set()

    def await_result(self):
        """Bounded wait — a lost dispatch surfaces typed, never hangs.
        The bound is a backstop well past any legitimate wire outcome
        (failover may burn several per-attempt timeouts), not a
        precision deadline (the dispatch path enforces those)."""
        budget = (self.deadline_s
                  if self.deadline_s and math.isfinite(self.deadline_s)
                  else knobs.get_float("OTPU_FLEET_TIMEOUT_S") * 2) + 30.0
        if not self.event.wait(budget):
            raise ReplicaUnavailableError(
                "coalesced dispatch never delivered within the bounded "
                "wait", reason="coalesce_timeout", trace_id=self.trace_id)
        if self.error is not None:
            raise self.error
        return self.result


class FleetCoalescer:
    """Cross-caller coalescing in front of replica selection — the
    MicroBatcher contract one level up, on the router↔replica wire:
    concurrent same-shape predicts from DIFFERENT callers merge into one
    wire dispatch, and results scatter back per caller.

    Leader/follower, no dedicated worker thread: a submitting caller
    becomes a *leader* while fewer leaders than replicas are active, and
    drains the pending queue — merging compatible members (2-D, same
    columns/dtype) up to ``OTPU_FLEET_COALESCE_ROWS`` (the ladder-clamp:
    the default matches the serving ladder's max bucket), optionally
    lingering ``OTPU_FLEET_COALESCE_WAIT_MS`` to accumulate more — until
    the queue is empty. Everyone else waits on a bounded future.

    Per-member semantics are preserved: a member whose deadline expired
    while queued is shed typed (``OverloadShedError``) while its
    siblings dispatch; a failed dispatch delivers the SAME typed error
    to every member (never a hang); hedging/breaker/failover operate on
    the merged dispatch. A solo member dispatches with its own trace id
    (the old wire exactly); a merged dispatch mints a wire id, counts
    propagation once per member, and the members' ids ride flow events
    (router-side ``s``/``t`` here, replica-side ``f`` via the
    ``X-OTPU-Member-Traces`` header into the device dispatch)."""

    def __init__(self, router: "FleetRouter"):
        self._router = router
        self._lock = threading.Lock()
        self._pending: collections.deque[_Member] = collections.deque()
        self._leaders = 0
        # monotonically growing — FleetDigest reads them for merge factor
        self.members = 0
        self.dispatches = 0
        self.sheds = 0

    @staticmethod
    def enabled() -> bool:
        return (fastwire.fastwire_enabled()
                and knobs.get_bool("OTPU_FLEET_COALESCE"))

    def _cap(self) -> int:
        # one leader per replica: merged dispatches can still saturate
        # the pool, and a single caller stream serializes (max merge)
        return max(1, len(self._router.endpoints))

    def stats(self) -> dict:
        with self._lock:
            members, dispatches = self.members, self.dispatches
            sheds, queued = self.sheds, len(self._pending)
        return {"members": members, "dispatches": dispatches,
                "sheds": sheds, "queued": queued,
                "merge_factor": round(members / dispatches, 2)
                if dispatches else 0.0}

    # ------------------------------------------------------------ submit
    def submit(self, X, trace_id: str, deadline_s: float | None,
               use_hedge: bool, tenant: str | None = None):
        m = _Member(np.asarray(X), trace_id, deadline_s, tenant)
        with self._lock:
            self._pending.append(m)
            lead = self._leaders < self._cap()
            if lead:
                self._leaders += 1
        if lead:
            self._drain(use_hedge)
        return m.await_result()

    def _drain(self, use_hedge: bool) -> None:
        wait_s = knobs.get_float("OTPU_FLEET_COALESCE_WAIT_MS") / 1e3
        max_rows = max(1, knobs.get_int("OTPU_FLEET_COALESCE_ROWS"))
        while True:
            if wait_s > 0:
                time.sleep(wait_s)      # bounded linger to gather members
            with self._lock:
                if not self._pending:
                    # decrement ATOMICALLY with the empty check: submit
                    # appends under this lock, so a racing caller either
                    # sees our pending grab (we loop) or leaders-1 (it
                    # leads itself) — nobody's member is left unowned
                    self._leaders -= 1
                    return
                group = self._take_group_locked(max_rows)
            self._dispatch(group, use_hedge)

    def _take_group_locked(self, max_rows: int) -> list[_Member]:
        first = self._pending.popleft()
        key = _merge_key(first.X)
        if key is None:
            return [first]
        # same-tenant merge only: a merged dispatch is admitted (and
        # quota-accounted) replica-side as ONE tenant, so mixing tenants
        # would bill one tenant for another's rows
        key = (key, first.tenant)
        group, rows, rest = [first], first.n, []
        while self._pending:
            m = self._pending.popleft()
            if ((_merge_key(m.X), m.tenant) == key
                    and rows + m.n <= max_rows):
                group.append(m)
                rows += m.n
            else:
                rest.append(m)
        self._pending.extendleft(reversed(rest))
        return group

    # ---------------------------------------------------------- dispatch
    def _dispatch(self, group: list[_Member], use_hedge: bool) -> None:
        now = time.monotonic()
        live: list[_Member] = []
        for m in group:
            rem = m.remaining_s(now)
            if rem is not None and rem <= 0:
                # this member's whole budget burned in the queue: shed
                # typed per member — dispatching work whose caller
                # already gave up is the waste deadlines exist to stop
                with self._lock:
                    self.sheds += 1
                _M_CO_SHEDS.inc()
                m.fail(OverloadShedError(
                    reason="deadline", queue_depth=len(group),
                    inflight=0, est_wait_s=0.0,
                    deadline_s=m.deadline_s, trace_id=m.trace_id))
                continue
            live.append(m)
        if not live:
            return
        with self._lock:
            self.members += len(live)
            self.dispatches += 1
        _M_CO_MEMBERS.inc(len(live))
        _M_CO_DISPATCHES.inc()
        if len(live) == 1:
            # solo: the member's own id IS the wire id — byte-identical
            # to the uncoalesced wire (no extra header, no flow events)
            m = live[0]
            try:
                m.finish(self._router._route(
                    m.X, m.trace_id, m.remaining_s(now), use_hedge,
                    tenant=m.tenant))
            except Exception as e:  # noqa: BLE001 — delivered, not hung
                m.fail(e)
            return
        from orange3_spark_tpu_torch.obs.trace import flow

        wire_id = new_trace_id("fleet")
        deadlines = [r for r in (m.remaining_s(now) for m in live)
                     if r is not None]
        deadline = min(deadlines) if deadlines else None
        for m in live:
            flow("s", m.trace_id)
        X = np.concatenate([m.X for m in live], axis=0)
        for m in live:
            flow("t", m.trace_id)
        try:
            out = self._router._route(
                X, wire_id, deadline, use_hedge, weight=len(live),
                member_traces=[m.trace_id for m in live],
                tenant=live[0].tenant)
        except Exception as e:  # noqa: BLE001 — same typed error to all
            for m in live:
                m.fail(e)
            return
        out = np.asarray(out)
        if out.ndim == 0 or out.shape[0] != X.shape[0]:
            err = ReplicaUnavailableError(
                f"coalesced response shape {out.shape} does not scatter "
                f"over {X.shape[0]} merged rows", reason="scatter")
            for m in live:
                m.fail(err)
            return
        off = 0
        for m in live:
            m.finish(out[off:off + m.n])
            off += m.n
