"""Digest-driven elastic autoscaling — the scaling half of the fleet
control plane.

The telemetry plane built :class:`~orange3_spark_tpu_torch.obs.fleetobs.FleetDigest`
explicitly as "the autoscaler's input" — queue depths, shed
totals, EWMA-p95, brownout level, one consolidated load signal per
scrape — and nothing consumed it. This module closes that loop: an
:class:`Autoscaler` registered through ``ReplicaManager.on_digest``
turns each digest into at most one replica-count decision through
classic hysteresis bands:

* **pressure** = (queued + in-flight requests) / up replicas — the
  per-replica backlog the digest already aggregates;
* **scale up** one replica when pressure >= ``OTPU_AUTOSCALE_UP_X``, or
  the fleet shed requests since the last look, or brownout has climbed
  past its first rung — capped at ``OTPU_AUTOSCALE_MAX``;
* **scale down** one replica when pressure <= ``OTPU_AUTOSCALE_DOWN_X``
  with zero sheds and no brownout — floored at ``OTPU_AUTOSCALE_MIN``;
* **cooldown** ``OTPU_AUTOSCALE_COOLDOWN_S`` between decisions on the
  INJECTED clock — every decision is a pure function of (digest,
  previous digest, clock), no wall-clock randomness, so tests and the
  drill replay exact timelines.

The bands must not overlap (``DOWN_X < UP_X`` enforced at
construction): between them sits the dead zone that keeps the fleet
from flapping. Scale-up rides the supervisor's EXISTING crash-restart
spawn path (``add_replica``); scale-down is drain-then-stop — the
router's endpoint table shrinks atomically FIRST (no new picks), the
replica drains its in-flight work, and only then does the process stop
and the client close: scale-down never kills live requests. Decisions
land as obs instants + ``otpu_autoscale_total{dir=}`` and the full
state (replicas, last decision, cooldown remaining) reports through
``/readyz``, ``/fleetz`` and ``tools/fleet_top.py``.

Kill-switch: ``OTPU_AUTOSCALE=0`` (read per step) — the fixed-size
fleet, bitwise: ``step()`` never scales and never ticks a metric.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from orange3_spark_tpu_torch.obs import trace
from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

__all__ = [
    "Autoscaler",
    "ScaleDecision",
    "active_autoscaler_state",
    "autoscale_enabled",
    "set_active_autoscaler",
]

_M_DECISIONS = REGISTRY.counter(
    "otpu_autoscale_total",
    "autoscaler replica-count decisions, by direction (up / down)")
_M_REPLICAS = REGISTRY.gauge(
    "otpu_autoscale_replicas",
    "supervised replica count as of the autoscaler's last look")


def autoscale_enabled() -> bool:
    """The autoscaling kill-switch (read per step): ``OTPU_AUTOSCALE=0``
    pins the fixed-size fleet."""
    return knobs.get_bool("OTPU_AUTOSCALE")


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One executed scale decision (the autoscale timeline's row)."""

    direction: str                 # "up" | "down"
    replica_id: int
    replicas_before: int
    replicas_after: int
    pressure: float
    shed_delta: int
    brownout: int
    reason: str
    at: float                      # injected-clock timestamp

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Autoscaler:
    """See module docstring. ``supervisor`` is a
    :class:`~orange3_spark_tpu_torch.fleet.supervisor.ReplicaManager` (or
    anything with ``handles``/``add_replica``/``remove_replica`` — the
    drill injects a fake); ``router`` a
    :class:`~orange3_spark_tpu_torch.fleet.router.FleetRouter` whose endpoint
    table tracks the fleet (None for supervisor-only drills). Band
    parameters default to their ``OTPU_AUTOSCALE_*`` knobs."""

    def __init__(self, supervisor, router=None, *,
                 min_replicas: int | None = None,
                 max_replicas: int | None = None,
                 up_x: float | None = None, down_x: float | None = None,
                 cooldown_s: float | None = None, clock=time.monotonic):
        self.supervisor = supervisor
        self.router = router
        self.min_replicas = max(1, int(
            min_replicas if min_replicas is not None
            else knobs.get_int("OTPU_AUTOSCALE_MIN")))
        self.max_replicas = int(
            max_replicas if max_replicas is not None
            else knobs.get_int("OTPU_AUTOSCALE_MAX"))
        self.up_x = float(up_x if up_x is not None
                          else knobs.get_float("OTPU_AUTOSCALE_UP_X"))
        self.down_x = float(down_x if down_x is not None
                            else knobs.get_float("OTPU_AUTOSCALE_DOWN_X"))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else knobs.get_float("OTPU_AUTOSCALE_COOLDOWN_S"))
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"autoscale bounds: max ({self.max_replicas}) < min "
                f"({self.min_replicas})")
        if not self.down_x < self.up_x:
            raise ValueError(
                f"autoscale bands overlap: DOWN_X ({self.down_x:g}) must "
                f"be < UP_X ({self.up_x:g}) — the dead zone between them "
                "is what prevents flapping")
        self.clock = clock
        self._lock = threading.Lock()
        self._last_decision_at: float | None = None
        self._last_shed_total: int | None = None
        self.decisions: list[ScaleDecision] = []

    # ------------------------------------------------------------- wiring
    def attach(self) -> "Autoscaler":
        """Consume every published digest (the FleetCollector scrape
        loop drives ``publish_digest``) and advertise this instance as
        the process's active autoscaler for /readyz//fleetz."""
        self.supervisor.on_digest(self.step)
        set_active_autoscaler(self)
        return self

    # ------------------------------------------------------------ reading
    @staticmethod
    def _load(digest) -> tuple[int, float, int, int]:
        """(up replicas, pressure numerator, shed total, brownout) from a
        FleetDigest — or a plain dict with the same keys (the drill's
        synthetic timelines)."""
        replicas = (digest.get("replicas") if isinstance(digest, dict)
                    else getattr(digest, "replicas", ()))
        if isinstance(replicas, dict):     # name -> load-view mapping
            replicas = list(replicas.values())
        n_up = queued = inflight = sheds = brownout = 0
        for r in replicas or ():
            get = (r.get if isinstance(r, dict)
                   else lambda k, _r=r: getattr(_r, k, 0))
            if not get("up") or get("stale"):
                continue
            n_up += 1
            queued += int(get("queue_depth") or 0)
            inflight += int(get("inflight") or 0)
            sheds += int(get("shed_total") or 0)
            brownout = max(brownout, int(get("brownout_level") or 0))
        return n_up, float(queued + inflight), sheds, brownout

    def cooldown_remaining_s(self) -> float:
        with self._lock:
            last = self._last_decision_at
        if last is None:
            return 0.0
        return max(0.0, self.cooldown_s - (self.clock() - last))

    # ------------------------------------------------------------ deciding
    def step(self, digest) -> ScaleDecision | None:
        """Consume one digest; execute at most one replica-count change.
        Returns the executed :class:`ScaleDecision` (None = no change).
        Deterministic: same digests + same clock = same decisions."""
        if digest is None or not autoscale_enabled():
            return None
        with self._lock:
            n_up, load, shed_total, brownout = self._load(digest)
            prev_sheds = self._last_shed_total
            self._last_shed_total = shed_total
            shed_delta = (max(0, shed_total - prev_sheds)
                          if prev_sheds is not None else 0)
            n = len(self.supervisor.handles)
            _M_REPLICAS.set(n)
            now = self.clock()
            if (self._last_decision_at is not None
                    and now - self._last_decision_at < self.cooldown_s):
                return None
            pressure = load / max(n_up, 1)
            if (n < self.max_replicas
                    and (pressure >= self.up_x or shed_delta > 0
                         or brownout >= 2)):
                direction = "up"
                reason = ("pressure" if pressure >= self.up_x
                          else "sheds" if shed_delta > 0 else "brownout")
            elif (n > self.min_replicas and pressure <= self.down_x
                    and shed_delta == 0 and brownout == 0
                    and n_up >= n):
                # drain only a fleet that is fully up: a replica mid-
                # restart already is capacity on the way back
                direction, reason = "down", "idle"
            else:
                return None
            self._last_decision_at = now
            # execute under the lock: one decision in flight at a time —
            # a drain that outlives the next scrape must not stack a
            # second decision on a table mid-mutation
            rid = (self._scale_up() if direction == "up"
                   else self._scale_down())
            if rid is None:
                return None
            decision = ScaleDecision(
                direction=direction, replica_id=rid, replicas_before=n,
                replicas_after=len(self.supervisor.handles),
                pressure=round(pressure, 4), shed_delta=shed_delta,
                brownout=brownout, reason=reason, at=now)
            self.decisions.append(decision)
        _M_DECISIONS.inc(1, dir=direction)
        _M_REPLICAS.set(decision.replicas_after)
        trace.instant("autoscale", dir=direction, replica=rid,
                      replicas=decision.replicas_after,
                      pressure=decision.pressure, reason=reason)
        return decision

    def _scale_up(self) -> int | None:
        rid = self.supervisor.add_replica()
        if self.router is not None:
            h = self.supervisor._handle(rid)
            # enters the table unpolled: _pick's cold-start ordering
            # keeps traffic on warm replicas until /readyz flips it
            self.router.add_endpoint(rid, "127.0.0.1", h.port)
        return rid

    def _scale_down(self) -> int | None:
        # deterministic victim: the newest replica (highest id) — the
        # one whose cache is coldest and whose port add_replica can
        # reuse on the next growth
        rid = max((h.replica_id for h in self.supervisor.handles),
                  default=None)
        if rid is None:
            return None
        ep = None
        if self.router is not None:
            try:
                ep = self.router.remove_endpoint(rid)
            except KeyError:
                ep = None          # never routed (still warming): fine
        # drain AFTER the table shrank: no new picks land on it, and
        # everything already on it finishes inside the drain budget
        self.supervisor.remove_replica(rid)
        if ep is not None:
            close = getattr(ep.client, "close", None)
            if close is not None:
                close()
        return rid

    # ----------------------------------------------------------- reporting
    def state(self) -> dict:
        """The control-plane status block /readyz, /fleetz and fleet_top
        render: bounds, live count, last decision, cooldown remaining."""
        with self._lock:
            last = (self.decisions[-1].to_dict()
                    if self.decisions else None)
            n_decisions = len(self.decisions)
        return {
            "enabled": autoscale_enabled(),
            "min": self.min_replicas,
            "max": self.max_replicas,
            "replicas": len(self.supervisor.handles),
            "decisions": n_decisions,
            "last_decision": last,
            "cooldown_remaining_s": round(self.cooldown_remaining_s(), 3),
        }


# the process's active autoscaler (at most one per supervisor process):
# /readyz and /fleetz report its state without threading a reference
# through every server constructor
_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Autoscaler | None = None


def set_active_autoscaler(a: Autoscaler | None) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = a


def active_autoscaler_state() -> dict | None:
    """The active autoscaler's ``state()`` (None when none attached) —
    the lazily-pulled /readyz//fleetz surface."""
    with _ACTIVE_LOCK:
        a = _ACTIVE
    if a is None:
        return None
    try:
        return a.state()
    except Exception:  # noqa: BLE001 - reporting must never break ready
        return None
