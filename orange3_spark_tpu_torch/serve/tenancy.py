"""Multi-tenant weighted-fair serving — the tenancy half of the fleet
control plane (docs/serving.md "Control plane").

The paper's production premise is many users' canvases sharing ONE accelerator
backend, but the serving stack below this module treats all traffic as
one anonymous tenant: a single bursting caller fills the admission
queue and every other caller's p99 rides its backlog. This module adds
the identity and the fairness:

* :func:`tenant_scope` — a thread-local tenant identity (the exact
  shape of :func:`~orange3_spark_tpu_torch.resilience.overload.request_deadline`)
  every serving entry point reads ambiently. The fleet client carries it
  on the wire as ``X-OTPU-Tenant`` (fleet/rpc.py) and the replica adopts
  it around its dispatch like the trace header, so one tenant
  identity spans caller → router → replica → device dispatch.
* :func:`parse_tenant_spec` — the ``OTPU_TENANT_SPEC`` grammar
  (``name:weight=4[,max_inflight=8,deadline_s=0.5]``, ``;``-separated;
  a malformed item raises naming the item, the ``parse_slo_spec``
  convention). Unlisted tenants get ``OTPU_TENANT_DEFAULT_WEIGHT``.
* :class:`TenantFairShare` — the weighted-fair queuing state an
  :class:`~orange3_spark_tpu_torch.resilience.overload.AdmissionController`
  consults under its condition variable: per-tenant token buckets
  (capacity ``weight x OTPU_TENANT_BURST``, refill ``weight x
  OTPU_TENANT_RATE``/s — inert at rate 0) bound a tenant's burst,
  weighted share caps bound its slot/queue occupancy under contention,
  and deficit-round-robin grant ordering hands freed slots to the
  most-underserved waiting tenant — so a bursting tenant sheds typed
  while the others' p99 stays bounded by their own share.
* :class:`TenantQuotaShedError` — the typed shed (an
  ``OverloadShedError`` subclass, so every existing except-clause and
  503 mapping keeps working) carrying ``tenant``/``usage``/``quota``/
  ``trace_id``: a quota shed in production logs is self-explaining.

Kill-switch: ``OTPU_TENANCY=0`` (read per call) restores the anonymous
fleet bitwise — no header rides the wire, admission ignores scopes, no
tenant metric is ever labeled. With tenancy ON but no scope entered the
behavior is identical too: fairness costs nothing until a tenant shows
up. Per-tenant state exports through ``otpu_tenant_*`` registry metrics
(docs/observability.md catalog), ``/readyz``/``/fleetz`` report shed
counts, and ``tools/fleet_top.py``/``tools/tenancy_drill.py`` render
the live fairness table.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager

from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.resilience.overload import OverloadShedError

__all__ = [
    "TenantFairShare",
    "TenantQuotaShedError",
    "TenantSpec",
    "current_tenant",
    "parse_tenant_spec",
    "tenancy_enabled",
    "tenant_scope",
    "tenant_shed_counts",
]

_M_TENANT_SHEDS = REGISTRY.counter(
    "otpu_tenant_sheds_total",
    "requests shed by per-tenant quota enforcement, by tenant and reason")
_M_TENANT_INFLIGHT = REGISTRY.gauge(
    "otpu_tenant_inflight",
    "admission slots currently held, per tenant")
_M_TENANT_GRANTS = REGISTRY.counter(
    "otpu_tenant_granted_total",
    "admission slots granted, per tenant (the DRR ledger's visible half)")


def tenancy_enabled() -> bool:
    """The tenancy kill-switch (read per call, the OTPU_DONATE
    convention): ``OTPU_TENANCY=0`` restores the anonymous fleet."""
    from orange3_spark_tpu_torch.utils import knobs

    return knobs.get_bool("OTPU_TENANCY")


# per-thread tenant identity — the exact request_deadline() shape, so a
# caller scopes identity and deadline the same way and both flow to the
# same admission decision
_TLS = threading.local()


@contextmanager
def tenant_scope(name: str | None):
    """Scope a tenant identity over a block of serve calls::

        with tenant_scope("canvas-42"):
            model.predict(batch)     # admitted against canvas-42's share

    ``None`` restores "no tenant" inside an outer scope. The identity is
    per-thread; cross-thread paths (the fleet router's hedge pool, the
    coalescer leader) capture it at submit and forward it explicitly."""
    prev = getattr(_TLS, "tenant", None)
    _TLS.tenant = name
    try:
        yield
    finally:
        _TLS.tenant = prev


def current_tenant() -> str | None:
    """The ambient tenant identity (None outside any scope)."""
    return getattr(_TLS, "tenant", None)


# ----------------------------------------------------------- typed shed
class TenantQuotaShedError(OverloadShedError):
    """A request was shed because ITS TENANT is over quota — not because
    the process as a whole is overloaded. Subclasses
    :class:`OverloadShedError` (same 503 mapping on the wire, same
    flight-recorder hook) and adds the quota evidence: which ``tenant``,
    its current ``usage`` against which ``quota``, and the shed
    ``reason`` (``tenant_inflight`` / ``tenant_queue`` /
    ``tenant_rate``)."""

    def __init__(self, *, tenant: str, reason: str, usage: float,
                 quota: float, queue_depth: int = 0, inflight: int = 0,
                 est_wait_s: float = 0.0, deadline_s: float | None = None,
                 diagnostics: dict | None = None,
                 trace_id: str | None = None):
        self.tenant = tenant
        self.usage = usage
        self.quota = quota
        super().__init__(
            reason=reason, queue_depth=queue_depth, inflight=inflight,
            est_wait_s=est_wait_s, deadline_s=deadline_s,
            diagnostics=diagnostics, trace_id=trace_id)
        # append the quota evidence to the inherited message so a raw
        # log line names the tenant without unpacking attributes
        self.args = (
            f"tenant {tenant!r} over quota ({reason}): usage "
            f"{usage:g} vs quota {quota:g}. " + self.args[0],)


# process-wide per-tenant shed ledger: the /readyz + /fleetz report
# surface (the registry metric carries the same counts as labels, but a
# JSON endpoint must not re-parse its own exposition to answer)
_SHED_LOCK = threading.Lock()
_SHED_COUNTS: dict[str, dict[str, int]] = {}


def _record_tenant_shed(tenant: str, reason: str) -> None:
    _M_TENANT_SHEDS.inc(1, tenant=tenant, reason=reason)
    with _SHED_LOCK:
        per = _SHED_COUNTS.setdefault(tenant, {})
        per[reason] = per.get(reason, 0) + 1


def tenant_shed_counts() -> dict[str, dict[str, int]]:
    """Per-tenant shed counts since process start ({tenant: {reason:
    n}}) — what ``/readyz`` and ``/fleetz`` report. Empty until a
    tenant sheds, so tenant-less callers see unchanged bodies."""
    with _SHED_LOCK:
        return {t: dict(r) for t, r in _SHED_COUNTS.items()}


def reset_tenant_sheds() -> None:
    """Tests/bench: forget the per-tenant shed ledger."""
    with _SHED_LOCK:
        _SHED_COUNTS.clear()


# ------------------------------------------------------------- the spec
@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's declared quota: relative ``weight`` (fair-share
    numerator), optional hard ``max_inflight`` cap (outranks the
    weighted share) and optional default ``deadline_s`` its requests
    carry when the caller scoped none."""

    name: str
    weight: int = 1
    max_inflight: int | None = None
    deadline_s: float | None = None


def parse_tenant_spec(spec: str) -> dict[str, TenantSpec]:
    """``OTPU_TENANT_SPEC`` grammar: ``;``-separated items, each
    ``name:weight=4[,max_inflight=8,deadline_s=0.5]``. A malformed item
    raises naming the item — an operator typo must fail loudly at state
    construction, not silently drop a tenant's quota (the
    ``parse_slo_spec`` convention)."""
    out: dict[str, TenantSpec] = {}
    for item in (spec or "").split(";"):
        item = item.strip()
        if not item:
            continue
        name, sep, params = item.partition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"tenant spec item {item!r}: want "
                "'name:weight=4[,max_inflight=8,deadline_s=0.5]'")
        weight = 1
        max_inflight = None
        deadline_s = None
        for kv in params.split(","):
            k, sep2, v = kv.partition("=")
            k = k.strip()
            if not sep2:
                raise ValueError(
                    f"tenant spec {name!r}: bad param {kv!r}")
            try:
                fv = float(v)
            except ValueError:
                raise ValueError(
                    f"tenant spec {name!r}: {k}={v!r} is not a number"
                ) from None
            if k == "weight":
                if fv < 1 or fv != int(fv):
                    raise ValueError(
                        f"tenant spec {name!r}: weight must be a "
                        "positive integer")
                weight = int(fv)
            elif k == "max_inflight":
                if fv < 1 or fv != int(fv):
                    raise ValueError(
                        f"tenant spec {name!r}: max_inflight must be a "
                        "positive integer")
                max_inflight = int(fv)
            elif k == "deadline_s":
                if fv <= 0:
                    raise ValueError(
                        f"tenant spec {name!r}: deadline_s must be > 0")
                deadline_s = fv
            else:
                raise ValueError(
                    f"tenant spec {name!r}: unknown param {k!r} (want "
                    "weight=, max_inflight= or deadline_s=)")
        out[name] = TenantSpec(name, weight, max_inflight, deadline_s)
    return out


# ---------------------------------------------------- weighted fairness
@dataclasses.dataclass
class _Tenant:
    """One tenant's live accounting (mutated only under the owning
    admission controller's condition variable)."""

    spec: TenantSpec
    inflight: int = 0
    waiting: int = 0
    granted: int = 0
    deficit: float = 0.0
    tokens: float = 0.0
    last_refill: float | None = None


class TenantFairShare:
    """Weighted-fair queuing state for one admission controller.

    NOT independently locked: every method is called with the owning
    ``AdmissionController``'s condition variable held (the controller's
    ``_acquire``/``slot`` already serialize there; a second lock here
    would only add an ordering hazard). Three mechanisms compose:

    * **token buckets** — capacity ``weight x burst``, refill ``weight x
      rate``/s on the injected clock; inert at rate 0. Bounds how far a
      tenant's admitted *rate* can run ahead of its share.
    * **share caps** — under cross-tenant contention (>= 2 live
      tenants) a tenant may hold at most ``ceil(max_inflight x w / W)``
      slots and park at most ``ceil(max_queue x w / W)`` waiters
      (``W`` = sum of live tenants' weights); an explicit
      ``max_inflight`` in the spec outranks the computed share and is
      enforced even without contention (the operator asked). Bounds
      *occupancy* — the queue ahead of a light tenant's request is its
      competitors' shares, not their backlogs.
    * **deficit round-robin** — freed slots are granted to the waiting
      tenant with the largest deficit (each replenish round adds
      ``weight`` to every waiting tenant; a grant costs 1), so grant
      *order* converges on the weight ratio even when caps alone would
      admit anyone.
    """

    def __init__(self, specs: dict[str, TenantSpec] | None = None, *,
                 clock=time.monotonic):
        from orange3_spark_tpu_torch.utils import knobs

        self.spec_raw = knobs.get_str("OTPU_TENANT_SPEC") \
            if specs is None else None
        self.specs = (parse_tenant_spec(self.spec_raw)
                      if specs is None else dict(specs))
        self.default_weight = max(
            1, int(knobs.get_int("OTPU_TENANT_DEFAULT_WEIGHT") or 1))
        self.rate = float(knobs.get_float("OTPU_TENANT_RATE") or 0.0)
        self.burst = max(1, int(knobs.get_int("OTPU_TENANT_BURST") or 1))
        self.clock = clock
        self._tenants: dict[str, _Tenant] = {}

    # ------------------------------------------------------------- state
    def _acct(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            spec = self.specs.get(name) or TenantSpec(
                name, weight=self.default_weight)
            t = self._tenants[name] = _Tenant(spec)
            if self.rate > 0:
                t.tokens = float(spec.weight * self.burst)
                t.last_refill = self.clock()
        return t

    def tenant_deadline_s(self, name: str) -> float | None:
        """The spec's default per-request deadline for this tenant
        (None = none declared)."""
        return self._acct(name).spec.deadline_s

    def _live(self) -> list[_Tenant]:
        """Tenants currently occupying anything (in flight or waiting)
        — the denominator of the weighted share."""
        return [t for t in self._tenants.values()
                if t.inflight > 0 or t.waiting > 0]

    def _refill(self, t: _Tenant) -> None:
        if self.rate <= 0:
            return
        now = self.clock()
        if t.last_refill is None:
            t.last_refill = now
            t.tokens = float(t.spec.weight * self.burst)
            return
        cap = float(t.spec.weight * self.burst)
        t.tokens = min(cap, t.tokens
                       + (now - t.last_refill) * self.rate * t.spec.weight)
        t.last_refill = now

    # -------------------------------------------------------- admission
    def try_admit(self, name: str, *, max_inflight: int,
                  max_queue: int) -> tuple[str, float, float] | None:
        """Quota check at admission entry (cv held). Returns None to
        proceed to the wait/grant path, or ``(reason, usage, quota)``
        when this tenant must shed typed RIGHT NOW."""
        t = self._acct(name)
        live = self._live()
        others = [x for x in live if x is not t]
        total_w = t.spec.weight + sum(x.spec.weight for x in others)
        # hard cap from the spec: enforced even without contention
        if t.spec.max_inflight is not None \
                and t.inflight >= t.spec.max_inflight:
            return ("tenant_inflight", float(t.inflight),
                    float(t.spec.max_inflight))
        if others:
            share_in = max(1, -(-max_inflight * t.spec.weight // total_w))
            if t.spec.max_inflight is None and t.inflight >= share_in:
                return ("tenant_inflight", float(t.inflight),
                        float(share_in))
            share_q = max(1, -(-max_queue * t.spec.weight // total_w))
            if t.waiting >= share_q:
                return ("tenant_queue", float(t.waiting), float(share_q))
        self._refill(t)
        if self.rate > 0 and t.tokens < 1.0:
            return ("tenant_rate", float(t.granted),
                    float(t.spec.weight * self.burst))
        return None

    def note_waiting(self, name: str, delta: int) -> None:
        self._acct(name).waiting += delta

    def may_grant(self, name: str) -> bool:
        """Deficit-round-robin grant gate (cv held): may THIS waiting
        tenant take the freed slot? True when it is the most-underserved
        waiting tenant (largest deficit; replenished by weight each
        round; ties break on name so tests pin exact orders)."""
        t = self._acct(name)
        waiting = [x for x in self._tenants.values() if x.waiting > 0]
        contenders = waiting if t in waiting else waiting + [t]
        if len(contenders) <= 1:
            return True
        if max(x.deficit for x in contenders) < 1.0:
            for x in contenders:
                x.deficit += float(x.spec.weight)
        head = max(contenders,
                   key=lambda x: (x.deficit, x.spec.weight, x.spec.name))
        return head is t

    def granted(self, name: str) -> None:
        t = self._acct(name)
        t.inflight += 1
        t.granted += 1
        t.deficit = max(0.0, t.deficit - 1.0)
        if self.rate > 0:
            self._refill(t)
            t.tokens = max(0.0, t.tokens - 1.0)
        _M_TENANT_INFLIGHT.set(t.inflight, tenant=name)
        _M_TENANT_GRANTS.inc(1, tenant=name)

    def release(self, name: str) -> None:
        t = self._acct(name)
        t.inflight = max(0, t.inflight - 1)
        _M_TENANT_INFLIGHT.set(t.inflight, tenant=name)

    # ---------------------------------------------------------- reporting
    def snapshot(self) -> dict[str, dict]:
        """The live fairness table ({tenant: {weight, inflight, waiting,
        granted, tokens, sheds}}) — /fleetz and fleet_top render it."""
        sheds = tenant_shed_counts()
        out: dict[str, dict] = {}
        for name, t in sorted(self._tenants.items()):
            out[name] = {
                "weight": t.spec.weight,
                "max_inflight": t.spec.max_inflight,
                "deadline_s": t.spec.deadline_s,
                "inflight": t.inflight,
                "waiting": t.waiting,
                "granted": t.granted,
                "tokens": round(t.tokens, 3) if self.rate > 0 else None,
                "sheds": sum(sheds.get(name, {}).values()),
            }
        return out
