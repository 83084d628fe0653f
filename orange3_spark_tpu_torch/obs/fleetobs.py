"""Fleet telemetry plane — the observability layer ABOVE the process.

The fleet (fleet/) turns one serving process into a supervised
multi-replica fleet,
but every telemetry surface stopped at the process boundary: each
replica serves its own ``/metrics``/``/healthz``, keeps its own span
ring and writes its own flight bundles, so an operator of the paper's
production shape (one accelerator, many users' canvases) has N disjoint
views and no fleet-level SLO. This module is the missing plane:

* :class:`FleetCollector` — scrapes every replica's ``/metrics`` (the
  fleet RPC port already serves it) on a deterministically-jittered
  cadence (``OTPU_FLEETOBS_SCRAPE_S``) into a router-side sample store;
  the fleet exposition re-exports every series with a ``replica=`` label
  plus computed aggregates (counters summed, gauges min/max'd,
  histograms bucket-merged) under ``replica="_fleet"`` — one valid
  Prometheus body for the whole fleet. A replica whose last successful
  scrape is older than ``OTPU_FLEETOBS_STALE_X`` scrape periods gets
  every series ``stale="1"``-flagged instead of silently frozen, and
  counts into the ``otpu_fleetobs_stale_replicas`` gauge. ``/fleetz``
  (obs/server.py, when a collector is attached) serves the JSON view.
* **Cross-process trace assembly** — replicas expose their span ring via
  ``GET /debug/spans?trace_id=`` (fleet/rpc.py); :func:`assemble_trace`
  stitches router- and replica-side spans (ids already propagate via the
  ``X-OTPU-Trace`` header) into ONE Chrome trace. Ring timestamps are
  process-local ``perf_counter_ns`` values, so every spans payload
  carries a wall/perf clock anchor and the assembler rebases onto the
  shared wall clock; each process keeps its own ``pid`` lane, and a
  synthesized ``xproc`` flow event links the router's ``serve`` span to
  the replica's dispatch across the process boundary.
* :class:`SLOEngine` — declarative specs (``OTPU_SLO_SPEC``: availability
  %, p99 latency bound) evaluated over sliding per-second windows with
  the SRE-workbook multi-window burn-rate rule: alert when the error
  budget burns ≥ threshold× in BOTH a long window and its 1/12 confirm
  window (fast rule = page, slow rule = ticket). Alerts are typed
  (:class:`SLOAlert`), land as ``slo_burn`` obs instants, tick
  ``otpu_slo_burn_total{slo=,rule=}`` / set
  ``otpu_slo_budget_remaining{slo=}``, can feed the rollout canary
  breaker (``Rollout(slo_engine=...)``) and trigger the fleet incident
  recorder.
* **Fleet incident bundles** — on an SLO alert (or any caller-named
  anomaly) :func:`auto_fleet_dump` pulls every live replica's
  ``/debug/flight`` plus the router's own bundle into one versioned
  ``fleet-*.json`` bundle (``fleet_flight_schema``), rate-limited like
  the single-process recorder and written through the same atomic
  tmp+rename path (obs/flight.py).
* :class:`FleetDigest` — the load-signal snapshot the autoscaler's
  autoscaler needs (per-replica queue depth, shed rate, in-flight,
  brownout level, plus the router's EWMA-p95), built each scrape and
  published on the supervisor hook (``ReplicaManager.publish_digest``)
  and any registered callback; ``tools/fleet_top.py`` renders it live.

Kill-switch: ``OTPU_FLEETOBS=0`` restores the plain fleet exactly — the
collector refuses to start, the router records no serve span and feeds
no SLO sample, and no fleet bundle is ever written.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import re
import threading
import time
import zlib

from orange3_spark_tpu_torch.obs.registry import (
    REGISTRY, _fmt_value, _label_str,
)
from orange3_spark_tpu_torch.utils import knobs

__all__ = [
    "FLEET_FLIGHT_SCHEMA_VERSION",
    "FleetCollector",
    "FleetDigest",
    "ReplicaLoad",
    "SLOAlert",
    "SLOEngine",
    "SLOSpec",
    "assemble_trace",
    "auto_fleet_dump",
    "collect_fleet_bundle",
    "fleetobs_enabled",
    "parse_prometheus",
    "parse_slo_spec",
]

FLEET_FLIGHT_SCHEMA_VERSION = 1
FLEETZ_SCHEMA_VERSION = 1

_M_SCRAPES = REGISTRY.counter(
    "otpu_fleetobs_scrapes_total",
    "fleet collector /metrics scrapes, by replica and outcome")
_M_STALE = REGISTRY.gauge(
    "otpu_fleetobs_stale_replicas",
    "replicas whose last successful scrape is older than the staleness "
    "budget (their fleet series are stale-flagged)")
_M_BURN = REGISTRY.counter(
    "otpu_slo_burn_total",
    "SLO burn-rate alerts fired, by slo and rule (fast=page, slow=ticket)")
_M_BUDGET = REGISTRY.gauge(
    "otpu_slo_budget_remaining",
    "fraction of the slow-window error budget left, per slo (1 = clean)")


def fleetobs_enabled() -> bool:
    """The fleet-telemetry kill-switch (read per call, the OTPU_DONATE
    convention): ``OTPU_FLEETOBS=0`` restores the plain fleet."""
    return knobs.get_bool("OTPU_FLEETOBS")


# ===================================================== prometheus parsing
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(.*)\})?'
    r'\s+(\S+)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape(s: str) -> str:
    # ONE left-to-right scan: sequential str.replace would let the 'n'
    # after a literal backslash ('C:\\new' escaped as 'C:\\\\new') be
    # misread as a \n escape and corrupt the label value
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), s)


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    return float(s)


def parse_prometheus(text: str) -> dict:
    """Parse text exposition format 0.0.4 (what ``to_prometheus`` on the
    other side of the scrape emits) into::

        {name: {"type": kind, "values": {label_key: float}}}          # or
        {name: {"type": "histogram",
                "values": {label_key: {"bounds": [...], "cum": [...],
                                       "sum": f, "count": n}}}}

    ``label_key`` is the registry's sorted ``((name, value), ...)`` tuple
    convention, so scraped samples and local registry snapshots compare
    directly. Histogram ``cum`` keeps the exposition's CUMULATIVE bucket
    counts (summing cumulative arrays across replicas stays cumulative —
    the merge the fleet aggregate needs)."""
    types: dict[str, str] = {}
    out: dict[str, dict] = {}
    hist_parts: dict[str, dict] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labels_s, value_s = m.group(1), m.group(2), m.group(3)
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(labels_s or "")}
        try:
            value = _parse_value(value_s)
        except ValueError:
            continue
        # histogram children ride as <base>_bucket/_sum/_count
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and types.get(name[:-len(suffix)]) \
                    == "histogram":
                base = name[:-len(suffix)]
                break
        if base is not None:
            le = labels.pop("le", None)
            key = tuple(sorted(labels.items()))
            h = hist_parts.setdefault(base, {}).setdefault(
                key, {"buckets": [], "sum": 0.0, "count": 0})
            if name.endswith("_bucket") and le is not None:
                h["buckets"].append((_parse_value(le), value))
            elif name.endswith("_sum"):
                h["sum"] = value
            else:
                h["count"] = int(value)
            continue
        key = tuple(sorted(labels.items()))
        metric = out.setdefault(
            name, {"type": types.get(name, "untyped"), "values": {}})
        metric["values"][key] = value
    for base, children in hist_parts.items():
        values = {}
        for key, h in children.items():
            bs = sorted(h["buckets"])
            values[key] = {
                "bounds": [b for b, _ in bs],
                "cum": [int(c) for _, c in bs],
                "sum": h["sum"], "count": h["count"],
            }
        out[base] = {"type": "histogram", "values": values}
    return out


# ============================================================= SLO engine
@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective: ``target`` is the good-request fraction
    (0..1); ``p99_ms`` switches the kind to latency — a completed request
    slower than the bound burns budget like a failure does."""

    name: str
    target: float                      # good fraction, e.g. 0.999
    p99_ms: float | None = None        # latency bound; None = availability

    @property
    def kind(self) -> str:
        return "latency" if self.p99_ms is not None else "availability"

    def good(self, ok: bool, latency_s: float | None) -> bool:
        if not ok:
            return False
        if self.p99_ms is not None:
            return latency_s is not None and latency_s * 1e3 <= self.p99_ms

        return True


def parse_slo_spec(spec: str) -> list[SLOSpec]:
    """``OTPU_SLO_SPEC`` grammar: ``;``-separated items, each
    ``name:key=val[,key=val...]`` with ``target=`` the good-percent
    (required) and ``p99_ms=`` the optional latency bound. Malformed
    items raise naming the item — an operator typo must fail loudly at
    engine construction, not silently drop an objective."""
    specs: list[SLOSpec] = []
    for item in (spec or "").split(";"):
        item = item.strip()
        if not item:
            continue
        name, sep, params = item.partition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(f"SLO spec item {item!r}: want "
                             "'name:target=99.9[,p99_ms=250]'")
        target = None
        p99_ms = None
        for kv in params.split(","):
            k, sep2, v = kv.partition("=")
            k = k.strip()
            if not sep2:
                raise ValueError(f"SLO spec {name!r}: bad param {kv!r}")
            try:
                fv = float(v)
            except ValueError:
                raise ValueError(
                    f"SLO spec {name!r}: {k}={v!r} is not a number"
                ) from None
            if k == "target":
                if not 0.0 < fv <= 100.0:
                    raise ValueError(
                        f"SLO spec {name!r}: target must be in (0, 100]")
                target = fv / 100.0
            elif k == "p99_ms":
                p99_ms = fv
            else:
                raise ValueError(f"SLO spec {name!r}: unknown param {k!r} "
                                 "(want target= or p99_ms=)")
        if target is None:
            raise ValueError(f"SLO spec {name!r}: target= is required")
        specs.append(SLOSpec(name, target, p99_ms))
    return specs


@dataclasses.dataclass(frozen=True)
class SLOAlert:
    """One burn-rate alert (the typed event): which objective, which
    rule (``fast`` = page, ``slow`` = ticket), the long/confirm-window
    burn rates that tripped it, and the budget left."""

    slo: str
    rule: str
    burn_long: float
    burn_short: float
    window_s: float
    budget_remaining: float
    at_wall: float


class SLOEngine:
    """Sliding-window multi-burn-rate evaluation over a shared request
    feed. ``record(ok, latency_s)`` is the one ingest point (the fleet
    router calls it per predict); per-second buckets hold (total, bad
    per spec) so a week-long window costs O(window) ints, not O(events).

    Burn rate over a window = (bad / total) / (1 - target): how many
    times faster than uniform the error budget is burning. A rule fires
    when burn ≥ threshold in BOTH its long window and the 1/12 confirm
    window (fast detection without single-blip pages — the Google SRE
    workbook shape). Alerts fire on the RISING edge per (slo, rule) and
    re-arm once both windows drop back under."""

    def __init__(self, specs: list[SLOSpec] | None = None, *,
                 fast_s: float | None = None, slow_s: float | None = None,
                 burn_fast: float | None = None,
                 burn_slow: float | None = None,
                 clock=time.monotonic):
        self.specs = list(specs) if specs is not None else parse_slo_spec(
            knobs.get_str("OTPU_SLO_SPEC"))
        self.fast_s = float(fast_s if fast_s is not None
                            else knobs.get_float("OTPU_SLO_WINDOW_FAST_S"))
        self.slow_s = float(slow_s if slow_s is not None
                            else knobs.get_float("OTPU_SLO_WINDOW_SLOW_S"))
        self.burn_fast = float(
            burn_fast if burn_fast is not None
            else knobs.get_float("OTPU_SLO_BURN_FAST"))
        self.burn_slow = float(
            burn_slow if burn_slow is not None
            else knobs.get_float("OTPU_SLO_BURN_SLOW"))
        self.clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[int, dict] = {}
        self._active: set[tuple[str, str]] = set()
        self._cbs: list = []
        self.alerts: list[SLOAlert] = []
        self.last_verdicts: list[dict] = []
        self._last_eval = -math.inf

    # ------------------------------------------------------------- ingest
    def on_alert(self, cb) -> None:
        """Register a rising-edge alert callback (the collector wires the
        fleet incident dump here; a rollout wires its canary breaker)."""
        self._cbs.append(cb)

    def record(self, ok: bool, latency_s: float | None = None) -> None:
        now = self.clock()
        sec = int(now)
        with self._lock:
            b = self._buckets.get(sec)
            if b is None:
                b = self._buckets[sec] = {
                    "total": 0, "bad": {s.name: 0 for s in self.specs}}
            b["total"] += 1
            for s in self.specs:
                if not s.good(ok, latency_s):
                    b["bad"][s.name] += 1
            due = now - self._last_eval >= max(
                min(1.0, self.fast_s / 12.0), 0.05)
        if due:
            self.evaluate()

    # --------------------------------------------------------- evaluation
    def _counts(self, name: str, window_s: float, now: float):
        lo = now - window_s
        bad = total = 0
        for sec, b in self._buckets.items():
            if lo < sec <= now:
                total += b["total"]
                bad += b["bad"].get(name, 0)
        return bad, total

    @staticmethod
    def _burn(bad: int, total: int, budget: float) -> float:
        if total == 0:
            return 0.0
        ratio = bad / total
        if budget <= 0.0:
            return math.inf if bad else 0.0
        return ratio / budget

    def evaluate(self) -> list[dict]:
        """One evaluation pass: per-spec verdict dicts (burn rates,
        budget, which rules are alerting), metric updates, and rising-
        edge alert dispatch. Returns (and stores) the verdicts."""
        from orange3_spark_tpu_torch.obs import trace

        now = self.clock()
        fired: list[SLOAlert] = []
        verdicts: list[dict] = []
        with self._lock:
            self._last_eval = now
            # prune past the slow window (+slack for the confirm reads)
            horizon = now - self.slow_s * 1.25 - 2
            for sec in [s for s in self._buckets if s < horizon]:
                del self._buckets[sec]
            for spec in self.specs:
                budget = 1.0 - spec.target
                rules = {}
                for rule, window_s, thresh in (
                        ("fast", self.fast_s, self.burn_fast),
                        ("slow", self.slow_s, self.burn_slow)):
                    short_s = max(window_s / 12.0, 1.0)
                    bl, tl = self._counts(spec.name, window_s, now)
                    bs, ts = self._counts(spec.name, short_s, now)
                    burn_long = self._burn(bl, tl, budget)
                    burn_short = self._burn(bs, ts, budget)
                    alerting = (burn_long >= thresh
                                and burn_short >= thresh)
                    rules[rule] = {
                        "window_s": window_s, "threshold": thresh,
                        "burn_long": burn_long, "burn_short": burn_short,
                        "alerting": alerting,
                    }
                bad_slow, total_slow = self._counts(
                    spec.name, self.slow_s, now)
                allowed = total_slow * budget
                if allowed > 0:
                    remaining = max(0.0, min(1.0, 1.0 - bad_slow / allowed))
                else:
                    remaining = 1.0 if bad_slow == 0 else 0.0
                verdicts.append({
                    "slo": spec.name, "kind": spec.kind,
                    "target": spec.target, "p99_ms": spec.p99_ms,
                    "rules": rules,
                    "budget_remaining": round(remaining, 6),
                    "window_events": total_slow,
                    "window_bad": bad_slow,
                    "alerting": any(r["alerting"] for r in rules.values()),
                })
                _M_BUDGET.set(remaining, slo=spec.name)
                for rule, r in rules.items():
                    key = (spec.name, rule)
                    if r["alerting"] and key not in self._active:
                        self._active.add(key)
                        _M_BURN.inc(1, slo=spec.name, rule=rule)
                        alert = SLOAlert(
                            slo=spec.name, rule=rule,
                            burn_long=r["burn_long"],
                            burn_short=r["burn_short"],
                            window_s=r["window_s"],
                            budget_remaining=remaining,
                            at_wall=time.time())
                        self.alerts.append(alert)
                        fired.append(alert)
                    elif not r["alerting"] and key in self._active:
                        self._active.discard(key)
            self.last_verdicts = verdicts
        for alert in fired:
            trace.instant("slo_burn", slo=alert.slo, rule=alert.rule,
                          burn=round(alert.burn_long, 3),
                          budget_remaining=round(
                              alert.budget_remaining, 4))
            for cb in list(self._cbs):
                try:
                    cb(alert)
                except Exception:  # noqa: BLE001 - alerting must not die
                    pass
        return verdicts

    def active_alerts(self) -> set[tuple[str, str]]:
        with self._lock:
            return set(self._active)


# ======================================================= fleet incident
_fleet_rate_lock = threading.Lock()
_last_fleet_dump = 0.0


def collect_fleet_bundle(reason: str, clients,
                         error: BaseException | None = None, *,
                         digest: dict | None = None,
                         slo: list | None = None, **extra) -> dict:
    """Assemble one fleet incident bundle: the router's OWN flight
    bundle plus every live replica's ``/debug/flight`` pull (a dead
    replica contributes its transport error, not silence). ``clients``
    is ``[(name, client), ...]`` (the collector's normalized list)."""
    import os

    from orange3_spark_tpu_torch.obs import flight

    replicas: dict[str, dict] = {}
    for name, client in clients:
        try:
            status, body = client.get_json("/debug/flight", timeout_s=10.0)
            # liveness = a schema-complete bundle came back; a replica
            # bundle carries its OWN "error" field (None on a manual
            # pull), so presence of that key is NOT a failed pull
            replicas[name] = (body if status == 200
                              and "flight_schema" in (body or {})
                              else {"pull_error": f"http_{status}"})
        except Exception as e:  # noqa: BLE001 - a dead replica is data
            replicas[name] = {"pull_error": f"{type(e).__name__}: {e}"}
    bundle = {
        "fleet_flight_schema": FLEET_FLIGHT_SCHEMA_VERSION,
        "written_at": time.time(),
        "pid": os.getpid(),
        "reason": reason,
        "error": ({"type": type(error).__name__, "message": str(error)}
                  if error is not None else None),
        "router": flight.collect_bundle(reason, error),
        "replicas": replicas,
        "live_replicas": sorted(n for n, b in replicas.items()
                                if "flight_schema" in b),
        "digest": digest,
        "slo": slo,
    }
    if extra:
        bundle["extra"] = extra
    return bundle


def auto_fleet_dump(reason: str, clients,
                    error: BaseException | None = None,
                    **kw) -> str | None:
    """Rate-limited fleet incident dump (the SLO-alert hook): never
    raises, shares ``OTPU_FLIGHT_RATE_S`` with the single-process
    recorder but keeps its OWN slot (a replica-local shed bundle must
    not silence the fleet-wide incident view, and vice versa). Writes a
    ``fleet-*.json`` bundle through obs/flight.py's atomic path."""
    global _last_fleet_dump
    try:
        from orange3_spark_tpu_torch.obs import flight

        if not fleetobs_enabled() or not flight.flight_enabled():
            return None
        min_gap = float(knobs.get_float("OTPU_FLIGHT_RATE_S"))
        now = time.monotonic()
        with _fleet_rate_lock:
            if _last_fleet_dump and now - _last_fleet_dump < min_gap:
                return None
            prev, _last_fleet_dump = _last_fleet_dump, now
        try:
            bundle = collect_fleet_bundle(reason, clients, error, **kw)
            return flight.dump(reason, error, bundle=bundle,
                               prefix="fleet")
        except Exception:  # noqa: BLE001 - best-effort evidence
            with _fleet_rate_lock:
                if _last_fleet_dump == now:
                    _last_fleet_dump = prev
            return None
    except Exception:  # noqa: BLE001 - never raise from an alert path
        return None


def reset_fleet_rate_limit() -> None:
    """Tests/drills: forget the last automatic fleet dump time."""
    global _last_fleet_dump
    with _fleet_rate_lock:
        _last_fleet_dump = 0.0


# ====================================================== trace assembly
def assemble_trace(trace_id: str, sources: list[tuple[str, dict]]) -> dict:
    """Stitch per-process spans payloads (``trace.spans_payload`` shape)
    into ONE Chrome trace object for ``trace_id``. Each source keeps its
    own ``pid`` lane (named via process_name metadata); timestamps are
    rebased onto the wall clock through each payload's anchor, so router
    and replica spans line up on one axis; a synthesized ``xproc`` flow
    event (``s`` in the router's ``serve`` span, ``f`` in the replica's
    dispatch) draws the cross-process arrow Perfetto renders. The result
    passes :func:`~orange3_spark_tpu_torch.obs.trace.validate_chrome_trace`."""
    trace_events: list[dict] = []
    # per-source best flow anchor: (is_router, pref, pid, tid, ts, dur)
    anchors: dict[str, dict] = {}
    for sname, payload in sources:
        pid = int(payload["pid"])
        anchor = payload["anchor"]
        off_ns = int(anchor["wall_ns"]) - int(anchor["perf_ns"])
        tid_map: dict[int, int] = {}
        for ev in payload["events"]:
            ph, name, t0_ns, dur_ns, ident, args, tid_, sid, par = ev
            if tid_ != trace_id:
                continue
            tid = tid_map.setdefault(ident, len(tid_map))
            ts_us = (int(t0_ns) + off_ns) / 1e3
            d: dict = {"name": name, "ph": ph, "cat": "otpu",
                       "pid": pid, "tid": tid, "ts": ts_us}
            a = dict(args) if args else {}
            if ph == "X":
                d["dur"] = dur_ns / 1e3
            elif ph == "i":
                d["s"] = "t"
            elif ph in ("s", "t", "f"):
                d["id"] = str(a.pop("id", "") or trace_id)
                d["bp"] = "e"
            a["trace_id"] = tid_
            if sid is not None:
                a["span_id"] = sid
            if par is not None:
                a["parent_id"] = par
            a["source"] = sname
            d["args"] = a
            trace_events.append(d)
            if ph == "X" and name in ("serve", "serve_dispatch"):
                best = anchors.get(sname)
                # prefer the innermost dispatch span on the replica side
                pref = 1 if name == "serve_dispatch" else 0
                if best is None or pref >= best["pref"]:
                    anchors[sname] = {
                        "pref": pref, "pid": pid, "tid": tid,
                        "ts": ts_us, "dur": dur_ns / 1e3, "name": name}
        trace_events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": sname}})
    # the cross-process flow link: router serve -> each replica dispatch
    router = anchors.get("router")
    if router is not None:
        for sname, a in anchors.items():
            if sname == "router" or a["pid"] == router["pid"]:
                continue
            mid = min(a["dur"], router["dur"]) / 2.0
            trace_events.append({
                "name": "xproc", "ph": "s", "cat": "otpu",
                "pid": router["pid"], "tid": router["tid"],
                "ts": router["ts"] + min(mid, router["dur"] / 2.0),
                "id": trace_id, "bp": "e",
                "args": {"trace_id": trace_id, "to": sname}})
            trace_events.append({
                "name": "xproc", "ph": "f", "cat": "otpu",
                "pid": a["pid"], "tid": a["tid"],
                "ts": a["ts"] + min(mid, a["dur"] / 2.0),
                "id": trace_id, "bp": "e",
                "args": {"trace_id": trace_id, "from": "router"}})
    trace_events.sort(key=lambda e: (e["ph"] == "M", e.get("ts", 0.0)))
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


# ============================================================== digest
@dataclasses.dataclass
class ReplicaLoad:
    """One replica's load signals as last scraped (None = never seen)."""

    replica: str
    up: bool
    stale: bool
    scrape_age_s: float | None
    inflight: float = 0.0
    queue_depth: float = 0.0
    shed_total: float = 0.0
    brownout_level: float = 0.0
    rpc_requests: float = 0.0
    router_inflight: int | None = None
    # goodput & memory attribution plane (obs/prof.py, scraped off the
    # replica's own gauges): per-stage wall fractions of its last fit
    # (None until one ran) and live device bytes per ledger owner —
    # tools/fleet_top.py renders both, the autoscaler reads
    # device_bytes as the capacity half of its load signal
    goodput: dict | None = None
    device_bytes: dict = dataclasses.field(default_factory=dict)
    # weighted-fair tenancy (serve/tenancy.py): this replica's typed
    # quota sheds, held slots and total grants per tenant — the fleet
    # view of who is over quota (tools/fleet_top.py renders the table)
    tenant_sheds: dict = dataclasses.field(default_factory=dict)
    tenant_inflight: dict = dataclasses.field(default_factory=dict)
    tenant_granted: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FleetDigest:
    """The load-signal surface the autoscaler consumes: one
    snapshot per collector tick, published on the supervisor hook."""

    at_wall: float
    scrape_s: float
    replicas: list[ReplicaLoad]
    ewma_p95_ms: float | None
    slo: list[dict]
    stale_replicas: int
    # data-plane fast path (fleet/fastwire.py): router-side connection
    # pool totals (reuse %), coalescer merge stats and SHM byte counts —
    # None when no router is attached or the fast wire never ran
    wire: dict | None = None
    # control plane (fleet/control.py): the active autoscaler's state()
    # block as of this tick — None when none is attached
    autoscaler: dict | None = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["replicas"] = [r.to_dict() if isinstance(r, ReplicaLoad) else r
                         for r in self.replicas]
        return d


@dataclasses.dataclass
class _Scrape:
    samples: dict
    at: float                 # collector clock of last SUCCESS
    at_wall: float
    scrapes: int = 0
    errors: int = 0
    last_error: str | None = None


def _values_total(parsed: dict, name: str) -> float:
    m = parsed.get(name)
    if not m or m["type"] == "histogram":
        return 0.0
    return float(sum(m["values"].values()))


def _values_by_label(parsed: dict, name: str, label: str) -> dict:
    """{label value: metric value} for one label dimension of one scraped
    metric (the per-owner/per-stage view of the prof-plane gauges)."""
    m = parsed.get(name)
    if not m or m["type"] == "histogram":
        return {}
    out: dict = {}
    for key, v in m["values"].items():
        for k, val in key:
            if k == label:
                out[val] = out.get(val, 0.0) + float(v)
    return out


# =========================================================== collector
#: per-process collector instance numbering: part of each collector's
#: jitter seed, so two collectors over the same endpoints decorrelate
_COLLECTOR_SEQ = itertools.count()


class FleetCollector:
    """See module docstring. ``endpoints`` accepts the supervisor's
    ``(id, host, port)`` tuples, router ``ReplicaEndpoint`` objects
    (their clients are reused) or anything with ``.name`` +
    ``get_text``/``get_json`` (test fakes)."""

    def __init__(self, endpoints, *, router=None, supervisor=None,
                 slo: SLOEngine | None = None,
                 scrape_s: float | None = None,
                 stale_x: float | None = None,
                 clock=time.monotonic):
        from orange3_spark_tpu_torch.fleet.rpc import FleetClient

        self.clients: list[tuple[str, object]] = []
        for ep in endpoints:
            if isinstance(ep, tuple):
                rid, host, port = ep
                name = f"replica-{rid}"
                self.clients.append(
                    (name, FleetClient(host, port, name=name)))
            elif hasattr(ep, "client"):
                self.clients.append((ep.name, ep.client))
            else:
                self.clients.append((ep.name, ep))
        self.router = router
        self.supervisor = supervisor
        self.slo = slo
        self.scrape_s = float(
            scrape_s if scrape_s is not None
            else knobs.get_float("OTPU_FLEETOBS_SCRAPE_S"))
        stale_x = float(stale_x if stale_x is not None
                        else knobs.get_float("OTPU_FLEETOBS_STALE_X"))
        self.stale_after_s = max(self.scrape_s * stale_x, self.scrape_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._scrapes: dict[str, _Scrape] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._ticks = 0
        ident = ("|".join(n for n, _ in self.clients)
                 + f"#{next(_COLLECTOR_SEQ)}")
        self._jitter_seed = zlib.crc32(ident.encode())
        self._digest_cbs: list = []
        self.last_incident_path: str | None = None
        self._incident_threads: list[threading.Thread] = []
        if slo is not None:
            slo.on_alert(self._on_alert)

    # ----------------------------------------------------------- control
    @property
    def active(self) -> bool:
        return self._thread is not None

    def on_digest(self, cb) -> None:
        self._digest_cbs.append(cb)

    def start(self) -> "FleetCollector":
        """Start the scrape loop; a no-op (no thread, no scrapes) under
        ``OTPU_FLEETOBS=0`` — the plain fleet exactly."""
        if not fleetobs_enabled() or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="otpu-fleetobs-scrape")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self) -> "FleetCollector":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 - scraping must never die
                pass
            # deterministic ±10% jitter (the crc32 seeding convention),
            # seeded per collector (endpoint set + instance number): two
            # collectors started together must NOT scrape in lockstep
            frac = zlib.crc32(
                f"fleetobs:{self._jitter_seed}:{self._ticks}".encode()) \
                / 0xFFFFFFFF
            self._stop.wait(self.scrape_s * (0.9 + 0.2 * frac))

    # ----------------------------------------------------------- scraping
    def scrape_once(self) -> FleetDigest:
        """One sweep: pull every replica's /metrics, refresh staleness,
        evaluate the SLO engine, build + publish the digest."""
        now = self.clock()
        for name, client in self.clients:
            try:
                status, text = client.get_text("/metrics", timeout_s=5.0)
                if status != 200:
                    raise RuntimeError(f"/metrics answered HTTP {status}")
                samples = parse_prometheus(text)
                with self._lock:
                    prev = self._scrapes.get(name)
                    self._scrapes[name] = _Scrape(
                        samples, at=now, at_wall=time.time(),
                        scrapes=(prev.scrapes if prev else 0) + 1,
                        errors=prev.errors if prev else 0)
                _M_SCRAPES.inc(1, replica=name, outcome="ok")
            except Exception as e:  # noqa: BLE001 - a dead replica is data
                with self._lock:
                    prev = self._scrapes.get(name)
                    if prev is not None:
                        prev.errors += 1
                        prev.last_error = f"{type(e).__name__}: {e}"
                    else:
                        self._scrapes[name] = _Scrape(
                            {}, at=-math.inf, at_wall=0.0, errors=1,
                            last_error=f"{type(e).__name__}: {e}")
                _M_SCRAPES.inc(1, replica=name, outcome="error")
        _M_STALE.set(len(self.stale_replicas()))
        if self.slo is not None:
            self.slo.evaluate()
        digest = self.digest()
        if self.supervisor is not None:
            try:
                self.supervisor.publish_digest(digest)
            except Exception:  # noqa: BLE001 - the hook is best-effort
                pass
        for cb in list(self._digest_cbs):
            try:
                cb(digest)
            except Exception:  # noqa: BLE001
                pass
        self._ticks += 1
        return digest

    def staleness(self) -> dict[str, float | None]:
        """Per-replica seconds since the last SUCCESSFUL scrape (None =
        never scraped successfully)."""
        now = self.clock()
        out: dict[str, float | None] = {}
        with self._lock:
            for name, _client in self.clients:
                sc = self._scrapes.get(name)
                out[name] = (None if sc is None or sc.at == -math.inf
                             else now - sc.at)
        return out

    def stale_replicas(self) -> list[str]:
        return sorted(n for n, age in self.staleness().items()
                      if age is None or age > self.stale_after_s)

    # --------------------------------------------------------- exposition
    def _sources(self, include_local: bool):
        """(name, parsed, stale, is_local) per source. The ROUTER process
        itself is one more source named ``router`` — so the fleet
        /metrics is one body with one TYPE line per metric, never a
        concatenation of two expositions fighting over the same names —
        but it is NOT a replica: its series ride re-labeled only and
        never fold into the ``_fleet`` aggregates (its registry holds a
        zero for every registered-but-untouched gauge, which would pin
        every ``_fleet`` minimum to 0)."""
        stale = set(self.stale_replicas())
        out = []
        if include_local:
            out.append(("router",
                        parse_prometheus(REGISTRY.to_prometheus()),
                        False, True))
        with self._lock:
            for name, _client in self.clients:
                sc = self._scrapes.get(name)
                if sc is not None and sc.samples:
                    out.append((name, sc.samples, name in stale, False))
        return out

    @staticmethod
    def _tagged(key: tuple, source: str, stale: bool) -> tuple:
        """Add the source label to a child's label key: ``replica=`` by
        convention; ``scraped_from=`` when the child already carries its
        own ``replica`` label (the router's per-replica gauges do)."""
        label = ("scraped_from" if any(k == "replica" for k, _ in key)
                 else "replica")
        tagged = list(key) + [(label, source)]
        if stale:
            tagged.append(("stale", "1"))
        return tuple(sorted(tagged))

    def to_prometheus(self, include_local: bool = True) -> str:
        """The fleet exposition: every source's series re-labeled with
        its replica, plus computed aggregates under ``replica="_fleet"``
        — aggregated over REPLICAS only (the router's own series ride
        re-labeled but never fold in): counters summed (stale replicas'
        last-known counts still count: counters are monotonic), gauges
        min/max over FRESH replicas only (a frozen gauge is not a load
        signal), histograms bucket-merged where bounds agree."""
        sources = self._sources(include_local)
        names: dict[str, str] = {}
        for _sname, parsed, _st, _loc in sources:
            for mname, m in parsed.items():
                names.setdefault(mname, m["type"])
        lines: list[str] = []
        for mname in sorted(names):
            mtype = names[mname]
            lines.append(f"# TYPE {mname} {mtype}")
            agg_counter: dict[tuple, float] = {}
            agg_gauge: dict[tuple, list[float]] = {}
            agg_hist: dict[tuple, dict] = {}
            for sname, parsed, st, local in sources:
                m = parsed.get(mname)
                if m is None or m["type"] != mtype:
                    continue
                for key, v in sorted(m["values"].items()):
                    tkey = self._tagged(key, sname, st)
                    if mtype == "histogram":
                        self._emit_hist(lines, mname, tkey, v)
                        if local:
                            continue
                        h = agg_hist.get(key)
                        if h is None:
                            agg_hist[key] = {
                                "bounds": list(v["bounds"]),
                                "cum": list(v["cum"]),
                                "sum": v["sum"], "count": v["count"]}
                        elif h["bounds"] == v["bounds"]:
                            h["cum"] = [a + b for a, b in
                                        zip(h["cum"], v["cum"])]
                            h["sum"] += v["sum"]
                            h["count"] += v["count"]
                        continue
                    lines.append(
                        f"{mname}{_label_str(tkey)} {_fmt_value(v)}")
                    if local:
                        continue
                    if mtype == "counter":
                        agg_counter[key] = agg_counter.get(key, 0.0) + v
                    elif mtype == "gauge" and not st:
                        agg_gauge.setdefault(key, []).append(v)
            for key, total in sorted(agg_counter.items()):
                fkey = self._tagged(key, "_fleet", False)
                lines.append(
                    f"{mname}{_label_str(fkey)} {_fmt_value(total)}")
            for key, vals in sorted(agg_gauge.items()):
                for agg, v in (("max", max(vals)), ("min", min(vals))):
                    fkey = tuple(sorted(
                        list(self._tagged(key, "_fleet", False))
                        + [("agg", agg)]))
                    lines.append(
                        f"{mname}{_label_str(fkey)} {_fmt_value(v)}")
            for key, h in sorted(agg_hist.items()):
                fkey = self._tagged(key, "_fleet", False)
                self._emit_hist(lines, mname, fkey, h)
        return "\n".join(lines) + "\n"

    @staticmethod
    def _emit_hist(lines: list, base: str, key: tuple, h: dict) -> None:
        for b, cum in zip(h["bounds"], h["cum"]):
            lk = tuple(sorted(list(key) + [("le", _fmt_value(b))]))
            lines.append(f"{base}_bucket{_label_str(lk)} {int(cum)}")
        lines.append(f"{base}_sum{_label_str(key)} "
                     f"{_fmt_value(h['sum'])}")
        lines.append(f"{base}_count{_label_str(key)} {int(h['count'])}")

    def fleetz(self) -> dict:
        """The JSON fleet view (``GET /fleetz`` on the router's obs
        server): per-replica scrape health, counter aggregates, the SLO
        verdicts and the current digest."""
        stale = set(self.stale_replicas())
        replicas: dict[str, dict] = {}
        aggregates: dict[str, float] = {}
        with self._lock:
            for name, _client in self.clients:
                sc = self._scrapes.get(name)
                age = (None if sc is None or sc.at == -math.inf
                       else self.clock() - sc.at)
                replicas[name] = {
                    "up": sc is not None and sc.at != -math.inf,
                    "stale": name in stale,
                    "scrape_age_s": (round(age, 3)
                                     if age is not None else None),
                    "scrapes": sc.scrapes if sc else 0,
                    "errors": sc.errors if sc else 0,
                    "last_error": sc.last_error if sc else None,
                }
                if sc is not None:
                    for mname, m in sc.samples.items():
                        if m["type"] == "counter":
                            aggregates[mname] = (
                                aggregates.get(mname, 0.0)
                                + sum(m["values"].values()))
        digest = self.digest()
        out = {
            "fleetz_schema": FLEETZ_SCHEMA_VERSION,
            "at": time.time(),
            "scrape_s": self.scrape_s,
            "stale_after_s": self.stale_after_s,
            "ticks": self._ticks,
            "replicas": replicas,
            "aggregates": {k: round(v, 6)
                           for k, v in sorted(aggregates.items())},
            "slo": (self.slo.last_verdicts
                    if self.slo is not None else []),
            "digest": digest.to_dict(),
            "last_incident_path": self.last_incident_path,
        }
        # control plane: present only when it has state, so a
        # tenant-less fixed-size fleet's body keeps the exact old keys.
        # Per-tenant sheds aggregate the replicas' scraped counters plus
        # THIS process's ledger (the router sheds caller-side too).
        from orange3_spark_tpu_torch.serve.tenancy import tenant_shed_counts

        tenants: dict[str, float] = {}
        for r in digest.replicas:
            for t, v in (r.tenant_sheds or {}).items():
                tenants[t] = tenants.get(t, 0.0) + float(v)
        for t, reasons in tenant_shed_counts().items():
            tenants[t] = tenants.get(t, 0.0) + float(sum(reasons.values()))
        if tenants:
            out["tenants"] = {"sheds": {t: round(v, 6) for t, v
                                        in sorted(tenants.items())}}
        if digest.autoscaler is not None:
            out["autoscaler"] = digest.autoscaler
        return out

    # -------------------------------------------------------------- digest
    def digest(self) -> FleetDigest:
        stale = set(self.stale_replicas())
        router_inflight: dict[str, int] = {}
        ewma_p95_ms = None
        if self.router is not None:
            try:
                for ep in self.router.endpoints:
                    router_inflight[ep.name] = ep.inflight
                ewma_p95_ms = round(
                    self.router.schedule.p_estimate_s() * 1e3, 3)
            except Exception:  # noqa: BLE001 - best-effort signals
                pass
        loads: list[ReplicaLoad] = []
        with self._lock:
            for name, _client in self.clients:
                sc = self._scrapes.get(name)
                up = sc is not None and sc.at != -math.inf
                age = (None if not up else self.clock() - sc.at)
                samples = sc.samples if sc else {}
                goodput = _values_by_label(
                    samples, "otpu_goodput_fraction", "stage")
                loads.append(ReplicaLoad(
                    replica=name, up=up, stale=name in stale,
                    scrape_age_s=(round(age, 3)
                                  if age is not None else None),
                    inflight=_values_total(samples, "otpu_serve_inflight"),
                    queue_depth=_values_total(
                        samples, "otpu_admission_queue_depth"),
                    shed_total=_values_total(samples, "otpu_shed_total"),
                    brownout_level=_values_total(
                        samples, "otpu_brownout_level"),
                    rpc_requests=_values_total(
                        samples, "otpu_fleet_rpc_requests_total"),
                    router_inflight=router_inflight.get(name),
                    goodput=goodput or None,
                    device_bytes=_values_by_label(
                        samples, "otpu_device_bytes", "owner"),
                    tenant_sheds=_values_by_label(
                        samples, "otpu_tenant_sheds_total", "tenant"),
                    tenant_inflight=_values_by_label(
                        samples, "otpu_tenant_inflight", "tenant"),
                    tenant_granted=_values_by_label(
                        samples, "otpu_tenant_granted_total", "tenant"),
                ))
        from orange3_spark_tpu_torch.fleet.control import active_autoscaler_state

        return FleetDigest(
            at_wall=time.time(), scrape_s=self.scrape_s, replicas=loads,
            ewma_p95_ms=ewma_p95_ms,
            slo=(self.slo.last_verdicts if self.slo is not None else []),
            stale_replicas=len(stale),
            wire=self._wire_stats(),
            autoscaler=active_autoscaler_state())

    def _wire_stats(self) -> dict | None:
        """Aggregate the fast-wire signals off the attached router:
        conn-pool reuse across its clients, coalescer merge factor, SHM
        bytes moved (best-effort — absent pieces just drop out)."""
        if self.router is None:
            return None
        wire: dict = {}
        try:
            opened = reused = stale_retries = 0
            for ep in self.router.endpoints:
                pool = getattr(ep.client, "pool", None)
                if pool is None:
                    continue
                s = pool.stats()
                opened += s["opened"]
                reused += s["reused"]
                stale_retries += s["stale_retries"]
            total = opened + reused
            wire["conn"] = {
                "opened": opened, "reused": reused,
                "stale_retries": stale_retries,
                "reuse_pct": round(100.0 * reused / total, 2)
                             if total else 0.0,
            }
        except Exception:  # noqa: BLE001 - best-effort signals
            pass
        try:
            co = getattr(self.router, "coalescer", None)
            if co is not None:
                wire["coalesce"] = co.stats()
        except Exception:  # noqa: BLE001 - best-effort signals
            pass
        try:
            from orange3_spark_tpu_torch.fleet import fastwire

            wire["shm"] = fastwire.shm_stats()
        except Exception:  # noqa: BLE001 - best-effort signals
            pass
        return wire or None

    # ------------------------------------------------------- trace assembly
    def assemble_trace(self, trace_id: str,
                       include_local: bool = True) -> dict:
        """Pull ``/debug/spans?trace_id=`` from every replica, join with
        the router's own ring, return the stitched Chrome trace (see
        :func:`assemble_trace`)."""
        from orange3_spark_tpu_torch.obs import trace

        sources: list[tuple[str, dict]] = []
        if include_local:
            sources.append(("router", trace.spans_payload(trace_id)))
        for name, client in self.clients:
            try:
                status, payload = client.get_json(
                    f"/debug/spans?trace_id={trace_id}", timeout_s=5.0)
            except Exception:  # noqa: BLE001 - a dead replica has no spans
                continue
            if status == 200 and payload.get("events") is not None:
                sources.append((name, payload))
        return assemble_trace(trace_id, sources)

    # -------------------------------------------------------------- alerts
    def _on_alert(self, alert: SLOAlert) -> None:
        """The SLO-alert hook: one rate-limited fleet incident bundle
        carrying every live replica's flight data — collected on a
        DEDICATED thread. Alerts rise inside ``SLOEngine.record``, i.e.
        on a serving caller's thread (the router's predict ``finally``),
        and a bundle pull is seconds of replica HTTP at exactly peak
        overload: blocking the unlucky request on it is the same stall
        the shed-dump hardening removed."""
        # prune finished dumps at append time (the _OPEN-stack
        # convention): a router alerting for weeks must not accumulate
        # dead Thread objects — nothing on the production path joins
        if len(self._incident_threads) > 8:
            self._incident_threads = [
                x for x in self._incident_threads if x.is_alive()]
        t = threading.Thread(
            target=self._dump_incident, args=(alert,), daemon=True,
            name="otpu-fleetobs-incident")
        self._incident_threads.append(t)
        t.start()

    def _dump_incident(self, alert: SLOAlert) -> None:
        try:
            path = auto_fleet_dump(
                f"slo_{alert.slo}_{alert.rule}", self.clients,
                digest=self.digest().to_dict(),
                slo=(self.slo.last_verdicts
                     if self.slo is not None else []),
                alert=dataclasses.asdict(alert))
            if path is not None:
                self.last_incident_path = path
        except Exception:  # noqa: BLE001 - incident IO must never leak
            pass

    def join_incident_dump(self, timeout_s: float = 15.0) -> None:
        """Block until every in-flight incident dump finishes (tests and
        a drill read ``last_incident_path`` deterministically). ALL
        spawned threads are joined, not just the newest: the rate-limit
        slot belongs to whichever alert arrived first, so the thread
        still writing may well be an older one."""
        deadline = time.monotonic() + timeout_s
        for t in list(self._incident_threads):
            t.join(max(0.0, deadline - time.monotonic()))
        self._incident_threads = [
            t for t in self._incident_threads if t.is_alive()]
