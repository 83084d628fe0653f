"""The port's fleet telemetry (``obs/fleetobs.py``), autoscaler
(``fleet/control.py``) and the obs server's fleet side against the JAX
package's.

The same inputs, made from a numpy seed, go through both packages:
Prometheus texts through ``parse_prometheus``; one feed of good and bad
requests through ``SLOEngine`` on a fake clock; scripted replica
expositions through ``FleetCollector`` (digest, ``/fleetz`` view, fleet
exposition); span payloads through ``assemble_trace``; one digest
sequence through ``Autoscaler`` on a fake clock. Everything is compared
exactly (the plane parses, sums counters in the same order and decides;
it rounds nothing differently), times of day excepted.
"""

from __future__ import annotations

import json
import types
import urllib.request

import numpy as np
import pytest

import orange3_spark_tpu.fleet.control as j_control
import orange3_spark_tpu.obs.fleetobs as j_fobs
import orange3_spark_tpu.obs.registry as j_reg
import orange3_spark_tpu_torch.fleet.control as t_control
import orange3_spark_tpu_torch.obs.fleetobs as t_fobs
import orange3_spark_tpu_torch.obs.registry as t_reg

from _torch_artifacts import artifact_dirs  # noqa: F401


def _exposition(reg_mod, seed: int) -> str:
    """A registry exposition with counters, gauges and a histogram whose
    values come from a numpy seed (label values with quotes and escapes)."""
    rng = np.random.default_rng(seed)
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("otpu_fleet_rpc_requests_total", 'rpc "requests"')
    c.inc(int(rng.integers(1, 100)))
    c.inc(int(rng.integers(1, 100)), path='/a"b\\c', verb="GET")
    reg.counter("otpu_shed_total", "sheds").inc(int(rng.integers(0, 5)), reason="queue_full")
    reg.gauge("otpu_serve_inflight", "inflight").set(float(rng.integers(0, 9)))
    reg.gauge("otpu_brownout_level", "brownout").set(float(rng.integers(0, 3)))
    reg.gauge("otpu_admission_queue_depth", "depth").set(float(rng.integers(0, 6)))
    h = reg.histogram("otpu_timed_seconds", "timed", buckets=(0.01, 0.1, 1.0))
    for v in rng.lognormal(-3, 1.5, 20):
        h.observe(float(v), label="x")
    return reg.to_prometheus()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_prometheus_equals_the_reference(seed):
    """Both packages' registries print the same text from the same calls,
    and each parser reads either text to the same structure."""
    jt, tt = _exposition(j_reg, seed), _exposition(t_reg, seed)
    assert jt == tt
    want = j_fobs.parse_prometheus(jt)
    assert t_fobs.parse_prometheus(tt) == want
    assert want["otpu_timed_seconds"]["values"][(("label", "x"),)]["count"] == 20


def test_slo_alerts_equal_the_reference():
    """One seeded feed of good/bad requests and latencies on a fake clock:
    the same verdicts after every block, the same alerts (rule, burn)."""
    rng = np.random.default_rng(4)
    spec = "avail:target=99.0;lat:target=95.0,p99_ms=50"
    clk = [1000.0]
    engines = [m.SLOEngine(m.parse_slo_spec(spec), fast_s=60.0, slow_s=600.0,
                           burn_fast=10.0, burn_slow=3.0, clock=lambda: clk[0])
               for m in (j_fobs, t_fobs)]
    verdicts = ([], [])
    for block in range(12):
        bad_rate = 0.3 if block in (3, 4, 8) else 0.002
        ok = rng.random(50) >= bad_rate
        lat = rng.lognormal(-3.5, 0.8, 50)
        for eng in engines:
            for o, dt in zip(ok, lat):
                eng.record(bool(o), float(dt))
        for eng, out in zip(engines, verdicts):
            out.append(eng.evaluate())
        clk[0] += 7.0
    assert verdicts[1] == verdicts[0]
    ja, ta = ([(a.slo, a.rule, a.burn_long, a.burn_short) for a in e.alerts]
              for e in engines)
    assert ta == ja and len(ta) >= 1


class _ScrapeClient:
    def __init__(self, name, text):
        self.name, self.text = name, text

    def get_text(self, path, timeout_s=None):
        assert path == "/metrics"
        return 200, self.text

    def get_json(self, path, timeout_s=None):
        return 404, {}


def _without_times(d):
    if isinstance(d, dict):
        return {k: _without_times(v) for k, v in d.items()
                if k not in ("at", "at_wall", "scrape_age_s")}
    if isinstance(d, list):
        return [_without_times(v) for v in d]
    return d


def test_fleet_collector_digest_equals_the_reference():
    """Three scripted replicas (one exposition each, from its seed): the
    digest, the ``/fleetz`` view and the fleet exposition of the replicas
    are the reference's, times of day aside."""
    texts = [_exposition(j_reg, 10 + i) for i in range(3)]
    clk = [500.0]
    out = []
    for m in (j_fobs, t_fobs):
        col = m.FleetCollector([_ScrapeClient(f"replica-{i}", t) for i, t in enumerate(texts)],
                               scrape_s=10.0, clock=lambda: clk[0])
        digest = col.scrape_once()
        # the exposition without this process's own registry (each
        # package's differs): the replicas' series and the aggregates
        out.append((_without_times(digest.to_dict()), _without_times(col.fleetz()),
                    col.to_prometheus(include_local=False)))
    assert out[1][0] == out[0][0]
    assert out[1][1] == out[0][1]
    assert out[1][2] == out[0][2]
    agg = out[1][1]["aggregates"]["otpu_fleet_rpc_requests_total"]
    assert agg == sum(t_fobs.parse_prometheus(t)["otpu_fleet_rpc_requests_total"]["values"][()]
                      + t_fobs.parse_prometheus(t)["otpu_fleet_rpc_requests_total"]["values"][
                          (("path", '/a"b\\c'), ("verb", "GET"))] for t in texts)


def test_assemble_trace_equals_the_reference():
    """Two synthetic span payloads (a router with one perf-clock origin, a
    replica with another) assemble into the same Chrome trace, flows and
    lanes included."""
    tid = "fleet-cafe-123"
    router = {"pid": 4242, "anchor": {"wall_ns": 1_700_000_000_000_000_000, "perf_ns": 5_000},
              "events": [["X", "serve", 10_000, 8_000_000, 1, {"kind": "fleet"}, tid, 11, None]],
              "open_spans": []}
    replica = {"pid": 999, "anchor": {"wall_ns": 1_700_000_000_001_000_000, "perf_ns": 0},
               "events": [["X", "serve", 1_000_000, 4_000_000, 1, {"kind": "array"}, tid, 71, None],
                          ["X", "serve_dispatch", 2_000_000, 1_000_000, 1, None, tid, 72, 71]],
               "open_spans": []}
    parts = [("router", router), ("replica-0", replica)]
    want = j_fobs.assemble_trace(tid, parts)
    got = t_fobs.assemble_trace(tid, parts)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert sorted(e["ph"] for e in got["traceEvents"] if e["name"] == "xproc") == ["f", "s"]


class _Handle:
    def __init__(self, rid):
        self.replica_id, self.port = rid, 42000 + rid


class _FakeSupervisor:
    def __init__(self, n=1):
        self.handles = [_Handle(i) for i in range(n)]
        self._next = n

    def add_replica(self):
        rid, self._next = self._next, self._next + 1
        self.handles.append(_Handle(rid))
        return rid

    def remove_replica(self, rid):
        self.handles = [h for h in self.handles if h.replica_id != rid]

    def _handle(self, rid):
        return next(h for h in self.handles if h.replica_id == rid)


class _FakeRouter:
    def __init__(self):
        self.table, self.events = {}, []

    def add_endpoint(self, rid, host, port):
        self.table[rid] = types.SimpleNamespace(
            replica_id=rid, client=types.SimpleNamespace(close=lambda: None))
        self.events.append(("add", rid))

    def remove_endpoint(self, rid):
        self.events.append(("remove", rid))
        return self.table.pop(rid)


def test_autoscaler_decisions_equal_the_reference(monkeypatch):
    """One seeded digest sequence (load bursts, sheds, brownout, stale and
    down replicas) on a fake clock: the same decision at every step, the
    same supervisor and router moves, the same final state."""
    for k in ("OTPU_AUTOSCALE", "OTPU_AUTOSCALE_MIN", "OTPU_AUTOSCALE_MAX",
              "OTPU_AUTOSCALE_UP_X", "OTPU_AUTOSCALE_DOWN_X", "OTPU_AUTOSCALE_COOLDOWN_S"):
        monkeypatch.delenv(k, raising=False)
    runs = []
    for mod in (j_control, t_control):
        sup, router, clk = _FakeSupervisor(1), _FakeRouter(), [0.0]
        sc = mod.Autoscaler(sup, router, min_replicas=1, max_replicas=4, up_x=2.0,
                            down_x=0.5, cooldown_s=3.0, clock=lambda: clk[0])
        r = np.random.default_rng(8)
        steps, sheds = [], 0
        for i in range(60):
            hot = (i // 12) % 2 == 0
            sheds += int(r.random() < (0.2 if hot else 0.0))
            digest = {"replicas": {
                f"replica-{h.replica_id}": {
                    "up": bool(r.random() > 0.05), "stale": bool(r.random() < 0.05),
                    "queue_depth": int(r.integers(0, 8 if hot else 1)),
                    "inflight": int(r.integers(0, 4 if hot else 1)),
                    "shed_total": sheds if j == 0 else 0,
                    "brownout_level": int(hot and r.random() < 0.1)}
                for j, h in enumerate(sup.handles)}}
            d = sc.step(digest)
            steps.append(None if d is None else d.to_dict())
            clk[0] += float(r.uniform(0.5, 2.0))
        runs.append((steps, [h.replica_id for h in sup.handles], router.events, sc.state()))
    assert runs[1] == runs[0]
    assert any(s is not None for s in runs[1][0])


def test_obs_server_serves_the_fleet_side(monkeypatch):
    """``TelemetryServer(fleet=collector)``: ``/metrics`` is the fleet
    exposition and ``/fleetz`` the collector's view (404 without one);
    ``/readyz`` carries the active autoscaler's state."""
    from orange3_spark_tpu_torch.obs.server import TelemetryServer, ready_body

    col = t_fobs.FleetCollector([_ScrapeClient("replica-0", _exposition(t_reg, 3))],
                                scrape_s=10.0)
    col.scrape_once()
    srv = TelemetryServer(port=0, fleet=col).start()
    bare = TelemetryServer(port=0).start()
    try:
        def get(url):
            try:
                with urllib.request.urlopen(url, timeout=10) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, ""

        status, text = get(srv.url + "/metrics")
        assert status == 200 and text == col.to_prometheus()
        assert 'replica="_fleet"' in text
        status, body = get(srv.url + "/fleetz")
        view = json.loads(body)
        assert status == 200 and set(view["replicas"]) == {"replica-0"}
        assert view["aggregates"] == col.fleetz()["aggregates"]
        assert get(bare.url + "/fleetz")[0] == 404
    finally:
        srv.stop()
        bare.stop()
    sc = t_control.Autoscaler(_FakeSupervisor(1), None, min_replicas=1, max_replicas=2,
                              up_x=2.0, down_x=0.5, cooldown_s=1.0)
    t_control.set_active_autoscaler(sc)
    try:
        assert ready_body(None)[0]["autoscaler"] == sc.state()
    finally:
        t_control.set_active_autoscaler(None)
    assert "autoscaler" not in ready_body(None)[0]
