"""The port's flight recorder (``obs/flight.py``), telemetry endpoint
(``obs/server.py``), knob table and ``timed`` held to the JAX package's:
a bundle's keys equal the reference's and the reference's stdlib
``tools/flight_view.py`` renders a port bundle; ``auto_dump``'s rate limit
(a fake clock, no sleeps), its kill-switches, retention and its refusal to
raise; every endpoint's status code and body over an ephemeral port, the
readiness flags, and no bind under ``OTPU_OBS=0``; ``knob_table_md`` rows
equal the reference's for the knobs the port holds.
"""

import json
import logging
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.obs.flight as j_flight
import orange3_spark_tpu.obs.server as j_server
import orange3_spark_tpu.utils.knobs as j_knobs
import orange3_spark_tpu_torch.obs.flight as t_flight
import orange3_spark_tpu_torch.obs.prof as t_prof
import orange3_spark_tpu_torch.obs.server as t_server
import orange3_spark_tpu_torch.utils.knobs as t_knobs
from orange3_spark_tpu_torch import TorchSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def obs_env(tmp_path, monkeypatch):
    """Bundles and captures under ``tmp_path``, default switches, fresh
    rate windows and readiness flags."""
    for k in ("OTPU_OBS", "OTPU_FLIGHT", "OTPU_FLIGHT_MAX", "OTPU_FLIGHT_RATE_S",
              "OTPU_OBS_PORT", "OTPU_PROF", "OTPU_OBS_STALE_S", "OTPU_PROF_RATE_S"):
        monkeypatch.delenv(k, raising=False)
    for mod in (t_flight, j_flight, t_prof):
        mod.reset_rate_limit()
    t_server.reset_readiness()
    yield tmp_path
    t_server.reset_readiness()
    t_prof.reset_rate_limit()


def _bundles(d):
    return sorted(p for p in os.listdir(d) if p.startswith("flight-")) if os.path.isdir(d) else []


# ------------------------------------------------------------- the knobs
# three of the reference's help texts name the reference's own pull
# requests; the port's program text names none, so these three rows hold
# the port's own text, and every other row is the reference's exactly
OWN_DOCS = {
    "OTPU_FLEET_FASTWIRE": (
        "Fleet data-plane fast-path kill-switch; 0 = the wire bitwise (one "
        "fresh TCP connection + npy body per request, no pooling, no SHM, "
        "no cross-caller coalescing)."),
    "OTPU_AUTOSCALE": (
        "Digest-driven elastic autoscaling kill-switch; 0 = no Autoscaler "
        "ever scales (the fixed-size fleet, bitwise)."),
    "OTPU_FLEETOBS": (
        "Fleet telemetry-plane kill-switch; 0 restores the plain fleet "
        "exactly (no collector scrapes, no router serve spans, no SLO "
        "samples, no fleet bundles)."),
}


def test_knob_table_rows_equal_the_reference():
    """``knob_table_md`` renders each knob the port holds exactly as the
    reference renders it, but for the three rows of ``OWN_DOCS``, which
    equal the reference's row with that effect text in place of its own;
    ``resolved`` types every value as the getters."""
    ref_rows = {ln.split("|")[1].strip(): ln for ln in j_knobs.knob_table_md().splitlines()[2:]}
    for name, doc in OWN_DOCS.items():
        row = ref_rows[f"`{name}`"]
        ref_rows[f"`{name}`"] = row.replace(f"| {j_knobs.KNOBS[name].doc} |", f"| {doc} |")
        assert ref_rows[f"`{name}`"] != row
    rows = t_knobs.knob_table_md().splitlines()
    assert rows[:2] == j_knobs.knob_table_md().splitlines()[:2]
    for ln in rows[2:]:
        assert ln == ref_rows[ln.split("|")[1].strip()]
    assert len(rows) - 2 == len(t_knobs.KNOBS) == 87
    res = t_knobs.resolved()
    ref = j_knobs.resolved()
    assert set(res) == set(t_knobs.KNOBS)
    assert all(res[k] == ref[k] for k in res)


# ---------------------------------------------------- the flight recorder
def _forget_tenant_sheds():
    """Both packages' process-wide tenant shed ledgers emptied: the bundle
    and the readiness body carry a ``tenants`` key once a tenant was shed,
    and an earlier test file in this process may have shed one in one
    package only."""
    from orange3_spark_tpu.serve import tenancy as j_tenancy
    from orange3_spark_tpu_torch.serve import tenancy as t_tenancy

    for tenancy in (j_tenancy, t_tenancy):
        tenancy.reset_tenant_sheds()


def _forget_ledger_entries():
    """Both packages' process-wide device-memory ledgers emptied (as
    tests/test_torch_prof.py does around each of its tests): a snapshot
    past 64 entries adds ``entries_truncated``, and earlier test files in
    this process may have left entries in one package only."""
    import gc

    import orange3_spark_tpu.obs.prof as j_prof

    gc.collect()
    for mod in (t_prof, j_prof):
        mod.LEDGER.clear()


def test_bundle_keys_equal_the_reference():
    """Schema 1: the top-level keys of a bundle (no serving context), and
    of its device-memory section, equal the reference's; the events are
    Chrome-ish dicts of the same fields."""
    from orange3_spark_tpu.obs import trace as j_trace
    from orange3_spark_tpu_torch.obs import trace as t_trace

    _forget_tenant_sheds()
    _forget_ledger_entries()
    with t_trace.span("flight_keys_t"):
        t = t_flight.collect_bundle("keys", RuntimeError("x"), note=1)
    with j_trace.span("flight_keys_j"):
        j = j_flight.collect_bundle("keys", RuntimeError("x"), note=1)
    assert set(t) == set(j)
    assert t["flight_schema"] == j["flight_schema"] == 1
    assert set(t["device_memory"]) == set(j["device_memory"])
    assert t["error"] == j["error"] == {"type": "RuntimeError", "message": "x"}
    assert t["extra"] == {"note": 1}
    assert {"flight_keys_t"} <= {s["name"] for s in t["open_spans"]}
    ev_keys = {k for e in t["events"] for k in e}
    assert ev_keys <= {k for e in j["events"] for k in e} | {"dur_us", "args", "trace_id",
                                                             "span_id", "parent_id"}
    assert t["knobs"] == t_knobs.resolved()


def test_flight_view_renders_a_port_bundle(tmp_path):
    """The reference's stdlib ``tools/flight_view.py`` renders a bundle this
    package wrote (a subprocess; ``--latest`` finds it in the directory)."""
    t_prof.LEDGER.set("model_state", "flight-view-test", 4096)
    try:
        path = t_flight.dump("view_test", ValueError("rendered"))
    finally:
        t_prof.LEDGER.release("model_state", "flight-view-test")
    assert path and os.path.isfile(path)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "flight_view.py"),
                          "--latest"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "view_test" in out.stdout and "ValueError" in out.stdout
    assert "model_state" in out.stdout        # the ledger table


def test_auto_dump_rate_limit_on_a_fake_clock(monkeypatch, tmp_path):
    """One automatic bundle per ``OTPU_FLIGHT_RATE_S`` window; a manual
    ``dump`` is never limited; a failed write hands the slot back."""
    clock = [100.0]
    monkeypatch.setattr(t_flight.time, "monotonic", lambda: clock[0])
    fdir = str(tmp_path / "flight")
    assert t_flight.auto_dump("a1", RuntimeError("1")) is not None
    clock[0] += 59.0
    assert t_flight.auto_dump("a2") is None
    assert t_flight.dump("manual") is not None
    clock[0] += 2.0
    assert t_flight.auto_dump("a3") is not None
    assert [n.rsplit("-", 1)[1] for n in _bundles(fdir)] == ["a1.json", "manual.json",
                                                             "a3.json"]
    assert t_flight.bundles_written() >= 3
    # an unwritable directory: never raises, and the slot is handed back
    clock[0] += 61.0
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("OTPU_FLIGHT_DIR", str(blocker / "sub"))
    assert t_flight.auto_dump("a4") is None
    monkeypatch.setenv("OTPU_FLIGHT_DIR", fdir)
    assert t_flight.auto_dump("a5") is not None


@pytest.mark.parametrize("switch", ["OTPU_FLIGHT", "OTPU_OBS"])
def test_kill_switches_write_nothing(monkeypatch, tmp_path, switch):
    monkeypatch.setenv(switch, "0")
    assert t_flight.auto_dump("off") is None
    assert t_flight.dump("off") is None
    assert _bundles(str(tmp_path / "flight")) == []


def test_retention_keeps_the_newest(monkeypatch, tmp_path):
    monkeypatch.setenv("OTPU_FLIGHT_MAX", "3")
    for i in range(5):
        t_flight.dump(f"r{i}")
    names = _bundles(str(tmp_path / "flight"))
    assert [n.rsplit("-", 1)[1] for n in names] == ["r2.json", "r3.json", "r4.json"]


# --------------------------------------------------------- the endpoint
def _get(url, method="GET"):
    req = urllib.request.Request(url, method=method, data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _hashed_model():
    from orange3_spark_tpu_torch.io.streaming import array_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator

    rng = np.random.default_rng(2)
    X = np.concatenate([rng.standard_normal((1024, 4)).astype(np.float32),
                        rng.integers(0, 100, (1024, 4)).astype(np.float32)], axis=1)
    y = (rng.random(1024) < 0.3).astype(np.float32)
    model = StreamingHashedLinearEstimator(
        n_dims=1 << 10, n_dense=4, n_cat=4, epochs=1, step_size=0.05,
        chunk_rows=512).fit_stream(array_chunk_source(X, y, chunk_rows=512),
                                   session=TorchSession("cpu"))
    return model, X


def test_endpoints_of_a_serving_window(monkeypatch):
    """``OTPU_OBS_PORT=0`` binds an ephemeral loopback port when a
    ServingContext activates and unbinds on its last exit. /readyz is 503
    (warmup_pending) until ``warmup``, 200 after, 503 (draining) under the
    drain flag; /healthz carries the sheds and the brownout level;
    /metrics is the registry's exposition; /debug/flight writes and returns
    a bundle; /debug/stacks, /debug/spans answer; an unknown route is 404;
    ``POST /debug/profile`` answers 200 with the capture, then 429 inside
    the rate window, 409 while a capture runs, 503 under ``OTPU_PROF=0``,
    400 on a bad duration."""
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

    monkeypatch.setenv("OTPU_OBS_PORT", "0")
    model, X = _hashed_model()
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=256)) as ctx:
        url = ctx._telemetry.url
        assert url.startswith("http://127.0.0.1:") and ctx.report()["telemetry_url"] == url
        code, body = _get(url + "/readyz")
        assert code == 503 and json.loads(body)["reason"] == "warmup_pending"
        ctx.warmup(model, n_cols=8)
        code, body = _get(url + "/readyz")
        assert code == 200 and json.loads(body)["ready"] is True
        model.predict(X[:100])
        code, body = _get(url + "/healthz")
        hz = json.loads(body)
        assert code == 200 and hz["status"] == "ok"
        assert set(hz) == {"status", "last_beat_age_s", "stale_after_s", "in_flight",
                           "wedges", "retries", "crc_failures", "dispatches",
                           "mb_queue_depth", "sheds", "brownout_level"}
        code, body = _get(url + "/metrics")
        assert code == 200 and b"otpu_shed_total" in body
        code, body = _get(url + "/debug/flight")
        b = json.loads(body)
        assert code == 200 and b["reason"] == "debug_endpoint" and os.path.isfile(b["path"])
        assert _get(url + "/debug/stacks")[0] == 200
        assert json.loads(_get(url + "/debug/spans")[1]) is not None
        assert _get(url + "/nope")[0] == 404
        code, body = _get(url + "/debug/profile?duration_ms=5", "POST")
        cap = json.loads(body)
        assert code == 200 and os.path.isdir(cap["path"]) and cap["duration_ms"] == 5.0
        assert _get(url + "/debug/profile?duration_ms=5", "POST")[0] == 429
        t_prof.reset_rate_limit()
        with t_prof._capture_lock:
            assert _get(url + "/debug/profile?duration_ms=5", "POST")[0] == 409
        assert _get(url + "/debug/profile?duration_ms=abc", "POST")[0] == 400
        monkeypatch.setenv("OTPU_PROF", "0")
        assert _get(url + "/debug/profile", "POST")[0] == 503
        t_server.set_draining(True)
        code, body = _get(url + "/readyz")
        assert code == 503 and json.loads(body)["reason"] == "draining"
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=5)


def test_never_binds_under_the_obs_kill_switch(monkeypatch):
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

    monkeypatch.setenv("OTPU_OBS_PORT", "0")
    monkeypatch.setenv("OTPU_OBS", "0")
    assert t_server.maybe_start_from_env() is None
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=256)) as ctx:
        assert ctx._telemetry is None and ctx.report()["telemetry_url"] is None
    monkeypatch.delenv("OTPU_OBS")
    monkeypatch.setenv("OTPU_OBS_PORT", "not-a-port")
    assert t_server.maybe_start_from_env() is None


def test_readiness_and_health_bodies_equal_the_reference():
    """With no serving context in either package, ``ready_body`` gives the
    same body in each readiness state, and ``health()`` the same keys."""
    _forget_tenant_sheds()
    for mod in (t_server, j_server):
        mod.reset_readiness()
    states = []
    for warm, drain in ((False, False), (True, False), (True, True)):
        for mod in (t_server, j_server):
            mod.note_warmup_complete(warm)
            mod.set_draining(drain)
        states.append((t_server.ready_body(), j_server.ready_body()))
    for mod in (t_server, j_server):
        mod.reset_readiness()
    assert all(t == j for t, j in states)
    assert set(t_server.TelemetryServer().health()[0]) == set(
        j_server.TelemetryServer().health()[0])


def test_timed_logs_the_reference_line(caplog):
    """``timed``: the reference's log line (label, seconds, rows/s when an
    argument has ``n_rows``), a ``timed:`` span, the histogram."""
    from orange3_spark_tpu_torch.obs.registry import REGISTRY
    from orange3_spark_tpu_torch.utils.profiling import timed

    class Table:
        n_rows = 1000

    @timed(name="obs_timed_test")
    def work(t):
        return 7

    with caplog.at_level(logging.INFO, logger="orange3_spark_tpu_torch"):
        assert work(Table()) == 7
    (rec,) = [r for r in caplog.records if r.getMessage().startswith("obs_timed_test:")]
    assert rec.getMessage().endswith(" rows/s)") and "s (" in rec.getMessage()
    assert "otpu_timed_seconds" in REGISTRY.to_prometheus()
