"""The port's copies of the host layers the serving path stands on, held to
the JAX package's originals: the same script runs on both, under the same
seeded clock and injected faults, and the traces must be equal.

Covered: the knob registry's names and defaults, ``CircuitBreaker``'s state
sequence, ``AdmissionController``'s shed decisions, ``retry_call``'s
backoff schedule and the ``aot_build`` fault it absorbs, the
``AdaptiveCoalescer``'s dial, the fault-spec grammar, the tenancy layer
(``OTPU_TENANT_SPEC``'s grammar, ``TenantFairShare``'s grants, share caps
and token buckets, tenant-scoped admission sheds), the online tap, the
metrics registry and the span tracer (whose one JAX use,
``jax.profiler.TraceAnnotation``, became a ``torch.profiler.record_function``
range taken only while a profiler runs).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import orange3_spark_tpu.online.tap as j_tap
import orange3_spark_tpu.resilience.faults as j_faults
import orange3_spark_tpu.resilience.overload as j_overload
import orange3_spark_tpu.resilience.retry as j_retry
import orange3_spark_tpu.serve.cache as j_cache
import orange3_spark_tpu.serve.tenancy as j_tenancy
import orange3_spark_tpu.utils.knobs as j_knobs
import orange3_spark_tpu.utils.profiling as j_prof
import orange3_spark_tpu_torch.online.tap as t_tap
import orange3_spark_tpu_torch.resilience.faults as t_faults
import orange3_spark_tpu_torch.resilience.overload as t_overload
import orange3_spark_tpu_torch.resilience.retry as t_retry
import orange3_spark_tpu_torch.serve.cache as t_cache
import orange3_spark_tpu_torch.serve.tenancy as t_tenancy
import orange3_spark_tpu_torch.utils.knobs as t_knobs
import orange3_spark_tpu_torch.utils.profiling as t_prof
from orange3_spark_tpu_torch.obs import trace as t_trace
from orange3_spark_tpu_torch.obs.registry import MetricsRegistry

PACKAGES = {
    "jax": (j_faults, j_overload, j_retry, j_cache, j_prof),
    "torch": (t_faults, t_overload, t_retry, t_cache, t_prof),
}


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    for k in ("OTPU_ADMISSION_DEADLINE_S", "OTPU_ADMISSION_SERVICE_MS",
              "OTPU_RESILIENCE", "OTPU_FAULT_SPEC",
              "OTPU_MB_ADAPT", "OTPU_BREAKER_COOLDOWN_S", "OTPU_TENANCY",
              "OTPU_TENANT_SPEC", "OTPU_TENANT_DEFAULT_WEIGHT", "OTPU_TENANT_RATE",
              "OTPU_TENANT_BURST", "OTPU_ONLINE"):
        monkeypatch.delenv(k, raising=False)


def test_knobs_keep_the_reference_names_and_defaults():
    """Every knob the port keeps has the JAX package's type, default and
    subsystem; the port keeps every knob its copied modules read."""
    assert set(t_knobs.KNOBS) <= set(j_knobs.KNOBS)
    for name, knob in t_knobs.KNOBS.items():
        ref = j_knobs.KNOBS[name]
        assert (knob.type, knob.default, knob.subsystem) == (
            ref.type, ref.default, ref.subsystem), name
        getter = {"flag": "get_bool", "int": "get_int", "float": "get_float",
                  "str": "get_str"}[knob.type]
        assert getattr(t_knobs, getter)(name) == getattr(j_knobs, getter)(name), name
    read = {"OTPU_OBS", "OTPU_OBS_TRACE_CAP", "OTPU_TRACE_SAMPLE", "OTPU_TRACE_SLOW_MS",
            "OTPU_RESILIENCE", "OTPU_RETRY_ATTEMPTS", "OTPU_MB_DEADLINE_S",
            "OTPU_ADMISSION_MAX_INFLIGHT", "OTPU_BREAKER_THRESHOLD", "OTPU_MB_ADAPT",
            "OTPU_TENANCY", "OTPU_TENANT_SPEC", "OTPU_TENANT_DEFAULT_WEIGHT",
            "OTPU_TENANT_RATE", "OTPU_TENANT_BURST", "OTPU_ONLINE"}
    assert read <= set(t_knobs.KNOBS)


@pytest.mark.parametrize("malformed", ["abc", ""])
def test_knob_getters_fall_back_like_the_reference(monkeypatch, malformed):
    monkeypatch.setenv("OTPU_RETRY_ATTEMPTS", malformed)
    monkeypatch.setenv("OTPU_RETRY_BASE_S", malformed)
    assert t_knobs.get_int("OTPU_RETRY_ATTEMPTS") == j_knobs.get_int("OTPU_RETRY_ATTEMPTS")
    assert t_knobs.get_float("OTPU_RETRY_BASE_S") == j_knobs.get_float("OTPU_RETRY_BASE_S")
    with pytest.raises(KeyError):
        t_knobs.get_bool("OTPU_NOT_A_KNOB")


def _breaker_trace(overload, *, threshold, jitter, seed):
    """allow()/state() after each step of a fixed failure script on a fake
    clock."""
    clk = [0.0]
    br = overload.CircuitBreaker("t", failure_threshold=threshold, cooldown_s=10.0,
                                 probe_successes=1, jitter=jitter, seed=seed,
                                 clock=lambda: clk[0])
    out = []
    script = ["f", "f", "a", 9.9, "a", 10.0, "a", "a", "f", 12.0, "a", 25.0, "a",
              "s", "a", "f", "f", "f", 40.0, "a", "s"]
    for step in script:
        if step == "f":
            br.record_failure()
        elif step == "s":
            br.record_success()
        elif step == "a":
            out.append(("allow", br.allow()))
        else:
            clk[0] = step
        out.append(br.state())
    return out


@pytest.mark.parametrize("threshold,jitter,seed", [(1, 0.0, 0), (2, 0.0, 0), (2, 0.25, 3)])
def test_circuit_breaker_trace_equals_reference(threshold, jitter, seed):
    """The copied breaker walks the same closed -> open -> half-open states
    under the same seeded clock (the JAX package's
    ``test_breaker_lifecycle_fake_clock`` and
    ``test_breaker_seeded_probe_cadence_pinned``)."""
    ref = _breaker_trace(j_overload, threshold=threshold, jitter=jitter, seed=seed)
    assert _breaker_trace(t_overload, threshold=threshold, jitter=jitter, seed=seed) == ref
    assert ("allow", True) in ref and "open" in ref


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_breaker_kill_switch_is_the_legacy_latch(monkeypatch, pkg):
    overload = PACKAGES[pkg][1]
    monkeypatch.setenv("OTPU_RESILIENCE", "0")
    clk = [0.0]
    br = overload.CircuitBreaker(failure_threshold=3, cooldown_s=0.1, clock=lambda: clk[0])
    br.record_failure()
    clk[0] = 1e9
    assert (br.state(), br.allow()) == ("open", False)


def _admission_decisions(overload, service_ms):
    """Shed decisions of ``check_queue`` and ``slot`` over a sweep of queue
    depths and deadlines, with the service-time floor set by the knob."""
    ac = overload.AdmissionController(max_inflight=2, max_queue=6)
    out = []
    for depth in (0, 1, 3, 5, 6, 40):
        for d in (None, 0.001, 0.05, 1.0, 60.0):
            try:
                ac.check_queue(queue_depth=depth, deadline_s=d)
                out.append("ok")
            except overload.OverloadShedError as e:
                out.append((e.reason, round(e.est_wait_s, 9), e.queue_depth))
    # a held slot, then a hopeless and a generous deadline
    entered, release = threading.Event(), threading.Event()

    def hold():
        with ac.slot():
            entered.set()
            release.wait(5.0)

    threads = [threading.Thread(target=hold, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    assert entered.wait(2.0)
    for _ in range(2000):
        if ac.inflight == 2:
            break
        threading.Event().wait(0.001)
    assert ac.inflight == 2
    try:
        with ac.slot(deadline_s=0.001):
            out.append("admitted")
    except overload.OverloadShedError as e:
        out.append((e.reason, e.inflight))
    release.set()
    for t in threads:
        t.join(2.0)
        assert not t.is_alive()
    with ac.slot(deadline_s=1.0):
        out.append(("slot", ac.inflight))
    return out


@pytest.mark.parametrize("service_ms", ["1000", "0.001"])
def test_admission_shed_decisions_equal_reference(monkeypatch, service_ms):
    """``AdmissionController`` sheds the same requests, for the same
    reasons, with the same wait estimates (the JAX package's admission
    tests: hopeless wait, queue bound, deadline-free legacy no-op)."""
    monkeypatch.setenv("OTPU_ADMISSION_SERVICE_MS", service_ms)
    ref = _admission_decisions(j_overload, service_ms)
    assert _admission_decisions(t_overload, service_ms) == ref
    assert "ok" in ref and any(isinstance(r, tuple) and r[0] == "queue_full" for r in ref)


def _retry_trace(faults, retry, prof):
    """retry_call over a flaky function (two transient failures), the
    delays it sleeps, and a seeded jittered schedule."""
    calls, slept = {"n": 0}, []

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise faults.TransientSourceError("blip")
        return "ok"

    before = prof.resilience_counters()["retries_by_cause"].get("parity", 0)
    pol = retry.RetryPolicy(max_attempts=4, base_delay_s=0.05, max_delay_s=1.0,
                            multiplier=2.0, jitter=0.25, seed=7)
    got = retry.retry_call(flaky, cause="parity", policy=pol, sleep=slept.append)
    after = prof.resilience_counters()["retries_by_cause"]["parity"]
    schedule = [retry.RetryPolicy(base_delay_s=0.1, jitter=0.5, seed=s).delay(i)
                for s in range(3) for i in range(4)]
    exhausted = []
    try:
        retry.retry_call(lambda: (_ for _ in ()).throw(faults.TransientSourceError("x")),
                         cause="parity", policy=retry.RetryPolicy(max_attempts=3, jitter=0.0),
                         sleep=exhausted.append)
    except faults.TransientSourceError:
        exhausted.append("raised")
    return got, calls["n"], slept, after - before, schedule, exhausted


def test_retry_backoff_trace_equals_reference():
    """The same delays, attempts and retry counts (the JAX package's
    ``test_retry_call_attempt_counts_fake_clock`` and
    ``test_retry_backoff_schedule_pinned``)."""
    ref = _retry_trace(j_faults, j_retry, j_prof)
    assert _retry_trace(t_faults, t_retry, t_prof) == ref
    assert ref[:2] == ("ok", 3) and ref[3] == 2


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_cache_build_retries_an_injected_fault(monkeypatch, pkg):
    """An injected transient build failure costs one retry; under the
    kill-switch it raises (``test_executable_cache_build_retry_and_kill_switch``)."""
    faults, _, _, cache_mod, prof = PACKAGES[pkg]
    monkeypatch.setenv("OTPU_RETRY_BASE_S", "0.001")
    cache = cache_mod.ExecutableCache(max_entries=4)
    builds = {"n": 0}

    def build():
        builds["n"] += 1
        return "exe"

    before = prof.resilience_counters()["retries_by_cause"].get("aot_build", 0)
    with faults.inject_faults("aot_build:fails=1"):
        assert cache.get_or_build(("k1",), build) == "exe"
    assert builds["n"] == 1
    assert prof.resilience_counters()["retries_by_cause"]["aot_build"] == before + 1
    monkeypatch.setenv("OTPU_RESILIENCE", "0")
    with faults.inject_faults("aot_build:fails=1"):
        with pytest.raises(faults.TransientBuildError):
            cache.get_or_build(("k2",), build)


def _coalescer_trace(overload):
    ac = overload.AdaptiveCoalescer(0.002, 256, 4096)
    out = []
    for depth in (0, 8, 64, 64, 64, 200, 0, 0, 0, 0, 1):
        ac.update(depth)
        out.append((round(ac.current_wait_s(), 12), ac.current_batch(), round(ac.factor, 9)))
    return out


def test_adaptive_coalescer_trace_equals_reference():
    assert _coalescer_trace(t_overload) == _coalescer_trace(j_overload)


def test_fault_spec_grammar_equals_reference():
    spec = "source_io:every=7,fails=2;aot_build:fails=1;overload:delay_ms=3,requests=2"
    j, t = j_faults.FaultSpec.parse(spec), t_faults.FaultSpec.parse(spec)
    assert [(c.kind, c.args) for c in t.clauses] == [(c.kind, c.args) for c in j.clauses]
    assert [t.take_overload_delay() for _ in range(3)] == [
        j.take_overload_delay() for _ in range(3)]
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_faults.FaultSpec.parse("no_such_kind:fails=1")


@pytest.mark.parametrize("kind", ["spill_corrupt:record=1", "wedge:at=2",
                                  "mem_pressure:frac=0.9", "label_skew:flip=0.5",
                                  "trainer_crash:at=1"])
def test_fault_kinds_without_a_consumer_raise(kind):
    """Kinds whose consumer is not ported (the spill's CRC check, the
    watchdog, the brownout ladder, the label joiner, the online trainer)
    raise instead of injecting nothing; the JAX package parses them."""
    j_faults.FaultSpec.parse(kind)
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_faults.FaultSpec.parse(kind)


# ---------------------------------------------------------------- tenancy
TENANT_SPECS = ["gold:weight=4;silver:weight=2,max_inflight=8,deadline_s=0.5",
                "", "  ;  ", "a:weight=1", "bronze", "gold:weight", "gold:weight=fast",
                "gold:weight=0", "gold:max_inflight=1.5", "gold:deadline_s=0",
                "gold:turbo=1"]


def _parsed(tenancy, spec):
    try:
        return sorted(dataclasses.astuple(v) for v in tenancy.parse_tenant_spec(spec).values())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", TENANT_SPECS)
def test_tenant_spec_grammar_equals_reference(spec):
    """``OTPU_TENANT_SPEC`` parses to the same quotas, or raises the same
    error naming the item (the JAX package's
    ``test_parse_tenant_spec_full_grammar`` and
    ``test_parse_tenant_spec_malformed_raises_naming_item``)."""
    assert _parsed(t_tenancy, spec) == _parsed(j_tenancy, spec)


def _fair_share_trace(tenancy):
    """Deficit-round-robin grants over 70 freed slots (weights 4:2:1), the
    share caps under contention, and a token bucket draining and refilling
    on a fake clock."""
    tenancy.reset_tenant_sheds()
    out = []
    fair = tenancy.TenantFairShare(tenancy.parse_tenant_spec("a:weight=4;b:weight=2;c:weight=1"),
                                   clock=lambda: 0.0)
    for name in ("a", "b", "c"):
        fair.note_waiting(name, +1)
    for _ in range(70):
        head = next(n for n in ("a", "b", "c") if fair.may_grant(n))
        fair.granted(head)
        out.append(head)
        fair.release(head)
    for name in ("a", "b", "c"):
        fair.note_waiting(name, -1)
    for _ in range(3):               # a holds slots while b waits: a's share caps it
        out.append(fair.try_admit("a", max_inflight=4, max_queue=4))
        fair.granted("a")
    fair.note_waiting("b", +1)
    out.append(fair.try_admit("a", max_inflight=4, max_queue=4))
    out.append(fair.try_admit("b", max_inflight=4, max_queue=4))
    out.append(sorted(fair.snapshot().items()))
    clk = [0.0]
    bucket = tenancy.TenantFairShare(tenancy.parse_tenant_spec("a:weight=1"),
                                     clock=lambda: clk[0])
    for t in (0.0, 0.0, 0.0, 0.5, 1.0, 1.0, 3.0, 3.0, 3.0, 3.0):
        clk[0] = t
        q = bucket.try_admit("a", max_inflight=8, max_queue=8)
        out.append(q)
        if q is None:
            bucket.granted("a")
            bucket.release("a")
    return out


def test_fair_share_trace_equals_reference(monkeypatch):
    """``TenantFairShare`` grants the same tenants in the same order, caps
    the same shares and drains and refills its token buckets the same
    (``test_drr_grants_follow_weights_on_fake_clock`` and
    ``test_token_bucket_rate_limits_and_refills_on_fake_clock``)."""
    monkeypatch.setenv("OTPU_TENANT_RATE", "1.0")
    monkeypatch.setenv("OTPU_TENANT_BURST", "2")
    ref = _fair_share_trace(j_tenancy)
    assert _fair_share_trace(t_tenancy) == ref
    assert ref[:70].count("a") == 40 and ref[:70].count("c") == 10
    assert any(isinstance(q, tuple) and q[0] == "tenant_rate" for q in ref)
    assert any(isinstance(q, tuple) and q[0] == "tenant_inflight" for q in ref)


def _tenant_admission_trace(overload, tenancy, monkeypatch):
    """A tenant at its spec'd in-flight cap sheds typed while another is
    admitted; the kill-switch builds no fair-share state."""
    tenancy.reset_tenant_sheds()
    monkeypatch.setenv("OTPU_TENANT_SPEC", "heavy:weight=1,max_inflight=1;light:weight=4")
    ac = overload.AdmissionController(max_inflight=4, max_queue=16)
    entered, release = threading.Event(), threading.Event()

    def hold():
        with tenancy.tenant_scope("heavy"):
            with ac.slot():
                entered.set()
                release.wait(10.0)

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    assert entered.wait(5.0)
    out = []
    try:
        with tenancy.tenant_scope("heavy"):
            with ac.slot():
                out.append("admitted")
    except tenancy.TenantQuotaShedError as e:
        out.append((type(e).__mro__[1].__name__, e.tenant, e.reason, e.usage, e.quota))
    with tenancy.tenant_scope("light"):
        with ac.slot():
            out.append(("light", tenancy.current_tenant()))
    release.set()
    t.join(5.0)
    assert not t.is_alive()
    out.append(sorted(ac.tenancy_snapshot().items()))
    out.append(tenancy.tenant_shed_counts())
    monkeypatch.setenv("OTPU_TENANCY", "0")
    ac2 = overload.AdmissionController(max_inflight=2, max_queue=8)
    with tenancy.tenant_scope("heavy"):
        with ac2.slot():
            pass
    out.append((tenancy.tenancy_enabled(), ac2._fair_share, ac2.tenancy_snapshot()))
    return out


def test_tenant_admission_sheds_equal_reference(monkeypatch):
    """Tenant-scoped admission sheds the same request, with the same quota
    evidence, as the JAX package's ``AdmissionController``
    (``test_tenant_max_inflight_hard_cap_sheds_typed``,
    ``test_tenancy_kill_switch_no_fair_state``)."""
    ref = _tenant_admission_trace(j_overload, j_tenancy, monkeypatch)
    monkeypatch.delenv("OTPU_TENANCY")
    got = _tenant_admission_trace(t_overload, t_tenancy, monkeypatch)
    assert got == ref
    assert ref[0] == ("OverloadShedError", "heavy", "tenant_inflight", 1.0, 1.0)
    assert ref[-1] == (False, None, {})


def test_tenant_scope_nests_and_is_thread_local():
    seen = []
    assert t_tenancy.current_tenant() is None
    with t_tenancy.tenant_scope("a"):
        with t_tenancy.tenant_scope("b"):
            seen.append(t_tenancy.current_tenant())
        seen.append(t_tenancy.current_tenant())
        th = threading.Thread(target=lambda: seen.append(t_tenancy.current_tenant()))
        th.start()
        th.join(5.0)
    assert seen == ["b", "a", None] and t_tenancy.current_tenant() is None


# ------------------------------------------------------------- online tap
class _ListLog:
    """The request log's two appends, kept in memory."""

    def __init__(self):
        self.requests, self.labels = [], []

    def append_request(self, X):
        self.requests.append(np.array(X))
        return len(self.requests) - 1

    def append_label(self, req_id, y):
        self.labels.append((req_id, np.array(y)))


def _tap_trace(tap_mod, faults, monkeypatch):
    """What an installed tap logs: one record per request, once inside a
    replica's ``tap_scope``, shifted by an injected drift from its onset,
    nothing under the kill-switch or once uninstalled."""
    log = _ListLog()
    X = np.arange(8, dtype=np.float32).reshape(4, 2)
    tap_mod.maybe_tap_request(X)                   # no tap installed
    tap = tap_mod.OnlineTap(log).install()
    try:
        tap_mod.maybe_tap_request(X)
        with tap_mod.tap_scope(X + 1):
            tap_mod.maybe_tap_request(X)
            tap_mod.maybe_tap_request(X)
        with faults.inject_faults("drift:shift=8,after=3"):
            tap.tap_request(X)                     # ordinal 2: before the onset
            tap.tap_request(X)                     # ordinal 3: shifted
        tap.tap_label(1, np.ones(4, np.float32))
        last = tap.last_request_id()
        monkeypatch.setenv("OTPU_ONLINE", "0")
        off = (tap.tap_request(X), tap_mod.online_enabled())
        tap.tap_label(0, np.ones(4, np.float32))
        monkeypatch.delenv("OTPU_ONLINE")
    finally:
        tap.uninstall()
    tap_mod.maybe_tap_request(X)                   # uninstalled
    return ([r.tolist() for r in log.requests], [(i, y.tolist()) for i, y in log.labels],
            last, off, tap_mod.active_tap())


def test_tap_trace_equals_reference(monkeypatch):
    """The copied tap logs the same records as the JAX package's
    (``test_tap_global_install_scope_and_kill_switch`` and
    ``test_tap_drift_injector_shifts_logged_features``)."""
    ref = _tap_trace(j_tap, j_faults, monkeypatch)
    assert _tap_trace(t_tap, t_faults, monkeypatch) == ref
    assert len(ref[0]) == 4 and ref[0][3][0] == [8.0, 9.0] and ref[2] == 3
    assert ref[3] == (None, False) and ref[4] is None


def test_registry_counts_and_exports():
    reg = MetricsRegistry()
    c = reg.counter("otpu_test_total", "a counter")
    c.inc(2, cause="a")
    c.inc(1, cause="b")
    g = reg.gauge("otpu_test_gauge", "a gauge")
    g.set(5)
    h = reg.histogram("otpu_test_seconds", "a histogram")
    for v in np.linspace(0.001, 0.5, 50):
        h.observe(float(v))
    assert c.total() == 3 and c.per_label("cause") == {"a": 2, "b": 1}
    snap = reg.snapshot()
    assert snap["otpu_test_gauge"]["values"][0]["value"] == 5
    text = reg.to_prometheus()
    assert 'otpu_test_total{cause="a"} 2' in text and "otpu_test_seconds_bucket" in text


def test_spans_take_a_profiler_range_only_while_a_profiler_records():
    """A span records into the ring either way; it enters a
    ``record_function`` range only under a running torch profiler, so the
    profile shows the span's name."""
    t_trace.clear()
    with t_trace.span("serve_test_no_profiler") as sp:
        assert sp.ann is None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t_trace.span("serve_test_profiled") as sp:
            assert sp.ann is not None
            torch.ones(4).sum()
    names = [e[1] for e in t_trace.events()]
    assert {"serve_test_no_profiler", "serve_test_profiled"} <= set(names)
    assert any(e.name == "serve_test_profiled" for e in prof.events())
