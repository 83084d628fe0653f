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

from _torch_artifacts import artifact_dirs  # noqa: F401
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
from orange3_spark_tpu_torch.obs import flight as t_flight
from orange3_spark_tpu_torch.obs import prof as t_obs_prof
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
              "OTPU_TENANT_BURST", "OTPU_ONLINE", "OTPU_DISPATCH_BUDGET_S",
              "OTPU_MEM_BUDGET_MB", "OTPU_MEM_WATERMARKS", "OTPU_FLIGHT", "OTPU_OBS",
              "OTPU_PROF"):
        monkeypatch.delenv(k, raising=False)
    t_flight.reset_rate_limit()


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
            "OTPU_TENANT_RATE", "OTPU_TENANT_BURST", "OTPU_ONLINE", "OTPU_DISPATCH_BUDGET_S"}
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


@pytest.mark.parametrize("kind", ["label_skew:flip=0.5", "trainer_crash:at=1"])
def test_fault_kinds_without_a_consumer_raise(kind):
    """Kinds whose consumer is not ported (the label joiner, the online
    trainer) raise instead of injecting nothing; the JAX package parses
    them."""
    j_faults.FaultSpec.parse(kind)
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_faults.FaultSpec.parse(kind)


@pytest.mark.parametrize("spec", [
    "spill_corrupt:record=1", "spill_corrupt:record=2,mode=truncate;spill_corrupt:record=0",
    "mem_pressure:frac=0.9", "mem_pressure:frac=0.97,after=2",
    "mem_pressure:frac=0.5,after=1;spill_corrupt:record=3,mode=flip"])
def test_spill_corrupt_and_mem_pressure_parse_and_are_consumed_like_the_reference(spec):
    """``spill_corrupt`` and ``mem_pressure`` have their consumers now (the
    spill's write path, the brownout ladder): they parse as the reference
    does, ``take_spill_corrupt`` fires once a clause on its record with its
    mode, ``mem_pressure_frac`` keeps the first ``after`` consuming queries
    free, never advances on a side observer's query, and ticks the fault
    counter once a clause."""
    j, t = j_faults.FaultSpec.parse(spec), t_faults.FaultSpec.parse(spec)
    assert [(c.kind, c.args) for c in t.clauses] == [(c.kind, c.args) for c in j.clauses]

    def trace(fs, prof):
        before = dict(prof.resilience_counters()["faults_by_kind"])
        out = [fs.take_spill_corrupt(r) for r in (0, 1, 2, 3, 1, 0)]
        out += [fs.mem_pressure_frac(consume=False) for _ in range(2)]
        out += [fs.mem_pressure_frac() for _ in range(4)]
        out += [fs.mem_pressure_frac(consume=False)]
        after = prof.resilience_counters()["faults_by_kind"]
        return out, {k: after.get(k, 0) - before.get(k, 0)
                     for k in ("spill_corrupt", "mem_pressure")}

    assert trace(t, t_prof) == trace(j, j_prof)


@pytest.mark.parametrize("spec", ["wedge:at=2,hold_s=0.5", "wedge", "wedge:at=1;overload"])
def test_wedge_kind_parses_and_is_consumed_like_the_reference(spec):
    """``wedge`` has its consumer now (the dispatch watchdog): it parses,
    and ``take_wedge`` fires on the ``at``-th guarded sync only, with the
    reference's hold and counters."""
    j, t = j_faults.FaultSpec.parse(spec), t_faults.FaultSpec.parse(spec)
    assert [(c.kind, c.args) for c in t.clauses] == [(c.kind, c.args) for c in j.clauses]
    before = t_prof.resilience_counters()["faults_by_kind"].get("wedge", 0)
    got = [t.take_wedge() for _ in range(4)]
    assert got == [j.take_wedge() for _ in range(4)]
    assert sum(h is not None for h in got) == 1
    assert t_prof.resilience_counters()["faults_by_kind"]["wedge"] == before + 1


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
    try:
        ref = _tenant_admission_trace(j_overload, j_tenancy, monkeypatch)
        monkeypatch.delenv("OTPU_TENANCY")
        got = _tenant_admission_trace(t_overload, t_tenancy, monkeypatch)
    finally:
        # the shed ledgers are process-wide: leave them empty for the next
        # file's tenant-less bodies (tests/test_torch_obs.py)
        for tenancy in (j_tenancy, t_tenancy):
            tenancy.reset_tenant_sheds()
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


# ------------------------------------------------- the streaming fit's recovery
def _hashed_data(n=4096, seed=4):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, 4)).astype(np.float32)
    cats = rng.integers(0, 40, (n, 6)).astype(np.float32)
    y = (dense[:, 0] + 0.3 * (cats[:, 0] % 3) + 0.3 * rng.standard_normal(n) > 0)
    return np.concatenate([dense, cats], axis=1), y.astype(np.float32)


def _hashed_fit(X, y, chunk_rows, *, checkpointer=None, stage_times=None, cache=True,
                **kw):
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io.streaming import array_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator

    est = StreamingHashedLinearEstimator(**{
        "n_dims": 1 << 10, "n_dense": 4, "n_cat": 6, "epochs": 3, "step_size": 0.05,
        "chunk_rows": chunk_rows, "optim_update": "sparse_adagrad", **kw})
    return est.fit_stream(array_chunk_source(X, y, chunk_rows=chunk_rows),
                          session=TorchSession("cpu"), cache_device=cache,
                          checkpointer=checkpointer, stage_times=stage_times)


@pytest.mark.parametrize("defer", [False, True])
def test_hashed_fit_recovers_from_source_faults_bitwise(monkeypatch, defer):
    """bench.py's fault protocol on the port's hashed fit: transient reads
    (every 7th chunk fails twice) and stragglers are absorbed by
    ``resilient_source``, and the fit equals the clean one bit for bit."""
    monkeypatch.setenv("OTPU_RETRY_BASE_S", "0.001")
    X, y = _hashed_data()
    kw = dict(defer_epoch1=defer)
    clean = _hashed_fit(X, y, 256, **kw)
    st: dict = {}
    with t_faults.inject_faults("source_io:every=7,fails=2;slow_source:every=8,delay_ms=5"):
        faulted = _hashed_fit(X, y, 256, stage_times=st, **kw)
    assert st["retries"] == 4          # ordinals 6 and 13 of 16, twice each
    for k in clean.theta:
        assert torch.equal(faulted.theta[k], clean.theta[k]), k
    assert faulted.n_steps_ == clean.n_steps_
    monkeypatch.setenv("OTPU_RESILIENCE", "0")     # fail-fast: the fault surfaces
    with t_faults.inject_faults("source_io:every=7,fails=2"):
        with pytest.raises(t_faults.TransientSourceError):
            _hashed_fit(X, y, 256, **kw)


@pytest.mark.parametrize("path", ["per_chunk", "epoch_replay"])
def test_nan_raises_typed_and_writes_no_snapshot(monkeypatch, tmp_path, path):
    """An Inf feature makes the first step's loss non-finite: the epoch
    guard raises ``NumericalDivergenceError`` naming epoch 0, before the
    epoch snapshot, so no NaN state reaches the disk (the JAX package's
    ``tests/test_criteo_tsv.py`` pins the same). Under the kill-switch the
    fit trains to NaN, as there."""
    from orange3_spark_tpu_torch.resilience import NumericalDivergenceError
    from orange3_spark_tpu_torch.utils.fault import StreamCheckpointer

    X, y = _hashed_data()
    X[3, 1] = np.inf
    kw = (dict(cache=False, checkpoint_every_epochs=1) if path == "per_chunk" else
          dict(defer_epoch1=True, replay_granularity="epoch"))
    ck = StreamCheckpointer(str(tmp_path / "nan.ckpt"), every_steps=4)
    with pytest.raises(NumericalDivergenceError, match="epoch 0") as e:
        _hashed_fit(X, y, 512, checkpointer=ck, **kw)
    assert e.value.what == "loss"
    assert not (tmp_path / "nan.ckpt").exists()
    monkeypatch.setenv("OTPU_RESILIENCE", "0")
    model = _hashed_fit(X, y, 512, **kw)
    assert not np.isfinite(model.final_loss_)


def test_wedged_sync_raises_typed_within_its_budget(monkeypatch):
    """``wedge:at=1,hold_s=30`` under a 0.25 s budget: the first guarded
    sync of a 32-step eager fit (``bound_dispatch`` waits every 4th step at
    prefetch depth 2) holds on the monitor thread, and the fit raises
    ``DispatchWedgedError`` within about a second instead of hanging."""
    import time

    from orange3_spark_tpu_torch.resilience import DispatchWedgedError
    from orange3_spark_tpu_torch.resilience.overload import reset_wedge_breaker

    X, y = _hashed_data()
    monkeypatch.setenv("OTPU_DISPATCH_BUDGET_S", "0.25")
    before = t_prof.resilience_counters()["wedges"]
    reset_wedge_breaker()
    try:
        with t_faults.inject_faults("wedge:at=1,hold_s=30"):
            t0 = time.perf_counter()
            with pytest.raises(DispatchWedgedError) as e:
                _hashed_fit(X, y, 128, cache=False, epochs=1)
            waited = time.perf_counter() - t0
        assert waited < 1.5, waited
        assert e.value.step == 4 and e.value.budget_s == 0.25
        assert t_prof.resilience_counters()["wedges"] == before + 1
    finally:
        reset_wedge_breaker()


# ------------------------------------------------- the brownout ladder
def _bundles(tmp_path, reason):
    d = tmp_path / "flight"
    return sorted(p for p in d.glob(f"flight-*-{reason}.json")) if d.exists() else []


def _brownout_trace(overload, faults, monkeypatch, watermarks):
    """Levels of ``brownout_level`` (and its side-observer form) over a
    sweep of injected fractions, an RSS budget far above and far below the
    process, and the kill-switch."""
    if watermarks is None:
        monkeypatch.delenv("OTPU_MEM_WATERMARKS", raising=False)
    else:
        monkeypatch.setenv("OTPU_MEM_WATERMARKS", watermarks)
    out = []
    for frac in (0.0, 0.5, 0.74, 0.75, 0.8, 0.88, 0.9, 0.95, 0.96, 0.97, 1.5):
        with faults.inject_faults(f"mem_pressure:frac={frac}"):
            out.append((overload.brownout_level(consume=False), overload.brownout_level(),
                        overload.current_brownout_level()))
    with faults.inject_faults("mem_pressure:frac=0.97,after=2"):
        out.append([overload.brownout_level() for _ in range(4)])
    for budget_mb in ("1000000000", "1"):
        monkeypatch.setenv("OTPU_MEM_BUDGET_MB", budget_mb)
        out.append(overload.brownout_level())
    monkeypatch.delenv("OTPU_MEM_BUDGET_MB")
    monkeypatch.setenv("OTPU_RESILIENCE", "0")
    with faults.inject_faults("mem_pressure:frac=0.99"):
        out.append(overload.brownout_level())
    monkeypatch.delenv("OTPU_RESILIENCE")
    out.append(overload.brownout_level())     # no pressure source: 0
    return out


@pytest.mark.parametrize("watermarks", [None, "0.5,0.6,0.7", "0.9,0.8,0.95", "abc"])
def test_brownout_level_equals_reference(monkeypatch, watermarks):
    """The ladder's rung for the same fractions and watermarks (malformed
    or unordered ones fall back to the defaults), the injector's ``after``
    budget, the RSS budget and the kill-switch, as in the reference."""
    ref = _brownout_trace(j_overload, j_faults, monkeypatch, watermarks)
    got = _brownout_trace(t_overload, t_faults, monkeypatch, watermarks)
    assert got == ref
    if watermarks is None:      # the sweep crosses every default rung
        assert {lvl for _, lvl, _ in ref[:11]} == {0, 1, 2, 3}


def test_device_cache_brownout_ladder(monkeypatch):
    """The reference's four rungs (``tests/test_overload.py``) on the port's
    ``_DeviceCache`` with tensors: 1 admits to half the budget, 2 admits
    nothing, 3 drops a cached prefix, the kill-switch ignores pressure; the
    ``cache_chunks`` ledger entry follows the cache's bytes."""
    from orange3_spark_tpu_torch.io.streaming import _DeviceCache

    def batch(kb=64):
        return (torch.zeros(kb * 256, dtype=torch.float32),)   # kb KiB

    def ledger(c):
        return t_obs_prof.LEDGER.get("cache_chunks", c.ledger_key)

    with t_faults.inject_faults("mem_pressure:frac=0.80"):
        c = _DeviceCache(True, budget=4 * 64 * 1024)
        c.offer(batch())
        c.offer(batch())
        assert len(c.batches) == 2 and not c.degraded
        assert ledger(c) == 2 * 64 * 1024
        c.offer(batch())            # past half the budget (fits the whole)
        assert not c.batches and c.degraded and ledger(c) == 0
    with t_faults.inject_faults("mem_pressure:frac=0.90"):
        c = _DeviceCache(True, budget=4 * 64 * 1024)
        c.offer(batch())
        assert not c.batches and c.degraded and not c.enabled
    with t_faults.inject_faults("mem_pressure:frac=0.97,after=2"):
        c = _DeviceCache(True, budget=4 * 64 * 1024)
        c.offer(batch())
        c.offer(batch())
        assert len(c.batches) == 2 and ledger(c) == 2 * 64 * 1024
        c.offer(batch())
        assert not c.batches and c.nbytes == 0 and not c.enabled
        assert c.degraded and ledger(c) == 0
        key = c.ledger_key
        del c
        import gc

        gc.collect()
        assert t_obs_prof.LEDGER.get("cache_chunks", key) is None   # released
    monkeypatch.setenv("OTPU_RESILIENCE", "0")
    with t_faults.inject_faults("mem_pressure:frac=0.97"):
        c = _DeviceCache(True, budget=4 * 64 * 1024)
        for _ in range(4):
            c.offer(batch())
        assert len(c.batches) == 4 and not c.degraded


@pytest.fixture(scope="module")
def jax_one_device():
    import jax

    from orange3_spark_tpu.core.session import TpuSession

    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


def _dense_data(n=4096, d=8, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X @ rng.standard_normal(d).astype(np.float32) > 0).astype(np.float32)
    return X, y


def test_mem_pressure_fit_equals_reference(jax_one_device):
    """bench's brownout drill at a small size: a dense streaming fit with
    the device cache under ``mem_pressure:frac=0.97,after=2`` lands on rung
    3 at its third chunk, drops the cache (its ledger entry 0 at fit end)
    and re-streams epoch 2 — coefficients bitwise the unpressured fit's,
    and within the usual 1e-5 of max|θ| of the reference's pressured fit."""
    from orange3_spark_tpu.io import streaming as jstream
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io import streaming as tstream

    X, y = _dense_data()
    kw = dict(loss="logistic", epochs=2, step_size=0.05, chunk_rows=1024)
    st: dict = {}
    with t_faults.inject_faults("mem_pressure:frac=0.97,after=2"):
        got = tstream.StreamingLinearEstimator(**kw).fit_stream(
            tstream.array_chunk_source(X, y, chunk_rows=1024), n_features=8,
            session=TorchSession("cpu"), cache_device=True, stage_times=st)
    assert t_overload.current_brownout_level() == 3
    assert st["replay_source"] == "stream"
    assert got.run_report_.to_dict()["device_memory"]["cache_entry_bytes"] == 0
    clean = tstream.StreamingLinearEstimator(**kw).fit_stream(
        tstream.array_chunk_source(X, y, chunk_rows=1024), n_features=8,
        session=TorchSession("cpu"), cache_device=True)
    assert torch.equal(got.coef, clean.coef) and torch.equal(got.intercept, clean.intercept)
    with j_faults.inject_faults("mem_pressure:frac=0.97,after=2"):
        ref = jstream.StreamingLinearEstimator(**kw).fit_stream(
            jstream.array_chunk_source(X, y, chunk_rows=1024), n_features=8,
            session=jax_one_device, cache_device=True)
    assert j_overload.current_brownout_level() == 3
    want = np.asarray(ref.coef)
    np.testing.assert_allclose(got.coef.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode,match", [("flip", "record 1"), ("truncate", "truncated")])
def test_spill_corruption_raises_typed_and_writes_a_bundle(tmp_path, mode, match):
    """A spill record corrupted at write time (``spill_corrupt``, after the
    CRC was computed) raises ``SpillCorruptionError`` at replay (a flipped
    byte: the CRC check, which ticks ``crc_failures`` and writes a
    ``spill_corruption`` flight bundle) or at finalize (a half-written
    record), as in the reference."""
    import json
    import warnings

    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io.codec import SpillCorruptionError
    from orange3_spark_tpu_torch.io import streaming as tstream

    X, y = _dense_data(n=2048)
    crc0 = t_prof.resilience_counters()["crc_failures"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with t_faults.inject_faults(f"spill_corrupt:record={1 if mode == 'flip' else 2},"
                                    f"mode={mode}"):
            with pytest.raises(SpillCorruptionError, match=match):
                tstream.StreamingLinearEstimator(
                    loss="logistic", epochs=2, chunk_rows=512).fit_stream(
                    tstream.array_chunk_source(X, y, chunk_rows=512), n_features=8,
                    session=TorchSession("cpu"), cache_device=True, cache_device_bytes=1,
                    cache_spill_dir=str(tmp_path / "spill"))
    bundles = _bundles(tmp_path, "spill_corruption")
    if mode == "truncate":
        assert not bundles       # caught by the size check, not the CRC
        return
    assert t_prof.resilience_counters()["crc_failures"] == crc0 + 1
    assert len(bundles) == 1
    b = json.loads(bundles[0].read_text())
    assert (b["flight_schema"], b["reason"]) == (1, "spill_corruption")
    assert b["error"]["type"] == "SpillCorruptionError" and "record 1" in b["error"]["message"]


def test_first_shed_writes_one_overload_shed_bundle(tmp_path, monkeypatch):
    """``AdmissionController._dump_shed``: the first shed of a spell writes
    a flight bundle (outside the admission lock) carrying the typed error
    and the shed count; sheds inside ``OTPU_FLIGHT_RATE_S`` write none."""
    import json

    ac = t_overload.AdmissionController(max_inflight=1, max_queue=2)
    for _ in range(3):
        with pytest.raises(t_overload.OverloadShedError):
            ac.check_queue(queue_depth=5, deadline_s=0.01)
    bundles = _bundles(tmp_path, "overload_shed")
    assert len(bundles) == 1
    b = json.loads(bundles[0].read_text())
    assert b["error"]["type"] == "OverloadShedError"
    assert b["sheds"] >= 1 and b["brownout_level"] is not None


def test_divergence_and_wedge_write_flight_bundles(tmp_path, monkeypatch):
    """The numerics guard and the dispatch watchdog dump the black box at
    their raise sites: a ``divergence`` bundle naming the typed error, and
    a ``dispatch_wedged`` bundle whose stacks hold the parked waiter."""
    import json

    from orange3_spark_tpu_torch.resilience import (
        DispatchWedgedError, NumericalDivergenceError, check_finite_training,
        guarded_block_until_ready,
    )
    from orange3_spark_tpu_torch.resilience.overload import reset_wedge_breaker

    with pytest.raises(NumericalDivergenceError):
        check_finite_training(torch.tensor(float("nan")), epoch=2, chunk=7)
    (b,) = [json.loads(p.read_text()) for p in _bundles(tmp_path, "divergence")]
    assert b["error"]["type"] == "NumericalDivergenceError"
    t_flight.reset_rate_limit()
    monkeypatch.setenv("OTPU_DISPATCH_BUDGET_S", "0.2")
    reset_wedge_breaker()
    try:
        with t_faults.inject_faults("wedge:at=1,hold_s=3"):
            with pytest.raises(DispatchWedgedError):
                guarded_block_until_ready(torch.zeros(1), step=1)
    finally:
        reset_wedge_breaker()
    (b,) = [json.loads(p.read_text()) for p in _bundles(tmp_path, "dispatch_wedged")]
    assert b["error"]["type"] == "DispatchWedgedError"
    assert any("otpu-dispatch-waiter" in k for k in b["stacks"])

