"""The port's goodput & memory plane (``obs/prof.py``) held to the JAX
package's: the same seeded feeds through both packages' accountants give
the same stage seconds, fractions and bottleneck labels; the ledger's
set/release/snapshot race and its watermarks; the goodput and ledger
sections of a real (CPU) hashed fit, and the ``OTPU_PROF=0`` kill-switch;
``profile_trace`` through the serialized, rate-limited capture path with a
Chrome trace of ``torch.profiler``.

A fixture resets the plane's process state (the contextvar's accountant,
the ledger's entries and watermarks, the capture rate slot) around every
test, so no test inherits another's abandoned accountant.
"""

import gc
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.obs.prof as j_prof
import orange3_spark_tpu_torch.obs.prof as t_prof
from orange3_spark_tpu_torch import TorchSession


@pytest.fixture(autouse=True)
def prof_env(tmp_path, monkeypatch):
    """A fresh plane: no live accountant, an empty ledger with no open
    watermark, the capture rate slot free, artifacts under ``tmp_path``."""
    for k in ("OTPU_PROF", "OTPU_PROF_HYST", "OTPU_PROF_RATE_S", "OTPU_OBS"):
        monkeypatch.delenv(k, raising=False)

    def reset():
        for mod in (t_prof, j_prof):
            mod._CURRENT.set(None)
        gc.collect()
        for mod in (t_prof, j_prof):
            mod.LEDGER.clear()
            with mod.LEDGER._lock:
                mod.LEDGER._watermarks.clear()
            mod.reset_rate_limit()

    reset()
    yield tmp_path
    reset()


# ------------------------------------------------- the accountant's parity
def _feeds(seed, n=40):
    rng = np.random.default_rng(seed)
    return [tuple(float(v) for v in rng.uniform(0, 1, 5) * rng.choice([0.0, 1.0, 3.0], 5))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decompose_equals_reference(seed):
    """``_decompose`` over seeded (wall, dev, sync, wait, encode) tuples,
    overshooting walls and zero walls included."""
    for wall, dev, sync, wait, enc in _feeds(seed):
        args = (wall * 2.5, dev, sync, wait, enc)
        assert (t_prof.GoodputAccountant._decompose(*args)
                == j_prof.GoodputAccountant._decompose(*args))


@pytest.mark.parametrize("hyst", [0.0, 0.1, 0.3])
def test_classify_sequence_equals_reference(hyst):
    """``_classify`` with hysteresis over one seeded sequence of fraction
    dicts: the same label, epoch by epoch (the incumbent carried along)."""
    rng = np.random.default_rng(7)
    accs = [m.GoodputAccountant(hysteresis=hyst) for m in (t_prof, j_prof)]
    labels = ([], [])
    for _ in range(60):
        f = dict(zip(t_prof.STAGES, rng.dirichlet(np.ones(5)) * rng.choice([0.0, 1.0])))
        for acc, out in zip(accs, labels):
            lab = acc._classify(f)
            acc.bottleneck = lab
            out.append(lab)
    assert labels[0] == labels[1]
    assert len(set(labels[0])) > 1


def _epoch_feed(mod, monkeypatch, seed):
    """One seeded fit through ``mod``'s accountant under a fake clock:
    per epoch, stage seconds fed by the hooks, then ``epoch_boundary``;
    then ``finish``."""
    clock = [1000.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    rng = np.random.default_rng(seed)
    acc = mod.begin_fit()
    enc = 0.0
    for epoch in range(8):
        dev, sync, wait = (float(v) for v in rng.uniform(0, 2, 3) * rng.choice([0, 1], 3))
        mod.note_sync(dev)
        mod.note_sync(sync, barrier=True)
        mod.note_input_wait(wait)
        enc += float(rng.uniform(0, 1))
        clock[0] += dev + sync + wait + float(rng.uniform(0, 1.5))
        acc.epoch_boundary(epoch, encode_s=enc)
    clock[0] += 0.25
    res = acc.finish(encode_s=enc)
    mod.end_fit(acc)
    monkeypatch.undo()
    return {k: res[k] for k in ("fractions", "seconds", "bottleneck", "epochs", "wall_s")}


@pytest.mark.parametrize("seed", [3, 4])
def test_epoch_boundary_feed_equals_reference(monkeypatch, seed):
    """The hooks (``note_sync`` as device compute and as a barrier,
    ``note_input_wait``), ``epoch_boundary`` and ``finish`` fed one seeded
    fit: equal stage seconds, fractions (summing to 1 within 0.02),
    per-epoch windows and labels."""
    got = _epoch_feed(t_prof, monkeypatch, seed)
    assert got == _epoch_feed(j_prof, monkeypatch, seed)
    assert abs(sum(got["fractions"].values()) - 1.0) <= 0.02
    assert len(got["epochs"]) == 8


def test_bottleneck_hysteresis_no_flap_at_boundary():
    """Feeds oscillating around input == compute keep one label; a
    challenger past the margin flips it once."""
    acc = t_prof.GoodputAccountant(hysteresis=0.1)
    acc.bottleneck = acc._classify({"input_wait": 0.6, "device_compute": 0.2})
    assert acc.bottleneck == "input_bound"
    for delta in (+0.02, -0.02, +0.04, -0.04, +0.08, -0.08):
        acc.bottleneck = acc._classify({"input_wait": 0.4, "device_compute": 0.4 + delta})
        assert acc.bottleneck == "input_bound", delta
    acc.bottleneck = acc._classify({"input_wait": 0.3, "device_compute": 0.55})
    assert acc.bottleneck == "compute_bound"


def test_goodput_framework_bound_when_nothing_measured():
    res = t_prof.GoodputAccountant(hysteresis=0.1).finish(wall_s=1.0)
    assert res["fractions"]["framework"] == 1.0
    assert res["bottleneck"] == "framework_bound"


# ------------------------------------------------------------ the ledger
def test_ledger_register_release_snapshot_race(monkeypatch):
    """Six threads race set/release on one ledger while two snapshot it:
    every snapshot is internally consistent, the final state exact."""
    led = t_prof.DeviceMemoryLedger()
    errors: list = []
    stop = threading.Event()

    def mutator(tid):
        try:
            for i in range(1500):
                led.set(f"owner{tid % 4}", f"e{tid}-{i % 8}", (i % 64) * 1024)
                if i % 3 == 0:
                    led.release(f"owner{tid % 4}", f"e{tid}-{(i + 4) % 8}")
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                snap = led.snapshot()
                assert sum(snap["owners"].values()) == snap["total_bytes"] >= 0
                assert snap["peak_bytes"] >= snap["total_bytes"]
                led.reconcile()
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=mutator, args=(t,)) for t in range(6)]
                   + [threading.Thread(target=reader) for _ in range(2)])
        for t in threads:
            t.start()
        for t in threads[:6]:
            t.join(60)
        stop.set()
        for t in threads[6:]:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    snap = led.snapshot(max_entries=10_000)
    assert sum(e["bytes"] for e in snap["entries"]) == snap["total_bytes"]
    for e in snap["entries"]:
        led.release(e["owner"], e["name"])
    assert led.total() == 0


def test_ledger_watermark_tracks_a_peak_and_deferred_release():
    led = t_prof.DeviceMemoryLedger()
    led.set("a", "x", 100)
    wm = led.watermark()
    led.set("a", "y", 900)
    led.release("a", "y")
    led.set("a", "z", 50)
    assert wm.close() == 1000 and led.total() == 150
    led.defer_release("a", "z")          # a finalizer's lock-free form
    assert led.get("a", "z") is None and led.total() == 100


def test_end_fit_closes_abandoned_watermark():
    """``begin_fit``/``end_fit`` without ``finish`` leaks no watermark, nor
    does an aborted fit that never reaches ``end_fit`` (its accountant's
    finalizer closes it once the next ``begin_fit`` drops it)."""
    def open_watermarks():
        t_prof.LEDGER.total()        # drains the deferred closes
        return len(t_prof.LEDGER._watermarks)

    before = open_watermarks()
    for _ in range(16):
        t_prof.end_fit(t_prof.begin_fit())
    assert open_watermarks() == before
    for _ in range(8):
        t_prof.begin_fit()           # abandoned
    t_prof.end_fit(t_prof.begin_fit())
    gc.collect()
    assert open_watermarks() == before


def test_tree_device_bytes_counts_elements_not_storages():
    base = torch.zeros(64, 4)
    tree = {"a": base, "v": [base[:8], (base[:, 0], None)], "n": 3}
    assert t_prof.tree_device_bytes(tree) == (256 + 32 + 64) * 4
    assert t_prof.tree_device_bytes(torch.zeros(3, dtype=torch.bfloat16)) == 6


def test_reconcile_reports_no_allocator_on_the_cpu():
    t_prof.LEDGER.set("model_state", "x", 123)
    rec = t_prof.LEDGER.reconcile()
    assert rec == {"ledger_bytes": 123, "allocator": None, "allocated_bytes": None,
                   "reserved_bytes": None, "delta_vs_allocated_bytes": None}


# ------------------------------------------------------- a fit's sections
def _fit_hashed(epochs=3, rows=4096, **fit_kw):
    from orange3_spark_tpu_torch.io.streaming import array_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator

    rng = np.random.default_rng(3)
    X = np.concatenate([rng.standard_normal((rows, 4)).astype(np.float32),
                        rng.integers(0, 500, (rows, 4)).astype(np.float32)], axis=1)
    y = (rng.random(rows) < 0.3).astype(np.float32)
    est = StreamingHashedLinearEstimator(n_dims=1 << 12, n_dense=4, n_cat=4,
                                         epochs=epochs, step_size=0.05, chunk_rows=512)
    return est.fit_stream(array_chunk_source(X, y, chunk_rows=512),
                          session=TorchSession("cpu"), cache_device=True, **fit_kw)


def test_fit_goodput_and_ledger_sections():
    """A cached hashed fit: the five fractions partition the wall (within
    0.02), an epoch window a streamed epoch plus the replay's; the ledger's
    ``cache_chunks`` entry equals ``stage_times['cache_bytes']``, the
    ``model_state`` entry is the table at fit end (the slots die with the
    fit) and lives as long as the model, and the fit's peak holds the
    table, the slots and the cache."""
    from orange3_spark_tpu_torch.models.hashed_linear import _init_fit_state

    st: dict = {}
    model = _fit_hashed(stage_times=st)
    rep = model.run_report_.to_dict()
    gp, dm = rep["goodput"], rep["device_memory"]
    assert rep["report_schema"] == 2 and rep["kind"] == "fit_stream"
    assert set(gp["fractions"]) == set(t_prof.STAGES)
    assert abs(sum(gp["fractions"].values()) - 1.0) <= 0.02
    assert [e["epoch"] for e in gp["epochs"]] == [0, 2]
    assert dm["cache_entry_bytes"] == st["cache_bytes"] > 0
    table = t_prof.tree_device_bytes(model.theta)
    assert dm["owners"]["model_state"] == table
    theta0, opt0 = _init_fit_state(model.params, TorchSession("cpu"))[:2]
    assert dm["peak_bytes_fit"] >= t_prof.tree_device_bytes((theta0, opt0)) + st["cache_bytes"]
    assert t_prof.LEDGER.owner_bytes().get("model_state") == table
    del model, rep
    gc.collect()
    assert t_prof.LEDGER.owner_bytes().get("model_state", 0) == 0


def test_kill_switch_drops_the_sections_and_changes_no_bit(monkeypatch):
    """``OTPU_PROF=0``: no goodput or device_memory section, no ledger
    entry, theta bitwise the instrumented fit's."""
    on = _fit_hashed()
    monkeypatch.setenv("OTPU_PROF", "0")
    t_prof.LEDGER.clear()
    off = _fit_hashed()
    rep = off.run_report_.to_dict()
    assert "goodput" not in rep and "device_memory" not in rep
    assert t_prof.LEDGER.total() == 0
    for k in on.theta:
        assert torch.equal(on.theta[k], off.theta[k]), k


def test_aborted_fit_releases_model_state_entry():
    """A fit that raises mid-stream strands no ``model_state`` entry."""
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator

    rng = np.random.default_rng(5)
    X = np.concatenate([rng.standard_normal((1024, 4)).astype(np.float32),
                        rng.integers(0, 500, (1024, 4)).astype(np.float32)], axis=1)
    y = (rng.random(1024) < 0.3).astype(np.float32)

    def poisoned():
        yield X[:512], y[:512], None
        raise RuntimeError("poisoned mid-fit")       # not transient

    with pytest.raises(RuntimeError, match="poisoned"):
        StreamingHashedLinearEstimator(n_dims=1 << 10, n_dense=4, n_cat=4, epochs=2,
                                       step_size=0.05, chunk_rows=512).fit_stream(
            lambda: poisoned(), session=TorchSession("cpu"))
    gc.collect()
    assert t_prof.LEDGER.owner_bytes().get("model_state", 0) == 0


# -------------------------------------------------------- deep capture
def test_profile_trace_routes_through_the_capture_path(tmp_path, monkeypatch):
    """``utils.profiling.profile_trace``: a Chrome trace (with the span's
    ``record_function`` range) and a ``snapshot.json`` land atomically in
    the caller's directory; a second profile inside the rate window is
    refused typed; under ``OTPU_PROF=0`` it is a bare profiler."""
    from orange3_spark_tpu_torch.obs import trace
    from orange3_spark_tpu_torch.utils.profiling import profile_trace

    out = tmp_path / "p1"
    with profile_trace(str(out)):
        with trace.span("prof_test_span"):
            torch.ones(64).sum()
    names = {e.get("name") for e in json.loads((out / "trace.json").read_text())["traceEvents"]}
    assert "prof_test_span" in names
    snap = json.loads((out / "snapshot.json").read_text())
    assert snap["reason"] == "profile_trace" and snap["prof_schema"] == 1
    assert not any(p.name.startswith("p1.tmp") for p in tmp_path.iterdir())
    with pytest.raises(t_prof.CaptureRateLimitedError):
        with profile_trace(str(tmp_path / "p2")):
            pass
    monkeypatch.setenv("OTPU_PROF", "0")
    with profile_trace(str(tmp_path / "p3")):
        torch.ones(4).sum()
    assert (tmp_path / "p3" / "trace.json").exists()
    assert not (tmp_path / "p3" / "snapshot.json").exists()


def test_trace_capture_publishes_the_artifact_when_the_body_raises(tmp_path):
    from orange3_spark_tpu_torch.utils.profiling import profile_trace

    with pytest.raises(ValueError, match="boom"):
        with profile_trace(str(tmp_path / "p")):
            torch.ones(8).sum()
            raise ValueError("boom")
    snap = json.loads((tmp_path / "p" / "snapshot.json").read_text())
    assert "ValueError: boom" in snap["body_error"]
    assert (tmp_path / "p" / "trace.json").exists()


def test_capture_refuses_typed_when_disabled_busy_or_rate_limited(tmp_path, monkeypatch):
    res = t_prof.capture(5.0, reason="t1")
    assert os.path.isfile(os.path.join(res["path"], "snapshot.json"))
    assert os.path.isfile(os.path.join(res["path"], "torch_trace", t_prof.TRACE_FILE))
    with pytest.raises(t_prof.CaptureRateLimitedError):
        t_prof.capture(5.0)
    t_prof.reset_rate_limit()
    with t_prof._capture_lock:
        with pytest.raises(t_prof.CaptureBusyError):
            t_prof.capture(5.0)
    monkeypatch.setenv("OTPU_PROF", "0")
    with pytest.raises(t_prof.CaptureDisabledError):
        t_prof.capture(5.0)
