"""The port's serving path (``orange3_spark_tpu_torch.serve``) on the CPU,
against its own raw path and the JAX package's serving path, on the same
numpy inputs.

On the CPU there are no CUDA graphs: a bucket's program is the model's
function applied to the padded bucket, so these tests cover the ladder,
the padding, the cache, the breakers and the micro-batcher, and
``tests/test_torch_cuda.py`` covers the captured graphs on the card.

Tolerances: served predictions, logits and probabilities equal the port's
raw ones bitwise at every request size: the dense block's term is a sum of
elementwise products in column order (``_linear.dense_logits``), not a
BLAS sgemm, whose tail block rounds rows apart from its full blocks (MKL's
once made a 9-row request and its 64-row bucket differ by one ulp), and
the embedding gather-sum rounds a row the same at every row count. Trees
are bitwise. Against the JAX package, predictions are equal and
logits and probabilities are within rtol 1e-5, atol 1e-6
(``test_reference_model_through_interop``'s bound: XLA's fused sums and
dot products round apart from PyTorch's).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.online.tap as j_tap
import orange3_spark_tpu_torch.online.tap as t_tap
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.io.streaming import array_chunk_source as j_array_source
from orange3_spark_tpu.models.hashed_linear import (
    StreamingHashedLinearEstimator as JEstimator,
)
from orange3_spark_tpu.serve import BucketLadder as JBucketLadder
from orange3_spark_tpu.serve import ExecutableCache as JExecutableCache
from orange3_spark_tpu.serve import ServingContext as JServingContext
from orange3_spark_tpu.utils import profiling as j_prof
from orange3_spark_tpu_torch import TorchSession, TorchTable, interop
from orange3_spark_tpu_torch.datasets import higgs_domain, make_higgs_proxy
from orange3_spark_tpu_torch.models.base import Model, to_host
from orange3_spark_tpu_torch.models.gbt import GBTClassifier
from orange3_spark_tpu_torch.models.random_forest import RandomForestClassifier
from orange3_spark_tpu_torch.serve import (
    BucketLadder, ExecutableCache, ServingContext, active_serving_context,
)
from orange3_spark_tpu_torch.serve.context import _fingerprint
from orange3_spark_tpu_torch.serve.microbatch import _Request
from orange3_spark_tpu_torch.utils.profiling import reset_serve_counters, serve_counters

SIZES = (9, 77, 256, 600)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def cpu():
    return TorchSession("cpu")


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


def _criteo_rows(n=600, n_dense=3, n_cat=2, seed=3):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(size=(n, n_dense)).astype(np.float32),
                        rng.integers(0, 50, size=(n, n_cat)).astype(np.float32)], axis=1)
    return X, (X[:, 0] > 0.2).astype(np.float32)


@pytest.fixture(scope="module")
def hashed(jax_session):
    """A JAX-trained hashed model and the port's model of the same theta
    (through ``interop.hashed_linear_model``), on the CPU."""
    X, y = _criteo_rows()
    ref = JEstimator(n_dims=1 << 12, n_dense=3, n_cat=2, epochs=2, chunk_rows=256,
                     fused_replay=False).fit_stream(
        j_array_source(X, y, chunk_rows=256), session=jax_session)
    state = {k: np.asarray(v) for k, v in ref.state_pytree.items()}
    port = interop.hashed_linear_model(state, ref.params.to_dict(), ref.class_values,
                                       device="cpu")
    return ref, port, X


def _port_hashed(hashed):
    """A fresh port model of the fixture's theta (tests that reload or
    mutate theta get their own copy)."""
    ref, port, X = hashed
    theta = {k: v.clone() for k, v in port.theta.items()}
    return type(port)(port.params, theta, port.salts, port.class_values), X


@pytest.fixture(scope="module")
def higgs(cpu):
    X, y = make_higgs_proxy(600, seed=5)
    return TorchTable.from_numpy(higgs_domain(), X, y, session=cpu), X, y


def _subtable(X, y, n, session):
    return TorchTable.from_numpy(higgs_domain(), X[:n], y[:n], session=session)


# ---------------------------------------------------------- bucket ladder
LADDERS = [dict(min_bucket=256, max_bucket=4096),
           dict(min_bucket=256, max_bucket=1 << 14),
           dict(min_bucket=64, max_bucket=2048),
           dict(min_bucket=100, max_bucket=3000),
           dict(min_bucket=1, max_bucket=1),
           dict(min_bucket=64, mode="fixed", fixed_step=64, max_bucket=256),
           dict(min_bucket=1, mode="fixed", fixed_step=48, max_bucket=500),
           dict(min_bucket=1, mode="none", max_bucket=100)]


@pytest.mark.parametrize("kw", LADDERS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_ladder_equals_reference(kw):
    """Rungs and ``bucket_for`` over every size up to past the top equal the
    JAX ladder's (``test_ladder_pow2_rungs_and_lookup``,
    ``test_ladder_fixed_and_none_modes``)."""
    ours, ref = BucketLadder(**kw), JBucketLadder(**kw)
    assert ours.buckets() == ref.buckets()
    top = kw["max_bucket"]
    assert [ours.bucket_for(n) for n in range(1, top + 3)] == [
        ref.bucket_for(n) for n in range(1, top + 3)]
    assert ours.bucket_for(top + 1) is None


@pytest.mark.parametrize("kw,match", [(dict(mode="log10"), "mode"),
                                      (dict(min_bucket=512, max_bucket=256), "min_bucket"),
                                      (dict(min_bucket=0), "min_bucket"),
                                      (dict(mode="fixed", fixed_step=0), "fixed_step")])
def test_ladder_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        BucketLadder(**kw)
    with pytest.raises(ValueError, match=match):
        JBucketLadder(**kw)


# ------------------------------------------------------------ the cache
def _lru_script(cache_cls, prof):
    prof.reset_serve_counters()
    cache = cache_cls(max_entries=2)
    built, evicted = [], []
    cache.on_evict = evicted.append
    for k in ("a", "b", "a", "c", "b"):
        cache.get_or_build(k, lambda k=k: built.append(k) or k)
    cache.mark("m")
    c = prof.serve_counters()
    return (built, evicted, cache.keys(), c["aot_hits"], c["aot_misses"],
            c["aot_evictions"])


def test_cache_lru_eviction_and_counters_equal_reference():
    """The same builds, evictions, LRU order and counters as the JAX
    package's cache on the same script (``test_cache_lru_eviction_and_counters``)."""
    ref = _lru_script(JExecutableCache, j_prof)
    ours = _lru_script(ExecutableCache, __import__(
        "orange3_spark_tpu_torch.utils.profiling", fromlist=["x"]))
    assert ours == ref
    assert ref[0] == ["a", "b", "c", "b"] and ref[3:] == (1, 4, 3)


def test_cache_build_serialized_across_threads():
    """Racing first requests pay one build (the JAX package's test of the
    same name)."""
    cache = ExecutableCache(max_entries=4)
    builds = []

    def build():
        builds.append(threading.get_ident())
        return "x"

    with ThreadPoolExecutor(8) as ex:
        out = list(ex.map(lambda _: cache.get_or_build("k", build), range(16)))
    assert out == ["x"] * 16
    assert len(builds) == 1   # racing first requests pay ONE build


def test_cache_build_does_not_block_other_keys():
    """One key's slow build does not block another key's hits or builds
    (the JAX package's test of the same name)."""
    cache = ExecutableCache(max_entries=4)
    started, release = threading.Event(), threading.Event()

    def slow_build():
        started.set()
        assert release.wait(5), "slow build never released"
        return "slow"

    with ThreadPoolExecutor(1) as ex:
        slow = ex.submit(cache.get_or_build, "cold", slow_build)
        assert started.wait(5)
        assert cache.get_or_build("warm", lambda: "w") == "w"
        assert cache.get_or_build("warm", lambda: "nope") == "w"
        release.set()
        assert slow.result(timeout=5) == "slow"
    assert "cold" in cache and "warm" in cache


def test_cache_counts_device_bytes_and_releases_them():
    """The cache's own count of device bytes (in place of the JAX package's
    device-memory ledger) follows its entries."""

    class Entry:
        device_bytes = 1000

    cache = ExecutableCache(max_entries=2)
    for k in "abc":
        cache.get_or_build(k, Entry)
    assert cache.device_bytes() == 2000      # 'a' fell out
    cache.clear()
    assert cache.device_bytes() == 0 and len(cache) == 0


def test_lru_eviction_releases_model_pins(hashed):
    """Once a model's last program is evicted, the context drops its record
    (``test_lru_eviction_releases_model_pins``)."""
    m1, X = _port_hashed(hashed)
    m2, _ = _port_hashed(hashed)
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=64), max_entries=1) as ctx:
        m1.predict(X[:9])
        fp1 = _fingerprint(m1)
        assert any(r.fingerprint == fp1 for r in ctx._records.values())
        m2.predict(X[:9])   # its build evicts m1's only program
        assert not any(r.fingerprint == fp1 for r in ctx._records.values())


# ------------------------------------------------- the hashed array path
@pytest.mark.parametrize("n", SIZES)
def test_hashed_served_equals_raw_and_the_reference(hashed, n):
    """``HashedLinearModel`` through ``served_array`` with a 64..2048
    ladder: predictions, logits and probabilities bitwise equal to the
    port's raw path; predictions equal to the JAX package's served predictions
    from the same theta, probabilities within its stated bound
    (``test_parity_hashed_linear_array_path``)."""
    ref, port, X = hashed
    raw = (port._logits(X[:n]), port.predict(X[:n]), port.predict_proba(X[:n]))
    reset_serve_counters()
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=2048)):
        served = (port._logits(X[:n]), port.predict(X[:n]), port.predict_proba(X[:n]))
    c = serve_counters()
    assert c["request_rows"] == 3 * n and c["aot_misses"] == 1 and c["aot_hits"] == 2
    assert c["padded_rows"] == 3 * max(64, 1 << (n - 1).bit_length())
    for a, b in zip(served, raw):
        assert a.shape == b.shape and a.dtype == b.dtype
    for a, b in zip(served, raw):
        assert np.array_equal(a, b)
    with JServingContext(JBucketLadder(min_bucket=64, max_bucket=2048)):
        ref_pred = np.asarray(ref.predict(X[:n]))
        ref_proba = np.asarray(ref.predict_proba(X[:n]))
        ref_logits = np.asarray(ref._logits(X[:n]))
    assert np.array_equal(served[1], ref_pred)
    np.testing.assert_allclose(served[0], ref_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(served[2], ref_proba, rtol=RTOL, atol=ATOL)


def test_warmup_builds_the_ladder_and_a_repeat_builds_nothing(hashed):
    """Warmup builds every rung once; a request trace then hits only warmed
    programs (``test_warmup_precompiles_ladder``)."""
    port, X = _port_hashed(hashed)
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=512)) as ctx:
        w = ctx.warmup(port, n_cols=X.shape[1])
        assert w == {"compiled": 4, "buckets": [64, 128, 256, 512]}
        assert ctx.warmup(port, n_cols=X.shape[1])["compiled"] == 0
        reset_serve_counters()
        for k in (9, 64, 65, 300, 512, 9):
            port.predict(X[:k])
        c = serve_counters()
        assert (c["aot_misses"], c["aot_hits"], c["bucket_hits"]) == (0, 6, 6)
        with pytest.raises(ValueError, match="n_cols"):
            ctx.warmup(port, kinds=("array",))


@pytest.mark.parametrize("leaves", ["tensor", "numpy"])
def test_hot_reload_keys_fresh_programs_and_in_place_updates_serve(hashed, leaves):
    """``load_state_pytree`` replaces theta and moves the fingerprint, so the
    next request builds a fresh program; an in-place update of theta is
    served by the next request through the same program
    (``test_state_hot_reload_keys_fresh_executables``). A state of numpy
    arrays, as the JAX package's checkpoints carry it, becomes tensors on
    the model's device, so the in-place update reaches the program too."""
    port, X = _port_hashed(hashed)
    other = {k: v + 0.25 for k, v in port.theta.items()}
    if leaves == "numpy":
        other = {k: v.numpy() for k, v in other.items()}
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=2048)) as ctx:
        before = port._logits(X[:77])
        fp0 = _fingerprint(port)
        port.load_state_pytree(other)
        assert _fingerprint(port) != fp0
        assert all(isinstance(v, torch.Tensor) and v.device == port.device
                   for v in port.theta.values())
        reloaded = port._logits(X[:77])
        assert len(ctx.cache) == 2
        with torch.no_grad():
            port.theta["emb"].add_(1.0)
        in_place = port._logits(X[:77])
        assert len(ctx.cache) == 2   # the same program served it
    assert not np.array_equal(reloaded, before)
    assert np.array_equal(in_place, port._logits(X[:77]))
    np.testing.assert_allclose(in_place - reloaded, 2.0, rtol=1e-5)   # two columns


class _ListLog:
    """The online request log's two appends, kept in memory."""

    def __init__(self):
        self.requests = []

    def append_request(self, X):
        self.requests.append(np.array(X).tolist())
        return len(self.requests) - 1

    def append_label(self, req_id, y):
        pass


def test_served_requests_reach_an_installed_tap(hashed):
    """``served_array`` hands each request to an installed online tap once,
    as the JAX package's does (``serve/context.py``'s tap call site)."""
    ref, port, X = hashed
    logs = {}
    for name, tap_mod, model, ctx in (
            ("jax", j_tap, ref, JServingContext(JBucketLadder(min_bucket=64, max_bucket=2048))),
            ("torch", t_tap, port, ServingContext(BucketLadder(min_bucket=64, max_bucket=2048)))):
        log = _ListLog()
        tap = tap_mod.OnlineTap(log).install()
        try:
            with ctx:
                model.predict(X[:9])
                model.predict_proba(X[:77])
        finally:
            tap.uninstall()
        logs[name] = log.requests
    assert logs["torch"] == logs["jax"]
    assert len(logs["jax"]) == 2 and logs["jax"][1] == X[:77].tolist()


# ---------------------------------------------------- the table paths
def _tree_models(higgs):
    table = higgs[0]
    return {"rf": RandomForestClassifier(num_trees=5, max_depth=4, seed=0).fit(table),
            "gbt": GBTClassifier(max_iter=4, max_depth=3).fit(table)}


@pytest.mark.parametrize("kind", ["rf", "gbt"])
def test_tree_models_serve_through_predict_pad(cpu, higgs, kind):
    """A model without a ``_device_predict`` hook (every tree model) serves
    through ``predict-pad``: the table is bucket-padded and the raw predict
    runs on it, bitwise equal to raw; no program is built
    (``test_parity_hookless_model_pads_through_raw``)."""
    _, X, y = higgs
    model = _tree_models(higgs)[kind]
    for k in (9, 150, 600):
        t = _subtable(X, y, k, cpu)
        raw = model.predict(t)
        reset_serve_counters()
        with ServingContext(BucketLadder(min_bucket=16, max_bucket=4096)) as ctx:
            served = model.predict(t)
            assert len(ctx.cache) == 1
        c = serve_counters()
        assert np.array_equal(served, raw) and served.shape == (k,)
        assert (c["aot_misses"], c["request_rows"]) == (0, k)
        assert c["padded_rows"] == max(16, 1 << (k - 1).bit_length())


class _Affine(Model):
    """A stub with a device-pure transform and a ``_device_predict`` hook."""

    def __init__(self, scale=2.0):
        self.scale = scale

    def transform(self, table):
        return table.with_X(table.X * self.scale + 1.0)

    def _device_predict(self, table):
        return (table.X.sum(1) > 0).to(torch.float32)

    def predict(self, table):
        return to_host((table.X.sum(1) > 0).to(torch.float32), table.n_rows)


def test_stub_transform_served_through_served_transform(cpu, higgs):
    """A device-pure transform serves through one bucket program, its live
    rows bitwise equal to raw (the JAX package's
    ``test_parity_logreg_transform_bitwise``)."""
    _, X, y = higgs
    model = _Affine()
    for k in (9, 100):
        t = _subtable(X, y, k, cpu)
        raw = model.transform(t)
        reset_serve_counters()
        with ServingContext(BucketLadder(min_bucket=16, max_bucket=256)) as ctx:
            served = model.transform(t)
            assert any(key[0] == "transform" for key in ctx.cache.keys())
        assert serve_counters()["aot_misses"] == 1
        assert served.n_rows == k and served.domain is raw.domain
        assert torch.equal(served.X[:k], raw.X[:k])
        assert torch.equal(served.W[:k], raw.W[:k]) and torch.equal(served.Y[:k], raw.Y[:k])


@pytest.mark.parametrize("micro_batch", [False, True])
def test_stub_device_predict_served_through_a_table_program(cpu, higgs, micro_batch):
    """A ``_device_predict`` hook serves through a table program, directly
    and through the micro-batcher (the JAX package's
    ``test_parity_logreg_predict_bitwise``)."""
    _, X, y = higgs
    model = _Affine()
    t = _subtable(X, y, 33, cpu)
    raw = model.predict(t)
    reset_serve_counters()
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=256),
                        micro_batch=micro_batch) as ctx:
        assert np.array_equal(model.predict(t), raw)
        assert any(key[0] == "predict" for key in ctx.cache.keys())
    c = serve_counters()
    assert c["aot_misses"] == 1 and c["mb_requests"] == int(micro_batch)


def test_unservable_model_falls_back_and_opens_its_breaker(cpu, higgs):
    """A hook that raises falls back to the raw path (same answer, no
    exception), is counted, and its breaker opens so the next request skips
    the doomed build (``test_unservable_model_falls_back_and_blacklists``)."""
    _, X, y = higgs

    class BadHook(_Affine):
        def _device_predict(self, table):
            raise RuntimeError("not device-pure")

    model = BadHook()
    t = _subtable(X, y, 33, cpu)
    want = _Affine.predict.__serve_raw__(model, t)
    reset_serve_counters()
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=4096)) as ctx:
        assert np.array_equal(model.predict(t), want)
        assert ctx.breaker_states() == {"BadHook:predict": "open"}
        assert ctx.report()["unservable"] == 1
        assert np.array_equal(model.predict(t), want)
    assert serve_counters()["build_failures"] == 1


def test_oversized_batch_bypasses_serving(hashed):
    """Requests above ``max_bucket`` run the raw path untouched (the JAX
    package's test of the same name)."""
    port, X = _port_hashed(hashed)
    raw = port.predict(X[:150])
    reset_serve_counters()
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=64)):
        served = port.predict(X[:150])
    c = serve_counters()
    assert c["request_rows"] == 0 and c["aot_misses"] == 0
    assert np.array_equal(served, raw)


# ---------------------------------------------------------- micro-batch
def test_microbatch_coalesces_and_scatters(hashed):
    """12 requests from 12 threads merge into fewer dispatches, and each
    caller gets its own rows, equal to raw
    (``test_microbatch_coalesces_and_scatters``)."""
    port, X = _port_hashed(hashed)
    sizes = (9, 17, 25)
    refs = [port.predict(X[:k]) for k in sizes]
    reset_serve_counters()
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=4096), micro_batch=True,
                        max_batch=4096, max_wait_ms=50.0):
        with ThreadPoolExecutor(12) as ex:
            outs = list(ex.map(lambda k: port.predict(X[:k]), sizes * 4))
    for i, out in enumerate(outs):
        assert np.array_equal(out, refs[i % 3])
    c = serve_counters()
    assert c["mb_requests"] == 12
    assert 1 <= c["mb_batches"] < c["mb_requests"]


def test_microbatch_oversized_request_direct_dispatches(hashed):
    """A request above ``max_batch`` dispatches directly (the JAX package's
    test of the same name)."""
    port, X = _port_hashed(hashed)
    raw = port.predict(X[:100])
    reset_serve_counters()
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=4096), micro_batch=True,
                        max_batch=32):
        served = port.predict(X[:100])   # 100 > max_batch: direct
    assert np.array_equal(served, raw)
    c = serve_counters()
    assert c["mb_requests"] == 0 and c["request_rows"] == 100


def test_microbatch_group_key_separates_labeled_requests():
    """Labeled and unlabeled requests, and requests for two devices, never
    merge (the JAX package's test of the same name; the port keys the
    device where it keyed the session)."""

    class Rec:
        fingerprint = ("M", 1)

    X = np.zeros((4, 3), np.float32)
    W = np.ones(4, np.float32)
    Y = np.zeros((4, 1), np.float32)
    labeled = _Request("predict", Rec(), (X, Y, W), 4, ("cpu", None, X.dtype))
    unlabeled = _Request("predict", Rec(), (X, None, W), 4, ("cpu", None, X.dtype))
    same = _Request("predict", Rec(), (X + 1, Y + 1, W), 4, ("cpu", None, X.dtype))
    other_device = _Request("predict", Rec(), (X, Y, W), 4, ("cuda:0", None, X.dtype))
    assert labeled.group_key != unlabeled.group_key
    assert labeled.group_key == same.group_key
    assert labeled.group_key != other_device.group_key


# ----------------------------------------------------- context plumbing
def test_context_stack_nesting():
    """Innermost wins (the JAX package's test of the same name)."""
    assert active_serving_context() is None
    a, b = ServingContext(), ServingContext()
    with a:
        assert active_serving_context() is a
        with b:
            assert active_serving_context() is b   # innermost wins
        assert active_serving_context() is a
    assert active_serving_context() is None


def test_routing_wraps_subclass_methods_once(hashed):
    """Every subclass's ``predict``/``transform`` is wrapped once by
    ``Transformer.__init_subclass__``."""
    port = hashed[1]
    assert hasattr(type(port).predict, "__serve_raw__")
    assert hasattr(_Affine.transform, "__serve_raw__")
    assert not hasattr(_Affine.transform.__serve_raw__, "__serve_raw__")


def test_report_brackets_the_window(hashed):
    """``report()`` after exit shows the window's counter deltas and the
    cache's state."""
    port, X = _port_hashed(hashed)
    ctx = ServingContext(BucketLadder(min_bucket=64, max_bucket=256))
    with ctx:
        port.predict(X[:70])
        port.predict(X[:70])
    rep = ctx.report()
    serve = rep["counters"]["serve"]
    assert (serve["aot_misses"], serve["aot_hits"], serve["request_rows"]) == (1, 1, 140)
    assert rep["cache_entries"] == 1 and rep["breakers"] == {}
    assert rep["cache_device_bytes"] == 0          # no graphs on the CPU
    assert rep["kind"] == "serving" and rep["meta"]["ladder"] == [64, 128, 256]
