"""The port's whole-workflow serving (serve/workflow.py ServedWorkflow):
the twins of tests/test_workflow_serve.py without its fleet and tool
cases, and the served DAG against the JAX package's.

A fitted StandardScaler -> PCA -> KMeans chain serves as ONE bucket
program per ladder rung (one dispatch a request; on the card one captured
CUDA graph), the kill-switch restores stage-by-stage serving, a nested
hot reload re-keys only that DAG, and the workflow pickles whole.

Tolerances. Every stage's product is summed per row
(``models/_linear.row_products``), so the port holds served output BITWISE
equal to its raw stagewise walk and to the kill-switch path at every
request size (the JAX package holds its fused path to 1e-5). Against the
JAX package, with the reference's fitted state carried over (interop):
cluster ids equal, transform within 1e-5 of its largest entry.
"""

import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.datasets import load_iris as jload_iris
from orange3_spark_tpu.models.kmeans import KMeans as JKMeans
from orange3_spark_tpu.models.pca import PCA as JPCA
from orange3_spark_tpu.models.preprocess import StandardScaler as JStandardScaler
from orange3_spark_tpu.serve import ServedWorkflow as JServedWorkflow
from orange3_spark_tpu_torch import TorchSession, TorchTable, interop
from orange3_spark_tpu_torch.datasets import load_iris
from orange3_spark_tpu_torch.models.kmeans import KMeans
from orange3_spark_tpu_torch.models.pca import PCA
from orange3_spark_tpu_torch.models.preprocess import StandardScaler
from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.serve import BucketLadder, ServedWorkflow, ServingContext
from orange3_spark_tpu_torch.utils.profiling import reset_serve_counters, serve_counters

from _port_parity import assert_port_equal, to_np


@pytest.fixture(scope="module")
def session():
    return TorchSession.builder_get_or_create("cpu")


@pytest.fixture(scope="module")
def iris(session):
    return load_iris(session)


def _subtable(table, n, session):
    Y = table.Y[:n].numpy() if table.Y is not None else None
    return TorchTable.from_numpy(table.domain, table.X[:n].numpy(), Y, session=session)


def _dispatches():
    c = serve_counters()
    return c.get("bucket_hits", 0) + c.get("bucket_misses", 0)


def _fit_stack(iris, *, km_seed=0):
    scaler = StandardScaler().fit(iris)
    scaled = scaler.transform(iris)
    pca = PCA(k=2).fit(scaled)
    km = KMeans(k=3, seed=km_seed).fit(pca.transform(scaled))
    return scaler, pca, km


@pytest.fixture(scope="module")
def stack(iris):
    return _fit_stack(iris)


@pytest.fixture(scope="module")
def wf(stack, iris):
    return ServedWorkflow.from_stages(list(stack), iris, name="wf-iris")


@pytest.fixture(scope="module")
def raw_ref(stack, iris):
    scaler, pca, km = stack
    pre = pca.transform(scaler.transform(iris))
    return {"transform_X": km.transform(pre).X.numpy(), "predict": km.predict(pre)}


# ------------------------------------------------------------ raw parity
def test_raw_walk_matches_manual_stagewise(wf, iris, raw_ref):
    np.testing.assert_array_equal(wf.transform(iris).X.numpy(), raw_ref["transform_X"])
    np.testing.assert_array_equal(wf.predict(iris), raw_ref["predict"])


def test_workflow_identity_surface(wf, iris):
    assert wf.n_stages == 3
    assert wf.n_cols == len(iris.domain.attributes)
    assert wf._dag_name == "wf-iris"
    assert wf._hot_reloadable
    assert wf._bundle_sig == ((1, "model", "StandardScalerModel"),
                              (2, "model", "PCAModel"), (3, "model", "KMeansModel"))
    assert wf.device.type == "cpu"


# ---------------------------------------------------------- fused parity
@pytest.mark.parametrize("n", (1, 9, 33, 64, 150))
def test_fused_predict_is_bitwise_raw_in_one_dispatch(session, iris, wf, raw_ref, n):
    t = _subtable(iris, n, session)
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=4096)):
        wf.predict(t)
        reset_serve_counters()
        served = wf.predict(t)
        assert _dispatches() == 1, "a fused workflow request must dispatch ONCE"
    np.testing.assert_array_equal(served, raw_ref["predict"][:n])


@pytest.mark.parametrize("n", (17, 64, 100))
def test_fused_transform_is_bitwise_raw(session, iris, wf, raw_ref, n):
    t = _subtable(iris, n, session)
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=4096)):
        served = wf.transform(t)
    assert served.n_rows == n
    np.testing.assert_array_equal(served.X.numpy(), raw_ref["transform_X"][:n])


def test_fused_array_wire_parity(iris, wf, raw_ref):
    X = iris.X[:50].numpy()
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=4096)):
        served = np.asarray(wf.predict(X))
    np.testing.assert_array_equal(served, raw_ref["predict"][:50])
    np.testing.assert_array_equal(np.asarray(wf.predict(X)), raw_ref["predict"][:50])


# ------------------------------------------------------------ kill-switch
def test_kill_switch_stagewise_bitwise_parity(session, iris, wf, stack, monkeypatch):
    scaler, pca, km = stack
    t = _subtable(iris, 33, session)
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=4096)):
        per_model = km.predict(pca.transform(scaler.transform(t)))
        fused = wf.predict(t)
        monkeypatch.setenv("OTPU_WORKFLOW_SERVE", "0")
        reset_serve_counters()
        switched = wf.predict(t)
        assert _dispatches() == wf.n_stages, "the kill-switch serves one dispatch a stage"
    np.testing.assert_array_equal(switched, per_model)
    np.testing.assert_array_equal(fused, per_model)


def test_oversized_dag_serves_stagewise(session, iris, wf, monkeypatch):
    monkeypatch.setenv("OTPU_WORKFLOW_MAX_STAGES", "2")   # the DAG has 3
    t = _subtable(iris, 17, session)
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=4096)):
        reset_serve_counters()
        wf.predict(t)
        assert _dispatches() == wf.n_stages
    snap = REGISTRY.snapshot()["otpu_workflow_stagewise_total"]
    assert any(v["labels"].get("dag") == "wf-iris" and v["value"] >= 1
               for v in snap["values"])
    assert REGISTRY.get("otpu_workflow_stages").value(dag="wf-iris") == 3


# --------------------------------------------------- warmup & rebuilds
def test_warmup_builds_the_ladder_and_repeat_traffic_builds_nothing(session, iris):
    wf2 = ServedWorkflow.from_stages(list(_fit_stack(iris)), iris, name="wf-warm")
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=256)) as ctx:
        report = ctx.warmup(wf2, template=iris)
        assert report["compiled"] == 3 * 3      # transform, predict, array x 3 rungs
        n_entries = len(ctx.cache)
        reset_serve_counters()
        for n in (9, 40, 64, 100, 150):
            t = _subtable(iris, n, session)
            wf2.predict(t)
            wf2.transform(t)
        assert serve_counters().get("bucket_misses", 0) == 0
        assert len(ctx.cache) == n_entries


def test_interior_stage_reload_rekeys_only_that_dag(session, iris):
    wf_a = ServedWorkflow.from_stages(list(_fit_stack(iris, km_seed=0)), iris, name="wf-a")
    wf_b = ServedWorkflow.from_stages(list(_fit_stack(iris, km_seed=1)), iris, name="wf-b")
    t = _subtable(iris, 33, session)
    _, pca_new, _ = _fit_stack(_subtable(iris, 90, session))
    tok0 = wf_a._serve_state_token()
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=4096)):
        wf_a.predict(t)
        wf_b.predict(t)
        reset_serve_counters()
        wf_a.predict(t)
        wf_b.predict(t)
        assert serve_counters().get("bucket_misses", 0) == 0
        wf_a.load_state_pytree({"node2": pca_new.state_pytree})
        assert wf_a._serve_state_token() != tok0
        reset_serve_counters()
        wf_b.predict(t)
        assert serve_counters().get("bucket_misses", 0) == 0, "wf-b was re-keyed"
        a1 = wf_a.predict(t)
        assert serve_counters().get("bucket_misses", 0) == 1, "wf-a kept its old program"
    np.testing.assert_array_equal(a1, wf_a.predict(t))    # serves the NEW state


def test_load_state_pytree_rejects_unknown_stage(iris):
    wf2 = ServedWorkflow.from_stages(list(_fit_stack(iris)), iris, name="wf-rej")
    with pytest.raises(ValueError, match="unknown stages"):
        wf2.load_state_pytree({"node9": {}})


def test_microbatch_merges_same_dag_requests(session, iris, wf):
    tables = [_subtable(iris, k, session) for k in (9, 17, 25)]
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=4096)):
        refs = [wf.predict(t) for t in tables]
    reset_serve_counters()
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=4096), micro_batch=True,
                        max_batch=4096, max_wait_ms=50.0):
        with ThreadPoolExecutor(12) as ex:
            outs = list(ex.map(lambda t: np.asarray(wf.predict(t)), tables * 4))
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, refs[i % 3])
    c = serve_counters()
    assert c["mb_requests"] == 12
    assert 1 <= c["mb_batches"] < c["mb_requests"]


# ----------------------------------------------------- bundle & pickling
def test_workflow_pickles_whole(iris, wf, raw_ref):
    clone = pickle.loads(pickle.dumps(wf))
    assert clone._bundle_sig == wf._bundle_sig and clone.dag_name == wf.dag_name
    np.testing.assert_array_equal(clone.transform(iris).X.numpy(), raw_ref["transform_X"])


def test_from_graph_and_program_guards(session, iris):
    from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY, OWTable
    from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph
    from orange3_spark_tpu_torch.workflow.staging import build_serve_program

    g = WorkflowGraph()
    src = g.add(OWTable(iris))
    sc = g.add(WIDGET_REGISTRY["OWStandardScaler"](with_mean=True))
    km = g.add(WIDGET_REGISTRY["OWKMeans"](k=3, seed=0))
    g.connect(src, "data", sc, "data")
    g.connect(sc, "data", km, "data")
    wfg = ServedWorkflow.from_graph(g, km, name="wf-graph")
    assert wfg.n_stages == 2 and wfg.graph_json == g.to_json()
    np.testing.assert_array_equal(wfg.transform(iris).X.numpy(), g.output(km, "data").X.numpy())
    g2 = WorkflowGraph()
    a, b = g2.add(OWTable(iris)), g2.add(OWTable(iris))
    mg = g2.add(WIDGET_REGISTRY["OWMergeColumns"]())
    g2.connect(a, "data", mg, "left")
    g2.connect(b, "data", mg, "right")
    with pytest.raises(ValueError, match="boundary input"):
        build_serve_program(g2, mg)
    with pytest.raises(ValueError, match="at least one"):
        ServedWorkflow.from_stages([], iris)


# ------------------------------------------------- against the reference
def test_served_dag_matches_the_jax_package(session, iris):
    """The reference's fitted chain, carried into the port, serves the
    reference's cluster ids and transform."""
    jsess = TpuSession(TpuSession.default_mesh(jax.devices()[:1]))
    jiris = jload_iris(jsess)
    js = JStandardScaler().fit(jiris)
    jscaled = js.transform(jiris)
    jp = JPCA(k=2).fit(jscaled)
    jk = JKMeans(k=3, seed=0).fit(jp.transform(jscaled))
    jwf = JServedWorkflow.from_stages([js, jp, jk], jiris, name="jwf")

    def state(m):
        return {k: np.asarray(v) for k, v in m.state_pytree.items()}

    stages = [interop.standard_scaler_model(state(js), js.params.to_dict(), device="cpu"),
              interop.pca_model(state(jp), jp.params.to_dict(), device="cpu"),
              interop.kmeans_model(state(jk), jk.params.to_dict(), device="cpu")]
    twf = ServedWorkflow.from_stages(stages, iris, name="twf")
    ref_ids = np.asarray(jwf.predict(jiris))
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=256)):
        got_ids = twf.predict(iris)
        got_tr = twf.transform(iris).X
    assert_port_equal(ref_ids, got_ids, what="cluster ids")
    ref_tr = to_np(jwf.transform(jiris).X)
    assert_port_equal(ref_tr, got_tr, atol=1e-5 * np.abs(ref_tr).max(), what="transform")
    assert torch.equal(got_tr, twf.transform(iris).X)
