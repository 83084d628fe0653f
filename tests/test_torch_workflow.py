"""The port's widgets, workflow graph and staging (widgets/, workflow/)
against the JAX package: the twins of tests/test_workflow.py for the
widgets this slice ports, the JSON cross-load, staged against eager, the
staged refit, and the taxi graph (BASELINE config 5) at 20,000 rows.

Tolerances. Staged programs run the same ops as the eager widget walk, so
staged output equals eager output BITWISE in the port (on the CPU the
steps run one by one; on the card as captured CUDA graphs, held bitwise
by tests/test_torch_cuda.py and chip_smoke.py). Against the JAX package,
the taxi graph: the scaler within 1e-6 relative, the principal components
up to a per-column sign within 1e-3 (the taxi table standardizes five
independent columns, whose eigenvalues 0.993-1.007 leave PC2-PC4 defined
to ~1e-4 in float32 only: a rotation inside that subspace moves the
projections by ~1e-4), and the cluster ids equal on every row whose
margin exceeds twice the two packages' disagreement on its distances
(99.72 % of the rows are decided, and every decided id is equal; 3 of
the 56 undecided rows differ); fitted logistic coefficients within 1e-4
relative.
The staged refit's KMeans (device init) equals the port's eager run of
the same init (a fit inside ``staging()``), bitwise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.core import domain as jdom
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.core.table import TpuTable
from orange3_spark_tpu.widgets import catalog as jcat
from orange3_spark_tpu.workflow.graph import WorkflowGraph as JGraph
from orange3_spark_tpu_torch import TorchSession, TorchTable
from orange3_spark_tpu_torch.core.domain import ContinuousVariable, DiscreteVariable, Domain
from orange3_spark_tpu_torch.datasets import (
    load_iris, make_classification, make_taxi_proxy, taxi_domain,
)
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params, staging
from orange3_spark_tpu_torch.models.kmeans import KMeans
from orange3_spark_tpu_torch.ops.relational import merge_columns
from orange3_spark_tpu_torch.widgets.catalog import (
    WIDGET_REGISTRY, OWApplyModel, OWTable, SelectColumns, SelectRows, widget_for_estimator,
)
from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph
from orange3_spark_tpu_torch.workflow.staging import stage_graph, stage_transform_path

from _port_parity import assert_columns_equal_up_to_sign, assert_port_equal, to_np


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def session():
    return TorchSession.builder_get_or_create("cpu")


def _eq(a: TorchTable, b: TorchTable) -> None:
    assert a.domain == b.domain
    for x, y in ((a.X, b.X), (a.Y, b.Y), (a.W, b.W)):
        assert (x is None and y is None) or torch.equal(x, y)


def _simple_graph(session):
    """OWTable -> StandardScaler -> LogisticRegression -> (model, data)."""
    iris = load_iris(session)
    g = WorkflowGraph()
    src = g.add(OWTable(iris))
    sc = g.add(WIDGET_REGISTRY["OWStandardScaler"](with_mean=True))
    lr = g.add(WIDGET_REGISTRY["OWLogisticRegression"](max_iter=100))
    g.connect(src, "data", sc, "data")
    g.connect(sc, "data", lr, "data")
    return g, src, sc, lr, iris


# --------------------------------------------------- graph and widgets
def test_graph_runs_topologically(session):
    g, src, sc, lr, iris = _simple_graph(session)
    outs = g.run()
    assert outs[lr]["model"].n_iter_ > 0
    assert "prediction" in [v.name for v in outs[lr]["data"].domain.attributes]
    assert g.topo_order() == [src, sc, lr]


def test_graph_caching_and_invalidation(session):
    g, src, sc, lr, iris = _simple_graph(session)
    g.run()
    fitted1 = g.nodes[lr].outputs["model"]
    g.run()
    assert g.nodes[lr].outputs["model"] is fitted1     # cached, no refire
    g.set_params(lr, max_iter=5)
    g.run()
    assert g.nodes[lr].outputs["model"] is not fitted1
    assert g.nodes[sc].outputs is not None               # upstream untouched


def test_graph_rejects_cycle_and_bad_ports(session):
    g, src, sc, lr, iris = _simple_graph(session)
    with pytest.raises(ValueError):
        g.connect(lr, "data", sc, "data")                # cycle
    with pytest.raises(ValueError, match="no output"):
        g.connect(src, "nope", sc, "data")
    with pytest.raises(ValueError, match="no input"):
        g.connect(src, "data", sc, "nope")
    g.run()                                              # the graph is intact
    assert g.nodes[lr].outputs is not None
    lone = WorkflowGraph()
    n = lone.add(WIDGET_REGISTRY["OWStandardScaler"]())
    with pytest.raises(ValueError, match="missing inputs"):
        lone.run()
    assert lone.nodes[n].outputs is None


def test_apply_model_evaluator_and_info_widgets(session):
    iris = load_iris(session)
    g = WorkflowGraph()
    src = g.add(OWTable(iris))
    lr = g.add(WIDGET_REGISTRY["OWLogisticRegression"](max_iter=50))
    ap = g.add(OWApplyModel())
    ev = g.add(WIDGET_REGISTRY["OWMulticlassEvaluator"]())
    info = g.add(WIDGET_REGISTRY["OWDataInfo"]())
    view = g.add(WIDGET_REGISTRY["OWTableView"]())
    g.connect(src, "data", lr, "data")
    g.connect(src, "data", ap, "data")
    g.connect(lr, "model", ap, "model")
    g.connect(ap, "data", ev, "data")
    g.connect(src, "data", info, "data")
    g.connect(src, "data", view, "data")
    assert "prediction" in [v.name for v in g.output(ap, "data").domain.attributes]
    assert g.output(ev, "score") > 0.9
    d = g.output(info, "info")
    assert d["n_rows"] == 150 and d["n_attrs"] == 4 and d["n_live"] == 150
    assert g.output(view).shape == (150, 5)
    ctx = WIDGET_REGISTRY["OWTpuContext"]().process()["session"]
    assert isinstance(ctx, TorchSession)


def test_widget_registry_covers_the_ported_estimators():
    for name in ("OWLogisticRegression", "OWLinearSVC", "OWLinearRegression", "OWKMeans",
                 "OWPCA", "OWStandardScaler", "OWMinMaxScaler", "OWMaxAbsScaler",
                 "OWImputer", "OWQuantileDiscretizer", "OWOneHotEncoder",
                 "OWStringIndexer", "OWTargetEncoder", "OWNormalizer", "OWBinarizer",
                 "OWBucketizer", "OWFeatureHasher", "OWApplyModel", "OWTpuContext",
                 "OWTable", "OWMergeColumns", "OWSelectColumns", "OWSelectRows",
                 "OWDataInfo", "OWTableView", "OWBinaryEvaluator", "OWMulticlassEvaluator",
                 "OWRegressionEvaluator", "OWClusteringEvaluator"):
        assert name in WIDGET_REGISTRY, name
        assert name in jcat.WIDGET_REGISTRY, name    # the reference's registry name
    # the reference registers these inside ``except ImportError`` blocks,
    # which an import order can skip: their names are the estimators'
    from orange3_spark_tpu.io import streaming as jstreaming
    from orange3_spark_tpu.models import gbt, random_forest

    for name, cls in (("OWGBTClassifier", gbt.GBTClassifier),
                      ("OWRandomForestRegressor", random_forest.RandomForestRegressor),
                      ("OWStreamingKMeans", jstreaming.StreamingKMeans)):
        assert name == f"OW{cls.__name__}" and name in WIDGET_REGISTRY, name
    assert "OWDecisionTreeClassifier" in WIDGET_REGISTRY
    assert "OWStreamingHashedLinearEstimator" in WIDGET_REGISTRY
    w = WIDGET_REGISTRY["OWKMeans"](k=5)
    assert w.params.k == 5
    assert ("k", "int", 2) in [(n, t, d) for n, t, d in type(w.params).describe()]
    for name in ("OWCsvReader", "OWParquetReader", "OWLibsvmReader", "OWSqlReader", "OWJoin",
                 "OWGroupBy", "OWPivot", "OWSaveData", "OWSQLTransformer"):
        assert name in WIDGET_REGISTRY and name in jcat.WIDGET_REGISTRY, name
    for name in ("OWGaussianMixture", "OWBisectingKMeans", "OWLDA", "OWWord2Vec",
                 "OWFPGrowth", "OWChiSqSelector", "OWTokenizer"):   # queue 1 item 4b
        assert name in WIDGET_REGISTRY and name in jcat.WIDGET_REGISTRY, name
    assert "OWNaiveBayes" in WIDGET_REGISTRY and "OWNaiveBayes" in jcat.WIDGET_REGISTRY


def test_set_params_affects_transformer_widget(session):
    t = TorchTable.from_arrays(np.asarray([[1.0], [3.0]], np.float32), session=session)
    g = WorkflowGraph()
    src = g.add(OWTable(t))
    bz = g.add(WIDGET_REGISTRY["OWBinarizer"](threshold=0.0))
    g.connect(src, "data", bz, "data")
    np.testing.assert_array_equal(g.output(bz, "data").to_numpy()[0][:, 0], [1.0, 1.0])
    g.set_params(bz, threshold=2.0)
    np.testing.assert_array_equal(g.output(bz, "data").to_numpy()[0][:, 0], [0.0, 1.0])


def test_restored_model_is_served_until_upstream_changes(session):
    g, src, sc, lr, iris = _simple_graph(session)
    g.run()
    restored = g.nodes[lr].outputs["model"]
    g.nodes[lr].widget.fitted_model = restored
    g.invalidate(lr)
    assert g.nodes[lr].widget.fitted_model is None      # a signal change drops it


# ---------------------------------------------------------- JSON, .ows role
def test_workflow_json_roundtrip(session):
    g, src, sc, lr, iris = _simple_graph(session)
    g.run()
    g2 = WorkflowGraph.from_json(g.to_json())
    src2 = [n for n, node in g2.nodes.items() if node.widget.name == "OWTable"][0]
    g2.nodes[src2].widget.table = iris
    lr2 = [n for n, node in g2.nodes.items() if node.widget.name == "OWLogisticRegression"][0]
    outs = g2.run()
    assert g2.nodes[lr2].widget.params.max_iter == 100
    assert torch.equal(g.nodes[lr].outputs["model"].coef, outs[lr2]["model"].coef)


def test_a_workflow_saved_by_the_jax_package_loads_and_runs(jsess, session, tmp_path):
    """The reference's JSON (node widgets, settings, links) loads here, runs,
    and serializes back to the same text."""
    from orange3_spark_tpu import datasets as jds

    jiris = jds.load_iris(jsess)
    jg = JGraph()
    s = jg.add(jcat.OWTable(jiris))
    sel = jg.add(jcat.WIDGET_REGISTRY["OWSelectRows"](
        conditions=(("petal length (cm)", ">", 1.5),)))
    sc = jg.add(jcat.WIDGET_REGISTRY["OWStandardScaler"](with_mean=True))
    lr = jg.add(jcat.WIDGET_REGISTRY["OWLogisticRegression"](max_iter=60, reg_param=1e-3))
    ev = jg.add(jcat.WIDGET_REGISTRY["OWMulticlassEvaluator"](metric_name="accuracy"))
    jg.connect(s, "data", sel, "data")
    jg.connect(sel, "data", sc, "data")
    jg.connect(sc, "data", lr, "data")
    jg.connect(lr, "data", ev, "data")
    path = tmp_path / "wf.json"
    jg.save(str(path))
    g = WorkflowGraph.load(str(path))
    assert g.to_json() == jg.to_json()
    src = [n for n, node in g.nodes.items() if node.widget.name == "OWTable"][0]
    g.nodes[src].widget.table = load_iris(session)
    ev2 = [n for n, node in g.nodes.items() if node.widget.name == "OWMulticlassEvaluator"][0]
    lr2 = [n for n, node in g.nodes.items() if node.widget.name == "OWLogisticRegression"][0]
    jouts = jg.run()
    outs = g.run()
    assert outs[ev2]["score"] == pytest.approx(jouts[ev]["score"], abs=1e-6)
    ref = to_np(jouts[lr]["model"].coef)
    assert_port_equal(ref, outs[lr2]["model"].coef, atol=1e-4 * np.abs(ref).max(),
                      what="coef")
    with pytest.raises(ValueError, match="unknown widget"):   # the reference's, not ported
        WorkflowGraph.from_json('{"version": 1, "nodes": [{"id": 0, "widget": '
                                '"OWStreamingLinearEstimator"}], "edges": []}')


# ------------------------------------------------------------------ staging
def test_staged_path_matches_eager(session):
    g, src, sc, lr, iris = _simple_graph(session)
    g.run()
    staged = stage_transform_path(g, src, lr)
    _eq(staged(iris), g.nodes[lr].outputs["data"])
    assert staged.graph_segments == 1 and staged.segments[0]["kind"] == "graph"
    with pytest.raises(ValueError, match="domain"):
        staged(make_classification(50, 4, 3, seed=1, session=session))


def test_staged_path_on_new_data(session):
    t = make_classification(512, 6, n_classes=2, seed=20, session=session)
    g = WorkflowGraph()
    src = g.add(OWTable(t))
    sc = g.add(WIDGET_REGISTRY["OWStandardScaler"]())
    lr = g.add(WIDGET_REGISTRY["OWLogisticRegression"](max_iter=50))
    g.connect(src, "data", sc, "data")
    g.connect(sc, "data", lr, "data")
    g.run()
    staged = stage_transform_path(g, src, lr)
    fresh = make_classification(300, 6, n_classes=2, seed=21, session=session)
    out = staged(fresh)      # a new shape builds a new program
    model, scaler = g.nodes[lr].outputs["model"], g.nodes[sc].outputs["model"]
    _eq(out, model.transform(scaler.transform(fresh)))
    assert out.n_rows == 300


def test_staged_dag_branches_merge_one_program(session):
    iris = load_iris(session)
    g = WorkflowGraph()
    src = g.add(OWTable(iris))
    sc = g.add(WIDGET_REGISTRY["OWStandardScaler"](with_mean=True))
    lr = g.add(WIDGET_REGISTRY["OWLogisticRegression"](max_iter=100))
    pca = g.add(WIDGET_REGISTRY["OWPCA"](k=2))
    merge = g.add(WIDGET_REGISTRY["OWMergeColumns"]())
    g.connect(src, "data", sc, "data")
    g.connect(sc, "data", lr, "data")
    g.connect(sc, "data", pca, "data")
    g.connect(lr, "data", merge, "left")
    g.connect(pca, "data", merge, "right")
    eager = g.run()[merge]["data"]
    staged = stage_graph(g, merge)
    assert staged.input_keys == [(src, "data")]
    assert [f["widget"] for f in staged.frontier] == ["OWTable"]
    assert staged.graph_segments == 1
    _eq(staged(), eager)
    _eq(staged({src: load_iris(session)}), eager)


def test_staged_dag_apply_model_and_frontier(session):
    t = make_classification(512, 6, n_classes=2, seed=21, session=session)
    g = WorkflowGraph()
    src = g.add(OWTable(t))
    lr = g.add(WIDGET_REGISTRY["OWLogisticRegression"](max_iter=50))
    ap = g.add(OWApplyModel())
    g.connect(src, "data", lr, "data")
    g.connect(src, "data", ap, "data")
    g.connect(lr, "model", ap, "model")
    eager = g.run()[ap]["data"]
    _eq(stage_graph(g, ap)(), eager)
    info = g.add(WIDGET_REGISTRY["OWDataInfo"]())
    g.connect(ap, "data", info, "data")
    with pytest.raises(ValueError, match="not stageable"):
        stage_graph(g, info)


def test_merge_columns_device_pure(session):
    t = load_iris(session)
    m = merge_columns(t, t)
    names = [v.name for v in m.domain.attributes]
    assert m.n_attrs == 2 * t.n_attrs and len(set(names)) == len(names)
    assert torch.equal(m.W, t.W)
    with pytest.raises(ValueError, match="row-aligned"):
        merge_columns(t, TorchTable.from_arrays(np.ones((3, 1), np.float32), session=session))


def test_select_widgets_and_staging(session):
    rng = np.random.default_rng(4)
    X = rng.standard_normal((300, 4)).astype(np.float32)
    t = TorchTable.from_numpy(Domain([ContinuousVariable(c) for c in "abcd"]), X,
                              session=session)
    g = WorkflowGraph()
    src = g.add(OWTable(t))
    rows = g.add(WIDGET_REGISTRY["OWSelectRows"](conditions=(("a", ">", 0.0), ("b", "<=", 1.0))))
    cols = g.add(WIDGET_REGISTRY["OWSelectColumns"](columns=("a", "c")))
    g.connect(src, "data", rows, "data")
    g.connect(rows, "data", cols, "data")
    out = g.run()[cols]["data"]
    assert [v.name for v in out.domain.attributes] == ["a", "c"]
    np.testing.assert_array_equal(out.to_numpy()[2] > 0, (X[:, 0] > 0) & (X[:, 1] <= 1.0))
    staged = stage_graph(g, cols)
    assert staged.frontier[-1]["reason"].startswith("source")
    _eq(staged(), out)
    with pytest.raises(ValueError, match="unknown op"):
        WIDGET_REGISTRY["OWSelectRows"](conditions=(("a", "~", 1.0),)).process(t)


def test_select_rows_null_and_category_semantics(session):
    t = TorchTable.from_numpy(Domain([ContinuousVariable("a")]),
                              np.array([[1.0], [np.nan], [-1.0]], np.float32), session=session)
    out = SelectRows(conditions=(("a", "!=", 0.0),)).transform(t)
    np.testing.assert_array_equal(out.to_numpy()[2] > 0, [True, False, True])
    with pytest.raises(ValueError, match="no columns"):
        SelectColumns().transform(t)
    region = np.array([0, 1, 2, 1, 0], np.float32)
    t2 = TorchTable.from_numpy(
        Domain([DiscreteVariable("region", ("east", "west", "north")), ContinuousVariable("x")]),
        np.stack([region, np.arange(5, dtype=np.float32)], 1), session=session)
    out = SelectRows(conditions=(("region", "==", "west"),)).transform(t2)
    np.testing.assert_array_equal(out.to_numpy()[2] > 0, region == 1)
    with pytest.raises(ValueError, match="neither numeric nor a category"):
        SelectRows(conditions=(("region", "==", "south"),)).transform(t2)


def test_select_rows_match_the_reference(jsess, session):
    X = np.random.default_rng(9).standard_normal((200, 3)).astype(np.float32)
    X[::7, 1] = np.nan
    conds = (("x0", ">=", -0.5), ("x1", "!=", 0.25), ("x2", "<", 1.0))
    ref = jcat.SelectRows(conditions=conds).transform(TpuTable.from_arrays(X, session=jsess))
    got = SelectRows(conditions=conds).transform(TorchTable.from_arrays(X, session=session))
    assert_port_equal(ref.W, got.W, what="W")


# ---------------------------------------------------------------- refit
def _five_col_table(seed, session):
    r = np.random.default_rng(seed)
    X = (r.standard_normal((256, 5)) * r.gamma(2, 1, 5)).astype(np.float32)
    return TorchTable.from_numpy(Domain([ContinuousVariable(f"f{i}") for i in range(5)]), X,
                                 session=session)


def _scaler_pca_graph(table, k=3):
    g = WorkflowGraph()
    src = g.add(OWTable(table))
    sc = g.add(WIDGET_REGISTRY["OWStandardScaler"](with_mean=True))
    pca = g.add(WIDGET_REGISTRY["OWPCA"](k=k))
    g.connect(src, "data", sc, "data")
    g.connect(sc, "data", pca, "data")
    return g, src, pca


def test_staged_refit_fits_on_the_data_flowing_through(session):
    t0, t1 = _five_col_table(1, session), _five_col_table(2, session)
    g, src, pca = _scaler_pca_graph(t0)
    staged = stage_graph(g, pca, refit=True, donate_inputs=True)
    assert staged.refit_fallbacks == []
    # the scaler is captured on a card; PCA's eigh reads its status on the host
    assert [s["kind"] for s in staged.segments] == ["graph", "eager"]
    assert staged.graph_segments == 1
    _eq(staged(), g.run()[pca]["data"])
    out1 = staged(replacements={src: t1})
    g2, _, p2 = _scaler_pca_graph(t1)
    _eq(out1, g2.run()[p2]["data"])
    served = stage_graph(g, pca)(replacements={src: t1})
    assert not torch.allclose(out1.X, served.X, atol=1e-4)


def test_staged_refit_of_kmeans_is_the_staged_eager_fit(session):
    """KMeans refits with its device init and fixed-trip loop; the result is
    the port's eager run of the same fit inside staging()."""
    t = _five_col_table(3, session)
    g = WorkflowGraph()
    src = g.add(OWTable(t))
    km = g.add(WIDGET_REGISTRY["OWKMeans"](k=4, max_iter=8))
    g.connect(src, "data", km, "data")
    staged = stage_graph(g, km, refit=True)
    assert staged.refit_fallbacks == [] and staged.graph_segments == 1
    out = staged()
    with staging():
        ref = KMeans(k=4, max_iter=8).fit(t).transform(t)
    _eq(out, ref)
    _eq(staged(), out)                                   # the same draws every call
    labels = out.X[:, -1]
    assert len(torch.unique(labels)) >= 2


def test_staged_refit_of_logistic_regression_runs_eagerly(session):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((512, 6)).astype(np.float32)
    y = (X @ rng.standard_normal(6) > 0).astype(np.float32)
    t = TorchTable.from_numpy(Domain([ContinuousVariable(f"f{i}") for i in range(6)],
                                     DiscreteVariable("y", ("0", "1"))), X, y, session=session)
    g = WorkflowGraph()
    src = g.add(OWTable(t))
    lr = g.add(WIDGET_REGISTRY["OWLogisticRegression"](max_iter=30))
    g.connect(src, "data", lr, "data")
    staged = stage_graph(g, lr, refit=True)
    assert staged.refit_fallbacks == []
    assert staged.segments[0]["kind"] == "eager"         # a host-loop minimizer
    assert "reads the device from the host" in staged.segments[0]["reason"]
    _eq(staged(), g.run()[lr]["data"])


def test_refit_fallback_reason_carries_the_actual_error(session):
    """A fit that cannot run staged keeps its eager fitted state and lands
    in refit_fallbacks with the error it raised."""
    @dataclasses.dataclass(frozen=True)
    class HostileParams(Params):
        pass

    class HostileModel(Model):
        def __init__(self, params):
            self.params = params

        def transform(self, table):
            return table

    class HostileEstimator(Estimator):
        ParamsCls = HostileParams

        def _fit(self, table):
            from orange3_spark_tpu_torch.models.base import staging_active

            if staging_active():
                raise NotImplementedError("this fit needs the whole table on the host")
            return HostileModel(self.params)

    hostile = widget_for_estimator(HostileEstimator, "OWHostileTest")
    iris = load_iris(session)
    g = WorkflowGraph()
    src = g.add(OWTable(iris))
    bad = g.add(hostile())
    lr = g.add(WIDGET_REGISTRY["OWLogisticRegression"](max_iter=20))
    g.connect(src, "data", bad, "data")
    g.connect(bad, "data", lr, "data")
    staged = stage_graph(g, lr, refit=True)
    falls = [f for f in staged.refit_fallbacks if f["widget"] == "OWHostileTest"]
    assert len(falls) == 1
    assert "fit cannot run staged" in falls[0]["reason"]
    assert "NotImplementedError: this fit needs the whole table" in falls[0]["reason"]
    assert staged().n_rows == iris.n_rows


def test_staged_program_lives_in_the_serving_cache(session):
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

    g, src, sc, lr, iris = _simple_graph(session)
    staged = stage_graph(g, lr)
    with ServingContext(BucketLadder(min_bucket=16, max_bucket=256)) as ctx:
        out = staged()
        staged()
        keys = [k for k in ctx.cache.keys() if k[0] == "staged"]
    assert len(keys) == 1 and keys[0][1] == id(staged)
    _eq(out, g.nodes[lr].outputs["data"])


# ------------------------------------------------------- the taxi graph
def _taxi_graphs(jsess, session, n=20_000):
    X = make_taxi_proxy(n)
    jdom_ = jdom.Domain([jdom.ContinuousVariable(v.name) for v in taxi_domain().attributes])
    graphs = []
    for cat, G, table in ((jcat, JGraph, TpuTable.from_numpy(jdom_, X, session=jsess)),
                          (None, WorkflowGraph,
                           TorchTable.from_numpy(taxi_domain(), X, session=session))):
        reg = cat.WIDGET_REGISTRY if cat else WIDGET_REGISTRY
        g = G()
        src = g.add((cat.OWTable if cat else OWTable)(table))
        sc = g.add(reg["OWStandardScaler"](with_mean=True))
        pca = g.add(reg["OWPCA"](k=4))
        km = g.add(reg["OWKMeans"](k=10, max_iter=10))
        g.connect(src, "data", sc, "data")
        g.connect(sc, "data", pca, "data")
        g.connect(pca, "data", km, "data")
        graphs.append((g, src, sc, pca, km))
    return X, graphs


def test_taxi_graph_matches_the_jax_package(jsess, session):
    X, ((jg, _, jsc, jpca, jkm), (g, src, sc, pca, km)) = _taxi_graphs(jsess, session)
    jouts, outs = jg.run(), g.run()
    ref_sc, got_sc = jouts[jsc]["model"], outs[sc]["model"]
    assert_port_equal(ref_sc.shift, got_sc.shift, rtol=1e-6, what="scaler shift")
    assert_port_equal(ref_sc.scale, got_sc.scale, rtol=1e-6, what="scaler scale")
    assert_columns_equal_up_to_sign(jouts[jpca]["model"].components,
                                    outs[pca]["model"].components, atol=1e-3,
                                    what="components")
    ids_ref = np.asarray(jouts[jkm]["data"].X[: len(X), -1])
    ids = outs[km]["data"].X[: len(X), -1].numpy()
    # each row's squared distances to the centers in both packages (the
    # port's projections and centers sign-aligned to the reference's PCs):
    # a row's id is decided where its margin (second-nearest minus nearest)
    # exceeds twice the packages' disagreement on its distances
    sign = np.sign(np.sum(to_np(jouts[jpca]["model"].components)
                          * to_np(outs[pca]["model"].components), axis=0))

    def d2(Z, C):
        Z, C = np.asarray(Z, np.float64), np.asarray(C, np.float64)
        return ((Z[:, None, :] - C[None]) ** 2).sum(-1)

    d_ref = d2(to_np(jouts[jpca]["data"].X)[: len(X)], to_np(jouts[jkm]["model"].centers))
    d_got = d2(outs[pca]["data"].X[: len(X)].numpy() * sign,
               outs[km]["model"].centers.numpy() * sign)
    srt = np.sort(d_ref, axis=1)
    decided = srt[:, 1] - srt[:, 0] > 2 * np.abs(d_got - d_ref).max(axis=1)
    assert decided.mean() > 0.99
    assert_port_equal(ids_ref[decided], ids[decided], what="cluster ids")
    assert jouts[jkm]["model"].n_iter_ == outs[km]["model"].n_iter_
    # staged (one program) equals the eager walk bitwise, on the same and new data
    staged = stage_graph(g, km)
    _eq(staged(), outs[km]["data"])
    X2 = make_taxi_proxy(5000, seed=7)
    fresh = TorchTable.from_numpy(taxi_domain(), X2, session=session)
    t = fresh
    for nid in (sc, pca, km):
        t = g.nodes[nid].outputs["model"].transform(t)
    _eq(staged({src: fresh}), t)
    # the refit: the scaler captured, PCA eager (eigh), KMeans captured
    refit = stage_graph(g, km, refit=True)
    assert refit.refit_fallbacks == [] and refit.graph_segments == 2
    assert [s["widgets"] for s in refit.segments] == [["OWStandardScaler"], ["OWPCA"],
                                                      ["OWKMeans"]]
    r1 = refit()
    with staging():
        ref = KMeans(k=10, max_iter=10).fit(outs[pca]["data"]).transform(outs[pca]["data"])
    _eq(r1, ref)
    _eq(refit(), r1)
