"""Saving and loading fitted models and workflows (utils/checkpoint.py):
the twins of the reference's round trips (tests/test_model_serialization.py,
tests/test_tuning_checkpoint.py) for the models the port has. A reloaded
model predicts BITWISE what it predicted before it was saved (its tensors
go through numpy unchanged), and a reloaded workflow serves its saved
models without refitting.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.datasets import load_iris, make_classification, make_ratings
from orange3_spark_tpu_torch.models.als import ALS, ALSModel, ratings_table
from orange3_spark_tpu_torch.models.base import predictions_to_numpy
from orange3_spark_tpu_torch.models.gbt import GBTClassifier
from orange3_spark_tpu_torch.models.kmeans import KMeans
from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression
from orange3_spark_tpu_torch.utils import checkpoint
from orange3_spark_tpu_torch.utils.checkpoint import (
    load_model, load_workflow, save_model, save_workflow,
)
from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY, OWTable
from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph


@pytest.fixture(scope="module")
def session():
    return TorchSession.builder_get_or_create("cpu")


@pytest.fixture(scope="module")
def ratings(session):
    return ratings_table(make_ratings(60, 40, 3000, rank=3, seed=21, noise=0.05), session)


def _roundtrip(model, tmp_path):
    save_model(model, str(tmp_path / "m"))
    return load_model(str(tmp_path / "m"))


def test_roundtrip_als(ratings, tmp_path):
    model = ALS(rank=3, max_iter=4, seed=2).fit(ratings)
    again = _roundtrip(model, tmp_path)
    assert isinstance(again, ALSModel) and again.params == model.params
    assert torch.equal(again.user_factors, model.user_factors)
    assert torch.equal(again.item_factors, model.item_factors)
    np.testing.assert_array_equal(predictions_to_numpy(model.transform(ratings)),
                                  predictions_to_numpy(again.transform(ratings)))
    np.testing.assert_array_equal(model.recommend_for_all_users(5),
                                  again.recommend_for_all_users(5))


def test_roundtrip_logistic_regression(session, tmp_path):
    iris = load_iris(session)
    model = LogisticRegression(max_iter=50, reg_param=1e-4).fit(iris)
    again = _roundtrip(model, tmp_path)
    np.testing.assert_array_equal(model.predict_proba(iris), again.predict_proba(iris))
    np.testing.assert_array_equal(model.predict(iris), again.predict(iris))


def test_roundtrip_kmeans(session, tmp_path):
    t = make_classification(400, 4, n_classes=3, seed=5, session=session)
    model = KMeans(k=4, max_iter=10, seed=3).fit(t)
    again = _roundtrip(model, tmp_path)
    np.testing.assert_array_equal(model.predict(t), again.predict(t))
    assert torch.equal(model.centers, again.centers)


def test_roundtrip_gbt(session, tmp_path):
    t = make_classification(500, 5, n_classes=2, seed=6, noise=0.3, session=session)
    model = GBTClassifier(max_iter=4, max_depth=3, max_bins=16).fit(t)
    again = _roundtrip(model, tmp_path)
    np.testing.assert_array_equal(model.predict_proba(t), again.predict_proba(t))


def test_save_is_atomic(ratings, tmp_path, monkeypatch):
    """A save that dies mid-write leaves the previous model.pkl whole and
    no temporary file behind the reader's name."""
    model = ALS(rank=3, max_iter=2, seed=2).fit(ratings)
    path = str(tmp_path / "m")
    save_model(model, path)
    before = open(os.path.join(path, checkpoint.MODEL_FILE), "rb").read()

    def dies(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(pickle, "dump", dies)
    with pytest.raises(OSError, match="disk gone"):
        save_model(ALS(rank=3, max_iter=3, seed=9).fit(ratings), path)
    monkeypatch.undo()
    assert open(os.path.join(path, checkpoint.MODEL_FILE), "rb").read() == before
    assert torch.equal(load_model(path).user_factors, model.user_factors)


def _als_graph(table):
    g = WorkflowGraph()
    src = g.add(OWTable(table))
    als = g.add(WIDGET_REGISTRY["OWALS"](rank=3, max_iter=5, reg_param=0.01, seed=4))
    g.connect(src, "data", als, "data")
    return g, src, als


def test_workflow_kill_and_resume_serves_without_refit(ratings, tmp_path, monkeypatch):
    """Fit an OWALS graph, save it, drop everything, reload it in a fresh
    graph: the reloaded graph serves the saved model (no fit runs) and
    predicts bitwise what the first graph predicted."""
    g, _, als = _als_graph(ratings)
    g.run()
    model = g.nodes[als].outputs["model"]
    before = predictions_to_numpy(g.nodes[als].outputs["data"])
    save_workflow(g, str(tmp_path / "wf"))
    assert sorted(os.listdir(tmp_path / "wf")) == [f"node{als}", checkpoint.WORKFLOW_FILE]
    del g

    g2 = load_workflow(str(tmp_path / "wf"))
    src2 = next(n for n, v in g2.nodes.items() if v.widget.name == "OWTable")
    als2 = next(n for n, v in g2.nodes.items() if v.widget.name == "OWALS")
    g2.nodes[src2].widget.table = ratings

    def no_fit(self, table):
        raise AssertionError("a restored workflow refitted")

    monkeypatch.setattr(ALS, "_fit", no_fit)
    g2.run()
    model2 = g2.nodes[als2].outputs["model"]
    assert g2.nodes[als2].widget.fitted_model is model2
    assert torch.equal(model2.user_factors, model.user_factors)
    np.testing.assert_array_equal(predictions_to_numpy(g2.nodes[als2].outputs["data"]),
                                  before)
    monkeypatch.undo()
    g2.set_params(als2, max_iter=2)        # a new setting refits
    g2.run()
    assert g2.nodes[als2].widget.fitted_model is None
    assert not torch.equal(g2.nodes[als2].outputs["model"].user_factors,
                           model.user_factors)


def test_restored_model_is_dropped_when_upstream_changes(ratings, tmp_path):
    g, src, als = _als_graph(ratings)
    g.run()
    save_workflow(g, str(tmp_path / "wf"))
    g2 = load_workflow(str(tmp_path / "wf"))
    g2.nodes[src].widget.table = ratings
    g2.run()
    assert g2.nodes[als].widget.fitted_model is not None
    g2.invalidate(src)                     # an upstream signal changed
    g2.run()
    assert g2.nodes[als].widget.fitted_model is None
