"""The streaming evaluators (``evaluate_{binary,multiclass,regression}_
stream``) against the JAX package's, on the CPU and the same numpy chunks,
and the binned AUC against the in-memory evaluator's exact one.

The score functions return a column of the chunk itself, so both packages
fold bit-identical scores: the histograms, the counts and the confusion
matrix must then be equal exactly (weights are small integers, whose
float32 sums are exact in any order), and the AUC from equal histograms
equal. logloss and the regression metrics come from per-chunk float32
sums taken in another order than XLA's, totalled in float64: within
1e-6 relative.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.io.streaming import array_chunk_source as j_source
from orange3_spark_tpu.models import evaluation as jeval
from orange3_spark_tpu_torch import TorchSession, TorchTable
from orange3_spark_tpu_torch.io.streaming import array_chunk_source as t_source
from orange3_spark_tpu_torch.models import evaluation as teval

CHUNK = 700


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def cpu():
    return TorchSession("cpu")


def _weights(n, rng):
    w = rng.integers(0, 3, n).astype(np.float32)      # 0 drops a row, 2 doubles it
    return w


@pytest.mark.parametrize("with_w", [False, True])
def test_binary_stream_matches_reference(jax_session, cpu, with_w):
    rng = np.random.default_rng(0)
    n = 5000
    y = (rng.random(n) < 0.4).astype(np.float32)
    score = np.clip(rng.beta(2, 5, n) + 0.3 * y, 0.0, 1.0).astype(np.float32)
    score[:5] = [0.0, 1.0, 0.5, 1e-9, 1 - 1e-9]      # the clip and the edge bins
    X = np.stack([score, rng.standard_normal(n).astype(np.float32)], axis=1)
    w = _weights(n, rng) if with_w else None
    kw = dict(chunk_rows=1024, n_bins=4096)
    ours = teval.evaluate_binary_stream(lambda Xd: Xd[:, 0],
                                        t_source(X, y, w, chunk_rows=CHUNK), session=cpu, **kw)
    ref = jeval.evaluate_binary_stream(lambda Xd: Xd[:, 0], j_source(X, y, w, chunk_rows=CHUNK),
                                       session=jax_session, **kw)
    assert ours["count"] == ref["count"]
    assert ours["accuracy"] == ref["accuracy"]
    assert ours["auc"] == ref["auc"]
    np.testing.assert_allclose(ours["logloss"], ref["logloss"], rtol=1e-6)
    # the binned AUC against the in-memory evaluator's exact rank AUC:
    # within O(1/n_bins) (ties inside a bin count half)
    t = TorchTable.from_arrays(score[:, None], y, attr_names=["probability_1"],
                               session=cpu)
    if w is not None:
        t = TorchTable.from_numpy(t.domain, score[:, None], y, W=w, session=cpu)
    exact = teval.BinaryClassificationEvaluator().evaluate(t)
    assert abs(ours["auc"] - exact) <= 4.0 / 4096


def test_binary_stream_one_class_and_empty(cpu):
    X = np.full((10, 1), 0.7, np.float32)
    out = teval.evaluate_binary_stream(lambda Xd: Xd[:, 0],
                                       t_source(X, np.ones(10, np.float32)), session=cpu)
    assert np.isnan(out["auc"]) and out["accuracy"] == 1.0 and out["count"] == 10.0
    with pytest.raises(ValueError, match="no chunks"):
        teval.evaluate_binary_stream(lambda Xd: Xd[:, 0],
                                     t_source(X[:0], np.ones(0, np.float32)), session=cpu)
    with pytest.raises(ValueError, match="labeled"):
        teval.evaluate_binary_stream(lambda Xd: Xd[:, 0], t_source(X), session=cpu)


@pytest.mark.parametrize("with_w", [False, True])
def test_multiclass_stream_matches_reference(jax_session, cpu, with_w):
    """Predictions and labels as class ids, some outside [0, k): the
    confusion matrix, the count and the dropped weight exactly; the
    metrics from the same matrix."""
    rng = np.random.default_rng(1)
    n, k = 4000, 4
    y = rng.integers(0, k, n).astype(np.float32)
    pred = np.where(rng.random(n) < 0.7, y, rng.integers(0, k, n)).astype(np.float32)
    pred[::97] = k            # out of range: dropped, and counted as such
    y[::89] = -1
    X = np.stack([pred, y], axis=1)
    w = _weights(n, rng) if with_w else None
    ours = teval.evaluate_multiclass_stream(lambda Xd: Xd[:, 0],
                                            t_source(X, y, w, chunk_rows=CHUNK),
                                            n_classes=k, session=cpu, chunk_rows=1024)
    ref = jeval.evaluate_multiclass_stream(lambda Xd: Xd[:, 0],
                                           j_source(X, y, w, chunk_rows=CHUNK),
                                           n_classes=k, session=jax_session, chunk_rows=1024)
    assert np.array_equal(ours["confusion"], ref["confusion"])
    assert ours["dropped_weight"] == ref["dropped_weight"] > 0
    for m in ("accuracy", "f1", "weightedPrecision", "weightedRecall", "count"):
        assert ours[m] == ref[m], m


@pytest.mark.parametrize("with_w", [False, True])
def test_regression_stream_matches_reference(jax_session, cpu, with_w):
    """Labels with a large mean (the shifted moments keep r2's bits)."""
    rng = np.random.default_rng(2)
    n = 6000
    y = (1e4 + 30 * rng.standard_normal(n)).astype(np.float32)
    pred = (y + 5 * rng.standard_normal(n)).astype(np.float32)
    X = pred[:, None]
    w = _weights(n, rng) if with_w else None
    ours = teval.evaluate_regression_stream(lambda Xd: Xd[:, 0],
                                            t_source(X, y, w, chunk_rows=CHUNK),
                                            session=cpu, chunk_rows=1024)
    ref = jeval.evaluate_regression_stream(lambda Xd: Xd[:, 0],
                                           j_source(X, y, w, chunk_rows=CHUNK),
                                           session=jax_session, chunk_rows=1024)
    assert ours["count"] == ref["count"]
    for m in ("rmse", "mse", "mae", "r2"):
        np.testing.assert_allclose(ours[m], ref[m], rtol=1e-6, err_msg=m)
    # against the in-memory evaluator on the same rows
    live = np.ones(n, bool) if w is None else w > 0
    rmse = np.sqrt(np.average((pred - y)[live] ** 2,
                              weights=None if w is None else w[live]))
    np.testing.assert_allclose(ours["rmse"], rmse, rtol=1e-5)


def test_stream_evaluators_take_a_fitted_models_head(cpu):
    """A streaming fit's model scored by its own probability head on the
    device, as a user would (the card runs the same code)."""
    from orange3_spark_tpu_torch.io.streaming import StreamingLinearEstimator

    rng = np.random.default_rng(3)
    X = rng.standard_normal((3000, 5)).astype(np.float32)
    y = (X @ rng.standard_normal(5) > 0).astype(np.float32)
    model = StreamingLinearEstimator(epochs=3, step_size=0.05, chunk_rows=1024).fit_stream(
        t_source(X, y, chunk_rows=1000), n_features=5, session=cpu)
    head = lambda Xd: torch.softmax(Xd @ model.coef + model.intercept, dim=-1)[:, 1]
    out = teval.evaluate_binary_stream(head, t_source(X, y, chunk_rows=1000), session=cpu,
                                       chunk_rows=1024)
    assert out["auc"] > 0.95 and out["count"] == 3000.0
    ref_acc = float(np.mean(model.predict(TorchTable.from_arrays(X, y, session=cpu)) == y))
    assert abs(out["accuracy"] - ref_acc) < 1e-3
