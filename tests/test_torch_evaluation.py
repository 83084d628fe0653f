"""The port's in-memory evaluators (models/evaluation.py) against the JAX
package's on the same scored tables: ties, user weights, filtered rows,
explicit columns.

Tolerances: with unit (or zero) weights every sum is of integers and the
metrics equal the reference's to 1e-7; with random float weights the
cumulative sums run in another order (the port's CPU cumsum accumulates
in double), 1e-6; the confusion matrix is then within 1e-6 relative
(bitwise with integer weights). The regression metrics sum float errors:
1e-5 relative.
"""

import jax
import numpy as np
import pytest

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core import domain as jdom
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.core.table import TpuTable
from orange3_spark_tpu.models import evaluation as jev
from orange3_spark_tpu_torch.core import domain as tdom
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models import evaluation as tev

from _port_parity import assert_port_equal


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession("cpu")


def _weights(rng, n, kind):
    if kind == "unit":
        return np.ones(n, np.float32)
    if kind == "filtered":
        W = np.ones(n, np.float32)
        W[rng.random(n) < 0.3] = 0.0
        return W
    W = rng.uniform(0.1, 3.0, n).astype(np.float32)
    W[rng.random(n) < 0.2] = 0.0
    return W


def _scored(jsess, tsess, cols, label, W, class_values=None):
    """Both packages' tables of the score columns ``cols`` {name: values}
    and a class column."""
    names = list(cols)
    X = np.stack([cols[n] for n in names], axis=1).astype(np.float32)

    def dom(m):
        attrs = [m.DiscreteVariable(n, class_values) if n == "prediction" and class_values
                 else m.ContinuousVariable(n) for n in names]
        cvar = (m.DiscreteVariable("y", class_values) if class_values
                else m.ContinuousVariable("y"))
        return m.Domain(attrs, cvar)

    return (TpuTable.from_numpy(dom(jdom), X, label, W=W, session=jsess),
            TorchTable.from_numpy(dom(tdom), X, label, W=W, session=tsess))


def _tol(kind):
    return 1e-6 if kind == "random" else 1e-7


@pytest.mark.parametrize("weights", ["unit", "filtered", "random"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("metric", ["areaUnderROC", "areaUnderPR"])
def test_binary_auc(jsess, tsess, weights, ties, metric):
    rng = np.random.default_rng(11)
    n = 1500
    y = (rng.random(n) < 0.4).astype(np.float32)
    score = rng.random(n).astype(np.float32) + 0.3 * y
    if ties:
        score = np.round(score * 8) / 8
    jt, tt = _scored(jsess, tsess, {"probability_0": 1 - score, "probability_1": score},
                     y, _weights(rng, n, weights), ("0", "1"))
    ref = jev.BinaryClassificationEvaluator(metric_name=metric).evaluate(jt)
    got = tev.BinaryClassificationEvaluator(metric_name=metric).evaluate(tt)
    assert isinstance(got, float)
    assert got == pytest.approx(ref, abs=_tol(weights))


@pytest.mark.parametrize("metric", ["areaUnderROC", "areaUnderPR"])
def test_binary_all_equal_scores(jsess, tsess, metric):
    """Order among ties never matters: all-equal scores give ROC AUC 0.5."""
    n = 300
    y = (np.arange(n) % 3 == 0).astype(np.float32)
    jt, tt = _scored(jsess, tsess, {"rawPrediction": np.zeros(n)}, y, np.ones(n, np.float32))
    got = tev.BinaryClassificationEvaluator(metric_name=metric).evaluate(tt)
    assert got == pytest.approx(
        jev.BinaryClassificationEvaluator(metric_name=metric).evaluate(jt), abs=1e-7)
    if metric == "areaUnderROC":
        assert got == 0.5


@pytest.mark.parametrize("cols,params", [
    ({"rawPrediction": None}, {}),
    ({"probability_a": None, "probability_b": None}, {}),
    ({"s": None, "probability_1": None}, {"probability_col": "s"}),
    ({"rawPrediction": None, "lab": "label"}, {"label_col": "lab"}),
])
def test_binary_score_and_label_columns(jsess, tsess, cols, params):
    """The score column: probability_col, else probability_1, else the last
    probability_<c>, else rawPrediction; label_col overrides the class."""
    rng = np.random.default_rng(4)
    n = 400
    y = (rng.random(n) < 0.5).astype(np.float32)
    lab = 1.0 - y
    vals = {k: (lab if v == "label" else rng.standard_normal(n) + y) for k, v in cols.items()}
    jt, tt = _scored(jsess, tsess, vals, y, np.ones(n, np.float32))
    for metric in ("areaUnderROC", "areaUnderPR"):
        ref = jev.BinaryClassificationEvaluator(metric_name=metric, **params).evaluate(jt)
        got = tev.BinaryClassificationEvaluator(metric_name=metric, **params).evaluate(tt)
        assert got == pytest.approx(ref, abs=1e-7)


def test_binary_errors(jsess, tsess):
    _, tt = _scored(jsess, tsess, {"x": np.zeros(4)}, np.zeros(4, np.float32),
                    np.ones(4, np.float32))
    with pytest.raises(ValueError, match="transform first"):
        tev.BinaryClassificationEvaluator().evaluate(tt)
    _, tt = _scored(jsess, tsess, {"rawPrediction": np.zeros(4)}, np.zeros(4, np.float32),
                    np.ones(4, np.float32))
    with pytest.raises(ValueError, match="unknown metric"):
        tev.BinaryClassificationEvaluator(metric_name="nope").evaluate(tt)


@pytest.mark.parametrize("weights", ["unit", "filtered", "random"])
@pytest.mark.parametrize("k", [2, 4])
def test_multiclass(jsess, tsess, weights, k):
    rng = np.random.default_rng(2 + k)
    n = 900
    y = rng.integers(0, k, n).astype(np.float32)
    pred = np.where(rng.random(n) < 0.7, y, rng.integers(0, k, n)).astype(np.float32)
    cv = tuple(str(c) for c in range(k))
    jt, tt = _scored(jsess, tsess, {"prediction": pred}, y, _weights(rng, n, weights), cv)
    jev_, tev_ = jev.MulticlassClassificationEvaluator(), tev.MulticlassClassificationEvaluator()
    C = tev_.confusion(tt)
    assert_port_equal(jev_.confusion(jt), C, rtol=1e-6 if weights == "random" else 0.0)
    assert C.shape == (k, k)
    for metric in ("accuracy", "f1", "weightedPrecision", "weightedRecall"):
        ref = jev.MulticlassClassificationEvaluator(metric_name=metric).evaluate(jt)
        got = tev.MulticlassClassificationEvaluator(metric_name=metric).evaluate(tt)
        assert got == pytest.approx(ref, abs=_tol(weights)), metric
    with pytest.raises(ValueError, match="unknown metric"):
        tev_.from_confusion(C, "nope")


@pytest.mark.parametrize("weights", ["unit", "filtered", "random"])
@pytest.mark.parametrize("metric", ["rmse", "mse", "mae", "r2"])
def test_regression(jsess, tsess, weights, metric):
    rng = np.random.default_rng(8)
    n = 700
    y = rng.standard_normal(n).astype(np.float32) * 3
    pred = (y + rng.standard_normal(n)).astype(np.float32)
    jt, tt = _scored(jsess, tsess, {"prediction": pred}, y, _weights(rng, n, weights))
    ref = jev.RegressionEvaluator(metric_name=metric).evaluate(jt)
    got = tev.RegressionEvaluator(metric_name=metric).evaluate(tt)
    assert got == pytest.approx(ref, rel=1e-5)


def test_regression_default_metric_and_label_col(jsess, tsess):
    rng = np.random.default_rng(1)
    n = 200
    y = rng.standard_normal(n).astype(np.float32)
    other = rng.standard_normal(n).astype(np.float32)
    jt, tt = _scored(jsess, tsess, {"prediction": y, "other": other}, y,
                     np.ones(n, np.float32))
    assert tev.RegressionEvaluator().evaluate(tt) == 0.0
    ref = jev.RegressionEvaluator(label_col="other").evaluate(jt)
    assert tev.RegressionEvaluator(label_col="other").evaluate(tt) == pytest.approx(ref, rel=1e-6)
    with pytest.raises(ValueError, match="unknown metric"):
        tev.RegressionEvaluator(metric_name="nope").evaluate(tt)
