"""The port's model selection (``models/tuning.py``: ParamGridBuilder,
CrossValidator, TrainValidationSplit) against the JAX package's, on the
same seeded numpy tables.

The fold ids are the reference's draw (``randint(PRNGKey(seed), (n_pad,),
0, num_folds)`` through ``ops/prng``): bitwise on every live row, whatever
each package pads to. The per-fold fits are LogisticRegression fits,
which tests/test_torch_linear.py holds to the reference within 1e-4, so the
fold metrics (AUC, rmse) agree within 1e-4 and the best point is the same.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.models import evaluation as JE
from orange3_spark_tpu.models import tuning as JT
from orange3_spark_tpu.models.base import Pipeline as JPipeline
from orange3_spark_tpu.models.linear_regression import LinearRegression as JLinR
from orange3_spark_tpu.models.logistic_regression import LogisticRegression as JLR
from orange3_spark_tpu.models.preprocess import StandardScaler as JSS
from orange3_spark_tpu_torch import interop
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.models import evaluation as TE
from orange3_spark_tpu_torch.models import tuning as TT
from orange3_spark_tpu_torch.models.base import Pipeline as TPipeline
from orange3_spark_tpu_torch.models.linear_regression import LinearRegression as TLinR
from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression as TLR
from orange3_spark_tpu_torch.models.preprocess import StandardScaler as TSS

from _port_parity import assert_port_equal, to_np
from _torch_tables import table_pair


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession.builder_get_or_create("cpu")


def _binary(jsess, tsess, n=601, d=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X @ np.linspace(1.0, -0.5, d) + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    cols = [(f"x{i}", None) for i in range(d)]
    return table_pair(jsess, tsess, cols, X, Y=y, class_var=("y", ("0", "1")))


def test_param_grid_builder_is_the_references():
    j = JT.ParamGridBuilder().add_grid("reg_param", [0.1, 0.01]).add_grid(
        "max_iter", [5, 10, 20]).build()
    t = TT.ParamGridBuilder().add_grid("reg_param", [0.1, 0.01]).add_grid(
        "max_iter", [5, 10, 20]).build()
    assert t == j and len(t) == 6


@pytest.mark.parametrize("seed,folds", [(0, 3), (7, 5)])
def test_fold_ids_are_the_references(jsess, tsess, seed, folds):
    jt, tt = _binary(jsess, tsess)
    j = JT.CrossValidator(JLR(), [{}], JE.BinaryClassificationEvaluator(),
                          num_folds=folds, seed=seed)._fold_masks(jt)
    t = TT.CrossValidator(TLR(), [{}], TE.BinaryClassificationEvaluator(),
                          num_folds=folds, seed=seed)._fold_masks(tt)
    n = tt.n_rows
    np.testing.assert_array_equal(to_np(t)[:n], to_np(j)[:n])
    assert t.shape[0] == tt.n_pad and set(to_np(t)[:n].tolist()) == set(range(folds))


def test_cross_validator_matches_reference(jsess, tsess):
    jt, tt = _binary(jsess, tsess)
    grid = [{"reg_param": 1e-4}, {"reg_param": 1.0}]
    jm = JT.CrossValidator(JLR(max_iter=50), grid, JE.BinaryClassificationEvaluator(),
                           num_folds=3).fit(jt)
    tm = TT.CrossValidator(TLR(max_iter=50), grid, TE.BinaryClassificationEvaluator(),
                           num_folds=3).fit(tt)
    np.testing.assert_allclose(tm.avg_metrics, jm.avg_metrics, atol=1e-4)
    assert tm.best_params == jm.best_params == {"reg_param": 1e-4}
    assert_port_equal(jm.best_model.coef, tm.best_model.coef, atol=1e-4, what="best coef")
    out = tm.transform(tt)
    assert [v.name for v in out.domain.attributes][-1] == "prediction"
    conv = interop.cross_validator_model(
        interop.logistic_regression({k: to_np(v) for k, v in jm.best_model.state_pytree.items()},
                                    jm.best_model.params.to_dict(),
                                    jm.best_model.class_values),
        jm.params.to_dict(), jm.best_params, jm.avg_metrics)
    assert conv.best_params == tm.best_params
    # a reload of the state reaches the best model (its coefficients)
    state = {k: torch.from_numpy(to_np(v).copy()) for k, v in jm.best_model.state_pytree.items()}
    tm.load_state_pytree(state)
    assert torch.equal(tm.best_model.coef, state["coef"])
    n = tt.n_rows
    np.testing.assert_array_equal(conv.transform(tt).X.numpy()[:n, -1],
                                  to_np(jm.transform(jt).X)[:n, -1])


def test_cross_validator_smaller_is_better_for_rmse(jsess, tsess):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((400, 3)).astype(np.float32)
    y = (X @ np.array([1.0, -2.0, 0.5]) + 0.1 * rng.standard_normal(400)).astype(np.float32)
    jt, tt = table_pair(jsess, tsess, [(f"x{i}", None) for i in range(3)], X, Y=y,
                        class_var=("y", None))
    grid = [{"reg_param": 10.0}, {"reg_param": 0.0}]
    jm = JT.CrossValidator(JLinR(), grid, JE.RegressionEvaluator(metric_name="rmse")).fit(jt)
    tm = TT.CrossValidator(TLinR(), grid, TE.RegressionEvaluator(metric_name="rmse")).fit(tt)
    np.testing.assert_allclose(tm.avg_metrics, jm.avg_metrics, rtol=1e-4)
    assert tm.best_params == jm.best_params == {"reg_param": 0.0}


def test_train_validation_split_matches_reference(jsess, tsess):
    jt, tt = _binary(jsess, tsess, seed=3)
    grid = [{"reg_param": 1e-3}, {"reg_param": 3.0}]
    kw = dict(train_ratio=0.7, seed=5)
    jm = JT.TrainValidationSplit(JLR(max_iter=50), grid, JE.BinaryClassificationEvaluator(),
                                 **kw).fit(jt)
    tm = TT.TrainValidationSplit(TLR(max_iter=50), grid, TE.BinaryClassificationEvaluator(),
                                 **kw).fit(tt)
    np.testing.assert_allclose(tm.avg_metrics, jm.avg_metrics, atol=1e-4)
    assert tm.best_params == jm.best_params
    conv = interop.cross_validator_model(tm.best_model, jm.params.to_dict(), jm.best_params,
                                         jm.avg_metrics)
    assert conv.params == tm.params and conv.avg_metrics == [float(m) for m in jm.avg_metrics]


def test_pipeline_grid_routing_and_errors(jsess, tsess):
    """A plain key goes to the LAST stage declaring it, ``i__name`` to stage
    i; the reference's errors, word for word."""
    jp = JPipeline([JSS(), JLR(max_iter=30)])
    tp = TPipeline([TSS(), TLR(max_iter=30)])
    for point in ({"reg_param": 0.5}, {"1__max_iter": 7, "0__with_mean": True}):
        jc, tc = JT._with_params(jp, point), TT._with_params(tp, point)
        for js, ts in zip(jc.stages, tc.stages):
            assert ts.params.to_dict() == js.params.to_dict()
    assert tp.stages[1].params.reg_param == 0.0          # the original is untouched
    for point in ({"x__reg_param": 1}, {"5__reg_param": 1}, {"0__reg_param": 1},
                  {"nope": 1}):
        with pytest.raises(ValueError) as want:
            JT._with_params(jp, point)
        with pytest.raises(ValueError) as got:
            TT._with_params(tp, point)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        TT._with_params(TLR(), {"nope": 1})
    jt, tt = _binary(jsess, tsess, seed=4)
    jm = JT.CrossValidator(jp, [{"reg_param": 1e-3}, {"reg_param": 2.0}],
                           JE.BinaryClassificationEvaluator(), num_folds=2).fit(jt)
    tm = TT.CrossValidator(tp, [{"reg_param": 1e-3}, {"reg_param": 2.0}],
                           TE.BinaryClassificationEvaluator(), num_folds=2).fit(tt)
    np.testing.assert_allclose(tm.avg_metrics, jm.avg_metrics, atol=1e-4)
    assert tm.best_params == jm.best_params
