"""The port's supervised estimators of MLlib (NaiveBayes, the GLM family,
IsotonicRegression, AFTSurvivalRegression, the MLP, the FMs, OneVsRest,
RFormula) against the JAX package's, fit on the same seeded numpy tables
(hundreds to a few thousand rows, narrow widths), and their widgets,
``interop`` converters and checkpoints.

Tolerances, with their reasons:

- NaiveBayes: the per-class sums are products whose float32 order differs
  between XLA's dot and torch's (rtol 1e-5 on the factors); the
  predictions equal.
- Isotonic: PAV runs on the host in Python floats in both packages
  (bitwise boundaries and values); the interpolation writes out
  ``jnp.interp`` with its fused multiply-add (within 1 ulp).
- GLM: IRLS from the same start; each iteration's Gram and its Cholesky
  solve sum in other orders (coefficients within 2e-4 of max(1, |b|), the
  deviance and AIC within 1e-4 relative, the iteration count equal).
- AFT, the MLP, FM: the minimizers run the reference's steps (L-BFGS with
  the zoom linesearch, sgd, adam) from the reference's initial point (the
  MLP's and FM's weights are its ``jax.random`` draws, ``ops/prng``); the
  gradients differ in float32 order, which a few dozen iterations grow to
  about 1e-4 relative (stated at each test).
- OneVsRest: its LogisticRegression fits, as tests/test_torch_linear.py
  holds them (1e-4).
- RFormula: one-hots, products and gathers: bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.models import aft as JAFT
from orange3_spark_tpu.models import fm as JFM
from orange3_spark_tpu.models import glm as JGLM
from orange3_spark_tpu.models import isotonic as JISO
from orange3_spark_tpu.models import mlp as JMLP
from orange3_spark_tpu.models import naive_bayes as JNB
from orange3_spark_tpu.models import one_vs_rest as JOVR
from orange3_spark_tpu.models import rformula as JRF
from orange3_spark_tpu.models.logistic_regression import LogisticRegression as JLR
from orange3_spark_tpu_torch import interop
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.models import aft as TAFT
from orange3_spark_tpu_torch.models import fm as TFM
from orange3_spark_tpu_torch.models import glm as TGLM
from orange3_spark_tpu_torch.models import isotonic as TISO
from orange3_spark_tpu_torch.models import mlp as TMLP
from orange3_spark_tpu_torch.models import naive_bayes as TNB
from orange3_spark_tpu_torch.models import one_vs_rest as TOVR
from orange3_spark_tpu_torch.models import rformula as TRF
from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression as TLR
from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext
from orange3_spark_tpu_torch.utils.checkpoint import load_model, save_model
from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY, OWTable
from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph

from _port_parity import assert_port_equal, to_np
from _torch_tables import table_pair


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession.builder_get_or_create("cpu")


def _cont(d, prefix="x"):
    return [(f"{prefix}{i}", None) for i in range(d)]


def _pair(jsess, tsess, X, y, class_values=None, cols=None):
    cols = cols or _cont(X.shape[1])
    cvar = ("y", class_values) if class_values else ("y", None)
    return table_pair(jsess, tsess, cols, X, Y=y, class_var=cvar)


def _rel(ref, got):
    ref, got = to_np(ref).astype(np.float64), to_np(got).astype(np.float64)
    return float(np.max(np.abs(ref - got) / np.maximum(1.0, np.abs(ref))))


# --------------------------------------------------------------- NaiveBayes
def _nb_data(model_type, n=700, d=6, k=3, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n).astype(np.float32)
    if model_type == "gaussian":
        X = rng.standard_normal((n, d)) + y[:, None] * np.linspace(0.2, 1.2, d)
    elif model_type == "bernoulli":
        X = rng.random((n, d)) < (0.2 + 0.2 * y[:, None] * np.linspace(0, 1, d))
    else:
        X = rng.poisson(1.0 + y[:, None] * np.linspace(0.2, 2.0, d))
    return X.astype(np.float32), y


@pytest.mark.parametrize("model_type", TNB.MODEL_TYPES)
def test_naive_bayes_matches_reference(jsess, tsess, model_type):
    X, y = _nb_data(model_type)
    jt, tt = _pair(jsess, tsess, X, y, ("a", "b", "c"))
    kw = dict(model_type=model_type, smoothing=0.5)
    jm, tm = JNB.NaiveBayes(**kw).fit(jt), TNB.NaiveBayes(**kw).fit(tt)
    assert set(tm.state_pytree) == set(jm.state_pytree)
    for key, ref in jm.state_pytree.items():
        assert_port_equal(ref, tm.state_pytree[key], rtol=1e-5, atol=1e-6, what=key)
    np.testing.assert_array_equal(tm.predict(tt), jm.predict(jt))
    assert_port_equal(jm.predict_proba(jt), tm.predict_proba(tt), atol=1e-5, what="proba")
    names = [v.name for v in tm.transform(tt).domain.attributes]
    assert names == [v.name for v in jm.transform(jt).domain.attributes]
    # the interop converter: the JAX model's state gives the same predictions
    state = {k: to_np(v) for k, v in jm.state_pytree.items()}
    conv = interop.naive_bayes_model(state, jm.params.to_dict(), jm.class_values)
    np.testing.assert_array_equal(conv.predict(tt), jm.predict(jt))


def test_naive_bayes_rejects_what_mllib_rejects(tsess):
    from orange3_spark_tpu_torch.core.table import TorchTable

    X, y = _nb_data("gaussian")
    t = TorchTable.from_arrays(X, y, class_values=("a", "b", "c"), session=tsess)
    with pytest.raises(ValueError, match="nonnegative"):
        TNB.NaiveBayes(model_type="multinomial").fit(t)
    Xb = np.abs(X)
    tb = TorchTable.from_arrays(Xb, y, class_values=("a", "b", "c"), session=tsess)
    with pytest.raises(ValueError, match="0/1"):
        TNB.NaiveBayes(model_type="bernoulli").fit(tb)
    with pytest.raises(ValueError, match="model_type"):
        TNB.NaiveBayes(model_type="poisson").fit(tb)


# ------------------------------------------------------------------ isotonic
@pytest.mark.parametrize("isotonic", [True, False])
def test_isotonic_matches_reference(jsess, tsess, isotonic):
    rng = np.random.default_rng(3)
    n = 800
    x = np.round(rng.uniform(0, 10, n), 1)            # ties in x
    y = (np.sqrt(x) if isotonic else -np.sqrt(x)) + 0.4 * rng.standard_normal(n)
    X = np.stack([rng.standard_normal(n), x], 1).astype(np.float32)
    jt, tt = _pair(jsess, tsess, X, y.astype(np.float32))
    kw = dict(isotonic=isotonic, feature_index=1)
    jm, tm = JISO.IsotonicRegression(**kw).fit(jt), TISO.IsotonicRegression(**kw).fit(tt)
    assert_port_equal(jm.boundaries, tm.boundaries, what="boundaries")
    assert_port_equal(jm.predictions, tm.predictions, what="predictions")
    steps = np.diff(to_np(tm.predictions))
    assert (steps >= 0).all() if isotonic else (steps <= 0).all()
    xq = np.linspace(-1, 11, 997).astype(np.float32)   # both extrapolation ends
    Xq = np.stack([np.zeros_like(xq), xq], 1)
    jq, tq = _pair(jsess, tsess, Xq, np.zeros_like(xq))
    ref, got = jm.predict(jq), tm.predict(tq)
    assert np.abs(ref.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64)).max() <= 1
    conv = interop.isotonic_model({k: to_np(v) for k, v in jm.state_pytree.items()},
                                  jm.params.to_dict())
    np.testing.assert_array_equal(conv.predict(tq), got)


# ------------------------------------------------------------------------ GLM
_GLM_CASES = [
    ("gaussian", "identity", {}), ("gaussian", "log", {}),
    ("binomial", "logit", {}), ("binomial", "probit", {}), ("binomial", "cloglog", {}),
    ("poisson", "log", {}), ("poisson", "sqrt", {}), ("poisson", "identity", {}),
    ("gamma", "inverse", {}), ("gamma", "log", {}),
    ("tweedie", "", {"variance_power": 1.5}), ("tweedie", "", {"variance_power": 1.5,
                                                               "link_power": 0.5}),
    ("gaussian", "identity", {"reg_param": 0.1}), ("poisson", "log", {"reg_param": 0.05}),
    ("binomial", "logit", {"fit_intercept": False}),
]


def _glm_data(family, link, n=500, d=3, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32) * 0.5
    eta = X @ np.array([0.4, -0.3, 0.2][:d]) + 0.3
    if family == "gaussian":
        mu = np.exp(eta) if link == "log" else eta
        y = mu + 0.3 * rng.standard_normal(n)
    elif family == "binomial":
        y = (rng.random(n) < 1 / (1 + np.exp(-2 * eta))).astype(np.float64)
    elif family == "poisson":
        y = rng.poisson(np.exp(eta) + (1.0 if link != "log" else 0.0))
    elif family == "gamma":
        y = rng.gamma(3.0, np.exp(eta) / 3.0)
    else:   # tweedie: a compound Poisson-gamma, zeros included
        y = np.where(rng.random(n) < 0.2, 0.0, rng.gamma(2.0, np.exp(eta) / 2.0))
    return X, y.astype(np.float32)


@pytest.mark.parametrize("family,link,extra", _GLM_CASES)
def test_glm_matches_reference(jsess, tsess, family, link, extra):
    X, y = _glm_data(family, link)
    jt, tt = _pair(jsess, tsess, X, y)
    kw = dict(family=family, link=link, **extra)
    jm = JGLM.GeneralizedLinearRegression(**kw).fit(jt)
    tm = TGLM.GeneralizedLinearRegression(**kw).fit(tt)
    assert tm.n_iter_ == jm.n_iter_
    assert _rel(jm.coef, tm.coef) < 2e-4 and _rel(jm.intercept, tm.intercept) < 2e-4
    for name in ("deviance_", "null_deviance_", "dispersion_", "aic_"):
        a, b = getattr(jm, name), getattr(tm, name)
        if a is None or np.isnan(a):
            assert b is None or np.isnan(b), name
        else:
            assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), (name, a, b)
    if extra.get("reg_param", 0.0) == 0.0:
        for name in ("coefficient_standard_errors_", "t_values_", "p_values_"):
            assert _rel(getattr(jm, name), getattr(tm, name)) < 1e-3, name
    else:
        assert tm.p_values_ is None
    assert_port_equal(jm.predict(jt), tm.predict(tt), rtol=2e-4, atol=1e-5, what="mu")
    conv = interop.glm_model({k: to_np(v) for k, v in jm.state_pytree.items()},
                             jm.params.to_dict(), jm.link, jm.link_power)
    assert_port_equal(jm.predict_link(jt), conv.predict_link(tt), rtol=1e-6, atol=1e-6,
                      what="eta")


def test_glm_rejects_unknown_family_and_link(tsess):
    X, y = _glm_data("gaussian", "identity")
    from orange3_spark_tpu_torch.core.table import TorchTable

    t = TorchTable.from_arrays(X, y, session=tsess)
    with pytest.raises(ValueError, match="family"):
        TGLM.GeneralizedLinearRegression(family="beta").fit(t)
    with pytest.raises(ValueError, match="link"):
        TGLM.GeneralizedLinearRegression(family="gaussian", link="tan").fit(t)


# ------------------------------------------------------------------------ AFT
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_aft_matches_reference(jsess, tsess, fit_intercept):
    rng = np.random.default_rng(5)
    n, d = 600, 3
    X = rng.standard_normal((n, d)) * 0.5
    scale = 0.7
    t = np.exp(X @ np.array([0.5, -0.4, 0.2]) + 1.0 + scale * np.log(rng.exponential(1.0, n)))
    censor = (rng.random(n) > 0.3).astype(np.float64)       # 30 % right-censored
    Xc = np.concatenate([X, censor[:, None]], 1).astype(np.float32)
    cols = _cont(d) + [("censor", None)]
    jt, tt = _pair(jsess, tsess, Xc, t.astype(np.float32), cols=cols)
    kw = dict(fit_intercept=fit_intercept, max_iter=50)
    jm, tm = JAFT.AFTSurvivalRegression(**kw).fit(jt), TAFT.AFTSurvivalRegression(**kw).fit(tt)
    # L-BFGS from zero, gradients in another float32 order: 1e-4
    assert _rel(jm.coef, tm.coef) < 1e-4
    assert _rel(jm.intercept, tm.intercept) < 1e-4 and _rel(jm.scale, tm.scale) < 1e-4
    if fit_intercept:     # the data's own scale (without b0 the fit absorbs the offset)
        assert abs(float(to_np(tm.scale)) - scale) < 0.1
    assert_port_equal(jm.predict(jt), tm.predict(tt), rtol=5e-4, what="predict")
    assert_port_equal(jm.predict_quantiles(jt), tm.predict_quantiles(tt), rtol=5e-4,
                      what="quantiles")
    conv = interop.aft_model({k: to_np(v) for k, v in jm.state_pytree.items()},
                             jm.params.to_dict(), jm.feature_indices)
    assert_port_equal(jm.predict(jt), conv.predict(tt), rtol=1e-6, what="converted")


# ------------------------------------------------------------------------ MLP
def _mlp_data(n=600, d=5, k=3, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.argmax(X[:, :k] + 0.5 * X[:, k - 1:k + k - 1] ** 2, 1)).astype(np.float32)
    return X, y


def test_mlp_init_is_the_reference_draw():
    """``_init_net``'s split chain and bounded uniforms: bitwise the
    reference's initial net."""
    ref = JMLP._init_net((28, 64, 64, 2), 0)
    got = TMLP._init_net((28, 64, 64, 2), 0, "cpu")
    for r, g in zip(ref, got):
        for key in ("W", "b"):
            assert np.array_equal(to_np(r[key]).view(np.uint32), to_np(g[key]).view(np.uint32))


@pytest.mark.parametrize("solver,max_iter,tol", [("l-bfgs", 15, 2e-4), ("gd", 40, 1e-5)])
def test_mlp_matches_reference(jsess, tsess, solver, max_iter, tol):
    """From the reference's initial net (its ``jax.random`` draw): l-bfgs's
    15 iterations grow float32 order differences to ~1e-4 (tol 2e-4 of
    max(1, |w|)); gd's 40 steps stay within 1e-5."""
    X, y = _mlp_data()
    jt, tt = _pair(jsess, tsess, X, y, ("a", "b", "c"))
    kw = dict(layers=(5, 8, 3), max_iter=max_iter, seed=3, solver=solver, step_size=0.5)
    jm = JMLP.MultilayerPerceptronClassifier(**kw).fit(jt)
    tm = TMLP.MultilayerPerceptronClassifier(**kw).fit(tt)
    assert tm.n_iter_ == jm.n_iter_
    for r, g in zip(jm.net, tm.net):
        for key in ("W", "b"):
            assert _rel(r[key], g[key]) < tol, (key, _rel(r[key], g[key]))
    assert abs(tm.final_loss_ - jm.final_loss_) < tol
    assert (tm.predict(tt) == jm.predict(jt)).mean() > 0.99
    conv = interop.mlp_model({"net": [{k: to_np(v) for k, v in layer.items()}
                                      for layer in jm.net]}, jm.params.to_dict(),
                             jm.class_values)
    assert_port_equal(jm.predict_probability(jt), conv.predict_probability(tt), atol=1e-6,
                      what="converted")


# ------------------------------------------------------------------------- FM
@pytest.mark.parametrize("kind,solver,fit_intercept,fit_linear", [
    ("classifier", "adamW", True, True), ("regressor", "adamW", True, False),
    ("classifier", "gd", False, True), ("regressor", "gd", True, True)])
def test_fm_matches_reference(jsess, tsess, kind, solver, fit_intercept, fit_linear):
    """From the reference's V (``init_std · normal(PRNGKey(seed))``, within
    2 ulp): 60 full-batch steps, the parameters within 5e-5 of max(1, |θ|)
    (autograd's and XLA's float32 orders); a frozen part stays zero."""
    rng = np.random.default_rng(4)
    n, d = 500, 6
    X = rng.standard_normal((n, d)).astype(np.float32)
    inter = X[:, 0] * X[:, 1] - X[:, 2] * X[:, 3]
    if kind == "classifier":
        y = (inter + 0.3 * X[:, 4] > 0).astype(np.float32)
        jt, tt = _pair(jsess, tsess, X, y, ("no", "yes"))
        J, T = JFM.FMClassifier, TFM.FMClassifier
    else:
        y = (inter + 0.5 * X[:, 4] + 1.0).astype(np.float32)
        jt, tt = _pair(jsess, tsess, X, y)
        J, T = JFM.FMRegressor, TFM.FMRegressor
    kw = dict(factor_size=4, max_iter=60, step_size=0.05, solver=solver, seed=7,
              init_std=0.1, fit_intercept=fit_intercept, fit_linear=fit_linear,
              reg_param=0.01, tol=0.0)
    jm, tm = J(**kw).fit(jt), T(**kw).fit(tt)
    for key in ("w0", "w", "V"):
        assert _rel(jm.theta[key], tm.theta[key]) < 5e-5, (key, _rel(jm.theta[key],
                                                                      tm.theta[key]))
    if not fit_intercept:
        assert float(tm.theta["w0"]) == 0.0
    if not fit_linear:
        assert float(tm.theta["w"].abs().max()) == 0.0
    assert_port_equal(jm.predict(jt), tm.predict(tt), rtol=1e-3, atol=1e-3, what="predict")
    conv = interop.fm_model({k: to_np(v) for k, v in jm.theta.items()}, jm.params.to_dict(),
                            getattr(jm, "class_values", None))
    assert type(conv).__name__ == type(tm).__name__


def test_fm_converges_by_the_relative_loss():
    """tol > 0 stops the loop at the first relative loss change below it."""
    from orange3_spark_tpu_torch.core.table import TorchTable

    rng = np.random.default_rng(0)
    X = rng.standard_normal((300, 4)).astype(np.float32)
    y = (X[:, 0] * X[:, 1]).astype(np.float32)
    t = TorchTable.from_arrays(X, y, session=TorchSession("cpu"))
    m = TFM.FMRegressor(max_iter=500, tol=1e-3, step_size=0.05).fit(t)
    assert 1 < m.n_iter_ < 500


# ------------------------------------------------------------------ OneVsRest
def test_one_vs_rest_matches_reference(jsess, tsess):
    X, y = _mlp_data(n=500, d=5, k=3, seed=8)
    jt, tt = _pair(jsess, tsess, X, y, ("a", "b", "c"))
    jm = JOVR.OneVsRest(JLR(max_iter=50)).fit(jt)
    tm = TOVR.OneVsRest(TLR(max_iter=50)).fit(tt)
    assert len(tm.models) == 3
    for jb, tb in zip(jm.models, tm.models):
        assert _rel(jb.coef, tb.coef) < 1e-4
    assert_port_equal(jm._scores(jt), tm._scores(tt), atol=1e-5, what="scores")
    np.testing.assert_array_equal(tm.predict(tt), jm.predict(jt))
    out = tm.transform(tt)
    assert out.domain.attributes[-1].name == "prediction"
    np.testing.assert_array_equal(out.X[: tt.n_rows, -1].numpy(), tm.predict(tt))
    conv = interop.one_vs_rest_model(
        [interop.logistic_regression({k: to_np(v) for k, v in m.state_pytree.items()},
                                     m.params.to_dict(), m.class_values)
         for m in jm.models], jm.params.to_dict(), jm.class_values)
    np.testing.assert_array_equal(conv.predict(tt), jm.predict(jt))


# ------------------------------------------------------------------- RFormula
_RF_COLS = [("x0", None), ("x1", None), ("color", ("red", "green", "blue")),
            ("size", ("s", "m")), ("target", None)]


def _rf_tables(jsess, tsess):
    rng = np.random.default_rng(9)
    n = 300
    X = np.stack([rng.standard_normal(n), rng.standard_normal(n), rng.integers(0, 3, n),
                  rng.integers(0, 2, n), rng.standard_normal(n)], 1).astype(np.float32)
    X[5, 2] = np.nan                                  # a NaN code: XLA's conversion, 0
    return table_pair(jsess, tsess, _RF_COLS, X)


@pytest.mark.parametrize("formula", [
    "target ~ x0 + x1 + color + size", "target ~ .", "target ~ . - x1",
    "target ~ x0 + color:x1 + color:size", "target ~ color + x0 - 1",
    "target ~ size + color - 1 + x0:x1", "target ~ x0 + x0 + x1"])
def test_rformula_columns_match_reference(jsess, tsess, formula):
    jt, tt = _rf_tables(jsess, tsess)
    jm = JRF.RFormula(formula=formula).fit(jt)
    tm = TRF.RFormula(formula=formula).fit(tt)
    assert tm.plan == jm.plan and tm.has_intercept == jm.has_intercept
    jo, to = jm.transform(jt), tm.transform(tt)
    assert [v.name for v in to.domain.attributes] == [v.name for v in jo.domain.attributes]
    assert to.domain.class_var.name == "target"
    for a, b in zip(jo.to_numpy()[:2], to.to_numpy()[:2]):
        np.testing.assert_array_equal(b, a)
    conv = interop.rformula_model(jm.params.to_dict(), tt.domain)
    np.testing.assert_array_equal(conv.transform(tt).X.numpy(), to.X.numpy())


@pytest.mark.parametrize("formula,match", [
    ("target x0", "needs '~'"), (" ~ x0", "label"), ("nope ~ x0", "not in table"),
    ("target ~ nope", "unknown column"), ("target ~ x0 - nope", "exclusion"),
    ("target ~ target", "cannot be a feature"), ("target ~ . - x0 - x1 - color - size",
                                                 "selects no terms")])
def test_rformula_errors_are_the_references(jsess, tsess, formula, match):
    jt, tt = _rf_tables(jsess, tsess)
    with pytest.raises(ValueError, match=match) as want:
        JRF.RFormula(formula=formula).fit(jt)
    with pytest.raises(ValueError, match=match) as got:
        TRF.RFormula(formula=formula).fit(tt)
    assert str(got.value) == str(want.value)


# ------------------------------------------- widgets, checkpoints, serving
@pytest.mark.parametrize("name,params,kind", [
    ("OWNaiveBayes", {"model_type": "gaussian"}, "cls"),
    ("OWGeneralizedLinearRegression", {"family": "poisson"}, "count"),
    ("OWIsotonicRegression", {}, "reg"),
    ("OWAFTSurvivalRegression", {"max_iter": 20}, "aft"),
    ("OWFMClassifier", {"max_iter": 10}, "bin"),
    ("OWFMRegressor", {"max_iter": 10}, "reg"),
    ("OWMultilayerPerceptronClassifier", {"layers": (3, 4, 2), "max_iter": 5}, "bin"),
    ("OWRFormula", {"formula": "y ~ x0 + x1"}, "reg")])
def test_widget_builds_runs_and_checkpoints(tsess, tmp_path, name, params, kind):
    """Every new widget builds from the registry, runs in a graph, and its
    fitted model saves and reloads (``utils/checkpoint``) to the same
    predictions; served predictions equal raw ones bitwise."""
    from orange3_spark_tpu_torch.core.table import TorchTable

    rng = np.random.default_rng(6)
    X = rng.standard_normal((256, 3)).astype(np.float32)
    y = {"cls": (X[:, 0] > 0) + (X[:, 1] > 0.5), "bin": X[:, 0] > 0,
         "count": rng.poisson(np.exp(0.3 * X[:, 0])), "reg": X[:, 0] + 0.1 * X[:, 1],
         "aft": np.exp(0.3 * X[:, 0] + 0.2 * rng.standard_normal(256))}[kind]
    y = np.asarray(y, np.float32)
    if kind == "aft":
        X[:, 2] = (rng.random(256) > 0.2)
        t = TorchTable.from_arrays(X, y, attr_names=["x0", "x1", "censor"], session=tsess)
    elif kind in ("cls", "bin"):
        cv = ("0", "1", "2") if kind == "cls" else ("0", "1")
        t = TorchTable.from_arrays(X, y, class_values=cv, session=tsess)
    else:
        t = TorchTable.from_arrays(X, y, session=tsess)
    g = WorkflowGraph()
    src = g.add(OWTable(t))
    node = g.add(WIDGET_REGISTRY[name](**params))
    g.connect(src, "data", node, "data")
    outs = g.run()
    model = outs[node]["model"]
    scored = outs[node]["data"]
    assert scored.n_rows == t.n_rows
    path = str(tmp_path / "model.pkl")
    save_model(model, path)
    back = load_model(path)
    np.testing.assert_array_equal(back.transform(t).X.numpy(), scored.X.numpy())
    if hasattr(model, "predict"):
        raw = model.predict(t)
        with ServingContext(BucketLadder(min_bucket=64, max_bucket=512)):
            served = model.predict(t)
        np.testing.assert_array_equal(served, raw)
