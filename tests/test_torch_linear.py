"""The dense linear family of the port (models/_linear.py and the
LogisticRegression, LinearSVC, LinearRegression estimators, Pipeline,
pickling, interop) against the JAX package on the same numpy tables.

Tolerances. The port's L-BFGS repeats optax's decisions step by step, so
the first iterations agree to float32 summation order: after 1, 2 and 3
iterations coef and intercept within 1e-4 relative (of the largest
reference entry) and the loss within 1e-5, for every loss, bf16 and OWLQN
included. Further on the two float32 iterates drift apart (Iris at
reg_param=1e-4 runs all 200 iterations); converging settings are held at
the optimum: coef within 1e-3 relative, loss within 1e-5 relative, the
same predictions. OWLQN's exactly-zero coefficients are the same set.
Normal equations: coef within 1e-4 relative; standard errors and t-values
within 1e-3; p-values (float64 here, float32 in the reference) within
1e-4 absolute. Carried JAX coefficients give the same predictions
bitwise; probabilities (torch's softmax of a row-wise product sum against
XLA's of an sgemm) within 4 float32 ulps of 1.0, margins within 1e-6.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu import datasets as jdatasets
from orange3_spark_tpu.core import domain as jdom
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.core.table import TpuTable
from orange3_spark_tpu.models import _linear as jlin
from orange3_spark_tpu.models.base import (
    Pipeline as JPipeline, predictions_to_numpy as jpredictions_to_numpy,
)
from orange3_spark_tpu.models.linear_regression import LinearRegression as JLinReg
from orange3_spark_tpu.models.linear_svc import LinearSVC as JSVC
from orange3_spark_tpu.models.logistic_regression import LogisticRegression as JLogReg
from orange3_spark_tpu_torch import datasets as tdatasets
from orange3_spark_tpu_torch import interop
from orange3_spark_tpu_torch.core import domain as tdom
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models import _linear as tlin
from orange3_spark_tpu_torch.models.base import (
    Pipeline, PipelineModel, predictions_to_numpy,
)
from orange3_spark_tpu_torch.models.linear_regression import LinearRegression
from orange3_spark_tpu_torch.models.linear_svc import LinearSVC
from orange3_spark_tpu_torch.models.logistic_regression import (
    LogisticRegression, LogisticRegressionModel,
)

import _port_parity as parity
from _port_parity import assert_port_equal, to_np

ULP_AT_1 = float(np.spacing(np.float32(1.0)))


@pytest.fixture(scope="module")
def jsess():
    """The reference on one device: its sums then run in the port's order."""
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession.builder_get_or_create("cpu")


@pytest.fixture(scope="module")
def iris(jsess, tsess):
    return jdatasets.load_iris(jsess), tdatasets.load_iris(tsess)


def _classification(jsess, tsess, n, d, k, seed, noise=1.0, W=None):
    jt = jdatasets.make_classification(n, d, k, seed, noise, session=jsess)
    tt = tdatasets.make_classification(n, d, k, seed, noise, session=tsess)
    if W is not None:
        jt, tt = jt.with_weights(jnp.asarray(W)), tt.with_weights(torch.from_numpy(W))
    return jt, tt


@pytest.fixture(scope="module")
def c2(jsess, tsess):
    return _classification(jsess, tsess, 512, 6, 2, 3)


@pytest.fixture(scope="module")
def c3(jsess, tsess):
    return _classification(jsess, tsess, 512, 6, 3, 4)


def _regression(jsess, tsess, n=400, d=5, seed=9, W=None):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X @ rng.standard_normal(d) + 0.3 + 0.5 * rng.standard_normal(n)).astype(np.float32)
    doms = [m.Domain([m.ContinuousVariable(f"x{i}") for i in range(d)],
                     m.ContinuousVariable("y")) for m in (jdom, tdom)]
    return (TpuTable.from_numpy(doms[0], X, y, W=W, session=jsess),
            TorchTable.from_numpy(doms[1], X, y, W=W, session=tsess))


# ------------------------------------------------------------- fit_linear
def _labels(table, loss):
    y = to_np(table.y)
    return (y > 0).astype(np.float32) if loss in ("hinge", "squared_hinge") else y


def _fit_both(jt, tt, loss, k, reg_l2, tol, max_iter, scale, reg_l1=None,
              dtype="float32"):
    y = _labels(tt, loss)
    js = jlin.column_inv_std(jt.X, jt.W) if scale else None
    ref = jlin.fit_linear(jt.X, jnp.asarray(y), jt.W, jnp.float32(reg_l2), jnp.float32(tol),
                          jnp.int32(max_iter), js,
                          None if reg_l1 is None else jnp.float32(reg_l1),
                          loss_kind=loss, k=k, compute_dtype=jnp.dtype(dtype))
    ts = tlin.column_inv_std(tt.X, tt.W) if scale else None
    got = tlin.fit_linear(tt.X, torch.from_numpy(y), tt.W, reg_l2, tol, max_iter, ts, reg_l1,
                          loss_kind=loss, k=k, compute_dtype=dtype)
    return ref, got


def _assert_fit_close(ref, got, coef_rtol, loss_rtol):
    scale = np.abs(to_np(ref.coef)).max()
    assert_port_equal(ref.coef, got.coef, atol=coef_rtol * scale, what="coef")
    assert_port_equal(ref.intercept, got.intercept,
                      atol=coef_rtol * max(scale, np.abs(to_np(ref.intercept)).max()),
                      what="intercept")
    assert_port_equal(ref.final_loss, np.float32(got.final_loss),
                      rtol=loss_rtol, what="loss")


_FIRST = [("logistic", 3, True, "float32"), ("logistic", 3, False, "float32"),
          ("logistic", 3, True, "bfloat16"),
          ("hinge", 1, True, "float32"), ("hinge", 1, False, "float32"),
          ("squared_hinge", 1, True, "float32"), ("squared_hinge", 1, False, "float32"),
          ("squared", 1, True, "float32"), ("squared", 1, False, "float32")]


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("loss,k,scale,dtype", _FIRST)
def test_fit_linear_first_iterations_on_iris(iris, loss, k, scale, dtype, iters):
    """Iris at reg 1e-4 (BASELINE config 1's setting), step for step."""
    ref, got = _fit_both(*iris, loss, k, 1e-4, 1e-6, iters, scale, dtype=dtype)
    assert got.n_iter == int(ref.n_iter) == iters
    _assert_fit_close(ref, got, 1e-4, 1e-4)


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("data,k", [("c2", 2), ("c3", 3)])
def test_fit_linear_bf16_first_iterations(request, data, k, scale, iters):
    """The bf16 arm (bench.py's dense_logreg setting) on 2 and 3 classes,
    with and without the column scale, step for step."""
    ref, got = _fit_both(*request.getfixturevalue(data), "logistic", k, 1e-4, 1e-6, iters,
                         scale, dtype="bfloat16")
    assert got.n_iter == int(ref.n_iter) == iters
    _assert_fit_close(ref, got, 1e-4, 1e-4)


def test_iris_first_iterates_are_the_reference_numbers(iris):
    """coef[0] of the original-space model after 1, 2, 3 iterations, as the
    reference gives them on the CPU."""
    want = [[-0.1014, 0.0112, 0.0902], [-0.1162, 0.0364, 0.0797],
            [-0.2392, 0.1289, 0.1103]]
    for iters, row in zip((1, 2, 3), want):
        model = LogisticRegression(max_iter=iters, reg_param=1e-4).fit(iris[1])
        np.testing.assert_allclose(to_np(model.coef)[0], row, atol=6e-5)


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("data,loss,k", [("c3", "logistic", 3), ("c2", "squared_hinge", 1),
                                         ("iris", "squared_hinge", 1)])
def test_owlqn_first_iterations(request, data, loss, k, iters):
    """Not Iris's softmax: its classes are balanced, so the intercept's
    gradient at the zero start is 0 up to rounding, whose sign (different
    in the two float32 sums) picks the orthant the intercept may enter."""
    ref, got = _fit_both(*request.getfixturevalue(data), loss, k, 0.025, 1e-6, iters,
                         True, reg_l1=0.025)
    assert got.n_iter == int(ref.n_iter)
    _assert_fit_close(ref, got, 1e-4, 1e-4)
    assert np.array_equal(to_np(ref.coef) == 0, to_np(got.coef) == 0)


def _predictions(res, X, loss):
    z = X @ to_np(res.coef) + to_np(res.intercept)
    if loss == "logistic":
        return np.argmax(z, axis=1)
    return z[:, 0] > 0 if loss != "squared" else z[:, 0]


# (data, loss, k, reg_l2, reg_l1, tol, standardization); hinge stops on a
# looser tol, as a non-smooth objective's gradient never falls below 1e-5,
# and so does OWLQN: its Armijo test sees the loss flat to a float32 ulp
# near the optimum, where the iterate freezes at a pseudo-gradient floor
# that float32 sums set (whether it lies below 1e-5 is chance:
# test_owlqn_freezes_at_a_float32_floor_in_both_packages); at 1e-3 both
# packages stop at the same iteration
_CONVERGED = [("c2", "logistic", 2, 1e-2, None, 1e-5, True),
              ("c3", "logistic", 3, 1e-2, None, 1e-5, True),
              ("c2", "squared_hinge", 1, 1e-2, None, 1e-5, True),
              ("c2", "hinge", 1, 1e-2, None, 1e-2, True),
              ("c2", "squared", 1, 1e-2, None, 1e-5, False),
              ("c3", "logistic", 3, 0.05, 0.05, 1e-3, True),
              ("c2", "squared_hinge", 1, 0.05, 0.05, 1e-3, True)]


@pytest.mark.parametrize("data,loss,k,reg_l2,reg_l1,tol,scale", _CONVERGED)
def test_fit_linear_converged(request, data, loss, k, reg_l2, reg_l1, tol, scale):
    jt, tt = request.getfixturevalue(data)
    ref, got = _fit_both(jt, tt, loss, k, reg_l2, tol, 500, scale, reg_l1=reg_l1)
    assert got.n_iter < 500 and int(ref.n_iter) < 500       # both converged
    _assert_fit_close(ref, got, 1e-3, 1e-5)
    X = to_np(tt.X)
    if loss == "squared":
        np.testing.assert_allclose(_predictions(got, X, loss), _predictions(ref, X, loss),
                                   rtol=1e-4, atol=1e-5)
    else:
        assert np.array_equal(_predictions(got, X, loss), _predictions(ref, X, loss))
    if reg_l1 is not None:
        assert (to_np(got.coef) == 0).any() or loss != "logistic"
        assert np.array_equal(to_np(ref.coef) == 0, to_np(got.coef) == 0)


def test_fit_linear_counts_evaluations_and_reads(iris):
    """L-BFGS: one evaluation to start, then the linesearch's; a read a
    linesearch step plus one an iteration (with the stopping test's read
    when it stops on tol)."""
    ref, got = _fit_both(*iris, "logistic", 3, 1e-4, 1e-6, 1, True)
    assert (got.n_evals, got.host_reads, got.iter_evals) == (3, 3, (3,))
    _, three = _fit_both(*iris, "logistic", 3, 1e-4, 1e-6, 3, True)
    assert three.n_evals == 5 and three.host_reads == three.n_evals + 2
    assert three.iter_evals == (3, 1, 1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_logreg_evaluations_follow_the_reference(dtype):
    """dense_logreg's fit (bench.py's data cut to 200,000 rows, tol 0): the
    first 13 iterations take one evaluation each after the start's in both
    packages. In bf16 the loss that bf16-rounded coefficients give is then
    flat, and from iteration 14 on both run most zoom searches to their
    20-step limit: more than 10 evaluations an iteration in both, so the
    bf16 arm's evaluations per iteration are the reference's algorithm."""
    X, y = parity.dense_logreg_data(200_000)
    ref = parity.reference_lbfgs_evals(X, y, dtype, (13, 20))
    got = parity.port_lbfgs_fit(X, y, dtype, 20)
    assert got.n_iter == ref[20]["n_iter"] == 20 and sum(got.iter_evals) == got.n_evals
    assert ref[13]["evals"] == sum(got.iter_evals[:13]) == 14
    late = [(ref[20]["evals"] - ref[13]["evals"]) / 7, sum(got.iter_evals[13:]) / 7]
    if dtype == "bfloat16":
        assert min(late) > 10, late
    assert_port_equal(ref[20]["loss"], np.float32(got.final_loss), rtol=1e-5, what="loss")


def test_owlqn_freezes_at_a_float32_floor_in_both_packages():
    """OWLQN on make_classification(2048, 12, 3, seed=1), reg 1e-2 + L1
    0.05: near the optimum both packages' searches accept points that
    leave the loss flat, the iterate stops moving and the pseudo-gradient
    norm stays at a floor set by float32 rounding (reference 2.5e-6, the
    port's CPU 1.4e-6 here). Below the floor neither stops before max_iter;
    at tol 1e-5 both stop, with the same exactly-zero count."""
    for tol, max_iter in ((1e-6, 60), (1e-5, 500)):
        ref, got = parity.owlqn_trace(tol, max_iter)
        if tol == 1e-6:
            assert ref["n_iter"] == got["n_iter"] == max_iter
            for line in (ref, got):
                assert line["iterate_last_moved_at_iter"] < 40, line
                assert 1e-7 < line["pg_norms"][-1] < 1e-5, line
        else:
            assert max(ref["n_iter"], got["n_iter"]) < 30
            assert ref["zeros"] == got["zeros"] > 0
        assert_port_equal(ref["loss"], np.float32(got["loss"]), rtol=1e-6, what="loss")


@pytest.mark.parametrize("n", [100, tlin.LOGIT_BLOCK_ROWS + 77])
def test_dense_logits_blocks_keep_each_rows_bits(n):
    """Past LOGIT_BLOCK_ROWS rows the logits are taken a block at a time;
    every row keeps the bits of the row's own call, and the sums are the
    products' within float32 order."""
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal((n, 6), dtype=np.float32))
    coef = torch.from_numpy(rng.standard_normal((6, 3), dtype=np.float32))
    got = tlin.dense_logits(X, coef)
    for lo in (0, n // 2, n - 40, max(tlin.LOGIT_BLOCK_ROWS - 5, 0)):
        rows = slice(min(lo, n - 40), min(lo, n - 40) + 40)
        assert torch.equal(got[rows], tlin.dense_logits(X[rows], coef))
    np.testing.assert_allclose(got.numpy(), X.numpy() @ coef.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reg_l1", [None, 0.01])
def test_fit_linear_max_iter_zero_returns_the_zero_init(iris, reg_l1):
    ref, got = _fit_both(*iris, "logistic", 3, 1e-4, 1e-6, 0, True, reg_l1=reg_l1)
    assert got.n_iter == int(ref.n_iter) == 0
    assert not to_np(got.coef).any() and not to_np(got.intercept).any()
    assert_port_equal(ref.final_loss, np.float32(got.final_loss), rtol=1e-6)


def test_fit_without_intercept_keeps_it_zero(c2):
    jt, tt = c2
    y = to_np(tt.y)
    ref = jlin.fit_linear(jt.X, jnp.asarray(y), jt.W, jnp.float32(1e-2), jnp.float32(1e-5),
                          jnp.int32(3), None, None, loss_kind="logistic", k=2,
                          fit_intercept=False)
    got = tlin.fit_linear(tt.X, tt.y, tt.W, 1e-2, 1e-5, 3, loss_kind="logistic", k=2,
                          fit_intercept=False)
    assert not to_np(got.intercept).any()
    _assert_fit_close(ref, got, 1e-4, 1e-5)


def test_split_bf16_is_exact():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((1000, 3)).astype(
        np.float32) * np.float32(1e-7))
    parts = tlin._split_bf16(g)
    assert parts.dtype == torch.bfloat16 and parts.shape == (1000, 9)
    total = (parts[:, :3].float() + parts[:, 3:6].float()) + parts[:, 6:].float()
    assert torch.equal(total, g)


# ------------------------------------------------------------- estimators
def _converged_logreg(**kw):
    return dict(max_iter=500, reg_param=1e-2, tol=1e-5, **kw)


@pytest.mark.parametrize("data", ["c2", "c3"])
def test_logistic_regression_matches_reference(request, data):
    jt, tt = request.getfixturevalue(data)
    jm, tm = JLogReg(**_converged_logreg()).fit(jt), \
        LogisticRegression(**_converged_logreg()).fit(tt)
    assert tm.class_values == jm.class_values
    assert isinstance(tm.n_iter_, int) and tm.n_iter_ < 500 and jm.n_iter_ < 500
    assert tm.n_evals_ >= tm.n_iter_ and tm.host_reads_ > tm.n_iter_
    scale = np.abs(to_np(jm.coef)).max()
    assert_port_equal(jm.coef, tm.coef, atol=1e-3 * scale)
    assert_port_equal(jm.predict(jt), tm.predict(tt))
    assert_port_equal(jm.predict_proba(jt), tm.predict_proba(tt), atol=1e-4)
    js, ts = jm.summary(jt), tm.summary(tt)
    assert sorted(ts) == sorted(js)
    for k in js:
        assert ts[k] == pytest.approx(js[k], abs=1e-6), k


def test_transform_domain_and_columns(c3):
    jt, tt = c3
    jm, tm = JLogReg(**_converged_logreg()).fit(jt), \
        LogisticRegression(**_converged_logreg()).fit(tt)
    jo, to = jm.transform(jt), tm.transform(tt)
    assert [v.name for v in to.domain.attributes] == [v.name for v in jo.domain.attributes]
    assert to.domain.attributes[-1].values == tuple(jo.domain.attributes[-1].values)
    assert to.n_attrs == tt.n_attrs + 3 + 1
    assert_port_equal(jo.X[:, :tt.n_attrs], to.X[:, :tt.n_attrs])
    assert_port_equal(jo.X[:, -1], to.X[:, -1])                  # predictions
    assert_port_equal(jo.X[:, tt.n_attrs:-1], to.X[:, tt.n_attrs:-1], atol=1e-4)
    np.testing.assert_allclose(to_np(to.X[:, tt.n_attrs:-1]).sum(axis=1), 1.0, rtol=1e-5)


def test_binomial_threshold(c2):
    _, tt = c2
    base = LogisticRegression(**_converged_logreg()).fit(tt)
    p1 = base.predict_proba(tt)[:, 1]
    for thr in (0.2, 0.5, 0.8):
        m = LogisticRegressionModel(base.params.replace(threshold=thr), base.coef,
                                    base.intercept, base.class_values)
        assert np.array_equal(m.predict(tt), (p1 > thr).astype(np.float32))
    with pytest.raises(ValueError, match="binomial family needs 2 classes"):
        LogisticRegression(family="binomial").fit(
            tdatasets.make_classification(50, 3, 3, session=tt.session))


def test_iris_config_1(iris):
    """BASELINE config 1 on the CPU: LogisticRegression(max_iter=200,
    reg_param=1e-4); the reference reads 0.98 here, the chip floor is 0.96."""
    jt, tt = iris
    tm = LogisticRegression(max_iter=200, reg_param=1e-4).fit(tt)
    jm = JLogReg(max_iter=200, reg_param=1e-4).fit(jt)
    y = to_np(tt.y)
    acc = float(np.mean(tm.predict(tt) == y))
    assert acc >= 0.96 and tm.n_iter_ == 200
    assert abs(acc - float(np.mean(jm.predict(jt) == y))) <= 0.02


def test_weighted_fit_ignores_zero_weight_rows(jsess, tsess):
    """The twin of the reference's test: filtered rows (W = 0) with flipped
    labels do not move the fit."""
    t = tdatasets.make_classification(400, 5, n_classes=2, seed=2, session=tsess)
    X, Y, _ = t.to_numpy()
    Y2 = Y.copy()
    Y2[200:] = 1 - Y2[200:]
    corrupt = TorchTable.from_numpy(t.domain, X, Y2, session=tsess)
    filtered = corrupt.filter(torch.arange(corrupt.n_pad) < 200)
    m_filtered = LogisticRegression(max_iter=100).fit(filtered)
    clean = TorchTable.from_numpy(t.domain, X[:200], Y[:200], session=tsess)
    m_clean = LogisticRegression(max_iter=100).fit(clean)
    np.testing.assert_allclose(to_np(m_filtered.coef), to_np(m_clean.coef),
                               rtol=1e-3, atol=1e-4)


def test_all_rows_filtered_floors_the_weight(tsess):
    t = tdatasets.make_classification(64, 3, session=tsess)
    res = tlin.fit_linear(t.X, t.y, torch.zeros_like(t.W), 1e-2, 1e-6, 5,
                          loss_kind="logistic", k=2)
    assert np.isfinite(res.final_loss) and np.isfinite(to_np(res.coef)).all()


def test_max_iter_zero_model(c2):
    jt, tt = c2
    jm, tm = JLogReg(max_iter=0).fit(jt), LogisticRegression(max_iter=0).fit(tt)
    assert tm.n_iter_ == jm.n_iter_ == 0
    assert_port_equal(jm.coef, tm.coef)
    assert_port_equal(jm.predict_proba(jt), tm.predict_proba(tt))


@pytest.mark.parametrize("loss,tol", [("squared_hinge", 1e-5), ("hinge", 1e-2)])
def test_linear_svc_matches_reference(c2, loss, tol):
    jt, tt = c2
    kw = dict(max_iter=500, reg_param=1e-2, tol=tol, loss=loss)
    jm, tm = JSVC(**kw).fit(jt), LinearSVC(**kw).fit(tt)
    assert tm.n_iter_ < 500 and jm.n_iter_ < 500
    assert_port_equal(jm.coef, tm.coef, atol=1e-3 * np.abs(to_np(jm.coef)).max())
    assert_port_equal(jm.predict(jt), tm.predict(tt))
    assert_port_equal(jm.decision_function(jt), tm.decision_function(tt), atol=1e-3)
    jo, to = jm.transform(jt), tm.transform(tt)
    assert [v.name for v in to.domain.attributes] == [v.name for v in jo.domain.attributes]
    assert_port_equal(jo.X[:, -1], to.X[:, -1])


def test_linear_svc_refuses_multiclass_and_l1_hinge(c3, c2):
    with pytest.raises(ValueError, match="LinearSVC is binary"):
        LinearSVC().fit(c3[1])
    with pytest.raises(ValueError, match="smooth data term"):
        LinearSVC(reg_param=0.1, elastic_net_param=0.5).fit(c2[1])
    with pytest.raises(ValueError, match=r"elastic_net_param must be in \[0, 1\]"):
        LogisticRegression(elastic_net_param=1.5).fit(c2[1])


def test_linear_svc_elastic_net_zero_pattern(c2):
    jt, tt = c2
    kw = dict(max_iter=500, reg_param=0.1, elastic_net_param=0.5, tol=1e-3,
              loss="squared_hinge")   # OWLQN's tol: see _CONVERGED
    jm, tm = JSVC(**kw).fit(jt), LinearSVC(**kw).fit(tt)
    assert np.array_equal(to_np(jm.coef) == 0, to_np(tm.coef) == 0)
    assert_port_equal(jm.predict(jt), tm.predict(tt))


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("weights", ["unit", "filtered"])
def test_linear_regression_normal_with_inference(jsess, tsess, fit_intercept, weights):
    W = None
    if weights == "filtered":
        W = np.ones(400, np.float32)
        W[np.random.default_rng(1).random(400) < 0.3] = 0.0
    jt, tt = _regression(jsess, tsess, W=W)
    jm = JLinReg(fit_intercept=fit_intercept).fit(jt)
    tm = LinearRegression(fit_intercept=fit_intercept).fit(tt)
    assert tm.n_iter_ == 1
    assert_port_equal(jm.coef, tm.coef, rtol=1e-4, atol=1e-6)
    assert_port_equal(jm.intercept, tm.intercept, rtol=1e-4, atol=1e-6)
    for name in ("r2_", "root_mean_squared_error_", "mean_absolute_error_",
                 "explained_variance_"):
        assert_port_equal(getattr(jm, name), getattr(tm, name), rtol=1e-4, what=name)
    assert_port_equal(jm.coefficient_standard_errors_, tm.coefficient_standard_errors_,
                      rtol=1e-3)
    assert_port_equal(jm.t_values_, tm.t_values_, rtol=1e-3)
    assert_port_equal(jm.p_values_, tm.p_values_, atol=1e-4)
    assert_port_equal(jm.predict(jt), tm.predict(tt), rtol=1e-4, atol=1e-5)


def test_linear_regression_ridge_has_no_inference(jsess, tsess):
    jt, tt = _regression(jsess, tsess)
    jm, tm = JLinReg(reg_param=0.1).fit(jt), LinearRegression(reg_param=0.1).fit(tt)
    assert tm.p_values_ is None and jm.p_values_ is None
    assert_port_equal(jm.coef, tm.coef, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("solver,alpha", [("l-bfgs", 0.0), ("l-bfgs", 0.5), ("normal", 0.5)])
def test_linear_regression_iterative_and_elastic_net(jsess, tsess, solver, alpha):
    """'normal' with an L1 term falls back to the quasi-Newton fit."""
    jt, tt = _regression(jsess, tsess)
    kw = dict(solver=solver, reg_param=0.2, elastic_net_param=alpha, max_iter=500,
              tol=1e-3 if alpha else 1e-5)   # OWLQN's tol: see _CONVERGED
    jm, tm = JLinReg(**kw).fit(jt), LinearRegression(**kw).fit(tt)
    assert 1 < tm.n_iter_ < 500 and tm.n_iter_ == jm.n_iter_
    assert_port_equal(jm.coef, tm.coef, atol=1e-3 * np.abs(to_np(jm.coef)).max())
    assert np.array_equal(to_np(jm.coef) == 0, to_np(tm.coef) == 0)
    if alpha:
        assert (to_np(tm.coef) == 0).any()
    assert_port_equal(jm.r2_, tm.r2_, rtol=1e-4)
    jo, to = jm.transform(jt), tm.transform(tt)
    assert [v.name for v in to.domain.attributes] == [v.name for v in jo.domain.attributes]


# ------------------------------------------------------------- interop
def _carry(jm):
    return {k: np.asarray(v) for k, v in jm.state_pytree.items()}, jm.params.to_dict()


def test_interop_logistic_regression(c3, iris):
    for jt, tt in (c3, iris):
        jm = JLogReg(max_iter=50, reg_param=1e-3).fit(jt)
        state, params = _carry(jm)
        tm = interop.logistic_regression(state, params, jm.class_values, device="cpu")
        assert_port_equal(jm.coef, tm.coef)
        assert_port_equal(jm.predict(jt), tm.predict(tt))
        # probabilities: softmax of a row-wise sum of products (the port)
        # against XLA's of an sgemm, both in float32
        assert_port_equal(jm.predict_proba(jt), tm.predict_proba(tt), atol=4 * ULP_AT_1)
        jo, to = jm.transform(jt), tm.transform(tt)
        assert [v.name for v in to.domain.attributes] == [v.name for v in jo.domain.attributes]
        assert_port_equal(jo.X[:, -1], to.X[:, -1])
        assert_port_equal(jo.X, to.X, atol=4 * ULP_AT_1)


def test_interop_binomial_and_svc(c2):
    jt, tt = c2
    jm = JLogReg(max_iter=50, reg_param=1e-3, threshold=0.4).fit(jt)
    tm = interop.logistic_regression(*_carry(jm), jm.class_values, device="cpu")
    assert_port_equal(jm.predict(jt), tm.predict(tt))
    js = JSVC(max_iter=50, reg_param=1e-3).fit(jt)
    ts = interop.linear_svc(*_carry(js), js.class_values, device="cpu")
    assert_port_equal(js.predict(jt), ts.predict(tt))
    assert_port_equal(js.decision_function(jt), ts.decision_function(tt), atol=1e-6)
    assert_port_equal(js.transform(jt).X[:, -1], ts.transform(tt).X[:, -1])


def test_interop_linear_regression(jsess, tsess):
    jt, tt = _regression(jsess, tsess)
    jm = JLinReg().fit(jt)
    tm = interop.linear_regression(*_carry(jm), device="cpu")
    assert tm.intercept.shape == ()
    assert_port_equal(jm.predict(jt), tm.predict(tt), atol=1e-5)
    assert_port_equal(jm.transform(jt).X, tm.transform(tt).X, atol=1e-5)


# ------------------------------------------------------------- pipeline, pickle
def test_pipeline_of_one_logistic_regression(c3):
    jt, tt = c3
    jp = JPipeline([JLogReg(**_converged_logreg())]).fit(jt)
    tp = Pipeline([LogisticRegression(**_converged_logreg())]).fit(tt)
    assert isinstance(tp, PipelineModel) and len(tp.stages) == 1
    assert sorted(tp.state_pytree) == sorted(jp.state_pytree) == ["stage0"]
    direct = LogisticRegression(**_converged_logreg()).fit(tt)
    assert torch.equal(tp.transform(tt).X, direct.transform(tt).X)
    jo, to = jp.transform(jt), tp.transform(tt)
    assert_port_equal(jo.X[:, -1], to.X[:, -1])
    assert_port_equal(jpredictions_to_numpy(jo), predictions_to_numpy(to))
    token = tp._serve_state_token()
    tp.load_state_pytree({"stage0": {"coef": tp.stages[0].coef * 2,
                                     "intercept": tp.stages[0].intercept}})
    assert tp._serve_state_token() != token
    with pytest.raises(ValueError, match="non-model stage"):
        PipelineModel([object()]).load_state_pytree({"stage0": {}})


def test_pickle_round_trip(c3, tsess):
    _, tt = c3
    tm = LogisticRegression(**_converged_logreg()).fit(tt)
    blob = pickle.dumps(tm)
    assert b"_rebuild_tensor" not in blob      # the tensors went as numpy arrays
    back = pickle.loads(blob)
    assert isinstance(back.coef, torch.Tensor) and back.coef.device == tsess.device
    assert torch.equal(back.coef, tm.coef) and back.n_iter_ == tm.n_iter_
    assert np.array_equal(back.predict(tt), tm.predict(tt))
    pm = pickle.loads(pickle.dumps(PipelineModel([tm])))
    assert torch.equal(pm.transform(tt).X, tm.transform(tt).X)


@pytest.mark.parametrize("case", ["tracked", "pad_aligned", "all_filtered"])
def test_predictions_to_numpy_carve_out(jsess, tsess, case):
    """A bucket-padded table whose caller tracked the row count keeps every
    logical row; on a pad-aligned one a trailing zero-weight run is
    trimmed as padding (the reference's carve-out)."""
    X = np.arange(24, dtype=np.float32).reshape(12, 2)
    W = np.ones(12, np.float32)
    W[9:] = 0.0
    if case == "all_filtered":
        W[:] = 0.0
    doms = [m.Domain([m.ContinuousVariable("prediction"), m.ContinuousVariable("v")])
            for m in (jdom, tdom)]
    jt = TpuTable.from_numpy(doms[0], X, W=W, session=jsess)
    tt = TorchTable.from_numpy(doms[1], X, W=W, session=tsess)
    if case == "tracked":
        jt.n_rows = tt.n_rows = 10
    got = predictions_to_numpy(tt)
    assert_port_equal(jpredictions_to_numpy(jt), got)
    assert len(got) == {"tracked": 10, "pad_aligned": 9, "all_filtered": 0}[case]
