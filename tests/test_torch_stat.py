"""The port's ``models/stat.py`` against the JAX package's, on the same
seeded numpy tables (a few hundred rows, narrow widths).

Tolerances, with their reasons:

- Integer outputs are bitwise: the Spearman ranks of tied data (their
  position sums are exact small integers), the contingency counts, the
  degrees of freedom, Summarizer's count, non-zeros, min and max.
- Float statistics sum in float32 in another order (XLA's reductions and
  dot against torch's): rtol 1e-5 on means, variances, correlations, F
  values and chi-square statistics (2e-5 where a variance is differenced).
- P-values: the reference evaluates the chi-square and F tails in float32
  (``jax.scipy.special``), the port in float64 (scipy's ``gammaincc`` on
  the host, ``ops/stats.betainc``). The chi-square tails agree within
  rtol 1e-4; the reference's float32 ``betainc`` is up to 4.6e-4 off the
  exact F tail here, so the F p-values are held to the reference at rtol
  1e-3 and to scipy's float64 ``f.sf`` of the port's own F at rtol 1e-9.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.models import stat as JS
from orange3_spark_tpu_torch.core.fmath import norm32, sqrt32
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.models import stat as TS

from _port_parity import assert_port_equal, to_np
from _torch_tables import table_pair


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession("cpu")


def _cont(jsess, tsess, n=300, d=5, seed=0, ties=False, k=3, W=None):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    if ties:
        X = np.round(X * 2).astype(np.float32)
    X[:, 1] += 0.7 * X[:, 0]
    y = rng.integers(0, k, n).astype(np.float32)
    X[:, 2] += y
    cols = [(f"x{j}", None) for j in range(d)]
    return table_pair(jsess, tsess, cols, X, Y=y, W=W,
                      class_var=("y", tuple(str(i) for i in range(k))))


def test_sqrt32_is_correctly_rounded():
    """100,000 seeded float32 values: the float64 root rounded once."""
    x = np.random.default_rng(0).uniform(0.01, 100.0, 100_000).astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    assert np.array_equal(sqrt32(torch.from_numpy(x)).numpy(), want)
    v = torch.from_numpy(x[:1000].reshape(100, 10))
    got = norm32(v, dim=1).numpy()
    assert np.array_equal(got, sqrt32((v * v).sum(dim=1)).numpy())


@pytest.mark.parametrize("method,ties", [("pearson", False), ("spearman", False),
                                         ("spearman", True)])
def test_correlation(jsess, tsess, method, ties):
    W = np.ones(300, np.float32)
    W[::7] = 0.0
    jt, tt = _cont(jsess, tsess, ties=ties, W=W)
    ref = JS.Correlation.corr(jt, method)
    got = TS.Correlation.corr(tt, method)
    assert_port_equal(ref, got, rtol=1e-5, atol=1e-6, what=method)
    assert np.all(np.diag(got) == 1.0)


def test_tied_ranks_bitwise(jsess, tsess):
    W = np.ones(300, np.float32)
    W[::5] = 0.0
    jt, tt = _cont(jsess, tsess, ties=True, W=W)
    ref = np.asarray(JS._tie_averaged_ranks(jt.X, jt.W))
    got = TS.tie_averaged_ranks(tt.X, tt.W).numpy()
    assert np.array_equal(ref, got)


def test_chi_square(jsess, tsess):
    rng = np.random.default_rng(3)
    n = 400
    y = rng.integers(0, 3, n).astype(np.float32)
    X = np.stack([rng.integers(0, 4, n), (y + rng.integers(0, 2, n)) % 5,
                  rng.integers(0, 2, n)], axis=1).astype(np.float32)
    W = np.ones(n, np.float32)
    W[::9] = 0.0
    jt, tt = table_pair(jsess, tsess, [("a", None), ("b", None), ("c", None)], X, Y=y, W=W,
                        class_var=("y", ("0", "1", "2")))
    ref, got = JS.ChiSquareTest.test(jt), TS.ChiSquareTest.test(tt)
    assert np.array_equal(ref.degrees_of_freedom, got.degrees_of_freedom)
    assert_port_equal(ref.statistics, got.statistics, rtol=1e-9, what="chi2")
    assert_port_equal(ref.p_values, got.p_values, rtol=1e-4, atol=1e-6, what="p")
    obs_ref = np.asarray(JS._contingency(jt.column("b"), jt.y, jt.W, m=5, k=3))
    obs_got = TS.contingency(tt.column("b"), tt.y, tt.W, 5, 3).numpy()
    assert np.array_equal(obs_ref, obs_got)


def test_summarizer(jsess, tsess):
    W = np.ones(300, np.float32)
    W[::4] = 0.0
    jt, tt = _cont(jsess, tsess, W=W)
    ref, got = JS.Summarizer.metrics(jt), TS.Summarizer.metrics(tt)
    assert ref.count == got.count
    for f in ("num_non_zeros", "max", "min"):
        assert np.array_equal(getattr(ref, f), getattr(got, f)), f
    for f in ("mean", "norm_l1", "norm_l2", "sum"):
        assert_port_equal(getattr(ref, f), getattr(got, f), rtol=1e-5, atol=1e-6, what=f)
    for f in ("variance", "std"):
        assert_port_equal(getattr(ref, f), getattr(got, f), rtol=2e-5, what=f)
    assert_port_equal(ref.weight_sum, got.weight_sum, rtol=1e-7)


def test_kolmogorov_smirnov(jsess, tsess):
    jt, tt = _cont(jsess, tsess, n=500)
    for loc, scale in ((0.0, 1.0), (0.3, 2.0)):
        ref = JS.KolmogorovSmirnovTest.test(jt, "x0", loc=loc, scale=scale)
        got = TS.KolmogorovSmirnovTest.test(tt, "x0", loc=loc, scale=scale)
        assert_port_equal(ref.statistic, got.statistic, rtol=1e-5, atol=1e-6)
        assert_port_equal(ref.p_value, got.p_value, rtol=1e-4, atol=1e-6)


def _exact_f_tail(res):
    from scipy import stats

    want = stats.f.sf(res.f_values, res.degrees_of_freedom[:, 0], res.degrees_of_freedom[:, 1])
    np.testing.assert_allclose(res.p_values, want, rtol=1e-9)


def test_anova_and_fvalue(jsess, tsess):
    W = np.ones(300, np.float32)
    W[::6] = 0.0
    jt, tt = _cont(jsess, tsess, W=W)
    ref, got = JS.ANOVATest.test(jt), TS.ANOVATest.test(tt)
    assert np.array_equal(ref.degrees_of_freedom, got.degrees_of_freedom)
    assert_port_equal(ref.f_values, got.f_values, rtol=2e-5, what="anova F")
    assert_port_equal(ref.p_values, got.p_values, rtol=1e-3, atol=1e-6, what="anova p")
    _exact_f_tail(got)
    ref, got = JS.FValueTest.test(jt), TS.FValueTest.test(tt)
    assert np.array_equal(ref.degrees_of_freedom, got.degrees_of_freedom)
    assert_port_equal(ref.f_values, got.f_values, rtol=2e-5, what="F")
    assert_port_equal(ref.p_values, got.p_values, rtol=1e-3, atol=1e-6, what="p")
    _exact_f_tail(got)
    sub = ["x2", "x0"]
    ref, got = JS.ANOVATest.test(jt, sub), TS.ANOVATest.test(tt, sub)
    assert_port_equal(ref.f_values, got.f_values, rtol=2e-5, what="anova F of a subset")


@pytest.mark.parametrize("rank", [4, 2])
def test_multivariate_gaussian(rank):
    rng = np.random.default_rng(rank)
    A = rng.standard_normal((4, rank))
    cov = A @ A.T + (np.eye(4) * 0.5 if rank == 4 else 0.0)
    mean = rng.standard_normal(4)
    x = rng.standard_normal((50, 4)).astype(np.float32)
    ref = JS.MultivariateGaussian(mean, cov)
    got = TS.MultivariateGaussian(mean, cov, device="cpu")
    assert_port_equal(to_np(ref.logpdf(x)), got.logpdf(x).numpy(), rtol=1e-5, atol=1e-5)
    assert_port_equal(to_np(ref.pdf(x[0])), got.pdf(x[0]).numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="no non-zero eigenvalue"):
        TS.MultivariateGaussian(mean, np.zeros((4, 4)), device="cpu")
