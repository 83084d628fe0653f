"""The port's table methods and weighted statistics (core/table.py,
ops/stats.py, datasets.load_iris) against the JAX package's on the same
numpy inputs: filtered rows, NaNs and class columns included.

Tolerances: selections, fills, filters, quantiles and Iris are bitwise.
Moments sum in another order (exactly where the sums are of integers):
1e-6 relative. The t-test p-value is computed in float64 here and in
float32 by the reference, so it is held to scipy's and to the reference's
formula evaluated in float64 (1e-7: its t arrives in float32) and to its
float32 function within that
function's own rounding (the df·(df + t²) ratio in float32, 1e-3 at
df ≤ 1e3); the incomplete beta itself within 1e-9 of jax.scipy's float64
betainc over a t x df grid and random (a, b, x).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu import datasets as jdatasets
from orange3_spark_tpu.core import domain as jdom
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.core.table import TpuTable
from orange3_spark_tpu.ops import stats as jstats
from orange3_spark_tpu_torch import datasets as tdatasets
from orange3_spark_tpu_torch.core import domain as tdom
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.ops import stats as tstats

from _port_parity import assert_port_equal, to_np


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession("cpu")


def _domain(m, d=5):
    return m.Domain([m.ContinuousVariable(f"a{i}") for i in range(d - 1)]
                    + [m.DiscreteVariable("c", ("x", "y", "z"))],
                    m.ContinuousVariable("target"))


@pytest.fixture(scope="module")
def tables(jsess, tsess):
    """600 rows: NaNs in attribute and class cells, a class-valued
    attribute, user weights with zeros, and a third of the rows filtered
    (the filter predicate is applied to both as numpy)."""
    rng = np.random.default_rng(7)
    n = 600
    X = rng.standard_normal((n, 5)).astype(np.float32)
    X[:, 4] = rng.integers(0, 3, n)
    X[rng.random((n, 5)) < 0.05] = np.nan
    y = rng.standard_normal(n).astype(np.float32)
    y[rng.random(n) < 0.05] = np.nan
    W = rng.uniform(0.5, 2.0, n).astype(np.float32)
    W[rng.random(n) < 0.1] = 0.0
    keep = rng.random(n) > 0.33
    jt = TpuTable.from_numpy(_domain(jdom), X, y, W=W, session=jsess)
    tt = TorchTable.from_numpy(_domain(tdom), X, y, W=W, session=tsess)
    return jt.filter(jnp.asarray(keep)), tt.filter(torch.from_numpy(keep)), X, y


def _same_table(jt, tt):
    assert [v.name for v in tt.domain.attributes] == [v.name for v in jt.domain.attributes]
    assert [v.name for v in tt.domain.class_vars] == [v.name for v in jt.domain.class_vars]
    assert tt.n_rows == jt.n_rows
    assert_port_equal(jt.X, tt.X, what="X")
    assert_port_equal(jt.W, tt.W, what="W")
    if jt.Y is None:
        assert tt.Y is None
    else:
        assert_port_equal(jt.Y, tt.Y, what="Y")


def test_valid_mask_column_and_count(tables):
    jt, tt, _, _ = tables
    assert_port_equal(jt.valid_mask, tt.valid_mask)
    assert tt.valid_mask.dtype == torch.float32
    for name in ("a0", "c", "target"):
        assert_port_equal(jt.column(name), tt.column(name), what=name)
    assert tt.count() == jt.count()


@pytest.mark.parametrize("cols", [["a2", "a0"], ["c"], ["a0", "a1", "a2", "a3", "c"]])
def test_select(tables, cols):
    jt, tt, _, _ = tables
    _same_table(jt.select(cols), tt.select(cols))


def test_select_refuses_class_columns(tables):
    _, tt, _, _ = tables
    with pytest.raises(ValueError, match="class vars stay put"):
        tt.select(["target"])


def test_where_is_filter(tables):
    jt, tt, X, _ = tables
    _same_table(jt.where(lambda t: t.X[:, 0] > 0), tt.where(lambda t: t.X[:, 0] > 0))


@pytest.mark.parametrize("value", [0.0, -1.5, {"a1": 3.25, "target": -7.0},
                                   {"c": 2.0}, {"target": 0.1}])
def test_fillna(tables, value):
    """A float fills every attribute column; a dict fills per column, the
    class column included."""
    jt, tt, _, _ = tables
    out = tt.fillna(value)
    _same_table(jt.fillna(value), out)
    assert torch.isnan(tt.X).any()      # the source table is unchanged


def test_fillna_unknown_column(tables):
    _, tt, _, _ = tables
    with pytest.raises(ValueError, match="unknown column"):
        tt.fillna({"nope": 1.0})


@pytest.mark.parametrize("subset", [None, ["a0"], ["target"], ["a1", "c", "target"]])
def test_dropna(tables, subset):
    jt, tt, _, _ = tables
    _same_table(jt.dropna(subset), tt.dropna(subset))


def test_dropna_unknown_column(tables):
    _, tt, _, _ = tables
    with pytest.raises(ValueError, match="unknown column"):
        tt.dropna(["nope"])


def test_compacted(tables):
    jt, tt, _, _ = tables
    jc, tc = jt.compacted(), tt.compacted()
    _same_table(jc, tc)
    assert tc.n_rows == tt.count()


@pytest.mark.parametrize("k", [0, 1, 5, 150])
def test_head_reads_live_rows(tables, k):
    jt, tt, _, _ = tables
    assert_port_equal(jt.head(k), tt.head(k))


def test_head_scans_past_a_filtered_prefix(jsess, tsess):
    """The first live rows lie past the first chunks: head() walks on
    until it has k of them."""
    n = 10_000
    X = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    W = np.zeros(n, np.float32)
    W[[4100, 4101, 9000]] = 1.0
    doms = [m.Domain([m.ContinuousVariable("u"), m.ContinuousVariable("v")])
            for m in (jdom, tdom)]
    jt = TpuTable.from_numpy(doms[0], X, W=W, session=jsess)
    tt = TorchTable.from_numpy(doms[1], X, W=W, session=tsess)
    for k in (2, 3, 5):
        assert_port_equal(jt.head(k), tt.head(k))
    assert_port_equal(X[[4100, 4101]], tt.head(2))


def test_describe(tables):
    jt, tt, _, _ = tables
    filled_j, filled_t = jt.fillna(0.0), tt.fillna(0.0)
    ref, got = filled_j.describe(), filled_t.describe()
    assert sorted(got) == sorted(ref)
    for k in ("min", "max"):
        assert_port_equal(ref[k], got[k], what=k)
    for k in ("mean", "std"):
        assert_port_equal(ref[k], got[k], rtol=1e-6, atol=1e-7, what=k)


@pytest.mark.parametrize("cols,probs", [("a0", [0.0, 0.5, 1.0]),
                                        (["a1", "target", "c"], [0.1, 0.25, 0.9])])
def test_approx_quantile(tables, cols, probs):
    """Attribute and class columns, filtered rows never selected."""
    jt, tt, _, _ = tables
    jt, tt = jt.fillna({"a0": 0.0, "a1": 0.0, "target": 0.0}), \
        tt.fillna({"a0": 0.0, "a1": 0.0, "target": 0.0})
    got = tt.approx_quantile(cols, probs)
    assert_port_equal(jt.approx_quantile(cols, probs), got)
    assert got.shape == (1 if isinstance(cols, str) else len(cols), len(probs))


def test_iris_loads_bitwise(jsess, tsess):
    """The port's own iris.csv gives the reference's table (from
    scikit-learn) bit for bit: X, y, W and the domain."""
    jt, tt = jdatasets.load_iris(jsess), tdatasets.load_iris(tsess)
    _same_table(jt, tt)
    assert tt.domain.class_var.values == tuple(jt.domain.class_var.values)
    assert tt.n_rows == 150


def test_iris_numpy_round_trip(jsess, tsess):
    """Iris numpy -> TorchTable -> numpy equals TpuTable.from_numpy."""
    from sklearn.datasets import load_iris as sk_iris

    d = sk_iris()
    jt = TpuTable.from_numpy(jdatasets.load_iris(jsess).domain, d.data, d.target,
                             session=jsess)
    tt = TorchTable.from_numpy(tdatasets.load_iris(tsess).domain, d.data, d.target,
                               session=tsess)
    for a, b in zip(jt.to_numpy(), tt.to_numpy()):
        assert_port_equal(a, b)


@pytest.mark.parametrize("n,d,k,seed,noise", [(300, 4, 2, 0, 1.0), (257, 7, 3, 5, 0.1)])
def test_make_classification_draws(jsess, tsess, n, d, k, seed, noise):
    _same_table(jdatasets.make_classification(n, d, k, seed, noise, session=jsess),
                tdatasets.make_classification(n, d, k, seed, noise, session=tsess))


@pytest.mark.parametrize("weights", ["unit", "filtered", "random"])
def test_weighted_moments_and_inv_std(weights):
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((1000, 6)) * [1, 10, 0.1, 1, 1, 0]).astype(np.float32)
    W = np.ones(1000, np.float32)
    if weights == "filtered":
        W[rng.random(1000) < 0.4] = 0.0
    elif weights == "random":
        W = rng.uniform(0, 3, 1000).astype(np.float32)
    ref = jstats.weighted_moments(jnp.asarray(X), jnp.asarray(W))
    got = tstats.weighted_moments(torch.from_numpy(X), torch.from_numpy(W))
    for r, g in zip(ref, got):
        assert_port_equal(r, g, rtol=1e-6, atol=1e-7)
    assert_port_equal(jstats.inv_std_scale(jnp.asarray(X), jnp.asarray(W)),
                      tstats.inv_std_scale(torch.from_numpy(X), torch.from_numpy(W)),
                      rtol=1e-6)
    # a constant column scales by 1
    assert tstats.inv_std_scale(torch.from_numpy(X), torch.from_numpy(W))[5] == 1.0


def test_weighted_moments_all_filtered():
    X = torch.ones((5, 2))
    mean, var, tot = tstats.weighted_moments(X, torch.zeros(5))
    assert float(tot) == float(np.float32(tstats.EPS_TOTAL_WEIGHT))
    assert (mean == 0).all() and (var == 0).all()


def test_two_sided_z_pvalue():
    z = np.linspace(-9, 9, 181).astype(np.float32)
    assert_port_equal(jstats.two_sided_z_pvalue(jnp.asarray(z)),
                      tstats.two_sided_z_pvalue(torch.from_numpy(z)), rtol=1e-6, atol=1e-7)


_T = np.concatenate([np.linspace(-40, 40, 81), [0.0, 1e-3, 1.96, -2.58]])
_DF = np.array([1, 2, 3, 5, 10, 30, 100, 1e3, 1e4, 1e5, 1e6])


def test_betainc_on_the_t_grid():
    T, D = np.meshgrid(_T, _DF)
    a, b, x = D / 2, np.full_like(D, 0.5), D / (D + T * T)
    with jax.enable_x64():
        ref = jax.scipy.special.betainc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x))
        ref = np.asarray(ref)
    got = tstats.betainc(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert_port_equal(ref, got, atol=1e-9)


def test_betainc_random_arguments_and_edges():
    rng = np.random.default_rng(0)
    a = np.exp(rng.uniform(np.log(0.1), np.log(1e6), 500))
    b = np.exp(rng.uniform(np.log(0.1), np.log(1e6), 500))
    x = rng.uniform(0, 1, 500)
    x[:3] = [0.0, 1.0, 0.5]
    with jax.enable_x64():
        ref = np.asarray(jax.scipy.special.betainc(jnp.asarray(a), jnp.asarray(b),
                                                   jnp.asarray(x)))
    got = tstats.betainc(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(x))
    assert_port_equal(ref, got, atol=1e-9)
    assert to_np(got)[0] == 0.0 and to_np(got)[1] == 1.0


def test_two_sided_t_pvalue():
    T, D = np.meshgrid(_T, _DF)
    t32 = T.astype(np.float32)
    got = tstats.two_sided_t_pvalue(torch.from_numpy(t32), torch.from_numpy(D))
    assert got.dtype == torch.float32
    exact = 2 * scipy.stats.t.sf(np.abs(t32.astype(np.float64)), D)
    assert_port_equal(exact, got, atol=1e-7)
    with jax.enable_x64():   # the reference's formula in float64
        d64 = jnp.asarray(D)
        t64 = jnp.asarray(t32.astype(np.float64))
        ref64 = np.asarray(jax.scipy.special.betainc(d64 / 2.0, 0.5, d64 / (d64 + t64 * t64)))
    assert_port_equal(ref64, got, atol=1e-7)
    # the reference's float32 function, where its own rounding allows
    small = D <= 1e3
    ref32 = np.asarray(jstats.two_sided_t_pvalue(jnp.asarray(t32), jnp.asarray(D, jnp.float32)))
    assert_port_equal(ref32[small], to_np(got)[small], atol=1e-3)
