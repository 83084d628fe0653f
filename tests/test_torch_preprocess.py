"""The port's feature transformers (models/preprocess.py) against the JAX
package's on the same seeded numpy tables.

Tolerances: integer and discrete outputs (bins, one-hot columns, string
indices, binarized cells, hash buckets) are exact; float states and
outputs within 1e-6 relative to the largest reference entry of the array
(the two packages sum the moments in their own orders). The fitted
preprocessors carried from the JAX package (interop) transform bitwise as
the reference does where the op is the same elementwise formula.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.core import domain as jdom
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.core.table import TpuTable
from orange3_spark_tpu.models import preprocess as JP
from orange3_spark_tpu_torch import interop
from orange3_spark_tpu_torch.core import domain as tdom
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models import preprocess as TP

from _port_parity import assert_port_equal, to_np

REL = 1e-6


def close(ref, got, what=""):
    ref = to_np(ref)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    assert_port_equal(ref, got, atol=REL * scale, rtol=REL, what=what)


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession.builder_get_or_create("cpu")


def _domain(m, n_cont=4):
    attrs = [m.ContinuousVariable(f"c{i}") for i in range(n_cont)]
    attrs += [m.DiscreteVariable("color", ("red", "green", "blue")),
              m.DiscreteVariable("size", ("s", "m", "l", "xl"))]
    return m.Domain(attrs, m.ContinuousVariable("y"), [m.StringVariable("city")])


def _data(n=300, seed=0, nan_share=0.0, sentinel=None):
    rng = np.random.default_rng(seed)
    cont = (rng.standard_normal((n, 4)) * [1, 5, 0.1, 10] + [0, 3, -2, 100]).astype(np.float32)
    cont[:, 2] = np.round(cont[:, 2], 1)          # ties for mode / quantiles
    if nan_share:
        cont[rng.random((n, 4)) < nan_share] = np.nan if sentinel is None else sentinel
    disc = np.stack([rng.integers(0, 3, n), rng.integers(0, 4, n)], 1).astype(np.float32)
    X = np.concatenate([cont, disc], 1)
    y = (rng.random(n) < 0.3 + 0.2 * disc[:, 0]).astype(np.float32)
    metas = rng.choice(["oslo", "rome", "lima", "kyiv", "nuuk"], size=(n, 1),
                       p=[0.4, 0.3, 0.15, 0.1, 0.05]).astype(object)
    W = np.ones(n, np.float32)
    W[rng.random(n) < 0.1] = 0.0                   # filtered rows
    return X, y, metas, W


def _tables(jsess, tsess, **kw):
    X, y, metas, W = _data(**kw)
    return (TpuTable.from_numpy(_domain(jdom), X, y, metas, W, session=jsess),
            TorchTable.from_numpy(_domain(tdom), X, y, metas, W, session=tsess))


@pytest.fixture(scope="module")
def tables(jsess, tsess):
    return _tables(jsess, tsess)


def _out(jt_out, tt_out):
    assert [v.name for v in jt_out.domain.attributes] == [v.name for v in tt_out.domain.attributes]
    return to_np(jt_out.X), to_np(tt_out.X)


# ------------------------------------------------------------------ scalers
@pytest.mark.parametrize("with_mean,with_std,cols", [
    (False, True, None), (True, True, None), (True, False, None), (True, True, ("c1", "c3"))])
def test_standard_scaler(tables, with_mean, with_std, cols):
    jt, tt = tables
    jm = JP.StandardScaler(with_mean=with_mean, with_std=with_std, input_cols=cols).fit(jt)
    tm = TP.StandardScaler(with_mean=with_mean, with_std=with_std, input_cols=cols).fit(tt)
    assert_port_equal(jm.idxs, tm.idxs, what="idxs")
    close(jm.shift, tm.shift, "shift")
    close(jm.scale, tm.scale, "scale")
    close(*_out(jm.transform(jt), tm.transform(tt)), "X")
    close(jm.std, tm.std, "std")


def test_min_max_scaler_with_a_constant_column(jsess, tsess):
    X, y, metas, W = _data()
    X[:, 1] = 7.0
    jt = TpuTable.from_numpy(_domain(jdom), X, y, metas, W, session=jsess)
    tt = TorchTable.from_numpy(_domain(tdom), X, y, metas, W, session=tsess)
    jm = JP.MinMaxScaler(min=-1.0, max=2.0).fit(jt)
    tm = TP.MinMaxScaler(min=-1.0, max=2.0).fit(tt)
    close(jm.shift, tm.shift, "min")
    close(jm.scale, tm.scale, "scale")
    close(*_out(jm.transform(jt), tm.transform(tt)), "X")


def test_max_abs_scaler(tables):
    jt, tt = tables
    jm, tm = JP.MaxAbsScaler().fit(jt), TP.MaxAbsScaler().fit(tt)
    close(jm.scale, tm.scale, "scale")
    close(*_out(jm.transform(jt), tm.transform(tt)), "X")


# ------------------------------------------------------------------ imputer
@pytest.mark.parametrize("strategy", ["mean", "median", "mode"])
@pytest.mark.parametrize("sentinel", [None, -999.0])
def test_imputer(jsess, tsess, strategy, sentinel):
    jt, tt = _tables(jsess, tsess, nan_share=0.15, sentinel=sentinel)
    mv = float("nan") if sentinel is None else sentinel
    jm = JP.Imputer(strategy=strategy, missing_value=mv).fit(jt)
    tm = TP.Imputer(strategy=strategy, missing_value=mv).fit(tt)
    close(jm.fill, tm.fill, "fill")
    close(*_out(jm.transform(jt), tm.transform(tt)), "X")


# -------------------------------------------------- discretization, encoding
def test_bucketizer_is_exact(tables):
    jt, tt = tables
    splits = (-np.inf, -1.0, 0.0, 0.5, 2.0, np.inf)
    jx, tx = _out(JP.Bucketizer(splits=splits, input_col="c0").transform(jt),
                  TP.Bucketizer(splits=splits, input_col="c0").transform(tt))
    assert_port_equal(jx, tx, what="binned")
    with pytest.raises(ValueError, match="split points"):
        TP.Bucketizer(splits=(0.0, 1.0), input_col="c0")


@pytest.mark.parametrize("k", [2, 4, 7])
def test_quantile_discretizer(tables, k):
    jt, tt = tables
    jb = JP.QuantileDiscretizer(num_buckets=k, input_col="c1").fit(jt)
    tb = TP.QuantileDiscretizer(num_buckets=k, input_col="c1").fit(tt)
    assert jb.params.splits == tb.params.splits
    assert_port_equal(*_out(jb.transform(jt), tb.transform(tt)), what="binned")


@pytest.mark.parametrize("drop_last", [True, False])
def test_one_hot_encoder_is_exact(tables, drop_last):
    jt, tt = tables
    kw = dict(input_cols=("color", "size"), drop_last=drop_last)
    jm, tm = JP.OneHotEncoder(**kw).fit(jt), TP.OneHotEncoder(**kw).fit(tt)
    assert (jm.col_idx, jm.sizes) == (tm.col_idx, tm.sizes)
    assert_port_equal(*_out(jm.transform(jt), tm.transform(tt)), what="one-hot")
    assert not tm.staged_capturable
    assert TP.OneHotEncoder(**kw, handle_invalid="keep").fit(tt).staged_capturable


def test_one_hot_encoder_rejects_an_unseen_category(jsess, tsess):
    jt, tt = _tables(jsess, tsess)
    tm = TP.OneHotEncoder(input_cols=("color",)).fit(tt)
    X = to_np(tt.X).copy()
    X[3, 4] = 5.0
    bad = TorchTable.from_numpy(tt.domain, X[: tt.n_rows], to_np(tt.Y)[: tt.n_rows],
                                tt.metas, session=tsess)
    with pytest.raises(ValueError, match="unseen at fit"):
        tm.transform(bad)


@pytest.mark.parametrize("order", ["frequencyDesc", "alphabetAsc"])
def test_string_indexer_is_exact(tables, order):
    jt, tt = tables
    jm = JP.StringIndexer(input_col="city", order=order).fit(jt)
    tm = TP.StringIndexer(input_col="city", order=order).fit(tt)
    assert tuple(jm.labels) == tm.labels
    assert_port_equal(*_out(jm.transform(jt), tm.transform(tt)), what="index")


def test_string_indexer_unseen_labels(jsess, tsess):
    jt, tt = _tables(jsess, tsess)
    jm = JP.StringIndexer(input_col="city", handle_invalid="keep").fit(jt)
    tm = TP.StringIndexer(input_col="city", handle_invalid="keep").fit(tt)
    X, y, metas, W = _data(seed=1)
    metas[:5, 0] = "paris"
    jn = TpuTable.from_numpy(_domain(jdom), X, y, metas, W, session=jsess)
    tn = TorchTable.from_numpy(_domain(tdom), X, y, metas, W, session=tsess)
    assert_port_equal(*_out(jm.transform(jn), tm.transform(tn)), what="index")
    strict = TP.StringIndexer(input_col="city").fit(tt)
    with pytest.raises(ValueError, match="unseen label"):
        strict.transform(TorchTable.from_numpy(_domain(tdom), X, y, metas, session=tsess))


# ------------------------------------------------------------------ stateless
@pytest.mark.parametrize("p", [1.0, 2.0, 3.0, float("inf")])
def test_normalizer(tables, p):
    jt, tt = tables
    close(*_out(JP.Normalizer(p=p).transform(jt), TP.Normalizer(p=p).transform(tt)), "X")


@pytest.mark.parametrize("cols", [None, ("c0", "c2")])
def test_binarizer_is_exact(tables, cols):
    jt, tt = tables
    assert_port_equal(*_out(JP.Binarizer(threshold=0.25, input_cols=cols).transform(jt),
                            TP.Binarizer(threshold=0.25, input_cols=cols).transform(tt)),
                      what="binarized")


def test_vector_assembler(tables):
    jt, tt = tables
    assert_port_equal(*_out(JP.VectorAssembler(["c3", "color"]).transform(jt),
                            TP.VectorAssembler(["c3", "color"]).transform(tt)), what="X")


@pytest.mark.parametrize("cols", [(), ("c0", "color", "c3", "size")])
def test_feature_hasher(tables, cols):
    jt, tt = tables
    close(*_out(JP.FeatureHasher(num_features=16, input_cols=cols).transform(jt),
                TP.FeatureHasher(num_features=16, input_cols=cols).transform(tt)), "hashed")


@pytest.mark.parametrize("smoothing", [0.0, 5.0])
def test_target_encoder(tables, smoothing):
    jt, tt = tables
    kw = dict(input_cols=("color", "size"), smoothing=smoothing)
    jm, tm = JP.TargetEncoder(**kw).fit(jt), TP.TargetEncoder(**kw).fit(tt)
    assert jm.prior == pytest.approx(tm.prior, rel=REL)
    for j, t in zip(jm.tables, tm.tables):
        close(j, t, "encoding")
    close(*_out(jm.transform(jt), tm.transform(tt)), "X")


# ------------------------------------------------------------- carried state
def test_fitted_preprocessors_carry_from_the_jax_package(tables):
    """interop's preprocess models from the reference's fitted state
    transform as the reference's models do."""
    jt, tt = tables

    def state(m):
        return {k: np.asarray(v) for k, v in m.state_pytree.items()}

    cases = [
        (JP.StandardScaler(with_mean=True).fit(jt), interop.standard_scaler_model),
        (JP.MinMaxScaler().fit(jt), interop.min_max_scaler_model),
        (JP.MaxAbsScaler().fit(jt), interop.max_abs_scaler_model),
        (JP.Imputer().fit(jt), interop.imputer_model),
    ]
    for jm, make in cases:
        tm = make(state(jm), jm.params.to_dict(), device="cpu")
        assert_port_equal(*_out(jm.transform(jt), tm.transform(tt)), what=type(jm).__name__)
    oh = JP.OneHotEncoder(input_cols=("color",)).fit(jt)
    tm = interop.one_hot_encoder_model(oh.params.to_dict(), oh.col_idx, oh.sizes)
    assert_port_equal(*_out(oh.transform(jt), tm.transform(tt)), what="one-hot")
    si = JP.StringIndexer(input_col="city").fit(jt)
    tm = interop.string_indexer_model(si.params.to_dict(), si.labels)
    assert_port_equal(*_out(si.transform(jt), tm.transform(tt)), what="index")
    te = JP.TargetEncoder(input_cols=("size",)).fit(jt)
    tm = interop.target_encoder_model(state(te), te.params.to_dict(), te.col_idx, te.prior,
                                      device="cpu")
    assert_port_equal(*_out(te.transform(jt), tm.transform(tt)), what="target encoding")


def test_staged_capturability_declarations():
    """The capturability each preprocessor declares to staging."""
    assert TP.StandardScaler().staged_fit_capturable
    assert TP.MinMaxScaler().staged_fit_capturable
    assert TP.MaxAbsScaler().staged_fit_capturable
    assert TP.Imputer().staged_fit_capturable
    assert not TP.Imputer(strategy="mode").staged_fit_capturable
    assert not TP.OneHotEncoder(input_cols=("a",)).staged_fit_capturable
    assert not TP.StringIndexerModel(TP.StringIndexerParams(), ["a"]).staged_capturable
    assert torch.equal(TP._scale_transform(torch.ones(2, 3), torch.tensor([1]),
                                           torch.tensor([1.0]), torch.tensor([2.0])),
                       torch.tensor([[1.0, 0.0, 1.0], [1.0, 0.0, 1.0]]))
