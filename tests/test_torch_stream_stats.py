"""The port's out-of-core feature pipeline (io/streaming.py: the feature
statistics pass, ``score_stream``, StreamingKMeans under every schedule,
and the ``fit_stream`` methods of the scalers, the imputer and PCA) against
the JAX package on the same seeded numpy chunk streams.

Tolerances. Both packages fold the same shifted float32 accumulators and
finish in float64 on the host, so the statistics differ only by the order
of each chunk's float32 sums: means, min and max within 1e-6 relative,
variances and covariances within 1e-5 relative to their largest entry
(the ss - s²/n finish cancels). StreamingKMeans seeds on the host in both
packages (the same kmeans++ draws), so the centers agree within 1e-5 and
the step counts exactly, under every schedule. Scored parquet rows equal
the reference's exactly (cluster ids).
"""

import tempfile
import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.io import streaming as JS
from orange3_spark_tpu.models import kmeans as JK
from orange3_spark_tpu.models import pca as JPCA
from orange3_spark_tpu.models import preprocess as JP
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.io import streaming as TS
from orange3_spark_tpu_torch.models import kmeans as TK
from orange3_spark_tpu_torch.models import pca as TPCA
from orange3_spark_tpu_torch.models import preprocess as TP
from orange3_spark_tpu_torch.resilience.numerics import NumericalDivergenceError

from _port_parity import assert_columns_equal_up_to_sign, assert_port_equal, to_np


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession.builder_get_or_create("cpu")


def _data(n=5000, seed=0, nan_share=0.0):
    """Five columns, one of them epoch-timestamp-like (mean 1.5e9, std
    1e5, f64-exact in the check): unshifted f32 moments would keep none of
    its variance."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, 5)) * [1, 2, 3, 4, 1e5]
         + [0.5, -2, 10, 0, 1.5e9]).astype(np.float32)
    X[:, 1] += 0.5 * X[:, 0]
    if nan_share:
        X[:, :4][rng.random((n, 4)) < nan_share] = np.nan
    W = np.ones(n, np.float32)
    W[rng.random(n) < 0.1] = 0.0
    W[:10] = 1.0                     # the first chunk is live
    return X, W


def _close(ref, got, rel, what):
    ref = to_np(ref).astype(np.float64)
    assert_port_equal(ref, to_np(got).astype(np.float64),
                      atol=rel * float(np.abs(ref).max()), rtol=rel, what=what)


def _stats_both(jsess, tsess, X, W, chunk_rows=1024, **kw):
    a = JS.stream_feature_stats(JS.array_chunk_source(X, None, W, chunk_rows=700),
                                session=jsess, chunk_rows=chunk_rows, **kw)
    b = TS.stream_feature_stats(TS.array_chunk_source(X, None, W, chunk_rows=700),
                                session=tsess, chunk_rows=chunk_rows, **kw)
    return a, b


def test_feature_stats_match_the_reference_and_keep_large_means(jsess, tsess):
    X, W = _data()
    st = {}
    a, b = _stats_both(jsess, tsess, X, W, gramian=True, stage_times=st)
    assert a["count"] == b["count"] == float(W.sum())
    for key in ("mean", "min", "max"):
        _close(a[key], b[key], 1e-6, key)
    for key in ("var", "cov", "second_moment"):
        _close(a[key], b[key], 1e-5, key)
    live = W > 0
    truth = X[live].astype(np.float64)
    np.testing.assert_allclose(b["var"], truth.var(0), rtol=1e-4)   # the shift works
    np.testing.assert_allclose(b["mean"], truth.mean(0), rtol=1e-6)
    assert st["dispatches"] == 5 and 0.0 <= st["overlap_pct"] <= 100.0


@pytest.mark.parametrize("sentinel", [None, -999.0])
def test_missing_aware_stats(jsess, tsess, sentinel):
    X, W = _data(nan_share=0.2)
    if sentinel is not None:
        X[np.isnan(X)] = sentinel
    X[:, 3] = np.nan if sentinel is None else sentinel        # an all-missing column
    mv = float("nan") if sentinel is None else sentinel
    a, b = _stats_both(jsess, tsess, X, W, missing_value=mv)
    assert_port_equal(a["count"], b["count"], what="count")
    for key in ("mean", "min", "max"):
        _close(a[key], b[key], 1e-6, key)
    _close(a["var"], b["var"], 1e-5, "var")
    assert b["mean"][3] == 0.0 and b["min"][3] == 0.0 and b["count"][3] == 0.0


def test_feature_stats_refuse_bad_calls(tsess):
    with pytest.raises(ValueError, match="incompatible"):
        TS.stream_feature_stats(lambda: iter(()), session=tsess, gramian=True,
                                missing_value=0.0)
    with pytest.raises(ValueError, match="no chunks"):
        TS.stream_feature_stats(lambda: iter(()), session=tsess)


# ------------------------------------------------------------- fit_stream
def test_scaler_imputer_and_pca_fit_streams(jsess, tsess):
    X, W = _data()
    X = X[:, :4]
    src_j = JS.array_chunk_source(X, None, W, chunk_rows=900)
    src_t = TS.array_chunk_source(X, None, W, chunk_rows=900)
    for jest, test in ((JP.StandardScaler(with_mean=True), TP.StandardScaler(with_mean=True)),
                       (JP.MinMaxScaler(), TP.MinMaxScaler())):
        jm = jest.fit_stream(src_j, session=jsess, chunk_rows=1024)
        tm = test.fit_stream(src_t, session=tsess, chunk_rows=1024)
        _close(jm.shift, tm.shift, 1e-6, "shift")
        _close(jm.scale, tm.scale, 1e-5, "scale")
        assert_port_equal(jm.idxs, tm.idxs, what="idxs")
    Xn, Wn = _data(nan_share=0.2)
    jm = JP.Imputer().fit_stream(JS.array_chunk_source(Xn[:, :4], None, Wn), session=jsess,
                                 chunk_rows=1024)
    tm = TP.Imputer().fit_stream(TS.array_chunk_source(Xn[:, :4], None, Wn), session=tsess,
                                 chunk_rows=1024)
    _close(jm.fill, tm.fill, 1e-6, "fill")
    with pytest.raises(ValueError, match="strategy='mean' only"):
        TP.Imputer(strategy="median").fit_stream(src_t, session=tsess)
    with pytest.raises(ValueError, match="input_cols"):
        TP.StandardScaler(input_cols=("a",)).fit_stream(src_t, session=tsess)
    for center in (True, False):
        jp = JPCA.PCA(k=3, center=center).fit_stream(src_j, session=jsess, chunk_rows=1024)
        tp = TPCA.PCA(k=3, center=center).fit_stream(src_t, session=tsess, chunk_rows=1024)
        assert_columns_equal_up_to_sign(jp.components, tp.components, atol=1e-5,
                                        what="components")
        _close(jp.explained_variance, tp.explained_variance, 1e-5, "explained variance")
    with pytest.raises(ValueError, match="exceeds n_features"):
        TPCA.PCA(k=9).fit_stream(src_t, session=tsess)


def test_streamed_scaler_equals_the_in_memory_fit(tsess):
    from orange3_spark_tpu_torch.core.table import TorchTable

    X, W = _data()
    t = TorchTable.from_arrays(X[:, :4], session=tsess).with_weights(torch.from_numpy(W))
    mem = TP.StandardScaler(with_mean=True).fit(t)
    st = TP.StandardScaler(with_mean=True).fit_stream(
        TS.array_chunk_source(X[:, :4], None, W), session=tsess, chunk_rows=1024)
    _close(mem.shift, st.shift, 1e-6, "shift")
    _close(mem.scale, st.scale, 1e-5, "scale")


# ------------------------------------------------------------ score_stream
def test_score_stream_writes_the_reference_rows(jsess, tsess, tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    X, W = _data()
    X = X[:, :4]
    centers = np.random.default_rng(1).standard_normal((4, 4)).astype(np.float32)
    jc = jax.numpy.asarray(centers)
    tc = torch.from_numpy(centers)
    n_j = JS.score_stream(lambda Xd: JK._assign(Xd, jc, jax.numpy.ones(Xd.shape[0]))[0],
                          JS.array_chunk_source(X, None, W), str(tmp_path / "j.parquet"),
                          session=jsess, chunk_rows=1024)
    n_t = TS.score_stream(lambda Xd: TK._assign(Xd, tc, torch.ones(Xd.shape[0]))[0],
                          TS.array_chunk_source(X, None, W), str(tmp_path / "t.parquet"),
                          session=tsess, chunk_rows=1024)
    assert n_j == n_t == int((W > 0).sum())
    a, b = pq.read_table(tmp_path / "j.parquet"), pq.read_table(tmp_path / "t.parquet")
    assert a.column_names == b.column_names
    for name in a.column_names:
        assert_port_equal(a[name].to_numpy(), b[name].to_numpy(), what=name)
    with pytest.raises(ValueError, match="feature_names"):
        TS.score_stream(lambda Xd: Xd[:, 0], TS.array_chunk_source(X), str(tmp_path / "x"),
                        session=tsess, feature_names=("a",), include_features=False)


# --------------------------------------------------------- StreamingKMeans
def _stream(X, W, pre_seed):
    if pre_seed:    # a first chunk with no live row: streamed before seeding
        W = W.copy()
        W[:600] = 0.0
    return W


SCHEDULES = [
    ("stream", {}, {}),
    ("cache", {}, dict(cache_device=True)),
    ("cache_epoch", dict(replay_granularity="epoch", epochs_per_dispatch=2),
     dict(cache_device=True)),
    ("defer", dict(defer_epoch1=True), dict(cache_device=True)),
    ("defer_epoch", dict(defer_epoch1=True, replay_granularity="epoch"),
     dict(cache_device=True)),
    ("spill", {}, dict(cache_device=True, cache_device_bytes=30_000, spill=True)),
    ("spill_defer", dict(defer_epoch1=True),
     dict(cache_device=True, cache_device_bytes=30_000, spill=True)),
    ("overflow", {}, dict(cache_device=True, cache_device_bytes=30_000)),
]


@pytest.mark.parametrize("pre_seed", [False, True])
@pytest.mark.parametrize("name,params,fit_kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_streaming_kmeans_schedules_match_the_reference(jsess, tsess, name, params, fit_kw,
                                                        pre_seed):
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((4000, 3)) + rng.integers(0, 4, (4000, 1)) * 3).astype(np.float32)
    W = _stream(X, np.ones(4000, np.float32), pre_seed)
    kw = dict(k=4, epochs=3, chunk_rows=512, seed=0, decay=0.9, **params)
    fit_kw = dict(fit_kw)
    spill = fit_kw.pop("spill", False)
    models = []
    for S, sess in ((JS, jsess), (TS, tsess)):
        extra = dict(cache_spill_dir=tempfile.mkdtemp()) if spill else {}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            models.append(S.StreamingKMeans(**kw).fit_stream(
                S.array_chunk_source(X, None, W, chunk_rows=300), n_features=3,
                session=sess, **fit_kw, **extra))
        overflowed = any("overflowed" in str(w.message) for w in caught)
        assert overflowed == (name == "overflow")
    ref, got = models
    assert ref.n_iter_ == got.n_iter_
    assert_port_equal(ref.centers, got.centers, atol=1e-5, what=f"centers ({name})")


def test_streaming_kmeans_cache_equals_the_restreamed_fit(tsess):
    """The cached replay (one captured graph an epoch on the card; the same
    steps here) is bitwise the fit that re-streams the source every epoch."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((5000, 4)).astype(np.float32)
    fits = [TS.StreamingKMeans(k=5, epochs=4, chunk_rows=1024).fit_stream(
        TS.array_chunk_source(X), n_features=4, session=tsess, cache_device=c)
        for c in (False, True)]
    assert torch.equal(fits[0].centers, fits[1].centers)
    assert fits[0].n_iter_ == fits[1].n_iter_ == 20


def test_streaming_kmeans_table_fit_and_widget_params(jsess, tsess):
    from orange3_spark_tpu.core.table import TpuTable
    from orange3_spark_tpu_torch.core.table import TorchTable

    X = np.random.default_rng(5).standard_normal((3000, 2)).astype(np.float32)
    jm = JS.StreamingKMeans(k=3, epochs=2, chunk_rows=1000).fit(
        TpuTable.from_arrays(X, session=jsess))
    tm = TS.StreamingKMeans(k=3, epochs=2, chunk_rows=1000).fit(
        TorchTable.from_arrays(X, session=tsess))
    assert_port_equal(jm.centers, tm.centers, atol=1e-5, what="centers")
    assert jm.n_iter_ == tm.n_iter_ and tm.training_cost_ is None


def test_streaming_kmeans_guards(tsess):
    X = np.ones((100, 2), np.float32)
    with pytest.raises(ValueError, match="replay_granularity"):
        TS.StreamingKMeans(replay_granularity="chunk").fit_stream(
            TS.array_chunk_source(X), n_features=2, session=tsess)
    with pytest.raises(ValueError, match="no live rows"):
        TS.StreamingKMeans(k=2).fit_stream(
            TS.array_chunk_source(X, None, np.zeros(100, np.float32)), n_features=2,
            session=tsess)
    bad = np.random.default_rng(0).standard_normal((2000, 2)).astype(np.float32)
    bad[1500] = np.inf
    with pytest.raises(NumericalDivergenceError):
        TS.StreamingKMeans(k=2, epochs=2, chunk_rows=512).fit_stream(
            TS.array_chunk_source(bad), n_features=2, session=tsess)
