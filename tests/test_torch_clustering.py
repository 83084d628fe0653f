"""The port's KMeans, PCA, ClusteringEvaluator and distributed Gramian
against the JAX package on the same seeded numpy tables.

Tolerances. KMeans' eager init is host numpy in both packages, so the
seeded centers are BITWISE the reference's; after Lloyd's iterations the
centers within 1e-5 (absolute, on blobs of unit spread), the cost within
1e-5 relative (the identity |x|² - 2x·c + |c|² cancels, so its float32
rounding is relative to |x|², not to the distance, and the two packages
sum x·c in their own orders), the same iteration count, cluster sizes and
cluster ids.
PCA's components are compared after aligning each column's sign (an
eigenvector's sign is arbitrary in every solver), within 1e-5; explained
and total variance within 1e-5 relative; projections up to sign within
1e-5 of their largest entry. The silhouette within 1e-5, the Gramian
within 1e-6 relative. The device init draws the reference's stream
(``ops/prng``): its centers within 1e-5 of the reference's device init;
it is also repeatable, picks live rows only, and in the staged refit
equals the port's eager run of the same init (tests/test_torch_workflow.py).
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
from orange3_spark_tpu.models import evaluation as JE
from orange3_spark_tpu.models import kmeans as JK
from orange3_spark_tpu.models import pca as JPCA
from orange3_spark_tpu.parallel.collectives import distributed_gramian as j_gramian
from orange3_spark_tpu_torch import interop
from orange3_spark_tpu_torch.core import domain as tdom
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models import evaluation as TE
from orange3_spark_tpu_torch.models import kmeans as TK
from orange3_spark_tpu_torch.models import pca as TPCA
from orange3_spark_tpu_torch.models.base import staging
from orange3_spark_tpu_torch.parallel.collectives import distributed_gramian as t_gramian

from _port_parity import assert_columns_equal_up_to_sign, assert_port_equal, to_np


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession.builder_get_or_create("cpu")


def _blobs(n=3000, d=4, k=5, seed=0, dead_share=0.1):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (k, d))
    lab = rng.integers(0, k, n)
    X = (centers[lab] + rng.standard_normal((n, d))).astype(np.float32)
    W = np.ones(n, np.float32)
    W[rng.random(n) < dead_share] = 0.0
    X[W == 0] += 1000.0                      # dead outliers must never seed
    return X, W


def _tables(jsess, tsess, X, W=None):
    names = [f"x{i}" for i in range(X.shape[1])]
    return (TpuTable.from_numpy(jdom.Domain([jdom.ContinuousVariable(c) for c in names]),
                                X, W=W, session=jsess),
            TorchTable.from_numpy(tdom.Domain([tdom.ContinuousVariable(c) for c in names]),
                                  X, W=W, session=tsess))


@pytest.fixture(scope="module")
def blobs(jsess, tsess):
    X, W = _blobs()
    return _tables(jsess, tsess, X, W)


# ------------------------------------------------------------------- KMeans
@pytest.mark.parametrize("init_mode", ["k-means||", "random"])
@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_centers_are_bitwise_the_reference(blobs, init_mode, seed):
    jt, tt = blobs
    kw = dict(k=5, init_mode=init_mode, seed=seed, init_sample_size=1000)
    ref = np.asarray(JK.KMeans(**kw)._init_centers(jt))
    got = TK.KMeans(**kw)._init_centers(tt)
    assert_port_equal(ref, got, what="seeded centers")
    assert float(np.abs(ref).max()) < 100.0        # no dead (outlier) row seeded


def test_kmeanspp_seed_is_the_reference_function():
    sample = np.random.default_rng(3).standard_normal((500, 3))
    for k in (4, 600):      # 600 > rows: the jitter padding
        assert_port_equal(JK.kmeanspp_seed(sample, k, np.random.default_rng(1)),
                          TK.kmeanspp_seed(sample, k, np.random.default_rng(1)),
                          what="kmeans++")


@pytest.mark.parametrize("max_iter", [1, 3, 20])
def test_kmeans_fit_matches_the_reference(blobs, max_iter):
    jt, tt = blobs
    jm = JK.KMeans(k=5, max_iter=max_iter, seed=1).fit(jt)
    tm = TK.KMeans(k=5, max_iter=max_iter, seed=1).fit(tt)
    assert jm.n_iter_ == tm.n_iter_
    assert_port_equal(jm.centers, tm.centers, atol=1e-5, what="centers")
    assert tm.training_cost_ == pytest.approx(jm.training_cost_, rel=1e-5)
    assert_port_equal(jm.cluster_sizes_, tm.cluster_sizes_, what="cluster sizes")
    assert_port_equal(jm.predict(jt), tm.predict(tt), what="cluster ids")
    assert tm.compute_cost(tt) == pytest.approx(jm.compute_cost(jt), rel=1e-5)
    assert_port_equal(jm.transform(jt).X, tm.transform(tt).X, atol=1e-5, what="transform")
    assert [v.name for v in tm.transform(tt).domain.attributes][-1] == "cluster"


def test_kmeans_n_init_keeps_the_lowest_cost(blobs):
    jt, tt = blobs
    jm = JK.KMeans(k=6, n_init=3, max_iter=5, seed=2, init_mode="random").fit(jt)
    tm = TK.KMeans(k=6, n_init=3, max_iter=5, seed=2, init_mode="random").fit(tt)
    assert jm.n_iter_ == tm.n_iter_
    assert_port_equal(jm.centers, tm.centers, atol=1e-5, what="centers")
    assert tm.training_cost_ == pytest.approx(jm.training_cost_, rel=1e-5)
    costs = [TK.KMeans(k=6, max_iter=5, seed=s, init_mode="random").fit(tt).training_cost_
             for s in (2, 3, 4)]
    assert tm.training_cost_ == min(costs)


def test_kmeans_with_fewer_rows_than_k(jsess, tsess):
    X = np.random.default_rng(4).standard_normal((3, 2)).astype(np.float32)
    jt, tt = _tables(jsess, tsess, X)
    for mode in ("k-means||", "random"):
        jm = JK.KMeans(k=5, init_mode=mode, max_iter=4).fit(jt)
        tm = TK.KMeans(k=5, init_mode=mode, max_iter=4).fit(tt)
        assert_port_equal(jm.centers, tm.centers, atol=1e-6, what=f"centers {mode}")
        assert_port_equal(jm.predict(jt), tm.predict(tt), what="ids")


def test_kmeans_bf16_assignment(blobs):
    jt, tt = blobs
    jm = JK.KMeans(k=5, max_iter=5, compute_dtype="bfloat16").fit(jt)
    tm = TK.KMeans(k=5, max_iter=5, compute_dtype="bfloat16").fit(tt)
    assert jm.n_iter_ == tm.n_iter_
    assert_port_equal(jm.centers, tm.centers, atol=1e-4, what="centers")


def test_kmeans_without_live_rows_raises(tsess):
    t = TorchTable.from_arrays(np.ones((4, 2), np.float32), session=tsess).with_weights(
        torch.zeros(4))
    with pytest.raises(ValueError, match="no live rows"):
        TK.KMeans(k=2).fit(t)


def test_lloyd_fixed_trip_form_is_bitwise_the_host_loop(blobs):
    _, tt = blobs
    c0 = TK.KMeans(k=5, seed=3)._init_centers(tt)
    for max_iter, tol in ((10, 1e-4), (50, 1e-4), (4, 0.0), (0, 1e-4)):
        eager = TK._lloyd(tt.X, tt.W, c0, tol, k=5, max_iter=max_iter)
        fixed = TK._lloyd_fixed(tt.X, tt.W, c0, tol, k=5, max_iter=max_iter)
        for a, b in zip(eager[:3], fixed[:3]):
            assert torch.equal(a, b)
        assert int(fixed[3]) == eager[3]


@pytest.mark.parametrize("init_mode", ["k-means||", "random"])
def test_device_init_repeats_and_seeds_live_rows(blobs, init_mode):
    _, tt = blobs
    est = TK.KMeans(k=5, init_mode=init_mode, init_sample_size=512, seed=4)
    a = est._device_init_centers(tt.X, tt.W)
    b = est._device_init_centers(tt.X, tt.W)
    assert torch.equal(a, b) and a.shape == (5, 4)
    assert float(a.abs().max()) < 100.0           # no dead outlier row
    other = TK.KMeans(k=5, init_mode=init_mode, init_sample_size=512, seed=5)
    assert not torch.equal(a, other._device_init_centers(tt.X, tt.W))


@pytest.mark.parametrize("init_mode", ["k-means||", "random"])
@pytest.mark.parametrize("seed", [0, 4])
def test_device_init_draws_the_reference_centers(blobs, init_mode, seed):
    """The device init (staged refit) draws the reference's gumbels,
    categoricals and normals from JAX's stream (``ops/prng``): the same rows
    are picked, so the centers equal the reference's ``_device_init_centers``
    within 1e-5 (the random mode's jitter is 1e-3 x a normal within a few
    ulp of the reference's)."""
    jt, tt = blobs
    kw = dict(k=5, init_mode=init_mode, init_sample_size=512, seed=seed)
    ref = np.asarray(JK.KMeans(**kw)._device_init_centers(jt.X, jt.W))
    got = TK.KMeans(**kw)._device_init_centers(tt.X, tt.W)
    assert_port_equal(ref, got, atol=1e-5, what="device-init centers")


def test_device_random_init_pads_past_the_live_rows(tsess):
    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    W = np.array([1, 1, 0, 0, 0, 0], np.float32)
    t = TorchTable.from_arrays(X, session=tsess).with_weights(torch.from_numpy(W))
    c = TK.KMeans(k=4, init_mode="random")._device_init_centers(t.X, t.W)
    live = {tuple(r) for r in X[:2].tolist()}
    assert {tuple(r) for r in c[:2].tolist()} <= live
    # the picks past the two live rows are jittered copies of the first
    assert float((c[2:] - c[0]).abs().max()) < 0.1 and not torch.equal(c[2], c[0])


def test_staged_fit_reports_no_host_diagnostics(blobs):
    """Inside staging() the fit reads nothing on the host: n_iter_ and
    training_cost_ are None (models.base.concrete_or_none)."""
    _, tt = blobs
    with staging():
        m = TK.KMeans(k=5, max_iter=6).fit(tt)
    assert m.n_iter_ is None and m.training_cost_ is None
    assert m.centers.shape == (5, 4)
    assert TK.KMeans(k=5, max_iter=6).fit(tt).n_iter_ > 0


def test_kmeans_model_carries_from_the_jax_package(blobs):
    jt, tt = blobs
    jm = JK.KMeans(k=5, seed=6).fit(jt)
    tm = interop.kmeans_model({"centers": np.asarray(jm.centers)}, jm.params.to_dict(),
                              device="cpu")
    assert_port_equal(jm.predict(jt), tm.predict(tt), what="cluster ids")
    assert_port_equal(np.asarray(JK._assign(jt.X, jm.centers, jt.W)[0]),
                      tm._device_predict(tt), what="device predict")


# ---------------------------------------------------------------------- PCA
@pytest.fixture(scope="module")
def correlated(jsess, tsess):
    # a well-separated spectrum (standard deviations 5, 4, 3, 2, 1.5, 1 along
    # random orthogonal axes): every component is determined to float32
    # precision, ‖C‖·eps / gap ~ 2e-6
    rng = np.random.default_rng(8)
    Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    A = np.diag([5.0, 4.0, 3.0, 2.0, 1.5, 1.0]) @ Q.T
    X = (rng.standard_normal((4000, 6)) @ A + [3, -1, 0, 2, 5, 1]).astype(np.float32)
    W = np.where(rng.random(4000) < 0.05, 0.0, 1.0).astype(np.float32)
    return _tables(jsess, tsess, X, W)


@pytest.mark.parametrize("k,center", [(3, True), (6, True), (2, False)])
def test_pca_matches_the_reference_up_to_sign(correlated, k, center):
    jt, tt = correlated
    jm, tm = JPCA.PCA(k=k, center=center).fit(jt), TPCA.PCA(k=k, center=center).fit(tt)
    assert_columns_equal_up_to_sign(jm.components, tm.components, atol=1e-5,
                                    what="components")
    assert_port_equal(jm.explained_variance, tm.explained_variance, rtol=1e-5,
                      what="explained variance")
    assert float(tm.total_variance) == pytest.approx(float(jm.total_variance), rel=1e-5)
    assert_port_equal(jm.mean, tm.mean, atol=1e-5, what="mean")
    jz, tz = to_np(jm.transform(jt).X), to_np(tm.transform(tt).X)
    assert_columns_equal_up_to_sign(jz, tz, atol=1e-5 * np.abs(jz).max(), what="projection")
    np.testing.assert_allclose(tm.explained_variance_ratio_, jm.explained_variance_ratio_,
                               rtol=1e-5)


def test_pca_rejects_k_past_the_features(correlated):
    _, tt = correlated
    with pytest.raises(ValueError, match="exceeds n_features"):
        TPCA.PCA(k=7).fit(tt)


def test_pca_model_carries_from_the_jax_package(correlated):
    jt, tt = correlated
    jm = JPCA.PCA(k=3).fit(jt)
    tm = interop.pca_model({k: np.asarray(v) for k, v in jm.state_pytree.items()},
                           jm.params.to_dict(), device="cpu")
    jz = to_np(jm.transform(jt).X)
    assert_port_equal(jz, tm.transform(tt).X, atol=1e-5 * np.abs(jz).max(), what="projection")


def test_projection_rows_do_not_depend_on_the_row_count(correlated):
    """The projection sums each row's products in column order: a row's
    bits are the same in a table of any length (a BLAS product may round a
    ragged tail apart)."""
    _, tt = correlated
    m = TPCA.PCA(k=3).fit(tt)
    full = m.transform(tt).X
    for n in (1, 7, 33, 1000):
        sub = TorchTable(tt.domain, tt.X[:n], None, tt.W[:n], None, n, tt.session)
        assert torch.equal(m.transform(sub).X, full[:n])


def test_distributed_gramian(correlated):
    jt, tt = correlated
    for center in (True, False):
        jg = j_gramian(jt.X, jt.W, center=center)
        tg = t_gramian(tt.X, tt.W, center=center)
        for a, b, what in zip(jg, tg, ("G", "mean", "total")):
            ref = to_np(a)
            assert_port_equal(ref, b, atol=1e-6 * float(np.abs(ref).max()), rtol=1e-6,
                              what=what)


# ---------------------------------------------------------------- evaluator
def test_clustering_evaluator_silhouette(blobs):
    jt, tt = blobs
    jm, tm = JK.KMeans(k=5, seed=1).fit(jt), TK.KMeans(k=5, seed=1).fit(tt)
    ref = JE.ClusteringEvaluator().evaluate(jm.transform(jt))
    got = TE.ClusteringEvaluator().evaluate(tm.transform(tt))
    assert got == pytest.approx(ref, abs=1e-5)
    assert 0.3 < got <= 1.0
    with pytest.raises(ValueError, match="unknown metric"):
        TE.ClusteringEvaluator(metric_name="davies").evaluate(tm.transform(tt))
    assert TE._silhouette_centroid(tt.X, torch.zeros(tt.n_pad), tt.W, 1).numel() == 1
