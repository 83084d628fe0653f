"""The rest of the port's ``models/feature_extra.py`` (everything but
SQLTransformer, which tests/test_torch_relational.py holds) against the JAX
package's, on the same seeded numpy tables (a few hundred rows, six
columns), with the ``interop`` converters and the widgets.

Tolerances, with their reasons:

- Selections, category maps, strings, products of columns, MinHash
  buckets, LSH buckets and neighbour indices: equal. The BRP buckets are
  floors of a six-term dot product that sums in another order than XLA's;
  on these inputs none lies within an ulp of a bucket edge.
- RobustScaler's quantiles interpolate with a multiply-add that XLA may
  fuse (rtol 1e-6); DCT is a product that sums in another float32 order
  (rtol 1e-5, atol 1e-5).
- Euclidean distances come from the expanded a² - 2ab + b², which cancels
  near 0: an ulp of squared norms of about 6 is 5e-7 in d², 1e-5 in d at d
  = 0.02 (atol 1e-4); Jaccard distances rtol 1e-5.
"""

import jax
import numpy as np
import pytest

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.models import feature_extra as JF
from orange3_spark_tpu_torch import interop
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.models import feature_extra as TF
from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY, OWTable
from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph

from _port_parity import assert_port_equal, to_np
from _torch_tables import assert_tables, table_pair

COLS = [(f"c{j}", None) for j in range(6)]


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession("cpu")


@pytest.fixture(scope="module")
def pair(jsess, tsess):
    rng = np.random.default_rng(11)
    n = 240
    X = rng.standard_normal((n, 6)).astype(np.float32)
    X[:, 3] = rng.integers(0, 4, n)                     # categorical-like
    X[:, 4] = np.where(rng.random(n) < 0.5, 0.0, X[:, 4])
    X[:, 5] = 0.25                                      # constant
    y = rng.integers(0, 3, n).astype(np.float32)
    X[:, 0] += y
    W = np.ones(n, np.float32)
    W[::11] = 0.0
    return table_pair(jsess, tsess, COLS, X, Y=y, W=W, class_var=("y", ("a", "b", "c")))


@pytest.mark.parametrize("kw", [{}, dict(with_centering=True, lower=0.1, upper=0.9,
                                         input_cols=("c0", "c2"))])
def test_robust_scaler(pair, kw):
    jt, tt = pair
    jm, tm = JF.RobustScaler(**kw).fit(jt), TF.RobustScaler(**kw).fit(tt)
    assert_port_equal(to_np(jm.median), tm.median.numpy(), rtol=1e-6, what="median")
    assert_port_equal(to_np(jm.iqr), tm.iqr.numpy(), rtol=1e-6, atol=1e-7, what="iqr")
    assert_tables(jm.transform(jt), tm.transform(tt), rtol=1e-5)
    conv = interop.robust_scaler_model({"median": to_np(jm.median), "iqr": to_np(jm.iqr)},
                                       jm.params.to_dict(), to_np(jm.idx), device="cpu")
    assert_tables(jm.transform(jt), conv.transform(tt), rtol=1e-6)


TRANSFORMS = [
    ("PolynomialExpansion", dict(degree=3, input_cols=("c0", "c1", "c2")), 0.0),
    ("PolynomialExpansion", {}, 0.0),
    ("DCT", {}, 1e-5),
    ("DCT", dict(inverse=True, input_cols=("c1", "c2", "c4")), 1e-5),
    ("Interaction", dict(input_cols=("c0", "c1", "c4")), 0.0),
    ("ElementwiseProduct", dict(scaling_vec=(1.0, -2.0, 0.5, 3.0, 1.5, 0.0)), 0.0),
    ("VectorSlicer", dict(names=("c2",), indices=(0, 4)), 0.0),
]


@pytest.mark.parametrize("name,kw,rtol", TRANSFORMS)
def test_transformers(pair, name, kw, rtol):
    jt, tt = pair
    ref = getattr(JF, name)(**kw).transform(jt)
    got = getattr(TF, name)(**kw).transform(tt)
    if rtol:
        assert_port_equal(to_np(ref.X), got.X.numpy(), rtol=rtol, atol=1e-5)
    else:
        assert_tables(ref, got)


def test_index_to_string_and_vector_indexer(jsess, tsess, pair):
    jt, tt = pair
    kw = dict(max_categories=4)
    jm, tm = JF.VectorIndexer(**kw).fit(jt), TF.VectorIndexer(**kw).fit(tt)
    assert jm.category_maps == tm.category_maps and 3 in tm.category_maps
    ji, ti = jm.transform(jt), tm.transform(tt)
    assert_tables(ji, ti)
    its = dict(input_col="c3", output_col="name")
    assert_tables(JF.IndexToString(**its).transform(ji), TF.IndexToString(**its).transform(ti))
    lab = dict(input_col="c3", labels=("w", "x"))
    assert_tables(JF.IndexToString(**lab).transform(jt), TF.IndexToString(**lab).transform(tt))
    rng = np.random.default_rng(2)
    X = rng.integers(0, 6, (40, 6)).astype(np.float32)
    j2, t2 = table_pair(jsess, tsess, COLS, X)
    keep = dict(max_categories=4, handle_invalid="keep")
    assert_tables(JF.VectorIndexer(**keep).fit(jt).transform(j2),
                  TF.VectorIndexer(**keep).fit(tt).transform(t2))
    with pytest.raises(ValueError, match="unseen at fit time"):
        tm.transform(t2)


@pytest.mark.parametrize("cls,kw", [
    ("VarianceThresholdSelector", dict(variance_threshold=0.5)),
    ("UnivariateFeatureSelector", dict(selection_threshold=3)),
    ("UnivariateFeatureSelector", dict(selection_mode="percentile", selection_threshold=0.5)),
    ("UnivariateFeatureSelector", dict(selection_mode="fpr", selection_threshold=0.05)),
    ("UnivariateFeatureSelector", dict(label_type="continuous", selection_threshold=2)),
    ("ChiSqSelector", dict(selection_threshold=2, n_bins=4)),
    ("ChiSqSelector", dict(selection_mode="fpr", selection_threshold=0.5, n_bins=8)),
])
def test_selectors(pair, cls, kw):
    jt, tt = pair
    jm, tm = getattr(JF, cls)(**kw).fit(jt), getattr(TF, cls)(**kw).fit(tt)
    assert jm.selected == tm.selected and len(tm.selected)
    assert_tables(jm.transform(jt), tm.transform(tt))


def test_chi2_scores(pair):
    jt, tt = pair
    ref = np.asarray(JF._chi2_stat(jt.X, jt.y, jt.W, 3, 6))
    got = TF.chi2_scores(tt.X, tt.y, tt.W, 3, 6).numpy()
    assert_port_equal(ref, got, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family,kw", [
    ("BucketedRandomProjectionLSH", dict(bucket_length=0.8, num_hash_tables=3, seed=4)),
    ("MinHashLSH", dict(num_hash_tables=4, seed=9)),
])
def test_lsh(pair, family, kw):
    jt, tt = pair
    jm, tm = getattr(JF, family)(**kw).fit(jt), getattr(TF, family)(**kw).fit(tt)
    assert_tables(jm.transform(jt), tm.transform(tt))
    key = to_np(jt.X)[5] + 0.01
    ri, rd = jm.approx_nearest_neighbors(jt, key, k=7)
    gi, gd = tm.approx_nearest_neighbors(tt, key, k=7)
    assert np.array_equal(ri, gi)
    assert_port_equal(rd, gd, rtol=1e-5, atol=1e-4)
    thr = 0.5 if family == "MinHashLSH" else 1.5
    a, b = (slice(0, 60), slice(60, 140))
    ref = jm.approx_similarity_join(_rows(jt, a), _rows(jt, b), thr)
    got = tm.approx_similarity_join(_rows(tt, a), _rows(tt, b), thr)
    assert np.array_equal(ref[0], got[0]) and np.array_equal(ref[1], got[1]) and len(ref[0])
    assert_port_equal(ref[2], got[2], rtol=1e-5, atol=1e-4)
    conv = (interop.brp_lsh_model({"R": to_np(jm.R)}, jm.params.to_dict(), device="cpu")
            if family != "MinHashLSH" else
            interop.minhash_lsh_model(jm.a, jm.b, jm.params.to_dict()))
    assert_tables(jm.transform(jt), conv.transform(tt))


def _rows(table, sl):
    X, Y, W = table.to_numpy()
    cls = type(table)
    return cls.from_numpy(table.domain, X[sl], Y[sl], None, W[sl], session=table.session)


@pytest.mark.parametrize("name,kw", [
    ("OWRobustScaler", {}), ("OWVectorIndexer", dict(max_categories=4)),
    ("OWVarianceThresholdSelector", dict(variance_threshold=0.5)),
    ("OWUnivariateFeatureSelector", dict(selection_threshold=2)),
    ("OWChiSqSelector", dict(selection_threshold=2)),
    ("OWBucketedRandomProjectionLSH", dict(num_hash_tables=2)), ("OWMinHashLSH", {}),
    ("OWPolynomialExpansion", {}), ("OWDCT", {}),
    ("OWInteraction", dict(input_cols=("c0", "c1"))),
    ("OWElementwiseProduct", dict(scaling_vec=(1.0,) * 6)),
    ("OWVectorSlicer", dict(indices=(1, 2))), ("OWIndexToString", dict(input_col="c3",
                                                                      labels=("p", "q"))),
])
def test_feature_widgets(pair, name, kw):
    _, tt = pair
    g = WorkflowGraph()
    src = g.add(OWTable(tt))
    node = g.add(WIDGET_REGISTRY[name](**kw))
    g.connect(src, "data", node, "data")
    out = g.run()[node]
    assert out["data"].n_rows == tt.n_rows
