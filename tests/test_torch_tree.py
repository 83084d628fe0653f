"""Tree induction of the port (orange3_spark_tpu_torch/models/_tree.py,
ops/stats.py) against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.models import _tree as jt
from orange3_spark_tpu.ops.stats import weighted_quantiles as jax_quantiles
from orange3_spark_tpu_torch.models import _tree as tt
from orange3_spark_tpu_torch.ops.stats import weighted_quantiles


def _t(x):
    return torch.from_numpy(np.array(x))


def _data(n=3000, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    return rng, X


@pytest.mark.parametrize("weights", ["unit", "filtered"])
@pytest.mark.parametrize("max_bins", [10, 32])
def test_compute_bin_edges_bitwise(weights, max_bins):
    rng, X = _data()
    W = np.ones(len(X), np.float32)
    if weights == "filtered":
        W[rng.random(len(X)) < 0.3] = 0.0   # filter() zeroes weights
        W[-7:] = 0.0                        # padding rows
        X[-7:] = 0.0
    ref = np.asarray(jt.compute_bin_edges(jnp.asarray(X), jnp.asarray(W), max_bins))
    got = tt.compute_bin_edges(_t(X), _t(W), max_bins).numpy()
    assert got.shape == (X.shape[1], max_bins - 1)
    np.testing.assert_array_equal(got, ref)


def test_weighted_quantiles_bitwise_per_cell_weights():
    """Per-cell 0/1 weights (a column mask), q=0 and q=1 included; a column
    with no live cell returns 0."""
    rng, X = _data(n=2000, d=4, seed=1)
    Wc = (rng.random(X.shape) < 0.7).astype(np.float32)
    Wc[:, 3] = 0.0
    qs = np.array([0.0, 0.1, 0.5, 0.9, 1.0], np.float32)
    ref = np.asarray(jax_quantiles(jnp.asarray(X), jnp.asarray(Wc), jnp.asarray(qs)))
    got = weighted_quantiles(_t(X), _t(Wc), _t(qs)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[:, 3] == 0).all()


def test_bin_features_bitwise_nan_and_edge_values():
    rng, X = _data()
    edges = np.asarray(jt.compute_bin_edges(jnp.asarray(X),
                                            jnp.ones(len(X)), 32))
    X[:40, 0] = edges[0, 5]                           # exactly on an edge
    X[40:71, 1] = edges[1]                            # every edge of column 1
    X[100:120, 2] = np.nan
    X[120, 3] = np.inf
    X[121, 3] = -np.inf
    ref = np.asarray(jt.bin_features(jnp.asarray(X), jnp.asarray(edges)))
    got = tt.bin_features(_t(X), _t(edges)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert (got[100:120, 2] == 0).all()


def test_bin_features_nan_edges_bitwise():
    """A column that is mostly NaN sorts its NaNs last, so its upper edges
    are NaN; the comparison form counts no NaN edge."""
    rng, X = _data(n=500, d=3, seed=2)
    X[rng.random(500) < 0.6, 1] = np.nan
    edges = np.asarray(jt.compute_bin_edges(jnp.asarray(X), jnp.ones(500), 16))
    assert np.isnan(edges[1]).any()
    np.testing.assert_array_equal(
        tt.compute_bin_edges(_t(X), torch.ones(500), 16).numpy(), edges)
    ref = np.asarray(jt.bin_features(jnp.asarray(X), jnp.asarray(edges)))
    got = tt.bin_features(_t(X), _t(edges)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_bins", [4, 16, 17, 32, 100, 256])
def test_bin_cumsum_bitwise_vs_jnp_cumsum(n_bins):
    rng = np.random.default_rng(n_bins)
    H = (rng.standard_normal((3, 2, n_bins, 3)) * 1000).astype(np.float32)
    ref = np.asarray(jnp.cumsum(jnp.asarray(H), axis=2))
    np.testing.assert_array_equal(tt.bin_cumsum(_t(H)).numpy(), ref)


def _stats(mode, rng, X, n_classes=2):
    """Row stats with well-separated gains: a strong signal in features 0
    and 1, continuous for the float modes."""
    n = len(X)
    z = X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.3 * rng.standard_normal(n)
    if mode == "gini":
        y = (z > 0.5).astype(np.int64) + (z > 1.5)
        return np.eye(n_classes + 1, dtype=np.float32)[y]
    if mode == "variance":
        y = z.astype(np.float32)
        return np.stack([y, y * y, np.ones(n, np.float32)], 1)
    p = 1 / (1 + np.exp(-0.3 * X[:, 2]))
    g = (p - (z > 0.5)).astype(np.float32)
    h = np.maximum(p * (1 - p), 1e-6).astype(np.float32)
    return np.stack([g, h, np.ones(n, np.float32)], 1)


@pytest.mark.parametrize("mode", ["gini", "variance", "newton"])
def test_impurity_gain_allclose(mode):
    rng, X = _data(n=2000, d=5, seed=3)
    B = np.asarray(jt.bin_features(jnp.asarray(X), jt.compute_bin_edges(
        jnp.asarray(X), jnp.ones(len(X)), 16)))
    S = _stats(mode, rng, X)
    pos = rng.integers(0, 4, len(X)).astype(np.int32)
    from orange3_spark_tpu.ops.histogram import _hist_xla

    H = np.asarray(_hist_xla(jnp.asarray(B), jnp.asarray(S), jnp.asarray(pos),
                             nodes=4, n_bins=16)).reshape(5, 4, 16, -1)
    Hc = np.cumsum(H, axis=2, dtype=np.float32)
    g_ref, w_ref = jt._impurity_gain(jnp.asarray(Hc), mode, 1.0, 3.0)
    g, w = tt._impurity_gain(_t(Hc), mode, 1.0, 3.0)
    g_ref = np.asarray(g_ref)
    np.testing.assert_array_equal(np.isfinite(g.numpy()), np.isfinite(g_ref))
    fin = np.isfinite(g_ref)
    np.testing.assert_allclose(g.numpy()[fin], g_ref[fin], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-6)


def _grow_both(mode, *, seed, n=3000, d=6, depth=4, n_bins=32, keep=None,
               min_gain=0.0, uint8=False):
    rng, X = _data(n=n, d=d, seed=seed)
    edges = np.asarray(jt.compute_bin_edges(jnp.asarray(X), jnp.ones(n), n_bins))
    B = np.asarray(jt.bin_features(jnp.asarray(X), jnp.asarray(edges)))
    S = _stats(mode, rng, X)
    keep = np.ones((depth, d), np.float32) if keep is None else keep
    kw = dict(depth=depth, n_bins=n_bins, gain_mode=mode)
    ref = jt.grow_tree(jnp.asarray(B), jnp.asarray(S), jnp.asarray(edges),
                       jnp.asarray(keep), jnp.float32(min_gain), **kw)
    Bp = tt.compact_bins(_t(B), n_bins) if uint8 else _t(B)
    got = tt.grow_tree(Bp, _t(S), _t(edges), _t(keep), min_gain, **kw)
    return X, ref, got


def test_grow_tree_gini_integer_stats_bitwise():
    rng = np.random.default_rng(9)
    keep = (rng.random((4, 6)) < 0.7).astype(np.float32)
    keep[:, 0] = 1.0
    _, (tr, pos_r, imp_r), (tg, pos_g, imp_g) = _grow_both(
        "gini", seed=4, keep=keep, min_gain=0.01)
    for f in ("feature", "split_bin", "threshold", "leaf_value"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(tr, f)), err_msg=f)
    np.testing.assert_array_equal(pos_g.numpy(), np.asarray(pos_r))
    np.testing.assert_allclose(imp_g.numpy(), np.asarray(imp_r), rtol=1e-5)
    assert (tg.split_bin.numpy() < 32).sum() >= 7   # it really split


@pytest.mark.parametrize("seed", [4, 11])
def test_grow_tree_gini_feature0_masked_uint8_bitwise(seed):
    """Feature 0 masked out on some levels with a min-gain threshold: the
    node weights still come from feature 0's totals, so do_split matches
    the reference bit for bit; uint8 bins route rows as int32 bins do."""
    rng = np.random.default_rng(seed + 20)
    keep = (rng.random((4, 6)) < 0.7).astype(np.float32)
    keep[[0, 2], 0] = 0.0
    keep[[1, 3], 0] = 1.0
    _, (tr, pos_r, imp_r), (tg, pos_g, imp_g) = _grow_both(
        "gini", seed=seed, keep=keep, min_gain=0.01, uint8=True)
    for f in ("feature", "split_bin", "threshold", "leaf_value"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(tr, f)), err_msg=f)
    np.testing.assert_array_equal(pos_g.numpy(), np.asarray(pos_r))
    np.testing.assert_allclose(imp_g.numpy(), np.asarray(imp_r), rtol=1e-5)
    assert (tg.split_bin.numpy() < 32).sum() >= 7
    # no split on a masked feature at levels 0 and 2
    assert (tg.feature.numpy()[[0, 3, 4, 5, 6]][tg.split_bin.numpy()[[0, 3, 4, 5, 6]] < 32]
            != 0).all()


def test_compact_bins():
    B = torch.tensor([[0, 31], [255, 7]], dtype=torch.int32)
    small = tt.compact_bins(B, 256)
    assert small.dtype == torch.uint8 and torch.equal(small.int(), B)
    assert tt.compact_bins(B, 257) is B


def test_grow_tree_no_mask_equals_all_ones():
    """feat_keep=None (boosting, a single decision tree) grows the tree an
    all-ones mask grows."""
    rng, X = _data(n=1500, d=5, seed=12)
    edges = tt.compute_bin_edges(_t(X), torch.ones(1500), 16)
    B = tt.compact_bins(tt.bin_features(_t(X), edges), 16)
    S = torch.from_numpy(_stats("newton", rng, X))
    kw = dict(depth=3, n_bins=16, gain_mode="newton")
    a = tt.grow_tree(B, S, edges, None, 0.0, **kw)
    b = tt.grow_tree(B, S, edges, torch.ones((3, 5)), 0.0, **kw)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


@pytest.mark.parametrize("mode", ["variance", "newton"])
def test_grow_tree_float_stats_structure(mode):
    _, (tr, _, imp_r), (tg, _, imp_g) = _grow_both(mode, seed=5)
    for f in ("feature", "split_bin", "threshold"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(tr, f)), err_msg=f)
    np.testing.assert_allclose(tg.leaf_value.numpy(), np.asarray(tr.leaf_value),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(imp_g.numpy(), np.asarray(imp_r), rtol=1e-5)


def test_grow_tree_batch_equals_single_trees():
    """The explicit tree axis: T trees grown together equal each tree grown
    alone (one histogram launch per level serves all of them)."""
    rng, X = _data(n=1500, d=5, seed=6)
    edges = tt.compute_bin_edges(_t(X), torch.ones(1500), 16)
    B = tt.bin_features(_t(X), edges)
    S = torch.from_numpy(np.stack([_stats("gini", rng, X) * rng.poisson(
        1.0, (1500, 1)).astype(np.float32) for _ in range(3)]))
    keep = torch.from_numpy((rng.random((3, 3, 5)) < 0.6).astype(np.float32))
    kw = dict(depth=3, n_bins=16, gain_mode="gini")
    forest, pos, imp = tt.grow_tree(B, S, edges, keep, 0.0, **kw)
    for t in range(3):
        tree, p, i = tt.grow_tree(B, S[t], edges, keep[t], 0.0, **kw)
        for a, b in zip(forest, tree):
            assert torch.equal(a[t], b)
        assert torch.equal(pos[t], p) and torch.equal(imp[t], i)


def test_tree_apply_bitwise():
    X, (tr, pos_r, _), (tg, _, _) = _grow_both("gini", seed=7)
    X = X.copy()
    X[:50, :] = np.nan            # NaN goes left at every node, in both
    ref = np.asarray(jt.tree_apply(jnp.asarray(X), tr))
    got = tt.tree_apply(_t(X), tg).numpy()
    np.testing.assert_array_equal(got, ref)
    # a stacked forest applies tree by tree
    forest = tt.Tree(*(torch.stack([x, x]) for x in tg))
    np.testing.assert_array_equal(tt.tree_apply(_t(X), forest).numpy(),
                                  np.stack([ref, ref]))


def test_leaf_values_and_importances_match():
    rng = np.random.default_rng(8)
    leaf = rng.random((2, 8, 3)).astype(np.float32)
    leaf[0, 1] = 0.0
    imp = rng.random((3, 5)).astype(np.float32)
    imp[1] = 0.0
    np.testing.assert_allclose(tt.leaf_class_probs(_t(leaf)).numpy(),
                               np.asarray(jt.leaf_class_probs(jnp.asarray(leaf))),
                               rtol=1e-6)
    np.testing.assert_allclose(tt.leaf_newton_values(_t(leaf), 1.0).numpy(),
                               np.asarray(jt.leaf_newton_values(jnp.asarray(leaf), 1.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(tt.normalize_importances(_t(imp)).numpy(),
                               np.asarray(jt.normalize_importances(jnp.asarray(imp))),
                               rtol=1e-6)
