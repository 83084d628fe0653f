"""Tree estimators of the port (DecisionTree, GBT, RandomForest) against the
JAX package's, fit on the same numpy tables, and the carry of fitted JAX
models into the port (orange3_spark_tpu_torch/interop.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core import domain as jdom
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.core.table import TpuTable
from orange3_spark_tpu.models import _tree as jt
from orange3_spark_tpu.models.decision_tree import (
    DecisionTreeClassifier as JDTC, DecisionTreeRegressor as JDTR,
)
from orange3_spark_tpu.models.gbt import GBTClassifier as JGBTC, GBTRegressor as JGBTR
from orange3_spark_tpu.models.random_forest import (
    RandomForestClassifier as JRFC, RandomForestRegressor as JRFR,
)
from orange3_spark_tpu_torch import interop
from orange3_spark_tpu_torch.core import domain as tdom
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.datasets import auc, make_higgs_proxy
from orange3_spark_tpu_torch.models import _tree as tt
from orange3_spark_tpu_torch.models.decision_tree import (
    DecisionTreeClassifier, DecisionTreeRegressor,
)
from orange3_spark_tpu_torch.models.gbt import GBTClassifier, GBTRegressor
from orange3_spark_tpu_torch.models.random_forest import (
    RandomForestClassifier, RandomForestRegressor, _subset_fraction, grow_forest,
)
from orange3_spark_tpu_torch.ops.histogram import node_histograms

TREE_FIELDS = ("feature", "split_bin", "threshold")


@pytest.fixture(scope="module")
def jsess():
    """The reference on ONE device: its sums then run in the same order as
    the port's CPU path (an 8-device mesh adds partial sums per shard)."""
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession("cpu")


def _tables(jsess, tsess, X, y, class_values=None, W=None):
    def dom(m):
        cvar = (m.DiscreteVariable("y", class_values) if class_values
                else m.ContinuousVariable("y"))
        return m.Domain([m.ContinuousVariable(f"x{i}")
                         for i in range(X.shape[1])], cvar)

    return (TpuTable.from_numpy(dom(jdom), X, y, W=W, session=jsess),
            TorchTable.from_numpy(dom(tdom), X, y, W=W, session=tsess))


def _higgs(jsess, tsess, n, seed=0):
    X, y = make_higgs_proxy(n, seed)
    return (X, y) + _tables(jsess, tsess, X, y, ("0", "1"))


def _split_gaps(B, S, ref_tree, n_bins, gain_mode):
    """Top-two gain gap at every node of the reference tree, from the
    reference's own routing: (level, node, gain1, gain2) per node."""
    N, d = B.shape
    pos = torch.zeros(N, dtype=torch.int32)
    feat = torch.from_numpy(np.array(ref_tree.feature)).long()
    sbin = torch.from_numpy(np.array(ref_tree.split_bin))
    out = []
    for level in range(ref_tree.depth):
        nodes = 2 ** level
        H = node_histograms(B, S, pos, nodes=nodes, n_bins=n_bins)
        gains, _ = tt._impurity_gain(
            tt.bin_cumsum(H.view(d, nodes, n_bins, -1)), gain_mode, 1.0, 1.0)
        top = gains.permute(1, 0, 2).reshape(nodes, -1).topk(2, dim=1).values
        out += [(level, k, float(top[k, 0]), float(top[k, 1]))
                for k in range(nodes)]
        off = nodes - 1
        xb = B[torch.arange(N), feat[off:off + nodes][pos.long()]]
        pos = 2 * pos + (xb > sbin[off:off + nodes][pos.long()]).int()
    return out


def _assert_same_structure(ref, got, explain=None):
    for f in TREE_FIELDS:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f).numpy()
        if not np.array_equal(a, b):
            where = np.argwhere(a != b)[:5].tolist()
            raise AssertionError(f"{f} differs at {where}"
                                 + (f"; {explain(where)}" if explain else ""))


# ------------------------------------------------------------------- tables
def test_table_round_trip_and_filter(jsess, tsess):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((301, 4)).astype(np.float32)
    y = rng.integers(0, 3, 301).astype(np.float32)
    W = rng.random(301).astype(np.float32)
    jtab, ttab = _tables(jsess, tsess, X, y, ("a", "b", "c"), W=W)
    for a, b in zip(jtab.to_numpy(), ttab.to_numpy()):
        np.testing.assert_array_equal(b, a)
    assert (ttab.n_rows, ttab.n_attrs) == (301, 4)
    assert ttab.X.device.type == "cpu" and ttab.session is tsess
    mask = X[:, 0] > 0
    jf = jtab.filter(jnp.asarray(np.pad(mask, (0, jtab.n_pad - 301))))
    tf = ttab.filter(lambda t: t.X[:, 0] > 0)
    assert tf.count() == jf.count() == int(mask.sum())
    np.testing.assert_array_equal(tf.to_numpy()[2], jf.to_numpy()[2])
    np.testing.assert_array_equal(tf.y.numpy(), y)
    assert tf.with_weights(ttab.W).count() == 301


# -------------------------------------------------------------- decision tree
@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_decision_tree_same_structure(jsess, tsess, kind):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((2048, 6)).astype(np.float32)
    if kind == "classifier":
        y = ((X[:, 0] * X[:, 1] > 0) ^ (X[:, 2] > 0.5)).astype(np.float32)
        jtab, ttab = _tables(jsess, tsess, X, y, ("0", "1"))
        jm, tm = JDTC(max_depth=5).fit(jtab), DecisionTreeClassifier(max_depth=5).fit(ttab)
        np.testing.assert_allclose(tm.predict_proba(ttab), jm.predict_proba(jtab),
                                   atol=1e-6)
    else:
        y = (np.sin(X[:, 0]) + X[:, 1] ** 2).astype(np.float32)
        jtab, ttab = _tables(jsess, tsess, X, y)
        jm, tm = JDTR(max_depth=5).fit(jtab), DecisionTreeRegressor(max_depth=5).fit(ttab)
    _assert_same_structure(jm.tree, tm.tree)
    np.testing.assert_allclose(tm.tree.leaf_value.numpy(),
                               np.asarray(jm.tree.leaf_value), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.predict(ttab), jm.predict(jtab), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.feature_importances_.numpy(),
                               np.asarray(jm.feature_importances_), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------------ GBT
def test_gbt_classifier_matches_reference_on_higgs_proxy(jsess, tsess):
    """A default GBTClassifier (no subsampling, so no random draws) on the
    HIGGS-proxy generator: the same trees, f0 and probabilities."""
    X, y, jtab, ttab = _higgs(jsess, tsess, 4096)
    jm = JGBTC(max_iter=5).fit(jtab)
    est = GBTClassifier(max_iter=5)
    tm = est.fit(ttab)
    np.testing.assert_allclose(tm.f0, jm.f0, rtol=1e-6)

    def explain(where):
        # re-grow the first differing round on the port's stats and report
        # the reference tree's top-two gain gap at each differing node
        r = where[0][0]
        F = torch.full((4096,), tm.f0)
        for k in range(r):
            leaves = tt.tree_apply(ttab.X, tt.Tree(*(x[k] for x in tm.forest)))
            F = F + 0.1 * tm.forest.leaf_value[k, :, 0][leaves]
        p = torch.sigmoid(F)
        yt = torch.from_numpy(y)
        S = torch.stack([p - yt, torch.clamp_min(p * (1 - p), 1e-6),
                         torch.ones(4096)], 1)
        edges = tt.compute_bin_edges(ttab.X, ttab.W, 32)
        ref_tree = jt.Tree(*(np.asarray(x)[r] for x in jm.forest))
        gaps = _split_gaps(tt.bin_features(ttab.X, edges), S, ref_tree, 32, "newton")
        nodes = {w[1] for w in where if w[0] == r}
        return "round %d top-two gains: %s" % (r, [
            g for i, g in enumerate(gaps) if i in nodes])

    _assert_same_structure(jm.forest, tm.forest, explain)
    np.testing.assert_allclose(tm.forest.leaf_value.numpy(),
                               np.asarray(jm.forest.leaf_value), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.predict_proba(ttab), jm.predict_proba(jtab), atol=1e-5)
    np.testing.assert_array_equal(tm.predict(ttab), jm.predict(jtab))
    np.testing.assert_allclose(tm.feature_importances_.numpy(),
                               np.asarray(jm.feature_importances_), rtol=1e-4, atol=1e-6)
    assert est.last_fit_metrics["fit_seconds"] > 0


def test_gbt_regressor_matches_reference(jsess, tsess):
    rng = np.random.default_rng(7)
    X = rng.standard_normal((2048, 4)).astype(np.float32)
    y = (X[:, 0] ** 2 + np.abs(X[:, 1])).astype(np.float32)
    jtab, ttab = _tables(jsess, tsess, X, y)
    jm = JGBTR(max_iter=4, max_depth=4, step_size=0.3).fit(jtab)
    tm = GBTRegressor(max_iter=4, max_depth=4, step_size=0.3).fit(ttab)
    np.testing.assert_allclose(tm.f0, jm.f0, rtol=1e-6)
    _assert_same_structure(jm.forest, tm.forest)
    np.testing.assert_allclose(tm.predict(ttab), jm.predict(jtab), rtol=1e-5, atol=1e-5)


def test_gbt_subsampling_draws_on_the_generator(tsess):
    """With subsampling_rate != 1 each round draws Poisson weights from JAX's
    threefry stream of the seed (``ops/prng.poisson``, a key a round): the
    same seed gives the same forest."""
    X, y = make_higgs_proxy(1024, seed=3)
    ttab = TorchTable.from_arrays(X, y, class_values=("0", "1"), session=tsess)
    a = GBTClassifier(max_iter=3, subsampling_rate=0.5, seed=4).fit(ttab)
    b = GBTClassifier(max_iter=3, subsampling_rate=0.5, seed=4).fit(ttab)
    c = GBTClassifier(max_iter=3).fit(ttab)
    for x, z in zip(a.forest, b.forest):
        assert torch.equal(x, z)
    assert not torch.equal(a.forest.leaf_value, c.forest.leaf_value)


def test_gbt_seeded_subsampling_matches_reference(jsess, tsess):
    """subsampling_rate=0.8 with no injected draws: each round's Poisson
    weights are the reference's (``key, sub = split(key)``, then
    ``poisson(sub, 0.8, (N,))``), so the trees, f0 and probabilities agree
    to the tolerances of the unsampled test above, on its data. (On
    ``make_higgs_proxy(4096, seed=4)`` round 1 meets exact gain ties,
    top-two gap 0.0 at four level-4 nodes, where either package's pick is
    float32 chance; the draws there are equal all the same.)"""
    X, y, jtab, ttab = _higgs(jsess, tsess, 4096)
    jm = JGBTC(max_iter=4, subsampling_rate=0.8, seed=3).fit(jtab)
    tm = GBTClassifier(max_iter=4, subsampling_rate=0.8, seed=3).fit(ttab)
    np.testing.assert_allclose(tm.f0, jm.f0, rtol=1e-6)
    _assert_same_structure(jm.forest, tm.forest)
    np.testing.assert_allclose(tm.forest.leaf_value.numpy(),
                               np.asarray(jm.forest.leaf_value), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.predict_proba(ttab), jm.predict_proba(jtab), atol=1e-5)
    np.testing.assert_array_equal(tm.predict(ttab), jm.predict(jtab))


def test_gbt_transform_appends_probabilities(tsess):
    X, y = make_higgs_proxy(512, seed=5)
    ttab = TorchTable.from_arrays(X, y, class_values=("neg", "pos"), session=tsess)
    m = GBTClassifier(max_iter=2, max_depth=3).fit(ttab)
    out = m.transform(ttab)
    names = [v.name for v in out.domain.attributes]
    assert names[-3:] == ["probability_neg", "probability_pos", "prediction"]
    np.testing.assert_allclose(out.X[:, -3:-1].numpy(), m.predict_proba(ttab), atol=1e-7)
    np.testing.assert_array_equal(out.X[:, -1].numpy(), m.predict(ttab))


# ------------------------------------------------------------- random forest
def test_forest_from_given_draws_equals_reference_tree_by_tree(jsess, tsess):
    """Numpy-made bootstrap weights and feature masks, fed to the port's
    draws-as-input entry and to the reference's grow_tree one tree at a
    time, give the same trees (gini on integer counts: bitwise)."""
    rng = np.random.default_rng(11)
    X, y = make_higgs_proxy(3000, seed=2)
    T, depth, d, n_bins = 5, 5, 28, 32
    boot = rng.poisson(1.0, (T, 3000)).astype(np.float32)
    keep = (rng.random((T, depth, d)) < _subset_fraction("auto", d, True)
            ).astype(np.float32)
    keep[0, 2] = 0.0                                  # an all-masked level
    W = np.ones(3000, np.float32)
    edges = np.array(jt.compute_bin_edges(jnp.asarray(X), jnp.asarray(W), n_bins))
    B = np.array(jt.bin_features(jnp.asarray(X), jnp.asarray(edges)))
    Ystats = np.eye(2, dtype=np.float32)[y.astype(int)]
    forest, imps = grow_forest(
        torch.from_numpy(B), torch.from_numpy(edges), torch.from_numpy(Ystats),
        torch.from_numpy(W), torch.from_numpy(boot), torch.from_numpy(keep), 0.0,
        depth=depth, n_bins=n_bins, gain_mode="gini", min_instances=1.0)
    for t in range(T):
        k = np.where(keep[t].sum(1, keepdims=True) > 0, keep[t], 1.0)
        ref, _, imp = jt.grow_tree(
            jnp.asarray(B), jnp.asarray(Ystats * (W * boot[t])[:, None]),
            jnp.asarray(edges), jnp.asarray(k), jnp.float32(0.0),
            depth=depth, n_bins=n_bins, gain_mode="gini")
        for f in ("feature", "split_bin", "threshold", "leaf_value"):
            np.testing.assert_array_equal(getattr(forest, f)[t].numpy(),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f"tree {t} {f}")
        np.testing.assert_allclose(
            imps[t].numpy(), np.asarray(jt.normalize_importances(imp)), rtol=1e-5)


@pytest.mark.parametrize("strategy,subsample", [("auto", 1.0), ("onethird", 0.7)])
def test_seeded_forest_equals_reference_field_by_field(jsess, tsess, strategy, subsample):
    """A seeded RandomForestClassifier with no injected draws: the port's
    ``draw_forest`` gives the reference's Poisson bootstrap and Bernoulli
    masks (``split(PRNGKey(seed), T)``, per tree ``kb, kf = split(tkey)``),
    so every tree equals the reference's field by field (gini on integer
    counts: bitwise), and the importances within 1e-5."""
    X, y, jtab, ttab = _higgs(jsess, tsess, 3000, seed=2)
    kw = dict(num_trees=4, max_depth=5, seed=9, feature_subset_strategy=strategy,
              subsampling_rate=subsample)
    jm, tm = JRFC(**kw).fit(jtab), RandomForestClassifier(**kw).fit(ttab)
    for f in ("feature", "split_bin", "threshold", "leaf_value"):
        np.testing.assert_array_equal(getattr(tm.forest, f).numpy(),
                                      np.asarray(getattr(jm.forest, f)), err_msg=f)
    np.testing.assert_allclose(tm.feature_importances_.numpy(),
                               np.asarray(jm.feature_importances_), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.predict_proba(ttab), jm.predict_proba(jtab), atol=1e-6)


def test_random_forest_holdout_auc_close_to_reference(jsess, tsess):
    """The port draws the reference's bootstrap (``ops/prng``: JAX's threefry
    stream), so the forests are the reference's and so is their holdout
    quality. Without feature subsetting the AUC of one seeded fit spreads by
    about 0.01 across seeds at this size (per-level feature masks spread it
    by 0.05), so the means of three seeded fits are compared."""
    X, y = make_higgs_proxy(2 * 16384, seed=1)
    tr, ho = slice(0, 16384), slice(16384, None)
    jtab, ttab = _tables(jsess, tsess, X[tr], y[tr], ("0", "1"))
    jho, tho = _tables(jsess, tsess, X[ho], y[ho], ("0", "1"))
    kw = dict(num_trees=20, max_depth=5, feature_subset_strategy="all")
    a_ref = np.mean([auc(JRFC(seed=s, **kw).fit(jtab).predict_proba(jho)[:, 1], y[ho])
                     for s in range(3)])
    a_port = np.mean([auc(RandomForestClassifier(seed=s, **kw).fit(ttab)
                          .predict_proba(tho)[:, 1], y[ho]) for s in range(3)])
    assert abs(a_port - a_ref) < 0.02, (a_port, a_ref)


def test_random_forest_seeded_fit_is_deterministic(tsess):
    X, y = make_higgs_proxy(3000, seed=6)
    ttab = TorchTable.from_arrays(X, y, class_values=("0", "1"), session=tsess)
    est = RandomForestClassifier(num_trees=20, max_depth=5, seed=0)
    a, b = est.fit(ttab), est.fit(ttab)
    for x, z in zip(a.forest, b.forest):
        assert torch.equal(x, z)
    assert auc(a.predict_proba(ttab)[:, 1], y) > 0.75
    probs = a.predict_proba(ttab)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-6)
    out = a.transform(ttab)
    np.testing.assert_allclose(out.X[:, -3:-1].numpy(), probs, atol=1e-7)
    np.testing.assert_array_equal(out.X[:, -1].numpy(), a.predict(ttab))


def test_random_forest_regressor_fits(tsess):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((1500, 5)).astype(np.float32)
    y = (np.sin(X[:, 0]) + X[:, 1] ** 2).astype(np.float32)
    ttab = TorchTable.from_arrays(X, y, session=tsess)
    m = RandomForestRegressor(num_trees=20, max_depth=7, seed=0).fit(ttab)
    pred = m.predict(ttab)
    r2 = 1 - np.sum((pred - y) ** 2) / np.sum((y - y.mean()) ** 2)
    assert r2 > 0.8, r2


# --------------------------------------------------------------- weight carry
def _state(model):
    return {k: np.asarray(v) for k, v in model.state_pytree.items()}


@pytest.mark.parametrize("kind", ["dt", "gbt", "rf"])
def test_weight_carry_classifiers(jsess, tsess, kind):
    X, y, jtab, ttab = _higgs(jsess, tsess, 2048, seed=4)
    est, carry = {
        "dt": (JDTC(max_depth=4), interop.decision_tree_classifier),
        "gbt": (JGBTC(max_iter=3, max_depth=4), interop.gbt_classifier),
        "rf": (JRFC(num_trees=6, max_depth=4, seed=3), interop.random_forest_classifier),
    }[kind]
    jm = est.fit(jtab)
    tm = carry(_state(jm), jm.params.to_dict(), jm.class_values, device="cpu")
    np.testing.assert_array_equal(tm.predict(ttab), jm.predict(jtab))
    np.testing.assert_allclose(tm.predict_proba(ttab), jm.predict_proba(jtab),
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["dt", "gbt", "rf"])
def test_weight_carry_regressors(jsess, tsess, kind):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((1024, 4)).astype(np.float32)
    y = (X[:, 0] ** 2 + np.abs(X[:, 1])).astype(np.float32)
    jtab, ttab = _tables(jsess, tsess, X, y)
    est, carry = {
        "dt": (JDTR(max_depth=4), interop.decision_tree_regressor),
        "gbt": (JGBTR(max_iter=3, max_depth=3), interop.gbt_regressor),
        "rf": (JRFR(num_trees=4, max_depth=4, seed=1), interop.random_forest_regressor),
    }[kind]
    jm = est.fit(jtab)
    tm = carry(_state(jm), jm.params.to_dict(), device="cpu")
    np.testing.assert_allclose(tm.predict(ttab), jm.predict(jtab), rtol=1e-6, atol=1e-6)
