"""RandomForest — parity with ``pyspark.ml.classification.RandomForestClassifier``
(and RandomForestRegressor).

Port of ``orange3_spark_tpu/models/random_forest.py``. The JAX version vmaps
the tree grower over a tree axis; here the tree axis is explicit, so the T
trees of a forest share one histogram launch per level. Per-tree Poisson
bootstrap weights (the with-replacement resample in expectation) and
per-(tree, level) Bernoulli feature masks (MLlib's featureSubsetStrategy,
applied per level) are the reference's ``jax.random`` draws
(``ops/prng.py``): ``split(PRNGKey(seed), num_trees)``, then per tree
``kb, kf = split(tkey)``, ``poisson(kb, subsample, (N,))`` (all trees in
one ``poisson_knuth`` launch on the card) and ``bernoulli(kf, keep_p,
(depth, d))``. ``grow_forest`` takes those draws as tensors, so tests can
also feed given draws to both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models._tree import (
    Tree,
    bin_features,
    class_one_hot,
    compact_bins,
    compute_bin_edges,
    grow_tree,
    leaf_class_probs,
    leaf_means,
    normalize_importances,
    regression_stats,
    tree_apply,
)
from orange3_spark_tpu_torch.models.base import (
    Estimator,
    Model,
    Params,
    append_columns,
    classification_columns,
    infer_class_values,
    to_host,
)
from orange3_spark_tpu_torch.ops import prng


def _subset_fraction(strategy: str, d: int, is_classification: bool) -> float:
    if strategy == "auto":
        strategy = "sqrt" if is_classification else "onethird"
    return {
        "all": 1.0,
        "sqrt": np.sqrt(d) / d,
        "log2": max(np.log2(max(d, 2)) / d, 1.0 / d),
        "onethird": 1.0 / 3.0,
    }[strategy]


@dataclasses.dataclass(frozen=True)
class RandomForestParams(Params):
    num_trees: int = 20            # MLlib numTrees
    max_depth: int = 5             # MLlib maxDepth
    max_bins: int = 32             # MLlib maxBins
    min_instances_per_node: float = 1.0  # MLlib minInstancesPerNode
    min_info_gain: float = 0.0     # MLlib minInfoGain
    subsampling_rate: float = 1.0  # MLlib subsamplingRate (Poisson lambda)
    feature_subset_strategy: str = "auto"  # MLlib featureSubsetStrategy
    seed: int = 0                  # MLlib seed


def draw_forest(N: int, d: int, *, num_trees: int, depth: int, keep_p: float,
                subsample: float, seed: int, device):
    """Bootstrap weights f32[T, N] ~ Poisson(subsample) and feature masks
    f32[T, depth, d] ~ Bernoulli(keep_p): the reference's draws of
    ``PRNGKey(seed)``, tree t from the t-th key of ``split(key,
    num_trees)``."""
    pairs = [prng.split(t) for t in prng.split(prng.PRNGKey(seed), num_trees)]
    boot = prng.poisson_knuth([kb for kb, _ in pairs], subsample, N, device)
    keep = torch.stack([prng.bernoulli(kf, keep_p, (depth, d), device) for _, kf in pairs])
    return boot.to(torch.float32), keep.to(torch.float32)


def grow_forest(B, edges, Ystats, W, boot, keep, min_gain, *, depth: int,
                n_bins: int, gain_mode: str, min_instances: float):
    """Grow T trees from given draws: ``boot`` f32[T, N] bootstrap weights,
    ``keep`` f32[T, depth, d] feature masks. Returns the stacked Tree and
    the per-tree-normalized importances f32[T, d]."""
    # never mask every feature of a level
    keep = torch.where(keep.sum(-1, keepdim=True) > 0, keep, 1.0)
    S = Ystats[None] * (W[None] * boot)[..., None]             # [T, N, k]
    forest, _, imp = grow_tree(
        B, S, edges, keep, min_gain, depth=depth, n_bins=n_bins,
        gain_mode=gain_mode, min_instances=min_instances,
    )
    # MLlib featureImportances: normalize PER TREE before averaging
    return forest, normalize_importances(imp)


def _fit_forest(table: TorchTable, Ystats, p: RandomForestParams,
                gain_mode: str, is_classification: bool):
    edges = compute_bin_edges(table.X, table.W, p.max_bins)
    B = compact_bins(bin_features(table.X, edges), p.max_bins)
    keep_p = _subset_fraction(p.feature_subset_strategy, table.n_attrs,
                              is_classification)
    boot, keep = draw_forest(
        table.n_pad, table.n_attrs, num_trees=p.num_trees, depth=p.max_depth,
        keep_p=keep_p, subsample=p.subsampling_rate, seed=p.seed,
        device=table.X.device)
    forest, tree_imps = grow_forest(
        B, edges, Ystats, table.W, boot, keep, p.min_info_gain,
        depth=p.max_depth, n_bins=p.max_bins, gain_mode=gain_mode,
        min_instances=p.min_instances_per_node)
    # MLlib: average the per-tree-normalized importances, renormalize
    return forest, normalize_importances(tree_imps.mean(0))


def _forest_probs(X, forest: Tree):
    """Mean of per-tree leaf class distributions (MLlib probability vote)."""
    leaves = tree_apply(X, forest)                                  # [T, N]
    probs = leaf_class_probs(forest.leaf_value)                     # [T, L, k]
    k = probs.shape[-1]
    per_tree = torch.gather(probs, 1, leaves[..., None].expand(-1, -1, k))
    return per_tree.mean(0)


class RandomForestClassifierModel(Model):
    def __init__(self, params, forest: Tree, class_values):
        self.params = params
        self.forest = forest
        self.class_values = tuple(class_values)

    @property
    def state_pytree(self):
        return dict(self.forest._asdict())

    def predict_proba(self, table: TorchTable) -> np.ndarray:
        return to_host(_forest_probs(table.X, self.forest), table.n_rows)

    def predict(self, table: TorchTable) -> np.ndarray:
        pred = torch.argmax(_forest_probs(table.X, self.forest), dim=1)
        return to_host(pred.to(torch.float32), table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        return append_columns(table, *classification_columns(
            _forest_probs(table.X, self.forest), self.class_values))


class RandomForestClassifier(Estimator):
    ParamsCls = RandomForestParams
    params: RandomForestParams

    def _fit(self, table: TorchTable) -> RandomForestClassifierModel:
        class_values = infer_class_values(table)
        Ystats = class_one_hot(table.y, len(class_values))
        forest, imp = _fit_forest(table, Ystats, self.params, "gini", True)
        model = RandomForestClassifierModel(self.params, forest, class_values)
        model.feature_importances_ = imp
        return model


# ---------------------------------------------------------------- regressor
def _forest_means(X, forest: Tree):
    leaves = tree_apply(X, forest)                                  # [T, N]
    per_tree = torch.gather(leaf_means(forest.leaf_value), 1, leaves)
    return per_tree.mean(0)


class RandomForestRegressorModel(Model):
    def __init__(self, params, forest: Tree):
        self.params = params
        self.forest = forest

    @property
    def state_pytree(self):
        return dict(self.forest._asdict())

    def predict(self, table: TorchTable) -> np.ndarray:
        return to_host(_forest_means(table.X, self.forest), table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        return append_columns(table, [_forest_means(table.X, self.forest)[:, None]],
                              [ContinuousVariable("prediction")])


class RandomForestRegressor(Estimator):
    ParamsCls = RandomForestParams
    params: RandomForestParams

    def _fit(self, table: TorchTable) -> RandomForestRegressorModel:
        Ystats = regression_stats(table.y)
        forest, imp = _fit_forest(table, Ystats, self.params, "variance", False)
        model = RandomForestRegressorModel(self.params, forest)
        model.feature_importances_ = imp
        return model
