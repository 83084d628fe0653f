"""DecisionTree — parity with ``pyspark.ml.classification.DecisionTreeClassifier``
and ``pyspark.ml.regression.DecisionTreeRegressor``.

Port of ``orange3_spark_tpu/models/decision_tree.py``: one ``grow_tree`` call
with the table's weights and a full feature mask.
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


@dataclasses.dataclass(frozen=True)
class DecisionTreeParams(Params):
    max_depth: int = 5                   # MLlib maxDepth
    max_bins: int = 32                   # MLlib maxBins
    min_instances_per_node: float = 1.0  # MLlib minInstancesPerNode
    min_info_gain: float = 0.0           # MLlib minInfoGain
    impurity: str = "auto"               # 'gini' (clf) / 'variance' (reg)
    seed: int = 0


def _grow_single(table: TorchTable, Ystats, p: DecisionTreeParams, gain_mode: str):
    edges = compute_bin_edges(table.X, table.W, p.max_bins)
    B = compact_bins(bin_features(table.X, edges), p.max_bins)
    tree, _, imp = grow_tree(
        B, Ystats * table.W[:, None], edges, None, p.min_info_gain,
        depth=p.max_depth, n_bins=p.max_bins, gain_mode=gain_mode,
        min_instances=p.min_instances_per_node,
    )
    return tree, normalize_importances(imp)


class DecisionTreeClassifierModel(Model):
    def __init__(self, params, tree: Tree, class_values):
        self.params = params
        self.tree = tree
        self.class_values = tuple(class_values)

    @property
    def state_pytree(self):
        return dict(self.tree._asdict())

    def load_state_pytree(self, state):
        self.tree = Tree(**{k: state[k] for k in Tree._fields})
        self._touch_serving_state()

    def _probs(self, X):
        leaves = tree_apply(X, self.tree)                    # [N]
        return leaf_class_probs(self.tree.leaf_value)[leaves]

    def predict_proba(self, table: TorchTable) -> np.ndarray:
        return to_host(self._probs(table.X), table.n_rows)

    def predict(self, table: TorchTable) -> np.ndarray:
        pred = torch.argmax(self._probs(table.X), dim=1).to(torch.float32)
        return to_host(pred, table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        return append_columns(table, *classification_columns(
            self._probs(table.X), self.class_values))


class DecisionTreeClassifier(Estimator):
    ParamsCls = DecisionTreeParams
    params: DecisionTreeParams

    def _fit(self, table: TorchTable) -> DecisionTreeClassifierModel:
        p = self.params
        if p.impurity not in ("auto", "gini"):
            raise ValueError(f"classifier impurity must be 'gini', got {p.impurity!r}")
        class_values = infer_class_values(table)
        Ystats = class_one_hot(table.y, len(class_values))
        tree, imp = _grow_single(table, Ystats, p, "gini")
        model = DecisionTreeClassifierModel(p, tree, class_values)
        model.feature_importances_ = imp   # MLlib featureImportances
        return model


class DecisionTreeRegressorModel(Model):
    def __init__(self, params, tree: Tree):
        self.params = params
        self.tree = tree

    @property
    def state_pytree(self):
        return dict(self.tree._asdict())

    def load_state_pytree(self, state):
        self.tree = Tree(**{k: state[k] for k in Tree._fields})
        self._touch_serving_state()

    def _yhat(self, X):
        return leaf_means(self.tree.leaf_value)[tree_apply(X, self.tree)]

    def predict(self, table: TorchTable) -> np.ndarray:
        return to_host(self._yhat(table.X), table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        return append_columns(table, [self._yhat(table.X)[:, None]],
                             [ContinuousVariable("prediction")])


class DecisionTreeRegressor(Estimator):
    ParamsCls = DecisionTreeParams
    params: DecisionTreeParams

    def _fit(self, table: TorchTable) -> DecisionTreeRegressorModel:
        p = self.params
        if p.impurity not in ("auto", "variance"):
            raise ValueError(
                f"regressor impurity must be 'variance', got {p.impurity!r}"
            )
        tree, imp = _grow_single(table, regression_stats(table.y), p, "variance")
        model = DecisionTreeRegressorModel(p, tree)
        model.feature_importances_ = imp   # MLlib featureImportances
        return model
