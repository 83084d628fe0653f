"""Gradient-boosted trees — parity with ``pyspark.ml.classification.GBTClassifier``
and GBTRegressor.

Port of ``orange3_spark_tpu/models/gbt.py``: boosting on gradient/hessian
histograms (second-order gains and leaf values), the binned features reused
by every round and the margin vector F kept on the device across rounds.

The JAX boosting loop calls ``bound_dispatch`` every few rounds to cap
XLA:CPU's queue of in-flight multi-device programs, a workaround for a
rendezvous wedge of that runtime. PyTorch has no such queue to bound, so the
port drops it: the loop enqueues its rounds and reads nothing back to the
host until the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, DiscreteVariable
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models._tree import (
    Tree,
    bin_features,
    compact_bins,
    compute_bin_edges,
    grow_tree,
    leaf_newton_values,
    normalize_importances,
    tree_apply,
)
from orange3_spark_tpu_torch.models.base import (
    Estimator, Model, Params, append_columns, to_host,
)
from orange3_spark_tpu_torch.ops import prng

EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class GBTParams(Params):
    max_iter: int = 20            # MLlib maxIter (number of trees)
    max_depth: int = 5            # MLlib maxDepth
    step_size: float = 0.1        # MLlib stepSize (learning rate)
    max_bins: int = 32            # MLlib maxBins
    min_instances_per_node: float = 1.0
    min_info_gain: float = 0.0
    subsampling_rate: float = 1.0 # MLlib subsamplingRate
    reg_lambda: float = 1.0       # newton leaf regularization (beyond MLlib)
    seed: int = 0


def _gbt_round(F, B, edges, W, y, boot, *, p: GBTParams, loss: str,
               depth: int, n_bins: int):
    """One boosting round: (F + step·tree(F), tree, its importances)."""
    w = W if boot is None else W * boot
    if loss == "logistic":
        prob = torch.sigmoid(F)
        g = (prob - y) * w
        h = torch.clamp_min(prob * (1 - prob), 1e-6) * w
    else:  # squared
        g = (F - y) * w
        h = w
    S = torch.stack([g, h, w], dim=1)
    tree, leaf_idx, imp = grow_tree(
        B, S, edges, None, p.min_info_gain,
        depth=depth, n_bins=n_bins, gain_mode="newton", reg=p.reg_lambda,
        min_instances=p.min_instances_per_node,
    )
    values = leaf_newton_values(tree.leaf_value, p.reg_lambda)  # [L]
    F_new = F + p.step_size * values[leaf_idx.long()]
    # store leaf scalar values in leaf_value[..., :1] for serving
    tree = tree._replace(leaf_value=values[:, None])
    # per-tree-normalized, as MLlib's ensemble featureImportances expects
    return F_new, tree, normalize_importances(imp)


def _boost(B, edges, W, y, depth, n_bins, p: GBTParams, loss: str):
    """Sequential boosting loop. Each round takes the next key of the
    reference's chain (``key, sub = split(key)`` from ``PRNGKey(seed)``)
    and, only when ``subsampling_rate != 1``, draws its bootstrap weights
    ``poisson(sub, rate, (N,))`` from it (``ops/prng.py``: JAX's stream,
    the ``poisson_knuth`` kernel on the card)."""
    N = B.shape[0]
    dev = B.device
    key = prng.PRNGKey(p.seed)
    if loss == "logistic":
        pos_w = torch.where(y > 0, W, 0.0).sum()
        tot_w = torch.clamp_min(W.sum(), EPS)
        prior = torch.clamp(pos_w / tot_w, 1e-6, 1 - 1e-6)
        f0 = torch.log(prior / (1 - prior))
    else:
        f0 = (y * W).sum() / torch.clamp_min(W.sum(), EPS)
    F = f0.expand(N).clone()
    trees, imps = [], []
    for _ in range(p.max_iter):
        key, sub = prng.split(key)
        boot = (None if p.subsampling_rate == 1.0
                else prng.poisson(sub, p.subsampling_rate, N, dev).to(torch.float32))
        F, tree, imp = _gbt_round(F, B, edges, W, y, boot, p=p, loss=loss,
                                  depth=depth, n_bins=n_bins)
        trees.append(tree)
        imps.append(imp)
    forest = Tree(*(torch.stack(xs) for xs in zip(*trees)))
    # MLlib ensemble featureImportances: mean of per-tree-normalized,
    # renormalized
    imp = normalize_importances(torch.stack(imps).mean(0))
    return float(f0), forest, imp


def _gbt_margin(X, f0: float, step_size: float, forest: Tree):
    leaves = tree_apply(X, forest)                                   # [T, N]
    vals = torch.gather(forest.leaf_value[..., 0], 1, leaves)        # [T, N]
    return f0 + step_size * vals.sum(0)


class GBTClassifierModel(Model):
    def __init__(self, params, f0, forest: Tree, class_values):
        self.params = params
        self.f0 = f0
        self.forest = forest
        self.class_values = tuple(class_values)

    @property
    def state_pytree(self):
        return {"f0": self.f0, **self.forest._asdict()}

    def _margin(self, X):
        return _gbt_margin(X, self.f0, self.params.step_size, self.forest)

    def predict_proba(self, table: TorchTable) -> np.ndarray:
        p1 = torch.sigmoid(self._margin(table.X))
        return to_host(torch.stack([1 - p1, p1], 1), table.n_rows)

    def predict(self, table: TorchTable) -> np.ndarray:
        return to_host((self._margin(table.X) > 0).to(torch.float32),
                       table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        p1 = torch.sigmoid(self._margin(table.X))
        pred = (p1 > 0.5).to(torch.float32)
        new_vars = [
            ContinuousVariable(f"probability_{self.class_values[0]}"),
            ContinuousVariable(f"probability_{self.class_values[1]}"),
            DiscreteVariable("prediction", self.class_values),
        ]
        return append_columns(
            table, [(1 - p1)[:, None], p1[:, None], pred[:, None]], new_vars)


class GBTClassifier(Estimator):
    """Binary classifier (MLlib GBTClassifier is binary-only too)."""

    ParamsCls = GBTParams
    params: GBTParams

    def _fit(self, table: TorchTable) -> GBTClassifierModel:
        p = self.params
        cvar = table.domain.class_var
        class_values = (
            cvar.values if isinstance(cvar, DiscreteVariable) and cvar.values
            else ("0", "1")
        )
        if len(class_values) != 2:
            raise ValueError("GBTClassifier is binary (MLlib parity)")
        edges = compute_bin_edges(table.X, table.W, p.max_bins)
        B = compact_bins(bin_features(table.X, edges), p.max_bins)
        f0, forest, imp = _boost(B, edges, table.W, table.y, p.max_depth,
                                 p.max_bins, p, loss="logistic")
        model = GBTClassifierModel(p, f0, forest, class_values)
        model.feature_importances_ = imp   # MLlib featureImportances
        return model


class GBTRegressorModel(Model):
    def __init__(self, params, f0, forest: Tree):
        self.params = params
        self.f0 = f0
        self.forest = forest

    @property
    def state_pytree(self):
        return {"f0": self.f0, **self.forest._asdict()}

    def predict(self, table: TorchTable) -> np.ndarray:
        m = _gbt_margin(table.X, self.f0, self.params.step_size, self.forest)
        return to_host(m, table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        yhat = _gbt_margin(table.X, self.f0, self.params.step_size, self.forest)
        return append_columns(table, [yhat[:, None]],
                              [ContinuousVariable("prediction")])


class GBTRegressor(Estimator):
    ParamsCls = GBTParams
    params: GBTParams

    def _fit(self, table: TorchTable) -> GBTRegressorModel:
        p = self.params
        edges = compute_bin_edges(table.X, table.W, p.max_bins)
        B = compact_bins(bin_features(table.X, edges), p.max_bins)
        f0, forest, imp = _boost(B, edges, table.W, table.y, p.max_depth,
                                 p.max_bins, p, loss="squared")
        model = GBTRegressorModel(p, f0, forest)
        model.feature_importances_ = imp   # MLlib featureImportances
        return model
