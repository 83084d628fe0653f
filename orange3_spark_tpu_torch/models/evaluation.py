"""Evaluators of the PyTorch package (``pyspark.ml.evaluation``): the
in-memory ones, computed as weighted device reductions over the columns a
model's transform() appended.

BinaryClassificationEvaluator (areaUnderROC/PR), MulticlassClassification-
Evaluator (accuracy/f1/weightedPrecision/weightedRecall from one weighted
confusion matrix), RegressionEvaluator (rmse/mse/mae/r2) and
ClusteringEvaluator (the centroid silhouette). Zero-weight (padding and
filtered) rows count for nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Params
from orange3_spark_tpu_torch.ops.stats import EPS_TOTAL_WEIGHT


@dataclasses.dataclass(frozen=True)
class EvaluatorParams(Params):
    metric_name: str = ""
    prediction_col: str = "prediction"
    label_col: str = ""          # default: the table's class var
    probability_col: str = ""    # binary: score column (default probability_<pos>)


class _Evaluator:
    ParamsCls = EvaluatorParams
    default_metric = ""

    def __init__(self, params: EvaluatorParams | None = None, **kwargs):
        self.params = params or EvaluatorParams(**kwargs)

    def _label(self, table: TorchTable) -> torch.Tensor:
        p = self.params
        return table.column(p.label_col) if p.label_col else table.y

    def evaluate(self, table: TorchTable) -> float:
        metric = self.params.metric_name or self.default_metric
        return float(self._compute(table, metric))

    def _compute(self, table: TorchTable, metric: str):
        raise NotImplementedError


def _group_ids(starts: torch.Tensor) -> torch.Tensor:
    """Dense ids of runs in sorted order: ``starts`` [N-1] marks the
    elements (after the first) that open a new run."""
    return torch.cat([torch.zeros((1,), dtype=torch.int64, device=starts.device),
                      torch.cumsum(starts.to(torch.int64), dim=0)])


def _weighted_auc(score: torch.Tensor, label: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted ROC AUC by the rank statistic after one stable sort.

    Tied scores get the exact weighted midrank of their tie group (the
    cumulative weight at the group's end less half the group's weight), so
    the result does not depend on the order among ties: all-equal scores
    give exactly 0.5."""
    n = score.shape[0]
    s, order = torch.sort(score, stable=True)
    y, ww = label[order], w[order]
    cw = torch.cumsum(ww, dim=0)
    gid = _group_ids(s[1:] > s[:-1])
    group_w = torch.zeros((n,), dtype=ww.dtype, device=ww.device).index_add_(0, gid, ww)
    group_end_cw = torch.zeros_like(cw).scatter_reduce_(0, gid, cw, "amax",
                                                        include_self=False)
    rank = (group_end_cw - group_w / 2.0)[gid]
    pos = y > 0
    pos_w = torch.where(pos, ww, 0.0).sum()
    neg_w = torch.where(pos, 0.0, ww).sum()
    sum_pos_ranks = torch.where(pos, rank * ww, 0.0).sum()
    auc = ((sum_pos_ranks / torch.clamp_min(pos_w, EPS_TOTAL_WEIGHT) - pos_w / 2.0)
           / torch.clamp_min(neg_w, EPS_TOTAL_WEIGHT))
    return torch.clamp(auc, 0.0, 1.0)


def _weighted_auc_pr(score: torch.Tensor, label: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Weighted area under the precision-recall curve: steps at descending
    score thresholds, tied scores one curve point (the tie group's end),
    sklearn's average_precision on distinct scores."""
    n = score.shape[0]
    neg_s, order = torch.sort(-score, stable=True)
    s = -neg_s
    y, ww = label[order], w[order]
    pos = y > 0
    tp = torch.cumsum(torch.where(pos, ww, 0.0), dim=0)
    fp = torch.cumsum(torch.where(pos, 0.0, ww), dim=0)
    pos_w = torch.clamp_min(tp[-1], EPS_TOTAL_WEIGHT)
    precision = tp / torch.clamp_min(tp + fp, EPS_TOTAL_WEIGHT)
    recall = tp / pos_w
    ends = s[1:] < s[:-1]
    gid = _group_ids(ends)
    is_end = torch.cat([ends, torch.ones((1,), dtype=torch.bool, device=s.device)])
    # each group holds one end element: its sum is that element's value
    zeros = torch.zeros((n,), dtype=recall.dtype, device=recall.device)
    g_recall = zeros.clone().index_add_(0, gid, torch.where(is_end, recall, 0.0))
    g_prec = zeros.index_add_(0, gid, torch.where(is_end, precision, 0.0))
    prev_recall = torch.cat([g_recall.new_zeros((1,)), g_recall[:-1]])
    # empty trailing group slots have g_prec == g_recall == 0: a zero step
    steps = torch.clamp_min(g_recall - prev_recall, 0.0) * g_prec
    return torch.clamp(steps.sum(), 0.0, 1.0)


class BinaryClassificationEvaluator(_Evaluator):
    default_metric = "areaUnderROC"

    def _compute(self, table: TorchTable, metric: str):
        p = self.params
        label = self._label(table)
        names = [v.name for v in table.domain.attributes]
        if p.probability_col:
            score = table.column(p.probability_col)
        elif "probability_1" in names:
            score = table.column("probability_1")
        elif any(n.startswith("probability_") for n in names):
            score = table.column([n for n in names if n.startswith("probability_")][-1])
        elif "rawPrediction" in names:
            score = table.column("rawPrediction")
        else:
            raise ValueError("no probability/rawPrediction column; transform first")
        if metric == "areaUnderROC":
            return _weighted_auc(score, label, table.W)
        if metric == "areaUnderPR":
            return _weighted_auc_pr(score, label, table.W)
        raise ValueError(f"unknown metric {metric!r}")


def _confusion_weighted(pred, label, w, n_classes: int) -> torch.Tensor:
    """[true, pred] weighted counts: one-hot(label)ᵀ @ (one-hot(pred)·w)."""
    eye = torch.eye(n_classes, dtype=torch.float32, device=w.device)
    return eye[label.to(torch.int64)].T @ (eye[pred.to(torch.int64)] * w[:, None])


class MulticlassClassificationEvaluator(_Evaluator):
    default_metric = "accuracy"

    def confusion(self, table: TorchTable) -> np.ndarray:
        """The weighted [true, pred] confusion matrix, one device pass:
        callers needing several metrics (model.summary) derive them all
        from it."""
        pred = table.column(self.params.prediction_col)
        label = self._label(table)
        n_classes = int(torch.maximum(pred.max(), label.max()).item()) + 1
        return _confusion_weighted(pred, label, table.W, n_classes).cpu().numpy()

    @staticmethod
    def from_confusion(C: np.ndarray, metric: str) -> float:
        tp = np.diag(C)
        tot = max(C.sum(), 1e-12)
        if metric == "accuracy":
            return float(tp.sum() / tot)
        prec = tp / np.maximum(C.sum(axis=0), 1e-12)
        rec = tp / np.maximum(C.sum(axis=1), 1e-12)
        support = C.sum(axis=1) / tot
        if metric == "weightedPrecision":
            return float(np.sum(prec * support))
        if metric == "weightedRecall":
            return float(np.sum(rec * support))
        if metric == "f1":
            f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
            return float(np.sum(f1 * support))
        raise ValueError(f"unknown metric {metric!r}")

    def _compute(self, table: TorchTable, metric: str):
        return self.from_confusion(self.confusion(table), metric)


class RegressionEvaluator(_Evaluator):
    default_metric = "rmse"

    def _compute(self, table: TorchTable, metric: str):
        pred = table.column(self.params.prediction_col)
        label = self._label(table)
        w = table.W
        tot = torch.clamp_min(w.sum(), EPS_TOTAL_WEIGHT)
        err = pred - label
        if metric in ("rmse", "mse"):
            mse = (err * err * w).sum() / tot
            return torch.sqrt(mse) if metric == "rmse" else mse
        if metric == "mae":
            return (torch.abs(err) * w).sum() / tot
        if metric == "r2":
            mean_y = (label * w).sum() / tot
            ss_res = (err * err * w).sum()
            ss_tot = torch.clamp_min(((label - mean_y) ** 2 * w).sum(), EPS_TOTAL_WEIGHT)
            return 1.0 - ss_res / ss_tot
        raise ValueError(f"unknown metric {metric!r}")


class ClusteringEvaluator(_Evaluator):
    """Silhouette, Spark's simplified squared-Euclidean form: distances to
    the cluster centroids instead of all pairs, O(N·k) on the device."""

    default_metric = "silhouette"

    def _compute(self, table: TorchTable, metric: str):
        if metric != "silhouette":
            raise ValueError(f"unknown metric {metric!r}")
        col = (self.params.prediction_col if self.params.prediction_col != "prediction"
               else "cluster")
        pred = table.column(col)
        feat_idx = [i for i, v in enumerate(table.domain.attributes)
                    if v.name not in ("cluster", "prediction")]
        X = table.X.index_select(1, torch.tensor(feat_idx, dtype=torch.int64,
                                                 device=table.X.device))
        k = int(pred.max()) + 1
        return float(_silhouette_centroid(X, pred, table.W, k))


def _silhouette_centroid(X, pred, w, k: int):
    ids = pred.to(torch.int64)
    member = ids[:, None] == torch.arange(k, device=X.device)
    onehot = member.to(torch.float32) * w[:, None]
    counts = torch.clamp_min(onehot.sum(dim=0), EPS_TOTAL_WEIGHT)
    centroids = (onehot.T @ X) / counts[:, None]
    d2 = ((X * X).sum(dim=1, keepdim=True) - 2.0 * X @ centroids.T
          + (centroids * centroids).sum(dim=1))              # [N, k]
    own = torch.gather(d2, 1, ids[:, None])[:, 0]
    other = torch.where(member, torch.inf, d2).amin(dim=1)
    s = (other - own) / torch.clamp_min(torch.maximum(own, other), EPS_TOTAL_WEIGHT)
    tot = torch.clamp_min(w.sum(), EPS_TOTAL_WEIGHT)
    return (s * w).sum() / tot
