"""Evaluators of the PyTorch package (``pyspark.ml.evaluation``): the
in-memory ones, computed as weighted device reductions over the columns a
model's transform() appended.

BinaryClassificationEvaluator (areaUnderROC/PR), MulticlassClassification-
Evaluator (accuracy/f1/weightedPrecision/weightedRecall from one weighted
confusion matrix), RegressionEvaluator (rmse/mse/mae/r2) and
ClusteringEvaluator (the centroid silhouette). Zero-weight (padding and
filtered) rows count for nothing. The set-valued RankingEvaluator and
MultilabelClassificationEvaluator score padded id matrices (ALS's
recommendations) instead of a table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.fmath import sqrt32
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
    """[true, pred] weighted counts: one-hot(label)ᵀ @ (one-hot(pred)·w). A
    row whose (truncated) class id lies outside [0, n_classes) counts for
    nothing, as the reference's one-hot makes it (its one-hot row is zero),
    instead of indexing out of range."""
    eye = torch.cat([torch.eye(n_classes, dtype=torch.float32, device=w.device),
                     torch.zeros((1, n_classes), dtype=torch.float32, device=w.device)])

    def ids(x):
        i = x.to(torch.int64)
        return torch.where((i < 0) | (i >= n_classes), n_classes, i)

    return eye[ids(label)].T @ (eye[ids(pred)] * w[:, None])


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
            return sqrt32(mse) if metric == "rmse" else mse
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


# --------------------------------------------------------------------------
# Set-valued evaluators (pyspark.ml.evaluation RankingEvaluator /
# MultilabelClassificationEvaluator, Spark 3.0). Spark evaluates DataFrames
# with ARRAY columns; this table model has no ragged arrays, so both take
# fixed-width padded id matrices — pred [n, P] and truth [n, T] integer ids
# with -1 padding — the same static-shape convention as the rest of the
# framework (and exactly what ALSModel.recommend_for_all_users emits).
# --------------------------------------------------------------------------

def _ids(x) -> torch.Tensor:
    """An id matrix as int32: a tensor stays on its device, anything else
    goes to the active session's."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    from orange3_spark_tpu_torch.core.session import TorchSession

    return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                           device=TorchSession.active().device)


def _pair_hits(pred, truth):
    """[n, P] bool: is pred slot j a member of the row's truth set.
    -1 pads never match (-1 == -1 is masked explicitly)."""
    eq = pred[:, :, None] == truth[:, None, :]
    eq = eq & (truth[:, None, :] >= 0)
    return eq.any(dim=2) & (pred >= 0)


@dataclasses.dataclass(frozen=True)
class RankingEvaluatorParams(Params):
    metric_name: str = "meanAveragePrecision"
    k: int = 10


class RankingEvaluator:
    """pyspark.ml.evaluation.RankingEvaluator parity (RankingMetrics):
    meanAveragePrecision, meanAveragePrecisionAtK, precisionAtK, recallAtK,
    ndcgAtK — binary relevance, predictions ordered best-first.

    evaluate(pred_ids [n, P], true_ids [n, T]) -> float; -1 pads ignored.
    """

    ParamsCls = RankingEvaluatorParams
    METRICS = ("meanAveragePrecision", "meanAveragePrecisionAtK",
               "precisionAtK", "recallAtK", "ndcgAtK")

    def __init__(self, params: RankingEvaluatorParams | None = None, **kw):
        self.params = params or RankingEvaluatorParams(**kw)

    def evaluate(self, pred_ids, true_ids) -> float:
        p = self.params
        m = p.metric_name
        if m not in self.METRICS:
            raise ValueError(f"unknown metric {m!r}; one of {self.METRICS}")
        pred = _ids(pred_ids)
        return float(_ranking_metric(pred, _ids(true_ids).to(pred.device), metric=m, k=p.k))


def _ranking_metric(pred, truth, *, metric: str, k: int):
    P = pred.shape[1]
    dev = pred.device
    hits = _pair_hits(pred, truth).to(torch.float32)                 # [n, P]
    n_rel = (truth >= 0).to(torch.float32).sum(dim=1)                # [n]
    ranks = torch.arange(1, P + 1, dtype=torch.float32, device=dev)
    topk = (ranks <= k).to(torch.float32)
    safe_rel = torch.clamp_min(n_rel, 1.0)
    if metric == "precisionAtK":
        # MLlib divides by k even when fewer than k predictions exist
        row = (hits * topk).sum(dim=1) / k
    elif metric == "recallAtK":
        row = (hits * topk).sum(dim=1) / safe_rel
    elif metric == "meanAveragePrecision":
        prec_at = torch.cumsum(hits, dim=1) / ranks
        row = (prec_at * hits).sum(dim=1) / safe_rel
    elif metric == "meanAveragePrecisionAtK":
        prec_at = torch.cumsum(hits, dim=1) / ranks
        row = ((prec_at * hits * topk).sum(dim=1)
               / torch.clamp_min(torch.clamp_max(n_rel, float(k)), 1.0))
    else:  # ndcgAtK, binary relevance
        disc = 1.0 / torch.log2(ranks + 1.0)
        dcg = (hits * disc * topk).sum(dim=1)
        # ideal DCG sums min(|rel|, k) discount terms INDEPENDENT of the
        # prediction width P (Spark ndcgAt) — a too-short prediction list
        # must lower the score, not the ideal
        ideal_n = torch.clamp_max(n_rel, float(k))
        iranks = torch.arange(1, k + 1, dtype=torch.float32, device=dev)
        idisc = torch.where(iranks[None, :] <= ideal_n[:, None],
                            1.0 / torch.log2(iranks[None, :] + 1.0), 0.0)
        idcg = torch.clamp_min(idisc.sum(dim=1), 1e-12)
        row = dcg / idcg
    # rows with an empty truth set contribute 0 (MLlib logs-and-zeros them)
    row = torch.where(n_rel > 0, row, 0.0)
    return row.mean()


@dataclasses.dataclass(frozen=True)
class MultilabelEvaluatorParams(Params):
    metric_name: str = "f1Measure"


class MultilabelClassificationEvaluator:
    """pyspark.ml.evaluation.MultilabelClassificationEvaluator parity
    (MultilabelMetrics): subsetAccuracy, accuracy, hammingLoss, precision,
    recall, f1Measure, microPrecision, microRecall, microF1Measure.

    evaluate(pred_ids [n, P], true_ids [n, T]) -> float; -1 pads ignored;
    ids within a row are treated as SETS (duplicates undefined, like
    Spark). hammingLoss normalizes by MLlib's numLabels = the distinct
    count of TRUE labels only (predicted ids absent from every truth row
    do not deflate it). Convention note: per-row 'accuracy' here returns
    1.0 when BOTH the prediction and truth sets are empty; Spark's 0/0
    yields NaN for such rows — an exactly-matched empty set counts as
    correct rather than poisoning the mean.
    """

    ParamsCls = MultilabelEvaluatorParams
    METRICS = ("subsetAccuracy", "accuracy", "hammingLoss", "precision",
               "recall", "f1Measure", "microPrecision", "microRecall",
               "microF1Measure")

    def __init__(self, params: MultilabelEvaluatorParams | None = None, **kw):
        self.params = params or MultilabelEvaluatorParams(**kw)

    def evaluate(self, pred_ids, true_ids) -> float:
        m = self.params.metric_name
        if m not in self.METRICS:
            raise ValueError(f"unknown metric {m!r}; one of {self.METRICS}")
        pred = _ids(pred_ids)
        truth = _ids(true_ids).to(pred.device)
        if m == "hammingLoss":
            # MLlib's numLabels = distinct count of TRUE labels only —
            # predicted ids absent from every truth row must not deflate it
            ids = truth.cpu().numpy().ravel()
            n_labels = len(np.unique(ids[ids >= 0]))
            return float(_multilabel_metric(pred, truth, metric=m) / max(n_labels, 1))
        return float(_multilabel_metric(pred, truth, metric=m))


def _multilabel_metric(pred, truth, *, metric: str):
    hit_p = _pair_hits(pred, truth).to(torch.float32)   # pred slot in truth
    np_ = (pred >= 0).to(torch.float32).sum(dim=1)
    nt = (truth >= 0).to(torch.float32).sum(dim=1)
    inter = hit_p.sum(dim=1)
    union = np_ + nt - inter
    if metric == "subsetAccuracy":
        return ((inter == np_) & (inter == nt)).to(torch.float32).mean()
    if metric == "accuracy":
        return torch.where(union > 0, inter / torch.clamp_min(union, 1.0), 1.0).mean()
    if metric == "hammingLoss":
        # symmetric difference summed over rows; the caller divides by
        # n * numLabels (numLabels needs a host-side distinct count)
        return (union - inter).sum() / pred.shape[0]
    if metric == "precision":
        return torch.where(np_ > 0, inter / torch.clamp_min(np_, 1.0), 0.0).mean()
    if metric == "recall":
        return torch.where(nt > 0, inter / torch.clamp_min(nt, 1.0), 0.0).mean()
    if metric == "f1Measure":
        return torch.where(np_ + nt > 0, 2.0 * inter / torch.clamp_min(np_ + nt, 1.0),
                           0.0).mean()
    tot_i, tot_p, tot_t = inter.sum(), np_.sum(), nt.sum()
    if metric == "microPrecision":
        return tot_i / torch.clamp_min(tot_p, 1e-12)
    if metric == "microRecall":
        return tot_i / torch.clamp_min(tot_t, 1e-12)
    return 2.0 * tot_i / torch.clamp_min(tot_p + tot_t, 1e-12)  # microF1Measure


# ------------------------------------------------- streaming evaluation
# A holdout too large to hold: one fold a chunk on the device, per-chunk
# sums kept on the device and totalled in float64 on the host, one read at
# the end (a single float32 running sum drifts ~1e-4 relative by 1e9 rows).

def _labeled_chunk_stream(source, session, chunk_rows: int):
    """A labeled ``(X, y[, w])`` source rechunked into padded device triples,
    the pad and copy of chunk t+1 overlapping the fold of chunk t (the
    streaming fits' prefetch thread)."""
    from orange3_spark_tpu_torch.core.session import TorchSession
    from orange3_spark_tpu_torch.io.streaming import (
        _device_put, _pad_chunk, _rechunk, prefetch_map,
    )
    from orange3_spark_tpu_torch.models.hashed_linear import _HostToDevice

    session = session or TorchSession.builder_get_or_create()
    pad_rows = session.pad_rows(chunk_rows)
    h2d = _HostToDevice(session.device)

    def prep(chunk):
        X_np, y_np, w_np = chunk
        if y_np is None:
            raise ValueError("streaming evaluation needs labeled chunks")
        return _device_put(h2d, _pad_chunk(X_np, y_np, w_np, pad_rows, X_np.shape[1]))

    for out, event in prefetch_map(prep, _rechunk(source(), pad_rows), depth=2):
        yield _HostToDevice.ready(out, event)


def _bound(steps: int, token) -> None:
    """The loop's only wait: at most 8 folds queued ahead of the device."""
    from orange3_spark_tpu_torch.utils.dispatch import bound_dispatch

    bound_dispatch(steps, token, period=8)


def _host_sums(parts: list) -> np.ndarray:
    """The per-chunk device sums ([n_chunks, ...]) in one host read, as
    float64."""
    return torch.stack(parts).cpu().numpy().astype(np.float64)


def _binary_stream_fold(acc: dict, s, y, w, *, n_bins: int) -> torch.Tensor:
    """Fold one scored chunk into the per-class score histograms, in place
    (binned AUC, error O(1/n_bins)), and return the chunk's weighted
    logloss, correct and weight sums ([3], summed in float64 on the
    host)."""
    s = torch.clamp(s, 1e-7, 1.0 - 1e-7)
    b = torch.clamp((s * n_bins).to(torch.int32), 0, n_bins - 1)
    y = (y > 0.5).to(torch.float32)
    acc["hp"].index_add_(0, b, w * y)
    acc["hn"].index_add_(0, b, w * (1.0 - y))
    ll = -(w * (y * torch.log(s) + (1.0 - y) * torch.log1p(-s))).sum()
    ok = (w * ((s > 0.5) == (y > 0.5)).to(torch.float32)).sum()
    return torch.stack([ll, ok, w.sum()])


def evaluate_binary_stream(score_fn, source, *, session=None, chunk_rows: int = 1 << 18,
                           n_bins: int = 4096) -> dict:
    """Binary metrics over a chunk stream, without holding the holdout (the
    in-memory evaluator's exact AUC needs every score resident; Spark's
    BinaryClassificationMetrics bins the same way).

    ``score_fn(X_device) -> P(y=1)`` per padded chunk (e.g. a fitted model's
    probability head); ``source`` yields ``(X, y[, w])`` chunks. Per-class
    score histograms give the AUC to O(1/n_bins); logloss, accuracy and the
    count are per-chunk device sums totalled in float64 on the host.
    Returns {'auc', 'logloss', 'accuracy', 'count'} ('auc' NaN when one
    class is absent)."""
    acc = None
    parts = []
    for steps, (Xd, yd, wd) in enumerate(_labeled_chunk_stream(source, session, chunk_rows),
                                         start=1):
        if acc is None:
            acc = {h: torch.zeros((n_bins,), dtype=torch.float32, device=Xd.device)
                   for h in ("hp", "hn")}
        parts.append(_binary_stream_fold(acc, score_fn(Xd), yd, wd, n_bins=n_bins))
        _bound(steps, parts[-1])
    if not parts:
        # a misconfigured source fails loudly, not with plausible zeros
        raise ValueError("stream produced no chunks")
    # one host read: the histograms, then the chunks' sums
    host = torch.cat([acc["hp"], acc["hn"], torch.stack(parts).reshape(-1)]).cpu().numpy()
    host = host.astype(np.float64)
    hp, hn = host[:n_bins], host[n_bins:2 * n_bins]
    sums = host[2 * n_bins:].reshape(-1, 3)
    ll_tot, ok_tot, n_tot = (float(sums[:, j].sum()) for j in range(3))
    P, N = hp.sum(), hn.sum()
    cum_neg_below = np.concatenate([[0.0], np.cumsum(hn)[:-1]])
    auc = (float(np.sum(hp * (cum_neg_below + 0.5 * hn)) / (P * N))
           if P > 0 and N > 0 else float("nan"))
    n = max(n_tot, 1e-12)
    return {"auc": auc, "logloss": ll_tot / n, "accuracy": ok_tot / n, "count": n_tot}


def _oor_weight(p, y, w, n_classes: int) -> torch.Tensor:
    """Weight of the rows a one-hot would silently drop (a class id outside
    [0, n_classes)), surfaced instead of vanishing."""
    bad = (p < 0) | (p >= n_classes) | (y < 0) | (y >= n_classes)
    return torch.where(bad, w, 0.0).sum()


def evaluate_multiclass_stream(predict_fn, source, *, n_classes: int, session=None,
                               chunk_rows: int = 1 << 18) -> dict:
    """Multiclass metrics over a chunk stream (MulticlassMetrics at holdout
    scale): per-chunk [k, k] weighted confusion matrices, totalled in
    float64 on the host, every metric from the total. ``predict_fn(
    X_device) -> class ids``. Returns accuracy / f1 / weightedPrecision /
    weightedRecall / count, the confusion matrix and ``dropped_weight``
    (rows whose label or prediction lies outside [0, n_classes) leave every
    metric; a nonzero value means n_classes is wrong)."""
    parts = []
    for steps, (Xd, yd, wd) in enumerate(_labeled_chunk_stream(source, session, chunk_rows),
                                         start=1):
        p = predict_fn(Xd)
        parts.append(torch.cat([_confusion_weighted(p, yd, wd, n_classes).reshape(-1),
                                _oor_weight(p, yd, wd, n_classes)[None]]))
        _bound(steps, parts[-1])
    if not parts:
        raise ValueError("stream produced no chunks")
    host = _host_sums(parts).sum(axis=0)
    Ch = host[:-1].reshape(n_classes, n_classes)
    out = {m: MulticlassClassificationEvaluator.from_confusion(Ch, m)
           for m in ("accuracy", "f1", "weightedPrecision", "weightedRecall")}
    out["count"] = float(Ch.sum())
    out["confusion"] = Ch
    out["dropped_weight"] = float(host[-1])
    return out


def _regression_stream_sums(s, y, w, shift) -> torch.Tensor:
    """One chunk's weighted sums for the regression metrics: [Σw, Σw·err²,
    Σw·|err|, Σw·z, Σw·z²] with z = y - shift (r2's total sum of squares
    does not move with the shift, and the raw identity loses float32 bits
    on labels with a large mean)."""
    err = s - y
    z = y - shift
    return torch.stack([w.sum(), (w * err * err).sum(), (w * err.abs()).sum(),
                        (w * z).sum(), (w * z * z).sum()])


def evaluate_regression_stream(predict_fn, source, *, session=None,
                               chunk_rows: int = 1 << 18) -> dict:
    """Regression metrics over a chunk stream (RegressionMetrics at any
    scale): weighted rmse / mse / mae / r2 from per-chunk device sums
    totalled in float64 on the host. ``predict_fn(X_device) ->
    predictions``. The label moments are taken about the first chunk's
    weighted label mean."""
    parts = []
    shift = None
    for steps, (Xd, yd, wd) in enumerate(_labeled_chunk_stream(source, session, chunk_rows),
                                         start=1):
        if shift is None:
            shift = (yd * wd).sum() / torch.clamp_min(wd.sum(), EPS_TOTAL_WEIGHT)
        parts.append(_regression_stream_sums(predict_fn(Xd), yd, wd, shift))
        _bound(steps, parts[-1])
    if not parts:
        raise ValueError("stream produced no chunks")
    S = _host_sums(parts).sum(axis=0)
    n_raw, ss_err, abs_err, sz, szz = S
    n = max(n_raw, 1e-12)
    mse = ss_err / n
    ss_tot = max(szz - sz * sz / n, 1e-12)
    return {"rmse": float(np.sqrt(mse)), "mse": float(mse), "mae": float(abs_err / n),
            "r2": float(1.0 - ss_err / ss_tot), "count": float(n_raw)}
