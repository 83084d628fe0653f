"""The port's RankingEvaluator and MultilabelClassificationEvaluator
(models/evaluation.py) against the JAX package on random padded id
matrices, and the hand-computed RankingMetrics / MultilabelMetrics values
of tests/test_ranking_eval.py.

Tolerance: every metric within 1e-6 of the reference's (measured worst
6e-8: both packages sum the same float32 per-row terms, in their own
reduction orders), and within pytest.approx of the hand-computed values.
"""

import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.models import evaluation as JE
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.models.evaluation import (
    MultilabelClassificationEvaluator,
    RankingEvaluator,
)


@pytest.fixture(scope="module", autouse=True)
def session():
    return TorchSession.builder_get_or_create("cpu")


def _random_ids(seed, n, P, T, n_ids, pad_share=0.2):
    """Padded id matrices: each row's predictions distinct (a ranking),
    its truth distinct, -1 pads at the end of some rows, some rows with an
    empty truth set."""
    rng = np.random.default_rng(seed)
    pred = np.stack([rng.permutation(n_ids)[:P] for _ in range(n)]).astype(np.int32)
    truth = np.stack([rng.permutation(n_ids)[:T] for _ in range(n)]).astype(np.int32)
    for M in (pred, truth):
        keep = rng.integers(0, M.shape[1] + 1, n)
        keep[rng.random(n) > pad_share] = M.shape[1]
        M[np.arange(M.shape[1])[None, :] >= keep[:, None]] = -1
    return pred, truth


_SHAPES = [(0, 64, 10, 6, 30), (1, 50, 4, 9, 12), (2, 33, 20, 3, 40), (3, 8, 1, 1, 3)]


@pytest.mark.parametrize("metric", RankingEvaluator.METRICS)
@pytest.mark.parametrize("k", [1, 3, 10, 25])
@pytest.mark.parametrize("seed,n,P,T,n_ids", _SHAPES)
def test_ranking_metric_matches_reference(metric, k, seed, n, P, T, n_ids):
    pred, truth = _random_ids(seed, n, P, T, n_ids)
    want = JE.RankingEvaluator(metric_name=metric, k=k).evaluate(pred, truth)
    got = RankingEvaluator(metric_name=metric, k=k).evaluate(pred, truth)
    assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("metric", MultilabelClassificationEvaluator.METRICS)
@pytest.mark.parametrize("seed,n,P,T,n_ids", _SHAPES)
def test_multilabel_metric_matches_reference(metric, seed, n, P, T, n_ids):
    pred, truth = _random_ids(seed, n, P, T, n_ids, pad_share=0.5)
    want = JE.MultilabelClassificationEvaluator(metric_name=metric).evaluate(pred, truth)
    got = MultilabelClassificationEvaluator(metric_name=metric).evaluate(pred, truth)
    assert got == pytest.approx(want, abs=1e-6)


def test_tensor_inputs_stay_on_their_device():
    pred, truth = _random_ids(4, 20, 5, 4, 10)
    ev = RankingEvaluator(metric_name="ndcgAtK", k=5)
    assert ev.evaluate(torch.from_numpy(pred), torch.from_numpy(truth).long()) == \
        ev.evaluate(pred, truth)


# ------------------------------------- twins of tests/test_ranking_eval.py
# two rows: preds best-first, -1 = padding
PRED = np.array([[1, 6, 2, 7, 8, 3, 9, 10, 4, 5],
                 [4, 1, 5, 6, 2, 7, 3, 8, 9, 10]])
TRUE = np.array([[1, 2, 3, 4, 5, -1],
                 [1, 2, 3, -1, -1, -1]])


def test_precision_at_k():
    ev = RankingEvaluator(metric_name="precisionAtK", k=5)
    assert ev.evaluate(PRED, TRUE) == pytest.approx((2 / 5 + 2 / 5) / 2)


def test_recall_at_k():
    ev = RankingEvaluator(metric_name="recallAtK", k=5)
    assert ev.evaluate(PRED, TRUE) == pytest.approx((2 / 5 + 2 / 3) / 2)


def test_mean_average_precision():
    r0 = (1 + 2 / 3 + 3 / 6 + 4 / 9 + 5 / 10) / 5
    r1 = (1 / 2 + 2 / 5 + 3 / 7) / 3
    ev = RankingEvaluator(metric_name="meanAveragePrecision")
    assert ev.evaluate(PRED, TRUE) == pytest.approx((r0 + r1) / 2, rel=1e-6)


def test_mean_average_precision_at_k():
    # row0 hits within top-4 at ranks 1, 3; min(|rel|, k) = 4
    r0 = (1 + 2 / 3) / 4
    # row1 hits within top-4 at rank 2; min(|rel|, k) = 3
    r1 = (1 / 2) / 3
    ev = RankingEvaluator(metric_name="meanAveragePrecisionAtK", k=4)
    assert ev.evaluate(PRED, TRUE) == pytest.approx((r0 + r1) / 2, rel=1e-6)


def test_ndcg_at_k():
    d = [1 / np.log2(i + 2) for i in range(10)]
    r0 = (d[0] + d[2] + d[5]) / sum(d[:5])
    r1 = (d[1] + d[4]) / sum(d[:3])
    ev = RankingEvaluator(metric_name="ndcgAtK", k=6)
    assert ev.evaluate(PRED, TRUE) == pytest.approx((r0 + r1) / 2, rel=1e-6)


def test_ndcg_ideal_independent_of_prediction_width():
    d = [1 / np.log2(i + 2) for i in range(10)]
    ev = RankingEvaluator(metric_name="ndcgAtK", k=10)
    got = ev.evaluate(np.array([[1, 2]]), np.array([[1, 2, 3, 4, 5]]))
    assert got == pytest.approx((d[0] + d[1]) / sum(d[:5]), rel=1e-6)


def test_empty_truth_contributes_zero():
    ev = RankingEvaluator(metric_name="meanAveragePrecision")
    t = np.array([[1, 2, -1], [-1, -1, -1]])
    p = np.array([[1, 2, 3], [1, 2, 3]])
    assert ev.evaluate(p, t) == pytest.approx(0.5 * 1.0)


PRED_ML = np.array([[0, 1, -1], [0, 2, -1], [2, -1, -1]])
TRUE_ML = np.array([[0, 1, -1], [0, 1, -1], [2, 0, -1]])


def test_multilabel_metrics():
    def ev(m):
        return MultilabelClassificationEvaluator(metric_name=m).evaluate(PRED_ML, TRUE_ML)

    assert ev("subsetAccuracy") == pytest.approx(1 / 3)
    assert ev("accuracy") == pytest.approx((1.0 + 1 / 3 + 1 / 2) / 3)
    assert ev("precision") == pytest.approx((1.0 + 0.5 + 1.0) / 3)
    assert ev("recall") == pytest.approx((1.0 + 0.5 + 0.5) / 3)
    assert ev("f1Measure") == pytest.approx((2 * 2 / 4 + 2 * 1 / 4 + 2 * 1 / 3) / 3)
    assert ev("microPrecision") == pytest.approx(4 / 5)
    assert ev("microRecall") == pytest.approx(4 / 6)
    assert ev("microF1Measure") == pytest.approx(2 * 4 / 11)
    assert ev("hammingLoss") == pytest.approx((0 + 2 + 1) / (3 * 3))


def test_hamming_loss_counts_true_labels_only():
    pred = np.array([[0, 5, -1]])
    true = np.array([[0, 1, -1]])
    ev = MultilabelClassificationEvaluator(metric_name="hammingLoss")
    assert ev.evaluate(pred, true) == pytest.approx(2 / (1 * 2))


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="unknown metric"):
        RankingEvaluator(metric_name="nope").evaluate(PRED, TRUE)
    with pytest.raises(ValueError, match="unknown metric"):
        MultilabelClassificationEvaluator(metric_name="nope").evaluate(PRED_ML, TRUE_ML)


def test_ranking_with_als_recommendations():
    """End-to-end: ALS top-k recommendations scored by RankingEvaluator."""
    from orange3_spark_tpu_torch.models.als import ALS, ratings_table

    rng = np.random.default_rng(0)
    n_u, n_i, rank = 30, 40, 4
    U = rng.normal(0, 1, (n_u, rank)).astype(np.float32)
    V = rng.normal(0, 1, (n_i, rank)).astype(np.float32)
    full = U @ V.T
    uu, ii = np.nonzero(rng.random((n_u, n_i)) < 0.5)
    r = full[uu, ii] + 0.01 * rng.standard_normal(len(uu)).astype(np.float32)
    t = ratings_table(np.stack([uu, ii, r], 1).astype(np.float32))
    model = ALS(rank=rank, max_iter=12, reg_param=0.05, n_users=n_u, n_items=n_i,
                seed=1).fit(t)
    recs = model.recommend_for_all_users(10).astype(np.int64)
    truth = np.argsort(-full, axis=1)[:, :10]
    score = RankingEvaluator(metric_name="ndcgAtK", k=10).evaluate(recs, truth)
    assert score > 0.6, score
