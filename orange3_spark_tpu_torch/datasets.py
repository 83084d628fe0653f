"""Synthetic datasets of the PyTorch package."""

from __future__ import annotations

import numpy as np

from orange3_spark_tpu_torch.core.domain import (
    ContinuousVariable, DiscreteVariable, Domain,
)

HIGGS_FEATURES = 28


def make_higgs_proxy(n_rows: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """HIGGS-shaped binary data, the generator of ``bench_suite.py`` config 3:
    28 standard-normal features and a signal built from pairwise products
    and a radial term (tree-learnable, linear-model-opaque).
    Returns (X f32[n, 28], y f32[n])."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_rows, HIGGS_FEATURES), dtype=np.float32)
    z = (X[:, 0] * X[:, 1] - X[:, 2] * X[:, 3]
         + 0.8 * (X[:, 4] ** 2 - 1.0)
         + 0.6 * np.sign(X[:, 5]) * X[:, 6])
    y = (z + 0.5 * rng.standard_normal(n_rows).astype(np.float32) > 0
         ).astype(np.float32)
    return X, y


def higgs_domain() -> Domain:
    return Domain([ContinuousVariable(f"f{i}") for i in range(HIGGS_FEATURES)],
                  DiscreteVariable("signal", ("0", "1")))


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC AUC by the rank-sum formula (ties broken by sort order), as
    ``bench_suite.py`` computes it."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    npos = labels.sum()
    nneg = len(labels) - npos
    return float((ranks[labels > 0.5].sum() - npos * (npos + 1) / 2)
                 / (npos * nneg))
