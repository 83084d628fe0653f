"""NaiveBayes — parity with ``pyspark.ml.classification.NaiveBayes``.

Port of ``orange3_spark_tpu/models/naive_bayes.py``. MLlib's four model
types (multinomial, bernoulli, gaussian, complement) fit from one pass of
per-class aggregates: counts, Σw·x and Σw·x² by class, here the products
``one_hot(y)ᵀ @ X`` and ``one_hot(y)ᵀ @ X²`` (``torch.matmul``, as the
reference leaves them to XLA's dot), then the log prior and the per-class
log factors. Prediction is the log joint, matmul-shaped; its products go
through ``_linear.dense_logits`` (each row summed over its own products),
so a served bucket gives the raw call's bits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models._linear import dense_logits
from orange3_spark_tpu_torch.models.base import (
    Estimator, Model, Params, append_columns, class_score_columns, infer_class_values,
    to_host,
)

_EPS = 1e-12
MODEL_TYPES = ("multinomial", "bernoulli", "gaussian", "complement")


@dataclasses.dataclass(frozen=True)
class NaiveBayesParams(Params):
    smoothing: float = 1.0           # MLlib smoothing (Laplace/Lidstone)
    model_type: str = "multinomial"  # MLlib modelType: one of MODEL_TYPES
    seed: int = 0


def _class_aggregates(X, y, w, k: int):
    """Per-class weighted sums: counts [k] Σw, sums [k, d] Σw·x, sq [k, d]
    Σw·x²."""
    cls = torch.arange(k, dtype=torch.int32, device=y.device)
    onehot = (y.to(torch.int32)[:, None] == cls).to(torch.float32) * w[:, None]
    return onehot.sum(0), onehot.T @ X, onehot.T @ (X * X)


def _fit_factors(counts, sums, sq, smoothing: float, model_type: str):
    """Log prior pi [k] and the per-class log factors used at predict time."""
    pi = torch.log(torch.clamp_min(counts, _EPS)) - torch.log(
        torch.clamp_min(counts.sum(), _EPS))
    if model_type == "multinomial":
        num = sums + smoothing
        return pi, {"theta": torch.log(num) - torch.log(num.sum(1, keepdim=True))}
    if model_type == "complement":
        # CNB (Rennie et al. 2003, as in MLlib): counts of all OTHER
        # classes, negated so the argmax reads as multinomial's
        num = (sums.sum(0, keepdim=True) - sums) + smoothing
        return pi, {"theta": -(torch.log(num) - torch.log(num.sum(1, keepdim=True)))}
    if model_type == "bernoulli":
        p1 = (sums + smoothing) / (counts[:, None] + 2.0 * smoothing)
        return pi, {"log_p1": torch.log(p1), "log_p0": torch.log1p(-p1)}
    if model_type == "gaussian":
        n = torch.clamp_min(counts[:, None], _EPS)
        mean = sums / n
        var = sq / n - mean * mean
        # MLlib-style flooring: epsilon scaled to the largest variance
        var = torch.maximum(var, 1e-9 * torch.clamp_min(var.max(), _EPS))
        return pi, {"mean": mean, "var": var}
    raise ValueError(f"unknown model_type {model_type!r}")


def _log_joint(X, pi, factors, model_type: str):
    """Per-row, per-class log joint likelihood [N, k]."""
    if model_type in ("multinomial", "complement"):
        return dense_logits(X, factors["theta"].T) + pi
    if model_type == "bernoulli":
        lp1, lp0 = factors["log_p1"], factors["log_p0"]
        return dense_logits(X, (lp1 - lp0).T) + lp0.sum(1) + pi
    # gaussian: Σ_j -(x-μ)²/(2σ²) - ½log(2πσ²) as x² @ a + x @ b + const
    mean, var = factors["mean"], factors["var"]
    a = -0.5 / var
    b = mean / var
    const = (-0.5 * mean * mean / var - 0.5 * torch.log(2.0 * math.pi * var)).sum(1)
    return dense_logits(X * X, a.T) + dense_logits(X, b.T) + const + pi


class NaiveBayesModel(Model):
    def __init__(self, params, pi, factors, class_values):
        self.params = params
        self.pi = pi                    # f32[k] log prior
        self.factors = factors          # dict of f32[k, d] log-factor arrays
        self.class_values = tuple(class_values)

    @property
    def state_pytree(self):
        return {"pi": self.pi, **self.factors}

    def load_state_pytree(self, state):
        state = dict(state)
        self.pi = state.pop("pi")
        self.factors = state
        self._touch_serving_state()

    def _scores(self, X):
        return _log_joint(X, self.pi, self.factors, self.params.model_type)

    def predict(self, table: TorchTable) -> np.ndarray:
        pred = torch.argmax(self._scores(table.X), 1).to(torch.float32)
        return to_host(pred, table.n_rows)

    def predict_proba(self, table: TorchTable) -> np.ndarray:
        return to_host(torch.softmax(self._scores(table.X), -1), table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        return append_columns(table, *class_score_columns(self._scores(table.X),
                                                          self.class_values))


class NaiveBayes(Estimator):
    ParamsCls = NaiveBayesParams
    params: NaiveBayesParams

    def _fit(self, table: TorchTable) -> NaiveBayesModel:
        p = self.params
        class_values = infer_class_values(table)
        live = table.W[:, None] > 0
        if p.model_type in ("multinomial", "complement", "bernoulli"):
            # MLlib requires nonnegative features for these model types
            if bool(((table.X < 0) & live).any()):
                raise ValueError(f"model_type={p.model_type!r} requires nonnegative features")
        if p.model_type == "bernoulli":
            # MLlib raises on non-0/1 values (p1 > 1 would make log1p(-p1) NaN)
            if bool((live & (table.X != 0.0) & (table.X != 1.0)).any()):
                raise ValueError("model_type='bernoulli' requires 0/1 features; "
                                 "binarize first (Binarizer)")
        counts, sums, sq = _class_aggregates(table.X, table.y, table.W, len(class_values))
        pi, factors = _fit_factors(counts, sums, sq, p.smoothing, p.model_type)
        return NaiveBayesModel(p, pi, factors, class_values)
