"""LogisticRegression of the PyTorch package (BASELINE config 1; the
reference's flagship estimator), ``pyspark.ml.classification.
LogisticRegression`` with MLlib's param names (maxIter -> max_iter ...).

A multinomial softmax fit (binomial is the 2-class case) by
``models/_linear.fit_linear``: L-BFGS, or OWLQN with an L1 term, with the
standardization folded into the coefficients. Predictions are row by row
(``_linear.dense_logits``), so a served bucket gives the same bits as the
raw call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, DiscreteVariable, Domain
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models._linear import (
    column_inv_std, dense_logits, fit_linear, penalties, record_fit_counts,
)
from orange3_spark_tpu_torch.models.base import (
    Estimator, Model, Params, infer_class_values, to_host,
)


@dataclasses.dataclass(frozen=True)
class LogisticRegressionParams(Params):
    max_iter: int = 100            # MLlib maxIter
    reg_param: float = 0.0         # MLlib regParam (L2 when elastic_net=0)
    elastic_net_param: float = 0.0 # MLlib elasticNetParam (L1 mixing, OWLQN)
    tol: float = 1e-6              # MLlib tol
    fit_intercept: bool = True     # MLlib fitIntercept
    family: str = "auto"           # 'auto' | 'binomial' | 'multinomial'
    standardization: bool = True   # MLlib standardization
    threshold: float = 0.5         # MLlib threshold (binomial decision cut)
    compute_dtype: str = "float32" # 'bfloat16': X and the coefficients in bf16


class LogisticRegressionModel(Model):
    def __init__(self, params, coef, intercept, class_values):
        self.params = params
        self.coef = coef              # f32[d, k]
        self.intercept = intercept    # f32[k]
        self.class_values = tuple(class_values)
        self.n_iter_: int | None = None

    @property
    def state_pytree(self):
        return {"coef": self.coef, "intercept": self.intercept}

    def _prob_pred(self, X: torch.Tensor):
        """The decision: softmax probabilities and the predicted class.
        Binomial (MLlib): class 1 iff P(1) > threshold; else the argmax."""
        logits = dense_logits(X, self.coef) + self.intercept
        prob = torch.softmax(logits, dim=-1)
        if self.coef.shape[1] == 2:
            pred = (prob[:, 1] > self.params.threshold).to(torch.float32)
        else:
            pred = torch.argmax(logits, dim=-1).to(torch.float32)
        return prob, pred

    def _device_predict(self, table: TorchTable) -> torch.Tensor:
        """Serving hook (serve/context.py): the per-row predictions on the
        device, what a bucket's program runs for ``predict``."""
        return self._prob_pred(table.X)[1]

    def transform(self, table: TorchTable) -> TorchTable:
        """Append probability_<c> and prediction columns (Spark's
        probability/prediction output columns)."""
        prob, pred = self._prob_pred(table.X)
        new_attrs = list(table.domain.attributes) + [
            ContinuousVariable(f"probability_{c}") for c in self.class_values
        ] + [DiscreteVariable("prediction", self.class_values)]
        new_domain = Domain(new_attrs, table.domain.class_vars, table.domain.metas)
        return table.with_X(torch.cat([table.X, prob, pred[:, None]], dim=1), new_domain)

    def predict(self, table: TorchTable) -> np.ndarray:
        return to_host(self._prob_pred(table.X)[1], table.n_rows)

    def predict_proba(self, table: TorchTable) -> np.ndarray:
        return to_host(self._prob_pred(table.X)[0], table.n_rows)

    def summary(self, table: TorchTable) -> dict:
        """MLlib ``model.summary``-style metrics on ``table`` (Spark's
        TrainingSummary scores the training data; a holdout gives the
        honest version): accuracy / f1 / weightedPrecision /
        weightedRecall from one confusion matrix, plus areaUnderROC /
        areaUnderPR for binomial models."""
        from orange3_spark_tpu_torch.models.evaluation import (
            BinaryClassificationEvaluator, MulticlassClassificationEvaluator,
        )

        scored = self.transform(table)
        ev = MulticlassClassificationEvaluator()
        C = ev.confusion(scored)
        out = {m: ev.from_confusion(C, m)
               for m in ("accuracy", "f1", "weightedPrecision", "weightedRecall")}
        if len(self.class_values) == 2:
            for m in ("areaUnderROC", "areaUnderPR"):
                out[m] = BinaryClassificationEvaluator(metric_name=m).evaluate(scored)
        return out


class LogisticRegression(Estimator):
    ParamsCls = LogisticRegressionParams
    params: LogisticRegressionParams
    #: fits a gang's local tables: its moments and objective fold over the
    #: ranks (models/_linear.LinearObjective)
    gang_fold = True

    def _fit(self, table: TorchTable) -> LogisticRegressionModel:
        p = self.params
        class_values = infer_class_values(table)
        k = len(class_values)
        if p.family == "binomial" and k != 2:
            raise ValueError(f"binomial family needs 2 classes, got {k}")
        X, w = table.X, table.W
        group = table.session.world.data_group
        inv_std = column_inv_std(X, w, group) if p.standardization else None
        reg_l2, reg_l1 = penalties(p.reg_param, p.elastic_net_param)
        result = fit_linear(X, table.y, w, reg_l2, p.tol, p.max_iter, inv_std, reg_l1,
                            loss_kind="logistic", k=k, fit_intercept=p.fit_intercept,
                            compute_dtype=p.compute_dtype, group=group)
        coef = result.coef
        if inv_std is not None:
            coef = coef * inv_std[:, None]   # back to the original feature space
        model = LogisticRegressionModel(p, coef, result.intercept, class_values)
        record_fit_counts(model, result)
        return model
