"""LinearSVC of the PyTorch package: ``pyspark.ml.classification.LinearSVC``.

A binary hinge-loss classifier, fit by the same ``fit_linear`` as
LogisticRegression with the hinge objective. ``loss='squared_hinge'`` is
offered because L-BFGS likes smooth objectives; the default stays 'hinge'
(MLlib). Multiclass tables are refused, as MLlib refuses them.
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
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params, to_host


@dataclasses.dataclass(frozen=True)
class LinearSVCParams(Params):
    max_iter: int = 100          # MLlib maxIter
    reg_param: float = 0.0       # MLlib regParam
    elastic_net_param: float = 0.0  # L1 mixing, an extension (MLlib's LinearSVC
    # is L2-only): OWLQN assumes a smooth data term, so use it with
    # loss='squared_hinge'
    tol: float = 1e-6            # MLlib tol
    fit_intercept: bool = True   # MLlib fitIntercept
    standardization: bool = True # MLlib standardization
    threshold: float = 0.0       # MLlib threshold (on the raw margin)
    loss: str = "hinge"          # 'hinge' (MLlib) | 'squared_hinge'
    compute_dtype: str = "float32"


class LinearSVCModel(Model):
    def __init__(self, params, coef, intercept, class_values):
        self.params = params
        self.coef = coef            # f32[d, 1]
        self.intercept = intercept  # f32[1]
        self.class_values = tuple(class_values)
        self.n_iter_: int | None = None

    @property
    def state_pytree(self):
        return {"coef": self.coef, "intercept": self.intercept}

    def _margin(self, X: torch.Tensor) -> torch.Tensor:
        return (dense_logits(X, self.coef) + self.intercept)[:, 0]

    def _pred(self, margin: torch.Tensor) -> torch.Tensor:
        return (margin > self.params.threshold).to(torch.float32)

    def decision_function(self, table: TorchTable) -> np.ndarray:
        return to_host(self._margin(table.X), table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        """Append rawPrediction (the margin) and prediction columns."""
        margin = self._margin(table.X)
        new_attrs = list(table.domain.attributes) + [
            ContinuousVariable("rawPrediction"),
            DiscreteVariable("prediction", self.class_values),
        ]
        new_domain = Domain(new_attrs, table.domain.class_vars, table.domain.metas)
        X = torch.cat([table.X, margin[:, None], self._pred(margin)[:, None]], dim=1)
        return table.with_X(X, new_domain)

    def predict(self, table: TorchTable) -> np.ndarray:
        return to_host(self._pred(self._margin(table.X)), table.n_rows)


class LinearSVC(Estimator):
    ParamsCls = LinearSVCParams
    params: LinearSVCParams
    #: fits a gang's local tables: its moments and objective fold over the
    #: ranks (models/_linear.LinearObjective)
    gang_fold = True

    def _fit(self, table: TorchTable) -> LinearSVCModel:
        p = self.params
        cvar = table.domain.class_var
        class_values = (cvar.values if isinstance(cvar, DiscreteVariable) and cvar.values
                        else ("0", "1"))
        if len(class_values) != 2:
            raise ValueError(
                f"LinearSVC is binary (MLlib parity); got {len(class_values)} classes")
        X, w = table.X, table.W
        group = table.session.world.data_group
        inv_std = column_inv_std(X, w, group) if p.standardization else None
        reg_l2, reg_l1 = penalties(p.reg_param, p.elastic_net_param)
        if reg_l1 is not None and p.loss == "hinge":
            raise ValueError("elastic_net_param > 0 needs a smooth data term for OWLQN; "
                             "use loss='squared_hinge'")
        result = fit_linear(X, table.y, w, reg_l2, p.tol, p.max_iter, inv_std, reg_l1,
                            loss_kind=p.loss, k=1, fit_intercept=p.fit_intercept,
                            compute_dtype=p.compute_dtype, group=group)
        coef = result.coef
        if inv_std is not None:
            coef = coef * inv_std[:, None]
        model = LinearSVCModel(p, coef, result.intercept, class_values)
        record_fit_counts(model, result)
        return model
