"""AFTSurvivalRegression — parity with ``pyspark.ml.regression.AFTSurvivalRegression``.

Port of ``orange3_spark_tpu/models/aft.py``: a Weibull accelerated-failure-
time model fitted by L-BFGS (``_linear.lbfgs_minimize``, optax's L-BFGS with
its zoom linesearch, a host loop here where the reference runs one
``lax.while_loop``) on the censored log-likelihood

    eps_i = (log t_i - x_i·beta - b0) / sigma
    logL  = sum_i  delta_i · (eps_i - log sigma) - exp(eps_i)

over (b0, beta, log sigma), flat in the reference's ``ravel_pytree`` order;
its gradient by autograd. The censor column (1 = event, 0 = right-censored)
is an attribute of the table and is not a feature.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models._linear import (
    AutogradObjective, dense_logits, lbfgs_minimize,
)
from orange3_spark_tpu_torch.models.base import (
    Estimator, Model, Params, append_columns, to_host,
)


@dataclasses.dataclass(frozen=True)
class AFTSurvivalRegressionParams(Params):
    censor_col: str = "censor"   # MLlib censorCol (1=event, 0=censored)
    max_iter: int = 100          # MLlib maxIter
    tol: float = 1e-6            # MLlib tol
    fit_intercept: bool = True
    quantile_probabilities: tuple = (0.01, 0.05, 0.1, 0.25, 0.5,
                                     0.75, 0.9, 0.95, 0.99)  # MLlib default


def _fit_aft(X, logt, delta, w, tol: float, *, fit_intercept: bool, max_iter: int):
    """Returns (b0, beta, log_sigma, n_iter, the objective)."""
    d = X.shape[1]
    sum_w = torch.clamp_min(w.sum(), 1e-12)

    def neg_loglik(theta):
        b0, beta, log_sigma = theta[0], theta[1:d + 1], theta[d + 1]
        eta = X @ beta + (b0 if fit_intercept else 0.0)
        eps = (logt - eta) * torch.exp(-log_sigma)
        # the clip guards exp on padded rows (w = 0 zeroes them anyway)
        ll_rows = delta * (eps - log_sigma) - torch.exp(torch.clamp(eps, -50.0, 50.0))
        return -(w * ll_rows).sum() / sum_w

    theta0 = torch.zeros(d + 2, dtype=torch.float32, device=X.device)
    objective = AutogradObjective(neg_loglik)
    theta, n_iter, _ = lbfgs_minimize(objective, theta0, tol, max_iter)
    return theta[0], theta[1:d + 1], theta[d + 1], n_iter, objective


class AFTSurvivalRegressionModel(Model):
    def __init__(self, params, coef, intercept, scale, feature_indices=None):
        self.params = params
        self.coef = coef            # f32[d]
        self.intercept = intercept  # f32[]
        self.scale = scale          # f32[] Weibull scale sigma
        self.feature_indices = feature_indices  # columns used (censor col excluded)
        self.n_iter_: int | None = None

    def _features(self, table: TorchTable):
        if self.feature_indices is None:
            return table.X
        return table.X[:, self.feature_indices]

    @property
    def state_pytree(self):
        return {"coef": self.coef, "intercept": self.intercept, "scale": self.scale}

    def _eta(self, table: TorchTable):
        return dense_logits(self._features(table), self.coef[:, None])[:, 0] + self.intercept

    def predict(self, table: TorchTable) -> np.ndarray:
        """The expected scale of the survival time, exp(x·b + b0) (MLlib
        predict)."""
        return to_host(torch.exp(self._eta(table)), table.n_rows)

    def predict_quantiles(self, table: TorchTable) -> np.ndarray:
        """MLlib predictQuantiles: t_p = exp(eta) · (-log(1 - p))^sigma."""
        probs = torch.tensor(self.params.quantile_probabilities, dtype=torch.float32,
                             device=table.X.device)
        q = torch.exp(self._eta(table))[:, None] * (-torch.log1p(-probs)) ** self.scale
        return to_host(q, table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        return append_columns(table, [torch.exp(self._eta(table))[:, None]],
                              [ContinuousVariable("prediction")])


class AFTSurvivalRegression(Estimator):
    ParamsCls = AFTSurvivalRegressionParams
    params: AFTSurvivalRegressionParams

    def _fit(self, table: TorchTable) -> AFTSurvivalRegressionModel:
        p = self.params
        if table.Y is None:
            raise ValueError("AFTSurvivalRegression needs a survival-time target")
        names = [v.name for v in table.domain.attributes]
        if p.censor_col not in names:
            raise ValueError(f"censor column {p.censor_col!r} not among attributes {names}")
        ci = names.index(p.censor_col)
        keep = [i for i in range(len(names)) if i != ci]
        X = table.X[:, keep]
        logt = torch.log(torch.clamp_min(table.y, 1e-12))
        b0, beta, log_sigma, n_iter, objective = _fit_aft(
            X, logt, table.X[:, ci], table.W, p.tol,
            fit_intercept=p.fit_intercept, max_iter=p.max_iter)
        model = AFTSurvivalRegressionModel(p, beta, b0, torch.exp(log_sigma),
                                           feature_indices=keep)
        model.n_iter_ = n_iter
        # the minimizer's objective evaluations, in all and by iteration
        model.n_evals_, model.iter_evals_ = objective.n_evals, tuple(objective.iter_evals)
        return model
