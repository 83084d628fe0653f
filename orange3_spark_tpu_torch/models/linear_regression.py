"""LinearRegression of the PyTorch package:
``pyspark.ml.regression.LinearRegression``.

Two solvers, as MLlib: ``solver='normal'`` solves the weighted normal
equations (one pass over the rows for the Gramian, a Cholesky solve of the
d x d system, with standard errors, t-values and p-values when
``reg_param == 0``); ``solver='l-bfgs'`` and any fit with an L1 term go
through ``fit_linear`` (an L1 term has no closed form, so 'normal' falls
back to it, as MLlib's WLS solver does).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
from orange3_spark_tpu_torch.core.fmath import sqrt32
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models._linear import (
    dense_logits, fit_linear, penalties, record_fit_counts,
)
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params, to_host
from orange3_spark_tpu_torch.ops.stats import EPS_TOTAL_WEIGHT, two_sided_t_pvalue


@dataclasses.dataclass(frozen=True)
class LinearRegressionParams(Params):
    max_iter: int = 100
    reg_param: float = 0.0
    elastic_net_param: float = 0.0  # MLlib elasticNetParam (L1 mixing, OWLQN)
    tol: float = 1e-6
    fit_intercept: bool = True
    solver: str = "normal"  # 'normal' | 'l-bfgs'  (MLlib solver param)
    compute_dtype: str = "float32"


def _predict(X, coef, intercept) -> torch.Tensor:
    return dense_logits(X, coef[:, None])[:, 0] + intercept


def _training_summary(X, y, w, coef, intercept):
    """MLlib's LinearRegressionTrainingSummary scalars in one pass over the
    training rows: (rss, r2, rmse, mae, explained variance)."""
    tot = torch.clamp_min(w.sum(), EPS_TOTAL_WEIGHT)
    yhat = _predict(X, coef, intercept)
    resid = y - yhat
    rss = (w * resid * resid).sum()
    ybar = (w * y).sum() / tot
    tss = torch.clamp_min((w * (y - ybar) ** 2).sum(), EPS_TOTAL_WEIGHT)
    mae = (w * torch.abs(resid)).sum() / tot
    # Spark's RegressionMetrics centres SSreg on the label mean, not the
    # prediction mean (they differ for through-origin or early-stopped fits)
    expl = (w * (yhat - ybar) ** 2).sum() / tot
    return rss, 1.0 - rss / tss, sqrt32(rss / tot), mae, expl


def _normal_equations(X, y, w):
    """Weighted normal equations: (XᵀWX [d, d], XᵀWy [d], Σwx [d], Σwy,
    Σw), so the intercept folds in without a bias column."""
    Xw = X * w[:, None]
    tot = torch.clamp_min(w.sum(), EPS_TOTAL_WEIGHT)
    return Xw.T @ X, Xw.T @ y, Xw.sum(dim=0), (y * w).sum(), tot


def _solve_pos(A, B):
    """Solve A X = B for symmetric positive-definite A by Cholesky; NaN
    where the factorization fails (as the reference's solve gives), with
    no read of the device."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, torch.cholesky_solve(B, L), torch.nan)


class LinearRegressionModel(Model):
    def __init__(self, params, coef, intercept):
        self.params = params
        self.coef = coef            # f32[d]
        self.intercept = intercept  # f32[]
        self.n_iter_: int | None = None
        # MLlib's LinearRegressionTrainingSummary, filled at fit on the
        # training data (device scalars)
        self.r2_ = None
        self.root_mean_squared_error_ = None
        self.mean_absolute_error_ = None
        self.explained_variance_ = None
        # inference statistics, solver='normal' with reg_param == 0 only
        # (MLlib raises elsewhere); order [coefficients..., intercept]
        self.coefficient_standard_errors_ = None
        self.t_values_ = None
        self.p_values_ = None

    @property
    def state_pytree(self):
        return {"coef": self.coef, "intercept": self.intercept}

    def predict(self, table: TorchTable) -> np.ndarray:
        return to_host(_predict(table.X, self.coef, self.intercept), table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        yhat = _predict(table.X, self.coef, self.intercept)
        new_attrs = list(table.domain.attributes) + [ContinuousVariable("prediction")]
        new_domain = Domain(new_attrs, table.domain.class_vars, table.domain.metas)
        return table.with_X(torch.cat([table.X, yhat[:, None]], dim=1), new_domain)


class LinearRegression(Estimator):
    ParamsCls = LinearRegressionParams
    params: LinearRegressionParams

    def _fit(self, table: TorchTable) -> LinearRegressionModel:
        p = self.params
        reg_l2, reg_l1 = penalties(p.reg_param, p.elastic_net_param)
        y, X, w = table.y, table.X, table.W
        if p.solver == "normal" and reg_l1 is None:
            return self._fit_normal(X, y, w)
        result = fit_linear(X, y, w, reg_l2, p.tol, p.max_iter, None, reg_l1,
                            loss_kind="squared", k=1, fit_intercept=p.fit_intercept,
                            compute_dtype=p.compute_dtype)
        model = LinearRegressionModel(p, result.coef[:, 0], result.intercept[0])
        record_fit_counts(model, result)
        self._fill_summary(model, X, y, w)
        return model

    def _fit_normal(self, X, y, w) -> LinearRegressionModel:
        p = self.params
        XtX, Xty, x_sum, y_sum, tot = _normal_equations(X, y, w)
        d = X.shape[1]
        eye = torch.eye(d, dtype=XtX.dtype, device=XtX.device)
        if p.fit_intercept:
            # centre through the accumulated sums: solve on centred moments
            mean_x, mean_y = x_sum / tot, y_sum / tot
            A = XtX - tot * torch.outer(mean_x, mean_x)
            b = Xty - tot * mean_x * mean_y
        else:
            A, b = XtX, Xty
        # MLlib's regParam scales the normalized objective; the normal
        # equations are on the unnormalized sums, so multiply by Σw
        A = A + p.reg_param * tot * eye
        coef = _solve_pos(A, b[:, None])[:, 0]
        intercept = (mean_y - coef @ mean_x if p.fit_intercept
                     else torch.zeros((), device=X.device))
        model = LinearRegressionModel(p, coef, intercept)
        model.n_iter_ = 1
        rss = self._fill_summary(model, X, y, w)
        if p.reg_param == 0.0:
            # inference on the unregularized solve (MLlib raises on any
            # regularization): σ² = RSS/(n - rank), the coefficients'
            # covariance from inv(A) on the centred moments, the
            # intercept's variance folding the mean back in
            rank = d + (1 if p.fit_intercept else 0)
            df = torch.clamp_min(tot - rank, 1.0)
            sigma2 = rss / df
            inv_A = _solve_pos(A + 1e-8 * eye, eye)
            se = sqrt32(torch.diagonal(inv_A) * sigma2)
            beta = coef
            if p.fit_intercept:
                se_int = sqrt32(sigma2 * (1.0 / tot + mean_x @ inv_A @ mean_x))
                se = torch.cat([se, se_int[None]])
                beta = torch.cat([coef, intercept[None]])
            tval = beta / torch.clamp_min(se, 1e-30)
            model.coefficient_standard_errors_ = se
            model.t_values_ = tval
            model.p_values_ = two_sided_t_pvalue(tval, df)
        return model

    @staticmethod
    def _fill_summary(model, X, y, w):
        """One summary pass; returns rss for the inference statistics."""
        rss, r2, rmse, mae, expl = _training_summary(X, y, w, model.coef, model.intercept)
        model.r2_ = r2
        model.root_mean_squared_error_ = rmse
        model.mean_absolute_error_ = mae
        model.explained_variance_ = expl
        return rss
