"""GeneralizedLinearRegression — parity with
``pyspark.ml.regression.GeneralizedLinearRegression``.

Port of ``orange3_spark_tpu/models/glm.py``. MLlib's IRLS: each iteration
is one weighted least-squares solve, the Gram ``Xᵀ·diag(ω)·X`` with the
intercept column folded in and ``Xᵀ·diag(ω)·z`` (``torch.mm``, as the
reference leaves them to XLA's dot), then a (d+1)² Cholesky solve with the
reference's ``+1e-8·I`` (``torch.linalg.cholesky_ex``, which reads no
status on the host, and ``cholesky_solve``). The reference runs the loop as
one ``lax.while_loop``; here it is a host loop that reads one flag an
iteration (the relative deviance change below ``tol``), at most
``max_iter`` times. Every family and link of the reference; the summary
(deviance, null deviance, Pearson dispersion, AIC on the host with scipy as
the reference, and for an unregularised fit the standard errors, t-values
and p-values through ``ops/stats``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable
from orange3_spark_tpu_torch.core.fmath import sqrt32
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models._linear import dense_logits
from orange3_spark_tpu_torch.models.base import (
    Estimator, Model, Params, append_columns, concrete_or_none, to_host,
)
from orange3_spark_tpu_torch.ops.stats import two_sided_t_pvalue, two_sided_z_pvalue

CANONICAL_LINK = {
    "gaussian": "identity",
    "binomial": "logit",
    "poisson": "log",
    "gamma": "inverse",
    "tweedie": "log",
}
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearRegressionParams(Params):
    family: str = "gaussian"     # MLlib family
    link: str = ""               # MLlib link; "" => canonical for family
    max_iter: int = 25           # MLlib maxIter
    tol: float = 1e-6            # MLlib tol (relative deviance change)
    reg_param: float = 0.0       # MLlib regParam (L2 on coef, not intercept)
    fit_intercept: bool = True
    variance_power: float = 0.0  # MLlib variancePower (tweedie)
    link_power: float | None = None  # MLlib linkPower; None => 1-variancePower (tweedie)


def _link_fns(link: str, link_power: float):
    """(g(mu) = eta, g⁻¹(eta) = mu, dmu/deta) of the named link."""
    if link == "identity":
        return (lambda m: m, lambda e: e, torch.ones_like)
    if link == "log":
        return (torch.log, torch.exp, torch.exp)
    if link == "logit":
        inv = torch.sigmoid
        return (lambda m: torch.log(m / (1 - m)), inv, lambda e: inv(e) * (1 - inv(e)))
    if link == "inverse":
        return (lambda m: 1.0 / m, lambda e: 1.0 / e, lambda e: -1.0 / (e * e))
    if link == "sqrt":
        return (sqrt32, lambda e: e * e, lambda e: 2.0 * e)
    if link == "probit":
        return (torch.special.ndtri, torch.special.ndtr,
                lambda e: torch.exp(-0.5 * e * e) * _INV_SQRT_2PI)
    if link == "cloglog":
        return (lambda m: torch.log(-torch.log(1 - m)),
                lambda e: 1.0 - torch.exp(-torch.exp(e)),
                lambda e: torch.exp(e - torch.exp(e)))
    if link == "power":  # tweedie with an arbitrary linkPower
        lp = link_power
        if lp == 0.0:
            return (torch.log, torch.exp, torch.exp)
        return (lambda m: m ** lp, lambda e: e ** (1.0 / lp),
                lambda e: (1.0 / lp) * e ** (1.0 / lp - 1.0))
    raise ValueError(f"unknown link {link!r}")


def _variance_fn(family: str, variance_power: float):
    if family == "gaussian":
        return torch.ones_like
    if family == "binomial":
        return lambda m: m * (1 - m)
    if family == "poisson":
        return lambda m: m
    if family == "gamma":
        return lambda m: m * m
    if family == "tweedie":
        return lambda m: m ** variance_power
    raise ValueError(f"unknown family {family!r}")


def _deviance_fn(family: str, variance_power: float):
    """Unit deviance d(y, mu); the total deviance is Σ w·d."""
    if family == "gaussian":
        return lambda y, m: (y - m) ** 2
    if family == "binomial":
        def dev(y, m):
            m = torch.clamp(m, 1e-10, 1 - 1e-10)
            return 2.0 * (torch.where(y > 0, y * torch.log(y / m), 0.0)
                          + torch.where(y < 1, (1 - y) * torch.log((1 - y) / (1 - m)), 0.0))
        return dev
    if family == "poisson":
        return lambda y, m: 2.0 * (torch.where(y > 0, y * torch.log(y / m), 0.0) - (y - m))
    if family == "gamma":
        # y > 0 guard: padded rows carry y = 0, w = 0 (log would give inf,
        # and 0·inf a NaN deviance)
        return lambda y, m: 2.0 * (
            torch.where(y > 0, -torch.log(torch.clamp_min(y, 1e-30) / m), 0.0) + (y - m) / m)
    if family == "tweedie":
        p = variance_power
        if p == 0.0:
            return lambda y, m: (y - m) ** 2
        if p == 1.0:
            return _deviance_fn("poisson", 0.0)
        if p == 2.0:
            return _deviance_fn("gamma", 0.0)

        def dev(y, m):
            yp = torch.clamp_min(y, 0.0)
            t1 = torch.where(yp > 0, yp ** (2 - p) / ((1 - p) * (2 - p)), 0.0)
            return 2.0 * (t1 - yp * m ** (1 - p) / (1 - p) + m ** (2 - p) / (2 - p))
        return dev
    raise ValueError(family)


def _mu_init(family: str, y):
    """MLlib's IRLS starting mean."""
    if family == "binomial":
        return (y + 0.5) / 2.0
    if family in ("poisson", "gamma", "tweedie"):
        return torch.clamp_min(y, 0.1)
    return y    # gaussian: eta0 = y


class IRLSResult:
    """The fit's coefficients (with the intercept last), deviance, null
    deviance, Pearson statistic, iterations, Σw and the covariance's
    diagonal (None for a regularised fit)."""

    def __init__(self, beta, dev, null_dev, pearson, n_iter, sum_w, cov_diag):
        self.beta, self.dev, self.null_dev, self.pearson = beta, dev, null_dev, pearson
        self.n_iter, self.sum_w, self.cov_diag = n_iter, sum_w, cov_diag


def _irls(X, y, w, reg: float, tol: float, *, family: str, link: str, fit_intercept: bool,
          max_iter: int, variance_power: float, link_power: float,
          want_inference: bool = True) -> IRLSResult:
    n, d = X.shape
    link_f, link_inv, dmu_deta = _link_fns(link, link_power)
    var_f = _variance_fn(family, variance_power)
    dev_f = _deviance_fn(family, variance_power)
    Xa = torch.cat([X, torch.ones((n, 1), dtype=X.dtype, device=X.device)], 1) \
        if fit_intercept else X
    da = Xa.shape[1]
    sum_w = torch.clamp_min(w.sum(), 1e-12)
    # the coefficients are regularised, never the intercept (MLlib)
    reg_diag = torch.cat([torch.ones(d, dtype=X.dtype, device=X.device),
                          torch.zeros(da - d, dtype=X.dtype, device=X.device)])
    eye = torch.eye(da, dtype=X.dtype, device=X.device)
    reg32 = float(np.float32(reg))

    def deviance(beta):
        return (w * dev_f(y, link_inv(Xa @ beta))).sum()

    def irls_weights(eta, mu):
        """The working weights w·g²/V(mu), one helper for the coefficients
        and the covariance, so the standard errors can never use another
        weight than the coefficients they describe."""
        g = dmu_deta(eta)
        return g, w * g * g / torch.clamp_min(var_f(mu), 1e-12)

    def cho_solve_gram(gram, rhs):
        L, _ = torch.linalg.cholesky_ex(gram + 1e-8 * eye)
        return torch.cholesky_solve(rhs, L)

    def wls(eta, mu):
        g, irls_w = irls_weights(eta, mu)
        z = eta + (y - mu) / torch.where(g.abs() > 1e-12, g, 1e-12)
        Xw = Xa * irls_w[:, None]
        gram = Xw.T @ Xa + (reg32 * sum_w) * torch.diag(reg_diag)
        return cho_solve_gram(gram, (Xw.T @ z)[:, None])[:, 0]

    mu0 = _mu_init(family, y)
    beta = wls(link_f(mu0), mu0)
    prev_dev = deviance(beta)
    n_iter = 0
    while n_iter < max_iter:
        eta = Xa @ beta
        beta = wls(eta, link_inv(eta))
        new_dev = deviance(beta)
        rel = (new_dev - prev_dev).abs() / torch.clamp_min(new_dev.abs(), 1e-12)
        prev_dev = new_dev
        n_iter += 1
        if bool(rel < tol):     # the iteration's one host read
            break
    # null deviance: the intercept-only model's mean, the weighted mean of y
    ybar = (w * y).sum() / sum_w
    null_dev = (w * dev_f(y, ybar)).sum()
    # Pearson's statistic Σ w·(y - mu)²/V(mu), MLlib's dispersion base
    eta_hat = Xa @ beta
    mu_hat = link_inv(eta_hat)
    pearson = (w * (y - mu_hat) ** 2 / torch.clamp_min(var_f(mu_hat), 1e-12)).sum()
    cov_diag = None
    if want_inference:
        # the unscaled covariance's diagonal, diag(inv(Xᵀ W_irls X)) at the
        # optimum, the base of MLlib's coefficientStandardErrors
        _, w_hat = irls_weights(eta_hat, mu_hat)
        cov_diag = torch.diagonal(cho_solve_gram((Xa * w_hat[:, None]).T @ Xa, eye))
    return IRLSResult(beta, prev_dev, null_dev, pearson, n_iter, sum_w, cov_diag)


class GeneralizedLinearRegressionModel(Model):
    def __init__(self, params, coef, intercept, link: str, link_power: float = 1.0):
        self.params = params
        self.coef = coef            # f32[d]
        self.intercept = intercept  # f32[]
        self.link = link
        self.link_power = link_power  # resolved (params.link_power may be None)
        self.n_iter_: int | None = None
        self.deviance_: float | None = None       # summary.deviance
        self.null_deviance_: float | None = None  # summary.nullDeviance
        self.dispersion_: float | None = None     # summary.dispersion
        self.aic_: float | None = None
        # summary inference stats (unregularised IRLS only, as MLlib; None
        # when reg_param > 0), ordered [coefficients..., intercept]; a z
        # test for binomial and poisson, a t test (df = n - rank) otherwise
        self.coefficient_standard_errors_ = None
        self.t_values_ = None
        self.p_values_ = None

    @property
    def state_pytree(self):
        return {"coef": self.coef, "intercept": self.intercept}

    def _eta(self, X):
        return dense_logits(X, self.coef[:, None])[:, 0] + self.intercept

    def _mu(self, X):
        return _link_fns(self.link, self.link_power)[1](self._eta(X))

    def predict(self, table: TorchTable) -> np.ndarray:
        """The mean mu = g⁻¹(x·b): MLlib's predictionCol."""
        return to_host(self._mu(table.X), table.n_rows)

    def predict_link(self, table: TorchTable) -> np.ndarray:
        """The linear predictor eta: MLlib's linkPredictionCol."""
        return to_host(self._eta(table.X), table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        eta = self._eta(table.X)
        mu = _link_fns(self.link, self.link_power)[1](eta)
        return append_columns(table, [mu[:, None], eta[:, None]],
                              [ContinuousVariable("prediction"),
                               ContinuousVariable("linkPrediction")])


class GeneralizedLinearRegression(Estimator):
    ParamsCls = GeneralizedLinearRegressionParams
    params: GeneralizedLinearRegressionParams

    def _fit(self, table: TorchTable) -> GeneralizedLinearRegressionModel:
        p = self.params
        if p.family not in CANONICAL_LINK:
            raise ValueError(f"unknown family {p.family!r}")
        link = p.link or CANONICAL_LINK[p.family]
        if p.family == "tweedie" and not p.link:
            link = "power"
        if table.Y is None:
            raise ValueError("GeneralizedLinearRegression needs a target column")
        # MLlib: linkPower defaults to 1 - variancePower for tweedie
        if p.link_power is not None:
            link_power = float(p.link_power)
        elif p.family == "tweedie":
            link_power = 1.0 - p.variance_power
        else:
            link_power = 1.0
        r = _irls(table.X, table.y, table.W, p.reg_param, p.tol, family=p.family, link=link,
                  fit_intercept=p.fit_intercept, max_iter=p.max_iter,
                  variance_power=p.variance_power, link_power=link_power,
                  want_inference=(p.reg_param == 0.0))
        d = table.n_attrs
        intercept = (r.beta[d] if p.fit_intercept
                     else torch.zeros((), dtype=torch.float32, device=r.beta.device))
        model = GeneralizedLinearRegressionModel(p, r.beta[:d], intercept, link, link_power)
        model.n_iter_ = r.n_iter
        model.deviance_ = concrete_or_none(r.dev)
        model.null_deviance_ = concrete_or_none(r.null_dev)
        # dispersion (MLlib): 1 for binomial and poisson, else Pearson's
        # statistic over the residual degrees of freedom
        rank = d + (1 if p.fit_intercept else 0)
        fixed_disp = p.family in ("binomial", "poisson")
        disp = (torch.ones((), dtype=torch.float32, device=r.beta.device) if fixed_disp
                else r.pearson / torch.clamp_min(r.sum_w - rank, 1.0))
        model.dispersion_ = 1.0 if fixed_disp else concrete_or_none(disp)
        n_eff = concrete_or_none(r.sum_w)
        model.aic_ = (None if n_eff is None or model.deviance_ is None
                      else _aic(p.family, model.deviance_, n_eff, rank, table, model))
        if p.reg_param == 0.0:
            # MLlib's summary inference stats exist only for the
            # unregularised fit; [coefficients..., intercept last]
            se = sqrt32(r.cov_diag[:rank] * disp)
            tval = r.beta[:rank] / torch.clamp_min(se, 1e-30)
            pval = (two_sided_z_pvalue(tval) if fixed_disp
                    else two_sided_t_pvalue(tval, r.sum_w - rank))
            model.coefficient_standard_errors_ = se
            model.t_values_ = tval
            model.p_values_ = pval
        return model


def _aic(family: str, dev: float, n: float, rank: int, table: TorchTable, model) -> float:
    """-2·loglik + 2·k by family (MLlib summary.aic), on the host. Tweedie
    has no closed-form likelihood: nan, where Spark raises."""
    from scipy.special import gammaln

    mu = model.predict(table)
    w = table.W[: table.n_rows].cpu().numpy()
    y = table.y[: table.n_rows].cpu().numpy()
    if family == "gaussian":
        ll = -0.5 * n * (np.log(2 * np.pi * (dev / n)) + 1.0)
        return float(-2 * ll + 2 * (rank + 1))
    if family == "binomial":
        # clip in float64: in float32 1 - 1e-10 is 1.0 and log(1 - mu) log(0)
        mu_c = np.clip(np.asarray(mu, np.float64), 1e-10, 1 - 1e-10)
        ll = np.sum(w * (y * np.log(mu_c) + (1 - y) * np.log(1 - mu_c)))
        return float(-2 * ll + 2 * rank)
    if family == "poisson":
        ll = np.sum(w * (y * np.log(np.maximum(mu, 1e-30)) - mu - gammaln(y + 1)))
        return float(-2 * ll + 2 * rank)
    if family == "gamma":
        # shape k = 1/dispersion, the deviance-based estimate (Spark)
        shape = 1.0 / max(dev / max(n - rank, 1.0), 1e-12)
        yp = np.maximum(y, 1e-30)
        m = np.maximum(mu, 1e-30)
        ll = np.sum(w * (shape * np.log(shape * yp / m) - shape * yp / m
                         - np.log(yp) - gammaln(shape)))
        return float(-2 * ll + 2 * (rank + 1))
    return float("nan")
