"""Factorization machines — parity with ``pyspark.ml.classification.FMClassifier``
and ``pyspark.ml.regression.FMRegressor``.

Port of ``orange3_spark_tpu/models/fm.py``: 2-way FMs (Rendle 2010), the
pairwise term by Rendle's O(N·d·k) identity ``0.5·Σ_f [(X v_f)² − X²·v_f²]``
(never the d² expansion). V starts at ``init_std · normal(PRNGKey(seed),
(d, k))``, the reference's draw (``ops/prng.normal``). Full-batch steps:
'adamW' is ``optax.adamw(step_size, weight_decay=0)``, the port's
``optim/sparse.adam_update`` (the zero decay adds 0·θ, which changes no
bit but a zero's sign); 'gd' is ``optax.sgd``. The reference runs the loop
as one ``lax.while_loop``; here it is a host loop reading one flag an
iteration (the relative loss change below ``tol``), at most ``max_iter``
times. The gradient is autograd's; a part the params leave out
(``fit_intercept``, ``fit_linear``) has its gradient zeroed, so it never
moves. Training takes ``torch.mm``; predictions ``_linear.row_products``
(a served bucket gives the raw bits).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, DiscreteVariable
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models._linear import row_products
from orange3_spark_tpu_torch.models.base import (
    Estimator, Model, Params, append_columns, infer_class_values, to_host,
)
from orange3_spark_tpu_torch.ops import prng
from orange3_spark_tpu_torch.optim.sparse import adam_update, init_adam_state


@dataclasses.dataclass(frozen=True)
class FMParams(Params):
    factor_size: int = 8          # MLlib factorSize
    fit_intercept: bool = True    # MLlib fitIntercept
    fit_linear: bool = True       # MLlib fitLinear
    reg_param: float = 0.0        # MLlib regParam (L2)
    init_std: float = 0.01        # MLlib initStd
    max_iter: int = 100           # MLlib maxIter
    step_size: float = 0.01       # MLlib stepSize
    tol: float = 1e-6
    solver: str = "adamW"         # MLlib solver: 'adamW' | 'gd'
    seed: int = 0
    mini_batch_fraction: float = 1.0  # parity; the full batch is used


def _fm_raw(theta, X, product=torch.mm):
    """w0 + X·w + 0.5 Σ_f [(X v_f)² − X²·v_f²]."""
    V = theta["V"]
    lin = product(X, theta["w"][:, None])[:, 0] + theta["w0"]
    xv = product(X, V)
    x2v2 = product(X * X, V * V)
    return lin + 0.5 * (xv * xv - x2v2).sum(1)


def _fit_fm(X, y, w, p: FMParams, loss_kind: str):
    """Returns (theta, final loss, n_iter)."""
    d = X.shape[1]
    dev = X.device
    sum_w = torch.clamp_min(w.sum(), 1e-12)
    init_std = float(np.float32(p.init_std))
    theta = {"w0": torch.zeros((), dtype=torch.float32, device=dev),
             "w": torch.zeros(d, dtype=torch.float32, device=dev),
             "V": init_std * prng.normal(prng.PRNGKey(p.seed), (d, p.factor_size), dev)}
    reg = float(np.float32(p.reg_param))
    lr = float(np.float32(p.step_size))

    def loss_fn(th):
        raw = _fm_raw(th, X)
        if loss_kind == "logistic":
            row = torch.logaddexp(torch.zeros_like(raw), -(2.0 * y - 1.0) * raw)
        else:   # squared
            row = 0.5 * (raw - y) ** 2
        reg_term = 0.5 * reg * ((th["w"] ** 2).sum() + (th["V"] ** 2).sum())
        return (row * w).sum() / sum_w + reg_term

    def value_and_grad(th):
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in th.items()}
            loss = loss_fn(leaves)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        g = dict(zip(leaves, grads))
        # freeze the parts the params leave out by zeroing their gradients
        if not p.fit_intercept:
            g["w0"] = torch.zeros_like(g["w0"])
        if not p.fit_linear:
            g["w"] = torch.zeros_like(g["w"])
        return loss.detach(), g

    if p.solver == "adamW":
        state = init_adam_state(theta)
    elif p.solver != "gd":
        raise ValueError(f"unknown solver {p.solver!r}")
    prev = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    n_iter = 0
    while n_iter < p.max_iter:
        loss, g = value_and_grad(theta)
        if p.solver == "adamW":
            theta, state = adam_update(theta, g, state, lr)
        else:
            theta = {k: v + lr * -g[k] for k, v in theta.items()}
        rel = (loss - prev).abs() / torch.clamp_min(loss.abs(), 1e-12)
        prev = loss
        n_iter += 1
        if bool(rel < p.tol):   # the iteration's one host read
            break
    with torch.no_grad():
        return theta, float(loss_fn(theta)), n_iter


class _FMModelBase(Model):
    def __init__(self, params, theta):
        self.params = params
        self.theta = theta  # {'w0', 'w'[d], 'V'[d, k]}

    @property
    def state_pytree(self):
        return self.theta

    def load_state_pytree(self, state):
        self.theta = dict(state)
        self._touch_serving_state()

    def _raw(self, table: TorchTable):
        return _fm_raw(self.theta, table.X, row_products)


class FMRegressorModel(_FMModelBase):
    def predict(self, table: TorchTable) -> np.ndarray:
        return to_host(self._raw(table), table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        return append_columns(table, [self._raw(table)[:, None]],
                              [ContinuousVariable("prediction")])


class FMClassifierModel(_FMModelBase):
    def __init__(self, params, theta, class_values):
        super().__init__(params, theta)
        self.class_values = tuple(class_values)

    def predict(self, table: TorchTable) -> np.ndarray:
        return to_host((self._raw(table) > 0).to(torch.int32), table.n_rows)

    def predict_probability(self, table: TorchTable) -> np.ndarray:
        p1 = torch.sigmoid(self._raw(table))
        return to_host(torch.stack([1 - p1, p1], 1), table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        raw = self._raw(table)
        return append_columns(
            table, [raw[:, None], torch.sigmoid(raw)[:, None],
                    (raw > 0).to(torch.float32)[:, None]],
            [ContinuousVariable("rawPrediction"), ContinuousVariable("probability"),
             DiscreteVariable("prediction", self.class_values)])


class FMRegressor(Estimator):
    ParamsCls = FMParams
    params: FMParams

    def _fit(self, table: TorchTable) -> FMRegressorModel:
        if table.Y is None:
            raise ValueError("FMRegressor needs a target column")
        theta, loss, n_iter = _fit_fm(table.X, table.y, table.W, self.params, "squared")
        model = FMRegressorModel(self.params, theta)
        model.n_iter_, model.final_loss_ = n_iter, loss
        return model


class FMClassifier(Estimator):
    ParamsCls = FMParams
    params: FMParams

    def _fit(self, table: TorchTable) -> FMClassifierModel:
        class_values = infer_class_values(table)
        if len(class_values) != 2:
            raise ValueError("FMClassifier is binary (MLlib parity); "
                             f"got {len(class_values)} classes")
        theta, loss, n_iter = _fit_fm(table.X, table.y, table.W, self.params, "logistic")
        model = FMClassifierModel(self.params, theta, class_values)
        model.n_iter_, model.final_loss_ = n_iter, loss
        return model
