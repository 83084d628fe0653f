"""MultilayerPerceptronClassifier — parity with
``pyspark.ml.classification.MultilayerPerceptronClassifier``.

Port of ``orange3_spark_tpu/models/mlp.py``: sigmoid hidden layers, a
softmax output, MLlib's params. The initial weights are the reference's:
``key, k = split(key)`` a layer from ``PRNGKey(seed)``, W uniform on ±√(6 /
(fan_in + fan_out)) (``ops/prng.uniform``, bitwise JAX's), b zero. The
'l-bfgs' solver runs ``_linear.lbfgs_minimize`` on the net flattened in
the reference's leaf order (each layer's W, then b: JAX sorts dict keys and
"W" < "b"), its gradient by autograd; 'gd' is ``optax.sgd``: ``max_iter``
full-batch steps. Training takes ``torch.mm``; predictions take
``_linear.row_products`` (a row's bits depend on that row alone), so a
served bucket gives the raw bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models._linear import (
    AutogradObjective, lbfgs_minimize, row_products,
)
from orange3_spark_tpu_torch.models.base import (
    Estimator, Model, Params, append_columns, class_score_columns, infer_class_values,
    to_host,
)
from orange3_spark_tpu_torch.ops import prng


@dataclasses.dataclass(frozen=True)
class MLPParams(Params):
    layers: tuple = ()        # MLlib layers: (in, hidden..., out); () => infer (in, out)
    max_iter: int = 100       # MLlib maxIter
    tol: float = 1e-6         # MLlib tol
    seed: int = 0             # MLlib seed
    solver: str = "l-bfgs"    # MLlib solver: 'l-bfgs' | 'gd'
    step_size: float = 0.03   # MLlib stepSize (gd only)
    block_size: int = 128     # parity; the whole batch is one pass


def _init_net(layers, seed: int, device) -> list[dict]:
    key = prng.PRNGKey(seed)
    net = []
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        key, k1 = prng.split(key)
        limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
        W = prng.uniform(k1, (fan_in, fan_out), device, -limit, limit)
        net.append({"W": W, "b": torch.zeros(fan_out, dtype=torch.float32, device=device)})
    return net


def _flatten(net) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for layer in net for t in (layer["W"], layer["b"])])


def _unflatten(theta, layers) -> list[dict]:
    net, at = [], 0
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        W = theta[at:at + fan_in * fan_out].view(fan_in, fan_out)
        at += fan_in * fan_out
        net.append({"W": W, "b": theta[at:at + fan_out]})
        at += fan_out
    return net


def _forward(net, X, product=torch.mm):
    """Sigmoid hidden layers, a linear output (softmax in the loss)."""
    h = X
    for layer in net[:-1]:
        h = torch.sigmoid(product(h, layer["W"]) + layer["b"])
    return product(h, net[-1]["W"]) + net[-1]["b"]


def _fit_mlp(X, y, w, tol: float, step_size: float, *, layers: tuple, solver: str,
             max_iter: int, seed: int):
    """Returns (net, n_iter, final loss, the objective: its evaluations in
    all and by iteration)."""
    sum_w = torch.clamp_min(w.sum(), 1e-12)
    yi = y.to(torch.int64)[:, None]

    def loss_fn(theta):
        logp = torch.log_softmax(_forward(_unflatten(theta, layers), X), dim=-1)
        return (-torch.gather(logp, 1, yi)[:, 0] * w).sum() / sum_w

    theta = _flatten(_init_net(layers, seed, X.device))
    objective = AutogradObjective(loss_fn)
    if solver == "l-bfgs":
        theta, n_iter, _ = lbfgs_minimize(objective, theta, tol, max_iter)
    elif solver == "gd":
        lr = float(np.float32(step_size))
        for _ in range(max_iter):
            theta = theta - lr * objective.value_and_grad(theta)[1]
        n_iter = max_iter
    else:
        raise ValueError(f"unknown solver {solver!r}")
    return _unflatten(theta, layers), n_iter, float(objective.value(theta)), objective


class MultilayerPerceptronClassifierModel(Model):
    def __init__(self, params, net, class_values):
        self.params = params
        self.net = net
        self.class_values = tuple(class_values)

    @property
    def state_pytree(self):
        return {"net": self.net}

    def _logits(self, table: TorchTable):
        return _forward(self.net, table.X, row_products)

    def predict(self, table: TorchTable) -> np.ndarray:
        return to_host(torch.argmax(self._logits(table), dim=1).to(torch.int32),
                       table.n_rows)

    def predict_probability(self, table: TorchTable) -> np.ndarray:
        return to_host(torch.softmax(self._logits(table), dim=1), table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        cols, new_vars = class_score_columns(self._logits(table), self.class_values)
        # the reference names the probabilities by class index
        new_vars[:-1] = [ContinuousVariable(f"probability_{i}")
                         for i in range(len(self.class_values))]
        return append_columns(table, cols, new_vars)


class MultilayerPerceptronClassifier(Estimator):
    ParamsCls = MLPParams
    params: MLPParams

    def _fit(self, table: TorchTable) -> MultilayerPerceptronClassifierModel:
        p = self.params
        class_values = infer_class_values(table)
        k = len(class_values)
        d = table.n_attrs
        layers = tuple(int(x) for x in p.layers) or (d, k)
        if layers[0] != d:
            raise ValueError(f"layers[0]={layers[0]} must equal n_features={d}")
        if layers[-1] != k:
            raise ValueError(f"layers[-1]={layers[-1]} must equal n_classes={k}")
        net, n_iter, loss, objective = _fit_mlp(
            table.X, table.y, table.W, p.tol, p.step_size, layers=layers, solver=p.solver,
            max_iter=p.max_iter, seed=p.seed)
        model = MultilayerPerceptronClassifierModel(p, net, class_values)
        model.n_iter_ = n_iter
        model.final_loss_ = loss
        # the minimizer's objective evaluations, in all and by iteration
        model.n_evals_, model.iter_evals_ = objective.n_evals, tuple(objective.iter_evals)
        return model
