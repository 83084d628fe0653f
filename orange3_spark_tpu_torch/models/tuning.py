"""Model selection — ``pyspark.ml.tuning`` parity: ParamGridBuilder,
CrossValidator, TrainValidationSplit.

Port of ``orange3_spark_tpu/models/tuning.py``. Folds are weight masks:
every fold sees the same padded tensors, its train and validation rows
carried in W. The fold ids are the reference's rows:
``randint(PRNGKey(seed), (n_pad,), 0, num_folds)`` from JAX's stream
(``ops/prng``), whose first n draws do not depend on the padding.
TrainValidationSplit splits by ``ops/relational.train_test_split``, the
reference's draw too.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Any, Sequence

import numpy as np
import torch

from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params, Pipeline
from orange3_spark_tpu_torch.ops import prng


class ParamGridBuilder:
    """pyspark.ml.tuning.ParamGridBuilder: the cartesian grid over params."""

    def __init__(self):
        self._grid: dict[str, Sequence[Any]] = {}

    def add_grid(self, name: str, values: Sequence[Any]) -> "ParamGridBuilder":
        self._grid[name] = list(values)
        return self

    def build(self) -> list[dict[str, Any]]:
        names = list(self._grid)
        return [dict(zip(names, c))
                for c in itertools.product(*(self._grid[n] for n in names))]


def _fields(obj) -> set:
    params = getattr(obj, "params", None)
    return set() if params is None else {f.name for f in dataclasses.fields(params)}


def _with_params(estimator: Estimator, point: dict[str, Any]) -> Estimator:
    """A shallow copy of ``estimator`` (its constructor extras kept) with the
    grid point's params. Unknown names raise. For a ``Pipeline`` the keys go
    INTO the stages (MLlib's usual CV pattern): a plain key (``"reg_param"``)
    to the LAST stage whose params declare it, ``"<stage_index>__reg_param"``
    to that stage."""
    clone = copy.copy(estimator)
    if not point:
        return clone
    if isinstance(estimator, Pipeline):
        stages = [copy.copy(s) for s in estimator.stages]
        for name, value in point.items():
            if "__" in name:
                idx_str, field = name.split("__", 1)
                try:
                    idx = int(idx_str)
                except ValueError:
                    raise ValueError(
                        f"grid key {name!r}: stage prefix must be an integer "
                        f"index ('<stage_index>__param'), got {idx_str!r}") from None
                if not 0 <= idx < len(stages):
                    raise ValueError(f"grid key {name!r}: no pipeline stage {idx}")
                if field not in _fields(stages[idx]):
                    raise ValueError(f"grid key {name!r}: stage {idx} "
                                     f"({type(stages[idx]).__name__}) has no param {field!r}")
            else:
                field = name
                matches = [i for i, s in enumerate(stages) if field in _fields(s)]
                if not matches:
                    raise ValueError(
                        f"grid param {name!r} matches no pipeline stage; stages: "
                        f"{[type(s).__name__ for s in stages]}")
                idx = matches[-1]
            stages[idx].params = stages[idx].params.replace(**{field: value})
        clone.stages = stages
        return clone
    clone.params = estimator.params.replace(**point)
    return clone


def _metric_larger_better(evaluator) -> bool:
    metric = (getattr(evaluator.params, "metric_name", "")
              or getattr(evaluator, "default_metric", ""))
    return metric not in ("rmse", "mse", "mae")


def _best(metrics, larger_better: bool) -> int:
    return int(np.argmax(metrics) if larger_better else np.argmin(metrics))


@dataclasses.dataclass(frozen=True)
class CrossValidatorParams(Params):
    num_folds: int = 3   # MLlib numFolds
    seed: int = 0
    parallel_folds: bool = True  # reserved (the folds share one padded layout)


class CrossValidatorModel(Model):
    def __init__(self, params, best_model: Model, best_params: dict,
                 avg_metrics: list[float]):
        self.params = params
        self.best_model = best_model
        self.best_params = best_params
        self.avg_metrics = avg_metrics  # one a grid point (MLlib avgMetrics)

    @property
    def state_pytree(self):
        return self.best_model.state_pytree

    def load_state_pytree(self, state):
        self.best_model.load_state_pytree(state)
        self._touch_serving_state()

    def _serve_state_token(self):
        return (getattr(self, "_serve_state_version", 0), self.best_model._serve_state_token())

    def transform(self, table: TorchTable) -> TorchTable:
        return self.best_model.transform(table)


class CrossValidator(Estimator):
    """estimator + param grid + evaluator -> the best point refitted on all
    the data (MLlib CV)."""

    ParamsCls = CrossValidatorParams

    def __init__(self, estimator: Estimator, param_grid: list[dict], evaluator,
                 num_folds: int = 3, seed: int = 0):
        super().__init__(CrossValidatorParams(num_folds=num_folds, seed=seed))
        self.estimator = estimator
        self.param_grid = param_grid or [{}]
        self.evaluator = evaluator

    def _fold_masks(self, table: TorchTable) -> torch.Tensor:
        """The fold id of every padded row, i32[n_pad]."""
        p = self.params
        return prng.randint(prng.PRNGKey(p.seed), table.n_pad, 0, p.num_folds,
                            table.W.device)

    def _fit(self, table: TorchTable) -> CrossValidatorModel:
        p = self.params
        fold_of = self._fold_masks(table)
        avg_metrics: list[float] = []
        for point in self.param_grid:
            est = _with_params(self.estimator, point)
            scores = []
            for f in range(p.num_folds):
                train = table.with_weights(torch.where(fold_of != f, table.W, 0.0))
                val = table.with_weights(torch.where(fold_of == f, table.W, 0.0))
                scores.append(self.evaluator.evaluate(est.fit(train).transform(val)))
            avg_metrics.append(float(np.mean(scores)))
        best_params = self.param_grid[_best(avg_metrics,
                                            _metric_larger_better(self.evaluator))]
        # refit on ALL the data (MLlib)
        best_model = _with_params(self.estimator, best_params).fit(table)
        return CrossValidatorModel(p, best_model, best_params, avg_metrics)


@dataclasses.dataclass(frozen=True)
class TrainValidationSplitParams(Params):
    train_ratio: float = 0.75  # MLlib trainRatio
    seed: int = 0


class TrainValidationSplit(Estimator):
    ParamsCls = TrainValidationSplitParams

    def __init__(self, estimator: Estimator, param_grid: list[dict], evaluator,
                 train_ratio: float = 0.75, seed: int = 0):
        super().__init__(TrainValidationSplitParams(train_ratio=train_ratio, seed=seed))
        self.estimator = estimator
        self.param_grid = param_grid or [{}]
        self.evaluator = evaluator

    def _fit(self, table: TorchTable) -> CrossValidatorModel:
        from orange3_spark_tpu_torch.ops.relational import train_test_split

        p = self.params
        train, val = train_test_split(table, 1.0 - p.train_ratio, p.seed)
        metrics = [float(self.evaluator.evaluate(
            _with_params(self.estimator, point).fit(train).transform(val)))
            for point in self.param_grid]
        best_params = self.param_grid[_best(metrics, _metric_larger_better(self.evaluator))]
        best_model = _with_params(self.estimator, best_params).fit(table)
        return CrossValidatorModel(p, best_model, best_params, metrics)
