"""OneVsRest — parity with ``pyspark.ml.classification.OneVsRest``.

Port of ``orange3_spark_tpu/models/one_vs_rest.py``: a k-class problem as k
binary fits of a caller-supplied base classifier, each on the same X with
the label relabelled ``y == c`` (a device op; X is shared, not copied); the
prediction is the class whose binary model is the most confident. The
confidences are the base models' own ``predict_proba`` (or
``decision_function``) columns, stacked on the host as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import DiscreteVariable, Domain
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import (
    Estimator, Model, Params, append_columns, infer_class_values,
)


@dataclasses.dataclass(frozen=True)
class OneVsRestParams(Params):
    parallelism: int = 1  # MLlib parallelism (a thread pool); the fits are
                          # queued on the device one after another anyway,
                          # so it is accepted for API parity only


def _binary_table(table: TorchTable, cls_index: int) -> TorchTable:
    """Relabel y -> 1{y == cls_index}, X untouched."""
    y_bin = (table.y == float(cls_index)).to(torch.float32)[:, None]
    domain = Domain(table.domain.attributes,
                    DiscreteVariable("_ovr_target", ("rest", "this")),
                    table.domain.metas)
    return TorchTable(domain, table.X, y_bin, table.W, table.metas, table.n_rows,
                      table.session)


def _confidence(model: Model, table: TorchTable) -> np.ndarray:
    """Per-row confidence in the positive class of a fitted binary model."""
    proba = getattr(model, "predict_proba", None)
    if proba is not None:
        return np.asarray(proba(table))[:, 1]
    dec = getattr(model, "decision_function", None)
    if dec is not None:
        return np.asarray(dec(table))
    raise TypeError(f"{type(model).__name__} exposes neither predict_proba nor "
                    "decision_function; OneVsRest cannot rank its confidence")


class OneVsRestModel(Model):
    def __init__(self, params, models, class_values):
        self.params = params
        self.models = list(models)      # k fitted binary models
        self.class_values = tuple(class_values)

    @property
    def state_pytree(self):
        return {f"class{i}": m.state_pytree for i, m in enumerate(self.models)}

    def load_state_pytree(self, state):
        for key, sub in state.items():
            self.models[int(key.removeprefix("class"))].load_state_pytree(sub)
        self._touch_serving_state()

    def _serve_state_token(self):
        return (getattr(self, "_serve_state_version", 0),
                tuple(m._serve_state_token() for m in self.models))

    def _scores(self, table: TorchTable) -> np.ndarray:
        return np.stack([_confidence(m, table) for m in self.models], axis=1)

    def predict(self, table: TorchTable) -> np.ndarray:
        return np.argmax(self._scores(table), axis=1).astype(np.float32)[: table.n_rows]

    def transform(self, table: TorchTable) -> TorchTable:
        s = self._scores(table)     # [n_rows, k]: the base models strip padding
        pred = np.zeros((table.n_pad,), np.float32)
        pred[: table.n_rows] = np.argmax(s, axis=1)[: table.n_rows]
        col = torch.from_numpy(pred).to(table.X.device)[:, None]
        return append_columns(table, [col], [DiscreteVariable("prediction", self.class_values)])


class OneVsRest(Estimator):
    ParamsCls = OneVsRestParams
    params: OneVsRestParams

    def __init__(self, classifier: Estimator, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self.classifier = classifier  # MLlib's `classifier` Param

    def _fit(self, table: TorchTable) -> OneVsRestModel:
        class_values = infer_class_values(table)
        base_params = self.classifier.params
        models = [type(self.classifier)(base_params).fit(_binary_table(table, c))
                  for c in range(len(class_values))]
        return OneVsRestModel(self.params, models, class_values)
