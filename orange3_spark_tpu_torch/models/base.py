"""MLlib-style Estimator / Transformer protocol of the PyTorch package.

Port of ``orange3_spark_tpu/models/base.py``: params are frozen dataclasses
(hashable, introspectable through ``dataclasses.fields``), ``Estimator.fit``
returns a ``Model`` that holds its fitted state as device tensors and
records the fit's wall time in ``last_fit_metrics``. Every subclass's
``transform``/``predict`` routes through the serving path (serve/) when a
``ServingContext`` is active.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import (
    ContinuousVariable, DiscreteVariable, Domain,
)
from orange3_spark_tpu_torch.core.table import TorchTable


def _serve_routed(kind: str, raw_fn):
    """Route a subclass-defined ``transform``/``predict`` through the
    serving path (serve/context.py) when a ServingContext is active. With
    no active context this is one None check of overhead; inside a serving
    build the per-thread reentrancy guard goes straight to the raw
    method."""

    @functools.wraps(raw_fn)
    def wrapper(self, *args, **kwargs):
        from orange3_spark_tpu_torch.serve.context import route

        return route(kind, raw_fn, self, *args, **kwargs)

    wrapper.__serve_raw__ = raw_fn
    return wrapper


@dataclasses.dataclass(frozen=True)
class Params:
    """Base for estimator hyper-parameter dataclasses.

    ``describe()`` yields (name, type, default) triples — the introspection
    surface a widget generator consumes, playing the role of
    ``pyspark.ml.param.Param`` metadata.
    """

    def replace(self, **kwargs) -> "Params":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def describe(cls) -> list[tuple[str, type, Any]]:
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


class HasParams:
    """The one params-dataclass constructor: subclasses declare ``ParamsCls``
    and get ``Cls(**kwargs)`` / ``Cls(params)`` / ``Cls(params, override=...)``."""

    ParamsCls: type[Params] | None = None

    def __init__(self, params: Params | None = None, **kwargs):
        if self.ParamsCls is None:
            if params is not None or kwargs:
                raise TypeError(f"{type(self).__name__} takes no params")
            return
        if params is None:
            params = self.ParamsCls(**kwargs)
        elif kwargs:
            params = params.replace(**kwargs)
        self.params = params


class Transformer(HasParams):
    """transform(table) -> table.

    Every subclass-defined ``transform``/``predict`` is wrapped at class
    creation to route through the serving subsystem (serve/) when a
    ``ServingContext`` is active — shape-bucketed padding, the cache of
    bucket programs, optional micro-batching. Without a context the raw
    method runs untouched."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for kind in ("transform", "predict"):
            fn = cls.__dict__.get(kind)
            if fn is not None and callable(fn) and not hasattr(fn, "__serve_raw__"):
                setattr(cls, kind, _serve_routed(kind, fn))

    def transform(self, table: TorchTable) -> TorchTable:
        raise NotImplementedError

    def __call__(self, table: TorchTable) -> TorchTable:
        return self.transform(table)


class Model(Transformer):
    """A fitted model: hyper-params + fitted state as device tensors,
    exposed through ``state_pytree``."""

    params: Params

    @property
    def state_pytree(self) -> dict[str, Any]:
        raise NotImplementedError

    def _touch_serving_state(self) -> None:
        """Move the serving fingerprint after the state's tensors were
        replaced: a bucket program reads the tensors it was built with
        (serve/context folds this version into the model fingerprint), so
        every ``load_state_pytree`` — base or override — must call this.
        An in-place update of the same tensors needs no call: the next
        replay reads it."""
        self._serve_state_version = getattr(self, "_serve_state_version", 0) + 1

    def _serve_state_token(self):
        """The version token serve/context folds into the fingerprint."""
        return getattr(self, "_serve_state_version", 0)

    def load_state_pytree(self, state: dict[str, Any]) -> None:
        for k, v in state.items():
            setattr(self, k, v)
        self._touch_serving_state()


class Estimator(HasParams):
    """fit(table) -> Model.  Subclasses define ``ParamsCls`` and ``_fit``."""

    ParamsCls: type[Params] = Params

    def __init__(self, params: Params | None = None, **kwargs):
        super().__init__(params, **kwargs)
        self.last_fit_metrics: dict[str, float] = {}

    def fit(self, table: TorchTable) -> Model:
        t0 = time.perf_counter()
        model = self._fit(table)
        # the device runs behind the host: time the work, not its enqueue
        table.session.synchronize()
        dt = time.perf_counter() - t0
        self.last_fit_metrics = {
            "fit_seconds": dt,
            "rows_per_sec_per_chip": table.n_rows / dt / table.session.n_devices,
        }
        return model

    def _fit(self, table: TorchTable) -> Model:
        raise NotImplementedError

    def fit_transform(self, table: TorchTable) -> TorchTable:
        return self.fit(table).transform(table)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}({self.params})"


def infer_class_values(table: TorchTable) -> tuple[str, ...]:
    """Class labels from the domain, or '0'..'max(y)' when untyped.

    The fallback max only looks at LIVE rows (W > 0) — filtered rows' labels
    must not inflate the class count.
    """
    cvar = table.domain.class_var
    if isinstance(cvar, DiscreteVariable) and cvar.values:
        return tuple(cvar.values)
    y_max = torch.where(table.W > 0, table.y, 0.0).max()
    return tuple(str(i) for i in range(int(y_max.item()) + 1))


def append_columns(table: TorchTable, cols, new_vars) -> TorchTable:
    """``table`` with columns appended to X and variables to its domain."""
    new_domain = Domain(list(table.domain.attributes) + list(new_vars),
                        table.domain.class_vars, table.domain.metas)
    return table.with_X(torch.cat([table.X, *cols], dim=1), new_domain)


def classification_columns(probs, class_values):
    """Probability columns plus the argmax prediction, and their variables."""
    pred = torch.argmax(probs, dim=1).to(torch.float32)
    new_vars = [ContinuousVariable(f"probability_{c}") for c in class_values]
    new_vars.append(DiscreteVariable("prediction", class_values))
    return [probs, pred[:, None]], new_vars


def to_host(x: torch.Tensor, n_rows: int) -> np.ndarray:
    """First ``n_rows`` of a device result as a numpy array."""
    return x[:n_rows].cpu().numpy()
