"""MLlib-style Estimator / Transformer protocol of the PyTorch package.

Port of ``orange3_spark_tpu/models/base.py``: params are frozen dataclasses
(hashable, introspectable through ``dataclasses.fields``), ``Estimator.fit``
returns a ``Model`` that holds its fitted state as device tensors and
records the fit's wall time in ``last_fit_metrics``. Every subclass's
``transform``/``predict`` routes through the serving path (serve/) when a
``ServingContext`` is active. A transformer pickles its tensors as numpy arrays;
they come back on the active session's device. ``Pipeline`` chains
estimators and transformers (pyspark.ml.Pipeline).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import (
    ContinuousVariable, DiscreteVariable, Domain,
)
from orange3_spark_tpu_torch.core.session import TorchSession
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


_STAGING = threading.local()


@contextlib.contextmanager
def staging():
    """Mark this thread's fits as running inside a staged refit
    (workflow/staging.py ``refit=True``). A fit that can run without
    reading the device from the host takes its device-pure branch here
    (KMeans' device init and fixed-trip Lloyd loop), so that the staged
    program can be captured as a CUDA graph. The flag, not whether a
    capture is running, picks the branch: the CPU and the card take the
    same one."""
    _STAGING.depth = getattr(_STAGING, "depth", 0) + 1
    try:
        yield
    finally:
        _STAGING.depth -= 1


def staging_active() -> bool:
    return getattr(_STAGING, "depth", 0) > 0


def concrete_or_none(x, cast=float):
    """``cast(x)`` for a fit's diagnostic scalars (``n_iter_``,
    ``training_cost_``), ``None`` inside a staged refit: reading them
    would wait for the device, which a captured graph cannot do, and the
    honest value there is "not available"."""
    if staging_active():
        return None
    return cast(x)


class _HostTensor:
    """A tensor's values in a pickle: numpy, off the device."""

    __slots__ = ("array",)

    def __init__(self, array: np.ndarray):
        self.array = array


def _map_leaves(obj, fn: Callable):
    """``fn`` on every leaf of nested dicts, lists and tuples (named
    tuples, such as a tree's arrays, keep their type)."""
    if isinstance(obj, dict):
        return {k: _map_leaves(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_leaves(v, fn) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_leaves(v, fn) for v in obj)
    return fn(obj)


class Transformer(HasParams):
    """transform(table) -> table.

    Every subclass-defined ``transform``/``predict`` is wrapped at class
    creation to route through the serving subsystem (serve/) when a
    ``ServingContext`` is active — shape-bucketed padding, the cache of
    bucket programs, optional micro-batching. Without a context the raw
    method runs untouched.

    Pickling copies every tensor (also inside dicts, lists and tuples) to
    numpy, so a pickle is portable between hosts and devices; unpickled,
    the tensors are on the active session's device."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for kind in ("transform", "predict"):
            fn = cls.__dict__.get(kind)
            if fn is not None and callable(fn) and not hasattr(fn, "__serve_raw__"):
                setattr(cls, kind, _serve_routed(kind, fn))

    #: whether ``transform`` runs without reading the device from the host,
    #: so that a staged program (workflow/staging.py) can capture it in a
    #: CUDA graph; a transform that checks its input on the host says False
    staged_capturable: bool = True

    def transform(self, table: TorchTable) -> TorchTable:
        raise NotImplementedError

    def __call__(self, table: TorchTable) -> TorchTable:
        return self.transform(table)

    def __getstate__(self):
        return _map_leaves(dict(self.__dict__), lambda x: _HostTensor(
            x.detach().cpu().numpy()) if isinstance(x, torch.Tensor) else x)

    def __setstate__(self, state):
        device = TorchSession.active().device
        self.__dict__.update(_map_leaves(state, lambda x: torch.from_numpy(
            x.array).to(device) if isinstance(x, _HostTensor) else x))

    def __copy__(self):
        """A shallow copy shares the tensors where they lie (``copy.copy``
        would otherwise go through the pickle state, to the host and back)."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        return new


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

    @property
    def staged_fit_capturable(self) -> bool:
        """Whether fit + transform run under ``staging()`` without reading
        the device from the host, so a staged refit can capture them in a
        CUDA graph. False (the default) runs the node eagerly on the
        device between captured segments."""
        return False

    #: whether the fit folds its sums over a gang's data-parallel ranks; an
    #: estimator without that fold raises on such a session
    #: (``TorchSession.require_fold``) rather than fit its local rows alone
    gang_fold = False

    def fit(self, table: TorchTable) -> Model:
        if not self.gang_fold:
            table.session.require_fold(type(self).__name__)
        if staging_active():
            # inside a staged refit: no wall clock, no wait for the device
            return self._fit(table)
        from orange3_spark_tpu_torch.obs.context import trace_scope
        from orange3_spark_tpu_torch.obs.trace import refreshed_enabled as obs_enabled
        from orange3_spark_tpu_torch.obs.trace import span

        # the outer obs bracket rides the OTPU_OBS kill-switch (its
        # counter snapshots are its only cost). unique=True: a streaming
        # _fit's fit_stream opens its own richer "fit" span — only the
        # outermost is recorded, so traces never show fit ⊃ fit
        report = None
        if obs_enabled():
            from orange3_spark_tpu_torch.obs.report import RunReport

            report = RunReport("fit", estimator=type(self).__name__, n_rows=table.n_rows)
        t0 = time.perf_counter()
        # the fit's run id is minted here (reused, not shadowed, by a
        # streaming _fit's own @traced("fit") entry), so every span and
        # typed anomaly under this fit carries one identity
        with trace_scope("fit", reuse=True):
            with span("fit", unique=True, estimator=type(self).__name__):
                model = self._fit(table)
                # the device runs behind the host: time the work, not its
                # enqueue
                table.session.synchronize()
        dt = time.perf_counter() - t0
        self.last_fit_metrics = {
            "fit_seconds": dt,
            "rows_per_sec_per_chip": table.n_rows / dt / table.session.n_devices,
        }
        # a streaming _fit already attached its richer fit_stream report:
        # the outer bracket must not clobber it
        if (report is not None and isinstance(model, Model)
                and getattr(model, "run_report_", None) is None):
            model.run_report_ = report.finish()
        return model

    def _fit(self, table: TorchTable) -> Model:
        raise NotImplementedError

    def fit_transform(self, table: TorchTable) -> TorchTable:
        return self.fit(table).transform(table)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}({self.params})"


class Pipeline(Estimator):
    """Chain of estimators/transformers (pyspark.ml.Pipeline): each
    estimator is fit on the table the stages before it transformed."""

    gang_fold = True            # each stage's own fit checks its fold

    def __init__(self, stages: Sequence[Estimator | Transformer]):
        super().__init__(Params())
        self.stages = list(stages)

    def _fit(self, table: TorchTable) -> "PipelineModel":
        fitted: list[Transformer] = []
        for stage in self.stages:
            if isinstance(stage, Estimator):
                stage = stage.fit(table)
            fitted.append(stage)
            table = stage.transform(table)
        return PipelineModel(fitted)


class PipelineModel(Model):
    def __init__(self, stages: Sequence[Transformer]):
        self.params = Params()
        self.stages = list(stages)

    def transform(self, table: TorchTable) -> TorchTable:
        for stage in self.stages:
            table = stage.transform(table)
        return table

    @property
    def state_pytree(self) -> dict[str, Any]:
        return {f"stage{i}": s.state_pytree for i, s in enumerate(self.stages)
                if isinstance(s, Model)}

    def load_state_pytree(self, state: dict[str, Any]) -> None:
        for key, sub in state.items():
            idx = int(key.removeprefix("stage"))
            stage = self.stages[idx]
            if not isinstance(stage, Model):
                raise ValueError(f"checkpoint has state for non-model stage {idx}")
            stage.load_state_pytree(sub)
        # the pipeline itself can be the served object (its bucket programs
        # read the stages' state), so its fingerprint must move too
        self._touch_serving_state()

    def _serve_state_token(self):
        return (getattr(self, "_serve_state_version", 0),
                tuple(s._serve_state_token() for s in self.stages
                      if isinstance(s, Model)))


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


def class_score_columns(scores, class_values):
    """Softmax probability columns of per-class scores plus the argmax of
    the scores (not of the rounded probabilities) as the prediction, and
    their variables."""
    pred = torch.argmax(scores, dim=1).to(torch.float32)
    new_vars = [ContinuousVariable(f"probability_{c}") for c in class_values]
    new_vars.append(DiscreteVariable("prediction", tuple(class_values)))
    return [torch.softmax(scores, dim=-1), pred[:, None]], new_vars


def predictions_to_numpy(table: TorchTable, column: str = "prediction") -> np.ndarray:
    """One prediction column on the host, padding stripped.

    Padding is stripped by the validity mask, not only by ``n_rows``: a
    bucket-padded table whose caller did not track the logical row count
    (``n_rows == n_pad``) still has W == 0 on every pad row, so the
    trailing zero-weight run is trimmed too. Interior zero-weight
    (filtered) rows are logical rows and stay.

    Carve-out: on a table with no padding a trailing run of filtered rows
    cannot be told from padding, and is trimmed. A caller that filters
    trailing rows and needs them back tracks the logical row count
    (``n_rows < n_pad``): then every logical row is returned."""
    col = table.column(column)[: table.n_rows].cpu().numpy()
    if table.n_rows < table.n_pad:
        return col
    live = np.flatnonzero(table.W[: table.n_rows].cpu().numpy() > 0)
    if live.size == 0:
        return col[:0]
    return col[: int(live[-1]) + 1]


def to_host(x: torch.Tensor, n_rows: int) -> np.ndarray:
    """First ``n_rows`` of a device result as a numpy array."""
    return x[:n_rows].cpu().numpy()
