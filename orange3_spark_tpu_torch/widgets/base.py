"""Headless widget protocol — the OWSpark* widget layer without Qt.

Port of ``orange3_spark_tpu/widgets/base.py`` (pure Python). A widget
declares named, typed input and output signals; its settings are the
estimator's frozen params dataclass (the introspection surface a GUI binds
to); ``process()`` is a pure function of (inputs, settings) returning its
output signals. That purity is what lets the workflow graph stage a data
path into captured CUDA graphs (workflow/staging.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from orange3_spark_tpu_torch.models.base import Params


@dataclasses.dataclass(frozen=True)
class Input:
    name: str
    type: type | None = None
    required: bool = True


@dataclasses.dataclass(frozen=True)
class Output:
    name: str
    type: type | None = None


class Widget:
    """Base headless widget. Subclasses declare:

    * ``name``     — registry key (stable across serialization)
    * ``inputs``   — tuple[Input, ...]
    * ``outputs``  — tuple[Output, ...]
    * ``ParamsCls``— settings dataclass (plain ``Params`` for none)
    * ``process(**inputs) -> dict[output_name, value]``
    """

    name: str = "widget"
    inputs: tuple[Input, ...] = ()
    outputs: tuple[Output, ...] = ()
    ParamsCls: type[Params] = Params

    def __init__(self, params: Params | None = None, **kwargs):
        if params is None:
            params = self.ParamsCls(**kwargs)
        elif kwargs:
            params = params.replace(**kwargs)
        self.params = params

    # ------------------------------------------------------------ protocol
    def process(self, **inputs) -> dict[str, Any]:
        raise NotImplementedError

    def input_names(self) -> list[str]:
        return [i.name for i in self.inputs]

    def output_names(self) -> list[str]:
        return [o.name for o in self.outputs]

    # -------------------------------------------------------- serialization
    def settings_dict(self) -> dict[str, Any]:
        return self.params.to_dict()

    @classmethod
    def from_settings(cls, settings: dict[str, Any]) -> "Widget":
        # tuples serialize as lists in JSON; coerce back by field
        kwargs = {}
        fields = {f.name for f in dataclasses.fields(cls.ParamsCls)}
        for k, v in settings.items():
            if k not in fields:
                continue
            kwargs[k] = tuple(v) if isinstance(v, list) else v
        return cls(cls.ParamsCls(**kwargs))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} {self.params}>"


class FunctionWidget(Widget):
    """Wrap a plain callable as a single-output widget (ad-hoc nodes)."""

    def __init__(self, fn: Callable[..., Any], name: str = "function",
                 inputs: tuple[Input, ...] = (Input("data"),),
                 outputs: tuple[Output, ...] = (Output("data"),)):
        super().__init__(Params())
        self.fn = fn
        self.name = name
        self.inputs = inputs
        self.outputs = outputs

    def process(self, **kw) -> dict[str, Any]:
        result = self.fn(**kw)
        if not isinstance(result, dict):
            result = {self.outputs[0].name: result}
        return result
