"""Headless widgets (the OWSpark* layer without Qt) and their registry."""

from orange3_spark_tpu_torch.widgets.base import FunctionWidget, Input, Output, Widget
from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY, widget_for_estimator

__all__ = ["FunctionWidget", "Input", "Output", "WIDGET_REGISTRY", "Widget",
           "widget_for_estimator"]
