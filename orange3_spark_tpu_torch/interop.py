"""Carry fitted tree models from the JAX package into this one.

Each function takes a JAX model's ``state_pytree`` with its leaves as numpy
arrays (``{k: np.asarray(v) for k, v in model.state_pytree.items()}``) and
its params (``model.params.to_dict()``), and builds the PyTorch model that
predicts what the JAX model predicts. Nothing here imports JAX: the caller
does the conversion to numpy.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.models._tree import Tree
from orange3_spark_tpu_torch.models.decision_tree import (
    DecisionTreeClassifierModel, DecisionTreeParams, DecisionTreeRegressorModel,
)
from orange3_spark_tpu_torch.models.gbt import (
    GBTClassifierModel, GBTParams, GBTRegressorModel,
)
from orange3_spark_tpu_torch.models.random_forest import (
    RandomForestClassifierModel, RandomForestParams, RandomForestRegressorModel,
)

_DTYPES = {"feature": torch.int32, "split_bin": torch.int32,
           "threshold": torch.float32, "leaf_value": torch.float32}


def tree_from_state(state: Mapping[str, Any], device=None) -> Tree:
    """Tree(feature, split_bin, threshold, leaf_value) from numpy arrays;
    a stacked forest ([T, ...] leaves) stays stacked."""
    device = TorchSession.active().device if device is None else device
    return Tree(**{
        k: torch.as_tensor(np.asarray(state[k]), dtype=dt, device=device)
        for k, dt in _DTYPES.items()})


def decision_tree_classifier(state, params: Mapping, class_values: Sequence[str],
                             device=None) -> DecisionTreeClassifierModel:
    return DecisionTreeClassifierModel(
        DecisionTreeParams(**params), tree_from_state(state, device), class_values)


def decision_tree_regressor(state, params: Mapping,
                            device=None) -> DecisionTreeRegressorModel:
    return DecisionTreeRegressorModel(
        DecisionTreeParams(**params), tree_from_state(state, device))


def gbt_classifier(state, params: Mapping, class_values: Sequence[str],
                   device=None) -> GBTClassifierModel:
    return GBTClassifierModel(GBTParams(**params), float(state["f0"]),
                              tree_from_state(state, device), class_values)


def gbt_regressor(state, params: Mapping, device=None) -> GBTRegressorModel:
    return GBTRegressorModel(GBTParams(**params), float(state["f0"]),
                             tree_from_state(state, device))


def random_forest_classifier(state, params: Mapping, class_values: Sequence[str],
                             device=None) -> RandomForestClassifierModel:
    return RandomForestClassifierModel(
        RandomForestParams(**params), tree_from_state(state, device), class_values)


def random_forest_regressor(state, params: Mapping,
                            device=None) -> RandomForestRegressorModel:
    return RandomForestRegressorModel(
        RandomForestParams(**params), tree_from_state(state, device))
