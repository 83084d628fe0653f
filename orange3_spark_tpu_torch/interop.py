"""Carry fitted models, and fits in progress, between the JAX package and
this one.

Each model function takes a JAX model's ``state_pytree`` with its leaves as
numpy arrays (``{k: np.asarray(v) for k, v in model.state_pytree.items()}``)
and its params (``model.params.to_dict()``), and builds the PyTorch model
that predicts what the JAX model predicts. ``hashed_fit_state`` and
``jax_hashed_fit_state`` convert the state a streaming hashed fit
checkpoints (``utils/fault.StreamCheckpointer``) between the two packages'
layouts; ``streaming_linear_fit_state`` and
``jax_streaming_linear_fit_state`` do the same for a
``StreamingLinearEstimator`` fit (theta and the adam state), whose models
the three linear converters take. The feature pipeline's models (KMeans,
PCA, the fitted preprocessors) and ALS's factors carry the same way; a
model whose state is host-side (OneHotEncoder, StringIndexer) takes its
host attributes.
Nothing here imports JAX: the caller does the conversion to numpy.
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
from orange3_spark_tpu_torch.models.hashed_linear import (
    HashedLinearModel, HashedLinearParams, hashed_salts,
)
from orange3_spark_tpu_torch.models.linear_regression import (
    LinearRegressionModel, LinearRegressionParams,
)
from orange3_spark_tpu_torch.models.linear_svc import LinearSVCModel, LinearSVCParams
from orange3_spark_tpu_torch.models.logistic_regression import (
    LogisticRegressionModel, LogisticRegressionParams,
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


def hashed_linear_model(state, params: Mapping, class_values: Sequence[str] | None,
                        device=None) -> HashedLinearModel:
    """A ``HashedLinearModel`` from the JAX model's ``state_pytree`` (emb,
    coef, intercept as numpy arrays) and params. The salts are not in the
    state: both packages derive them from ``seed`` and ``n_cat`` (one per
    column, or one per model repeated over the slots of a value-weighted
    model, ``hashed_linear.hashed_salts``)."""
    device = TorchSession.active().device if device is None else device
    p = HashedLinearParams(**params)
    theta = {k: torch.tensor(np.asarray(state[k], np.float32), device=device)
             for k in ("emb", "coef", "intercept")}
    return HashedLinearModel(p, theta, hashed_salts(p), class_values)


def _linear_state(state, device):
    device = TorchSession.active().device if device is None else device
    return [torch.tensor(np.asarray(state[k], np.float32), device=device)
            for k in ("coef", "intercept")]


def logistic_regression(state, params: Mapping, class_values: Sequence[str],
                        device=None) -> LogisticRegressionModel:
    """A ``LogisticRegressionModel`` from the JAX model's ``state_pytree``
    (coef [d, k], intercept [k]) and params."""
    return LogisticRegressionModel(LogisticRegressionParams(**params),
                                   *_linear_state(state, device), class_values)


def linear_svc(state, params: Mapping, class_values: Sequence[str],
               device=None) -> LinearSVCModel:
    """A ``LinearSVCModel`` from the JAX model's state (coef [d, 1],
    intercept [1]) and params."""
    return LinearSVCModel(LinearSVCParams(**params), *_linear_state(state, device),
                          class_values)


def linear_regression(state, params: Mapping, device=None) -> LinearRegressionModel:
    """A ``LinearRegressionModel`` from the JAX model's state (coef [d],
    intercept []) and params."""
    return LinearRegressionModel(LinearRegressionParams(**params),
                                 *_linear_state(state, device))


def _np_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def hashed_fit_state(saved: Mapping) -> dict:
    """A streaming hashed fit's snapshot state (``{"theta", "opt_state"}``,
    numpy leaves) in this package's layout, from either package's snapshot.
    theta and the sparse rules' state (``step``, ``t``, ``slots``) are the
    same dicts in both. 'adam': the JAX package keeps optax's
    ``(ScaleByAdamState(count, mu, nu), EmptyState())``, this one the dict
    ``{"count", "mu", "nu"}`` (optim/sparse.py ``init_adam_state``)."""
    opt = saved["opt_state"]
    if not isinstance(opt, Mapping):
        count, mu, nu = opt[0]
        opt = {"count": count, "mu": mu, "nu": nu}
    return {"theta": _np_tree(saved["theta"]), "opt_state": _np_tree(opt)}


def jax_hashed_fit_state(state: Mapping, *, adam_state=None) -> dict:
    """The inverse of ``hashed_fit_state``: this package's snapshot state in
    the JAX package's layout, which its ``fit_stream`` resumes from. The
    sparse rules' state passes as it is. An 'adam' state needs optax's
    classes, which this package does not import: ``adam_state(count, mu,
    nu)`` builds the JAX state, e.g. ``lambda c, m, n:
    (optax.ScaleByAdamState(c, m, n), optax.EmptyState())``."""
    state = hashed_fit_state(state)
    opt = state["opt_state"]
    if "count" in opt:
        if adam_state is None:
            raise ValueError("an 'adam' fit state needs adam_state= to build optax's state")
        opt = adam_state(opt["count"], opt["mu"], opt["nu"])
    return {"theta": state["theta"], "opt_state": opt}


def streaming_linear_fit_state(saved: Mapping) -> dict:
    """A ``StreamingLinearEstimator`` snapshot's state (theta ``{"coef" [d,
    k], "intercept" [k]}`` and its adam state, numpy leaves) in this
    package's layout, from either package's snapshot: optax's adam tuple
    becomes ``{"count", "mu", "nu"}`` (the conversion of ``hashed_fit_state``)."""
    return hashed_fit_state(saved)


def jax_streaming_linear_fit_state(state: Mapping, *, adam_state) -> dict:
    """The inverse of ``streaming_linear_fit_state``: this package's
    snapshot state in the JAX package's layout; ``adam_state(count, mu,
    nu)`` builds optax's state (as for ``jax_hashed_fit_state``)."""
    return jax_hashed_fit_state(state, adam_state=adam_state)


# ------------------------------------------------- the feature pipeline
def _tensor(a, dtype, device):
    device = TorchSession.active().device if device is None else device
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def kmeans_model(state, params: Mapping, device=None):
    """A ``KMeansModel`` from the JAX model's state (centers [k, d]) and
    params."""
    from orange3_spark_tpu_torch.models.kmeans import KMeansModel, KMeansParams

    return KMeansModel(KMeansParams(**params), _tensor(state["centers"], torch.float32, device))


def pca_model(state, params: Mapping, device=None):
    """A ``PCAModel`` from the JAX model's state (components [d, k], mean,
    explained_variance, total_variance) and params."""
    from orange3_spark_tpu_torch.models.pca import PCAModel, PCAParams

    return PCAModel(PCAParams(**params),
                    *(_tensor(state[k], torch.float32, device)
                      for k in ("components", "mean", "explained_variance",
                                "total_variance")))


def als_model(state, params: Mapping, device=None):
    """An ``ALSModel`` from the JAX model's state (``user_factors``
    [n_users, k], ``item_factors`` [n_items, k]) and params: its
    predictions and recommendations are the reference's on the same
    factors."""
    from orange3_spark_tpu_torch.models.als import ALSModel, ALSParams

    return ALSModel(ALSParams(**params), _tensor(state["user_factors"], torch.float32, device),
                    _tensor(state["item_factors"], torch.float32, device))


def _scale_model(cls, params_cls, state, params, device):
    return cls(params_cls(**params), _tensor(state["idxs"], torch.int64, device),
               _tensor(state["shift"], torch.float32, device),
               _tensor(state["scale"], torch.float32, device))


def standard_scaler_model(state, params: Mapping, device=None):
    """A ``StandardScalerModel`` from the JAX model's state (idxs, shift,
    scale) and params."""
    from orange3_spark_tpu_torch.models import preprocess as P

    return _scale_model(P.StandardScalerModel, P.StandardScalerParams, state, params, device)


def min_max_scaler_model(state, params: Mapping, device=None):
    """A ``MinMaxScalerModel`` from the JAX model's state and params."""
    from orange3_spark_tpu_torch.models import preprocess as P

    return _scale_model(P.MinMaxScalerModel, P.MinMaxScalerParams, state, params, device)


def max_abs_scaler_model(state, params: Mapping, device=None):
    """A MaxAbsScaler's fitted model from the JAX model's state and params."""
    from orange3_spark_tpu_torch.models import preprocess as P

    return _scale_model(P._ColumnScaleModel, P.MaxAbsScalerParams, state, params, device)


def imputer_model(state, params: Mapping, device=None):
    """An ``ImputerModel`` from the JAX model's state (idxs, fill) and params."""
    from orange3_spark_tpu_torch.models import preprocess as P

    return P.ImputerModel(P.ImputerParams(**params), _tensor(state["idxs"], torch.int64, device),
                          _tensor(state["fill"], torch.float32, device))


def one_hot_encoder_model(params: Mapping, col_idx: Sequence[int], sizes: Sequence[int]):
    """A ``OneHotEncoderModel`` (host state only: the columns and their
    category counts, the JAX model's ``col_idx`` and ``sizes``)."""
    from orange3_spark_tpu_torch.models import preprocess as P

    return P.OneHotEncoderModel(P.OneHotEncoderParams(**params), list(col_idx), list(sizes))


def string_indexer_model(params: Mapping, labels: Sequence[str]):
    """A ``StringIndexerModel`` (host state only: the JAX model's labels)."""
    from orange3_spark_tpu_torch.models import preprocess as P

    return P.StringIndexerModel(P.StringIndexerParams(**params), labels)


def target_encoder_model(state, params: Mapping, col_idx: Sequence[int], prior: float,
                         device=None):
    """A ``TargetEncoderModel`` from the JAX model's state (``enc_<j>``
    tables), its ``col_idx`` and ``prior``, and params."""
    from orange3_spark_tpu_torch.models import preprocess as P

    tables = [_tensor(state[f"enc_{j}"], torch.float32, device) for j in col_idx]
    return P.TargetEncoderModel(P.TargetEncoderParams(**params), list(col_idx), tables,
                                float(prior))


# ------------------------------------------------- the supervised estimators
def _f32(state, keys, device):
    return [_tensor(np.asarray(state[k], np.float32), torch.float32, device) for k in keys]


def naive_bayes_model(state, params: Mapping, class_values: Sequence[str], device=None):
    """A ``NaiveBayesModel`` from the JAX model's state (``pi`` [k] and its
    model type's log factors, [k, d] each) and params."""
    from orange3_spark_tpu_torch.models.naive_bayes import NaiveBayesModel, NaiveBayesParams

    factors = {k: _tensor(np.asarray(v, np.float32), torch.float32, device)
               for k, v in state.items() if k != "pi"}
    return NaiveBayesModel(NaiveBayesParams(**params), *_f32(state, ["pi"], device),
                           factors, class_values)


def isotonic_model(state, params: Mapping, device=None):
    """An ``IsotonicRegressionModel`` from the JAX model's state
    (``boundaries``, ``predictions``) and params."""
    from orange3_spark_tpu_torch.models.isotonic import (
        IsotonicRegressionModel, IsotonicRegressionParams,
    )

    return IsotonicRegressionModel(IsotonicRegressionParams(**params),
                                   *_f32(state, ("boundaries", "predictions"), device))


def glm_model(state, params: Mapping, link: str, link_power: float, device=None):
    """A ``GeneralizedLinearRegressionModel`` from the JAX model's state
    (coef [d], intercept []), params and resolved link (``model.link``,
    ``model.link_power``)."""
    from orange3_spark_tpu_torch.models.glm import (
        GeneralizedLinearRegressionModel, GeneralizedLinearRegressionParams,
    )

    return GeneralizedLinearRegressionModel(
        GeneralizedLinearRegressionParams(**params),
        *_f32(state, ("coef", "intercept"), device), link, link_power)


def aft_model(state, params: Mapping, feature_indices: Sequence[int], device=None):
    """An ``AFTSurvivalRegressionModel`` from the JAX model's state (coef,
    intercept, scale), params and ``feature_indices`` (the columns but the
    censor column)."""
    from orange3_spark_tpu_torch.models.aft import (
        AFTSurvivalRegressionModel, AFTSurvivalRegressionParams,
    )

    return AFTSurvivalRegressionModel(AFTSurvivalRegressionParams(**params),
                                      *_f32(state, ("coef", "intercept", "scale"), device),
                                      feature_indices=list(feature_indices))


def mlp_model(state, params: Mapping, class_values: Sequence[str], device=None):
    """A ``MultilayerPerceptronClassifierModel`` from the JAX model's state
    (``net``: a list of {W [fan_in, fan_out], b [fan_out]}) and params."""
    from orange3_spark_tpu_torch.models.mlp import (
        MLPParams, MultilayerPerceptronClassifierModel,
    )

    net = [dict(zip(("W", "b"), _f32(layer, ("W", "b"), device))) for layer in state["net"]]
    return MultilayerPerceptronClassifierModel(MLPParams(**params), net, class_values)


def fm_model(state, params: Mapping, class_values: Sequence[str] | None = None, device=None):
    """An ``FMClassifierModel`` (with ``class_values``) or ``FMRegressorModel``
    from the JAX model's state (w0 [], w [d], V [d, k]) and params."""
    from orange3_spark_tpu_torch.models.fm import FMClassifierModel, FMParams, FMRegressorModel

    theta = dict(zip(("w0", "w", "V"), _f32(state, ("w0", "w", "V"), device)))
    if class_values is None:
        return FMRegressorModel(FMParams(**params), theta)
    return FMClassifierModel(FMParams(**params), theta, class_values)


def one_vs_rest_model(models: Sequence, params: Mapping, class_values: Sequence[str]):
    """A ``OneVsRestModel`` of already-converted binary models (one a
    class, in class order) and the JAX model's params."""
    from orange3_spark_tpu_torch.models.one_vs_rest import OneVsRestModel, OneVsRestParams

    return OneVsRestModel(OneVsRestParams(**params), models, class_values)


def rformula_model(params: Mapping, domain):
    """An ``RFormulaModel`` of the JAX model's formula over a port Domain:
    the model has no tensors, its plan follows from the formula and the
    domain (names, categorical levels), so it equals the reference's."""
    from orange3_spark_tpu_torch.models.rformula import RFormulaParams, compile_formula

    return compile_formula(RFormulaParams(**params), domain)


def cross_validator_model(best_model, params: Mapping, best_params: Mapping,
                          avg_metrics: Sequence[float]):
    """A ``CrossValidatorModel`` around an already-converted best model, with
    the JAX model's params (a CrossValidator's, or a TrainValidationSplit's:
    told apart by their fields), best point and metrics."""
    from orange3_spark_tpu_torch.models.tuning import (
        CrossValidatorModel, CrossValidatorParams, TrainValidationSplitParams,
    )

    cls = TrainValidationSplitParams if "train_ratio" in params else CrossValidatorParams
    return CrossValidatorModel(cls(**params), best_model, dict(best_params),
                               [float(m) for m in avg_metrics])


# ------------------------------- the unsupervised, text, feature and pattern estimators
def gaussian_mixture_model(state, params: Mapping, device=None):
    """A ``GaussianMixtureModel`` from the JAX model's state (weights [k],
    means [k, d], covs [k, d, d]) and params."""
    from orange3_spark_tpu_torch.models.gaussian_mixture import (
        GaussianMixtureModel, GaussianMixtureParams,
    )

    return GaussianMixtureModel(GaussianMixtureParams(**params),
                                *_f32(state, ("weights", "means", "covs"), device))


def bisecting_kmeans_model(state, params: Mapping, device=None):
    """A ``BisectingKMeansModel`` from the JAX model's state (the leaf
    centers [k, d]) and params."""
    from orange3_spark_tpu_torch.models.bisecting_kmeans import (
        BisectingKMeansModel, BisectingKMeansParams,
    )

    return BisectingKMeansModel(BisectingKMeansParams(**params),
                                *_f32(state, ("centers",), device))


def lda_model(state, params: Mapping, device=None):
    """An ``LDAModel`` from the JAX model's state (``lam`` [k, V]) and
    params."""
    from orange3_spark_tpu_torch.models.lda import LDAModel, LDAParams

    (lam,) = _f32(state, ("lam",), device)
    return LDAModel(LDAParams(**params), lam, lam.shape[1])


def count_vectorizer_model(params: Mapping, vocabulary: Sequence[str]):
    """A ``CountVectorizerModel`` of the JAX model's vocabulary."""
    from orange3_spark_tpu_torch.models.text import CountVectorizerModel, CountVectorizerParams

    return CountVectorizerModel(CountVectorizerParams(**params), vocabulary)


def idf_model(state, params: Mapping, col_idx: Sequence[int], device=None):
    """An ``IDFModel`` from the JAX model's state (``idf`` [m]), params and
    the scaled columns' indices."""
    from orange3_spark_tpu_torch.models.text import IDFModel, IDFParams

    return IDFModel(IDFParams(**params), *_f32(state, ("idf",), device),
                    _tensor(np.asarray(col_idx), torch.int64, device))


def word2vec_model(state, params: Mapping, vocabulary: Sequence[str], device=None):
    """A ``Word2VecModel`` from the JAX model's state (``vectors`` [V, D]),
    params and vocabulary."""
    from orange3_spark_tpu_torch.models.text import Word2VecModel, Word2VecParams

    return Word2VecModel(Word2VecParams(**params), vocabulary,
                         *_f32(state, ("vectors",), device))


def robust_scaler_model(state, params: Mapping, idx: Sequence[int], device=None):
    """A ``RobustScalerModel`` from the JAX model's state (median, iqr),
    params and scaled column indices."""
    from orange3_spark_tpu_torch.models.feature_extra import (
        RobustScalerModel, RobustScalerParams,
    )

    return RobustScalerModel(RobustScalerParams(**params),
                             *_f32(state, ("median", "iqr"), device),
                             _tensor(np.asarray(idx), torch.int64, device))


def vector_indexer_model(params: Mapping, category_maps: Mapping):
    """A ``VectorIndexerModel`` of the JAX model's category maps
    ({column index: sorted distinct values})."""
    from orange3_spark_tpu_torch.models.feature_extra import (
        VectorIndexerModel, VectorIndexerParams,
    )

    return VectorIndexerModel(VectorIndexerParams(**params),
                              {int(j): list(v) for j, v in category_maps.items()})


def column_selector_model(params, selected: Sequence[str]):
    """The model of a fitted VarianceThresholdSelector, UnivariateFeatureSelector
    or ChiSqSelector: its params (the port's params object) and the
    selected column names."""
    from orange3_spark_tpu_torch.models.feature_extra import _ColumnSelectorModel

    return _ColumnSelectorModel(params, tuple(selected))


def brp_lsh_model(state, params: Mapping, device=None):
    """A ``BucketedRandomProjectionLSHModel`` from the JAX model's state
    (``R`` [d, T]) and params."""
    from orange3_spark_tpu_torch.models.feature_extra import (
        BucketedRandomProjectionLSHModel, BucketedRandomProjectionLSHParams,
    )

    return BucketedRandomProjectionLSHModel(BucketedRandomProjectionLSHParams(**params),
                                            *_f32(state, ("R",), device))


def minhash_lsh_model(a, b, params: Mapping):
    """A ``MinHashLSHModel`` of the JAX model's hash coefficients (host
    int64 ``a``, ``b``) and params."""
    from orange3_spark_tpu_torch.models.feature_extra import MinHashLSHModel, MinHashLSHParams

    return MinHashLSHModel(MinHashLSHParams(**params), np.asarray(a), np.asarray(b))


def fpgrowth_model(params: Mapping, item_names: Sequence[str], freq_itemsets,
                   n_rows_weighted: float):
    """An ``FPGrowthModel`` of the JAX model's items, frequent itemsets
    ((frozenset of item ids, support count) pairs) and total weight; its
    rules follow from them."""
    from orange3_spark_tpu_torch.models.fpm import FPGrowthModel, FPGrowthParams

    return FPGrowthModel(FPGrowthParams(**params), item_names,
                         [(frozenset(s), float(c)) for s, c in freq_itemsets],
                         float(n_rows_weighted))
