"""Widget catalog: widgets generated from estimator params, plus the core
hand-written widgets.

Port of ``orange3_spark_tpu/widgets/catalog.py``. Its design idea is the
reference add-on's: ML widgets are GENERATED by introspecting an
estimator's params rather than written per estimator.
``widget_for_estimator`` makes a widget class from any Estimator subclass
through its frozen params dataclass, so an estimator of ``models/`` gets
its widget (and its place in saved workflows) by being listed in
``_build_catalog``. Registry names are the JAX package's, so a workflow
JSON (or an ``.ows`` file, ``workflow/ows.py``) written there loads here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.io import readers
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params, Transformer
from orange3_spark_tpu_torch.widgets.base import Input, Output, Widget

WIDGET_REGISTRY: dict[str, type[Widget]] = {}


def register(cls: type[Widget]) -> type[Widget]:
    WIDGET_REGISTRY[cls.name] = cls
    return cls


def widget_for_estimator(est_cls: type[Estimator], name: str | None = None) -> type[Widget]:
    """Make (and register) a learner widget from an Estimator class: data
    in; the fitted model and the scored data out (Orange learner widgets
    emit both)."""
    wname = name or f"OW{est_cls.__name__}"

    class EstimatorWidget(Widget):
        name = wname
        inputs = (Input("data", TorchTable),)
        outputs = (Output("model", Model), Output("data", TorchTable))
        ParamsCls = est_cls.ParamsCls
        estimator_cls = est_cls
        fitted_model: Model | None = None  # set by checkpoint restore: serve,
                                           # don't refit (cleared on set_params)

        def process(self, data: TorchTable) -> dict[str, Any]:
            if self.fitted_model is not None:
                model = self.fitted_model
            else:
                model = self.estimator_cls(self.params).fit(data)
            out: dict[str, Any] = {"model": model}
            try:
                out["data"] = model.transform(data)
            except NotImplementedError:
                out["data"] = data  # models without transform keep data flowing
            return out

    EstimatorWidget.__name__ = wname
    EstimatorWidget.__qualname__ = wname
    return register(EstimatorWidget)


def widget_for_transformer(tr_cls: type[Transformer], name: str | None = None) -> type[Widget]:
    """Make (and register) a widget from a stateless Transformer class."""
    wname = name or f"OW{tr_cls.__name__}"

    class TransformerWidget(Widget):
        name = wname
        inputs = (Input("data", TorchTable),)
        outputs = (Output("data", TorchTable),)
        ParamsCls = getattr(tr_cls, "ParamsCls", None) or Params
        transformer_cls = tr_cls

        @property
        def transformer(self) -> Transformer:
            # rebuilt from the current params on each access, so set_params
            # takes effect on the next refire (as for estimator widgets)
            if type(self.params) is Params:
                return tr_cls()
            return tr_cls(self.params)

        def process(self, data: TorchTable) -> dict[str, Any]:
            return {"data": self.transformer.transform(data)}

    TransformerWidget.__name__ = wname
    TransformerWidget.__qualname__ = wname
    return register(TransformerWidget)


# ---------------------------------------------------------------------------
# Core (hand-written) widgets: environment, data source, apply, view
# ---------------------------------------------------------------------------
@register
class OWTpuContext(Widget):
    """Environment widget (OWSparkContext's role): ensures the session
    exists and republishes it downstream. It keeps the JAX package's
    registry name, so saved workflows load; here it publishes the
    ``TorchSession``."""

    name = "OWTpuContext"
    inputs = ()
    outputs = (Output("session"),)

    def process(self) -> dict[str, Any]:
        from orange3_spark_tpu_torch.core.session import TorchSession

        return {"session": TorchSession.builder_get_or_create()}


@register
class OWTable(Widget):
    """In-memory data source: holds a TorchTable set at construction (the
    'Orange Table → canvas' entry point)."""

    name = "OWTable"
    inputs = ()
    outputs = (Output("data", TorchTable),)

    def __init__(self, table: TorchTable | None = None):
        super().__init__(Params())
        self.table = table

    def process(self) -> dict[str, Any]:
        if self.table is None:
            raise ValueError("OWTable has no table set")
        return {"data": self.table}


@register
class OWCsvReader(Widget):
    """File source widget (spark.read.csv): ``io/readers.read_csv``."""

    name = "OWCsvReader"
    inputs = ()
    outputs = (Output("data", TorchTable),)
    ParamsCls = readers.CsvReaderParams

    def process(self) -> dict[str, Any]:
        return {"data": readers.read_csv(params=self.params)}


@dataclasses.dataclass(frozen=True)
class ParquetReaderParams(Params):
    path: str = ""
    class_col: str = ""


@register
class OWParquetReader(Widget):
    """Parquet source widget (spark.read.parquet): a whole-file load by
    ``io/readers.read_parquet``; the out-of-core regime streams row groups
    through ``io/streaming.parquet_raw_chunk_source`` instead."""

    name = "OWParquetReader"
    inputs = ()
    outputs = (Output("data", TorchTable),)
    ParamsCls = ParquetReaderParams

    def process(self) -> dict[str, Any]:
        p = self.params
        return {"data": readers.read_parquet(p.path, p.class_col)}


@dataclasses.dataclass(frozen=True)
class LibsvmReaderParams(Params):
    path: str = ""
    n_features: int = 0          # 0 = inferred from the file's largest index
    zero_based: bool = False


@register
class OWLibsvmReader(Widget):
    """libsvm/svmlight source widget (spark.read.format('libsvm')):
    ``io/libsvm.read_libsvm``."""

    name = "OWLibsvmReader"
    inputs = ()
    outputs = (Output("data", TorchTable),)
    ParamsCls = LibsvmReaderParams

    def process(self) -> dict[str, Any]:
        from orange3_spark_tpu_torch.io.libsvm import read_libsvm

        p = self.params
        return {"data": read_libsvm(p.path, n_features=p.n_features or None,
                                    zero_based=p.zero_based)}


@dataclasses.dataclass(frozen=True)
class SqlReaderParams(Params):
    query: str = ""
    database: str = ""           # SQLite file path (the spark.read.jdbc role)
    class_col: str = ""


@register
class OWSqlReader(Widget):
    """SQL source widget (spark.read.jdbc over the standard library's
    sqlite3): ``io/readers.read_sql``."""

    name = "OWSqlReader"
    inputs = ()
    outputs = (Output("data", TorchTable),)
    ParamsCls = SqlReaderParams

    def process(self) -> dict[str, Any]:
        p = self.params
        return {"data": readers.read_sql(p.query, p.database, p.class_col)}


@register
class OWApplyModel(Widget):
    """Apply a fitted model to (new) data: the model.transform(df) widget."""

    name = "OWApplyModel"
    inputs = (Input("data", TorchTable), Input("model", Model))
    outputs = (Output("data", TorchTable),)

    def process(self, data: TorchTable, model: Model) -> dict[str, Any]:
        return {"data": model.transform(data)}


@register
class OWMergeColumns(Widget):
    """Row-aligned column merge of two branches (Orange 'Merge Data' by
    position). Device-pure, so a DAG that fans out and re-merges through it
    stages whole."""

    name = "OWMergeColumns"
    inputs = (Input("left", TorchTable), Input("right", TorchTable))
    outputs = (Output("data", TorchTable),)

    def process(self, left: TorchTable, right: TorchTable) -> dict[str, Any]:
        from orange3_spark_tpu_torch.ops.relational import merge_columns

        return {"data": merge_columns(left, right)}


@dataclasses.dataclass(frozen=True)
class JoinParams(Params):
    on: str = ""
    how: str = "left"        # 'left' | 'inner' | 'outer' (outer => host)
    # 0: unique-key dimension join (device gather, left shape kept);
    # >0: bounded fan-out join_expand (static max_matches slots a row);
    # -1: fully general host sort-merge (join_host, unbounded cardinality)
    max_matches: int = 0


@register
class OWJoin(Widget):
    """Equi-join on a discrete key in the three regimes of
    ``ops/relational``: the dimension gather, the bounded fan-out expand
    and the general host sort-merge, chosen by ``max_matches`` (and sent
    to the host by ``how='outer'``). The right side's key scan runs on the
    host, so staging stops here and reports it."""

    name = "OWJoin"
    inputs = (Input("left", TorchTable), Input("right", TorchTable))
    outputs = (Output("data", TorchTable),)
    ParamsCls = JoinParams

    def process(self, left: TorchTable, right: TorchTable) -> dict[str, Any]:
        from orange3_spark_tpu_torch.ops.relational import join, join_expand, join_host

        p = self.params
        if p.max_matches < -1:
            raise ValueError(f"max_matches={p.max_matches}: use -1 (host join), 0 "
                             "(dimension join) or a positive fan-out bound")
        if p.max_matches == -1 or p.how == "outer":
            return {"data": join_host(left, right, p.on, p.how)}
        if p.max_matches > 0:
            return {"data": join_expand(left, right, p.on, max_matches=p.max_matches,
                                        how=p.how)}
        return {"data": join(left, right, p.on, p.how)}


_ROW_OPS = {
    ">": lambda c, v: c > v, ">=": lambda c, v: c >= v,
    "<": lambda c, v: c < v, "<=": lambda c, v: c <= v,
    "==": lambda c, v: c == v, "!=": lambda c, v: c != v,
}


@dataclasses.dataclass(frozen=True)
class SelectColumnsParams(Params):
    columns: tuple = ()     # attribute names to keep, in order


class SelectColumns(Transformer):
    """Orange's 'Select Columns': a projection on the device (stageable)."""

    ParamsCls = SelectColumnsParams
    params: SelectColumnsParams

    def transform(self, table: TorchTable) -> TorchTable:
        if not self.params.columns:
            raise ValueError("SelectColumns has no columns configured — set "
                             "columns=(name, ...) on the widget/params")
        return table.select(list(self.params.columns))


@dataclasses.dataclass(frozen=True)
class SelectRowsParams(Params):
    conditions: tuple = ()  # ((col, op, value), ...), AND-combined


class SelectRows(Transformer):
    """Orange's 'Select Rows': an AND of per-column comparisons folded into
    the weight mask (on the device, stageable). SQL null semantics: a row
    whose compared column is NaN (missing) fails EVERY condition,
    including '!=' (IEEE would keep it)."""

    ParamsCls = SelectRowsParams
    params: SelectRowsParams

    def transform(self, table: TorchTable) -> TorchTable:
        from orange3_spark_tpu_torch.core.domain import DiscreteVariable

        mask = torch.ones((table.n_pad,), dtype=torch.bool, device=table.W.device)
        for cond in self.params.conditions:
            col, op, value = tuple(cond)
            if op not in _ROW_OPS:
                raise ValueError(f"unknown op {op!r}; supported: {sorted(_ROW_OPS)}")
            var = table.domain[col]
            if isinstance(value, str):
                # a category NAME compares by its code
                if isinstance(var, DiscreteVariable) and value in var.values:
                    value = float(var.values.index(value))
                else:
                    try:
                        value = float(value)
                    except ValueError:
                        raise ValueError(
                            f"SelectRows value {value!r} is neither numeric "
                            f"nor a category of {col!r}"
                            + (f" (categories: {list(var.values)})"
                               if isinstance(var, DiscreteVariable) else "")
                        ) from None
            c = table.column(col)
            mask = mask & _ROW_OPS[op](c, float(value)) & ~torch.isnan(c)
        return table.filter(mask)


widget_for_transformer(SelectColumns, "OWSelectColumns")
widget_for_transformer(SelectRows, "OWSelectRows")


@dataclasses.dataclass(frozen=True)
class GroupByParams(Params):
    keys: tuple = ()        # discrete key column names; () = global agg
    aggs: tuple = ()        # ((col, fn), ...) with fn in relational.AGG_FNS


@register
class OWGroupBy(Widget):
    """df.groupBy(keys).agg(...) widget (``ops/relational.group_by``): a
    fixed ∏kᵢ-row output from one grouped pass."""

    name = "OWGroupBy"
    inputs = (Input("data", TorchTable),)
    outputs = (Output("data", TorchTable),)
    ParamsCls = GroupByParams

    def process(self, data: TorchTable) -> dict[str, Any]:
        from orange3_spark_tpu_torch.ops.relational import group_by

        p = self.params
        return {"data": group_by(data, list(p.keys) or None, p.aggs)}


@dataclasses.dataclass(frozen=True)
class PivotParams(Params):
    keys: tuple = ()        # group key column names
    pivot_col: str = ""
    aggs: tuple = ()        # ((col, fn), ...)
    values: tuple = ()      # a subset of the pivot values; () = all categories


@register
class OWPivot(Widget):
    """df.groupBy(keys).pivot(col).agg(...) widget (``ops/relational.pivot``)."""

    name = "OWPivot"
    inputs = (Input("data", TorchTable),)
    outputs = (Output("data", TorchTable),)
    ParamsCls = PivotParams

    def process(self, data: TorchTable) -> dict[str, Any]:
        from orange3_spark_tpu_torch.ops.relational import pivot

        p = self.params
        return {"data": pivot(data, list(p.keys), p.pivot_col, p.aggs,
                              values=(list(p.values) or None))}


@register
class OWDataInfo(Widget):
    """DataFrame-info viewer: row/col counts + describe stats (host dict)."""

    name = "OWDataInfo"
    inputs = (Input("data", TorchTable),)
    outputs = (Output("info", dict),)

    def process(self, data: TorchTable) -> dict[str, Any]:
        return {"info": {
            "n_rows": data.n_rows,
            "n_live": data.count(),
            "n_attrs": data.n_attrs,
            "attributes": [v.name for v in data.domain.attributes],
            "class_vars": [v.name for v in data.domain.class_vars],
            "stats": data.describe(),
        }}


@dataclasses.dataclass(frozen=True)
class SaveDataParams(Params):
    path: str = ""
    # '' = chosen by the path's extension (.csv / .parquet / .db);
    # 'csv' | 'parquet' | 'sql' forces a writer
    format: str = ""
    sql_table: str = "data"      # the table name for the sql writer
    drop_filtered: bool = True


@register
class OWSaveData(Widget):
    """Save Data sink (Orange canvas 'Save Data', the df.write role):
    writes the incoming table with the matching ``io/readers`` writer."""

    name = "OWSaveData"
    inputs = (Input("data", TorchTable),)
    outputs = (Output("path", str),)
    ParamsCls = SaveDataParams

    def process(self, data: TorchTable) -> dict[str, Any]:
        p = self.params
        if not p.path:
            raise ValueError("OWSaveData needs a path")
        fmt = p.format or {
            ".csv": "csv", ".parquet": "parquet", ".pq": "parquet",
            ".db": "sql", ".sqlite": "sql",
        }.get("." + p.path.rsplit(".", 1)[-1].lower(), "")
        if fmt == "csv":
            readers.write_csv(data, p.path, drop_filtered=p.drop_filtered)
        elif fmt == "parquet":
            readers.write_parquet(data, p.path, drop_filtered=p.drop_filtered)
        elif fmt == "sql":
            readers.write_sql(data, p.path, p.sql_table, drop_filtered=p.drop_filtered)
        else:
            raise ValueError(f"cannot infer a writer for {p.path!r}; set format="
                             "'csv'|'parquet'|'sql'")
        return {"path": p.path}


@register
class OWTableView(Widget):
    """Collect-to-host sink (the toPandas / Orange-table boundary)."""

    name = "OWTableView"
    inputs = (Input("data", TorchTable),)
    outputs = (Output("array", np.ndarray),)

    def process(self, data: TorchTable) -> dict[str, Any]:
        X, Y, _ = data.to_numpy()
        return {"array": X if Y is None else np.concatenate([X, Y], axis=1)}


def _evaluation_widget(evaluator_cls, wname):
    from orange3_spark_tpu_torch.models.evaluation import EvaluatorParams

    class EvaluatorWidget(Widget):
        name = wname
        inputs = (Input("data", TorchTable),)
        outputs = (Output("score", float),)
        ParamsCls = EvaluatorParams

        def process(self, data: TorchTable) -> dict[str, Any]:
            return {"score": evaluator_cls(self.params).evaluate(data)}

    EvaluatorWidget.__name__ = wname
    EvaluatorWidget.__qualname__ = wname
    return register(EvaluatorWidget)


# ---------------------------------------------------------------------------
# The generated catalog: every estimator the port has
# ---------------------------------------------------------------------------
def _build_catalog() -> None:
    from orange3_spark_tpu_torch.io.streaming import StreamingKMeans
    from orange3_spark_tpu_torch.models import evaluation as E
    from orange3_spark_tpu_torch.models import preprocess as P
    from orange3_spark_tpu_torch.models.aft import AFTSurvivalRegression
    from orange3_spark_tpu_torch.models.als import ALS
    from orange3_spark_tpu_torch.models import feature_extra as FE
    from orange3_spark_tpu_torch.models import text as T
    from orange3_spark_tpu_torch.models.bisecting_kmeans import BisectingKMeans
    from orange3_spark_tpu_torch.models.fpm import FPGrowth
    from orange3_spark_tpu_torch.models.gaussian_mixture import GaussianMixture
    from orange3_spark_tpu_torch.models.lda import LDA
    from orange3_spark_tpu_torch.models.fm import FMClassifier, FMRegressor
    from orange3_spark_tpu_torch.models.glm import GeneralizedLinearRegression
    from orange3_spark_tpu_torch.models.isotonic import IsotonicRegression
    from orange3_spark_tpu_torch.models.mlp import MultilayerPerceptronClassifier
    from orange3_spark_tpu_torch.models.naive_bayes import NaiveBayes
    from orange3_spark_tpu_torch.models.rformula import RFormula
    from orange3_spark_tpu_torch.models.decision_tree import (
        DecisionTreeClassifier, DecisionTreeRegressor,
    )
    from orange3_spark_tpu_torch.models.gbt import GBTClassifier, GBTRegressor
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
    from orange3_spark_tpu_torch.models.kmeans import KMeans
    from orange3_spark_tpu_torch.models.linear_regression import LinearRegression
    from orange3_spark_tpu_torch.models.linear_svc import LinearSVC
    from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression
    from orange3_spark_tpu_torch.models.pca import PCA
    from orange3_spark_tpu_torch.models.random_forest import (
        RandomForestClassifier, RandomForestRegressor,
    )

    for est in (
        LogisticRegression, LinearSVC, LinearRegression, KMeans, PCA,
        P.StandardScaler, P.MinMaxScaler, P.MaxAbsScaler, P.Imputer,
        P.QuantileDiscretizer, P.OneHotEncoder, P.StringIndexer,
        P.TargetEncoder,
        RandomForestClassifier, RandomForestRegressor,
        GBTClassifier, GBTRegressor,
        DecisionTreeClassifier, DecisionTreeRegressor,
        StreamingKMeans, StreamingHashedLinearEstimator, ALS,
        NaiveBayes, GeneralizedLinearRegression, IsotonicRegression,
        AFTSurvivalRegression, FMClassifier, FMRegressor,
        MultilayerPerceptronClassifier, RFormula,
        # the reference's clustering, text, feature and pattern blocks
        GaussianMixture, BisectingKMeans, LDA,
        T.CountVectorizer, T.IDF, T.Word2Vec,
        FE.RobustScaler, FE.VectorIndexer, FE.VarianceThresholdSelector,
        FE.UnivariateFeatureSelector, FE.ChiSqSelector,
        FE.BucketedRandomProjectionLSH, FE.MinHashLSH, FPGrowth,
    ):
        widget_for_estimator(est)
    for tr in (P.Normalizer, P.Binarizer, P.Bucketizer, P.FeatureHasher,
               T.Tokenizer, T.RegexTokenizer, T.StopWordsRemover, T.NGram, T.HashingTF,
               FE.PolynomialExpansion, FE.DCT, FE.Interaction, FE.ElementwiseProduct,
               FE.VectorSlicer, FE.IndexToString, FE.SQLTransformer):
        widget_for_transformer(tr)
    _evaluation_widget(E.BinaryClassificationEvaluator, "OWBinaryEvaluator")
    _evaluation_widget(E.MulticlassClassificationEvaluator, "OWMulticlassEvaluator")
    _evaluation_widget(E.RegressionEvaluator, "OWRegressionEvaluator")
    _evaluation_widget(E.ClusteringEvaluator, "OWClusteringEvaluator")


_build_catalog()
