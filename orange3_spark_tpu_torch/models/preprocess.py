"""Feature transformers — ``pyspark.ml.feature`` capability parity.

Port of ``orange3_spark_tpu/models/preprocess.py``. Every fitted state is a
few small device tensors; every transform is a columnar op on the one X
matrix. The JAX package writes a column subset with ``.at[:, idxs].set``;
here a shift-and-scale builds full-width shift and scale vectors with
``index_copy_`` (one elementwise pass over X), and the other column
writes ``index_copy_`` into a copy of X.

Column addressing: ``input_cols=None`` means "all continuous attributes"
for scalers/imputer (our table IS the assembled matrix); VectorAssembler is
a thin select for API parity.

Host constants a transform needs on the device (column indices, split
points, hash projections) go through ``utils.graphs.device_constant``: made
once, outside any CUDA graph capture, and read in place afterwards. A
transform that checks its input on the host (OneHotEncoder and
TargetEncoder with ``handle_invalid='error'``, StringIndexer on the metas)
sets ``staged_capturable`` False; a staged program then runs it eagerly
between captured segments (workflow/staging.py).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Sequence

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import (
    ContinuousVariable,
    DiscreteVariable,
    Domain,
)
from orange3_spark_tpu_torch.core.fmath import norm32, sqrt32
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params, Transformer
from orange3_spark_tpu_torch.ops.stats import (
    EPS_TOTAL_WEIGHT, weighted_moments, weighted_quantiles,
)
from orange3_spark_tpu_torch.utils.graphs import device_constant

_F32_MAX = float(np.finfo(np.float32).max)


def _col_indices(table: TorchTable, input_cols: Sequence[str] | None) -> np.ndarray:
    if input_cols is None:
        idxs = [
            i for i, v in enumerate(table.domain.attributes)
            if isinstance(v, ContinuousVariable)
        ]
    else:
        idxs = [table.domain.index(c) for c in input_cols]
    return np.asarray(idxs, dtype=np.int64)


def _idx_tensor(idxs, device) -> torch.Tensor:
    return device_constant(np.asarray(idxs, np.int64), torch.int64, device)


def _scale_transform(X, idxs, shift, scale):
    """X'[:, idxs] = (X[:, idxs] - shift) * scale as one pass over X: the
    other columns get shift 0 and scale 1, which leave them unchanged."""
    d = X.shape[1]
    full_shift = torch.zeros((d,), dtype=X.dtype, device=X.device).index_copy_(
        0, idxs, shift.to(X.dtype))
    full_scale = torch.ones((d,), dtype=X.dtype, device=X.device).index_copy_(
        0, idxs, scale.to(X.dtype))
    return (X - full_shift) * full_scale


def _set_columns(X, idxs, cols):
    """A copy of X with columns ``idxs`` replaced by ``cols``."""
    return X.clone().index_copy_(1, idxs, cols.to(X.dtype))


def _stream_index(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _session_device(session):
    from orange3_spark_tpu_torch.core.session import TorchSession

    session = session or TorchSession.builder_get_or_create()
    session.require_fold("a streaming feature transformer's fit")
    return session.device


# ---------------------------------------------------------------------------
# Scalers
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StandardScalerParams(Params):
    with_mean: bool = False  # MLlib withMean (False default, like Spark)
    with_std: bool = True    # MLlib withStd
    input_cols: tuple | None = None


class _ColumnScaleModel(Model):
    """Shared shift-and-scale fitted state."""

    def __init__(self, params, idxs, shift, scale):
        self.params = params
        self.idxs = idxs        # int64 [m] device
        self.shift = shift      # f32 [m]
        self.scale = scale      # f32 [m]

    @property
    def state_pytree(self):
        return {"idxs": self.idxs, "shift": self.shift, "scale": self.scale}

    def transform(self, table: TorchTable) -> TorchTable:
        return table.with_X(_scale_transform(table.X, self.idxs, self.shift, self.scale))


class StandardScalerModel(_ColumnScaleModel):
    @property
    def mean(self):
        return self.shift

    @property
    def std(self):
        return 1.0 / self.scale


class StandardScaler(Estimator):
    ParamsCls = StandardScalerParams
    params: StandardScalerParams
    staged_fit_capturable = True

    def _fit(self, table: TorchTable) -> StandardScalerModel:
        idxs = _idx_tensor(_col_indices(table, self.params.input_cols), table.X.device)
        mean, var, _ = weighted_moments(table.X.index_select(1, idxs), table.W)
        return self._finalize(mean, var, idxs)

    def _finalize(self, mean, var, idxs) -> StandardScalerModel:
        p = self.params
        mean = mean.to(torch.float32)
        std = sqrt32(var.to(torch.float32))
        scale = (torch.where(std > 1e-12, 1.0 / std, 1.0) if p.with_std
                 else torch.ones_like(std))
        shift = mean if p.with_mean else torch.zeros_like(mean)
        return StandardScalerModel(p, idxs, shift, scale)

    def fit_stream(self, source, *, session=None,
                   chunk_rows: int = 1 << 18) -> StandardScalerModel:
        """Out-of-core fit: ONE pass of per-column moments over a chunk
        stream (io/streaming.stream_feature_stats), the population variance
        of the in-memory fit at any row count. The stream's columns are the
        features (``input_cols`` must be unset)."""
        if self.params.input_cols is not None:
            raise ValueError("fit_stream scales every stream column; "
                             "select columns in the source instead of "
                             "input_cols")
        from orange3_spark_tpu_torch.io.streaming import stream_feature_stats

        dev = _session_device(session)
        st = stream_feature_stats(source, session=session, chunk_rows=chunk_rows)
        return self._finalize(torch.as_tensor(st["mean"], device=dev),
                              torch.as_tensor(st["var"], device=dev),
                              _stream_index(len(st["mean"]), dev))


@dataclasses.dataclass(frozen=True)
class MinMaxScalerParams(Params):
    min: float = 0.0  # MLlib min
    max: float = 1.0  # MLlib max
    input_cols: tuple | None = None


class MinMaxScaler(Estimator):
    ParamsCls = MinMaxScalerParams
    params: MinMaxScalerParams
    staged_fit_capturable = True

    def _fit(self, table: TorchTable) -> "MinMaxScalerModel":
        idxs = _idx_tensor(_col_indices(table, self.params.input_cols), table.X.device)
        Xsel = table.X.index_select(1, idxs)
        live = (table.W > 0)[:, None]
        mn = torch.where(live, Xsel, _F32_MAX).amin(dim=0)
        mx = torch.where(live, Xsel, -_F32_MAX).amax(dim=0)
        return self._finalize(mn, mx, idxs)

    def _finalize(self, mn, mx, idxs) -> "MinMaxScalerModel":
        p = self.params
        mn = mn.to(torch.float32)
        rng = mx.to(torch.float32) - mn
        scale = torch.where(rng > 1e-12, (p.max - p.min) / rng, 0.0)
        return MinMaxScalerModel(p, idxs, mn, scale)

    def fit_stream(self, source, *, session=None,
                   chunk_rows: int = 1 << 18) -> "MinMaxScalerModel":
        """Out-of-core fit: one pass of per-column min/max over a chunk
        stream; see ``StandardScaler.fit_stream`` for the column rule."""
        if self.params.input_cols is not None:
            raise ValueError("fit_stream scales every stream column; "
                             "select columns in the source instead of "
                             "input_cols")
        from orange3_spark_tpu_torch.io.streaming import stream_feature_stats

        dev = _session_device(session)
        st = stream_feature_stats(source, session=session, chunk_rows=chunk_rows)
        return self._finalize(torch.as_tensor(st["min"], device=dev),
                              torch.as_tensor(st["max"], device=dev),
                              _stream_index(len(st["min"]), dev))


class MinMaxScalerModel(_ColumnScaleModel):
    params: MinMaxScalerParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        Xsel = table.X.index_select(1, self.idxs)
        # Spark maps constant columns (scale == 0) to the output range's
        # midpoint; both constants derive from params
        mid_fill = p.min + 0.5 * (p.max - p.min)
        scaled = torch.where(self.scale > 0, (Xsel - self.shift) * self.scale + p.min,
                             mid_fill)
        return table.with_X(_set_columns(table.X, self.idxs, scaled))


@dataclasses.dataclass(frozen=True)
class MaxAbsScalerParams(Params):
    input_cols: tuple | None = None


class MaxAbsScaler(Estimator):
    ParamsCls = MaxAbsScalerParams
    staged_fit_capturable = True

    def _fit(self, table: TorchTable) -> _ColumnScaleModel:
        idxs = _idx_tensor(_col_indices(table, self.params.input_cols), table.X.device)
        Xsel = table.X.index_select(1, idxs)
        live = (table.W > 0)[:, None]
        mabs = torch.where(live, Xsel.abs(), 0.0).amax(dim=0)
        scale = torch.where(mabs > 1e-12, 1.0 / mabs, 1.0)
        return _ColumnScaleModel(self.params, idxs, torch.zeros_like(scale), scale)


# ---------------------------------------------------------------------------
# Imputer
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ImputerParams(Params):
    strategy: str = "mean"       # MLlib strategy: 'mean' | 'median' | 'mode'
    missing_value: float = float("nan")  # MLlib missingValue
    input_cols: tuple | None = None


def _missing(Xsel, mv: float):
    return torch.isnan(Xsel) if np.isnan(mv) else (Xsel == mv)


class ImputerModel(Model):
    def __init__(self, params, idxs, fill):
        self.params = params
        self.idxs = idxs
        self.fill = fill  # f32 [len(idxs)]

    @property
    def state_pytree(self):
        return {"idxs": self.idxs, "fill": self.fill}

    def transform(self, table: TorchTable) -> TorchTable:
        Xsel = table.X.index_select(1, self.idxs)
        miss = _missing(Xsel, self.params.missing_value)
        filled = torch.where(miss, self.fill, Xsel)
        return table.with_X(_set_columns(table.X, self.idxs, filled))


class Imputer(Estimator):
    ParamsCls = ImputerParams
    params: ImputerParams

    @property
    def staged_fit_capturable(self) -> bool:
        return self.params.strategy == "mean"

    def _fit(self, table: TorchTable) -> ImputerModel:
        p = self.params
        idxs = _idx_tensor(_col_indices(table, p.input_cols), table.X.device)
        Xsel = table.X.index_select(1, idxs)
        miss = _missing(Xsel, p.missing_value)
        w_eff = torch.where(miss, 0.0, table.W[:, None])
        if p.strategy == "mean":
            tot = torch.clamp_min(w_eff.sum(dim=0), EPS_TOTAL_WEIGHT)
            fill = (torch.where(miss, 0.0, Xsel) * w_eff).sum(dim=0) / tot
        elif p.strategy == "median":
            # one batched weighted-quantile call; per-cell weights drop
            # each column's own missing entries
            Xclean = torch.where(miss, 0.0, Xsel)
            qs = torch.tensor([0.5], dtype=torch.float32, device=Xsel.device)
            fill = weighted_quantiles(Xclean, w_eff, qs)[0]
        elif p.strategy == "mode":
            # mode over observed values: host-side exact (small unique sets)
            Xh = Xsel.cpu().numpy()
            Wh = w_eff.cpu().numpy()
            fills = []
            for j in range(Xh.shape[1]):
                vals = Xh[Wh[:, j] > 0, j]
                if len(vals) == 0:
                    fills.append(0.0)
                else:
                    uniq, counts = np.unique(vals, return_counts=True)
                    fills.append(float(uniq[np.argmax(counts)]))
            fill = torch.tensor(fills, dtype=torch.float32, device=Xsel.device)
        else:
            raise ValueError(f"unknown strategy {p.strategy!r}")
        return ImputerModel(p, idxs, fill)

    def fit_stream(self, source, *, session=None,
                   chunk_rows: int = 1 << 18) -> ImputerModel:
        """Out-of-core mean-imputer fit: one missing-aware stats pass
        (per-CELL observation masks: a missing cell drops out of its
        column only). 'median'/'mode' need the rows in memory."""
        p = self.params
        if p.strategy != "mean":
            raise ValueError(
                f"fit_stream supports strategy='mean' only (got "
                f"{p.strategy!r}); median/mode need the rows in memory")
        if p.input_cols is not None:
            raise ValueError("fit_stream imputes every stream column; "
                             "select columns in the source instead of "
                             "input_cols")
        from orange3_spark_tpu_torch.io.streaming import stream_feature_stats

        dev = _session_device(session)
        st = stream_feature_stats(source, session=session, chunk_rows=chunk_rows,
                                  missing_value=p.missing_value)
        return ImputerModel(p, _stream_index(len(st["mean"]), dev),
                            torch.as_tensor(st["mean"], dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# Discretization & encoding
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BucketizerParams(Params):
    splits: tuple = ()           # MLlib splits: boundaries incl. +-inf allowed
    input_col: str = ""


class Bucketizer(Transformer):
    """Stateless: bin one column by explicit split points (MLlib Bucketizer)."""

    ParamsCls = BucketizerParams

    def __init__(self, params: BucketizerParams | None = None, **kwargs):
        self.params = params or BucketizerParams(**kwargs)
        if len(self.params.splits) < 3:
            raise ValueError("need >= 3 split points (>= 2 buckets)")

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        j = table.domain.index(p.input_col)
        splits = device_constant(np.asarray(p.splits, np.float32), torch.float32,
                                 table.X.device)
        col = table.X[:, j].contiguous()
        binned = torch.clamp(torch.searchsorted(splits, col, right=True) - 1,
                             0, len(p.splits) - 2).to(torch.float32)
        n_bins = len(p.splits) - 1
        var = DiscreteVariable(f"{p.input_col}_binned", tuple(str(i) for i in range(n_bins)))
        new_domain = Domain(list(table.domain.attributes) + [var],
                            table.domain.class_vars, table.domain.metas)
        return table.with_X(torch.cat([table.X, binned[:, None]], dim=1), new_domain)


@dataclasses.dataclass(frozen=True)
class QuantileDiscretizerParams(Params):
    num_buckets: int = 2         # MLlib numBuckets
    input_col: str = ""


class QuantileDiscretizer(Estimator):
    """Fit quantile split points, return a Bucketizer (MLlib behavior)."""

    ParamsCls = QuantileDiscretizerParams
    params: QuantileDiscretizerParams

    def _fit(self, table: TorchTable) -> Bucketizer:
        p = self.params
        j = table.domain.index(p.input_col)
        qs = torch.linspace(0.0, 1.0, p.num_buckets + 1, dtype=torch.float32,
                            device=table.X.device)[1:-1]
        inner = weighted_quantiles(table.X[:, j:j + 1], table.W, qs)[:, 0]
        splits = (-np.inf,) + tuple(np.unique(inner.cpu().numpy()).tolist()) + (np.inf,)
        return Bucketizer(BucketizerParams(splits=splits, input_col=p.input_col))


@dataclasses.dataclass(frozen=True)
class OneHotEncoderParams(Params):
    input_cols: tuple = ()       # discrete attribute names
    drop_last: bool = True       # MLlib dropLast
    handle_invalid: str = "error"  # MLlib handleInvalid: 'error' | 'keep'


def _one_hot(col: torch.Tensor, size: int) -> torch.Tensor:
    """f32 [N, size] one-hot of integer-valued floats (truncated toward
    zero); an index outside [0, size) gives a zero row, as jax.nn.one_hot."""
    ids = col.to(torch.int64)
    return (ids[:, None] == torch.arange(size, device=col.device)).to(torch.float32)


class OneHotEncoderModel(Model):
    def __init__(self, params, col_idx, sizes):
        self.params = params
        self.col_idx = col_idx   # list[int]
        self.sizes = sizes       # list[int] categories per column

    @property
    def state_pytree(self):
        return {}

    @property
    def staged_capturable(self) -> bool:
        return self.params.handle_invalid != "error"

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        pieces, new_vars = [], []
        drop = set(self.col_idx)
        keep = [i for i in range(table.n_attrs) if i not in drop]
        pieces.append(table.X.index_select(1, _idx_tensor(keep, table.X.device)))
        new_vars.extend(table.domain.attributes[i] for i in keep)
        for j, size, name in zip(self.col_idx, self.sizes, p.input_cols, strict=True):
            if p.handle_invalid == "error":
                # under drop_last an unseen index would silently alias the
                # dropped last category (a zero row), so check
                mx = int(torch.where(table.W > 0, table.X[:, j], 0.0).max())
                if mx >= size:
                    raise ValueError(
                        f"column {name!r} has category index {mx} >= {size} "
                        "unseen at fit (handle_invalid='error')")
            width = size - 1 if p.drop_last else size
            var = table.domain.attributes[j]
            values = (var.values if isinstance(var, DiscreteVariable) and var.values
                      else tuple(str(i) for i in range(size)))
            pieces.append(_one_hot(table.X[:, j], size)[:, :width])
            new_vars.extend(ContinuousVariable(f"{name}_{values[c]}") for c in range(width))
        new_domain = Domain(new_vars, table.domain.class_vars, table.domain.metas)
        return table.with_X(torch.cat(pieces, dim=1), new_domain)


class OneHotEncoder(Estimator):
    ParamsCls = OneHotEncoderParams
    params: OneHotEncoderParams

    def _fit(self, table: TorchTable) -> OneHotEncoderModel:
        p = self.params
        if not p.input_cols:
            raise ValueError("OneHotEncoder needs input_cols")
        col_idx, sizes = [], []
        for name in p.input_cols:
            var = table.domain[name]
            j = table.domain.index(name)
            col_idx.append(j)
            if isinstance(var, DiscreteVariable) and var.values:
                sizes.append(len(var.values))
            else:  # infer the category count from the data (Spark's OHE fit)
                sizes.append(int(table.X[:, j].max()) + 1)
        return OneHotEncoderModel(p, col_idx, sizes)


@dataclasses.dataclass(frozen=True)
class StringIndexerParams(Params):
    input_col: str = ""           # a meta (string) column
    order: str = "frequencyDesc"  # MLlib stringOrderType
    handle_invalid: str = "error" # 'error' | 'keep' (maps unseen -> n)


class StringIndexerModel(Model):
    staged_capturable = False     # reads the metas and W on the host

    def __init__(self, params, labels):
        self.params = params
        self.labels = tuple(labels)

    @property
    def state_pytree(self):
        return {}

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        meta_names = [v.name for v in table.domain.metas]
        mj = meta_names.index(p.input_col)
        strings = np.asarray(table.metas[:, mj], dtype=object)
        live = table.W.cpu().numpy()[: len(strings)] > 0
        lut = {s: i for i, s in enumerate(self.labels)}
        out = np.zeros(len(strings), dtype=np.float32)
        for i, s in enumerate(strings):
            if s in lut:
                out[i] = lut[s]
            elif not live[i]:
                out[i] = 0.0  # dead (filtered) rows never error
            elif p.handle_invalid == "keep":
                out[i] = len(self.labels)
            else:
                raise ValueError(f"unseen label {s!r} (handle_invalid='error')")
        pad = np.zeros(table.n_pad, dtype=np.float32)
        pad[: len(out)] = out
        col = torch.from_numpy(pad).to(table.X.device)
        values = self.labels + (("__unknown__",) if p.handle_invalid == "keep" else ())
        var = DiscreteVariable(f"{p.input_col}_idx", values)
        new_domain = Domain(list(table.domain.attributes) + [var],
                            table.domain.class_vars, table.domain.metas)
        return table.with_X(torch.cat([table.X, col[:, None]], dim=1), new_domain)


class StringIndexer(Estimator):
    """Meta string column -> discrete index attribute (host-side fit: strings
    never live on the device, the boundary Orange draws for metas)."""

    ParamsCls = StringIndexerParams
    params: StringIndexerParams

    def _fit(self, table: TorchTable) -> StringIndexerModel:
        p = self.params
        if table.metas is None:
            raise ValueError("table has no meta columns")
        meta_names = [v.name for v in table.domain.metas]
        if p.input_col not in meta_names:
            raise ValueError(f"no meta column {p.input_col!r}")
        strings = np.asarray(table.metas[:, meta_names.index(p.input_col)], dtype=object)
        # frequency ordering counts only live rows (filter semantics)
        live = table.W.cpu().numpy()[: len(strings)] > 0
        uniq, counts = np.unique(strings[live].astype(str), return_counts=True)
        if p.order == "frequencyDesc":
            order = np.lexsort((uniq, -counts))
        elif p.order == "alphabetAsc":
            order = np.argsort(uniq)
        else:
            raise ValueError(f"unknown order {p.order!r}")
        return StringIndexerModel(p, uniq[order].tolist())


# ---------------------------------------------------------------------------
# Stateless transformers
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NormalizerParams(Params):
    p: float = 2.0               # MLlib p (row norm)


class Normalizer(Transformer):
    ParamsCls = NormalizerParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params.p
        norms = (norm32(table.X, dim=1, keepdim=True) if p == 2.0 else
                 torch.linalg.vector_norm(table.X, ord=p, dim=1, keepdim=True))
        return table.with_X(table.X / torch.clamp_min(norms, 1e-12))


@dataclasses.dataclass(frozen=True)
class BinarizerParams(Params):
    threshold: float = 0.0       # MLlib threshold
    input_cols: tuple | None = None


class Binarizer(Transformer):
    ParamsCls = BinarizerParams

    def transform(self, table: TorchTable) -> TorchTable:
        idxs = _idx_tensor(_col_indices(table, self.params.input_cols), table.X.device)
        binz = (table.X.index_select(1, idxs) > self.params.threshold).to(torch.float32)
        return table.with_X(_set_columns(table.X, idxs, binz))


class VectorAssembler(Transformer):
    """Column projection for API parity: our table IS the assembled matrix."""

    def __init__(self, input_cols: Sequence[str]):
        self.params = Params()
        self.input_cols = tuple(input_cols)

    def transform(self, table: TorchTable) -> TorchTable:
        return table.select(self.input_cols)


@dataclasses.dataclass(frozen=True)
class FeatureHasherParams(Params):
    num_features: int = 256      # MLlib numFeatures (power of two)
    input_cols: tuple = ()       # continuous and/or discrete attribute names


class FeatureHasher(Transformer):
    """MLlib FeatureHasher: a continuous column adds its value at
    crc32(name) mod num_features; a discrete column adds 1.0 at
    crc32(name + '=' + category). The buckets come from column metadata
    on the host (tiny); the rows' scatter is a product with a one-hot
    projection matrix on the device."""

    ParamsCls = FeatureHasherParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        nf = p.num_features
        dev = table.X.device
        cols = p.input_cols or tuple(v.name for v in table.domain.attributes)
        cont_idx, cont_bucket = [], []
        disc_idx, disc_maps = [], []
        for name in cols:
            var = table.domain[name]
            j = table.domain.index(name)
            if isinstance(var, DiscreteVariable):
                disc_idx.append(j)
                disc_maps.append([zlib.crc32(f"{name}={v}".encode()) % nf
                                  for v in var.values])
            else:
                cont_idx.append(j)
                cont_bucket.append(zlib.crc32(name.encode()) % nf)
        out = torch.zeros((table.n_pad, nf), dtype=torch.float32, device=dev)
        if cont_idx:
            Pm = np.zeros((len(cont_idx), nf), dtype=np.float32)
            Pm[np.arange(len(cont_idx)), cont_bucket] = 1.0
            Xc = table.X.index_select(1, _idx_tensor(cont_idx, dev))
            out = out + Xc @ device_constant(Pm, torch.float32, dev)
        for j, buckets in zip(disc_idx, disc_maps, strict=True):
            k = len(buckets)
            Pm = np.zeros((k, nf), dtype=np.float32)
            Pm[np.arange(k), buckets] = 1.0
            out = out + _one_hot(table.X[:, j], k) @ device_constant(Pm, torch.float32, dev)
        new_domain = Domain([ContinuousVariable(f"hash_{i}") for i in range(nf)],
                            table.domain.class_vars, table.domain.metas)
        return table.with_X(out, new_domain)


# ---------------------------------------------------------------------------
# Target encoding (pyspark.ml.feature.TargetEncoder, Spark 4.0)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TargetEncoderParams(Params):
    input_cols: tuple = ()        # discrete attribute names
    target_type: str = "binary"   # MLlib targetType: 'binary' | 'continuous'
    smoothing: float = 0.0        # MLlib smoothing (shrink toward the prior)
    handle_invalid: str = "error" # 'error' | 'keep' (unseen -> global prior)


class TargetEncoderModel(Model):
    """Per-category target means, smoothing-shrunk toward the global prior:
    enc[c] = (sum_y[c] + smoothing * prior) / (count[c] + smoothing)."""

    def __init__(self, params, col_idx, tables, prior):
        self.params = params
        self.col_idx = col_idx     # list[int]
        self.tables = tables       # list[f32[k+1]] (last slot = unseen)
        self.prior = prior

    @property
    def state_pytree(self):
        return {f"enc_{j}": t for j, t in zip(self.col_idx, self.tables)}

    @property
    def staged_capturable(self) -> bool:
        return self.params.handle_invalid != "error"

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        X = table.X.clone()
        new_attrs = list(table.domain.attributes)
        for j, enc, name in zip(self.col_idx, self.tables, p.input_cols, strict=True):
            k = enc.shape[0] - 1
            raw = table.X[:, j].to(torch.int32)
            if p.handle_invalid == "error":
                mx = int(torch.where(table.W > 0, raw, 0).max())
                if mx >= k:
                    raise ValueError(f"column {name!r} has unseen category {mx} "
                                     "(handle_invalid='error')")
            idx = torch.clamp(raw, 0, k - 1)
            idx = torch.where((raw < 0) | (raw >= k), k, idx)  # the unseen slot
            X[:, j] = enc[idx.to(torch.int64)]
            new_attrs[j] = ContinuousVariable(f"{name}_te")
        domain = Domain(new_attrs, table.domain.class_vars, table.domain.metas)
        return table.with_X(X, domain)


class TargetEncoder(Estimator):
    """Mean target encoding per category, the one-hot alternative for
    high-cardinality categoricals (one segment sum over the rows)."""

    ParamsCls = TargetEncoderParams
    params: TargetEncoderParams

    def _fit(self, table: TorchTable) -> TargetEncoderModel:
        p = self.params
        if not p.input_cols:
            raise ValueError("TargetEncoder needs input_cols")
        y, W = table.y, table.W
        prior = float((y * W).sum() / torch.clamp_min(W.sum(), EPS_TOTAL_WEIGHT))
        col_idx, tables = [], []
        for name in p.input_cols:
            var = table.domain[name]
            j = table.domain.index(var)
            col_idx.append(j)
            if isinstance(var, DiscreteVariable) and var.values:
                k = len(var.values)
            else:
                k = int(torch.where(W > 0, table.X[:, j], 0.0).max()) + 1
            idx = torch.clamp(table.X[:, j].to(torch.int32), 0, k - 1).to(torch.int64)
            zeros = torch.zeros((k,), dtype=torch.float32, device=W.device)
            sum_y = zeros.index_add(0, idx, y * W)
            cnt = zeros.index_add(0, idx, W)
            enc = (sum_y + p.smoothing * prior) / torch.clamp_min(cnt + p.smoothing,
                                                                  EPS_TOTAL_WEIGHT)
            enc = torch.where(cnt > 0, enc, prior)
            # slot k serves unseen categories at transform time
            tables.append(torch.cat([enc, torch.full((1,), prior, dtype=torch.float32,
                                                     device=W.device)]))
        return TargetEncoderModel(p, col_idx, tables, prior)
