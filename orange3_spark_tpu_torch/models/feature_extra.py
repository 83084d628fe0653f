"""The rest of ``pyspark.ml.feature``: RobustScaler, PolynomialExpansion,
DCT, Interaction, ElementwiseProduct, VectorSlicer, IndexToString,
VectorIndexer, VarianceThresholdSelector, UnivariateFeatureSelector and
ChiSqSelector, SQLTransformer (whose expression engine
``ops/relational.with_column`` evaluates string expressions with), and the
two LSH families (BucketedRandomProjectionLSH, MinHashLSH) with their
approximate neighbours and similarity join.

Port of ``orange3_spark_tpu/models/feature_extra.py``: the same transforms
on the table's device. The chi-square selector's per-column contingency
tables are grouped sums (``models/stat.contingency``) where the reference
forms one-hot products; ANOVA's and the F-test's scores are
``models/stat``'s kernels, as in the reference. The LSH families draw their
projections and hash coefficients from ``np.random.default_rng(seed)``, the
reference's numpy draws.
"""

from __future__ import annotations

import ast
import dataclasses
import itertools
import re

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, DiscreteVariable, Domain
from orange3_spark_tpu_torch.core.fmath import sqrt32
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params, Transformer
from orange3_spark_tpu_torch.models.text import _append_meta
from orange3_spark_tpu_torch.ops.hashing import to_index


def _attr_names(table: TorchTable) -> list[str]:
    return [v.name for v in table.domain.attributes]


def _col_idx(table: TorchTable, cols) -> np.ndarray:
    names = _attr_names(table)
    return np.asarray([names.index(c) for c in cols], dtype=np.int64)


def _idx_tensor(table: TorchTable, cols) -> torch.Tensor:
    return torch.from_numpy(_col_idx(table, cols)).to(table.X.device)


def _append_cols(table: TorchTable, new_vars, cols) -> TorchTable:
    domain = Domain(list(table.domain.attributes) + list(new_vars),
                    table.domain.class_vars, table.domain.metas)
    return table.with_X(torch.cat([table.X, cols], dim=1), domain)


def _set_cols(X: torch.Tensor, idx: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """X with the columns ``idx`` replaced by ``cols`` (a copy)."""
    out = X.clone()
    out[:, idx] = cols
    return out


# -------------------------------------------------------------- RobustScaler
@dataclasses.dataclass(frozen=True)
class RobustScalerParams(Params):
    lower: float = 0.25           # MLlib lower quantile
    upper: float = 0.75           # MLlib upper
    with_centering: bool = False  # MLlib withCentering
    with_scaling: bool = True     # MLlib withScaling
    input_cols: tuple = ()        # () => all attributes


class RobustScalerModel(Model):
    def __init__(self, params, median, iqr, idx):
        self.params = params
        self.median = median
        self.iqr = iqr
        self.idx = idx

    @property
    def state_pytree(self):
        return {"median": self.median, "iqr": self.iqr}

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        sub = table.X.index_select(1, self.idx)
        if p.with_centering:
            sub = sub - self.median[None, :]
        if p.with_scaling:
            sub = sub / torch.clamp_min(self.iqr, 1e-12)[None, :]
        return table.with_X(_set_cols(table.X, self.idx, sub), table.domain)


class RobustScaler(Estimator):
    """Median/IQR scaling over the live rows (W > 0): a masked sort of each
    column on the device (dead rows sort last as +inf), then the
    reference's linear interpolation at q·(n_live - 1)."""

    ParamsCls = RobustScalerParams
    params: RobustScalerParams

    def _fit(self, table: TorchTable) -> RobustScalerModel:
        p = self.params
        cols = list(p.input_cols) if p.input_cols else _attr_names(table)
        idx = _idx_tensor(table, cols)
        sub = table.X.index_select(1, idx)
        live = table.W > 0
        n_live = live.to(torch.float32).sum()
        srt = torch.sort(torch.where(live[:, None], sub, float("inf")), dim=0).values

        def q_at(q):
            pos = np.float32(q) * torch.clamp_min(n_live - 1.0, 0.0)
            lo, hi = torch.floor(pos), torch.ceil(pos)
            frac = pos - lo
            a = srt.index_select(0, lo.to(torch.int64).reshape(1))[0]
            b = srt.index_select(0, hi.to(torch.int64).reshape(1))[0]
            return a * (1 - frac) + b * frac

        med = q_at(0.5)
        iqr = q_at(p.upper) - q_at(p.lower)
        return RobustScalerModel(p, med, iqr, idx)


# ------------------------------------------------------ PolynomialExpansion
@dataclasses.dataclass(frozen=True)
class PolynomialExpansionParams(Params):
    degree: int = 2              # MLlib degree
    input_cols: tuple = ()       # () => all attributes


class PolynomialExpansion(Transformer):
    """All monomials of the inputs of degree 2 to ``degree`` (MLlib's
    expansion less the constant and linear terms the table already has),
    each a product of column slices in the reference's order."""

    ParamsCls = PolynomialExpansionParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        cols = list(p.input_cols) if p.input_cols else _attr_names(table)
        idx = _col_idx(table, cols)
        X = table.X
        new_cols, new_vars = [], []
        for deg in range(2, p.degree + 1):
            for combo in itertools.combinations_with_replacement(range(len(cols)), deg):
                prod = X[:, idx[combo[0]]]
                for j in combo[1:]:
                    prod = prod * X[:, idx[j]]
                new_cols.append(prod[:, None])
                new_vars.append(ContinuousVariable("*".join(cols[j] for j in combo)))
        if not new_cols:
            return table
        return _append_cols(table, new_vars, torch.cat(new_cols, dim=1))


# ------------------------------------------------------------------- DCT
@dataclasses.dataclass(frozen=True)
class DCTParams(Params):
    inverse: bool = False        # MLlib inverse
    input_cols: tuple = ()


class DCT(Transformer):
    """The orthonormal DCT-II across the feature axis, one [N, d] @ [d, d]
    product with the reference's float32 cosine basis."""

    ParamsCls = DCTParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        cols = list(p.input_cols) if p.input_cols else _attr_names(table)
        idx = _idx_tensor(table, cols)
        d = len(cols)
        n = np.arange(d)
        basis = np.sqrt(2.0 / d) * np.cos(np.pi * (n[:, None] + 0.5) * n[None, :] / d)
        basis[:, 0] = 1.0 / np.sqrt(d)
        B = torch.from_numpy(basis.astype(np.float32)).to(table.X.device)
        if p.inverse:
            B = B.T
        out = table.X.index_select(1, idx) @ B
        return table.with_X(_set_cols(table.X, idx, out), table.domain)


# -------------------------------------------------------------- Interaction
@dataclasses.dataclass(frozen=True)
class InteractionParams(Params):
    input_cols: tuple = ()       # columns whose product forms the interaction
    output_col: str = "interaction"


class Interaction(Transformer):
    """The product of the named columns (MLlib's Interaction over scalar
    columns)."""

    ParamsCls = InteractionParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        if len(p.input_cols) < 2:
            raise ValueError("Interaction needs >= 2 input_cols")
        idx = _col_idx(table, p.input_cols)
        prod = table.X[:, idx[0]]
        for j in idx[1:]:
            prod = prod * table.X[:, j]
        return _append_cols(table, [ContinuousVariable(p.output_col)], prod[:, None])


# -------------------------------------------------------- ElementwiseProduct
@dataclasses.dataclass(frozen=True)
class ElementwiseProductParams(Params):
    scaling_vec: tuple = ()      # MLlib scalingVec
    input_cols: tuple = ()


class ElementwiseProduct(Transformer):
    ParamsCls = ElementwiseProductParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        cols = list(p.input_cols) if p.input_cols else _attr_names(table)
        if len(p.scaling_vec) != len(cols):
            raise ValueError(
                f"scaling_vec has {len(p.scaling_vec)} entries for {len(cols)} columns")
        idx = _idx_tensor(table, cols)
        v = torch.tensor(np.asarray(p.scaling_vec, dtype=np.float32), device=table.X.device)
        out = table.X.index_select(1, idx) * v[None, :]
        return table.with_X(_set_cols(table.X, idx, out), table.domain)


# ------------------------------------------------------------- VectorSlicer
@dataclasses.dataclass(frozen=True)
class VectorSlicerParams(Params):
    names: tuple = ()            # MLlib names
    indices: tuple = ()          # MLlib indices


class VectorSlicer(Transformer):
    ParamsCls = VectorSlicerParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        names = _attr_names(table)
        keep = list(p.names) + [names[i] for i in p.indices]
        if not keep:
            raise ValueError("VectorSlicer needs names and/or indices")
        return table.select(keep)


# ------------------------------------------------------------ IndexToString
@dataclasses.dataclass(frozen=True)
class IndexToStringParams(Params):
    input_col: str = ""
    output_col: str = ""
    labels: tuple = ()           # () => the DiscreteVariable's values


class IndexToString(Transformer):
    """Inverse StringIndexer: a discrete index attribute -> host meta
    strings."""

    ParamsCls = IndexToStringParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        names = _attr_names(table)
        j = names.index(p.input_col)
        var = table.domain.attributes[j]
        labels = p.labels or getattr(var, "values", ())
        if not labels:
            raise ValueError(f"{p.input_col!r} has no labels; pass labels=")
        vals = table.X[: table.n_rows, j].cpu().numpy()
        out = np.empty(table.n_rows, dtype=object)
        for i, v in enumerate(vals):
            k = int(v)
            out[i] = labels[k] if 0 <= k < len(labels) else "__unknown__"
        return _append_meta(table, p.output_col or f"{p.input_col}_str", out)


# ------------------------------------------------------------ VectorIndexer
@dataclasses.dataclass(frozen=True)
class VectorIndexerParams(Params):
    max_categories: int = 20       # MLlib maxCategories
    handle_invalid: str = "error"  # MLlib handleInvalid: 'error' | 'keep'


class VectorIndexerModel(Model):
    def __init__(self, params, category_maps):
        self.params = params
        # {col_index: sorted distinct values} of the detected categorical columns
        self.category_maps = category_maps

    @property
    def state_pytree(self):
        return {}

    def transform(self, table: TorchTable) -> TorchTable:
        X = table.X.clone()
        new_attrs = list(table.domain.attributes)
        for j, cats in self.category_maps.items():
            c = torch.tensor(np.asarray(cats, dtype=np.float32), device=X.device)
            hit = table.X[:, j][:, None] == c[None, :]
            matched = hit.any(dim=1)
            enc = torch.argmax(hit.to(torch.uint8), dim=1).to(torch.float32)
            values = tuple(str(v) for v in cats)
            if self.params.handle_invalid == "keep":
                enc = torch.where(matched, enc, float(len(cats)))
                values = values + ("__unknown__",)
            elif bool((~matched & (table.W > 0)).any()):
                raise ValueError(
                    f"column {new_attrs[j].name!r} has values unseen at fit time "
                    "(handle_invalid='error'; use 'keep' to bucket them)")
            X[:, j] = enc
            new_attrs[j] = DiscreteVariable(new_attrs[j].name, values)
        domain = Domain(new_attrs, table.domain.class_vars, table.domain.metas)
        return table.with_X(X, domain)


class VectorIndexer(Estimator):
    """Re-types the columns of at most ``max_categories`` distinct live
    values as categorical, with an ordinal re-encoding (MLlib's automatic
    categorical feature detection)."""

    ParamsCls = VectorIndexerParams
    params: VectorIndexerParams

    def _fit(self, table: TorchTable) -> VectorIndexerModel:
        p = self.params
        X = table.X.cpu().numpy()
        live = table.W.cpu().numpy() > 0
        maps = {}
        for j in range(X.shape[1]):
            u = np.unique(X[live, j])
            if len(u) <= p.max_categories:
                maps[j] = u.astype(np.float32).tolist()
        return VectorIndexerModel(p, maps)


# ------------------------------------------- VarianceThresholdSelector
@dataclasses.dataclass(frozen=True)
class VarianceThresholdSelectorParams(Params):
    variance_threshold: float = 0.0  # MLlib varianceThreshold


class _ColumnSelectorModel(Model):
    def __init__(self, params, selected):
        self.params = params
        self.selected = tuple(selected)  # MLlib selectedFeatures (as names)

    @property
    def state_pytree(self):
        return {}

    def transform(self, table: TorchTable) -> TorchTable:
        return table.select(self.selected)


class VarianceThresholdSelector(Estimator):
    ParamsCls = VarianceThresholdSelectorParams
    params: VarianceThresholdSelectorParams

    def _fit(self, table: TorchTable):
        X, W = table.X, table.W
        sw = torch.clamp_min(W.sum(), 1e-12)
        mean = (X * W[:, None]).sum(dim=0) / sw
        var = (((X - mean) ** 2) * W[:, None]).sum(dim=0) / sw
        keep_mask = var.cpu().numpy() > self.params.variance_threshold
        keep = [n for n, k in zip(_attr_names(table), keep_mask) if k]
        return _ColumnSelectorModel(self.params, tuple(keep))


# ------------------------------------- ChiSqSelector / UnivariateFeatureSelector
@dataclasses.dataclass(frozen=True)
class UnivariateFeatureSelectorParams(Params):
    feature_type: str = "continuous"   # MLlib featureType
    label_type: str = "categorical"    # MLlib labelType
    selection_mode: str = "numTopFeatures"  # | 'percentile' | 'fpr'
    selection_threshold: float = 50    # top-N count / keep-fraction / fpr alpha
    n_bins: int = 16                   # binning for chi² on continuous features


def chi2_scores(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, k: int,
                n_bins: int) -> torch.Tensor:
    """Per-column chi² of the binned feature against the label: the live
    range of each column cut in ``n_bins`` equal bins (XLA's conversion of
    the bin position), each column's [n_bins, k] contingency table grouped
    sums of the weights, the statistic in float32 as the reference forms
    it."""
    from orange3_spark_tpu_torch.models.stat import contingency

    live = w[:, None] > 0
    lo = torch.where(live, X, float("inf")).amin(dim=0)
    hi = torch.where(live, X, float("-inf")).amax(dim=0)
    width = torch.clamp_min((hi - lo) / n_bins, 1e-12)
    b = torch.clamp(to_index((X - lo) / width), 0, n_bins - 1)
    stats = []
    for j in range(X.shape[1]):
        t = contingency(b[:, j], y, w, n_bins, k)
        rs = t.sum(dim=1, keepdim=True)
        cs = t.sum(dim=0, keepdim=True)
        tot = torch.clamp_min(t.sum(), 1e-12)
        expected = rs @ cs / tot
        stats.append(torch.where(expected > 0,
                                 (t - expected) ** 2 / torch.clamp_min(expected, 1e-12),
                                 0.0).sum())
    return torch.stack(stats)


class UnivariateFeatureSelector(Estimator):
    """Scores each feature against the label (ANOVA-F for continuous
    features and a categorical label, chi² of binned features for
    categorical ones, the squared-correlation F for a continuous label) and
    keeps the best: MLlib's selector family (ChiSqSelector is the
    feature_type='categorical' case)."""

    ParamsCls = UnivariateFeatureSelectorParams
    params: UnivariateFeatureSelectorParams

    def _fit(self, table: TorchTable):
        from orange3_spark_tpu_torch.models.stat import anova_kernel, fvalue_kernel

        p = self.params
        if table.Y is None:
            raise ValueError("selector needs a label column")
        X, y, w = table.X, table.y, table.W
        names = _attr_names(table)
        if p.label_type == "categorical":
            # masked, so that filtered rows' labels cannot raise the class count
            k = int(torch.max(torch.where(w > 0, y, 0.0))) + 1
            if p.feature_type == "categorical":
                scores = chi2_scores(X, y, w, k, p.n_bins)
            else:
                scores = anova_kernel(X, y, w, k)[0]
        else:
            scores = fvalue_kernel(X, y, w)[0]
        s = scores.cpu().numpy()
        if p.selection_mode == "numTopFeatures":
            top = np.argsort(-s)[: int(p.selection_threshold)]
        elif p.selection_mode == "percentile":
            n_keep = max(1, int(round(p.selection_threshold * len(s))))
            top = np.argsort(-s)[:n_keep]
        elif p.selection_mode == "fpr":
            from scipy import stats as sps

            n_eff = float(w.sum())
            if p.label_type == "categorical" and p.feature_type == "categorical":
                pvals = sps.chi2.sf(s, (p.n_bins - 1) * (k - 1))
            elif p.label_type == "categorical":
                pvals = sps.f.sf(s, k - 1, max(n_eff - k, 1.0))
            else:
                pvals = sps.f.sf(s, 1, max(n_eff - 2, 1.0))
            top = np.flatnonzero(pvals < p.selection_threshold)
        else:
            raise ValueError(f"unknown selection_mode {p.selection_mode!r}")
        keep = [names[i] for i in sorted(top)]
        return _ColumnSelectorModel(p, tuple(keep))


class ChiSqSelector(UnivariateFeatureSelector):
    """MLlib ChiSqSelector = UnivariateFeatureSelector with chi² scoring."""

    def __init__(self, params=None, **kwargs):
        kwargs.setdefault("feature_type", "categorical")
        kwargs.setdefault("label_type", "categorical")
        super().__init__(params, **kwargs)


# ------------------------------------------------------------ SQLTransformer
@dataclasses.dataclass(frozen=True)
class SQLTransformerParams(Params):
    statement: str = "SELECT * FROM __THIS__"  # MLlib statement


def _compare(fn):
    return lambda a, b: fn(a, b).to(torch.float32)


class SQLTransformer(Transformer):
    """The useful subset of MLlib's SQLTransformer:

        SELECT *, <expr> AS <name> [, ...] FROM __THIS__ [WHERE <cond>]

    Expressions are parsed with Python's ``ast`` (arithmetic, comparisons,
    and/or, unary minus over column names and literals, and abs, log, exp,
    sqrt, sin, cos) and evaluated as float32 column arithmetic on the
    device; a literal is a float32 constant, so the arithmetic is the
    reference's operation for operation. WHERE becomes a weight-mask
    filter (static shapes)."""

    ParamsCls = SQLTransformerParams

    _BIN = {ast.Add: torch.add, ast.Sub: torch.sub, ast.Mult: torch.mul,
            ast.Div: torch.div, ast.Mod: torch.remainder, ast.Pow: torch.pow}
    _CMP = {ast.Gt: _compare(torch.gt), ast.Lt: _compare(torch.lt),
            ast.GtE: _compare(torch.ge), ast.LtE: _compare(torch.le),
            ast.Eq: _compare(torch.eq), ast.NotEq: _compare(torch.ne)}
    _FNS = {"abs": torch.abs, "log": torch.log, "exp": torch.exp,
            "sqrt": sqrt32, "sin": torch.sin, "cos": torch.cos}

    def _eval(self, node, env):
        if isinstance(node, ast.Expression):
            return self._eval(node.body, env)
        if isinstance(node, ast.Name):
            if node.id not in env:
                raise ValueError(f"unknown column {node.id!r}")
            return env[node.id]
        if isinstance(node, ast.Constant):
            return torch.tensor(np.float32(node.value))
        if isinstance(node, ast.BinOp) and type(node.op) in self._BIN:
            return self._BIN[type(node.op)](self._eval(node.left, env),
                                            self._eval(node.right, env))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -self._eval(node.operand, env)
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            return self._CMP[type(node.ops[0])](self._eval(node.left, env),
                                                self._eval(node.comparators[0], env))
        if isinstance(node, ast.BoolOp):
            vals = [self._eval(v, env) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = (out * v) if isinstance(node.op, ast.And) else torch.maximum(out, v)
            return out
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id in self._FNS and len(node.args) == 1:
                return self._FNS[node.func.id](self._eval(node.args[0], env))
        raise ValueError(f"unsupported SQL expression node {ast.dump(node)}")

    def transform(self, table: TorchTable) -> TorchTable:
        stmt = self.params.statement.strip().rstrip(";")
        m = re.match(r"(?is)^SELECT\s+(.*?)\s+FROM\s+__THIS__(?:\s+WHERE\s+(.*))?$", stmt)
        if not m:
            raise ValueError("statement must be 'SELECT ... FROM __THIS__ [WHERE ...]'")
        select_part, where_part = m.group(1), m.group(2)
        env = {v.name: table.X[:, j] for j, v in enumerate(table.domain.attributes)}
        out = table
        new_vars, new_cols = [], []
        star = False
        for item in re.split(r",(?![^(]*\))", select_part):
            item = item.strip()
            if item == "*":
                star = True
                continue
            am = re.match(r"(?is)^(.*?)\s+AS\s+(\w+)$", item)
            if not am:
                raise ValueError(f"each non-* select item needs 'expr AS name': {item!r}")
            expr, name = am.group(1), am.group(2)
            col = self._eval(ast.parse(expr, mode="eval"), env)
            new_vars.append(ContinuousVariable(name))
            new_cols.append(col[:, None])
        if not star and not new_cols:
            raise ValueError("empty select list")
        if new_cols:
            out = _append_cols(out, new_vars, torch.cat(new_cols, dim=1))
        if not star:
            out = out.select([v.name for v in new_vars])
        if where_part:
            cond = self._eval(ast.parse(where_part, mode="eval"), env)
            out = out.filter(cond > 0)
        return out


# ----------------------------------------------------------------------- LSH
@dataclasses.dataclass(frozen=True)
class BucketedRandomProjectionLSHParams(Params):
    bucket_length: float = 1.0   # MLlib bucketLength
    num_hash_tables: int = 1     # MLlib numHashTables
    seed: int = 0
    output_prefix: str = "lsh"


class _LSHModelBase(Model):
    """Approximate neighbours and the similarity join over the hash
    columns."""

    def _hash_raw(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _distance(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _hash_cols(self, H):
        """Bucket ids as float32-exact column values."""
        return H.to(torch.float32)

    def transform(self, table: TorchTable) -> TorchTable:
        H = self._hash_cols(self._hash_raw(table.X))
        names = [f"{self.params.output_prefix}_{j}" for j in range(H.shape[1])]
        return _append_cols(table, [ContinuousVariable(n) for n in names], H)

    def approx_nearest_neighbors(self, table: TorchTable, key: np.ndarray, k: int = 2):
        """MLlib approxNearestNeighbors: the live rows sharing a bucket with
        ``key`` in at least one table, by true distance (a stable sort).
        Returns (indices, distances) as numpy."""
        keyt = torch.tensor(np.asarray(key, dtype=np.float32), device=table.X.device)[None, :]
        cand = (self._hash_raw(table.X) == self._hash_raw(keyt)).any(dim=1) & (table.W > 0)
        d = torch.where(cand, self._distance(table.X, keyt)[:, 0], float("inf"))
        idx = torch.sort(d, stable=True).indices[:k]
        idx_np, d_np = idx.cpu().numpy(), d[idx].cpu().numpy()
        ok = np.isfinite(d_np)
        return idx_np[ok], d_np[ok]

    def approx_similarity_join(self, a: TorchTable, b: TorchTable, threshold: float):
        """Pairs (i, j, dist) sharing a bucket with dist <= threshold, from
        the dense [Na, Nb] candidate mask (join sides of up to ~10^4 rows,
        as the reference)."""
        share = (self._hash_raw(a.X)[:, None, :] == self._hash_raw(b.X)[None, :, :]).any(dim=2)
        dist = self._distance(a.X, b.X)
        mask = share & (dist <= threshold) & (a.W[:, None] > 0) & (b.W[None, :] > 0)
        ii, jj = (v.cpu().numpy() for v in torch.nonzero(mask, as_tuple=True))
        dd = dist.cpu().numpy()[ii, jj]
        keep = (ii < a.n_rows) & (jj < b.n_rows)
        return ii[keep], jj[keep], dd[keep]


class BucketedRandomProjectionLSHModel(_LSHModelBase):
    def __init__(self, params, R):
        self.params = params
        self.R = R  # f32[d, T] random unit projection directions

    @property
    def state_pytree(self):
        return {"R": self.R}

    def _hash_raw(self, X):
        return torch.floor((X @ self.R) / self.params.bucket_length)

    def _distance(self, A, B):
        a2 = (A * A).sum(dim=1, keepdim=True)
        b2 = (B * B).sum(dim=1)
        cross = A @ B.T
        return sqrt32(torch.clamp_min(a2 - 2 * cross + b2[None, :], 0.0))


class BucketedRandomProjectionLSH(Estimator):
    """Euclidean LSH: h(x) = floor(x·r / bucketLength), one random unit
    direction a hash table, one [N, d] @ [d, T] product."""

    ParamsCls = BucketedRandomProjectionLSHParams
    params: BucketedRandomProjectionLSHParams

    def _fit(self, table: TorchTable) -> BucketedRandomProjectionLSHModel:
        p = self.params
        rng = np.random.default_rng(p.seed)
        R = rng.standard_normal((table.X.shape[1], p.num_hash_tables)).astype(np.float32)
        R /= np.linalg.norm(R, axis=0, keepdims=True)
        return BucketedRandomProjectionLSHModel(p, torch.from_numpy(R).to(table.X.device))


@dataclasses.dataclass(frozen=True)
class MinHashLSHParams(Params):
    num_hash_tables: int = 1
    seed: int = 0
    output_prefix: str = "minhash"


_MINHASH_PRIME = 2038074743  # MLlib's prime


class MinHashLSHModel(_LSHModelBase):
    def __init__(self, params, a, b):
        self.params = params
        self.a = np.asarray(a, dtype=np.int64)  # [T] hash coefficients (host)
        self.b = np.asarray(b, dtype=np.int64)

    @property
    def state_pytree(self):
        return {}

    def _hash_raw(self, X):
        """h_t(x) = min over the nonzero indices i of (a_t·(i+1) + b_t) mod
        prime: the [d, T] table in int64 on the host, then one masked min a
        table on the device (int32)."""
        d = X.shape[1]
        idx = np.arange(1, d + 1, dtype=np.int64)
        hv = ((self.a[None, :] * idx[:, None] + self.b[None, :]) % _MINHASH_PRIME
              ).astype(np.int32)
        hv_t = torch.from_numpy(hv).to(X.device)
        nz = X > 0
        big = torch.tensor(_MINHASH_PRIME, dtype=torch.int32, device=X.device)
        return torch.stack([torch.where(nz, hv_t[:, t][None, :], big).amin(dim=1)
                            for t in range(hv.shape[1])], dim=1)

    def _hash_cols(self, H):
        # raw ids reach ~2·10^9, past float32's exact integers: folded mod
        # 2^24 (equal buckets stay equal), as the reference
        return (H % (1 << 24)).to(torch.float32)

    def _distance(self, A, B):
        """Jaccard distance between binarized rows."""
        a = (A > 0).to(torch.float32)
        b = (B > 0).to(torch.float32)
        inter = a @ b.T
        na = a.sum(dim=1, keepdim=True)
        nb = b.sum(dim=1)
        union = torch.clamp_min(na + nb[None, :] - inter, 1e-12)
        return 1.0 - inter / union


class MinHashLSH(Estimator):
    """Jaccard LSH over binary (nonzero-support) rows: MLlib MinHashLSH."""

    ParamsCls = MinHashLSHParams
    params: MinHashLSHParams

    def _fit(self, table: TorchTable) -> MinHashLSHModel:
        p = self.params
        rng = np.random.default_rng(p.seed)
        a = rng.integers(1, _MINHASH_PRIME, size=p.num_hash_tables)
        b = rng.integers(0, _MINHASH_PRIME, size=p.num_hash_tables)
        return MinHashLSHModel(p, a, b)
