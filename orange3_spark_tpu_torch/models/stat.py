"""Statistics: ``pyspark.ml.stat``'s Correlation (Pearson and Spearman),
ChiSquareTest, Summarizer, KolmogorovSmirnovTest, ANOVATest, FValueTest and
MultivariateGaussian.

Port of ``orange3_spark_tpu/models/stat.py``: the same statistics, the same
float32 arithmetic on the table's device. Where the reference sums by a
one-hot product (the contingency table, ANOVA's class sums) the port runs
``ops/relational.grouped_sums``: a stable sort of the group index and one
``segment_sum_sorted`` launch, O(N) memory at any category count.
Spearman's tie groups are sorted segments by construction, so their rank
sums are one ``segment_sum_sorted`` launch over every column at once.

P-values: the chi-square tail is scipy's ``gammaincc`` on the host, in
float64 of the reference's float32 arguments (the reference's float32
``jax.scipy.special.gammaincc`` agrees within 1e-5 relative); the F tail is
``ops/stats.betainc`` in float64 on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from orange3_spark_tpu_torch.core.fmath import sqrt32
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.ops.hashing import to_index
from orange3_spark_tpu_torch.ops.relational import grouped_sums
from orange3_spark_tpu_torch.ops.segment_sum import segment_sum_sorted
from orange3_spark_tpu_torch.ops.stats import EPS_TOTAL_WEIGHT, betainc, weighted_moments

__all__ = ["ANOVATest", "ChiSquareResult", "ChiSquareTest", "Correlation", "FTestResult",
           "FValueTest", "KSTestResult", "KolmogorovSmirnovTest", "MultivariateGaussian",
           "Summarizer", "Summary", "anova_kernel", "fvalue_kernel"]

_BIG = float(np.finfo(np.float32).max)


# ------------------------------------------------------------- correlation
def _pearson(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted Pearson correlation matrix [d, d]."""
    mean, var, tot = weighted_moments(X, w)
    Xc = X - mean
    cov = (Xc * w[:, None]).T @ Xc / tot
    std = sqrt32(torch.clamp_min(var, 0.0))
    denom = torch.outer(std, std)
    corr = torch.where(denom > EPS_TOTAL_WEIGHT,
                       cov / torch.clamp_min(denom, EPS_TOTAL_WEIGHT), 0.0)
    corr = torch.clamp(corr, -1.0, 1.0)
    corr.fill_diagonal_(1.0)
    return corr


def tie_averaged_ranks(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-column fractional (tie-averaged) ranks of the live rows; dead
    rows (w == 0) sort last as float32's max, as in the reference. A stable
    sort per column; the tie groups of column j become the segments
    ``j·N + group`` of one sorted list, whose position sums and counts are
    one ``segment_sum_sorted`` launch."""
    N, d = X.shape
    Xm = torch.where(w[:, None] > 0, X, _BIG)
    Xs, order = torch.sort(Xm, dim=0, stable=True)
    new_group = torch.ones_like(Xs, dtype=torch.int32)
    new_group[1:] = (Xs[1:] != Xs[:-1]).to(torch.int32)
    gid = torch.cumsum(new_group, dim=0, dtype=torch.int64) - 1            # [N, d]
    seg = (gid + torch.arange(d, device=X.device)[None, :] * N).T.reshape(-1)
    pos = torch.arange(1, N + 1, dtype=torch.float32, device=X.device)
    g = torch.stack([pos.repeat(d), torch.ones(N * d, device=X.device)], dim=1)
    sums = segment_sum_sorted(g, seg, N * d)
    avg = sums[:, 0] / torch.clamp_min(sums[:, 1], 1.0)
    avg_sorted = avg.index_select(0, seg).reshape(d, N).T
    return torch.empty_like(avg_sorted).scatter_(0, order, avg_sorted)


class Correlation:
    """``pyspark.ml.stat.Correlation.corr`` equivalent."""

    @staticmethod
    def corr(table: TorchTable, method: str = "pearson") -> np.ndarray:
        X, w = table.X, table.W
        if method == "pearson":
            return _pearson(X, w).cpu().numpy()
        if method == "spearman":
            return _pearson(tie_averaged_ranks(X, w), w).cpu().numpy()
        raise ValueError(f"method must be 'pearson' or 'spearman', got {method!r}")


# ----------------------------------------------------------- chi-square test
class ChiSquareResult(NamedTuple):
    p_values: np.ndarray            # f64[n_features]
    degrees_of_freedom: np.ndarray  # i64[n_features]
    statistics: np.ndarray          # f64[n_features]


def chi2_sf(stat, dof) -> float:
    """Chi-square survival function, the regularized upper gamma of
    float32 arguments, in float64 on the host."""
    from scipy.special import gammaincc

    a = np.float64(np.maximum(np.float32(dof), np.float32(1.0)) / np.float32(2.0))
    return float(gammaincc(a, np.float64(np.float32(stat) / np.float32(2.0))))


def contingency(f: torch.Tensor, y: torch.Tensor, w: torch.Tensor, m: int,
                k: int) -> torch.Tensor:
    """Weighted [m, k] contingency table of one categorical column against
    the label, as grouped sums of the weights by ``f·k + y``: both convert
    to int as XLA does (NaN to 0), and a value outside [0, m) or a label
    outside [0, k) counts nowhere, as a zero row of the reference's
    one-hot."""
    fi = to_index(f).to(torch.int64)
    yi = to_index(y).to(torch.int64)
    ok = (fi >= 0) & (fi < m) & (yi >= 0) & (yi < k)
    slot = torch.where(ok, fi * k + yi, m * k).to(torch.int32)
    return grouped_sums(slot, w[:, None].contiguous(), m * k).reshape(m, k)


class ChiSquareTest:
    """``pyspark.ml.stat.ChiSquareTest.test`` equivalent: Pearson's
    independence test of each categorical feature column (small
    non-negative integers) against the categorical class column."""

    @staticmethod
    def test(table: TorchTable, feature_cols: Sequence[str] | None = None) -> ChiSquareResult:
        y, w = table.y, table.W
        names = list(feature_cols) if feature_cols is not None else [
            v.name for v in table.domain.attributes]
        cols = [table.column(name) for name in names]
        live = w > 0
        maxes = torch.stack([torch.max(torch.where(live, c, 0.0)) for c in cols]
                            + [torch.max(torch.where(live, y, 0.0))]).cpu().numpy()
        k = int(maxes[-1]) + 1
        m = int(maxes[:-1].max()) + 1 if names else 1
        stats, dofs, ps = [], [], []
        for f in cols:
            obs_np = contingency(f, y, w, m, k).cpu().numpy().astype(np.float64)
            row = obs_np.sum(1, keepdims=True)
            col = obs_np.sum(0, keepdims=True)
            tot = max(obs_np.sum(), EPS_TOTAL_WEIGHT)
            exp = row @ col / tot
            ok = (row > 0) & (col > 0)
            stat = float(((obs_np - exp) ** 2 / np.where(ok, exp, 1.0))[ok].sum())
            dof = max((int((row > 0).sum()) - 1) * (int((col > 0).sum()) - 1), 0)
            stats.append(stat)
            dofs.append(dof)
            ps.append(chi2_sf(stat, dof) if dof > 0 else 1.0)
        return ChiSquareResult(np.array(ps), np.array(dofs), np.array(stats))


# ---------------------------------------------------------------- summarizer
class Summary(NamedTuple):
    mean: np.ndarray
    variance: np.ndarray    # unbiased weighted variance (MLlib convention)
    std: np.ndarray
    count: int              # live row count
    weight_sum: float
    num_non_zeros: np.ndarray
    max: np.ndarray
    min: np.ndarray
    norm_l1: np.ndarray     # Σ w·|x|
    norm_l2: np.ndarray     # sqrt(Σ w·x²)
    sum: np.ndarray         # Σ w·x


class Summarizer:
    """``pyspark.ml.stat.Summarizer`` equivalent: one pass of column
    reductions."""

    @staticmethod
    def metrics(table: TorchTable) -> Summary:
        X, w = table.X, table.W
        mean, var_pop, tot = weighted_moments(X, w)
        wcol = w[:, None]
        live = wcol > 0
        count = live.to(torch.float32)[:, 0].sum()
        # MLlib's MultivariateOnlineSummarizer divides M2 by (Σw - 1)
        var = var_pop * tot / torch.clamp_min(tot - 1.0, EPS_TOTAL_WEIGHT)
        nnz = ((X.abs() > 0) & live).sum(dim=0).to(torch.float32)
        mx = torch.where(live, X, -_BIG).amax(dim=0)
        mn = torch.where(live, X, _BIG).amin(dim=0)
        l1 = (X.abs() * wcol).sum(dim=0)
        l2 = sqrt32((X * X * wcol).sum(dim=0))
        s = (X * wcol).sum(dim=0)
        host = [t.cpu().numpy() for t in (mean, var, count, tot, nnz, mx, mn, l1, l2, s)]
        mean, var, count, tot, nnz, mx, mn, l1, l2, s = host
        return Summary(mean=mean, variance=var, std=np.sqrt(np.maximum(var, 0.0)),
                       count=int(count), weight_sum=float(tot), num_non_zeros=nnz,
                       max=mx, min=mn, norm_l1=l1, norm_l2=l2, sum=s)


# ------------------------------------------------------ Kolmogorov–Smirnov
class KSTestResult(NamedTuple):
    p_value: float
    statistic: float


def _ks_pvalue(d: float, n: float) -> float:
    """Asymptotic Kolmogorov distribution tail, Q(√n·D) (the reference's
    host formula)."""
    t = (np.sqrt(n) + 0.12 + 0.11 / np.sqrt(n)) * d
    j = np.arange(1, 101)
    return float(np.clip(2.0 * np.sum((-1.0) ** (j - 1) * np.exp(-2.0 * j**2 * t**2)),
                         0.0, 1.0))


class KolmogorovSmirnovTest:
    """``pyspark.ml.stat.KolmogorovSmirnovTest.test`` equivalent ('norm')."""

    @staticmethod
    def test(table: TorchTable, col: str, dist: str = "norm",
             loc: float = 0.0, scale: float = 1.0) -> KSTestResult:
        if dist != "norm":
            raise ValueError(f"only dist='norm' is supported, got {dist!r}")
        x, w = table.column(col), table.W
        N = x.shape[0]
        live = w > 0
        n = torch.clamp_min(live.to(torch.float32).sum(), 1.0)
        xs = torch.sort(torch.where(live, x, _BIG)).values
        cdf = torch.special.ndtr((xs - float(np.float32(loc))) / float(np.float32(scale)))
        i = torch.arange(1, N + 1, dtype=torch.float32, device=x.device)
        in_range = i <= n
        d_plus = torch.where(in_range, i / n - cdf, -1.0)
        d_minus = torch.where(in_range, cdf - (i - 1.0) / n, -1.0)
        d, n = (float(v) for v in torch.stack(
            [torch.maximum(d_plus.max(), d_minus.max()), n]).cpu())
        return KSTestResult(p_value=_ks_pvalue(d, n), statistic=d)


# ------------------------------------------------------- ANOVA / F-value
class FTestResult(NamedTuple):
    p_values: np.ndarray            # f64[n_features]
    degrees_of_freedom: np.ndarray  # i64[n_features, 2]: (df_between, df_within)
    f_values: np.ndarray            # f64[n_features]


def f_sf(f: torch.Tensor, d1, d2) -> torch.Tensor:
    """F survival function, I_{d2/(d2 + d1·f)}(d2/2, d1/2), in float64."""
    f64 = torch.clamp_min(f.to(torch.float64), 0.0)
    d1 = torch.as_tensor(d1, dtype=torch.float64, device=f.device)
    d2 = torch.as_tensor(d2, dtype=torch.float64, device=f.device)
    x = d2 / (d2 + d1 * f64)
    return betainc(d2 / 2.0, d1 / 2.0, x)


def anova_kernel(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, k: int):
    """Per-column one-way ANOVA F, its dfs and p-values of continuous
    features against a k-class label (weighted). The class sums are grouped
    sums of ``[w, w·X]`` by label (the reference's one-hot product)."""
    yi = to_index(y).to(torch.int64)
    slot = torch.where((yi >= 0) & (yi < k), yi, k).to(torch.int32)
    g = grouped_sums(slot, torch.cat([w[:, None], X * w[:, None]], dim=1).contiguous(), k)
    raw_cnt, grp_sum = g[:, 0], g[:, 1:]
    cnt = torch.clamp_min(raw_cnt, 1e-12)
    tot_w = torch.clamp_min(w.sum(), 1e-12)
    grand = (X * w[:, None]).sum(dim=0) / tot_w
    grp_mean = grp_sum / cnt[:, None]
    ss_between = (cnt[:, None] * (grp_mean - grand[None, :]) ** 2).sum(dim=0)
    ex2 = ((X * X) * w[:, None]).sum(dim=0)
    ss_within = ex2 - (cnt[:, None] * grp_mean ** 2).sum(dim=0)
    n_grp = (raw_cnt > 1e-6).sum().to(torch.float32)
    df_b = torch.clamp_min(n_grp - 1.0, 1.0)
    df_w = torch.clamp_min(tot_w - n_grp, 1.0)
    f = (ss_between / df_b) / torch.clamp_min(ss_within / df_w, 1e-12)
    return f, df_b, df_w, f_sf(f, df_b, df_w)


def _feature_matrix(table: TorchTable, feature_cols):
    names = list(feature_cols) if feature_cols is not None else [
        v.name for v in table.domain.attributes]
    X = (table.X if feature_cols is None
         else torch.stack([table.column(n) for n in names], dim=1))
    return names, X


class ANOVATest:
    """``pyspark.ml.stat.ANOVATest.test`` equivalent (Spark 3.1): one-way
    ANOVA of each continuous feature against the categorical class."""

    @staticmethod
    def test(table: TorchTable, feature_cols: Sequence[str] | None = None) -> FTestResult:
        names, X = _feature_matrix(table, feature_cols)
        y, w = table.y, table.W
        k = int(torch.max(torch.where(w > 0, y, 0.0))) + 1
        f, df_b, df_w, p = anova_kernel(X, y, w, k)
        d = len(names)
        dofs = np.stack([np.full(d, int(df_b)), np.full(d, int(df_w))], axis=1)
        return FTestResult(p.cpu().numpy().astype(np.float64), dofs,
                           f.cpu().numpy().astype(np.float64))


def fvalue_kernel(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Per-column regression F-test against a continuous label: F =
    r²/(1 - r²)·df2, df (1, n - 2), r the weighted Pearson correlation."""
    tot_w = torch.clamp_min(w.sum(), 1e-12)
    xm = (X * w[:, None]).sum(dim=0) / tot_w
    ym = (y * w).sum() / tot_w
    xc = X - xm[None, :]
    yc = y - ym
    cov = (xc * (yc * w)[:, None]).sum(dim=0)
    vx = torch.clamp_min((xc * xc * w[:, None]).sum(dim=0), 1e-12)
    vy = torch.clamp_min((yc * yc * w).sum(), 1e-12)
    r2 = torch.clamp(cov * cov / (vx * vy), 0.0, float(np.float32(1.0 - 1e-9)))
    df2 = torch.clamp_min(tot_w - 2.0, 1.0)
    f = r2 / (1.0 - r2) * df2
    return f, df2, f_sf(f, 1.0, df2)


class FValueTest:
    """``pyspark.ml.stat.FValueTest.test`` equivalent (Spark 3.1)."""

    @staticmethod
    def test(table: TorchTable, feature_cols: Sequence[str] | None = None) -> FTestResult:
        names, X = _feature_matrix(table, feature_cols)
        f, df2, p = fvalue_kernel(X, table.y, table.W)
        d = len(names)
        dofs = np.stack([np.ones(d, np.int64), np.full(d, int(df2))], axis=1)
        return FTestResult(p.cpu().numpy().astype(np.float64), dofs,
                           f.cpu().numpy().astype(np.float64))


# -------------------------------------------------- multivariate gaussian
class MultivariateGaussian:
    """``pyspark.ml.stat.distribution.MultivariateGaussian`` equivalent: the
    reference's construction (a float64 eigendecomposition on the host, a
    float32-scaled rank tolerance, MLlib's full-dimension normalisation),
    then ``logpdf`` of a batch on ``device`` (default: the active
    session's)."""

    def __init__(self, mean, cov, device=None):
        from orange3_spark_tpu_torch.core.session import TorchSession

        mean64 = np.asarray(mean, np.float64)
        cov64 = np.asarray(cov, np.float64)
        d = mean64.shape[0]
        if cov64.shape != (d, d):
            raise ValueError(f"cov must be ({d},{d}), got {cov64.shape}")
        evals, evecs = np.linalg.eigh(cov64)
        tol = (np.finfo(np.float32).eps * d) * np.max(np.abs(evals))
        live = evals > tol
        if not live.any():
            raise ValueError("covariance matrix has no non-zero eigenvalue")
        inv = np.zeros(d)
        inv[live] = 1.0 / evals[live]
        dev = TorchSession.active().device if device is None else torch.device(device)
        self.mean = torch.tensor(mean64, dtype=torch.float32, device=dev)
        self.cov = torch.tensor(cov64, dtype=torch.float32, device=dev)
        self._root_inv = torch.tensor(evecs * np.sqrt(inv)[None, :], dtype=torch.float32,
                                      device=dev)
        log_pseudo_det = float(np.sum(np.log(evals[live])))
        self._log_norm = float(np.float32(-0.5 * (d * float(np.log(2.0 * np.pi))
                                                  + log_pseudo_det)))

    def logpdf(self, x) -> torch.Tensor:
        """log N(x; mean, cov) for one point [d] or a batch [n, d]."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.mean.device)
        xb = x[None, :] if x.ndim == 1 else x
        z = (xb - self.mean[None, :]) @ self._root_inv
        out = self._log_norm - 0.5 * (z * z).sum(dim=1)
        return out[0] if x.ndim == 1 else out

    def pdf(self, x) -> torch.Tensor:
        return torch.exp(self.logpdf(x))
