"""Weighted statistics of the PyTorch package.

One definition of the weighted moments for the whole package (describe,
standardization, the normal equations' centering), the weighted quantiles
of tree binning and ``approx_quantile``, and the two-sided p-values of the
linear models' inference statistics.
"""

from __future__ import annotations

import torch
from orange3_spark_tpu_torch.core.fmath import sqrt32, xla_sum

#: guard for total-weight division on empty/fully-filtered tables
EPS_TOTAL_WEIGHT = 1e-12
#: iterations of the incomplete beta's continued fraction (float64): within
#: 1e-9 of jax.scipy's float64 betainc for a, b in [0.1, 1e6] and over the
#: t-test grid (tests/test_torch_table_stats.py)
BETAINC_ITERS = 100


def weighted_moments(X: torch.Tensor, w: torch.Tensor, group=None):
    """Per-column weighted moments: (mean[d], var[d], total_weight[]), the
    population variance (MLlib's convention for standardization). The
    column sums in XLA:CPU's order (``xla_sum``) on either device: the
    one-device reference's bits. ``group``: a gang's data group (X, w this
    rank's rows): the sums are then folded over the ranks in rank order,
    (Σw, Σw·x) in one gather and Σw·(x - mean)² in a second."""
    from orange3_spark_tpu_torch.parallel.collectives import world_fold

    wcol = w[:, None]
    if group is None:
        tot = torch.clamp_min(xla_sum(w), EPS_TOTAL_WEIGHT)
        mean = xla_sum(X * wcol) / tot
    else:
        first = world_fold(torch.cat([xla_sum(w).reshape(1), xla_sum(X * wcol)]), group)
        tot = torch.clamp_min(first[0], EPS_TOTAL_WEIGHT)
        mean = first[1:] / tot
    var = world_fold(xla_sum((X - mean) ** 2 * wcol), group) / tot
    return mean, var, tot


def inv_std_scale(X: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """1/std per column (1.0 for constant columns): MLlib's scale-only
    standardization factor (over a gang's ranks with ``group``)."""
    _, var, _ = weighted_moments(X, w, group)
    std = sqrt32(var)
    return torch.where(std > 1e-12, 1.0 / std, 1.0)


def two_sided_z_pvalue(z: torch.Tensor) -> torch.Tensor:
    """2·Φ̄(|z|), the two-sided normal test, on the device via erfc."""
    return torch.special.erfc(torch.abs(z) / sqrt32(torch.tensor(2.0, dtype=z.dtype)))


def two_sided_t_pvalue(t: torch.Tensor, df) -> torch.Tensor:
    """2·sf_t(|t|; df), the two-sided Student-t test, through the
    regularized incomplete beta I_{df/(df+t²)}(df/2, 1/2). Computed in
    float64 on ``t``'s device and returned in ``t``'s dtype."""
    t64 = t.to(torch.float64)
    df = torch.clamp_min(torch.as_tensor(df, dtype=torch.float64, device=t.device), 1.0)
    x = df / (df + t64 * t64)
    return betainc(df / 2.0, torch.full_like(x, 0.5), x).to(t.dtype)


def betainc(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Regularized incomplete beta I_x(a, b), elementwise, in float64.

    PyTorch has no ``betainc``. This is the continued fraction of Numerical
    Recipes (``betacf``) by the modified Lentz method, run for a fixed
    ``BETAINC_ITERS`` iterations (no data-dependent loop exit, so nothing
    waits for the device), on the side of the symmetry I_x(a, b) =
    1 - I_{1-x}(b, a) where it converges fast: x < (a+1)/(a+b+2)."""
    a, b, x = torch.broadcast_tensors(*(torch.as_tensor(v, dtype=torch.float64,
                                                         device=x.device)
                                        for v in (a, b, x)))
    flip = x >= (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(flip, b, a), torch.where(flip, a, b)
    xx = torch.where(flip, 1.0 - x, x)
    tiny = 1e-300
    qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0
    c = torch.ones_like(xx)
    d = 1.0 - qab * xx / qap
    d = 1.0 / torch.where(d.abs() < tiny, tiny, d)
    h = d
    for m in range(1, BETAINC_ITERS + 1):
        m2 = 2.0 * m
        for num in (m * (bb - m) * xx / ((qam + m2) * (aa + m2)),
                    -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))):
            d = 1.0 + num * d
            d = 1.0 / torch.where(d.abs() < tiny, tiny, d)
            c = 1.0 + num / c
            c = torch.where(c.abs() < tiny, tiny, c)
            h = h * d * c
    log_front = (torch.lgamma(qab) - torch.lgamma(aa) - torch.lgamma(bb)
                 + aa * torch.log(xx) + bb * torch.log1p(-xx))
    inner = torch.exp(log_front) * h / aa
    out = torch.where(flip, 1.0 - inner, inner)
    out = torch.where(x <= 0.0, 0.0, out)
    return torch.where(x >= 1.0, 1.0, out)


def weighted_quantiles(X: torch.Tensor, w: torch.Tensor,
                       qs: torch.Tensor) -> torch.Tensor:
    """Per-column weighted quantiles (DataFrame.approxQuantile parity).

    Exact: a stable sort per column, then the first position whose
    cumulative weight reaches ``q·total``. Zero-weight (padding/filtered) rows
    are never selected, including at q=0. Columns with zero total weight
    return 0.0.

    X: f32[N, d]; w: f32[N] or f32[N, d] per-cell weights; qs: f32[q].
    Returns f32[q, d].

    The JAX version counts ``cw < target`` over a [q, N, d] comparison, which
    eager PyTorch would materialise (about 9 GB at 11M rows × 28 features ×
    31 quantiles). Here the columns are laid out as rows of a [d, N] tensor
    and ``searchsorted`` of the targets into the non-decreasing cumulative
    weights gives the same count. With unit or zero weights the cumulative
    sums are exact integers below 2^24, so the result is bitwise the
    reference's.
    """
    N = X.shape[0]
    Xt = X.T.contiguous()                                     # [d, N]
    Wt = (w[None, :].expand_as(Xt) if w.ndim == 1 else w.T).contiguous()
    # stable, like jnp.argsort; NaN sorts last in both
    Xs, order = torch.sort(Xt, dim=1, stable=True)
    ws = torch.gather(Wt, 1, order)
    del order, Wt
    cw = torch.cumsum(ws, dim=1)                              # [d, N]
    tot_raw = cw[:, -1]                                       # [d]
    tot = torch.clamp_min(tot_raw, EPS_TOTAL_WEIGHT)
    # clip the target above zero so leading zero-weight runs — where cw is
    # still exactly 0 — are never selected, even at q=0
    targets = torch.clamp_min(tot[:, None] * qs[None, :].to(tot),
                              EPS_TOTAL_WEIGHT)               # [d, q]
    idx = torch.searchsorted(cw, targets.contiguous())        # #(cw < target)
    idx = torch.clamp(idx, 0, N - 1)
    out = torch.gather(Xs, 1, idx)                            # [d, q]
    out = torch.where(tot_raw[:, None] > 0, out, 0.0)
    return out.T
