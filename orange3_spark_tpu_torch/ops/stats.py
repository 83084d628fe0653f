"""Weighted statistics of the PyTorch package.

Only ``weighted_quantiles`` is ported so far: tree binning needs it
(``models/_tree.compute_bin_edges``).
"""

from __future__ import annotations

import torch

#: guard for total-weight division on empty/fully-filtered tables
EPS_TOTAL_WEIGHT = 1e-12


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
