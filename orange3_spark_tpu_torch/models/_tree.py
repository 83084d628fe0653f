"""Histogram-based decision-tree induction on tensors.

Port of ``orange3_spark_tpu/models/_tree.py``, same algorithm and layout:

* features are quantile-binned once to int32 bins (the reference's layout),
  and a fit keeps one uint8 copy of them (``compact_bins``) for the kernel
  and the row routing;
* the tree is a PERFECT binary tree of static depth D: dead nodes stop
  splitting (split_bin = n_bins routes all rows left);
* per level, ``ops.histogram.node_histograms`` sums the row stats per
  (feature, node, bin), and split selection is a cumsum over bins plus an
  argmax over (feature, bin), all on the device with no host sync;
* the tree axis is explicit: ``grow_tree`` takes stats f32[T, N, s] for a
  forest of T trees (one kernel launch per level for all of them), or
  f32[N, s] for one tree.

Gain modes: 'gini' (classification, stats = per-class weighted counts),
'variance' ([Σwy, Σwy², Σw]) and 'newton' ([G, H, Σw], used by GBT).

The two other sums of a tree, the importances (chosen gains by feature)
and the leaf stat sums (row stats by leaf), are ``index_add_`` on the CPU,
in the reference's order. On CUDA, where that would add with float atomics
in an order that changes from run to run, they go through the same
fixed-point kernel as one histogram with a single constant bin
(``_bucket_sums``): integer adds, the same bits on every run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orange3_spark_tpu_torch.ops.histogram import node_histograms
from orange3_spark_tpu_torch.ops.stats import weighted_quantiles

EPS = 1e-12


class Tree(NamedTuple):
    """Perfect binary tree of depth D over binned features.

    feature:    i32[2^D - 1]    split feature per internal node (level order)
    split_bin:  i32[2^D - 1]    go left iff bin <= split_bin (n_bins => leaf)
    threshold:  f32[2^D - 1]    raw-value threshold (edges[feature, split_bin])
    leaf_value: f32[2^D, s_out] value at each depth-D leaf

    A forest stacks its trees on a leading axis: [T, 2^D - 1] and [T, 2^D, s].
    """

    feature: torch.Tensor
    split_bin: torch.Tensor
    threshold: torch.Tensor
    leaf_value: torch.Tensor

    @property
    def depth(self) -> int:
        # leaf axis is second-to-last so this holds for stacked forests too
        return self.leaf_value.shape[-2].bit_length() - 1


def compute_bin_edges(X, W, max_bins: int):
    """Weighted-quantile bin boundaries: f32[d, max_bins - 1]."""
    # i · float32(1/max_bins): the values jnp.linspace(0, 1, max_bins + 1)
    # gives on the CPU, so the edges can be bitwise the reference's
    step = np.float32(1.0) / np.float32(max_bins)
    qs = torch.arange(1, max_bins, dtype=torch.float32, device=X.device) * float(step)
    return weighted_quantiles(X, W, qs).T.contiguous()


def bin_features(X, edges):
    """int32 bins: B[n, f] = #edges strictly below X[n, f] (0..max_bins-1).

    The JAX version sums ``X[:, :, None] > edges[None]``, which eager
    PyTorch would materialise as [N, d, max_bins - 1] bools (9.3 GB at HIGGS
    size). ``searchsorted`` (left side) of each value into its column's
    sorted edges gives the same count. Two cases need care, because
    searchsorted orders NaN above every number while ``>`` is false for it:
    a NaN value goes to bin 0, as the comparison form gives, and a NaN edge
    (the tail of a column's sorted NaNs) counts as +inf, below no value.
    """
    e = torch.where(torch.isnan(edges), torch.inf, edges).contiguous()
    Xt = X.T.contiguous()                                       # [d, N]
    B = torch.searchsorted(e, Xt, out_int32=True)
    B = torch.where(torch.isnan(Xt), 0, B)
    return B.T.contiguous()


def compact_bins(B, n_bins: int):
    """uint8 copy of int32 bins when every bin fits (n_bins <= 256): a
    quarter of the bytes for the histogram kernel and the row routing."""
    return B.to(torch.uint8) if n_bins <= 256 else B


_SCAN_BLOCK = 16


def bin_cumsum(H):
    """Cumulative sum over the bin axis of H f32[..., n_bins, s].

    Summed in the order XLA's CPU backend sums ``jnp.cumsum`` (its
    reduce-window rewrite): sequentially within blocks of 16 bins, then the
    running total of the earlier blocks added on. Split candidates that
    send the same rows left have equal gains in exact arithmetic, and the
    summation order decides which of them rounds highest; in the
    reference's order, identical histograms give the reference's argmax.
    The adds are explicit fp32 adds: ``torch.cumsum`` on the CPU accumulates
    in double. Exact for up to 16·16 = 256 bins.
    """
    n_bins, s = H.shape[-2:]
    lead = H.shape[:-2]
    n_blk = -(-n_bins // _SCAN_BLOCK)
    pad = n_blk * _SCAN_BLOCK - n_bins
    Hp = torch.nn.functional.pad(H, (0, 0, 0, pad)) if pad else H
    within = Hp.reshape(*lead, n_blk, _SCAN_BLOCK, s).clone()
    for k in range(1, _SCAN_BLOCK):
        within[..., k, :] += within[..., k - 1, :]
    if n_blk > 1:
        carry = torch.zeros_like(within[..., 0, :])             # [..., n_blk, s]
        for b in range(1, n_blk):
            carry[..., b, :] = carry[..., b - 1, :] + within[..., b - 1, -1, :]
        within += carry[..., None, :]
    return within.reshape(*lead, n_blk * _SCAN_BLOCK, s)[..., :n_bins, :]


def _impurity_gain(Hc, gain_mode: str, reg: float, min_instances: float):
    """Split gains from cumulative histograms.

    Hc: f32[..., d, nodes, bins, s] cumulative-over-bins stats; candidate
    'split at bin b' sends bins <= b left. Returns gains
    f32[..., d, nodes, bins] with invalid candidates at -inf, and the node
    weights f32[..., nodes].
    """
    total = Hc[..., -1:, :]
    left, right = Hc, total - Hc

    if gain_mode == "gini":
        def gini_w(S):  # S [..., k] class counts -> weighted gini * count
            c = S.sum(-1)
            p2 = (S * S).sum(-1) / torch.clamp_min(c, EPS)
            return c - p2  # = c * (1 - sum p_i^2)
        gain = gini_w(total) - gini_w(left) - gini_w(right)
        wl = left.sum(-1)
        wr = right.sum(-1)
    elif gain_mode == "variance":
        def var_w(S):  # [Σwy, Σwy², Σw] -> weighted variance * count
            s1, s2, c = S[..., 0], S[..., 1], S[..., 2]
            return s2 - s1 * s1 / torch.clamp_min(c, EPS)
        gain = var_w(total) - var_w(left) - var_w(right)
        wl, wr = left[..., 2], right[..., 2]
    elif gain_mode == "newton":
        def score(S):  # [G, H, Σw] -> -loss reduction potential
            return S[..., 0] ** 2 / torch.clamp_min(S[..., 1] + reg, EPS)
        gain = 0.5 * (score(left) + score(right) - score(total))
        wl, wr = left[..., 2], right[..., 2]
    else:  # pragma: no cover
        raise ValueError(gain_mode)

    valid = (wl >= min_instances) & (wr >= min_instances)
    # node weight for MLlib-style NORMALIZED min-gain thresholds
    if gain_mode == "gini":
        node_w = total.sum(-1)[..., 0, :, 0]   # [..., nodes]
    else:
        node_w = total[..., 0, :, 0, 2]        # [..., nodes]
    return torch.where(valid, gain, -torch.inf), node_w


def grow_tree(
    B,            # u8 or i32[N, d] binned features
    S,            # f32[N, s] or f32[T, N, s] per-row stats
    edges,        # f32[d, n_bins - 1] raw bin boundaries
    feat_keep,    # f32[depth, d] or f32[T, depth, d] per-level feature
                  # masks, or None: every feature at every level
    min_gain,     # float minimum gain to split (MLlib minInfoGain)
    *,
    depth: int,
    n_bins: int,
    gain_mode: str,
    reg: float = 1.0,
    min_instances: float = 1.0,
):
    """Grow one depth-D tree, or T trees at once on a leading tree axis.

    Returns (Tree, pos, imp): pos i32[(T,) N] is the leaf of each row and imp
    f32[(T,) d] the per-feature sum of chosen split gains. The level loop
    reads nothing back to the host. The histograms of masked features are
    not built (feature 0's always is: it gives the node weights).
    """
    single = S.ndim == 2
    if single:
        S = S[None]
        feat_keep = None if feat_keep is None else feat_keep[None]
    T, N, s = S.shape
    d = B.shape[1]
    dev = S.device
    n_internal = 2**depth - 1
    feature = torch.zeros((T, n_internal), dtype=torch.int32, device=dev)
    split_bin = torch.full((T, n_internal), n_bins, dtype=torch.int32, device=dev)
    threshold = torch.full((T, n_internal), torch.inf, dtype=torch.float32,
                           device=dev)
    pos = torch.zeros((T, N), dtype=torch.int32, device=dev)
    gain_at = torch.zeros((T, n_internal), dtype=torch.float32, device=dev)

    for level in range(depth):
        nodes = 2**level
        keep = None if feat_keep is None else feat_keep[:, level]
        H = node_histograms(B, S, pos, nodes=nodes, n_bins=n_bins, features=keep)
        Hc = bin_cumsum(H.view(T, d, nodes, n_bins, s))
        gains, node_w = _impurity_gain(Hc, gain_mode, reg, min_instances)
        if keep is not None:
            gains = torch.where(keep[..., None, None] > 0, gains, -torch.inf)
        # flatten (nodes, d*n_bins) exactly as the reference does: argmax
        # returns the first maximum in both, so ties resolve the same way
        flat = gains.permute(0, 2, 1, 3).reshape(T, nodes, d * n_bins)
        best = torch.argmax(flat, dim=2)                            # [T, nodes]
        best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
        bf = (best // n_bins).to(torch.int32)
        bb = (best % n_bins).to(torch.int32)
        # MLlib minInfoGain semantics: threshold the PER-WEIGHT gain
        do_split = best_gain > min_gain * torch.clamp_min(node_w, EPS)
        bf = torch.where(do_split, bf, 0)
        bb = torch.where(do_split, bb, n_bins)                      # leaf
        thr = torch.where(
            bb < n_bins - 1,
            edges[bf.long(), torch.clamp(bb, 0, n_bins - 2).long()],
            torch.inf,
        )
        thr = torch.where(do_split, thr, torch.inf)
        off = nodes - 1  # level-order offset of this level
        gain_at[:, off:off + nodes] = torch.where(do_split, best_gain, 0.0)
        feature[:, off:off + nodes] = bf
        split_bin[:, off:off + nodes] = bb
        threshold[:, off:off + nodes] = thr
        # ---- route rows ----
        node = pos.long()
        row_f = torch.gather(bf, 1, node)                           # [T, N]
        row_b = torch.gather(bb, 1, node)
        x_b = torch.gather(B.expand(T, N, d), 2, row_f.long()[..., None])[..., 0]
        pos = 2 * pos + (x_b > row_b).to(torch.int32)

    # importances: each node's chosen gain added into its feature, in level
    # order (the reference adds them level by level, in the same order)
    imp = _bucket_sums(gain_at[..., None], feature, d)[..., 0]
    # per-leaf stat sums (the reference's segment_sum)
    leaf = _bucket_sums(S, pos, 2**depth)
    tree = Tree(feature, split_bin, threshold, leaf)
    if single:
        return Tree(*(x[0] for x in tree)), pos[0], imp[0]
    return tree, pos, imp


def _bucket_sums(S, pos, n_buckets: int):
    """f32[T, n_buckets, s]: ``S`` f32[T, N, s] summed by bucket ``pos``
    i32[T, N]. CPU: ``index_add_`` in row order (several rows share a
    bucket, so it is an add, not an indexed assignment). CUDA: the
    histogram kernel with one feature of one constant bin, whose
    fixed-point integer adds give the same bits in any order (exact for
    integer stats, float stats within its stated bound)."""
    T, N, s = S.shape
    if S.device.type != "cuda":
        out = torch.zeros((T * n_buckets, s), dtype=torch.float32, device=S.device)
        idx = (torch.arange(T, device=S.device)[:, None] * n_buckets + pos).view(-1)
        return out.index_add_(0, idx, S.reshape(T * N, s)).view(T, n_buckets, s)
    return _bucket_sums_histogram(S, pos, n_buckets)


def _bucket_sums_histogram(S, pos, n_buckets: int):
    """``_bucket_sums``' CUDA form: one histogram of one feature whose bin
    is always 0, ``pos`` as the node (on the CPU it runs the histogram's
    plain version, which the tests hold to the ``index_add_`` form)."""
    N = S.shape[1]
    one_bin = torch.zeros((N, 1), dtype=torch.uint8, device=S.device)
    H = node_histograms(one_bin, S.contiguous(), pos.contiguous(), nodes=n_buckets,
                        n_bins=1)
    return H[:, 0]


def normalize_importances(imp):
    """MLlib featureImportances normalization: scale to sum 1 (all-zero —
    no split anywhere — stays zero). Works on [d] or stacked [T, d]."""
    s = imp.sum(-1, keepdim=True)
    return torch.where(s > 0, imp / torch.clamp_min(s, EPS), 0.0)


def tree_apply(X, tree: Tree):
    """Leaf index per row on RAW features (no binning needed): i64[N] for
    one tree, i64[T, N] for a stacked forest."""
    single = tree.feature.ndim == 1
    feature, threshold = tree.feature, tree.threshold
    if single:
        feature, threshold = feature[None], threshold[None]
    T = feature.shape[0]
    N, d = X.shape
    L = tree.leaf_value.shape[-2]
    node = torch.zeros((T, N), dtype=torch.int64, device=X.device)
    Xe = X.expand(T, N, d)
    fl = feature.long()
    for _ in range(L.bit_length() - 1):
        f = torch.gather(fl, 1, node)
        thr = torch.gather(threshold, 1, node)
        go_right = torch.gather(Xe, 2, f[..., None])[..., 0] > thr
        node = 2 * node + 1 + go_right.long()
    leaves = node - (L - 1)  # leaf index in [0, 2^D)
    return leaves[0] if single else leaves


def leaf_class_probs(leaf_stats):
    """Per-leaf class distribution from one-hot count stats."""
    tot = leaf_stats.sum(-1, keepdim=True)
    k = leaf_stats.shape[-1]
    return torch.where(tot > 0, leaf_stats / torch.clamp_min(tot, EPS), 1.0 / k)


def leaf_means(leaf_value):
    """Per-leaf mean target from [Σwy, Σwy², Σw] stats."""
    return leaf_value[..., 0] / torch.clamp_min(leaf_value[..., 2], EPS)


def class_one_hot(y, k: int):
    """f32[N, k] one-hot class stats; a label outside 0..k-1 (or NaN) gives
    a zero row, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(k, device=y.device, dtype=y.dtype)
    return (torch.trunc(y)[:, None] == classes).to(torch.float32)


def regression_stats(y):
    """[y, y², 1] per row: weighted, the variance-gain stats [Σwy, Σwy², Σw]."""
    return torch.stack([y, y * y, torch.ones_like(y)], dim=1)


def leaf_newton_values(leaf_stats, reg: float):
    """-G/(H + reg) per leaf from [G, H, w] stats."""
    G, H = leaf_stats[..., 0], leaf_stats[..., 1]
    return -G / torch.clamp_min(H + reg, EPS)
