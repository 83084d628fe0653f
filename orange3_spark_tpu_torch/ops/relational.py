"""Relational DataFrame ops — the ``pyspark.sql`` wrangling subset.

Port of ``orange3_spark_tpu/ops/relational.py``: the same functions, the
same static-shape semantics, the same answers.

* ``group_by`` (and ``pivot``, ``rollup`` / ``cube``, ``crosstab``,
  ``value_counts``, ``freq_items``, which stand on it): discrete keys with
  known category counts give a FIXED k-row result. The reference sums by a
  one-hot product ``onehot.T @ V``, an [N, k] matrix that does not fit at
  real sizes (10M rows x 265 zones is 10.6 GB). Here the grouped pass is a
  stable sort of the composite key, a gather of ``[W, W*V]`` in that order
  and one launch of the hand-written ``segment_sum_sorted``
  (``ops/segment_sum.py``; on the CPU its plain version): deterministic,
  O(N) memory. Min and max are a masked ``scatter_reduce`` (order-free).
  The product's non-finite semantics are kept for parity: ``0 * NaN`` and
  ``0 * inf`` are NaN, so a value column with a non-finite entry in a row
  outside a group makes that group's sum NaN (every group's, for a row
  whose key is out of range or whose weight is 0). The pass computes it
  from per-group counts of non-finite entries against the column's total.
  A NaN key converts to index 0 as XLA converts it, so it counts in
  group 0.
* ``join``: a dimension-table join (the right side keyed uniquely by a
  discrete column) keeps the LEFT shape; the right columns arrive by a
  device gather. One-to-many fan-out is ``join_expand`` (each left row
  expands into a static ``max_matches`` slots, dead slots weight-zeroed);
  the fully general many-to-many / outer join is ``join_host``, a
  sort-merge on the host into a fresh table.
* ``sort``: two stable device sorts. ``sample``, ``sample_by`` and the
  splits draw JAX's threefry stream (``ops/prng.py``), so a seed keeps the
  same rows as the reference. ``union`` and ``distinct`` stay on the host.

Every float key or code becomes an index as XLA converts it
(``ops/hashing.to_index``: NaN to 0, toward zero, saturating), never by
PyTorch's own conversion.
"""

from __future__ import annotations

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, DiscreteVariable, Domain
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.ops import prng
from orange3_spark_tpu_torch.ops.hashing import to_index
from orange3_spark_tpu_torch.ops.segment_sum import segment_sum_sorted
from orange3_spark_tpu_torch.ops.stats import EPS_TOTAL_WEIGHT

AGG_FNS = ("sum", "mean", "count", "min", "max")
_BIG = float(np.finfo(np.float32).max)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32's range, as int32 arithmetic wraps."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _slots(key: torch.Tensor, k: int) -> torch.Tensor:
    """int32 slots: the key where it lies in [0, k), else the dropped slot
    k (the reference's one-hot and segment ops drop such rows)."""
    return torch.where((key >= 0) & (key < k), key, k).to(torch.int32)


def grouped_sums(slot: torch.Tensor, cols: torch.Tensor, k: int) -> torch.Tensor:
    """Per-slot sums f32[k, c] of the rows of ``cols`` (f32[N, c]) by
    ``slot`` (int32 [N] in [0, k]; slot k is dropped): a stable sort of
    the slots, a gather of the rows in that order and one
    ``segment_sum_sorted`` (on CUDA its kernel, on the CPU its plain
    version). Each sum adds its rows in an order fixed by the data."""
    s, order = torch.sort(slot, stable=True)
    g = cols.index_select(0, order).contiguous()
    return segment_sum_sorted(g, s, k + 1)[:k]


def _group_kernel(key: torch.Tensor, W: torch.Tensor, V: torch.Tensor, k: int):
    """Per-group (count, sum, min, max) of every value column, as numpy:
    counts f32[k], sums, mins and maxs f32[k, c]. ``key`` holds the
    composite group index of each row (int64); rows whose index lies
    outside [0, k) count nowhere. Empty groups hold min +inf and max -inf;
    groups whose rows are all dead hold +-big (the reference's fills)."""
    c = V.shape[1]
    slot = _slots(key, k)
    tot = grouped_sums(slot, torch.cat([W[:, None], W[:, None] * V], 1), k)
    counts, sums = tot[:, 0], tot[:, 1:]
    live = (W > 0)[:, None]
    nan = torch.isnan(V)
    idx = slot.to(torch.int64)[:, None].expand(-1, c)
    ok = live & ~nan
    mins = torch.full((k + 1, c), float("inf"), device=V.device).scatter_reduce_(
        0, idx, torch.where(ok, V, _BIG), "amin")[:k]
    maxs = torch.full((k + 1, c), float("-inf"), device=V.device).scatter_reduce_(
        0, idx, torch.where(ok, V, -_BIG), "amax")[:k]
    bad = ~torch.isfinite(V)
    total_bad = bad.sum(0)
    if c and bool(total_bad.any()):
        # the product's 0 * NaN: a non-finite entry outside a group makes
        # its sum NaN; a live NaN inside makes its min and max NaN
        flags = torch.cat([bad, nan & live], 1).to(torch.int64)
        per = torch.zeros((k + 1, 2 * c), dtype=torch.int64, device=V.device)
        per = per.index_add_(0, slot.to(torch.int64), flags)[:k]
        sums = torch.where(per[:, :c] < total_bad[None, :], float("nan"), sums)
        has_nan = per[:, c:] > 0
        mins = torch.where(has_nan, float("nan"), mins)
        maxs = torch.where(has_nan, float("nan"), maxs)
    return tuple(t.cpu().numpy() for t in (counts, sums, mins, maxs))


def _grouped_stats(table: TorchTable, keys, pairs):
    """Shared groupBy prologue: validate discrete keys and agg columns,
    build the row-major composite key index (int32 arithmetic, wrapping
    as the reference's does), and run ONE grouped pass. Returns (kvars,
    sizes, k, ucols, counts, sums, mins, maxs). Used by ``group_by`` and
    ``rollup`` / ``cube`` (which fold coarser levels from this
    finest-level pass)."""
    kvars = []
    for kname in keys:
        kvar = table.domain[kname]
        if not isinstance(kvar, DiscreteVariable) or not kvar.values:
            raise ValueError(f"group key {kname!r} must be a DiscreteVariable "
                             f"with known values")
        kvars.append(kvar)
    sizes = [len(v.values) for v in kvars]
    k = int(np.prod(sizes))
    key = torch.zeros((table.n_pad,), dtype=torch.int64, device=table.W.device)
    for kname, sz in zip(keys, sizes):
        key = _wrap32(key * sz + to_index(table.column(kname)).to(torch.int64))
    for col, _ in pairs:
        table.domain[col]  # raises KeyError on unknown column
    ucols = list(dict.fromkeys(col for col, _ in pairs))
    V = (torch.stack([table.column(c) for c in ucols], 1) if ucols
         else torch.zeros((table.n_pad, 0), device=table.W.device))
    counts, sums, mins, maxs = _group_kernel(key, table.W, V, k)
    return kvars, sizes, k, ucols, counts, sums, mins, maxs


def _agg_pairs(aggs) -> list[tuple[str, str]]:
    """Normalize an aggs spec — {col: fn} dict or ordered ((col, fn), ...)
    pairs — into a pair list. The pair form allows several aggs of one
    column (Spark's agg(sum(x), mean(x)))."""
    pairs = list(aggs.items()) if isinstance(aggs, dict) else [(c, f) for c, f in aggs]
    for col, fn in pairs:
        if fn not in AGG_FNS:
            raise ValueError(f"unknown agg {fn!r}; supported: {AGG_FNS}")
    return pairs


def group_by(table: TorchTable, key, aggs) -> TorchTable:
    """df.groupBy(keys).agg(...) with discrete key(s) -> fixed-row table.

    ``key``: one column name or a sequence of them (the composite key is
    the cross product of the categories, so the result has ∏kᵢ rows).
    ``key=None`` or ``[]`` is the global aggregation: one row, agg columns
    only. ``aggs``: ``{col: fn}`` or ordered ``((col, fn), ...)`` pairs.
    Output columns: each key (as its category index) + one column per
    (col, fn) pair named ``fn_col``; rows ordered by composite index.
    Groups with no live rows get count 0 and NaN for mean/min/max."""
    keys = [] if key is None else ([key] if isinstance(key, str) else list(key))
    pairs = _agg_pairs(aggs)
    if not keys and not pairs:
        raise ValueError("group_by with no keys needs at least one agg")
    kvars, sizes, k, ucols, counts, sums, mins, maxs = _grouped_stats(table, keys, pairs)

    # the keys keep their discrete identity (values included) so the result
    # can feed joins / value_counts / one-hot downstream
    new_attrs: list = [DiscreteVariable(v.name, v.values) for v in kvars]
    composite = np.arange(k)
    data = []
    for i in range(len(keys) - 1, -1, -1):  # decompose the row-major index
        data.insert(0, (composite % sizes[i]).astype(np.float32))
        composite = composite // sizes[i]
    for col, fn in pairs:
        j = ucols.index(col)
        new_attrs.append(ContinuousVariable(f"{fn}_{col}"))
        if fn == "count":
            data.append(counts)
        elif fn == "sum":
            data.append(sums[:, j])
        elif fn == "mean":
            data.append(np.where(counts > 0,
                                 sums[:, j] / np.maximum(counts, EPS_TOTAL_WEIGHT), np.nan))
        elif fn == "min":
            data.append(np.where(counts > 0, mins[:, j], np.nan))
        elif fn == "max":
            data.append(np.where(counts > 0, maxs[:, j], np.nan))
    X = np.stack(data, axis=1).astype(np.float32)
    return TorchTable.from_numpy(Domain(new_attrs), X, session=table.session)


def pivot(table: TorchTable, key, pivot_col: str, aggs, values=None) -> TorchTable:
    """df.groupBy(key).pivot(pivot_col[, values]).agg({col: fn}).

    One row per key group, one output column per (pivot value, agg). The
    key(s) and ``pivot_col`` must be discrete: the composite (key x pivot)
    group-by is ONE grouped pass, since the category set is already in the
    Domain. ``values``: an optional subset of pivot values to keep. Column
    naming follows Spark: ``<value>`` for a single agg,
    ``<value>_<fn>_<col>`` otherwise."""
    keys = [key] if isinstance(key, str) else list(key)
    pairs = _agg_pairs(aggs)
    if not keys:
        raise ValueError("pivot needs at least one group key")
    if not pairs:
        raise ValueError("pivot needs at least one agg")
    pvar = table.domain[pivot_col]
    if not isinstance(pvar, DiscreteVariable) or not pvar.values:
        raise ValueError(f"pivot column {pivot_col!r} must be a DiscreteVariable "
                         f"with known values")
    pvals = list(pvar.values)
    if values is not None:
        missing = [v for v in values if v not in pvals]
        if missing:
            raise ValueError(f"pivot values {missing} not in {pivot_col!r}'s "
                             f"categories {pvals}")
        sel = [pvals.index(v) for v in values]
    else:
        sel = list(range(len(pvals)))

    g = group_by(table, keys + [pivot_col], pairs)
    gX, _, _ = g.to_numpy()
    k_piv = len(pvals)
    n_groups = gX.shape[0] // k_piv

    # group_by rows are row-major over (keys..., pivot): row = g*k_piv + p
    attrs: list = [DiscreteVariable(kn, table.domain[kn].values) for kn in keys]
    data = [gX[::k_piv, i] for i in range(len(keys))]
    single = len(pairs) == 1
    for j, (col, fn) in enumerate(pairs):
        M = gX[:, len(keys) + 1 + j].reshape(n_groups, k_piv)
        for pi in sel:
            name = str(pvals[pi]) if single else f"{pvals[pi]}_{fn}_{col}"
            attrs.append(ContinuousVariable(name))
            data.append(M[:, pi])
    X = np.stack(data, axis=1).astype(np.float32)
    return TorchTable.from_numpy(Domain(attrs), X, session=table.session)


def _grouping_levels(table: TorchTable, levels, keys, pairs) -> TorchTable:
    """Shared rollup/cube assembly from ONE finest-level grouped pass.

    Every coarser level folds out of the finest per-cell stats on the host
    (counts and sums add, mins and maxs fold across an aggregated-out key
    axis, means recompute from the folded sums and counts). Key columns
    come back CONTINUOUS (category index, or NaN — Spark's null — where a
    key is aggregated out)."""
    _, sizes, _, ucols, counts, sums, mins, maxs = _grouped_stats(table, keys, pairs)
    nc = len(ucols)
    C = counts.reshape(sizes)
    S = sums.reshape(sizes + [nc])
    Mn = mins.reshape(sizes + [nc])
    Mx = maxs.reshape(sizes + [nc])

    parts = []
    for level in levels:
        axes = tuple(i for i, kn in enumerate(keys) if kn not in level)
        c = C.sum(axis=axes)
        s = S.sum(axis=axes)
        mn = Mn.min(axis=axes) if axes else Mn
        mx = Mx.max(axis=axes) if axes else Mx
        cf, sf = c.reshape(-1), s.reshape(-1, nc)
        mnf, mxf = mn.reshape(-1, nc), mx.reshape(-1, nc)
        n_rows = cf.shape[0]
        out = np.full((n_rows, len(keys) + len(pairs)), np.nan, np.float32)
        # decompose the level's row-major composite back into key columns
        lvl_sizes = [sizes[keys.index(kn)] for kn in level]
        composite = np.arange(n_rows)
        for i in range(len(level) - 1, -1, -1):
            out[:, keys.index(level[i])] = composite % lvl_sizes[i]
            composite = composite // lvl_sizes[i]
        for j, (col, fn) in enumerate(pairs):
            u = ucols.index(col)
            if fn == "count":
                v = cf
            elif fn == "sum":
                v = sf[:, u]
            elif fn == "mean":
                v = np.where(cf > 0, sf[:, u] / np.maximum(cf, EPS_TOTAL_WEIGHT), np.nan)
            elif fn == "min":
                v = np.where(cf > 0, mnf[:, u], np.nan)
            else:
                v = np.where(cf > 0, mxf[:, u], np.nan)
            out[:, len(keys) + j] = v
        parts.append(out)
    X = np.concatenate(parts, axis=0)
    attrs = [ContinuousVariable(kn) for kn in keys] + [
        ContinuousVariable(f"{fn}_{col}") for col, fn in pairs]
    return TorchTable.from_numpy(Domain(attrs), X, session=table.session)


def rollup(table: TorchTable, keys, aggs) -> TorchTable:
    """df.rollup(keys).agg(...): hierarchical subtotals — one block per key
    PREFIX (all keys, then all-but-last, ..., then the grand total), key
    columns NaN where aggregated out. Empty key combinations stay as
    count-0 rows (static shapes)."""
    keys = [keys] if isinstance(keys, str) else list(keys)
    pairs = _agg_pairs(aggs)
    if not keys or not pairs:
        raise ValueError("rollup needs keys and at least one agg")
    levels = [tuple(keys[:i]) for i in range(len(keys), -1, -1)]
    return _grouping_levels(table, levels, keys, pairs)


def cube(table: TorchTable, keys, aggs) -> TorchTable:
    """df.cube(keys).agg(...): subtotals for EVERY key subset (2^n blocks),
    key columns NaN where aggregated out; empty groups as in rollup."""
    from itertools import combinations

    keys = [keys] if isinstance(keys, str) else list(keys)
    pairs = _agg_pairs(aggs)
    if not keys or not pairs:
        raise ValueError("cube needs keys and at least one agg")
    levels = [lv for r in range(len(keys), -1, -1) for lv in combinations(keys, r)]
    return _grouping_levels(table, levels, keys, pairs)


def join(left: TorchTable, right: TorchTable, on: str, how: str = "left") -> TorchTable:
    """Dimension-table join: the right side keyed uniquely by discrete
    column ``on``.

    Keeps the left table's shape; right's other attribute columns are
    gathered per left row on the device. how='left': unmatched keys get
    NaN; how='inner': unmatched rows are weight-zeroed."""
    if how not in ("left", "inner"):
        raise ValueError("how must be 'left' or 'inner'")
    kvar = left.domain[on]
    rvar = right.domain[on]
    if not isinstance(kvar, DiscreteVariable) or not isinstance(rvar, DiscreteVariable):
        raise ValueError(f"join key {on!r} must be discrete on both sides")

    rX, _, rW = right.to_numpy()
    r_key_col = [v.name for v in right.domain.attributes].index(on)
    r_keys = rX[:, r_key_col].astype(np.int64)
    live = rW > 0
    r_keys = r_keys[live]
    if len(np.unique(r_keys)) != len(r_keys):
        raise ValueError(
            "right side has duplicate keys; only unique-key (dimension-table) "
            "joins are supported on device — aggregate the right side first")
    # category-index remap if the two sides enumerate values differently
    remap = {v: i for i, v in enumerate(rvar.values)}
    key_lut = np.full((len(kvar.values),), -1, dtype=np.int64)
    for i, v in enumerate(kvar.values):
        if v in remap:
            key_lut[i] = remap[v]

    other_cols = [j for j, v in enumerate(right.domain.attributes) if v.name != on]
    left_names = {v.name for v in left.domain.variables}
    clashes = [right.domain.attributes[j].name for j in other_cols
               if right.domain.attributes[j].name in left_names]
    if clashes:
        raise ValueError(
            f"join would duplicate column names {clashes}; rename the right "
            "side's columns first (Spark would defer this to an ambiguity "
            "error at first use — we fail at the join)")
    n_right = int(np.max(r_keys)) + 1 if len(r_keys) else 1
    lut = np.full((n_right + 1, len(other_cols)), np.nan, dtype=np.float32)
    matched = np.zeros((n_right + 1,), dtype=np.float32)
    lut[r_keys] = rX[live][:, other_cols]
    matched[r_keys] = 1.0

    dev = left.X.device
    left_key = to_index(left.column(on)).to(torch.int64)
    mapped = torch.as_tensor(key_lut, device=dev)[left_key.clamp(0, len(key_lut) - 1)]
    sel = torch.where(mapped < 0, n_right, mapped.clamp(0, n_right))
    gathered = torch.as_tensor(lut, device=dev)[sel]
    hit = torch.as_tensor(matched, device=dev)[sel]

    new_attrs = list(left.domain.attributes) + [
        ContinuousVariable(right.domain.attributes[j].name) for j in other_cols]
    X = torch.cat([left.X, gathered], dim=1)
    W = left.W if how == "left" else torch.where(hit > 0, left.W, 0.0)
    return TorchTable(Domain(new_attrs, left.domain.class_vars, left.domain.metas),
                      X, left.Y, W, left.metas, left.n_rows, left.session)


def _right_side_prep(left: TorchTable, right: TorchTable, on: str):
    """Shared join prologue: validate discrete keys on both sides, pull the
    right side to the host, remap right key codes into the LEFT's category
    indexing, and check column-name clashes. Returns
    (rX_live, rW_live, r_keys_in_left_idx, other_cols, key variable)."""
    kvar = left.domain[on]
    rvar = right.domain[on]
    if not isinstance(kvar, DiscreteVariable) or not isinstance(rvar, DiscreteVariable):
        raise ValueError(f"join key {on!r} must be discrete on both sides")
    rX, _, rW = right.to_numpy()
    r_key_col = [v.name for v in right.domain.attributes].index(on)
    live = rW > 0
    rX, rW = rX[live], rW[live]
    r_codes = rX[:, r_key_col].astype(np.int64)
    # remap right's category codes into LEFT's enumeration (-1: value
    # absent on the left — such right rows can never match)
    remap = {v: i for i, v in enumerate(kvar.values)}
    r_keys = np.asarray([remap.get(rvar.values[c], -1) if 0 <= c < len(rvar.values)
                         else -1 for c in r_codes], dtype=np.int64)
    other_cols = [j for j, v in enumerate(right.domain.attributes) if v.name != on]
    left_names = {v.name for v in left.domain.variables}
    clashes = [right.domain.attributes[j].name for j in other_cols
               if right.domain.attributes[j].name in left_names]
    if clashes:
        raise ValueError(f"join would duplicate column names {clashes}; rename the right "
                         "side's columns first")
    return rX, rW, r_keys, other_cols, kvar


def join_expand(left: TorchTable, right: TorchTable, on: str, *, max_matches: int,
                how: str = "inner") -> TorchTable:
    """One-to-many join with STATIC fan-out.

    Every left row expands into exactly ``max_matches`` output slots (rows
    ``i*max_matches .. i*max_matches+max_matches-1``); slot j carries the
    j-th matching right row's columns, surplus slots are weight-zeroed, so
    the expansion is one device gather. A right key with more than
    ``max_matches`` live rows raises (silent truncation would be a wrong
    join). ``how='left'``: a left row with NO match keeps slot 0 alive with
    NaN right columns (Spark's NULL row); ``'inner'``: all its slots die.
    Output weight of a live slot = left_w * right_w."""
    if how not in ("left", "inner"):
        raise ValueError("how must be 'left' or 'inner'")
    if max_matches < 1:
        raise ValueError("max_matches must be >= 1")
    k = int(max_matches)
    rX, rW, r_keys, other_cols, kvar = _right_side_prep(left, right, on)

    n_keys = len(kvar.values)
    matchable = r_keys >= 0
    counts = np.bincount(r_keys[matchable], minlength=n_keys)
    if counts.size and counts.max() > k:
        worst = int(np.argmax(counts))
        raise ValueError(
            f"key {kvar.values[worst]!r} has {int(counts.max())} matches > "
            f"max_matches={k}; raise the bound (or aggregate the right side)")
    # slot LUTs [n_keys + 1, k, ...]; the sentinel row n_keys serves
    # unmatched/out-of-range left keys (all slots dead, NaN columns)
    lut = np.full((n_keys + 1, k, len(other_cols)), np.nan, np.float32)
    slot_w = np.zeros((n_keys + 1, k), np.float32)
    # slot j = rank within the key's run of the stably sorted right rows
    idxs = np.flatnonzero(matchable)
    if idxs.size:
        order = np.argsort(r_keys[idxs], kind="stable")
        src = idxs[order]
        keys_sorted = r_keys[src]
        slots = np.arange(len(src)) - np.searchsorted(keys_sorted, keys_sorted, side="left")
        lut[keys_sorted, slots] = rX[src][:, other_cols]
        slot_w[keys_sorted, slots] = rW[src]

    dev = left.X.device
    left_key = to_index(left.column(on)).to(torch.int64)
    idx = torch.where((left_key < 0) | (left_key >= n_keys), n_keys, left_key)
    gathered = torch.as_tensor(lut, device=dev)[idx]          # [n_pad, k, c]
    sw = torch.as_tensor(slot_w, device=dev)[idx]             # [n_pad, k]
    W = left.W[:, None] * sw                                  # live slots only
    if how == "left":
        no_match = sw.sum(dim=1) == 0
        W[:, 0] = torch.where(no_match, left.W, W[:, 0])

    n_pad, k_cols = left.X.shape[0], len(other_cols)
    X = torch.cat([left.X.repeat_interleave(k, dim=0),
                   gathered.reshape(n_pad * k, k_cols)], dim=1)
    Y = None if left.Y is None else left.Y.repeat_interleave(k, dim=0)
    metas = None if left.metas is None else np.repeat(left.metas, k, axis=0)
    new_attrs = list(left.domain.attributes) + [
        ContinuousVariable(right.domain.attributes[j].name) for j in other_cols]
    return TorchTable(Domain(new_attrs, left.domain.class_vars, left.domain.metas),
                      X, Y, W.reshape(n_pad * k), metas, left.n_rows * k, left.session)


def join_host(left: TorchTable, right: TorchTable, on: str, how: str = "inner") -> TorchTable:
    """Fully general equi-join (unbounded many-to-many; 'inner' | 'left' |
    'outer') at the HOST boundary — a sort-merge join in numpy that builds
    a fresh table. Output cardinality is data-dependent by nature, so a
    host hop is the honest cost here (Spark pays a full shuffle at the
    same spot).

    Left's class vars and metas replicate onto each matched pair; an outer
    join's right-only rows carry NaN left columns (and NaN class values).
    Live rows only (W > 0) take part; output weight = left_w * right_w
    (1 * right_w for right-only rows)."""
    if how not in ("inner", "left", "outer"):
        raise ValueError("how must be 'inner' | 'left' | 'outer'")
    rX, rW, r_keys, other_cols, kvar = _right_side_prep(left, right, on)

    lX, lY, lW = left.to_numpy()
    lmeta = None if left.metas is None else np.asarray(left.metas)[:len(lX)]
    l_live = lW > 0
    lX, lW = lX[l_live], lW[l_live]
    lY = None if lY is None else lY[l_live]
    lmeta = None if lmeta is None else lmeta[l_live]
    l_key_col = [v.name for v in left.domain.attributes].index(on)
    l_keys = lX[:, l_key_col].astype(np.int64)

    # sort-merge: right sorted by key; per left row, the [start, end) run
    # of its matches by searchsorted — O((n+m) log m), no hashing
    order = np.argsort(r_keys, kind="stable")
    rk_sorted = r_keys[order]
    starts = np.searchsorted(rk_sorted, l_keys, side="left")
    ends = np.searchsorted(rk_sorted, l_keys, side="right")
    n_match = ends - starts
    matched_mask = n_match > 0

    # matched pairs: left row i repeated n_match[i] times, aligned with its
    # run of sorted right rows
    li = np.repeat(np.arange(len(lX)), n_match)
    if li.size:
        within = np.arange(li.size) - np.repeat(np.cumsum(n_match) - n_match, n_match)
        ri = order[np.repeat(starts, n_match) + within]
    else:
        ri = np.zeros((0,), np.int64)
    parts_X = [np.concatenate([lX[li], rX[ri][:, other_cols]], axis=1)]
    parts_W = [lW[li] * rW[ri]]
    parts_Y = [None if lY is None else lY[li]]
    parts_M = [None if lmeta is None else lmeta[li]]

    if how in ("left", "outer"):
        keep = ~matched_mask
        nan_r = np.full((int(keep.sum()), len(other_cols)), np.nan, np.float32)
        parts_X.append(np.concatenate([lX[keep], nan_r], axis=1))
        parts_W.append(lW[keep])
        parts_Y.append(None if lY is None else lY[keep])
        parts_M.append(None if lmeta is None else lmeta[keep])
    if how == "outer":
        r_unmatched = np.ones(len(rX), bool)
        r_unmatched[ri] = False
        ru = np.flatnonzero(r_unmatched)
        nan_l = np.full((len(ru), lX.shape[1]), np.nan, np.float32)
        # the key column survives on the left layout: write the right row's
        # key (in LEFT indexing; -1 -> NaN for left-unknown values)
        nan_l[:, l_key_col] = np.where(r_keys[ru] >= 0, r_keys[ru].astype(np.float32), np.nan)
        parts_X.append(np.concatenate([nan_l, rX[ru][:, other_cols]], axis=1))
        parts_W.append(rW[ru])
        parts_Y.append(None if lY is None
                       else np.full((len(ru), lY.shape[1]), np.nan, np.float32))
        parts_M.append(None if lmeta is None
                       else np.full((len(ru),) + lmeta.shape[1:], None, object))

    X = np.concatenate(parts_X, axis=0)
    W = np.concatenate(parts_W, axis=0)
    Y = None if lY is None else np.concatenate(parts_Y, axis=0)
    metas = None if lmeta is None else np.concatenate(parts_M, axis=0)
    new_attrs = list(left.domain.attributes) + [
        ContinuousVariable(right.domain.attributes[j].name) for j in other_cols]
    return TorchTable.from_numpy(Domain(new_attrs, left.domain.class_vars, left.domain.metas),
                                 X, Y, metas, W, session=left.session)


def merge_columns(left: TorchTable, right: TorchTable, *, suffix: str = "_r") -> TorchTable:
    """Row-aligned column merge (Orange's 'Merge Data' by position), on the
    device: one concat, no host hop, so a DAG that fans out and re-merges
    stages whole (workflow/staging.py).

    Both tables must have the same (padded) row count; weights intersect
    (a row dead on either side is dead in the merge). Right-side attribute
    names that clash with the left get ``suffix`` appended. Keeps the
    left's class vars and metas."""
    if left.X.shape[0] != right.X.shape[0]:
        raise ValueError(
            f"merge_columns needs row-aligned tables, got {left.X.shape[0]} "
            f"vs {right.X.shape[0]} padded rows")
    taken = {v.name for v in left.domain.attributes}
    rattrs = []
    for v in right.domain.attributes:
        name = v.name
        while name in taken:     # suffix until unique ('a_r' may exist too)
            name += suffix
        taken.add(name)
        rattrs.append(v if name == v.name else v.renamed(name))
    domain = Domain(list(left.domain.attributes) + rattrs,
                    left.domain.class_vars, left.domain.metas)
    X = torch.cat([left.X, right.X], dim=1)
    W = torch.minimum(left.W, right.W)
    return TorchTable(domain, X, left.Y, W, left.metas, left.n_rows, left.session)


def sort(table: TorchTable, by: str, ascending: bool = True) -> TorchTable:
    """Full device sort of all rows by one column (df.orderBy).

    A stable sort by the key (NaN neutralized to 0; a zero's sign dropped,
    so -0.0 ties +0.0 as in the reference's sort on every device), then a
    stable sort on a 4-level rank: live non-NaN and live NaN ordered by
    Spark's NaN-is-largest rule (NaN last ascending, first descending; not
    folded into the key, where it would tie with a genuine inf), then
    filtered rows (W == 0 inside the live region, so metas and
    ``to_numpy()``'s window stay aligned), padding strictly last."""
    key = table.column(by)
    nan = torch.isnan(key)
    key = torch.where(nan, 0.0, key)
    key = (key if ascending else -key) + 0.0
    order_by_key = torch.sort(key, stable=True).indices
    nan_rank = (nan if ascending else ~nan).to(torch.int32)
    idx = torch.arange(table.n_pad, device=key.device)
    rank = torch.where(table.W > 0, nan_rank,
                       torch.where(idx < table.n_rows, 2, 3).to(torch.int32))
    order = order_by_key[torch.sort(rank[order_by_key], stable=True).indices]
    X = table.X[order]
    Y = table.Y[order] if table.Y is not None else None
    W = table.W[order]
    metas = None
    if table.metas is not None:
        ho = order.cpu().numpy()
        metas = table.metas[ho[ho < len(table.metas)]]
    return TorchTable(table.domain, X, Y, W, metas, table.n_rows, table.session)


def sample(table: TorchTable, fraction: float, seed: int = 0) -> TorchTable:
    """df.sample(fraction): a bernoulli row mask folded into the weights,
    JAX's draw for ``seed`` row for row."""
    keep = prng.bernoulli(prng.PRNGKey(seed), fraction, table.n_pad, table.W.device)
    return table.with_weights(torch.where(keep, table.W, 0.0))


def sample_by(table: TorchTable, col: str, fractions: dict, seed: int = 0) -> TorchTable:
    """df.stat.sampleBy(col, fractions): stratified bernoulli sample — each
    row keeps with the probability given for ITS category of ``col``
    (unlisted categories drop, Spark semantics). The per-row fraction is a
    gather from a k-vector, folded into the weight mask like ``sample``."""
    var = table.domain[col]
    if not isinstance(var, DiscreteVariable) or not var.values:
        raise ValueError(f"sampleBy column {col!r} must be discrete")
    fr = np.zeros((len(var.values),), np.float32)
    for v, f in fractions.items():
        if v not in var.values:
            raise ValueError(f"fraction key {v!r} not in {col!r}'s "
                             f"categories {list(var.values)}")
        if not 0.0 <= f <= 1.0:
            raise ValueError(f"fraction for {v!r} must be in [0, 1], got {f}")
        fr[var.values.index(v)] = f
    code = table.column(col)
    # NaN category codes = missing values: Spark drops null-category rows
    valid = ~torch.isnan(code)
    idx = to_index(torch.where(valid, code, 0.0)).clamp(0, len(fr) - 1).to(torch.int64)
    row_frac = torch.where(valid, torch.as_tensor(fr, device=code.device)[idx], 0.0)
    u = prng.uniform(prng.PRNGKey(seed), table.n_pad, code.device)
    return table.with_weights(torch.where(u < row_frac, table.W, 0.0))


def freq_items(table: TorchTable, cols, support: float = 0.01) -> dict:
    """df.stat.freqItems(cols, support): per column, the categories whose
    weighted frequency is >= support * total live weight. Discrete columns
    carry their full category set in the Domain, so one grouped pass per
    column is exact (Spark approximates with a sketch)."""
    if not 1e-4 <= support <= 1.0:
        raise ValueError(f"support must be in [1e-4, 1], got {support}")
    cols = [cols] if isinstance(cols, str) else list(cols)
    total = float(table.W.sum())
    out = {}
    for col in cols:
        counts = value_counts(table, col)
        out[f"{col}_freqItems"] = [v for v, c in counts.items() if c >= support * total]
    return out


def union(a: TorchTable, b: TorchTable) -> TorchTable:
    """df.union: a host re-concat (a repartition boundary, as in Spark)."""
    if a.domain != b.domain:
        raise ValueError("union requires identical domains")
    Xa, Ya, Wa = a.to_numpy()
    Xb, Yb, Wb = b.to_numpy()
    if (Ya is None) != (Yb is None):
        raise ValueError("union: one table has Y and the other does not")
    metas = None
    if a.metas is not None or b.metas is not None:
        # one-sided metas: pad the missing side with None rows instead of
        # dropping the present side's host data
        ma = a.metas if a.metas is not None else np.full(
            (len(Xa), b.metas.shape[1]), None, dtype=object)
        mb = b.metas if b.metas is not None else np.full(
            (len(Xb), ma.shape[1]), None, dtype=object)
        if ma.shape[1] != mb.shape[1]:
            raise ValueError(f"union: metas width mismatch ({ma.shape[1]} vs {mb.shape[1]})")
        metas = np.concatenate([ma, mb], axis=0)
    return TorchTable.from_numpy(
        a.domain, np.concatenate([Xa, Xb], 0),
        np.concatenate([Ya, Yb], 0) if Ya is not None else None,
        metas, np.concatenate([Wa, Wb], 0), a.session)


def value_counts(table: TorchTable, col: str) -> dict[str, float]:
    """Weighted category counts of one discrete column (df.groupBy.count);
    NaN codes (missing values) count nowhere."""
    var = table.domain[col]
    if not isinstance(var, DiscreteVariable):
        raise ValueError(f"{col!r} is not discrete")
    k = len(var.values)
    code = table.column(col)
    idx = to_index(torch.where(torch.isnan(code), -1.0, code))
    counts = grouped_sums(_slots(idx, k), table.W[:, None], k)[:, 0].cpu().numpy()
    return {v: float(c) for v, c in zip(var.values, counts)}


def train_test_split(table: TorchTable, test_fraction: float = 0.25, seed: int = 0):
    """df.randomSplit([1-f, f]) — the two-way case of ``random_split`` (one
    implementation, one random stream)."""
    train, test = random_split(table, [1.0 - test_fraction, test_fraction], seed=seed)
    return train, test


def random_split(table: TorchTable, weights, seed: int = 0) -> list:
    """``df.randomSplit(weights, seed)`` — an n-way disjoint split: every
    live row lands in one part, with probability proportional to its
    part's weight. One uniform draw a row (JAX's for ``seed``) and a
    ``searchsorted`` on the float32 cumulative weights; each part is a
    weight-masked view."""
    w = np.asarray(weights, np.float64)
    if not np.isfinite(w).all() or (w <= 0).any():
        raise ValueError(f"split weights must be positive and finite, got {weights}")
    p = w / w.sum()
    dev = table.W.device
    u = prng.uniform(prng.PRNGKey(seed), table.n_pad, dev)
    part = torch.searchsorted(torch.as_tensor(np.cumsum(p).astype(np.float32), device=dev), u)
    return [table.with_weights(torch.where(part == i, table.W, 0.0)) for i in range(len(w))]


def distinct(table: TorchTable, cols=None) -> TorchTable:
    """df.distinct() / df.dropDuplicates(cols) over live rows.

    The result's shape depends on the data, so this is an ACTION: unique
    rows are found on the host and put back as a fresh table. Dedup keys
    default to ALL columns (attributes + class vars, as in Spark); the
    first occurrence's full row — X, Y and weight — survives."""
    X, Y, W = table.to_numpy()
    live = W > 0
    live_idx = np.flatnonzero(live)
    Xl = X[live]
    Yl = Y[live] if Y is not None else None
    Wl = W[live]
    full = Xl if Yl is None else np.concatenate([Xl, Yl], axis=1)
    full_names = [v.name for v in table.domain.attributes] + [
        v.name for v in (table.domain.class_vars or ())]
    if cols is not None:
        idx = []
        for c in cols:
            if c not in full_names:
                raise ValueError(f"distinct column {c!r} not found; available: {full_names}")
            idx.append(full_names.index(c))
        keymat = full[:, idx]
    else:
        keymat = full
    # NaN != NaN under np.unique; Spark's dropDuplicates treats nulls as
    # equal, so NaN maps to a sentinel first (the lowest float32)
    keymat = np.where(np.isnan(keymat), np.float32(np.finfo(np.float32).min), keymat)
    _, first = np.unique(keymat, axis=0, return_index=True)
    order = np.sort(first)
    metas = table.metas[live_idx[order]] if table.metas is not None else None
    return TorchTable.from_numpy(
        Domain(list(table.domain.attributes), table.domain.class_vars, table.domain.metas),
        Xl[order].astype(np.float32),
        None if Yl is None else Yl[order].astype(np.float32),
        metas=metas, W=Wl[order].astype(np.float32), session=table.session)


def crosstab(table: TorchTable, col1: str, col2: str) -> np.ndarray:
    """df.stat.crosstab: weighted contingency counts f32[k1, k2], one
    grouped pass over the pair's index. As in the reference, a NaN code
    counts as category 0 and a row out of either column's range nowhere."""
    v1, v2 = table.domain[col1], table.domain[col2]
    for v in (v1, v2):
        if not isinstance(v, DiscreteVariable) or not v.values:
            raise ValueError(f"crosstab needs discrete columns, got {v.name!r}")
    k1, k2 = len(v1.values), len(v2.values)
    a = to_index(table.column(col1)).to(torch.int64)
    b = to_index(table.column(col2)).to(torch.int64)
    ok = (a >= 0) & (a < k1) & (b >= 0) & (b < k2)
    slot = torch.where(ok, a * k2 + b, k1 * k2).to(torch.int32)
    return grouped_sums(slot, table.W[:, None], k1 * k2)[:, 0].reshape(k1, k2).cpu().numpy()


def with_column(table: TorchTable, name: str, expr) -> TorchTable:
    """df.withColumn: append (or, for an existing name, replace) a column.

    ``expr``: a ready [N_pad] column (tensor or numpy array — e.g. a window
    function's result from ops/window.py), a callable (table) -> f32[N_pad],
    or a SQL-ish string over attribute names ("a + log(b)") evaluated by
    the SQLTransformer expression engine."""
    if isinstance(expr, (torch.Tensor, np.ndarray)):
        col = torch.as_tensor(expr, device=table.W.device)
    elif callable(expr):
        col = expr(table)
    else:
        import ast as _ast

        from orange3_spark_tpu_torch.models.feature_extra import SQLTransformer

        env = {v.name: table.X[:, j] for j, v in enumerate(table.domain.attributes)}
        col = SQLTransformer()._eval(_ast.parse(str(expr), mode="eval"), env)
    # dead/padding rows carry X=0 and can give NaN/inf under the expression
    # (0/0, log 0): zero them so weighted reductions downstream never see 0·NaN
    col = torch.where(table.W > 0, torch.as_tensor(col, device=table.W.device), 0.0)
    names = [v.name for v in table.domain.attributes]
    if name in names:
        # Spark's withColumn REPLACES an existing column in place
        j = names.index(name)
        X = table.X.clone()
        X[:, j] = col
        attrs = list(table.domain.attributes)
        attrs[j] = ContinuousVariable(name)
        return table.with_X(X, Domain(attrs, table.domain.class_vars, table.domain.metas))
    domain = Domain(list(table.domain.attributes) + [ContinuousVariable(name)],
                    table.domain.class_vars, table.domain.metas)
    return table.with_X(torch.cat([table.X, col[:, None]], dim=1), domain)


def drop(table: TorchTable, cols) -> TorchTable:
    """df.drop(columns): select the complement."""
    gone = {cols} if isinstance(cols, str) else set(cols)
    names = [v.name for v in table.domain.attributes]
    unknown = gone - set(names)
    if unknown:
        raise ValueError(f"cannot drop unknown columns {sorted(unknown)}")
    return table.select([n for n in names if n not in gone])
