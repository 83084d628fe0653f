"""Frequent pattern mining: ``pyspark.ml.fpm``'s FPGrowth (frequent
itemsets, association rules, transform) and PrefixSpan (sequential
patterns).

Port of ``orange3_spark_tpu/models/fpm.py``. Transactions become a binary
incidence matrix on the device; the support of a level's candidate
itemsets is one product ``B @ members.T`` (a row holds a candidate when it
holds all its items), then ``full.T @ W``, with TF32 off so that the
float32 counts are exact, in chunks of 2^22 rows summed in float64 on the
host, as the reference does (its counts are exact integers below 2^24). The
candidates are also taken in chunks, so the [rows, candidates] product
never exceeds ``SUPPORT_CHUNK_ELEMS`` floats (a level can hold tens of
thousands of candidates). Candidate generation, the rules and PrefixSpan's
recursion stay on the host, as in the reference.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Estimator, HasParams, Model, Params
from orange3_spark_tpu_torch.models.text import _meta_col


@dataclasses.dataclass(frozen=True)
class FPGrowthParams(Params):
    min_support: float = 0.3      # MLlib minSupport (fraction of rows)
    min_confidence: float = 0.8   # MLlib minConfidence (rules)
    items_col: str = ""           # meta column of item lists; "" => X is binary
    max_pattern_length: int = 10  # guard on itemset size


def _incidence(table: TorchTable, items_col: str):
    """(binary incidence [N_pad, n_items] on the table's device, item
    names)."""
    if not items_col:
        names = [v.name for v in table.domain.attributes]
        return (table.X > 0).to(torch.float32), names
    col = _meta_col(table, items_col)
    vocab: dict[str, int] = {}
    rows, cols = [], []
    for i, items in enumerate(col):
        items = items if isinstance(items, (list, tuple)) else str(items).split()
        for it in set(items):
            j = vocab.setdefault(str(it), len(vocab))
            rows.append(i)
            cols.append(j)
    M = np.zeros((table.n_pad, len(vocab)), dtype=np.float32)
    M[rows, cols] = 1.0
    names = [w for w, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
    return torch.from_numpy(M).to(table.X.device), names


#: rows of one support chunk (float32 integers are exact below 2^24)
SUPPORT_CHUNK_ROWS = 1 << 22
#: the largest [rows, candidates] product a support chunk forms
SUPPORT_CHUNK_ELEMS = 1 << 28


def _matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full float32 (TF32 off on CUDA): counts stay exact."""
    if not a.is_cuda:
        return a @ b
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _support_chunk(B, W, members):
    hits = _matmul_exact(B, members.T)                                  # [N, c]
    sizes = members.sum(dim=1)
    full = (hits >= sizes[None, :] - 0.5).to(torch.float32)
    return _matmul_exact(full.T, W[:, None])[:, 0]                       # [c]


def support_batch(B: torch.Tensor, W: torch.Tensor, members: torch.Tensor) -> np.ndarray:
    """Supports (float64) of a batch of candidate itemsets: ``members``
    f32[c, m], one row a candidate. Row chunks of ``SUPPORT_CHUNK_ROWS``
    summed in float64 on the host; candidate chunks so that no product
    exceeds ``SUPPORT_CHUNK_ELEMS``."""
    n, c = B.shape[0], members.shape[0]
    rows = min(n, SUPPORT_CHUNK_ROWS)
    cands = max(1, SUPPORT_CHUNK_ELEMS // max(rows, 1))
    total = np.zeros((c,), dtype=np.float64)
    for c0 in range(0, c, cands):
        mem = members[c0:c0 + cands]
        for s in range(0, n, SUPPORT_CHUNK_ROWS):
            e = min(s + SUPPORT_CHUNK_ROWS, n)
            total[c0:c0 + cands] += _support_chunk(B[s:e], W[s:e], mem).cpu().numpy()
    return total


class FPGrowthModel(Model):
    def __init__(self, params, item_names, freq_itemsets, n_rows_weighted):
        self.params = params
        self.item_names = tuple(item_names)
        # list[(frozenset[int] item ids, float support count)]
        self.freq_itemsets_ = freq_itemsets
        self.n_rows_weighted = n_rows_weighted
        self.association_rules_ = self._rules()

    @property
    def state_pytree(self):
        return {}

    def freq_itemsets(self):
        """MLlib freqItemsets frame: [{'items': [names], 'freq': count}]."""
        return [{"items": sorted(self.item_names[i] for i in s), "freq": c}
                for s, c in self.freq_itemsets_]

    def _rules(self):
        """antecedent => consequent with confidence, lift and support
        (MLlib: exactly one consequent item a rule)."""
        sup = {s: c for s, c in self.freq_itemsets_}
        rules = []
        for s, c in self.freq_itemsets_:
            if len(s) < 2:
                continue
            for cons_item in sorted(s):
                ante = s - {cons_item}
                if ante not in sup:
                    continue
                conf = c / sup[ante]
                if conf >= self.params.min_confidence:
                    cons_sup = sup.get(frozenset([cons_item]))
                    lift = (conf / (cons_sup / self.n_rows_weighted)
                            if cons_sup else float("nan"))
                    rules.append({
                        "antecedent": sorted(self.item_names[i] for i in ante),
                        "consequent": [self.item_names[cons_item]],
                        "confidence": conf,
                        "lift": lift,
                        "support": c / self.n_rows_weighted,
                    })
        return rules

    def transform(self, table: TorchTable) -> TorchTable:
        """MLlib transform: for each row, the consequents of the rules whose
        antecedent the row holds and whose item it lacks, as one binary
        'pred_<item>' column an item; all rules in two products."""
        B, names = _incidence(table, self.params.items_col)
        name_to_id = {n: j for j, n in enumerate(names)}
        pred_items = sorted({it for r in self.association_rules_ for it in r["consequent"]})
        m = B.shape[1]
        dev = B.device
        usable = [r for r in self.association_rules_
                  if all(a in name_to_id for a in r["antecedent"])]
        if usable:
            ante_members = np.zeros((len(usable), m), dtype=np.float32)
            cons_map = np.zeros((len(usable), len(pred_items)), dtype=np.float32)
            for ri, r in enumerate(usable):
                ante_members[ri, [name_to_id[a] for a in r["antecedent"]]] = 1.0
                for it in r["consequent"]:
                    cons_map[ri, pred_items.index(it)] = 1.0
            AM = torch.from_numpy(ante_members).to(dev)
            sizes = AM.sum(dim=1)
            has_ante = (_matmul_exact(B, AM.T) >= sizes[None, :] - 0.5).to(torch.float32)
            fired = _matmul_exact(has_ante, torch.from_numpy(cons_map).to(dev)) > 0
            has_item = torch.stack(
                [B[:, name_to_id[it]] > 0 if it in name_to_id
                 else torch.zeros((B.shape[0],), dtype=torch.bool, device=dev)
                 for it in pred_items], dim=1)
            out = (fired & ~has_item).to(torch.float32)
        else:
            out = torch.zeros((B.shape[0], len(pred_items)), dtype=torch.float32, device=dev)
        new_attrs = list(table.domain.attributes) + [
            ContinuousVariable(f"pred_{it}") for it in pred_items]
        domain = Domain(new_attrs, table.domain.class_vars, table.domain.metas)
        return table.with_X(torch.cat([table.X, out], dim=1), domain)


class FPGrowth(Estimator):
    ParamsCls = FPGrowthParams
    params: FPGrowthParams

    def _fit(self, table: TorchTable) -> FPGrowthModel:
        p = self.params
        B, names = _incidence(table, p.items_col)
        W = table.W
        m = len(names)
        total_w = float(W.sum())
        min_count = p.min_support * total_w
        sup1 = support_batch(B, W, torch.eye(m, dtype=torch.float32, device=B.device))
        freq: list[tuple[frozenset, float]] = []
        current = []
        for j in range(m):
            if sup1[j] >= min_count:
                s = frozenset([j])
                freq.append((s, float(sup1[j])))
                current.append(s)
        level = 1
        # level-wise growth (Apriori over the incidence matrix): candidates
        # on the host, a level's supports in one batch
        while current and level < p.max_pattern_length:
            level += 1
            cand = sorted({a | b for a, b in itertools.combinations(current, 2)
                           if len(a | b) == level})
            fset = {s for s, _ in freq}
            cand = [c for c in cand
                    if all(frozenset(sub) in fset
                           for sub in itertools.combinations(c, level - 1))]
            if not cand:
                break
            members = np.zeros((len(cand), m), dtype=np.float32)
            for ci, s in enumerate(cand):
                members[ci, sorted(s)] = 1.0
            sup = support_batch(B, W, torch.from_numpy(members).to(B.device))
            current = []
            for ci, s in enumerate(cand):
                if sup[ci] >= min_count:
                    freq.append((s, float(sup[ci])))
                    current.append(s)
        return FPGrowthModel(p, names, freq, total_w)


# ------------------------------------------------------------------ PrefixSpan
@dataclasses.dataclass(frozen=True)
class PrefixSpanParams(Params):
    min_support: float = 0.1        # MLlib minSupport
    max_pattern_length: int = 10    # MLlib maxPatternLength
    max_local_proj_db_size: int = 32_000_000  # parity; host recursion here
    sequence_col: str = "sequence"  # meta column of item-list sequences


def _seq_contains(seq, pat) -> bool:
    """Itemset-subsequence containment: each pattern element a subset of a
    strictly later sequence element (the greedy match is exact)."""
    i = 0
    for elem in seq:
        if pat[i] <= elem:
            i += 1
            if i == len(pat):
                return True
    return False


class PrefixSpan(HasParams):
    """Sequential pattern mining (Pei et al.) with MLlib's API shape:
    ``find_frequent_sequential_patterns(table)`` returns the pattern frame.
    A depth-first search with s-extensions (an item opens a new element)
    and i-extensions (an item joins the last element); the recursion and
    its containment counts run on the host, as in the reference."""

    ParamsCls = PrefixSpanParams

    def find_frequent_sequential_patterns(self, table: TorchTable):
        p = self.params
        col = _meta_col(table, p.sequence_col)
        live = table.W[: len(col)].cpu().numpy() > 0
        seqs = []
        for i, s in enumerate(col):
            if not live[i]:
                continue
            if isinstance(s, (list, tuple)):
                seqs.append([frozenset(e) if isinstance(e, (list, tuple, set, frozenset))
                             else frozenset([e]) for e in s])
            else:
                seqs.append([frozenset([tok]) for tok in str(s).split()])
        min_count = max(p.min_support * len(seqs), 1.0)
        item_counts: dict[str, int] = {}
        for sq in seqs:
            for it in {x for e in sq for x in e}:
                item_counts[it] = item_counts.get(it, 0) + 1
        freq_items = sorted(it for it, c in item_counts.items() if c >= min_count)
        results: list[tuple[tuple, int]] = []

        def count(pat) -> int:
            return sum(1 for sq in seqs if _seq_contains(sq, pat))

        def explore(pat, total_items):
            if total_items >= p.max_pattern_length:
                return
            for it in freq_items:
                cand = pat + [frozenset([it])]                 # s-extension
                c = count(cand)
                if c >= min_count:
                    results.append((tuple(tuple(sorted(e)) for e in cand), c))
                    explore(cand, total_items + 1)
                if pat and all(it > x for x in pat[-1]):       # i-extension
                    cand = pat[:-1] + [pat[-1] | {it}]
                    c = count(cand)
                    if c >= min_count:
                        results.append((tuple(tuple(sorted(e)) for e in cand), c))
                        explore(cand, total_items + 1)

        explore([], 0)
        return [{"sequence": [list(e) for e in pat], "freq": c}
                for pat, c in sorted(results, key=lambda r: (-r[1], r[0]))]
