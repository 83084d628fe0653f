"""Touched-row-only optimizer updates for the hashed embedding hot path.

A Criteo-shaped step touches at most ``batch x n_cat`` embedding rows, so
the sparse rules update only those rows (lazy/sparse Adagrad and FTRL, as
in large-scale click-through training):

* **update rules** — ``sgd`` / ``adagrad`` / ``ftrl``, each as a
  ``sparse_*`` (touched-row) and a ``dense_*`` (full-table twin) lowering
  of the SAME math; per-row f32 slots (adagrad's ``acc``, ftrl's ``z`` and
  ``n``) live beside the table and are touched just as sparsely.
* **within-step dedup** — per-occurrence gradients are sorted by bucket and
  segment-summed, so each touched row is gathered, updated and written
  back once. The sort is STABLE, so a row's occurrences are summed in
  their original order, the order of the dense twin's scatter-add.
* **lazy decay** — regularization is decoupled weight decay
  (``p <- (1 - lr*reg) * p - update(g)``). An untouched row's step is a
  multiply by ``(1 - lr*reg)``, so the sparse rules defer it: a per-row
  last-seen step ``t`` lets the next touch apply ``(1 - lr*reg)^dt``, and
  ``finalize_lazy_decay`` settles what is left at the end of the fit.
  FTRL carries its own L2 in its closed form and ignores the decay.
* **two lowerings** of the dedup, resolved per device:

  - ``'plan'`` — the sort runs on the HOST at ingest (``build_plan_np``):
    a chunk's hashed indices are static data, so the plan (sort order,
    segment ids, unique rows, inverse map) rides the chunk cache and the
    step becomes gather -> segment sum -> rule -> gather-based writeback.
    The CPU default. Its ``inv`` map is an [n_dims] array per chunk.
    Under value-weighted rows the plan also carries each sorted
    occurrence's value (``val``).
  - ``'sort'`` — the dedup runs in the step: a stable ``torch.sort`` of
    the occurrence keys, then ``segment_update_sorted`` does the rest in
    place (on CUDA one kernel: the sums, the decay, the rule and the
    write-back of the live rows only). No per-chunk memory beside the
    chunk. The CUDA default.
  - under the 'packed' cache dtype the plan is stored bit-packed
    (``pack_plan_np``) and unpacked in the step (``unpack_plan``),
    exactly.

* **value-weighted rows** (libsvm's (index, value) pairs): an
  occurrence's gradient is ``dl[row] * val``; a pair whose raw index is
  below 0 (the -1 padding of ``io/libsvm``) is dead in both lowerings, as
  a padding row is.
* **kill-switch** — ``OTPU_SPARSE_UPDATE=0`` resolves every ``sparse_*``
  rule to its ``dense_*`` twin, once, at fit entry.

Segment sums go through ``ops/segment_sum``: on the CPU the plain
versions, an ``index_add_`` that adds in index order, so a row's
occurrences are summed one after another in their stable-sorted order
(bitwise the dense twin's sums, and the reference's); on CUDA the
hand-written kernels, which add without float atomics in an order fixed by
the data, so two fits on the card give the same bits (a segment of up to
32 occurrences, the kernels' ``walk_max()``, even in the CPU's order). The
'plan' lowering and the dense gradient of the table (``dense_table_grad``,
the 'adam' rule and the dense twins) call ``segment_sum_sorted``; on CUDA
the dense gradient is a stable sort of the occurrences, the segment sums
and one write per touched row.

The step has no host sync, so a replay epoch can be captured as one CUDA
graph: the step counter ``opt_state["step"]`` is a device int32 scalar
that the step advances. On CUDA the 'sort' lowering's kernel finds the
segments and the live rows on the device. Its plain version works on all
``plan_slots`` segment slots (as the reference does) instead of selecting
the live ones. What it cannot take from JAX is a scatter that drops
out-of-range indices (PyTorch raises on the CPU and asserts on CUDA), so
a slot past the live segments repeats the last live slot: the same row,
the same new value, written twice. The live segments come first (the
dead sentinel ``n_dims`` sorts last), so that slot is ``min(j, L - 1)``
with ``L`` the live count, a device scalar.

'adam' (the params' default) is the dense optax rule ``optax.adam(1.0)``
scaled by the learning rate, written as plain tensor functions over
``opt_state`` (``init_adam_state``, ``adam_update``).

Layering: this module knows nothing about chunks or streams;
``models/hashed_linear`` composes it into the step.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from orange3_spark_tpu_torch.core.fmath import sqrt32
from orange3_spark_tpu_torch.io.codec import bit_width, flat_words, pack_flat_np, unpack_flat
from orange3_spark_tpu_torch.ops.segment_sum import (
    ROUND_TO, RULE_SLOTS, segment_sum_sorted, segment_update_sorted,
)

__all__ = [
    "OPTIM_UPDATES", "SPARSE_UPDATES", "DENSE_UPDATES", "ADAGRAD_EPS", "FTRL_BETA",
    "sparse_updates_enabled", "resolve_optim_update", "resolve_sparse_lowering",
    "optim_kind", "is_sparse_update", "init_optim_state", "apply_rule",
    "dense_update", "ADAM_B1", "ADAM_B2", "ADAM_EPS", "init_adam_state",
    "adam_update", "plan_slots", "plan_field_shapes", "build_plan_np",
    "plan_pack_widths", "plan_packed_field_shapes", "pack_plan_np", "unpack_plan",
    "occurrence_dead", "occurrence_keys", "sorted_keys_update", "sparse_embedding_update",
    "dense_table_grad", "EMB_UPDATES", "finalize_lazy_decay",
]

SPARSE_UPDATES = ("sparse_sgd", "sparse_adagrad", "sparse_ftrl")
DENSE_UPDATES = ("dense_sgd", "dense_adagrad", "dense_ftrl")
OPTIM_UPDATES = ("adam",) + DENSE_UPDATES + SPARSE_UPDATES

#: adagrad denominator floor: sqrt(acc + eps). A row's first touch moves it
#: by at most lr * |g| / sqrt(g^2) = lr.
ADAGRAD_EPS = 1e-10
#: FTRL-proximal beta (McMahan et al. 2013); alpha is the fit's step_size.
FTRL_BETA = 1.0


def sparse_updates_enabled() -> bool:
    """``OTPU_SPARSE_UPDATE=0`` resolves every ``sparse_*`` rule to its
    ``dense_*`` twin (read at each resolution, i.e. at each fit's entry)."""
    return os.environ.get("OTPU_SPARSE_UPDATE", "1") != "0"


def resolve_optim_update(value: str) -> str:
    """The concrete update rule of a fit, resolved once at its entry."""
    if value not in OPTIM_UPDATES:
        raise ValueError(f"optim_update must be one of {OPTIM_UPDATES}, got {value!r}")
    if value in SPARSE_UPDATES and not sparse_updates_enabled():
        return "dense_" + value[len("sparse_"):]
    return value


def resolve_sparse_lowering(value: str, device) -> str:
    """'auto' picks the dedup lowering by device: ``'sort'`` on CUDA (the
    in-step sort is milliseconds there, and device memory is what a plan
    per chunk would cost), ``'plan'`` on the CPU (where an in-step sort of
    millions of keys costs seconds)."""
    if value == "auto":
        return "sort" if torch.device(device).type == "cuda" else "plan"
    if value not in ("plan", "sort"):
        raise ValueError(
            f"sparse_lowering must be 'auto' | 'plan' | 'sort', got {value!r}")
    return value


def optim_kind(resolved: str) -> str:
    """'adam' | 'sgd' | 'adagrad' | 'ftrl' from a resolved optim_update."""
    if resolved == "adam":
        return "adam"
    return resolved.split("_", 1)[1]


def is_sparse_update(resolved: str) -> bool:
    return resolved in SPARSE_UPDATES


def _rule_slots(kind: str, param: torch.Tensor) -> dict:
    return {n: torch.zeros_like(param) for n in RULE_SLOTS[kind]}


def init_optim_state(resolved: str, theta: dict) -> dict:
    """Fresh state of a rule. 'adam': ``init_adam_state``. The others: the
    step counter (a device int32 scalar, so a captured step advances it),
    the per-row last-seen steps ``t`` (the lazy-decay timestamps; unused by
    the dense twins and ftrl) and per-parameter slot dicts."""
    kind = optim_kind(resolved)
    if kind == "adam":
        return init_adam_state(theta)
    emb = theta["emb"]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=emb.device),
        "t": torch.zeros(emb.shape[0], dtype=torch.int32, device=emb.device),
        "slots": {name: _rule_slots(kind, p) for name, p in theta.items()},
    }


# --------------------------------------------------------------- the rules

def apply_rule(kind: str, p, slots: dict, g, lr: float, reg: float, l1: float):
    """One rule application, shared by the touched-row engines (``p``,
    ``slots``, ``g`` are gathered [U, k] rows) and the dense twins (full
    arrays). Decoupled decay is the caller's job; ``reg``/``l1`` only feed
    FTRL's closed form. A zero gradient is a no-op for every rule, which
    keeps untouched rows of the dense twins and pad slots inert."""
    if kind == "sgd":
        return p - lr * g, slots
    if kind == "adagrad":
        acc = slots["acc"] + g * g
        return p - lr * g * torch.rsqrt(acc + ADAGRAD_EPS), {"acc": acc}
    if kind == "ftrl":
        n, z = slots["n"], slots["z"]
        n2 = n + g * g
        sigma = (sqrt32(n2) - sqrt32(n)) / lr
        z2 = z + g - sigma * p
        shrunk = torch.sign(z2) * torch.clamp_min(torch.abs(z2) - l1, 0.0)
        p2 = -shrunk / ((FTRL_BETA + sqrt32(n2)) / lr + 2.0 * reg)
        return p2, {"n": n2, "z": z2}
    raise ValueError(f"unknown rule kind {kind!r}")


def dense_update(kind: str, p, slots: dict, g, lr: float, decay: float, reg: float,
                 l1: float, *, use_decay: bool):
    """Dense twin / small-parameter update: per-step decoupled decay, then
    the rule over the full array."""
    if use_decay and kind != "ftrl":
        p = p * decay
    return apply_rule(kind, p, slots, g, lr, reg, l1)


# ------------------------------------------------------- the dense adam rule
#: ``optax.adam(1.0)``'s constants (eps_root 0)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def init_adam_state(theta: dict) -> dict:
    """Zero moments and an int32 count on the device, as optax's
    ``ScaleByAdamState``."""
    dev = next(iter(theta.values())).device
    return {"count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": {k: torch.zeros_like(v) for k, v in theta.items()},
            "nu": {k: torch.zeros_like(v) for k, v in theta.items()}}


def adam_update(theta: dict, grads: dict, state: dict, lr: float):
    """One ``optax.adam(1.0)`` update scaled by ``lr`` and applied: the
    moments ``(1 - b) * g^i + b * m``, bias-corrected by ``1 - b^count``
    with the count advanced first (saturating, int32), the update
    ``m_hat / (sqrt(v_hat) + eps)``. Returns (theta, state)."""
    count = torch.where(state["count"] < torch.iinfo(torch.int32).max,
                        state["count"] + 1, state["count"])
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(ADAM_B1, c)
    bc2 = 1.0 - torch.pow(ADAM_B2, c)
    new_theta, mu, nu = {}, {}, {}
    for k, p in theta.items():
        g = grads[k]
        mu[k] = (1.0 - ADAM_B1) * g + ADAM_B1 * state["mu"][k]
        nu[k] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * state["nu"][k]
        u = (mu[k] / bc1) / (sqrt32(nu[k] / bc2) + ADAM_EPS)
        new_theta[k] = p + lr * -u
    return new_theta, {"count": count, "mu": mu, "nu": nu}


# ------------------------------------------------- plan building (host side)

def plan_slots(pad_rows: int, n_cat: int, n_dims: int) -> int:
    """Bound on a chunk's unique-row count, plus ONE spare slot for the
    dead-occurrence segment (padding rows): live segments number at most
    min(occurrences, table rows)."""
    return min(pad_rows * n_cat, n_dims) + 1


def plan_field_shapes(pad_rows: int, n_cat: int, n_dims: int,
                      value_weighted: bool = False) -> dict:
    """Shapes of the per-chunk plan arrays (all int32 but the value-weighted
    plan's f32 'val')."""
    M = pad_rows * n_cat
    shapes = {"row": (M,), "seg": (M,), "uniq": (plan_slots(pad_rows, n_cat, n_dims),),
              "inv": (n_dims,)}
    if value_weighted:
        shapes["val"] = (M,)
    return shapes


def build_plan_np(cats: np.ndarray, salts: np.ndarray, n_dims: int, n_valid: int, *,
                  vals: np.ndarray | None = None, idx: np.ndarray | None = None) -> dict:
    """Host-side touched-row plan of one padded chunk, built once on the
    prefetch thread and replayed every epoch.

    ``cats``: [N, C] raw categorical codes (before the hash; a NaN code
    hashes as code 0, as the step's hash takes it). ``vals``: the per-pair
    values of a value-weighted chunk. Dead occurrences (rows >= ``n_valid``,
    and with ``vals`` the pairs whose raw index is below 0) sort behind an
    ``n_dims`` sentinel into the spare slot; their gradients are zero
    (w == 0 rows, value-0 pairs), so nothing masks them in the step.

    Returns {'row': i32[M] source row of each SORTED occurrence, 'seg':
    i32[M] its segment id, 'uniq': i32[U] the touched table row of each
    segment (-1 on dead/pad slots), 'inv': i32[D] table row -> segment id
    (-1 untouched)[, 'val': f32[M] the sorted occurrences' values]}. The
    argsort is STABLE, so a row's occurrences keep their original order."""
    from orange3_spark_tpu_torch.ops.hashing import hash_columns_np

    cats = np.asarray(cats)
    if idx is None:
        idx = hash_columns_np(np.where(np.isnan(cats), np.float32(0.0), cats), salts, n_dims)
    N, C = idx.shape
    M = N * C
    U = plan_slots(N, C, n_dims)
    dead = np.zeros((N, C), np.bool_)
    if n_valid < N:
        dead[n_valid:] = True
    if vals is not None:
        dead |= cats < 0
    flat = np.where(dead, np.int32(n_dims), idx).reshape(-1)
    order = np.argsort(flat, kind="stable").astype(np.int32)
    s = flat[order]
    start = np.empty(M, np.bool_)
    start[0] = True
    np.not_equal(s[1:], s[:-1], out=start[1:])
    seg = (np.cumsum(start, dtype=np.int64) - 1).astype(np.int32)
    live_start = start & (s < n_dims)
    uniq = np.full(U, -1, np.int32)
    uniq[seg[live_start]] = s[live_start]
    inv = np.full(n_dims, -1, np.int32)
    inv[s[live_start]] = seg[live_start]
    plan = {"row": (order // C).astype(np.int32), "seg": seg, "uniq": uniq, "inv": inv}
    if vals is not None:
        plan["val"] = np.ascontiguousarray(np.asarray(vals, np.float32).reshape(-1)[order])
    return plan


def plan_pack_widths(pad_rows: int, n_cat: int, n_dims: int) -> dict:
    """Static bit widths of the packed plan arrays (io/codec.py), each
    bounded by the chunk and table shape: 'row' < pad_rows, 'uniq' + 1 <=
    n_dims (the -1 dead sentinel shifts to 0), 'inv' + 1 <= U. 'seg' has
    no width: it rises in 0/1 steps, so it is stored as its boundary bits
    and rebuilt by a running count."""
    U = plan_slots(pad_rows, n_cat, n_dims)
    return {"row": bit_width(pad_rows), "uniq": bit_width(n_dims + 1),
            "inv": bit_width(U + 1)}


def plan_packed_field_shapes(pad_rows: int, n_cat: int, n_dims: int) -> dict:
    """name -> (shape, dtype) of the packed plan's u32 arrays, in spill
    order. 'segb' holds one anchor per word and the boundary bits, hence
    twice the word count."""
    M = pad_rows * n_cat
    U = plan_slots(pad_rows, n_cat, n_dims)
    wb = plan_pack_widths(pad_rows, n_cat, n_dims)
    return {
        "rowp": ((flat_words(M, wb["row"]),), np.uint32),
        "segb": ((2 * -(-M // 32),), np.uint32),
        "uniqp": ((flat_words(U, wb["uniq"]),), np.uint32),
        "invp": ((flat_words(n_dims, wb["inv"]),), np.uint32),
    }


def _popcount_u32(words: np.ndarray) -> np.ndarray:
    """Set bits of each u32 word (numpy < 2.0 has no ``bitwise_count``)."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(words).astype(np.uint32)
    v = words.copy()
    v = v - ((v >> np.uint32(1)) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> np.uint32(2)) & np.uint32(0x33333333))
    v = (v + (v >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.uint32)


def pack_plan_np(plan: dict, pad_rows: int, n_cat: int, n_dims: int) -> dict:
    """The lossless bit-packed form of a plan, cached and spilled in place
    of the int32 arrays under the 'packed' cache dtype; ``unpack_plan`` is
    its exact inverse on the device. 'segb' is one running anchor per
    word (the set bits before it) followed by the segment-boundary bits."""
    wb = plan_pack_widths(pad_rows, n_cat, n_dims)
    seg = plan["seg"]
    M = seg.shape[0]
    start = np.empty(M, np.uint32)
    start[0] = 1
    start[1:] = (seg[1:] != seg[:-1]).astype(np.uint32)
    bitwords = pack_flat_np(start, 1)
    pops = _popcount_u32(bitwords)
    anchors = np.zeros(bitwords.shape[0], np.uint32)
    np.cumsum(pops[:-1], out=anchors[1:], dtype=np.uint32)
    return {
        "rowp": pack_flat_np(plan["row"], wb["row"]),
        "segb": np.concatenate([anchors, bitwords]),
        "uniqp": pack_flat_np(plan["uniq"] + 1, wb["uniq"]),
        "invp": pack_flat_np(plan["inv"] + 1, wb["inv"]),
    }


def unpack_plan(enc: dict, pad_rows: int, n_cat: int, n_dims: int) -> dict:
    """Device decode of ``pack_plan_np``'s arrays back to the int32 plan.
    'seg' is the running count of the boundary bits less one (the anchors
    only spare the reference a scan; a cumsum gives the same integers)."""
    M = pad_rows * n_cat
    U = plan_slots(pad_rows, n_cat, n_dims)
    wb = plan_pack_widths(pad_rows, n_cat, n_dims)
    B = enc["segb"].shape[0] // 2
    start = unpack_flat(enc["segb"][B:], 1, M)
    return {
        "row": unpack_flat(enc["rowp"], wb["row"], M),
        "seg": (torch.cumsum(start, 0, dtype=torch.int32) - 1),
        "uniq": unpack_flat(enc["uniqp"], wb["uniq"], U) - 1,
        "inv": unpack_flat(enc["invp"], wb["inv"], n_dims) - 1,
    }


def occurrence_dead(n_rows: int, n_cat: int, n_valid, device, raw_cats=None) -> torch.Tensor:
    """[N, C] dead-occurrence mask of the 'sort' lowering — the device twin
    of ``build_plan_np``'s rule: every occurrence of a padding row and, with
    ``raw_cats`` (a value-weighted chunk's raw indices), every pair whose
    index is below 0. ``n_valid`` is an int or a device int scalar."""
    rows = torch.arange(n_rows, dtype=torch.int32, device=device)
    dead = (rows[:, None] >= n_valid).expand(n_rows, n_cat)
    if raw_cats is not None:
        dead = dead | (raw_cats < 0)
    return dead


# ------------------------------------------------- the touched-row engines

def _touched_rows_update(kind, emb, t, slots, sums, rid, lr, decay, reg, l1, step, *,
                         use_decay):
    """Gather the touched rows (and slots and timestamps), apply catch-up
    lazy decay and the rule — the core both lowerings share. ``rid`` lists
    the touched rows (-1 on the plan's dead slots: gathers clamp, the
    writeback masks). Returns the updated rows and slot rows."""
    rsafe = rid.clamp_min(0)
    p_rows = emb.index_select(0, rsafe)
    slot_rows = {n: v.index_select(0, rsafe) for n, v in slots.items()}
    if use_decay:
        t_rows = t.index_select(0, rsafe)
        # catch-up for the steps the row sat untouched, plus this step's
        # own decay: (1-lr*reg)^(step+1-t), the product the dense twin
        # applies one factor at a time
        dt = (step + 1 - t_rows).to(torch.float32)
        fac = torch.pow(torch.full_like(dt, decay), dt)
        p_rows = p_rows * fac[:, None]
    return apply_rule(kind, p_rows, slot_rows, sums, lr, reg, l1)


def _sort_segments(flat: torch.Tensor):
    """Stable sort of flat occurrence keys and their segments, for the dense
    table gradient: (sorted keys, the sort order, segment-start flags, i32
    segment ids from 0). No host sync."""
    s_idx, order = torch.sort(flat, stable=True)
    start = torch.ones_like(s_idx, dtype=torch.bool)
    torch.ne(s_idx[1:], s_idx[:-1], out=start[1:])
    return s_idx, order, start, torch.cumsum(start, 0, dtype=torch.int32) - 1


#: the embedding's gather/scatter lowerings ('auto' resolves to 'fused')
EMB_UPDATES = ("fused", "per_column", "sorted")


def _occurrences(idx: torch.Tensor, vals, emb_update: str):
    """The table gradient's occurrences in the order its sums take them:
    (flat keys [M], the row of ``dl`` of each, the flat values or None).
    'fused' and 'sorted' take the [N, C] occurrences row by row (the
    reference's one scatter over the flattened gather), 'per_column'
    column by column (its C gathers, one a column)."""
    N, C = idx.shape
    if emb_update == "per_column":
        rows = torch.arange(N, device=idx.device).repeat(C)
        return (idx.T.reshape(-1), rows,
                None if vals is None else vals.T.reshape(-1))
    return idx.reshape(-1), None, None if vals is None else vals.reshape(-1)


def dense_table_grad(idx: torch.Tensor, dl: torch.Tensor, n_rows: int, *, vals=None,
                     emb_update: str = "fused", round_to=None) -> torch.Tensor:
    """The table's [n_rows, k] gradient: each row of ``dl`` [N, k] (times
    the pair's value with ``vals`` [N, C]) added into the table rows of its
    ``idx`` [N, C] occurrences. 'fused' and 'per_column' on the CPU add by
    ``index_add_`` in their occurrence order (row by row, or column by
    column). 'sorted' (the reference's custom backward: a stable sort of
    the pairs, then a conflict-free scatter), and every lowering on CUDA,
    sort the occurrences stably, sum them by segment with the deterministic
    kernel (the same order for segments of up to ``walk_max()`` rows) and
    write each touched row once; slots past the live segments repeat the
    last live one, the same row and value written twice (no host sync).

    ``round_to`` (torch.bfloat16 or torch.float16: the fit's compute dtype)
    gives the gradient the reference takes through its table rows rounded
    to that type: each occurrence's gradient rounded to it, and each table
    row's sum held in it (an add rounded at a time, in occurrence order,
    by ``segment_sum_sorted(round_to=)`` on every device); under
    'per_column' a sum a column, the C columns' sums then added from the
    last column to the first, each add rounded but the last one (the
    reference's compiled backward pass: XLA keeps the last add of the
    columns' cotangents in float32)."""
    if emb_update not in EMB_UPDATES:
        raise ValueError(f"emb_update must be one of {EMB_UPDATES}, got {emb_update!r}")
    N, C = idx.shape
    k = dl.shape[1]
    if ROUND_TO[round_to] and emb_update == "per_column":
        total = None
        for c in reversed(range(C)):
            col = _dense_table_grad_sorted(
                idx[:, c:c + 1], dl, n_rows, vals=None if vals is None else vals[:, c:c + 1],
                round_to=round_to)
            if total is None:
                total = col
            elif c:
                total = (total + col).to(round_to).to(torch.float32)
            else:
                total = total + col
        return total
    if idx.device.type != "cuda" and emb_update != "sorted" and not ROUND_TO[round_to]:
        out = torch.zeros((n_rows, k), dtype=dl.dtype, device=dl.device)
        flat, rows, vflat = _occurrences(idx, vals, emb_update)
        g = dl[:, None, :].expand(N, C, k).reshape(N * C, k) if rows is None \
            else dl.index_select(0, rows)
        if vflat is not None:
            g = g * vflat[:, None]
        return out.index_add_(0, flat, g)
    return _dense_table_grad_sorted(idx, dl, n_rows, vals=vals, emb_update=emb_update,
                                    round_to=round_to)


def _dense_table_grad_sorted(idx: torch.Tensor, dl: torch.Tensor, n_rows: int, *,
                             vals=None, emb_update: str = "fused", round_to=None):
    """``dense_table_grad``'s sorted form (CUDA's, and 'sorted' everywhere;
    on the CPU the tests hold it to the ``index_add_`` form bitwise)."""
    N, C = idx.shape
    k = dl.shape[1]
    flat, rows, vflat = _occurrences(idx, vals, emb_update)
    s_idx, order, start, seg = _sort_segments(flat)
    U = min(N * C, n_rows)
    g = dl.index_select(0, order // C if rows is None else rows.index_select(0, order))
    if vflat is not None:
        g = g * vflat.index_select(0, order)[:, None]
    if ROUND_TO[round_to]:
        g = g.to(round_to).to(torch.float32)
    sums = segment_sum_sorted(g, seg, U, round_to=round_to)
    uniq = torch.zeros(U, dtype=s_idx.dtype, device=idx.device).scatter_(0, seg, s_idx)
    src = torch.minimum(torch.arange(U, device=idx.device), start.sum() - 1)
    out = torch.zeros((n_rows, k), dtype=dl.dtype, device=dl.device)
    return out.index_copy_(0, uniq.index_select(0, src).to(torch.int64),
                           sums.index_select(0, src))


def sparse_embedding_update(kind, emb, t, slots, dl, idx, lr, decay, reg, l1, step, *,
                            lowering: str, use_decay: bool, plan=None, n_valid=None,
                            raw_cats=None, vals=None):
    """One touched-row-only table update. ``dl`` is the [N, k] gradient of
    the loss with respect to the logits; an occurrence's gradient is
    ``dl[row]``, times its pair's value in a value-weighted chunk (``vals``
    [N, C]; its ``raw_cats`` [N, C], the indices before the hash, mark the
    dead pairs, index < 0). Returns (emb, t, slots).

    'plan': the host-built plan gives the sort order, segments, unique rows
    and inverse map; the writeback is a gather
    (``where(touched, new_rows[inv], emb)``) into new tensors.
    'sort': a stable sort of the occurrence keys in the step, then
    ``segment_update_sorted`` updates the touched rows in place (on CUDA one
    kernel; on the CPU its plain version, the chain over all ``plan_slots``
    slots of the module docstring). No step of either lowering waits for
    the device."""
    D = emb.shape[0]
    if lowering == "plan":
        g = dl.index_select(0, plan["row"])
        if "val" in plan:
            g = g * plan["val"][:, None]
        sums = segment_sum_sorted(g, plan["seg"], plan["uniq"].shape[0])
        p_rows, slot_rows = _touched_rows_update(
            kind, emb, t, slots, sums, plan["uniq"], lr, decay, reg, l1, step,
            use_decay=use_decay)
        inv = plan["inv"]
        sel = (inv >= 0)[:, None]
        isafe = inv.clamp_min(0)
        emb = torch.where(sel, p_rows.index_select(0, isafe), emb)
        slots = {n: torch.where(sel, v.index_select(0, isafe), slots[n])
                 for n, v in slot_rows.items()}
        if use_decay:
            t = torch.where(sel[:, 0], step + 1, t).to(torch.int32)
        return emb, t, slots

    if lowering != "sort":
        raise ValueError(f"unknown sparse lowering {lowering!r}")
    if isinstance(n_valid, int) and n_valid == 0:
        return emb, t, slots          # every occurrence dead: no row moves
    return sorted_keys_update(kind, emb, t, slots, dl, occurrence_keys(idx, n_valid, D, raw_cats),
                              idx.shape[1], lr, decay, reg, l1, step, use_decay=use_decay,
                              vals=None if vals is None else vals.reshape(-1).contiguous())


def occurrence_keys(idx: torch.Tensor, n_valid, D: int, raw_cats=None) -> torch.Tensor:
    """The 'sort' lowering's flat [N·C] occurrence keys: the table row of
    each occurrence, or the sentinel ``D`` for a dead one (padding rows,
    value-weighted pads; ``occurrence_dead``), which sorts last."""
    N, C = idx.shape
    return idx.masked_fill(occurrence_dead(N, C, n_valid, idx.device, raw_cats), D).reshape(-1)


def sorted_keys_update(kind, emb, t, slots, dl, keys, C: int, lr, decay, reg, l1, step, *,
                       use_decay: bool, vals=None):
    """The 'sort' lowering after its keys: a stable sort of ``keys`` (i32
    [M], the sentinel ``emb.shape[0]`` for dead occurrences; occurrence i
    takes ``dl[i // C]``, times ``vals[i]`` when given), then
    ``segment_update_sorted`` in place. A gang calls it on the global
    occurrence list (every rank's keys, in rank order), so every rank runs
    the same arithmetic as one process on the global chunk."""
    s_idx, order = torch.sort(keys, stable=True)
    return segment_update_sorted(kind, s_idx, order, C, dl, emb, slots, t, step, lr, decay,
                                 reg, l1, use_decay=use_decay, vals=vals)


def finalize_lazy_decay(theta: dict, state: dict, lr: float, reg: float,
                        resolved: str) -> dict:
    """Settle the decay a sparse-trained table still owes: rows untouched
    since step ``t`` get their trailing ``(1-lr*reg)^(step-t)`` in one pass
    at the end of the fit, after which the table equals the dense
    schedule's. No-op for dense twins, FTRL and reg == 0."""
    kind = optim_kind(resolved)
    if not is_sparse_update(resolved) or kind == "ftrl" or reg == 0 or lr == 0:
        return theta
    theta = dict(theta)
    dt = (state["step"] - state["t"]).to(torch.float32)
    fac = torch.pow(torch.full_like(dt, float(np.float32(1.0 - lr * reg))), dt)
    theta["emb"] = theta["emb"] * fac[:, None]
    return theta
