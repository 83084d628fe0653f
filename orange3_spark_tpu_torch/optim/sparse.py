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
  - ``'sort'`` — the dedup runs in the step: a stable ``torch.sort``,
    segment ids by a cumsum of boundaries, writeback in place. No
    per-chunk memory beside the chunk. The CUDA default.
  - under the 'packed' cache dtype the plan is stored bit-packed
    (``pack_plan_np``) and unpacked in the step (``unpack_plan``),
    exactly.

* **kill-switch** — ``OTPU_SPARSE_UPDATE=0`` resolves every ``sparse_*``
  rule to its ``dense_*`` twin, once, at fit entry.

Segment sums use ``index_add_``. On the CPU it adds in index order, so a
row's occurrences are summed one after another in their stable-sorted
order (bitwise the dense twin's sums, and the reference's). On CUDA it adds
with atomics in an order that is not fixed, so two runs on the card, or
the card against the CPU, agree to float32 rounding of those sums, not
bitwise; the tests and the chip check state that tolerance.

The step has no host sync, so a replay epoch can be captured as one CUDA
graph: the step counter ``opt_state["step"]`` is a device int32 scalar
that the step advances, and the 'sort' lowering works on all
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

from orange3_spark_tpu_torch.io.codec import bit_width, flat_words, pack_flat_np, unpack_flat

__all__ = [
    "OPTIM_UPDATES", "SPARSE_UPDATES", "DENSE_UPDATES", "ADAGRAD_EPS", "FTRL_BETA",
    "sparse_updates_enabled", "resolve_optim_update", "resolve_sparse_lowering",
    "optim_kind", "is_sparse_update", "init_optim_state", "apply_rule",
    "dense_update", "ADAM_B1", "ADAM_B2", "ADAM_EPS", "init_adam_state",
    "adam_update", "plan_slots", "plan_field_shapes", "build_plan_np",
    "plan_pack_widths", "plan_packed_field_shapes", "pack_plan_np", "unpack_plan",
    "occurrence_dead", "sparse_embedding_update", "finalize_lazy_decay",
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
    if kind == "adagrad":
        return {"acc": torch.zeros_like(param)}
    if kind == "ftrl":
        return {"z": torch.zeros_like(param), "n": torch.zeros_like(param)}
    return {}


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
        sigma = (torch.sqrt(n2) - torch.sqrt(n)) / lr
        z2 = z + g - sigma * p
        shrunk = torch.sign(z2) * torch.clamp_min(torch.abs(z2) - l1, 0.0)
        p2 = -shrunk / ((FTRL_BETA + torch.sqrt(n2)) / lr + 2.0 * reg)
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
    dev = theta["emb"].device
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
        u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
        new_theta[k] = p + lr * -u
    return new_theta, {"count": count, "mu": mu, "nu": nu}


# ------------------------------------------------- plan building (host side)

def plan_slots(pad_rows: int, n_cat: int, n_dims: int) -> int:
    """Bound on a chunk's unique-row count, plus ONE spare slot for the
    dead-occurrence segment (padding rows): live segments number at most
    min(occurrences, table rows)."""
    return min(pad_rows * n_cat, n_dims) + 1


def plan_field_shapes(pad_rows: int, n_cat: int, n_dims: int) -> dict:
    """Shapes of the per-chunk plan arrays (all int32)."""
    M = pad_rows * n_cat
    return {"row": (M,), "seg": (M,), "uniq": (plan_slots(pad_rows, n_cat, n_dims),),
            "inv": (n_dims,)}


def build_plan_np(cats: np.ndarray, salts: np.ndarray, n_dims: int, n_valid: int, *,
                  impute_missing: bool = False, idx: np.ndarray | None = None) -> dict:
    """Host-side touched-row plan of one padded chunk, built once on the
    prefetch thread and replayed every epoch.

    ``cats``: [N, C] raw categorical codes (before the hash; NaN allowed
    with ``impute_missing``). Dead occurrences (rows >= ``n_valid``) sort
    behind an ``n_dims`` sentinel into the spare slot; their gradients are
    zero (w == 0 rows), so nothing masks them in the step.

    Returns {'row': i32[M] source row of each SORTED occurrence, 'seg':
    i32[M] its segment id, 'uniq': i32[U] the touched table row of each
    segment (-1 on dead/pad slots), 'inv': i32[D] table row -> segment id
    (-1 untouched)}. The argsort is STABLE, so a row's occurrences keep
    their original order."""
    from orange3_spark_tpu_torch.ops.hashing import hash_columns_np

    if idx is None:
        cats = np.asarray(cats)
        if impute_missing:
            cats = np.where(np.isnan(cats), 0.0, cats)
        idx = hash_columns_np(cats, salts, n_dims)
    N, C = idx.shape
    M = N * C
    U = plan_slots(N, C, n_dims)
    dead = np.zeros((N, C), np.bool_)
    if n_valid < N:
        dead[n_valid:] = True
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
    return {"row": (order // C).astype(np.int32), "seg": seg, "uniq": uniq, "inv": inv}


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


def occurrence_dead(n_rows: int, n_cat: int, n_valid, device) -> torch.Tensor:
    """[N, C] dead-occurrence mask of the 'sort' lowering — the device twin
    of ``build_plan_np``'s rule: every occurrence of a padding row.
    ``n_valid`` is an int or a device int scalar."""
    rows = torch.arange(n_rows, dtype=torch.int32, device=device)
    return (rows[:, None] >= n_valid).expand(n_rows, n_cat)


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


def _segment_sums(g_sorted: torch.Tensor, seg: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Per-segment sums of SORTED per-occurrence gradients (see the module
    docstring for the order of the adds on each device)."""
    out = torch.zeros((n_slots,) + tuple(g_sorted.shape[1:]), dtype=g_sorted.dtype,
                      device=g_sorted.device)
    return out.index_add_(0, seg, g_sorted)


def sparse_embedding_update(kind, emb, t, slots, dl, idx, lr, decay, reg, l1, step, *,
                            lowering: str, use_decay: bool, plan=None, n_valid=None):
    """One touched-row-only table update. ``dl`` is the [N, k] gradient of
    the loss with respect to the logits; an occurrence's gradient is
    ``dl[row]``. Returns (emb, t, slots).

    'plan': the host-built plan gives the sort order, segments, unique rows
    and inverse map; the writeback is a gather
    (``where(touched, new_rows[inv], emb)``) into new tensors.
    'sort': everything derived in the step over all ``plan_slots`` slots;
    the rows are written back in place (``index_copy_``), a slot past the
    live segments repeating the last live one (module docstring). No step
    of either lowering waits for the device."""
    D = emb.shape[0]
    if lowering == "plan":
        g = dl.index_select(0, plan["row"])
        sums = _segment_sums(g, plan["seg"], plan["uniq"].shape[0])
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
    N, C = idx.shape
    U = plan_slots(N, C, D)
    dead = occurrence_dead(N, C, n_valid, idx.device)
    flat = idx.masked_fill(dead, D).reshape(-1)
    s_idx, order = torch.sort(flat, stable=True)
    g = dl.index_select(0, order // C)
    start = torch.ones_like(s_idx, dtype=torch.bool)
    torch.ne(s_idx[1:], s_idx[:-1], out=start[1:])
    seg = torch.cumsum(start, 0) - 1
    sums = _segment_sums(g, seg, U)
    # the row of each segment: every occurrence of a segment writes the
    # same value, so the scatter is deterministic with duplicates
    uniq = torch.zeros(U, dtype=s_idx.dtype, device=idx.device).scatter_(0, seg, s_idx)
    # slots past the live segments (the dead sentinel's, the empty ones)
    # repeat the last live slot: its row and its new values, written twice
    n_live = (start & (s_idx < D)).sum()
    src = torch.minimum(torch.arange(U, device=idx.device), n_live - 1)
    rid = uniq.index_select(0, src).to(torch.int64)
    p_rows, slot_rows = _touched_rows_update(
        kind, emb, t, slots, sums.index_select(0, src), rid, lr, decay, reg, l1, step,
        use_decay=use_decay)
    emb.index_copy_(0, rid, p_rows)
    for n, v in slot_rows.items():
        slots[n].index_copy_(0, rid, v)
    if use_decay:
        t.index_copy_(0, rid, (step + 1).to(t.dtype).expand(U))
    return emb, t, slots


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
