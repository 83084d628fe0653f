"""Hashed-sparse linear models — the Criteo-scale categorical path.

BASELINE config 2 (the headline metric) is Criteo click-through: 13 dense
numerics and 26 categoricals hashed into millions of dimensions, fit with
logistic regression over a CSV stream.

* Every row has EXACTLY ``n_cat`` categorical slots, so the sparse
  structure is two fixed-shape arrays: raw codes [N, C] (hashed to indices,
  ops/hashing.py) and an embedding table [n_dims, k]. The forward is an
  embedding gather and sum plus a small matmul for the dense block.
* Binary targets use the k = 1 sigmoid form (``binary_logistic``): the
  optimum of the 2-column softmax at half the gather and update bytes.
* A chunk arrives as ONE [N, 1 + n_dense + n_cat] f32 array from fastcsv,
  label column included (``label_in_chunk``). Padding rows are masked by
  ``n_valid``, not by a shipped weight vector.
* Epoch 1 streams: parse, pad, encode and the copy of chunk t+1 run on a
  prefetch thread (io/streaming.py ``prefetch_map``) while the device runs
  step t.
* ``cache_dtype`` (io/codec.py) sets what the cache, the disk spill and
  the copies carry: float32 chunks, or 'bf16' / 'packed' blocks (bf16
  dense columns, a uint8 label, under 'packed' the indices hashed on the
  host and bit-packed) that the step decodes on the device.
* ``cache_device=True`` keeps each chunk on the device and replays the
  cache for the later epochs (Spark's ``persist()`` before an iterative
  fit). A stream that outgrows ``cache_device_bytes`` replays from the
  disk spill (``cache_spill_dir``), or else re-runs the source every
  epoch: a partial replay would reorder chunks.
* ``fused_replay`` (the reference's one XLA scan over the replay epochs):
  on CUDA one replay epoch — one step per cached chunk, reading the cache
  in place — is captured as ONE CUDA graph and replayed once per epoch;
  the state is updated in place at fixed addresses. On the CPU the same
  steps run one by one. ``defer_epoch1`` makes epoch 1 ingest only, and
  every epoch then runs in the replay.

* Recovery (the JAX package's resilience layer): the source goes through
  ``resilient_source`` (transient read errors retried, faults injected
  there); ``check_finite_training`` guards every epoch and the end; the
  periodic dispatch wait runs under the watchdog (``bound_dispatch``); a
  ``StreamCheckpointer`` snapshots per step, or per epoch with
  ``checkpoint_every_epochs``, and a restarted fit resumes from the
  snapshot (its own or the JAX package's) to the same bits as an
  uninterrupted one.

The update rules are optim/sparse.py's ``adam`` and ``{dense,sparse}_
{sgd,adagrad,ftrl}``. Not in this package yet (each raises
``NotImplementedError`` where a parameter asks for it): the 'per_column'
and 'sorted' ``emb_update`` lowerings, value-weighted rows,
``missing='keep'`` and a compute dtype other than float32.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch
from torch.profiler import record_function

from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.exec.pipeline import PipelineStats
from orange3_spark_tpu_torch.io.codec import (
    bf16_bits_np, bf16_to_f32, bit_width, pack_rows_np, resolve_cache_dtype, unpack_rows,
)
from orange3_spark_tpu_torch.models._linear import (
    EPS_TOTAL_WEIGHT, per_row_loss, per_row_loss_grad,
)
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params
from orange3_spark_tpu_torch.ops.hashing import (
    column_salts, hash_columns, hash_columns_np, salts_tensor,
)
from orange3_spark_tpu_torch.optim.sparse import (
    adam_update, build_plan_np, dense_table_grad, dense_update, finalize_lazy_decay,
    init_optim_state, is_sparse_update, optim_kind, pack_plan_np, plan_field_shapes,
    plan_packed_field_shapes, resolve_optim_update, resolve_sparse_lowering,
    sparse_embedding_update, unpack_plan,
)
from orange3_spark_tpu_torch.resilience.numerics import check_finite_training
from orange3_spark_tpu_torch.utils.dispatch import bound_dispatch
from orange3_spark_tpu_torch.utils.graphs import capture_graph
from orange3_spark_tpu_torch.utils.profiling import count_dispatch

AUC_BINS = 4096
#: the profiler ranges of ``_step_core``, in step order ('split_hash' is
#: the decode under a compressed cache; under 'adam' the whole update of
#: the three parameters is 'embedding_update')
STEP_STAGES = ("split_hash", "forward", "loss_grad", "embedding_update", "dense_update")


@dataclasses.dataclass(frozen=True)
class HashedLinearParams(Params):
    """The JAX package's ``HashedLinearParams``, field for field, so a
    model's params round-trip between the two packages (see the module
    docstring for the values this package does not run yet)."""

    n_dims: int = 1 << 20        # hashed feature space (power of two)
    n_dense: int = 13            # leading numeric columns (Criteo I1-I13)
    n_cat: int = 26              # trailing categorical columns (C1-C26)
    loss: str = "logistic"       # 'logistic' | 'squared' | 'squared_hinge' | 'hinge'
    n_classes: int = 2
    epochs: int = 1
    step_size: float = 0.02
    reg_param: float = 0.0       # adam: in-loss L2; the others: decoupled decay
    chunk_rows: int = 1 << 18
    threshold: float = 0.5
    seed: int = 0
    compute_dtype: str = "float32"
    label_in_chunk: bool = False  # chunks carry the label as column 0
    prefetch_depth: int = 2       # host->device pipeline depth (0 disables)
    emb_update: str = "auto"     # 'auto' | 'fused' (| 'per_column' | 'sorted')
    optim_update: str = "adam"   # 'adam' | '{dense,sparse}_{sgd,adagrad,ftrl}'
    sparse_lowering: str = "auto"   # 'auto' | 'plan' | 'sort'
    l1_param: float = 0.0        # FTRL-proximal l1 (ftrl rules only)
    fused_replay: bool = True    # replay epochs as one captured CUDA graph
    # 'all': replay every epoch back to back; 'epoch': groups of
    # epochs_per_dispatch epochs with a device sync between groups
    replay_granularity: str = "all"
    epochs_per_dispatch: int = 1
    # epoch 1 only ingests (parse, pad, encode, cache, spill); all `epochs`
    # passes then run in the replay, the same step sequence
    defer_epoch1: bool = False
    # with a checkpointer: snapshot every K trained epochs instead of every
    # checkpointer.every_steps steps (io/streaming.resolve_epoch_checkpointing)
    checkpoint_every_epochs: int = 0
    value_weighted: bool = False
    # 'zero': NaN dense cells -> 0 and NaN categorical cells -> the reserved
    # code 0, on the device (or in the host hash under 'packed')
    missing: str = "zero"        # 'zero' (| 'keep')
    cache_dtype: str = "f32"     # 'f32' | 'bf16' | 'packed' | 'auto'


def _effective_k(p: HashedLinearParams) -> int:
    """Width of theta's class dimension: binary logistic collapses to k = 1."""
    if p.loss != "logistic":
        return 1
    return 1 if p.n_classes == 2 else p.n_classes


def resolve_emb_update(p: HashedLinearParams) -> str:
    """The gather/scatter lowering of a fit: 'auto' is 'fused'."""
    if p.emb_update == "auto":
        return "fused"
    return p.emb_update


def _impute_flag(p: HashedLinearParams) -> bool:
    if p.missing not in ("zero", "keep"):
        raise ValueError(f"missing must be 'zero' or 'keep', got {p.missing!r}")
    return p.missing == "zero" and not p.value_weighted


def _row_loss_kind(p: HashedLinearParams) -> str:
    if p.loss == "logistic" and p.n_classes == 2:
        return "binary_logistic"
    return p.loss


def _check_ported(p: HashedLinearParams) -> None:
    """Raise on a parameter value whose path this package does not run yet."""
    missing = [
        (resolve_emb_update(p) != "fused", f"emb_update={p.emb_update!r}"),
        (p.value_weighted, "value_weighted=True"),
        (not _impute_flag(p), f"missing={p.missing!r}"),
        (p.compute_dtype != "float32", f"compute_dtype={p.compute_dtype!r}"),
    ]
    names = [name for hit, name in missing if hit]
    if names:
        raise NotImplementedError(
            "not ported to orange3_spark_tpu_torch yet: " + ", ".join(names))
    if p.replay_granularity not in ("all", "epoch"):
        raise ValueError(
            f"replay_granularity must be 'all' or 'epoch', got {p.replay_granularity!r}")


def _dense_term(dense: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """``dense @ coef`` as the elementwise products [N, d, k] summed over
    the d dense columns, the form of the embedding sum beside it: a row's
    reduction runs over its own d products alone, so it rounds the same
    whatever the row count. (A BLAS sgemm need not: MKL's rounds the rows of
    a ragged tail block apart from those of its full blocks, so a served
    request and its padded bucket could differ by an ulp.)"""
    return (dense[:, :, None] * coef).sum(dim=1)


def _hashed_logits(theta: dict, dense: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, k] logits: the 'fused' form, one gather of the [N, C] embedding
    rows summed over the columns, plus the dense block's term."""
    emb = theta["emb"]
    N, C = idx.shape
    rows = emb.index_select(0, idx.reshape(-1)).view(N, C, emb.shape[1])
    logits = rows.sum(dim=1)
    if theta["coef"].shape[0]:
        logits = logits + _dense_term(dense, theta["coef"])
    return logits + theta["intercept"]


def _row_mask(n_rows: int, n_valid, device) -> torch.Tensor:
    """f32 [N]: 1 on the first ``n_valid`` rows (an int, or a device int
    scalar in a captured replay whose chunk buffers are refilled)."""
    return (torch.arange(n_rows, device=device) < n_valid).to(torch.float32)


def _split_chunk(Xall, n_valid, y, w, *, label_in_chunk: bool, n_dense: int,
                 impute_missing: bool = False):
    """Chunk anatomy, on the device. label_in_chunk: column 0 is the label
    and the row mask is ``arange < n_valid`` (no y/w vectors shipped).
    impute_missing: NaN dense cells -> 0, NaN categorical cells -> the
    reserved code 0 (crc32 of the empty string, what fastcsv gives an empty
    categorical cell). Returns (y, dense, cats, w)."""
    if label_in_chunk:
        yv = Xall[:, 0]
        feat = Xall[:, 1:]
        wv = _row_mask(Xall.shape[0], n_valid, Xall.device)
    else:
        yv, feat, wv = y, Xall, w
    dense, cats = feat[:, :n_dense], feat[:, n_dense:]
    if impute_missing:
        dense = torch.where(torch.isnan(dense), 0.0, dense)
        cats = torch.where(torch.isnan(cats), 0.0, cats)
    return yv, dense, cats, wv


# ------------------------------------------------------------ the chunk codec

#: spill order of the touched-row plan's arrays, raw and packed
_PLAN_ORDER = ("row", "seg", "uniq", "inv")
_PLAN_PACKED_ORDER = ("rowp", "segb", "uniqp", "invp")


@dataclasses.dataclass(frozen=True)
class _ChunkCodec:
    """The compressed chunk layout of a fit, resolved once at its entry
    (``resolve_chunk_codec``). ``None`` stands for float32 chunks."""

    mode: str             # 'bf16' | 'packed'
    label_in_chunk: bool
    n_dense: int
    n_cat: int
    n_dims: int
    label_u8: bool        # classification labels stored uint8 (exact)
    impute: bool          # NaN -> 0 in the decode (and the host hash)

    @property
    def idx_bits(self) -> int:
        return bit_width(self.n_dims)

    @property
    def cat_words(self) -> int:
        return -(-(self.n_cat * self.idx_bits) // 32)


def resolve_chunk_codec(p: HashedLinearParams, session: TorchSession | None = None):
    """The cache codec of a fit, or ``None`` for float32 chunks
    (``OTPU_CACHE_DTYPE=f32`` forces that). 'packed' falls back to 'bf16'
    under ``missing='keep'``: a NaN code must reach the device hash, where
    it shows, not vanish in a host hash."""
    mode = resolve_cache_dtype(p.cache_dtype, session)
    if mode == "f32" or p.value_weighted:
        return None
    impute = _impute_flag(p)
    if mode == "packed" and not impute and p.n_cat:
        mode = "bf16"
    kind = _row_loss_kind(p)
    return _ChunkCodec(
        mode=mode, label_in_chunk=p.label_in_chunk, n_dense=p.n_dense, n_cat=p.n_cat,
        n_dims=p.n_dims,
        # class ids are exact in a byte while there are at most 256 classes
        label_u8=(p.label_in_chunk
                  and (kind in ("binary_logistic", "hinge", "squared_hinge")
                       or (kind == "logistic" and p.n_classes <= 256))),
        impute=impute)


def _encode_chunk_np(codec: _ChunkCodec, Xp: np.ndarray, salts_np: np.ndarray,
                     idx: np.ndarray | None = None) -> dict:
    """Host encode of one PADDED chunk, on the prefetch thread: the dict the
    cache, the spill and the copy to the device carry. ``idx``: the [N, C]
    indices when the caller has hashed them already (one host hash a chunk
    serves the plan and the encode). bf16 fields are uint16 bits."""
    off = 1 if codec.label_in_chunk else 0
    enc = {}
    if codec.label_in_chunk:
        lab = Xp[:, 0]
        if codec.label_u8:
            lab8 = lab.astype(np.uint8)
            if not np.array_equal(lab8.astype(np.float32), lab):
                raise ValueError(
                    "cache_dtype compression stores classification labels as u8, but a "
                    "label is not an integer in [0, 255] — soft labels need "
                    "cache_dtype='f32' (or OTPU_CACHE_DTYPE=f32)")
            enc["y"] = lab8
        else:
            enc["y"] = np.ascontiguousarray(lab, np.float32)
    if codec.n_dense:
        enc["dense"] = bf16_bits_np(Xp[:, off:off + codec.n_dense])
    cats = Xp[:, off + codec.n_dense:]
    if codec.mode == "packed":
        if idx is None:
            if codec.impute:
                cats = np.where(np.isnan(cats), np.float32(0.0), cats)
            idx = hash_columns_np(cats, salts_np, codec.n_dims)
        enc["cats"] = pack_rows_np(idx, codec.idx_bits)
    else:
        enc["cats"] = np.ascontiguousarray(cats, np.float32)
    return enc


def _hash_and_encode(codec: _ChunkCodec, Xp: np.ndarray, salts_np: np.ndarray,
                     cats_off: int):
    """A chunk's (or a row block's) one host hash under 'packed', then its
    encode: (the encoded dict, the [N, C] indices or None). The blocks of a
    chunk are row-aligned, so encoding row blocks apart and joining them
    gives the whole chunk's bytes."""
    idx = None
    if codec.mode == "packed":
        c = Xp[:, cats_off:cats_off + codec.n_cat]
        if codec.impute:
            c = np.where(np.isnan(c), np.float32(0.0), c)
        idx = hash_columns_np(c, salts_np, codec.n_dims)
    return _encode_chunk_np(codec, Xp, salts_np, idx=idx), idx


def _decode_chunk(codec: _ChunkCodec, enc: dict, n_valid, y, w, salts):
    """Device decode: the encoded blocks -> (yv, dense f32, idx i32, wv).
    Under 'packed' the indices were hashed on the host (bitwise the device
    hash), so the step only unpacks them; under 'bf16' it hashes the codes
    as the float32 step does."""
    N = enc["cats"].shape[0]
    dev = enc["cats"].device
    if codec.label_in_chunk:
        yv = enc["y"].to(torch.float32)
        wv = _row_mask(N, n_valid, dev)
    else:
        yv, wv = y, w
    if codec.n_dense:
        dense = bf16_to_f32(enc["dense"])
        if codec.impute:
            dense = torch.where(torch.isnan(dense), 0.0, dense)
    else:
        dense = torch.zeros((N, 0), dtype=torch.float32, device=dev)
    if codec.mode == "packed":
        idx = unpack_rows(enc["cats"], codec.idx_bits, codec.n_cat)
    else:
        cats = enc["cats"]
        if codec.impute:
            cats = torch.where(torch.isnan(cats), 0.0, cats)
        idx = hash_columns(cats, salts, codec.n_dims)
    return yv, dense, idx, wv


def _chunk_field_specs(p: HashedLinearParams, codec, pad_rows: int) -> tuple:
    """Ordered (name, shape, numpy dtype) of one spill record's chunk
    fields; the plan's fields (``_plan_store_specs``) follow them. A bf16
    field is its uint16 bits."""
    if codec is None:
        fields = [("x", (pad_rows, _chunk_cols(p)), np.dtype(np.float32))]
        if not p.label_in_chunk:
            fields += [("yv", (pad_rows,), np.dtype(np.float32)),
                       ("wv", (pad_rows,), np.dtype(np.float32))]
        return tuple(fields)
    fields = []
    if codec.label_in_chunk:
        fields.append(("y", (pad_rows,),
                       np.dtype(np.uint8 if codec.label_u8 else np.float32)))
    if codec.n_dense:
        fields.append(("dense", (pad_rows, codec.n_dense), np.dtype(np.uint16)))
    if codec.mode == "packed":
        fields.append(("cats", (pad_rows, codec.cat_words), np.dtype(np.uint32)))
    else:
        fields.append(("cats", (pad_rows, codec.n_cat), np.dtype(np.float32)))
    if not codec.label_in_chunk:
        fields += [("yv", (pad_rows,), np.dtype(np.float32)),
                   ("wv", (pad_rows,), np.dtype(np.float32))]
    return tuple(fields)


def _plan_store_specs(p: HashedLinearParams, codec, pad_rows: int) -> tuple:
    """Ordered (name, shape, dtype) of the plan's spill fields: packed u32
    words under the 'packed' codec, int32 arrays else."""
    if codec is not None and codec.mode == "packed":
        d = plan_packed_field_shapes(pad_rows, p.n_cat, p.n_dims)
        return tuple((k, d[k][0], np.dtype(d[k][1])) for k in _PLAN_PACKED_ORDER)
    shapes = plan_field_shapes(pad_rows, p.n_cat, p.n_dims)
    return tuple((k, shapes[k], np.dtype(np.int32)) for k in _PLAN_ORDER)


def _plan_device_form(codec, plan_np: dict, pad_rows: int, p: HashedLinearParams) -> dict:
    """The plan as it travels with its chunk: bit-packed under 'packed'."""
    if codec is not None and codec.mode == "packed":
        return pack_plan_np(plan_np, pad_rows, p.n_cat, p.n_dims)
    return plan_np


def _raw_chunk_bytes(p: HashedLinearParams, pad_rows: int, sparse_plan: bool) -> int:
    """Bytes of one cached chunk (and its plan) in the float32 layout: the
    denominator of ``compression_ratio``."""
    n = pad_rows * _chunk_cols(p) * 4
    if not p.label_in_chunk:
        n += 2 * pad_rows * 4
    if sparse_plan:
        n += 4 * sum(int(np.prod(s)) for s in
                     plan_field_shapes(pad_rows, p.n_cat, p.n_dims).values())
    return n


def estimate_cached_chunk_bytes(p: HashedLinearParams, session: TorchSession) -> int:
    """Device cache bytes of one chunk under the resolved codec and
    lowering: what ``fit_stream``'s cache accounting will count."""
    pad_rows = session.pad_rows(p.chunk_rows)
    codec = resolve_chunk_codec(p, session)
    sparse_plan = (is_sparse_update(resolve_optim_update(p.optim_update))
                   and resolve_sparse_lowering(p.sparse_lowering, session.device) == "plan")
    specs = _chunk_field_specs(p, codec, pad_rows)
    if sparse_plan:
        specs = specs + _plan_store_specs(p, codec, pad_rows)
    return sum(int(np.prod(s)) * dt.itemsize for _, s, dt in specs)


def warm_eval_chunk(p: HashedLinearParams, session: TorchSession) -> tuple:
    """A zero device chunk in the fit's cache layout, to warm the eval path
    before a timed run."""
    pad_rows = session.pad_rows(p.chunk_rows)
    codec = resolve_chunk_codec(p, session)
    h2d = _HostToDevice(session.device)
    Xp0 = np.zeros((pad_rows, _chunk_cols(p)), np.float32)
    if codec is None:
        Xd = h2d.put(Xp0)
    else:
        Xd = h2d.put(_encode_chunk_np(codec, Xp0, column_salts(p.n_cat, p.seed)))
    zy = zw = None
    if not p.label_in_chunk:
        zy = h2d.put(np.zeros((pad_rows,), np.float32))
        zw = zy
    return h2d.ready((Xd, 1, zy, zw), h2d.done())


# ------------------------------------------------------------------ the step

def _step_core(theta: dict, opt_state: dict, Xall, n_valid, y, w, salts, reg: float,
               lr: float, plan=None, l1: float = 0.0, *, loss_kind: str, n_dims: int,
               n_dense: int, label_in_chunk: bool = False, impute_missing: bool = False,
               optim_update: str, sparse_lowering: str = "none",
               use_decay: bool = False, codec: _ChunkCodec | None = None):
    """One optimizer step on one chunk. Returns (theta, opt_state, loss).

    'adam' is the reference's dense optax path: the loss includes the L2
    term ``0.5·reg·(Σemb² + Σcoef²)``, the table's gradient is dense (every
    occurrence added into a full-table gradient in occurrence order,
    ``dense_table_grad``, plus ``reg·θ``) and adam sweeps every parameter. The
    other rules report the pure data loss and treat ``reg`` as decoupled
    weight decay; the sparse ones update only the touched rows, with
    ``plan`` carrying the host-built dedup under the 'plan' lowering; the
    dense twins sweep the whole table.

    ``codec``: None for float32 chunks; else ``Xall`` is the encoded block
    dict, decoded here (and a packed plan unpacked), so the cache holds the
    compressed bytes. Nothing here waits for the device, so the step can be
    captured. Its stages run in profiler ranges named by ``STEP_STAGES``."""
    kind = optim_kind(optim_update)
    with record_function("split_hash"):
        if codec is None:
            yv, dense, cats, wv = _split_chunk(
                Xall, n_valid, y, w, label_in_chunk=label_in_chunk, n_dense=n_dense,
                impute_missing=impute_missing)
            idx = hash_columns(cats, salts, n_dims)
        else:
            yv, dense, idx, wv = _decode_chunk(codec, Xall, n_valid, y, w, salts)
            if plan is not None and codec.mode == "packed":
                plan = unpack_plan(plan, idx.shape[0], codec.n_cat, n_dims)
    with record_function("forward"):
        logits = _hashed_logits(theta, dense, idx)
    with record_function("loss_grad"):
        sw = torch.clamp_min(wv.sum(), EPS_TOTAL_WEIGHT)
        loss = (per_row_loss(loss_kind, logits, yv) * wv).sum() / sw
        dl = per_row_loss_grad(loss_kind, logits, yv) * (wv / sw)[:, None]   # [N, k]
        g_coef = dense.T @ dl
        g_int = dl.sum(dim=0)
        if kind == "adam":
            loss = loss + 0.5 * reg * ((theta["emb"] ** 2).sum()
                                       + (theta["coef"] ** 2).sum())
            g_coef = g_coef + reg * theta["coef"]
    with record_function("embedding_update"):
        if is_sparse_update(optim_update):
            decay = float(np.float32(1.0) - np.float32(lr) * np.float32(reg))
            emb, t, eslots = sparse_embedding_update(
                kind, theta["emb"], opt_state["t"], opt_state["slots"]["emb"], dl, idx,
                lr, decay, reg, l1, opt_state["step"], lowering=sparse_lowering,
                use_decay=use_decay, plan=plan, n_valid=n_valid)
        else:
            g_emb = dense_table_grad(idx, dl, theta["emb"].shape[0])
            if kind == "adam":
                return (*adam_update(
                    theta, {"emb": g_emb + reg * theta["emb"], "coef": g_coef,
                            "intercept": g_int}, opt_state, lr), loss)
            decay = float(np.float32(1.0) - np.float32(lr) * np.float32(reg))
            t = opt_state["t"]
            emb, eslots = dense_update(kind, theta["emb"], opt_state["slots"]["emb"],
                                       g_emb, lr, decay, reg, l1, use_decay=use_decay)
    with record_function("dense_update"):
        slots = opt_state["slots"]
        coef, cslots = dense_update(kind, theta["coef"], slots["coef"], g_coef, lr,
                                    decay, reg, l1, use_decay=use_decay)
        intercept, islots = dense_update(kind, theta["intercept"], slots["intercept"],
                                         g_int, lr, decay, reg, l1, use_decay=False)
    theta = {"emb": emb, "coef": coef, "intercept": intercept}
    opt_state = {"step": opt_state["step"] + 1, "t": t,
                 "slots": {"emb": eslots, "coef": cslots, "intercept": islots}}
    return theta, opt_state, loss


def _write_back(dst: dict, src: dict) -> None:
    """Copy a step's results into the state's own tensors, so the state
    keeps its addresses (a captured graph reads and writes them there)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write_back(dst[k], v)
        elif v is not dst[k]:
            dst[k].copy_(v)


def _step_into(theta: dict, opt_state: dict, chunk: tuple, salts, hyper: tuple,
               static_kw: dict) -> torch.Tensor:
    """One step on a device chunk ``(X, n_valid, y, w[, plan])``, updating
    ``theta`` and ``opt_state`` in place. Returns the loss (a device scalar)."""
    reg, lr, l1 = hyper
    Xd, n_valid, yd, wd = chunk[:4]
    plan = chunk[4] if len(chunk) > 4 else None
    new_theta, new_opt, loss = _step_core(theta, opt_state, Xd, n_valid, yd, wd, salts,
                                          reg, lr, plan, l1, **static_kw)
    _write_back(theta, new_theta)
    _write_back(opt_state, new_opt)
    return loss


def _load_into(dst: dict, src: dict) -> None:
    """Copy a snapshot's numpy leaves into the fit's own tensors, in place:
    a captured graph reads and writes the state at fixed addresses, so the
    state is never rebound. Raises on a missing leaf or a shape that
    differs."""
    for k, d in dst.items():
        if isinstance(d, dict):
            _load_into(d, src[k])
            continue
        v = torch.from_numpy(np.array(src[k]))     # a copy; 0-d stays 0-d
        if tuple(v.shape) != tuple(d.shape):
            raise ValueError(f"checkpoint leaf {k!r} has shape {tuple(v.shape)}, "
                             f"the fit's has {tuple(d.shape)}")
        d.copy_(v)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class _Replay:
    """Replay epochs: one step per chunk, in order, on a state updated in
    place. ``capture()`` (CUDA) records one epoch as a CUDA graph — every
    step's kernels, reading the chunks where they lie (the cache itself, no
    stacked copy), the losses into the fixed ``losses`` buffer — and
    ``run(n)`` replays it ``n`` times. Uncaptured (the CPU), ``run`` runs
    the same steps one by one. A failed capture raises; nothing falls
    back to the eager steps."""

    def __init__(self, theta: dict, opt_state: dict, chunks: list, step: Callable):
        self.theta, self.opt_state, self.chunks, self.step = theta, opt_state, chunks, step
        self.losses = torch.zeros(len(chunks), dtype=torch.float32,
                                  device=theta["emb"].device)
        self.graph = None

    def _epoch(self) -> None:
        for i, c in enumerate(self.chunks):
            self.losses[i].copy_(self.step(self.theta, self.opt_state, c))

    def capture(self) -> None:
        """Warm one step on a copy of the state on a side stream (library
        handles and workspaces), then capture one epoch. Thread-local
        capture mode lets the prefetch thread keep copying meanwhile."""
        theta, opt_state = self.theta, self.opt_state
        self.graph, _, _ = capture_graph(
            self._epoch, theta["emb"].device,
            warm=lambda: self.step(_clone_tree(theta), _clone_tree(opt_state), self.chunks[0]))

    def run(self, n_epochs: int) -> None:
        for _ in range(n_epochs):
            if self.graph is None:
                self._epoch()
            else:
                self.graph.replay()


# ------------------------------------------------------------- predict, eval

def _hashed_predict(theta, Xall, salts, *, n_dims: int, n_dense: int,
                    impute_missing: bool = False) -> torch.Tensor:
    _, dense, cats, _ = _split_chunk(Xall, 0, None, None, label_in_chunk=False,
                                     n_dense=n_dense, impute_missing=impute_missing)
    return _hashed_logits(theta, dense, hash_columns(cats, salts, n_dims))


def _hashed_eval_chunk(theta, Xall, n_valid, y, w, salts, *, loss_kind: str,
                       n_dims: int, n_dense: int, label_in_chunk: bool,
                       impute_missing: bool = False, codec: _ChunkCodec | None = None):
    """Device-side eval accumulators of one chunk: (weighted logloss sum,
    weighted correct sum, weight sum, pos/neg score histograms for AUC).
    Only these small tensors ever go back to the host. ``codec``: the fit's
    codec for encoded cached chunks."""
    if codec is None:
        yv, dense, cats, wv = _split_chunk(
            Xall, n_valid, y, w, label_in_chunk=label_in_chunk, n_dense=n_dense,
            impute_missing=impute_missing)
        idx = hash_columns(cats, salts, n_dims)
    else:
        yv, dense, idx, wv = _decode_chunk(codec, Xall, n_valid, y, w, salts)
    logits = _hashed_logits(theta, dense, idx)
    loss_sum = (per_row_loss(loss_kind, logits, yv) * wv).sum()
    if loss_kind == "binary_logistic":
        score = torch.sigmoid(logits[:, 0])
        pred = (score > 0.5).to(torch.float32)
    elif loss_kind == "logistic":
        score = torch.softmax(logits, dim=-1)[:, -1]
        pred = torch.argmax(logits, dim=-1).to(torch.float32)
    else:
        score = logits[:, 0]
        pred = (logits[:, 0] > 0).to(torch.float32)
    correct = ((pred == yv).to(torch.float32) * wv).sum()
    b = torch.clamp((score * AUC_BINS).to(torch.int32), 0, AUC_BINS - 1)
    zeros = torch.zeros(AUC_BINS, dtype=torch.float32, device=logits.device)
    pos = zeros.index_add(0, b, wv * (yv > 0.5))
    neg = zeros.index_add(0, b, wv * (yv <= 0.5))
    return loss_sum, correct, wv.sum(), pos, neg


def _auc_from_hists(pos_h: np.ndarray, neg_h: np.ndarray) -> float | None:
    npos, nneg = pos_h.sum(), neg_h.sum()
    if not (npos and nneg):
        return None
    cum_neg = np.concatenate([[0.0], np.cumsum(neg_h)[:-1]])
    return float((pos_h * (cum_neg + 0.5 * neg_h)).sum() / (npos * nneg))


class HashedLinearModel(Model):
    """Fitted hashed-sparse linear model; predicts on raw (dense +
    categorical) chunks — the hashing travels with the model via its salts."""

    def __init__(self, params: HashedLinearParams, theta: dict, salts, class_values):
        self.params = params
        self.theta = theta            # {'emb': [D, k], 'coef': [dd, k], 'intercept': [k]}
        self.salts = np.asarray(salts, np.uint32)
        self.class_values = tuple(class_values) if class_values else None
        self.n_steps_: int | None = None
        self.final_loss_: float | None = None
        self.device_chunks_ = None
        self.holdout_chunks_ = None
        # the cache codec of the producing fit (None: float32 chunks), the
        # decode ``evaluate_device`` applies to its chunks by default
        self.cache_codec_ = None

    @property
    def state_pytree(self) -> dict:
        return dict(self.theta)

    @property
    def device(self) -> torch.device:
        return self.theta["emb"].device

    @property
    def _binary(self) -> bool:
        return _row_loss_kind(self.params) == "binary_logistic"

    def load_state_pytree(self, state: dict) -> None:
        """Replace theta with ``state`` (emb, coef, intercept): tensors, or
        numpy arrays as the JAX package's checkpoints carry them, each put
        on the model's device as a tensor (a served graph then reads theta
        itself, so a later in-place update reaches it). Moves the serving
        fingerprint."""
        device = self.device
        self.theta = {k: torch.as_tensor(v, device=device) for k, v in state.items()}
        self._touch_serving_state()

    def _serve_array_state(self):
        """Serving hook (serve/context.py ``served_array``): the state the
        bucket program reads where it lies — theta itself, so an in-place
        update of theta is served by the next request, as the JAX
        package's state-as-arguments executables serve it."""
        return {"theta": self.theta, "salts": salts_tensor(self.salts, self.device)}

    def _serve_array_fn(self, state, Xp):
        """Device fn of the bucket program: row-wise (hash + gather + sum +
        dense product), so bucket padding changes no live row's inputs (a
        CPU BLAS may still round a row's dense product an ulp apart at
        another row count; the card's cuBLAS did not)."""
        p = self.params
        return _hashed_predict(state["theta"], Xp, state["salts"], n_dims=p.n_dims,
                               n_dense=p.n_dense, impute_missing=_impute_flag(p))

    def _logits(self, Xall: np.ndarray) -> np.ndarray:
        from orange3_spark_tpu_torch.serve.context import (
            _reentrant, active_serving_context,
        )

        ctx = active_serving_context()
        if ctx is not None and not _reentrant():
            out = ctx.served_array(self, np.asarray(Xall, np.float32))
            if out is not None:
                return out
        p = self.params
        X = torch.as_tensor(np.asarray(Xall, np.float32), device=self.device)
        out = _hashed_predict(self.theta, X, salts_tensor(self.salts, self.device),
                              n_dims=p.n_dims, n_dense=p.n_dense,
                              impute_missing=_impute_flag(p))
        return out.cpu().numpy()

    def predict(self, Xall: np.ndarray) -> np.ndarray:
        p = self.params
        logits = self._logits(Xall)
        if p.loss == "logistic":
            if self._binary:
                prob = 1.0 / (1.0 + np.exp(-logits[:, 0]))
                return (prob > p.threshold).astype(np.float32)
            if logits.shape[1] == 2:
                prob = 1.0 / (1.0 + np.exp(logits[:, 0] - logits[:, 1]))
                return (prob > p.threshold).astype(np.float32)
            return np.argmax(logits, axis=-1).astype(np.float32)
        if p.loss == "squared":
            return logits[:, 0]
        return (logits[:, 0] > 0).astype(np.float32)  # hinge margins

    def predict_proba(self, Xall: np.ndarray) -> np.ndarray:
        z = self._logits(Xall)
        if self._binary:
            p1 = 1.0 / (1.0 + np.exp(-z[:, 0]))
            return np.stack([1.0 - p1, p1], axis=1)
        z = z - z.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)

    def evaluate_stream(self, source: Callable[[], Iterator]) -> dict:
        """Stream logloss + accuracy (+AUC when binary) on the host, without
        collecting the dataset. At scale use ``evaluate_device``."""
        n = 0
        loss_sum = 0.0
        correct = 0
        pos_h = np.zeros(AUC_BINS)
        neg_h = np.zeros(AUC_BINS)
        for chunk in source():
            Xall, y = chunk[0], chunk[1]
            if y is None:
                raise ValueError("evaluate_stream needs labeled chunks")
            prob = self.predict_proba(Xall)
            yi = np.asarray(y).astype(int)
            pi = np.clip(prob[np.arange(len(yi)), yi], 1e-12, 1.0)
            loss_sum += float(-np.log(pi).sum())
            correct += int((prob.argmax(1) == yi).sum())
            n += len(yi)
            if prob.shape[1] == 2:
                b = np.minimum((prob[:, 1] * AUC_BINS).astype(int), AUC_BINS - 1)
                pos_h += np.bincount(b[yi == 1], minlength=AUC_BINS)
                neg_h += np.bincount(b[yi == 0], minlength=AUC_BINS)
        out = {"logloss": loss_sum / max(n, 1), "accuracy": correct / max(n, 1)}
        auc = _auc_from_hists(pos_h, neg_h)
        if auc is not None:
            out["auc"] = auc
        return out

    def eval_accumulators(self, device_chunks, *, codec="auto") -> tuple:
        """Sums of ``_hashed_eval_chunk`` over device chunks (as a cached fit
        keeps them: (X, n_valid, y, w[, plan]) tuples), on the device.
        ``codec='auto'`` decodes with the producing fit's ``cache_codec_``;
        pass ``None`` for float32 chunks made by hand."""
        p = self.params
        if codec == "auto":
            codec = self.cache_codec_
        salts = salts_tensor(self.salts, self.device)
        tot = None
        for chunk in device_chunks:
            Xd, n_valid, yd, wd = chunk[:4]
            out = _hashed_eval_chunk(
                self.theta, Xd, n_valid, yd, wd, salts, loss_kind=_row_loss_kind(p),
                n_dims=p.n_dims, n_dense=p.n_dense, label_in_chunk=p.label_in_chunk,
                impute_missing=_impute_flag(p), codec=codec)
            tot = out if tot is None else tuple(a + b for a, b in zip(tot, out))
        if tot is None:
            raise ValueError("no chunks to evaluate")
        return tot

    def evaluate_device(self, device_chunks, *, codec="auto") -> dict:
        """Evaluate over device-resident chunks (``fit_stream(...,
        cache_device=True)``'s ``device_chunks_`` or ``holdout_chunks_``,
        encoded under the fit's cache codec). All reduction happens on the
        device; five small tensors come back at the end."""
        loss_sum, correct, wsum, pos, neg = (
            a.cpu().numpy() for a in self.eval_accumulators(device_chunks, codec=codec))
        out = {"logloss": float(loss_sum / max(wsum, 1e-12)),
               "accuracy": float(correct / max(wsum, 1e-12))}
        # AUC only for probability scores: margins are unbounded, and their
        # [0, 1]-binned histogram would pile up in the edge bins
        if _row_loss_kind(self.params) in ("binary_logistic", "logistic"):
            auc = _auc_from_hists(pos, neg)
            if auc is not None:
                out["auc"] = auc
        return out


def _chunk_cols(p: HashedLinearParams) -> int:
    """Expected chunk width: [label?] + dense + categorical columns."""
    return p.n_cat + p.n_dense + (1 if p.label_in_chunk else 0)


def _init_fit_state(p: HashedLinearParams, session: TorchSession):
    """Fresh (theta, opt_state, salts_np, salts, static_kw) exactly as a fit
    starts: a zero theta, the rule's zero state, the numpy salts and the
    resolved statics (rule, lowering, codec), so two fits (or this package
    and the JAX package) compare step for step."""
    _check_ported(p)
    optim = resolve_optim_update(p.optim_update)
    k = _effective_k(p)
    dev = session.device
    theta = {
        "emb": torch.zeros((p.n_dims, k), dtype=torch.float32, device=dev),
        "coef": torch.zeros((p.n_dense, k), dtype=torch.float32, device=dev),
        "intercept": torch.zeros((k,), dtype=torch.float32, device=dev),
    }
    opt_state = init_optim_state(optim, theta)
    salts_np = column_salts(p.n_cat, p.seed)
    static_kw = dict(
        loss_kind=_row_loss_kind(p), n_dims=p.n_dims, n_dense=p.n_dense,
        label_in_chunk=p.label_in_chunk, impute_missing=_impute_flag(p),
        optim_update=optim,
        sparse_lowering=(resolve_sparse_lowering(p.sparse_lowering, dev)
                         if is_sparse_update(optim) else "none"),
        # reg == 0 runs the sparse step without the timestamp gathers and
        # the pow (and ftrl owns its L2 in closed form)
        use_decay=(p.reg_param != 0.0 and optim_kind(optim) not in ("ftrl", "adam")),
        codec=resolve_chunk_codec(p, session),
    )
    return theta, opt_state, salts_np, salts_tensor(salts_np, dev), static_kw


def _torch_view(a: np.ndarray) -> np.ndarray:
    """uint32 / uint16 host arrays as int32 / int16, their bits unchanged:
    the device decodes them as bits, and PyTorch's unsigned types have
    few ops."""
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype == np.uint16:
        return a.view(np.int16)
    return a


class _HostToDevice:
    """Copies of host arrays to the device, made on the prefetch thread.
    On CUDA each array goes through a pinned staging buffer and is copied
    with ``non_blocking`` on a copy stream; ``done()`` records an event
    after the copies and ``ready(chunk, event)`` makes the compute stream
    wait for it. Each array gets its own staging buffer from PyTorch's
    pinned-memory cache, which does not hand a buffer out again before the
    copy that reads it has finished. On the CPU a chunk's tensors share the
    host arrays' memory (nothing writes to them); a read-only array (a
    spill record's memmap view) is copied."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(self, a):
        """One array, or a dict of them (an encoded chunk, a plan)."""
        if isinstance(a, dict):
            return {k: self.put(v) for k, v in a.items()}
        a = _torch_view(np.ascontiguousarray(a))
        if not a.flags.writeable:
            a = a.copy()
        host = torch.from_numpy(a)
        if self.stream is None:
            return host
        staged = host.pin_memory()
        with torch.cuda.stream(self.stream):
            return staged.to(self.device, non_blocking=True)

    def done(self):
        """An event after every copy enqueued so far (None on the CPU)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    @staticmethod
    def ready(chunk, event):
        """Make the current stream wait for ``chunk``'s copies (a chunk, or
        a list of them), and tell the allocator their memory is in use
        there."""
        if event is None:
            return chunk
        stream = torch.cuda.current_stream()
        stream.wait_event(event)

        def mark(x):
            if isinstance(x, torch.Tensor):
                x.record_stream(stream)
            elif isinstance(x, (dict, tuple, list)):
                for v in (x.values() if isinstance(x, dict) else x):
                    mark(v)

        mark(chunk)
        return chunk


def _chunk_slot(chunk: tuple) -> tuple:
    """Device buffers shaped like ``chunk``, with ``n_valid`` as a device
    int32 scalar: a slot of the captured disk-group replay, refilled by
    ``_fill_slot`` for every group."""
    def like(x):
        if isinstance(x, dict):
            return {k: like(v) for k, v in x.items()}
        return None if x is None else torch.empty_like(x)

    Xd, n, yd, wd = chunk[:4]
    dev = (Xd["cats"] if isinstance(Xd, dict) else Xd).device
    slot = (like(Xd), torch.zeros((), dtype=torch.int32, device=dev), like(yd), like(wd))
    return slot + tuple(like(x) for x in chunk[4:])


def _fill_slot(slot: tuple, chunk: tuple) -> None:
    def fill(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k])
        elif dst is not None:
            dst.copy_(src)

    slot[1].fill_(chunk[1])
    for i in (0, 2, 3) + tuple(range(4, len(chunk))):
        fill(slot[i], chunk[i])


class StreamingHashedLinearEstimator(Estimator):
    """Out-of-core hashed-sparse fit over chunk streams.

    ``fit_stream(source)`` consumes chunks of ``(Xall [n, n_dense+n_cat],
    y)`` or, with ``label_in_chunk=True``, raw ``[n, 1+n_dense+n_cat]``
    arrays from ``csv_raw_chunk_source``. The Criteo pipeline is
    ``csv_raw_chunk_source(path) -> fit_stream -> model.evaluate_device``,
    on the session's device (CUDA unless the caller passes the CPU).
    """

    ParamsCls = HashedLinearParams
    params: HashedLinearParams

    def _fit(self, table):
        """Estimator protocol: an in-memory table streamed in chunks."""
        from orange3_spark_tpu_torch.io.streaming import array_chunk_source
        from orange3_spark_tpu_torch.models.base import infer_class_values

        X, Y, W = table.to_numpy()
        y = Y[:, 0] if Y is not None else None
        class_values = (infer_class_values(table) if self.params.loss == "logistic"
                        else None)
        return self.fit_stream(
            array_chunk_source(X, y, W, chunk_rows=self.params.chunk_rows),
            session=table.session, class_values=class_values)

    def warm_replay(self, n_chunks: int, *, session: TorchSession | None = None):
        """Pay a replay's one-time costs before a timed ``fit_stream``:
        library handles, the sort's workspace, a first graph capture and
        replay (its memory pool), on a zero chunk of the fit's layout
        (encoded as the fit encodes) referenced ``n_chunks`` times, the
        train chunks the fit will cache. Without ``defer_epoch1`` one eager
        step runs first, as epoch 1 would. Returns ``(theta, salts_np)``
        after one warm replay epoch, or None where the fit has no fused
        replay (``fused_replay`` off, one epoch without defer, no chunks)."""
        p = self.params
        session = session or TorchSession.active()
        if not (p.fused_replay and (p.epochs > 1 or p.defer_epoch1) and n_chunks > 0):
            return None
        pad_rows = session.pad_rows(p.chunk_rows)
        theta, opt, salts_np, salts, kw = _init_fit_state(p, session)
        codec = kw["codec"]
        h2d = _HostToDevice(session.device)
        Xp0 = np.zeros((pad_rows, _chunk_cols(p)), np.float32)
        z = h2d.put(Xp0 if codec is None else _encode_chunk_np(codec, Xp0, salts_np))
        zy = zw = None
        if not p.label_in_chunk:
            zy = h2d.put(np.zeros((pad_rows,), np.float32))
            zw = h2d.put(np.ones((pad_rows,), np.float32))
        chunk = (z, pad_rows, zy, zw)
        if kw["sparse_lowering"] == "plan":
            plan_np = build_plan_np(np.zeros((pad_rows, p.n_cat), np.float32), salts_np,
                                    p.n_dims, pad_rows, impute_missing=kw["impute_missing"])
            chunk = chunk + (h2d.put(_plan_device_form(codec, plan_np, pad_rows, p)),)
        chunk = h2d.ready(chunk, h2d.done())
        hyper = tuple(float(np.float32(v)) for v in (p.reg_param, p.step_size, p.l1_param))

        def step(th, op, c):
            return _step_into(th, op, c, salts, hyper, kw)

        if not p.defer_epoch1:
            step(theta, opt, chunk)
        replay = _Replay(theta, opt, [chunk] * n_chunks, step)
        if session.device.type == "cuda":
            replay.capture()
        replay.run(1)
        session.synchronize()
        return theta, salts_np

    def fit_stream(self, source: Callable[[], Iterator], *,
                   session: TorchSession | None = None,
                   class_values: tuple | None = None, cache_device: bool = False,
                   cache_device_bytes: int = 8 << 30, cache_spill_dir: str | None = None,
                   holdout_chunks: int = 0,
                   stage_times: dict | None = None,
                   checkpointer=None) -> HashedLinearModel:
        """Fit over a re-iterable chunk source.

        cache_device: keep the device chunks of epoch 1 (encoded per
          ``cache_dtype``) and replay them for the later epochs. With
          ``fused_replay`` (the default) and a full cache, the replay is
          one captured CUDA graph per epoch on CUDA. Its gate is only that
          the cache fits ``cache_device_bytes``: the graph reads the cache
          in place, with no second stacked copy (the reference also needs
          half the budget free for its stack). If the stream outgrows the
          budget the fit replays from the disk spill when
          ``cache_spill_dir`` is set, and else re-runs the source every
          epoch (a warning says so). The cached list is
          ``model.device_chunks_``.
        cache_spill_dir: where epoch 1 writes the spill (io/streaming.py
          ``DiskChunkCache``: the encoded records, CRC-checked, released
          when the fit returns). It is written whether or not the cache
          overflows (that is known only at the end of the stream). A
          spill replay with ``fused_replay`` trains groups of records as
          one captured graph over fixed device buffers, refilled per
          group; a partial last group runs step by step.
        holdout_chunks: keep the LAST n device chunks of each epoch out of
          training; with cache_device they are kept on the device as
          ``model.holdout_chunks_`` for ``evaluate_device``.
        stage_times: receives host stage seconds ('parse_s', 'h2d_s',
          'plan_s', 'encode_s' (the host hash of the packed codec and the
          encode), 'spill_s', accumulated on the prefetch thread, so they
          overlap device work) and 'epoch_s', one wall per epoch, each
          ended by a device synchronize; with the fused replay 'epoch_s'
          is [epoch 1, the whole replay] and 'replay_fused_s' (the replay
          phase, capture included) and 'graph_capture_s' say so; plus the
          resolved rule, lowering, codec, 'replay_source' and the cache's
          bytes ('cache_bytes', and 'cache_raw_bytes' at float32), and the
          transient source reads retried ('retries').
        checkpointer: a ``utils/fault.StreamCheckpointer``. The fit resumes
          from its snapshot if there is one (written by this package or by
          the JAX package for the same params), snapshots every
          ``every_steps`` steps, or every ``checkpoint_every_epochs``
          trained epochs, and deletes the snapshot when it returns. With
          ``defer_epoch1`` or a fused replay it composes only under
          ``replay_granularity='epoch'`` (snapshots at epoch boundaries,
          between graph replays); else the fit runs its steps one by one.
        """
        from orange3_spark_tpu_torch.io.streaming import (
            DiskChunkCache, _DeviceCache, _pad_chunk, _rechunk, epoch_boundary_snapshot,
            prefetch_map, resolve_epoch_checkpointing, run_epoch_replay,
            warn_cache_overflow,
        )
        from orange3_spark_tpu_torch.resilience.retry import resilient_source

        p = self.params
        session = session or TorchSession.active()
        theta, opt_state, salts_np, salts, static_kw = _init_fit_state(p, session)
        resume_from = 0
        ckpt_meta = {"params": p.to_dict(), "k": _effective_k(p)}
        ckpt_epochs = resolve_epoch_checkpointing(p, checkpointer)
        if checkpointer is not None:
            step0, saved = checkpointer.load(expect_meta=ckpt_meta)
            if saved is not None:
                from orange3_spark_tpu_torch.interop import hashed_fit_state

                saved = hashed_fit_state(saved)
                _load_into(theta, saved["theta"])
                _load_into(opt_state, saved["opt_state"])
                resume_from = step0

        def snapshot():
            # the host copies in StreamCheckpointer.save run on this
            # stream, after every step the device has been given
            return {"theta": theta, "opt_state": opt_state}

        pad_rows = session.pad_rows(p.chunk_rows)
        n_cols = _chunk_cols(p)
        hyper = tuple(float(np.float32(v)) for v in (p.reg_param, p.step_size, p.l1_param))
        optim_resolved = static_kw["optim_update"]
        sparse_plan = static_kw["sparse_lowering"] == "plan"
        codec = static_kw["codec"]
        chunk_specs = _chunk_field_specs(p, codec, pad_rows)
        plan_specs = _plan_store_specs(p, codec, pad_rows) if sparse_plan else ()
        cats_off = (1 if p.label_in_chunk else 0) + p.n_dense
        times = ({"parse_s": 0.0, "h2d_s": 0.0, "encode_s": 0.0}
                 if stage_times is not None else None)
        pipe_stats = PipelineStats()
        # the source chokepoint: fault injection and bounded retries of
        # transient reads, on the prefetch thread; retries count into
        # pipe_stats
        source = resilient_source(source, stats=pipe_stats)
        h2d = _HostToDevice(session.device)
        is_cuda = session.device.type == "cuda"

        def put_chunk(payload, n, yp, wp, plan_store):
            """(X, n_valid, y, w[, plan]) on the device, and its event."""
            t0 = time.perf_counter()
            out = (h2d.put(payload), n,
                   None if yp is None else h2d.put(yp),
                   None if wp is None else h2d.put(wp))
            if plan_store is not None:
                out = out + (h2d.put(plan_store),)
            event = h2d.done()
            if times is not None:
                times["h2d_s"] += time.perf_counter() - t0
            return out, event

        def record_arrays(payload, yp, wp, plan_store):
            """A spill record's fields, in ``chunk_specs`` + ``plan_specs``
            order."""
            if codec is None:
                rec = (payload,) if p.label_in_chunk else (payload, yp, wp)
            else:
                rec = tuple(yp if name == "yv" else wp if name == "wv" else payload[name]
                            for name, _, _ in chunk_specs)
            if plan_store is not None:
                rec = rec + tuple(plan_store[name] for name, _, _ in plan_specs)
            return rec

        def record_to_host(arrays):
            """A spill record's fields -> (payload, y, w, plan): the inverse
            of ``record_arrays``."""
            chunk_arr = arrays[:len(chunk_specs)]
            y_np = w_np = None
            if codec is None:
                payload = chunk_arr[0]
                if not p.label_in_chunk:
                    y_np, w_np = chunk_arr[1], chunk_arr[2]
            else:
                payload = {}
                for (name, _, _), a in zip(chunk_specs, chunk_arr):
                    if name == "yv":
                        y_np = a
                    elif name == "wv":
                        w_np = a
                    else:
                        payload[name] = a
            plan_np = None
            if plan_specs:
                plan_np = {name: a for (name, _, _), a
                           in zip(plan_specs, arrays[len(chunk_specs):])}
            return payload, y_np, w_np, plan_np

        def to_device(host_chunk):
            """Prefetch-thread side: pad, hash and encode, build the plan,
            spill, copy to the device."""
            if p.label_in_chunk:
                X_np = (host_chunk if isinstance(host_chunk, np.ndarray)
                        else host_chunk[0])
                y_np = w_np = None
            else:
                X_np, y_np, w_np = (tuple(host_chunk) + (None, None))[:3]
            if X_np.shape[1] != n_cols:
                raise ValueError(f"chunk has {X_np.shape[1]} columns, expected {n_cols}")
            n = X_np.shape[0]
            if p.label_in_chunk:
                if n == pad_rows:
                    Xp = np.ascontiguousarray(X_np, dtype=np.float32)
                else:
                    Xp = np.zeros((pad_rows, n_cols), np.float32)
                    Xp[:n] = X_np
                yp = wp = None
            else:
                Xp, yp, wp = _pad_chunk(X_np, y_np, w_np, pad_rows, n_cols)
            payload, idx_np = Xp, None
            if codec is not None:
                # hash (under 'packed', once: the plan reuses the indices)
                # and encode, in row blocks on the encode threads (numpy
                # releases the GIL): the epoch-1 host work a chunk costs
                t_en = time.perf_counter()
                parts = list(encode_pool.map(
                    lambda ab: _hash_and_encode(codec, Xp[ab[0]:ab[1]], salts_np, cats_off),
                    encode_blocks))
                payload = {k: np.concatenate([e[k] for e, _ in parts]) for k in parts[0][0]}
                if codec.mode == "packed":
                    idx_np = np.concatenate([i for _, i in parts])
                if times is not None:
                    times["encode_s"] += time.perf_counter() - t_en
            plan_np = None
            if sparse_plan:
                # the host-sorted touched-row plan, built once here,
                # overlapping device steps, and replayed every epoch
                t_pl = time.perf_counter()
                plan_np = build_plan_np(Xp[:, cats_off:cats_off + p.n_cat], salts_np,
                                        p.n_dims, n,
                                        impute_missing=static_kw["impute_missing"],
                                        idx=idx_np)
                if times is not None:
                    times["plan_s"] = times.get("plan_s", 0.0) + time.perf_counter() - t_pl
            plan_store = (None if plan_np is None
                          else _plan_device_form(codec, plan_np, pad_rows, p))
            if spill_active[0]:
                t_sp = time.perf_counter()
                spill.append(record_arrays(payload, yp, wp, plan_store), n)
                if times is not None:
                    times["spill_s"] = times.get("spill_s", 0.0) + time.perf_counter() - t_sp
            return put_chunk(payload, n, yp, wp, plan_store)

        def host_chunks():
            """The rechunked host stream, with parse time attributed."""
            if p.label_in_chunk:
                it = _rechunk(((c, None) for c in source()), pad_rows)
            else:
                it = _rechunk(source(), pad_rows)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                if times is not None:
                    times["parse_s"] += time.perf_counter() - t0
                yield item[0] if p.label_in_chunk else item

        def staged(fn, items, depth):
            """``fn`` over ``items`` behind the prefetch thread (or inline
            with prefetch_depth 0), each result made ready on this stream."""
            if p.prefetch_depth > 0:
                it = prefetch_map(fn, items, depth=depth, stats_into=pipe_stats)
            else:
                it = (fn(x) for x in items)
            for out, event in it:
                yield h2d.ready(out, event)

        def device_chunk_iter():
            return staged(to_device, host_chunks(), p.prefetch_depth)

        def read_record(i):
            arrays, n = spill.read(i)
            payload, y_np, w_np, plan_np = record_to_host(arrays)
            return put_chunk(payload, n, y_np, w_np, plan_np)

        def disk_chunk_iter(start: int = 0):
            """Device feed of a spill replay epoch: records straight off the
            memmap (no parse), the holdout tail skipped."""
            return staged(read_record, iter(range(start, spill.n_records - holdout_chunks)),
                          p.prefetch_depth)

        def disk_group_iter(group: int, n_full: int):
            """Groups of ``group`` records on the device, one list per
            group, for the captured group replay."""
            def read_group(start):
                chunks, events = zip(*(read_record(start + j) for j in range(group)))
                return list(chunks), events[-1]

            return staged(read_group, iter(range(0, n_full, group)), 1)

        # encode threads: one row block each, blocks of at least 4096 rows
        n_blocks = max(1, min(8, os.cpu_count() or 1, pad_rows // 4096))
        bounds = np.linspace(0, pad_rows, n_blocks + 1).astype(int)
        encode_blocks = list(zip(bounds[:-1], bounds[1:]))
        encode_pool = (ThreadPoolExecutor(n_blocks, thread_name_prefix="encode")
                       if codec is not None else None)
        cache = _DeviceCache(cache_device, cache_device_bytes,
                             may_exclude_tail=holdout_chunks)
        # defer: the streaming pass only ingests and all `epochs` passes run
        # in the replay (at epochs == 1 too), the same step sequence. Per-step
        # snapshots need per-chunk steps, so a checkpointed fit defers only
        # under replay_granularity='epoch', whose epoch boundaries are the
        # snapshot and resume grain
        ckpt_epoch_ok = p.replay_granularity == "epoch"
        defer = (p.defer_epoch1 and cache_device and p.epochs > 0
                 and (checkpointer is None or ckpt_epoch_ok)
                 and (resume_from == 0 or ckpt_epoch_ok))
        spill: DiskChunkCache | None = None
        spill_active = [False]      # read by to_device on the prefetch thread
        if cache_device and cache_spill_dir is not None and (p.epochs > 1 or defer):
            specs = chunk_specs + plan_specs
            spill = DiskChunkCache(cache_spill_dir, tuple(s for _, s, _ in specs),
                                   tuple(dt for _, _, dt in specs))
            spill_active[0] = True
        use_disk = False
        holdout: list = []
        n_steps = 0
        last_loss = None

        def step(th, op, chunk):
            return _step_into(th, op, chunk, salts, hyper, static_kw)

        # the dispatch queue's depth follows the staging depth: a loop that
        # runs further ahead than the prefetcher stages gains nothing
        step_period = max(2, 2 * p.prefetch_depth)

        def run_step(dev_chunk):
            nonlocal n_steps, last_loss
            last_loss = step(theta, opt_state, dev_chunk)
            n_steps += 1
            bound_dispatch(n_steps, last_loss, period=step_period)
            if checkpointer is not None and not ckpt_epochs:
                checkpointer.maybe_save(n_steps, snapshot(), meta=ckpt_meta)

        fuse_replay = (p.fused_replay and cache_device and (p.epochs > 1 or defer)
                       and ((checkpointer is None and resume_from == 0) or ckpt_epoch_ok))
        epoch_walls: list = []
        replay_fused_s = graph_capture_s = None
        disk_replay: _Replay | None = None
        try:
            for epoch in range(p.epochs + (1 if defer else 0)):
                t_epoch = time.perf_counter()
                if epoch == 0 or not (cache.enabled or use_disk):
                    # stream from the source; a look-ahead window keeps the
                    # last holdout_chunks device chunks out of training
                    window: list = []
                    for dev_chunk in device_chunk_iter():
                        if epoch == 0:
                            cache.offer(dev_chunk)
                        if holdout_chunks > 0:
                            window.append(dev_chunk)
                            if len(window) <= holdout_chunks:
                                continue
                            dev_chunk = window.pop(0)
                        if epoch == 0 and defer:
                            continue          # ingest only
                        if n_steps < resume_from:
                            n_steps += 1      # checkpointed: fast-forward
                            continue
                        run_step(dev_chunk)
                    if epoch == 0:
                        if holdout_chunks > 0:
                            holdout = window[-holdout_chunks:]
                            if cache.enabled:
                                # the tail lives in the cache too: never replay it
                                cache.exclude({id(c[0]) for c in holdout})
                                cache.forgive_tail(holdout_chunks)
                        spill_active[0] = False   # the prefetch thread is done
                        if spill is not None:
                            spill.finalize()
                        cache.settle()
                        if cache.degraded and (p.epochs > 1 or defer):
                            use_disk = spill is not None and spill.n_records > holdout_chunks
                            if not use_disk:
                                warn_cache_overflow(
                                    cache_device_bytes, p.epochs - 1 + (1 if defer else 0),
                                    detail=("The disk spill has no trainable records "
                                            "(fewer chunks than the holdout tail)."
                                            if spill is not None else
                                            "Set cache_spill_dir= to replay parsed "
                                            "chunks from disk instead."))
                elif cache.enabled:
                    for dev_chunk in cache.batches:   # replay: no host work at all
                        if n_steps < resume_from:
                            n_steps += 1
                            continue
                        run_step(dev_chunk)
                else:
                    # a replay epoch off the disk spill: read + copy, no parse
                    n_train = spill.n_records - holdout_chunks
                    group = max(1, min(spill.n_records,
                                       cache_device_bytes // (4 * spill.payload_bytes)))
                    # captured groups skip no step: not while resuming or
                    # snapshotting per step
                    grouped = (p.fused_replay and group > 1 and checkpointer is None
                               and resume_from == 0)
                    n_full = (n_train // group) * group if grouped else 0
                    if n_full:
                        n_groups = 0
                        if times is not None:
                            times["disk_replay_group"] = group
                        for chunks in disk_group_iter(group, n_full):
                            if disk_replay is None:
                                disk_replay = _Replay(theta, opt_state,
                                                      [_chunk_slot(c) for c in chunks], step)
                            for slot, c in zip(disk_replay.chunks, chunks):
                                _fill_slot(slot, c)
                            if is_cuda and disk_replay.graph is None:
                                disk_replay.capture()   # once a fit, on filled slots
                            disk_replay.run(1)
                            last_loss = disk_replay.losses[-1]
                            n_steps += group
                            n_groups += 1
                            # each group in flight holds its chunks: one
                            # running, one queued
                            bound_dispatch(n_groups, last_loss, period=2)
                    for dev_chunk in disk_chunk_iter(start=n_full):
                        if n_steps < resume_from:
                            n_steps += 1
                            continue
                        run_step(dev_chunk)
                # the non-finite guard BEFORE the save: a divergent epoch
                # raises typed and never checkpoints NaN state
                check_finite_training(last_loss, theta, epoch=epoch, chunk=n_steps,
                                      estimator="StreamingHashedLinearEstimator")
                epoch_boundary_snapshot(checkpointer, ckpt_epochs, epoch, defer, n_steps,
                                        resume_from, snapshot, ckpt_meta)
                if times is not None:
                    session.synchronize()   # an honest epoch wall
                    epoch_walls.append(time.perf_counter() - t_epoch)
                if (epoch == 0 and fuse_replay and cache.enabled and cache.batches
                        # whole epochs are the replay's resume grain: a
                        # snapshot off an epoch boundary takes the per-chunk
                        # replay, which skips at step grain
                        and resume_from % len(cache.batches) == 0):
                    # the remaining epochs: one captured epoch, replayed
                    n_rep = p.epochs - 1 + (1 if defer else 0)
                    spe = len(cache.batches)
                    if n_steps + n_rep * spe <= resume_from:
                        # the snapshot covers every replay epoch: nothing to
                        # run (final_loss_ stays None)
                        n_steps += n_rep * spe
                        break
                    t_rep = time.perf_counter()
                    replay = _Replay(theta, opt_state, cache.batches, step)
                    if is_cuda:
                        replay.capture()
                    graph_capture_s = time.perf_counter() - t_rep
                    if p.replay_granularity == "epoch":
                        def dispatch_epochs(k):
                            replay.run(k)
                            return replay.losses[-1]

                        n_steps, last, _ = run_epoch_replay(
                            n_rep, spe, n_steps, resume_from, checkpointer,
                            dispatch_epochs, snapshot, ckpt_meta,
                            epochs_per_dispatch=p.epochs_per_dispatch,
                            every_epochs=ckpt_epochs)
                        if last is not None:
                            last_loss = last
                    else:
                        replay.run(n_rep)
                        count_dispatch()   # one call: no loop to bound
                        last_loss = replay.losses[-1]
                        n_steps += n_rep * spe
                    session.synchronize()
                    replay_fused_s = time.perf_counter() - t_rep
                    if times is not None:
                        epoch_walls.append(replay_fused_s)
                    del replay
                    break
        finally:
            if spill is not None:
                spill.delete()
            if encode_pool is not None:
                encode_pool.shutdown()

        # the fused replay leaves the loop before the per-epoch guard: the
        # final check sweeps theta too (a last-step divergence shows only
        # there)
        check_finite_training(last_loss, theta, epoch=p.epochs - 1, chunk=n_steps,
                              final=True, estimator="StreamingHashedLinearEstimator")
        # settle the decay the table still owes, so the returned model
        # equals the dense schedule's
        theta = finalize_lazy_decay(theta, opt_state, hyper[1], hyper[0], optim_resolved)
        if stage_times is not None:
            stage_times.update(times)
            stage_times.update(
                optim_update=optim_resolved, sparse_lowering=static_kw["sparse_lowering"],
                cache_dtype=codec.mode if codec else "f32", epoch_s=epoch_walls,
                cache_overflow=cache.degraded, retries=pipe_stats.retries,
                replay_source=(None if p.epochs <= 1 and not defer
                               else ("fused" if p.replay_granularity != "epoch"
                                     else "fused_epoch") if replay_fused_s is not None
                               else "disk" if use_disk
                               else "hbm" if cache.enabled
                               else "stream"))
            if replay_fused_s is not None:
                stage_times.update(replay_fused_s=replay_fused_s,
                                   graph_capture_s=graph_capture_s)
            if cache_device:
                stage_times.update(
                    cache_bytes=cache.nbytes, cache_chunks=len(cache.batches),
                    cache_raw_bytes=len(cache.batches) * _raw_chunk_bytes(
                        p, pad_rows, sparse_plan))
            if pipe_stats.items:
                stage_times.update(overlap_pct=pipe_stats.overlap_pct,
                                   prefetch_prep_s=pipe_stats.prep_s,
                                   prefetch_wait_s=pipe_stats.wait_s)
        model = HashedLinearModel(
            p, theta, salts_np,
            class_values or (tuple(str(i) for i in range(p.n_classes))
                             if p.loss == "logistic" else None))
        model.n_steps_ = n_steps
        model.final_loss_ = float(last_loss) if last_loss is not None else None
        model.device_chunks_ = cache.batches if cache_device else None
        model.holdout_chunks_ = holdout if holdout_chunks > 0 else None
        model.cache_codec_ = codec
        if checkpointer is not None:
            checkpointer.delete()
        return model
