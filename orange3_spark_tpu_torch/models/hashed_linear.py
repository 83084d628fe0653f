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

* Value-weighted rows (``value_weighted``, MLlib's SparseVector): a chunk
  carries ``n_cat`` (index, value) pairs, ``[label?, idx..., val...]``
  (``io/libsvm.libsvm_chunk_source``), the forward is ``sum(emb[hash(idx)]
  * val)`` and every slot hashes with one salt (a feature lands in one
  bucket whatever slot it sits in); pairs of index -1 (padding, value 0)
  are dead.
* ``emb_update`` picks the forward and the table gradient of 'adam' and
  the dense twins: 'fused' (one gather; the gradient row by row), 'per_column'
  (C gathers added in column order; the gradient column by column) or
  'sorted' (the fused forward; the gradient by a stable sort of the pairs
  and the deterministic segment sum). The sparse rules take the fused
  forward and their own update, whatever ``emb_update`` says.
* ``missing='keep'`` leaves NaN cells as they are, so a NaN dense cell
  reaches the loss and ``check_finite_training`` raises; a NaN categorical
  code hashes as code 0 (``ops/hashing.hash_columns`` converts as XLA
  does on the reference's device), the bucket 'zero' gives it.
* ``compute_dtype`` 'bfloat16' (or 'float16') rounds the gathered
  embedding rows, the dense block and its coefficients to that type and
  then multiplies and adds in float32 (a product of two bf16 values is
  exact in float32: the reference's ``preferred_element_type=float32``).
  'adam' and the dense twins differentiate through those rounded copies,
  as the reference does: the coefficients' gradient is rounded to the
  type, and the table's is summed in it (``optim/sparse.dense_table_grad``
  with ``round_to``). The sparse rules' gradients stay float32, as the
  reference's.

* A gang of ranks (``core/session.World``, ``parallel/``): each rank steps
  on its block of the global chunk; ``Σw`` and the dense gradients are
  folded over the data ranks in rank order, and every rank sorts the
  gathered global occurrence list, so its table update is the one-process
  update of the global chunk. Under model parallelism a rank holds the
  table rows of its model index, with their slots and timestamps, and the
  whole table is gathered once at the end. A gang's replay runs its steps
  eagerly: a CUDA graph cannot hold a gloo collective.

The update rules are optim/sparse.py's ``adam`` and ``{dense,sparse}_
{sgd,adagrad,ftrl}``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import weakref
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
    EPS_TOTAL_WEIGHT, dense_logits, per_row_loss, per_row_loss_and_grad,
)
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params
from orange3_spark_tpu_torch.obs import prof
from orange3_spark_tpu_torch.obs.report import RunReport
from orange3_spark_tpu_torch.obs.trace import refreshed_enabled as obs_enabled
from orange3_spark_tpu_torch.obs.trace import traced
from orange3_spark_tpu_torch.ops.hashing import (
    column_salts, hash_columns, hash_columns_np, salts_tensor,
)
from orange3_spark_tpu_torch.optim.sparse import (
    EMB_UPDATES, adam_update, build_plan_np, dense_table_grad, dense_update, finalize_lazy_decay,
    init_optim_state, is_sparse_update, occurrence_keys, optim_kind, pack_plan_np,
    plan_field_shapes, plan_packed_field_shapes, resolve_optim_update, resolve_sparse_lowering,
    sorted_keys_update, sparse_embedding_update, unpack_plan,
)
from orange3_spark_tpu_torch.parallel.collectives import (
    collective_stats, fold, gather_host, gather_packed, to_device, world_fold,
)
from orange3_spark_tpu_torch.resilience.numerics import check_finite_training
from orange3_spark_tpu_torch.utils.dispatch import bound_dispatch
from orange3_spark_tpu_torch.utils.graphs import EpochReplay, capture_graph

AUC_BINS = 4096
#: the profiler ranges of ``_step_core``, in step order ('split_hash' is
#: the decode under a compressed cache; under 'adam' the whole update of
#: the three parameters is 'embedding_update')
STEP_STAGES = ("split_hash", "forward", "loss_grad", "embedding_update", "dense_update")


@dataclasses.dataclass(frozen=True)
class HashedLinearParams(Params):
    """The JAX package's ``HashedLinearParams``, field for field, so a
    model's params round-trip between the two packages (the module
    docstring says what the options do)."""

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
    emb_update: str = "auto"     # 'auto' | 'fused' | 'per_column' | 'sorted'
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
    missing: str = "zero"        # 'zero' | 'keep'
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


#: the compute dtypes of the step's products (the reference's jnp.dtype names)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}


def _check_ported(p: HashedLinearParams) -> None:
    """Raise on a parameter value the fit does not take."""
    if resolve_emb_update(p) not in EMB_UPDATES:
        raise ValueError(f"emb_update must be 'auto' or one of {EMB_UPDATES}, "
                         f"got {p.emb_update!r}")
    _impute_flag(p)
    if p.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {tuple(COMPUTE_DTYPES)}, "
                         f"got {p.compute_dtype!r}")
    if p.value_weighted and p.n_dense:
        raise ValueError("value_weighted mode carries (index, value) pairs only — "
                         f"n_dense must be 0, got {p.n_dense}")
    if p.replay_granularity not in ("all", "epoch"):
        raise ValueError(
            f"replay_granularity must be 'all' or 'epoch', got {p.replay_granularity!r}")


def _rounded(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and widened back to float32 (exact),
    so the products that follow run in float32 on rounded operands."""
    return x if compute_dtype == torch.float32 else x.to(compute_dtype).to(torch.float32)


def _hashed_logits(theta: dict, dense: torch.Tensor, idx: torch.Tensor, vals=None, *,
                   emb_update: str = "fused",
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[N, k] logits: the [N, C] embedding rows (each times its pair's value
    with ``vals``) summed over the columns, plus the dense block's term.
    'fused' and 'sorted' gather all rows at once and sum them; 'per_column'
    adds the C gathered columns to zeros in column order. Under a narrower
    ``compute_dtype`` the rows, the dense block and its coefficients are
    rounded to it and the products and sums run in float32."""
    emb = theta["emb"]
    N, C = idx.shape
    k = emb.shape[1]
    if emb_update == "per_column":
        logits = torch.zeros((N, k), dtype=torch.float32, device=emb.device)
        for c in range(C):
            col = _rounded(emb.index_select(0, idx[:, c]), compute_dtype)
            if vals is not None:
                col = col * vals[:, c, None]
            logits = logits + col
    else:
        rows = _rounded(emb.index_select(0, idx.reshape(-1)).view(N, C, k), compute_dtype)
        if vals is not None:
            rows = rows * vals[:, :, None]
        logits = rows.sum(dim=1)
    if theta["coef"].shape[0]:
        logits = logits + dense_logits(_rounded(dense, compute_dtype),
                                       _rounded(theta["coef"], compute_dtype))
    return logits + theta["intercept"]


def _row_mask(n_rows: int, n_valid, device) -> torch.Tensor:
    """f32 [N]: 1 on the first ``n_valid`` rows (an int, or a device int
    scalar in a captured replay whose chunk buffers are refilled)."""
    return (torch.arange(n_rows, device=device) < n_valid).to(torch.float32)


def _split_chunk(Xall, n_valid, y, w, *, label_in_chunk: bool, n_dense: int,
                 value_weighted: bool = False, impute_missing: bool = False):
    """Chunk anatomy, on the device. label_in_chunk: column 0 is the label
    and the row mask is ``arange < n_valid`` (no y/w vectors shipped).
    value_weighted: the features are C (index, value) pairs, ``[idx...,
    val...]``, and there is no dense block. impute_missing: NaN dense cells
    -> 0, NaN categorical cells -> the reserved code 0 (crc32 of the empty
    string, what fastcsv gives an empty categorical cell; the hash takes a
    NaN code kept by 'keep' as 0 too, ``ops/hashing.hash_columns``). Returns
    (y, dense, cats, w, vals), ``vals`` None unless value-weighted; ``cats``
    keeps a value-weighted chunk's raw -1 pads (its dead pairs)."""
    if label_in_chunk:
        yv = Xall[:, 0]
        feat = Xall[:, 1:]
        wv = _row_mask(Xall.shape[0], n_valid, Xall.device)
    else:
        yv, feat, wv = y, Xall, w
    if value_weighted:
        C = feat.shape[1] // 2
        return yv, feat[:, :0], feat[:, :C], wv, feat[:, C:]
    dense, cats = feat[:, :n_dense], feat[:, n_dense:]
    if impute_missing:
        dense = torch.where(torch.isnan(dense), 0.0, dense)
        cats = torch.where(torch.isnan(cats), 0.0, cats)
    return yv, dense, cats, wv, None


# ------------------------------------------------------------ the chunk codec

#: spill order of the touched-row plan's arrays, raw and packed
_PLAN_ORDER = ("row", "seg", "uniq", "inv", "val")
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
    words under the 'packed' codec, int32 arrays (and the value-weighted
    plan's f32 'val') else."""
    if codec is not None and codec.mode == "packed":
        d = plan_packed_field_shapes(pad_rows, p.n_cat, p.n_dims)
        return tuple((k, d[k][0], np.dtype(d[k][1])) for k in _PLAN_PACKED_ORDER)
    shapes = plan_field_shapes(pad_rows, p.n_cat, p.n_dims, p.value_weighted)
    return tuple((k, shapes[k], np.dtype(np.float32 if k == "val" else np.int32))
                 for k in _PLAN_ORDER if k in shapes)


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
                     plan_field_shapes(pad_rows, p.n_cat, p.n_dims,
                                       p.value_weighted).values())
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


# ------------------------------------------------------------------ the gang

@dataclasses.dataclass(frozen=True, eq=False)
class _Gang:
    """A fit's place in a gang of ranks (``core/session.World``): its data
    group (None: one data rank), its model group (None: the whole table
    lives here) and the table rows it owns, ``[lo, lo + rows)``: under
    model parallelism model rank m owns ``[m·D/mp, (m+1)·D/mp)`` with their
    optimizer slots and timestamps (the reference's ``P('model', None)``
    table)."""

    data_group: object
    model_group: object
    lo: int
    rows: int


def _gang_of(session: TorchSession, p: HashedLinearParams) -> "_Gang | None":
    """The gang of a fit on ``session``; None for a world of one rank, so
    that fit is the one-process fit, bit for bit."""
    w = session.world
    if w.size == 1:
        return None
    mp = w.model_parallel
    if p.n_dims % mp:
        raise ValueError(f"model_parallel={mp} does not divide n_dims={p.n_dims}")
    rows = p.n_dims // mp
    return _Gang(w.data_group, w.model_group, w.model_index * rows, rows)


def _owned_keys(keys: torch.Tensor, gang: "_Gang | None", sentinel: int) -> torch.Tensor:
    """Global table rows -> this model rank's rows (``key - lo``), every
    key outside ``[lo, lo + rows)`` (the dead sentinel included) to
    ``sentinel``. The identity without model parallelism."""
    if gang is None or gang.model_group is None:
        return keys
    local = keys - gang.lo
    return torch.where((local >= 0) & (local < gang.rows), local,
                       torch.full_like(local, sentinel))


def _sharded_logits(theta: dict, dense, idx, vals, gang: _Gang,
                    compute_dtype: torch.dtype) -> torch.Tensor:
    """``_hashed_logits`` over a model-split table: each model rank sums the
    rows it owns of every logit of its data block (the others count 0), the
    partial logits are folded over the model group in rank order, then the
    dense term and the intercept are added."""
    emb = theta["emb"]
    N, C = idx.shape
    local = idx - gang.lo
    owned = (local >= 0) & (local < gang.rows)
    rows = emb.index_select(0, local.clamp(0, gang.rows - 1).reshape(-1)).view(N, C, -1)
    rows = torch.where(owned[:, :, None], _rounded(rows, compute_dtype), 0.0)
    if vals is not None:
        rows = rows * vals[:, :, None]
    logits = world_fold(rows.sum(dim=1), gang.model_group)
    if theta["coef"].shape[0]:
        logits = logits + dense_logits(_rounded(dense, compute_dtype),
                                       _rounded(theta["coef"], compute_dtype))
    return logits + theta["intercept"]


def _gang_gather(gang: "_Gang | None", keys, dl, vals, small: list):
    """One gather over the data group of this rank's occurrence keys (i32
    [N·C]), ``dl`` [N, k], the pairs' values (f32 [N·C] or None) and the
    small dense partials ``small`` (the coefficients' and intercept's
    gradients and the data loss). Returns the global occurrence list (keys,
    dl, vals: every rank's, concatenated in rank order, on the device: the
    one-process global chunk's list in its order) and the partials folded in
    rank order. The identity for one rank (no gang, or a data group of
    one)."""
    if gang is None or gang.data_group is None:
        return keys, dl, vals, small
    dev = dl.device
    sizes = [t.numel() for t in small]
    tensors = ([keys.to(torch.int32), dl] + ([vals] if vals is not None else [])
               + [torch.cat([t.reshape(-1) for t in small])])
    parts = gather_packed(tensors, gang.data_group)
    cat = [to_device(torch.cat([q[i] for q in parts]), dev) for i in range(len(tensors) - 1)]
    flat = to_device(fold([q[-1] for q in parts]), dev)
    small = [v.view(t.shape) for v, t in zip(torch.split(flat, sizes), small)]
    return cat[0], cat[1], (cat[2] if vals is not None else None), small


def _gather_table(emb: torch.Tensor, gang: "_Gang | None") -> torch.Tensor:
    """The whole table from the model ranks' row blocks (concatenated in
    model rank order), once at the end of a fit; the table itself without
    model parallelism."""
    if gang is None or gang.model_group is None:
        return emb
    return to_device(torch.cat(gather_host(emb.contiguous(), gang.model_group)), emb.device)


# ------------------------------------------------------------------ the step

def _step_core(theta: dict, opt_state: dict, Xall, n_valid, y, w, salts, reg: float,
               lr: float, plan=None, l1: float = 0.0, *, loss_kind: str, n_dims: int,
               n_dense: int, label_in_chunk: bool = False, impute_missing: bool = False,
               optim_update: str, sparse_lowering: str = "none",
               use_decay: bool = False, codec: _ChunkCodec | None = None,
               emb_update: str = "fused", value_weighted: bool = False,
               compute_dtype: torch.dtype = torch.float32, gang: _Gang | None = None):
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
    compressed bytes. ``emb_update`` (the forward and table gradient of
    'adam' and the dense twins), ``value_weighted`` (pair chunks) and
    ``compute_dtype`` (the products' operands rounded to it) as the module
    docstring says. Nothing here waits for the device, so the step can be
    captured. Its stages run in profiler ranges named by ``STEP_STAGES``.

    ``gang`` (None for one rank): the chunk is this rank's block of the
    global chunk. The forward runs per rank (over a model-split table, the
    model group folds the partial logits); ``Σw`` is folded over the data
    group before ``dl`` is formed; then one gather hands every rank the
    global occurrence list (keys with the dead ones at the sentinel, ``dl``,
    the values) and the folded dense gradients and loss. Every rank then
    runs the same stable sort and ``segment_update_sorted`` (the sparse
    rules; the 'sort' lowering) or ``dense_table_grad`` (adam, the dense
    twins) on that list, filtered to the rows it owns, so its table update
    is the one-process update of the global chunk. The collectives wait for
    the device."""
    kind = optim_kind(optim_update)
    sparse = is_sparse_update(optim_update)
    with record_function("split_hash"):
        vals = cats = None
        if codec is None:
            yv, dense, cats, wv, vals = _split_chunk(
                Xall, n_valid, y, w, label_in_chunk=label_in_chunk, n_dense=n_dense,
                value_weighted=value_weighted, impute_missing=impute_missing)
            idx = hash_columns(cats, salts, n_dims)
        else:
            yv, dense, idx, wv = _decode_chunk(codec, Xall, n_valid, y, w, salts)
            if plan is not None and codec.mode == "packed":
                plan = unpack_plan(plan, idx.shape[0], codec.n_cat, n_dims)
    with record_function("forward"):
        if gang is not None and gang.model_group is not None:
            logits = _sharded_logits(theta, dense, idx, vals, gang, compute_dtype)
        else:
            logits = _hashed_logits(theta, dense, idx, vals,
                                    emb_update="fused" if sparse else emb_update,
                                    compute_dtype=compute_dtype)
    with record_function("loss_grad"):
        sw = torch.clamp_min(wv.sum() if gang is None else world_fold(wv.sum(), gang.data_group),
                             EPS_TOTAL_WEIGHT)
        rows, dl = per_row_loss_and_grad(loss_kind, logits, yv, wv / sw)   # dl: [N, k]
        C = idx.shape[1]
        plan_lowering = sparse and sparse_lowering == "plan"
        # the occurrence list (with the 'sort' lowering's dead keys at the
        # sentinel) and the dense partials: this rank's, or in a gang every
        # rank's list and the partials folded
        keys = (None if plan_lowering else
                occurrence_keys(idx, n_valid, n_dims, cats if value_weighted else None)
                if sparse else idx.reshape(-1))
        keys, g_dl, g_vals, (g_coef, g_int, data_loss) = _gang_gather(
            gang, keys, dl, None if vals is None else vals.reshape(-1).contiguous(),
            [_rounded(dense, compute_dtype).T @ dl, dl.sum(dim=0), (rows * wv).sum()])
        loss = data_loss / sw
        if not sparse:          # differentiated through the rounded coef
            g_coef = _rounded(g_coef, compute_dtype)
        if kind == "adam":
            emb_sq = (theta["emb"] ** 2).sum()
            if gang is not None:
                emb_sq = world_fold(emb_sq, gang.model_group)
            loss = loss + 0.5 * reg * (emb_sq + (theta["coef"] ** 2).sum())
            g_coef = g_coef + reg * theta["coef"]
    with record_function("embedding_update"):
        D = theta["emb"].shape[0]
        decay = float(np.float32(1.0) - np.float32(lr) * np.float32(reg))
        if plan_lowering:
            emb, t, eslots = sparse_embedding_update(
                kind, theta["emb"], opt_state["t"], opt_state["slots"]["emb"], dl, idx,
                lr, decay, reg, l1, opt_state["step"], lowering="plan",
                use_decay=use_decay, plan=plan, n_valid=n_valid, vals=vals)
        elif sparse and gang is None and isinstance(n_valid, int) and n_valid == 0:
            # every occurrence dead: no row moves
            emb, t, eslots = theta["emb"], opt_state["t"], opt_state["slots"]["emb"]
        elif sparse:
            emb, t, eslots = sorted_keys_update(
                kind, theta["emb"], opt_state["t"], opt_state["slots"]["emb"], g_dl,
                _owned_keys(keys, gang, D), C, lr, decay, reg, l1, opt_state["step"],
                use_decay=use_decay, vals=g_vals)
        else:
            # over a model-split table, a key this rank does not own lands on
            # a spare row D, dropped
            spare = int(gang is not None and gang.model_group is not None)
            g_emb = dense_table_grad(
                _owned_keys(keys, gang, D).view(-1, C), g_dl, D + spare,
                vals=None if g_vals is None else g_vals.view(-1, C),
                emb_update=emb_update, round_to=compute_dtype)[:D]
            if kind == "adam":
                return (*adam_update(
                    theta, {"emb": g_emb + reg * theta["emb"], "coef": g_coef,
                            "intercept": g_int}, opt_state, lr), loss)
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


#: per-process ledger-entry numbering for hashed fits and replays (obs/prof.py)
_FIT_LEDGER_SEQ = itertools.count()
_REPLAY_LEDGER_SEQ = itertools.count()


class _Replay(EpochReplay):
    """Replay epochs: one step per chunk, in order, on a state updated in
    place. ``capture()`` (CUDA) records one epoch as a CUDA graph — every
    step's kernels, reading the chunks where they lie (the cache itself, no
    stacked copy), the losses into the fixed ``losses`` buffer — and
    ``run(n)`` replays it ``n`` times (``utils.graphs.EpochReplay``).
    Uncaptured (the CPU), ``run`` runs the same steps one by one. A failed
    capture raises; nothing falls
    back to the eager steps. The dense streaming fit
    (``io/streaming.StreamingLinearEstimator``) replays through it too."""

    def __init__(self, theta: dict, opt_state: dict, chunks: list, step: Callable):
        super().__init__()
        self.theta, self.opt_state, self.chunks, self.step = theta, opt_state, chunks, step
        self.device = next(iter(theta.values())).device
        self.losses = torch.zeros(len(chunks), dtype=torch.float32, device=self.device)
        # the replay's own device memory (the losses, the captured graph's
        # pool; it reads the cache in place) is the ledger entry
        # ``replay_plans`` while it lives (released GC-safely when it dies)
        self.ledger_key = f"replay_graph-{next(_REPLAY_LEDGER_SEQ)}"
        weakref.finalize(self, prof.ledger_release_on_gc, "replay_plans", self.ledger_key)
        prof.ledger_set("replay_plans", self.ledger_key, prof.tree_device_bytes(self.losses))

    def _epoch(self) -> None:
        for i, c in enumerate(self.chunks):
            self.losses[i].copy_(self.step(self.theta, self.opt_state, c))

    def capture(self) -> None:
        """Warm one step on a copy of the state on a side stream (library
        handles and workspaces), then capture one epoch. Thread-local
        capture mode lets the prefetch thread keep copying meanwhile."""
        theta, opt_state = self.theta, self.opt_state
        self.graph, _, pool_bytes = capture_graph(
            self._epoch, self.device,
            warm=lambda: self.step(_clone_tree(theta), _clone_tree(opt_state), self.chunks[0]))
        prof.ledger_set("replay_plans", self.ledger_key,
                        pool_bytes + prof.tree_device_bytes(self.losses))


# ------------------------------------------------------------- predict, eval

def _hashed_predict(theta, Xall, salts, *, n_dims: int, n_dense: int,
                    value_weighted: bool = False,
                    impute_missing: bool = False) -> torch.Tensor:
    _, dense, cats, _, vals = _split_chunk(
        Xall, 0, None, None, label_in_chunk=False, n_dense=n_dense,
        value_weighted=value_weighted, impute_missing=impute_missing)
    return _hashed_logits(theta, dense, hash_columns(cats, salts, n_dims), vals)


def _hashed_eval_chunk(theta, Xall, n_valid, y, w, salts, *, loss_kind: str,
                       n_dims: int, n_dense: int, label_in_chunk: bool,
                       value_weighted: bool = False, impute_missing: bool = False,
                       codec: _ChunkCodec | None = None):
    """Device-side eval accumulators of one chunk: (weighted logloss sum,
    weighted correct sum, weight sum, pos/neg score histograms for AUC).
    Only these small tensors ever go back to the host. ``codec``: the fit's
    codec for encoded cached chunks."""
    vals = None
    if codec is None:
        yv, dense, cats, wv, vals = _split_chunk(
            Xall, n_valid, y, w, label_in_chunk=label_in_chunk, n_dense=n_dense,
            value_weighted=value_weighted, impute_missing=impute_missing)
        idx = hash_columns(cats, salts, n_dims)
    else:
        yv, dense, idx, wv = _decode_chunk(codec, Xall, n_valid, y, w, salts)
    logits = _hashed_logits(theta, dense, idx, vals)
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
                               n_dense=p.n_dense, value_weighted=p.value_weighted,
                               impute_missing=_impute_flag(p))

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
                              value_weighted=p.value_weighted,
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
                value_weighted=p.value_weighted, impute_missing=_impute_flag(p), codec=codec)
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
    """Expected chunk width: [label?] + (idx..., val...) pairs in the
    value-weighted layout, or [label?] + dense + categorical columns."""
    return (2 if p.value_weighted else 1) * p.n_cat + p.n_dense + (1 if p.label_in_chunk else 0)


def hashed_salts(p: HashedLinearParams) -> np.ndarray:
    """The uint32 salts of a fit: one per column, or under value-weighted
    rows ONE salt repeated over the slots (libsvm packs pairs by position,
    so a feature must hash alike in every slot)."""
    if p.value_weighted:
        return np.repeat(column_salts(1, p.seed), p.n_cat)
    return column_salts(p.n_cat, p.seed)


def _init_fit_state(p: HashedLinearParams, session: TorchSession):
    """Fresh (theta, opt_state, salts_np, salts, static_kw) exactly as a fit
    starts: a zero theta, the rule's zero state, the numpy salts and the
    resolved statics (rule, lowering, codec, the gang), so two fits (or this
    package and the JAX package) compare step for step. In a gang with
    model parallelism the table, its slots and timestamps hold this rank's
    rows only; a gang's sparse rules take the 'sort' lowering ('auto'
    resolves to it, 'plan' raises)."""
    _check_ported(p)
    optim = resolve_optim_update(p.optim_update)
    k = _effective_k(p)
    dev = session.device
    gang = _gang_of(session, p)
    lowering = "none"
    if is_sparse_update(optim):
        lowering = resolve_sparse_lowering(p.sparse_lowering, dev)
        if gang is not None:
            # a host plan is one rank's chunk; the gang sorts the global list
            if p.sparse_lowering == "plan":
                raise ValueError("sparse_lowering='plan' sorts each rank's own chunk; a "
                                 "gang's update sorts the global chunk: use 'sort' or 'auto'")
            lowering = "sort"
    theta = {
        "emb": torch.zeros((p.n_dims if gang is None else gang.rows, k), dtype=torch.float32,
                           device=dev),
        "coef": torch.zeros((p.n_dense, k), dtype=torch.float32, device=dev),
        "intercept": torch.zeros((k,), dtype=torch.float32, device=dev),
    }
    opt_state = init_optim_state(optim, theta)
    salts_np = hashed_salts(p)
    static_kw = dict(
        loss_kind=_row_loss_kind(p), n_dims=p.n_dims, n_dense=p.n_dense,
        label_in_chunk=p.label_in_chunk, impute_missing=_impute_flag(p),
        emb_update=resolve_emb_update(p), value_weighted=p.value_weighted,
        compute_dtype=COMPUTE_DTYPES[p.compute_dtype],
        optim_update=optim,
        sparse_lowering=lowering, gang=gang,
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


def _live_prefix(w: np.ndarray) -> int:
    """The live rows of a label-in-chunk chunk's weights: the chunk masks
    its rows by a count (``n_valid``), so its weights must be ones then a
    dead tail of zeros (a sharded source's lockstep pads). Raises otherwise."""
    n = int(np.count_nonzero(w))
    if not (np.all(w[:n] == 1.0) and not np.any(w[n:])):
        raise ValueError("label_in_chunk chunks take row weights only as ones followed by "
                         "a dead (w=0) tail")
    return n


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
    gang_fold = True            # each step folds and gathers over the ranks

    def _fit(self, table):
        """Estimator protocol: an in-memory table streamed in chunks."""
        from orange3_spark_tpu_torch.io.streaming import array_chunk_source
        from orange3_spark_tpu_torch.models.base import infer_class_values

        if self.params.value_weighted:
            # a table's features are dense columns, never the (idx..., val...)
            # pair layout: hashing feature values as indices trains nonsense
            raise ValueError("value_weighted fits consume (index, value) pair chunks "
                             "(io.libsvm.libsvm_chunk_source) via fit_stream, not "
                             "dense tables")
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
        replay (``fused_replay`` off, one epoch without defer, no chunks, a
        gang's session)."""
        p = self.params
        session = session or TorchSession.active()
        if not (p.fused_replay and (p.epochs > 1 or p.defer_epoch1) and n_chunks > 0
                and session.world.size == 1):
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
            zeros = np.zeros((pad_rows, p.n_cat), np.float32)
            plan_np = build_plan_np(zeros, salts_np, p.n_dims, pad_rows,
                                    vals=zeros if p.value_weighted else None)
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

    @traced("fit", model="hashed_linear")
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
          phase, capture included) and 'graph_capture_s' say so;
          'epoch_collectives', ``collective_stats()`` at the end of each of
          those walls; plus the
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
            prefetch_map, replay_epochs, resolve_epoch_checkpointing, warn_cache_overflow,
        )
        from orange3_spark_tpu_torch.resilience.retry import resilient_source

        p = self.params
        # the run report rides the OTPU_OBS kill-switch; the goodput
        # accountant (obs/prof.py) is None under OTPU_PROF=0, and every
        # downstream hook then no-ops on a contextvar read
        report = (RunReport("fit_stream", estimator=type(self).__name__,
                            n_dims=p.n_dims, epochs=p.epochs)
                  if obs_enabled() else None)
        acc = prof.begin_fit()
        session = session or TorchSession.active()
        theta, opt_state, salts_np, salts, static_kw = _init_fit_state(p, session)
        # device-memory ledger: the table and the optimizer slots, the
        # other big tenant beside the chunk cache. Re-set to the table at
        # fit end (the slots die with the fit); released when the fitted
        # model dies, or by the guard when the fit aborts
        state_key = f"hashed-{next(_FIT_LEDGER_SEQ)}"
        prof.ledger_set("model_state", state_key, prof.tree_device_bytes((theta, opt_state)))
        _state_guard = prof.ledger_guard("model_state", state_key)
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
        # host stage seconds, for stage_times= and the run report
        times = {"parse_s": 0.0, "h2d_s": 0.0}
        pipe_stats = PipelineStats()
        # the source chokepoint: fault injection and bounded retries of
        # transient reads, on the prefetch thread; retries count into
        # pipe_stats
        source = resilient_source(source, stats=pipe_stats)
        h2d = _HostToDevice(session.device)
        gang = static_kw["gang"]
        # a CUDA graph cannot hold a gloo collective: a gang's replay epochs
        # run eagerly (each step waits for its collectives anyway)
        is_cuda = session.device.type == "cuda" and gang is None

        def put_chunk(payload, n, yp, wp, plan_store):
            """(X, n_valid, y, w[, plan]) on the device, and its event."""
            t0 = time.perf_counter()
            out = (h2d.put(payload), n,
                   None if yp is None else h2d.put(yp),
                   None if wp is None else h2d.put(wp))
            if plan_store is not None:
                out = out + (h2d.put(plan_store),)
            event = h2d.done()
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
                X_np, _, w_np = ((host_chunk, None, None) if isinstance(host_chunk, np.ndarray)
                                 else (tuple(host_chunk) + (None, None))[:3])
                y_np = None
            else:
                X_np, y_np, w_np = (tuple(host_chunk) + (None, None))[:3]
            if X_np.shape[1] != n_cols:
                raise ValueError(f"chunk has {X_np.shape[1]} columns, expected {n_cols}")
            n = X_np.shape[0]
            if p.label_in_chunk:
                if w_np is not None:
                    # a sharded source's lockstep pads: a dead (w=0) tail
                    n = _live_prefix(w_np)
                if n == pad_rows:
                    Xp = np.ascontiguousarray(X_np, dtype=np.float32)
                else:
                    Xp = np.zeros((pad_rows, n_cols), np.float32)
                    Xp[:n] = X_np[:n]
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
                pipe_stats.encode_s += time.perf_counter() - t_en
            plan_np = None
            if sparse_plan:
                # the host-sorted touched-row plan, built once here,
                # overlapping device steps, and replayed every epoch
                t_pl = time.perf_counter()
                plan_np = build_plan_np(
                    Xp[:, cats_off:cats_off + p.n_cat], salts_np, p.n_dims, n,
                    vals=(Xp[:, cats_off + p.n_cat:] if p.value_weighted else None),
                    idx=idx_np)
                times["plan_s"] = times.get("plan_s", 0.0) + time.perf_counter() - t_pl
            plan_store = (None if plan_np is None
                          else _plan_device_form(codec, plan_np, pad_rows, p))
            if spill_active[0]:
                t_sp = time.perf_counter()
                spill.append(record_arrays(payload, yp, wp, plan_store), n)
                times["spill_s"] = times.get("spill_s", 0.0) + time.perf_counter() - t_sp
            return put_chunk(payload, n, yp, wp, plan_store)

        def host_chunks():
            """The rechunked host stream, with parse time attributed. Raw
            label-in-chunk arrays may come as ``(X, None, w)`` triples (a
            sharded source's), their weights a dead tail."""
            if p.label_in_chunk:
                it = _rechunk(((c, None) if isinstance(c, np.ndarray) else c
                               for c in source()), pad_rows)
            else:
                it = _rechunk(source(), pad_rows)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                times["parse_s"] += time.perf_counter() - t0
                yield item[0] if p.label_in_chunk and item[2] is None else item

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

        def _encode_s():
            """Host encode seconds so far, for the goodput accountant."""
            return pipe_stats.encode_s + times.get("plan_s", 0.0)

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
        epoch_collectives: list = []

        def close_epoch(wall):
            epoch_walls.append(wall)
            epoch_collectives.append(collective_stats())

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
                        times["disk_replay_group"] = group
                        for chunks in disk_group_iter(group, n_full):
                            if disk_replay is None:
                                disk_replay = _Replay(theta, opt_state,
                                                      [_chunk_slot(c) for c in chunks], step)
                            for slot, c in zip(disk_replay.chunks, chunks):
                                _fill_slot(slot, c)
                            if is_cuda and disk_replay.graph is None:
                                disk_replay.capture()   # once a fit, on filled slots
                            # bound_dispatch's waits and the epoch barrier
                            # feed the goodput here, as for the eager steps
                            disk_replay.run(1, timed=False)
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
                if stage_times is not None:
                    # only an explicit stage_times= caller pays a device
                    # synchronize an epoch for honest epoch walls
                    t_bar = time.perf_counter()
                    session.synchronize()
                    # an explicit barrier is synchronization, not device
                    # pace (the periodic wait charged that)
                    prof.note_sync(time.perf_counter() - t_bar, barrier=True)
                close_epoch(time.perf_counter() - t_epoch)
                if acc is not None:
                    # close the epoch's goodput window: its stage deltas
                    # and the bottleneck, classified with hysteresis
                    acc.epoch_boundary(epoch, encode_s=_encode_s())
                if (epoch == 0 and fuse_replay and cache.enabled and cache.batches
                        # whole epochs are the replay's resume grain: a
                        # snapshot off an epoch boundary takes the per-chunk
                        # replay, which skips at step grain
                        and resume_from % len(cache.batches) == 0):
                    # the remaining epochs: one captured epoch, replayed
                    # (when a snapshot covers them all, nothing runs and
                    # final_loss_ stays None)
                    t_rep = time.perf_counter()
                    replay = _Replay(theta, opt_state, cache.batches, step)
                    n_steps, last, graph_capture_s = replay_epochs(
                        replay, lambda: replay.losses[-1], p.epochs - 1 + (1 if defer else 0),
                        len(cache.batches), n_steps, capture=is_cuda,
                        granularity=p.replay_granularity,
                        epochs_per_dispatch=p.epochs_per_dispatch, resume_from=resume_from,
                        checkpointer=checkpointer, snapshot=snapshot, ckpt_meta=ckpt_meta,
                        every_epochs=ckpt_epochs)
                    if last is not None:
                        last_loss = last
                    if graph_capture_s is not None:
                        # replay_epochs charged the replays' device seconds
                        # and waited for the last; nothing is left queued
                        session.synchronize()
                        replay_fused_s = time.perf_counter() - t_rep
                        close_epoch(replay_fused_s)
                    if acc is not None and last is not None:
                        acc.epoch_boundary(p.epochs - 1, encode_s=_encode_s())
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
        # a model-split table is gathered once, so serving and saving see the
        # whole table
        theta = dict(theta, emb=_gather_table(theta["emb"], gang))
        if stage_times is not None or report is not None:
            # one stage dict feeds the caller's stage_times= and the report
            st = dict(times, encode_s=pipe_stats.encode_s)
            st.update(
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
                st.update(replay_fused_s=replay_fused_s, graph_capture_s=graph_capture_s)
            if cache_device:
                st.update(
                    cache_bytes=cache.nbytes, cache_chunks=len(cache.batches),
                    cache_raw_bytes=len(cache.batches) * _raw_chunk_bytes(
                        p, pad_rows, sparse_plan))
            if pipe_stats.items:
                st.update(overlap_pct=pipe_stats.overlap_pct,
                          prefetch_prep_s=pipe_stats.prep_s,
                          prefetch_wait_s=pipe_stats.wait_s)
            if report is not None:
                report.stage_times.update(st)
            if stage_times is not None:
                stage_times.update(st, epoch_collectives=epoch_collectives)
        model = HashedLinearModel(
            p, theta, salts_np,
            class_values or (tuple(str(i) for i in range(p.n_classes))
                             if p.loss == "logistic" else None))
        model.n_steps_ = n_steps
        model.final_loss_ = float(last_loss) if last_loss is not None else None
        model.device_chunks_ = cache.batches if cache_device else None
        model.holdout_chunks_ = holdout if holdout_chunks > 0 else None
        model.cache_codec_ = codec
        # ledger: the optimizer slots die with the fit — the entry shrinks
        # to the table and lives as long as the model (the abort guard
        # hands ownership to the model's finalizer)
        _state_guard.finalizer.detach()
        prof.ledger_set("model_state", state_key, prof.tree_device_bytes(theta))
        weakref.finalize(model, prof.ledger_release_on_gc, "model_state", state_key)
        # freeze the goodput decomposition and the ledger view into the
        # report; cache_key names this fit's cache entry
        prof.attach_fit_report(report, acc, encode_s=_encode_s(),
                               cache_key=cache.ledger_key)
        if report is not None:
            model.run_report_ = report.add(n_steps=n_steps).finish()
        if checkpointer is not None:
            checkpointer.delete()
        return model
