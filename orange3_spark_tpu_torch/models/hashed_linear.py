"""Hashed-sparse linear models — the Criteo-scale categorical path.

BASELINE config 2 (the headline metric) is Criteo click-through: 13 dense
numerics and 26 categoricals hashed into millions of dimensions, fit with
logistic regression over a CSV stream.

* Every row has EXACTLY ``n_cat`` categorical slots, so the sparse
  structure is two fixed-shape arrays: raw codes [N, C] (hashed to indices
  on the device, ops/hashing.py) and an embedding table [n_dims, k]. The
  forward is an embedding gather and sum plus a small matmul for the dense
  block.
* Binary targets use the k = 1 sigmoid form (``binary_logistic``): the
  optimum of the 2-column softmax at half the gather and update bytes.
* A chunk arrives as ONE [N, 1 + n_dense + n_cat] f32 array from fastcsv,
  label column included (``label_in_chunk``): the host does no per-cell
  work and the copy to the device is one transfer; the split into label,
  dense and categorical columns happens on the device. Padding rows are
  masked by ``n_valid``, not by a shipped weight vector.
* Epoch 1 streams: parse, pad and the copy of chunk t+1 run on a prefetch
  thread (io/streaming.py ``prefetch_map``) while the device runs step t.
* ``cache_device=True`` keeps each chunk on the device and replays the
  cache for epochs 2+, with no host work (Spark's ``persist()`` before an
  iterative fit). A stream that outgrows ``cache_device_bytes`` degrades to
  streaming every epoch: a partial replay would reorder chunks.
* Epochs 2+ replay the cached chunks one step per chunk, in the order of
  the JAX package's replay scan, so the step sequence is the same.

The update rules are optim/sparse.py's ``{dense,sparse}_{sgd,adagrad,
ftrl}`` with a float32 chunk cache. Not in this package yet (each raises
``NotImplementedError`` where a parameter asks for it): the 'adam' rule,
the 'per_column' and 'sorted' ``emb_update`` lowerings, value-weighted
rows, ``missing='keep'``, compressed caches (``cache_dtype`` other than
'f32'), ``defer_epoch1``, a compute dtype other than float32, disk spill
and checkpoints. ``fused_replay``, ``replay_granularity`` and
``epochs_per_dispatch`` choose how the JAX package dispatches the replay;
here every replay epoch runs per chunk, with the same steps.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Iterator

import numpy as np
import torch
from torch.profiler import record_function

from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.exec.pipeline import PipelineStats
from orange3_spark_tpu_torch.models._linear import (
    EPS_TOTAL_WEIGHT, per_row_loss, per_row_loss_grad,
)
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params
from orange3_spark_tpu_torch.ops.hashing import (
    column_salts, hash_columns, salts_tensor,
)
from orange3_spark_tpu_torch.optim.sparse import (
    build_plan_np, dense_update, finalize_lazy_decay, init_optim_state,
    is_sparse_update, optim_kind, resolve_optim_update, resolve_sparse_lowering,
    sparse_embedding_update,
)

AUC_BINS = 4096
#: the profiler ranges of ``_step_core``, in step order
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
    reg_param: float = 0.0       # decoupled weight decay (ftrl: closed-form L2)
    chunk_rows: int = 1 << 18
    threshold: float = 0.5
    seed: int = 0
    compute_dtype: str = "float32"
    label_in_chunk: bool = False  # chunks carry the label as column 0
    prefetch_depth: int = 2       # host->device pipeline depth (0 disables)
    emb_update: str = "auto"     # 'auto' | 'fused' (| 'per_column' | 'sorted')
    optim_update: str = "adam"   # '{dense,sparse}_{sgd,adagrad,ftrl}' (| 'adam')
    sparse_lowering: str = "auto"   # 'auto' | 'plan' | 'sort'
    l1_param: float = 0.0        # FTRL-proximal l1 (ftrl rules only)
    fused_replay: bool = True
    replay_granularity: str = "all"
    epochs_per_dispatch: int = 1
    defer_epoch1: bool = False
    checkpoint_every_epochs: int = 0
    value_weighted: bool = False
    # 'zero': NaN dense cells -> 0 and NaN categorical cells -> the reserved
    # code 0, on the device
    missing: str = "zero"        # 'zero' (| 'keep')
    cache_dtype: str = "f32"     # 'f32' (| 'bf16' | 'packed' | 'auto')


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


def _check_ported(p: HashedLinearParams, optim: str) -> None:
    """Raise on a parameter value whose path this package does not run yet."""
    missing = [
        (optim == "adam", "optim_update='adam' (use a dense_* or sparse_* rule)"),
        (resolve_emb_update(p) != "fused", f"emb_update={p.emb_update!r}"),
        (p.value_weighted, "value_weighted=True"),
        (not _impute_flag(p), f"missing={p.missing!r}"),
        (p.cache_dtype != "f32", f"cache_dtype={p.cache_dtype!r}"),
        (p.defer_epoch1, "defer_epoch1=True"),
        (p.compute_dtype != "float32", f"compute_dtype={p.compute_dtype!r}"),
    ]
    names = [name for hit, name in missing if hit]
    if names:
        raise NotImplementedError(
            "not ported to orange3_spark_tpu_torch yet: " + ", ".join(names))


def _hashed_logits(theta: dict, dense: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, k] logits: the 'fused' form, one gather of the [N, C] embedding
    rows summed over the columns, plus the dense block's matmul."""
    emb = theta["emb"]
    N, C = idx.shape
    rows = emb.index_select(0, idx.reshape(-1)).view(N, C, emb.shape[1])
    logits = rows.sum(dim=1)
    if theta["coef"].shape[0]:
        logits = logits + dense @ theta["coef"]
    return logits + theta["intercept"]


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
        wv = (torch.arange(Xall.shape[0], device=Xall.device) < n_valid).to(torch.float32)
    else:
        yv, feat, wv = y, Xall, w
    dense, cats = feat[:, :n_dense], feat[:, n_dense:]
    if impute_missing:
        dense = torch.where(torch.isnan(dense), 0.0, dense)
        cats = torch.where(torch.isnan(cats), 0.0, cats)
    return yv, dense, cats, wv


def _step_core(theta: dict, opt_state: dict, Xall, n_valid, y, w, salts, reg: float,
               lr: float, plan=None, l1: float = 0.0, *, loss_kind: str, n_dims: int,
               n_dense: int, label_in_chunk: bool = False, impute_missing: bool = False,
               optim_update: str, sparse_lowering: str = "none",
               use_decay: bool = False):
    """One optimizer step on one chunk. Returns (theta, opt_state, loss).

    The rules report the pure data loss and treat ``reg`` as decoupled
    weight decay. The sparse rules update only the touched rows, with
    ``plan`` carrying the host-built dedup under the 'plan' lowering; the
    dense twins add every occurrence's gradient into a full-table gradient
    (``index_add_`` in occurrence order) and sweep the whole table.

    Its stages run in profiler ranges named by ``STEP_STAGES``, so a
    profile of the step gives each stage's device time."""
    kind = optim_kind(optim_update)
    decay = float(np.float32(1.0) - np.float32(lr) * np.float32(reg))
    step = opt_state["step"]
    slots = opt_state["slots"]
    with record_function("split_hash"):
        yv, dense, cats, wv = _split_chunk(
            Xall, n_valid, y, w, label_in_chunk=label_in_chunk, n_dense=n_dense,
            impute_missing=impute_missing)
        idx = hash_columns(cats, salts, n_dims)
    with record_function("forward"):
        logits = _hashed_logits(theta, dense, idx)
    with record_function("loss_grad"):
        sw = torch.clamp_min(wv.sum(), EPS_TOTAL_WEIGHT)
        loss = (per_row_loss(loss_kind, logits, yv) * wv).sum() / sw
        dl = per_row_loss_grad(loss_kind, logits, yv) * (wv / sw)[:, None]   # [N, k]
        g_coef = dense.T @ dl
        g_int = dl.sum(dim=0)
    with record_function("embedding_update"):
        if is_sparse_update(optim_update):
            emb, t, eslots = sparse_embedding_update(
                kind, theta["emb"], opt_state["t"], slots["emb"], dl, idx, lr, decay,
                reg, l1, step, lowering=sparse_lowering, use_decay=use_decay, plan=plan,
                n_valid=n_valid)
        else:
            N, C = idx.shape
            g_emb = torch.zeros_like(theta["emb"]).index_add_(
                0, idx.reshape(-1),
                dl[:, None, :].expand(N, C, dl.shape[1]).reshape(N * C, -1))
            t = opt_state["t"]
            emb, eslots = dense_update(kind, theta["emb"], slots["emb"], g_emb, lr,
                                       decay, reg, l1, use_decay=use_decay)
    with record_function("dense_update"):
        coef, cslots = dense_update(kind, theta["coef"], slots["coef"], g_coef, lr,
                                   decay, reg, l1, use_decay=use_decay)
        intercept, islots = dense_update(kind, theta["intercept"], slots["intercept"],
                                         g_int, lr, decay, reg, l1, use_decay=False)
    theta = {"emb": emb, "coef": coef, "intercept": intercept}
    opt_state = {"step": step + 1, "t": t,
                 "slots": {"emb": eslots, "coef": cslots, "intercept": islots}}
    return theta, opt_state, loss


def _hashed_predict(theta, Xall, salts, *, n_dims: int, n_dense: int,
                    impute_missing: bool = False) -> torch.Tensor:
    _, dense, cats, _ = _split_chunk(Xall, 0, None, None, label_in_chunk=False,
                                     n_dense=n_dense, impute_missing=impute_missing)
    return _hashed_logits(theta, dense, hash_columns(cats, salts, n_dims))


def _hashed_eval_chunk(theta, Xall, n_valid, y, w, salts, *, loss_kind: str,
                       n_dims: int, n_dense: int, label_in_chunk: bool,
                       impute_missing: bool = False):
    """Device-side eval accumulators of one chunk: (weighted logloss sum,
    weighted correct sum, weight sum, pos/neg score histograms for AUC).
    Only these small tensors ever go back to the host."""
    yv, dense, cats, wv = _split_chunk(
        Xall, n_valid, y, w, label_in_chunk=label_in_chunk, n_dense=n_dense,
        impute_missing=impute_missing)
    logits = _hashed_logits(theta, dense, hash_columns(cats, salts, n_dims))
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

    @property
    def state_pytree(self) -> dict:
        return dict(self.theta)

    @property
    def device(self) -> torch.device:
        return self.theta["emb"].device

    @property
    def _binary(self) -> bool:
        return _row_loss_kind(self.params) == "binary_logistic"

    def _logits(self, Xall: np.ndarray) -> np.ndarray:
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

    def eval_accumulators(self, device_chunks) -> tuple:
        """Sums of ``_hashed_eval_chunk`` over device chunks (as a cached fit
        keeps them: (Xall, n_valid, y, w[, plan]) tuples), on the device."""
        p = self.params
        salts = salts_tensor(self.salts, self.device)
        tot = None
        for chunk in device_chunks:
            Xd, n_valid, yd, wd = chunk[:4]
            out = _hashed_eval_chunk(
                self.theta, Xd, n_valid, yd, wd, salts, loss_kind=_row_loss_kind(p),
                n_dims=p.n_dims, n_dense=p.n_dense, label_in_chunk=p.label_in_chunk,
                impute_missing=_impute_flag(p))
            tot = out if tot is None else tuple(a + b for a, b in zip(tot, out))
        if tot is None:
            raise ValueError("no chunks to evaluate")
        return tot

    def evaluate_device(self, device_chunks) -> dict:
        """Evaluate over device-resident chunks (``fit_stream(...,
        cache_device=True)``'s ``device_chunks_`` or ``holdout_chunks_``).
        All reduction happens on the device; five small tensors come back
        at the end."""
        loss_sum, correct, wsum, pos, neg = (
            a.cpu().numpy() for a in self.eval_accumulators(device_chunks))
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
    starts: a zero theta, the rule's zero state and the numpy salts, so two
    fits (or this package and the JAX package) compare step for step."""
    optim = resolve_optim_update(p.optim_update)
    _check_ported(p, optim)
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
        use_decay=(p.reg_param != 0.0 and optim_kind(optim) != "ftrl"),
    )
    return theta, opt_state, salts_np, salts_tensor(salts_np, dev), static_kw


class _HostToDevice:
    """Copies of host arrays to the device, made on the prefetch thread.
    On CUDA each array goes through a pinned staging buffer and is copied
    with ``non_blocking`` on a copy stream; ``done()`` records an event
    after the copies and ``ready(chunk, event)`` makes the compute stream
    wait for it. Each array gets its own staging buffer from PyTorch's
    pinned-memory cache, which does not hand a buffer out again before the
    copy that reads it has finished. On the CPU a chunk's tensors share the
    host arrays' memory (nothing writes to them)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(self, a: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(a))
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
    def ready(chunk: tuple, event) -> tuple:
        """Make the current stream wait for ``chunk``'s copies, and tell the
        allocator the chunk's memory is in use there."""
        if event is None:
            return chunk
        stream = torch.cuda.current_stream()
        stream.wait_event(event)

        def mark(x):
            if isinstance(x, torch.Tensor):
                x.record_stream(stream)
            elif isinstance(x, dict):
                for v in x.values():
                    mark(v)

        for x in chunk:
            mark(x)
        return chunk


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

    def fit_stream(self, source: Callable[[], Iterator], *,
                   session: TorchSession | None = None,
                   class_values: tuple | None = None, cache_device: bool = False,
                   cache_device_bytes: int = 8 << 30, holdout_chunks: int = 0,
                   stage_times: dict | None = None) -> HashedLinearModel:
        """Fit over a re-iterable chunk source.

        cache_device: keep the device chunks of epoch 1 and replay them for
          epochs 2+. If the stream outgrows ``cache_device_bytes`` the fit
          degrades to re-running the source every epoch (a warning says
          so). The cached list is ``model.device_chunks_``.
        holdout_chunks: keep the LAST n device chunks of each epoch out of
          training; with cache_device they are kept on the device as
          ``model.holdout_chunks_`` for ``evaluate_device``.
        stage_times: receives host stage seconds ('parse_s', 'h2d_s',
          accumulated on the prefetch thread, so they overlap device work)
          and 'epoch_s', one wall per epoch, each ended by a device
          synchronize; plus the resolved rule, lowering and cache figures.
        """
        from orange3_spark_tpu_torch.io.streaming import (
            _DeviceCache, _pad_chunk, _rechunk, prefetch_map, warn_cache_overflow,
        )

        p = self.params
        session = session or TorchSession.active()
        theta, opt_state, salts_np, salts, static_kw = _init_fit_state(p, session)
        pad_rows = session.pad_rows(p.chunk_rows)
        n_cols = _chunk_cols(p)
        reg, lr, l1 = (float(np.float32(v)) for v in
                       (p.reg_param, p.step_size, p.l1_param))
        optim_resolved = static_kw["optim_update"]
        sparse_plan = static_kw["sparse_lowering"] == "plan"
        cats_off = (1 if p.label_in_chunk else 0) + p.n_dense
        times = {"parse_s": 0.0, "h2d_s": 0.0} if stage_times is not None else None
        pipe_stats = PipelineStats()
        h2d = _HostToDevice(session.device)

        def to_device(host_chunk):
            """Prefetch-thread side: pad, build the plan, copy to the device."""
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
            plan_np = None
            if sparse_plan:
                # the host-sorted touched-row plan, built once here,
                # overlapping device steps, and replayed every epoch
                plan_np = build_plan_np(Xp[:, cats_off:cats_off + p.n_cat], salts_np,
                                        p.n_dims, n,
                                        impute_missing=static_kw["impute_missing"])
            t0 = time.perf_counter()
            out = (h2d.put(Xp), n,
                   None if yp is None else h2d.put(yp),
                   None if wp is None else h2d.put(wp))
            if plan_np is not None:
                out = out + ({k: h2d.put(v) for k, v in plan_np.items()},)
            event = h2d.done()
            if times is not None:
                times["h2d_s"] += time.perf_counter() - t0
            return out, event

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

        def device_chunk_iter():
            if p.prefetch_depth > 0:
                staged = prefetch_map(to_device, host_chunks(), depth=p.prefetch_depth,
                                      stats_into=pipe_stats)
            else:
                staged = (to_device(c) for c in host_chunks())
            for chunk, event in staged:
                yield h2d.ready(chunk, event)

        cache = _DeviceCache(cache_device, cache_device_bytes,
                             may_exclude_tail=holdout_chunks)
        holdout: list = []
        n_steps = 0
        last_loss = None

        def run_step(dev_chunk):
            nonlocal theta, opt_state, n_steps, last_loss
            Xd, n_valid, yd, wd = dev_chunk[:4]
            plan = dev_chunk[4] if len(dev_chunk) > 4 else None
            theta, opt_state, last_loss = _step_core(
                theta, opt_state, Xd, n_valid, yd, wd, salts, reg, lr, plan, l1,
                **static_kw)
            n_steps += 1

        epoch_walls: list = []
        for epoch in range(p.epochs):
            t_epoch = time.perf_counter()
            if epoch == 0 or not cache.enabled:
                # stream from the source; a look-ahead window keeps the last
                # holdout_chunks device chunks out of training
                window: list = []
                for dev_chunk in device_chunk_iter():
                    if epoch == 0:
                        cache.offer(dev_chunk)
                    if holdout_chunks > 0:
                        window.append(dev_chunk)
                        if len(window) <= holdout_chunks:
                            continue
                        dev_chunk = window.pop(0)
                    run_step(dev_chunk)
                if epoch == 0:
                    if holdout_chunks > 0:
                        holdout = window[-holdout_chunks:]
                        if cache.enabled:
                            # the tail lives in the cache too: never replay it
                            cache.exclude({id(c[0]) for c in holdout})
                            cache.forgive_tail(holdout_chunks)
                    cache.settle()
                    if cache.degraded and p.epochs > 1:
                        warn_cache_overflow(cache_device_bytes, p.epochs - 1)
            else:
                for dev_chunk in cache.batches:   # replay: no host work at all
                    run_step(dev_chunk)
            if times is not None:
                session.synchronize()   # an honest epoch wall
                epoch_walls.append(time.perf_counter() - t_epoch)

        if last_loss is not None and not (
                math.isfinite(float(last_loss))
                and bool(torch.isfinite(theta["emb"]).all())):
            raise FloatingPointError(
                f"StreamingHashedLinearEstimator diverged: final loss "
                f"{float(last_loss)} after {n_steps} steps")
        # settle the decay the table still owes, so the returned model
        # equals the dense schedule's
        theta = finalize_lazy_decay(theta, opt_state, lr, reg, optim_resolved)
        if stage_times is not None:
            stage_times.update(times)
            stage_times.update(
                optim_update=optim_resolved, sparse_lowering=static_kw["sparse_lowering"],
                cache_dtype="f32", epoch_s=epoch_walls, cache_overflow=cache.degraded,
                replay_source=(None if p.epochs <= 1 else
                               "hbm" if cache.enabled else "stream"))
            if cache_device:
                stage_times.update(cache_bytes=cache.nbytes,
                                   cache_chunks=len(cache.batches))
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
        return model

