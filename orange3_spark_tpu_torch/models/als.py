"""ALS matrix factorization — parity with ``pyspark.ml.recommendation.ALS``.

Port of ``orange3_spark_tpu/models/als.py``. The ratings stay three vectors
(user, item, rating) of the table, never a dense matrix. Each half-step
solves every entity's normal equations A·x = b against the other side's
factors, with ALS-WR regularisation (λ·n_ratings) for explicit feedback
and MLlib's confidence weighting c = 1 + α|r| with the VᵀV base for
implicit feedback.

Where the reference forms per-rating outer products and segment-sums them
chunk by chunk (XLA), the port sorts the ratings by entity once a fit, per
side (``ops/normal_equations.sort_side``), and each half-step sums them in
one launch of a CUDA kernel (``normal_equations_sorted``; on the CPU its
plain version): no float atomics, nothing materialised, the reference's
chunk order. The rest of a half-step is torch: the VᵀV base
(``torch.mm``), the regulariser on the diagonal, one batched LU solve
(``torch.linalg.solve_ex``, which reads nothing on the host) and the
optional NNLS sweeps. A fit reads the device from the host once for the
index range, and once a side for the layout's work list (its long
segments), all before its first half-step.

The initial factors are |N(0, 1)|/√rank drawn as the reference draws
them, from JAX's threefry stream (``ops/prng.py``; on the card its
``threefry_bits`` kernel), on the fit's device: the bits are the
reference's, and the normals within a few ulp of its (``prng.normal``), so
a seeded fit is the reference's fit.

The session has one device and no mesh: ``factor_sharding`` 'auto' and
'replicated' keep the factors replicated, and 'model' raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params, append_columns
from orange3_spark_tpu_torch.ops import prng
from orange3_spark_tpu_torch.ops.normal_equations import normal_equations_sorted, sort_side

#: the most bytes of scores ``recommend_for_all_*`` holds at once (a row
#: block of the [n, m] product)
RECOMMEND_BLOCK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class ALSParams(Params):
    rank: int = 10                 # MLlib rank
    max_iter: int = 10             # MLlib maxIter
    reg_param: float = 0.1         # MLlib regParam (ALS-WR: scaled by n_ratings)
    implicit_prefs: bool = False   # MLlib implicitPrefs
    alpha: float = 1.0             # MLlib alpha (implicit confidence)
    nonnegative: bool = False      # MLlib nonnegative: batched NNLS solves
    nnls_sweeps: int = 48          # coordinate-descent sweeps per NNLS solve
    n_users: int = 0               # explicit user-dim (0 = infer from data max)
    n_items: int = 0               # explicit item-dim (0 = infer from data max)
    seed: int = 0                  # MLlib seed
    user_col: str = "user"         # MLlib userCol
    item_col: str = "item"         # MLlib itemCol
    rating_col: str = "rating"     # MLlib ratingCol
    cold_start_strategy: str = "nan"  # MLlib coldStartStrategy: 'nan' | 'drop'
    chunk_size: int = 1 << 18      # ratings per reference chunk (the sums' order)
    # 'auto' and 'replicated' keep the factors replicated on the one
    # device; 'model' needs a mesh with a model axis, which the port's
    # session does not have yet (it raises)
    factor_sharding: str = "auto"  # 'auto' | 'model' | 'replicated'


def _nnls_cd(A, b, x0, sweeps: int):
    """Batched NNLS: min_x 0.5 xᵀAx - bᵀx s.t. x >= 0, for PSD A.

    Cyclic projected coordinate descent (x_j <- max(0, x_j - g_j/A_jj)),
    ``sweeps`` full cycles over all entities at once, warm-started from the
    clipped unconstrained solve (the reference's algorithm, as torch ops
    on the device).

    A: [n, k, k], b: [n, k], x0: [n, k] -> [n, k]
    """
    k = b.shape[1]
    diag = torch.clamp_min(torch.diagonal(A, dim1=1, dim2=2), 1e-12)
    x = torch.clamp_min(x0, 0.0)
    for _ in range(sweeps):
        for j in range(k):
            g = (A[:, j, :] * x).sum(dim=1) - b[:, j]
            x[:, j] = torch.clamp_min(x[:, j] - g / diag[:, j], 0.0)
    return x


def _side_weights(rating, w, implicit: bool, alpha: float):
    """Each rating's weights for A, b and the count, by the reference's
    expressions: explicit (w, r·w, w), where the count's weight is A's and
    is given as None; implicit, with the confidence c = 1 + α|r| (negative
    feedback raises it too) and the preference p = [r > 0],
    ((c - 1)·w, c·p·w, w)."""
    if not implicit:
        return w, rating * w, None
    conf = 1.0 + alpha * torch.abs(rating)
    pref = (rating > 0).to(torch.float32)
    return (conf - 1.0) * w, conf * pref * w, w


def _side_plan(idx, other_idx, rating, w, n_entities: int, n_other: int,
               implicit: bool, alpha: float):
    """One side's ratings for its half-steps: ``plan(chunk)`` is their
    sorted layout (``sort_side``) for reference chunks of ``chunk``
    ratings, made on first use and kept, so once a fit."""
    aw, bw, cw = _side_weights(rating, w, implicit, alpha)
    return functools.cache(
        lambda chunk: sort_side(idx, other_idx, aw, bw, cw, n_entities, n_other, chunk))


def _solve_side(plan, other_factors, reg: float, implicit: bool, chunk: int,
                nonnegative: bool = False, nnls_sweeps: int = 48):
    """Normal-equation solve for one side given the other side's factors;
    ``plan``: the side's ``_side_plan``."""
    A, b, cnt = normal_equations_sorted(other_factors, plan(chunk))
    if implicit:
        # global VᵀV base + per-entry corrections already in A; plain lambda
        A += (other_factors.T @ other_factors)[None, :, :]
        reg_scale = torch.ones_like(cnt)
    else:
        reg_scale = cnt   # ALS-WR: lambda times the entity's rating count
    # the reference adds lam·max(scale, 1)·I; adding it to the diagonal
    # alone gives the same bits (A's off-diagonal zeros are never -0.0)
    A.diagonal(dim1=1, dim2=2).add_((reg * torch.clamp_min(reg_scale, 1.0))[:, None])
    x = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]   # [n_entities, k]
    if nonnegative:
        x = _nnls_cd(A, b, x, nnls_sweeps)
    return x


def _als_init(seed: int, n_users: int, n_items: int, rank: int, device="cpu"):
    """MLlib's init, |N(0, 1)|/√rank (initial predictions positive), as the
    reference draws it (``ops/prng.py``): ``key_u, key_v =
    split(PRNGKey(seed))``, U from key_u, V from key_v."""
    key_u, key_v = prng.split(prng.PRNGKey(seed))
    scale = math.sqrt(rank)
    U = prng.normal(key_u, (n_users, rank), device).abs_() / scale
    V = prng.normal(key_v, (n_items, rank), device).abs_() / scale
    return U, V


def _als_fit(user_idx, item_idx, rating, w, U, V, *, n_users: int,
             n_items: int, rank: int, max_iter: int, reg: float,
             implicit: bool, alpha: float, chunk: int,
             nonnegative: bool = False, nnls_sweeps: int = 48,
             factor_sharding=None):
    """``max_iter`` alternations from the initial factors ``U``, ``V``
    (tensors on the ratings' device): the user side, then the item side.
    Each side's ratings are sorted once, on its first half-step; no
    half-step after reads the device from the host. ``factor_sharding`` must be None (one device)."""
    if factor_sharding is not None:
        raise ValueError("_als_fit: the port runs on one device; factor_sharding "
                         "must be None")
    if U.shape != (n_users, rank) or V.shape != (n_items, rank):
        raise ValueError(f"_als_fit: factors {list(U.shape)} and {list(V.shape)} do not "
                         f"match ({n_users}, {rank}) and ({n_items}, {rank})")
    uplan = _side_plan(user_idx, item_idx, rating, w, n_users, n_items, implicit, alpha)
    iplan = _side_plan(item_idx, user_idx, rating, w, n_items, n_users, implicit, alpha)
    for _ in range(max_iter):
        U = _solve_side(uplan, V, reg, implicit, chunk, nonnegative, nnls_sweeps)
        V = _solve_side(iplan, U, reg, implicit, chunk, nonnegative, nnls_sweeps)
    return U, V


def _predict_pairs(U, V, user_idx, item_idx):
    """Σ_c U[u, c]·V[i, c] for each row, summed column by column (a row's
    bits depend on that row alone, at any row count)."""
    Ug, Vg = U.index_select(0, user_idx), V.index_select(0, item_idx)
    out = Ug[:, 0] * Vg[:, 0]
    for c in range(1, U.shape[1]):
        out = out + Ug[:, c] * Vg[:, c]
    return out


def _order_keys(scores, ids, m: int):
    """int64 keys whose descending order is score descending, then the
    lower id first. The score goes in the high half by the total order of
    its bits (-NaN < -inf < ... < +inf < NaN, ``lax.top_k``'s); the caller
    gives -0.0 as +0.0, so that equal scores tie."""
    bits = scores.contiguous().view(torch.int32)
    total = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return total.to(torch.int64) * (1 << 32) + (m - 1 - ids)


def _top_n(Q, K, n: int) -> np.ndarray:
    """Per row of ``Q``, the ids of the ``n`` rows of ``K`` with the
    highest ``Q @ Kᵀ`` score, as int32 numpy: score descending, and of
    equal scores the lower id first, ties at the n-th place included
    (``lax.top_k``'s order). The product is taken a block of rows of ``Q``
    at a time, at most ``RECOMMEND_BLOCK_BYTES`` of scores; each row's ids
    do not depend on the block.

    ``torch.topk`` picks each row's n + 1 best (its order among equal
    scores is not promised); the first n are sorted by ``_order_keys``. A
    row with a NaN among them, or whose n-th score equals its (n + 1)-th
    (a tie at the n-th place with a score left out), is picked again over
    the whole row by those keys. A zero score
    counts as +0.0: ``lax.top_k`` ranks -0.0 below +0.0, and which zeros
    carry a -0.0 depends on how a product kernel starts its sums (XLA's
    CPU GEMM from +0.0, as cuBLAS and the CPU BLAS; its rank-1 and
    one-row products keep a product's -0.0), so only there do the two
    packages' ids part."""
    rows, m = Q.shape[0], K.shape[0]
    block = max(1, RECOMMEND_BLOCK_BYTES // (4 * max(m, 1)))
    out = torch.empty((rows, n), dtype=torch.int32, device=Q.device)
    Kt = K.T
    for s in range(0, rows, block):
        S = Q[s:s + block] @ Kt
        vals, ids = torch.topk(S, min(n + 1, m), dim=1)
        # torch.topk takes a NaN as the largest score
        redo = torch.isnan(vals).any(dim=1)
        if m > n > 0:
            redo |= vals[:, n] == vals[:, n - 1]
        vals, ids = vals[:, :n], ids[:, :n]
        ids = ids.gather(1, torch.argsort(_order_keys(vals + 0.0, ids, m), dim=1,
                                          descending=True))
        if n > 0:
            redo = torch.nonzero(redo).flatten()
            if redo.numel():
                every = torch.arange(m, device=Q.device).expand(redo.numel(), m)
                keys = _order_keys(S.index_select(0, redo) + 0.0, every, m)
                ids[redo] = torch.topk(keys, n, dim=1).indices
        out[s:s + block] = ids
    return out.cpu().numpy()


class ALSModel(Model):
    def __init__(self, params, user_factors, item_factors):
        self.params = params
        self.user_factors = user_factors  # f32[n_users, k]
        self.item_factors = item_factors  # f32[n_items, k]

    @property
    def state_pytree(self):
        return {"user_factors": self.user_factors, "item_factors": self.item_factors}

    def _cols(self, table: TorchTable):
        p = self.params
        u = table.column(p.user_col).to(torch.int32)
        i = table.column(p.item_col).to(torch.int32)
        return u, i

    def transform(self, table: TorchTable) -> TorchTable:
        """Append 'prediction' (Spark: predicted rating per (user,item) row).

        Cold-start rows (unseen user/item index) follow cold_start_strategy:
        'nan' marks them NaN; 'drop' zero-weights them (static shapes — the
        Spark row-drop equivalent under the filter semantics).
        """
        u, i = self._cols(table)
        n_u = self.user_factors.shape[0]
        n_i = self.item_factors.shape[0]
        pred = _predict_pairs(self.user_factors, self.item_factors,
                              torch.clamp(u, 0, n_u - 1), torch.clamp(i, 0, n_i - 1))
        cold = (u < 0) | (u >= n_u) | (i < 0) | (i >= n_i)
        W = table.W
        if self.params.cold_start_strategy == "drop":
            W = torch.where(cold, 0.0, W)
        else:
            pred = torch.where(cold, torch.nan, pred)
        out = append_columns(table, [pred[:, None]], [ContinuousVariable("prediction")])
        return out.with_weights(W)

    def recommend_for_all_users(self, num_items: int) -> np.ndarray:
        """Top-N items per user: U @ Vᵀ in row blocks, best first, the
        lower id first among equal scores (``_top_n``).

        Returns int32 [n_users, num_items]. (MLlib recommendForAllUsers.)
        """
        return _top_n(self.user_factors, self.item_factors, num_items)

    def recommend_for_all_items(self, num_users: int) -> np.ndarray:
        return _top_n(self.item_factors, self.user_factors, num_users)


class ALS(Estimator):
    ParamsCls = ALSParams
    params: ALSParams

    def _fit(self, table: TorchTable) -> ALSModel:
        p = self.params
        u = table.column(p.user_col).to(torch.int32)
        i = table.column(p.item_col).to(torch.int32)
        r = table.column(p.rating_col)
        # one device->host read for the observed index range; with explicit
        # dims it becomes a RANGE CHECK (a fit that silently clipped or
        # under-sized its factor tables would be quietly wrong)
        live = table.W > 0
        max_u, max_i = (int(v) for v in torch.stack(
            [torch.where(live, u, 0).max(), torch.where(live, i, 0).max()]).cpu())
        if p.n_users > 0:
            if max_u >= p.n_users:
                raise ValueError(
                    f"user index {max_u} out of range for n_users={p.n_users}"
                )
            n_users = p.n_users
        else:
            n_users = max_u + 1
        if p.n_items > 0:
            if max_i >= p.n_items:
                raise ValueError(
                    f"item index {max_i} out of range for n_items={p.n_items}"
                )
            n_items = p.n_items
        else:
            n_items = max_i + 1
        if p.factor_sharding not in ("auto", "model", "replicated"):
            raise ValueError(
                f"factor_sharding must be 'auto' | 'model' | 'replicated', "
                f"got {p.factor_sharding!r}")
        if p.factor_sharding == "model":
            raise ValueError(
                "factor_sharding='model' needs a session mesh with a model "
                "axis wider than 1; the port's session is one device with no "
                "mesh")
        dev = table.session.device
        U0, V0 = _als_init(p.seed, n_users, n_items, p.rank, dev)
        U, V = _als_fit(
            u, i, r, table.W, U0, V0,
            n_users=n_users, n_items=n_items, rank=p.rank, max_iter=p.max_iter,
            reg=p.reg_param, implicit=p.implicit_prefs, alpha=p.alpha,
            chunk=min(p.chunk_size, table.n_pad),
            nonnegative=p.nonnegative, nnls_sweeps=p.nnls_sweeps,
        )
        return ALSModel(p, U, V)


def ratings_table(ratings: np.ndarray, session=None, *,
                  user_col="user", item_col="item", rating_col="rating") -> TorchTable:
    """[n,3] (user, item, rating) float array -> ALS-ready TorchTable."""
    domain = Domain([
        ContinuousVariable(user_col),
        ContinuousVariable(item_col),
        ContinuousVariable(rating_col),
    ])
    return TorchTable.from_numpy(domain, ratings, session=session)
