"""KMeans — parity with ``pyspark.ml.clustering.KMeans``.

Port of ``orange3_spark_tpu/models/kmeans.py``:

* assignment = argmin of |x|² - 2x·c + |c|². The cross term and the
  squared norms are summed column by column (``models/_linear.row_products``),
  so a row's distances, and with them its cluster id, are the same bits on
  the CPU and the card at any row count: a served bucket equals the raw
  predict bitwise;
* center update = one-hot(assign)ᵀ @ X, one product;
* the eager fit runs Lloyd's loop on the host and reads the convergence
  flag once an iteration (the MLlib test: every center moved less than
  tol). Inside a staged refit (``models.base.staging``) nothing may wait
  for the device, so the loop runs all ``max_iter`` iterations and a
  device-side ``done`` flag freezes the centers once they converged and
  stops counting ``n_iter``: the same centers, cost and count, bit for bit.

Init. The eager init is host numpy in both packages: ``rng.choice`` over
the live rows' indices, then kmeans++ (``kmeanspp_seed``) in float64 on
that sample. Given the same indices it seeds the same centers bitwise.
Under a staged refit the init runs on the device (``_device_init_centers``):
a gumbel-max top-k sample of live rows and categorical D² sampling as
argmax(logits + gumbel), every draw the reference's (``ops/prng.py``:
JAX's threefry stream from ``PRNGKey(params.seed)``, its keys split on the
host, its draws on the device with no host read). Every call, and every
replay of a captured refit, draws the same numbers, and they seed the
reference's device-init centers (its gumbels and normals within a few
ulp).

``n_init > 1``: one fit per seed in a loop (a ``vmap`` in the reference);
the lowest cost wins, the first on a tie (``argmin``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import DiscreteVariable, Domain
from orange3_spark_tpu_torch.core.fmath import sqrt32
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models._linear import row_products
from orange3_spark_tpu_torch.models.base import (
    Estimator, Model, Params, concrete_or_none, staging_active,
)
from orange3_spark_tpu_torch.ops import prng


@dataclasses.dataclass(frozen=True)
class KMeansParams(Params):
    k: int = 2                    # MLlib k
    max_iter: int = 20            # MLlib maxIter
    tol: float = 1e-4             # MLlib tol (center movement)
    init_mode: str = "k-means||"  # MLlib initMode: 'random' | 'k-means||'
    seed: int = 0                 # MLlib seed
    n_init: int = 1               # restarts, best cost wins (beyond MLlib)
    init_sample_size: int = 8192  # host sample for the ++-style init
    compute_dtype: str = "float32"


def _dtype(name) -> torch.dtype:
    return getattr(torch, str(name))


def live_cluster_sizes(W, assign, num_segments: int):
    """MLlib ``summary.clusterSizes``: live ROW counts per cluster (Spark
    counts rows, not weights; W only gates padding/filtered membership).
    A reduction over the [N, k] membership mask, exact in f32 up to 2^24
    rows a cluster (a scatter-add into k slots would serialize on atomics)."""
    member = assign.to(torch.int64)[:, None] == torch.arange(num_segments, device=W.device)
    return (member & (W > 0)[:, None]).sum(dim=0).to(torch.float32)


def _row_sq(X: torch.Tensor) -> torch.Tensor:
    """Σ_j x_j² per row, column by column in order (see ``row_products``)."""
    out = X[:, 0] * X[:, 0]
    for j in range(1, X.shape[1]):
        out = out + X[:, j] * X[:, j]
    return out


def _assign(X, centers, w, compute_dtype=torch.float32):
    """Nearest-center ids (int32) + weighted cost, by the matmul identity."""
    if compute_dtype == torch.float32:
        cross = row_products(X, centers.T)
    else:   # the reference's dot of rounded operands with an f32 result
        cross = row_products(X.to(compute_dtype).to(torch.float32),
                             centers.to(compute_dtype).to(torch.float32).T)
    d2 = _row_sq(X)[:, None] - 2.0 * cross + _row_sq(centers)
    mind2, assign = torch.min(d2, dim=1)
    return assign.to(torch.int32), (mind2 * w).sum()


def _lloyd_step(X, w, centers, tol, k, compute_dtype, wide_sums=False):
    """One Lloyd iteration: (new centers, converged as a device bool).
    ``wide_sums``: the clusters' sums and weights in float64, each center
    rounded once to float32. cuBLAS and the CPU's BLAS sum in other
    orders, and in float32 those orders part the centers by ulps that,
    over the iterations, move points near a boundary to another cluster
    (5 of 200,000 taxi rows, centers 3.3e-4 apart); in float64 both round
    to the same centers (the assignment is bitwise on both devices
    already). KMeans takes it; PIC's and the bisecting splits' 1-D and
    2-centre runs keep the reference's float32 sums."""
    assign, _ = _assign(X, centers, w, compute_dtype)
    acc = torch.float64 if wide_sums else torch.float32
    onehot = (assign[:, None] == torch.arange(k, dtype=torch.int32, device=X.device)
              ).to(acc) * w[:, None].to(acc)
    sums = onehot.T @ X.to(acc)
    counts = onehot.sum(dim=0)
    new = torch.where(counts[:, None] > 0,
                      (sums / torch.clamp_min(counts, 1e-12)[:, None]).to(torch.float32),
                      centers)
    move = sqrt32(((new - centers) ** 2).sum(dim=1))
    return new, torch.all(move < tol)


def _lloyd(X, w, centers0, tol, *, k: int, max_iter: int,
           compute_dtype=torch.float32, wide_sums: bool = False):
    """Lloyd's loop on the host: one flag read an iteration. Returns
    (centers, assign, cost, n_iter) with n_iter an int."""
    centers, n_iter = centers0, 0
    while n_iter < max_iter:
        centers, converged = _lloyd_step(X, w, centers, tol, k, compute_dtype, wide_sums)
        n_iter += 1
        if bool(converged):
            break
    assign, cost = _assign(X, centers, w, compute_dtype)
    return centers, assign, cost, n_iter


def _lloyd_fixed(X, w, centers0, tol, *, k: int, max_iter: int,
                 compute_dtype=torch.float32, wide_sums: bool = False):
    """The same loop with a fixed trip count and no host read: ``max_iter``
    iterations, the centers frozen by a device ``done`` flag once they
    converged. Bitwise ``_lloyd``'s centers, assignment, cost and count
    (n_iter an int32 device scalar)."""
    centers = centers0
    done = torch.zeros((), dtype=torch.bool, device=X.device)
    n_iter = torch.zeros((), dtype=torch.int32, device=X.device)
    for _ in range(max_iter):
        new, converged = _lloyd_step(X, w, centers, tol, k, compute_dtype, wide_sums)
        centers = torch.where(done, centers, new)
        n_iter = n_iter + (~done).to(torch.int32)
        done = done | converged
    assign, cost = _assign(X, centers, w, compute_dtype)
    return centers, assign, cost, n_iter


def kmeanspp_seed(sample: np.ndarray, k: int, rng) -> np.ndarray:
    """kmeans++ seeding on a host-side sample -> f32[k, d] centers.

    Distances/probabilities run in float64 (float32 D² vectors can fail
    numpy's choice() sum-to-1 tolerance on large samples) and the result is
    jitter-padded when the sample has fewer than k distinct points (exact
    duplicate centers would never win an argmin tie and stay empty forever).
    The JAX package's function, line for line: shared by KMeans._init_centers
    and io.streaming.StreamingKMeans.
    """
    sample = np.asarray(sample, dtype=np.float64)
    m = len(sample)
    centers = [sample[rng.integers(m)]]
    d2 = np.sum((sample - centers[0]) ** 2, axis=1)
    for _ in range(1, min(k, m)):
        s = d2.sum()
        if s > 0:
            p = d2 / s
            p = p / p.sum()  # exact renormalization for choice()
            centers.append(sample[rng.choice(m, p=p)])
        else:  # all remaining points identical to a seed: pick uniformly
            centers.append(sample[rng.integers(m)])
        d2 = np.minimum(d2, np.sum((sample - centers[-1]) ** 2, axis=1))
    out = np.stack(centers)
    if out.shape[0] < k:  # fewer rows than k: pad with PER-ROW random jitter
        extra = out[rng.integers(out.shape[0], size=k - out.shape[0])]
        # jitter scaled to the value's magnitude (an absolute 1e-3 rounds
        # away in float32 when |center| ~ 1e5+)
        jitter = rng.normal(size=extra.shape) * 1e-3 * (1.0 + np.abs(extra))
        out = np.concatenate([out, extra + jitter], axis=0)
    return out.astype(np.float32)


class KMeansModel(Model):
    def __init__(self, params, centers):
        self.params = params
        self.centers = centers  # f32[k, d]
        self.n_iter_: int | None = None
        self.training_cost_: float | None = None  # MLlib summary.trainingCost

    @property
    def state_pytree(self):
        return {"centers": self.centers}

    @property
    def cluster_centers_(self) -> np.ndarray:
        return self.centers.cpu().numpy()

    def predict(self, table: TorchTable) -> np.ndarray:
        assign, _ = _assign(table.X, self.centers, table.W)
        return assign[: table.n_rows].cpu().numpy()

    def _device_predict(self, table: TorchTable):
        """Serving hook (serve/context.py): per-row cluster ids on the
        device. Row-wise, so bucket padding cannot perturb live rows."""
        assign, _ = _assign(table.X, self.centers, table.W)
        return assign

    def compute_cost(self, table: TorchTable) -> float:
        _, cost = _assign(table.X, self.centers, table.W)
        return float(cost)

    def transform(self, table: TorchTable) -> TorchTable:
        """Append the 'cluster' prediction column (Spark's predictionCol)."""
        assign, _ = _assign(table.X, self.centers, table.W)
        k = self.centers.shape[0]
        new_attrs = list(table.domain.attributes) + [
            DiscreteVariable("cluster", tuple(str(i) for i in range(k)))]
        new_domain = Domain(new_attrs, table.domain.class_vars, table.domain.metas)
        X = torch.cat([table.X, assign[:, None].to(torch.float32)], dim=1)
        return table.with_X(X, new_domain)


# ------------------------------------------------------------ device init
def _row(X: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a 0-d device index) of X with no host read (``X[i]``
    would read i on the host)."""
    return X.index_select(0, i.reshape(1))[0]


def device_sample_live(X, W, cap: int, key):
    """A uniform subsample of up to ``cap`` LIVE rows (gumbel-max top-k over
    the live mask), on the device with no host read: the device twin of
    the eager init's host sampling. Returns (Xs [cap, d], Ws [cap]) where
    picks past the live count carry Ws = 0."""
    N = X.shape[0]
    g = torch.where(W > 0, prng.gumbel(key, (N,), X.device), -math.inf)
    gv, idx = torch.topk(g, min(cap, N))
    return X[idx], torch.isfinite(gv).to(torch.float32)


def device_d2_seed(X, W, k: int, k0, k1) -> torch.Tensor:
    """Categorical D² sampling (kmeans++) on the device with no host read:
    each draw is ``prng.categorical`` of log D² (argmax of logits + gumbel),
    the chain of keys the reference's ``fori_loop`` splits."""
    N, d = X.shape
    dev = X.device
    live = W > 0
    i0 = torch.argmax(torch.where(live, prng.gumbel(k0, (N,), dev), -math.inf))
    x0 = _row(X, i0)
    centers = [x0]
    d2 = torch.where(live, ((X - x0) ** 2).sum(dim=1), 0.0)
    key = k1
    for _ in range(1, k):
        key, kc, ku = prng.split(key, 3)
        mask = live & (d2 > 0)
        any_mask = mask.any()
        logits = torch.where(mask, torch.log(torch.clamp_min(d2, 1e-30)), -math.inf)
        cat = prng.categorical(kc, logits)
        # every remaining live point coincides with a seed: uniform pick
        uni = torch.argmax(torch.where(live, prng.gumbel(ku, (N,), dev), -math.inf))
        idx = torch.where(any_mask, cat, uni)
        xi = _row(X, idx)
        # a duplicate center gets jitter scaled to its magnitude (the
        # dead-center guard of kmeanspp_seed)
        newc = xi + torch.where(any_mask, 0.0,
                                1e-3 * (1.0 + xi.abs()) * prng.normal(ku, (d,), dev))
        centers.append(newc)
        d2 = torch.where(live, torch.minimum(d2, ((X - newc) ** 2).sum(dim=1)), 0.0)
    return torch.stack(centers)


class KMeans(Estimator):
    ParamsCls = KMeansParams
    params: KMeansParams
    staged_fit_capturable = True

    def _device_init_centers(self, X, W) -> torch.Tensor:
        """Center init on the device with no host read, used inside a staged
        refit. 'random' draws k distinct live rows (gumbel-max top-k);
        picks past the live count would land on dead rows, so they become
        jittered copies of the first (live) pick. 'k-means||' runs D²
        sampling on a uniform live subsample of ``init_sample_size`` rows
        (k passes over the sample, not over N)."""
        p = self.params
        k0, k1 = prng.split(prng.PRNGKey(p.seed))
        if p.init_mode == "random":
            centers, ws = device_sample_live(X, W, p.k, k0)
            base = centers[0]
            jit = 1e-3 * (1.0 + base.abs()) * prng.normal(k1, centers.shape, X.device)
            return torch.where((ws == 0)[:, None], base[None, :] + jit, centers)
        if p.init_mode != "k-means||":
            raise ValueError(f"unknown init_mode {p.init_mode!r}")
        ks, k0b = prng.split(k0)
        Xs, Ws = device_sample_live(X, W, p.init_sample_size, ks)
        return device_d2_seed(Xs, Ws, p.k, k0b, k1)

    def _init_centers(self, table: TorchTable) -> torch.Tensor:
        """The eager init: host numpy, as in the reference (see the module
        docstring)."""
        p = self.params
        if staging_active():
            return self._device_init_centers(table.X, table.W)
        rng = np.random.default_rng(p.seed)
        # sample only live rows: a center stranded on a dead (w=0) row
        # never receives points, and Lloyd's keeps it forever
        live = np.flatnonzero((table.W > 0).cpu().numpy())
        n = len(live)
        if n == 0:
            raise ValueError("cannot fit KMeans: table has no live rows")

        def rows(idx):
            sel = torch.from_numpy(np.sort(idx).astype(np.int64)).to(table.X.device)
            return table.X[sel].cpu().numpy()

        if p.init_mode == "random":
            centers = rows(live[rng.choice(n, size=min(p.k, n), replace=False)])
        elif p.init_mode == "k-means||":
            # kmeans++ on a host sample (MLlib's k-means|| intent: spread seeds)
            m = min(n, p.init_sample_size)
            idx = live[rng.choice(n, size=m, replace=False)] if m < n else live
            centers = kmeanspp_seed(rows(idx), p.k, rng)
        else:
            raise ValueError(f"unknown init_mode {p.init_mode!r}")
        if centers.shape[0] < p.k:  # fewer rows than k: pad with jitter
            extra = centers[rng.integers(centers.shape[0], size=p.k - centers.shape[0])]
            centers = np.concatenate([centers, extra + 1e-3], axis=0)
        return torch.from_numpy(centers.astype(np.float32)).to(table.X.device)

    def _fit(self, table: TorchTable) -> KMeansModel:
        p = self.params
        kw = dict(k=p.k, max_iter=p.max_iter, compute_dtype=_dtype(p.compute_dtype),
                  wide_sums=True)
        lloyd = _lloyd_fixed if staging_active() else _lloyd
        if p.n_init <= 1:
            centers, assign, cost, n_iter = lloyd(
                table.X, table.W, self._init_centers(table), p.tol, **kw)
        else:
            runs = [lloyd(table.X, table.W, self.replace_seed(s)._init_centers(table),
                          p.tol, **kw)
                    for s in range(p.seed, p.seed + p.n_init)]
            costs = torch.stack([r[2] for r in runs])
            best = torch.argmin(costs)      # the first on a tie, as jnp.argmin
            centers = _row(torch.stack([r[0] for r in runs]), best)
            assign = _row(torch.stack([r[1] for r in runs]), best)
            cost = _row(costs, best)
            n_iter = (_row(torch.stack([r[3] for r in runs]), best) if staging_active()
                      else runs[int(best)][3])
        model = KMeansModel(p, centers)
        model.n_iter_ = concrete_or_none(n_iter, int)
        model.training_cost_ = concrete_or_none(cost)
        # the converged assignment, reused: no extra distance pass
        model.cluster_sizes_ = live_cluster_sizes(table.W, assign, p.k)
        return model

    def replace_seed(self, seed: int) -> "KMeans":
        return KMeans(self.params.replace(seed=seed))
