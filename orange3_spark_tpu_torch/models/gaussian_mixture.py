"""GaussianMixture: ``pyspark.ml.clustering.GaussianMixture``.

Port of ``orange3_spark_tpu/models/gaussian_mixture.py``: full-covariance
EM with MLlib's convergence test (|Δ log-likelihood| / Σw < tol). The
reference runs EM as one ``lax.while_loop``; here it is a host loop that
reads one flag an iteration, and nothing inside an iteration waits for the
device: the batched Cholesky is ``torch.linalg.cholesky_ex`` (its info is
never read; a failed factor gives non-finite densities, as the
reference's NaN factor), the E-step the [k, d, d] inverse factors
(``solve_triangular`` of the identity) times the [k, d, N] differences,
the M-step two products a component.

Both initialisations are ported: the eager one on the host (a numpy sample
and kmeans++-style seeding, the reference's draws) and the device one a
staged refit uses (``device_sample_live`` / ``device_d2_seed`` of
``models/kmeans.py`` on JAX's stream, never a ``torch.Generator``).
Row weights fold into the responsibilities, so padding and filtered rows
(W == 0) count in no statistic.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, DiscreteVariable, Domain
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params, staging_active
from orange3_spark_tpu_torch.models.kmeans import (
    device_d2_seed,
    device_sample_live,
    live_cluster_sizes,
)
from orange3_spark_tpu_torch.ops import prng

_LOG2PI = float(np.log(2.0 * np.pi))


@dataclasses.dataclass(frozen=True)
class GaussianMixtureParams(Params):
    k: int = 2                 # MLlib k
    max_iter: int = 100        # MLlib maxIter
    tol: float = 0.01          # MLlib tol (log-likelihood delta over Σw)
    seed: int = 0              # MLlib seed
    reg_covar: float = 1e-6    # diagonal jitter (beyond MLlib; keeps Cholesky sane)
    init_sample_size: int = 8192


def _log_resp(X, W, weights, means, chols):
    """Per-row component log-joints [N, k] and the weighted total
    log-likelihood; ``chols`` f32[k, d, d] lower Cholesky factors."""
    d = X.shape[1]
    diff = X[None, :, :] - means[:, None, :]                               # [k, N, d]
    # z_c = L_c^-1 (x - mu_c): the [k, d, d] inverses once, then one batched
    # product (a triangular solve of N right-hand sides is far slower on CUDA)
    eye = torch.eye(d, dtype=X.dtype, device=X.device).expand_as(chols)
    z = torch.linalg.solve_triangular(chols, eye, upper=False) @ diff.transpose(1, 2)
    quad = (z * z).sum(dim=1)                                              # [k, N]
    logdet = 2.0 * torch.log(torch.diagonal(chols, dim1=1, dim2=2)).sum(dim=1)
    log_pdf = -0.5 * (d * _LOG2PI + logdet[:, None] + quad)
    log_joint = log_pdf.T + torch.log(weights)[None, :]                    # [N, k]
    lse = torch.logsumexp(log_joint, dim=1)
    loglik = torch.where(W > 0, lse * W, 0.0).sum()
    return log_joint, loglik


def _cholesky(covs: torch.Tensor) -> torch.Tensor:
    """Lower factors with no host read (a failed factor's info is not
    checked: its non-finite entries carry through, as the reference's)."""
    L, _ = torch.linalg.cholesky_ex(covs)
    return L


def em_step(X, W, weights, means, covs, reg: float, w_total):
    """One E-step then M-step: (weights, means, covs, loglik)."""
    d = X.shape[1]
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    chols = _cholesky(covs + reg * eye[None])
    log_joint, loglik = _log_resp(X, W, weights, means, chols)
    resp = torch.softmax(log_joint, dim=1) * W[:, None]                    # [N, k]
    nk = resp.sum(dim=0)
    nk_safe = torch.clamp_min(nk, 1e-12)
    new_means = (resp.T @ X) / nk_safe[:, None]
    scatter = torch.stack([(X * rc[:, None]).T @ X for rc in resp.T])      # [k, d, d]
    new_covs = scatter / nk_safe[:, None, None] - new_means[:, :, None] * new_means[:, None, :]
    new_weights = nk / torch.clamp_min(w_total, 1e-12)
    return new_weights, new_means, new_covs, loglik


def em(X, W, weights, means, covs, tol: float, reg: float, max_iter: int):
    """EM to MLlib's convergence test, one flag read an iteration:
    (weights, means, covs + reg·I, loglik, n_iter)."""
    w_total = W.sum()
    denom = torch.clamp_min(w_total, 1.0)
    prev = torch.tensor(-float("inf"), device=X.device)
    ll, n_iter = prev, 0
    while n_iter < max_iter:
        weights, means, covs, ll = em_step(X, W, weights, means, covs, reg, w_total)
        n_iter += 1
        if bool(torch.abs(ll - prev) / denom < tol):
            break
        prev = ll
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    return weights, means, covs + reg * eye[None], ll, n_iter


class GaussianMixtureModel(Model):
    def __init__(self, params, weights, means, covs):
        self.params = params
        self.weights = weights   # f32[k]
        self.means = means       # f32[k, d]
        self.covs = covs         # f32[k, d, d]
        self.n_iter_: int | None = None
        self.log_likelihood_: float | None = None  # summary.logLikelihood

    @property
    def state_pytree(self):
        return {"weights": self.weights, "means": self.means, "covs": self.covs}

    def _log_joint(self, table: TorchTable):
        log_joint, _ = _log_resp(table.X, table.W, self.weights, self.means,
                                 _cholesky(self.covs))
        return log_joint

    def predict(self, table: TorchTable) -> np.ndarray:
        return torch.argmax(self._log_joint(table), dim=1)[: table.n_rows].cpu().numpy()

    def predict_probability(self, table: TorchTable) -> np.ndarray:
        """MLlib predictProbability: posterior responsibilities [n, k]."""
        return torch.softmax(self._log_joint(table), dim=1)[: table.n_rows].cpu().numpy()

    def log_likelihood(self, table: TorchTable) -> float:
        _, ll = _log_resp(table.X, table.W, self.weights, self.means, _cholesky(self.covs))
        return float(ll)

    def transform(self, table: TorchTable) -> TorchTable:
        """Appends 'prediction' and the per-component 'probability_i'."""
        log_joint = self._log_joint(table)
        probs = torch.softmax(log_joint, dim=1)
        pred = torch.argmax(log_joint, dim=1).to(torch.float32)
        k = self.params.k
        new_attrs = (list(table.domain.attributes)
                     + [DiscreteVariable("prediction", tuple(str(i) for i in range(k)))]
                     + [ContinuousVariable(f"probability_{i}") for i in range(k)])
        new_domain = Domain(new_attrs, table.domain.class_vars, table.domain.metas)
        return table.with_X(torch.cat([table.X, pred[:, None], probs], dim=1), new_domain)


class GaussianMixture(Estimator):
    ParamsCls = GaussianMixtureParams
    params: GaussianMixtureParams

    def _device_init(self, table: TorchTable):
        """The staged refit's init, no host read: means by D² seeding on a
        live subsample (``device_d2_seed``), a shared diagonal covariance
        from the weighted variance of all rows, JAX's key chain."""
        p = self.params
        X, W = table.X, table.W
        k0, k1 = prng.split(prng.PRNGKey(p.seed))
        ks, k0b = prng.split(k0)
        Xs, Ws = device_sample_live(X, W, p.init_sample_size, ks)
        means0 = device_d2_seed(Xs, Ws, p.k, k0b, k1)
        wsum = torch.clamp_min(W.sum(), 1e-12)
        mean = (X * W[:, None]).sum(dim=0) / wsum
        var = torch.clamp_min((((X - mean) ** 2) * W[:, None]).sum(dim=0) / wsum, 1e-3)
        covs0 = torch.diag(var)[None].repeat(p.k, 1, 1)
        weights0 = torch.full((p.k,), 1.0 / p.k, dtype=torch.float32, device=X.device)
        return weights0, means0, covs0

    def _init(self, table: TorchTable):
        """kmeans++-style seeding on a host sample (the reference's numpy
        draws); a shared diagonal covariance."""
        p = self.params
        if staging_active():
            return self._device_init(table)
        rng = np.random.default_rng(p.seed)
        live = np.flatnonzero(table.W.cpu().numpy() > 0)
        if len(live) == 0:
            raise ValueError("cannot fit GaussianMixture: table has no live rows")
        m = min(len(live), p.init_sample_size)
        idx = live[rng.choice(len(live), size=m, replace=False)] if m < len(live) else live
        sel = torch.from_numpy(np.sort(idx).astype(np.int64)).to(table.X.device)
        sample = table.X.index_select(0, sel).cpu().numpy()
        centers = [sample[rng.integers(m)]]
        d2 = np.sum((sample - centers[0]) ** 2, axis=1)
        for _ in range(1, p.k):
            s = d2.sum()
            c = sample[rng.choice(m, p=d2 / s)] if s > 0 else sample[rng.integers(m)]
            centers.append(c)
            d2 = np.minimum(d2, np.sum((sample - c) ** 2, axis=1))
        means0 = np.stack(centers).astype(np.float32)
        var = np.maximum(sample.var(axis=0), 1e-3).astype(np.float32)
        covs0 = np.tile(np.diag(var)[None], (p.k, 1, 1))
        weights0 = np.full((p.k,), 1.0 / p.k, dtype=np.float32)
        dev = table.X.device
        return tuple(torch.from_numpy(a).to(dev) for a in (weights0, means0, covs0))

    def _fit(self, table: TorchTable) -> GaussianMixtureModel:
        p = self.params
        weights0, means0, covs0 = self._init(table)
        weights, means, covs, ll, n_iter = em(
            table.X, table.W, weights0, means0, covs0, float(np.float32(p.tol)),
            float(np.float32(p.reg_covar)), p.max_iter)
        model = GaussianMixtureModel(p, weights, means, covs)
        model.n_iter_ = n_iter
        model.log_likelihood_ = float(ll)
        assign = torch.argmax(model._log_joint(table), dim=1)
        model.cluster_sizes_ = live_cluster_sizes(table.W, assign, p.k)
        return model
