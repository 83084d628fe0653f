"""LDA: ``pyspark.ml.clustering.LDA`` with MLlib's default online
variational Bayes (Hoffman et al.).

Port of ``orange3_spark_tpu/models/lda.py``. Documents are rows of the dense
count matrix ``X: f32[N, V]``; the E-step runs the reference's
``gamma_iters`` passes over all documents at once, each two [N, k] x [k, V]
products, and the sufficient statistics are one more. The outer loop is a
host loop of ``max_iter`` steps with Hoffman's rate (tau0 + t)^-kappa, the
full corpus a step, as the reference. E[log x] under a Dirichlet is
``torch.digamma`` (the reference's ``jax.scipy.special.digamma``: within
2e-6 relative in float32), the bound's log-gamma ``torch.lgamma``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params


@dataclasses.dataclass(frozen=True)
class LDAParams(Params):
    k: int = 10                        # MLlib k
    max_iter: int = 20                 # MLlib maxIter
    doc_concentration: float = -1.0    # MLlib docConcentration (alpha); -1 => 1/k
    topic_concentration: float = -1.0  # MLlib topicConcentration (eta); -1 => 1/k
    learning_offset: float = 1024.0    # MLlib learningOffset (tau0)
    learning_decay: float = 0.51       # MLlib learningDecay (kappa)
    subsampling_rate: float = 1.0      # accepted for parity; the full batch is used
    gamma_iters: int = 25              # inner E-step passes (MLlib: until tol)
    seed: int = 0


def dirichlet_expectation(a: torch.Tensor) -> torch.Tensor:
    """E[log x] under Dirichlet(a), row by row."""
    return torch.digamma(a) - torch.digamma(a.sum(dim=-1, keepdim=True))


def e_step(X, W, lam, alpha: float, k: int, gamma_iters: int):
    """The batched variational E-step over all documents: (gamma [N, k],
    sstats [k, V])."""
    n = X.shape[0]
    expElogbeta = torch.exp(dirichlet_expectation(lam))                    # [k, V]
    gamma = torch.ones((n, k), dtype=torch.float32, device=X.device)
    for _ in range(gamma_iters):
        expElogtheta = torch.exp(dirichlet_expectation(gamma))            # [N, k]
        phinorm = expElogtheta @ expElogbeta + 1e-30                       # [N, V]
        gamma = alpha + expElogtheta * ((X / phinorm) @ expElogbeta.T)
    expElogtheta = torch.exp(dirichlet_expectation(gamma))
    phinorm = expElogtheta @ expElogbeta + 1e-30
    sstats = (expElogtheta * W[:, None]).T @ (X / phinorm)
    return gamma, sstats * expElogbeta


def online_vb(X, W, lam0, alpha: float, eta: float, tau0: float, kappa: float, *, k: int,
              max_iter: int, gamma_iters: int) -> torch.Tensor:
    lam = lam0
    for t in range(max_iter):
        _, sstats = e_step(X, W, lam, alpha, k, gamma_iters)
        rho = float(np.float32(tau0 + np.float32(t)) ** np.float32(-kappa))
        lam = (1.0 - rho) * lam + rho * (eta + sstats)
    return lam


def bound(X, W, lam, alpha: float, eta: float, *, k: int, gamma_iters: int) -> torch.Tensor:
    """The variational lower bound on log p(docs) (Hoffman's eq. 3, the
    corpus part)."""
    gamma, _ = e_step(X, W, lam, alpha, k, gamma_iters)
    Elogtheta = dirichlet_expectation(gamma)
    Elogbeta = dirichlet_expectation(lam)
    phinorm = torch.exp(Elogtheta) @ torch.exp(Elogbeta) + 1e-30
    ll_docs = (W[:, None] * X * torch.log(phinorm)).sum()
    a = torch.tensor(alpha, dtype=torch.float32, device=X.device)
    ll_theta = (W * (((a - gamma) * Elogtheta).sum(dim=1) + torch.lgamma(gamma).sum(dim=1)
                     - torch.lgamma(gamma.sum(dim=1)) + torch.lgamma(k * a)
                     - k * torch.lgamma(a))).sum()
    return ll_docs + ll_theta


class LDAModel(Model):
    def __init__(self, params, lam, vocab_size):
        self.params = params
        self.lam = lam                 # f32[k, V] variational topic parameters
        self.vocab_size = vocab_size
        self.n_docs_: int | None = None

    @property
    def state_pytree(self):
        return {"lam": self.lam}

    def topics_matrix(self) -> np.ndarray:
        """MLlib topicsMatrix: [V, k] column-normalised topic-word weights."""
        lam = self.lam.cpu().numpy()
        return (lam / lam.sum(axis=1, keepdims=True)).T

    def describe_topics(self, max_terms: int = 10):
        """MLlib describeTopics: each topic's top term indices and weights."""
        tm = self.topics_matrix()
        out = []
        for c in range(self.params.k):
            order = np.argsort(tm[:, c])[::-1][:max_terms]
            out.append({"topic": c, "termIndices": order.tolist(),
                        "termWeights": tm[order, c].tolist()})
        return out

    def _alpha(self) -> float:
        p = self.params
        return float(np.float32(p.doc_concentration if p.doc_concentration > 0 else 1.0 / p.k))

    def transform(self, table: TorchTable) -> TorchTable:
        """Appends topicDistribution_{i} columns (normalised gamma)."""
        gamma, _ = e_step(table.X, table.W, self.lam, self._alpha(), self.params.k,
                          self.params.gamma_iters)
        theta = gamma / gamma.sum(dim=1, keepdim=True)
        k = self.params.k
        new_attrs = list(table.domain.attributes) + [
            ContinuousVariable(f"topicDistribution_{i}") for i in range(k)]
        new_domain = Domain(new_attrs, table.domain.class_vars, table.domain.metas)
        return table.with_X(torch.cat([table.X, theta], dim=1), new_domain)

    def log_likelihood(self, table: TorchTable) -> float:
        p = self.params
        eta = float(np.float32(p.topic_concentration if p.topic_concentration > 0
                               else 1.0 / p.k))
        return float(bound(table.X, table.W, self.lam, self._alpha(), eta, k=p.k,
                           gamma_iters=p.gamma_iters))

    def log_perplexity(self, table: TorchTable) -> float:
        """MLlib logPerplexity: -logLikelihood / total token count."""
        tokens = float((table.X * table.W[:, None]).sum())
        return -self.log_likelihood(table) / max(tokens, 1.0)


class LDA(Estimator):
    ParamsCls = LDAParams
    params: LDAParams

    def _fit(self, table: TorchTable) -> LDAModel:
        p = self.params
        v = table.X.shape[1]
        alpha = float(np.float32(p.doc_concentration if p.doc_concentration > 0 else 1.0 / p.k))
        eta = float(np.float32(p.topic_concentration if p.topic_concentration > 0
                               else 1.0 / p.k))
        rng = np.random.default_rng(p.seed)
        lam0 = torch.from_numpy(rng.gamma(100.0, 0.01, size=(p.k, v)).astype(np.float32)
                                ).to(table.X.device)
        lam = online_vb(table.X, table.W, lam0, alpha, eta, float(np.float32(p.learning_offset)),
                        float(np.float32(p.learning_decay)), k=p.k, max_iter=p.max_iter,
                        gamma_iters=p.gamma_iters)
        model = LDAModel(p, lam, v)
        model.n_docs_ = table.n_rows
        return model
