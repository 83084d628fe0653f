"""PCA — parity with ``pyspark.ml.feature.PCA``.

Port of ``orange3_spark_tpu/models/pca.py``: one weighted [d, d] Gramian
product (``parallel/collectives.distributed_gramian``), then
``torch.linalg.eigh`` of the covariance, symmetrized first as
``jnp.linalg.eigh`` does. d is small, N is the long dimension.

Eigenvector signs are arbitrary: LAPACK, jaxlib and cuSOLVER may each
return a component negated, and neither package fixes a sign convention,
so the parity tests align each column's sign before comparing.

``torch.linalg.eigh`` reads its solver's status on the host, so a fit
cannot be captured in a CUDA graph (``probes/eigh_capture.py``): a staged
refit runs it eagerly on the device between captured segments
(``staged_fit_capturable`` is False). The transform is the projection
summed column by column (``models/_linear.row_products``), so a row's bits
do not depend on the row count: served output equals raw output bitwise.

Transform follows Orange's PCA widget: the output table's attributes ARE
the principal components (PC1..PCk).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models._linear import row_products
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params
from orange3_spark_tpu_torch.parallel.collectives import distributed_gramian


@dataclasses.dataclass(frozen=True)
class PCAParams(Params):
    k: int = 2          # MLlib k: number of principal components
    center: bool = True # Orange centers; MLlib PCA does too (covariance)


class PCAModel(Model):
    def __init__(self, params, components, mean, explained_variance, total_variance):
        self.params = params
        self.components = components                  # f32[d, k] (columns = PCs)
        self.mean = mean                              # f32[d]
        self.explained_variance = explained_variance  # f32[k]
        self.total_variance = total_variance          # f32[] trace of covariance

    @property
    def state_pytree(self):
        return {
            "components": self.components,
            "mean": self.mean,
            "explained_variance": self.explained_variance,
            "total_variance": self.total_variance,
        }

    @property
    def explained_variance_ratio_(self) -> np.ndarray:
        ev = self.explained_variance.cpu().numpy()
        tot = float(self.total_variance)
        return ev / tot if tot > 0 else ev

    def transform(self, table: TorchTable) -> TorchTable:
        Z = row_products(table.X - self.mean, self.components)
        k = self.components.shape[1]
        new_domain = Domain([ContinuousVariable(f"PC{i + 1}") for i in range(k)],
                            table.domain.class_vars, table.domain.metas)
        return table.with_X(Z, new_domain)


class PCA(Estimator):
    ParamsCls = PCAParams
    params: PCAParams

    def _fit(self, table: TorchTable) -> PCAModel:
        p = self.params
        if p.k > table.n_attrs:
            raise ValueError(f"k={p.k} exceeds n_features={table.n_attrs}")
        G, mean, tot = distributed_gramian(table.X, table.W, center=p.center)
        return self._finalize(G / tot, mean)

    def _finalize(self, cov, mean) -> PCAModel:
        p = self.params
        cov = (cov + cov.T) / 2       # jnp.linalg.eigh's symmetrize_input
        eigvals, eigvecs = torch.linalg.eigh(cov)   # ascending
        order = torch.argsort(eigvals, stable=True).flip(0)[: p.k]
        components = eigvecs[:, order]
        explained = torch.clamp_min(eigvals[order], 0.0)
        total = torch.clamp_min(torch.trace(cov), 0.0)
        if not p.center:
            mean = torch.zeros_like(mean)
        return PCAModel(p, components, mean, explained, total)

    def fit_stream(self, source, *, session=None, chunk_rows: int = 1 << 18,
                   stage_times: dict | None = None) -> PCAModel:
        """Out-of-core fit: ONE pass accumulating the (shift-centered)
        weighted Gramian, one product per chunk, plus the column means over
        a chunk stream (io/streaming.stream_feature_stats), then the same
        eigh finalize as the in-memory fit. ``stage_times`` receives the
        pass's ``overlap_pct`` and ``dispatches``."""
        from orange3_spark_tpu_torch.core.session import TorchSession
        from orange3_spark_tpu_torch.io.streaming import stream_feature_stats

        # validate k BEFORE the pass: an invalid k fails in one chunk, not
        # after a whole out-of-core sweep
        first = next(iter(source()), None)
        if first is not None:
            X0 = first[0] if isinstance(first, tuple) else first
            if self.params.k > X0.shape[1]:
                raise ValueError(f"k={self.params.k} exceeds n_features={X0.shape[1]}")
        dev = (session or TorchSession.builder_get_or_create()).device
        st = stream_feature_stats(source, session=session, chunk_rows=chunk_rows,
                                  gramian=True, stage_times=stage_times)
        cov = st["cov"] if self.params.center else st["second_moment"]
        return self._finalize(torch.as_tensor(cov, dtype=torch.float32, device=dev),
                              torch.as_tensor(st["mean"], dtype=torch.float32, device=dev))
