"""BisectingKMeans: ``pyspark.ml.clustering.BisectingKMeans``.

Port of ``orange3_spark_tpu/models/bisecting_kmeans.py``. All rows start
in one cluster; the largest divisible leaf is split by a local 2-means until
there are k leaves. The outer loop runs on the host (O(k) steps); each
split is ``models/kmeans._lloyd`` on the whole table with the rows outside
the leaf weighted 0, seeded from the reference's numpy stream (``seed +
31·step``). Prediction is the flat nearest-center rule of ``KMeansModel``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Estimator, Params
from orange3_spark_tpu_torch.models.kmeans import (
    KMeansModel,
    _assign,
    _lloyd,
    live_cluster_sizes,
)


@dataclasses.dataclass(frozen=True)
class BisectingKMeansParams(Params):
    k: int = 4                               # MLlib k (leaf clusters)
    max_iter: int = 20                       # MLlib maxIter (inner Lloyd iterations)
    min_divisible_cluster_size: float = 1.0  # MLlib minDivisibleClusterSize
    seed: int = 0                            # MLlib seed
    tol: float = 1e-4


class BisectingKMeansModel(KMeansModel):
    """Flat nearest-center prediction over the leaf centers: predict,
    compute_cost and transform are KMeansModel's."""


class BisectingKMeans(Estimator):
    ParamsCls = BisectingKMeansParams
    params: BisectingKMeansParams

    def _two_means(self, X, w_masked: torch.Tensor, w_masked_np: np.ndarray, seed: int):
        """One local 2-means on the weight-masked table: (2, d) centers, or
        None for a leaf of fewer than two live rows."""
        rng = np.random.default_rng(seed)
        live = np.flatnonzero(w_masked_np > 0)
        if len(live) < 2:
            return None
        idx = np.sort(live[rng.choice(len(live), size=2, replace=False)])
        c0 = X.index_select(0, torch.from_numpy(idx).to(X.device))
        centers, _, _, _ = _lloyd(X, w_masked, c0, float(np.float32(self.params.tol)), k=2,
                                  max_iter=self.params.max_iter)
        return centers

    def _fit(self, table: TorchTable) -> BisectingKMeansModel:
        p = self.params
        X, W = table.X, table.W
        w_np = W.cpu().numpy()
        total_w = float(w_np.sum())
        mean0 = ((X * W[:, None]).sum(dim=0).cpu().numpy() / max(total_w, 1e-12))
        leaves = [np.asarray(mean0, dtype=np.float32)]
        masks = [w_np > 0]
        sizes = [total_w]
        divisible = [True]
        # MLlib: minDivisibleClusterSize >= 1 is a point count, in (0, 1) a
        # fraction of the total weight
        min_size = (p.min_divisible_cluster_size if p.min_divisible_cluster_size >= 1.0
                    else p.min_divisible_cluster_size * total_w)
        step = 0
        while len(leaves) < p.k:
            order = np.argsort(sizes)[::-1]      # the largest divisible leaf first
            split_at = None
            for j in order:
                if divisible[j] and sizes[j] >= min_size and masks[j].sum() >= 2:
                    split_at = int(j)
                    break
            if split_at is None:
                break                            # nothing divisible: fewer than k, as MLlib
            wm_np = np.where(masks[split_at], w_np, 0.0).astype(np.float32)
            w_masked = torch.from_numpy(wm_np).to(X.device)
            centers2 = self._two_means(X, w_masked, wm_np, p.seed + 31 * step)
            step += 1
            if centers2 is None:
                divisible[split_at] = False
                continue
            assign, _ = _assign(X, centers2, w_masked)
            a = assign.cpu().numpy()
            m_left = masks[split_at] & (a == 0)
            m_right = masks[split_at] & (a == 1)
            if m_left.sum() == 0 or m_right.sum() == 0:
                divisible[split_at] = False      # identical points: this leaf cannot divide
                continue
            c2 = centers2.cpu().numpy()
            leaves[split_at] = c2[0]
            masks[split_at] = m_left
            sizes[split_at] = float(w_np[m_left].sum())
            leaves.append(c2[1])
            masks.append(m_right)
            sizes.append(float(w_np[m_right].sum()))
            divisible.append(True)
        centers = torch.from_numpy(np.stack(leaves).astype(np.float32)).to(X.device)
        model = BisectingKMeansModel(p, centers)
        assign, cost = _assign(X, centers, W)
        model.training_cost_ = float(cost)
        model.cluster_sizes_ = live_cluster_sizes(W, assign, len(leaves))
        return model
