"""PowerIterationClustering: ``pyspark.ml.clustering.PowerIterationClustering``.

Port of ``orange3_spark_tpu/models/power_iteration.py`` (Lin & Cohen): power
iteration on the degree-normalised affinity v' = D⁻¹ A v of an undirected
similarity graph, L1-normalised each step, then a 1-D k-means on the
pseudo-eigenvector. The graph stays an edge list: the symmetrised edges
are stably sorted by source once a fit, so that every per-source sum (the
degree, and A v in each of the ``max_iter`` steps) is one
``segment_sum_sorted`` launch over the same order, deterministic on the
card. The degree is taken on the device. The 1-D k-means is
``models/kmeans._lloyd``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import HasParams, Params
from orange3_spark_tpu_torch.models.kmeans import _assign, _lloyd
from orange3_spark_tpu_torch.ops.segment_sum import segment_sum_sorted


@dataclasses.dataclass(frozen=True)
class PowerIterationClusteringParams(Params):
    k: int = 2                 # MLlib k
    max_iter: int = 20         # MLlib maxIter
    init_mode: str = "random"  # MLlib initMode: 'random' | 'degree'
    seed: int = 0
    src_col: str = "src"
    dst_col: str = "dst"
    weight_col: str = "weight"


class EdgeLayout:
    """The symmetrised edges sorted by source (stable), once a fit: the
    sorted sources (the segments), the destinations and weights in that
    order, and the [n] degree."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray, n: int, device):
        s2 = torch.from_numpy(np.concatenate([src, dst])).to(device)
        d2 = torch.from_numpy(np.concatenate([dst, src])).to(device)
        w2 = torch.from_numpy(np.concatenate([w, w]).astype(np.float32)).to(device)
        self.src, order = torch.sort(s2, stable=True)
        self.dst = d2.index_select(0, order)
        self.w = w2.index_select(0, order).contiguous()
        self.n = n
        self.deg = segment_sum_sorted(self.w[:, None], self.src, n)[:, 0]

    def step(self, v: torch.Tensor, inv_deg: torch.Tensor) -> torch.Tensor:
        """v' = D⁻¹ A v, L1-normalised."""
        contrib = (self.w * v.index_select(0, self.dst))[:, None].contiguous()
        v = inv_deg * segment_sum_sorted(contrib, self.src, self.n)[:, 0]
        return v / torch.clamp_min(v.abs().sum(), 1e-30)


def power_iterate(layout: EdgeLayout, v0: torch.Tensor, max_iter: int) -> torch.Tensor:
    deg = layout.deg
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp_min(deg, 1e-30), 0.0)
    v = v0
    for _ in range(max_iter):
        v = layout.step(v, inv_deg)
    return v


class PowerIterationClustering(HasParams):
    """Not an Estimator, as in MLlib, where PIC has only assignClusters()."""

    ParamsCls = PowerIterationClusteringParams

    def assign_clusters(self, dataset, device=None) -> np.ndarray:
        """``dataset``: a TorchTable with src/dst/weight attribute columns,
        or a (src, dst, weight) triple of arrays (weight may be None).
        Returns the int64 cluster of every vertex (index = vertex id), on
        ``device`` (default: the table's, else the active session's)."""
        p = self.params
        if isinstance(dataset, TorchTable):
            device = dataset.X.device if device is None else device
            names = [v.name for v in dataset.domain.attributes]
            X = dataset.X[: dataset.n_rows].cpu().numpy()
            X = X[dataset.W[: dataset.n_rows].cpu().numpy() > 0]
            src = X[:, names.index(p.src_col)].astype(np.int64)
            dst = X[:, names.index(p.dst_col)].astype(np.int64)
            if len(src) and max(src.max(), dst.max()) >= (1 << 24):
                raise ValueError(
                    "vertex ids >= 2^24 cannot come from float32 table columns; "
                    "pass (src, dst, weight) integer arrays instead")
            w = (X[:, names.index(p.weight_col)].astype(np.float32)
                 if p.weight_col in names else np.ones(len(src), dtype=np.float32))
        else:
            src, dst, w = dataset
            src = np.asarray(src, dtype=np.int64)
            dst = np.asarray(dst, dtype=np.int64)
            w = (np.ones(len(src), dtype=np.float32) if w is None
                 else np.asarray(w, dtype=np.float32))
        device = TorchSession.active().device if device is None else torch.device(device)
        if np.any(w < 0):
            raise ValueError("PIC requires nonnegative similarities")
        n = int(max(src.max(), dst.max())) + 1 if len(src) else 0
        if n == 0:
            return np.zeros((0,), dtype=np.int64)
        layout = EdgeLayout(src, dst, w, n, device)
        rng = np.random.default_rng(p.seed)
        if p.init_mode == "degree":
            # the reference's float64 degree, rounded once to float32 (a
            # vertex's few float32 weights sum exactly in float64, in any order)
            deg64 = torch.zeros(n, dtype=torch.float64, device=device).index_add_(
                0, layout.src, layout.w.to(torch.float64))
            v0 = (deg64 / torch.clamp_min(deg64.sum(), 1e-30)).to(torch.float32)
        elif p.init_mode == "random":
            r = rng.random(n).astype(np.float32)
            r /= max(np.abs(r).sum(), 1e-30)
            v0 = torch.from_numpy(r).to(device)
        else:
            raise ValueError(f"unknown init_mode {p.init_mode!r}")
        v = power_iterate(layout, v0, p.max_iter)
        # 1-D k-means on the pseudo-eigenvector
        vv = v[:, None]
        live = torch.ones(n, dtype=torch.float32, device=device)
        q = np.quantile(v.cpu().numpy(), np.linspace(0.05, 0.95, p.k))
        centers0 = torch.from_numpy(q[:, None].astype(np.float32)).to(device)
        centers, _, _, _ = _lloyd(vv, live, centers0, float(np.float32(1e-6)), k=p.k,
                                  max_iter=50)
        assign, _ = _assign(vv, centers, live)
        return assign.cpu().numpy().astype(np.int64)
