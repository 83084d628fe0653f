"""The distributed reduction backbone of the PyTorch package.

Port of ``orange3_spark_tpu/parallel/collectives.py``, cut to
``distributed_gramian``. The JAX package contracts over row-sharded arrays
and lets GSPMD insert the all-reduce; the port runs on one device, so the
Gramian is one product there. The explicit ``tree_aggregate`` /
``data_parallel_sum`` wait for the multi-device slice (``torch.distributed``).
"""

from __future__ import annotations

import torch

from orange3_spark_tpu_torch.ops.stats import weighted_moments


def distributed_gramian(X: torch.Tensor, W: torch.Tensor, center: bool = True):
    """Weighted Gramian  Xᶜᵀ diag(W) Xᶜ  of the rows, with Xᶜ = X - mean
    when ``center`` (the weighted column means). The building block of PCA.
    Returns (G [d, d], mean [d], total_weight [])."""
    mean, _, tot = weighted_moments(X, W)
    Xc = X - mean if center else X
    G = (Xc * W[:, None]).T @ Xc
    return G, mean, tot
