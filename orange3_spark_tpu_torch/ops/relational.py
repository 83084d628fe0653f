"""Relational ops of the PyTorch package.

Port of ``orange3_spark_tpu/ops/relational.py``, cut to ``merge_columns``
(the device-pure column merge that branching workflow DAGs re-join
through). Joins, group-by, pivot and sort wait for ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import torch

from orange3_spark_tpu_torch.core.domain import Domain
from orange3_spark_tpu_torch.core.table import TorchTable


def merge_columns(left: TorchTable, right: TorchTable, *, suffix: str = "_r") -> TorchTable:
    """Row-aligned column merge (Orange's 'Merge Data' by position), on the
    device: one concat, no host hop, so a DAG that fans out and re-merges
    stages whole (workflow/staging.py).

    Both tables must have the same (padded) row count; weights intersect
    (a row dead on either side is dead in the merge). Right-side attribute
    names that clash with the left get ``suffix`` appended. Keeps the
    left's class vars and metas."""
    if left.X.shape[0] != right.X.shape[0]:
        raise ValueError(
            f"merge_columns needs row-aligned tables, got {left.X.shape[0]} "
            f"vs {right.X.shape[0]} padded rows")
    taken = {v.name for v in left.domain.attributes}
    rattrs = []
    for v in right.domain.attributes:
        name = v.name
        while name in taken:     # suffix until unique ('a_r' may exist too)
            name += suffix
        taken.add(name)
        rattrs.append(v if name == v.name else v.renamed(name))
    domain = Domain(list(left.domain.attributes) + rattrs,
                    left.domain.class_vars, left.domain.metas)
    X = torch.cat([left.X, right.X], dim=1)
    W = torch.minimum(left.W, right.W)
    return TorchTable(domain, X, left.Y, W, left.metas, left.n_rows, left.session)
