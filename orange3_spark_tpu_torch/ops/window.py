"""Window functions — the ``pyspark.sql.Window`` wrangling subset.

Port of ``orange3_spark_tpu/ops/window.py``. Spark shuffles each partition
to one executor and scans it in order; here ONE device lexsort by
(partition, liveness, order value) puts every partition's rows adjacent and
ordered, the windowed quantity is computed by position on the sorted view
(an index, a shift, a cumulative sum), and one inverse permutation puts
the results back in row order. The reference's ``jnp.lexsort`` is three
stable sorts here, least significant key first.

Semantics as Spark's: rows with a NULL/NaN partition key form their own
group; NaN values are skipped by ``running_sum``; dead rows (W == 0) sort
behind their partition and report NaN everywhere. ``running_sum`` keeps the
reference's formula, one global prefix sum less the partition's base, so
its rounding follows the global prefix, not a per-partition sum.

``Window(table, partition_by, order_by)`` computes the sorted view once and
shares it across its methods; the module-level functions are one-shot
conveniences. Every result is an [N_pad] device vector aligned with the
table's rows — ``relational.with_column`` appends it.
"""

from __future__ import annotations

import torch

from orange3_spark_tpu_torch.core.domain import DiscreteVariable
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.ops.hashing import to_index

__all__ = ["Window", "row_number", "lag", "lead", "running_sum"]


def _stable_order(key: torch.Tensor, order: torch.Tensor | None = None) -> torch.Tensor:
    """The permutation that stably sorts ``key[order]`` applied to ``order``."""
    if order is None:
        return torch.sort(key, stable=True).indices
    return order[torch.sort(key[order], stable=True).indices]


class Window:
    """Shared sorted view over one (partition_by, order_by) spec."""

    def __init__(self, table: TorchTable, partition_by: str, order_by: str, *,
                 ascending: bool = True):
        kvar = table.domain[partition_by]
        if not isinstance(kvar, DiscreteVariable):
            raise ValueError(f"partition_by {partition_by!r} must be discrete")
        self._table = table
        raw = table.column(partition_by)
        n_groups = max(len(kvar.values), 1)
        # Spark groups NULL keys together: NaN keys get their own id past
        # every real category
        part = torch.where(torch.isnan(raw), n_groups, to_index(raw)).to(torch.int32)
        val = table.column(order_by)
        if not ascending:
            val = -val
        # NULLS LAST in either direction (Spark's asc/desc default); a zero's
        # sign dropped, so -0.0 ties +0.0 as in the reference's sort
        val = torch.where(torch.isnan(val), float("inf"), val) + 0.0
        live = table.W > 0
        # lexsort by partition id, then the dead-row bump (dead rows land
        # after every live row of their partition), then the order value
        order = _stable_order(val)
        order = _stable_order(torch.where(live, 0, 1).to(torch.int32), order)
        order = _stable_order(part, order)
        self._order = order
        pos = torch.arange(part.shape[0], device=part.device)
        self._inv = torch.empty_like(order).scatter_(0, order, pos)
        self._part_s = part[order]
        self._live_s = live[order]
        is_start = torch.ones_like(self._live_s)
        is_start[1:] = self._part_s[1:] != self._part_s[:-1]
        self._seg_start = torch.cummax(torch.where(is_start, pos, 0), 0).values
        self._pos = pos

    # ------------------------------------------------------------- queries
    def row_number(self) -> torch.Tensor:
        """1-based rank of each live row within its partition (Spark
        ``row_number().over(...)``)."""
        rn = (self._pos - self._seg_start + 1).to(torch.float32)
        return torch.where(self._live_s, rn, float("nan"))[self._inv]

    def _shift(self, col: str, offset: int) -> torch.Tensor:
        v_sorted = self._table.column(col)[self._order]
        shifted = torch.roll(v_sorted, offset)
        n = self._part_s.shape[0]
        same_part = torch.roll(self._part_s, offset) == self._part_s
        in_range = (self._pos - offset >= 0) if offset > 0 else (self._pos - offset < n)
        ok = same_part & in_range & self._live_s & torch.roll(self._live_s, offset)
        return torch.where(ok, shifted, float("nan"))[self._inv]

    def lag(self, col: str, offset: int = 1) -> torch.Tensor:
        """Value of ``col`` ``offset`` rows earlier in the partition's
        order; NaN at partition starts (Spark ``lag``)."""
        return self._shift(col, offset)

    def lead(self, col: str, offset: int = 1) -> torch.Tensor:
        """Value of ``col`` ``offset`` rows later in the partition's order;
        NaN at partition ends (Spark ``lead``)."""
        return self._shift(col, -offset)

    def running_sum(self, col: str) -> torch.Tensor:
        """Null-skipping cumulative sum over the partition's order — Spark
        ``sum(col).over(rowsBetween(unboundedPreceding, currentRow))``."""
        v = self._table.column(col)[self._order]
        v = torch.where(self._live_s & ~torch.isnan(v), v, 0.0)   # nulls skipped
        total = torch.cumsum(v, 0)
        base = torch.where(self._seg_start > 0, total[(self._seg_start - 1).clamp_min(0)], 0.0)
        return torch.where(self._live_s, total - base, float("nan"))[self._inv]


# ----------------------------------------------------------- one-shot forms
def row_number(table: TorchTable, partition_by: str, order_by: str, *,
               ascending: bool = True) -> torch.Tensor:
    return Window(table, partition_by, order_by, ascending=ascending).row_number()


def lag(table: TorchTable, col: str, partition_by: str, order_by: str, *,
        offset: int = 1, ascending: bool = True) -> torch.Tensor:
    return Window(table, partition_by, order_by, ascending=ascending).lag(col, offset)


def lead(table: TorchTable, col: str, partition_by: str, order_by: str, *,
         offset: int = 1, ascending: bool = True) -> torch.Tensor:
    return Window(table, partition_by, order_by, ascending=ascending).lead(col, offset)


def running_sum(table: TorchTable, col: str, partition_by: str, order_by: str, *,
                ascending: bool = True) -> torch.Tensor:
    return Window(table, partition_by, order_by, ascending=ascending).running_sum(col)
