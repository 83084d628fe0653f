"""IsotonicRegression — parity with ``pyspark.ml.regression.IsotonicRegression``.

Port of ``orange3_spark_tpu/models/isotonic.py``. The fit is pool-adjacent
violators (PAV) on the host, as in the reference (and as MLlib finishes it
on the driver): a stack-based O(n) numpy/Python loop over the live rows in
feature order. Its output, the boundaries and the fitted values at them,
goes to the device. The transform is ``jnp.interp``'s arithmetic over
``torch.searchsorted``: linear between the two boundaries around x, flat
outside them, a row at a time (a served bucket gives the raw bits).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import (
    Estimator, Model, Params, append_columns, to_host,
)


#: jnp.interp's threshold on a zero-width interval: np.spacing(eps) of f32
_DX_EPS = float(np.spacing(np.finfo(np.float32).eps))


@dataclasses.dataclass(frozen=True)
class IsotonicRegressionParams(Params):
    isotonic: bool = True    # MLlib isotonic: True=nondecreasing, False=antitonic
    feature_index: int = 0   # MLlib featureIndex


def _pav(x: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Stack-based pool-adjacent-violators on (x-sorted) data, O(n): the
    reference's loop, block for block."""
    means: list[float] = []
    weights: list[float] = []
    x_lo: list[float] = []
    x_hi: list[float] = []
    for xi, yi, wi in zip(x.tolist(), y.tolist(), w.tolist()):
        means.append(yi)
        weights.append(wi)
        x_lo.append(xi)
        x_hi.append(xi)
        while len(means) > 1 and means[-2] > means[-1]:
            m2, w2 = means.pop(), weights.pop()
            hi = x_hi.pop()
            x_lo.pop()
            m1, w1 = means[-1], weights[-1]
            tot = w1 + w2
            means[-1] = (m1 * w1 + m2 * w2) / tot if tot > 0 else (m1 + m2) / 2
            weights[-1] = tot
            x_hi[-1] = hi
    bx, by = [], []
    for m, lo, hi in zip(means, x_lo, x_hi):
        bx.append(lo)
        by.append(m)
        if hi > lo:
            bx.append(hi)
            by.append(m)
    return np.asarray(bx, dtype=np.float32), np.asarray(by, dtype=np.float32)


def _interp(x: torch.Tensor, bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, bx, by)``: i = searchsorted(bx, x, 'right') clipped
    to [1, m-1]; df = by[i] - by[i-1], dx = bx[i] - bx[i-1], delta = x -
    bx[i-1]; by[i-1] + (delta/dx)·df, the product and sum one fused
    multiply-add as XLA contracts them (float64, rounded once), or by[i-1]
    where |dx| is below spacing(eps); flat extrapolation: by[0] below
    bx[0], by[-1] above bx[-1]."""
    m = bx.shape[0]
    if m == 1:
        return by[0].expand_as(x).clone()
    i = torch.clamp(torch.searchsorted(bx, x.contiguous(), right=True), 1, m - 1)
    x0, x1, y0, y1 = bx[i - 1], bx[i], by[i - 1], by[i]
    df, dx, delta = y1 - y0, x1 - x0, x - x0
    dx0 = dx.abs() <= _DX_EPS
    q = delta / torch.where(dx0, 1.0, dx)
    f = torch.where(dx0, y0, (q.double() * df.double() + y0.double()).float())
    f = torch.where(x < bx[0], by[0], f)
    return torch.where(x > bx[-1], by[-1], f)


class IsotonicRegressionModel(Model):
    def __init__(self, params, boundaries, predictions):
        self.params = params
        self.boundaries = boundaries    # f32[m] ascending feature values
        self.predictions = predictions  # f32[m] fitted values at boundaries

    @property
    def state_pytree(self):
        return {"boundaries": self.boundaries, "predictions": self.predictions}

    def _predict(self, table: TorchTable) -> torch.Tensor:
        return _interp(table.X[:, self.params.feature_index], self.boundaries,
                       self.predictions)

    def predict(self, table: TorchTable) -> np.ndarray:
        return to_host(self._predict(table), table.n_rows)

    def transform(self, table: TorchTable) -> TorchTable:
        return append_columns(table, [self._predict(table)[:, None]],
                              [ContinuousVariable("prediction")])


class IsotonicRegression(Estimator):
    ParamsCls = IsotonicRegressionParams
    params: IsotonicRegressionParams

    def _fit(self, table: TorchTable) -> IsotonicRegressionModel:
        p = self.params
        if table.Y is None:
            raise ValueError("IsotonicRegression needs a target column")
        x = table.X[:, p.feature_index].cpu().numpy()
        y = table.y.cpu().numpy()
        w = table.W.cpu().numpy()
        live = w > 0
        x, y, w = x[live], y[live], w[live]
        if not p.isotonic:
            y = -y
        order = np.argsort(x, kind="stable")
        bx, by = _pav(x[order], y[order], w[order])
        if not p.isotonic:
            by = -by
        dev = table.session.device
        return IsotonicRegressionModel(p, torch.from_numpy(bx).to(dev),
                                       torch.from_numpy(by).to(dev))
