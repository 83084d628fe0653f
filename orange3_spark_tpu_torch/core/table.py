"""TorchTable — the columnar table of the PyTorch package.

The same layout as the JAX package's ``TpuTable``: all numeric cells in one
``X: f32[N_pad, d]`` tensor, targets in ``Y``, and a weight vector ``W`` that
carries both user row weights and the padding/filter mask (``W == 0`` marks a
padding or filtered row, so a filter zeroes weights instead of changing
shapes). Metas stay host-side in numpy. The JAX table's ``put_sharded``
becomes ``.to(session.device)``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import (
    ContinuousVariable,
    DiscreteVariable,
    Domain,
    Variable,
)
from orange3_spark_tpu_torch.core.fmath import sqrt32
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.ops.stats import weighted_moments, weighted_quantiles


class TorchTable:
    """Columnar table over device tensors.

    Attributes
    ----------
    domain : Domain            column metadata (host)
    X : f32[N_pad, n_attrs]    features
    Y : f32[N_pad, n_class]    targets (may be None)
    W : f32[N_pad]             row weights; 0 marks padding / filtered rows
    metas : object[n_rows, m]  host-side meta columns (unpadded)
    n_rows : int               logical (unpadded) row count
    """

    def __init__(self, domain, X, Y, W, metas, n_rows, session=None):
        self.domain = domain
        self.X = X
        self.Y = Y
        self.W = W
        self.metas = metas
        self.n_rows = int(n_rows)
        self.session = session or TorchSession.active()

    # ------------------------------------------------------------ construct
    @classmethod
    def from_numpy(
        cls,
        domain: Domain,
        X: np.ndarray,
        Y: np.ndarray | None = None,
        metas: np.ndarray | None = None,
        W: np.ndarray | None = None,
        session: TorchSession | None = None,
    ) -> "TorchTable":
        session = session or TorchSession.active()
        X = np.asarray(X, dtype=np.float32)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got shape {X.shape}")
        n = X.shape[0]
        if X.shape[1] != len(domain.attributes):
            raise ValueError(
                f"X has {X.shape[1]} columns, domain has {len(domain.attributes)}"
            )
        n_pad = session.pad_rows(n)
        Xp = np.zeros((n_pad, X.shape[1]), dtype=np.float32)
        Xp[:n] = X
        if Y is not None:
            Y = np.asarray(Y, dtype=np.float32)
            if Y.ndim == 1:
                Y = Y[:, None]
            if Y.shape[1] != len(domain.class_vars):
                raise ValueError(
                    f"Y has {Y.shape[1]} columns, domain has "
                    f"{len(domain.class_vars)} class vars"
                )
            Yp = np.zeros((n_pad, Y.shape[1]), dtype=np.float32)
            Yp[:n] = Y
        elif domain.class_vars:
            raise ValueError("domain has class_vars but Y is None")
        else:
            Yp = None
        Wp = np.zeros((n_pad,), dtype=np.float32)
        Wp[:n] = 1.0 if W is None else np.asarray(W, dtype=np.float32)
        dev = session.device
        Xd = torch.from_numpy(Xp).to(dev)
        Yd = torch.from_numpy(Yp).to(dev) if Yp is not None else None
        Wd = torch.from_numpy(Wp).to(dev)
        if metas is not None:
            metas = np.asarray(metas, dtype=object)
            if metas.ndim == 1:
                metas = metas[:, None]
        return cls(domain, Xd, Yd, Wd, metas, n, session)

    @classmethod
    def from_arrays(cls, X, Y=None, *, attr_names=None, class_name="y",
                    class_values=None, session=None) -> "TorchTable":
        """Convenience: build a Domain from bare arrays (continuous attrs)."""
        X = np.asarray(X)
        names = attr_names or [f"x{i}" for i in range(X.shape[1])]
        attrs = [ContinuousVariable(n) for n in names]
        cvar = None
        if Y is not None:
            if class_values is not None:
                cvar = DiscreteVariable(class_name, class_values)
            else:
                cvar = ContinuousVariable(class_name)
        return cls.from_numpy(Domain(attrs, cvar), X, Y, session=session)

    # -------------------------------------------------------------- export
    def to_numpy(self) -> tuple[np.ndarray, np.ndarray | None, np.ndarray]:
        """Copy to host and strip padding: (X, Y, W). The collect() action."""
        n = self.n_rows
        X = self.X[:n].cpu().numpy()
        Y = self.Y[:n].cpu().numpy() if self.Y is not None else None
        W = self.W[:n].cpu().numpy()
        return X, Y, W

    # ------------------------------------------------------------ properties
    @property
    def n_pad(self) -> int:
        return self.X.shape[0]

    @property
    def n_attrs(self) -> int:
        return self.X.shape[1]

    def __len__(self) -> int:
        return self.n_rows

    @property
    def y(self) -> torch.Tensor:
        """First class column as a flat [N_pad] device vector."""
        if self.Y is None:
            raise ValueError("table has no class variable")
        return self.Y[:, 0]

    @property
    def valid_mask(self) -> torch.Tensor:
        """f32[N_pad] 1.0 where the row is live (unfiltered, not padding)."""
        return (self.W > 0).to(torch.float32)

    # ------------------------------------------------------------ DataFrame ops
    def select(self, columns: Sequence[str | Variable]) -> "TorchTable":
        """Column projection (DataFrame.select): gathers attribute columns
        on the device; class variables stay where they are."""
        attrs, idxs = [], []
        for c in columns:
            var = self.domain[c]
            if not isinstance(var, (ContinuousVariable, DiscreteVariable)):
                raise ValueError(f"cannot select non-numeric column {var.name!r}")
            if var in self.domain.class_vars:
                raise ValueError("use select on attributes; class vars stay put")
            attrs.append(var)
            idxs.append(self.domain.index(var))
        new_domain = Domain(attrs, self.domain.class_vars, self.domain.metas)
        X = self.X.index_select(1, torch.tensor(idxs, dtype=torch.int64,
                                                device=self.X.device))
        return TorchTable(new_domain, X, self.Y, self.W, self.metas, self.n_rows,
                          self.session)

    def filter(self, predicate: Callable[["TorchTable"], torch.Tensor]
               | torch.Tensor) -> "TorchTable":
        """Row filter (DataFrame.filter): zero the weights of dropped rows,
        so shapes stay as they are."""
        mask = predicate(self) if callable(predicate) else predicate
        mask = torch.as_tensor(mask, device=self.W.device).to(torch.bool)
        return self.with_weights(torch.where(mask, self.W, 0.0))

    # Spark spells DataFrame.filter as where() too
    def where(self, predicate) -> "TorchTable":
        return self.filter(predicate)

    def fillna(self, value) -> "TorchTable":
        """Replace NaNs (DataFrame.fillna / na.fill): a float fills every
        attribute column; a {column_name: float} dict fills per column,
        class columns included."""
        if not isinstance(value, dict):
            return self.with_X(torch.where(torch.isnan(self.X), float(value), self.X))
        X, Y = self.X, self.Y
        for name, v in value.items():
            try:
                var = self.domain[name]
            except KeyError as e:
                raise ValueError(f"fillna: unknown column {name!r}") from e
            if var in self.domain.class_vars:
                j = list(self.domain.class_vars).index(var)
                Y = Y.clone() if Y is self.Y else Y
                Y[:, j] = torch.where(torch.isnan(Y[:, j]), float(v), Y[:, j])
            else:
                j = self.domain.index(var)
                X = X.clone() if X is self.X else X
                X[:, j] = torch.where(torch.isnan(X[:, j]), float(v), X[:, j])
        return TorchTable(self.domain, X, Y, self.W, self.metas, self.n_rows,
                          self.session)

    def dropna(self, subset: Sequence[str] | None = None) -> "TorchTable":
        """Drop rows with NaNs (DataFrame.dropna / na.drop): their weights
        are zeroed, as filter() does."""
        if subset is None:
            bad = torch.isnan(self.X).any(dim=1)
            if self.Y is not None:
                bad = bad | torch.isnan(self.Y).any(dim=1)
        else:
            bad = torch.zeros((self.n_pad,), dtype=torch.bool, device=self.W.device)
            for name in subset:
                try:
                    bad = bad | torch.isnan(self.column(name))  # attr or class
                except (KeyError, ValueError) as e:
                    raise ValueError(f"dropna: unknown column {name!r}") from e
        return self.with_weights(torch.where(bad, 0.0, self.W))

    def with_weights(self, W) -> "TorchTable":
        return TorchTable(self.domain, self.X, self.Y, W, self.metas,
                          self.n_rows, self.session)

    def with_X(self, X, domain: Domain | None = None) -> "TorchTable":
        return TorchTable(domain or self.domain, X, self.Y, self.W, self.metas,
                          self.n_rows, self.session)

    def count(self) -> int:
        """Number of live rows (DataFrame.count action — forces compute)."""
        return int((self.W > 0).sum())

    def compacted(self) -> "TorchTable":
        """Physically drop filtered rows (a round trip through the host, the
        collect boundary)."""
        X, Y, W = self.to_numpy()
        live = W > 0
        metas = self.metas[live[: len(self.metas)]] if self.metas is not None else None
        return TorchTable.from_numpy(self.domain, X[live],
                                     Y[live] if Y is not None else None,
                                     metas, W[live], self.session)

    def column(self, key: str | Variable) -> torch.Tensor:
        """One attribute or class column as an [N_pad] device vector."""
        var = self.domain[key]
        if var in self.domain.class_vars:
            return self.Y[:, list(self.domain.class_vars).index(var)]
        return self.X[:, self.domain.index(var)]

    # ------------------------------------------------------------- actions
    def head(self, k: int = 5) -> np.ndarray:
        """First k LIVE rows (respects filters, like DataFrame.head). Reads
        the device in chunks until k live rows are found, so no more than
        the prefix it needs crosses to the host."""
        k = min(k, self.n_rows)
        out: list[np.ndarray] = []
        chunk = max(1024, 4 * k)
        start = 0
        while start < self.n_rows and sum(len(c) for c in out) < k:
            stop = min(start + chunk, self.n_rows)
            Xc = self.X[start:stop].cpu().numpy()
            Wc = self.W[start:stop].cpu().numpy()
            out.append(Xc[Wc > 0])
            start = stop
        return (np.concatenate(out, axis=0)[:k] if out
                else np.empty((0, self.n_attrs), np.float32))

    def describe(self) -> dict[str, np.ndarray]:
        """Weighted per-column mean/std/min/max (DataFrame.describe)."""
        mean, var, _ = weighted_moments(self.X, self.W)
        big = float(np.finfo(np.float32).max)
        live = self.W[:, None] > 0
        stats = {"mean": mean, "std": sqrt32(var),
                 "min": torch.where(live, self.X, big).amin(dim=0),
                 "max": torch.where(live, self.X, -big).amax(dim=0)}
        return {k: v.cpu().numpy() for k, v in stats.items()}

    def approx_quantile(self, cols, probabilities) -> np.ndarray:
        """DataFrame.approxQuantile, exact here (one sort per column, in
        ``ops/stats.weighted_quantiles``). Returns [n_cols, n_probs]."""
        if isinstance(cols, str):
            cols = [cols]
        Xsel = torch.stack([self.column(c) for c in cols], dim=1)
        qs = torch.tensor(list(probabilities), dtype=torch.float32, device=Xsel.device)
        return weighted_quantiles(Xsel, self.W, qs).T.cpu().numpy()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"TorchTable[{self.n_rows} rows x {self.n_attrs} attrs, "
            f"{len(self.domain.class_vars)} class vars, on {self.session.device}]"
        )
