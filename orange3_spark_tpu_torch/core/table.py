"""TorchTable — the columnar table of the PyTorch package.

The same layout as the JAX package's ``TpuTable``: all numeric cells in one
``X: f32[N_pad, d]`` tensor, targets in ``Y``, and a weight vector ``W`` that
carries both user row weights and the padding/filter mask (``W == 0`` marks a
padding or filtered row, so a filter zeroes weights instead of changing
shapes). Metas stay host-side in numpy. The JAX table's ``put_sharded``
becomes ``.to(session.device)``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import (
    ContinuousVariable,
    DiscreteVariable,
    Domain,
)
from orange3_spark_tpu_torch.core.session import TorchSession


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

    # ------------------------------------------------------------ DataFrame ops
    def filter(self, predicate: Callable[["TorchTable"], torch.Tensor]
               | torch.Tensor) -> "TorchTable":
        """Row filter (DataFrame.filter): zero the weights of dropped rows,
        so shapes stay as they are."""
        mask = predicate(self) if callable(predicate) else predicate
        mask = torch.as_tensor(mask, device=self.W.device).to(torch.bool)
        return self.with_weights(torch.where(mask, self.W, 0.0))

    def with_weights(self, W) -> "TorchTable":
        return TorchTable(self.domain, self.X, self.Y, W, self.metas,
                          self.n_rows, self.session)

    def with_X(self, X, domain: Domain | None = None) -> "TorchTable":
        return TorchTable(domain or self.domain, X, self.Y, self.W, self.metas,
                          self.n_rows, self.session)

    def count(self) -> int:
        """Number of live rows (DataFrame.count action — forces compute)."""
        return int((self.W > 0).sum())

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"TorchTable[{self.n_rows} rows x {self.n_attrs} attrs, "
            f"{len(self.domain.class_vars)} class vars, on {self.session.device}]"
        )
