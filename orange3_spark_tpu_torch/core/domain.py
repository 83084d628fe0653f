"""Orange-style data domain: typed column metadata for TorchTable.

A copy of ``orange3_spark_tpu/core/domain.py`` (pure Python), kept here so
that the PyTorch package imports nothing of the JAX package. It mirrors the
role of ``Orange.data.Domain`` / ``Orange.data.Variable``. The domain is pure
host-side metadata; all cell data lives in device tensors owned by
TorchTable.
"""

from __future__ import annotations

from typing import Iterable, Sequence


class Variable:
    """A named column descriptor. Hashable, compared by identity of (type, name)."""

    def __init__(self, name: str):
        self.name = str(name)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}({self.name!r})"

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.name == other.name

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.name))

    def renamed(self, name: str) -> "Variable":
        """Copy with a different name (used by column-merge suffixing)."""
        import copy

        out = copy.copy(self)
        out.name = str(name)
        return out

    @property
    def is_continuous(self) -> bool:
        return isinstance(self, ContinuousVariable)

    @property
    def is_discrete(self) -> bool:
        return isinstance(self, DiscreteVariable)

    @property
    def is_string(self) -> bool:
        return isinstance(self, StringVariable)


class ContinuousVariable(Variable):
    """Real-valued column (Spark DoubleType / Orange ContinuousVariable)."""


class DiscreteVariable(Variable):
    """Categorical column with a fixed set of string values.

    Cell data is stored as float value-indexes (0..len(values)-1), NaN for
    missing — the same encoding Orange uses, which keeps the whole X matrix a
    single dense float array (good for the MXU: one big matmul instead of
    ragged per-column kernels).
    """

    def __init__(self, name: str, values: Sequence[str] = ()):
        super().__init__(name)
        self.values = tuple(str(v) for v in values)

    def __eq__(self, other) -> bool:
        return super().__eq__(other) and self.values == other.values

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.name, self.values))


class StringVariable(Variable):
    """Free-text column; lives host-side in table.metas only (never on device)."""


class Domain:
    """attributes (features) + class_vars (targets) + metas (host-side strings).

    Same three-part split as Orange's Domain, which is what the reference
    add-on round-trips through when moving Spark DataFrames into the canvas.
    """

    def __init__(
        self,
        attributes: Iterable[Variable],
        class_vars: Iterable[Variable] | Variable | None = None,
        metas: Iterable[Variable] = (),
    ):
        self.attributes: tuple[Variable, ...] = tuple(attributes)
        if class_vars is None:
            class_vars = ()
        elif isinstance(class_vars, Variable):
            class_vars = (class_vars,)
        self.class_vars: tuple[Variable, ...] = tuple(class_vars)
        self.metas: tuple[Variable, ...] = tuple(metas)
        for var in self.attributes + self.class_vars:
            if isinstance(var, StringVariable):
                raise ValueError(
                    f"StringVariable {var.name!r} can only appear in metas"
                )
        self._index = {v.name: v for v in self.variables + self.metas}

    @property
    def variables(self) -> tuple[Variable, ...]:
        return self.attributes + self.class_vars

    @property
    def class_var(self) -> Variable | None:
        if len(self.class_vars) > 1:
            raise ValueError("Domain has multiple class variables")
        return self.class_vars[0] if self.class_vars else None

    def __len__(self) -> int:
        return len(self.attributes)

    def __iter__(self):
        return iter(self.attributes)

    def __getitem__(self, key: str | Variable) -> Variable:
        if isinstance(key, Variable):
            key = key.name
        return self._index[key]

    def __contains__(self, key: str | Variable) -> bool:
        if isinstance(key, Variable):
            key = key.name
        return key in self._index

    def index(self, key: str | Variable) -> int:
        """Position of a variable: attributes 0.., class_vars after them."""
        var = self[key]
        for i, v in enumerate(self.variables):
            if v == var:
                return i
        raise KeyError(key)  # pragma: no cover - meta vars have no column index

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Domain)
            and self.attributes == other.attributes
            and self.class_vars == other.class_vars
            and self.metas == other.metas
        )

    def __hash__(self) -> int:
        return hash((self.attributes, self.class_vars, self.metas))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        parts = ", ".join(v.name for v in self.attributes)
        cls = " | " + ", ".join(v.name for v in self.class_vars) if self.class_vars else ""
        return f"Domain([{parts}{cls}])"
