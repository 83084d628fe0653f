"""RFormula — parity with ``pyspark.ml.feature.RFormula``.

Port of ``orange3_spark_tpu/models/rformula.py``. The formula surface MLlib
documents: ``~``, ``+``, ``-`` (term removal; ``- 1`` drops the
intercept), ``.`` (every non-label column) and ``:`` (interaction). The fit
compiles the formula against the table's Domain into a static column plan
(indices, one-hot widths, interaction products) on the host; the transform
runs the plan as device gathers, one-hots and products. A categorical term
expands to reference-level dummies: the FIRST level is dropped (R's
treatment contrasts, as the reference); with ``- 1`` the first categorical
main effect is coded in full, as in R. Interactions multiply the encoded
blocks column by column. The label becomes the table's class variable.
Errors are the reference's.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, DiscreteVariable, Domain
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params
from orange3_spark_tpu_torch.ops.hashing import to_index


@dataclasses.dataclass(frozen=True)
class RFormulaParams(Params):
    formula: str = ""


def _parse(formula: str):
    """-> (label, included term tuples, excluded term tuples, intercept)."""
    if "~" not in formula:
        raise ValueError(f"formula needs '~': {formula!r}")
    lhs, rhs = formula.split("~", 1)
    label = lhs.strip()
    if not label:
        raise ValueError("formula needs a label on the left of '~'")
    include, exclude, intercept = [], [], True
    # '+' separates terms; a '-' flips the following term to a removal
    for signed in rhs.replace("-", "+-").split("+"):
        t = signed.strip()
        if not t:
            continue
        neg = t.startswith("-")
        t = t.lstrip("-").strip()
        if t == "1":
            if neg:
                intercept = False
            continue
        factors = tuple(f.strip() for f in t.split(":") if f.strip())
        if not factors:
            continue
        (exclude if neg else include).append(factors)
    return label, include, exclude, intercept


def _one_hot(col: torch.Tensor, width: int) -> torch.Tensor:
    """``jax.nn.one_hot(col.astype(int32), width)``: a code outside [0,
    width) is a row of zeros; a float code converts as XLA converts it."""
    cls = torch.arange(width, dtype=torch.int32, device=col.device)
    return (to_index(col)[:, None] == cls).to(torch.float32)


class RFormulaModel(Model):
    def __init__(self, params, plan, out_domain, label_var, label_src):
        self.params = params
        self.plan = plan            # [(name, [(col_idx, n_onehot | 0 | -k), ...])]
        self.out_domain = out_domain
        self.label_var = label_var
        self.label_src = label_src  # ('attr', j) | ('class', j)
        self.has_intercept = True   # '- 1' in the formula flips this

    @property
    def state_pytree(self):
        return {}

    def transform(self, table: TorchTable) -> TorchTable:
        X = table.X
        blocks = []
        for _, factors in self.plan:
            encoded = []
            for j, width in factors:
                col = X[:, j]
                if width < 0:      # full coding (the no-intercept first factor)
                    encoded.append(_one_hot(col, -width))
                elif width:        # drop the FIRST level: R's treatment contrasts
                    encoded.append(_one_hot(col, width + 1)[:, 1:])
                else:
                    encoded.append(col[:, None])
            block = encoded[0]
            for nxt in encoded[1:]:
                # interaction: the columnwise cross product of the blocks
                block = (block[:, :, None] * nxt[:, None, :]).reshape(block.shape[0], -1)
            blocks.append(block)
        feats = (torch.cat(blocks, dim=1) if blocks
                 else torch.zeros((X.shape[0], 0), dtype=torch.float32, device=X.device))
        kind, j = self.label_src
        ycol = table.Y[:, j] if kind == "class" else X[:, j]
        return TorchTable(self.out_domain, feats, ycol[:, None], table.W, table.metas,
                          table.n_rows, table.session)


class RFormula(Estimator):
    ParamsCls = RFormulaParams
    params: RFormulaParams

    def _fit(self, table: TorchTable) -> RFormulaModel:
        return compile_formula(self.params, table.domain)


def compile_formula(params: RFormulaParams, domain: Domain) -> RFormulaModel:
    """The fitted model of ``params.formula`` over a table of ``domain``:
    the plan depends on the domain alone (names, categorical levels)."""
    label, include, exclude, intercept = _parse(params.formula)
    attr_names = [v.name for v in domain.attributes]
    class_names = [v.name for v in domain.class_vars]
    if label in attr_names:
        label_src = ("attr", attr_names.index(label))
        label_var = domain.attributes[label_src[1]]
    elif label in class_names:
        label_src = ("class", class_names.index(label))
        label_var = domain.class_vars[label_src[1]]
    else:
        raise ValueError(f"label {label!r} not in table columns")
    # '.' expands to every attribute but the label, in domain order
    expanded: list[tuple[str, ...]] = []
    for t in include:
        if t == (".",):
            expanded.extend((n,) for n in attr_names if n != label)
        else:
            expanded.append(t)
    for t in exclude:
        for f in t:
            if f not in attr_names:
                raise ValueError(f"unknown column {f!r} in formula exclusion")
    removed = set(exclude)
    terms = [t for t in expanded if t not in removed]
    # dedupe, keeping the first occurrence (R keeps the term order)
    seen: set = set()
    terms = [t for t in terms if not (t in seen or seen.add(t))]
    if not terms:
        raise ValueError(f"formula {params.formula!r} selects no terms")
    plan = []
    out_vars: list[ContinuousVariable] = []
    # R: without an intercept the FIRST categorical main effect is coded
    # in full (all k levels), so the columns still span the mean
    full_code_budget = 0 if intercept else 1
    for t in terms:
        factors, factor_names = [], []
        for f in t:
            if f == label:
                raise ValueError(f"label {label!r} cannot be a feature term")
            if f not in attr_names:
                raise ValueError(f"unknown column {f!r} in formula")
            j = attr_names.index(f)
            var = domain.attributes[j]
            if isinstance(var, DiscreteVariable) and var.values:
                k = len(var.values)
                if len(t) == 1 and full_code_budget:
                    full_code_budget = 0
                    factors.append((j, -k))       # the full-coding marker
                    factor_names.append([f"{f}_{v}" for v in var.values])
                else:
                    factors.append((j, k - 1))
                    factor_names.append([f"{f}_{v}" for v in var.values[1:]])
            else:
                factors.append((j, 0))
                factor_names.append([f])
        plan.append((":".join(t), factors))
        out_vars.extend(ContinuousVariable(":".join(c))
                        for c in itertools.product(*factor_names))
    model = RFormulaModel(params, plan, Domain(out_vars, label_var, domain.metas),
                          label_var, label_src)
    model.has_intercept = intercept
    return model
