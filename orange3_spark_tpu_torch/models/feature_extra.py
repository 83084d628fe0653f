"""Feature transformers beyond ``models/preprocess.py``: for now
``SQLTransformer``, whose expression engine ``ops/relational.with_column``
evaluates string expressions with.

Port of the ``SQLTransformer`` of ``orange3_spark_tpu/models/feature_extra.py``;
the rest of that file (RobustScaler, the selectors, the LSH families and
the other ``pyspark.ml.feature`` transformers) is not ported yet.
"""

from __future__ import annotations

import ast
import dataclasses
import re

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Params, Transformer


def _append_cols(table: TorchTable, new_vars, cols) -> TorchTable:
    domain = Domain(list(table.domain.attributes) + list(new_vars),
                    table.domain.class_vars, table.domain.metas)
    return table.with_X(torch.cat([table.X, cols], dim=1), domain)


@dataclasses.dataclass(frozen=True)
class SQLTransformerParams(Params):
    statement: str = "SELECT * FROM __THIS__"  # MLlib statement


def _compare(fn):
    return lambda a, b: fn(a, b).to(torch.float32)


class SQLTransformer(Transformer):
    """The useful subset of MLlib's SQLTransformer:

        SELECT *, <expr> AS <name> [, ...] FROM __THIS__ [WHERE <cond>]

    Expressions are parsed with Python's ``ast`` (arithmetic, comparisons,
    and/or, unary minus over column names and literals, and abs, log, exp,
    sqrt, sin, cos) and evaluated as float32 column arithmetic on the
    device; a literal is a float32 constant, so the arithmetic is the
    reference's operation for operation. WHERE becomes a weight-mask
    filter (static shapes)."""

    ParamsCls = SQLTransformerParams

    _BIN = {ast.Add: torch.add, ast.Sub: torch.sub, ast.Mult: torch.mul,
            ast.Div: torch.div, ast.Mod: torch.remainder, ast.Pow: torch.pow}
    _CMP = {ast.Gt: _compare(torch.gt), ast.Lt: _compare(torch.lt),
            ast.GtE: _compare(torch.ge), ast.LtE: _compare(torch.le),
            ast.Eq: _compare(torch.eq), ast.NotEq: _compare(torch.ne)}
    _FNS = {"abs": torch.abs, "log": torch.log, "exp": torch.exp,
            "sqrt": torch.sqrt, "sin": torch.sin, "cos": torch.cos}

    def _eval(self, node, env):
        if isinstance(node, ast.Expression):
            return self._eval(node.body, env)
        if isinstance(node, ast.Name):
            if node.id not in env:
                raise ValueError(f"unknown column {node.id!r}")
            return env[node.id]
        if isinstance(node, ast.Constant):
            return torch.tensor(np.float32(node.value))
        if isinstance(node, ast.BinOp) and type(node.op) in self._BIN:
            return self._BIN[type(node.op)](self._eval(node.left, env),
                                            self._eval(node.right, env))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -self._eval(node.operand, env)
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            return self._CMP[type(node.ops[0])](self._eval(node.left, env),
                                                self._eval(node.comparators[0], env))
        if isinstance(node, ast.BoolOp):
            vals = [self._eval(v, env) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = (out * v) if isinstance(node.op, ast.And) else torch.maximum(out, v)
            return out
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id in self._FNS and len(node.args) == 1:
                return self._FNS[node.func.id](self._eval(node.args[0], env))
        raise ValueError(f"unsupported SQL expression node {ast.dump(node)}")

    def transform(self, table: TorchTable) -> TorchTable:
        stmt = self.params.statement.strip().rstrip(";")
        m = re.match(r"(?is)^SELECT\s+(.*?)\s+FROM\s+__THIS__(?:\s+WHERE\s+(.*))?$", stmt)
        if not m:
            raise ValueError("statement must be 'SELECT ... FROM __THIS__ [WHERE ...]'")
        select_part, where_part = m.group(1), m.group(2)
        env = {v.name: table.X[:, j] for j, v in enumerate(table.domain.attributes)}
        out = table
        new_vars, new_cols = [], []
        star = False
        for item in re.split(r",(?![^(]*\))", select_part):
            item = item.strip()
            if item == "*":
                star = True
                continue
            am = re.match(r"(?is)^(.*?)\s+AS\s+(\w+)$", item)
            if not am:
                raise ValueError(f"each non-* select item needs 'expr AS name': {item!r}")
            expr, name = am.group(1), am.group(2)
            col = self._eval(ast.parse(expr, mode="eval"), env)
            new_vars.append(ContinuousVariable(name))
            new_cols.append(col[:, None])
        if not star and not new_cols:
            raise ValueError("empty select list")
        if new_cols:
            out = _append_cols(out, new_vars, torch.cat(new_cols, dim=1))
        if not star:
            out = out.select([v.name for v in new_vars])
        if where_part:
            cond = self._eval(ast.parse(where_part, mode="eval"), env)
            out = out.filter(cond > 0)
        return out
