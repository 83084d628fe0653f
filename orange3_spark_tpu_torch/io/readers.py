"""Table readers and writers — the ``spark.read`` / ``df.write`` roles.

Port of ``orange3_spark_tpu/io/readers.py``. The host parses (pyarrow's CSV
and parquet readers, or sqlite3 from the standard library), the columns land
in numpy, and one copy puts the table on the session's device. pyarrow is
imported inside the functions that use it, so the package imports where
pyarrow is absent; there ``read_csv``, ``read_parquet`` and
``write_parquet`` raise ImportError, and the native CSV reader
(``io/native.read_csv_native``) and the sqlite functions remain.

Schema inference: numeric columns -> ContinuousVariable; string columns
with few distinct values -> DiscreteVariable (value-indexed, the values
sorted); other strings -> metas. The class column is chosen by name
(``class_col``), as the reference's reader widgets let the user pick a
target.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from orange3_spark_tpu_torch.core.domain import (
    ContinuousVariable, DiscreteVariable, Domain, StringVariable,
)
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Params

MAX_DISCRETE_VALUES = 64  # string columns above this many distinct values become metas


@dataclasses.dataclass(frozen=True)
class CsvReaderParams(Params):
    path: str = ""
    class_col: str = ""          # name of the target column ("" = none)
    header: bool = True          # Spark option("header", ...)
    delimiter: str = ","         # Spark option("sep", ...)


def _table_from_columns(names: list[str], columns: dict, class_col: str,
                        session=None) -> TorchTable:
    if class_col and class_col not in names:
        raise ValueError(f"class_col {class_col!r} not found; columns are {names}")
    attrs, attr_cols = [], []
    class_var, class_vals = None, None
    metas_vars, meta_cols = [], []
    for name in names:
        col = columns[name]
        is_target = name == class_col
        if isinstance(col, tuple) and col[0] == "categorical":
            # a pre-typed categorical (a parquet dictionary column): its
            # value set and code order are kept as they are
            _, cat_values, vals = col
            var = DiscreteVariable(name, tuple(cat_values))
        elif np.issubdtype(col.dtype, np.number) or col.dtype == bool:
            var = ContinuousVariable(name)
            vals = col.astype(np.float32)
        else:
            # None, '' and NaN cells are MISSING, never a category of their own
            raw = np.asarray(col, dtype=object)
            missing = np.asarray([s is None or s == "" or (isinstance(s, float) and s != s)
                                  for s in raw])
            strings = np.asarray(["" if m else str(s) for s, m in zip(raw, missing)])
            uniq = np.unique(strings[~missing])
            if len(uniq) <= MAX_DISCRETE_VALUES or is_target:
                var = DiscreteVariable(name, tuple(uniq.tolist()))
                lut = {s: float(i) for i, s in enumerate(var.values)}
                vals = np.asarray([np.nan if m else lut[s] for s, m in zip(strings, missing)],
                                  dtype=np.float32)
            else:
                metas_vars.append(StringVariable(name))
                meta_cols.append(raw)
                continue
        if is_target:
            # a numeric target stays continuous; a string target is discrete
            class_var, class_vals = var, vals
        else:
            attrs.append(var)
            attr_cols.append(vals)
    if attr_cols:
        X = np.stack(attr_cols, axis=1)
    else:
        # the row count from a VALUE array: a ('categorical', values, idx)
        # tuple's len() is its arity
        col = next(iter(columns.values()))
        n = len(col[2]) if isinstance(col, tuple) else len(col)
        X = np.zeros((n, 0), np.float32)
    metas = np.stack(meta_cols, axis=1) if meta_cols else None
    return TorchTable.from_numpy(Domain(attrs, class_var, metas_vars), X, class_vals, metas,
                                 session=session)


def read_csv(path: str = "", class_col: str = "", *, params: CsvReaderParams | None = None,
             session=None) -> TorchTable:
    """CSV -> TorchTable through pyarrow's multithreaded C++ parser."""
    import pyarrow.csv as pacsv

    p = params or CsvReaderParams(path=path, class_col=class_col)
    table = pacsv.read_csv(
        p.path or path,
        parse_options=pacsv.ParseOptions(delimiter=p.delimiter),
        read_options=pacsv.ReadOptions(autogenerate_column_names=not p.header))
    names = table.column_names
    columns = {n: table.column(n).to_numpy(zero_copy_only=False) for n in names}
    return _table_from_columns(names, columns, p.class_col or class_col, session)


def read_parquet(path: str, class_col: str = "", *, session=None) -> TorchTable:
    """Parquet -> TorchTable (the spark.read.parquet role)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pq.read_table(path)
    names = table.column_names
    columns = {}
    for n in names:
        col = table.column(n)
        if pa.types.is_dictionary(col.type):
            # the parquet dictionary IS the category set (order kept): codes
            # round-trip exactly and absent categories survive. to_numpy on
            # a dictionary column would fill nulls from a neighbour, so the
            # indices' nulls become -1, then NaN.
            c = col.combine_chunks()
            values = tuple(str(s) for s in c.dictionary.to_pylist())
            idx = c.indices.fill_null(-1).to_numpy(zero_copy_only=False).astype(np.float32)
            idx[idx < 0] = np.nan
            columns[n] = ("categorical", values, idx)
        else:
            columns[n] = col.to_numpy(zero_copy_only=False)
    return _table_from_columns(names, columns, class_col, session)


def read_sql(query: str, database: str, class_col: str = "", *, session=None) -> TorchTable:
    """SQL query -> TorchTable — the ``spark.read.jdbc`` role over a SQLite
    database file (the standard library's driver). Column types follow the
    CSV reader's inference: numeric -> continuous, strings with few
    distinct values -> discrete, other strings -> metas. The rows are
    converted cell by cell in Python."""
    import sqlite3

    with sqlite3.connect(database) as conn:
        cur = conn.execute(query)
        names = [d[0] for d in cur.description]
        rows = cur.fetchall()
    columns = {n: np.asarray([r[j] for r in rows], dtype=object) for j, n in enumerate(names)}
    # numeric columns come back as Python numbers; tighten their dtype
    for n, col in columns.items():
        if all(v is None or isinstance(v, (int, float)) for v in col):
            columns[n] = np.asarray([np.nan if v is None else float(v) for v in col],
                                    dtype=np.float32)
    return _table_from_columns(names, columns, class_col, session)


def _collect_rows(table: TorchTable, *, drop_filtered: bool = True):
    """Shared writer preamble: collect X and Y, concatenate, and (by
    default) drop weight-zero rows — filters zero weights here, so a writer
    that ignored W would persist the rows the user filtered out. Returns
    (variables, data)."""
    X, Y, W = table.to_numpy()
    data = X if Y is None else np.concatenate([X, Y], axis=1)
    variables = list(table.domain.attributes) + list(table.domain.class_vars)
    if drop_filtered and W is not None:
        data = data[W[: len(data)] > 0]
    return variables, data


def write_parquet(table: TorchTable, path: str, *, drop_filtered: bool = True) -> None:
    """Collect and write Parquet (the df.write.parquet role). Discrete
    columns are written as their CATEGORY STRINGS (a dictionary-encoded
    column holding the full category tuple in Domain order), so
    ``read_parquet`` rebuilds the same Domain. ``drop_filtered``: rows of
    zero weight are left out, as df.write after a filter does."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    variables, data = _collect_rows(table, drop_filtered=drop_filtered)
    cols = []
    for j, var in enumerate(variables):
        v = data[:, j]
        if isinstance(var, DiscreteVariable) and var.values:
            nan = ~np.isfinite(v)
            idx = np.clip(np.where(nan, 0, v), 0, len(var.values) - 1).astype(np.int32)
            cols.append(pa.DictionaryArray.from_arrays(
                pa.array(np.ma.masked_array(idx, mask=nan)), pa.array(list(var.values))))
        else:
            cols.append(pa.array(v))
    pq.write_table(pa.table(cols, names=[var.name for var in variables]), path)


def write_csv(table: TorchTable, path: str, *, drop_filtered: bool = True) -> None:
    """Collect and write CSV (the df.write.csv role) through the native
    writer (shortest round-trip floats: ``read_csv_native`` reads back the
    same float32 bits). Raises ``io.native.NativeUnavailable`` where the
    native engine cannot be built: there is no slower writer, whose
    rounding would write another file. ``drop_filtered`` as in
    ``write_parquet``."""
    from orange3_spark_tpu_torch.io.native import write_csv_native

    variables, data = _collect_rows(table, drop_filtered=drop_filtered)
    write_csv_native(path, data, [v.name for v in variables])


def write_sql(table: TorchTable, database: str, name: str, *, if_exists: str = "replace",
              drop_filtered: bool = True) -> None:
    """Collect and write to a SQLite table — the ``df.write.jdbc`` role.
    Discrete columns are written as their category STRINGS, so a
    ``read_sql`` of the table rebuilds the same attribute and class shape;
    missing cells (NaN) become NULL. Meta columns are not written (as in
    ``write_parquet`` and ``write_csv``).

    if_exists: 'replace' (default) drops an existing table first; 'fail'
    raises if it exists; 'append' inserts below it. The whole write is ONE
    transaction, so a failed 'replace' leaves the previous table intact.
    drop_filtered: weight-zero rows are left out."""
    import sqlite3

    if if_exists not in ("replace", "fail", "append"):
        raise ValueError(f"if_exists must be replace|fail|append, got {if_exists!r}")
    variables, data = _collect_rows(table, drop_filtered=drop_filtered)

    def cell(var, v):
        if np.isnan(v):
            return None     # missing -> NULL, discrete or continuous
        values = getattr(var, "values", None)
        if values:          # discrete: the category string
            i = int(v)
            return values[i] if 0 <= i < len(values) else None
        return float(v)

    qname = '"' + name.replace('"', '""') + '"'
    cols = ", ".join('"' + v.name.replace('"', '""') + '"'
                     + (" TEXT" if getattr(v, "values", None) else " REAL")
                     for v in variables)
    conn = sqlite3.connect(database, isolation_level=None)  # a manual transaction
    try:
        conn.execute("BEGIN IMMEDIATE")
        # SQLite table names are case-insensitive: so is this test, else
        # 'append' would miss 'Data' when asked for 'data'
        exists = conn.execute(
            "SELECT 1 FROM sqlite_master WHERE type='table' AND lower(name)=lower(?)",
            (name,)).fetchone() is not None
        if exists and if_exists == "fail":
            raise ValueError(f"table {name!r} already exists")
        if if_exists == "replace":
            conn.execute(f"DROP TABLE IF EXISTS {qname}")
            exists = False
        if not exists:
            conn.execute(f"CREATE TABLE {qname} ({cols})")
        ph = ", ".join("?" for _ in variables)
        conn.executemany(f"INSERT INTO {qname} VALUES ({ph})",
                         [tuple(cell(v, row[j]) for j, v in enumerate(variables))
                          for row in data])
        conn.execute("COMMIT")
    except BaseException:
        try:
            conn.execute("ROLLBACK")
        except sqlite3.Error:
            pass
        raise
    finally:
        conn.close()
