"""libsvm / svmlight files — MLlib's canonical sparse input.

``spark.read.format("libsvm")`` is MLlib's entry point for sparse features.
Lines look like ``label idx:val idx:val ...`` with 1-based ascending
indices (``zero_based=True`` takes 0-based files). The JAX package's
``io/libsvm.py`` holds the same functions; this is the port's own copy.

Two shapes, both static:

* ``read_libsvm`` densifies a whole file into a ``TorchTable``: right for
  the moderate widths the dense estimators take.
* ``libsvm_chunk_source`` yields FIXED-NNZ rows for the hashed streaming
  fit: each row's (index, value) pairs truncated or padded to
  ``nnz_per_row`` slots, as ``[n, 1 + 2*nnz]`` float32 chunks (label,
  idx..., val...). Pads are index -1, value 0. The consumer is
  ``StreamingHashedLinearEstimator(value_weighted=True, n_dense=0,
  n_cat=nnz_per_row, label_in_chunk=True)``.

The parse is host Python, line by line for the labels; the pairs of a
batch of lines are converted in one numpy call. A batch that call cannot
take whole (a malformed token, a hexadecimal literal, an index below the
base, a non-integral index) is parsed again token by token, which raises
the reference's own error.
"""

from __future__ import annotations

import re
import warnings
from typing import Callable, Iterator

import numpy as np

#: indices travel as float32 in a chunk; 2^24 is the last integer float32
#: holds exactly, beyond it distinct features would merge
MAX_CHUNK_INDEX = 1 << 24
_TWO_COLONS = re.compile(r":[^\s:]*:")


def _parse_lines_tokens(lines, zero_based: bool):
    """The reference's token-by-token parse: (labels, [(idx i64, val
    f32)])."""
    labels: list = []
    rows: list = []
    off = 0 if zero_based else 1
    for ln in lines:
        # svmlight allows trailing '# info' comments; '#' cannot occur in a
        # label or idx:val token, so cutting at the first '#' is safe
        ln = ln.split("#", 1)[0].strip()
        if not ln:
            continue
        parts = ln.split()
        labels.append(float(parts[0]))
        idx = np.empty(len(parts) - 1, np.int64)
        val = np.empty(len(parts) - 1, np.float32)
        for j, tok in enumerate(parts[1:]):
            i, _, v = tok.partition(":")
            idx[j] = int(i) - off
            val[j] = float(v)
        if np.any(idx < 0):
            raise ValueError(f"libsvm index < {off} in line {ln[:60]!r} — "
                             "pass zero_based=True for 0-based files")
        rows.append((idx, val))
    return labels, rows


def _parse_flat(lines, zero_based: bool):
    """A batch of lines as flat arrays: (labels f64[n], pairs a row i64[n],
    flat indices i64[P], flat values f32[P]), the pairs in file order. The
    same numbers as ``_parse_lines_tokens`` (both round each decimal
    correctly to a double, the values then to float32); a batch the numpy
    conversion cannot take whole goes through ``_parse_lines_tokens``,
    which raises where the reference raises."""
    lines = list(lines)
    labels: list = []
    counts: list = []
    toks: list = []
    for ln in lines:
        ln = ln.split("#", 1)[0].strip()
        if not ln:
            continue
        parts = ln.split()
        labels.append(parts[0])
        counts.append(len(parts) - 1)
        toks.extend(parts[1:])
    off = 0 if zero_based else 1
    flat = " ".join(toks)
    nums = None
    # every token one colon (as many colons as tokens, none with two), no
    # hexadecimal literal (strtod reads one, float() does not)
    if (flat.count(":") == len(toks) and _TWO_COLONS.search(flat) is None
            and "x" not in flat and "X" not in flat):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # a short read is caught below
            nums = np.fromstring(flat.replace(":", " "), dtype=np.float64, sep=" ")
        if nums.size != 2 * len(toks):
            nums = None
    if nums is not None:
        fidx = nums[0::2]
        if not (np.all(np.isfinite(fidx)) and np.all(fidx == np.floor(fidx))
                and np.all(fidx - off >= 0)):
            nums = None
    try:
        lab = np.array(labels, dtype=np.float64)
    except ValueError:
        nums = None
    if nums is None:
        lab_l, rows = _parse_lines_tokens(lines, zero_based)
        cnt = np.array([len(i) for i, _ in rows], np.int64)
        return (np.asarray(lab_l, np.float64), cnt,
                np.concatenate([i for i, _ in rows]) if rows else np.zeros(0, np.int64),
                np.concatenate([v for _, v in rows]) if rows else np.zeros(0, np.float32))
    return (lab, np.asarray(counts, np.int64), nums[0::2].astype(np.int64) - off,
            nums[1::2].astype(np.float32))


def read_libsvm(path: str, *, n_features: int | None = None, zero_based: bool = False,
                class_col: str = "label", session=None):
    """A whole libsvm file as a dense ``TorchTable`` (the labels as its
    class variable)."""
    from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
    from orange3_spark_tpu_torch.core.table import TorchTable

    with open(path) as f:
        lab, cnt, idx, val = _parse_flat(f, zero_based)
    if not len(lab):
        raise ValueError(f"{path!r} contains no libsvm rows")
    row = np.repeat(np.arange(len(cnt)), cnt)
    row_max = np.full(len(cnt), -1, np.int64)
    np.maximum.at(row_max, row, idx)
    d = n_features or int(max(row_max.max() + 1, 0))
    over = np.flatnonzero(row_max >= d)
    if len(over):
        r = int(over[0])
        raise ValueError(f"libsvm index {int(row_max[r]) + (0 if zero_based else 1)} "
                         f"exceeds n_features={d} (row {r})")
    X = np.zeros((len(cnt), d), np.float32)
    X[row, idx] = val          # in file order: a repeated index keeps its last value
    domain = Domain([ContinuousVariable(f"f{i}") for i in range(d)],
                    ContinuousVariable(class_col))
    return TorchTable.from_numpy(domain, X, lab.astype(np.float32), session=session)


def write_libsvm(table, path: str, *, zero_based: bool = False) -> None:
    """A dense ``TorchTable`` as a libsvm file (MLUtils.saveAsLibSVMFile):
    one line a live row, its nonzero features only, 1-based indices unless
    ``zero_based``; the label is the class variable (0.0 without one)."""
    X, Y, W = table.to_numpy()
    off = 0 if zero_based else 1
    with open(path, "w") as f:
        for r in range(table.n_rows):
            if W is not None and W[r] <= 0:
                continue
            lab = float(Y[r, 0]) if Y is not None else 0.0
            nz = np.flatnonzero(X[r])
            pairs = " ".join(f"{i + off}:{X[r, i]:.9g}" for i in nz)
            f.write(f"{lab:.9g} {pairs}\n".rstrip() + "\n")


def _fixed_rows(lab, cnt, idx, val, nnz: int) -> np.ndarray:
    """[n, 1 + 2·nnz] f32 rows: the label, the first ``nnz`` indices (-1
    after a row's last pair), their values (0 there)."""
    n = len(cnt)
    out = np.zeros((n, 1 + 2 * nnz), np.float32)
    out[:, 0] = lab
    out[:, 1:1 + nnz] = -1.0
    row = np.repeat(np.arange(n), cnt)
    pos = np.arange(len(idx)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    keep = pos < nnz
    out[row[keep], 1 + pos[keep]] = idx[keep].astype(np.float32)
    out[row[keep], 1 + nnz + pos[keep]] = val[keep]
    return out


def libsvm_chunk_source(path: str, *, nnz_per_row: int, chunk_rows: int = 1 << 18,
                        zero_based: bool = False) -> Callable[[], Iterator[np.ndarray]]:
    """Re-iterable source of fixed-nnz ``[n, 1 + 2*nnz_per_row]`` f32 chunks:
    column 0 the label, then ``nnz_per_row`` index slots, then as many value
    slots. A row with fewer pairs pads with index -1 / value 0 (inert under
    value weighting: a value of 0 contributes nothing forward or backward);
    a longer one keeps its first ``nnz_per_row`` pairs. Every chunk holds
    ``chunk_rows`` rows but the last. An index of 2^24 or more raises: it
    cannot travel exactly in a float32 chunk. The consumer is
    ``StreamingHashedLinearEstimator(value_weighted=True, n_dense=0,
    n_cat=nnz_per_row, label_in_chunk=True)``."""
    if nnz_per_row < 1:
        raise ValueError(f"nnz_per_row must be >= 1, got {nnz_per_row}")

    def open_stream() -> Iterator[np.ndarray]:
        pending: list = []
        have = 0
        with open(path) as f:
            while True:
                lines = f.readlines(1 << 22)
                if lines:
                    lab, cnt, idx, val = _parse_flat(lines, zero_based)
                    big = np.flatnonzero(idx >= MAX_CHUNK_INDEX)
                    if len(big):
                        r = int(np.searchsorted(np.cumsum(cnt), big[0], side="right"))
                        s = int(np.cumsum(cnt)[r] - cnt[r])
                        raise ValueError(
                            f"libsvm index {int(idx[s:s + cnt[r]].max())} >= 2^24 cannot "
                            "travel exactly in a float32 chunk — use read_libsvm or "
                            "pre-hash the indices")
                    if len(cnt):
                        pending.append(_fixed_rows(lab, cnt, idx, val, nnz_per_row))
                        have += len(cnt)
                while have >= chunk_rows or (not lines and have):
                    block = np.concatenate(pending) if len(pending) > 1 else pending[0]
                    take = min(chunk_rows, have)
                    yield np.ascontiguousarray(block[:take])
                    rest = block[take:]
                    pending = [rest] if len(rest) else []
                    have = len(rest)
                if not lines:
                    return

    return open_stream
