"""Shape bucketing — the serving path's bound on captured graphs.

A port of the JAX package's ``serve/bucketing.py``. There, every distinct
request size would compile its own XLA program; here, every distinct size
would need its own captured CUDA graph (a graph replays fixed shapes at
fixed addresses). So the fix is the same classic serving trick (TF
Serving's batching ladder, vLLM's paddings): pad every batch up to a small
LADDER of canonical row counts, so arbitrary request sizes share a handful
of captured graphs.

Padding is host-side numpy: requests arrive as host arrays (the serving
scenario) or round-trip through host memory here — bounded by the ladder's
``max_bucket``, which also gates serving off for large analytical tables
where the copy would dominate.

Correctness: padded rows ride with weight 0 — the same W-mask convention
the whole framework uses for its row padding — so row-wise kernels compute
garbage on pad rows that is stripped before anything reads it, and
weighted reductions never see them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """The canonical batch shapes the serving path captures graphs for.

    mode:
      * 'pow2'  — powers of two from ``min_bucket`` to ``max_bucket``
                  (default: log-many executables cover every size);
      * 'fixed' — multiples of ``fixed_step`` (tight padding waste,
                  linearly many executables — for latency-critical
                  deployments with a known narrow size range);
      * 'none'  — identity ladder (every size its own shape; the
                  unbucketed baseline the bench sweeps against).

    Requests larger than ``max_bucket`` bypass serving entirely (the raw
    path handles them; analytical batches are rare and run eagerly) —
    ``bucket_for`` returns None there.
    """

    min_bucket: int = 256
    max_bucket: int = 1 << 16
    mode: str = "pow2"
    fixed_step: int = 64

    def __post_init__(self):
        if self.mode not in ("pow2", "fixed", "none"):
            raise ValueError(
                f"mode must be 'pow2' | 'fixed' | 'none', got {self.mode!r}"
            )
        if self.min_bucket < 1 or self.max_bucket < self.min_bucket:
            raise ValueError(
                f"need 1 <= min_bucket <= max_bucket, got "
                f"{self.min_bucket}..{self.max_bucket}"
            )
        if self.mode == "fixed" and self.fixed_step < 1:
            raise ValueError(f"fixed_step must be >= 1, got {self.fixed_step}")

    def buckets(self) -> tuple[int, ...]:
        """The full ladder, ascending — what ``warmup(buckets=None)``
        captures. 'fixed' ladders enumerate every step (warm the ones
        you serve by passing ``buckets=`` explicitly when that is many);
        'none' has no enumerable ladder."""
        if self.mode == "none":
            return ()
        if self.mode == "fixed":
            out = list(
                range(self.fixed_step, self.max_bucket + 1, self.fixed_step)
            )
        else:
            out = []
            b = 1
            while b < self.min_bucket:
                b <<= 1
            while b <= self.max_bucket:
                out.append(b)
                b <<= 1
        # max_bucket is always served (bypass starts ABOVE it), so it must
        # be a rung even when it is not itself a power of two / step
        # multiple — otherwise warmup() and bucket_for() disagree on the
        # top of the ladder.
        if not out or out[-1] != self.max_bucket:
            out.append(self.max_bucket)
        return tuple(out)

    def bucket_for(self, n: int) -> int | None:
        """Smallest ladder rung holding ``n`` rows, or None when ``n``
        exceeds ``max_bucket`` (serve bypass). Always returns a member of
        ``buckets()`` so warmup captures exactly the rungs requests
        hit."""
        if n > self.max_bucket:
            return None
        if self.mode == "none":
            return n
        if self.mode == "fixed":
            b = max(self.fixed_step,
                    -(-n // self.fixed_step) * self.fixed_step)
        else:
            b = 1
            while b < self.min_bucket:
                b <<= 1
            while b < n:
                b <<= 1
        return min(b, self.max_bucket)


def domain_sig(domain) -> tuple:
    """Hashable schema signature for executable-cache keys. Variables
    compare by (type, name, values), so two tables that merely share
    shapes but differ in column metadata (names, class values) key
    DIFFERENT executables — a transform's output domain is derived from
    its input domain at build time, and a same-shape different-domain
    table must not inherit it from the cache."""
    if domain is None:
        return ()
    return (domain.attributes, domain.class_vars, domain.metas)


def pad_rows_np(arr: np.ndarray | None, n_pad: int) -> np.ndarray | None:
    """Zero-pad a host array's leading (row) axis up to ``n_pad``.
    Pure numpy — launches nothing on the device."""
    if arr is None:
        return None
    arr = np.asarray(arr)
    n = arr.shape[0]
    if n == n_pad:
        return np.ascontiguousarray(arr)
    if n > n_pad:
        raise ValueError(f"batch has {n} rows, bucket holds {n_pad}")
    out = np.zeros((n_pad,) + arr.shape[1:], dtype=arr.dtype)
    out[:n] = arr
    return out


def boundary_mask_np(n: int, n_pad: int) -> np.ndarray:
    """The W validity mask for a request padded once at a boundary: 1.0 on
    the ``n`` live rows, 0.0 on the ``n_pad - n`` pad rows — built
    host-side for the same reason ``pad_rows_np`` is."""
    if n > n_pad:
        raise ValueError(f"batch has {n} rows, bucket holds {n_pad}")
    W = np.zeros((n_pad,), np.float32)
    W[:n] = 1.0
    return W


def table_to_host(table) -> tuple[np.ndarray, np.ndarray | None, np.ndarray]:
    """(X, Y, W) as PADDED host arrays (no row stripping — the pad rows
    already carry W=0 and the bucket pad extends that convention)."""
    X = table.X.cpu().numpy()
    Y = table.Y.cpu().numpy() if table.Y is not None else None
    W = table.W.cpu().numpy()
    return X, Y, W
