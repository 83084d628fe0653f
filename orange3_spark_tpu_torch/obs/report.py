"""Per-run structured reports — one object instead of scattered plumbing.

Before this subsystem, answering "where did this fit's time go" meant
threading a ``stage_times=`` dict through the estimator, diffing three
process-global counter dicts around the call yourself, and knowing which
keys each PR happened to add. A ``RunReport`` does the bracketing once:

* created at run entry, it snapshots the process counters;
* the run's stage timings / resolved decisions land in ``stage_times``
  (the estimators keep accepting a caller ``stage_times=`` dict — it gets
  the same keys, so no bench/test call site changed);
* ``finish()`` freezes the wall clock and the COUNTER DELTAS attributable
  to this run (dispatches, prefetch overlap, cache economics, retries,
  faults, CUDA graph captures);
* the result rides the artifact: ``model.run_report_`` on every fitted
  model, ``ctx.report()`` on a ServingContext — JSON-dumpable via
  ``to_json()``.

Deltas are per-RUN attribution only insofar as runs don't overlap: two
concurrent fits in one process both see the shared counters move (the
registry is process-global by design — same caveat the legacy dicts had).
"""

from __future__ import annotations

import json
import time

__all__ = ["REPORT_SCHEMA_VERSION", "RunReport", "counter_families"]

#: the JAX package's report schema. 2 = the goodput (wall decomposition)
#: and device_memory (ledger) sections of obs/prof.py — both ABSENT (not
#: null) under OTPU_PROF=0 and in reports that are not a fit's.
REPORT_SCHEMA_VERSION = 2

#: derived ratio fields recomputed by the shims — meaningless to delta
_DERIVED = {"overlap_pct", "pad_overhead", "mb_merge_factor"}


def counter_families() -> dict:
    """Current {family: counters} view of the three legacy shim families
    plus the CUDA graph capture count."""
    from orange3_spark_tpu_torch.utils.profiling import (
        exec_counters, graph_capture_count, resilience_counters,
        serve_counters,
    )

    return {
        "exec": exec_counters(),
        "serve": serve_counters(),
        "resilience": resilience_counters(),
        "graph_captures": graph_capture_count(),
    }


def _delta(before, after):
    if isinstance(after, dict):
        out = {}
        for k, v in after.items():
            if k in _DERIVED:
                out[k] = v          # end-state ratio, not a difference
                continue
            d = _delta((before or {}).get(k), v)
            if d or not isinstance(d, dict):
                out[k] = d
        return out
    if isinstance(after, (int, float)) and isinstance(
            before, (int, float)):
        d = after - before
        return round(d, 9) if isinstance(d, float) else d
    return after


class RunReport:
    """See module docstring. ``kind`` names the run ("fit_stream",
    "serving", ...); free-form ``meta`` identifies the subject."""

    def __init__(self, kind: str, **meta):
        self.kind = kind
        self.meta = dict(meta)
        self.stage_times: dict = {}
        self.started_at = time.time()
        self._t0 = time.perf_counter()
        self._t0_ns = time.perf_counter_ns()
        self._c0 = counter_families()
        self.wall_s: float | None = None
        self.counters: dict | None = None
        self.slow_traces: list | None = None
        # obs/prof.py sections (attach_fit_report): the wall-time
        # decomposition and the device-memory ledger view at fit end
        self.goodput: dict | None = None
        self.device_memory: dict | None = None

    def _slow_traces(self) -> list:
        """Top-k slowest trace trees among spans recorded since this run
        started — the report's link into the trace ring (a report names
        the trace ids an operator can pull from the exported Chrome
        trace or a flight bundle)."""
        from orange3_spark_tpu_torch.obs.trace import slowest_traces

        return slowest_traces(5, since_ns=self._t0_ns)

    def add(self, **fields) -> "RunReport":
        """Merge run-level facts (resolved decisions, warmup info)."""
        self.meta.update(fields)
        return self

    def finish(self) -> "RunReport":
        """Freeze the wall clock, counter deltas and the slow-trace view
        (idempotent: the first call wins, so a fit's report isn't
        re-bracketed by its caller)."""
        if self.wall_s is None:
            self.wall_s = round(time.perf_counter() - self._t0, 6)
            self.counters = _delta(self._c0, counter_families())
            self.slow_traces = self._slow_traces()
        return self

    def to_dict(self) -> dict:
        """Current view — a finished report's frozen numbers, a live one's
        deltas-so-far (``ctx.report()`` polls a long-lived context)."""
        if self.wall_s is not None:
            wall, counters = self.wall_s, self.counters
            slow = self.slow_traces if self.slow_traces is not None else []
        else:
            wall = round(time.perf_counter() - self._t0, 6)
            counters = _delta(self._c0, counter_families())
            slow = self._slow_traces()
        out = {
            "report_schema": REPORT_SCHEMA_VERSION,
            "kind": self.kind,
            "meta": dict(self.meta),
            "started_at": self.started_at,
            "wall_s": wall,
            "stage_times": dict(self.stage_times),
            "counters": counters,
            "slow_traces": slow,
        }
        if self.goodput is not None:
            out["goodput"] = self.goodput
        if self.device_memory is not None:
            out["device_memory"] = self.device_memory
        return out

    def to_json(self, path: str | None = None, **dump_kw) -> str:
        text = json.dumps(self.to_dict(), default=str, **dump_kw)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = "finished" if self.wall_s is not None else "live"
        return f"RunReport({self.kind!r}, {state}, meta={self.meta!r})"
