"""Shadow gate — the candidate scores live traffic before it may serve.

The candidate re-scores a deterministic sample of the logged request
chunks in the standby executable path (it is a distinct model object, so
its serving fingerprint keys its OWN bucket programs — the serving
model's cache is untouched), and its predicted classes are compared
row-by-row against the serving model's. Disagreement past
``OTPU_ONLINE_SHADOW_DISAGREE`` raises :class:`ShadowMismatchError`.

Shadow dispatches ride the EXISTING admission control: each scored chunk
runs under a ``request_deadline`` scope, so under overload the shadow
work sheds first (``OverloadShedError`` — counted, never failed) and can
never starve real traffic. Sampling is the seeded-crc32 per-ordinal coin
(``OTPU_ONLINE_SHADOW_SAMPLE``), the fault-grammar convention — the same
chunks shadow in a subprocess drill and an in-process test.

Skipped under ``OTPU_RESILIENCE=0``. Outcomes tick
``otpu_online_shadow_total{outcome=scored|shed}``.
"""

from __future__ import annotations

import zlib

import numpy as np

from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

__all__ = ["ShadowMismatchError", "ShadowScorer"]

_M_SHADOW = REGISTRY.counter(
    "otpu_online_shadow_total",
    "candidate shadow-scoring chunk outcomes (scored / shed)")


class ShadowMismatchError(RuntimeError):
    """The candidate disagreed with the serving model on too much live
    traffic. Carries the measured disagreement fraction, the bound, and
    the evidence size."""

    def __init__(self, *, disagreement: float, threshold: float,
                 rows_scored: int, chunks_scored: int, chunks_shed: int,
                 trace_id: str | None = None):
        self.disagreement = disagreement
        self.threshold = threshold
        self.rows_scored = rows_scored
        self.chunks_scored = chunks_scored
        self.chunks_shed = chunks_shed
        self.trace_id = trace_id
        tr = f" [trace {trace_id}]" if trace_id else ""
        super().__init__(
            f"shadow gate: candidate disagreed with the serving model on "
            f"{disagreement:.1%} of {rows_scored} shadow-scored rows "
            f"(bound {threshold:.1%}, {chunks_scored} chunks scored, "
            f"{chunks_shed} shed under load){tr}. The candidate was "
            "quarantined. OTPU_RESILIENCE=0 disables this gate.")


class ShadowScorer:
    """One shadow pass per promotion attempt (module doc)."""

    def __init__(self, serving_model, *, sample: float | None = None,
                 disagree_threshold: float | None = None, seed: int = 0,
                 deadline_s: float = 1.0):
        self.serving_model = serving_model
        self.sample = float(sample if sample is not None
                            else knobs.get_float("OTPU_ONLINE_SHADOW_SAMPLE"))
        self.threshold = float(
            disagree_threshold if disagree_threshold is not None
            else knobs.get_float("OTPU_ONLINE_SHADOW_DISAGREE"))
        self.seed = int(seed)
        self.deadline_s = float(deadline_s)

    def _sampled(self, ordinal: int) -> bool:
        h = zlib.crc32(f"{self.seed}:{ordinal}".encode()) / 0xFFFFFFFF
        return h < self.sample

    def score(self, candidate, chunks) -> dict:
        """Shadow-score ``candidate`` over ``chunks`` (iterable of
        ``(ordinal, X)``); raise typed past the disagreement bound.
        Returns the evidence dict. No-op under OTPU_RESILIENCE=0."""
        from orange3_spark_tpu_torch.resilience.faults import resilience_enabled
        from orange3_spark_tpu_torch.resilience.overload import (
            OverloadShedError, request_deadline,
        )

        result = {"rows_scored": 0, "chunks_scored": 0, "chunks_shed": 0,
                  "disagreement": 0.0, "sampled": 0}
        if not resilience_enabled():
            return result
        disagree_rows = 0
        for ordinal, X in chunks:
            if not self._sampled(ordinal):
                continue
            result["sampled"] += 1
            try:
                # the deadline scope is what makes shadow work shed-first:
                # under overload the admission controller's projected wait
                # exceeds it long before real traffic is refused
                with request_deadline(self.deadline_s):
                    pc = candidate.predict_proba(X)
                    ps = self.serving_model.predict_proba(X)
            except OverloadShedError:
                result["chunks_shed"] += 1
                _M_SHADOW.inc(1, outcome="shed")
                continue
            disagree_rows += int(np.sum(np.argmax(pc, axis=1)
                                        != np.argmax(ps, axis=1)))
            result["rows_scored"] += int(X.shape[0])
            result["chunks_scored"] += 1
            _M_SHADOW.inc(1, outcome="scored")
        if result["rows_scored"]:
            result["disagreement"] = disagree_rows / result["rows_scored"]
        if result["disagreement"] > self.threshold:
            from orange3_spark_tpu_torch.obs import trace as _trace
            from orange3_spark_tpu_torch.obs.context import (
                current_trace_id, flag_current_trace,
            )

            _trace.instant("shadow_mismatch",
                           disagreement=result["disagreement"],
                           rows=result["rows_scored"])
            flag_current_trace()
            err = ShadowMismatchError(
                disagreement=result["disagreement"],
                threshold=self.threshold,
                rows_scored=result["rows_scored"],
                chunks_scored=result["chunks_scored"],
                chunks_shed=result["chunks_shed"],
                trace_id=current_trace_id())
            from orange3_spark_tpu_torch.obs.flight import auto_dump

            auto_dump("shadow_mismatch", err)
            raise err
        return result
