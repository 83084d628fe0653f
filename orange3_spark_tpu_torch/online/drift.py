"""Drift gate — typed rejection of candidates trained on shifted traffic.

Two independent checks, both against the SERVING model's world:

1. **Feature-stats delta**: per-column mean of the recent tapped traffic
   vs the serving model's training distribution (mean/var captured at
   training time), normalized to a z-score by the reference spread.
   Columns past ``OTPU_ONLINE_DRIFT_Z`` raise
   :class:`DriftDetectedError` NAMING the offending features — "which
   columns moved" is the first question a paged operator asks.
2. **Holdout regression bound**: the candidate's holdout metric (AUC,
   falling back to accuracy when AUC is undefined) may not fall more
   than ``OTPU_ONLINE_HOLDOUT_DROP`` below the serving model's — the
   label-poisoning catch (a ``label_skew``-injected trainer produces a
   candidate whose FEATURES look fine).

Both checks are skipped under ``OTPU_RESILIENCE=0`` (the unguarded loop
the failure drills demonstrate shipping a bad model). A trip ticks
``otpu_online_drift_checks_total{outcome=}``, lands a ``drift`` instant
on the obs timeline and dumps a flight bundle — the numerics-guard
template (resilience/numerics.py).
"""

from __future__ import annotations

import numpy as np

from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

__all__ = ["DriftDetectedError", "DriftDetector", "feature_stats"]

_M_DRIFT = REGISTRY.counter(
    "otpu_online_drift_checks_total",
    "online promotion drift-gate checks, by outcome "
    "(clean / feature_shift / holdout_regression)")


class DriftDetectedError(RuntimeError):
    """The candidate (or the traffic it trained on) drifted past the
    gate. ``kind`` is 'feature_shift' or 'holdout_regression';
    ``features`` lists offending column indices (feature_shift);
    ``z_scores``/``metric_drop`` carry the measured magnitudes."""

    def __init__(self, *, kind: str, features: list[int] | None = None,
                 z_scores: list[float] | None = None,
                 metric: str = "", metric_drop: float | None = None,
                 threshold: float | None = None,
                 trace_id: str | None = None):
        self.kind = kind
        self.features = list(features or [])
        self.z_scores = list(z_scores or [])
        self.metric = metric
        self.metric_drop = metric_drop
        self.threshold = threshold
        self.trace_id = trace_id
        if kind == "feature_shift":
            cols = ", ".join(
                f"{f} (z={z:.1f})" for f, z in zip(self.features,
                                                  self.z_scores))
            msg = (f"drift detected: feature mean shift past "
                   f"z={threshold:g} on column(s) {cols} vs the serving "
                   "model's training distribution")
        else:
            msg = (f"drift detected: candidate {metric} regressed "
                   f"{metric_drop:.4f} on holdout (bound "
                   f"{threshold:g}) vs the serving model")
        tr = f" [trace {trace_id}]" if trace_id else ""
        super().__init__(
            msg + tr + ". The candidate was quarantined; it will not be "
            "re-promoted. OTPU_RESILIENCE=0 disables this gate.")


def feature_stats(X: np.ndarray) -> dict:
    """Reference per-column stats of a training matrix — what the online
    loop pins as 'the serving model's training distribution'. (At
    out-of-core scale use io.streaming.stream_feature_stats, which
    returns the same keys.)"""
    X = np.asarray(X, np.float64)
    return {"count": float(X.shape[0]),
            "mean": X.mean(axis=0),
            "var": X.var(axis=0)}


class DriftDetector:
    """One gate instance per promotion pipeline (module doc)."""

    def __init__(self, reference: dict, *, z_threshold: float | None = None,
                 holdout_drop: float | None = None):
        self.reference = reference
        self.z_threshold = float(
            z_threshold if z_threshold is not None
            else knobs.get_float("OTPU_ONLINE_DRIFT_Z"))
        self.holdout_drop = float(
            holdout_drop if holdout_drop is not None
            else knobs.get_float("OTPU_ONLINE_HOLDOUT_DROP"))

    # ------------------------------------------------------------ checks
    def check_features(self, recent_X: np.ndarray) -> list[float]:
        """Raise typed when the recent traffic's per-column means moved
        past the z bound; returns the per-column z-scores otherwise."""
        recent_X = np.asarray(recent_X, np.float64)
        n = max(recent_X.shape[0], 1)
        ref_mean = np.asarray(self.reference["mean"], np.float64)
        ref_var = np.asarray(self.reference["var"], np.float64)
        mean_r = recent_X.mean(axis=0)
        # standard error of the recent-window mean under the reference
        # spread; the 1e-12 floor keeps constant columns finite
        se = np.sqrt(ref_var / n) + 1e-12
        z = np.abs(mean_r - ref_mean) / se
        bad = np.nonzero(z > self.z_threshold)[0]
        if bad.size:
            self._trip("feature_shift", features=[int(i) for i in bad],
                       z_scores=[float(z[i]) for i in bad])
        return [float(v) for v in z]

    def check_holdout(self, candidate, serving, holdout_source) -> dict:
        """Raise typed when the candidate's holdout metric regressed past
        the bound; returns both models' metric dicts otherwise."""
        mc = candidate.evaluate_stream(holdout_source)
        ms = serving.evaluate_stream(holdout_source)
        metric = "auc" if (mc.get("auc") is not None
                           and ms.get("auc") is not None) else "accuracy"
        drop = float(ms[metric]) - float(mc[metric])
        if drop > self.holdout_drop:
            self._trip("holdout_regression", metric=metric,
                       metric_drop=drop)
        return {"candidate": mc, "serving": ms, "metric": metric,
                "drop": drop}

    def check(self, *, recent_X=None, candidate=None, serving=None,
              holdout_source=None) -> None:
        """The full gate, in cost order: feature stats first (cheap host
        arithmetic), holdout eval second. No-op under OTPU_RESILIENCE=0."""
        from orange3_spark_tpu_torch.resilience.faults import resilience_enabled

        if not resilience_enabled():
            return
        if recent_X is not None and len(recent_X):
            self.check_features(recent_X)
        if candidate is not None and holdout_source is not None \
                and serving is not None:
            self.check_holdout(candidate, serving, holdout_source)
        _M_DRIFT.inc(1, outcome="clean")

    # -------------------------------------------------------------- trip
    def _trip(self, kind: str, **kw) -> None:
        _M_DRIFT.inc(1, outcome=kind)
        from orange3_spark_tpu_torch.obs import trace as _trace
        from orange3_spark_tpu_torch.obs.context import (
            current_trace_id, flag_current_trace,
        )

        _trace.instant("drift", kind=kind,
                       **{k: v for k, v in kw.items()
                          if k in ("features", "metric", "metric_drop")})
        flag_current_trace()
        threshold = (self.z_threshold if kind == "feature_shift"
                     else self.holdout_drop)
        err = DriftDetectedError(kind=kind, threshold=threshold,
                                 trace_id=current_trace_id(), **kw)
        from orange3_spark_tpu_torch.obs.flight import auto_dump

        auto_dump("drift", err)
        raise err
