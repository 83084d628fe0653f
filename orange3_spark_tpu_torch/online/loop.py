"""Guarded promotion loop — the train-while-serve control plane.

Composes the whole subsystem: the request log + serving tap, the
incremental trainer, and the three-gate promotion pipeline that stands
between a candidate and the fleet::

    candidate --publish--> [drift gate] -> [shadow gate] -> Rollout.roll
                                |               |            (canary +
                                v               v             SLO burn)
                           quarantine      quarantine            |
                                                            rollback ->
                                                            quarantine

* a candidate is **published** first (publication makes a version
  AVAILABLE; only a completed roll moves ``CURRENT`` — fleet/rollout.py),
  so every rejected candidate leaves post-mortem evidence on disk;
* the **drift gate** (online/drift.py) rejects typed BEFORE any replica
  is touched; the **shadow gate** (online/shadow.py) likewise;
* the roll itself keeps the existing canary breaker + SLO burn-rate
  engine; a ``rolled_back`` outcome is quarantined too;
* every rejection lands in the store's ``REJECTED/`` ledger
  (``rollout.quarantine``) and :meth:`Rollout.roll` refuses quarantined
  versions forever.

Under ``OTPU_RESILIENCE=0`` the drift/shadow gates are inert (the
unguarded loop the failure drills demonstrate shipping a bad model);
under ``OTPU_ONLINE=0`` the whole loop is inert. ``publish_cycle()``
always returns an outcome dict — a dead trainer is a typed outcome, not
an exception out of the cadence thread.
"""

from __future__ import annotations

import threading

import numpy as np

from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

__all__ = ["OnlineLoop"]

_M_PROMOTIONS = REGISTRY.counter(
    "otpu_online_promotions_total",
    "online promotion-cycle outcomes (promoted / published / "
    "rejected_drift / rejected_shadow / rolled_back / skipped / "
    "trainer_dead)")


class OnlineLoop:
    """One continuous-learning control plane over one model store.

    ``router=None`` runs storeside only (publish + gates, no roll) —
    the single-process mode; with a fleet router attached a passing
    candidate rolls out replica by replica under canary + SLO guard."""

    def __init__(self, model, store_root: str, log_path: str, *,
                 session, reference_X=None, holdout_source=None,
                 router=None, canary_input=None, slo_engine=None,
                 min_examples: int | None = None,
                 publish_s: float | None = None,
                 trainer_kw: dict | None = None,
                 drift_kw: dict | None = None,
                 shadow_kw: dict | None = None):
        from orange3_spark_tpu_torch.io.reqlog import RequestLog
        from orange3_spark_tpu_torch.online.drift import (
            DriftDetector, feature_stats,
        )
        from orange3_spark_tpu_torch.online.shadow import ShadowScorer
        from orange3_spark_tpu_torch.online.tap import OnlineTap
        from orange3_spark_tpu_torch.online.trainer import IncrementalTrainer

        self.model = model
        self.store_root = store_root
        self.session = session
        self.router = router
        self.canary_input = canary_input
        self.slo_engine = slo_engine
        self.holdout_source = holdout_source
        self.min_examples = int(
            min_examples if min_examples is not None
            else knobs.get_int("OTPU_ONLINE_MIN_EXAMPLES"))
        self.publish_s = float(
            publish_s if publish_s is not None
            else knobs.get_float("OTPU_ONLINE_PUBLISH_S"))
        self.log = RequestLog(log_path)
        self.tap = OnlineTap(self.log)
        tkw = dict(trainer_kw or {})
        tkw.setdefault("checkpoint_path", log_path + ".ckpt")
        self.trainer = IncrementalTrainer(model, self.log,
                                          session=session, **tkw)
        self.drift = (DriftDetector(feature_stats(reference_X),
                                    **(drift_kw or {}))
                      if reference_X is not None else None)
        self.shadow = ShadowScorer(model, **(shadow_kw or {}))
        self.history: list[dict] = []
        self._stop = threading.Event()
        self._publisher: threading.Thread | None = None
        self._cycle_lock = threading.Lock()
        self._closed = False

    # ----------------------------------------------------------- lifecycle
    def __enter__(self) -> "OnlineLoop":
        self.tap.install()
        self.trainer.start()
        return self

    def start_publisher(self) -> None:
        """Run :meth:`publish_cycle` on the ``OTPU_ONLINE_PUBLISH_S``
        cadence until closed (drills call publish_cycle directly)."""
        self._publisher = threading.Thread(
            target=self._publish_loop, daemon=True,
            name="otpu-online-publisher")
        self._publisher.start()

    def _publish_loop(self) -> None:
        while not self._stop.wait(self.publish_s):
            self.publish_cycle()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, timeout_s: float = 10.0) -> None:
        """Idempotent, bounded teardown: uninstall the tap FIRST (no new
        log appends), stop the trainer (final drain + checkpoint), stop
        the publisher. A caller mid-``publish_cycle`` finishes; a caller
        arriving after close gets the typed refusal below."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self.tap.uninstall()
        try:
            self.trainer.stop(timeout_s=timeout_s)
        except Exception:  # noqa: BLE001 - teardown reports via status()
            pass
        if self._publisher is not None:
            self._publisher.join(timeout=timeout_s)
        self.log.close()

    # ------------------------------------------------------------- evidence
    def request_chunks(self, last_n: int | None = None) -> list:
        """``(ordinal, X)`` request chunks from the log (the drift/shadow
        evidence). Bench/drill scale reads the whole log; ``last_n``
        bounds the window."""
        from orange3_spark_tpu_torch.io.reqlog import KIND_REQUEST

        out = []
        for _nxt, ordinal, kind, _rid, arr in self.log.read_from(0):
            if kind == KIND_REQUEST:
                out.append((ordinal, arr))
        if last_n is not None:
            out = out[-last_n:]
        return out

    # ----------------------------------------------------------- promotion
    def publish_cycle(self) -> dict:
        """One guarded promotion attempt (module doc). Returns an
        outcome dict; never raises for a gated rejection or rollback."""
        from orange3_spark_tpu_torch.fleet import rollout as ro
        from orange3_spark_tpu_torch.obs import trace as _trace
        from orange3_spark_tpu_torch.online.drift import DriftDetectedError
        from orange3_spark_tpu_torch.online.shadow import ShadowMismatchError
        from orange3_spark_tpu_torch.online.tap import online_enabled
        from orange3_spark_tpu_torch.online.trainer import OnlineTrainerError
        from orange3_spark_tpu_torch.resilience.faults import resilience_enabled

        if not online_enabled():
            return {"outcome": "disabled", "version": None, "error": None}
        with self._cycle_lock:
            if self._closed:
                return self._done({"outcome": "closed", "version": None,
                                   "error": "loop closed"})
            try:
                st = self.trainer.result()
            except OnlineTrainerError as e:
                return self._done({"outcome": "trainer_dead",
                                   "version": None,
                                   "error": str(e)})
            if st["examples"] < self.min_examples or st["steps"] == 0:
                return self._done({
                    "outcome": "skipped", "version": None, "error": None,
                    "examples": st["examples"],
                    "min_examples": self.min_examples})
            candidate = self.trainer.candidate_model()
            p = self.model.params
            # bootstrap: the SERVING model is the store's first version, so
            # CURRENT points at the vetted baseline and a rejected first
            # candidate can never become CURRENT by bootstrap accident
            if not ro.list_versions(self.store_root):
                ro.publish_version(self.model, self.store_root,
                                   n_cols=p.n_dense + p.n_cat,
                                   extra_meta={"online_baseline": True})
            version = ro.publish_version(
                candidate, self.store_root, n_cols=p.n_dense + p.n_cat,
                extra_meta={"online_steps": st["steps"],
                            "online_examples": st["examples"]})
            _trace.instant("online_publish", version=version,
                           steps=st["steps"])
            guarded = resilience_enabled()
            try:
                if guarded and self.drift is not None:
                    chunks = self.request_chunks(last_n=16)
                    recent = (np.concatenate([c for _o, c in chunks])
                              if chunks else None)
                    self.drift.check(
                        recent_X=recent, candidate=candidate,
                        serving=self.model,
                        holdout_source=self.holdout_source)
                if guarded:
                    self.shadow.score(candidate, self.request_chunks())
            except DriftDetectedError as e:
                ro.quarantine(self.store_root, version,
                              f"DriftDetectedError:{e.kind}",
                              detail={"error": str(e)})
                return self._done({
                    "outcome": "rejected_drift", "version": version,
                    "error": f"{type(e).__name__}: {e}",
                    "quarantined": True})
            except ShadowMismatchError as e:
                ro.quarantine(self.store_root, version,
                              "ShadowMismatchError",
                              detail={"error": str(e)})
                return self._done({
                    "outcome": "rejected_shadow", "version": version,
                    "error": f"{type(e).__name__}: {e}",
                    "quarantined": True})
            if self.router is None:
                # storeside mode: the version is published and gated;
                # promotion (moving CURRENT) is the fleet's move
                return self._done({"outcome": "published",
                                   "version": version, "error": None})
            res = ro.Rollout(
                self.router, self.store_root,
                canary_input=self.canary_input,
                slo_engine=self.slo_engine).roll(version)
            if res["outcome"] == "rolled_back":
                ro.quarantine(self.store_root, version,
                              f"rollout:{res.get('error')}",
                              detail={"failed_replica":
                                      res.get("failed_replica")})
                _trace.instant("online_rollback", version=version)
                res = dict(res, quarantined=True)
                return self._done(res)
            _trace.instant("online_promoted", version=version)
            return self._done(res)

    def _done(self, res: dict) -> dict:
        _M_PROMOTIONS.inc(1, outcome=res["outcome"])
        self.history.append(res)
        return res

    # -------------------------------------------------------------- status
    def status(self) -> dict:
        """The one-shot loop view tools/online_top.py renders."""
        from orange3_spark_tpu_torch.fleet import rollout as ro

        return {
            "trainer": self.trainer.status(),
            "log_bytes": self.log.size_bytes,
            "store": {
                "current": ro.read_current(self.store_root),
                "versions": ro.list_versions(self.store_root),
                "quarantined": ro.list_quarantined(self.store_root),
            },
            "cycles": len(self.history),
            "last_outcome": (self.history[-1]["outcome"]
                             if self.history else None),
        }
