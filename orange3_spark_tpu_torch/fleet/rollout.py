"""Versioned model publish + zero-downtime rollout with auto-rollback.

**Publish** is the blue/green storage half: a version directory is
staged under a dot-tmp name (utils/checkpoint.py ``save_model`` writes
the payload) and ``os.replace``d into place — readers never see a
half-written version — then the ``CURRENT`` pointer file is rewritten
via the same tmp+rename. Layout::

    <root>/
      v0001/ model.pkl VERSION.json      # immutable once renamed in
      v0002/ ...
      CURRENT                            # "v0002\\n", atomically replaced

**Rollout** (:class:`Rollout`) replaces the serving version under live
traffic, one replica at a time:

1. hold the replica in the router (``set_admitted(False)`` — no new
   requests route to it) and wait for its in-flight count to quiesce;
2. ``POST /reload`` — the replica loads the new version into its
   standby via the ``load_state_pytree`` hot-reload keying, warms the
   fresh executables, and flips atomically (fleet/replica.py); a reload
   failure leaves the OLD version serving, untouched;
3. send ``OTPU_ROLLOUT_CANARY`` canary predicts straight at the flipped
   replica; a canary failure feeds the rollout breaker;
4. verify ``/readyz`` reports ready on the new version, re-admit.

Any step failing — reload error, canary breaker trip, readiness timeout
(``OTPU_ROLLOUT_TIMEOUT_S``) — aborts the roll and **rolls back**: every
already-flipped replica reloads the old version (same warm-then-flip
path), the ``CURRENT`` pointer is untouched, and the result says so.
Only a fully-completed roll moves ``CURRENT``. Outcomes tick
``otpu_fleet_rollouts_total{outcome=}``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time

from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

__all__ = [
    "Rollout",
    "RolloutError",
    "is_quarantined",
    "list_quarantined",
    "load_version_model",
    "publish_version",
    "publish_workflow_version",
    "quarantine",
    "read_current",
    "read_quarantine_meta",
    "read_version_meta",
]

log = logging.getLogger("orange3_spark_tpu_torch")

CURRENT_FILE = "CURRENT"
META_FILE = "VERSION.json"
REJECTED_DIR = "REJECTED"
_VERSION_RE = re.compile(r"^v(\d{4,})$")

_M_ROLLOUTS = REGISTRY.counter(
    "otpu_fleet_rollouts_total",
    "fleet version rollouts, by outcome (completed / rolled_back)")


class RolloutError(RuntimeError):
    """A rollout step failed (reload, canary, readiness); the fleet was
    rolled back to the previous version. Carries the failing replica id
    and the step that tripped."""

    def __init__(self, message: str, *, replica_id: int | None = None,
                 step: str = ""):
        self.replica_id = replica_id
        self.step = step
        super().__init__(message)


# ------------------------------------------------------------------ storage
def _atomic_write(path: str, text: str) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def list_versions(root: str) -> list[str]:
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    return sorted(n for n in names if _VERSION_RE.match(n)
                  and os.path.isdir(os.path.join(root, n)))


def publish_version(model, root: str, *, version: str | None = None,
                    n_cols: int | None = None,
                    extra_meta: dict | None = None) -> str:
    """Atomically publish ``model`` as a new version under ``root``.
    Returns the version id (``v0001``-style, auto-incremented unless
    given). ``n_cols`` rides VERSION.json so a replica knows its warmup
    chunk width without unpickling first.

    Publishing makes a version AVAILABLE; it moves the ``CURRENT``
    serving pointer only when none exists yet (bootstrap). After that,
    only a *completed* :meth:`Rollout.roll` moves it — so a replica
    that (re)starts mid-roll comes up on the version the fleet actually
    serves, and a rolled-back version leaves no trace on the pointer."""
    from orange3_spark_tpu_torch.utils.checkpoint import save_model

    os.makedirs(root, exist_ok=True)
    if version is None:
        have = list_versions(root)
        nxt = (int(_VERSION_RE.match(have[-1]).group(1)) + 1) if have else 1
        version = f"v{nxt:04d}"
    elif not _VERSION_RE.match(version):
        raise ValueError(f"version must match v<NNNN>, got {version!r}")
    final = os.path.join(root, version)
    if os.path.exists(final):
        raise FileExistsError(
            f"version {version} already published under {root} "
            "(versions are immutable — publish a new one)")
    staging = os.path.join(root, f".staging-{version}-{os.getpid()}")
    save_model(model, staging)
    meta = {"version": version, "model_class": type(model).__name__,
            "n_cols": n_cols, **(extra_meta or {})}
    with open(os.path.join(staging, META_FILE), "w",
              encoding="utf-8") as f:
        json.dump(meta, f)
    os.replace(staging, final)            # the atomic publish
    if read_current(root) is None:        # bootstrap only — see docstring
        _atomic_write(os.path.join(root, CURRENT_FILE), version + "\n")
    log.info("fleet: published %s -> %s", type(model).__name__, final)
    return version


def publish_workflow_version(workflow, root: str, *,
                             version: str | None = None,
                             extra_meta: dict | None = None) -> str:
    """Publish a :class:`~orange3_spark_tpu_torch.serve.workflow.ServedWorkflow`
    as ONE versioned unit: the pickle carries every stage's fitted state
    plus the graph spec, so a :meth:`Rollout.roll` of the version flips /
    canaries / rolls back the whole DAG atomically — a workflow can never
    serve stage A of v2 against stage B of v1. ``n_cols`` comes from the
    workflow's own boundary width; VERSION.json additionally records the
    DAG identity so replicas and the router can report which workflow a
    version serves."""
    meta = {
        "workflow": True,
        "dag": workflow.dag_name,
        "n_stages": workflow.n_stages,
        "stage_classes": [type(op["payload"]).__name__
                          if op["payload"] is not None else op["op"]
                          for op in workflow._ops],
        **(extra_meta or {}),
    }
    return publish_version(workflow, root, version=version,
                           n_cols=workflow.n_cols, extra_meta=meta)


_TENANT_NAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def _current_file(tenant: str | None = None) -> str:
    """The pointer file a (tenant-scoped) roll moves: ``CURRENT`` for
    the fleet, ``CURRENT-<tenant>`` for one tenant's independent line.
    Tenant names are path components here, so the charset is strict."""
    if not tenant:
        return CURRENT_FILE
    if not _TENANT_NAME_RE.match(tenant):
        raise ValueError(
            f"tenant name {tenant!r} cannot scope a rollout pointer "
            "(want letters, digits, '.', '_' or '-')")
    return f"{CURRENT_FILE}-{tenant}"


def read_current(root: str, tenant: str | None = None) -> str | None:
    """The serving version pointer. With ``tenant``, the tenant's own
    pointer wins and the fleet-wide ``CURRENT`` is the fallback — a
    tenant that never rolled independently follows the fleet."""
    names = ([_current_file(tenant), CURRENT_FILE] if tenant
             else [CURRENT_FILE])
    for name in names:
        try:
            with open(os.path.join(root, name), encoding="utf-8") as f:
                v = f.read().strip()
            if v:
                return v
        except FileNotFoundError:
            continue
    return None


def set_current(root: str, version: str, *,
                tenant: str | None = None) -> None:
    _atomic_write(os.path.join(root, _current_file(tenant)),
                  version + "\n")


def read_version_meta(root: str, version: str) -> dict:
    try:
        with open(os.path.join(root, version, META_FILE),
                  encoding="utf-8") as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return {}


def load_version_model(root: str, version: str):
    from orange3_spark_tpu_torch.utils.checkpoint import load_model

    return load_model(os.path.join(root, version))


# --------------------------------------------------------------- quarantine
def quarantine(root: str, version: str, reason: str, *,
               detail: dict | None = None) -> str:
    """Record ``version`` in the store's ``REJECTED/`` ledger. A
    quarantined version stays on disk (post-mortem evidence) but
    :meth:`Rollout.roll` refuses it forever — a candidate that tripped a
    promotion gate (or rolled back under canary/SLO fire) must never be
    re-promoted by a later cycle that no longer remembers why it failed.
    Idempotent (first reason wins); returns the ledger path."""
    ledger = os.path.join(root, REJECTED_DIR)
    os.makedirs(ledger, exist_ok=True)
    path = os.path.join(ledger, f"{version}.json")
    if not os.path.exists(path):
        _atomic_write(path, json.dumps(
            {"version": version, "reason": reason,
             "quarantined_at": time.time(), **(detail or {})}))
        log.warning("fleet: quarantined %s under %s (%s)", version, root,
                    reason)
    return path


def is_quarantined(root: str, version: str) -> bool:
    return os.path.exists(os.path.join(root, REJECTED_DIR,
                                       f"{version}.json"))


def list_quarantined(root: str) -> list[str]:
    try:
        names = os.listdir(os.path.join(root, REJECTED_DIR))
    except FileNotFoundError:
        return []
    return sorted(n[:-len(".json")] for n in names if n.endswith(".json"))


def read_quarantine_meta(root: str, version: str) -> dict:
    try:
        with open(os.path.join(root, REJECTED_DIR, f"{version}.json"),
                  encoding="utf-8") as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return {}


# ------------------------------------------------------------------ rollout
class Rollout:
    """One rolling version swap over a live fleet (see module doc).

    ``router`` supplies the endpoint table + per-replica traffic gate;
    ``canary_input`` (a small feature array) drives the post-flip canary
    predicts — None skips canaries (reload + readiness still gate)."""

    def __init__(self, router, root: str, *, canary_input=None,
                 canary_n: int | None = None,
                 timeout_s: float | None = None,
                 slo_engine=None,
                 clock=time.monotonic):
        self.router = router
        self.root = root
        self.canary_input = canary_input
        self.canary_n = int(canary_n if canary_n is not None
                            else knobs.get_int("OTPU_ROLLOUT_CANARY"))
        self.timeout_s = float(
            timeout_s if timeout_s is not None
            else knobs.get_float("OTPU_ROLLOUT_TIMEOUT_S"))
        # fleet SLO feed (obs/fleetobs.py SLOEngine): a burn-rate alert
        # that fires while the roll is in progress counts like a canary
        # breaker trip — the fleet-level error-rate half of rollback
        self.slo_engine = slo_engine
        self.clock = clock

    # -------------------------------------------------------------- steps
    def _quiesce(self, ep, budget_s: float = 5.0) -> None:
        """Wait for the held replica's router-side in-flight to drain
        (new traffic already routes elsewhere)."""
        deadline = self.clock() + budget_s
        while ep.inflight > 0 and self.clock() < deadline:
            time.sleep(0.01)

    def _reload(self, ep, version: str) -> None:
        status, body = ep.client.post_json(
            "/reload", {"version": version}, timeout_s=self.timeout_s)
        if status != 200 or body.get("version") != version:
            raise RolloutError(
                f"{ep.name} reload to {version} failed: "
                f"HTTP {status} {body.get('error', '')} "
                f"{body.get('message', '')}".strip(),
                replica_id=ep.replica_id, step="reload")

    def _canary(self, ep, version: str,
                tenant: str | None = None) -> None:
        """Post-flip canaries straight at the replica, feeding a rollout
        breaker: one failure past the breaker threshold means the new
        version cannot serve — roll back."""
        if self.canary_input is None or self.canary_n <= 0:
            return
        from orange3_spark_tpu_torch.resilience.overload import CircuitBreaker

        # explicit threshold: the shared OTPU_BREAKER_THRESHOLD knob is
        # tuned for serving/dispatch flap, and raising it there must not
        # silently disarm rollout canaries (threshold > canary_n would
        # let a version that fails EVERY canary complete its rollout)
        breaker = CircuitBreaker(f"rollout:{ep.name}", failure_threshold=1)
        # a tenant-scoped roll canaries AS that tenant: the probe rides
        # the X-OTPU-Tenant header, so replica-side admission exercises
        # exactly the quota path the tenant's real traffic will hit
        kw = {"tenant": tenant} if tenant else {}
        for i in range(self.canary_n):
            try:
                out, _ = ep.client.predict(
                    self.canary_input, trace_id=f"rollout-canary-{i}",
                    timeout_s=self.timeout_s, **kw)
                if out.shape[0] != self.canary_input.shape[0]:
                    raise RolloutError(
                        f"canary returned {out.shape[0]} rows for "
                        f"{self.canary_input.shape[0]}",
                        replica_id=ep.replica_id, step="canary")
                breaker.record_success()
            except Exception as e:  # noqa: BLE001 - breaker classifies
                breaker.record_failure()
                if breaker.state() != "closed":
                    raise RolloutError(
                        f"{ep.name} canary {i + 1}/{self.canary_n} on "
                        f"{version} tripped the rollout breaker: "
                        f"{type(e).__name__}: {e}",
                        replica_id=ep.replica_id, step="canary") from e

    def _check_slo(self, ep, version: str, alerts0: int) -> None:
        """A fleet burn-rate alert fired since the roll started means
        live traffic is burning error budget UNDER the new version —
        stop and roll back, exactly like a tripped canary breaker."""
        if self.slo_engine is None:
            return
        self.slo_engine.evaluate()
        fresh = self.slo_engine.alerts[alerts0:]
        if fresh:
            a = fresh[-1]
            raise RolloutError(
                f"SLO {a.slo!r} burn-rate alert ({a.rule} rule, burn "
                f"{a.burn_long:.1f}x) fired during the rollout of "
                f"{version}", replica_id=ep.replica_id, step="slo_burn")

    def _verify_ready(self, ep, version: str) -> None:
        deadline = self.clock() + self.timeout_s
        while self.clock() < deadline:
            ok, body = ep.client.ready(timeout_s=1.0)
            if ok and body.get("version") == version:
                ep.version = version
                return
            time.sleep(0.05)
        raise RolloutError(
            f"{ep.name} not ready on {version} within "
            f"{self.timeout_s:.0f}s", replica_id=ep.replica_id,
            step="readyz")

    def _rollback(self, flipped: list, old_version: str) -> list:
        """Best-effort: reload every already-flipped replica back to the
        old version. Returns replica ids that could not be restored."""
        failed = []
        for ep in flipped:
            try:
                self._reload(ep, old_version)
                self._verify_ready(ep, old_version)
            except Exception as e:  # noqa: BLE001 - best-effort restore
                log.error("fleet: rollback of %s to %s failed: %s",
                          ep.name, old_version, e)
                failed.append(ep.replica_id)
        return failed

    # ---------------------------------------------------------------- roll
    def roll(self, version: str, *, tenant: str | None = None) -> dict:
        """Swap the fleet to ``version``, one replica at a time. Returns
        a result dict (never raises for a clean rollback — the typed
        error rides ``result['error']``)::

            {"outcome": "completed" | "rolled_back",
             "version": ..., "previous": ..., "tenant": ...,
             "flipped": [ids], "error": str | None,
             "failed_replica": id | None, "rollback_failed": [ids]}

        With ``tenant``, the roll is TENANT-SCOPED: the previous version
        is the tenant's own pointer (falling back to the fleet's), the
        canaries probe as that tenant (quota path included), and a
        completed roll moves only ``CURRENT-<tenant>`` — the fleet-wide
        pointer and every other tenant's line are untouched, so tenants
        roll, canary and roll back independently through the same
        publish/flip machinery."""
        old = read_current(self.root, tenant)
        if old is None:
            raise RolloutError(f"no CURRENT under {self.root}")
        if not os.path.isdir(os.path.join(self.root, version)):
            raise RolloutError(f"version {version} not published under "
                               f"{self.root}")
        if is_quarantined(self.root, version):
            meta = read_quarantine_meta(self.root, version)
            raise RolloutError(
                f"version {version} is quarantined under {self.root} "
                f"(REJECTED ledger: {meta.get('reason', 'unknown')}) — "
                "a rejected candidate is never re-promoted; publish a "
                "new version", step="quarantine")
        alerts0 = (len(self.slo_engine.alerts)
                   if self.slo_engine is not None else 0)
        flipped: list = []
        for ep in list(self.router.endpoints):
            self.router.set_admitted(ep.replica_id, False)
            try:
                self._quiesce(ep)
                self._reload(ep, version)
                self._canary(ep, version, tenant)
                self._verify_ready(ep, version)
                self._check_slo(ep, version, alerts0)
            except Exception as e:  # noqa: BLE001 - roll back, report typed
                log.warning("fleet: rollout of %s halted at %s: %s; "
                            "rolling back %d replica(s)", version, ep.name,
                            e, len(flipped))
                # the failing replica still serves OLD (reload is
                # all-or-nothing) unless it flipped and failed later
                maybe_flipped = ([ep] if getattr(e, "step", "")
                                 in ("canary", "readyz", "slo_burn")
                                 else [])
                rollback_failed = self._rollback(
                    flipped + maybe_flipped, old)
                # (the finally below re-admits the failing replica)
                _M_ROLLOUTS.inc(1, outcome="rolled_back")
                return {"outcome": "rolled_back", "version": version,
                        "previous": old, "tenant": tenant,
                        "flipped": [f.replica_id for f in flipped],
                        "error": f"{type(e).__name__}: {e}",
                        "failed_replica": ep.replica_id,
                        "rollback_failed": rollback_failed}
            finally:
                self.router.set_admitted(ep.replica_id, True)
            flipped.append(ep)
        set_current(self.root, version, tenant=tenant)
        _M_ROLLOUTS.inc(1, outcome="completed")
        log.info("fleet: rollout %s -> %s completed over %d replicas%s",
                 old, version, len(flipped),
                 f" (tenant {tenant})" if tenant else "")
        return {"outcome": "completed", "version": version,
                "previous": old, "tenant": tenant,
                "flipped": [f.replica_id for f in flipped],
                "error": None, "failed_replica": None,
                "rollback_failed": []}
