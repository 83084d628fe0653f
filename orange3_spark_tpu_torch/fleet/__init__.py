"""fleet/ — the multi-process serving layer.

Everything below ``ServingContext`` is one Python process; this
package is the layer that turns that fast single process into a fast
*service*: N supervised replica subprocesses behind a health-aware
router with request hedging and zero-downtime version rollout —

* ``rpc``        stdlib npy-over-HTTP inference wire + typed errors;
  trace ids propagate across the process boundary via header
  (obs/context.py), so one trace spans router → replica → dispatch;
* ``replica``    the worker main: load published version, warm, serve,
  graceful drain on SIGTERM / ``POST /drain``, hot version reload;
* ``supervisor`` ``ReplicaManager`` — spawn/monitor/restart (seeded
  exponential backoff), drain-then-stop;
* ``router``     ``FleetRouter`` — /readyz-aware least-inflight routing,
  per-replica circuit breakers, retry-with-replica-exclusion,
  deterministic EWMA-p95 tail hedging (``OTPU_FLEET_HEDGE_*``);
* ``rollout``    atomic versioned publish + one-replica-at-a-time roll
  with canaries and automatic rollback (an attached SLO engine's
  mid-roll burn-rate alert rolls back too).

Fleet-WIDE telemetry — aggregated /metrics + /fleetz, cross-process
trace assembly, SLO burn-rate alerting, fleet incident bundles and the
FleetDigest load-signal snapshot — lives in obs/fleetobs.py
(kill-switch ``OTPU_FLEETOBS=0``).

Kill-switch: ``OTPU_FLEET=0`` — :class:`FleetFrontend` then serves on
the single-process path *exactly* (the raw in-process ``predict``, no
subprocess ever spawns; regression-pinned bitwise in
tests/test_torch_fleet.py).
"""

from __future__ import annotations

from orange3_spark_tpu_torch.fleet.rpc import (
    FleetClient,
    NoReplicaAvailableError,
    ReplicaDrainingError,
    ReplicaServer,
    ReplicaUnavailableError,
)

__all__ = [
    "FleetClient",
    "FleetFrontend",
    "NoReplicaAvailableError",
    "ReplicaDrainingError",
    "ReplicaServer",
    "ReplicaUnavailableError",
    "fleet_enabled",
]


def fleet_enabled() -> bool:
    """THE kill-switch (read per call, the ``OTPU_DONATE`` convention):
    ``OTPU_FLEET=0`` disables the multi-process layer — FleetFrontend
    serves in-process, ReplicaManager.start refuses."""
    from orange3_spark_tpu_torch.utils import knobs

    return knobs.get_bool("OTPU_FLEET")


class FleetFrontend:
    """One ``predict()`` facade over either serving shape.

    With the fleet enabled: publish the model (fleet/rollout.py), spawn
    ``n_replicas`` supervised workers, route through a hedged
    ``FleetRouter``. Under ``OTPU_FLEET=0`` (or ``n_replicas=0``):
    ``predict`` IS the raw single-process call — same object, same code
    path, bitwise-identical output, zero subprocesses — which is what
    makes the kill-switch a real escape hatch rather than a second
    implementation. The fleet serves on ``session``'s device (default
    the active ``TorchSession``): in-process lanes share that session,
    replica processes start with its device type."""

    def __init__(self, model, *, root: str | None = None,
                 n_replicas: int | None = None, n_cols: int | None = None,
                 env: dict | None = None, hedging: bool = True,
                 ladder_max: int = 1 << 12, start: bool = True,
                 ready_timeout_s: float = 120.0, session=None):
        self.model = model
        self.manager = None
        self.router = None
        self.root = root
        self._inproc = None
        if not fleet_enabled() or n_replicas == 0:
            return                      # single-process mode
        if root is None:
            raise ValueError("FleetFrontend needs root= (the versioned "
                             "model dir) to run a fleet")
        from orange3_spark_tpu_torch.core.session import TorchSession
        from orange3_spark_tpu_torch.fleet.rollout import (
            publish_version, read_current, read_version_meta,
        )
        from orange3_spark_tpu_torch.fleet.router import FleetRouter
        from orange3_spark_tpu_torch.fleet.supervisor import ReplicaManager

        from orange3_spark_tpu_torch.utils import knobs

        current = read_current(root)
        if current is None:
            if not n_cols:
                # fail in THIS process with the fix named, instead of N
                # replicas crash-looping on the same missing width
                raise ValueError(
                    "FleetFrontend needs n_cols= (the serving chunk "
                    "width) to publish a fleet-servable version — "
                    "replicas warm their bucket ladder from it before "
                    "reporting /readyz-ready")
            publish_version(model, root, n_cols=n_cols)
        elif not read_version_meta(root, current).get("n_cols"):
            raise ValueError(
                f"published version {current} under {root!r} carries no "
                "n_cols; republish with publish_version(model, root, "
                "n_cols=...)")
        session = session or TorchSession.active()
        inproc = knobs.get_int("OTPU_FLEET_INPROC")
        if inproc > 0:
            # one process, N lanes behind the SAME router
            # (fleet/inproc.py) — no subprocesses, no serialization
            from orange3_spark_tpu_torch.fleet.inproc import InprocFleet

            self._inproc = InprocFleet(
                root, lanes=inproc, ladder_max=ladder_max, session=session)
            self.router = FleetRouter(
                self._inproc.endpoints(), hedging=hedging)
            self.router.refresh()
            return
        self.manager = ReplicaManager(
            root, n_replicas=n_replicas, env=env, ladder_max=ladder_max,
            device=session.device.type)
        if start:
            self.manager.start()
            if not self.manager.wait_ready(timeout_s=ready_timeout_s):
                states = {h.replica_id: h.alive()
                          for h in self.manager.handles}
                self.close()
                raise TimeoutError(
                    f"fleet replicas not ready in {ready_timeout_s:.0f}s "
                    f"(alive: {states}); see {self.manager.log_dir}")
            self.router = FleetRouter(
                self.manager.endpoints(),
                hedging=hedging).start_health_poller()
            self.router.refresh()

    @property
    def mode(self) -> str:
        if self.router is None:
            return "local"
        return "inproc" if self._inproc is not None else "fleet"

    def predict(self, X):
        if self.router is None:
            # the single-process path EXACTLY — not a reimplementation
            return self.model.predict(X)
        return self.router.predict(X)

    def close(self) -> None:
        if self.router is not None:
            self.router.close()
            self.router = None
        if self.manager is not None:
            self.manager.stop_all()
            self.manager = None
        if self._inproc is not None:
            self._inproc.close()
            self._inproc = None

    def __enter__(self) -> "FleetFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
