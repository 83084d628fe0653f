"""Replica supervision — spawn, monitor, restart, drain-then-stop.

``ReplicaManager`` owns N replica worker subprocesses (fleet/replica.py
mains, launched in their own process groups so the repo's one
group-kill helper — utils/procs.py ``kill_process_group`` — can always
reap an escaped subtree). A monitor thread polls the children:

* a replica that EXITS UNEXPECTEDLY (crash, OOM-kill, the test drill's
  SIGKILL) is restarted on the same port after a seeded exponential
  backoff — the resilience retry schedule
  (``resilience/retry.py RetryPolicy``, seeded per replica so fleet
  restarts decorrelate while tests stay pinnable), reset once the
  replacement lives long enough to be considered stable;
* ``drain_stop`` performs the graceful ladder: ``POST /drain``
  (finish in-flight up to ``OTPU_DRAIN_S``, exit 0) → SIGTERM (same
  handler, for a replica whose listener already died) → group SIGKILL;
* ``kill`` is the hard-failure drill hook (group SIGKILL, NO stopping
  mark) — the supervisor should restart it; that is the test.

Ports are stable across restarts (replica i keeps its port), so a
router's endpoint table never changes — a restarted replica re-admits
itself through the router's /readyz polling + breaker half-open probe.
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from orange3_spark_tpu_torch.obs import trace
from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs
from orange3_spark_tpu_torch.utils.procs import kill_process_group

__all__ = ["ReplicaHandle", "ReplicaManager", "free_port"]

log = logging.getLogger("orange3_spark_tpu_torch")

_M_RESTARTS = REGISTRY.counter(
    "otpu_fleet_replica_restarts_total",
    "crashed replica subprocesses restarted by the supervisor")
#: the labeled lifecycle view (obs/fleetobs.py): crash-loops show up on
#: the fleet timeline per replica and reason, not only in supervisor state
_M_LIFECYCLE = REGISTRY.counter(
    "otpu_fleet_restarts_total",
    "supervised replica lifecycle events, by replica and reason "
    "(crash / drain / kill)")

#: a replica that survives this long has "started": its restart-backoff
#: ladder resets (a crash loop keeps climbing, a one-off crash does not
#: poison the next restart with a long delay)
STABLE_AFTER_S = 10.0


def free_port() -> int:
    """One free ephemeral port (bind-probe). Racy by nature — good
    enough for localhost test fleets; production deployments pin
    ``OTPU_FLEET_PORT_BASE``."""
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


class ReplicaHandle:
    """One supervised replica slot: stable id + port, current process."""

    def __init__(self, replica_id: int, port: int):
        self.replica_id = replica_id
        self.port = port
        self.proc: subprocess.Popen | None = None
        self.restarts = 0
        self.stopping = False          # drain_stop/stop_all in progress
        self.started_at = 0.0
        self.restart_due_at: float | None = None
        #: seconds from this process's spawn to its first /readyz 200
        #: seen by ``wait_ready`` (device start-up plus the ladder's
        #: warm-up), None until then
        self.ready_after_s: float | None = None

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ReplicaManager:
    """Spawn + supervise ``n_replicas`` fleet replica subprocesses."""

    def __init__(self, model_root: str, *, n_replicas: int | None = None,
                 port_base: int | None = None, env: dict | None = None,
                 per_replica_env: dict[int, dict] | None = None,
                 log_dir: str | None = None, ladder_max: int = 1 << 12,
                 monitor_period_s: float = 0.05,
                 python: str | None = None, device: str = "cuda"):
        from orange3_spark_tpu_torch.resilience.retry import RetryPolicy

        self.model_root = model_root
        self.n_replicas = int(n_replicas if n_replicas is not None
                              else knobs.get_int("OTPU_FLEET_REPLICAS"))
        base = int(port_base if port_base is not None
                   else knobs.get_int("OTPU_FLEET_PORT_BASE"))
        # kept for elastic growth: add_replica() allocates ports on the
        # same scheme the initial fleet used
        self.port_base = base
        self.env = dict(env or {})
        # per-replica overrides (e.g. an injected straggler:
        # one replica carries its own OTPU_FAULT_SPEC service delay)
        self.per_replica_env = {int(k): dict(v) for k, v in
                                (per_replica_env or {}).items()}
        self.log_dir = log_dir or os.path.join(model_root, "logs")
        self.ladder_max = ladder_max
        self.monitor_period_s = monitor_period_s
        self.python = python or sys.executable
        # every replica's serving device (replica.py --device): each is a
        # fresh interpreter spawned by Popen, never a fork of this process,
        # so a parent that touched CUDA hands none of its state down
        self.device = str(device)
        self.handles = [
            ReplicaHandle(i, base + i if base else free_port())
            for i in range(self.n_replicas)
        ]
        # per-replica seeded backoff: the same schedule a transient source
        # read retries on, so one knob family (OTPU_RETRY_*) tunes both.
        # Keyed by replica id, NOT list position: the autoscaler adds and
        # removes replicas, so ids and positions diverge over time
        self._policies = {i: RetryPolicy.from_env(seed=i)
                          for i in range(self.n_replicas)}
        self._lock = threading.Lock()
        self._monitor: threading.Thread | None = None
        self._stop = threading.Event()
        self._clients: dict[int, object] = {}
        # fleet-digest hook (obs/fleetobs.py FleetCollector publishes a
        # FleetDigest here each scrape): the load-signal surface the
        # autoscaler (fleet/control.py) grows/shrinks replicas from
        self._digest = None
        self._digest_cbs: list = []

    # ------------------------------------------------------------- spawning
    def _spawn(self, handle: ReplicaHandle) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        prev = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = repo + (os.pathsep + prev if prev else "")
        env.update(self.env)
        env.update(self.per_replica_env.get(handle.replica_id, {}))
        logf = open(os.path.join(
            self.log_dir, f"replica-{handle.replica_id}.log"), "ab")
        try:
            handle.proc = subprocess.Popen(
                [self.python, "-m", "orange3_spark_tpu_torch.fleet.replica",
                 "--port", str(handle.port),
                 "--model-root", self.model_root,
                 "--replica-id", str(handle.replica_id),
                 "--ladder-max", str(self.ladder_max),
                 "--device", self.device],
                stdout=logf, stderr=subprocess.STDOUT, env=env,
                start_new_session=True,      # own group: killable whole
            )
        finally:
            logf.close()                      # child holds its own fd
        handle.started_at = time.monotonic()
        log.info("fleet: spawned replica-%d pid %d port %d",
                 handle.replica_id, handle.proc.pid, handle.port)

    def start(self) -> "ReplicaManager":
        from orange3_spark_tpu_torch.fleet import fleet_enabled

        if not fleet_enabled():
            raise RuntimeError(
                "OTPU_FLEET=0: the serving fleet is disabled — use the "
                "single-process serving path (FleetFrontend does this "
                "automatically)")
        for h in self.handles:
            self._spawn(h)
        self._stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="otpu-fleet-supervisor")
        self._monitor.start()
        return self

    # ------------------------------------------------------------- clients
    def _handle(self, replica_id: int) -> ReplicaHandle:
        """Handle lookup BY ID (positions shift once the autoscaler
        removes a replica, so ``self.handles[rid]`` is wrong in general)."""
        for h in self.handles:
            if h.replica_id == replica_id:
                return h
        raise KeyError(f"unknown replica id {replica_id}")

    def client(self, replica_id: int):
        from orange3_spark_tpu_torch.fleet.rpc import FleetClient

        c = self._clients.get(replica_id)
        if c is None:
            h = self._handle(replica_id)
            c = self._clients[replica_id] = FleetClient(
                "127.0.0.1", h.port, name=f"replica-{replica_id}")
        return c

    def endpoints(self) -> list[tuple[int, str, int]]:
        return [(h.replica_id, "127.0.0.1", h.port) for h in self.handles]

    # ------------------------------------------------------- elastic sizing
    def add_replica(self) -> int:
        """Grow the fleet by one replica through the SAME spawn path a
        crash restart uses (fleet/control.py's scale-up). Returns the new
        replica id; the caller (autoscaler) registers it with the router,
        whose /readyz polling + breaker probe admit it once warm."""
        with self._lock:
            rid = (max((h.replica_id for h in self.handles), default=-1)
                   + 1)
            port = (self.port_base + rid if self.port_base
                    else free_port())
            h = ReplicaHandle(rid, port)
            from orange3_spark_tpu_torch.resilience.retry import RetryPolicy

            self._policies[rid] = RetryPolicy.from_env(seed=rid)
            self.handles.append(h)
            self._spawn(h)
        _M_LIFECYCLE.inc(1, replica=f"replica-{rid}", reason="scale_up")
        trace.instant("replica_add", replica=rid, port=port)
        return rid

    def remove_replica(self, replica_id: int) -> int | None:
        """Shrink the fleet by one replica: drain-then-stop (in-flight
        work finishes inside the drain budget — scale-down never kills
        live requests), then forget the handle so the monitor never
        restarts it. Returns the exit code (0 = clean drain)."""
        h = self._handle(replica_id)          # KeyError on unknown id
        code = self.drain_stop(replica_id)
        with self._lock:
            if h in self.handles:
                self.handles.remove(h)
            self._policies.pop(replica_id, None)
            c = self._clients.pop(replica_id, None)
        if c is not None:
            try:
                c.close()
            except Exception:  # noqa: BLE001 - already gone is fine
                pass
        self._unlink_uds(h.port)
        _M_LIFECYCLE.inc(1, replica=f"replica-{replica_id}",
                         reason="scale_down")
        trace.instant("replica_remove", replica=replica_id, rc=code)
        return code

    # --------------------------------------------------------- digest hook
    def on_digest(self, cb) -> None:
        """Register a FleetDigest consumer (the autoscaler hook)."""
        self._digest_cbs.append(cb)

    def publish_digest(self, digest) -> None:
        """FleetCollector's per-scrape publish: store the latest digest
        and fan it out to registered consumers (each guarded — a broken
        consumer must not kill the scrape loop's publish)."""
        self._digest = digest
        for cb in list(self._digest_cbs):
            try:
                cb(digest)
            except Exception:  # noqa: BLE001 - consumer's problem
                pass

    def latest_digest(self):
        return self._digest

    def wait_ready(self, timeout_s: float = 120.0,
                   poll_s: float = 0.1) -> bool:
        """Block until every replica answers /readyz 200 (or timeout).
        The default budget covers a CUDA replica: a fresh interpreter,
        the device's context and one graph capture a ladder rung."""
        deadline = time.monotonic() + timeout_s
        pending = {h.replica_id for h in self.handles}
        while pending and time.monotonic() < deadline:
            for rid in list(pending):
                ok, _ = self.client(rid).ready(timeout_s=0.5)
                if ok:
                    pending.discard(rid)
                    h = self._handle(rid)
                    if h.ready_after_s is None:
                        h.ready_after_s = time.monotonic() - h.started_at
            if pending:
                time.sleep(poll_s)
        return not pending

    # ------------------------------------------------------------ monitoring
    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            for h in list(self.handles):   # snapshot: scale ops mutate
                with self._lock:
                    if h.stopping or h.proc is None:
                        continue
                    rc = h.proc.poll()
                    if rc is None:
                        if (h.restarts and h.restart_due_at is None
                                and now - h.started_at >= STABLE_AFTER_S):
                            h.restarts = 0    # stable: backoff ladder resets
                        continue
                    if h.restart_due_at is None:
                        d = self._policies[h.replica_id].delay(
                            min(h.restarts, 8))
                        h.restart_due_at = now + d
                        log.warning(
                            "fleet: replica-%d exited rc=%s; restart %d "
                            "in %.2fs", h.replica_id, rc, h.restarts + 1, d)
                        # the crash lands on the fleet timeline the moment
                        # it is DETECTED (the interesting instant), not
                        # only once the backed-off respawn happens
                        trace.instant(
                            "replica_exit", replica=h.replica_id, rc=rc,
                            restart_in_s=round(d, 3),
                            restarts=h.restarts + 1)
                        continue
                    if now < h.restart_due_at:
                        continue
                    h.restart_due_at = None
                    h.restarts += 1
                    _M_RESTARTS.inc()
                    _M_LIFECYCLE.inc(
                        1, replica=f"replica-{h.replica_id}",
                        reason="crash")
                    trace.instant("replica_restart",
                                  replica=h.replica_id,
                                  restarts=h.restarts)
                    self._spawn(h)
            self._stop.wait(self.monitor_period_s)

    # ------------------------------------------------------------- stopping
    def kill(self, replica_id: int) -> None:
        """HARD kill (the failure drill): group SIGKILL, no stopping mark
        — the monitor must notice and restart it."""
        h = self._handle(replica_id)
        if h.proc is not None:
            _M_LIFECYCLE.inc(1, replica=f"replica-{replica_id}",
                             reason="kill")
            trace.instant("replica_kill", replica=replica_id,
                          pid=h.proc.pid)
            kill_process_group(h.proc, drain_s=5.0)
            # a hard-killed replica leaves its UDS socket file behind;
            # unlink it so clients fall back to TCP (and the stale-retry
            # rung) instead of connecting a dead socket until restart
            self._unlink_uds(h.port)

    def drain_stop(self, replica_id: int, *,
                   extra_wait_s: float = 5.0) -> int | None:
        """Graceful stop ladder: POST /drain → SIGTERM → group SIGKILL.
        Returns the replica's exit code (0 = clean drain)."""
        from orange3_spark_tpu_torch.fleet.rpc import (
            ReplicaUnavailableError, drain_budget_s,
        )

        h = self._handle(replica_id)
        with self._lock:
            h.stopping = True
        if h.proc is None:
            return None
        _M_LIFECYCLE.inc(1, replica=f"replica-{replica_id}",
                         reason="drain")
        trace.instant("replica_drain", replica=replica_id,
                      pid=h.proc.pid)
        budget = drain_budget_s() + extra_wait_s
        try:
            self.client(replica_id).post_json("/drain", timeout_s=2.0)
        except ReplicaUnavailableError:
            # listener already dead or never came up: signal instead (the
            # replica's SIGTERM handler is the same drain path)
            try:
                os.killpg(h.proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                return h.proc.poll()
        try:
            return h.proc.wait(timeout=budget)
        except subprocess.TimeoutExpired:
            log.warning("fleet: replica-%d ignored drain (+%.1fs); "
                        "killing its group", replica_id, budget)
            kill_process_group(h.proc, grace_s=1.0, drain_s=10.0)
            return h.proc.poll()

    def stop_all(self) -> dict[int, int | None]:
        """Drain-stop every replica and join the monitor."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        codes = {h.replica_id: self.drain_stop(h.replica_id)
                 for h in self.handles}
        for h in self.handles:          # no orphan sockets under run dir
            self._unlink_uds(h.port)
        return codes

    @staticmethod
    def _unlink_uds(port: int) -> None:
        from orange3_spark_tpu_torch.fleet import fastwire

        try:
            fastwire.unlink_uds_socket(port)
        except OSError:
            pass

    def __enter__(self) -> "ReplicaManager":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop_all()
