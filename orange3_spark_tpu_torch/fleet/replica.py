"""Fleet replica worker — one serving process of the replica pool.

``python -m orange3_spark_tpu_torch.fleet.replica --port P --model-root DIR
[--device cuda|cpu]`` (what ``fleet/supervisor.py`` spawns) does, in order:

1. install the SIGTERM → graceful-drain handler;
2. build a ``TorchSession`` on the replica's device (``cuda`` unless the
   caller asks for ``cpu``; with no CUDA device it fails at start, never
   falls back), load the published ``CURRENT`` model version from ``DIR``
   onto that device (fleet/rollout.py layout: atomic versioned checkpoint
   dirs over utils/checkpoint.py), plus a second copy as the rollout
   STANDBY;
3. activate a ``ServingContext``, warm the bucket ladder (on CUDA one
   captured graph a rung, so no request pays a capture — this is what
   flips ``/readyz`` to 200);
4. serve ``POST /predict`` npy RPCs (fleet/rpc.py) until drained.

**Zero-downtime reload** (``POST /reload``): the new version's state
loads into the *standby* model object via the existing
``load_state_pytree`` hot-reload keying — the serving fingerprint moves,
so warming the standby builds fresh bucket programs for the new weights
while the OLD model keeps serving from its still-cached ones — then the
serving reference flips atomically (one assignment). A reload
that fails anywhere (load, state shape, warm) leaves the old version
serving untouched: per-replica rollback is free by construction.

**Graceful drain** (SIGTERM or ``POST /drain``): raise the drain flag
(``/readyz`` 503 ``draining``; new predicts refuse with typed
``ReplicaDrainingError``), wait for in-flight requests up to
``OTPU_DRAIN_S``, stop the listener, exit 0.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
import time

import numpy as np

__all__ = ["ReplicaRuntime", "main"]

log = logging.getLogger("orange3_spark_tpu_torch")


class ReplicaRuntime:
    """The replica's serving state machine (the ``runtime`` a
    :class:`~orange3_spark_tpu_torch.fleet.rpc.ReplicaServer` fronts)."""

    def __init__(self, model_root: str, *, name: str = "replica",
                 session=None, ladder=None, n_cols: int | None = None,
                 device: str | None = None):
        from orange3_spark_tpu_torch.core.session import TorchSession
        from orange3_spark_tpu_torch.fleet import rollout as ro
        from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

        self.model_root = model_root
        self.name = name
        # the device: the given session's, else ``device`` (default
        # 'cuda': TorchSession raises where CUDA is absent)
        self.session = session or TorchSession.builder_get_or_create(
            device if device is not None else "cuda")
        self.version = ro.read_current(model_root)
        if self.version is None:
            raise FileNotFoundError(
                f"no CURRENT version published under {model_root!r} "
                "(fleet.rollout.publish_version writes it)")
        meta = ro.read_version_meta(model_root, self.version)
        # workflow bundles record the DAG identity they serve (rollout.
        # publish_workflow_version); /readyz reports it so the router can
        # route/observe per DAG. None for plain per-model versions.
        self.dag = meta.get("dag")
        self._n_cols = n_cols if n_cols is not None else meta.get("n_cols")
        if not self._n_cols:
            # fail FAST and say how to fix it: without the serving chunk
            # width there is nothing to warm, and noting warmup complete
            # anyway would flip /readyz to 200 with every early request
            # paying a build — the exact lie the readiness gate exists
            # to prevent
            raise ValueError(
                f"version {self.version} under {model_root!r} carries no "
                "n_cols (the serving chunk width): publish with "
                "publish_version(model, root, n_cols=...) so the replica "
                "can warm its bucket ladder before reporting ready")
        self._model = self._load(self.version)
        # the standby is a SECOND instance of the same version: rollouts
        # hot-reload new state into it (fingerprint moves), warm it, and
        # flip — the serving model is never mutated under traffic
        self._standby = self._load(self.version)
        self.serving_context = ServingContext(
            ladder or BucketLadder(min_bucket=64, max_bucket=1 << 12))
        self._lock = threading.Lock()          # reload/drain transitions
        self._inflight_lock = threading.Lock()
        self._in_flight = 0
        self._idle = threading.Condition(self._inflight_lock)
        self.draining = False
        self._drain_reason: str | None = None
        self._server = None                    # attached by serve()/main
        self._exit_event = threading.Event()

    def _load(self, version: str):
        """Load a published version onto this replica's device (a model's
        tensors unpickle onto the active session's device)."""
        from orange3_spark_tpu_torch.fleet import rollout as ro

        with self.session.use():
            return ro.load_version_model(self.model_root, version)

    # ------------------------------------------------------------ lifecycle
    def activate(self) -> "ReplicaRuntime":
        self.serving_context.__enter__()
        self._warm(self._model)
        return self

    def _warm(self, model) -> None:
        """Build the ladder's bucket programs for ``model`` (readiness
        gate — ``n_cols`` is guaranteed by __init__). Array-serving models
        (the fleet's primary payload — raw-chunk predict) warm every rung;
        a model without the hook warms by one probe predict."""
        if hasattr(type(model), "_serve_array_fn"):
            self.serving_context.warmup(
                model, n_cols=int(self._n_cols), kinds=("array",))
            return
        probe = np.zeros((1, int(self._n_cols)), np.float32)
        model.predict(probe)
        from orange3_spark_tpu_torch.obs.server import note_warmup_complete

        note_warmup_complete()

    @property
    def in_flight(self) -> int:
        return self._in_flight

    # ------------------------------------------------------------- serving
    def predict(self, X: np.ndarray) -> np.ndarray:
        from orange3_spark_tpu_torch.fleet.rpc import ReplicaDrainingError
        from orange3_spark_tpu_torch.obs.context import current_trace_id

        with self._inflight_lock:
            if self.draining:
                raise ReplicaDrainingError(
                    replica=self.name, trace_id=current_trace_id(),
                    in_flight=self._in_flight)
            self._in_flight += 1
        try:
            from orange3_spark_tpu_torch.online.tap import tap_scope

            # the replica boundary is the online tap point: one log record
            # per request; the scope suppresses the inner served_array tap
            # so a tapped request is never double-logged
            with tap_scope(X):
                model = self._model    # atomic ref read — the flip point
                return np.asarray(model.predict(X))
        finally:
            with self._inflight_lock:
                self._in_flight -= 1
                if self._in_flight == 0:
                    self._idle.notify_all()

    def health(self) -> tuple[dict, bool]:
        """The obs-server liveness body, served off the data port."""
        from orange3_spark_tpu_torch.obs.server import TelemetryServer

        probe = TelemetryServer(context=self.serving_context)  # not started
        body, healthy = probe.health()
        body["replica"] = self.name
        body["version"] = self.version
        body["draining"] = self.draining
        body["device"] = str(self.session.device)
        return body, healthy

    # ------------------------------------------------------------- rollout
    def reload(self, version: str) -> str:
        """Load published ``version`` into the standby, warm, flip.
        Serialized (one reload at a time); raises on any failure with the
        OLD version still serving."""
        from orange3_spark_tpu_torch.fleet import rollout as ro

        with self._lock:
            if version == self.version:
                return self.version
            new_model = self._load(version)
            standby = self._standby
            if (type(standby) is type(new_model)
                    and getattr(standby, "params", None)
                    == getattr(new_model, "params", None)
                    # workflow bundles: in-place reload only when the DAG
                    # shape matches AND every stage's state rides
                    # state_pytree; otherwise replace the object (a fresh
                    # identity keys fresh executables, same as an
                    # architecture change)
                    and getattr(standby, "_bundle_sig", None)
                    == getattr(new_model, "_bundle_sig", None)
                    and getattr(new_model, "_hot_reloadable", True)):
                # same architecture: the hot-reload path — state loads in
                # place and load_state_pytree moves the serving
                # fingerprint, so _warm builds fresh bucket programs for
                # the new weights (stale ones retire through the LRU)
                standby.load_state_pytree(dict(new_model.state_pytree))
            else:
                # architecture changed: the standby becomes the freshly
                # loaded object (a new identity keys fresh programs)
                standby = new_model
            self._warm(standby)
            # the atomic flip: one reference assignment; in-flight
            # requests that already read self._model finish on the old
            # version (correct either way — both are warmed and whole)
            self._model, self._standby = standby, self._model
            old, self.version = self.version, version
            self.dag = ro.read_version_meta(self.model_root, version).get("dag")
            log.info("fleet: %s flipped %s -> %s", self.name, old, version)
            return self.version

    # --------------------------------------------------------------- drain
    def initiate_drain(self, *, reason: str = "sigterm") -> None:
        """Enter draining: refuse new predicts (typed), fail /readyz,
        finish in-flight work up to ``OTPU_DRAIN_S``, then stop the
        listener and let main exit 0. Idempotent."""
        from orange3_spark_tpu_torch.fleet.rpc import drain_budget_s
        from orange3_spark_tpu_torch.obs.server import set_draining

        with self._inflight_lock:
            if self.draining:
                return
            self.draining = True
            self._drain_reason = reason
        set_draining(True)
        threading.Thread(target=self._drain_then_stop,
                         args=(drain_budget_s(),), daemon=True,
                         name="otpu-fleet-drain").start()

    def _drain_then_stop(self, budget_s: float) -> None:
        deadline = time.monotonic() + max(budget_s, 0.0)
        with self._inflight_lock:
            while self._in_flight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    log.warning(
                        "fleet: %s drain budget (%.1fs) exhausted with %d "
                        "in flight; stopping anyway", self.name, budget_s,
                        self._in_flight)
                    break
                self._idle.wait(timeout=min(remaining, 0.1))
        server = self._server
        if server is not None:
            server.shutdown()
        self._exit_event.set()

    # ------------------------------------------------------------ in-process
    def serve_background(self, port: int = 0):
        """Bind + serve from a background thread (in-process drills and
        tests — the subprocess path is :func:`main`). Returns the
        ReplicaServer (its ``.port`` is the bound port)."""
        from orange3_spark_tpu_torch.fleet.rpc import ReplicaServer

        self._server = ReplicaServer(self, port).start_background()
        return self._server

    def close(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
        try:
            self.serving_context.__exit__(None, None, None)
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--model-root", required=True)
    ap.add_argument("--replica-id", default="0")
    ap.add_argument("--ladder-max", type=int, default=1 << 12)
    ap.add_argument("--device", default="cuda",
                    help="the serving device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(
        stream=sys.stderr, level=logging.INFO,
        format=f"[replica-{args.replica_id} %(asctime)s] %(message)s")

    from orange3_spark_tpu_torch.fleet.rpc import ReplicaServer
    from orange3_spark_tpu_torch.serve import BucketLadder

    runtime = ReplicaRuntime(
        args.model_root, name=f"replica-{args.replica_id}",
        ladder=BucketLadder(min_bucket=64, max_bucket=args.ladder_max),
        device=args.device)

    # SIGTERM = graceful drain (the supervisor's drain_stop and any
    # orchestrator's pod termination both land here); SIGINT likewise so
    # an interactive ^C drains instead of stack-tracing
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_a: runtime.initiate_drain())

    server = ReplicaServer(runtime, args.port)
    runtime._server = server
    runtime.activate()     # warm AFTER bind: /readyz answers 503
    #                        warmup_pending during the build window
    log.info("fleet: %s serving %s on 127.0.0.1:%d (version %s, device %s, "
             "pid %d)", runtime.name, args.model_root, server.port,
             runtime.version, runtime.session.device, os.getpid())
    server.serve_forever()            # returns after drain's shutdown()
    runtime._exit_event.wait(timeout=drain_wait_cap())
    try:
        runtime.serving_context.__exit__(None, None, None)
    except Exception:  # noqa: BLE001 - exiting anyway
        pass
    log.info("fleet: %s drained (%s); exiting 0", runtime.name,
             runtime._drain_reason or "shutdown")
    return 0


def drain_wait_cap() -> float:
    from orange3_spark_tpu_torch.fleet.rpc import drain_budget_s

    return drain_budget_s() + 5.0


if __name__ == "__main__":
    sys.exit(main())
