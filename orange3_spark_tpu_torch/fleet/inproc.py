"""In-process replica lanes (``OTPU_FLEET_INPROC=N``).

One process, N serving *lanes*, zero serialization: each
:class:`LaneClient` is a FleetClient-shaped facade over a shared
:class:`~orange3_spark_tpu_torch.fleet.replica.ReplicaRuntime`. The port
runs on one device (the multi-device slice is still to come), so every
lane dispatches on the runtime's device: the lanes are N concurrent
callers of its bucket programs, each entry's lock serializing replays. The lanes sit behind the
ordinary :class:`~orange3_spark_tpu_torch.fleet.router.FleetRouter`, so
least-inflight selection, per-lane circuit breakers, hedging, failover
and the coalescer all run UNCHANGED — the router's least-inflight over
lane endpoints *is* lane-level least-inflight routing — and the fleet
tests exercise the same code paths against lanes that they do against
subprocess replicas.

A lane reproduces the wire handler's semantics without the wire: the
trace id is adopted via ``propagated_scope`` and the echoed header
carries what the serving path actually picked up; an explicit deadline
becomes a ``request_deadline`` scope so replica-side admission sheds
typed (:class:`~orange3_spark_tpu_torch.fleet.rpc.ReplicaOverloadedError`);
coalesced member ids ride ``dispatch_traces_scope`` into the device
dispatch's flow events; failures map onto the same typed errors the
router classifies on the wire path.
"""

from __future__ import annotations

import math
from contextlib import nullcontext

import numpy as np

from orange3_spark_tpu_torch.fleet.rpc import (
    TRACE_HEADER,
    VERSION_HEADER,
    ReplicaDrainingError,
    ReplicaOverloadedError,
    ReplicaUnavailableError,
)

__all__ = ["InprocFleet", "LaneClient"]


class LaneClient:
    """One serving lane with the FleetClient surface
    (``predict``/``ready``/``get_json``/``get_text``/``post_json``)."""

    def __init__(self, runtime, lane_id: int):
        self.runtime = runtime
        self.lane_id = lane_id
        self.name = f"lane-{lane_id}"

    def close(self) -> None:            # router.close() parity; no pool
        pass

    # ---------------------------------------------------------- data plane
    def predict(self, X, *, trace_id: str | None = None,
                timeout_s: float | None = None,
                conn_slot: list | None = None,
                member_traces: list | None = None):
        from orange3_spark_tpu_torch.obs.context import (
            current_trace_id, propagated_scope,
        )
        from orange3_spark_tpu_torch.resilience.overload import (
            OverloadShedError, request_deadline,
        )
        from orange3_spark_tpu_torch.serve.context import dispatch_traces_scope

        runtime = self.runtime
        if runtime.draining:
            raise ReplicaDrainingError(
                replica=self.name, trace_id=trace_id,
                in_flight=runtime.in_flight)
        dl = (timeout_s if timeout_s is not None
              and math.isfinite(timeout_s) else None)
        try:
            with propagated_scope(trace_id, "serve"):
                carried = current_trace_id() or ""
                with (request_deadline(dl) if dl is not None
                      else nullcontext()):
                    with (dispatch_traces_scope(member_traces)
                          if member_traces else nullcontext()):
                        out = runtime.predict(X)
        except (ReplicaDrainingError, ReplicaOverloadedError):
            raise
        except OverloadShedError as e:
            raise ReplicaOverloadedError(
                f"lane {self.name} shed the request: {e}",
                replica=self.name,
                reason=getattr(e, "reason", "overload"),
                trace_id=trace_id) from e
        except Exception as e:  # noqa: BLE001 — the wire's 500 mapping
            raise ReplicaUnavailableError(
                f"lane {self.name} predict failed: "
                f"{type(e).__name__}: {e}", replica=self.name,
                reason="inproc", trace_id=trace_id) from e
        return np.asarray(out), {TRACE_HEADER: carried,
                                 VERSION_HEADER: runtime.version or ""}

    # ------------------------------------------------------- control plane
    def ready(self, *, timeout_s: float | None = None):
        status, body = self.get_json("/readyz")
        return status == 200 and bool(body.get("ready")), body

    def get_json(self, path: str, *, timeout_s: float | None = None):
        route = path.split("?")[0]
        runtime = self.runtime
        if route == "/readyz":
            from orange3_spark_tpu_torch.obs.server import ready_body

            body, ready = ready_body(runtime.serving_context)
            body["version"] = runtime.version
            body["replica"] = self.name
            return (200 if ready else 503), body
        if route == "/healthz":
            body, healthy = runtime.health()
            return (200 if healthy else 503), body
        if route == "/debug/spans":
            from orange3_spark_tpu_torch.obs.server import spans_body

            return 200, spans_body(path)
        if route == "/debug/stacks":
            from orange3_spark_tpu_torch.obs.server import stacks_body

            return 200, stacks_body()
        if route == "/debug/flight":
            from orange3_spark_tpu_torch.obs import flight

            return 200, flight.debug_bundle(
                context=runtime.serving_context)
        return 404, {}

    def get_text(self, path: str, *, timeout_s: float | None = None):
        if path.split("?")[0] == "/metrics":
            from orange3_spark_tpu_torch.obs.registry import REGISTRY

            return 200, REGISTRY.to_prometheus()
        status, body = self.get_json(path)
        import json as _json

        return status, _json.dumps(body, default=str)

    def post_json(self, path: str, obj: dict | None = None, *,
                  timeout_s: float | None = None):
        runtime = self.runtime
        route = path.split("?")[0]
        if route == "/drain":
            runtime.initiate_drain(reason="drain_endpoint")
            return 200, {"draining": True}
        if route == "/reload":
            try:
                version = runtime.reload(str((obj or {})["version"]))
                return 200, {"version": version}
            except Exception as e:  # noqa: BLE001 — typed to caller
                return 500, {"error": type(e).__name__,
                             "message": str(e),
                             "version": runtime.version}
        return 404, {}


class InprocFleet:
    """N lanes over one activated ReplicaRuntime; hand ``endpoints()``
    to a FleetRouter and the fleet code paths run without a single
    socket. The runtime serves on ``session``'s device (default the
    active ``TorchSession``)."""

    def __init__(self, root: str, *, lanes: int, session=None,
                 ladder_max: int = 1 << 12):
        from orange3_spark_tpu_torch.core.session import TorchSession
        from orange3_spark_tpu_torch.fleet.replica import ReplicaRuntime
        from orange3_spark_tpu_torch.serve import BucketLadder

        self.runtime = ReplicaRuntime(
            root, name="inproc", session=session or TorchSession.active(),
            ladder=BucketLadder(min_bucket=64, max_bucket=ladder_max))
        self.runtime.activate()
        self.clients = [LaneClient(self.runtime, i)
                        for i in range(max(1, int(lanes)))]

    def endpoints(self) -> list:
        from orange3_spark_tpu_torch.fleet.router import ReplicaEndpoint

        eps = []
        for c in self.clients:
            ep = ReplicaEndpoint(c.lane_id, "127.0.0.1", 0, client=c)
            ep.ready = True             # no poll latency: lanes are us
            ep.version = self.runtime.version
            eps.append(ep)
        return eps

    def close(self) -> None:
        self.runtime.close()
