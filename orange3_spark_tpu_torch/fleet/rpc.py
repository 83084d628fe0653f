"""Fleet RPC — the stdlib inference wire between router and replica.

A replica is one Python process holding an activated ``ServingContext``
(serve/context.py) behind a ``ThreadingHTTPServer`` — the data-plane
sibling of the telemetry listener in obs/server.py. Wire format is
binary npy (``np.save``/``np.load`` over the request/response body):
zero dependencies, exact dtypes, and no JSON float round-trip on the
hot path.

Routes (loopback only, like the obs listener — exposure beyond the host
is a reverse proxy's job):

* ``POST /predict``  — body: one npy array of raw feature rows; response:
  the npy prediction vector. The router-minted trace id rides the
  ``X-OTPU-Trace`` header and is ADOPTED into obs/context.py
  (:func:`~orange3_spark_tpu_torch.obs.context.propagated_scope`), so one trace
  spans router → replica → device dispatch across the process boundary;
  the response echoes the id the serving path actually carried (the
  router's cross-process coverage measurement) plus the serving model
  version (``X-OTPU-Version``). A draining replica answers 503 with a
  typed ``ReplicaDrainingError`` payload instead of accepting work.
* ``GET /readyz`` / ``GET /healthz`` / ``GET /metrics`` — the obs
  server's readiness/liveness/exposition bodies served off the data
  port, so a router needs ONE address per replica.
* ``GET /debug/flight`` / ``GET /debug/stacks`` /
  ``GET /debug/spans?trace_id=`` — the replica's black box pulled off
  the SAME port (an operator needs no second listener): the flight
  bundle (written + returned, like the obs server's), every thread's
  stack + open spans, and the span-ring payload (with a wall/perf clock
  anchor) the fleet collector's cross-process trace assembly stitches
  (obs/fleetobs.py). Loopback-only like everything here.
* ``POST /drain``    — the loopback drain hook (same path as SIGTERM):
  finish in-flight work up to ``OTPU_DRAIN_S``, then exit 0.
* ``POST /reload``   — zero-downtime rollout hook (fleet/rollout.py):
  load the named published version into the standby model via the
  existing ``load_state_pytree`` hot-reload keying, warm it, flip
  atomically; 200 with the new version or 500 with the failure (the
  old version keeps serving — reload is all-or-nothing per replica).

The client half (:class:`FleetClient`) maps connect/read deadlines onto
socket timeouts — an ambient
:func:`~orange3_spark_tpu_torch.resilience.overload.request_deadline` scope
outranks the ``OTPU_FLEET_TIMEOUT_S`` default — and converts transport
failures into the typed errors the router's failover logic classifies.

**The fast path** (fleet/fastwire.py, ``OTPU_FLEET_FASTWIRE=0`` restores
everything above bitwise): requests reuse pooled keep-alive connections
(a stale pooled socket gets ONE typed reconnect-retry before any error
reaches the router/breaker; hedging still cancels a loser by closing its
connection), loopback predicts can ride shared-memory segments instead
of the npy body (``Content-Type: application/x-otpu-shm`` descriptor
both ways, typed npy fallback on any SHM failure — a replica that
cannot map the request segment answers 422 and the client re-sends that
one request as npy), and an optional ``AF_UNIX`` listener serves the
same routes through a 0600 socket under the fleet run dir. Two more
headers ride the predict: ``X-OTPU-Deadline-Ms`` (the caller's remaining
deadline, adopted into a replica-side ``request_deadline`` scope so
admission sheds nearly-expired work typed — 503 ``OverloadShedError`` →
:class:`ReplicaOverloadedError`, surfaced to the caller, never a breaker
trip or failover) and ``X-OTPU-Member-Traces`` (coalesced members' trace
ids, attached to the device dispatch's flow events).
"""

from __future__ import annotations

import io
import json
import math
import socket
import threading
from contextlib import nullcontext
from http.client import HTTPConnection, HTTPException
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from orange3_spark_tpu_torch.fleet import fastwire
from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

__all__ = [
    "FleetClient",
    "NoReplicaAvailableError",
    "ReplicaDrainingError",
    "ReplicaOverloadedError",
    "ReplicaServer",
    "ReplicaUnavailableError",
    "drain_budget_s",
]

NPY_CONTENT_TYPE = "application/x-npy"
TRACE_HEADER = "X-OTPU-Trace"
VERSION_HEADER = "X-OTPU-Version"
#: caller's remaining deadline in integer milliseconds; the replica
#: adopts it into a request_deadline scope so admission can shed typed
DEADLINE_HEADER = "X-OTPU-Deadline-Ms"
#: comma-joined trace ids of coalesced members riding one wire dispatch
MEMBER_TRACES_HEADER = "X-OTPU-Member-Traces"
#: the caller's tenant identity (serve/tenancy.py); the replica adopts
#: it into a tenant_scope like the trace header, so replica-side
#: admission enforces the SAME weighted-fair quotas the caller declared
TENANT_HEADER = "X-OTPU-Tenant"

_M_RPC = REGISTRY.counter(
    "otpu_fleet_rpc_requests_total",
    "predict RPCs served by this replica process")
_M_DRAINED = REGISTRY.counter(
    "otpu_fleet_drained_requests_total",
    "predict RPCs refused with ReplicaDrainingError mid-drain")


def drain_budget_s() -> float:
    return float(knobs.get_float("OTPU_DRAIN_S"))


# ------------------------------------------------------------ typed errors
class ReplicaDrainingError(RuntimeError):
    """A request arrived at a replica that is draining (SIGTERM or
    ``POST /drain``): new work is refused — shed-style, typed, carrying
    the trace id — while in-flight requests finish. The router treats it
    as a failover signal (retry on another replica), never a breaker
    failure: draining is *graceful*."""

    def __init__(self, *, replica: str = "", trace_id: str | None = None,
                 in_flight: int = 0):
        self.replica = replica
        self.trace_id = trace_id
        self.in_flight = in_flight
        tid = f" [trace {trace_id}]" if trace_id else ""
        super().__init__(
            f"replica {replica or '?'} is draining "
            f"({in_flight} in flight){tid}; retry on another replica")


class ReplicaUnavailableError(RuntimeError):
    """Transport/server failure talking to one replica (connect refused,
    connection reset mid-read, read deadline, HTTP 5xx): the router's
    failover-with-exclusion signal, and a breaker failure for that
    replica. Carries the failure ``reason`` the failover counter is
    labeled with."""

    def __init__(self, message: str, *, replica: str = "",
                 reason: str = "connect", trace_id: str | None = None):
        self.replica = replica
        self.reason = reason
        self.trace_id = trace_id
        super().__init__(message)


class ReplicaOverloadedError(RuntimeError):
    """Replica-side admission shed the request typed (queue full, or the
    caller's propagated ``X-OTPU-Deadline-Ms`` already expired). NOT a
    replica failure: the router neither trips the breaker nor fails over
    — re-sending a nearly-expired request elsewhere would complete after
    the caller gave up, the exact waste the deadline header exists to
    stop. Surfaced to the caller as-is."""

    def __init__(self, message: str, *, replica: str = "",
                 reason: str = "overload", trace_id: str | None = None):
        self.replica = replica
        self.reason = reason
        self.trace_id = trace_id
        super().__init__(message)


class NoReplicaAvailableError(RuntimeError):
    """Every replica is excluded, open-breakered or draining — the
    router has nowhere left to send the request. Carries the per-replica
    state map so a production log line is self-explaining."""

    def __init__(self, states: dict, *, trace_id: str | None = None):
        self.states = dict(states)
        self.trace_id = trace_id
        super().__init__(
            f"no replica available to serve the request: {self.states}")


# ------------------------------------------------------------- npy helpers
def dump_npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def load_npy(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


# ------------------------------------------------------------------ server
class _ReplicaHandler(BaseHTTPRequestHandler):
    server_version = "otpu-fleet/1"
    protocol_version = "HTTP/1.1"
    # idle keep-alive reap: a pooled connection the client abandoned
    # closes itself after this long with no next request (the client's
    # stale-socket retry makes the close invisible to callers)
    timeout = 60.0
    # server half of the anti-Nagle contract (see FleetClient._open):
    # responses on persistent connections must not wait out the
    # client's delayed ACK
    disable_nagle_algorithm = True

    def log_message(self, *args):  # replica stdout is not an access log
        pass

    def _send(self, code: int, body: bytes, ctype: str,
              headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: dict,
                   headers: dict | None = None) -> None:
        # default=str matches the obs server's serializer: a debug body
        # carrying a non-JSON-native span arg must render, not 500
        self._send(code, json.dumps(obj, default=str).encode(),
                   "application/json", headers)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    # ------------------------------------------------------------- routes
    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        runtime = self.server._otpu_runtime
        try:
            route = self.path.split("?")[0]
            if route == "/readyz":
                from orange3_spark_tpu_torch.obs.server import ready_body

                body, ready = ready_body(runtime.serving_context)
                body["version"] = runtime.version
                body["replica"] = runtime.name
                # workflow bundles: which DAG this version serves (None
                # for plain per-model versions) — the router mirrors it
                body["dag"] = getattr(runtime, "dag", None)
                self._send_json(200 if ready else 503, body)
            elif route == "/healthz":
                body, healthy = runtime.health()
                self._send_json(200 if healthy else 503, body)
            elif route == "/metrics":
                from orange3_spark_tpu_torch.obs.server import PROM_CONTENT_TYPE

                self._send(200, REGISTRY.to_prometheus().encode(),
                           PROM_CONTENT_TYPE)
            elif route == "/debug/flight":
                from orange3_spark_tpu_torch.obs import flight

                self._send_json(200, flight.debug_bundle(
                    context=runtime.serving_context))
            elif route == "/debug/stacks":
                from orange3_spark_tpu_torch.obs.server import stacks_body

                self._send_json(200, stacks_body())
            elif route == "/debug/spans":
                from orange3_spark_tpu_torch.obs.server import spans_body

                self._send_json(200, spans_body(self.path))
            else:
                self._send(404, b"not found: try /predict (POST), "
                                b"/readyz, /healthz, /metrics, "
                                b"/debug/flight, /debug/stacks or "
                                b"/debug/spans\n",
                           "text/plain")
        except Exception as e:  # noqa: BLE001 - never kill the listener
            self._oops(e)

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        runtime = self.server._otpu_runtime
        try:
            # consume the request body BEFORE any response is written:
            # under keep-alive, unread body bytes sit on the persistent
            # connection and get parsed as the NEXT request line — every
            # later request on that connection then fails 501
            body = self._body()
            route = self.path.split("?")[0]
            if route == "/predict":
                self._predict(runtime, body)
            elif route == "/drain":
                runtime.initiate_drain(reason="drain_endpoint")
                self._send_json(200, {"draining": True,
                                      "budget_s": drain_budget_s()})
            elif route == "/reload":
                try:
                    spec = json.loads(body or b"{}")
                    version = runtime.reload(str(spec["version"]))
                    self._send_json(200, {"version": version})
                except Exception as e:  # noqa: BLE001 - typed to caller
                    # reload is all-or-nothing: the old version is still
                    # serving, the caller (rollout) decides to roll back
                    self._send_json(500, {
                        "error": type(e).__name__, "message": str(e),
                        "version": runtime.version})
            else:
                self._send(404, b"not found\n", "text/plain")
        except Exception as e:  # noqa: BLE001 - never kill the listener
            self._oops(e)

    def _predict(self, runtime, body: bytes) -> None:
        from orange3_spark_tpu_torch.obs.context import (
            current_trace_id, propagated_scope,
        )
        from orange3_spark_tpu_torch.resilience.overload import (
            OverloadShedError, request_deadline,
        )
        from orange3_spark_tpu_torch.serve.tenancy import (
            TenantQuotaShedError, tenancy_enabled, tenant_scope,
        )

        trace_id = self.headers.get(TRACE_HEADER) or None
        # tenant adoption mirrors the trace header: the identity the
        # caller scoped rides the wire and re-enters a tenant_scope here,
        # so replica-side admission bills the right tenant. Gated on the
        # kill-switch AND header presence — tenant-less wires unchanged.
        tenant = (self.headers.get(TENANT_HEADER) or None
                  if tenancy_enabled() else None)
        if runtime.draining:
            # typed, shed-style: carries the trace id of the request it
            # refused, and ticks the drain counter — never silently drops
            _M_DRAINED.inc()
            err = ReplicaDrainingError(
                replica=runtime.name, trace_id=trace_id,
                in_flight=runtime.in_flight)
            self._send_json(503, {
                "error": "ReplicaDrainingError", "message": str(err),
                "trace_id": trace_id},
                headers={TRACE_HEADER: trace_id or ""})
            return
        dl_ms = self._deadline_ms()
        if dl_ms is not None and dl_ms <= 0:
            # the caller's deadline expired in flight: completing the
            # predict now only produces an answer the router already
            # abandoned — shed typed BEFORE touching the device (the
            # admission controller cannot help here when it is disabled)
            self._send_json(503, {
                "error": "OverloadShedError",
                "message": "caller deadline expired before dispatch",
                "reason": "deadline", "trace_id": trace_id},
                headers={TRACE_HEADER: trace_id or ""})
            return
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        via_shm = ctype.strip() == fastwire.SHM_CONTENT_TYPE
        if via_shm:
            try:
                X = fastwire.load_shm(body)
            except fastwire.ShmWireError as e:
                # typed 422: the client re-sends THIS request as npy —
                # never a 5xx, the replica itself is healthy
                self._send_json(422, {
                    "error": "ShmWireError", "message": str(e)[:500],
                    "trace_id": trace_id},
                    headers={TRACE_HEADER: trace_id or ""})
                return
        else:
            X = load_npy(body)
        members = [t for t in
                   (self.headers.get(MEMBER_TRACES_HEADER) or "").split(",")
                   if t]
        _M_RPC.inc()
        try:
            # adopt the router-minted trace id for the whole serving path:
            # the serve/serve_dispatch spans under route()/served_array
            # reuse (never shadow) this identity
            with propagated_scope(trace_id, "serve"):
                # echo ONLY what the serving path actually carried: under
                # OTPU_OBS=0 nothing is adopted, and parroting the request
                # header back would let the router count a propagation
                # that never happened (a vacuous trace_coverage == 1.0)
                carried = current_trace_id() or ""
                with (request_deadline(dl_ms / 1e3) if dl_ms is not None
                      else nullcontext()):
                    with (tenant_scope(tenant) if tenant is not None
                          else nullcontext()):
                        with (self._member_scope(members) if members
                              else nullcontext()):
                            out = runtime.predict(X)
        except ReplicaDrainingError as e:   # drain raced the flag check
            _M_DRAINED.inc()
            self._send_json(503, {
                "error": "ReplicaDrainingError", "message": str(e),
                "trace_id": trace_id},
                headers={TRACE_HEADER: trace_id or ""})
            return
        except TenantQuotaShedError as e:
            # the quota shed travels typed with its evidence so the
            # client reconstructs the SAME exception class and a caller
            # sees one error type whether admission ran local or remote
            self._send_json(503, {
                "error": "TenantQuotaShedError", "message": str(e)[:500],
                "reason": getattr(e, "reason", "tenant_inflight"),
                "tenant": e.tenant, "usage": e.usage, "quota": e.quota,
                "trace_id": trace_id},
                headers={TRACE_HEADER: trace_id or ""})
            return
        except OverloadShedError as e:
            # replica-side admission shed under the propagated deadline:
            # typed to the router, which surfaces it (no breaker/failover)
            self._send_json(503, {
                "error": "OverloadShedError", "message": str(e)[:500],
                "reason": getattr(e, "reason", "overload"),
                "trace_id": trace_id},
                headers={TRACE_HEADER: trace_id or ""})
            return
        except Exception as e:  # noqa: BLE001 - typed to the caller
            self._send_json(500, {
                "error": type(e).__name__, "message": str(e)[:500],
                "trace_id": trace_id},
                headers={TRACE_HEADER: trace_id or ""})
            return
        rheaders = {TRACE_HEADER: carried,
                    VERSION_HEADER: runtime.version or ""}
        out = np.asarray(out)
        if via_shm and fastwire.shm_worthwhile(out.nbytes):
            # answer in kind: the request proved the client maps our
            # segments; the tracker keeps the response segment alive
            # until the client unlinks it (bounded, leak-proof)
            try:
                rbody, seg = fastwire.dump_shm(out)
                fastwire.track_response_segment(seg)
                self._send(200, rbody, fastwire.SHM_CONTENT_TYPE,
                           headers=rheaders)
                return
            except fastwire.ShmWireError:
                fastwire.note_shm_fallback()
        self._send(200, dump_npy(out), NPY_CONTENT_TYPE, headers=rheaders)

    def _deadline_ms(self) -> int | None:
        raw = self.headers.get(DEADLINE_HEADER)
        if not raw:
            return None
        try:
            return int(raw)
        except ValueError:
            return None

    @staticmethod
    def _member_scope(members):
        from orange3_spark_tpu_torch.serve.context import dispatch_traces_scope

        return dispatch_traces_scope(members)

    def _oops(self, e: Exception) -> None:
        try:
            self._send(500, f"{type(e).__name__}: {e}\n".encode(),
                       "text/plain")
        except Exception:  # noqa: BLE001 - client went away
            pass


class _UdsReplicaHandler(_ReplicaHandler):
    # AF_UNIX has no Nagle: setting TCP_NODELAY on a unix socket raises
    disable_nagle_algorithm = False


class ReplicaServer:
    """The replica's data-plane listener. ``runtime`` is the replica's
    serving runtime (fleet/replica.py ``ReplicaRuntime`` — anything with
    ``predict``/``reload``/``initiate_drain``/``health`` plus the
    ``draining``/``in_flight``/``version``/``name``/``serving_context``
    attributes works, which is what the in-process tests stub)."""

    def __init__(self, runtime, port: int = 0):
        self.runtime = runtime
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          _ReplicaHandler)
        # Daemonic: under keep-alive a handler thread's lifetime is the
        # CONNECTION, not the response — an idle pooled connection would
        # otherwise hold process exit hostage in readline(). The drain
        # contract (in-flight responses finish before exit) is enforced
        # by the runtime's in_flight==0 gate, not by thread join.
        self._httpd.daemon_threads = True
        self._httpd.block_on_close = False
        self._httpd._otpu_runtime = runtime
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None
        # companion AF_UNIX listener: same handler/runtime, same routes,
        # reachable only through the 0600 socket file keyed by our TCP
        # port; an unusable run dir degrades to TCP-only, never fatal
        self._uds = None
        self._uds_thread: threading.Thread | None = None
        if fastwire.uds_enabled():
            try:
                self._uds = fastwire.bind_uds_server(
                    self.port, _UdsReplicaHandler, runtime)
                self._uds.daemon_threads = True
                self._uds.block_on_close = False
            except OSError:
                self._uds = None

    def _start_uds(self) -> None:
        if self._uds is not None and self._uds_thread is None:
            self._uds_thread = threading.Thread(
                target=self._uds.serve_forever,
                kwargs={"poll_interval": 0.05},
                daemon=True, name="otpu-fleet-uds")
            self._uds_thread.start()

    def serve_forever(self) -> None:
        """Block serving requests (the replica main loop); returns after
        :meth:`shutdown` (the drain sequence)."""
        self._start_uds()
        self._httpd.serve_forever(poll_interval=0.05)

    def start_background(self) -> "ReplicaServer":
        """Serve from a background thread (in-process drills)."""
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="otpu-fleet-rpc")
        self._thread.start()
        return self

    def shutdown(self) -> None:
        if self._uds is not None:
            self._uds.shutdown()
            self._uds.server_close()
            fastwire.unlink_uds_socket(self.port)
            if self._uds_thread is not None:
                self._uds_thread.join(timeout=5.0)
                self._uds_thread = None
            self._uds = None
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ------------------------------------------------------------------ client
def _default_timeout_s() -> float:
    """Explicit request_deadline() scope > OTPU_FLEET_TIMEOUT_S. An
    ``inf`` deadline (the deadline-exempt convention) maps to the knob
    default — a socket cannot wait forever and still be cancellable."""
    from orange3_spark_tpu_torch.resilience.overload import _ambient_deadline_s

    d = _ambient_deadline_s()
    if d is not None and math.isfinite(d) and d > 0:
        return float(d)
    return float(knobs.get_float("OTPU_FLEET_TIMEOUT_S"))


class FleetClient:
    """One replica's client. Under the fast path requests reuse a pooled
    keep-alive connection (stale pooled sockets get one typed reconnect
    retry that never reaches the breaker); under ``OTPU_FLEET_FASTWIRE=0``
    every request opens and closes its own connection (the plain wire,
    bitwise). ``conn_slot`` (a list) receives the live connection so a
    hedging router can cancel a losing request by closing it."""

    def __init__(self, host: str, port: int, *, name: str = ""):
        self.host = host
        self.port = port
        self.name = name or f"{host}:{port}"
        self.pool = fastwire.ConnPool(self.name)

    def close(self) -> None:
        """Drop pooled idle connections (safe anytime: an in-flight
        request owns its connection until it releases it)."""
        self.pool.close_all()

    # ------------------------------------------------------------ plumbing
    def _transport(self) -> str:
        return ("uds" if fastwire.uds_available(self.host, self.port)
                else "tcp")

    def _open(self, transport: str, timeout: float) -> HTTPConnection:
        conn = None
        if transport == "uds":
            try:
                conn = fastwire._UnixHTTPConnection(
                    fastwire.uds_socket_path(self.port, create_dir=False),
                    timeout=timeout)
                conn.connect()
            except OSError:
                # stale socket file (replica hard-killed): degrade to
                # TCP for this request — the supervisor unlinks the file
                # on kill, so the next open goes straight to TCP
                conn = None
        if conn is None:
            try:
                conn = HTTPConnection(self.host, self.port,
                                      timeout=timeout)
                # TCP_NODELAY, else Nagle + the peer's delayed ACK stall
                # every request on a WARMED connection ~40ms (fresh
                # sockets ride Linux quickack, which is why the legacy
                # one-connection-per-request wire never saw it)
                conn.connect()
                conn.sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except (ConnectionError, socket.timeout, TimeoutError,
                    OSError) as e:
                timed_out = isinstance(e, (socket.timeout, TimeoutError))
                raise ReplicaUnavailableError(
                    f"replica {self.name} connect failed: "
                    f"{type(e).__name__}: {e}", replica=self.name,
                    reason="timeout" if timed_out else "connect") from e
        self.pool.note_opened()
        return conn

    def _request(self, method: str, path: str, body: bytes | None,
                 headers: dict, timeout_s: float | None,
                 conn_slot: list | None = None):
        timeout = timeout_s if timeout_s else _default_timeout_s()
        if not fastwire.fastwire_enabled():
            # OTPU_FLEET_FASTWIRE=0: the pre-fastwire wire bitwise — one
            # fresh TCP connection per request, closed in finally
            conn = HTTPConnection(self.host, self.port, timeout=timeout)
            if conn_slot is not None:
                conn_slot.append(conn)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                return resp.status, dict(resp.headers), data
            except (ConnectionError, socket.timeout, TimeoutError, OSError,
                    HTTPException) as e:
                reason = ("timeout" if isinstance(
                    e, (socket.timeout, TimeoutError)) else "connect")
                raise ReplicaUnavailableError(
                    f"replica {self.name} {method} {path} failed: "
                    f"{type(e).__name__}: {e}", replica=self.name,
                    reason=reason,
                    trace_id=headers.get(TRACE_HEADER)) from e
            finally:
                conn.close()
        transport = self._transport()
        conn = self.pool.acquire(transport)
        reused = conn is not None
        if conn is None:
            conn = self._open(transport, timeout)
        else:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
        while True:
            if conn_slot is not None:
                conn_slot.append(conn)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (ConnectionError, socket.timeout, TimeoutError, OSError,
                    HTTPException) as e:
                conn.close()
                timed_out = isinstance(e, (socket.timeout, TimeoutError))
                if reused and not timed_out:
                    # a pooled socket the replica closed behind our back
                    # (idle timeout, restart): a wire artifact, not a
                    # replica failure — retry ONCE on a fresh connection
                    # before anything reaches the router/breaker
                    self.pool.note_stale()
                    conn = self._open(transport, timeout)
                    reused = False
                    continue
                raise ReplicaUnavailableError(
                    f"replica {self.name} {method} {path} failed: "
                    f"{type(e).__name__}: {e}", replica=self.name,
                    reason="timeout" if timed_out else "connect",
                    trace_id=headers.get(TRACE_HEADER)) from e
            if resp.will_close:
                conn.close()
            else:
                self.pool.release(transport, conn)
            return resp.status, dict(resp.headers), data

    @staticmethod
    def _raise_for_status(status: int, data: bytes, replica: str,
                          trace_id: str | None) -> None:
        if status < 400:
            return
        try:
            err = json.loads(data)
        except ValueError:
            err = {}
        if err.get("error") == "ReplicaDrainingError":
            raise ReplicaDrainingError(replica=replica, trace_id=trace_id)
        if err.get("error") == "TenantQuotaShedError":
            from orange3_spark_tpu_torch.serve.tenancy import (
                TenantQuotaShedError,
            )

            raise TenantQuotaShedError(
                tenant=str(err.get("tenant") or "?"),
                reason=err.get("reason") or "tenant_inflight",
                usage=float(err.get("usage") or 0.0),
                quota=float(err.get("quota") or 0.0),
                trace_id=trace_id)
        if err.get("error") == "OverloadShedError":
            raise ReplicaOverloadedError(
                f"replica {replica} shed the request: "
                f"{err.get('message', '')}".strip(),
                replica=replica, reason=err.get("reason") or "overload",
                trace_id=trace_id)
        raise ReplicaUnavailableError(
            f"replica {replica} answered HTTP {status}: "
            f"{err.get('error', '')} {err.get('message', '')}".strip(),
            replica=replica, reason=f"http_{status}", trace_id=trace_id)

    @staticmethod
    def _deadline_ms(timeout_s: float | None) -> int | None:
        """The remaining deadline the predict header carries: an explicit
        per-call deadline wins, else an ambient request_deadline scope;
        no deadline → no header (the knob default is a socket timeout,
        not a caller deadline)."""
        if timeout_s is not None and math.isfinite(timeout_s):
            return max(0, int(timeout_s * 1000))
        from orange3_spark_tpu_torch.resilience.overload import (
            _ambient_deadline_s,
        )

        d = _ambient_deadline_s()
        if d is not None and math.isfinite(d) and d > 0:
            return int(d * 1000)
        return None

    # ---------------------------------------------------------- data plane
    def predict(self, X: np.ndarray, *, trace_id: str | None = None,
                timeout_s: float | None = None,
                conn_slot: list | None = None,
                member_traces: list | None = None,
                tenant: str | None = None,
                ) -> tuple[np.ndarray, dict]:
        """One predict RPC → (prediction array, response headers)."""
        from orange3_spark_tpu_torch.serve.tenancy import (
            current_tenant, tenancy_enabled,
        )

        X = np.asarray(X)
        headers = {"Content-Type": NPY_CONTENT_TYPE}
        if trace_id:
            headers[TRACE_HEADER] = trace_id
        if member_traces:
            headers[MEMBER_TRACES_HEADER] = ",".join(member_traces)
        if tenancy_enabled():
            # explicit arg (the router captured the caller's scope on its
            # own thread) wins over this thread's ambient scope; no
            # tenant → no header — the tenant-less wire is byte-identical
            tenant = tenant if tenant is not None else current_tenant()
            if tenant:
                headers[TENANT_HEADER] = tenant
        if fastwire.fastwire_enabled():
            # header gated with the rest of the fast path so that
            # OTPU_FLEET_FASTWIRE=0 restores the old wire byte-for-byte
            dl_ms = self._deadline_ms(timeout_s)
            if dl_ms is not None:
                headers[DEADLINE_HEADER] = str(dl_ms)
        seg = None
        try:
            body = None
            if (fastwire.shm_enabled() and fastwire._is_loopback(self.host)
                    and fastwire.shm_worthwhile(np.asarray(X).nbytes)):
                try:
                    body, seg = fastwire.dump_shm(X)
                    headers["Content-Type"] = fastwire.SHM_CONTENT_TYPE
                except fastwire.ShmWireError:
                    fastwire.note_shm_fallback()
                    body = None
                    headers["Content-Type"] = NPY_CONTENT_TYPE
            if body is None:
                body = dump_npy(X)
            status, rheaders, data = self._request(
                "POST", "/predict", body, headers, timeout_s, conn_slot)
            if status == 422 and seg is not None:
                # the replica could not map our segment (namespace or
                # mount mismatch): fall back to npy for THIS request,
                # typed, once
                fastwire.note_shm_fallback()
                headers["Content-Type"] = NPY_CONTENT_TYPE
                status, rheaders, data = self._request(
                    "POST", "/predict", dump_npy(X), headers, timeout_s,
                    conn_slot)
        finally:
            if seg is not None:
                seg.cleanup()
        self._raise_for_status(status, data, self.name, trace_id)
        ctype = (rheaders.get("Content-Type") or "").split(";")[0].strip()
        if ctype == fastwire.SHM_CONTENT_TYPE:
            try:
                return fastwire.load_shm(data), rheaders
            except fastwire.ShmWireError as e:
                # the response segment vanished before we read it: the
                # payload is lost — typed so the router retries elsewhere
                raise ReplicaUnavailableError(
                    f"replica {self.name} response segment lost: {e}",
                    replica=self.name, reason="shm",
                    trace_id=trace_id) from e
        return load_npy(data), rheaders

    # -------------------------------------------------------- control plane
    def get_json(self, path: str, *, timeout_s: float | None = None,
                 ) -> tuple[int, dict]:
        status, _h, data = self._request("GET", path, None, {}, timeout_s)
        try:
            return status, json.loads(data)
        except ValueError:
            return status, {}

    def get_text(self, path: str, *, timeout_s: float | None = None,
                 ) -> tuple[int, str]:
        """One GET → (status, body text) — the fleet collector's
        /metrics scrape (Prometheus exposition is text, not JSON)."""
        status, _h, data = self._request("GET", path, None, {}, timeout_s)
        return status, data.decode("utf-8", errors="replace")

    def post_json(self, path: str, obj: dict | None = None, *,
                  timeout_s: float | None = None) -> tuple[int, dict]:
        body = json.dumps(obj or {}).encode()
        status, _h, data = self._request(
            "POST", path, body, {"Content-Type": "application/json"},
            timeout_s)
        try:
            return status, json.loads(data)
        except ValueError:
            return status, {}

    def ready(self, *, timeout_s: float | None = None) -> tuple[bool, dict]:
        """One /readyz poll → (ready?, body). Transport failures report
        unready (the router's health view must never raise)."""
        try:
            status, body = self.get_json("/readyz", timeout_s=timeout_s)
        except ReplicaUnavailableError as e:
            return False, {"reason": e.reason}
        return status == 200 and bool(body.get("ready")), body
