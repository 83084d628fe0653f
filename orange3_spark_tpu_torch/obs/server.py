"""Live telemetry endpoint — a scrapeable serving process, zero deps.

A copy of the JAX package's ``obs/server.py`` without the fleet side (the
fleet collector, ``/fleetz`` and the autoscaler's readiness keys wait for
the port's ``fleet/``). A stdlib ``ThreadingHTTPServer`` on a daemon
thread exposes:

* ``GET /metrics``  — Prometheus text exposition of the whole registry
  (the serving counters, dispatches, retries, histograms, the device-memory
  ledger's ``otpu_device_bytes``);
* ``GET /readyz``   — JSON **readiness** (distinct from liveness): 200
  only when a ``ServingContext`` is active, its warmup has completed
  (``ServingContext.warmup`` notes it), and the process is not draining
  (``set_draining``); otherwise 503 with a ``reason``. A process
  mid-warmup or mid-drain is *alive* (``/healthz`` 200) but must receive
  no new traffic;
* ``GET /healthz``  — JSON liveness: seconds since the last progress beat
  (``utils.dispatch.beat`` — every step loop, prefetch worker, routed
  serve call and micro-batch flush ticks it), in-flight/wedge/retry
  counts, the micro-batcher queue depth, admission-control shed totals
  and the memory-pressure ``brownout_level`` (resilience/overload.py).
  Returns **503** once the beat is older than ``OTPU_OBS_STALE_S``
  (default 60 s) WHILE work is in flight — the wedged-dispatch signature.
  An idle process (nothing in flight, nothing to beat about) reports
  ``idle`` and stays 200-healthy, so a load balancer acting on this
  endpoint never ejects a backend for a quiet minute;
* ``GET /debug/flight``, ``GET /debug/stacks``, ``GET /debug/spans`` —
  a flight bundle written now (obs/flight.py), every thread's stack, the
  span ring (optionally one ``?trace_id=``);
* ``POST /debug/profile?duration_ms=`` — a deep capture (obs/prof.py).

Opt-in by ``OTPU_OBS_PORT`` (0 = ephemeral, for tests): ``ServingContext``
activation starts it, the last deactivation stops it. Inert under
``OTPU_OBS=0`` — the endpoint never binds. Binds 127.0.0.1 only; exposing
it beyond the host is a reverse proxy's job, not a data-plane library's.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from orange3_spark_tpu_torch.utils import knobs

__all__ = [
    "TelemetryServer",
    "is_draining",
    "maybe_start_from_env",
    "note_warmup_complete",
    "profile_capture_body",
    "ready_body",
    "reset_readiness",
    "set_draining",
]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# ---------------------------------------------------------------- readiness
# Process-wide readiness state, distinct from the liveness heartbeat:
# /healthz answers "is this process making progress", /readyz answers
# "should a router send this process NEW work". Warmup completion is noted
# by ServingContext.warmup(); the drain flag by ``set_draining``. A fresh
# serving window (first ServingContext activation with none already
# active) resets warmup — a context is not ready until it is warm.
_READY_LOCK = threading.Lock()
_warmup_complete = False
_draining = False


def note_warmup_complete(done: bool = True) -> None:
    """ServingContext.warmup() calls this on success — the readiness
    half of "warmed ahead of traffic"."""
    global _warmup_complete
    with _READY_LOCK:
        _warmup_complete = bool(done)


def set_draining(on: bool = True) -> None:
    """Raise/clear the process drain flag:
    a draining process fails /readyz so routers stop sending new work,
    while in-flight requests finish."""
    global _draining
    with _READY_LOCK:
        _draining = bool(on)


def is_draining() -> bool:
    return _draining


def reset_readiness() -> None:
    """Fresh serving window: not warm, not draining."""
    global _warmup_complete, _draining
    with _READY_LOCK:
        _warmup_complete = False
        _draining = False


def ready_body(context=None) -> tuple[dict, bool]:
    """(/readyz body, ready?). Ready means: an active ServingContext,
    warmup complete, and not draining — in that *reporting* order, with
    draining outranking the rest (a draining replica must advertise WHY
    it refuses work, not a stale warmup state)."""
    from orange3_spark_tpu_torch.serve.context import active_serving_context

    ctx = context if context is not None else active_serving_context()
    with _READY_LOCK:
        draining, warm = _draining, _warmup_complete
    if draining:
        reason = "draining"
    elif ctx is None:
        reason = "no_active_context"
    elif not warm:
        reason = "warmup_pending"
    else:
        reason = None
    ready = reason is None
    body = {
        "status": "ready" if ready else "unready",
        "ready": ready,
        "reason": reason,
        "draining": draining,
        "warmup_complete": warm,
        "context_active": ctx is not None,
    }
    # control-plane status: the key appears ONLY once a tenant was shed —
    # tenant-less processes keep the exact pre-tenancy body
    from orange3_spark_tpu_torch.serve.tenancy import tenant_shed_counts

    sheds = tenant_shed_counts()
    if sheds:
        body["tenants"] = {"sheds": sheds}
    return body, ready


def spans_body(path: str) -> dict:
    """The ``GET /debug/spans?trace_id=`` body: this process's span-ring
    payload, optionally
    filtered to the trace id in the query string."""
    from urllib.parse import parse_qs, urlsplit

    from orange3_spark_tpu_torch.obs import trace

    q = parse_qs(urlsplit(path).query)
    tid = (q.get("trace_id") or [None])[0] or None
    return trace.spans_payload(tid)


def stacks_body() -> dict:
    """The shared ``GET /debug/stacks`` body: every thread's Python
    stack plus the open spans each was inside."""
    from orange3_spark_tpu_torch.obs import flight, trace

    return {"stacks": flight.thread_stacks(),
            "open_spans": trace.open_spans()}


def profile_capture_body(path: str) -> tuple[int, dict]:
    """The ``POST /debug/profile?duration_ms=`` body (obs/prof.py deep
    capture): status mapping is part of the contract — 503 under the
    ``OTPU_PROF=0`` kill-switch, 409 while another capture runs
    (captures serialize), 429 inside the ``OTPU_PROF_RATE_S`` window,
    200 with the artifact path. The response is a summary, not the full
    snapshot — the artifact dir holds the real thing."""
    from urllib.parse import parse_qs, urlsplit

    from orange3_spark_tpu_torch.obs import prof

    q = parse_qs(urlsplit(path).query)
    raw = (q.get("duration_ms") or [None])[0]
    try:
        duration_ms = float(raw) if raw not in (None, "") else 500.0
    except ValueError:
        return 400, {"error": "bad_duration_ms", "duration_ms": raw}
    try:
        out = prof.capture(duration_ms, reason="debug_endpoint")
    except prof.CaptureDisabledError as e:
        return 503, {"error": "prof_disabled", "message": str(e)}
    except prof.CaptureBusyError as e:
        return 409, {"error": "capture_busy", "message": str(e)}
    except prof.CaptureRateLimitedError as e:
        return 429, {"error": "rate_limited", "message": str(e)}
    except Exception as e:  # noqa: BLE001 - typed to the caller
        return 500, {"error": type(e).__name__, "message": str(e)[:500]}
    snap = out["snapshot"]
    return 200, {
        "path": out["path"],
        "reason": out["reason"],
        "duration_ms": out["duration_ms"],
        "ledger_total_bytes": snap["ledger"]["total_bytes"],
        "goodput": snap["goodput"],
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "otpu-obs/1"
    # HTTP/1.1 so scrapers reuse their keep-alive connection to us:
    # every response goes through _send, which sets Content-Length — the
    # invariant that makes connection reuse safe
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # serving stdout is not an access log
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        owner: "TelemetryServer" = self.server._otpu_owner
        try:
            route = self.path.split("?")[0]
            if route == "/metrics":
                from orange3_spark_tpu_torch.obs.registry import REGISTRY

                self._send(200, REGISTRY.to_prometheus().encode(),
                           PROM_CONTENT_TYPE)
            elif route == "/debug/spans":
                self._send(200,
                           json.dumps(spans_body(self.path),
                                      default=str).encode(),
                           "application/json")
            elif route == "/healthz":
                body, healthy = owner.health()
                self._send(200 if healthy else 503,
                           json.dumps(body).encode(), "application/json")
            elif route == "/readyz":
                body, ready = ready_body(owner._context)
                self._send(200 if ready else 503,
                           json.dumps(body).encode(), "application/json")
            elif route == "/debug/flight":
                # the manual black-box pull on a LIVE process: write a
                # bundle (no rate limit — the operator asked) and return
                # it; loopback-only like everything on this listener
                from orange3_spark_tpu_torch.obs import flight

                bundle = flight.debug_bundle(context=owner._context)
                self._send(200, json.dumps(bundle, default=str).encode(),
                           "application/json")
            elif route == "/debug/stacks":
                self._send(200,
                           json.dumps(stacks_body(),
                                      default=str).encode(),
                           "application/json")
            else:
                self._send(404, b"not found: try /metrics, /healthz, "
                                b"/readyz, /debug/flight, "
                                b"/debug/stacks, /debug/spans or "
                                b"POST /debug/profile\n",
                           "text/plain")
        except Exception as e:  # noqa: BLE001 - never kill the listener
            try:
                self._send(500, f"{type(e).__name__}: {e}\n".encode(),
                           "text/plain")
            except Exception:  # noqa: BLE001 - client went away
                pass

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        try:
            # drain the request body before responding: unread bytes on
            # a keep-alive connection are parsed as the next request
            n = int(self.headers.get("Content-Length") or 0)
            if n:
                self.rfile.read(n)
            route = self.path.split("?")[0]
            if route == "/debug/profile":
                # on-demand deep capture (obs/prof.py): loopback-only
                # like everything on this listener, serialized (409),
                # rate-limited (429), refused under OTPU_PROF=0 (503)
                code, body = profile_capture_body(self.path)
                self._send(code, json.dumps(body, default=str).encode(),
                           "application/json")
            else:
                self._send(404, b"not found: POST /debug/profile\n",
                           "text/plain")
        except Exception as e:  # noqa: BLE001 - never kill the listener
            try:
                self._send(500, f"{type(e).__name__}: {e}\n".encode(),
                           "text/plain")
            except Exception:  # noqa: BLE001 - client went away
                pass


class TelemetryServer:
    """One /metrics + /healthz listener; start() binds, stop() joins."""

    def __init__(self, port: int = 0, *, stale_s: float | None = None,
                 context=None):
        self.port = port
        self.stale_s = (stale_s if stale_s is not None
                        else float(knobs.get_float("OTPU_OBS_STALE_S")))
        self._context = context      # owning ServingContext (queue depth)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ control
    def start(self) -> "TelemetryServer":
        httpd = ThreadingHTTPServer(("127.0.0.1", self.port), _Handler)
        httpd.daemon_threads = True
        httpd._otpu_owner = self
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, daemon=True, name="otpu-obs-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # ------------------------------------------------------------- health
    def health(self) -> tuple[dict, bool]:
        """(/healthz body, healthy?). Unhealthy means WEDGED, not idle:
        a stale heartbeat only degrades the status while serve calls are
        in flight (or micro-batch work is queued) — that is the hang
        signature the watchdog exists for. An idle process has
        nothing to beat about and must stay healthy, or a load balancer
        acting on this endpoint would permanently eject every backend
        that sees a quiet minute."""
        from orange3_spark_tpu_torch.obs.registry import REGISTRY
        from orange3_spark_tpu_torch.resilience.overload import (
            brownout_level, shed_total,
        )
        from orange3_spark_tpu_torch.utils.dispatch import last_beat
        from orange3_spark_tpu_torch.utils.profiling import (
            exec_counters, resilience_counters,
        )

        age = time.monotonic() - last_beat()
        res = resilience_counters()
        ex = exec_counters()
        depth = None
        ctx = self._context
        mb = getattr(ctx, "micro_batcher", None) if ctx is not None else None
        if mb is not None:
            depth = mb._q.qsize()
        g = REGISTRY.get("otpu_serve_inflight")
        inflight = int(g.value()) if g is not None else 0
        busy = inflight > 0 or bool(depth)
        stale = age >= self.stale_s
        healthy = not (stale and busy)
        return {
            "status": ("ok" if not stale else
                       "stale" if busy else "idle"),
            "last_beat_age_s": round(age, 3),
            "stale_after_s": self.stale_s,
            "in_flight": inflight,
            "wedges": res["wedges"],
            "retries": res["retries"],
            "crc_failures": res["crc_failures"],
            "dispatches": ex["dispatches"],
            "mb_queue_depth": depth,
            # overload-protection state (resilience/overload.py): how
            # hard admission control is shedding, and which brownout
            # rung the memory-pressure ladder lands on — RECOMPUTED per
            # scrape (a level-3 spike during a finished fit must not be
            # echoed forever), so a load balancer can steer AWAY from a
            # browned-out backend and return once pressure subsides
            "sheds": shed_total(),
            "brownout_level": brownout_level(consume=False),
        }, healthy


def maybe_start_from_env(context=None) -> TelemetryServer | None:
    """The ServingContext hook: bind iff ``OTPU_OBS_PORT`` is set AND obs
    is enabled (``OTPU_OBS=0`` => the endpoint never binds). A bind
    failure (port taken) warns and returns None — serving must not die
    for its telemetry."""
    from orange3_spark_tpu_torch.obs import trace

    raw = knobs.get_raw("OTPU_OBS_PORT")
    # refreshed_enabled: activation is a chokepoint where a mid-process
    # OTPU_OBS flip must take effect (never bind under the kill-switch)
    if raw in (None, "") or not trace.refreshed_enabled():
        return None
    import logging

    port = knobs.get_int("OTPU_OBS_PORT")
    if port is None:
        # malformed port: the declared default (None) means "no server" —
        # binding a surprise ephemeral port would break the operator's
        # scrape silently, so warn and stay unbound instead
        logging.getLogger("orange3_spark_tpu_torch").warning(
            "obs: OTPU_OBS_PORT=%r is not a port number; telemetry "
            "server not started", raw)
        return None
    try:
        return TelemetryServer(int(port), context=context).start()
    except OSError as e:
        logging.getLogger("orange3_spark_tpu_torch").warning(
            "obs: telemetry server failed to bind port %s (%s); "
            "serving continues without it", port, e)
        return None
