"""ServingContext — the predict/transform hot path as a subsystem.

A port of the JAX package's ``serve/context.py``. Three composable pieces:

1. **Shape bucketing** (serve/bucketing.py): incoming batches pad up to a
   configurable ladder of canonical row counts, so mixed request sizes
   share a handful of captured programs instead of one per distinct size.
   Pad rows carry weight 0 — the framework's validity-mask convention —
   and are stripped before any caller sees them.

2. **Executable cache** (serve/cache.py): each (model fingerprint, kind,
   bucket shape, dtype, device) maps to one bucket program — LRU-bounded,
   warmable ahead of traffic (``warmup``), with hit/miss/build-time
   counters in ``utils.profiling.serve_counters()``.

3. **Dynamic micro-batching** (serve/microbatch.py): concurrent
   ``predict()`` calls coalesce on a bounded background thread into one
   bucketed dispatch, and results scatter back per caller.

**What a bucket program is.** The JAX package AOT-compiles each bucket
(``jit(fn).lower(...).compile()``), with the model's state passed as
arguments. On a CUDA device the counterpart is one captured
``torch.cuda.CUDAGraph`` per bucket (:class:`_BucketGraph`): the graph
reads static input buffers of the bucket's shape, reads the model's own
tensors in place (the role of state-as-arguments: an in-place update of
the state is seen by the next replay, while ``load_state_pytree``, which
replaces the tensors, moves the model's fingerprint so fresh graphs are
keyed) and writes static outputs. A dispatch copies the request's rows
into the static inputs and zeroes the pad rows, replays the graph and
copies the live rows out — under the entry's lock, because a graph's
static buffers are shared state (a JAX executable is reentrant; a
captured graph is not). Captures are serialized and thread-local
(``utils/graphs.capture_graph``, the fit's replay recipe too), so a
capture can run beside live replays. **On the CPU there are no graphs**: a bucket's program
(:class:`_BucketEager`) is the same function applied to the padded
bucket, so the CPU tests cover the bucketing, padding, cache, breakers
and micro-batching, but not the capture (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` do).

Activation is a context manager::

    with ServingContext(BucketLadder(min_bucket=256, max_bucket=1 << 14)):
        model.predict(batch)        # routed: bucketed + cached + counted

``models.base`` routes every Transformer subclass's ``transform``/
``predict`` through ``route()`` below; with no active context the raw
methods run untouched (one None check), and batches larger than the
ladder's ``max_bucket`` bypass serving. A model whose bucket program
cannot be built (its transform cannot be captured, its hook raises) trips
a per-(model, kind) circuit breaker (resilience/overload.py): the failure
is logged and counted (``build_failures``), and the model serves raw, on
its own device, while the breaker is open; a half-open probe re-admits a
recovered model. Dispatches run under admission control — bounded
in-flight work with projected-wait shedding (typed ``OverloadShedError``)
when a request deadline applies.

The active context is PROCESS-wide (serving worker threads must see the
context their pool installed); nesting is a stack, innermost wins.

Staged workflow programs (workflow/staging.py) share this context's cache
through ``staged_executable``. The first activation of a serving window
resets the process's readiness (obs/server.py ``/readyz`` answers 503
until ``warmup`` completes) and, with ``OTPU_OBS_PORT`` set, binds the
telemetry endpoint for the window's lifetime; ``dump_flight`` writes a
flight bundle now (obs/flight.py). Not ported from the JAX package's
context: the donation switch in the staged keys (the port donates
nothing).
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.obs import context as obs_context
from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.obs.trace import enabled as trace_enabled
from orange3_spark_tpu_torch.obs.trace import flow, span
from orange3_spark_tpu_torch.resilience.overload import (
    AdmissionController, CircuitBreaker, maybe_injected_service_delay,
    shed_total,
)
from orange3_spark_tpu_torch.serve.bucketing import BucketLadder, domain_sig, table_to_host
from orange3_spark_tpu_torch.serve.cache import ExecutableCache
from orange3_spark_tpu_torch.serve.tenancy import current_tenant, tenancy_enabled
from orange3_spark_tpu_torch.utils.dispatch import beat
from orange3_spark_tpu_torch.utils.graphs import capture_graph
from orange3_spark_tpu_torch.utils.profiling import record_serve

# routed serve calls currently executing (a liveness probe treats a stale
# heartbeat as unhealthy only while this is > 0)
_M_INFLIGHT = REGISTRY.gauge(
    "otpu_serve_inflight", "routed serve calls currently in flight")
_M_TRACED = REGISTRY.counter(
    "otpu_traced_requests_total",
    "serve requests that minted a trace id at entry")

log = logging.getLogger("orange3_spark_tpu_torch")

# process-wide context stack + per-thread reentrancy depth (serving builds
# run the RAW methods; the guard keeps the router out of its own build)
_ACTIVE: list["ServingContext"] = []
_ACTIVE_LOCK = threading.Lock()
_TLS = threading.local()


def active_serving_context() -> "ServingContext | None":
    # lock-free on purpose: this runs on EVERY predict/transform, and a
    # single-bytecode list index is atomic under the GIL — only the
    # __enter__/__exit__ writers take _ACTIVE_LOCK
    try:
        return _ACTIVE[-1]
    except IndexError:
        return None


def _reentrant() -> bool:
    return getattr(_TLS, "depth", 0) > 0


class _raw_calls:
    """Suppress serve routing on this thread (used around built bodies)."""

    def __enter__(self):
        _TLS.depth = getattr(_TLS, "depth", 0) + 1

    def __exit__(self, *exc):
        _TLS.depth -= 1


def _request_scope():
    """Per-request trace context (obs/context.py): mint a trace id at the
    serving entry — ``route()`` for table calls, ``served_array`` for the
    raw-chunk models whose predict routes itself — unless an outer scope
    already minted one (reuse). Ticks the trace-coverage counter only on
    a genuine mint, so ``traced_requests / requests`` is an honest ratio."""
    if trace_enabled() and obs_context.current_trace() is None:
        _M_TRACED.inc()
    return obs_context.trace_scope("serve", reuse=True, sample=True)


# micro-batch flush -> _dispatch side channel for the merged requests'
# trace ids (same worker thread). take() clears, so ids never leak across
# flushes.
_DISPATCH_TLS = threading.local()


def set_dispatch_traces(ids) -> None:
    _DISPATCH_TLS.ids = ids


def take_dispatch_traces():
    ids = getattr(_DISPATCH_TLS, "ids", None)
    _DISPATCH_TLS.ids = None
    return ids


def route(kind: str, raw_fn: Callable, model, *args, **kwargs):
    """The models.base dispatch point: serve when a context is active and
    the call is a plain single-table ``transform``/``predict``; otherwise
    run the raw method untouched."""
    ctx = active_serving_context()
    if (ctx is None or _reentrant() or kwargs or len(args) != 1
            or not isinstance(args[0], TorchTable)):
        return raw_fn(model, *args, **kwargs)
    # a served workflow under its kill-switch (or past its stage ceiling)
    # runs its raw stagewise walk HERE: each stage then re-enters route()
    # and serves on its own, bitwise the per-model path
    passthrough = getattr(model, "_serve_passthrough", None)
    if passthrough is not None and passthrough(kind):
        return raw_fn(model, *args, **kwargs)
    table = args[0]
    dag = getattr(model, "_dag_name", None)
    beat()
    _M_INFLIGHT.inc()
    try:
        with _request_scope():
            tenant = current_tenant() if tenancy_enabled() else None
            with span("serve", kind=kind, rows=table.n_rows,
                      **({"dag": dag} if dag else {}),
                      **({"tenant": tenant} if tenant else {})):
                if kind == "transform":
                    return ctx.served_transform(model, table, raw_fn)
                return ctx.served_predict(model, table, raw_fn)
    finally:
        _M_INFLIGHT.dec()
        beat()


def _fingerprint(model) -> tuple:
    # the state token moves on in-place checkpoint hot-reloads
    # (Model.load_state_pytree): a bucket program reads the model's
    # tensors at the addresses they had when it was built, so a reloaded
    # model (new tensors) must key fresh programs — not silently serve
    # the old weights
    token_fn = getattr(model, "_serve_state_token", None)
    token = (token_fn() if token_fn is not None
             else getattr(model, "_serve_state_version", 0))
    return (type(model).__name__, id(model), token)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _state_device(state) -> torch.device:
    """The device of a serving state's tensors (CPU when it holds none)."""
    stack = [state]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return torch.device("cpu")


def _serve_device(model) -> torch.device:
    """Where an array-serving model's state lies: its ``device`` when it
    has one (no state is built for the question), else its state's."""
    dev = getattr(model, "device", None)
    if isinstance(dev, torch.device):
        return dev
    return _state_device(model._serve_array_state())


def _to_device(state, device):
    """Host leaves (numpy arrays) of a serving state moved to ``device``;
    tensors stay where they are, so the program reads them in place."""
    if isinstance(state, dict):
        return {k: _to_device(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_device(v, device) for v in state)
    if isinstance(state, np.ndarray):
        return torch.as_tensor(state, device=device)
    return state


def _rows(src, n: int) -> torch.Tensor:
    """The first ``n`` rows of a host array or tensor, as a tensor."""
    t = src if isinstance(src, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(src))
    return t[:n]


class _BucketGraph:
    """One bucket's program on a CUDA device: ``fn(*inputs)`` captured as
    a CUDA graph over static input buffers of the bucket's shape.

    ``specs``: one (shape, dtype) per input, or None for an absent input
    (a table without Y). ``device_bytes`` is what the entry holds on the
    device: the static inputs plus the graph's memory pool (its outputs
    and intermediates), measured by the allocator around the build.

    The entry keeps ``fn`` — and with it every tensor ``fn`` closes over
    (the model's state, the salts made for the build): the graph reads
    them at the addresses they had during the capture, and a tensor freed
    after the build would hand its memory to the next allocation.
    """

    def __init__(self, fn: Callable, specs, device: torch.device):
        self.fn = fn
        self.device = device
        self.n_pad = next(s[0][0] for s in specs if s is not None)
        mem0 = torch.cuda.memory_allocated(device)
        self.inputs = [None if s is None else torch.zeros(s[0], dtype=s[1], device=device)
                       for s in specs]
        in_bytes = torch.cuda.memory_allocated(device) - mem0
        self.graph, self.outputs, pool_bytes = capture_graph(
            lambda: fn(*self.inputs), device)
        self.device_bytes = in_bytes + pool_bytes
        self.lock = threading.Lock()

    def fill(self, arrays, n: int) -> None:
        """Copy the request's ``n`` rows into the static inputs and zero
        rows ``n..n_pad`` (the zero padding ``pad_rows_np`` gives)."""
        for buf, src in zip(self.inputs, arrays):
            if buf is None:
                continue
            buf[:n].copy_(_rows(src, n))
            if n < self.n_pad:
                buf[n:].zero_()

    def replay(self) -> None:
        self.graph.replay()
        record_serve(graph_replays=1)

    def __call__(self, arrays, n: int, take: Callable):
        """Fill, replay, and ``take(outputs)`` — all under the entry's
        lock: ``take`` must copy what it returns (the next dispatch
        overwrites the static outputs)."""
        with self.lock:
            self.fill(arrays, n)
            self.replay()
            return take(self.outputs)


class _BucketEager:
    """One bucket's program where there are no graphs (the CPU): ``fn``
    applied to the request padded to the bucket, per call. The build runs
    ``fn`` once on a zero bucket, as a capture would, so a function that
    cannot serve fails at build time and opens its breaker there."""

    def __init__(self, fn: Callable, specs, device: torch.device):
        self.fn, self.specs, self.device = fn, specs, device
        fn(*self._padded((None,) * len(specs), 0))

    def _padded(self, arrays, n: int) -> list:
        inputs = []
        for spec, src in zip(self.specs, arrays):
            if spec is None:
                inputs.append(None)
                continue
            buf = torch.zeros(spec[0], dtype=spec[1], device=self.device)
            if n:
                buf[:n].copy_(_rows(src, n))
            inputs.append(buf)
        return inputs

    def __call__(self, arrays, n: int, take: Callable):
        return take(self.fn(*self._padded(arrays, n)))


def _bucket_program(fn: Callable, specs, device: torch.device):
    """A bucket's program: a captured graph on CUDA, eager on the CPU."""
    cls = _BucketGraph if device.type == "cuda" else _BucketEager
    return cls(fn, specs, device)


def _host_rows(n: int):
    """``take`` for row outputs: the first ``n`` rows as a numpy array the
    caller owns (a copy, never a view of a static buffer)."""
    return lambda out: out[:n].cpu().numpy()


class _ModelRecord:
    """Per-model serving snapshot: the fingerprint that keys programs.

    Identity-based on purpose — an in-process serving cache serves the
    model OBJECTS the process fitted/loaded; replacing a model (or
    refitting into a new instance) naturally keys fresh programs and the
    LRU retires the old ones."""

    __slots__ = ("model", "fingerprint")

    def __init__(self, model):
        self.model = model
        self.fingerprint = _fingerprint(model)


class ServingContext:
    """See module docstring. Parameters:

    ladder        BucketLadder (default pow2 256..65536)
    max_entries   LRU bound on bucket programs
    micro_batch   enable the background coalescer for predict()
    max_batch     micro-batcher: flush when merged rows reach this
    max_wait_ms   micro-batcher: flush when the oldest request has waited
                  this long
    """

    def __init__(self, ladder: BucketLadder | None = None, *,
                 max_entries: int = 64, micro_batch: bool = False,
                 max_batch: int = 4096, max_wait_ms: float = 2.0,
                 admission: AdmissionController | None = None,
                 breaker_clock=None):
        self.ladder = ladder or BucketLadder()
        self.cache = ExecutableCache(max_entries, on_evict=self._on_evict)
        self._records: dict[int, _ModelRecord] = {}
        self._rec_lock = threading.Lock()
        # (fingerprint, kind) -> CircuitBreaker: a build failure opens it
        # (raw path while open), the seeded cooldown admits a half-open
        # probe build, and a probe success re-admits the model
        self._unservable: dict = {}
        self._breaker_clock = breaker_clock or time.monotonic
        # admission control: bounded in-flight dispatches + projected-wait
        # shedding (sheds only once a request deadline is configured). A
        # caller-shared controller keeps ITS diagnostics hook
        self.admission = admission or AdmissionController()
        if self.admission.diagnostics_hook is None:
            self.admission.diagnostics_hook = self.breaker_states
        self._micro_batch = micro_batch
        # a merged batch larger than the ladder's top rung would need its
        # own program per merged size, so the coalescer never merges past
        # max_bucket
        if max_batch > self.ladder.max_bucket:
            if micro_batch:
                log.warning(
                    "serve: max_batch=%d exceeds the ladder's max_bucket=%d; "
                    "clamping (larger merges would build per merged size)",
                    max_batch, self.ladder.max_bucket)
            max_batch = self.ladder.max_bucket
        self._max_batch = max_batch
        self._max_wait_ms = max_wait_ms
        # staged programs cached here, pinned by identity (staged_executable)
        self._staged_refs: dict[int, Any] = {}
        self._activations = 0
        self.micro_batcher = None
        self._telemetry = None       # obs/server.py, OTPU_OBS_PORT opt-in
        self._run_report = None      # obs/report.py, per-activation window

    # ------------------------------------------------------ context stack
    def __enter__(self) -> "ServingContext":
        # the batcher (and its daemon worker) lives while ANY activation is
        # open: re-entry gets a fresh coalescer, a context built but never
        # entered starts no thread, and the last overlapping __exit__
        # closes it
        with _ACTIVE_LOCK:
            if self._micro_batch and self.micro_batcher is None:
                from orange3_spark_tpu_torch.serve.microbatch import MicroBatcher

                self.micro_batcher = MicroBatcher(
                    self, max_batch=self._max_batch,
                    max_wait_ms=self._max_wait_ms,
                    admission=self.admission,
                    batch_cap=self.ladder.max_bucket,
                )
            self._activations += 1
            if not _ACTIVE:
                # a FRESH serving window for the process (no context was
                # active): not /readyz-ready until warmed (obs/server.py;
                # overlapping activations inherit the window's state)
                from orange3_spark_tpu_torch.obs.server import reset_readiness

                reset_readiness()
            if self._activations == 1:
                from orange3_spark_tpu_torch.obs.server import maybe_start_from_env
                from orange3_spark_tpu_torch.obs.trace import refreshed_enabled

                # per-window observability: a fresh run report brackets
                # the serve counters, and the opt-in telemetry endpoint
                # (OTPU_OBS_PORT) binds for the window's lifetime. Both
                # ride the OTPU_OBS kill-switch (report() then degrades to
                # the process-absolute view)
                if refreshed_enabled():
                    from orange3_spark_tpu_torch.obs.report import RunReport

                    self._run_report = RunReport(
                        "serving", ladder=list(self.ladder.buckets()),
                        micro_batch=self._micro_batch)
                else:
                    self._run_report = None
                self._telemetry = maybe_start_from_env(self)
            _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _ACTIVE_LOCK:
            try:
                _ACTIVE.remove(self)
            except ValueError:
                pass
            self._activations = max(0, self._activations - 1)
            mb = self.micro_batcher if self._activations == 0 else None
            if mb is not None:
                self.micro_batcher = None
            srv = self._telemetry if self._activations == 0 else None
            if srv is not None:
                self._telemetry = None
            rep = self._run_report if self._activations == 0 else None
        # all outside the lock (close/stop join threads), and chained so a
        # close() that raises neither leaks the bound listener nor leaves
        # the window's report unfrozen
        try:
            if mb is not None:
                mb.close()
        finally:
            try:
                if srv is not None:
                    srv.stop()
            finally:
                if rep is not None:
                    rep.finish()

    # ------------------------------------------------------------ records
    def _record_for(self, model) -> _ModelRecord:
        key = id(model)
        with self._rec_lock:
            rec = self._records.get(key)
            if rec is None or rec.fingerprint != _fingerprint(model):
                # fingerprint moved (state hot-reload): fresh record keys
                # fresh programs; the old ones retire through the LRU
                rec = self._records[key] = _ModelRecord(model)
            return rec

    def _tick_bucket(self, key, n: int, n_pad: int) -> None:
        hit = key in self.cache
        record_serve(request_rows=n, padded_rows=n_pad,
                     **({"bucket_hits": 1} if hit else {"bucket_misses": 1}))

    def _tick_dispatch(self, key, n_pad: int) -> None:
        """Bucket hit/miss + padded rows for one DEVICE DISPATCH — under
        the micro-batcher that is the merged batch, not each caller's
        request (callers tick ``request_rows`` at submit)."""
        hit = key in self.cache
        record_serve(padded_rows=n_pad,
                     **({"bucket_hits": 1} if hit else {"bucket_misses": 1}))

    def _on_evict(self, key) -> None:
        """LRU eviction releases the context-side pins: once the cache
        holds no program for a model fingerprint, drop the record so
        refitted-away models do not accumulate for the context's lifetime.
        Called by the cache outside its lock."""
        live = self.cache.keys()
        fp = key[1]
        if any(len(k) > 1 and k[1] == fp for k in live):
            return
        with self._rec_lock:
            for mid, r in list(self._records.items()):
                if r.fingerprint == fp:
                    del self._records[mid]
            # the record's strong ref kept id(model) stable; without it the
            # id can be reused, so fingerprint-keyed breakers go too
            self._unservable = {u: br for u, br in self._unservable.items()
                                if u[0] != fp}

    # ----------------------------------------------------- served entries
    def served_transform(self, model, table: TorchTable, raw_fn=None):
        raw_fn = raw_fn or type(model).transform
        n = table.n_rows
        bucket = self.ladder.bucket_for(n)
        # bypass/breaker checks BEFORE _record_for: a record pins the model
        if (bucket is None
                or self._breaker_blocks(_fingerprint(model), "transform")):
            with _raw_calls():
                return raw_fn(model, table)
        rec = self._record_for(model)
        n_pad = table.session.pad_rows(bucket)
        key = self._table_key("transform", rec, n_pad, table.n_attrs, table.X.dtype,
                              self._y_cols(table.Y), table.domain, table.X.device)
        self._tick_bucket(key, n, n_pad)
        try:
            program, meta = self._ensure_table_exec(
                key, rec, "transform", table.session, table.domain,
                n_attrs=table.n_attrs, x_dtype=table.X.dtype,
                y_cols=self._y_cols(table.Y),
                y_dtype=(table.Y.dtype if table.Y is not None else None),
                n_pad=n_pad, device=table.X.device)
        except Exception as e:  # noqa: BLE001 - a transform that cannot be built
            self._blacklist(rec, "transform", e, key=key)
            with _raw_calls():
                return raw_fn(model, table)
        self._breaker_ok(rec.fingerprint, "transform")
        with self.admission.slot():
            maybe_injected_service_delay()
            outX, outY, outW = program(
                (table.X, table.Y, table.W), n,
                lambda out: tuple(None if o is None else o[:n].clone() for o in out))
        return TorchTable(meta["domain"], outX, outY, outW, table.metas, n,
                          table.session)

    def served_predict(self, model, table: TorchTable, raw_fn=None):
        raw_fn = raw_fn or type(model).predict
        n = table.n_rows
        bucket = self.ladder.bucket_for(n)
        if bucket is None:
            with _raw_calls():
                return raw_fn(model, table)
        rec = self._record_for(model)
        n_pad = table.session.pad_rows(bucket)
        device = table.X.device
        hook = getattr(type(model), "_device_predict", None)
        if hook is None or self._breaker_blocks(rec.fingerprint, "predict"):
            # no device hook: bucket-pad the table and run the raw predict
            # on it (rows are independent, and the raw predict strips by
            # n_rows as ever) — every tree model of this package
            key = self._table_key("predict-pad", rec, n_pad, table.n_attrs, table.X.dtype,
                                  self._y_cols(table.Y), table.domain, device)
            self._tick_bucket(key, n, n_pad)
            self.cache.mark(key)   # LRU presence: pad-served models prune
            #                        via _on_evict like every other kind
            padded = self._bucket_pad_table(table, n_pad)
            with _raw_calls():
                return raw_fn(model, padded)
        meta = (str(device), table.domain, table.X.dtype)
        if self.micro_batcher is None:
            key = self._table_key("predict", rec, n_pad, table.n_attrs, table.X.dtype,
                                  self._y_cols(table.Y), table.domain, device)
            self._tick_bucket(key, n, n_pad)
            try:
                program, _ = self._ensure_table_exec(
                    key, rec, "predict", table.session, table.domain,
                    n_attrs=table.n_attrs, x_dtype=table.X.dtype,
                    y_cols=self._y_cols(table.Y),
                    y_dtype=(table.Y.dtype if table.Y is not None else None),
                    n_pad=n_pad, device=device)
            except Exception as e:  # noqa: BLE001
                self._blacklist(rec, "predict", e, key=key)
                with _raw_calls():
                    return raw_fn(model, table)
            self._breaker_ok(rec.fingerprint, "predict")
            with self.admission.slot():
                maybe_injected_service_delay()
                return program((table.X, table.Y, table.W), n, _host_rows(n))
        record_serve(request_rows=n)    # dispatch-level ticks live in
        #                                 _dispatch (merged under the mb)
        X, Y, W = table_to_host(table)
        arrays = (X[:n], Y[:n] if Y is not None else None, W[:n])
        fut = self.micro_batcher.submit("predict", rec, arrays, n, meta=meta)
        try:
            if fut is not None:
                return fut.result()
            return self._dispatch("predict", rec, arrays, n, meta=meta)
        except _BuildFailed:
            # same contract as direct dispatch: an unservable model falls
            # back to its raw path, never raises
            with _raw_calls():
                return raw_fn(model, table)

    def served_array(self, model, Xall: np.ndarray):
        """Array-program serving (models whose predict consumes raw host
        chunks, e.g. hashed_linear): the model supplies the device fn via
        ``_serve_array_fn`` and its state via ``_serve_array_state``; the
        program reads that state in place. Returns the fn's output rows
        for ``Xall`` or None when serving does not apply (the caller falls
        through to its raw path)."""
        Xall = np.asarray(Xall)
        from orange3_spark_tpu_torch.online.tap import maybe_tap_request

        maybe_tap_request(Xall)
        n = Xall.shape[0]
        # serving-doesn't-apply checks BEFORE the trace mint
        if (self.ladder.bucket_for(n) is None
                or self._breaker_blocks(_fingerprint(model), "array")):
            return None
        with _request_scope():
            tenant = current_tenant() if tenancy_enabled() else None
            with span("serve", kind="array", rows=n,
                      **({"tenant": tenant} if tenant else {})):
                return self._served_array_inner(model, Xall, n)

    def _served_array_inner(self, model, Xall: np.ndarray, n: int):
        rec = self._record_for(model)
        record_serve(request_rows=n)
        arrays = (Xall, None, None)
        meta = (str(_serve_device(model)), None, Xall.dtype)
        try:
            if self.micro_batcher is not None:
                fut = self.micro_batcher.submit("array", rec, arrays, n, meta=meta)
                if fut is not None:
                    return fut.result()
            return self._dispatch("array", rec, arrays, n, meta=meta)
        except _BuildFailed:
            return None      # caller falls through to its raw path

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, kind: str, rec: _ModelRecord, arrays, n: int, *,
                  meta) -> np.ndarray:
        """Pad ``arrays`` (host, row-stripped) to the bucket, run the
        bucket's program, return per-row outputs stripped back to ``n``
        rows. The micro-batcher calls this with MERGED request rows (their
        trace ids ride the thread-local side channel)."""
        member_traces = take_dispatch_traces()
        device, domain, x_dtype = meta
        bucket = self.ladder.bucket_for(n)
        if bucket is None:       # merged batch outgrew the ladder: clamp
            bucket = self.ladder.max_bucket
        n_pad = max(bucket, n)
        X, Y, W = arrays
        if kind == "array":
            key = ("array", rec.fingerprint, n_pad, X.shape[1], str(X.dtype), device)
            build = lambda: self._build_array_exec(rec, X.shape[1], X.dtype, n_pad)  # noqa: E731
        else:
            key = self._table_key("predict", rec, n_pad, X.shape[1], x_dtype,
                                  self._y_cols(Y), domain, device)
            build = lambda: self._build_table_exec(  # noqa: E731
                rec, "predict", TorchSession(device), domain, n_attrs=X.shape[1],
                x_dtype=x_dtype,
                y_cols=self._y_cols(Y), y_dtype=(Y.dtype if Y is not None else None),
                n_pad=n_pad, device=torch.device(device))
        self._tick_dispatch(key, n_pad)
        try:
            program = self.cache.get_or_build(key, build)
        except Exception as e:  # noqa: BLE001
            self._blacklist(rec, kind, e, key=key)
            raise _BuildFailed from e
        if kind != "array":
            program = program[0]
        self._breaker_ok(rec.fingerprint, kind)
        with self.admission.slot():
            maybe_injected_service_delay()
            with span("serve_dispatch", kind=kind, rows=n, n_pad=n_pad):
                for t in member_traces or ():
                    flow("f", t)
                return program(arrays, n, _host_rows(n))

    # ------------------------------------------------------------ builders
    @staticmethod
    def _y_cols(Y) -> int:
        return Y.shape[1] if Y is not None else 0

    def _table_key(self, kind, rec, n_pad: int, n_attrs: int, x_dtype, y_cols: int,
                   domain, device) -> tuple:
        return (kind, rec.fingerprint, n_pad, n_attrs, str(x_dtype), y_cols,
                domain_sig(domain), str(device))

    def _ensure_table_exec(self, key, rec, kind, session, domain, **kw):
        return self.cache.get_or_build(
            key, lambda: self._build_table_exec(rec, kind, session, domain, **kw))

    def _build_table_exec(self, rec, kind, session, domain, *, n_attrs, x_dtype,
                          y_cols, y_dtype, n_pad, device):
        """``((X, Y, W), n, take) -> take(outputs)`` for one bucket: the
        model's transform (outputs X, Y, W) or its ``_device_predict``,
        on a bucket-shaped table. The model's fitted state is read where
        it lies (these models' states are small)."""
        model = rec.model
        meta: dict[str, Any] = {}

        def fn(X, Y, W):
            t = TorchTable(domain, X, Y, W, None, n_pad, session)
            with _raw_calls():
                if kind == "transform":
                    # copy: transforms may set host attrs on self
                    out = copy.copy(model).transform(t)
                    meta["domain"] = out.domain
                    return out.X, out.Y, out.W
                return model._device_predict(t)

        specs = [((n_pad, n_attrs), _torch_dtype(x_dtype)),
                 ((n_pad, y_cols), _torch_dtype(y_dtype)) if y_cols else None,
                 ((n_pad,), torch.float32)]
        return _bucket_program(fn, specs, torch.device(device)), meta

    def _build_array_exec(self, rec, n_cols, dtype, n_pad):
        """``((X, _, _), n, take)`` for an array-serving model
        (``_serve_array_state`` / ``_serve_array_fn`` hooks): ``X`` is
        ``[n_pad, n_cols]`` on the device of the model's state."""
        model = rec.model
        state = model._serve_array_state()
        device = _state_device(state)
        state = _to_device(state, device)

        def fn(Xp, _y, _w):
            with _raw_calls():
                return model._serve_array_fn(state, Xp)

        return _bucket_program(fn, [((n_pad, n_cols), _torch_dtype(dtype)), None, None],
                               device)

    def _breaker_blocks(self, fp, kind) -> bool:
        """Is this (fingerprint, kind) barred from serving right now?
        No breaker = never failed = serve. An open breaker serves raw
        until its cooldown admits a half-open probe."""
        br = self._unservable.get((fp, kind))
        return br is not None and not br.allow()

    def _breaker_ok(self, fp, kind) -> None:
        """A build/cache hit succeeded for a key that has a breaker: close
        a half-open probe (the recovered model is re-admitted)."""
        br = self._unservable.get((fp, kind))
        if br is not None:
            br.record_success()

    def breaker_states(self) -> dict:
        """{'<Model>:<kind>': 'closed'|'half-open'|'open'} for every
        breaker this context holds. Two same-class models' breakers get
        id-suffixed keys instead of overwriting each other."""
        with self._rec_lock:
            items = list(self._unservable.items())
        out: dict = {}
        for (fp, kind), br in items:
            key = f"{fp[0]}:{kind}"
            if key in out:
                key = f"{fp[0]}[{fp[1]}]:{kind}"
            out[key] = br.state()
        return out

    def _blacklist(self, rec, kind, e, key=None) -> None:
        """A serving build failed (post-retry): log it, count it, and trip
        the (fingerprint, kind) circuit breaker. While open the model
        serves raw; after the seeded cooldown one half-open probe
        re-attempts the build."""
        record_serve(build_failures=1)
        with self._rec_lock:
            br = self._unservable.get((rec.fingerprint, kind))
            known = br is not None
            if br is None:
                br = self._unservable[(rec.fingerprint, kind)] = \
                    CircuitBreaker(f"serve:{kind}", clock=self._breaker_clock)
        br.record_failure()
        if not known:
            log.warning(
                "serve: %s %s cannot be built for serving, using the raw path "
                "until the breaker re-probes (%s)", rec.fingerprint[0], kind,
                f"{type(e).__name__}: {e}"[:200])
        if key is not None:
            # the failed build left no cache entry; a marker gives the
            # fingerprint LRU presence so _on_evict eventually releases
            # the record pin and the breaker entry
            self.cache.mark(key)

    # ----------------------------------------------------------- utilities
    @staticmethod
    def _bucket_pad_table(table: TorchTable, n_pad: int) -> TorchTable:
        """``table`` with its first ``n_rows`` rows zero-padded to
        ``n_pad`` (pad rows ride W=0), on the table's device."""
        if table.n_pad == n_pad:
            return table
        n = table.n_rows

        def pad(a):
            if a is None:
                return None
            out = torch.zeros((n_pad,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
            out[:n] = a[:n]
            return out

        return TorchTable(table.domain, pad(table.X), pad(table.Y), pad(table.W),
                          table.metas, n, table.session)

    # ------------------------------------------------------------- warmup
    def warmup(self, model, template: TorchTable | None = None, *,
               buckets=None, kinds=None, n_cols: int | None = None) -> dict:
        """Build the model's bucket programs for ``buckets`` (default: the
        ladder's full rungs) so no request pays a capture. ``template``
        supplies the schema for table-serving models (a 1-row table with
        the right domain is enough); ``n_cols`` does the same for
        array-serving models. Returns {"compiled": n, "buckets": [...]}
        (``compiled``: the programs built, the JAX package's key name)."""
        buckets = list(buckets if buckets is not None else self.ladder.buckets())
        rec = self._record_for(model)
        if kinds is None:
            kinds = []
            if template is not None:
                kinds.append("transform")
                if getattr(type(model), "_device_predict", None) is not None:
                    kinds.append("predict")
            if n_cols is not None or hasattr(model, "_serve_array_fn"):
                kinds.append("array")
        built = 0
        for b in buckets:
            for kind in kinds:
                if kind == "array":
                    n_cols = n_cols if n_cols is not None else getattr(model, "n_cols", None)
                    if n_cols is None:
                        raise ValueError(
                            "array warmup needs n_cols= (the model's serving "
                            "chunk width)")
                    key = ("array", rec.fingerprint, b, n_cols,
                           str(np.dtype(np.float32)), str(_serve_device(model)))
                    hit = key in self.cache
                    self.cache.get_or_build(
                        key, lambda: self._build_array_exec(
                            rec, n_cols, np.dtype(np.float32), b))
                    built += 0 if hit else 1
                    continue
                if template is None:
                    raise ValueError(f"{kind} warmup needs template=")
                n_pad = template.session.pad_rows(b)
                y_cols = self._y_cols(template.Y)
                key = self._table_key(kind, rec, n_pad, template.n_attrs, template.X.dtype,
                                      y_cols, template.domain, template.X.device)
                hit = key in self.cache
                self._ensure_table_exec(
                    key, rec, kind, template.session, template.domain,
                    n_attrs=template.n_attrs, x_dtype=template.X.dtype, y_cols=y_cols,
                    y_dtype=(template.Y.dtype if template.Y is not None else None),
                    n_pad=n_pad, device=template.X.device)
                built += 0 if hit else 1
        # readiness (obs/server.py /readyz): the ladder is built, so a
        # router may send traffic without a request paying a capture
        from orange3_spark_tpu_torch.obs.server import note_warmup_complete

        note_warmup_complete()
        return {"compiled": built, "buckets": buckets}

    # ------------------------------------------------------------- report
    def report(self) -> dict:
        """Structured serving report (obs/report.py): counter deltas since
        the first activation of the current window, live cache/batcher
        state. Poll it on a long-lived context or read it after __exit__ —
        the window's report is frozen at the last deactivation."""
        rep = self._run_report
        if rep is None:
            from orange3_spark_tpu_torch.obs.report import counter_families

            out = {
                "kind": "serving",
                "meta": {"ladder": list(self.ladder.buckets()),
                         "micro_batch": self._micro_batch,
                         "window": "process-absolute"},
                "started_at": None, "wall_s": None, "stage_times": {},
                "counters": counter_families(),
            }
        else:
            out = rep.to_dict()
        out["cache_entries"] = len(self.cache)
        out["cache_device_bytes"] = self.cache.device_bytes()
        out["breakers"] = self.breaker_states()
        with self._rec_lock:
            brs = list(self._unservable.values())
        out["unservable"] = sum(1 for br in brs if br.state() != "closed")
        out["sheds"] = shed_total()
        out["micro_batcher_active"] = self.micro_batcher is not None
        out["telemetry_url"] = (self._telemetry.url
                                if self._telemetry is not None else None)
        if "slow_traces" not in out:
            from orange3_spark_tpu_torch.obs.trace import slowest_traces

            out["slow_traces"] = slowest_traces(5)
        return out

    def dump_flight(self, reason: str = "manual") -> str | None:
        """Write an anomaly flight bundle NOW (obs/flight.py) — the manual
        black-box pull of a live serving process. Returns the bundle path
        (None under the OTPU_OBS/OTPU_FLIGHT kill-switches)."""
        from orange3_spark_tpu_torch.obs import flight

        return flight.dump(reason, context=self)

    # ------------------------------------------------- staged-graph reuse
    def staged_executable(self, staged, tables: dict):
        """Staged workflow programs share this context's cache: a staged
        graph's program (its captured segments) is keyed on (program
        identity, input shapes) and built under ``_raw_calls`` (the build
        runs each stage's raw transform; a stage re-entering the router
        would serve a bucket in the middle of the staged program)."""
        from orange3_spark_tpu_torch.workflow.staging import _shape_key

        # pin the staged object: the key is identity-based, and a strong ref
        # keeps a collected program from handing its id to another
        self._staged_refs[id(staged)] = staged
        key = ("staged", id(staged), _shape_key(tables, staged.input_keys))

        def build():
            with _raw_calls():
                return staged._build_program(tables)

        return self.cache.get_or_build(key, build)


class _BuildFailed(Exception):
    """Internal: the bucket build for a request failed; caller falls back."""
