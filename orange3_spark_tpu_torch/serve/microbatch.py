"""Dynamic micro-batching — coalesce concurrent predicts into one dispatch.

Serving traffic arrives as many small concurrent ``predict()`` calls; each
would dispatch its own (bucket-padded) graph replay and serialize on the
device. This worker merges them: requests enqueue on a bounded queue (the
``exec/pipeline.py`` daemon-thread/queue idiom, coalescing instead of
prefetching), the worker drains up to ``max_batch`` merged rows or
``max_wait_ms`` of the oldest request's wait, concatenates the host-side
row blocks, runs ONE bucketed executable through the owning
``ServingContext``, and scatters the per-row outputs back to each
caller's future.

A copy of the JAX package's ``serve/microbatch.py``; a request's group
key names its device where the JAX package names its session.

Only same-model, same-kind requests merge (different fingerprints flush
the in-flight group and start a new one — request streams are usually
model-homogeneous per endpoint, so the lost merge is marginal). Transform
serving stays direct-dispatch: its output is a table, and splitting a
merged table back per caller would cost more than the merge saves.

Failure semantics: an exception in the merged dispatch lands on every
participating future (callers see the real error, not a hang). ``submit``
and ``close`` are mutually exclusive, so the shutdown sentinel is always
the LAST item the worker sees — everything ahead of it flushes normally
and no future is ever abandoned behind it.

Deadline semantics (resilience/): every returned future carries a hard
deadline (``deadline_s``, env ``OTPU_MB_DEADLINE_S``, default 30 s) — if
the worker thread dies or its dispatch wedges, ``result()`` raises a
typed ``MicroBatchTimeoutError`` naming the request's group key (and
carrying live queue/worker/breaker diagnostics) instead of blocking the
caller forever. A worker found dead at ``submit`` time sheds the request
to direct dispatch (``submit`` returns None). Disabled (legacy
block-forever futures) under ``OTPU_RESILIENCE=0``.

Overload semantics (resilience/overload.py): ``submit`` runs the owning
context's admission check against the queue depth — a request whose
projected queue wait exceeds its deadline budget raises a typed
``OverloadShedError`` instead of parking behind a queue it cannot clear
(no deadline configured = the legacy behavior: a full queue sheds to
direct dispatch via the None return). The worker's coalescing window is
ADAPTIVE: sustained queue depth grows ``max_wait_ms``/the merge target
(bounded by ``OTPU_MB_MAX_WAIT_MS`` and the bucket ladder's top rung),
an idle queue shrinks both back — bigger merges exactly when the queue
needs draining, minimum latency when it does not.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from dataclasses import dataclass, field

import numpy as np

from orange3_spark_tpu_torch.obs.context import current_trace_id
from orange3_spark_tpu_torch.obs.trace import flow, span
from orange3_spark_tpu_torch.serve.bucketing import domain_sig
from orange3_spark_tpu_torch.utils.dispatch import beat
from orange3_spark_tpu_torch.utils.profiling import record_serve

_SENTINEL = object()


class MicroBatchTimeoutError(TimeoutError):
    """A micro-batched request's future missed its hard deadline — the
    coalescer thread died or its merged dispatch wedged. Carries the
    request's ``group_key`` (model fingerprint / schema / session) and
    ``trace_id`` (minted at the serving entry, obs/context.py) plus
    live ``diagnostics`` (queue depth, worker liveness, breaker states)
    so the stuck endpoint is self-explaining from the error alone."""

    def __init__(self, group_key, waited_s: float,
                 diagnostics: dict | None = None,
                 trace_id: str | None = None):
        self.group_key = group_key
        self.waited_s = waited_s
        self.diagnostics = diagnostics or {}
        self.trace_id = trace_id
        extra = f" Diagnostics: {self.diagnostics}." if self.diagnostics \
            else ""
        tr = f" [trace {trace_id}]" if trace_id else ""
        super().__init__(
            f"micro-batched request (group_key={group_key!r}){tr} got no "
            f"result within its {waited_s:.3g}s deadline: the dispatch "
            f"thread died or its device dispatch wedged.{extra} Direct "
            "dispatch (micro_batch=False) or OTPU_MB_DEADLINE_S tune the "
            "deadline; OTPU_RESILIENCE=0 restores unbounded waits."
        )


class _DeadlineFuture(Future):
    """A Future whose no-timeout ``result()``/``exception()`` default to
    the micro-batcher's hard deadline instead of blocking forever."""

    _deadline_s: float | None = None
    _group_key = None
    _diag_fn = None
    _trace_id = None

    def _timeout_error(self, eff) -> MicroBatchTimeoutError:
        diag = None
        if self._diag_fn is not None:
            try:
                diag = self._diag_fn()
            except Exception:  # noqa: BLE001 - diagnostics must not mask
                diag = None
        return MicroBatchTimeoutError(self._group_key, eff, diag,
                                      trace_id=self._trace_id)

    def result(self, timeout=None):
        eff = timeout if timeout is not None else self._deadline_s
        if eff is None:
            return super().result()
        try:
            return super().result(eff)
        except _FutTimeout:
            raise self._timeout_error(eff) from None

    def exception(self, timeout=None):
        eff = timeout if timeout is not None else self._deadline_s
        if eff is None:
            return super().exception()
        try:
            return super().exception(eff)
        except _FutTimeout:
            raise self._timeout_error(eff) from None


@dataclass
class _Request:
    kind: str                    # 'predict' | 'array'
    rec: object                  # serve.context._ModelRecord
    arrays: tuple                # row-stripped host arrays (X, Y|None, W|None)
    n: int                       # logical rows in this request
    meta: tuple                  # (device, domain, x_dtype) for dispatch
    future: Future = field(default_factory=Future)
    trace_id: str | None = None  # the caller's trace id (obs/context.py)

    @property
    def group_key(self):
        # EVERY array's schema, not just X: a labeled (Y present) and an
        # unlabeled predict on the same model must not merge — their row
        # blocks cannot concatenate. Domain and device follow _dispatch's
        # executable key for the same reason.
        device, domain, _ = self.meta
        return (self.kind, self.rec.fingerprint,
                tuple((a.shape[1:], str(a.dtype)) if a is not None else None
                      for a in self.arrays),
                device, domain_sig(domain))


class MicroBatcher:
    """Bounded background coalescer; see module docstring."""

    def __init__(self, ctx, *, max_batch: int = 4096,
                 max_wait_ms: float = 2.0, queue_depth: int = 1024,
                 deadline_s: float | None = None, admission=None,
                 batch_cap: int | None = None):
        from orange3_spark_tpu_torch.resilience.overload import AdaptiveCoalescer

        self.ctx = ctx
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        # the owning context's AdmissionController (None = no admission:
        # the stub-ctx test path and pre-overload callers)
        self.admission = admission
        # load-adaptive wait/merge dial; fixed base values under the
        # kill-switch. batch_cap = the bucket ladder's top rung — growth
        # can never merge past a shape the ladder captures
        self._adapt = AdaptiveCoalescer(
            self.max_wait_s, max_batch,
            batch_cap if batch_cap is not None else max_batch)
        # hard future deadline; None = legacy block-forever (kill-switch)
        from orange3_spark_tpu_torch.resilience.faults import resilience_enabled

        if deadline_s is None and resilience_enabled():
            from orange3_spark_tpu_torch.utils import knobs

            # knobs.get_float falls back to the declared 30 s default on a
            # malformed/unset value — never crash serving-context
            # activation. An EXPLICIT 0 must survive (deadline disabled,
            # the legacy block-forever contract), so no `or` collapse.
            deadline_s = float(knobs.get_float("OTPU_MB_DEADLINE_S"))
        self.deadline_s = (deadline_s if deadline_s and deadline_s > 0
                           and resilience_enabled() else None)
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._closed = False
        self._close_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="serve-microbatch"
        )
        self._thread.start()

    def submit(self, kind: str, rec, arrays, n: int, *,
               meta) -> Future | None:
        """Enqueue one request; returns its Future, or None when this
        request cannot micro-batch (oversized, full queue, dead worker
        thread, or the batcher is closed / called from its own worker —
        the caller then direct-dispatches)."""
        if (self._closed or n > self.max_batch
                or threading.current_thread() is self._thread
                # a dead worker would never drain the queue: shed to
                # direct dispatch instead of parking a doomed future
                or not self._thread.is_alive()):
            return None
        if self.admission is not None:
            # typed load shedding (resilience/overload.py): a request
            # whose projected queue wait exceeds its deadline budget
            # raises OverloadShedError HERE — it must not enqueue (the
            # queue is the overload) nor fall to direct dispatch (that
            # ADDS load). No deadline configured = no-op, and the
            # queue.Full path below keeps its legacy shed-to-direct.
            self.admission.check_queue(self._q.qsize())
        fut = _DeadlineFuture()
        fut._deadline_s = self.deadline_s
        fut._diag_fn = self.diagnostics
        trace_id = current_trace_id()
        req = _Request(kind, rec, tuple(
            np.asarray(a) if a is not None else None for a in arrays
        ), n, meta, future=fut, trace_id=trace_id)
        fut._group_key = req.group_key
        fut._trace_id = trace_id
        if trace_id is not None:
            # flow start (inside the caller's serve span): the arrow's
            # tail; the flush's step and the dispatch's end complete the
            # submit → flush → dispatch link across threads. Emitted
            # BEFORE the enqueue — the worker can flush (and stamp the
            # 't'/'f' hops) in the gap, and an out-of-order chain draws
            # no arrow; a rare dangling 's' on the shed-to-direct path
            # below is harmless by the flow-event rules.
            flow("s", trace_id)
        # atomic with close(): no request can land BEHIND the shutdown
        # sentinel, where the worker would exit without resolving its
        # future and the caller would block in fut.result() forever
        with self._close_lock:
            if self._closed:
                return None
            try:
                self._q.put_nowait(req)
            except queue.Full:
                return None          # overloaded: shed to direct dispatch
        return req.future

    def close(self, timeout_s: float = 5.0) -> None:
        with self._close_lock:
            if not self._closed:
                self._closed = True
                self._q.put(_SENTINEL)   # worker drains ahead of us
        self._thread.join(timeout=timeout_s)

    def diagnostics(self) -> dict:
        """Live state a timeout/shed error carries: queue depth, worker
        liveness, the adaptive factor, and (when an admission controller
        is attached) in-flight count + breaker states."""
        d = {
            "queue_depth": self._q.qsize(),
            "worker_alive": self._thread.is_alive(),
            "closed": self._closed,
            "adapt_factor": round(self._adapt.factor, 3),
        }
        adm = self.admission
        if adm is not None:
            d["inflight"] = adm.inflight
            hook = adm.diagnostics_hook
            if hook is not None:
                try:
                    d["breakers"] = dict(hook())
                except Exception:  # noqa: BLE001 - diagnostics only
                    pass
        return d

    # ------------------------------------------------------------- worker
    def _worker(self) -> None:
        # admitted work: the worker waits for admission slots but is
        # never itself shed (its requests were admitted at submit)
        from orange3_spark_tpu_torch.resilience.overload import request_deadline

        with request_deadline(float("inf")):
            self._worker_loop()

    def _worker_loop(self) -> None:
        pending = None
        while True:
            item = pending if pending is not None else self._q.get()
            pending = None
            if item is _SENTINEL:
                return
            batch = [item]
            rows = item.n
            # adaptive coalescing window (resilience/overload.py): depth
            # pressure grows the wait/merge target, idle shrinks it back
            max_batch = self._adapt.current_batch()
            deadline = time.perf_counter() + self._adapt.current_wait_s()
            while rows < max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    pending = nxt
                    break
                if (nxt.group_key != item.group_key
                        or rows + nxt.n > max_batch):
                    pending = nxt     # flush current group, start the next
                    break
                batch.append(nxt)
                rows += nxt.n
            # service-time EWMA: fed by the admission slot inside
            # ctx._dispatch (dispatch wall only — a flush-level sample
            # here would double-count and fold slot-acquisition WAIT
            # into the "service" estimate, over-shedding under load)
            self._flush(batch, rows)
            self._adapt.update(self._q.qsize())
            beat()                    # serving progress feeds the watchdog

    def _flush(self, batch: list, rows: int) -> None:
        record_serve(mb_requests=len(batch), mb_batches=1)
        traces = [r.trace_id for r in batch if r.trace_id is not None]
        # same-DAG requests group by fingerprint, so the whole flush
        # belongs to one workflow when the model is a ServedWorkflow
        dag = getattr(getattr(batch[0].rec, "model", None), "_dag_name", None)
        with span("mb_flush", requests=len(batch), rows=rows,
                  **({"traces": traces} if traces else {}),
                  **({"dag": dag} if dag else {})):
            # flow steps: each member request's arrow passes through this
            # merged flush on the worker thread
            for t in traces:
                flow("t", t)
            self._flush_inner(batch, rows, traces)

    def _flush_inner(self, batch: list, rows: int,
                     traces: list | None = None) -> None:
        try:
            from orange3_spark_tpu_torch.serve.context import set_dispatch_traces

            # side channel (same thread): _dispatch closes each member's
            # flow arrow inside its serve_dispatch span. Set
            # UNCONDITIONALLY — an empty list clears the slot, so a
            # traceless flush (or one that fails before _dispatch) can
            # never hand the PREVIOUS flush's ids to the next dispatch
            set_dispatch_traces(traces or [])
            first = batch[0]
            if len(batch) == 1:
                merged = first.arrays
            else:
                merged = tuple(
                    np.concatenate([r.arrays[i] for r in batch])
                    if first.arrays[i] is not None else None
                    for i in range(len(first.arrays))
                )
            out = self.ctx._dispatch(first.kind, first.rec, merged, rows,
                                     meta=first.meta)
            off = 0
            for r in batch:
                r.future.set_result(out[off:off + r.n])
                off += r.n
        except BaseException as e:  # noqa: BLE001 - delivered to callers
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
