"""Structured span tracing — the host-side timeline a Spark UI would show.

``torch.profiler`` already captures DEVICE time; what it cannot show is
the framework's own structure —
which fit, which epoch, which chunk, which dispatch the host was inside
when the device stalled. This module records that structure as spans:

    with span("epoch", i):          # or: for i in span_iter("epoch", rng)
        ...
    instant("retry", cause="source")   # point events (retries, wedges)

Design constraints, in order:

* **lock-free fast path** — recording a span is one ``perf_counter_ns``
  pair, one atomic-under-the-GIL ``itertools.count`` bump, a push/pop on
  the thread's open-span stack and one list slot store; no lock anywhere
  on the hot path. With ``OTPU_OBS=0`` the ``span()`` call returns a
  shared no-op context manager (one global read, zero allocation) — the
  bench obs A/B arm pins the overhead < 2%.
* **bounded** — events land in a ring buffer (``OTPU_OBS_TRACE_CAP``,
  default 65536); a week-long serving process overwrites, never grows.
* **request identity** — every span carries ``trace_id`` (the active
  :mod:`obs.context` trace/run id), a process-unique ``span_id`` and the
  ``parent_id`` of the enclosing span on its thread, so one request's
  events are joinable across threads (the flight recorder and the
  slow-trace report both group by trace id). Cross-thread hops record
  Chrome **flow events** (:func:`flow`) linking a micro-batched submit to
  its coalesced flush and dispatch.
* **standard export** — ``export_chrome_trace()`` emits Chrome
  trace-event JSON (loads in Perfetto / ``chrome://tracing``); span
  nesting is by time containment per thread, the viewer convention, and
  flow arrows render from the ``s``/``t``/``f`` events.
* **device alignment** — while a ``torch.profiler`` session is recording,
  each span also enters a ``torch.profiler.record_function`` range, so the
  profile shows the SAME host span names lined up against the device
  timeline. With no profiler running a span does not touch the profiler
  at all (one flag read), so it costs what it costs with none.

Span taxonomy (docs/observability.md): ``fit`` ⊃ ``epoch`` ⊃ ``chunk`` ⊃
``dispatch`` for the streaming estimators, ``prefetch`` on the pipeline
worker thread, ``serve``/``mb_flush``/``serve_dispatch`` on the serving
path, ``timed:*`` for ``@timed`` functions; instants ``retry``/``fault``/
``wedge``/``crc_failure``/``shed``/``divergence``/``brownout`` from the
resilience subsystem; flows ``req`` across the micro-batcher's threads.

Ring-event layout (consumed by flight.py and the tests):
``(ph, name, t0_ns, dur_ns, thread_ident, args, trace_id, span_id,
parent_id)`` — the first six slots are the original span layout, unchanged.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterable, Iterator

import torch

from orange3_spark_tpu_torch.obs import context as _context
from orange3_spark_tpu_torch.utils import knobs

__all__ = [
    "clear",
    "enabled",
    "events",
    "export_chrome_trace",
    "flow",
    "flush_buffered",
    "force_disabled",
    "force_enabled",
    "instant",
    "open_spans",
    "refresh",
    "refreshed_enabled",
    "set_enabled",
    "slowest_traces",
    "span",
    "span_iter",
    "spans_payload",
    "validate_chrome_trace",
]

_enabled: bool = knobs.get_bool("OTPU_OBS")
_cap: int = max(16, int(knobs.get_int("OTPU_OBS_TRACE_CAP")))
_ring: list = [None] * _cap
_seq = itertools.count()
#: span ids are their own sequence (ring slots recycle, identities don't)
_span_ids = itertools.count(1)


def _profiler_range(name: str):
    """A ``record_function`` range when a torch profiler is recording,
    else None (the range would cost a dispatcher call per span for a
    profile nobody takes)."""
    if not torch._C._autograd._profiler_enabled():
        return None
    return torch.profiler.record_function(name)


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Programmatic switch — env-backed (writes ``OTPU_OBS``) so the
    fit-entry re-resolve (``refreshed_enabled``) cannot silently unwind
    an explicit override at the next fit."""
    global _enabled
    os.environ["OTPU_OBS"] = "1" if on else "0"
    _enabled = bool(on)


def refresh() -> None:
    """Re-read ``OTPU_OBS`` (tests and the bench A/B flip it mid-process)."""
    global _enabled
    _enabled = knobs.get_bool("OTPU_OBS")


def refreshed_enabled() -> bool:
    """Re-resolve the knob, then report it — the fit-entry/activation
    chokepoints use this so a mid-process env flip takes effect at the
    next run (the OTPU_DONATE/OTPU_SPARSE_UPDATE convention), while the
    per-span hot path keeps reading the cached flag lock-free. A
    ``set_enabled``/``force_disabled`` override is env-backed too (the
    bench A/B uses force_disabled around whole probe arms), so the
    re-read cannot unwind an active override mid-arm: spans and entry
    points flip together."""
    refresh()
    return _enabled


@contextlib.contextmanager
def _force(value: str):
    """Env-backed temporary override — so the fit-entry re-resolve
    (``refreshed_enabled``) agrees with the cached flag instead of
    silently unwinding the override mid-window."""
    prev = os.environ.get("OTPU_OBS")
    os.environ["OTPU_OBS"] = value
    refresh()
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("OTPU_OBS", None)
        else:
            os.environ["OTPU_OBS"] = prev
        refresh()


def force_disabled():
    """Temporarily no-op spans (the bench A/B's OTPU_OBS=0 arm)."""
    return _force("0")


def force_enabled():
    """Temporarily force spans ON (the bench A/B's obs-on arm must
    measure real instrumentation even when the ambient env carries
    OTPU_OBS=0 — a no-op-vs-no-op comparison would bank a vacuous
    overhead claim)."""
    return _force("1")


def _record(ph: str, name: str, t0_ns: int, dur_ns: int, args, *,
            trace_id=None, span_id=None, parent_id=None,
            buffer=None) -> None:
    ev = (ph, name, t0_ns, dur_ns, threading.get_ident(),
          args or None, trace_id, span_id, parent_id)
    if buffer is not None:
        # tail-retention (obs/context.py): an unsampled trace buffers its
        # events on the context; they reach the ring only if the request
        # turns out slow/shed/erroring — a plain append, still lock-free
        buffer.append(ev)
        return
    # single slot store — atomic under the GIL, no lock
    _ring[next(_seq) % _cap] = ev


def flush_buffered(evs: list) -> None:
    """Move a retained trace's buffered events into the ring (called by
    the obs.context scope exit — events carry their own thread idents)."""
    for ev in evs:
        _ring[next(_seq) % _cap] = ev


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


_TLS = threading.local()

# thread ident -> that thread's open-span stack. The stack object itself
# is only ever mutated by its owning thread (append/pop, GIL-atomic); the
# dict is written once per thread under the lock and read by the flight
# recorder, which copies each stack before walking it.
_OPEN: dict[int, list] = {}
_OPEN_LOCK = threading.Lock()


def _prune_dead_stacks_locked() -> None:
    """Drop _OPEN entries whose thread no longer exists (caller holds
    _OPEN_LOCK). sys._current_frames() is the ground truth for 'has a
    frame right now' — an abandoned-but-alive dispatch waiter stays, a
    finished pool thread goes, along with any span it never exited."""
    import sys

    live = set(sys._current_frames())
    for ident in [i for i in _OPEN if i not in live]:
        del _OPEN[ident]


def _open_stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
        with _OPEN_LOCK:
            if len(_OPEN) >= 64:    # short-lived-thread churn (serving
                #                     pools): don't grow without bound
                _prune_dead_stacks_locked()
            _OPEN[threading.get_ident()] = st
    return st


class _Span:
    __slots__ = ("name", "args", "t0", "ann", "uniq",
                 "trace_id", "span_id", "parent_id", "_buf")

    def __init__(self, name: str, args: dict | None, uniq: bool = False):
        self.name = name
        self.args = args
        self.ann = None
        self.uniq = uniq
        self.t0 = None
        self.trace_id = None
        self.span_id = None
        self.parent_id = None
        self._buf = None

    def __enter__(self):
        if self.uniq:
            open_names = getattr(_TLS, "open", None)
            if open_names is None:
                open_names = _TLS.open = set()
            open_names.add(self.name)
        ctx = _context.current_trace()
        if ctx is not None:
            self.trace_id = ctx.trace_id
            self._buf = ctx.buffer
        st = _open_stack()
        self.parent_id = st[-1].span_id if st else None
        self.span_id = next(_span_ids)
        st.append(self)
        ann = _profiler_range(self.name)
        if ann is not None:
            ann.__enter__()
            self.ann = ann
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t0 = self.t0
        _record("X", self.name, t0, time.perf_counter_ns() - t0, self.args,
                trace_id=self.trace_id, span_id=self.span_id,
                parent_id=self.parent_id, buffer=self._buf)
        st = getattr(_TLS, "stack", None)
        if st:
            if st[-1] is self:
                st.pop()
            else:  # mis-nested exit (generator-driven spans): best effort
                try:
                    st.remove(self)
                except ValueError:
                    pass
        if self.ann is not None:
            self.ann.__exit__(*exc)
        if self.uniq:
            _TLS.open.discard(self.name)
        return False


def span(name: str, index=None, unique: bool = False, **args):
    """Context manager timing one named region; ``index`` is shorthand for
    the ``i=`` arg (``span("epoch", 3)``). No-op (shared instance, zero
    allocation) when obs is disabled. ``unique=True`` records only the
    OUTERMOST same-named span per thread — ``Estimator.fit`` brackets a
    streaming ``fit_stream`` that opens its own "fit" span, and a trace
    with fit ⊃ fit would double-count fit time for anyone aggregating by
    span name."""
    if not _enabled:
        return _NULL
    if unique and name in getattr(_TLS, "open", ()):
        return _NULL
    if index is not None:
        args["i"] = index
    return _Span(name, args or None, uniq=unique)


def span_iter(name: str, iterable: Iterable) -> Iterator:
    """Wrap each ITERATION of a for-loop body in a span — the one-line way
    to instrument an existing loop without re-indenting it::

        for epoch in span_iter("epoch", range(n)):   # body spans "epoch"

    The span covers the loop body (yield -> resume), indexed per pass."""
    if not _enabled:
        yield from iterable
        return
    for i, item in enumerate(iterable):
        sp = span(name, i)
        sp.__enter__()
        try:
            yield item
        finally:
            sp.__exit__(None, None, None)


def instant(name: str, **args) -> None:
    """Record a point event (retries, wedges, faults) on the timeline."""
    if not _enabled:
        return
    ctx = _context.current_trace()
    _record("i", name, time.perf_counter_ns(), 0, args or None,
            trace_id=(ctx.trace_id if ctx is not None else None),
            buffer=(ctx.buffer if ctx is not None else None))


def flow(ph: str, flow_id, name: str = "req") -> None:
    """Record a Chrome flow event: ``ph`` is ``'s'`` (start), ``'t'``
    (step) or ``'f'`` (end); same ``flow_id`` + ``name`` across the three
    draws one arrow in Perfetto. The micro-batcher uses the request's
    trace id as the flow id, linking each caller's submit to the merged
    flush and its device dispatch across threads. Flow events bypass the
    tail-retention buffer on purpose: the worker-side ``t``/``f`` hops
    record from a context-less thread straight into the ring, so a
    sampled-out caller buffering its ``s`` would leave dangling
    steps/ends in every export."""
    if not _enabled:
        return
    if ph not in ("s", "t", "f"):
        raise ValueError(f"flow phase must be 's'/'t'/'f', got {ph!r}")
    ctx = _context.current_trace()
    _record(ph, name, time.perf_counter_ns(), 0, {"id": str(flow_id)},
            trace_id=(ctx.trace_id if ctx is not None else None))


def traced(name: str, **fixed_args):
    """Decorator form: the call body becomes one ``name`` span (unique
    per thread — a re-entrant/bracketed call records only the outermost,
    see ``span(unique=)``) AND a trace-context chokepoint: a fit entry
    mints the run id every span under it carries (an already-active
    context — the ``Estimator.fit`` bracket — is reused, never shadowed)."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            # fit entries are the chokepoint where a mid-process
            # OTPU_OBS flip takes effect (the kill-switch convention)
            if not refreshed_enabled():
                return fn(*a, **kw)
            # the run id's kind is the span name ("fit-<pid>-<n>" for
            # @traced("fit")) — a future @traced("score") mints an
            # honestly-labeled id, not a fake fit
            with _context.trace_scope(name, reuse=True):
                with span(name, unique=True, **fixed_args):
                    return fn(*a, **kw)

        return wrapper

    return deco


def events() -> list:
    """Recorded events, oldest first (chronological even after ring wrap)."""
    evs = [e for e in list(_ring) if e is not None]
    evs.sort(key=lambda e: e[2])
    return evs


def open_spans() -> list[dict]:
    """Currently-OPEN spans across every thread — the flight recorder's
    "what was each thread inside when the anomaly fired" view (a wedged
    dispatch's span is open at dump time: it only reaches the ring when
    the raise unwinds it). Best-effort snapshot: each stack is copied
    before walking, so a concurrent push/pop can cost one entry, never a
    torn read."""
    now = time.perf_counter_ns()
    with _OPEN_LOCK:
        _prune_dead_stacks_locked()   # a dead thread's abandoned spans
        #                               must not pollute post-mortems
        stacks = [(ident, list(st)) for ident, st in _OPEN.items()]
    out = []
    for ident, st in stacks:
        for sp in st:
            t0 = sp.t0
            if t0 is None:
                continue
            out.append({
                "thread": ident, "name": sp.name,
                "args": dict(sp.args) if sp.args else None,
                "trace_id": sp.trace_id, "span_id": sp.span_id,
                "parent_id": sp.parent_id,
                "age_ms": round((now - t0) / 1e6, 3), "open": True,
            })
    return out


def spans_payload(trace_id: str | None = None,
                  limit: int = 4096) -> dict:
    """JSON-able view of this PROCESS's ring (optionally filtered to one
    trace id) for cross-process trace assembly (obs/fleetobs.py): the
    fleet ``GET /debug/spans?trace_id=`` body. Ring tuples are process-
    local ``perf_counter_ns`` values, so the payload carries a
    wall/perf **clock anchor** sampled at build time — the assembler
    rebases every timestamp as ``wall_ns + (t_ns - perf_ns)``, putting
    router- and replica-side spans on one shared wall-clock axis."""
    evs = events()
    if trace_id is not None:
        evs = [e for e in evs if e[6] == trace_id]
    opened = open_spans()
    if trace_id is not None:
        opened = [s for s in opened if s["trace_id"] == trace_id]
    return {
        "pid": os.getpid(),
        "anchor": {"wall_ns": time.time_ns(),
                   "perf_ns": time.perf_counter_ns()},
        "events": [[ph, name, t0, dur, ident,
                    dict(args) if args else None, tid, sid, pid_]
                   for (ph, name, t0, dur, ident, args, tid, sid, pid_)
                   in evs[-max(limit, 0):]],
        "open_spans": opened,
    }


def clear() -> None:
    """Drop every recorded event (benches/tests bracket with this)."""
    global _ring, _seq
    _ring = [None] * _cap
    _seq = itertools.count()


_MAX_TREE_CHILDREN = 16


def slowest_traces(k: int = 5, since_ns: int | None = None) -> list[dict]:
    """Top-``k`` slowest traces currently in the ring, as span trees —
    the report hook that links a run report straight into the trace ring.
    A trace's duration is its longest ROOT span (the serve/fit bracket);
    ``since_ns`` (a ``perf_counter_ns`` value) restricts to events after
    a run's start. Children are capped at 16 per node (``truncated``
    marks the cut) so a many-chunk fit report stays readable."""
    by_trace: dict = {}
    for ev in events():
        if ev[0] != "X" or ev[6] is None:
            continue
        if since_ns is not None and ev[2] < since_ns:
            continue
        by_trace.setdefault(ev[6], []).append(ev)
    ranked = []
    for trace_id, evs in by_trace.items():
        recorded = {e[7] for e in evs}
        # roots = spans whose parent never reached the ring: true roots
        # (parent None) AND orphans whose parent span is still OPEN — a
        # report frozen mid-fit sees the epochs under a not-yet-closed
        # fit span, and they must all anchor the tree, not just one
        roots = [e for e in evs if e[8] is None or e[8] not in recorded]
        anchor = max(roots or evs, key=lambda e: e[3])
        ranked.append((anchor[3], trace_id, anchor, roots or [anchor], evs))
    ranked.sort(key=lambda r: (-r[0], r[1]))

    def node(e, children_by_parent):
        kids = sorted(children_by_parent.get(e[7], ()), key=lambda c: c[2])
        out = {
            "name": e[1], "dur_ms": round(e[3] / 1e6, 3),
            "args": dict(e[5]) if e[5] else None,
            "children": [node(c, children_by_parent)
                         for c in kids[:_MAX_TREE_CHILDREN]],
        }
        if len(kids) > _MAX_TREE_CHILDREN:
            out["truncated"] = len(kids) - _MAX_TREE_CHILDREN
        return out

    out = []
    for dur_ns, trace_id, anchor, roots, evs in ranked[:max(k, 0)]:
        children_by_parent: dict = {}
        for e in evs:
            children_by_parent.setdefault(e[8], []).append(e)
        roots = sorted(roots, key=lambda e: e[2])
        if len(roots) == 1:
            tree = node(roots[0], children_by_parent)
        else:                       # multi-root: synthesized container
            tree = {
                "name": "(trace)", "dur_ms": round(dur_ns / 1e6, 3),
                "args": None,
                "children": [node(r, children_by_parent)
                             for r in roots[:_MAX_TREE_CHILDREN]],
            }
            if len(roots) > _MAX_TREE_CHILDREN:
                tree["truncated"] = len(roots) - _MAX_TREE_CHILDREN
        out.append({
            "trace_id": trace_id, "span": anchor[1],
            "dur_ms": round(dur_ns / 1e6, 3), "n_spans": len(evs),
            "tree": tree,
        })
    return out


def export_chrome_trace(path: str | None = None) -> dict:
    """Chrome trace-event JSON of every recorded event. Loads in Perfetto
    / ``chrome://tracing``; ``ts``/``dur`` are microseconds on the
    process-local ``perf_counter`` clock; trace/span/parent ids ride the
    ``args`` pane; flow events carry their required top-level ``id``.
    Writes to ``path`` when given; returns the trace object either way."""
    pid = os.getpid()
    tid_map: dict[int, int] = {}
    trace_events: list[dict] = []
    for ph, name, t_ns, dur_ns, ident, args, trace_id, span_id, parent_id \
            in events():
        tid = tid_map.setdefault(ident, len(tid_map))
        ev: dict = {
            "name": name, "ph": ph, "cat": "otpu",
            "pid": pid, "tid": tid, "ts": t_ns / 1e3,
        }
        a = dict(args) if args else {}
        if ph == "X":
            ev["dur"] = dur_ns / 1e3
        elif ph == "i":
            ev["s"] = "t"
        elif ph in ("s", "t", "f"):
            # the flow-event contract: matching (cat, name, id) triples
            # draw one arrow; bind to the enclosing slice
            ev["id"] = str(a.pop("id", ""))
            ev["bp"] = "e"
        if trace_id is not None:
            a["trace_id"] = trace_id
            if span_id is not None:
                a["span_id"] = span_id
            if parent_id is not None:
                a["parent_id"] = parent_id
        if a:
            ev["args"] = a
        trace_events.append(ev)
    # thread-name metadata rows make the Perfetto view self-describing
    for ident, tid in tid_map.items():
        trace_events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": f"thread-{ident}"},
        })
    out = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f)
    return out


def validate_chrome_trace(obj) -> list[dict]:
    """Raise ValueError unless ``obj`` (a dict or a JSON string) is valid
    Chrome trace-event JSON by the format's object-form rules; returns the
    event list. Used by tools/obs_dump.py and the trace tests."""
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise ValueError("not object-form Chrome trace JSON "
                         "(missing 'traceEvents' list)")
    for ev in obj["traceEvents"]:
        if not isinstance(ev, dict):
            raise ValueError(f"non-object trace event: {ev!r}")
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"trace event missing {field!r}: {ev!r}")
        if ev["ph"] in ("X", "B", "E", "i", "s", "t", "f") \
                and not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"trace event missing numeric ts: {ev!r}")
        if ev["ph"] == "X" and not isinstance(
                ev.get("dur"), (int, float)):
            raise ValueError(f"complete event missing dur: {ev!r}")
        if ev["ph"] in ("s", "t", "f") and not ev.get("id"):
            raise ValueError(f"flow event missing id: {ev!r}")
    return obj["traceEvents"]
