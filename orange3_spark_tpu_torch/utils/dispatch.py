"""Dispatch-queue bounding for step loops, and the liveness heartbeat.

A copy of the JAX package's ``utils/dispatch.py``. PyTorch's CUDA calls
return before the device finishes, so a loop that enqueues one step per
chunk can run far ahead of the card. Every sequential step loop calls
``bound_dispatch`` once per dispatched step (or captured-graph replay):
one wait per ``period`` dispatches caps the queue, and that wait is the
one place a loop can block forever on a wedged device, so it goes through
the resilience watchdog (resilience/watchdog.py ``maybe_guarded_block``).
Its seconds feed the live fit's goodput accountant as device compute
(``obs/prof.note_sync``): the host sees the device's pace only there.
"""

from __future__ import annotations

import time

from orange3_spark_tpu_torch.utils.profiling import count_dispatch

#: steps between waits; small enough to cap the queue, large enough that
#: the wait costs nothing against real step times
DISPATCH_SYNC_PERIOD = 16

#: liveness heartbeat — every step loop, prefetch worker and serving call
#: ticks it
_last_beat = time.monotonic()


def beat() -> None:
    """Record forward progress (a dispatch, a parsed chunk, a flush)."""
    global _last_beat
    _last_beat = time.monotonic()


def last_beat() -> float:
    """Monotonic timestamp of the most recent progress tick."""
    return _last_beat


def bound_dispatch(step: int, token, period: int = DISPATCH_SYNC_PERIOD) -> None:
    """Beat, count the dispatch (``utils.profiling.count_dispatch``), and
    on every ``period``-th ``step`` (1-based) wait for ``token`` (a tensor
    the step produced) under a ``dispatch`` span, through the watchdog:
    with ``OTPU_DISPATCH_BUDGET_S`` set, a wait past the budget raises a
    typed ``DispatchWedgedError`` instead of hanging the process."""
    beat()
    count_dispatch()
    if step % period == 0:
        from orange3_spark_tpu_torch.obs.prof import note_sync
        from orange3_spark_tpu_torch.obs.trace import span
        from orange3_spark_tpu_torch.resilience.watchdog import maybe_guarded_block

        # the one place a step loop blocks on the device: a "dispatch"
        # span puts the wait on the timeline, and the same blocked seconds
        # feed the goodput accountant as device_compute (a bare contextvar
        # read when no fit is live)
        with span("dispatch", step):
            t0 = time.perf_counter()
            maybe_guarded_block(token, step=step)
            note_sync(time.perf_counter() - t0)
        beat()
