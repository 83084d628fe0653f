"""Dispatch watchdog — typed errors instead of infinite hangs.

A copy of the JAX package's ``resilience/watchdog.py``. A device sync that
never returns (a wedged device or driver) would hang the whole process.
Python cannot interrupt a blocked C call, so the watchdog inverts the wait:
the sync runs on a daemon monitor thread while the calling thread waits on
it with a budget (``OTPU_DISPATCH_BUDGET_S``). On exhaustion the caller
raises a typed ``DispatchWedgedError`` carrying the last-good-progress
counters (``utils.profiling`` exec counters, the liveness beat's age) and
can act: fall back, resume from a checkpoint, or exit cleanly; the
abandoned waiter parks in the runtime. The budget is off by default (0: a
long first build must never be misread as a wedge) and inert under the
``OTPU_RESILIENCE=0`` kill-switch.

The sync: on CUDA, the monitor thread records an event on the token's
stream after the work and waits for it (``torch.cuda.Event.synchronize``,
which leaves the GIL free); on the CPU, where work finishes before the call
returns, there is nothing to wait for. ``utils.dispatch.bound_dispatch``
routes every step loop's periodic sync through ``maybe_guarded_block``. The
``wedge`` fault kind (resilience/faults.py) injects the never-returning
sync here: the monitor thread holds for ``hold_s`` before syncing, so the
budget really races it; without a budget the hold is a finite stall. The
JAX package's flight-recorder dump on a wedge is not ported.
"""

from __future__ import annotations

import threading
import time

import torch

from orange3_spark_tpu_torch.resilience.faults import active_fault_spec, resilience_enabled

__all__ = [
    "DispatchWedgedError",
    "dispatch_budget_s",
    "guarded_block_until_ready",
    "maybe_guarded_block",
]


class DispatchWedgedError(RuntimeError):
    """A device sync exceeded its budget. ``stage``/``step`` locate the
    wedge, ``budget_s``/``waited_s`` quantify it, ``diagnostics`` holds the
    last-good-progress counters (dispatches issued, chunks prefetched,
    seconds since the last liveness beat)."""

    def __init__(self, *, stage: str, step: int | None, budget_s: float,
                 waited_s: float, diagnostics: dict, trace_id: str | None = None):
        self.stage = stage
        self.step = step
        self.budget_s = budget_s
        self.waited_s = waited_s
        self.diagnostics = diagnostics
        self.trace_id = trace_id
        at = f" at step {step}" if step is not None else ""
        if trace_id:
            at += f" [trace {trace_id}]"
        super().__init__(
            f"device dispatch wedged: {stage}{at} exceeded its "
            f"{budget_s:.3g}s budget (waited {waited_s:.3g}s; last "
            f"liveness beat {diagnostics.get('last_beat_age_s', '?')}s "
            f"ago, {diagnostics.get('dispatches', '?')} dispatches / "
            f"{diagnostics.get('prefetch_items', '?')} chunks completed "
            "before the wedge). The process is still alive — fall back, "
            "resume from the last checkpoint, or set "
            "OTPU_DISPATCH_BUDGET_S=0 to restore unbounded waits."
        )


def dispatch_budget_s() -> float:
    """Seconds a guarded sync may block (0 = watchdog off). Env
    ``OTPU_DISPATCH_BUDGET_S`` (utils/knobs.py); 0 under the kill-switch."""
    if not resilience_enabled():
        return 0.0
    from orange3_spark_tpu_torch.utils import knobs

    return float(knobs.get_float("OTPU_DISPATCH_BUDGET_S"))


def _diagnostics() -> dict:
    from orange3_spark_tpu_torch.utils.dispatch import last_beat
    from orange3_spark_tpu_torch.utils.profiling import exec_counters

    c = exec_counters()
    return {
        "last_beat_age_s": round(time.monotonic() - last_beat(), 3),
        "dispatches": c["dispatches"],
        "prefetch_items": c["prefetch_items"],
        "prefetch_prep_s": round(c["prefetch_prep_s"], 3),
        "prefetch_wait_s": round(c["prefetch_wait_s"], 3),
    }


def _done_marker(token):
    """What the monitor thread waits on for ``token``: an event recorded on
    the current stream after the work that produced it (CUDA), or None (the
    CPU: the work is done when the call returns)."""
    if isinstance(token, torch.Tensor) and token.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(token.device))
        return ev
    return None


def _wait(marker) -> None:
    if marker is not None:
        marker.synchronize()


def guarded_block_until_ready(token, *, step: int | None = None, stage: str = "step"):
    """Wait for the device work behind ``token`` (a tensor), bounded by the
    watchdog budget. The wait runs on a daemon monitor thread; this thread
    waits up to the budget and raises ``DispatchWedgedError`` on
    exhaustion. A waiter-side exception re-raises here; an injected
    ``wedge`` hold runs on the waiter, so the budget races it."""
    spec = active_fault_spec()
    hold = spec.take_wedge() if spec is not None else None
    budget = dispatch_budget_s()
    marker = _done_marker(token)
    if budget <= 0:
        # unbounded wait; an injected wedge degrades to a finite stall
        if hold is not None:
            time.sleep(hold)
        _wait(marker)
        return token
    # circuit breaker on repeated wedges (resilience/overload.py): once a
    # budgeted sync has wedged, later guarded syncs fail fast, typed, until
    # the breaker's cooldown admits a half-open probe sync
    from orange3_spark_tpu_torch.obs.context import current_trace_id, flag_current_trace
    from orange3_spark_tpu_torch.resilience.overload import wedge_breaker

    breaker = wedge_breaker()
    if not breaker.allow():
        diag = _diagnostics()
        diag["breaker_state"] = breaker.state()
        flag_current_trace()
        raise DispatchWedgedError(stage=stage, step=step, budget_s=budget, waited_s=0.0,
                                  diagnostics=diag, trace_id=current_trace_id())
    done = threading.Event()
    err: list = []

    def waiter():
        try:
            if hold is not None:
                time.sleep(hold)
            _wait(marker)
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller
            err.append(e)
        finally:
            done.set()

    t0 = time.perf_counter()
    threading.Thread(target=waiter, daemon=True, name="otpu-dispatch-waiter").start()
    if not done.wait(budget):
        from orange3_spark_tpu_torch.utils.profiling import record_wedge

        record_wedge()
        breaker.record_failure()
        flag_current_trace()
        # a distinct name: `err` is the waiter's result list
        raise DispatchWedgedError(
            stage=stage, step=step, budget_s=budget, waited_s=time.perf_counter() - t0,
            diagnostics=_diagnostics(), trace_id=current_trace_id())
    if err:
        raise err[0]
    breaker.record_success()
    return token


def maybe_guarded_block(token, *, step: int | None = None, stage: str = "step"):
    """The ``bound_dispatch`` hook: a plain wait when no budget and no
    fault spec are active, the guarded path otherwise."""
    if active_fault_spec() is None and dispatch_budget_s() <= 0:
        _wait(_done_marker(token))
        return token
    return guarded_block_until_ready(token, step=step, stage=stage)
