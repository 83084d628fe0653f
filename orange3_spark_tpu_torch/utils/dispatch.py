"""Liveness heartbeat and dispatch count of the serving path.

A copy of the JAX package's ``utils/dispatch.py`` without its guarded
periodic sync: ``bound_dispatch`` there routes every 16th step through the
resilience watchdog (``resilience/watchdog.py``) and the goodput
accountant (``obs/prof.note_sync``), neither of which this package has
ported yet. What serving needs is here: ``beat`` (serving progress, the
heartbeat a liveness probe reads); the process-wide dispatch count is
``utils.profiling.count_dispatch``.
"""

from __future__ import annotations

import time

#: liveness heartbeat — every serving call and micro-batch flush ticks it
_last_beat = time.monotonic()


def beat() -> None:
    """Record forward progress (a dispatch, a parsed chunk, a flush)."""
    global _last_beat
    _last_beat = time.monotonic()


def last_beat() -> float:
    """Monotonic timestamp of the most recent progress tick."""
    return _last_beat
