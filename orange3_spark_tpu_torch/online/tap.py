"""Serving tap — mirrors live request traffic into the online log.

One module-global active tap (installed by the
:class:`~orange3_spark_tpu_torch.online.loop.OnlineLoop`, or directly in
tests). The serving call sites stay one ``is None`` check when no tap is
installed, and the whole module is inert under ``OTPU_ONLINE=0`` — the
kill-switch restores the pre-online serving path bitwise.

Two call sites, deduplicated by a thread-local depth counter:

* ``fleet/replica.py`` wraps its model call in :func:`tap_scope` — the
  request is logged once at the replica boundary, and the inner
  serving-context tap (below) sees the scope and skips;
* ``serve/context.py served_array`` calls :func:`maybe_tap_request` —
  the single-process path, where no replica boundary exists.

Labels arrive later, from the caller's feedback path, via
``OnlineTap.tap_label(req_id, y)``.

The ``drift:shift=S,after=K`` injector (resilience/faults.py) lands
HERE: after K tapped chunks the logged features are shifted by S — the
deterministic stand-in for live traffic drifting away from the serving
model's training distribution, which the promotion drift gate must
catch before any replica flips.
"""

from __future__ import annotations

import threading

import numpy as np

from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

__all__ = ["OnlineTap", "active_tap", "maybe_tap_request", "tap_scope"]

_M_TAPPED = REGISTRY.counter(
    "otpu_online_tapped_total",
    "request chunks mirrored into the online request log by the "
    "serving tap")

_ACTIVE: "OnlineTap | None" = None
_TLS = threading.local()


def online_enabled() -> bool:
    """THE kill-switch (read per call, the ``OTPU_DONATE`` convention):
    ``OTPU_ONLINE=0`` = no tap, no trainer, no promotion loop."""
    return knobs.get_bool("OTPU_ONLINE")


class OnlineTap:
    """Mirrors request chunks (and their later labels) into a
    :class:`~orange3_spark_tpu_torch.io.reqlog.RequestLog`."""

    def __init__(self, log):
        self.log = log
        self._chunks_seen = 0
        self._last_req_id: int | None = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ requests
    def tap_request(self, X: np.ndarray) -> int | None:
        if not online_enabled():
            return None
        X = np.asarray(X, np.float32)
        with self._lock:
            ordinal = self._chunks_seen
            self._chunks_seen += 1
        from orange3_spark_tpu_torch.resilience.faults import active_fault_spec

        spec = active_fault_spec()
        if spec is not None:
            shift = spec.take_drift_shift(ordinal)
            if shift is not None:
                X = X + np.float32(shift)
        req_id = self.log.append_request(X)
        with self._lock:
            self._last_req_id = req_id
        _M_TAPPED.inc()
        return req_id

    def tap_label(self, req_id: int, y: np.ndarray) -> None:
        if not online_enabled():
            return
        self.log.append_label(req_id, np.asarray(y, np.float32))

    def last_request_id(self) -> int | None:
        with self._lock:
            return self._last_req_id

    # ----------------------------------------------------------- install
    def install(self) -> "OnlineTap":
        global _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None


def active_tap() -> OnlineTap | None:
    return _ACTIVE


def maybe_tap_request(X) -> None:
    """The serving-context hook: one global read when no tap is
    installed; skipped inside an enclosing :func:`tap_scope` (the
    replica already logged this request)."""
    tap = _ACTIVE
    if tap is None or getattr(_TLS, "depth", 0) > 0:
        return
    tap.tap_request(X)


class tap_scope:
    """Replica-boundary tap: logs ``X`` once on enter and suppresses the
    inner serving-context tap for the duration (the model call beneath
    routes through ``served_array``, which would double-log)."""

    def __init__(self, X):
        self.X = X

    def __enter__(self):
        tap = _ACTIVE
        if tap is not None:
            tap.tap_request(self.X)
        _TLS.depth = getattr(_TLS, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _TLS.depth = getattr(_TLS, "depth", 1) - 1
        return False
