"""Observability of the port: copies of the JAX package's host-side layers.

One kill-switch (``OTPU_OBS=0``) for spans and the endpoint:

* ``registry`` — typed thread-safe metrics (counters, gauges, histograms,
  labels, JSON snapshot, Prometheus text exposition);
* ``trace``    — low-overhead structured spans (lock-free ring buffer,
  trace/span/parent ids, Chrome trace-event export), lined up with the
  ``torch.profiler`` timeline while a profiler records;
* ``context``  — per-request trace ids minted at the serving entry, per-fit
  run ids at fit entry;
* ``flight``   — the anomaly flight recorder: a rate-limited JSON bundle
  (spans, breakers, queue depths, the device-memory ledger, knobs, every
  thread's stack) written at the typed-anomaly raise sites
  (``OTPU_FLIGHT=0`` disables);
* ``report``   — per-run structured reports (``model.run_report_``,
  ``ServingContext.report()``);
* ``server``   — the opt-in stdlib ``/metrics`` + ``/healthz`` +
  ``/readyz`` + ``/debug/*`` endpoint of a serving process
  (``OTPU_OBS_PORT``), never bound under the kill-switch;
* ``prof``     — the goodput & memory plane (its own kill-switch,
  ``OTPU_PROF``): the five-way wall decomposition of a fit with per-epoch
  bottlenecks, the named device-memory ledger reconciled against the CUDA
  caching allocator, and on-demand ``torch.profiler`` capture
  (``POST /debug/profile``).

Not ported yet: the fleet telemetry plane (``fleetobs``), with the fleet.
"""

from orange3_spark_tpu_torch.obs.registry import (  # noqa: F401
    REGISTRY, Counter, Gauge, Histogram, MetricsRegistry, get_registry,
)
from orange3_spark_tpu_torch.obs.report import RunReport  # noqa: F401
from orange3_spark_tpu_torch.obs.server import (  # noqa: F401
    TelemetryServer, maybe_start_from_env,
)
from orange3_spark_tpu_torch.obs.trace import (  # noqa: F401
    export_chrome_trace, instant, span, span_iter, validate_chrome_trace,
)
from orange3_spark_tpu_torch.obs import context, flight, trace  # noqa: F401
from orange3_spark_tpu_torch.obs.context import (  # noqa: F401
    current_trace_id, trace_scope,
)


def obs_enabled() -> bool:
    """The master switch (``OTPU_OBS``): spans/endpoint on or off. The
    registry and the counter shims stay live either way."""
    return trace.enabled()
