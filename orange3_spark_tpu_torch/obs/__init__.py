"""Observability of the port: copies of the JAX package's host-side layers.

* ``registry`` — typed thread-safe metrics (counters, gauges, histograms,
  labels, JSON snapshot, Prometheus text exposition);
* ``trace``    — low-overhead structured spans (lock-free ring buffer,
  trace/span/parent ids, Chrome trace-event export), lined up with the
  ``torch.profiler`` timeline while a profiler records;
* ``context``  — per-request trace ids minted at the serving entry;
* ``report``   — per-run structured reports (``ServingContext.report()``).

Not ported yet: the flight recorder, the telemetry endpoint, the fleet
telemetry plane and the goodput/memory plane (``flight``, ``server``,
``fleetobs``, ``prof``).
"""

from orange3_spark_tpu_torch.obs.registry import (  # noqa: F401
    REGISTRY, Counter, Gauge, Histogram, MetricsRegistry, get_registry,
)
from orange3_spark_tpu_torch.obs.report import RunReport  # noqa: F401
