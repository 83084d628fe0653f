"""resilience/ — fault injection, bounded retries and overload protection.

Copies of the JAX package's ``faults``, ``retry`` and ``overload``
modules, which the serving path stands on (``serve/cache.py`` retries a
failed build; ``serve/context.py`` admits, sheds and opens breakers).
``OTPU_RESILIENCE=0`` restores fail-fast behaviour, as there. Not ported
yet: the dispatch watchdog, the numerics guard and the fit checkpointer.
"""

from __future__ import annotations

from orange3_spark_tpu_torch.resilience.faults import (
    FaultSpec,
    TransientBuildError,
    TransientSourceError,
    active_fault_spec,
    inject_faults,
    resilience_enabled,
)
from orange3_spark_tpu_torch.resilience.overload import (
    AdaptiveCoalescer,
    AdmissionController,
    CircuitBreaker,
    OverloadShedError,
    request_deadline,
)
from orange3_spark_tpu_torch.resilience.retry import (
    RetryPolicy,
    is_transient,
    resilient_source,
    retry_call,
)

__all__ = [
    "AdaptiveCoalescer",
    "AdmissionController",
    "CircuitBreaker",
    "FaultSpec",
    "OverloadShedError",
    "RetryPolicy",
    "TransientBuildError",
    "TransientSourceError",
    "active_fault_spec",
    "inject_faults",
    "is_transient",
    "request_deadline",
    "resilience_enabled",
    "resilient_source",
    "retry_call",
]
