"""resilience/ — fault injection, bounded retries and overload protection.

Copies of the JAX package's ``faults``, ``retry``, ``overload``,
``numerics`` and ``watchdog`` modules. The serving path stands on the
first three (``serve/cache.py`` retries a failed build;
``serve/context.py`` admits, sheds and opens breakers); the streaming fit
on all five (``resilient_source`` wraps its source, ``check_finite_training``
guards each epoch, the watchdog bounds its periodic sync). The fit's
checkpointer is ``utils/fault.StreamCheckpointer``. ``OTPU_RESILIENCE=0``
restores fail-fast behaviour, as there.
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
from orange3_spark_tpu_torch.resilience.numerics import (
    NumericalDivergenceError,
    check_finite_training,
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
from orange3_spark_tpu_torch.resilience.watchdog import (
    DispatchWedgedError,
    dispatch_budget_s,
)

__all__ = [
    "AdaptiveCoalescer",
    "AdmissionController",
    "CircuitBreaker",
    "DispatchWedgedError",
    "FaultSpec",
    "NumericalDivergenceError",
    "OverloadShedError",
    "RetryPolicy",
    "TransientBuildError",
    "TransientSourceError",
    "active_fault_spec",
    "check_finite_training",
    "dispatch_budget_s",
    "inject_faults",
    "is_transient",
    "request_deadline",
    "resilience_enabled",
    "resilient_source",
    "retry_call",
]
