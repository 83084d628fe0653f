"""serve/ — the bucketed inference path, on captured CUDA graphs.

Public surface::

    from orange3_spark_tpu_torch.serve import ServingContext, BucketLadder

    ctx = ServingContext(BucketLadder(min_bucket=256, max_bucket=1 << 14),
                         micro_batch=True)
    with ctx:
        ctx.warmup(model, n_cols=39)     # capture the ladder ahead of traffic
        model.predict(batch)             # bucketed + cached + coalesced

Counters: ``orange3_spark_tpu_torch.utils.profiling.serve_counters()``.
``ServedWorkflow`` serves a fitted workflow DAG as one model.
"""

from orange3_spark_tpu_torch.serve.bucketing import BucketLadder
from orange3_spark_tpu_torch.serve.cache import ExecutableCache
from orange3_spark_tpu_torch.serve.context import (
    ServingContext, active_serving_context,
)
from orange3_spark_tpu_torch.serve.workflow import ServedWorkflow

__all__ = [
    "BucketLadder",
    "ExecutableCache",
    "ServedWorkflow",
    "ServingContext",
    "active_serving_context",
]
