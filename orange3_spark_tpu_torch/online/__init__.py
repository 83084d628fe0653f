"""online/ — the serving tap of train-while-serve.

Only ``tap`` is ported (``serve/context.py`` calls ``maybe_tap_request``
on every array request): the request log, the incremental trainer, the
drift and shadow gates and the control loop are not.
"""

from orange3_spark_tpu_torch.online.tap import (  # noqa: F401
    OnlineTap,
    active_tap,
    maybe_tap_request,
    online_enabled,
    tap_scope,
)
