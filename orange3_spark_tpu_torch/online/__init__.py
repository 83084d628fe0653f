"""Continuous train-while-serve: guarded online learning.

The subsystem behind ``OTPU_ONLINE`` (kill-switch: ``OTPU_ONLINE=0``
makes every hook inert — the pre-online serving path, bitwise):

* :mod:`orange3_spark_tpu_torch.io.reqlog` — the OTPURQL1 request/label log
  and the bounded-window label joiner;
* :mod:`.tap` — the serving-side tap that feeds the log;
* :mod:`.trainer` — the background incremental trainer over a standby
  model copy, checkpointed for SIGKILL-resume;
* :mod:`.drift` / :mod:`.shadow` — the two pre-roll promotion gates;
* :mod:`.loop` — the control plane composing all of it with
  quarantine-on-rejection.
"""

from orange3_spark_tpu_torch.online.drift import (  # noqa: F401
    DriftDetectedError,
    DriftDetector,
    feature_stats,
)
from orange3_spark_tpu_torch.online.loop import OnlineLoop  # noqa: F401
from orange3_spark_tpu_torch.online.shadow import (  # noqa: F401
    ShadowMismatchError,
    ShadowScorer,
)
from orange3_spark_tpu_torch.online.tap import (  # noqa: F401
    OnlineTap,
    active_tap,
    maybe_tap_request,
    online_enabled,
    tap_scope,
)
from orange3_spark_tpu_torch.online.trainer import (  # noqa: F401
    IncrementalTrainer,
    OnlineTrainerError,
    TrainerCrashInjected,
)

__all__ = [
    "DriftDetectedError",
    "DriftDetector",
    "IncrementalTrainer",
    "OnlineLoop",
    "OnlineTap",
    "OnlineTrainerError",
    "ShadowMismatchError",
    "ShadowScorer",
    "TrainerCrashInjected",
    "active_tap",
    "feature_stats",
    "maybe_tap_request",
    "online_enabled",
    "tap_scope",
]
