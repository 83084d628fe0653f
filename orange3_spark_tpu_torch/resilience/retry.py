"""Retry policy: exponential backoff + jitter + max-attempts.

Two call shapes, both no-ops under the ``OTPU_RESILIENCE=0`` kill-switch:

* ``retry_call(fn, cause=...)`` — bounded retries of an idempotent
  callable (the serving ``ExecutableCache`` wraps its AOT builds in it).
* ``resilient_source(source)`` — wraps a re-iterable zero-arg chunk-source
  factory: every streaming fit routes its source through this ONE
  chokepoint at fit entry, so transient read errors (NFS blip, injected
  ``source_io`` fault) are absorbed by re-opening the source and
  fast-forwarding to the failed chunk instead of killing a 100-epoch fit.
  Sources are re-iterable by the streaming contract (epochs restart them),
  which is exactly what makes the re-open + skip recovery sound — the
  replayed prefix is bit-identical, so a recovered fit matches the
  fault-free fit bitwise (pinned in tests/test_resilience.py).

Backoff: ``delay(i) = min(base * multiplier**i, max) * (1 + jitter * u)``
with ``u`` a deterministic per-(seed, i) uniform — seeded jitter keeps the
schedule test-pinnable while still decorrelating real fleet retries.
Every retry ticks a per-cause counter in
``utils.profiling.resilience_counters()`` and, when a ``PipelineStats`` is
threaded in, ``stats.retries`` — the bench's ``retries`` field.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, Iterator

from orange3_spark_tpu_torch.resilience.faults import (
    active_fault_spec,
    resilience_enabled,
)

__all__ = [
    "RetryPolicy",
    "is_transient",
    "resilient_source",
    "retry_call",
]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule knobs (env twins: OTPU_RETRY_*)."""

    max_attempts: int = 4        # total tries (1 first + 3 retries)
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25         # + up to this fraction of the delay
    seed: int = 0                # deterministic jitter stream

    @classmethod
    def from_env(cls, **overrides) -> "RetryPolicy":
        from orange3_spark_tpu_torch.utils import knobs

        kw = dict(
            max_attempts=knobs.get_int("OTPU_RETRY_ATTEMPTS"),
            base_delay_s=knobs.get_float("OTPU_RETRY_BASE_S"),
            max_delay_s=knobs.get_float("OTPU_RETRY_MAX_S"),
            multiplier=knobs.get_float("OTPU_RETRY_MULTIPLIER"),
            jitter=knobs.get_float("OTPU_RETRY_JITTER"),
        )
        kw.update(overrides)
        return cls(**kw)

    def delay(self, retry_index: int) -> float:
        """Seconds to wait before retry ``retry_index`` (0-based)."""
        d = min(self.base_delay_s * self.multiplier ** retry_index,
                self.max_delay_s)
        if self.jitter > 0:
            u = zlib.crc32(
                f"{self.seed}:{retry_index}".encode()) / 0xFFFFFFFF
            d *= 1.0 + self.jitter * u
        return d


def is_transient(exc: BaseException) -> bool:
    """The retry classifier — deliberately conservative: OS-level I/O
    errors (which the injected ``TransientSourceError`` subclasses) and
    runtime errors carrying the grpc-style transient status words (a
    lost device tunnel surfaces as ``UNAVAILABLE``). Everything else —
    shape mismatches, bad labels, corruption, and the PERMANENT OSError
    family (a mistyped path will not appear on retry 3) — must fail
    fast."""
    if isinstance(exc, (FileNotFoundError, PermissionError,
                        IsADirectoryError, NotADirectoryError)):
        return False
    if isinstance(exc, OSError):
        return True
    from orange3_spark_tpu_torch.resilience.faults import TransientBuildError

    if isinstance(exc, TransientBuildError):
        return True
    msg = f"{type(exc).__name__}: {exc}"
    return "UNAVAILABLE" in msg or "DEADLINE_EXCEEDED" in msg


def _record(cause: str, wait_s: float, stats) -> None:
    from orange3_spark_tpu_torch.utils.profiling import record_retry

    record_retry(cause, wait_s)
    if stats is not None:
        stats.retries += 1


def retry_call(fn: Callable, *, cause: str, policy: RetryPolicy | None = None,
               sleep: Callable[[float], None] = time.sleep,
               classify: Callable = is_transient, stats=None):
    """``fn()`` with bounded transient-error retries. Fail-fast (one
    attempt, no classification) under the kill-switch."""
    if not resilience_enabled():
        return fn()
    policy = policy or RetryPolicy.from_env()
    retries = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - classified below
            if not classify(e) or retries + 1 >= policy.max_attempts:
                raise
            d = policy.delay(retries)
            _record(cause, d, stats)
            retries += 1
            sleep(d)


def _injected(source: Callable[[], Iterator]) -> Callable[[], Iterator]:
    """Wrap a source factory with the fault-injection layer (active
    regardless of the kill-switch — the tests inject through it)."""

    def opener():
        for ordinal, chunk in enumerate(source()):
            spec = active_fault_spec()
            if spec is not None:
                spec.on_source_chunk(ordinal)
            yield chunk

    return opener


def resilient_source(source: Callable[[], Iterator], *,
                     policy: RetryPolicy | None = None, stats=None,
                     sleep: Callable[[float], None] = time.sleep,
                     ) -> Callable[[], Iterator]:
    """THE source chokepoint: every streaming fit wraps its chunk-source
    factory here at fit entry. Returns a factory with the same re-iterable
    zero-arg contract. Recovery protocol on a transient read error at
    chunk i: close the broken iterator, back off per the policy, re-open
    the source and fast-forward the i already-delivered chunks, then
    resume — the consumer sees an uninterrupted, identical stream.
    ``max_attempts`` bounds consecutive failures while repositioning on
    one chunk; a successful yield resets the count. Under the
    kill-switch the stream is injection-wrapped but fail-fast."""
    spec = active_fault_spec()
    if spec is None and not resilience_enabled():
        return source
    injected = _injected(source)
    if not resilience_enabled():
        return injected

    def opener():
        pol = policy or RetryPolicy.from_env()

        def skipping(start: int) -> Iterator:
            it = injected()
            for i, chunk in enumerate(it):
                if i >= start:
                    yield chunk

        ordinal = 0
        failures = 0
        it = None
        while True:
            if it is None:
                it = skipping(ordinal)
            try:
                chunk = next(it)
            except StopIteration:
                return
            except Exception as e:  # noqa: BLE001 - classified below
                if not is_transient(e):
                    raise
                failures += 1
                if failures >= pol.max_attempts:
                    raise
                d = pol.delay(failures - 1)
                _record("source", d, stats)
                try:
                    it.close()
                except Exception:  # noqa: BLE001 - already broken
                    pass
                it = None
                sleep(d)
                continue
            yield chunk
            ordinal += 1
            failures = 0

    return opener
