"""Deterministic, seedable fault injectors (docs/resilience.md).

One spec string drives every injector so the SAME tier-1 tests, tools and
bench arms can exercise the whole failure surface:

    OTPU_FAULT_SPEC = clause [ ';' clause ... ]
    clause          = kind [ ':' key '=' value [ ',' key '=' value ... ] ]

Kinds (all ordinals 0-based; every targeting rule is deterministic —
either explicit ordinals or a seeded hash, never wall-clock or id()):

* ``source_io``     transient ``TransientSourceError`` (an ``IOError``) on
  chunk-source reads. Targeting: ``chunk=N`` (that ordinal), ``every=K``
  (ordinals K-1, 2K-1, ...), or ``p=F,seed=S`` (seeded per-ordinal coin).
  ``fails=N`` — each targeted ordinal fails its first N reads then
  succeeds (the fail-N-then-succeed pattern retries must absorb);
  ``fails=-1`` = always fails (the retry-exhaustion pattern).
* ``slow_source``   straggler chunks: sleep ``delay_ms`` before serving
  targeted ordinals (``every=K`` / ``chunk=N``; every read, no budget).
* ``spill_corrupt`` corrupt spill record ``record=N`` at WRITE time:
  ``mode=flip`` XORs one payload byte after the CRC was computed (so the
  v2 read-side check trips), ``mode=truncate`` writes only half the
  record (a crash-mid-write; caught by the finalize/attach size check).
* ``wedge``         the ``at=N``-th guarded dispatch sync (1-based) holds
  for ``hold_s`` seconds (default 3600) before syncing
  (resilience/watchdog.py): under ``OTPU_DISPATCH_BUDGET_S`` the watchdog
  raises ``DispatchWedgedError``; without a budget it is a finite stall.
* ``aot_build``     the first ``fails=N`` AOT builds in the serving
  ``ExecutableCache`` raise ``TransientBuildError`` (optionally only for
  keys whose repr contains ``key=SUBSTR``).
* ``overload``      sleep ``delay_ms`` inside each of the first
  ``requests=N`` serving dispatches (``-1`` = every dispatch, the
  default) — the deterministic slow-service load the admission
  controller's shed/deadline logic is tested and benched against
  (resilience/overload.py).
* ``drift``         the serving tap (online/tap.py) shifts the features
  it logs by ``shift=S`` (default 3.0) from tapped-chunk ordinal
  ``after=K`` (default 0) on — the deterministic distribution-shift the
  promotion drift gate must reject before any replica flips.
* ``mem_pressure``  report a synthetic memory-pressure fraction
  ``frac=F`` to the brownout watermarks (after the first ``after=K``
  queries, default 0) — drives the shrink-admission/force-spill/degrade
  ladder without actually exhausting host RAM.
* ``label_skew``    the label joiner flips a ``flip=F`` fraction of
  joined labels (seeded per-example crc32 coin, ``seed=S``) from joined
  chunk ``after=K`` on — feature stats stay clean, so only the holdout
  regression bound can catch the poisoned candidate.
* ``trainer_crash`` the ``at=N``-th incremental-trainer device step
  (1-based) raises instead of running — the SIGKILL stand-in the
  checkpoint-resume drill kills the online trainer thread with.
  Consumed once.

State (per-ordinal fail budgets, sync counters) lives on the ``FaultSpec``
instance, so a retried read observes the budget already consumed — that is
what makes fail-twice-then-succeed deterministic. Programmatic activation
(``inject_faults``) takes precedence over the env var; the env-derived
spec is parsed once per distinct ``OTPU_FAULT_SPEC`` value and kept, so
its state also persists across calls within the process.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import zlib

__all__ = [
    "FaultSpec",
    "TransientBuildError",
    "TransientSourceError",
    "active_fault_spec",
    "inject_faults",
    "resilience_enabled",
]


def resilience_enabled() -> bool:
    """THE kill-switch (read per call, the ``OTPU_DONATE`` convention):
    ``OTPU_RESILIENCE=0`` restores legacy fail-fast behavior — no
    retries, no watchdog budget, no spill CRC verification, no
    epoch-cadence snapshots. Injection stays active (see module doc)."""
    from orange3_spark_tpu_torch.utils import knobs

    return knobs.get_bool("OTPU_RESILIENCE")


class TransientSourceError(IOError):
    """Injected transient chunk-source failure (retryable by contract)."""


class TransientBuildError(RuntimeError):
    """Injected transient AOT-build failure (retryable by contract)."""


_KINDS = ("source_io", "slow_source", "spill_corrupt", "wedge", "aot_build",
          "overload", "mem_pressure", "drift", "label_skew",
          "trainer_crash")


def _record_fault(kind: str) -> None:
    from orange3_spark_tpu_torch.utils.profiling import record_fault

    record_fault(kind)


class _Clause:
    """One parsed ``kind:args`` clause plus its mutable injection state."""

    def __init__(self, kind: str, args: dict):
        self.kind = kind
        self.args = args
        self.fail_left: dict[int, int] = {}   # ordinal -> remaining fails
        self.sync_seen = 0                    # wedge/overload/mem_pressure:
        #                                       consuming queries seen
        self.build_fails_done = 0             # aot_build: raises so far
        self.fired = False                    # drift/mem_pressure: ticked

    def _arg(self, key, default=None, cast=float):
        v = self.args.get(key)
        return default if v is None else cast(v)

    def targets(self, ordinal: int) -> bool:
        """Deterministic ordinal targeting shared by the source kinds."""
        if "chunk" in self.args:
            return ordinal == int(self.args["chunk"])
        if "every" in self.args:
            k = max(1, int(self.args["every"]))
            return ordinal % k == k - 1
        if "p" in self.args:
            p = float(self.args["p"])
            seed = int(self.args.get("seed", 0))
            # seeded per-ordinal coin: crc32 is stable across processes
            # (unlike hash()), so the same spec targets the same chunks
            # in a subprocess bench arm and an in-process test
            h = zlib.crc32(f"{seed}:{ordinal}".encode()) / 0xFFFFFFFF
            return h < p
        return True                           # bare kind: every ordinal


class FaultSpec:
    """Parsed, stateful fault-injection spec (see the module docstring)."""

    def __init__(self, clauses: list[_Clause], text: str = ""):
        self.clauses = clauses
        self.text = text
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        clauses = []
        for raw in text.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            kind, _, rest = raw.partition(":")
            kind = kind.strip()
            if kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in OTPU_FAULT_SPEC "
                    f"(known: {_KINDS}); spec grammar: docs/resilience.md"
                )
            args = {}
            for kv in rest.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                k, sep, v = kv.partition("=")
                if not sep:
                    raise ValueError(
                        f"malformed fault arg {kv!r} in clause {raw!r} "
                        "(expected key=value)"
                    )
                args[k.strip()] = v.strip()
            clauses.append(_Clause(kind, args))
        return cls(clauses, text)

    def _of(self, kind: str):
        return [c for c in self.clauses if c.kind == kind]

    # ------------------------------------------------------ source hooks
    @property
    def has_source_faults(self) -> bool:
        return any(c.kind in ("source_io", "slow_source")
                   for c in self.clauses)

    def on_source_chunk(self, ordinal: int) -> None:
        """Called by the injected source wrapper before yielding chunk
        ``ordinal``: may sleep (straggler) and/or raise (transient IO)."""
        for c in self._of("slow_source"):
            if c.targets(ordinal):
                _record_fault("slow_source")
                time.sleep(c._arg("delay_ms", 10.0) / 1e3)
        for c in self._of("source_io"):
            if not c.targets(ordinal):
                continue
            fails = int(c._arg("fails", 1, cast=int))
            with self._lock:
                if fails < 0:
                    left = -1
                else:
                    left = c.fail_left.setdefault(ordinal, fails)
                    if left > 0:
                        c.fail_left[ordinal] = left - 1
            if left != 0:
                _record_fault("source_io")
                raise TransientSourceError(
                    f"injected transient source fault at chunk {ordinal}"
                    f" ({'always' if fails < 0 else f'{left} left'})"
                )

    # ----------------------------------------------------- storage hooks
    def take_spill_corrupt(self, record: int) -> str | None:
        """'flip' / 'truncate' when record ``record`` should be corrupted
        at write time (consumed: each clause fires once)."""
        for c in self._of("spill_corrupt"):
            with self._lock:
                if c.fail_left.get(record, 1) == 0:
                    continue
                if record == int(c._arg("record", 0, cast=int)):
                    c.fail_left[record] = 0
                    _record_fault("spill_corrupt")
                    return str(c.args.get("mode", "flip"))
        return None

    # ---------------------------------------------------- dispatch hooks
    def take_wedge(self) -> float | None:
        """hold-seconds when THIS guarded dispatch sync should wedge
        (the Nth sync since the spec was installed), else None."""
        for c in self._of("wedge"):
            with self._lock:
                c.sync_seen += 1
                if c.sync_seen == int(c._arg("at", 1, cast=int)):
                    _record_fault("wedge")
                    return c._arg("hold_s", 3600.0)
        return None

    def take_overload_delay(self) -> float | None:
        """Seconds of injected service delay for THIS serving dispatch
        (the Nth since the spec was installed), else None. ``requests=N``
        bounds the slow spell (default -1 = every dispatch)."""
        for c in self._of("overload"):
            with self._lock:
                c.sync_seen += 1
                budget = int(c._arg("requests", -1, cast=int))
                if 0 <= budget < c.sync_seen:
                    continue
            _record_fault("overload")
            return c._arg("delay_ms", 10.0) / 1e3
        return None

    def mem_pressure_frac(self, consume: bool = True) -> float | None:
        """Synthetic memory-pressure fraction for the brownout
        watermarks, else None. ``after=K`` keeps the first K CONSUMING
        queries (chunk offers) pressure-free so a ladder test can cache
        a prefix before the squeeze; side observers (/healthz scrapes)
        pass ``consume=False`` and never advance the budget — a load
        balancer polling health must not shift deterministic targeting.
        The fault counter ticks once per clause, at first activation."""
        for c in self._of("mem_pressure"):
            fire = False
            with self._lock:
                if consume:
                    c.sync_seen += 1
                if c.sync_seen <= int(c._arg("after", 0, cast=int)):
                    continue
                if consume and not c.fired:
                    c.fired = True
                    fire = True
            if fire:
                _record_fault("mem_pressure")
            return c._arg("frac", 1.0)
        return None

    # ------------------------------------------------------ online hooks
    def take_drift_shift(self, ordinal: int) -> float | None:
        """Feature shift to apply to tapped chunk ``ordinal`` (0-based),
        else None. The counter ticks once per clause, at first
        activation (a sustained shift is one fault, not N)."""
        for c in self._of("drift"):
            fire = False
            with self._lock:
                if ordinal < int(c._arg("after", 0, cast=int)):
                    continue
                if not c.fired:
                    c.fired = True
                    fire = True
            if fire:
                _record_fault("drift")
            return c._arg("shift", 3.0)
        return None

    def take_label_flip(self, ordinal: int, n_rows: int):
        """Boolean mask of labels to flip in joined chunk ``ordinal``,
        else None. Seeded per-(chunk, row) crc32 coin so the SAME rows
        flip in a subprocess bench arm and an in-process test; counter
        ticks once per clause."""
        for c in self._of("label_skew"):
            fire = False
            with self._lock:
                if ordinal < int(c._arg("after", 0, cast=int)):
                    continue
                if not c.fired:
                    c.fired = True
                    fire = True
            if fire:
                _record_fault("label_skew")
            frac = c._arg("flip", 0.5)
            seed = int(c._arg("seed", 0, cast=int))
            mask = [
                zlib.crc32(f"{seed}:{ordinal}:{r}".encode()) / 0xFFFFFFFF
                < frac for r in range(n_rows)
            ]
            return mask
        return None

    def take_trainer_crash(self) -> bool:
        """True when THIS trainer device step (the Nth since the spec was
        installed, 1-based ``at=N``) should die. Consumed once per
        matching clause."""
        for c in self._of("trainer_crash"):
            with self._lock:
                c.sync_seen += 1
                if c.sync_seen == int(c._arg("at", 1, cast=int)):
                    _record_fault("trainer_crash")
                    return True
        return False

    # ----------------------------------------------------- serving hooks
    def maybe_fail_aot_build(self, key) -> None:
        for c in self._of("aot_build"):
            sub = c.args.get("key")
            if sub is not None and sub not in repr(key):
                continue
            with self._lock:
                if c.build_fails_done >= int(c._arg("fails", 1, cast=int)):
                    continue
                c.build_fails_done += 1
            _record_fault("aot_build")
            raise TransientBuildError(
                f"injected transient AOT build fault ({c.build_fails_done}"
                f"/{int(c._arg('fails', 1, cast=int))}) for key {key!r}"
            )


# programmatic install (innermost wins) > env-derived spec. The env spec
# is parsed once per distinct string and KEPT so its per-ordinal budgets
# persist across reads within the process.
_installed: list[FaultSpec] = []
_env_cache: tuple[str, FaultSpec | None] = ("", None)


def active_fault_spec() -> FaultSpec | None:
    """The currently active spec, or None when no faults are configured."""
    if _installed:
        return _installed[-1]
    global _env_cache
    text = os.environ.get("OTPU_FAULT_SPEC", "")
    if not text:
        return None
    if _env_cache[0] != text:
        _env_cache = (text, FaultSpec.parse(text))
    return _env_cache[1]


@contextlib.contextmanager
def inject_faults(spec: "FaultSpec | str"):
    """Scope a fault spec over a block (tests / tools / bench arms):

        with inject_faults("source_io:chunk=2,fails=2"):
            model = est.fit_stream(source, ...)
    """
    if isinstance(spec, str):
        spec = FaultSpec.parse(spec)
    _installed.append(spec)
    try:
        yield spec
    finally:
        _installed.remove(spec)
