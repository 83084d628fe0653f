"""Incremental trainer — a background fit thread over the request log.

Tails the :class:`~orange3_spark_tpu_torch.io.reqlog.RequestLog`, joins labels
onto their request chunks (bounded window, typed accounting), and
applies sparse touched-row updates (the ``optim/`` rules via the SAME
step the offline fit runs, ``models/hashed_linear._step_core``, with the
'sort' lowering: on CUDA its update is one ``segment_update_sorted``
launch) to a **standby** copy of the serving model's state — the serving
model object is never mutated; a candidate snapshot is minted on demand
for the promotion gates.

The step updates ``emb`` and the optimizer's slots IN PLACE (the JAX
package's functional arrays are new buffers each step), so the standby
state is a clone of the serving model's tensors, made before the first
step, and every step runs under the trainer's lock, so a candidate
snapshot never reads a half-written table.

**Checkpoint/resume**: every ``OTPU_ONLINE_CKPT_STEPS`` device steps the
trainer snapshots (theta, optimizer state, the consumed-log byte offset,
the join window and the partial example buffer) through the existing
:class:`~orange3_spark_tpu_torch.utils.fault.StreamCheckpointer` — a SIGKILL'd
trainer resumes from the recorded offset WITHOUT re-reading the consumed
log prefix, and (because steps are deterministic) converges to the same
candidate bitwise as an uninterrupted run.

The ``trainer_crash:at=N`` injector (resilience/faults.py) kills the
thread at its Nth device step — the deterministic SIGKILL stand-in the
resume drill is built on. A dead trainer is a typed condition
(:class:`OnlineTrainerError` from :meth:`IncrementalTrainer.result`),
never a hang.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

__all__ = ["IncrementalTrainer", "OnlineTrainerError",
           "TrainerCrashInjected"]

_M_EXAMPLES = REGISTRY.counter(
    "otpu_online_examples_total",
    "labeled examples consumed by the incremental trainer")
_M_STEPS = REGISTRY.counter(
    "otpu_online_steps_total",
    "incremental-trainer device steps applied to the standby state")
_G_LAG = REGISTRY.gauge(
    "otpu_online_trainer_lag_bytes",
    "request-log bytes appended but not yet consumed by the trainer")
_G_LOG = REGISTRY.gauge(
    "otpu_online_log_bytes", "request-log size on disk")


class OnlineTrainerError(RuntimeError):
    """The incremental trainer died (or failed to stop in budget).
    Carries the phase and the original error string — the caller's
    typed alternative to a silently-stale candidate."""

    def __init__(self, *, phase: str, detail: str):
        self.phase = phase
        self.detail = detail
        super().__init__(
            f"online trainer failed during {phase}: {detail}")


class TrainerCrashInjected(RuntimeError):
    """Injected trainer death (``trainer_crash:at=N``) — the SIGKILL
    stand-in the checkpoint-resume drill kills the thread with."""


class IncrementalTrainer:
    """Background supervised fit over the live request/label log."""

    def __init__(self, model, log, *, session, checkpoint_path: str,
                 chunk_rows: int | None = None,
                 join_window: int | None = None,
                 ckpt_steps: int | None = None,
                 poll_s: float = 0.02):
        from orange3_spark_tpu_torch.io.reqlog import LabelJoiner

        self.model = model
        self.log = log
        self.session = session
        self.chunk_rows = int(chunk_rows if chunk_rows is not None
                              else knobs.get_int("OTPU_ONLINE_CHUNK_ROWS"))
        self.join_window = int(
            join_window if join_window is not None
            else knobs.get_int("OTPU_ONLINE_JOIN_WINDOW"))
        self.ckpt_steps = int(ckpt_steps if ckpt_steps is not None
                              else knobs.get_int("OTPU_ONLINE_CKPT_STEPS"))
        self.poll_s = float(poll_s)
        self.joiner = LabelJoiner(self.join_window)
        self._buf_X: list[np.ndarray] = []
        self._buf_y: list[np.ndarray] = []
        self._buf_rows = 0
        self.offset = 0                  # consumed-log byte offset
        self.steps = 0
        self.examples = 0
        self.resumed_from_step = 0
        self.last_loss: float | None = None
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()    # device state + counters
        self._t0 = time.perf_counter()
        self._init_device_state()
        from orange3_spark_tpu_torch.utils.fault import StreamCheckpointer

        self.ckpt = StreamCheckpointer(checkpoint_path,
                                       every_steps=self.ckpt_steps)
        self._maybe_resume()

    # ------------------------------------------------------- device state
    def _init_device_state(self) -> None:
        from orange3_spark_tpu_torch.models.hashed_linear import (
            _init_fit_state,
        )
        from orange3_spark_tpu_torch.ops.hashing import salts_tensor
        from orange3_spark_tpu_torch.optim.sparse import init_optim_state

        p = self.model.params
        _theta0, _opt0, _salts_np, _salts, kw = _init_fit_state(
            p, self.session)
        dev = self.session.device
        # the trainer consumes raw f32 joined chunks, never cache-encoded
        # ones, and the 'sort' lowering needs no host-side presort plan —
        # the two statics that differ from the offline fit's program
        kw["codec"] = None
        if kw["sparse_lowering"] == "plan":
            kw["sparse_lowering"] = "sort"
        self._kw = kw
        # warm-start the STANDBY from the serving model's state: CLONES on
        # the session's device, because the step writes emb and the slots
        # in place — the serving object keeps its own tensors (never
        # mutated under it)
        self.theta = {k: torch.as_tensor(v).to(dev, copy=True)
                      for k, v in self.model.state_pytree.items()}
        self.opt_state = init_optim_state(kw["optim_update"], self.theta)
        self.salts = salts_tensor(np.asarray(self.model.salts), dev)
        self._reg = float(p.reg_param)
        self._lr = float(p.step_size)
        self.pad_rows = self.session.pad_rows(self.chunk_rows)
        self.n_cols = p.n_dense + p.n_cat

    def _meta(self) -> tuple:
        p = self.model.params
        return ("online-trainer-v1", p.n_dims, p.n_dense, p.n_cat,
                self.chunk_rows, self._kw["optim_update"])

    # -------------------------------------------------- checkpoint/resume
    def _maybe_resume(self) -> None:
        from orange3_spark_tpu_torch.models.hashed_linear import _load_into

        step, state = self.ckpt.load(expect_meta=self._meta())
        if state is None:
            return
        with self._lock:
            _load_into(self.theta, state["theta"])
            _load_into(self.opt_state, state["opt"])
            self.offset = int(state["offset"])
            self.steps = int(step)
            self.examples = int(state["examples"])
            self.joiner.load_state(state["joiner"])
            self._buf_X = [np.asarray(a) for a in state["buf_X"]]
            self._buf_y = [np.asarray(a) for a in state["buf_y"]]
            self._buf_rows = sum(a.shape[0] for a in self._buf_X)
            self.resumed_from_step = int(step)

    def _checkpoint(self, force: bool = False) -> None:
        state = {
            "theta": self.theta, "opt": self.opt_state,
            "offset": self.offset, "examples": self.examples,
            "joiner": self.joiner.state(),
            "buf_X": list(self._buf_X), "buf_y": list(self._buf_y),
        }
        if force:
            self.ckpt.save(self.steps, state, self._meta())
        else:
            self.ckpt.maybe_save(self.steps, state, self._meta())

    # --------------------------------------------------------------- step
    def _device_step(self, X: np.ndarray, y: np.ndarray) -> float:
        from orange3_spark_tpu_torch.io.streaming import _pad_chunk
        from orange3_spark_tpu_torch.models.hashed_linear import _step_into
        from orange3_spark_tpu_torch.resilience.faults import active_fault_spec

        spec = active_fault_spec()
        if spec is not None and spec.take_trainer_crash():
            raise TrainerCrashInjected(
                f"injected trainer crash at step {self.steps + 1}")
        Xp, yp, wp = _pad_chunk(X, y, None, self.pad_rows, self.n_cols)
        dev = self.session.device
        chunk = (torch.from_numpy(Xp).to(dev), int(X.shape[0]),
                 torch.from_numpy(yp).to(dev), torch.from_numpy(wp).to(dev))
        # the step writes theta and the optimizer state in place: under
        # the lock, so a candidate snapshot reads whole tables
        with self._lock:
            loss = _step_into(self.theta, self.opt_state, chunk, self.salts,
                              (self._reg, self._lr, 0.0), self._kw)
        return float(loss)

    def _apply_label_skew(self, ordinal: int, y: np.ndarray) -> np.ndarray:
        from orange3_spark_tpu_torch.resilience.faults import active_fault_spec

        spec = active_fault_spec()
        if spec is None:
            return y
        flip = spec.take_label_flip(ordinal, y.shape[0])
        if flip is None:
            return y
        mask = np.asarray(flip, bool)
        if not mask.any():
            return y
        y = y.copy()
        y[mask] = 1.0 - y[mask]
        return y

    def consume_available(self) -> int:
        """Drain every complete log record appended since the consumed
        offset; step whenever the example buffer fills. Returns records
        consumed. (The background loop calls this on a poll cadence;
        tests call it directly for determinism.)"""
        consumed = 0
        for nxt, _ordinal, kind, req_id, arr in \
                self.log.read_from(self.offset):
            joined = self.joiner.offer(kind, req_id, arr)
            if joined is not None:
                X, y = joined
                y = self._apply_label_skew(self.joiner.counts["joined"], y)
                with self._lock:
                    self._buf_X.append(X)
                    self._buf_y.append(y)
                    self._buf_rows += X.shape[0]
                    self.examples += X.shape[0]
                _M_EXAMPLES.inc(X.shape[0])
            self.offset = nxt
            consumed += 1
            while self._buf_rows >= self.chunk_rows:
                self._step_from_buffer()
        _G_LOG.set(self.log.size_bytes)
        _G_LAG.set(max(self.log.size_bytes - self.offset, 0))
        return consumed

    def _step_from_buffer(self) -> None:
        from orange3_spark_tpu_torch.obs import trace as _trace

        with self._lock:
            X = np.concatenate(self._buf_X, axis=0)
            y = np.concatenate(self._buf_y, axis=0)
            take = self.chunk_rows
            Xc, yc = X[:take], y[:take]
            rest_X, rest_y = X[take:], y[take:]
            self._buf_X = [rest_X] if rest_X.shape[0] else []
            self._buf_y = [rest_y] if rest_y.shape[0] else []
            self._buf_rows = rest_X.shape[0]
        with _trace.span("online_step", rows=int(Xc.shape[0])):
            self.last_loss = self._device_step(Xc, yc)
        with self._lock:
            self.steps += 1
        _M_STEPS.inc()
        self._checkpoint()

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "IncrementalTrainer":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="otpu-online-trainer")
        self._thread.start()
        return self

    def _run(self) -> None:
        from orange3_spark_tpu_torch.online.tap import online_enabled

        try:
            while not self._stop.is_set():
                if online_enabled():
                    self.consume_available()
                self._stop.wait(self.poll_s)
            self.consume_available()        # final drain, then snapshot
            self._checkpoint(force=True)
        except BaseException as e:  # noqa: BLE001 - typed via result()
            self.error = e

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop the thread (bounded); typed error instead of a hang."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            if t.is_alive():
                raise OnlineTrainerError(
                    phase="stop",
                    detail=f"trainer thread still running after "
                           f"{timeout_s:.0f}s")
        self.result()

    def result(self) -> dict:
        """The trainer's status — or the typed error that killed it."""
        if self.error is not None:
            raise OnlineTrainerError(
                phase="train",
                detail=f"{type(self.error).__name__}: {self.error}"
            ) from self.error
        return self.status()

    def status(self) -> dict:
        wall = max(time.perf_counter() - self._t0, 1e-9)
        with self._lock:
            return {
                "steps": self.steps, "examples": self.examples,
                "offset": self.offset, "last_loss": self.last_loss,
                "resumed_from_step": self.resumed_from_step,
                "examples_per_s": round(self.examples / wall, 1),
                "lag_bytes": max(self.log.size_bytes - self.offset, 0),
                "buffered_rows": self._buf_rows,
                "join_counts": dict(self.joiner.counts),
                "alive": bool(self._thread and self._thread.is_alive()),
                "died": self.error is not None,
            }

    # ---------------------------------------------------------- candidate
    def candidate_model(self):
        """A standalone candidate snapshot: same class/params/salts as
        the serving model, the trainer's CURRENT theta (a copy — the
        promotion gates must not race live steps): clones of the
        trainer's tensors on its device, so the shadow gate scores on the
        serving device."""
        from orange3_spark_tpu_torch.models.hashed_linear import (
            HashedLinearModel,
        )

        with self._lock:
            theta = {k: v.clone() for k, v in self.theta.items()}
        m = HashedLinearModel(self.model.params, theta,
                              np.asarray(self.model.salts),
                              self.model.class_values)
        m.n_steps_ = self.steps
        return m

