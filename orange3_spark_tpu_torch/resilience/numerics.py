"""Non-finite training guard — typed divergence instead of silent NaN.

A copy of the JAX package's ``resilience/numerics.py`` on tensors. A too-hot
step size (or one Inf cell in a billion-row stream) turns a streaming fit
into a NaN factory that trains to completion and ships a useless model. The
guard is one check per EPOCH (never per step: a per-step host sync would
serialise the step pipeline): the epoch's last loss scalar, or, when there
is no loss (a deferred ingest pass) and on the fit's final check, one sum
over theta. A non-finite value raises :class:`NumericalDivergenceError`
naming the epoch and chunk ordinal, ticks ``otpu_divergence_total`` and
lands an instant on the span timeline. Inert under ``OTPU_RESILIENCE=0``
(read per call). A divergence writes a flight bundle (obs/flight.py).
"""

from __future__ import annotations

import math

import torch

from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.resilience.faults import resilience_enabled

__all__ = ["NumericalDivergenceError", "check_finite_training"]

_M_DIVERGENCE = REGISTRY.counter(
    "otpu_divergence_total",
    "streaming fits aborted by the non-finite training guard")


class NumericalDivergenceError(FloatingPointError):
    """Training state went non-finite. ``what`` names the tripping value
    ('loss' or 'theta'), ``epoch``/``chunk`` locate it in the stream,
    ``trace_id`` names the fit's run id (obs/context.py)."""

    def __init__(self, *, what: str, epoch: int, chunk: int,
                 estimator: str = "", trace_id: str | None = None):
        self.what = what
        self.epoch = epoch
        self.chunk = chunk
        self.estimator = estimator
        self.trace_id = trace_id
        who = f"{estimator} " if estimator else ""
        tr = f" [trace {trace_id}]" if trace_id else ""
        super().__init__(
            f"{who}training diverged: non-finite {what} at epoch {epoch}, "
            f"chunk ordinal {chunk}{tr}. Lower step_size / raise "
            "reg_param, or check the stream for Inf/NaN features. "
            "OTPU_RESILIENCE=0 restores the legacy silent-NaN behavior."
        )


def _tree_finite(tree) -> bool:
    """Every leaf finite: one sum per leaf (an Inf or NaN poisons it, and
    +Inf + -Inf is NaN, so no cancellation hides one), read once."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, torch.Tensor):
            leaves.append(t.sum(dtype=torch.float32))

    walk(tree)
    if not leaves:
        return True
    return math.isfinite(float(torch.stack(leaves).sum()))


def check_finite_training(loss=None, theta=None, *, epoch: int, chunk: int,
                          estimator: str = "", final: bool = False) -> None:
    """The per-epoch guard every streaming fit calls at its epoch boundary.
    Reads the loss scalar; checks ``theta`` only when there is no loss for
    the epoch, and always on the fit's ``final`` check: a step's loss is
    computed from theta before its update, so a last-step divergence
    leaves a finite loss and only theta carries the NaN. No-op under the
    kill-switch."""
    if not resilience_enabled():
        return
    what = None
    if loss is not None and not math.isfinite(float(loss)):
        what = "loss"
    elif theta is not None and (loss is None or final) and not _tree_finite(theta):
        what = "theta"
    if what is None:
        return
    _M_DIVERGENCE.inc()
    from orange3_spark_tpu_torch.obs import trace as _trace
    from orange3_spark_tpu_torch.obs.context import current_trace_id, flag_current_trace

    _trace.instant("divergence", what=what, epoch=epoch, chunk=chunk)
    flag_current_trace()
    err = NumericalDivergenceError(what=what, epoch=epoch, chunk=chunk,
                                   estimator=estimator, trace_id=current_trace_id())
    # black box (obs/flight.py): the fit's spans, registry state and knob
    # table at the moment of divergence, before any checkpoint or caller
    # cleanup can disturb them
    from orange3_spark_tpu_torch.obs.flight import auto_dump

    auto_dump("divergence", err)
    raise err
