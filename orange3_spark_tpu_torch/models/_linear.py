"""The dense linear trainer of the PyTorch package, and the per-row losses
the linear models share.

``per_row_loss`` is the one loss implementation of the hashed-sparse path
and the dense linear models; its logits come from an embedding gather or a
matmul. ``per_row_loss_grad`` is its derivative with respect to the logits,
written out, with the JAX package's autodiff rules at the kinks: d max(a, b)
splits 1/2 to each side at a tie, and d|z|/dz is +1 at z = 0. Those rules
matter here: a fit starts from zero, so every logit of the first step is
exactly 0 (where the binary logistic gradient is ½ - y - ½, 0 or -1, not
sigmoid(0) - y) and a hinge margin can sit exactly at 1.

``fit_linear`` fits LogisticRegression, LinearSVC and LinearRegression
(l-bfgs): MLlib's objective (1/Σw) Σ wᵢ·lossᵢ + ½·reg_l2·‖coef‖², the
intercept unregularized, minimized by ``lbfgs_minimize`` (optax's L-BFGS
with its zoom linesearch, step for step) or, with an L1 term, by
``owlqn_minimize``. The JAX package runs each minimizer as one
``lax.while_loop`` on the device. Here each is a host loop over device
tensors: the device computes the objective and every vector of the
recursion, and the host reads back only the scalars a decision needs, a
handful at a time (counted in ``LinearFitResult.host_reads``, beside the
objective evaluations in ``n_evals``). The decisions' scalar arithmetic
runs on the host in float32, as the reference's runs on the device.

The products ``X @ B`` and ``X^T G`` are ``torch.mm`` calls (the reference
leaves them to XLA's dot, outside any Pallas kernel). With
``compute_dtype='bfloat16'`` X is cast once a fit, and the products follow
the reference's rounding: the forward multiplies bf16 X by bf16 B with an
f32 result; the gradient is X^T G with G in f32, rounded once to bf16.
cuBLAS has no product of an f32 and a bf16 operand, so G is split into
three bf16 parts whose sum is G exactly (``_split_bf16``) and X^T [G_hi,
G_lo, G_lo2] is one bf16 product with an f32 result: each product of two
bf16 values is exact in f32, so the result differs from the reference's
only in the order of its sums. It costs writing and reading G's three
parts (6·N·k bytes) against reading an f32 copy of X (4·N·d bytes) twice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orange3_spark_tpu_torch.core.fmath import norm32, sqrt32, xla_sum
from orange3_spark_tpu_torch.ops.prng import _fma32, _xla_exp, _xla_log, _xla_log1p
from orange3_spark_tpu_torch.ops.stats import EPS_TOTAL_WEIGHT
from orange3_spark_tpu_torch.ops.stats import inv_std_scale as column_inv_std

__all__ = ["AutogradObjective", "EPS_TOTAL_WEIGHT", "LOGIT_BLOCK_ROWS", "LOSS_KINDS", "LinearFitResult",
           "LinearObjective", "column_inv_std",
           "dense_logits", "fit_linear", "lbfgs_minimize", "owlqn_minimize",
           "penalties", "per_row_loss", "per_row_loss_and_grad", "per_row_loss_grad",
           "record_fit_counts"]

LOSS_KINDS = ("logistic", "binary_logistic", "hinge", "squared_hinge", "squared")
_F32 = np.float32


def _xla_log_softmax(logits: torch.Tensor):
    """``jax.nn.log_softmax`` over the last axis as XLA:CPU runs it:
    ``shifted = z - max``, then ``shifted - log(Σ exp(shifted))`` with
    XLA's exp and log and the k entries summed in its order. Returns the
    log-probabilities, exp(shifted) and the sum (the backward's inputs)."""
    shifted = logits - torch.amax(logits, dim=-1, keepdim=True)
    e = _xla_exp(shifted)
    s = xla_sum(e, dim=-1, keepdim=True)
    return shifted - _xla_log(s), e, s


#: elements of one row block of the CPU path's written-out losses: an op
#: on fewer than torch's parallel grain (32,768) runs on the calling
#: thread, where an OpenMP region an op would cost more than the work on a
#: machine whose cores are shared (tens of ops an element here)
_CPU_BLOCK = (1 << 15) - 1


def _by_row_blocks(fn, logits: torch.Tensor, *rows: torch.Tensor):
    """``fn(logits, *rows)`` (a tensor or a tuple of them) a block of at
    most ``_CPU_BLOCK`` logits at a time, concatenated: every step of
    ``fn`` is row by row, so the blocks give its bits."""
    step = max(1, _CPU_BLOCK // max(1, logits.shape[1]))
    if logits.shape[0] <= step:
        return fn(logits, *rows)
    parts = [fn(logits[i:i + step], *(r[i:i + step] for r in rows))
             for i in range(0, logits.shape[0], step)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def _xla_logistic(loss_kind: str, logits: torch.Tensor, y: torch.Tensor,
                  ct: torch.Tensor | None):
    """The CPU path of the two logistic losses: the row losses with XLA's
    exp, log, log1p and sum order, and (``ct`` given) their gradient times
    ``ct`` as the reference's ``jax.grad`` steps through its jaxpr.
    Softmax cross-entropy: -log_softmax at the label; the one-hot
    cotangent c = -ct at the label, then c + (Σ(-c) / Σexp) · exp(shifted),
    that multiply-add fused as XLA:CPU fuses it (on an AVX-512 host every
    column but the last of k = 3, whose vector tail it leaves as a product
    and a sum). Binary: max(z, 0) - z·y + log1p(u), u = exp(-|z|); b = ct /
    (u + 1) · u, then ±b (by the sign of z) + (-ct)·y + ct·step(z).
    Returns (rows, gradient or None)."""
    if loss_kind == "logistic":
        logp, e, s = _xla_log_softmax(logits)
        label = y.to(torch.int64)[:, None]
        rows = -torch.gather(logp, 1, label)[:, 0]
        if ct is None:
            return rows, None
        c = torch.zeros_like(logits).scatter_add_(1, label, (-ct)[:, None])
        b = xla_sum(-c, dim=1, keepdim=True) / s
        g = _fma32(b, e, c)
        if logits.shape[1] == 3:
            g[:, 2] = c[:, 2] + b[:, 0] * e[:, 2]
        return rows, g
    z = logits[:, 0]
    u = _xla_exp(-torch.abs(z))
    rows = torch.clamp_min(z, 0.0) - z * y + _xla_log1p(u)
    if ct is None:
        return rows, None
    b = ct / (u + 1.0) * u
    g = torch.where(z >= 0, -b, b) + (-ct) * y
    return rows, (g + ct * _tie_step(z))[:, None]


def _xla_path(loss_kind: str, logits: torch.Tensor) -> bool:
    return not logits.is_cuda and loss_kind in ("logistic", "binary_logistic")


def per_row_loss(loss_kind: str, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[N] loss of each row from [N, k] logits and [N] labels.

    'logistic' is softmax cross-entropy over k classes; 'binary_logistic'
    the single-logit sigmoid form (k = 1), softplus(z) - z·y written
    stably; 'hinge'/'squared_hinge' the SVM margins on the first logit;
    'squared' least squares. On the CPU the two logistic losses take XLA's
    exp, log and log1p and its sum order (``_xla_logistic``): bitwise the
    reference's; on the card torch's."""
    if _xla_path(loss_kind, logits):
        return _by_row_blocks(lambda z, yy: _xla_logistic(loss_kind, z, yy, None)[0],
                              logits, y)
    if loss_kind == "logistic":
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, 1, y.to(torch.int64)[:, None])[:, 0]
    if loss_kind == "binary_logistic":
        z = logits[:, 0]
        return torch.clamp_min(z, 0.0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    if loss_kind in ("hinge", "squared_hinge"):
        margin = torch.clamp_min(1.0 - (2.0 * y - 1.0) * logits[:, 0], 0.0)
        return margin if loss_kind == "hinge" else margin**2
    if loss_kind == "squared":
        return 0.5 * (logits[:, 0] - y) ** 2
    raise ValueError(loss_kind)


def _tie_step(a: torch.Tensor) -> torch.Tensor:
    """d max(a, 0)/da: 1 above, ½ at the tie, 0 below."""
    return torch.where(a > 0, 1.0, torch.where(a == 0, 0.5, 0.0))


def per_row_loss_grad(loss_kind: str, logits: torch.Tensor, y: torch.Tensor,
                      ct: torch.Tensor | None = None) -> torch.Tensor:
    """[N, k] d per_row_loss / d logits, row by row, times ``ct`` ([N], each
    row loss's cotangent, e.g. wᵢ·(1/Σw); 1 when None). On the CPU the
    logistic losses follow the reference's autodiff step for step
    (``_xla_logistic``: bitwise its ``jax.grad``); elsewhere the
    derivative is formed, then scaled by ``ct``."""
    if ct is None:
        ct = torch.ones_like(logits[:, 0])
    if _xla_path(loss_kind, logits):
        return per_row_loss_and_grad(loss_kind, logits, y, ct)[1]
    if loss_kind == "logistic":
        p = torch.softmax(logits, dim=-1)
        g = p - torch.nn.functional.one_hot(
            y.to(torch.int64), logits.shape[1]).to(logits.dtype)
        return g * ct[:, None]
    z = logits[:, 0]
    if loss_kind == "binary_logistic":
        x = torch.exp(-torch.abs(z))
        q = x / (1.0 + x)
        g = _tie_step(z) - y - torch.where(z >= 0, q, -q)
    elif loss_kind in ("hinge", "squared_hinge"):
        s = 2.0 * y - 1.0
        a = 1.0 - s * z
        g = -s * _tie_step(a)
        if loss_kind == "squared_hinge":
            g = 2.0 * torch.clamp_min(a, 0.0) * g
    elif loss_kind == "squared":
        g = z - y
    else:
        raise ValueError(loss_kind)
    return g[:, None] * ct[:, None]


def per_row_loss_and_grad(loss_kind: str, logits: torch.Tensor, y: torch.Tensor,
                          ct: torch.Tensor):
    """(``per_row_loss``, ``per_row_loss_grad`` given ``ct``) in one pass:
    the CPU path's logistic losses share their exp and log_softmax."""
    if _xla_path(loss_kind, logits):
        return _by_row_blocks(lambda z, yy, cc: _xla_logistic(loss_kind, z, yy, cc),
                              logits, y, ct)
    return (per_row_loss(loss_kind, logits, y),
            per_row_loss_grad(loss_kind, logits, y, ct))


LOGIT_BLOCK_ROWS = 1 << 16


def dense_logits(X: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """``X @ coef`` ([N, d] @ [d, k]) as the elementwise products [N, d, k]
    summed over d: a row's reduction runs over its own d products alone, so
    it rounds the same whatever the row count. (A BLAS product need not:
    MKL rounds the rows of a ragged tail block apart from those of its full
    blocks, so a served request and its padded bucket could differ by an
    ulp.) The fitted models' predictions go through it. Tables of more than
    ``LOGIT_BLOCK_ROWS`` rows are taken a block of rows at a time, so the
    products never hold more than LOGIT_BLOCK_ROWS·d·k floats; a row's bits
    do not depend on its block."""
    if X.shape[0] <= LOGIT_BLOCK_ROWS:
        return (X[:, :, None] * coef).sum(dim=1)
    return torch.cat([(Xb[:, :, None] * coef).sum(dim=1)
                      for Xb in X.split(LOGIT_BLOCK_ROWS)])


def row_products(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``X @ M`` ([N, d] @ [d, k]) summed column by column in order: one
    rounded product and one rounded add per column, as separate
    elementwise ops (no fused multiply-add). A row's bits depend on that
    row alone and are the same on the CPU and the card, at any row count
    (a BLAS product may round a ragged tail block apart, and cuBLAS and
    MKL sum in other orders). For the narrow products of the feature
    pipeline (the PCA projection, KMeans' cross term), whose served
    output is held bitwise to the raw transform."""
    out = X[:, 0:1] * M[0]
    for j in range(1, X.shape[1]):
        out = out + X[:, j:j + 1] * M[j]
    return out


class LinearFitResult(NamedTuple):
    coef: torch.Tensor       # [d, k]
    intercept: torch.Tensor  # [k]
    n_iter: int
    final_loss: float
    n_evals: int             # objective evaluations (passes over X: 1, or 2 with the gradient)
    host_reads: int          # device-to-host reads the minimizer's decisions took
    iter_evals: tuple        # evaluations of each iteration (the first's include the start's)


class HostReads:
    """Reads device scalars to the host, one transfer a call, and counts the
    calls: the minimizers' only waits on the device."""

    def __init__(self):
        self.n = 0

    def __call__(self, *scalars: torch.Tensor) -> list:
        self.n += 1
        vals = torch.stack([s.reshape(()).to(torch.float32) for s in scalars]).cpu()
        return [_F32(v) for v in vals.numpy()]


# ------------------------------------------------------------- objective
def _sum(x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """The objective's sums: on the CPU in XLA:CPU's order (``xla_sum``; a
    full sum of the flattened tensor), bitwise the reference's where its
    reduction is one tree; on the card torch's."""
    if x.is_cuda:
        return x.sum() if dim is None else x.sum(dim=dim)
    return xla_sum(x.reshape(-1)) if dim is None else xla_sum(x, dim)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result. Two bf16 operands: on CUDA one cuBLAS
    product with f32 output (``aten::mm.dtype``); on the CPU, which has no
    such kernel, the operands widened to f32 (each product of two bf16
    values is exact in f32, so only the order of the sums differs)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _split_bf16(g: torch.Tensor) -> torch.Tensor:
    """[N, k] f32 -> [N, 3k] bf16 [hi, lo, lo2] with hi + lo + lo2 == g
    exactly: each part takes the next 8 bits of g's 24-bit significand (the
    remainders are exact in f32, and the last is exact in bf16)."""
    hi = g.to(torch.bfloat16)
    r = g - hi.float()
    lo = r.to(torch.bfloat16)
    return torch.cat([hi, lo, (r - lo.float()).to(torch.bfloat16)], dim=1)


class LinearObjective:
    """The loss of a flat theta [d·k + k] (coef row-major, then the
    intercept: the reference's ``ravel_pytree`` order) and its gradient,
    over one table's X, y, w. ``n_evals`` counts the passes."""

    def __init__(self, X, y, w, reg_l2, col_scale, *, loss_kind: str, k: int,
                 fit_intercept: bool, compute_dtype: torch.dtype, group=None):
        from orange3_spark_tpu_torch.parallel.collectives import world_fold

        self.d, self.k = X.shape[1], k
        self.Xc = X.to(compute_dtype)        # once a fit, never once an evaluation
        self.y, self.w = y, w
        self.reg_l2 = float(_F32(reg_l2))
        self.col_scale = col_scale[:, None]
        self.loss_kind, self.fit_intercept = loss_kind, fit_intercept
        # a gang's data group (None for one rank): X, y, w are this rank's
        # rows, and Σw, the data loss and the gradient are folded over the
        # ranks in rank order, Σw once a fit, the rest in one gathered
        # vector an evaluation
        self.group = group
        self.sum_w = torch.clamp_min(world_fold(_sum(w), group), EPS_TOTAL_WEIGHT)
        # d(loss)/d(row loss): the reference's autodiff takes 1/Σw, then × w
        self.row_ct = w * (1.0 / self.sum_w)
        self.n_evals = 0
        self.iter_evals: list[int] = []

    def end_iteration(self) -> None:
        """Marks a minimizer's iteration done: ``iter_evals`` takes the
        evaluations since the last mark."""
        self.iter_evals.append(self.n_evals - sum(self.iter_evals))

    def _split(self, theta):
        dk = self.d * self.k
        return theta[:dk].view(self.d, self.k), theta[dk:]

    def _logits(self, coef, intercept):
        B = (coef * self.col_scale).to(self.Xc.dtype)
        logits = _mm_f32(self.Xc, B)
        return logits + intercept if self.fit_intercept else logits

    def _value(self, coef, logits, rows=None, data_sum=None):
        from orange3_spark_tpu_torch.parallel.collectives import world_fold

        if data_sum is None:
            if rows is None:
                rows = per_row_loss(self.loss_kind, logits, self.y)
            data_sum = world_fold(_sum(rows * self.w), self.group)
        return data_sum / self.sum_w + 0.5 * self.reg_l2 * _sum(coef * coef)

    def value(self, theta: torch.Tensor) -> torch.Tensor:
        self.n_evals += 1
        coef, intercept = self._split(theta)
        return self._value(coef, self._logits(coef, intercept))

    def value_and_grad(self, theta: torch.Tensor):
        self.n_evals += 1
        coef, intercept = self._split(theta)
        logits = self._logits(coef, intercept)
        from orange3_spark_tpu_torch.parallel.collectives import world_fold

        rows, G = per_row_loss_and_grad(self.loss_kind, logits, self.y, self.row_ct)
        k = self.k
        if self.Xc.dtype == torch.float32:
            gB = self.Xc.T @ G
        else:
            P = _mm_f32(self.Xc.T, _split_bf16(G))
            gB = (P[:, :k] + P[:, k:2 * k]) + P[:, 2 * k:]
        g_int = _sum(G, 0) if self.fit_intercept else torch.zeros_like(intercept)
        data_sum = _sum(rows * self.w)
        if self.group is not None:
            dk = self.d * k
            tot = world_fold(torch.cat([gB.reshape(-1), g_int, data_sum.reshape(1)]),
                             self.group)
            gB, g_int, data_sum = tot[:dk].view(self.d, k), tot[dk:dk + k], tot[-1]
        if self.Xc.dtype != torch.float32:
            # the reference rounds the coefficient gradient once to bf16
            gB = gB.to(self.Xc.dtype).float()
        g_coef = gB * self.col_scale + self.reg_l2 * coef
        return (self._value(coef, logits, data_sum=data_sum),
                torch.cat([g_coef.reshape(-1), g_int]))


class AutogradObjective:
    """An objective of ``lbfgs_minimize`` from ``fn``, a scalar function of
    the flat theta (the reference's ``ravel_pytree`` order of its params),
    its gradient by autograd: what the reference's ``jax.value_and_grad``
    of the same function gives, up to the order of float32 sums."""

    def __init__(self, fn):
        self.fn = fn
        self.n_evals = 0
        self.iter_evals: list[int] = []

    def end_iteration(self) -> None:
        self.iter_evals.append(self.n_evals - sum(self.iter_evals))

    def value(self, theta: torch.Tensor) -> torch.Tensor:
        self.n_evals += 1
        with torch.no_grad():
            return self.fn(theta)

    def value_and_grad(self, theta: torch.Tensor):
        self.n_evals += 1
        with torch.enable_grad():
            t = theta.detach().requires_grad_(True)
            v = self.fn(t)
            (g,) = torch.autograd.grad(v, t)
        return v.detach(), g


# ------------------------------------------------------------- L-BFGS
# optax.lbfgs's defaults: scale_by_lbfgs(memory_size, scale_init_precond=True),
# scale(-1), scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy='one') with zoom_linesearch's own defaults
_LS_MAX_STEPS = 20
_SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL = _F32(1e-4), _F32(0.9), _F32(1e-6)
_INTERVAL_THRESHOLD, _INCREASE_FACTOR, _LS_TOL = _F32(1e-5), _F32(2.0), _F32(0.0)
_APPROX_SLOPE = _F32(2 * 1e-4 - 1.0)   # (2·slope_rtol - 1), formed in double as in Python


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when there is none (float32, as optax)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * (dc * dc)) * v0 + db * (db * db) * v1) / denom
    radical = B * B - _F32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (_F32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (float32, as optax)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (_F32(2.0) * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """optax's sufficient-decrease error: Armijo, relaxed by the
    approximate-Wolfe test; 0 when satisfied, inf on NaN."""
    err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope - _APPROX_SLOPE * slope_init
    delta = value - value_init - _APPROX_DEC_RTOL * np.abs(value_init)
    err = np.minimum(np.maximum(approx, delta), err)
    err = np.maximum(err, _F32(0.0))
    return _F32(np.inf) if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - _CURV_RTOL * np.abs(slope_init), _F32(0.0))
    return _F32(np.inf) if np.isnan(err) else err


def _zoom_linesearch(objective, params, updates, value_init, grad_init, slope_init,
                     read: HostReads):
    """optax's ``zoom_linesearch`` along ``updates`` from ``params``: the
    interval search (Nocedal & Wright 3.5), then the zoom (3.6) by cubic,
    quadratic or bisection steps, and the safeguarded return when it runs
    out of steps. One objective evaluation and one host read a step.
    Returns (new params, value as float32, gradient)."""
    count, stepsize = 0, _F32(0.0)
    value, grad, slope, point = value_init, grad_init, slope_init, params
    decrease_error = _F32(np.inf)
    interval_found = done = failed = False
    low = high = cubic_ref = _F32(0.0)
    value_low = value_high = value_cubic_ref = value_init
    slope_low = slope_high = slope_init
    safe = (_F32(0.0), value_init, grad_init, params)   # stepsize, value, grad, point

    def on_line(t):
        p = params + float(t) * updates
        v, g = objective.value_and_grad(p)
        v_h, s_h = read(v, torch.dot(g, updates))
        return p, v_h, g, s_h

    with np.errstate(all="ignore"):
        while not (done or failed):
            if not interval_found:
                new = _F32(1.0) if count == 0 else _INCREASE_FACTOR * stepsize
                p, v, g, s = on_line(new)
                decrease_error = _decrease_error(new, v, s, value_init, slope_init)
                error = max(decrease_error, _curvature_error(s, slope_init))
                if decrease_error <= _LS_TOL:
                    safe = (new, v, g, p)
                high_to_new = decrease_error > 0 or (v >= value and count > 0)
                low_to_new = s >= 0 and not high_to_new
                if low_to_new:
                    low, value_low, slope_low = new, v, s
                    high, value_high, slope_high = stepsize, value, slope
                else:
                    low, value_low, slope_low = stepsize, value, slope
                    high, value_high, slope_high = new, v, s
                cubic_ref, value_cubic_ref = low, value_low
                interval_found = high_to_new or low_to_new or error <= _LS_TOL
                done = bool(error <= _LS_TOL)
                failed = count + 1 >= _LS_MAX_STEPS and not done
            else:
                delta = np.abs(high - low)
                left, right = min(high, low), max(high, low)
                cubic_chk, quad_chk = _F32(0.2) * delta, _F32(0.1) * delta
                mid_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                      cubic_ref, value_cubic_ref)
                mid_quad = _quadmin(low, value_low, slope_low, high, value_high)
                if left + cubic_chk < mid_cubic < right - cubic_chk:
                    new = mid_cubic
                elif left + quad_chk < mid_quad < right - quad_chk:
                    new = mid_quad
                else:
                    new = (low + high) / _F32(2.0)
                p, v, g, s = on_line(new)
                decrease_error = _decrease_error(new, v, s, value_init, slope_init)
                error = max(decrease_error, _curvature_error(s, slope_init))
                if decrease_error <= _LS_TOL and v < safe[1]:
                    safe = (new, v, g, p)
                done = bool(error <= _LS_TOL)
                high_to_mid = decrease_error > 0 or v >= value_low
                high_to_low = s * (high - low) >= 0 and not high_to_mid
                old_low, old_high = (low, value_low, slope_low), (high, value_high, slope_high)
                if high_to_mid:
                    high, value_high, slope_high = new, v, s
                if high_to_low:
                    high, value_high, slope_high = old_low
                if not high_to_mid:
                    low, value_low, slope_low = new, v, s
                cubic_ref, value_cubic_ref = (old_high[:2] if high_to_mid or high_to_low
                                              else old_low[:2])
                too_small = delta <= _INTERVAL_THRESHOLD
                failed = ((count + 1 >= _LS_MAX_STEPS or (too_small and safe[0] > 0))
                          and not done)
            count += 1
            stepsize, value, grad, slope, point = new, v, g, s, p
            if failed and (safe[0] > 0 or np.isinf(decrease_error)):
                stepsize, value, grad, point = safe
    return point, value, grad


def lbfgs_minimize(objective, theta0: torch.Tensor, tol: float, max_iter: int, *,
                   memory_size: int = 10, read: HostReads | None = None):
    """optax.lbfgs (memory 10, scaled initial preconditioner, the zoom
    linesearch), driven as the reference's ``lbfgs_minimize`` drives it:
    the first iteration always runs, then the loop goes on while count <
    max_iter and ‖g‖ > tol, where g is the linesearch's last gradient,
    reused with its value as the next iteration's (optax's
    ``value_and_grad_from_state``); ``max_iter=0`` returns theta0 and its
    value. An iteration costs its linesearch's evaluations and one more
    host read (‖g‖ and the new direction's slope together).
    Returns (theta, n_iter, final value as a float)."""
    read = read or HostReads()
    tol = _F32(tol)
    if max_iter <= 0:
        (v,) = read(objective.value(theta0))
        return theta0, 0, float(v)
    theta, count = theta0, 0
    memory: list[tuple] = []       # (dw, du, rho), the newest last
    prev = None                    # (params, grad) the last update saw
    value = _F32(np.inf)
    grad = torch.zeros_like(theta0)
    while True:
        fresh = not np.isfinite(value)
        if fresh and count > 0:    # the loop test reads the state's gradient
            (gnorm,) = read(sqrt32(torch.dot(grad, grad)))
            if not (count < max_iter and gnorm > tol):
                break
        if fresh:
            value_t, grad = objective.value_and_grad(theta)
        # scale_by_lbfgs: the memory takes the newest pair, then the
        # two-loop recursion from a scaled identity
        if count > 0:
            dw, du = theta - prev[0], grad - prev[1]
            sy = torch.dot(du, dw)
            memory.append((dw, du, torch.where(sy == 0, 0.0, 1.0 / sy)))
            del memory[:-memory_size]
            den = torch.dot(du, du)
            scale = torch.where(den > 0, sy / den, 1.0)
        else:
            scale = torch.clamp_max(1.0 / sqrt32(torch.dot(grad, grad)), 1.0)
        vec, alphas = grad, []
        for dw, du, rho in reversed(memory):
            alpha = rho * torch.dot(dw, vec)
            vec = vec - alpha * du
            alphas.append(alpha)
        vec = scale * vec
        for (dw, du, rho), alpha in zip(memory, reversed(alphas)):
            vec = vec + (alpha - rho * torch.dot(du, vec)) * dw
        updates = -vec
        slope = torch.dot(updates, grad)
        if fresh:
            value, slope_init = read(value_t, slope)
        else:
            gnorm, slope_init = read(sqrt32(torch.dot(grad, grad)), slope)
            if not (count < max_iter and gnorm > tol):
                break
        prev = (theta, grad)
        count += 1
        theta, value, grad = _zoom_linesearch(objective, theta, updates, value, grad,
                                              slope_init, read)
        objective.end_iteration()
        if count >= max_iter:
            break
    return theta, count, float(value)


# ------------------------------------------------------------- OWLQN
def _pseudo_grad(x, g, l1):
    """The minimum-norm subgradient of smooth + Σ l1·|x| (its steepest
    descent direction, negated)."""
    right, left = g + l1, g - l1
    return torch.where(x > 0, right, torch.where(
        x < 0, left, torch.where(right < 0, right, torch.where(left > 0, left, 0.0))))


def _two_loop(gp, memory):
    """The L-BFGS product with the newest pair last in ``memory``
    ((s, y, rho) triples), from the identity scaled by sᵀy/yᵀy."""
    q, alphas = gp, []
    for s, y, rho in reversed(memory):
        a = rho * torch.dot(s, q)
        q = q - a * y
        alphas.append(a)
    if memory:
        s, y, _ = memory[-1]
        q = torch.dot(s, y) / torch.clamp_min(torch.dot(y, y), 1e-30) * q
    for (s, y, rho), a in zip(memory, reversed(alphas)):
        q = q + s * (a - rho * torch.dot(y, q))
    return q


def owlqn_minimize(objective, x0: torch.Tensor, l1_weight: torch.Tensor, tol: float,
                   max_iter: int, *, memory_size: int = 10, max_backtracks: int = 25,
                   read: HostReads | None = None):
    """Orthant-Wise Limited-memory Quasi-Newton (Andrew & Gao 2007), as
    the reference's ``owlqn_minimize``: minimizes objective(x) +
    Σ l1_weight·|x| (l1_weight 0 on unpenalized coordinates, the
    intercept). The pseudo-gradient, the two-loop recursion over the last
    ``memory_size`` pairs with sᵀy > 1e-10, a direction kept only where it
    descends, and a backtracking Armijo search whose trial points are
    projected onto the current orthant; a search that runs out of halvings
    keeps the last iterate and ends the fit, as does a zero direction.
    A trial costs one forward pass and one host read; an iteration adds one
    value-and-gradient pass and two reads. Returns (x, n_iter, final full
    value as a float)."""
    read = read or HostReads()
    tol, c1 = _F32(tol), _F32(1e-4)

    def full_value(x):
        return objective.value(x) + (l1_weight * torch.abs(x)).sum()

    f0, g = objective.value_and_grad(x0)
    F, gpnorm = read(f0 + (l1_weight * torch.abs(x0)).sum(),
                     norm32(_pseudo_grad(x0, g, l1_weight)))
    x, memory, it, stalled = x0, [], 0, False
    while it < max_iter and gpnorm > tol and not stalled:
        gp = _pseudo_grad(x, g, l1_weight)
        d = -_two_loop(gp, memory)
        d = torch.where(d * gp < 0, d, 0.0)
        nonzero, dnorm = read((d != 0).any(), norm32(d))
        xi = torch.where(x != 0, torch.sign(x), torch.sign(-gp))
        t = _F32(1.0) if memory else _F32(1.0) / max(dnorm, _F32(1e-12))
        ok = False
        for _ in range(max_backtracks):
            x_try = x + float(t) * d
            x_t = torch.where(x_try * xi > 0, x_try, 0.0)
            F_t, dec = read(full_value(x_t), torch.dot(gp, x_t - x))
            ok = bool(F_t <= F + c1 * dec)
            t = t * _F32(0.5)
            if ok:
                break
        if not ok:              # an exhausted search keeps the last iterate
            x_t, F_t = x, F
        _, g_new = objective.value_and_grad(x_t)
        s, y = x_t - x, g_new - g
        sy_dev = torch.dot(s, y)
        sy, gpnorm = read(sy_dev, norm32(
            _pseudo_grad(x_t, g_new, l1_weight)))
        if sy > _F32(1e-10):    # the curvature condition: a well-posed pair
            memory.append((s, y, 1.0 / sy_dev))
            del memory[:-memory_size]
        x, F, g, it = x_t, F_t, g_new, it + 1
        objective.end_iteration()
        stalled = not ok or not nonzero
    return x, it, float(F)


# ------------------------------------------------------------- the fit
def fit_linear(
    X: torch.Tensor,      # f32[N_pad, d]
    y: torch.Tensor,      # f32[N_pad] labels (class index, 0/1, or regression y)
    w: torch.Tensor,      # f32[N_pad] weights; 0 on padding and filtered rows
    reg_l2: float,
    tol: float,
    max_iter: int,
    col_scale: torch.Tensor | None = None,   # f32[d], folded into the coefficients
    reg_l1: float | None = None,             # L1 strength; None: pure-L2 L-BFGS
    *,
    loss_kind: str,
    k: int,
    fit_intercept: bool = True,
    memory_size: int = 10,
    compute_dtype: str | torch.dtype = torch.float32,
    group=None,
) -> LinearFitResult:
    """The L-BFGS (or, given ``reg_l1``, OWLQN) fit of a linear model.

    MLlib's regParam/elasticNetParam split maps to ``reg_l2 = regParam·(1-α)``
    and ``reg_l1 = regParam·α``; with standardization the L1 applies in the
    scaled space, as in MLlib. ``col_scale`` scales X's columns inside the
    product's coefficient side (X @ (coef·s)), so no scaled copy of X is
    made; the returned coef is the scaled-space coefficient, which callers
    multiply by the scale. ``group``: a gang's data group (X, y, w this
    rank's rows; ``LinearObjective`` folds over the ranks), None for one."""
    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    d, dev = X.shape[1], X.device
    if col_scale is None:
        col_scale = torch.ones((d,), dtype=torch.float32, device=dev)
    objective = LinearObjective(X, y, w, reg_l2, col_scale, loss_kind=loss_kind, k=k,
                                fit_intercept=fit_intercept, compute_dtype=compute_dtype,
                                group=group)
    theta0 = torch.zeros((d * k + k,), dtype=torch.float32, device=dev)
    read = HostReads()
    if reg_l1 is not None:
        # L1 hits the coefficients only, never the intercept (MLlib)
        l1 = torch.cat([torch.full((d * k,), float(_F32(reg_l1)), device=dev),
                        torch.zeros((k,), device=dev)])
        theta, n_iter, final = owlqn_minimize(objective, theta0, l1, tol, max_iter,
                                              memory_size=memory_size, read=read)
    else:
        theta, n_iter, final = lbfgs_minimize(objective, theta0, tol, max_iter,
                                              memory_size=memory_size, read=read)
    coef = theta[: d * k].view(d, k)
    intercept = theta[d * k:] if fit_intercept else torch.zeros((k,), device=dev)
    return LinearFitResult(coef, intercept, n_iter, final, objective.n_evals, read.n,
                           tuple(objective.iter_evals))


def penalties(reg_param: float, elastic_net_param: float) -> tuple[float, float | None]:
    """MLlib's regParam/elasticNetParam as (L2, L1 or None): α = 0 keeps the
    pure-L2 L-BFGS, α > 0 switches to OWLQN."""
    if not 0.0 <= elastic_net_param <= 1.0:
        raise ValueError(f"elastic_net_param must be in [0, 1], got {elastic_net_param}")
    l1 = reg_param * elastic_net_param
    return reg_param * (1.0 - elastic_net_param), (l1 if l1 > 0.0 else None)


def record_fit_counts(model, result: LinearFitResult) -> None:
    """A linear fit's counts on its model: iterations, objective
    evaluations (in all and by iteration) and the minimizer's host reads."""
    model.n_iter_ = result.n_iter
    model.n_evals_ = result.n_evals
    model.iter_evals_ = result.iter_evals
    model.host_reads_ = result.host_reads
