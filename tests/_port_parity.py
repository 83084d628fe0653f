"""Helpers of the port's parity tests: the JAX package's values and the
PyTorch package's on the host, and their comparison (``to_np``,
``assert_port_equal``); and the two packages' minimizer runs side by side,
on the CPU, which the tests of the linear family and PERF.md read:

- ``dense_logreg_evals``: objective evaluations by iteration on
  ``bench.py --config dense_logreg``'s data (``default_rng(0)``, its
  labels; 4,000,000 rows there, cut here to ``rows``), reg 1e-6, tol 0:
  the reference's ``lbfgs_minimize`` (its ``value_fn`` calls, counted by a
  debug callback) and the port's ``fit_linear`` (``iter_evals``).
- ``owlqn_trace``: the reference's ``owlqn_minimize`` at a tol, its
  ``n_iter`` and the pseudo-gradient norm after each iteration (a
  custom-VJP tap hands each gradient evaluation's point and gradient to
  the host), beside the port's CPU run of the same fit, traced by
  ``probes/owlqn_trace.py`` (which also traces it on the card).

Run as a script on the CPU, where both packages run, it prints both:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_port_parity.py [--rows 200000]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orange3_spark_tpu.models import _linear as jlin
from orange3_spark_tpu_torch.models import _linear as tlin


def to_np(x) -> np.ndarray:
    """A ``jax.Array``, a ``torch.Tensor`` (any device) or anything numpy
    takes, as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_port_equal(jax_val, torch_val, *, rtol: float = 0.0, atol: float = 0.0,
                      what: str = "") -> None:
    """The port's value equals the reference's: exactly by default (NaNs
    in the same places), else |port - ref| <= atol + rtol·|ref| everywhere.
    A failure names the worst element, its index and both values."""
    ref, got = to_np(jax_val), to_np(torch_val)
    assert ref.shape == got.shape, f"{what} shape {got.shape} != reference {ref.shape}"
    ref64, got64 = ref.astype(np.float64), got.astype(np.float64)
    same = (ref64 == got64) | (np.isnan(ref64) & np.isnan(got64))
    err = np.where(same, 0.0, np.abs(got64 - ref64))
    err = np.where(np.isnan(err), np.inf, err)
    # an element equal to the reference (NaN to NaN, inf to inf) passes; any
    # other NaN, inf or difference past the tolerance fails, so that one NaN
    # in the reference cannot turn the maximum below into NaN
    excess = np.where(same, -np.inf, err - (atol + rtol * np.abs(ref64)))
    excess = np.where(np.isnan(excess), np.inf, excess)
    if ref.size and excess.max() > 0:
        i = np.unravel_index(int(np.argmax(excess)), ref.shape)
        raise AssertionError(
            f"{what} differs from the reference at {tuple(int(j) for j in i)}: port "
            f"{got[i]!r}, reference {ref[i]!r}, |err| {err[i]:.3g} > atol {atol:g} + "
            f"rtol {rtol:g}·|ref| ({int((excess > 0).sum())} of {ref.size} elements)")


def sign_aligned(ref, got) -> np.ndarray:
    """``got`` with each column negated where that aligns it with ``ref``'s
    column (the sign of an eigenvector is arbitrary: LAPACK, jaxlib and
    cuSOLVER may each return a principal component negated)."""
    ref, got = to_np(ref).astype(np.float64), to_np(got).astype(np.float64)
    s = np.sign(np.sum(ref * got, axis=0))
    return got * np.where(s == 0, 1.0, s)


def assert_columns_equal_up_to_sign(jax_val, torch_val, *, rtol: float = 0.0,
                                    atol: float = 0.0, what: str = "") -> None:
    """``assert_port_equal`` after aligning each of the port's columns' sign
    with the reference's: for principal components and projections on
    them."""
    ref = to_np(jax_val)
    assert_port_equal(ref, sign_aligned(ref, torch_val).astype(ref.dtype), rtol=rtol,
                      atol=atol, what=what)


# ------------------------------------------------- the minimizers side by side
DENSE_LOGREG_REG = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dense_logreg_data(rows: int, features: int = 40):
    """bench_dense_logreg's X and labels, cut to ``rows``."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((rows, features), dtype=np.float32)
    true_w = rng.standard_normal((features,)).astype(np.float32)
    y = (X @ true_w + 0.5 * rng.standard_normal(rows).astype(np.float32) > 0)
    return X, y.astype(np.float32)


def reference_lbfgs_evals(X, y, dtype: str, max_iters) -> dict:
    """The reference's value_fn calls in an L-BFGS fit of ``max_iter``
    iterations, for each of ``max_iters`` (one compiled program; each run
    starts from zero and repeats the shorter ones' iterations)."""
    calls = [0]

    def bump():
        calls[0] += 1

    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    wj = jnp.ones_like(yj)
    scale = jlin.column_inv_std(Xj, wj)
    sum_w = jnp.maximum(wj.sum(), jlin.EPS_TOTAL_WEIGHT)
    objective = jlin._make_objective("logistic", True, jnp.dtype(dtype))

    def value_fn(theta):
        jax.debug.callback(bump)
        return objective(theta, Xj, yj, wj, jnp.float32(DENSE_LOGREG_REG), sum_w, scale)

    d = X.shape[1]
    theta0 = {"coef": jnp.zeros((d, 2)), "intercept": jnp.zeros((2,))}
    fit = jax.jit(lambda m: jlin.lbfgs_minimize(value_fn, theta0, jnp.float32(0.0), m))
    out = {}
    for m in max_iters:
        calls[0] = 0
        theta, n_iter, value = fit(jnp.int32(m))
        jax.block_until_ready(theta)
        out[m] = {"n_iter": int(n_iter), "evals": calls[0], "loss": float(value)}
    return out


def port_lbfgs_fit(X, y, dtype: str, max_iter: int) -> tlin.LinearFitResult:
    """The port's CPU fit of the same objective."""
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    w = torch.ones_like(yt)
    return tlin.fit_linear(Xt, yt, w, DENSE_LOGREG_REG, 0.0, max_iter,
                           tlin.column_inv_std(Xt, w), loss_kind="logistic", k=2,
                           compute_dtype=dtype)


def dense_logreg_evals(rows: int, dtype: str, max_iter: int = 20) -> dict:
    """Evaluations by iteration, the reference's and the port's."""
    X, y = dense_logreg_data(rows)
    ref = reference_lbfgs_evals(X, y, dtype, range(1, max_iter + 1))
    cum = [ref[m]["evals"] for m in range(1, max_iter + 1)]
    got = port_lbfgs_fit(X, y, dtype, max_iter)
    return {"rows": rows, "dtype": dtype, "max_iter": max_iter,
            "reference_evals": cum[-1],
            "reference_iter_evals": [cum[0]] + [b - a for a, b in zip(cum, cum[1:])],
            "port_evals": got.n_evals, "port_iter_evals": list(got.iter_evals),
            "reference_loss": ref[max_iter]["loss"], "port_loss": got.final_loss}


def _owlqn_probe():
    """``probes/owlqn_trace.py``, the port's side of the OWLQN trace."""
    spec = importlib.util.spec_from_file_location(
        "owlqn_trace", os.path.join(ROOT, "probes", "owlqn_trace.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_owlqn_trace(X, y, w, k, reg_l2, reg_l1, tol, max_iter, scale=True) -> dict:
    """The reference's OWLQN fit, as its ``fit_linear`` runs it, with the
    pseudo-gradient norm at the start and after each iteration (the points
    where it takes the smooth gradient)."""
    from jax.flatten_util import ravel_pytree

    seen = []

    @jax.custom_vjp
    def tap(x):
        return x

    def tap_bwd(x, g):
        jax.debug.callback(lambda a, b: seen.append((np.asarray(a), np.asarray(b))), x, g,
                           ordered=True)
        return (g,)

    tap.defvjp(lambda x: (x, x), tap_bwd)
    Xj, yj, wj = jnp.asarray(X), jnp.asarray(y), jnp.asarray(w)
    d = X.shape[1]
    col_scale = jlin.column_inv_std(Xj, wj) if scale else jnp.ones((d,), jnp.float32)
    sum_w = jnp.maximum(wj.sum(), jlin.EPS_TOTAL_WEIGHT)
    objective = jlin._make_objective("logistic", True, jnp.float32)
    x0, unravel = ravel_pytree({"coef": jnp.zeros((d, k), jnp.float32),
                                "intercept": jnp.zeros((k,), jnp.float32)})
    l1, _ = ravel_pytree({"coef": jnp.full((d, k), reg_l1, jnp.float32),
                          "intercept": jnp.zeros((k,), jnp.float32)})

    def smooth(x):
        return objective(unravel(tap(x)), Xj, yj, wj, jnp.float32(reg_l2), sum_w, col_scale)

    fit = jax.jit(lambda: jlin.owlqn_minimize(smooth, x0, l1, jnp.float32(tol),
                                               jnp.int32(max_iter)))
    x, n_iter, F = fit()
    jax.block_until_ready(x)
    probe, l1h = _owlqn_probe(), np.asarray(l1)
    return {"device": "reference (JAX, CPU)", "tol": tol, "max_iter": max_iter,
            "n_iter": int(n_iter), "loss": float(F),
            "zeros": int((np.asarray(x)[:d * k] == 0).sum()),
            "pg_norms": [probe.pseudo_grad_norm(a, b, l1h) for a, b in seen],
            "iterate_last_moved_at_iter": probe.last_move([a for a, _ in seen])}


def owlqn_trace(tol: float, max_iter: int) -> tuple[dict, dict]:
    """The reference's and the port's CPU OWLQN fit of
    ``probes/owlqn_trace.py`` (``make_classification(2048, 12, 3, seed=1)``,
    reg_l2 1e-2, L1 0.05, the column scale)."""
    from orange3_spark_tpu_torch.core.session import TorchSession
    from orange3_spark_tpu_torch.datasets import make_classification

    table = make_classification(2048, 12, 3, seed=1, session=TorchSession("cpu"))
    X, y, w = (v.numpy() for v in (table.X, table.y, table.W))
    return (reference_owlqn_trace(X, y, w, 3, 1e-2, 0.05, tol, max_iter),
            _owlqn_probe().trace("cpu", tol, max_iter))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=200_000,
                    help="rows of the dense_logreg data (bench.py: 4,000,000)")
    args = ap.parse_args(argv)
    for dtype in ("bfloat16", "float32"):
        print(json.dumps({"dense_logreg_evals": dense_logreg_evals(args.rows, dtype)}),
              flush=True)
    probe = _owlqn_probe()
    for tol in (1e-5, 1e-6):
        for line in owlqn_trace(tol, 300):
            print(json.dumps({"owlqn_trace": probe.summary(line)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
