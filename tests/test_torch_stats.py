"""XLA:CPU's reduction order, exp and log_softmax written out in the port
(``core/fmath.xla_sum``, ``ops/prng._xla_exp``, ``models/_linear``'s CPU
losses), held bitwise to the one-device reference on seeded inputs.

Every comparison here is of bits: the port's CPU path runs the reference's
float32 steps in its order, so no tolerance applies. The one exception is
named where it is met: XLA fuses the softmax backward's multiply-add by
its vectorisation, which the port copies for the widths measured (k = 2,
3, 7 and the binary form) at these row counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.models import _linear as jlin
from orange3_spark_tpu.ops import stats as jstats
from orange3_spark_tpu_torch.core.fmath import xla_sum
from orange3_spark_tpu_torch.models import _linear as tlin
from orange3_spark_tpu_torch.ops import prng
from orange3_spark_tpu_torch.ops import stats as tstats


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _same_bits(ref, got) -> bool:
    """Equal bit patterns, any NaN equal to any NaN."""
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    both_nan = np.isnan(ref) & np.isnan(got)
    return ref.shape == got.shape and bool(((_bits(ref) == _bits(got)) | both_nan).all())


@pytest.mark.parametrize("n,d", [(2048, 12), (3000, 12), (20000, 8), (200000, 40), (77, 5)])
def test_xla_sum_and_weighted_moments_bitwise_the_reference(n, d):
    """The column sums in XLA:CPU's tree order (windows of 32, the padding
    split evenly): ``weighted_moments``' mean, variance and total weight,
    the 1-D total and the plain column sums, bitwise the reference's jitted
    ones (torch's own CPU sum differs from them at every one of these
    shapes but the smallest)."""
    rng = np.random.default_rng(n + d)
    X = (rng.standard_normal((n, d)) * rng.uniform(0.1, 100.0, d)
         + rng.uniform(-5.0, 5.0, d)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    w[::7] = 0.0                                  # filtered rows
    ref = jstats.weighted_moments(jnp.asarray(X), jnp.asarray(w))
    got = tstats.weighted_moments(torch.from_numpy(X), torch.from_numpy(w))
    for r, g in zip(ref, got):
        assert _same_bits(r, g.numpy())
    assert _same_bits(jnp.sum(jnp.asarray(w)), xla_sum(torch.from_numpy(w)).numpy())
    assert _same_bits(jax.jit(lambda a: jnp.sum(a, axis=0))(X),
                      xla_sum(torch.from_numpy(X)).numpy())


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_xla_sum_over_any_axis(axis):
    """A 3-D array summed over each axis (5,000 rows: a tree; 7 and 3: in
    order) bitwise ``jnp.sum``; an empty axis sums to zeros."""
    X = np.random.default_rng(1).standard_normal((5000, 7, 3)).astype(np.float32)
    ref = jax.jit(lambda a: jnp.sum(a, axis=axis))(X)
    assert _same_bits(ref, xla_sum(torch.from_numpy(X), axis).numpy())
    assert xla_sum(torch.zeros(0, 3)).tolist() == [0.0, 0.0, 0.0]


def test_xla_exp_bitwise_jnp_exp():
    """Cephes' expf with fused multiply-adds: a seeded sample over [-88,
    88], one near each end of the range (where the exponent caps at 127
    and where results flush to 0), and the edges ±88.38, 0, -0, ±inf and
    NaN, bitwise ``jnp.exp`` (torch's CPU exp differs on ~10 %)."""
    rng = np.random.default_rng(0)
    step = np.float32(7.6e-6)
    x = np.concatenate([
        rng.uniform(-88.0, 88.0, 1_000_000),
        np.float32(88.72283935546875) + np.arange(-4000, 4000) * step,
        np.float32(-87.33654475) + np.arange(-4000, 4000) * step,
        [88.38, -88.38, 0.0, -0.0, np.inf, -np.inf, np.nan, 89.0, -103.0, 1e-30],
    ]).astype(np.float32)
    ref = jax.jit(jnp.exp)(x)
    assert _same_bits(ref, prng._xla_exp(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("kind,k", [("logistic", 2), ("logistic", 3), ("logistic", 7),
                                    ("binary_logistic", 1)])
@pytest.mark.parametrize("n", [2048, 20000])
def test_log_softmax_and_its_gradient_bitwise_the_reference(kind, k, n):
    """The CPU losses written out (log_softmax: shifted - log Σ exp,
    the k entries summed in order; the binary form's log1p(exp(-|z|))) and
    their gradient as ``jax.value_and_grad`` steps through the reference's
    loss, times each row's cotangent w·(1/Σw): bitwise. Zero logits (the
    first step of a fit) included."""
    rng = np.random.default_rng(k * 1000 + n)
    z = (rng.standard_normal((n, k)) * 3.0).astype(np.float32)
    z[:5] = 0.0
    y = rng.integers(0, k if k > 1 else 2, n).astype(np.float32)
    ct = (rng.uniform(0.0, 2.0, n) * np.float32(1.0 / n)).astype(np.float32)
    vg = jax.jit(jax.value_and_grad(
        lambda zz, yy, cc: jnp.sum(jlin.per_row_loss(kind, zz, yy) * cc)))
    _, ref_g = vg(z, y, ct)
    ref_l = jax.jit(lambda zz, yy: jlin.per_row_loss(kind, zz, yy))(z, y)
    Z, Y, C = (torch.from_numpy(a) for a in (z, y, ct))
    assert _same_bits(ref_l, tlin.per_row_loss(kind, Z, Y).numpy())
    assert _same_bits(ref_g, tlin.per_row_loss_grad(kind, Z, Y, C).numpy())
