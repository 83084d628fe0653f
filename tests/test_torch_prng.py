"""``ops/prng.py`` against ``jax.random``: the keys and the uniform and
bernoulli draws bitwise, for seeds 0, 1, 42, 2^31-1 and 2^40 (which JAX,
with 64-bit ints off, wraps to 32 bits) and shapes 1 to 4099; a draw of n
rows is the prefix of a draw padded to a multiple of 8 (the partitionable
threefry layout), the property that lets the port pad a table to another
row count than the reference and keep the same rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu_torch.ops import prng

SEEDS = [0, 1, 42, 2**31 - 1, 2**40]
SHAPES = [1, 2, 7, 8, 13, 255, 1024, 4099]


@pytest.mark.parametrize("seed", SEEDS + [-5, 2**32 + 7])
def test_key(seed):
    assert prng.PRNGKey(seed) == tuple(int(w) for w in np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SHAPES)
def test_uniform_and_bernoulli_bitwise(seed, n):
    key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    ref = np.asarray(jax.random.uniform(key, (n,)))
    got = prng.uniform(tkey, n, "cpu").numpy()
    assert got.dtype == np.float32
    assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0
    for p in (0.0, 0.3, 0.5, 1.0 / 3.0, 1.0):
        assert np.array_equal(np.asarray(jax.random.bernoulli(key, p, (n,))),
                              prng.bernoulli(tkey, p, n, "cpu").numpy())
    bits = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
    assert np.array_equal(bits.astype(np.int64), prng.random_bits(tkey, n, "cpu").numpy())


@pytest.mark.parametrize("n", [13, 203, 4099])
def test_padding_keeps_the_prefix(n):
    """The reference pads n rows to a multiple of 8 devices and draws
    n_pad; its first n draws are the port's draw of n."""
    n_pad = -(-n // 8) * 8 + 8
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (n_pad,)))
    assert np.array_equal(ref[:n], prng.uniform(prng.PRNGKey(3), n, "cpu").numpy())


def test_two_dimensional_shape():
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (3, 5)))
    got = prng.uniform(prng.PRNGKey(9), (3, 5), "cpu").numpy()
    assert got.shape == (3, 5) and np.array_equal(ref, got)
