"""The port's node×bin histogram (orange3_spark_tpu_torch/ops/histogram.py)
against the JAX package's segment_sum path and its Pallas kernel run in
interpret mode, on the same numpy inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orange3_spark_tpu.ops.histogram import _hist_pallas, _hist_xla
from orange3_spark_tpu_torch.ops import histogram as th


def _inputs(rng, n, d, s, nodes, n_bins, T=None):
    B = rng.integers(0, n_bins, (n, d)).astype(np.int32)
    lead = () if T is None else (T,)
    S = rng.standard_normal(lead + (n, s)).astype(np.float32)
    pos = rng.integers(0, nodes, lead + (n,)).astype(np.int32)
    return B, S, pos


def _port(B, S, pos, **kw):
    return th.node_histograms(torch.from_numpy(B), torch.from_numpy(S),
                              torch.from_numpy(pos), **kw).numpy()


@pytest.mark.parametrize("seed", range(8))
def test_plain_matches_xla_and_pallas_randomized(seed):
    """The randomized-shape sweep of tests/test_histogram.py (ragged row
    counts, odd feature counts, single node / single stat), port vs both
    JAX paths."""
    rng = np.random.default_rng(100 + seed)
    nodes = int(rng.choice([1, 2, 3, 5, 8]))
    n_bins = int(rng.choice([4, 8, 16, 32, 64]))
    s = int(rng.integers(1, 6))
    n = int(rng.integers(1, 3000))
    d = int(rng.integers(1, 9))
    B, S, pos = _inputs(rng, n, d, s, nodes, n_bins)
    kw = dict(nodes=nodes, n_bins=n_bins)
    got = _port(B, S, pos, **kw)
    ref = _hist_xla(jnp.asarray(B), jnp.asarray(S), jnp.asarray(pos), **kw)
    pal = _hist_pallas(jnp.asarray(B), jnp.asarray(S), jnp.asarray(pos),
                       interpret=True, **kw)
    msg = f"shape=({nodes},{n_bins},{s},{n},{d})"
    assert got.shape == (d, nodes * n_bins, s)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-4,
                               err_msg=msg)
    np.testing.assert_allclose(got, np.asarray(pal), rtol=1e-5, atol=1e-4,
                               err_msg=msg)


def test_plain_bitwise_on_integer_stats():
    """Small-integer stats (random-forest class counts) sum exactly in any
    order, so the port equals the reference bit for bit."""
    rng = np.random.default_rng(3)
    n, d, s, nodes, n_bins = 2500, 6, 2, 4, 32
    B, _, pos = _inputs(rng, n, d, s, nodes, n_bins)
    S = rng.integers(0, 4, (n, s)).astype(np.float32)
    kw = dict(nodes=nodes, n_bins=n_bins)
    got = _port(B, S, pos, **kw)
    ref = np.asarray(_hist_xla(jnp.asarray(B), jnp.asarray(S),
                               jnp.asarray(pos), **kw))
    np.testing.assert_array_equal(got, ref)


def test_zero_weight_rows_ignored():
    rng = np.random.default_rng(1)
    n, d, s, n_bins = 512, 3, 2, 8
    B, S, _ = _inputs(rng, n, d, s, 1, n_bins)
    S[100:] = 0.0  # dead rows carry zero stats
    pos = np.zeros(n, np.int32)
    got = _port(B, S, pos, nodes=1, n_bins=n_bins)
    ref = _hist_xla(jnp.asarray(B[:100]), jnp.asarray(S[:100]),
                    jnp.asarray(pos[:100]), nodes=1, n_bins=n_bins)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_batched_trees_share_B():
    """Forests: one B for all trees, per-tree stats and positions; the port's
    tree axis against jax.vmap of the reference over (S, pos)."""
    rng = np.random.default_rng(2)
    T, n, d, s, n_bins, nodes = 3, 1200, 4, 2, 8, 2
    B, S, pos = _inputs(rng, n, d, s, nodes, n_bins, T=T)
    got = _port(B, S, pos, nodes=nodes, n_bins=n_bins)
    g = functools.partial(_hist_xla, nodes=nodes, n_bins=n_bins)
    ref = jax.vmap(g, in_axes=(None, 0, 0))(
        jnp.asarray(B), jnp.asarray(S), jnp.asarray(pos))
    assert got.shape == (T, d, nodes * n_bins, s)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(4)
    B, S, pos = _inputs(rng, 64, 3, 2, 2, 8)
    before = th.node_histograms.launches
    got = _port(B, S, pos, nodes=2, n_bins=8)
    ref = th.node_histograms_reference(
        torch.from_numpy(B), torch.from_numpy(S), torch.from_numpy(pos),
        nodes=2, n_bins=8).numpy()
    np.testing.assert_array_equal(got, ref)
    assert th.node_histograms.launches == before


@pytest.mark.parametrize("s,nodes,group", [(3, 16, 7), (2, 16, 11), (3, 1, 28)])
def test_launch_shape_at_higgs_width(s, nodes, group):
    """At HIGGS width (d=28, 32 bins) a block's shared histogram of `group`
    features stays within 48 KB, and the blocks fill one wave of 4 per SM."""
    N, d, n_bins, sms = 10_737_856, 28, 32, 132
    T = 20 if s == 2 else 1
    g, row_tiles = th.launch_shape(N, d, s, T, nodes, n_bins, sms)
    assert g == group
    assert g * (nodes * n_bins * s + 1) * 4 <= 48 * 1024
    n_groups = -(-d // g)
    assert 4 * sms - n_groups * T < row_tiles * n_groups * T <= 4 * sms


def test_kernel_wrapper_rejects_bad_inputs():
    """The CUDA wrapper checks dtype, contiguity and shapes before it touches
    the device."""
    B = torch.zeros((10, 3), dtype=torch.int64)
    S = torch.zeros((1, 10, 2))
    pos = torch.zeros((1, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="B must be"):
        th._node_histograms_cuda(B, S, pos, nodes=1, n_bins=4)
    with pytest.raises(ValueError, match="do not agree"):
        th._node_histograms_cuda(B.int(), S, pos[:, :5].contiguous(),
                                 nodes=1, n_bins=4)
