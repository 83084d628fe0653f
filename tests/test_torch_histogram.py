"""The port's node×bin histogram (orange3_spark_tpu_torch/ops/histogram.py)
against the JAX package's segment_sum path and its Pallas kernel run in
interpret mode, on the same numpy inputs, and the kernel's launch plan."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
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


def test_plain_sums_float64_stats_in_double():
    """float64 stats give float64 histograms summed in double, the reference
    the kernel's fixed point is held to per stat: regression stats
    [y, y², 1] with y in [1e4, 1e5] against numpy's float64 sums, and in
    float32 against the JAX path."""
    rng = np.random.default_rng(9)
    n, d, nodes, n_bins = 3000, 4, 2, 8
    B, _, pos = _inputs(rng, n, d, 1, nodes, n_bins)
    y = rng.uniform(1e4, 1e5, n)
    S = np.stack([y, y * y, np.ones(n)], axis=1)
    got = th.node_histograms_reference(torch.from_numpy(B), torch.from_numpy(S),
                                       torch.from_numpy(pos), nodes=nodes, n_bins=n_bins)
    assert got.dtype == torch.float64
    exact = np.zeros((d, nodes * n_bins, 3))
    for j in range(d):
        np.add.at(exact[j], pos * n_bins + B[:, j], S)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-12)
    ref = _hist_xla(jnp.asarray(B), jnp.asarray(S.astype(np.float32)), jnp.asarray(pos),
                    nodes=nodes, n_bins=n_bins)
    np.testing.assert_allclose(np.asarray(ref), exact, rtol=1e-5, atol=1e-4)


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


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("integer", [False, True])
def test_uint8_bins_equal_int32_bins(seed, integer):
    """uint8 B gives the int32 histograms, bit for bit, through
    node_histograms on the CPU; 256 bins with s = 3 would wrap if the bins
    were not widened before B·s."""
    rng = np.random.default_rng(200 + seed)
    n, d, s = int(rng.integers(1, 3000)), int(rng.integers(1, 9)), 3
    nodes, n_bins = int(rng.choice([1, 2, 5])), int(rng.choice([8, 32, 256]))
    T = int(rng.choice([1, 3]))
    B, S, pos = _inputs(rng, n, d, s, nodes, n_bins, T=T)
    if integer:
        S = rng.integers(0, 4, S.shape).astype(np.float32)
    kw = dict(nodes=nodes, n_bins=n_bins)
    got = _port(B.astype(np.uint8), S, pos, **kw)
    ref = _port(B, S, pos, **kw)
    np.testing.assert_array_equal(got, ref)


def _masked(rng, T, d):
    keep = rng.random((T, d)) < 0.4
    keep[:, 0] = rng.random(T) < 0.5   # the caller may drop feature 0
    return keep


@pytest.mark.parametrize("seed", range(6))
def test_masked_features_match_xla_and_pallas(seed):
    """With a per-tree feature mask, the kept features and feature 0 (always
    built) equal both JAX paths on the same inputs; the other features are
    exactly zero. uint8 and int32 B alike."""
    rng = np.random.default_rng(300 + seed)
    nodes = int(rng.choice([1, 2, 4, 8]))
    n_bins = int(rng.choice([8, 16, 32]))
    s, T = int(rng.integers(1, 4)), int(rng.choice([1, 2, 4]))
    n, d = int(rng.integers(1, 2500)), int(rng.integers(2, 12))
    B, S, pos = _inputs(rng, n, d, s, nodes, n_bins, T=T)
    keep = _masked(rng, T, d)
    kw = dict(nodes=nodes, n_bins=n_bins)
    feats = torch.from_numpy(keep.astype(np.float32) if seed % 2 else keep)
    got = _port(B, S, pos, features=feats, **kw)
    got8 = _port(B.astype(np.uint8), S, pos, features=feats, **kw)
    np.testing.assert_array_equal(got8, got)
    built = keep.copy()
    built[:, 0] = True
    for t in range(T):
        args = (jnp.asarray(B), jnp.asarray(S[t]), jnp.asarray(pos[t]))
        ref = np.asarray(_hist_xla(*args, **kw))
        pal = np.asarray(_hist_pallas(*args, interpret=True, **kw))
        msg = f"tree {t}, shape=({nodes},{n_bins},{s},{n},{d})"
        np.testing.assert_allclose(got[t][built[t]], ref[built[t]], rtol=1e-5,
                                   atol=1e-4, err_msg=msg)
        np.testing.assert_allclose(got[t][built[t]], pal[built[t]], rtol=1e-5,
                                   atol=1e-4, err_msg=msg)
        assert not got[t][~built[t]].any(), msg


def test_masked_features_bitwise_on_integer_stats():
    rng = np.random.default_rng(7)
    T, n, d, s, nodes, n_bins = 3, 2000, 7, 2, 4, 32
    B, _, pos = _inputs(rng, n, d, s, nodes, n_bins, T=T)
    S = rng.integers(0, 4, (T, n, s)).astype(np.float32)
    keep = _masked(rng, T, d)
    got = _port(B.astype(np.uint8), S, pos, nodes=nodes, n_bins=n_bins,
                features=torch.from_numpy(keep))
    keep[:, 0] = True
    for t in range(T):
        ref = np.asarray(_hist_xla(jnp.asarray(B), jnp.asarray(S[t]),
                                   jnp.asarray(pos[t]), nodes=nodes, n_bins=n_bins))
        np.testing.assert_array_equal(got[t][keep[t]], ref[keep[t]])
        assert not got[t][~keep[t]].any()


def test_single_tree_mask_and_kept_features():
    """A single tree takes a [d] mask; kept_features always keeps feature 0
    and leaves the caller's mask as it was."""
    rng = np.random.default_rng(8)
    B, S, pos = _inputs(rng, 300, 5, 2, 2, 8)
    mask = torch.tensor([0.0, 1.0, 0.0, 0.0, 1.0])
    got = _port(B, S, pos, nodes=2, n_bins=8, features=mask)
    full = _port(B, S, pos, nodes=2, n_bins=8)
    np.testing.assert_array_equal(got[[0, 1, 4]], full[[0, 1, 4]])
    assert not got[[2, 3]].any()
    keep = th.kept_features(mask, 1, 5)
    assert keep.tolist() == [[True, True, False, False, True]]
    assert mask[0] == 0.0


# (s, nodes, T, B bytes) -> (group, tile rows, stages, blocks per SM)
_SHAPES = {
    (3, 16, 1, 1): (28, 512, 2, 1),    # GBT level 4: all 28 features, one pass
    (2, 16, 20, 1): (28, 1024, 2, 1),  # RF level 4: a row for each of 1024 threads
    (3, 1, 1, 1): (28, 512, 4, 2),     # GBT level 0: two blocks an SM, a deep ring
    (2, 1, 20, 1): (28, 512, 4, 2),    # RF level 0: the same plan
    (3, 16, 1, 4): (28, 128, 3, 1),    # int32 B: smaller tiles, still one pass
    (3, 32, 1, 1): (14, 512, 2, 1),    # deeper than the fits: two groups
}


@pytest.mark.parametrize("key", list(_SHAPES), ids=str)
def test_launch_shape_at_higgs_width(key):
    """At HIGGS width (d=28, 32 bins) the features go in as few groups as
    fit, a block's shared memory (the staging ring included) stays within
    227 KB and its SM's 228 KB, and the blocks fill one wave on the SMs."""
    s, nodes, T, b_bytes = key
    N, d, n_bins, sms = 10_737_856, 28, 32, 132
    shape = th.launch_shape(N, d, s, T, nodes, n_bins, sms, b_bytes)
    assert (shape.group, shape.tile_rows, shape.stages,
            shape.blocks_per_sm) == _SHAPES[key]
    assert shape.smem_bytes == th.smem_bytes(d, s, nodes, n_bins, b_bytes, shape.group,
                                             shape.tile_rows, shape.stages)
    assert shape.smem_bytes <= 232_448
    assert shape.blocks_per_sm * (shape.smem_bytes + 1024) <= 233_472
    # a row a thread at most; the SM's 2048 threads and 64 registers each
    assert shape.tile_rows <= shape.threads
    assert shape.blocks_per_sm * shape.threads <= 2048
    # the group's cells: the histogram itself fits
    cstride = (nodes * n_bins) | 1
    assert shape.group * ((s * cstride) | 1) * 4 <= 232_448
    lanes = T * -(-d // shape.group)
    blocks = lanes * shape.row_blocks
    wave = shape.blocks_per_sm * sms
    assert wave - lanes < blocks <= wave


def test_launch_shape_small_inputs():
    """Few rows: no more row blocks than tiles; one feature too big for
    shared memory raises."""
    shape = th.launch_shape(1000, 28, 3, 1, 1, 32, 132)
    assert shape.row_blocks == -(-1000 // shape.tile_rows)
    with pytest.raises(ValueError, match="does not fit"):
        th.launch_shape(1000, 4, 3, 1, 1024, 32, 132)


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
    with pytest.raises(ValueError, match="features must be"):
        th._node_histograms_cuda(B.to(torch.uint8), S, pos, nodes=1, n_bins=4,
                                 features=torch.ones(4))
