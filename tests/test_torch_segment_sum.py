"""The deterministic segment sum (``ops/segment_sum.py``) and the sums built
on it, on the CPU: the plain version against ``index_add_`` and against the
JAX package's ``_segment_sums`` (XLA's sorted scatter-add), on the same
numpy inputs; the dead segment; empty slots; a long segment; and the CUDA
forms of the dense table gradient and the tree's bucket sums, which run on
the CPU through the plain versions and must give the ``index_add_`` forms'
bits. The kernel itself runs only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).

Tolerances: none on the CPU. ``index_add_`` on the CPU adds a segment's rows
in index order, and so does XLA's sorted scatter-add on one CPU device, so
every comparison here is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.optim import sparse as jsparse
from orange3_spark_tpu_torch.models import _tree
from orange3_spark_tpu_torch.ops import segment_sum as ss
from orange3_spark_tpu_torch.optim import sparse as tsparse


def _sorted_inputs(rng, M, n_dims, k, *, dead=0, long_rows=0, gaps=False):
    """Sorted keys of M occurrences (the last ``dead`` set to the sentinel
    ``n_dims``; ``long_rows`` of them on one key), their stable order, the
    segment ids (with ``gaps``: ids that skip slots) and gradients."""
    keys = rng.integers(0, n_dims, M)
    if long_rows:
        keys[rng.choice(M - dead, long_rows, replace=False)] = n_dims // 2
    if dead:
        keys[M - dead:] = n_dims
    order = np.argsort(keys, kind="stable")
    s = keys[order]
    start = np.ones(M, bool)
    start[1:] = s[1:] != s[:-1]
    seg = np.cumsum(start) - 1
    if gaps:
        seg = seg * 2 + 1        # every other slot, and slot 0, stay empty
    g = rng.standard_normal((M, k)).astype(np.float32)
    return s, seg, g


CASES = [  # (M, n_dims, k, dead, long_rows, gaps, seg dtype)
    (5000, 1 << 12, 1, 0, 0, False, np.int64),
    (5000, 1 << 12, 1, 700, 0, False, np.int64),      # a dead tail segment
    (5000, 1 << 12, 3, 0, 0, True, np.int32),         # empty slots between
    (20_000, 1 << 14, 1, 300, 4096, False, np.int64),  # one long segment
    (20_000, 1 << 10, 2, 0, 0, False, np.int32),      # many rows a segment
]


@pytest.mark.parametrize("M,n_dims,k,dead,long_rows,gaps,dt", CASES)
def test_plain_version_equals_index_add_and_the_reference(M, n_dims, k, dead, long_rows,
                                                         gaps, dt):
    rng = np.random.default_rng(M + k + dead)
    s, seg, g = _sorted_inputs(rng, M, n_dims, k, dead=dead, long_rows=long_rows,
                               gaps=gaps)
    n_slots = int(seg[-1]) + 3
    gt, segt = torch.from_numpy(g), torch.from_numpy(seg.astype(dt))
    got = ss.segment_sum_sorted(gt, segt, n_slots)
    want = torch.zeros((n_slots, k)).index_add_(0, segt.long(), gt)
    assert torch.equal(got, want)
    ref = np.asarray(jsparse._segment_sums(jnp.asarray(g), jnp.asarray(seg), n_slots))
    np.testing.assert_array_equal(got.numpy(), ref)
    empty = np.ones(n_slots, bool)
    empty[seg] = False
    assert (got.numpy()[empty] == 0).all() and not np.signbit(got.numpy()[empty]).any()


@pytest.mark.parametrize("dead", [0, 1, 900])
def test_dead_segment_is_zero_with_keys(dead):
    """Given the flag the sorted keys give (the last key is the sentinel
    n_dims), the dead sentinel's slot holds +0.0 (the kernel skips it;
    nothing reads it); every other slot is the plain sum. Without dead
    rows the flag is false and every slot is the plain sum."""
    rng = np.random.default_rng(dead)
    n_dims = 1 << 10
    s, seg, g = _sorted_inputs(rng, 4000, n_dims, 1, dead=dead)
    n_slots = int(seg[-1]) + 2
    gt, segt, st = (torch.from_numpy(a) for a in (g, seg, s))
    got = ss.segment_sum_sorted(gt, segt, n_slots, skip_last=st[-1:] >= n_dims)
    plain = ss.segment_sum_sorted(gt, segt, n_slots)
    dead_slot = int(seg[-1]) if dead else None
    for j in range(n_slots):
        if j == dead_slot:
            assert got[j].item() == 0.0 and not torch.signbit(got[j]).item()
        else:
            assert torch.equal(got[j], plain[j])


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    g = torch.ones((4, 1))
    seg = torch.tensor([0, 0, 1, 1])
    before = ss.segment_sum_sorted.launches
    assert torch.equal(ss.segment_sum_sorted(g, seg, 3), torch.tensor([[2.0], [2.0], [0.0]]))
    assert ss.segment_sum_sorted.launches == before     # no kernel ran
    with pytest.raises(ValueError, match="no kernel for device"):
        ss.segment_sum_sorted(g.to("meta"), seg.to("meta"), 3)


@pytest.mark.parametrize("N,C,n_rows,k", [(512, 6, 1 << 10, 1), (300, 26, 1 << 12, 1),
                                          (64, 4, 32, 3), (1, 3, 8, 1)])
def test_dense_table_grad_sorted_form_equals_index_add(N, C, n_rows, k):
    """The CUDA form of the dense table gradient (sort, segment sums, one
    write a touched row), run on the CPU, gives ``index_add_``'s bits: a
    row's occurrences are added in occurrence order in both. Padding rows
    (zero gradient) and repeated rows included."""
    rng = np.random.default_rng(N + C)
    idx = torch.from_numpy(rng.integers(0, n_rows, (N, C)).astype(np.int32))
    dl = torch.from_numpy(rng.standard_normal((N, k)).astype(np.float32))
    dl[N // 2:] = 0.0
    want = tsparse.dense_table_grad(idx, dl, n_rows)
    got = tsparse._dense_table_grad_sorted(idx, dl, n_rows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("T,N,s,n_buckets,integer", [(1, 5000, 3, 32, False),
                                                     (4, 3000, 2, 16, True),
                                                     (2, 40, 1, 28, False)])
def test_tree_bucket_sums_histogram_form_equals_index_add(T, N, s, n_buckets, integer):
    """The CUDA form of the tree's leaf sums and importances (the histogram
    of one constant-bin feature), run on the CPU through the histogram's
    plain version, gives the ``index_add_`` form's bits."""
    rng = np.random.default_rng(T * N)
    S = (rng.integers(0, 4, (T, N, s)) if integer
         else rng.standard_normal((T, N, s))).astype(np.float32)
    pos = rng.integers(0, n_buckets, (T, N)).astype(np.int32)
    S, pos = torch.from_numpy(S), torch.from_numpy(pos)
    want = _tree._bucket_sums(S, pos, n_buckets)
    got = _tree._bucket_sums_histogram(S, pos, n_buckets)
    assert got.shape == (T, n_buckets, s)
    assert torch.equal(got, want)


def _rounded_loop(g, seg, n_slots, round_to):
    """Each segment's rows added one at a time in index order, each sum
    rounded to ``round_to``: a sum held in that type."""
    out = torch.zeros((n_slots, g.shape[1]))
    for i in range(g.shape[0]):
        out[seg[i]] = (out[seg[i]] + g[i]).to(round_to).to(torch.float32)
    return out


@pytest.mark.parametrize("round_to", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dead,long_rows,k", [(0, 0, 1), (40, 300, 2)])
def test_rounded_sums_add_in_index_order(round_to, dead, long_rows, k):
    """``round_to``: each add's result rounded to the type, every segment
    (long ones too) in index order, as an add-at-a-time loop gives it; the
    dead segment skipped; float32 (or None) is the plain sum's bits."""
    rng = np.random.default_rng(k + dead)
    _, seg, g = _sorted_inputs(rng, 1500, 1 << 8, k, dead=dead, long_rows=long_rows)
    g, seg = torch.from_numpy(g), torch.from_numpy(seg)
    n_slots = int(seg[-1]) + 3
    want = _rounded_loop(g, seg, n_slots, round_to)
    skip = torch.tensor([dead > 0])
    if dead:
        want[int(seg[-1])] = 0.0
    got = ss.segment_sum_sorted(g, seg, n_slots, skip_last=skip, round_to=round_to)
    assert torch.equal(got, want)
    plain = ss.segment_sum_sorted(g, seg, n_slots, skip_last=skip)
    assert torch.equal(ss.segment_sum_sorted(g, seg, n_slots, skip_last=skip,
                                             round_to=torch.float32), plain)
    assert not torch.equal(got, plain)
    with pytest.raises(ValueError, match="round_to"):
        ss.segment_sum_sorted(g, seg, n_slots, round_to=torch.float64)


@pytest.mark.parametrize("emb_update", ["fused", "per_column", "sorted"])
def test_dense_table_grad_rounded_matches_the_reference_backward(emb_update):
    """The table gradient with ``round_to=bfloat16`` equals the reference's
    gradient through bf16 table rows (jax.grad of its jitted
    ``_hashed_logits`` at compute dtype bf16) bitwise, pairs' values
    included."""
    import jax

    from orange3_spark_tpu.models.hashed_linear import _hashed_logits

    rng = np.random.default_rng(9)
    N, C, D = 400, 4, 1 << 10
    idx = rng.integers(0, 90, (N, C)).astype(np.int32)
    vals = rng.uniform(0.0, 2.0, (N, C)).astype(np.float32)
    ct = (rng.standard_normal((N, 1)) * 0.01).astype(np.float32)
    theta = {"emb": np.zeros((D, 1), np.float32), "coef": np.zeros((0, 1), np.float32),
             "intercept": np.zeros(1, np.float32)}

    def loss(th):
        z = _hashed_logits(th, jnp.zeros((N, 0)), jnp.asarray(idx), jnp.bfloat16, emb_update,
                           jnp.asarray(vals))
        return jnp.sum(z * ct)

    want = np.asarray(jax.jit(jax.grad(loss))(theta)["emb"])
    got = tsparse.dense_table_grad(torch.from_numpy(idx), torch.from_numpy(ct), D,
                                   vals=torch.from_numpy(vals), emb_update=emb_update,
                                   round_to=torch.bfloat16)
    assert np.array_equal(got.numpy(), want)
