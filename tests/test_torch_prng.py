"""``ops/prng.py`` against ``jax.random``: the keys and the uniform and
bernoulli draws bitwise, for seeds 0, 1, 42, 2^31-1 and 2^40 (which JAX,
with 64-bit ints off, wraps to 32 bits) and shapes 1 to 4099; a draw of n
rows is the prefix of a draw padded to a multiple of 8 (the partitionable
threefry layout), the property that lets the port pad a table to another
row count than the reference and keep the same rows."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


# --------------------------------------------- split and the other draws
def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 20])
def test_split_bitwise(seed, num):
    ref = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = prng.split(prng.PRNGKey(seed), num)
    assert [tuple(int(w) for w in k) for k in ref] == got
    # a chain of splits, as GBT's rounds and Knuth's loop take it
    key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for _ in range(5):
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
    assert tuple(int(w) for w in np.asarray(sub)) == tsub


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
@pytest.mark.parametrize("shape", [(7,), (28, 64), (1000,)])
@pytest.mark.parametrize("bounds", [(-0.3, 0.3), (-1.7, 2.5), (1e-3, 7.0), (-5.0, -4.0)])
def test_bounded_uniform_bitwise(seed, shape, bounds):
    """The fused multiply-add of JAX's bounded uniform, taken in float64
    and rounded once, gives its bits (an f32 multiply then add misses some
    by an ulp)."""
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32, *bounds))
    got = prng.uniform(prng.PRNGKey(seed), shape, "cpu", *bounds).numpy()
    assert got.shape == shape and np.array_equal(ref.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 5, 2**40])
@pytest.mark.parametrize("bounds", [(0, 3), (0, 7), (-5, 1000), (0, 2**31 - 1), (3, 3),
                                    (0, 100_003), (-2**31, 2**31 - 1)])
def test_randint_bitwise(seed, bounds):
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (4099,), *bounds))
    got = prng.randint(prng.PRNGKey(seed), (4099,), *bounds, "cpu").numpy()
    assert got.dtype == np.int32 and np.array_equal(ref, got)


def test_randint_prefix_of_a_padded_draw():
    """CrossValidator draws its fold ids over the reference's padded rows:
    the first n of a padded draw are the draw of n."""
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (1024,), 0, 3))
    assert np.array_equal(ref[:1001], prng.randint(prng.PRNGKey(0), 1001, 0, 3, "cpu").numpy())


@pytest.mark.parametrize("seed", [0, 9, 2**31 - 1])
def test_normal_within_two_ulp(seed):
    """``normal`` writes out XLA's float32 erf_inv (FMA steps) over XLA's
    log1p and log (Cephes' forms, written out): within 2 ulp of JAX's, and
    about 2 draws in 100,000 differ at all."""
    n = 200_000
    key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    ref = np.asarray(jax.random.normal(key, (n,)))
    got = prng.normal(tkey, (n,), "cpu").numpy()
    ulps = _ulps(ref, got)
    assert ulps.max() <= 2 and (ulps > 0).mean() < 1e-4, (ulps.max(), (ulps > 0).mean())
    # the ends: erf_inv(+-1) is +-inf
    ends = prng._erf_inv(torch.tensor([-1.0, 1.0])).numpy()
    assert np.array_equal(ends, [-np.inf, np.inf])


def test_xla_log_and_log1p_bitwise():
    """The written-out XLA float32 ``log`` and ``log1p`` (the draws' own)
    against ``jnp.log`` / ``jnp.log1p`` over (0, 100] and (-1, 1], bitwise,
    and their ends: 0 and denormals -inf, inf, negative and NaN."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-6, 1.0, 100_000), rng.uniform(1.0, 100.0, 20_000),
                        np.exp(rng.uniform(-80.0, 4.0, 20_000))]).astype(np.float32)
    assert np.array_equal(np.asarray(jnp.log(x)), prng._xla_log(torch.from_numpy(x)).numpy())
    z = rng.uniform(-1.0, 1.0, 100_000).astype(np.float32)
    assert np.array_equal(np.asarray(jnp.log1p(z)), prng._xla_log1p(torch.from_numpy(z)).numpy())
    ends = np.array([0.0, -0.0, 1e-40, np.inf, -1.0, np.nan], np.float32)
    np.testing.assert_array_equal(prng._xla_log(torch.from_numpy(ends)).numpy(),
                                  np.asarray(jnp.log(ends)))


def _fma_single_rounding(a, b, c) -> torch.Tensor:
    """float32 a·b + c rounded once from the exact value (a fused
    multiply-add): the float64 product is exact, TwoSum gives the float64
    sum's error e, and a float64 sum that sits exactly on a float32
    midpoint goes to e's side of it."""
    def wide(v):
        return v.to(torch.float64) if torch.is_tensor(v) else float(np.float32(v))
    p = wide(a) * wide(b)
    c = wide(c)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.to(torch.float32)
    other = torch.nextafter(r, torch.where(s > r.to(torch.float64), math.inf, -math.inf)
                            .to(torch.float32))
    at_mid = (s == (r.to(torch.float64) + other.to(torch.float64)) * 0.5) & (e != 0)
    toward_e = torch.sign(other.to(torch.float64) - r.to(torch.float64)) == torch.sign(e)
    return torch.where(at_mid & toward_e, other, r)


def test_fma_single_rounding_catches_double_rounding():
    """The exact multiply-add above against the float64 form on triples
    whose float64 sum lands on a float32 midpoint: (1 + 2^-12)² = 1 +
    2^-11 + 2^-24 lies halfway between two floats, so ± 2^-60 decides the
    rounding, which the float64 sum loses."""
    a = torch.full((2,), 1 + 2.0 ** -12, dtype=torch.float32)
    c = torch.tensor([2.0 ** -60, -(2.0 ** -60)], dtype=torch.float32)
    exact = _fma_single_rounding(a, a, c)
    assert exact.tolist() == [1 + 2.0 ** -11 + 2.0 ** -23, 1 + 2.0 ** -11]
    assert prng._fma32(a, a, c).tolist() == [1 + 2.0 ** -11, 1 + 2.0 ** -11]


def test_gumbel_fma_forms_agree_on_every_uniform(monkeypatch):
    """Every value JAX's gumbel can take: u over all 2^23 uniforms on
    [tiny, 1). The logs' multiply-adds as a float64 product and sum (the
    plain version's form) give the same bits as one single-rounding fused
    multiply-add (``categorical_gumbel``'s kernel's), and as ``jnp.log``:
    so the kernel takes FFMAs and stays bitwise the plain version."""
    k = torch.arange(1, 1 << 23, dtype=torch.int64)
    u = torch.cat([torch.tensor([np.finfo(np.float32).tiny], dtype=torch.float32),
                   (k.to(torch.float64) * 2.0 ** -23).to(torch.float32)])
    wide = -prng._xla_log(-prng._xla_log(u))
    monkeypatch.setattr(prng, "_fma32", _fma_single_rounding)
    single = -prng._xla_log(-prng._xla_log(u))
    ref = np.asarray(-jnp.log(-jnp.log(u.numpy())))
    assert np.array_equal(wide.numpy().view(np.uint32), single.numpy().view(np.uint32))
    assert np.array_equal(wide.numpy().view(np.uint32), ref.view(np.uint32))


def test_gumbel_bucket_table_bounds_every_uniform():
    """``categorical_gumbel``'s skip rests on its table: over all 2^23
    uniforms JAX draws, each bucket's entry is the largest gumbel of the
    words in it (``jnp.log``'s, computed apart from the port's logs), so no
    gumbel exceeds its bucket's bound; the bucket map is non-increasing in
    the word's 23 bits m, covers 0 .. GUMBEL_BUCKETS - 1 and is exact
    (one m a bucket) for the 127 largest m, where the gumbel is steepest."""
    m = torch.arange(1 << 23, dtype=torch.int32)
    bits = m << 9
    u = np.maximum(m.numpy().astype(np.float32) * np.float32(2.0 ** -23),
                   np.finfo(np.float32).tiny)
    g = torch.from_numpy(np.array(-jnp.log(-jnp.log(u))))
    codes = prng.gumbel_bucket(bits)
    table = prng.gumbel_bucket_table("cpu")
    assert table.shape == (prng.GUMBEL_BUCKETS,) and table.dtype == torch.float32
    assert int(codes.min()) == 0 and int(codes.max()) == prng.GUMBEL_BUCKETS - 1
    assert bool((codes[1:] <= codes[:-1]).all())
    assert bool((g <= table[codes]).all())
    want = torch.full_like(table, -math.inf).scatter_reduce_(0, codes, g, "amax")
    assert torch.equal(table, want)
    top = codes[-127:]
    assert torch.unique(top).numel() == 127


@pytest.mark.parametrize("seed", [0, 9])
def test_gumbel_and_categorical(seed):
    """gumbel: -log(-log u) through XLA's log, written out: bitwise;
    categorical: the argmax of gumbel + logits, bitwise."""
    n = 100_000
    key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    ref = np.asarray(jax.random.gumbel(key, (n,)))
    got = prng.gumbel(tkey, (n,), "cpu").numpy()
    assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))
    logits = np.random.default_rng(seed).standard_normal((300, 9)).astype(np.float32)
    logits[:, 4] = -np.inf                       # a masked category is never drawn
    for axis in (-1, 0):
        r = np.asarray(jax.random.categorical(key, jnp.asarray(logits), axis=axis))
        g = prng.categorical(tkey, torch.from_numpy(logits), axis=axis).numpy()
        assert np.array_equal(r, g)
    assert not (prng.categorical(tkey, torch.from_numpy(logits)).numpy() == 4).any()


@pytest.mark.parametrize("lam", [0.0, 0.5, 1.0, 9.5])
def test_poisson_bitwise(lam):
    """Knuth's loop (lam < 10) on JAX's uniforms with XLA's log (the CPU path): every
    count of 200k lanes equals ``jax.random.poisson``; lam == 0 gives 0."""
    n = 200_000
    ref = np.asarray(jax.random.poisson(jax.random.PRNGKey(1), lam, (n,)))
    got = prng.poisson(prng.PRNGKey(1), lam, n, "cpu").numpy()
    assert got.dtype == np.int32 and np.array_equal(ref, got)


def test_poisson_batch_of_keys_as_the_forest_vmaps_it():
    """The forest's draw: ``vmap(poisson)`` over a batch of 4 keys (a chain
    each) is ``poisson_knuth`` of the 4 keys, lane by lane; the first n
    lanes of a padded draw are the draw of n."""
    keys = jax.random.split(jax.random.PRNGKey(6), 4)
    ref = np.asarray(jax.vmap(lambda k: jax.random.poisson(k, 0.8, (5003,)))(keys))
    got = prng.poisson_knuth([tuple(int(w) for w in k) for k in np.asarray(keys)], 0.8,
                             5000, "cpu").numpy()
    assert got.shape == (4, 5000) and np.array_equal(ref[:, :5000], got)


def test_poisson_rejection_branch_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prng.poisson(prng.PRNGKey(0), 10.0, 8, "cpu")


def test_split_chain_table_continues_the_chain():
    """The wrapper's table of ``poisson_knuth``: row j is the j-th subkey
    of ``rng, sub = split(rng)``, and the state after it the chain's key,
    which the kernel splits on for a lane past the table."""
    keys = [prng.PRNGKey(3), prng.PRNGKey(4)]
    table, rng = prng._split_chains(keys, 5)
    for t, key in enumerate(keys):
        for j in range(5):
            key, sub = prng.split(key)
            assert (int(table[t, j, 0]), int(table[t, j, 1])) == sub
        assert (int(rng[t, 0]), int(rng[t, 1])) == key


@pytest.mark.parametrize("lam", [1e-3, 0.8, 1.0, 2.0, 5.0, 9.5])
def test_chain_table_sized_from_lam(lam):
    """``poisson_knuth``'s table at ``lam``: the least J past which a count
    runs with probability below ``CHAIN_PAST_P`` (scipy's Poisson tail)."""
    from scipy.stats import poisson

    J = prng.chain_table_size(lam)
    assert J >= 1 and poisson.sf(J - 1, lam) < prng.CHAIN_PAST_P
    assert J == 1 or poisson.sf(J - 2, lam) >= prng.CHAIN_PAST_P


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_113poisson_knuthILb0EEEvPKjS2_iiixfPiPy
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_3:
        /*0020*/                   IADD3 R2, R2, R3, RZ ;
        /*0030*/              @!P0 BRA `(.L_x_1) ;
        /*0040*/                   MOV R4, R2 ;
        /*0050*/                   CALL.REL.NOINC `(.L_x_9) ;
        /*0060*/                   MOV R2, R4 ;
.L_x_1:
        /*0070*/                   SHF.L.W.U32.HI R3, R3, 0xd, R3 ;
        /*0080*/                   LOP3.LUT R3, R3, R2, RZ, 0x3c, !PT ;
        /*0090*/               @P1 BRA `(.L_x_3) ;
        /*00a0*/                   STG.E [R4.64], R2 ;
        /*00b0*/                   EXIT ;
.L_x_4:
        /*00c0*/                   BRA `(.L_x_4);
.L_x_9:
        /*00d0*/                   IADD3 R4, R4, 0x1, RZ ;
        /*00e0*/                   LOP3.LUT R5, R4, R5, RZ, 0x3c, !PT ;
        /*00f0*/                   RET.REL.NODEC R20 `(_ZN12_GLOBAL__N_113poisson_knuthILb0EEEvPKjS2_iiixfPiPy) ;
        /*0100*/                   NOP;
\t\tFunction : _ZN12_GLOBAL__N_113threefry_bitsEjjxPj
        /*0000*/                   EXIT ;
"""


def test_sass_loop_counts_a_pass_without_the_call():
    """``chip_smoke.sass_loop``, the yardstick of ``poisson_knuth``'s bound:
    a cuobjdump listing's labels resolve to addresses, the longest backward
    branch spans the loop, and the block that calls out of line (the split
    past the table) and the NOP padding are left out of a pass; the call's
    own instructions, its callee in the caller's listing, up to its RET."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    funcs = smoke.sass_functions(_SASS)
    assert len(funcs) == 2
    kernel = funcs["_ZN12_GLOBAL__N_113poisson_knuthILb0EEEvPKjS2_iiixfPiPy"]
    assert [a for a, _, _ in kernel][:3] == [0x0, 0x10, 0x20]
    loop = smoke.sass_loop(kernel)
    assert loop["span"] == ["0x20", "0x90"] and loop["call_blocks_left_out"] == 1
    assert loop["instructions"] == 5
    assert loop["opcodes"] == {"IADD3": 1, "BRA": 2, "SHF": 1, "LOP3": 1}
    assert smoke.sass_callee(funcs, kernel, loop["calls"][0]) == 3


_SASS_NESTED = """
\t\tFunction : knuth_work
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0010*/                   IADD3 R2, R0, R5, RZ ;
        /*0020*/                   MOV R3, RZ ;
.L_x_1:
        /*0030*/                   LDG.E.64 R6, [R8.64] ;
        /*0040*/                   LOP3.LUT R6, R6, R2, RZ, 0x3c, !PT ;
        /*0050*/                   FADD R3, R3, R6 ;
        /*0060*/                   FSETP.GT.AND P0, PT, R3, R4, PT ;
        /*0070*/               @P0 BRA `(.L_x_1) ;
        /*0080*/                   STG.E [R10.64], R2 ;
        /*0090*/                   IADD3 R0, R0, 0x100, RZ ;
        /*00a0*/                   ISETP.GE.AND P1, PT, R0, R12, PT ;
        /*00b0*/              @!P1 BRA `(.L_x_0) ;
        /*00c0*/                   EXIT ;
.L_x_2:
        /*00d0*/                   BRA `(.L_x_2);
        /*00e0*/                   NOP;
"""


def test_sass_loop_innermost_counts_the_inner_pass():
    """``chip_smoke.sass_loop`` over a loop in a loop (``knuth_work``'s
    shape, the yardstick of ``poisson_knuth``'s work): the longest
    backward branch spans a row, ``innermost`` an iteration, and the
    function's closing branch to itself is no loop."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    insns = smoke.sass_functions(_SASS_NESTED)["knuth_work"]
    rows, iters = smoke.sass_loop(insns), smoke.sass_loop(insns, innermost=True)
    assert rows["span"] == ["0x10", "0xb0"] and rows["instructions"] == 11
    assert iters["span"] == ["0x30", "0x70"] and iters["instructions"] == 5
    assert iters["opcodes"] == {"LDG": 1, "LOP3": 1, "FADD": 1, "FSETP": 1, "BRA": 1}
