"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against their
plain PyTorch versions on the card. They import neither JAX nor the JAX
package, so they run on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX.) Without a
CUDA device every test here skips with its reason.
"""

import numpy as np
import pytest
import torch

from orange3_spark_tpu_torch.datasets import make_higgs_proxy
from orange3_spark_tpu_torch.models import _tree
from orange3_spark_tpu_torch.models.random_forest import grow_forest
from orange3_spark_tpu_torch.ops import histogram as th


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py also holds it to the plain version on the card)")
    return torch.device("cuda")


def _inputs(rng, n, d, s, T, nodes, n_bins, integer):
    B = rng.integers(0, n_bins, (n, d)).astype(np.int32)
    pos = rng.integers(0, nodes, (T, n)).astype(np.int32)
    if integer:   # forest gini stats: a class one-hot times a Poisson weight
        cls = rng.integers(0, s, (T, n))
        S = (np.eye(s, dtype=np.float32)[cls]
             * rng.poisson(1.0, (T, n, 1)).astype(np.float32))
    else:
        S = rng.standard_normal((T, n, s)).astype(np.float32)
    return B, S, pos


def _agree(got, args, integer, **kw):
    """Bitwise against the plain version for integer stats. For float stats,
    each stat within 1e-5 of its own max|H| of the plain version summed in
    float64 (fp32 atomics would round in a run-dependent order, and one
    tolerance over all stats would hide a small stat beside a large one)."""
    B, S, pos = args
    if integer:
        return torch.equal(got, th.node_histograms_reference(B, S, pos, **kw))
    ref = th.node_histograms_reference(B, S.double(), pos, **kw)
    err = (got.double() - ref).abs().amax(dim=tuple(range(ref.ndim - 1)))
    return bool((err <= 1e-5 * ref.abs().amax(dim=tuple(range(ref.ndim - 1)))).all())


# (T, s, nodes, integer, d, uint8 bins, masked)
_CASES = [(1, 3, 16, False, 28, False, False), (20, 2, 16, True, 28, False, False),
          (1, 3, 1, False, 28, False, False), (3, 5, 3, False, 28, False, False),
          (1, 3, 16, False, 28, True, False), (20, 2, 16, True, 28, True, True),
          (4, 3, 8, False, 28, True, True), (1, 3, 1, False, 40, True, False),
          (2, 2, 4, True, 40, False, True)]
# every level of both fits: GBT (T=1, s=3, no mask), RF (T=20, s=2, masks)
_CASES += [(1, 3, 2**lv, False, 28, True, False) for lv in range(5)]
_CASES += [(20, 2, 2**lv, True, 28, True, True) for lv in range(5)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,s,nodes,integer,d,uint8,masked", _CASES)
def test_kernel_matches_plain_on_cuda(cuda_device, T, s, nodes, integer, d, uint8,
                                      masked):
    """The kernel against the plain version on the card, uint8 and int32
    bins, with and without per-tree masks (feature 0 dropped from some
    trees' lists: it is built all the same)."""
    rng = np.random.default_rng(5)
    n, n_bins = 50_001, 32
    B, S, pos = _inputs(rng, n, d, s, T, nodes, n_bins, integer)
    if uint8:
        B = B.astype(np.uint8)
    args = [torch.from_numpy(x).to(cuda_device) for x in (B, S, pos)]
    features = None
    if masked:
        keep = rng.random((T, d)) < 0.19
        keep[: T // 2 + 1, 0] = False
        features = torch.from_numpy(keep).to(cuda_device)
    before = th.node_histograms.launches
    got = th.node_histograms(*args, nodes=nodes, n_bins=n_bins, features=features)
    torch.cuda.synchronize()
    assert th.node_histograms.launches == before + -(-s // 4)   # four stats a launch
    assert _agree(got, args, integer, nodes=nodes, n_bins=n_bins, features=features)
    if masked:
        built = th.kept_features(features, T, d)
        assert built[:, 0].all() and not got[~built].any()


@pytest.mark.cuda
def _fixed_point_bound_holds(cuda_device, B, S, pos, nodes, n_bins):
    """The kernel's sums are the same on every run and within
    n·2^(e_c-25) + one fp32 rounding of the float64 sums (max|S[..., c]| <
    2^e_c, n the adds into a cell)."""
    n, d = B.shape
    s = S.shape[2]
    args = [torch.from_numpy(x).to(cuda_device) for x in (B.astype(np.uint8), S, pos)]
    got = th.node_histograms(*args, nodes=nodes, n_bins=n_bins)
    again = th.node_histograms(*args, nodes=nodes, n_bins=n_bins)
    assert torch.equal(got, again)
    key = torch.from_numpy(pos[0, :, None] * n_bins + B).long()    # [n, d]
    exact = torch.zeros((d, nodes * n_bins, s), dtype=torch.float64)
    count = torch.zeros((d, nodes * n_bins), dtype=torch.float64)
    S64 = torch.from_numpy(S[0]).double()
    for j in range(d):
        exact[j].index_add_(0, key[:, j], S64)
        count[j].index_add_(0, key[:, j], torch.ones(n, dtype=torch.float64))
    e = torch.from_numpy(np.frexp(np.abs(S).max(axis=(0, 1)))[1]).double()
    bound = count[..., None] * 2.0 ** (e - 25) + exact.abs() * 2.0 ** -24
    assert ((got.cpu().double() - exact).abs() <= bound).all()


@pytest.mark.cuda
def test_kernel_fixed_point_bound_and_repeatable(cuda_device):
    rng = np.random.default_rng(6)
    n, d, s, nodes, n_bins = 200_003, 8, 3, 4, 32
    B, S, pos = _inputs(rng, n, d, s, 1, nodes, n_bins, False)
    S[0, :, 0] *= 1e-3    # stats of very different scales in one launch
    _fixed_point_bound_holds(cuda_device, B, S, pos, nodes, n_bins)


def _regression_stats(rng, T, n, bootstrap):
    """[wy, wy², w] with y ~ U(1e4, 1e5): the variance stats, y² up to 1e10
    beside a weight column of ones (or Poisson bootstrap counts)."""
    y = rng.uniform(1e4, 1e5, (T, n))
    w = rng.poisson(1.0, (T, n)) if bootstrap else np.ones((T, n))
    return np.stack([w * y, w * y * y, w], axis=2).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("T,nodes,bootstrap", [(1, 1, False), (1, 16, False),
                                               (4, 8, True)])
def test_regression_stats_per_stat_scale(cuda_device, T, nodes, bootstrap):
    """Each stat has its own fixed-point scale: the weight column beside y²
    in the 1e10s keeps its exact counts (one scale for all stats rounded
    each 1 to 0), and every stat holds the bound and the plain version."""
    rng = np.random.default_rng(12)
    n, d, n_bins = 100_003, 6, 32
    B = rng.integers(0, n_bins, (n, d)).astype(np.int32)
    pos = rng.integers(0, nodes, (T, n)).astype(np.int32)
    S = _regression_stats(rng, T, n, bootstrap)
    args = [torch.from_numpy(x).to(cuda_device) for x in (B.astype(np.uint8), S, pos)]
    got = th.node_histograms(*args, nodes=nodes, n_bins=n_bins)
    ref = th.node_histograms_reference(*args, nodes=nodes, n_bins=n_bins)
    assert torch.equal(got[..., 2], ref[..., 2])     # integer weights: exact
    assert _agree(got, args, False, nodes=nodes, n_bins=n_bins)
    if T == 1:
        _fixed_point_bound_holds(cuda_device, B, S, pos, nodes, n_bins)


@pytest.mark.cuda
def test_non_finite_stat_makes_every_cell_nan(cuda_device):
    rng = np.random.default_rng(13)
    B, S, pos = _inputs(rng, 5_000, 4, 3, 1, 2, 8, False)
    S[0, 17, 1] = np.nan
    args = [torch.from_numpy(x).to(cuda_device) for x in (B, S, pos)]
    assert th.node_histograms(*args, nodes=2, n_bins=8).isnan().all()


@pytest.mark.cuda
def test_forest_on_cuda_equals_cpu_path_bitwise(cuda_device):
    """Same data and draws on the card and on the CPU: integer gini counts
    sum exactly in any order, so the trees are equal bit for bit."""
    X, y = make_higgs_proxy(20_000, seed=3)
    rng = np.random.default_rng(3)
    boot = rng.poisson(1.0, (4, len(X))).astype(np.float32)
    keep = (rng.random((4, 5, 28)) < 0.2).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        Xt = torch.from_numpy(X).to(dev)
        W = torch.ones(len(X), device=dev)
        edges = _tree.compute_bin_edges(Xt, W, 32)
        B = _tree.bin_features(Xt, edges)
        forest, _ = grow_forest(
            B, edges, _tree.class_one_hot(torch.from_numpy(y).to(dev), 2), W,
            torch.from_numpy(boot).to(dev), torch.from_numpy(keep).to(dev), 0.0,
            depth=5, n_bins=32, gain_mode="gini", min_instances=1.0)
        out.append([x.cpu() for x in forest])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_misaligned_inputs_and_many_stats(cuda_device):
    """Views that start off a 16-byte line (the kernel's bulk copies move
    whole lines) and more stats than one launch takes (gini with six
    classes) give the plain version's histograms."""
    rng = np.random.default_rng(8)
    T, n, d, s, nodes, n_bins = 3, 30_001, 9, 6, 4, 16
    B, S, pos = _inputs(rng, n, d, s, T, nodes, n_bins, True)
    def shifted(x):   # the same values, 4 bytes past an aligned start
        flat = torch.empty(x.size + 1, dtype=torch.from_numpy(x).dtype, device=cuda_device)
        flat[1:] = torch.from_numpy(x.reshape(-1)).to(cuda_device)
        return flat[1:].view(x.shape)
    args = [shifted(x) for x in (B.astype(np.uint8), S, pos)]
    assert all(a.data_ptr() % 16 for a in args)
    got = th.node_histograms(*args, nodes=nodes, n_bins=n_bins)
    ref = th.node_histograms_reference(*args, nodes=nodes, n_bins=n_bins)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_launch_plan_matches_kernel_layout(cuda_device):
    """ops/histogram.py plans shared memory with its own copy of the
    kernel's layout; the kernel's own sum agrees at every level of both
    fits and for int32 bins."""
    import ctypes

    fn = th._lib().node_histograms_smem_bytes
    fn.argtypes = [ctypes.c_int] * 8
    fn.restype = ctypes.c_longlong
    for s, T in ((3, 1), (2, 20), (1, 1), (4, 3)):
        for nodes in (1, 2, 4, 8, 16, 32):
            for b_bytes in (1, 4):
                shape = th.launch_shape(10_737_856, 28, s, T, nodes, 32, 132, b_bytes)
                assert fn(28, s, nodes, 32, b_bytes, shape.group, shape.tile_rows,
                          shape.stages) == shape.smem_bytes


# (T, N, d, s, nodes, n_bins): 256 bins in uint8, more blocks than one wave,
# more features than threads, a row or a few, four feature groups
_EDGE = [(1, 20_011, 5, 3, 2, 256), (300, 3_001, 4, 2, 2, 8),
         (1, 5_003, 600, 1, 1, 4), (2, 1, 28, 3, 1, 32), (3, 17, 28, 2, 4, 32),
         (1, 40_000, 28, 3, 64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,d,s,nodes,n_bins", _EDGE)
def test_kernel_edge_shapes(cuda_device, T, N, d, s, nodes, n_bins):
    rng = np.random.default_rng(9)
    B, S, pos = _inputs(rng, N, d, s, T, nodes, n_bins, True)
    args = [torch.from_numpy(x).to(cuda_device) for x in (B.astype(np.uint8), S, pos)]
    got = th.node_histograms(*args, nodes=nodes, n_bins=n_bins)
    ref = th.node_histograms_reference(*args, nodes=nodes, n_bins=n_bins)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_decision_tree_and_five_class_forest_on_cuda_equal_cpu_path(cuda_device):
    """A decision tree (one tree, no masks) and a 5-class forest (five
    stats: the kernel takes them four at a time) grow the same trees on the
    card as on the CPU from the same data and draws: their gini counts are
    integers, summed exactly."""
    from orange3_spark_tpu_torch import TorchSession, TorchTable
    from orange3_spark_tpu_torch.core.domain import (
        ContinuousVariable, DiscreteVariable, Domain)
    from orange3_spark_tpu_torch.models.decision_tree import DecisionTreeClassifier

    rng = np.random.default_rng(10)
    X = rng.standard_normal((20_000, 6)).astype(np.float32)
    z = X[:, 0] + 0.5 * X[:, 1]
    boot = rng.poisson(1.0, (4, len(X))).astype(np.float32)
    keep = (rng.random((4, 4, 6)) < 0.5).astype(np.float32)
    domain = Domain([ContinuousVariable(f"x{i}") for i in range(6)],
                    DiscreteVariable("y", ("0", "1")))
    out = {}
    for dev in ("cpu", cuda_device):
        y2 = (z > 0).astype(np.float32)
        tab = TorchTable.from_numpy(domain, X, y2, session=TorchSession(str(dev)))
        dt = DecisionTreeClassifier(max_depth=5).fit(tab).tree
        Xt = torch.from_numpy(X).to(dev)
        W = torch.ones(len(X), device=dev)
        edges = _tree.compute_bin_edges(Xt, W, 32)
        B = _tree.compact_bins(_tree.bin_features(Xt, edges), 32)
        y5 = torch.from_numpy(np.digitize(z, np.linspace(-1.5, 1.5, 4)).astype(np.float32))
        forest, _ = grow_forest(
            B, edges, _tree.class_one_hot(y5.to(dev), 5), W,
            torch.from_numpy(boot).to(dev), torch.from_numpy(keep).to(dev), 0.0,
            depth=4, n_bins=32, gain_mode="gini", min_instances=1.0)
        out[str(dev)] = [x.cpu() for x in (*dt, *forest)]
    for a, b in zip(*out.values()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_regression_trees_on_cuda_equal_cpu_path(cuda_device):
    """DecisionTreeRegressor, and the forest RandomForestRegressor grows
    (``grow_forest`` with variance stats, fed the same bootstrap draws on
    both devices), on targets in [1e4, 1e5] grow the CPU path's trees on
    the card: the same features, split bins and thresholds, and leaf sums
    within fp32 rounding."""
    from orange3_spark_tpu_torch import TorchSession, TorchTable
    from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
    from orange3_spark_tpu_torch.models.decision_tree import DecisionTreeRegressor

    rng = np.random.default_rng(11)
    n = 20_000
    X = rng.integers(0, 10, (n, 6)).astype(np.float32)
    y = (1e4 + 4e4 * (X[:, 0] >= 5) + 2e4 * (X[:, 1] >= 3) + 1e4 * (X[:, 2] >= 6)
         + 5e3 * (X[:, 3] >= 4) + rng.uniform(0, 1e4, n)).astype(np.float32)
    boot = rng.poisson(1.0, (4, n)).astype(np.float32)
    domain = Domain([ContinuousVariable(f"x{i}") for i in range(6)],
                    ContinuousVariable("y"))
    out = {}
    for dev in ("cpu", str(cuda_device)):
        tab = TorchTable.from_numpy(domain, X, y, session=TorchSession(dev))
        dt = DecisionTreeRegressor(max_depth=4).fit(tab).tree
        edges = _tree.compute_bin_edges(tab.X, tab.W, 32)
        B = _tree.compact_bins(_tree.bin_features(tab.X, edges), 32)
        rf, _ = grow_forest(
            B, edges, _tree.regression_stats(tab.y), tab.W,
            torch.from_numpy(boot).to(dev), torch.ones((4, 4, 6), device=dev), 0.0,
            depth=4, n_bins=32, gain_mode="variance", min_instances=1.0)
        out[dev] = [x.cpu() for x in (*dt, *rf)]
    cpu, gpu = out.values()
    assert cpu[1][0] < 32            # the root splits
    for i, (a, b) in enumerate(zip(cpu, gpu)):
        if i % 4 == 3:    # leaf sums: fp32 adds in another order
            torch.testing.assert_close(b, a, rtol=1e-5, atol=0.0)
        else:
            assert torch.equal(a, b)


# ---------------------------------------------------------- the Criteo path

@pytest.mark.cuda
@pytest.mark.parametrize("n_dims", [1, 256, 1 << 20, 1 << 22])
def test_hash_bitwise_on_cuda(cuda_device, n_dims):
    """The device hash on the card equals the numpy twin bit for bit:
    negative codes, zero, large codes, the f32 carrier and int32 codes."""
    from orange3_spark_tpu_torch.ops.hashing import (
        column_salts, hash_columns, hash_columns_np,
    )

    rng = np.random.default_rng(8)
    salts = column_salts(26, seed=0)
    codes = rng.integers(-(1 << 24), 1 << 24, size=(100_003, 26))
    codes[:3] = [[0], [-1], [(1 << 24) - 1]]
    for cats in (codes.astype(np.float32), codes.astype(np.int32)):
        got = hash_columns(torch.from_numpy(cats).to(cuda_device), salts, n_dims)
        assert np.array_equal(got.cpu().numpy(), hash_columns_np(cats, salts, n_dims))


def _criteo_fit(device, lowering, path, **kw):
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io.streaming import csv_raw_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import (
        StreamingHashedLinearEstimator,
    )

    params = dict(n_dims=1 << 14, n_dense=13, n_cat=26, chunk_rows=1024, epochs=3,
                  step_size=0.04, reg_param=1e-5, label_in_chunk=True,
                  optim_update="sparse_adagrad", sparse_lowering=lowering)
    params.update(kw)
    return StreamingHashedLinearEstimator(**params).fit_stream(
        csv_raw_chunk_source(path, chunk_rows=1000), session=TorchSession(device),
        cache_device=True, holdout_chunks=1)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["sparse_adagrad", "sparse_sgd", "dense_adagrad"])
def test_criteo_fit_on_cuda_matches_cpu_path(cuda_device, tmp_path, rule):
    """The 'sort' lowering on the card against the CPU path's 'plan' and
    'sort'. CUDA's index_add_ adds with atomics in no fixed order, so theta
    agrees to float32 rounding of the segment sums carried through the
    steps: atol 1e-5, rtol 1e-4 (not bitwise). The holdout evaluation of
    the same theta agrees within 1e-4 in AUC."""
    from orange3_spark_tpu_torch.datasets import gen_criteo_csv

    path = str(tmp_path / "criteo.csv")
    gen_criteo_csv(path, 5000, seed=2)
    gpu = _criteo_fit("cuda", "sort", path, optim_update=rule)
    assert gpu.theta["emb"].device.type == "cuda"
    assert gpu.holdout_chunks_[0][0].device.type == "cuda"
    for lowering in ("plan", "sort"):
        cpu = _criteo_fit("cpu", lowering, path, optim_update=rule)
        for name, want in cpu.theta.items():
            np.testing.assert_allclose(gpu.theta[name].cpu().numpy(), want.numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=name)
    a, b = gpu.evaluate_device(gpu.holdout_chunks_), cpu.evaluate_device(cpu.holdout_chunks_)
    assert abs(a["auc"] - b["auc"]) <= 1e-4
    assert a["logloss"] == pytest.approx(b["logloss"], rel=1e-4)


@pytest.mark.cuda
def test_default_session_fits_on_cuda(cuda_device, tmp_path):
    """With no session given, the fit and its cached chunks are on the card."""
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.datasets import gen_criteo_csv
    from orange3_spark_tpu_torch.io.streaming import csv_raw_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import (
        StreamingHashedLinearEstimator,
    )

    TorchSession.builder_get_or_create("cuda")
    path = str(tmp_path / "c.csv")
    gen_criteo_csv(path, 3000, seed=1)
    st: dict = {}
    model = StreamingHashedLinearEstimator(
        n_dims=1 << 12, chunk_rows=1024, epochs=2, label_in_chunk=True,
        optim_update="sparse_adagrad").fit_stream(
            csv_raw_chunk_source(path), cache_device=True, stage_times=st)
    assert model.theta["emb"].device.type == "cuda"
    assert all(c[0].device.type == "cuda" for c in model.device_chunks_)
    assert st["sparse_lowering"] == "sort" and model.n_steps_ == 6
    assert np.isfinite(model.final_loss_)


# ------------------------------------- the packed cache and the graph replay

@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 7, 13, 22, 31])
def test_packed_decode_on_cuda(cuda_device, bits):
    """The device unpack on the card equals the values packed on the host,
    bitwise: per-row words (26 columns), flat planes and a packed plan."""
    from orange3_spark_tpu_torch.io.codec import (
        pack_flat_np, pack_rows_np, unpack_flat, unpack_rows,
    )
    from orange3_spark_tpu_torch.ops.hashing import column_salts
    from orange3_spark_tpu_torch.optim.sparse import (
        build_plan_np, pack_plan_np, unpack_plan,
    )

    rng = np.random.default_rng(bits)
    vals = rng.integers(0, 1 << bits, size=(70_001, 26), dtype=np.int64)
    words = torch.from_numpy(pack_rows_np(vals, bits).view(np.int32)).to(cuda_device)
    assert np.array_equal(unpack_rows(words, bits, 26).cpu().numpy(), vals)
    flat = vals[:, 0]
    fw = torch.from_numpy(pack_flat_np(flat, bits).view(np.int32)).to(cuda_device)
    assert np.array_equal(unpack_flat(fw, bits, len(flat)).cpu().numpy(), flat)
    N, C, D = 4096, 26, 1 << 16
    cats = rng.integers(0, 50_000, (N, C)).astype(np.float32)
    plan = build_plan_np(cats, column_salts(C), D, N - 100)
    enc = {k: torch.from_numpy(v.view(np.int32)).to(cuda_device)
           for k, v in pack_plan_np(plan, N, C, D).items()}
    for k, v in unpack_plan(enc, N, C, D).items():
        assert np.array_equal(v.cpu().numpy(), plan[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("rule,lowering", [("sparse_adagrad", "sort"),
                                           ("sparse_adagrad", "plan"), ("sparse_sgd", "sort")])
def test_graph_replay_matches_eager_replay_on_cuda(cuda_device, tmp_path, rule, lowering):
    """A packed, deferred fit whose replay runs as one captured CUDA graph
    against the same fit replayed step by step (``fused_replay=False``) on
    the card, and against the CPU path: theta within the atomics tolerance
    (atol 1e-5, rtol 1e-4); the graph replays really ran."""
    from orange3_spark_tpu_torch.datasets import gen_criteo_csv

    path = str(tmp_path / "criteo.csv")
    gen_criteo_csv(path, 9000, seed=3)
    kw = dict(optim_update=rule, cache_dtype="packed", defer_epoch1=True, epochs=4)
    st: dict = {}
    fits = {}
    for name, dev, fused in (("graph", "cuda", True), ("eager", "cuda", False),
                             ("cpu", "cpu", True)):
        from orange3_spark_tpu_torch import TorchSession
        from orange3_spark_tpu_torch.io.streaming import csv_raw_chunk_source
        from orange3_spark_tpu_torch.models.hashed_linear import (
            StreamingHashedLinearEstimator,
        )

        params = dict(n_dims=1 << 14, n_dense=13, n_cat=26, chunk_rows=1024,
                      step_size=0.04, reg_param=1e-5, label_in_chunk=True,
                      sparse_lowering=lowering, fused_replay=fused, **kw)
        fits[name] = StreamingHashedLinearEstimator(**params).fit_stream(
            csv_raw_chunk_source(path, chunk_rows=1000), session=TorchSession(dev),
            cache_device=True, holdout_chunks=1,
            stage_times=st if name == "graph" else None)
    assert st["replay_source"] == "fused" and st["graph_capture_s"] > 0
    assert fits["graph"].n_steps_ == fits["eager"].n_steps_ == 4 * 8
    for other in ("eager", "cpu"):
        for name, want in fits[other].theta.items():
            np.testing.assert_allclose(fits["graph"].theta[name].cpu().numpy(),
                                       want.cpu().numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=f"{other}.{name}")


@pytest.mark.cuda
def test_adam_on_cuda_matches_cpu(cuda_device, tmp_path):
    """'adam' on the card against the CPU path. The update on the same
    inputs: within 1e-7 + 1e-6·|θ| (pow may round an ulp apart). Three
    steps of a fit: the losses within 1e-5 relative and θ within the
    atomics tolerance (1e-5 + 1e-4·|θ|) on all but 1e-4 of the entries; the
    rest within 2·lr·steps. Adam divides by sqrt(v) + 1e-8, so where a
    row's first gradient is a near-cancelled sum, the card's reordered
    sums (atomics, another reduction order in the forward) move that one
    update by up to lr."""
    from orange3_spark_tpu_torch.datasets import gen_criteo_csv
    from orange3_spark_tpu_torch.optim.sparse import adam_update, init_adam_state

    rng = np.random.default_rng(4)
    theta = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in (("emb", (5000, 1)), ("coef", (13, 1)), ("intercept", (1,)))}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-3
             for k, v in theta.items()}
    out = {}
    for dev in ("cpu", cuda_device):
        th = {k: torch.from_numpy(v).to(dev) for k, v in theta.items()}
        state = init_adam_state(th)
        for _ in range(3):
            th, state = adam_update(th, {k: torch.from_numpy(v).to(dev)
                                         for k, v in grads.items()}, state, 0.04)
        out[str(dev)] = {k: v.cpu().numpy() for k, v in th.items()}
    for k in theta:
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], atol=1e-7, rtol=1e-6)
    path = str(tmp_path / "c.csv")
    gen_criteo_csv(path, 3 * 4096, seed=5)
    fits = {dev: _criteo_fit(dev, "sort", path, optim_update="adam", epochs=1,
                             chunk_rows=4096) for dev in ("cuda", "cpu")}
    assert fits["cuda"].n_steps_ == 2              # one chunk held out
    assert fits["cuda"].final_loss_ == pytest.approx(fits["cpu"].final_loss_, rel=1e-5)
    for name, want in fits["cpu"].theta.items():
        got, want = fits["cuda"].theta[name].cpu().numpy(), want.numpy()
        off = np.abs(got - want) > 1e-5 + 1e-4 * np.abs(want)
        assert off.mean() <= 1e-4, (name, int(off.sum()))
        assert np.abs(got - want).max() <= 2 * 0.04 * 2, name


# ------------------------------------------------------------- serving
# served logits against eager raw logits on the card: bitwise. The graph
# runs the raw path's ops at the bucket's row count, and on the H100 no op
# of the path (the gather-sum, ``dense @ coef``) rounded a live row apart
# there; a change that makes them round apart is a finding for ROADMAP
# queue 3 (the op and its measured max |Δ|), not a tolerance to widen here.


def _served_model(device, n_dims=1 << 14, seed=0):
    """A hashed model with random theta on ``device`` (13 + 26 columns)
    and requests drawn from the Criteo generator's shape."""
    from orange3_spark_tpu_torch.models.hashed_linear import (
        HashedLinearModel, HashedLinearParams,
    )
    from orange3_spark_tpu_torch.ops.hashing import column_salts

    rng = np.random.default_rng(seed)
    p = HashedLinearParams(n_dims=n_dims, n_dense=13, n_cat=26)
    theta = {"emb": torch.from_numpy(rng.normal(0, 0.3, (n_dims, 1)).astype(np.float32)),
             "coef": torch.from_numpy(rng.normal(0, 0.3, (13, 1)).astype(np.float32)),
             "intercept": torch.tensor([0.1])}
    model = HashedLinearModel(p, {k: v.to(device) for k, v in theta.items()},
                              column_salts(26, 0), ("0", "1"))
    X = np.concatenate([rng.lognormal(0, 1, (4096, 13)).astype(np.float32),
                        rng.integers(0, 200_000, (4096, 26)).astype(np.float32)], axis=1)
    return model, X


def _assert_served_bitwise(served, raw):
    assert served.shape == raw.shape and served.dtype == raw.dtype
    assert np.array_equal(served, raw), float(np.abs(served - raw).max())


@pytest.mark.cuda
def test_served_graph_logits_match_eager_at_every_rung(cuda_device):
    """Every rung of a 64..2048 ladder serves from a captured graph, bitwise
    equal to the eager raw logits; a repeat of the trace
    captures nothing and replays one graph per request."""
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext
    from orange3_spark_tpu_torch.utils.profiling import (
        graph_capture_count, reset_serve_counters, serve_counters,
    )

    model, X = _served_model(cuda_device)
    sizes = (1, 50, 64, 100, 200, 300, 700, 1500, 2048)
    raws = {n: model._logits(X[:n]) for n in sizes}
    reset_serve_counters()
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=2048)) as ctx:
        c0 = graph_capture_count()
        served = {n: model._logits(X[:n]) for n in sizes}
        first = graph_capture_count() - c0
        # churn the allocator: memory freed after a build (a tensor the
        # graph still reads) would be handed out and overwritten here
        junk = [torch.full((1 << 16,), -7, dtype=torch.int64, device=cuda_device)
                for _ in range(64)]
        del junk
        again = {n: model._logits(X[:n]) for n in sizes}
        assert graph_capture_count() - c0 == first      # a repeat captures nothing
        assert ctx.breaker_states() == {}
        assert ctx.cache.device_bytes() > 0
    assert first == 6                                   # the six rungs touched
    assert serve_counters()["graph_replays"] == 2 * len(sizes)
    for n in sizes:
        assert served[n].shape == raws[n].shape
        assert np.array_equal(served[n], again[n])      # one graph, same bits
        _assert_served_bitwise(served[n], raws[n])


@pytest.mark.cuda
def test_served_from_eight_threads(cuda_device):
    """Direct dispatch from 8 threads: the entry's lock keeps one request's
    fill, replay and copy-out together, so each caller gets its own rows,
    equal to a single-threaded served answer."""
    from concurrent.futures import ThreadPoolExecutor

    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

    model, X = _served_model(cuda_device)
    reqs = [(int(o), int(n)) for o, n in zip(np.arange(32) * 37, (np.arange(32) * 61) % 900 + 5)]
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=1024)) as ctx:
        ctx.warmup(model, n_cols=X.shape[1])
        want = [model._logits(X[o:o + n]) for o, n in reqs]
        with ThreadPoolExecutor(8) as ex:
            got = list(ex.map(lambda r: model._logits(X[r[0]:r[0] + r[1]]), reqs))
    for (o, n), a, b in zip(reqs, got, want):
        assert a.shape == (n, 1) and np.array_equal(a, b)


@pytest.mark.cuda
def test_served_hot_reload_and_in_place_theta(cuda_device):
    """``load_state_pytree`` keys a fresh graph (one more capture), and a
    state of numpy arrays (as the JAX package's checkpoints carry it) lands
    on the card; an in-place update of theta is read by the next replay of
    the same graph. Both bitwise equal to the eager raw logits."""
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext
    from orange3_spark_tpu_torch.serve.context import _raw_calls
    from orange3_spark_tpu_torch.utils.profiling import graph_capture_count

    model, X = _served_model(cuda_device)
    other = {k: (v * 0.5).cpu().numpy() for k, v in model.theta.items()}
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=1024)):
        before = model._logits(X[:100])
        c0 = graph_capture_count()
        model.load_state_pytree(other)
        assert all(v.is_cuda for v in model.theta.values())
        reloaded = model._logits(X[:100])
        with _raw_calls():
            raw_reloaded = model._logits(X[:100])
        assert graph_capture_count() == c0 + 1
        with torch.no_grad():
            model.theta["intercept"].add_(3.0)
        in_place = model._logits(X[:100])
        assert graph_capture_count() == c0 + 1
    _assert_served_bitwise(reloaded, raw_reloaded)
    _assert_served_bitwise(in_place, model._logits(X[:100]))
    assert not np.allclose(before, reloaded)
    assert not np.allclose(in_place, reloaded)


@pytest.mark.cuda
def test_no_cpu_tensor_on_the_served_path(cuda_device):
    """On a CUDA model, every ATen op of a served request runs on the card,
    apart from wrapping the host request as a tensor, its copy in and the
    result's copy out."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

    class Devices(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            devs = {a.device.type for a in torch.utils._pytree.tree_leaves((args, kwargs))
                    if isinstance(a, torch.Tensor)}
            self.ops.append((str(func), devs))
            return func(*args, **(kwargs or {}))

    model, X = _served_model(cuda_device)
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=1024)) as ctx:
        ctx.warmup(model, n_cols=X.shape[1])
        with Devices() as mode:
            out = model._logits(X[:300])
    assert out.shape == (300, 1)
    on_cpu = [op for op, devs in mode.ops if "cpu" in devs
              and not op.startswith(("aten.lift_fresh", "aten.copy_", "aten._to_copy",
                                     "aten.slice", "aten.alias", "aten.detach"))]
    assert not on_cpu, on_cpu
    assert any(op.startswith("aten.copy_") and devs == {"cpu", "cuda"}
               for op, devs in mode.ops)
