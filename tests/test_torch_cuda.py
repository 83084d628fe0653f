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
    if integer:
        S = rng.poisson(1.0, (T, n, s)).astype(np.float32)
    else:
        S = rng.standard_normal((T, n, s)).astype(np.float32)
    return B, S, pos


@pytest.mark.cuda
@pytest.mark.parametrize("T,s,nodes,integer", [(1, 3, 16, False), (20, 2, 16, True),
                                               (1, 3, 1, False), (3, 5, 3, False)])
def test_kernel_matches_plain_on_cuda(cuda_device, T, s, nodes, integer):
    """Bitwise for integer stats, within 1e-5·max|H| for float stats (fp32
    atomics add in a run-dependent order)."""
    rng = np.random.default_rng(5)
    n, d, n_bins = 50_001, 28, 32
    args = [torch.from_numpy(x).to(cuda_device)
            for x in _inputs(rng, n, d, s, T, nodes, n_bins, integer)]
    before = th.node_histograms.launches
    got = th.node_histograms(*args, nodes=nodes, n_bins=n_bins)
    ref = th.node_histograms_reference(*args, nodes=nodes, n_bins=n_bins)
    torch.cuda.synchronize()
    assert th.node_histograms.launches == before + 1
    if integer:
        assert torch.equal(got, ref)
    else:
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


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
