"""The port's GaussianMixture, BisectingKMeans, PowerIterationClustering and
LDA against the JAX package's, on the same seeded numpy inputs (a few
hundred rows or documents, a few columns), with their ``interop``
converters and widgets.

Tolerances, with their reasons:

- BisectingKMeans: the same seeds and splits; Lloyd's sums run in another
  float32 order, so the centers agree within 1e-5 and the assignments are
  equal (the blobs are well apart).
- GaussianMixture: EM from the same start (the host init's numpy draws;
  the device init's JAX draws, bitwise); each iteration's Cholesky, solve
  and scatter sum in other orders, so the parameters agree within 1e-4 of
  their scale, the log-likelihood within 1e-5 relative, and the iteration
  count and predictions are equal.
- PIC: the same pseudo-eigenvector within 1e-6 relative after 20 steps
  (the per-source sums run in sorted-edge order); the clusters equal.
- LDA: digamma and lgamma are torch's, within 2e-6 relative of
  ``jax.scipy.special``; after the E-step's 25 passes and 5 outer steps the
  topics agree within 1e-4 relative, the bound within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.models import bisecting_kmeans as JB
from orange3_spark_tpu.models import gaussian_mixture as JG
from orange3_spark_tpu.models import lda as JL
from orange3_spark_tpu.models import power_iteration as JP
from orange3_spark_tpu_torch import interop
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.models import bisecting_kmeans as TB
from orange3_spark_tpu_torch.models import gaussian_mixture as TG
from orange3_spark_tpu_torch.models import lda as TL
from orange3_spark_tpu_torch.models import power_iteration as TP
from orange3_spark_tpu_torch.models.base import staging
from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY, OWTable
from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph

from _port_parity import assert_port_equal, to_np
from _torch_tables import table_pair


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession("cpu")


@pytest.fixture(scope="module")
def blobs(jsess, tsess):
    rng = np.random.default_rng(5)
    centers = np.array([[0, 0, 0], [6, 0, 1], [0, 7, -2], [5, 6, 4]], np.float32)
    X = np.concatenate([c + rng.standard_normal((80, 3)).astype(np.float32) * (0.5 + i / 4)
                        for i, c in enumerate(centers)])
    W = np.ones(len(X), np.float32)
    W[::13] = 0.0
    return table_pair(jsess, tsess, [(f"x{j}", None) for j in range(3)], X, W=W)


@pytest.mark.parametrize("kw", [dict(k=4, seed=1), dict(k=3, max_iter=5, seed=7,
                                                         min_divisible_cluster_size=0.3)])
def test_bisecting_kmeans(blobs, kw):
    jt, tt = blobs
    jm, tm = JB.BisectingKMeans(**kw).fit(jt), TB.BisectingKMeans(**kw).fit(tt)
    assert_port_equal(to_np(jm.centers), tm.centers.numpy(), atol=1e-5, what="centers")
    assert np.array_equal(jm.predict(jt), tm.predict(tt))
    assert np.array_equal(to_np(jm.cluster_sizes_), tm.cluster_sizes_.numpy())
    assert_port_equal(jm.training_cost_, tm.training_cost_, rtol=1e-5)
    conv = interop.bisecting_kmeans_model({"centers": to_np(jm.centers)}, jm.params.to_dict(),
                                          device="cpu")
    assert np.array_equal(conv.predict(tt), jm.predict(jt))


def _gmm_close(jm, tm):
    assert jm.n_iter_ == tm.n_iter_
    for f in ("weights", "means", "covs"):
        ref = to_np(getattr(jm, f))
        assert_port_equal(ref, getattr(tm, f).numpy(), atol=1e-4 * max(1.0, np.abs(ref).max()),
                          what=f)
    assert_port_equal(jm.log_likelihood_, tm.log_likelihood_, rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(k=4, seed=2), dict(k=2, max_iter=7, tol=1e-3, seed=0)])
def test_gaussian_mixture(blobs, kw):
    jt, tt = blobs
    jm, tm = JG.GaussianMixture(**kw).fit(jt), TG.GaussianMixture(**kw).fit(tt)
    _gmm_close(jm, tm)
    assert np.array_equal(jm.predict(jt), tm.predict(tt))
    assert_port_equal(jm.predict_probability(jt), tm.predict_probability(tt), atol=1e-4)
    assert np.array_equal(to_np(jm.cluster_sizes_), tm.cluster_sizes_.numpy())
    assert_port_equal(to_np(jm.transform(jt).X), tm.transform(tt).X.numpy(), atol=1e-4)
    conv = interop.gaussian_mixture_model({f: to_np(getattr(jm, f))
                                           for f in ("weights", "means", "covs")},
                                          jm.params.to_dict(), device="cpu")
    assert np.array_equal(conv.predict(tt), jm.predict(jt))
    assert_port_equal(jm.log_likelihood(jt), conv.log_likelihood(tt), rtol=1e-5)


def test_gaussian_mixture_device_init(blobs):
    """The staged refit's init: JAX's draws through ``device_d2_seed``,
    bitwise the reference's means."""
    jt, tt = blobs
    p = dict(k=3, seed=4, init_sample_size=64)
    jw, jmu, jc = JG.GaussianMixture(**p)._device_init(jt)
    with staging():
        tw, tmu, tc = TG.GaussianMixture(**p)._init(tt)
    assert np.array_equal(to_np(jmu), tmu.numpy())
    assert np.array_equal(to_np(jw), tw.numpy())
    assert_port_equal(to_np(jc), tc.numpy(), rtol=1e-5)


def _graph(n=300, seed=3):
    rng = np.random.default_rng(seed)
    half = n // 2
    src, dst, w = [], [], []
    for _ in range(6 * n):
        a = rng.integers(0, n)
        same = rng.random() < 0.9
        lo, hi = (0, half) if (a < half) == same else (half, n)
        src.append(a)
        dst.append(rng.integers(lo, hi))
        w.append(rng.random() + 0.1)
    return np.array(src), np.array(dst), np.array(w, np.float32)


@pytest.mark.parametrize("init_mode", ["random", "degree"])
def test_power_iteration_clustering(init_mode):
    src, dst, w = _graph()
    kw = dict(k=2, max_iter=20, init_mode=init_mode, seed=3)
    ref = JP.PowerIterationClustering(**kw).assign_clusters((src, dst, w))
    got = TP.PowerIterationClustering(**kw).assign_clusters((src, dst, w), device="cpu")
    assert np.array_equal(ref, got)
    layout = TP.EdgeLayout(src, dst, w, 300, "cpu")
    import jax.numpy as jnp
    v0 = np.random.default_rng(0).random(300).astype(np.float32)
    v0 /= v0.sum()
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    vr = JP._power_iterate(jnp.asarray(s2), jnp.asarray(d2), jnp.asarray(np.concatenate([w, w])),
                           jnp.asarray(v0), n=300, max_iter=20)
    vg = TP.power_iterate(layout, torch.from_numpy(v0), 20)
    assert_port_equal(to_np(vr), vg.numpy(), rtol=1e-6, atol=1e-9)


def test_power_iteration_degree_start_on_a_denser_community():
    """``chip_smoke.py``'s PIC traffic at 20,000 nodes: a planted partition
    whose first community sources 60 % of the edges, at com-LiveJournal's
    mean degree. From the degree start the port assigns as the reference
    does, up to 1e-3 of the nodes (a node within float32's resolution of
    the two centres' midpoint may flip between the packages' sum orders),
    and both find the planted partition on at least 99 % of the nodes."""
    from orange3_spark_tpu_torch.datasets import (
        LIVEJOURNAL_EDGES, LIVEJOURNAL_NODES, make_planted_graph,
    )
    n = 20_000
    graph = make_planted_graph(n, n * LIVEJOURNAL_EDGES // LIVEJOURNAL_NODES, first_share=0.6)
    kw = dict(k=2, max_iter=20, init_mode="degree")
    ref = JP.PowerIterationClustering(**kw).assign_clusters(graph)
    got = TP.PowerIterationClustering(**kw).assign_clusters(graph, device="cpu")
    assert np.mean(ref != got) <= 1e-3
    planted = np.arange(n) >= n // 2
    for a in (ref, got):
        hit = np.mean(a == planted)
        assert max(hit, 1.0 - hit) >= 0.99


@pytest.fixture(scope="module")
def counts(jsess, tsess):
    rng = np.random.default_rng(8)
    topics = rng.dirichlet(np.full(30, 0.2), size=3)
    X = np.stack([rng.multinomial(rng.integers(20, 60), topics[rng.integers(0, 3)])
                  for _ in range(120)]).astype(np.float32)
    W = np.ones(len(X), np.float32)
    W[::10] = 0.0
    return table_pair(jsess, tsess, [(f"t{j}", None) for j in range(30)], X, W=W)


def test_lda(counts):
    jt, tt = counts
    kw = dict(k=3, max_iter=5, seed=1)
    jm, tm = JL.LDA(**kw).fit(jt), TL.LDA(**kw).fit(tt)
    assert_port_equal(to_np(jm.lam), tm.lam.numpy(), rtol=1e-4, what="lam")
    assert_port_equal(jm.topics_matrix(), tm.topics_matrix(), rtol=1e-4)
    assert [t["termIndices"][:3] for t in jm.describe_topics()] == \
        [t["termIndices"][:3] for t in tm.describe_topics()]
    assert_port_equal(jm.log_likelihood(jt), tm.log_likelihood(tt), rtol=1e-5)
    assert_port_equal(jm.log_perplexity(jt), tm.log_perplexity(tt), rtol=1e-5)
    assert_port_equal(to_np(jm.transform(jt).X), tm.transform(tt).X.numpy(), atol=1e-4)
    conv = interop.lda_model({"lam": to_np(jm.lam)}, jm.params.to_dict(), device="cpu")
    assert_port_equal(jm.log_likelihood(jt), conv.log_likelihood(tt), rtol=1e-5)


def test_dirichlet_expectation():
    import jax.numpy as jnp
    a = np.random.default_rng(0).gamma(2.0, 1.0, (20, 7)).astype(np.float32) + 0.01
    ref = np.asarray(JL._dirichlet_expectation(jnp.asarray(a)))
    got = TL.dirichlet_expectation(torch.from_numpy(a)).numpy()
    assert_port_equal(ref, got, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("name,kw", [("OWGaussianMixture", dict(k=3)),
                                     ("OWBisectingKMeans", dict(k=3)),
                                     ("OWLDA", dict(k=2, max_iter=2))])
def test_unsupervised_widgets(blobs, counts, name, kw):
    tt = counts[1] if name == "OWLDA" else blobs[1]
    g = WorkflowGraph()
    src = g.add(OWTable(tt))
    node = g.add(WIDGET_REGISTRY[name](**kw))
    g.connect(src, "data", node, "data")
    out = g.run()[node]
    assert out["data"].n_rows == tt.n_rows and out["model"] is not None
