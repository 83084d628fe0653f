"""The port's hashed logistic regression (the Criteo path) against the JAX
package's, on the CPU and the same numpy inputs: the hash, the touched-row
plan, the losses and their gradients, theta after ``fit_stream`` for every
update rule and lowering, a reference-trained model evaluated by the port,
and CSV -> fit_stream -> evaluate_device end to end.

The JAX side runs on a one-device session, as ``fit_stream`` there would on
one chip; its replay runs per chunk (``fused_replay=False``), the same step
sequence as its fused scan with one compile fewer.

Tolerances: theta within atol 1e-6, rtol 1e-5 of the reference's. The
port's CPU segment sums add in the reference's order (index_add_ on the CPU
is sequential), so what differs is float32 rounding elsewhere: XLA's fused
sums and dot products against PyTorch's, and ``pow``/``rsqrt``/``exp`` a
few ulps apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.io.streaming import array_chunk_source as j_array_source
from orange3_spark_tpu.models import _linear as jlin
from orange3_spark_tpu.models.hashed_linear import (
    StreamingHashedLinearEstimator as JEstimator,
)
from orange3_spark_tpu.ops import hashing as jhash
from orange3_spark_tpu.optim import sparse as jsparse
from orange3_spark_tpu_torch import TorchSession, interop
from orange3_spark_tpu_torch.io.streaming import array_chunk_source
from orange3_spark_tpu_torch.models import _linear as tlin
from orange3_spark_tpu_torch.models.hashed_linear import (
    HashedLinearParams, StreamingHashedLinearEstimator, _auc_from_hists,
)
from orange3_spark_tpu_torch.ops import hashing as thash
from orange3_spark_tpu_torch.optim import sparse as tsparse

BASE = dict(n_dims=1 << 12, n_dense=4, n_cat=6, epochs=4, step_size=0.05,
            chunk_rows=1024)
ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def cpu():
    return TorchSession("cpu")


def _criteo_shaped(n, n_dense=4, n_cat=6, card=50, seed=0):
    """Criteo-shaped data: labels driven by a few categorical levels and a
    dense signal (tests/test_hashed_linear.py's generator)."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, n_dense)).astype(np.float32)
    cats = rng.integers(0, card, size=(n, n_cat)).astype(np.float32)
    effects = rng.normal(0, 1.2, size=(n_cat, card))
    logit = dense[:, 0] - 0.5 * dense[:, 1]
    for j in range(n_cat):
        logit = logit + effects[j, cats[:, j].astype(int)]
    y = (logit + 0.3 * rng.standard_normal(n) > 0).astype(np.float32)
    return np.concatenate([dense, cats], axis=1), y


@pytest.fixture(scope="module")
def data():
    # 4000 rows in 1024-row chunks: the last chunk has 928 live rows, so
    # the padding path (dead occurrences) runs every epoch
    return _criteo_shaped(4000, seed=21)


def _theta(model):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in model.theta.items()}


def _fit_port(session, X, y, **kw):
    est = StreamingHashedLinearEstimator(**{**BASE, **kw})
    return est.fit_stream(array_chunk_source(X, y, chunk_rows=1000), session=session,
                          cache_device=True)


def _fit_ref(session, X, y, **kw):
    est = JEstimator(**{**BASE, **kw}, fused_replay=False)
    return est.fit_stream(j_array_source(X, y, chunk_rows=1000), session=session,
                          cache_device=True)


# ------------------------------------------------------------------ hashing

@pytest.mark.parametrize("n_dims", [1, 256, 1 << 20, 1 << 22])
def test_hash_bitwise_against_both_reference_hashes(n_dims):
    """Negative codes, zero and large codes, in the f32 carrier and as
    integers: the port's device hash, its numpy twin and both JAX hashes
    give the same buckets."""
    rng = np.random.default_rng(3)
    salts = thash.column_salts(7, seed=7)
    assert np.array_equal(salts, jhash.column_salts(7, seed=7))
    codes = rng.integers(-(1 << 24), 1 << 24, size=(600, 7))
    codes[0] = 0
    codes[1] = -1
    codes[2] = (1 << 24) - 1
    for cats in (codes.astype(np.float32), codes.astype(np.int32), codes):
        want = jhash.hash_columns_np(cats, salts, n_dims)
        assert np.array_equal(np.asarray(jhash.hash_columns(jnp.asarray(cats), salts,
                                                            n_dims)), want)
        assert np.array_equal(thash.hash_columns_np(cats, salts, n_dims), want)
        got = thash.hash_columns(torch.from_numpy(cats), salts, n_dims)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_hash_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        thash.hash_columns(torch.zeros((2, 2)), thash.column_salts(2), 1000)
    with pytest.raises(ValueError, match="power of two"):
        thash.hash_columns_np(np.zeros((2, 2)), thash.column_salts(2), 6)


@pytest.mark.parametrize("n_dims,n_valid", [(128, 50), (1 << 12, 64), (1, 10)])
def test_build_plan_bitwise(n_dims, n_valid):
    rng = np.random.default_rng(4)
    N, C = 64, 3
    salts = thash.column_salts(C, seed=1)
    cats = rng.integers(0, 500, (N, C)).astype(np.float32)
    cats[rng.random((N, C)) < 0.1] = np.nan
    ours = tsparse.build_plan_np(cats, salts, n_dims, n_valid)
    ref = jsparse.build_plan_np(cats, salts, n_dims, n_valid, impute_missing=True)
    assert sorted(ours) == sorted(ref)
    for k in ours:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k
    assert tsparse.plan_slots(N, C, n_dims) == jsparse.plan_slots(N, C, n_dims)
    assert tsparse.plan_field_shapes(N, C, n_dims) == jsparse.plan_field_shapes(
        N, C, n_dims, False)


def test_resolvers_follow_the_reference(monkeypatch):
    for rule in tsparse.OPTIM_UPDATES:
        assert tsparse.resolve_optim_update(rule) == jsparse.resolve_optim_update(rule)
    monkeypatch.setenv("OTPU_SPARSE_UPDATE", "0")
    assert tsparse.resolve_optim_update("sparse_ftrl") == "dense_ftrl"
    with pytest.raises(ValueError):
        tsparse.resolve_optim_update("rmsprop")
    assert tsparse.resolve_sparse_lowering("auto", "cpu") == "plan"
    assert tsparse.resolve_sparse_lowering("auto", "cuda") == "sort"
    with pytest.raises(ValueError):
        tsparse.resolve_sparse_lowering("hash", "cpu")
    assert (tsparse.ADAGRAD_EPS, tsparse.FTRL_BETA) == (jsparse.ADAGRAD_EPS,
                                                          jsparse.FTRL_BETA)


# ------------------------------------------------------------------- losses

@pytest.mark.parametrize("kind", tlin.LOSS_KINDS)
def test_per_row_loss_and_gradient(kind):
    """All five losses, and d loss / d logits with the reference's autodiff
    rules at the kinks (logits of exactly 0, hinge margins of exactly 0)."""
    rng = np.random.default_rng(5)
    k = 3 if kind == "logistic" else 1
    z = rng.standard_normal((40, k)).astype(np.float32) * 3
    y = rng.integers(0, k if kind == "logistic" else 2, 40).astype(np.float32)
    z[:5] = 0.0
    if kind in ("hinge", "squared_hinge"):
        z[5:8, 0] = 2.0 * y[5:8] - 1.0          # margin exactly 0
    got = tlin.per_row_loss(kind, torch.from_numpy(z), torch.from_numpy(y)).numpy()
    want = np.asarray(jlin.per_row_loss(kind, z, y))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    g = tlin.per_row_loss_grad(kind, torch.from_numpy(z), torch.from_numpy(y)).numpy()
    g_ref = np.asarray(jax.grad(lambda zz: jnp.sum(jlin.per_row_loss(kind, zz, y)))(z))
    np.testing.assert_allclose(g, g_ref, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ fits vs reference

_RULES = ([(r, "auto") for r in tsparse.DENSE_UPDATES]
          + [(r, low) for r in tsparse.SPARSE_UPDATES for low in ("plan", "sort")])


@pytest.mark.parametrize("reg", [0.0, 1e-3])
@pytest.mark.parametrize("rule,lowering", _RULES)
def test_theta_matches_reference(jax_session, cpu, data, rule, lowering, reg):
    X, y = data
    kw = dict(optim_update=rule, sparse_lowering=lowering, reg_param=reg,
              l1_param=1e-4 if rule.endswith("ftrl") else 0.0)
    ours = _fit_port(cpu, X, y, **kw)
    ref = _fit_ref(jax_session, X, y, **kw)
    got, want = _theta(ours), _theta(ref)
    for name in ("emb", "coef", "intercept"):
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    assert ours.n_steps_ == ref.n_steps_ == 16
    np.testing.assert_allclose(ours.final_loss_, ref.final_loss_, rtol=1e-5)
    assert np.abs(got["emb"]).max() > 1e-3        # the table really trained


@pytest.mark.parametrize("lowering", ["sort", "plan"])
def test_padding_touches_no_table_row(jax_session, cpu, data, lowering):
    """A 16-row table, so every row (the last one too) is touched in every
    chunk, and a padded last chunk: the dead occurrences of the padding
    rows must update no row — not the last row, where a clamped index
    would land, nor any other."""
    X, y = data
    kw = dict(n_dims=16, optim_update="sparse_adagrad", sparse_lowering=lowering,
              reg_param=1e-3)
    got, want = _theta(_fit_port(cpu, X, y, **kw)), _theta(_fit_ref(jax_session, X, y, **kw))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, rtol=RTOL)


def test_sparse_matches_dense_twin(cpu, data):
    """The reference's own pins, inside the port: SGD without decay is the
    dense twin's sums in the same order (<= 5e-9); lazy decay against the
    per-step decay (< 1e-6); FTRL (< 1e-7); the two lowerings (< 1e-7)."""
    X, y = data

    def emb(**kw):
        return _theta(_fit_port(cpu, X, y, **kw))["emb"]

    dense_sgd = emb(optim_update="dense_sgd")
    for lowering in ("plan", "sort"):
        assert np.abs(emb(optim_update="sparse_sgd", sparse_lowering=lowering)
                      - dense_sgd).max() <= 5e-9
    for rule in ("sgd", "adagrad"):
        d = emb(optim_update=f"dense_{rule}", reg_param=1e-3)
        s = emb(optim_update=f"sparse_{rule}", reg_param=1e-3)
        assert np.abs(s - d).max() < 1e-6, rule
    ftrl = dict(reg_param=1e-3, l1_param=1e-4)
    s = emb(optim_update="sparse_ftrl", **ftrl)
    assert np.abs(s - emb(optim_update="dense_ftrl", **ftrl)).max() < 1e-7
    assert (s == 0.0).any()                        # l1 makes exact zeros
    a = emb(optim_update="sparse_adagrad", sparse_lowering="plan", reg_param=1e-3)
    b = emb(optim_update="sparse_adagrad", sparse_lowering="sort", reg_param=1e-3)
    assert np.abs(a - b).max() < 1e-7


def test_reference_model_through_interop(jax_session, cpu, data):
    """A model the JAX package trained, loaded through
    ``interop.hashed_linear_model``: the same logits, accuracy, AUC and
    logloss, on the host (predict) and on the device (evaluate_device)."""
    X, y = data
    kw = dict(optim_update="sparse_adagrad", reg_param=1e-4, label_in_chunk=False)
    ref = _fit_ref(jax_session, X, y, **kw)
    state = {k: np.asarray(v) for k, v in ref.state_pytree.items()}
    model = interop.hashed_linear_model(state, ref.params.to_dict(), ref.class_values,
                                        device="cpu")
    assert model.params == HashedLinearParams(**ref.params.to_dict())
    np.testing.assert_allclose(model._logits(X), ref._logits(X), rtol=1e-5, atol=1e-6)
    assert np.array_equal(model.predict(X), ref.predict(X))
    np.testing.assert_allclose(model.predict_proba(X), ref.predict_proba(X),
                               rtol=1e-5, atol=1e-6)
    ours = model.evaluate_device(_fit_port(cpu, X, y, epochs=1, **kw).device_chunks_)
    want = ref.evaluate_device(ref.device_chunks_)
    assert ours["accuracy"] == want["accuracy"]
    assert abs(ours["auc"] - want["auc"]) <= 1e-4
    np.testing.assert_allclose(ours["logloss"], want["logloss"], rtol=1e-5)
    src = array_chunk_source(X, y, chunk_rows=700)
    s_ours, s_want = model.evaluate_stream(src), ref.evaluate_stream(
        j_array_source(X, y, chunk_rows=700))
    assert s_ours["accuracy"] == s_want["accuracy"]
    assert abs(s_ours["auc"] - s_want["auc"]) <= 1e-4
    np.testing.assert_allclose(s_ours["logloss"], s_want["logloss"], rtol=1e-5)


def test_cache_overflow_streams_every_epoch(cpu, data):
    """A cache budget smaller than the stream degrades to re-running the
    source every epoch, with a warning, and trains the same theta."""
    X, y = data
    kw = dict(optim_update="sparse_adagrad", reg_param=1e-3)
    est = StreamingHashedLinearEstimator(**{**BASE, **kw})
    with pytest.warns(RuntimeWarning, match="overflowed"):
        small = est.fit_stream(array_chunk_source(X, y, chunk_rows=1000), session=cpu,
                               cache_device=True, cache_device_bytes=50_000)
    assert small.device_chunks_ == []
    full = _fit_port(cpu, X, y, **kw)
    assert np.array_equal(_theta(small)["emb"], _theta(full)["emb"])


def test_fit_protocol_and_auc_helper(cpu, data):
    """``Estimator.fit`` on a TorchTable streams it in chunks; the AUC of
    the histogram helper matches the reference helper."""
    from orange3_spark_tpu.models.hashed_linear import _auc_from_hists as j_auc
    from orange3_spark_tpu_torch import TorchTable

    X, y = data
    table = TorchTable.from_arrays(X, y, session=cpu)
    est = StreamingHashedLinearEstimator(**{**BASE, "optim_update": "sparse_sgd"})
    model = est.fit(table)
    assert model.n_steps_ == 16 and est.last_fit_metrics["fit_seconds"] > 0
    assert np.mean(model.predict(X) == y) > 0.6
    rng = np.random.default_rng(0)
    pos, neg = rng.random(4096), rng.random(4096)
    assert _auc_from_hists(pos, neg) == j_auc(pos, neg)
    assert _auc_from_hists(pos, np.zeros(4096)) is None


@pytest.mark.parametrize("override", [
    dict(emb_update="per_column"), dict(value_weighted=True, n_dense=0, n_cat=5),
    dict(missing="keep"), dict(missing="keep", cache_dtype="packed"),
    dict(emb_update="sorted"), dict(compute_dtype="float16"),
    dict(compute_dtype="bfloat16")])
def test_unported_options_raise(cpu, data, override):
    """The options the port once refused with ``NotImplementedError`` now
    fit (tests/test_torch_libsvm.py holds them to the reference); a value
    no package takes still raises, as a ValueError."""
    X, y = data
    kw = {**BASE, "optim_update": "sparse_sgd", **override}
    model = StreamingHashedLinearEstimator(**kw).fit_stream(
        array_chunk_source(X, y), session=cpu)
    assert all(bool(torch.isfinite(v).all()) for v in model.theta.values())
    assert model.n_steps_ == 16
    name, value = next(iter(override.items()))
    if isinstance(value, str):
        with pytest.raises(ValueError):
            StreamingHashedLinearEstimator(**{**kw, name: value + "_x"}).fit_stream(
                array_chunk_source(X, y), session=cpu)
