"""The port's replay configuration against the JAX package's, on the CPU
and the same numpy inputs: theta after ``fit_stream`` with a compressed
cache ('bf16', 'packed'), both sparse lowerings, with and without
``defer_epoch1``, against the reference's fused replay scan; the 'adam'
rule (the params' default); the disk-spill replay against the device
cache replay; ``evaluate_device`` on a packed holdout; ``warm_replay``;
the device step counter.

The JAX side runs on a one-device session with its fused replay, as on
one chip. On the CPU the port's fused replay runs the same steps chunk by
chunk (CUDA graphs are the card's; tests/test_torch_cuda.py holds the
captured replay against these eager steps there).

Tolerances: theta within atol 1e-6, rtol 1e-5 of the reference's (float32
rounding of XLA's fused sums against PyTorch's; the segment sums add in
the same order on the CPU). Adam: atol 1e-6, rtol 1e-5 as well. Within the
port (spill against cache, granularity, warm-up) the comparisons are
bitwise: the same steps on the same bytes.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.models.hashed_linear import (
    StreamingHashedLinearEstimator as JEstimator,
)
from orange3_spark_tpu_torch import TorchSession, interop
from orange3_spark_tpu_torch.models import hashed_linear as thl
from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator

BASE = dict(n_dims=1 << 12, n_dense=4, n_cat=6, epochs=4, step_size=0.05,
            chunk_rows=1024, label_in_chunk=True, optim_update="sparse_adagrad",
            reg_param=1e-3)
ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def cpu():
    return TorchSession("cpu")


@pytest.fixture(scope="module")
def raw():
    """[label | 4 dense | 6 codes] rows, NaN cells in both blocks; 4000
    rows in 1024-row chunks, so the last chunk is padded."""
    rng = np.random.default_rng(21)
    n = 4000
    dense = (rng.lognormal(0, 1, (n, 4)) * 10).astype(np.float32)
    cats = rng.integers(0, 60, (n, 6)).astype(np.float32)
    effects = rng.normal(0, 1.2, (6, 60))
    logit = 0.05 * dense[:, 0] - 0.5
    for j in range(6):
        logit = logit + effects[j, cats[:, j].astype(int)]
    y = (logit + 0.3 * rng.standard_normal(n) > 0).astype(np.float32)
    dense[rng.random((n, 4)) < 0.03] = np.nan
    cats[rng.random((n, 6)) < 0.03] = np.nan
    return np.concatenate([y[:, None], dense, cats], axis=1)


def _source(X, rows=1000):
    def open_stream():
        for s in range(0, len(X), rows):
            yield X[s:s + rows]
    return open_stream


def _theta(model):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in model.theta.items()}


def _fit_port(session, X, rows=1000, fit_kw=None, **kw):
    est = StreamingHashedLinearEstimator(**{**BASE, **kw})
    return est.fit_stream(_source(X, rows), session=session, cache_device=True,
                          **(fit_kw or {}))


def _fit_ref(session, X, rows=1000, fit_kw=None, **kw):
    est = JEstimator(**{**BASE, **kw})
    return est.fit_stream(_source(X, rows), session=session, cache_device=True,
                          **(fit_kw or {}))


def _assert_theta_close(ours, ref):
    got, want = _theta(ours), _theta(ref)
    for name in ("emb", "coef", "intercept"):
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("lowering", ["plan", "sort"])
@pytest.mark.parametrize("cache_dtype", ["bf16", "packed"])
def test_theta_matches_reference_fused(jax_session, cpu, raw, cache_dtype, lowering,
                                       defer):
    kw = dict(cache_dtype=cache_dtype, sparse_lowering=lowering, defer_epoch1=defer)
    st: dict = {}
    ours = _fit_port(cpu, raw, fit_kw={"stage_times": st}, **kw)
    ref = _fit_ref(jax_session, raw, **kw)
    _assert_theta_close(ours, ref)
    assert ours.n_steps_ == ref.n_steps_ == 16
    np.testing.assert_allclose(ours.final_loss_, ref.final_loss_, rtol=1e-5)
    assert np.abs(_theta(ours)["emb"]).max() > 1e-3         # the table trained
    assert st["cache_dtype"] == cache_dtype and st["replay_source"] == "fused"
    assert st["cache_raw_bytes"] > st["cache_bytes"] > 0
    assert len(st["epoch_s"]) == 2 and st["encode_s"] > 0


@pytest.mark.parametrize("cache_dtype", ["f32", "packed"])
@pytest.mark.parametrize("reg", [0.0, 1e-3])
def test_adam_default_rule_matches_reference(jax_session, cpu, raw, cache_dtype, reg):
    """``StreamingHashedLinearEstimator()``'s rule is 'adam' (optax.adam(1.0)
    scaled by lr, in-loss L2): theta and the final loss (which includes the
    L2 term) against the reference's, atol 1e-6 / rtol 1e-5."""
    assert thl.HashedLinearParams().optim_update == "adam"
    kw = dict(optim_update="adam", reg_param=reg, cache_dtype=cache_dtype, step_size=0.02)
    ours, ref = _fit_port(cpu, raw, **kw), _fit_ref(jax_session, raw, **kw)
    _assert_theta_close(ours, ref)
    np.testing.assert_allclose(ours.final_loss_, ref.final_loss_, rtol=1e-5)
    assert ours.n_steps_ == 16


def test_default_estimator_fits(cpu, raw):
    """The params' defaults (adam, f32 cache, one epoch) fit as they are."""
    est = StreamingHashedLinearEstimator(n_dims=1 << 10, n_dense=4, n_cat=6,
                                         label_in_chunk=True, chunk_rows=1024)
    model = est.fit_stream(_source(raw), session=cpu)
    assert model.n_steps_ == 4 and np.isfinite(model.final_loss_)
    assert model.params.optim_update == "adam"


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("lowering", ["plan", "sort"])
def test_spill_replay_bitwise_equals_cache_replay(cpu, raw, tmp_path, lowering, fused):
    """A cache budget below the data replays from the disk spill: theta is
    bitwise the device-cache replay's. 256-row chunks make 16 records, so
    the fused spill replay trains groups of records as one replay over
    fixed buffers, and a partial last group step by step."""
    kw = dict(cache_dtype="packed", sparse_lowering=lowering, defer_epoch1=True,
              fused_replay=fused, chunk_rows=256, epochs=3)
    payload = thl.estimate_cached_chunk_bytes(
        thl.HashedLinearParams(**{**BASE, **kw}), cpu)
    budget = 9 * payload          # the cache overflows; a group is 2 records
    st: dict = {}
    spilled = _fit_port(cpu, raw, rows=700, fit_kw=dict(
        cache_device_bytes=budget, cache_spill_dir=str(tmp_path), holdout_chunks=1,
        stage_times=st), **kw)
    cached = _fit_port(cpu, raw, rows=700, fit_kw=dict(holdout_chunks=1), **kw)
    assert st["replay_source"] == "disk" and st["cache_overflow"]
    assert (st.get("disk_replay_group") == 2) == fused
    assert spilled.n_steps_ == cached.n_steps_ == 3 * 15
    for name, want in _theta(cached).items():
        assert np.array_equal(_theta(spilled)[name], want), name
    assert spilled.final_loss_ == cached.final_loss_
    assert list(tmp_path.iterdir()) == []            # the spill is released


def test_evaluate_device_packed_holdout_matches_reference(jax_session, cpu, raw):
    """One theta (the reference's, through interop), evaluated on each
    package's packed holdout chunks: the same rows, the same sums."""
    kw = dict(cache_dtype="packed", sparse_lowering="sort")
    ref = _fit_ref(jax_session, raw, fit_kw={"holdout_chunks": 1}, **kw)
    ours = _fit_port(cpu, raw, fit_kw={"holdout_chunks": 1}, **kw)
    assert ours.cache_codec_.mode == "packed"
    assert isinstance(ours.holdout_chunks_[0][0], dict)
    model = interop.hashed_linear_model(
        {k: np.asarray(v) for k, v in ref.state_pytree.items()}, ref.params.to_dict(),
        ref.class_values, device="cpu")
    model.cache_codec_ = ours.cache_codec_
    got = model.evaluate_device(ours.holdout_chunks_)
    want = ref.evaluate_device(ref.holdout_chunks_)
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["auc"] - want["auc"]) <= 1e-6
    np.testing.assert_allclose(got["logloss"], want["logloss"], rtol=1e-6)
    # the fit's own model decodes its chunks by its recorded codec
    own = ours.evaluate_device(ours.holdout_chunks_)
    assert abs(own["auc"] - want["auc"]) <= 1e-4


def test_granularity_and_warm_replay_change_nothing(cpu, raw):
    """'epoch' granularity (groups of 3 epochs, a sync between groups) and
    a ``warm_replay`` before the fit give the 'all' fit's theta bitwise;
    ``warm_replay`` returns a theta and the salts, and None where the fit
    has no fused replay."""
    kw = dict(cache_dtype="packed", sparse_lowering="sort", defer_epoch1=True, epochs=5)
    base = _theta(_fit_port(cpu, raw, **kw))
    est = StreamingHashedLinearEstimator(**{**BASE, **kw})
    theta, salts = est.warm_replay(4, session=cpu)
    assert theta["emb"].shape == (BASE["n_dims"], 1)
    assert np.array_equal(salts, thl.column_salts(6, 0))
    after_warm = _theta(est.fit_stream(_source(raw), session=cpu, cache_device=True))
    st: dict = {}
    grouped = _fit_port(cpu, raw, replay_granularity="epoch", epochs_per_dispatch=3,
                        fit_kw={"stage_times": st}, **{k: v for k, v in kw.items()
                                                       if k != "epochs"}, epochs=5)
    assert st["replay_source"] == "fused_epoch"
    for name in base:
        assert np.array_equal(after_warm[name], base[name])
        assert np.array_equal(_theta(grouped)[name], base[name])
    assert StreamingHashedLinearEstimator(**{**BASE, "fused_replay": False}).warm_replay(
        4, session=cpu) is None
    assert StreamingHashedLinearEstimator(**{**BASE, "epochs": 1}).warm_replay(
        4, session=cpu) is None


@pytest.mark.parametrize("rule", ["sparse_adagrad", "adam"])
def test_step_state_is_updated_in_place(cpu, raw, rule):
    """The step counter is a device int32 scalar that the step advances,
    and every state tensor keeps its address across steps (what a captured
    replay needs); ``n_valid`` as a device scalar (a refilled replay
    buffer) steps exactly as the int."""
    p = thl.HashedLinearParams(**{**BASE, "optim_update": rule, "sparse_lowering": "sort",
                                  "cache_dtype": "packed"})
    theta, opt, salts_np, salts, kw = thl._init_fit_state(p, cpu)
    counter = "count" if rule == "adam" else "step"
    assert opt[counter].dtype == torch.int32 and opt[counter].dim() == 0
    Xp = raw[:1024].copy()
    Xp[700:] = 0.0
    enc = thl._encode_chunk_np(kw["codec"], Xp, salts_np)
    chunk = ({k: torch.from_numpy(thl._torch_view(v)) for k, v in enc.items()}, 700,
             None, None)
    ptrs = {k: v.data_ptr() for k, v in theta.items()}
    counter_ptr = opt[counter].data_ptr()
    hyper = (1e-3, 0.05, 0.0)
    twin = (thl._clone_tree(theta), thl._clone_tree(opt))
    for _ in range(3):
        thl._step_into(theta, opt, chunk, salts, hyper, kw)
    assert int(opt[counter]) == 3 and opt[counter].data_ptr() == counter_ptr
    assert {k: v.data_ptr() for k, v in theta.items()} == ptrs
    slot = thl._chunk_slot(chunk)
    thl._fill_slot(slot, chunk)
    assert slot[1].dtype == torch.int32 and int(slot[1]) == 700
    for _ in range(3):
        thl._step_into(*twin, slot, salts, hyper, kw)
    for name in theta:
        assert torch.equal(theta[name], twin[0][name]), name
