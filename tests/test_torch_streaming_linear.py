"""The port's dense streaming fit (``StreamingLinearEstimator``) and its
chunk sources against the JAX package's, on the CPU and the same numpy
inputs: theta for the three losses (k = 2 and 3 for logistic), every
schedule held to the default one bit for bit (the cached replay, the
deferred epoch 1, epoch-granular replay with several epochs a call, the
disk spill, a bf16 cache against its own default), kill-and-resume at both
granularities, a resume from the JAX package's snapshot, a fit under
source faults, a wedged fit, the label range error; then the CSV and
parquet chunk sources bitwise.

The JAX side runs on a one-device session. Tolerance against it: theta
within 1e-5 · max|θ| after 4 epochs. Both take the same adam steps on the
same chunks; what differs is float32 rounding (XLA's dot against MKL's,
``log_softmax``'s autodiff against the port's softmax form of its
gradient, ``exp``/``sqrt`` a few ulps apart), which adam's normalised
steps carry along without growing past that.
"""

import os

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.io import streaming as jstream
from orange3_spark_tpu.utils.fault import StreamCheckpointer as JCheckpointer
from orange3_spark_tpu_torch import TorchSession, interop
from orange3_spark_tpu_torch.io import streaming as tstream
from orange3_spark_tpu_torch.resilience import faults as t_faults
from orange3_spark_tpu_torch.utils.fault import StreamCheckpointer

BASE = dict(epochs=4, step_size=0.05, reg_param=1e-3, chunk_rows=1024)
CHUNK = 1000        # source chunks: rechunked into 1024-row padded batches
N_ROWS = 3000       # the last batch holds 952 live rows: padding every epoch
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def cpu():
    return TorchSession("cpu")


def _data(k: int, n=N_ROWS, d=8, seed=0):
    """Separable-ish data: labels from a noisy linear score (k classes, or
    a continuous target for k = 1)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((d, max(k, 1)))
    s = X @ W + 0.3 * rng.standard_normal((n, max(k, 1)))
    if k == 1:
        return X, s[:, 0].astype(np.float32)
    if k == 2:
        return X, (s[:, 0] > 0).astype(np.float32)
    return X, s.argmax(1).astype(np.float32)


LOSSES = [("logistic", 2), ("logistic", 3), ("squared", 1), ("squared_hinge", 2)]


def _port_fit(session, X, y, *, fit_kw=None, **kw):
    est = tstream.StreamingLinearEstimator(**{**BASE, **kw})
    src = tstream.array_chunk_source(X, y, chunk_rows=CHUNK)
    return est.fit_stream(src, n_features=X.shape[1], session=session, **(fit_kw or {}))


def _ref_fit(session, X, y, fit_kw=None, **kw):
    est = jstream.StreamingLinearEstimator(**{**BASE, **kw})
    return est.fit_stream(jstream.array_chunk_source(X, y, chunk_rows=CHUNK),
                          n_features=X.shape[1], session=session, **(fit_kw or {}))


def _theta(model) -> dict:
    out = {}
    for name in ("coef", "intercept"):
        v = getattr(model, name)
        out[name] = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _bitwise(a, b) -> bool:
    ta, tb = _theta(a), _theta(b)
    return all(np.array_equal(ta[k], tb[k]) for k in ta)


# ------------------------------------------------------------ theta vs reference

@pytest.mark.parametrize("loss,k", LOSSES)
def test_theta_matches_reference(jax_session, cpu, loss, k):
    X, y = _data(1 if loss == "squared" else k)
    kw = dict(loss=loss, n_classes=max(k, 2))
    ours = _port_fit(cpu, X, y, **kw, fit_kw=dict(cache_device=True))
    ref = _ref_fit(jax_session, X, y, **kw, fit_kw=dict(cache_device=True))
    assert type(ours).__name__ == type(ref).__name__
    got, want = _theta(ours), _theta(ref)
    scale = max(np.abs(want["coef"]).max(), np.abs(want["intercept"]).max())
    for name in got:
        assert got[name].shape == want[name].shape, name
        assert np.abs(got[name] - want[name]).max() <= REL_TOL * scale, name
    assert ours.n_steps_ == ref.n_steps_ == 12
    np.testing.assert_allclose(ours.final_loss_, ref.final_loss_, rtol=1e-5)
    assert scale > 0.05                               # the fit really moved
    # the reference's model through interop predicts as the port's own
    if loss == "logistic":
        conv = interop.logistic_regression(
            {k_: np.asarray(v) for k_, v in ref.state_pytree.items()},
            ref.params.to_dict(), ref.class_values, device="cpu")
    elif loss == "squared":
        conv = interop.linear_regression(
            {k_: np.asarray(v) for k_, v in ref.state_pytree.items()},
            ref.params.to_dict(), device="cpu")
    else:
        conv = interop.linear_svc({k_: np.asarray(v) for k_, v in ref.state_pytree.items()},
                                  ref.params.to_dict(), ref.class_values, device="cpu")
    assert _bitwise(conv, ref)


# ------------------------------------------------------------ schedules, bitwise

SCHEDULES = {
    "stream": (dict(), dict()),
    "defer": (dict(defer_epoch1=True), dict(cache_device=True)),
    "epoch_k2": (dict(replay_granularity="epoch", epochs_per_dispatch=2),
                 dict(cache_device=True)),
    "defer_epoch_k3": (dict(defer_epoch1=True, replay_granularity="epoch",
                            epochs_per_dispatch=3), dict(cache_device=True)),
    # a budget of 1.5x the cache: it holds the cache, not the reference's stack
    "per_chunk_cache": (dict(), dict(cache_device=True, cache_budget_x=1.5)),
    "spill": (dict(), dict(cache_device=True, cache_device_bytes=50_000, spill=True)),
}


@pytest.mark.parametrize("schedule,cache_dtype", [
    (s, dt) for s in sorted(SCHEDULES) for dt in ("f32", "bf16")
    if not (s == "stream" and dt == "bf16")])     # nothing is cached to store as bf16
def test_schedules_are_bitwise_the_cached_default(cpu, tmp_path, schedule, cache_dtype):
    """Every schedule trains the same steps on the same chunks: its theta is
    bitwise the cached default's of the same cache dtype. 'per_chunk_cache'
    holds the cache but fails the half-budget gate (per-chunk replay);
    'spill' overflows the cache and replays from the disk."""
    X, y = _data(3)
    kw = dict(n_classes=3, cache_dtype=cache_dtype)
    base = _port_fit(cpu, X, y, **kw, fit_kw=dict(cache_device=True))
    params, fit_kw = SCHEDULES[schedule]
    fit_kw = dict(fit_kw)
    st: dict = {}
    if fit_kw.pop("spill", False):
        fit_kw["cache_spill_dir"] = str(tmp_path)
    if "cache_budget_x" in fit_kw:
        chunk_bytes = 1024 * (X.shape[1] * (2 if cache_dtype == "bf16" else 4) + 8)
        fit_kw["cache_device_bytes"] = int(fit_kw.pop("cache_budget_x") * 3 * chunk_bytes)
    got = _port_fit(cpu, X, y, **kw, **params, fit_kw=dict(fit_kw, stage_times=st))
    assert _bitwise(got, base), schedule
    assert got.n_steps_ == base.n_steps_ == 12
    want_source = {"stream": "stream", "defer": "fused", "epoch_k2": "fused_epoch",
                   "defer_epoch_k3": "fused_epoch", "per_chunk_cache": "hbm",
                   "spill": "disk"}[schedule]
    assert st["replay_source"] == want_source
    assert not os.listdir(tmp_path)          # the spill is gone with the fit


def test_bf16_cache_matches_reference_and_differs_from_f32(jax_session, cpu):
    X, y = _data(2)
    kw = dict(cache_dtype="bf16")
    ours = _port_fit(cpu, X, y, **kw, fit_kw=dict(cache_device=True))
    ref = _ref_fit(jax_session, X, y, **kw, fit_kw=dict(cache_device=True))
    got, want = _theta(ours), _theta(ref)
    scale = np.abs(want["coef"]).max()
    for name in got:
        assert np.abs(got[name] - want[name]).max() <= REL_TOL * scale, name
    f32 = _theta(_port_fit(cpu, X, y, fit_kw=dict(cache_device=True)))
    assert not np.array_equal(f32["coef"], got["coef"])     # the cache really held bf16


# ------------------------------------------------------------ recovery

class _Killed(RuntimeError):
    pass


def _dying(cls, path, every_steps, die_after):
    class Dying(cls):
        saves = 0

        def save(self, step, state, meta=None):
            super().save(step, state, meta)
            Dying.saves += 1
            if Dying.saves >= die_after:
                raise _Killed(f"killed after save {Dying.saves}")

    return Dying(path, every_steps=every_steps)


@pytest.mark.parametrize("granularity", ["all", "epoch"])
def test_kill_and_resume_is_bitwise(cpu, tmp_path, granularity):
    """A fit killed right after a snapshot and run again with the same
    checkpointer path resumes to the uninterrupted fit's bits, and deletes
    its snapshot. 'all' with a checkpointer steps chunk by chunk and
    snapshots every 5 steps (off the epoch boundaries); 'epoch' defers
    epoch 1 and snapshots every epoch between replay calls."""
    X, y = _data(2)
    if granularity == "all":
        kw, every = dict(), 5
    else:
        kw, every = dict(replay_granularity="epoch", defer_epoch1=True,
                         checkpoint_every_epochs=1), 1000
    clean = _port_fit(cpu, X, y, **kw, fit_kw=dict(cache_device=True))
    path = str(tmp_path / "ckpt.pkl")
    with pytest.raises(_Killed):
        _port_fit(cpu, X, y, **kw, fit_kw=dict(
            cache_device=True, checkpointer=_dying(StreamCheckpointer, path, every, 2)))
    assert os.path.exists(path)
    resumed = _port_fit(cpu, X, y, **kw, fit_kw=dict(
        cache_device=True, checkpointer=StreamCheckpointer(path, every_steps=every)))
    assert _bitwise(resumed, clean)
    assert resumed.n_steps_ == clean.n_steps_
    assert not os.path.exists(path)


def test_resumes_from_the_reference_snapshot(jax_session, cpu, tmp_path):
    """A JAX fit killed after its second per-step snapshot (optax's adam
    tuple inside); the port resumes from that file (``interop.
    streaming_linear_fit_state``) and ends within tolerance of the
    reference's uninterrupted fit. The port's own snapshot converts back
    into the JAX package's layout."""
    import optax

    X, y = _data(2)
    path = str(tmp_path / "ckpt.pkl")
    with pytest.raises(_Killed):
        _ref_fit(jax_session, X, y, fit_kw=dict(
            checkpointer=_dying(JCheckpointer, path, 4, 2)))
    resumed = _port_fit(cpu, X, y, fit_kw=dict(
        checkpointer=StreamCheckpointer(path, every_steps=4)))
    ref = _ref_fit(jax_session, X, y)
    got, want = _theta(resumed), _theta(ref)
    scale = np.abs(want["coef"]).max()
    for name in got:
        assert np.abs(got[name] - want[name]).max() <= REL_TOL * scale, name
    state = {"theta": {"coef": np.ones((8, 2), np.float32), "intercept": np.zeros(2)},
             "opt_state": {"count": np.int32(3), "mu": {"coef": np.ones((8, 2))},
                           "nu": {"coef": np.ones((8, 2))}}}
    back = interop.jax_streaming_linear_fit_state(
        state, adam_state=lambda c, m, n: (optax.ScaleByAdamState(c, m, n),
                                           optax.EmptyState()))
    assert int(back["opt_state"][0].count) == 3
    assert interop.streaming_linear_fit_state(back)["opt_state"]["count"] == 3


FAULT_SPEC = "source_io:every=7,fails=2;slow_source:every=8,delay_ms=5"


def test_source_faults_recover_bitwise(cpu, monkeypatch):
    """bench.py's fault spec on the stream (transient read errors, a slow
    chunk): the fit retries and ends bitwise the clean fit."""
    X, y = _data(2, n=9000)
    clean = _port_fit(cpu, X, y, epochs=3)
    monkeypatch.setenv("OTPU_RETRY_BASE_S", "0.001")
    st: dict = {}
    with t_faults.inject_faults(FAULT_SPEC):
        faulted = _port_fit(cpu, X, y, epochs=3, fit_kw=dict(stage_times=st))
    assert st["retries"] > 0
    assert _bitwise(faulted, clean)


def test_wedged_fit_raises_typed(cpu, monkeypatch):
    """``wedge:at=1,hold_s=30`` under a 0.25 s budget: the first guarded
    wait of the fit holds and the fit raises ``DispatchWedgedError`` within
    about a second of that wait. The window opens at the first guarded
    wait, so the fit's set-up before it (a clean fit first pays the
    one-time costs) is outside it."""
    import time

    from orange3_spark_tpu_torch.resilience import DispatchWedgedError
    from orange3_spark_tpu_torch.resilience import watchdog
    from orange3_spark_tpu_torch.resilience.overload import reset_wedge_breaker

    X, y = _data(2, n=40 * 256)
    _port_fit(cpu, X, y, epochs=1, chunk_rows=256)
    first_wait = []
    guarded = watchdog.guarded_block_until_ready

    def timed_guarded(*args, **kw):
        first_wait.append(time.perf_counter())
        return guarded(*args, **kw)

    monkeypatch.setattr(watchdog, "guarded_block_until_ready", timed_guarded)
    monkeypatch.setenv("OTPU_DISPATCH_BUDGET_S", "0.25")
    reset_wedge_breaker()
    try:
        with t_faults.inject_faults("wedge:at=1,hold_s=30"):
            with pytest.raises(DispatchWedgedError):
                _port_fit(cpu, X, y, epochs=1, chunk_rows=256)
            assert time.perf_counter() - first_wait[0] < 1.5
    finally:
        reset_wedge_breaker()


def test_label_out_of_range_raises(cpu):
    X, y = _data(3)
    with pytest.raises(ValueError, match="out of range for k=2"):
        _port_fit(cpu, X, y, n_classes=2)
    with pytest.raises(ValueError, match="replay_granularity"):
        _port_fit(cpu, X, y, n_classes=3, replay_granularity="epochs")


def test_fit_protocol_on_a_table(cpu):
    """``Estimator.fit`` streams a TorchTable in chunks, with the table's
    class values."""
    from orange3_spark_tpu_torch import TorchTable

    X, y = _data(2)
    t = TorchTable.from_arrays(X, y, class_values=("no", "yes"), session=cpu)
    model = tstream.StreamingLinearEstimator(**BASE).fit(t)
    assert model.class_values == ("no", "yes")
    assert np.mean(np.asarray(model.predict(t)) == y) > 0.9


# ------------------------------------------------------------ chunk sources

def _chunks_equal(ours, ref) -> None:
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert (u is None) == (v is None)
            if u is not None:
                assert u.dtype == v.dtype and np.array_equal(u, v, equal_nan=True)


@pytest.fixture(scope="module")
def table_files(tmp_path_factory):
    """One table as a CSV (with a NaN cell) and as a parquet file of three
    row groups."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path_factory.mktemp("sources")
    rng = np.random.default_rng(5)
    A = rng.standard_normal((700, 4)).astype(np.float32)
    A[3, 1] = np.nan
    names = ["a", "label", "b", "c"]
    csv = str(d / "t.csv")
    with open(csv, "w") as f:
        f.write(",".join(names) + "\n")
        for row in A:
            f.write(",".join("" if np.isnan(v) else f"{v:.9g}" for v in row) + "\n")
    pqf = str(d / "t.parquet")
    pq.write_table(pa.table({n: A[:, j] for j, n in enumerate(names)}), pqf,
                   row_group_size=300)
    return csv, pqf


@pytest.mark.parametrize("class_col", ["label", ""])
def test_csv_chunk_source_bitwise(table_files, class_col):
    csv, _ = table_files
    kw = dict(chunk_rows=256)
    _chunks_equal(list(tstream.csv_chunk_source(csv, class_col, **kw)()),
                  list(jstream.csv_chunk_source(csv, class_col, **kw)()))
    with pytest.raises(ValueError, match="not in"):
        list(tstream.csv_chunk_source(csv, "nope")())


@pytest.mark.parametrize("kw", [dict(), dict(row_groups=(0, 2)),
                                dict(columns=("c", "label", "a"))])
def test_parquet_sources_bitwise(table_files, kw):
    _, pqf = table_files
    _chunks_equal(list(tstream.parquet_chunk_source(pqf, "label", chunk_rows=128, **kw)()),
                  list(jstream.parquet_chunk_source(pqf, "label", chunk_rows=128, **kw)()))
    _chunks_equal([(c,) for c in tstream.parquet_raw_chunk_source(pqf, chunk_rows=128,
                                                                  **kw)()],
                  [(c,) for c in jstream.parquet_raw_chunk_source(pqf, chunk_rows=128,
                                                                  **kw)()])
    # shard=True in one process reads every group, as the reference's does
    _chunks_equal(list(tstream.parquet_chunk_source(pqf, "label", chunk_rows=128,
                                                    shard=True, **kw)()),
                  list(jstream.parquet_chunk_source(pqf, "label", chunk_rows=128,
                                                    shard=True, **kw)()))
    with pytest.raises(ValueError, match="not in"):
        list(tstream.parquet_chunk_source(pqf, "nope")())
