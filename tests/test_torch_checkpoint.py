"""Checkpoint and resume of the port's Criteo fit, on the CPU.

* ``utils/fault.StreamCheckpointer``: round trip, the meta check, an atomic
  write that a crash cannot tear; its snapshots cross between the two
  packages in both directions.
* Kill and resume against the port's own uninterrupted fit, bitwise: theta,
  the optimizer state at every snapshot both runs took after the resume
  point (the last one is the fit's end), and ``n_steps_``. The cases
  mirror the JAX package's drills: per-step snapshots
  (``tests/test_hashed_linear.py``), ``defer_epoch1`` with
  ``replay_granularity='epoch'`` killed mid-replay
  (``tests/test_hashed_defer.py``), ``checkpoint_every_epochs``, resume at
  completion, and a snapshot written off an epoch boundary.
* Cross-package resume: the JAX package's fit is killed after its second
  snapshot and the port resumes from that snapshot; its theta lies within
  1e-6 of the JAX package's uninterrupted theta (float32 rounding of XLA's
  fused sums against PyTorch's, as in ``tests/test_torch_hashed.py``).
"""

import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.io.streaming import array_chunk_source as j_array_source
from orange3_spark_tpu.models.hashed_linear import (
    StreamingHashedLinearEstimator as JEstimator,
)
from orange3_spark_tpu.utils import fault as j_fault
from orange3_spark_tpu_torch import TorchSession, interop
from orange3_spark_tpu_torch.io.streaming import array_chunk_source
from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
from orange3_spark_tpu_torch.utils import fault as t_fault

from tests.test_torch_hashed import _criteo_shaped


@pytest.fixture(scope="module")
def cpu():
    return TorchSession("cpu")


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def data():
    # 4096 rows: four 1024-row chunks, or eight of 512
    return _criteo_shaped(4096, seed=21)


class Killed(RuntimeError):
    pass


class Recorder(t_fault.StreamCheckpointer):
    """Keeps a host copy of every state it saves (``saves[step]``) and, with
    ``die_after``, raises right after that many saves have landed."""

    def __init__(self, path, every_steps, die_after=None):
        super().__init__(path, every_steps=every_steps)
        self.saves, self.die_after = {}, die_after

    def save(self, step, state, meta=None):
        super().save(step, state, meta)
        self.saves[step] = t_fault.host_tree(state)
        if self.die_after is not None and len(self.saves) >= self.die_after:
            raise Killed("injected fault")


def _tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _theta(model):
    return {k: v.cpu().numpy() for k, v in model.theta.items()}


# ------------------------------------------------------- the checkpointer

def test_checkpointer_round_trip_and_meta(tmp_path):
    ck = t_fault.StreamCheckpointer(str(tmp_path / "a" / "ck"), every_steps=3)
    assert ck.load() == (0, None)
    state = {"theta": {"emb": torch.arange(6.0).view(3, 2)},
             "opt_state": {"step": torch.tensor(4, dtype=torch.int32)}}
    assert not ck.maybe_save(4, state, meta={"k": 1})
    assert ck.maybe_save(6, state, meta={"k": 1})
    step, got = ck.load(expect_meta={"k": 1})
    assert step == 6
    assert isinstance(got["theta"]["emb"], np.ndarray)
    assert got["opt_state"]["step"].dtype == np.int32
    _tree_equal(got, t_fault.host_tree(state))
    with pytest.raises(ValueError, match="different configuration"):
        ck.load(expect_meta={"k": 2})
    ck.delete()
    assert ck.load() == (0, None)


def test_crash_inside_pickle_leaves_the_old_snapshot(tmp_path, monkeypatch):
    path = tmp_path / "ck"
    ck = t_fault.StreamCheckpointer(str(path))
    ck.save(1, {"x": np.arange(4)})

    def torn(obj, f, *a, **kw):
        f.write(b"half a snapshot")
        raise KeyboardInterrupt

    monkeypatch.setattr(t_fault.pickle, "dump", torn)
    with pytest.raises(KeyboardInterrupt):
        ck.save(2, {"x": np.arange(8)})
    monkeypatch.undo()
    step, state = ck.load()
    assert step == 1
    np.testing.assert_array_equal(state["x"], np.arange(4))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".ckpt.tmp")]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshots_cross_between_the_packages(tmp_path, writer):
    """Either package's StreamCheckpointer reads the other's snapshot: the
    same pickle layout, numpy leaves (the port copies tensors to the host),
    the same meta check."""
    rng = np.random.default_rng(3)
    state = {"theta": {"emb": rng.standard_normal((8, 1)).astype(np.float32)},
             "opt_state": {"step": np.int32(5), "t": np.arange(8, dtype=np.int32),
                           "slots": {"emb": {"acc": np.ones((8, 1), np.float32)}}}}
    meta = {"params": {"n_dims": 8}, "k": 1}
    path = str(tmp_path / "ck")
    mods = {"jax": j_fault, "torch": t_fault}
    reader = mods["torch" if writer == "jax" else "jax"]
    written = state
    if writer == "torch":   # the port hands it tensors
        written = {"theta": {"emb": torch.from_numpy(state["theta"]["emb"])},
                   "opt_state": state["opt_state"]}
    mods[writer].StreamCheckpointer(path).save(5, written, meta=meta)
    step, got = reader.StreamCheckpointer(path).load(expect_meta=meta)
    assert step == 5
    _tree_equal(got, state)
    with pytest.raises(ValueError, match="different configuration"):
        reader.StreamCheckpointer(path).load(expect_meta={"k": 2})


# ------------------------------------------------------- kill and resume

BASE = dict(n_dims=1 << 10, n_dense=4, n_cat=6, step_size=0.05, reg_param=1e-4)

# name: (params, chunk rows, cache_device, every_steps, die_after, cache budget)
DRILLS = {
    # per-step snapshots, the per-chunk path (tests/test_hashed_linear.py)
    "per_step_adam": (dict(epochs=2), 512, False, 4, 2, None),
    "per_step_sparse": (dict(epochs=2, optim_update="sparse_adagrad"), 512, False, 4, 2,
                        None),
    # defer + epoch granularity: epoch snapshots between replays, killed
    # after the 3rd, mid-replay (tests/test_hashed_defer.py)
    "defer_epoch": (dict(epochs=6, replay_granularity="epoch", defer_epoch1=True), 1024,
                    True, 4, 3, None),
    "defer_epoch_sparse_sort": (dict(epochs=6, replay_granularity="epoch",
                                     defer_epoch1=True, optim_update="sparse_adagrad",
                                     sparse_lowering="sort", cache_dtype="packed"),
                                1024, True, 4, 3, None),
    # checkpoint_every_epochs=2, epochs_per_dispatch=3 (groups clamped to
    # the snapshot boundaries), not deferred: epoch 1 streams
    "every_epochs": (dict(epochs=7, replay_granularity="epoch", checkpoint_every_epochs=2,
                          epochs_per_dispatch=3), 1024, True, 1000, 2, None),
    # the snapshot covers the whole fit: the resume runs nothing
    "at_completion": (dict(epochs=3, replay_granularity="epoch", defer_epoch1=True), 1024,
                      True, 4, 3, None),
    # runs starved of cache: the stream replay snapshots every 3 steps, the
    # 3rd at step 9 of 4-chunk epochs; the resume (ample cache) must take
    # the per-chunk replay, which skips at step grain
    "off_boundary": (dict(epochs=4, replay_granularity="epoch", defer_epoch1=True), 1024,
                     True, 3, 3, 1 << 14),
}


@pytest.mark.parametrize("name", list(DRILLS))
def test_kill_and_resume_is_bitwise(cpu, data, tmp_path, name):
    import warnings

    kw, chunk, cache, every, die_after, budget = DRILLS[name]
    X, y = data
    src = array_chunk_source(X, y, chunk_rows=chunk)

    def fit(ck, cache_bytes=8 << 30):
        est = StreamingHashedLinearEstimator(**BASE, **kw, chunk_rows=chunk)
        return est.fit_stream(src, session=cpu, cache_device=cache,
                              cache_device_bytes=cache_bytes, checkpointer=ck)

    clean_ck = Recorder(str(tmp_path / "clean"), every)
    path = str(tmp_path / "killed")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")           # a starved cache warns
        clean = fit(clean_ck, cache_bytes=budget or 8 << 30)
        with pytest.raises(Killed):
            fit(Recorder(path, every, die_after=die_after), cache_bytes=budget or 8 << 30)
    assert not os.path.exists(clean_ck.path)      # deleted on success
    step, _ = t_fault.StreamCheckpointer(path).load()
    assert step > 0
    if name == "off_boundary":
        assert step % 4 != 0                      # genuinely off an epoch boundary
    resumed_ck = Recorder(path, every)
    resumed = fit(resumed_ck)
    _tree_equal(_theta(resumed), _theta(clean))
    assert resumed.n_steps_ == clean.n_steps_
    later = sorted(s for s in resumed_ck.saves if s > step)
    assert set(later) <= set(clean_ck.saves)
    for s in later:
        _tree_equal(resumed_ck.saves[s], clean_ck.saves[s])
    if name == "at_completion":
        assert step == clean.n_steps_ and not later and resumed.final_loss_ is None
    else:
        assert later
        # the fit's end compared too (the per-step cadence of the starved
        # run ends at step 15 of 16)
        assert later[-1] == clean.n_steps_ - (name == "off_boundary")
        assert resumed.final_loss_ == clean.final_loss_


@pytest.mark.parametrize("rule", ["sparse_adagrad", "adam"])
def test_port_resumes_a_jax_snapshot(cpu, jax_session, data, tmp_path, rule):
    """The JAX package's fit, killed after its 2nd snapshot; the port resumes
    from that snapshot and lands within 1e-6 of the JAX package's
    uninterrupted theta. The two packages' params are the same dict, so
    the snapshot's meta check passes."""
    X, y = data
    kw = dict(**BASE, epochs=2, chunk_rows=512, optim_update=rule)
    assert JEstimator(**kw).params.to_dict() == StreamingHashedLinearEstimator(
        **kw).params.to_dict()
    ref = JEstimator(**kw).fit_stream(j_array_source(X, y, chunk_rows=512),
                                      session=jax_session)
    path = str(tmp_path / "jax.ckpt")

    class JKiller(j_fault.StreamCheckpointer):
        saves = 0

        def save(self, step, state, meta=None):
            super().save(step, state, meta)
            JKiller.saves += 1
            if JKiller.saves >= 2:
                raise Killed("injected fault")

    with pytest.raises(Killed):
        JEstimator(**kw).fit_stream(j_array_source(X, y, chunk_rows=512),
                                    session=jax_session,
                                    checkpointer=JKiller(path, every_steps=3))
    assert t_fault.StreamCheckpointer(path).load()[0] == 6
    ours = StreamingHashedLinearEstimator(**kw).fit_stream(
        array_chunk_source(X, y, chunk_rows=512), session=cpu,
        checkpointer=t_fault.StreamCheckpointer(path, every_steps=3))
    want = {k: np.asarray(v) for k, v in ref.theta.items()}
    for k, got in _theta(ours).items():
        np.testing.assert_allclose(got, want[k], atol=1e-6, rtol=0, err_msg=k)
    assert ours.n_steps_ == ref.n_steps_ == 16


@pytest.mark.parametrize("rule", ["sparse_adagrad", "adam"])
def test_fit_state_layouts_convert_both_ways(tmp_path, rule, jax_session):
    """``interop.hashed_fit_state`` reads the JAX package's snapshot state
    (optax's tuple for adam) into the port's dicts, and
    ``jax_hashed_fit_state`` gives it back, leaf for leaf."""
    from orange3_spark_tpu.models.hashed_linear import HashedLinearParams, _init_fit_state

    p = HashedLinearParams(**BASE, optim_update=rule)
    theta, opt, *_ = _init_fit_state(p, jax_session)
    rng = np.random.default_rng(0)
    j_state = jax.tree.map(lambda a: np.asarray(a) + rng.integers(0, 3, np.shape(a))
                           .astype(np.asarray(a).dtype), {"theta": theta, "opt_state": opt})
    ours = interop.hashed_fit_state(j_state)
    if rule == "adam":
        assert set(ours["opt_state"]) == {"count", "mu", "nu"}
        np.testing.assert_array_equal(ours["opt_state"]["mu"]["emb"],
                                      j_state["opt_state"][0].mu["emb"])
    back = interop.jax_hashed_fit_state(
        ours, adam_state=lambda c, m, n: (optax.ScaleByAdamState(c, m, n),
                                          optax.EmptyState()))
    assert jax.tree.structure(back) == jax.tree.structure(j_state)
    jax.tree.map(np.testing.assert_array_equal, back, j_state)
    if rule == "adam":
        with pytest.raises(ValueError, match="adam_state"):
            interop.jax_hashed_fit_state(ours)
    with open(tmp_path / "s.pkl", "wb") as f:     # numpy leaves only
        pickle.dump(ours, f)
