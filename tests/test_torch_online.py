"""The port's online loop (``io/reqlog.py``, ``online/``) against the JAX
package's, and on its own.

Against the reference, on inputs made from a numpy seed in one process:

* an OTPURQL1 request log written by one package reads back in the other
  bitwise, record by record, offsets included;
* ``LabelJoiner`` makes the same joins and counts (in-window, late,
  orphan, row mismatch) over one seeded offer sequence;
* ``feature_stats`` and ``DriftDetector`` give the same statistics (the
  same float64 arithmetic on the host: compared exactly) and the same
  gate decisions; ``ShadowScorer`` the same sample, disagreement and
  decision;
* ``IncrementalTrainer``, warm-started from the same model (the
  reference's fit, carried over by ``interop.hashed_linear_model``) and
  fed the same log, ends within ``test_torch_hashed.py``'s tolerance of
  the reference's theta (atol 1e-6, rtol 1e-5), for adam (the params'
  default) and sparse_adagrad (the 'sort' lowering).

On its own: a ``trainer_crash`` resume ends bitwise equal to the
uninterrupted run; the trainer never changes the bits the serving model
serves; the loop publishes, rejects drift typed and is inert under
``OTPU_ONLINE=0``.
"""

from __future__ import annotations

import numpy as np
import pytest

import orange3_spark_tpu.io.reqlog as j_reqlog
import orange3_spark_tpu.online.drift as j_drift
import orange3_spark_tpu.online.shadow as j_shadow
import orange3_spark_tpu_torch.io.reqlog as t_reqlog
import orange3_spark_tpu_torch.online.drift as t_drift
import orange3_spark_tpu_torch.online.shadow as t_shadow
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.fleet import rollout as ro
from orange3_spark_tpu_torch.io.streaming import array_chunk_source
from orange3_spark_tpu_torch.resilience.faults import inject_faults

from _torch_artifacts import artifact_dirs  # noqa: F401

CHUNK = 128
ATOL, RTOL = 1e-6, 1e-5


def _ctr_rows(seed=7, n=1024):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.standard_normal((n, 2)).astype(np.float32),
                        rng.integers(0, 50, (n, 2)).astype(np.float32)], axis=1)
    y = (X[:, 0] + 0.25 * X[:, 1] > 0).astype(np.float32)
    return X, y


def _fill_log(log, X, y, chunk=CHUNK):
    for i in range(0, X.shape[0], chunk):
        rid = log.append_request(X[i:i + chunk])
        log.append_label(rid, y[i:i + chunk])


# ------------------------------------------------------ the request log
@pytest.mark.parametrize("writer,reader", [(j_reqlog, t_reqlog), (t_reqlog, j_reqlog)],
                         ids=["jax_writes", "port_writes"])
def test_request_log_reads_across_packages(tmp_path, writer, reader):
    """Requests of seeded shapes and labels, appended by one package, read
    back by the other: the same records (next offset, ordinal, kind, id,
    array bits), file bytes identical to the other package's write."""
    paths = {}
    for mod in (writer, reader):
        log = mod.RequestLog(str(tmp_path / f"{mod.__name__}.log"))
        r = np.random.default_rng(2)
        for _ in range(6):
            X = r.standard_normal((int(r.integers(1, 40)), 5)).astype(np.float32)
            rid = log.append_request(X)
            if r.random() < 0.7:
                log.append_label(rid, (r.random(X.shape[0]) < 0.5).astype(np.float32))
        log.close()
        paths[mod] = str(tmp_path / f"{mod.__name__}.log")
    raw = {m: open(p, "rb").read() for m, p in paths.items()}
    assert raw[writer] == raw[reader]

    def records(mod, path):
        log = mod.RequestLog(path)
        try:
            return [(nxt, o, k, rid, a.dtype.str, a.shape, a.tobytes())
                    for nxt, o, k, rid, a in log.read_from(log.data_start)]
        finally:
            log.close()

    got, want = records(reader, paths[writer]), records(writer, paths[writer])
    assert got == want and len(got) >= 6


def test_label_joiner_joins_equal_the_reference():
    """One seeded sequence of requests and labels (labels in order, late,
    never logged, of the wrong row count) through both joiners: the same
    joins, the same counts, the same state round trip."""
    rng = np.random.default_rng(6)
    ops = []
    pending = []
    for rid in range(40):
        n = int(rng.integers(1, 9))
        ops.append((0, rid, rng.standard_normal((n, 3)).astype(np.float32)))
        pending.append((rid, n))
        while pending and rng.random() < 0.6:
            prid, pn = pending.pop(int(rng.integers(0, len(pending))))
            rows = pn if rng.random() > 0.1 else pn + 1
            ops.append((1, prid, (rng.random((rows, 1)) < 0.5).astype(np.float32)))
        if rng.random() < 0.05:
            ops.append((1, 1000 + rid, np.zeros((2, 1), np.float32)))
    out = []
    for mod in (j_reqlog, t_reqlog):
        jn = mod.LabelJoiner(window=6)
        res = []
        for k, rid, a in ops:
            kind = mod.KIND_REQUEST if k == 0 else mod.KIND_LABEL
            got = jn.offer(kind, rid, a)
            res.append(None if got is None else (got[0].tobytes(), got[1].tobytes()))
        j2 = mod.LabelJoiner(window=6)
        j2.load_state(jn.state())
        out.append((res, dict(jn.counts), dict(j2.counts)))
    assert out[1] == out[0]
    assert out[1][1]["joined"] > 0 and out[1][1]["late"] > 0 and out[1][1]["orphan"] > 0


# ------------------------------------------------------- the two gates
class _Scorer:
    """A stub model: class 1 where the first column passes its threshold;
    a fixed holdout metric."""

    def __init__(self, thresh=0.0, auc=0.9):
        self.thresh, self.auc = thresh, auc

    def predict_proba(self, X):
        p1 = (X[:, 0] > self.thresh).astype(np.float32)
        return np.stack([1.0 - p1, p1], axis=1)

    def evaluate_stream(self, source):
        return {"auc": self.auc, "accuracy": self.auc}


def _outcome(fn):
    try:
        return ("ok", fn())
    except (j_drift.DriftDetectedError, t_drift.DriftDetectedError,
            j_shadow.ShadowMismatchError, t_shadow.ShadowMismatchError) as e:
        keep = ("kind", "features", "z_scores", "metric_drop", "disagreement",
                "rows_scored", "chunks_scored", "chunks_shed")
        return (type(e).__name__, {k: getattr(e, k) for k in keep if hasattr(e, k)})


@pytest.mark.parametrize("shift", [0.0, 0.4, 5.0])
def test_drift_statistics_and_gate_equal_the_reference(shift):
    """``feature_stats`` of a seeded reference table and the drift gate's
    z-scores and verdicts on shifted traffic and on holdout drops are the
    reference's, exactly."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((2048, 4)).astype(np.float32) * [1, 2, 0.5, 3]
    recent = X[:256].copy()
    recent[:, 1] += shift * 2
    src = array_chunk_source(np.zeros((8, 4), np.float32), np.zeros(8, np.float32),
                             chunk_rows=8)
    res = []
    for mod in (j_drift, t_drift):
        stats = mod.feature_stats(X)
        det = mod.DriftDetector(stats, z_threshold=6.0, holdout_drop=0.02)
        res.append((
            {k: np.asarray(v).tobytes() for k, v in stats.items()},
            _outcome(lambda: det.check_features(recent)),
            _outcome(lambda: det.check_holdout(_Scorer(auc=0.9 - shift / 10), _Scorer(auc=0.9),
                                               src)),
        ))
    assert repr(res[1]) == repr(res[0])


@pytest.mark.parametrize("sample,thresh", [(1.0, 0.25), (0.5, 1.0), (0.5, 0.05)])
def test_shadow_statistics_and_gate_equal_the_reference(sample, thresh):
    """The shadow gate's seeded sample of chunks, its disagreement over the
    scored rows and its verdict are the reference's."""
    rng = np.random.default_rng(3)
    chunks = [(i, rng.standard_normal((16, 2)).astype(np.float32)) for i in range(12)]
    res = []
    for mod in (j_shadow, t_shadow):
        sc = mod.ShadowScorer(_Scorer(0.0), sample=sample, disagree_threshold=thresh)
        res.append([_outcome(lambda: sc.score(_Scorer(t), chunks)) for t in (0.0, 0.3, 2.0)])
    assert repr(res[1]) == repr(res[0])
    assert res[1][0][0] == "ok"


# --------------------------------------------------------- the trainer
@pytest.fixture(scope="module")
def jax_session():
    import jax

    from orange3_spark_tpu.core.session import TpuSession

    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


def _jax_model(jax_session, X, y, **kw):
    from orange3_spark_tpu.io.streaming import array_chunk_source as j_source
    from orange3_spark_tpu.models.hashed_linear import (
        StreamingHashedLinearEstimator as JEst,
    )

    return JEst(n_dims=1 << 8, n_dense=2, n_cat=2, epochs=1, step_size=0.05,
                chunk_rows=CHUNK, **kw).fit_stream(
        j_source(X, y, chunk_rows=CHUNK), session=jax_session)


@pytest.mark.parametrize("optim_update", ["adam", "sparse_adagrad"])
def test_trainer_theta_matches_the_reference(jax_session, tmp_path, optim_update):
    """The reference's model, carried over by ``interop``, warm-starts both
    trainers; each reads the same log (written by the reference) for six
    steps. The candidates' theta agree within atol 1e-6 / rtol 1e-5, the
    steps, examples, offsets and join counts exactly."""
    from orange3_spark_tpu.online.trainer import IncrementalTrainer as JTrainer
    from orange3_spark_tpu_torch import interop
    from orange3_spark_tpu_torch.online.trainer import IncrementalTrainer as TTrainer

    X, y = _ctr_rows()
    kw = {"optim_update": optim_update, "reg_param": 1e-3}
    jm = _jax_model(jax_session, X[:512], y[:512], **kw)
    tm = interop.hashed_linear_model({k: np.asarray(v) for k, v in jm.state_pytree.items()},
                                     jm.params.to_dict(), jm.class_values, device="cpu")
    path = str(tmp_path / "req.log")
    log = j_reqlog.RequestLog(path)
    _fill_log(log, X[256:1024], 1.0 - y[256:1024])
    log.close()
    tkw = {"chunk_rows": CHUNK, "join_window": 32, "ckpt_steps": 100}
    jt = JTrainer(jm, j_reqlog.RequestLog(path), session=jax_session,
                  checkpoint_path=str(tmp_path / "j.ck"), **tkw)
    tt = TTrainer(tm, t_reqlog.RequestLog(path), session=TorchSession("cpu"),
                  checkpoint_path=str(tmp_path / "t.ck"), **tkw)
    assert tt.consume_available() == jt.consume_available() == 12
    js, ts = jt.status(), tt.status()
    for k in ("steps", "examples", "offset", "join_counts", "lag_bytes"):
        assert ts[k] == js[k], k
    assert ts["steps"] == 6
    np.testing.assert_allclose(ts["last_loss"], js["last_loss"], rtol=RTOL, atol=ATOL)
    want = jt.candidate_model().state_pytree
    got = tt.candidate_model().state_pytree
    for k in ("emb", "coef", "intercept"):
        np.testing.assert_allclose(got[k].cpu().numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert not np.array_equal(got["emb"].cpu().numpy(), tm.theta["emb"].cpu().numpy())


def _port_model(optim_update="sparse_adagrad"):
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator

    X, y = _ctr_rows()
    model = StreamingHashedLinearEstimator(
        n_dims=1 << 8, n_dense=2, n_cat=2, epochs=1, step_size=0.05, chunk_rows=CHUNK,
        optim_update=optim_update, reg_param=1e-3,
    ).fit_stream(array_chunk_source(X, y, chunk_rows=CHUNK),
                 session=TorchSession.builder_get_or_create("cpu"))
    return model, X, y


def _trainer(model, log, path, **kw):
    from orange3_spark_tpu_torch.online.trainer import IncrementalTrainer

    kw.setdefault("chunk_rows", CHUNK)
    kw.setdefault("join_window", 32)
    kw.setdefault("ckpt_steps", 100)
    return IncrementalTrainer(model, log, session=TorchSession("cpu"),
                              checkpoint_path=str(path), **kw)


def _leaves(model):
    return {k: v.cpu().numpy().copy() for k, v in model.state_pytree.items()}


def test_trainer_crash_resume_ends_bitwise_the_uninterrupted_run(tmp_path):
    """``trainer_crash:at=3`` kills the third step after the step-2
    snapshot; a new trainer on the snapshot resumes past the consumed log
    and ends bitwise equal to the run that never crashed."""
    from orange3_spark_tpu_torch.online.trainer import TrainerCrashInjected

    model, X, y = _port_model()
    log = t_reqlog.RequestLog(str(tmp_path / "req.log"))
    _fill_log(log, X[:768], y[:768])
    ref = _trainer(model, log, tmp_path / "ref.ck", ckpt_steps=2)
    ref.consume_available()
    assert ref.status()["steps"] == 6
    crash = _trainer(model, log, tmp_path / "crash.ck", ckpt_steps=2)
    with inject_faults("trainer_crash:at=3"):
        with pytest.raises(TrainerCrashInjected):
            crash.consume_available()
    assert crash.status()["steps"] == 2
    resumed = _trainer(model, log, tmp_path / "crash.ck", ckpt_steps=2)
    assert resumed.resumed_from_step == 2 and resumed.status()["offset"] > 0
    resumed.consume_available()
    assert resumed.status()["steps"] == 6
    a, b = _leaves(resumed.candidate_model()), _leaves(ref.candidate_model())
    assert all(np.array_equal(a[k], b[k]) for k in a)
    log.close()


@pytest.mark.parametrize("optim_update", ["adam", "sparse_adagrad"])
def test_trainer_never_changes_the_served_bits(tmp_path, optim_update):
    """The trainer's steps write its standby tables in place: the serving
    model's tensors, and what a ``ServingContext`` serves from them, keep
    their bits over 20 steps."""
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

    model, X, y = _port_model(optim_update)
    before = _leaves(model)
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=256)) as ctx:
        ctx.warmup(model, n_cols=4, kinds=("array",))
        served0 = model.predict_proba(X[:200])
        log = t_reqlog.RequestLog(str(tmp_path / "req.log"))
        _fill_log(log, np.tile(X, (3, 1))[:2560], 1.0 - np.tile(y, 3)[:2560])
        tr = _trainer(model, log, tmp_path / "ck")
        tr.consume_available()
        assert tr.status()["steps"] == 20
        served1 = model.predict_proba(X[:200])
        log.close()
    assert np.array_equal(served0, served1)
    after = _leaves(model)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert not np.array_equal(_leaves(tr.candidate_model())["emb"], before["emb"])


def test_online_loop_publishes_rejects_drift_and_is_inert_when_off(tmp_path, monkeypatch):
    """A loop over the CPU model: skipped with no examples; clean traffic
    publishes a candidate beside the serving baseline; drifted traffic is
    rejected typed and quarantined with CURRENT untouched;
    ``OTPU_ONLINE=0`` makes a cycle inert."""
    from orange3_spark_tpu_torch.online import OnlineLoop

    model, X, y = _port_model()
    loop = OnlineLoop(model, str(tmp_path / "store"), str(tmp_path / "req.log"),
                      session=TorchSession("cpu"), reference_X=X,
                      holdout_source=array_chunk_source(X, y, chunk_rows=CHUNK),
                      min_examples=CHUNK,
                      trainer_kw={"chunk_rows": CHUNK, "join_window": 32, "ckpt_steps": 100},
                      shadow_kw={"disagree_threshold": 0.95})
    root = loop.store_root

    def drive(lo, hi):
        for i in range(lo, hi, CHUNK):
            rid = loop.tap.tap_request(X[i:i + CHUNK])
            loop.tap.tap_label(rid, y[i:i + CHUNK])

    assert loop.publish_cycle()["outcome"] == "skipped"
    drive(0, 512)
    loop.trainer.consume_available()
    res = loop.publish_cycle()
    assert res["outcome"] == "published" and res["version"] == "v0002"
    assert ro.read_current(root) == "v0001"
    with inject_faults("drift:shift=50"):
        drive(512, 1024)
    loop.trainer.consume_available()
    res = loop.publish_cycle()
    assert res["outcome"] == "rejected_drift" and res["quarantined"]
    assert ro.is_quarantined(root, res["version"]) and ro.read_current(root) == "v0001"
    monkeypatch.setenv("OTPU_ONLINE", "0")
    assert loop.publish_cycle()["outcome"] == "disabled"
    monkeypatch.delenv("OTPU_ONLINE")
    loop.close()
