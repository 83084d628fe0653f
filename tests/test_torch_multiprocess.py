"""Real 2-rank gloo gangs of the port on the CPU, held to the JAX package's
one-process answers (the port's ``tests/test_multiprocess.py``).

The module's fixture starts four gangs at once through
``parallel/launcher.MultihostLauncher`` (each rank a fresh interpreter, one
torch thread): ``tests/_torch_mp_worker.py`` (the dense streaming fit, a
batch ``LogisticRegression``, the collectives, ``group_by``) and three
Criteo hashed fits through ``parallel/mh_worker`` (data-parallel
sparse_adagrad and adam, and data 1 x model 2). Each rank reads only its
row block of a shared CSV.

Tolerances: the streaming fit rtol 1e-4 / atol 1e-5 and LogisticRegression
rtol 5e-3 / atol 5e-4 against the reference's one-process fits (its own
bounds, ``tests/test_multiprocess.py``); the hashed fits atol 1e-6 / rtol
1e-5 (``tests/test_torch_hashed.py``'s); the collectives rtol 1e-5 against
the reference's 8-device mesh. Ranks must be bitwise equal, and a world of
one rank bitwise the plain path.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu_torch import TorchSession, TorchTable
from orange3_spark_tpu_torch.parallel.drill import gang_global_chunks, read_gang, worker_env

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_mp_worker.py")
N_ROWS, N_COLS = 1000, 4
# the hashed gangs: a Criteo CSV, 2^12 dims, 1024 rows a rank a chunk, 2 epochs,
# reg 1e-5 (the sparse rules' lazy decay, timestamps and all, on a model shard)
H_ROWS, H_DIMS, H_CHUNK, H_EPOCHS, H_LR, H_REG = 8192, 1 << 12, 1024, 2, 0.04, 1e-5
RANK_ENV = {"OMP_NUM_THREADS": "1"}


def _gang(argv, log_dir, model_parallel=1):
    from orange3_spark_tpu_torch.parallel.launcher import MultihostLauncher

    return MultihostLauncher(argv, 2, env=worker_env(RANK_ENV), log_dir=log_dir,
                             max_gang_restarts=0, wall_s=240.0,
                             model_parallel=model_parallel).run()


def _hashed_argv(csv, out, rule, mp, n_total=H_ROWS):
    def argv(r, n, coord):
        return [sys.executable, "-m", "orange3_spark_tpu_torch.parallel.mh_worker",
                "--rank", str(r), "--nprocs", str(n), "--coord", coord, "--csv", csv,
                "--n-total", str(n_total), "--n-features", "39",
                "--chunk-rows", str(H_CHUNK), "--epochs", str(H_EPOCHS),
                "--step-size", str(H_LR), "--out-dir", out, "--device", "cpu", "--hashed",
                "--n-dims", str(H_DIMS), "--optim-update", rule, "--cache-dtype", "packed",
                "--model-parallel", str(mp), "--reg-param", str(H_REG)]
    return argv


HASHED = {"dp_sparse_adagrad": ("sparse_adagrad", 1), "dp_adam": ("adam", 1),
          "mp_sparse_adagrad": ("sparse_adagrad", 2),
          # one row short: rank 1's last chunk ends in a lockstep pad (w=0)
          "dp_padded": ("sparse_adagrad", 1)}
PADDED_ROWS = H_ROWS - 1


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    from orange3_spark_tpu_torch.datasets import gen_criteo_csv
    from orange3_spark_tpu_torch.parallel.launcher import cross_process_collectives_supported

    ok, why = cross_process_collectives_supported()
    if not ok:
        pytest.skip(why)
    tmp = tmp_path_factory.mktemp("tmp_gangs")
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N_ROWS, N_COLS)).astype(np.float32)
    w_true = np.asarray([1.5, -2.0, 0.7, 0.0], np.float32)
    y = (X @ w_true + 0.3 * rng.standard_normal(N_ROWS) > 0).astype(np.float32)
    csv = str(tmp / "shared.csv")
    header = ",".join([f"f{i}" for i in range(N_COLS)] + ["y"])
    np.savetxt(csv, np.column_stack([X, y]), delimiter=",", header=header, comments="",
               fmt="%.9g")
    hcsv = str(tmp / "criteo.csv")
    gen_criteo_csv(hcsv, H_ROWS, seed=0)
    main_out = str(tmp / "main")
    os.makedirs(main_out)
    jobs = {"main": (lambda r, n, c: [sys.executable, _WORKER, csv, main_out],
                     os.path.join(main_out, "logs"), 1)}
    for name, (rule, mp) in HASHED.items():
        out = str(tmp / name)
        n_total = PADDED_ROWS if name == "dp_padded" else H_ROWS
        jobs[name] = (_hashed_argv(hcsv, out, rule, mp, n_total), os.path.join(out, "logs"),
                      mp)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(_gang, *v) for k, v in jobs.items()}
        for f in futs.values():
            f.result()
    ranks = [dict(np.load(os.path.join(main_out, f"rank{r}.npz"))) for r in range(2)]
    hashed = {name: read_gang(str(tmp / name)) for name in HASHED}
    return X, y, ranks, hcsv, hashed


@pytest.fixture(scope="module")
def jsess1():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


def test_two_rank_gang_ranks_and_lockstep(gangs):
    _, _, ranks, _, hashed = gangs
    assert [int(r["rank"]) for r in ranks] == [0, 1] and int(ranks[0]["size"]) == 2
    assert int(ranks[0]["local_rows"]) == int(ranks[1]["local_rows"]) == N_ROWS // 2
    # every rank holds the same bits: the rank-order folds
    for k in ("stream_coef", "stream_intercept", "coef", "intercept", "agg_xw", "agg_w",
              "dps_a", "dps_w", "gram", "gram_mean", "gram_tot", "group_by"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    for name, (_, hosts) in hashed.items():
        assert len({h["theta_sha256"] for h in hosts.values()}) == 1, name
        assert all(h["backend"] == "gloo" and h["collectives"]["calls"] > 0
                   for h in hosts.values())


def test_two_rank_streaming_fit_matches_equivalent_chunks(gangs, jsess1):
    """Each rank streams its block in 128-row chunks (the reference's own
    layout, ``tests/test_multiprocess.py``: 500 rows -> 128, 128, 128, 116
    padded with dead rows): every global chunk is [rank 0's; rank 1's]. The
    reference's one-process fit over those concatenated chunks lands on the
    same numbers. (At 126-row chunks the first global chunk holds as many
    positives as negatives: the intercept's first gradient is 0 up to
    rounding, and adam's first step turns the rounding's sign into a
    +-0.03 step, so there the two packages' one-process fits part too.)"""
    from orange3_spark_tpu.io.streaming import StreamingLinearEstimator

    X, y, ranks, _, _ = gangs
    half, pad = N_ROWS // 2, 128
    blocks = [(X[:half], y[:half]), (X[half:], y[half:])]
    chunks = []
    for i in range(4):
        xs, ys, ws = [], [], []
        for Xb, yb in blocks:
            seg_x, seg_y = Xb[i * pad:(i + 1) * pad], yb[i * pad:(i + 1) * pad]
            xp = np.zeros((pad, N_COLS), np.float32)
            xp[:len(seg_x)] = seg_x
            yp = np.zeros((pad,), np.float32)
            yp[:len(seg_y)] = seg_y
            wp = np.zeros((pad,), np.float32)
            wp[:len(seg_x)] = 1.0
            xs.append(xp)
            ys.append(yp)
            ws.append(wp)
        chunks.append((np.concatenate(xs), np.concatenate(ys), np.concatenate(ws)))
    ref = StreamingLinearEstimator(loss="logistic", epochs=2, step_size=0.1,
                                   chunk_rows=2 * pad).fit_stream(
        lambda: iter(chunks), n_features=N_COLS, session=jsess1)
    assert int(ranks[0]["stream_steps"]) == ref.n_steps_ == 8
    np.testing.assert_allclose(ranks[0]["stream_coef"], np.asarray(ref.coef),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["stream_intercept"], np.asarray(ref.intercept),
                               rtol=1e-4, atol=1e-5)


def test_two_rank_logistic_regression_matches_single_process(gangs, session):
    """The batch fit ran over blocks no rank held together (its moments and
    every objective evaluation folded over the ranks); its coefficients
    match the reference's one-process fit of the full data."""
    from orange3_spark_tpu.core.domain import ContinuousVariable, DiscreteVariable, Domain
    from orange3_spark_tpu.core.table import TpuTable
    from orange3_spark_tpu.models.logistic_regression import LogisticRegression

    X, y, ranks, _, _ = gangs
    domain = Domain([ContinuousVariable(f"f{i}") for i in range(N_COLS)],
                    DiscreteVariable("y", ("0", "1")))
    ref = LogisticRegression(max_iter=100, reg_param=1e-3).fit(
        TpuTable.from_numpy(domain, X, y, session=session))
    np.testing.assert_allclose(ranks[0]["coef"], np.asarray(ref.coef), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(ranks[0]["intercept"], np.asarray(ref.intercept),
                               rtol=5e-3, atol=5e-4)


def test_collectives_match_the_jax_mesh(gangs, session):
    """tree_aggregate, data_parallel_sum and distributed_gramian over the
    gang's two blocks against the JAX functions over both blocks sharded on
    the 8-device mesh."""
    import jax.numpy as jnp

    from orange3_spark_tpu.parallel import collectives as jc

    _, _, ranks, _, _ = gangs
    A = np.concatenate([r["A"] for r in ranks])
    W = np.concatenate([r["W"] for r in ranks])
    Aj = jax.device_put(A, session.row_sharding)
    Wj = jax.device_put(W, session.vector_sharding)
    xw, wsum = jc.tree_aggregate(lambda a, w: ((a * w[:, None]).sum(axis=0), w.sum()), Aj, Wj,
                                 session=session)
    da, dw = jc.data_parallel_sum((Aj, Wj), session=session)
    G, mean, tot = jc.distributed_gramian(Aj, Wj)
    got = ranks[0]
    for mine, theirs in ((got["agg_xw"], xw), (got["agg_w"], wsum), (got["dps_a"], da),
                         (got["dps_w"], dw), (got["gram"], G), (got["gram_mean"], mean),
                         (got["gram_tot"], tot)):
        np.testing.assert_allclose(mine, np.asarray(theirs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["dps_a"], jnp.sum(A, axis=0), rtol=1e-5)


def test_group_by_nan_min_max_stays_rank_local(gangs):
    """ROADMAP queue 3 item 3: relational ops stay rank-local, and a group's
    min and max of a column with a live NaN is NaN at every world size (the
    one-device answer; the reference's 8-device mesh can drop a NaN met
    after a number)."""
    _, _, ranks, _, _ = gangs
    for r in ranks:
        gb = r["group_by"]
        assert np.isnan(gb[1, 1:]).all()                    # group 'b': 3.0, NaN, 5.0
        assert gb[0, 1:].tolist() == [1.0, 1.0] and gb[2, 1:].tolist() == [4.0, 4.0]


def _port_hashed(rule, n_ranks, sess, csv, n_total=H_ROWS):
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator

    est = StreamingHashedLinearEstimator(
        n_dims=H_DIMS, n_dense=13, n_cat=26, chunk_rows=n_ranks * H_CHUNK, epochs=H_EPOCHS,
        step_size=H_LR, reg_param=H_REG, loss="logistic", label_in_chunk=True, optim_update=rule,
        cache_dtype="packed", replay_granularity="epoch", sparse_lowering="sort")
    return est.fit_stream(_raw(gang_global_chunks(csv, "", n_total, H_CHUNK, n_ranks)),
                          session=sess, cache_device=True)


def _raw(src):
    """A gang's global chunks as raw label-in-chunk arrays (no pads here)."""
    def open_stream():
        for X, _, w in src():
            assert w is None
            yield X
    return open_stream


def test_hashed_gang_with_a_lockstep_pad_matches_one_process(gangs):
    """One row short of an even split: rank 1 tops its last chunk up with a
    dead row (w=0; its own ``n_valid``), whose occurrences go to the
    sentinel before the gather. The gang against the one-process fit over
    the same global chunks (their last one's dead row at its end)."""
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator

    _, _, _, csv, hashed = gangs
    theta, hosts = hashed["dp_padded"]
    src = gang_global_chunks(csv, "", PADDED_ROWS, H_CHUNK, 2)
    w_last = list(src())[-1][2]
    assert w_last is not None and w_last[-1] == 0.0 and w_last[:-1].min() == 1.0
    one = StreamingHashedLinearEstimator(
        n_dims=H_DIMS, n_dense=13, n_cat=26, chunk_rows=2 * H_CHUNK, epochs=H_EPOCHS,
        step_size=H_LR, reg_param=H_REG, loss="logistic", label_in_chunk=True,
        optim_update="sparse_adagrad", cache_dtype="packed", replay_granularity="epoch",
        sparse_lowering="sort").fit_stream(src, session=TorchSession("cpu"), cache_device=True)
    for k in ("emb", "coef", "intercept"):
        np.testing.assert_allclose(theta[k], one.theta[k].numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["dp_sparse_adagrad", "dp_adam"])
def test_hashed_data_parallel_matches_reference(gangs, jsess1, name):
    """A 2-rank data-parallel Criteo fit (every rank sorts the gathered
    global occurrence list) against the reference's one-process fit over the
    same global chunks."""
    from orange3_spark_tpu.models.hashed_linear import (
        StreamingHashedLinearEstimator as JHashed,
    )

    _, _, _, csv, hashed = gangs
    theta, hosts = hashed[name]
    rule = HASHED[name][0]
    ref = JHashed(n_dims=H_DIMS, n_dense=13, n_cat=26, chunk_rows=2 * H_CHUNK,
                  epochs=H_EPOCHS, step_size=H_LR, reg_param=H_REG, loss="logistic",
                  label_in_chunk=True,
                  optim_update=rule, cache_dtype="packed", replay_granularity="epoch",
                  sparse_lowering="sort").fit_stream(
        _raw(gang_global_chunks(csv, "", H_ROWS, H_CHUNK, 2)), session=jsess1,
        cache_device=True)
    assert int(theta["n_steps"]) == ref.n_steps_ == H_EPOCHS * H_ROWS // (2 * H_CHUNK)
    for k in ("emb", "coef", "intercept"):
        np.testing.assert_allclose(theta[k], np.asarray(ref.theta[k]), atol=1e-6, rtol=1e-5,
                                   err_msg=k)


def test_hashed_model_parallel_matches_data_parallel(gangs):
    """Data 1 x model 2: each rank owns half the table rows (its slots and
    timestamps with them), the partial logits fold over the model group and
    each owner updates its rows from the occurrence list filtered to them;
    the gathered table against the data-parallel fit at the same data
    parallelism (one rank, the same chunks): the reference's own bound."""
    _, _, _, csv, hashed = gangs
    theta, hosts = hashed["mp_sparse_adagrad"]
    assert {h["model_index"] for h in hosts.values()} == {0, 1}
    dp = _port_hashed("sparse_adagrad", 1, TorchSession("cpu"), csv)
    for k in ("emb", "coef", "intercept"):
        np.testing.assert_allclose(theta[k], dp.theta[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_world_of_one_rank_is_the_plain_path(tmp_path):
    """A world of one rank (``initialize_distributed`` with no gang) makes no
    process group, and every fit on it is the plain session's, bit for bit."""
    from orange3_spark_tpu_torch.core.domain import ContinuousVariable, DiscreteVariable, Domain
    from orange3_spark_tpu_torch.datasets import gen_criteo_csv
    from orange3_spark_tpu_torch.io.streaming import StreamingLinearEstimator, array_chunk_source
    from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression

    world = TorchSession.initialize_distributed(0, 1)
    assert world.data_group is None and world.model_group is None
    one, plain = TorchSession("cpu", world=world), TorchSession("cpu")
    rng = np.random.default_rng(3)
    X = rng.standard_normal((300, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    dom = Domain([ContinuousVariable(f"f{i}") for i in range(4)],
                 DiscreteVariable("y", ("0", "1")))
    fits = []
    for s in (one, plain):
        sm = StreamingLinearEstimator(loss="logistic", epochs=2, step_size=0.1,
                                      chunk_rows=64).fit_stream(
            array_chunk_source(X, y, chunk_rows=64), n_features=4, session=s)
        lr = LogisticRegression(max_iter=50).fit(TorchTable.from_numpy(dom, X, y, session=s))
        fits.append([sm.coef, sm.intercept, lr.coef, lr.intercept])
    csv = str(tmp_path / "c.csv")
    gen_criteo_csv(csv, 2048, seed=1)
    for s, out in zip((one, plain), fits):
        m = _port_hashed("sparse_adagrad", 1, s, csv, n_total=2048)
        out += [m.theta[k] for k in ("emb", "coef", "intercept")]
    for a, b in zip(*fits):
        assert torch.equal(a, b)
