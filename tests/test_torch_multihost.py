"""The port's multi-process ingest, partitioners and launcher
(``orange3_spark_tpu_torch/io/multihost.py``, ``io/streaming.py``'s
sharded sources, ``parallel/{partitioner,launcher,drill}.py``) against the
JAX package's, case by case as ``tests/test_multihost.py``, in one process.

A rank's place is a ``World`` (rank, size, model parallelism) without a
process group: the pure functions take it explicitly, where the reference's
read ``jax.process_count`` / ``jax.process_index`` (monkeypatched here as in
its own tests). Pure functions are bitwise the reference's on the same
inputs. The launcher runs real subprocesses; the drill runs a real 2-rank
gloo gang on the CPU (``cross_process_collectives_supported`` gates it).
"""

import os
import pickle
import sys
import time

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.io import multihost as jmh
from orange3_spark_tpu.io import streaming as jstream
from orange3_spark_tpu_torch import TorchSession
from orange3_spark_tpu_torch.core.session import (
    BackendNotPortedError, NoCrossRankFoldError, World,
)
from orange3_spark_tpu_torch.io import multihost as tmh
from orange3_spark_tpu_torch.io import streaming as tstream

# the worker env of every subprocess here: one torch thread a process
RANK_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def tsess():
    return TorchSession.builder_get_or_create("cpu")


def _jworld(monkeypatch, pi, pc):
    monkeypatch.setattr(jax, "process_count", lambda: pc)
    monkeypatch.setattr(jax, "process_index", lambda: pi)


def _shared_csv(tmp_path, n, d=4, seed=0, name="shared.csv"):
    """%.9g round-trips float32 exactly: both packages read the same bits."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float32)
    p = str(tmp_path / name)
    header = ",".join([f"f{i}" for i in range(d)] + ["y"])
    np.savetxt(p, np.column_stack([X, y]), delimiter=",", fmt="%.9g", header=header,
               comments="")
    return p, X, y


def _chunks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


# ------------------------------------------------------------ io/multihost
def test_put_sharded_global_assembly_matches_device_put(session, tsess):
    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    a = tmh.put_sharded(x, tsess)
    b = tmh.put_sharded(x, tsess, force_global=True)   # the gang's validating path
    assert b.shape == (64, 3) and b.device == tsess.device
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jmh.put_sharded(x, session.row_sharding)))


def test_put_sharded_feeds_table_and_fit(tsess):
    """A block placed through the validating path fits and predicts like
    the plain one."""
    from orange3_spark_tpu_torch import TorchTable
    from orange3_spark_tpu_torch.core.domain import (
        ContinuousVariable, DiscreteVariable, Domain,
    )
    from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression

    rng = np.random.default_rng(0)
    X = rng.standard_normal((400, 4)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float32)
    dom = Domain([ContinuousVariable(f"f{i}") for i in range(4)],
                 DiscreteVariable("y", ("0", "1")))
    Xb = tmh.put_sharded(X, tsess, force_global=True).numpy()
    t = TorchTable.from_numpy(dom, Xb, y, session=tsess)
    m = LogisticRegression(max_iter=100).fit(t)
    assert np.mean(m.predict(t) == y) > 0.95


def test_process_row_slice_partitions_exactly(monkeypatch):
    slices = []
    for pi in range(4):
        _jworld(monkeypatch, pi, 4)
        got = tmh.process_row_slice(10, World(pi, 4))
        assert got == jmh.process_row_slice(10)
        slices.append(got)
    covered = [i for s in slices for i in range(s.start, s.stop)]
    assert covered == list(range(10))          # disjoint, complete, ordered
    sizes = [s.stop - s.start for s in slices]
    assert max(sizes) - min(sizes) <= 1        # near-equal


def test_blocks_follow_the_data_index():
    """Ranks of one model group (data 2 x model 2) read the same block."""
    got = [tmh.process_row_slice(10, World(r, 4, 2)) for r in range(4)]
    assert got[0] == got[1] == slice(0, 5) and got[2] == got[3] == slice(5, 10)


def test_shard_paths_round_robin(monkeypatch):
    paths = [f"part-{i:03d}.csv" for i in range(7)]
    seen = []
    for pi in range(3):
        _jworld(monkeypatch, pi, 3)
        got = tmh.shard_paths(paths, World(pi, 3))
        assert got == jmh.shard_paths(paths)
        seen.append(got)
    assert sorted(p for sub in seen for p in sub) == sorted(paths)
    assert all(len(s) in (2, 3) for s in seen)


def test_single_process_defaults():
    assert tmh.process_row_slice(100) == jmh.process_row_slice(100) == slice(0, 100)
    assert tmh.shard_paths(["b", "a"]) == ["a", "b"]
    assert tmh.lockstep_rows(7) == 7


def test_shard_row_groups_partitions_single_parquet(tmp_path, monkeypatch):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    p = str(tmp_path / "d.parquet")
    data = np.arange(70, dtype=np.float32)
    pq.write_table(pa.table({"v": data}), p, row_group_size=10)  # 7 groups
    slices = []
    for pi in range(3):
        _jworld(monkeypatch, pi, 3)
        got = tmh.shard_row_groups(p, World(pi, 3))
        assert got == jmh.shard_row_groups(p)
        slices.append(got)
    assert [len(s) for s in slices] == [3, 2, 2]
    assert sorted(sum(slices, [])) == list(range(7))
    got = np.concatenate([
        np.concatenate(list(tstream.parquet_raw_chunk_source(p, chunk_rows=8,
                                                             row_groups=tuple(s))()))
        for s in slices])
    np.testing.assert_array_equal(got[:, 0], data)


def test_put_sharded_ragged_block_raises_typed(monkeypatch):
    """A block whose peers contributed other row counts fails TYPED and
    names the fix (the weight-mask pad convention); so does an empty one."""
    gang = TorchSession("cpu", world=World(0, 2))
    monkeypatch.setattr(tmh, "_peer_rows", lambda n, world: [n, n - 1])
    with pytest.raises(tmh.RaggedHostBlockError) as ei:
        tmh.put_sharded(np.zeros((10, 3), np.float32), gang)
    msg = str(ei.value)
    assert "w=0" in msg and "lockstep_rows" in msg
    monkeypatch.setattr(tmh, "_peer_rows", lambda n, world: [n, n])
    assert tmh.put_sharded(np.ones((16, 3), np.float32), gang).shape == (16, 3)
    with pytest.raises(tmh.RaggedHostBlockError):
        tmh.put_sharded(np.zeros((0, 3), np.float32), TorchSession("cpu"), force_global=True)


def test_lockstep_rows_is_largest_slice(monkeypatch):
    for n in (10, 12, 1001):
        _jworld(monkeypatch, 0, 4)
        assert tmh.lockstep_rows(n, World(0, 4)) == jmh.lockstep_rows(n)
    widths = [tmh.process_row_slice(10, World(r, 4)) for r in range(4)]
    assert tmh.lockstep_rows(10, World(0, 4)) == max(s.stop - s.start for s in widths) == 3


# ------------------------------------------------------- the sharded CSV
def test_sharded_csv_kill_switch_is_plain_source(tmp_path, monkeypatch):
    p, X, y = _shared_csv(tmp_path, 1000)
    monkeypatch.setenv("OTPU_MULTIHOST", "0")
    got = list(tstream.sharded_csv_chunk_source(p, "y", shard_total_rows=1000,
                                                chunk_rows=256)())
    _chunks_equal(got, list(tstream.csv_chunk_source(p, "y", chunk_rows=256)()))
    _chunks_equal(got, list(jstream.sharded_csv_chunk_source(p, "y", shard_total_rows=1000,
                                                             chunk_rows=256)()))


def test_sharded_csv_single_process_matches_plain(tmp_path):
    p, X, y = _shared_csv(tmp_path, 1000)
    got = list(tstream.sharded_csv_chunk_source(p, "y", shard_total_rows=1000,
                                                chunk_rows=256)())
    assert [len(c[0]) for c in got] == [256, 256, 256, 232]
    np.testing.assert_array_equal(np.concatenate([c[0] for c in got]), X)
    np.testing.assert_array_equal(np.concatenate([c[1] for c in got]), y)
    assert all(c[2] is None for c in got)
    _chunks_equal(got, list(jstream.sharded_csv_chunk_source(p, "y", shard_total_rows=1000,
                                                             chunk_rows=256)()))


def test_sharded_csv_two_process_lockstep_schedule(tmp_path, monkeypatch):
    """1001 rows over 2 ranks: rows split 501/500, yet both emit [256, 245];
    the short rank tops up with one dead w=0 row. Bitwise the reference's
    per-process chunks."""
    p, X, y = _shared_csv(tmp_path, 1001)
    per_rank = []
    for pi in range(2):
        _jworld(monkeypatch, pi, 2)
        got = list(tstream.sharded_csv_chunk_source(p, "y", shard_total_rows=1001,
                                                    chunk_rows=256, world=World(pi, 2))())
        _chunks_equal(got, list(jstream.sharded_csv_chunk_source(
            p, "y", shard_total_rows=1001, chunk_rows=256)()))
        per_rank.append(got)
    assert [len(c[0]) for c in per_rank[0]] == [len(c[0]) for c in per_rank[1]] == [256, 245]
    np.testing.assert_array_equal(np.concatenate([c[0] for c in per_rank[0]]), X[:501])
    X1 = np.concatenate([c[0] for c in per_rank[1]])
    np.testing.assert_array_equal(X1[:500], X[501:])
    np.testing.assert_array_equal(X1[500], np.zeros(4, np.float32))
    w_last = per_rank[1][-1][2]
    assert w_last[-1] == 0.0 and w_last[:-1].min() == 1.0


def test_sharded_csv_overstated_rows_raises(tmp_path):
    p, _, _ = _shared_csv(tmp_path, 100)
    src = tstream.sharded_csv_chunk_source(p, "y", shard_total_rows=500, chunk_rows=64)
    with pytest.raises(ValueError, match="overstates"):
        list(src())


def test_parquet_shard_flag_splits_and_kill_switch_doesnt(tmp_path, monkeypatch):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    p = str(tmp_path / "d.parquet")
    data = np.arange(70, dtype=np.float32)
    pq.write_table(pa.table({"v": data}), p, row_group_size=10)
    parts = []
    for pi in range(2):
        _jworld(monkeypatch, pi, 2)
        got = list(tstream.parquet_raw_chunk_source(p, chunk_rows=16, shard=True,
                                                    world=World(pi, 2))())
        _chunks_equal([(c,) for c in got],
                      [(c,) for c in jstream.parquet_raw_chunk_source(p, chunk_rows=16,
                                                                      shard=True)()])
        parts.append(np.concatenate(got))
    np.testing.assert_array_equal(np.concatenate(parts)[:, 0], data)
    assert len(parts[0]) == 40 and len(parts[1]) == 30   # 4+3 groups
    monkeypatch.setenv("OTPU_MULTIHOST", "0")
    full = np.concatenate(list(tstream.parquet_raw_chunk_source(
        p, chunk_rows=16, shard=True, world=World(1, 2))()))
    np.testing.assert_array_equal(full[:, 0], data)


def test_rechunk_weighs_unweighted_rows_one():
    """A sharded source weighs only its padded chunk; rechunked across it,
    the unweighted rows keep weight 1 and the pads 0."""
    X = np.arange(10, dtype=np.float32)[:, None]
    src = [(X[:6], None, None), (X[6:], None, np.array([1, 1, 0, 0], np.float32))]
    out = list(tstream._rechunk(iter(src), 4))
    assert [len(c[0]) for c in out] == [4, 4, 2] and out[0][2] is None   # None: all ones
    np.testing.assert_array_equal(np.concatenate([c[2] for c in out[1:]]), [1, 1, 1, 1, 0, 0])


# ------------------------------------------------------------ partitioners
def test_data_parallel_partitioner_fit_and_kill_switch_parity(tmp_path, monkeypatch):
    """The partitioner plugs into fit_stream as a session factory + source
    facade, and OTPU_MULTIHOST=0 reproduces the stock path BITWISE."""
    from orange3_spark_tpu_torch.parallel import DataParallelPartitioner

    p, X, y = _shared_csv(tmp_path, 2048)

    def fit(src_of):
        part = DataParallelPartitioner(device="cpu")
        est = tstream.StreamingLinearEstimator(loss="logistic", epochs=3, step_size=0.1,
                                               chunk_rows=256)
        m = est.fit_stream(src_of(part), n_features=4, session=part.session)
        return part, m.coef.numpy(), m.intercept.numpy()

    shard = lambda part: part.shard_csv(p, "y", n_total=2048, chunk_rows=256)  # noqa: E731
    monkeypatch.setenv("OTPU_MULTIHOST", "1")
    part_on, coef_on, icpt_on = fit(shard)
    assert part_on.enabled and part_on.mesh == {"data": 1, "model": 1}
    monkeypatch.setenv("OTPU_MULTIHOST", "0")
    part_off, coef_off, icpt_off = fit(shard)
    assert not part_off.enabled
    _, coef_stock, icpt_stock = fit(lambda part: tstream.csv_chunk_source(p, "y",
                                                                          chunk_rows=256))
    for c, i in ((coef_off, icpt_off), (coef_stock, icpt_stock)):
        np.testing.assert_array_equal(coef_on, c)     # bitwise pin
        np.testing.assert_array_equal(icpt_on, i)
    scores = X @ coef_on + icpt_on
    assert np.mean(scores.argmax(axis=1) == y) > 0.9


def test_spmd_partitioner_mesh_and_state_sharding(monkeypatch):
    from orange3_spark_tpu_torch.parallel import SPMDPartitioner

    monkeypatch.setenv("OTPU_MULTIHOST", "1")
    part = SPMDPartitioner(World(3, 4, 2), model_parallel=2, device="cpu")
    assert part.mesh == {"data": 2, "model": 2} and part.n_processes == 4
    assert part.state_sharding("emb", np.zeros((32, 4), np.float32))[0] == part.model_axis
    assert part.state_sharding("bias", np.zeros((4,), np.float32)) == ()
    assert part.state_sharding("emb", np.zeros((4,), np.float32)) == ()
    emb = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
    st = part.shard_state({"emb": emb, "opt": {"m": np.zeros((4,), np.float32)}})
    np.testing.assert_array_equal(st["emb"].numpy(), emb[16:])   # model index 1's rows
    assert st["opt"]["m"].shape == (4,)
    with pytest.raises(ValueError, match="does not divide"):
        SPMDPartitioner(World(0, 4, 2), model_parallel=3, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        SPMDPartitioner(model_parallel=2, device="cpu")    # a 1-rank world


def test_partitioner_partition_runs_donated_step(monkeypatch):
    from orange3_spark_tpu_torch.parallel import DataParallelPartitioner

    monkeypatch.setenv("OTPU_MULTIHOST", "1")
    part = DataParallelPartitioner(device="cpu")
    step = part.partition(lambda st, x: {"w": st["w"] + x.sum()})
    st = part.shard_state({"w": np.float32(1.0)})
    held = st["w"]
    Xb, yb, wb = part.shard_batch(np.ones((16, 2), np.float32))
    assert yb is None and wb is None
    out = step(st, Xb)
    assert float(out["w"]) == 33.0 and out["w"] is held   # written in place


def test_nccl_and_folds_raise_typed(tsess):
    """No fallback: 'nccl' raises a typed error naming item 6b, and an
    estimator without a cross-rank fold raises on a gang's session instead
    of fitting its local rows; the linear family and the streaming fits
    pass the check."""
    from orange3_spark_tpu_torch import TorchTable
    from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
    from orange3_spark_tpu_torch.models.kmeans import KMeans
    from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression

    with pytest.raises(BackendNotPortedError, match="6b"):
        TorchSession.initialize_distributed(0, 2, backend="nccl")
    gang = TorchSession("cpu", world=World(0, 2))
    t = TorchTable.from_numpy(Domain([ContinuousVariable("a")]),
                              np.zeros((8, 1), np.float32), session=gang)
    with pytest.raises(NoCrossRankFoldError, match="6b"):
        KMeans(k=2).fit(t)
    with pytest.raises(NoCrossRankFoldError):
        tstream.stream_feature_stats(tstream.array_chunk_source(np.zeros((4, 1), np.float32)),
                                     session=gang)
    assert LogisticRegression.gang_fold and tstream.StreamingLinearEstimator.gang_fold
    assert gang.pad_rows(7) == 8 and tsess.pad_rows(7) == 7   # the JAX formula


# ---------------------------------------------------------------- launcher
def test_launcher_lost_host_is_typed(tmp_path):
    from orange3_spark_tpu_torch.parallel.launcher import HostLostError, MultihostLauncher

    def argv(rank, n, coord):
        return [sys.executable, "-c", "import sys; sys.exit(3)" if rank == 1 else "pass"]

    lau = MultihostLauncher(argv, 2, env=dict(os.environ), log_dir=str(tmp_path / "logs"),
                            max_gang_restarts=0, wall_s=60.0)
    with pytest.raises(HostLostError) as ei:
        lau.run()
    assert (ei.value.rank, ei.value.returncode, ei.value.restarts) == (1, 3, 0)


def test_launcher_wall_budget_wedge_is_typed(tmp_path):
    from orange3_spark_tpu_torch.parallel.launcher import HostLostError, MultihostLauncher

    argv = lambda r, n, c: [sys.executable, "-c", "import time; time.sleep(60)"]  # noqa: E731
    lau = MultihostLauncher(argv, 2, env=dict(os.environ), log_dir=str(tmp_path / "logs"),
                            max_gang_restarts=0, wall_s=0.5)
    t0 = time.perf_counter()
    with pytest.raises(HostLostError, match="wedged"):
        lau.run()
    assert time.perf_counter() - t0 < 30


def test_launcher_gang_restart_recovers(tmp_path, monkeypatch):
    """The first gang loses rank 1 (once, marker-armed); the launcher
    restarts the whole gang with backoff and the second attempt succeeds.
    Each rank sees its rank, the world size and a fresh rendezvous."""
    from orange3_spark_tpu_torch.parallel.launcher import MultihostLauncher

    marker = str(tmp_path / "rank1.died")
    seen = str(tmp_path / "seen")

    def argv(rank, n, coord):
        code = ("import os\n"
                f"open({seen!r} + os.environ['OTPU_RANK'], 'a').write("
                "os.environ['OTPU_WORLD_SIZE'] + ' ' + os.environ['OTPU_INIT_METHOD'] + '\\n')\n")
        if rank == 1:
            code += (f"m = {marker!r}\n"
                     "if not os.path.exists(m):\n"
                     "    open(m, 'w').close()\n"
                     "    raise SystemExit(9)\n")
        return [sys.executable, "-c", code]

    monkeypatch.setenv("OTPU_RETRY_BASE_S", "0.01")
    lau = MultihostLauncher(argv, 2, env=dict(os.environ), log_dir=str(tmp_path / "logs"),
                            max_gang_restarts=2, wall_s=60.0)
    res = lau.run()
    assert (res.n_processes, res.hosts_lost, res.gang_restarts, res.gang_starts) == (2, 1, 1, 2)
    lines = open(seen + "1").read().split()
    assert lines[0] == "2" and lines[1].startswith("file://") and lines[1] != lines[3]


def test_align_checkpoints_common_step_and_donor_copy(tmp_path):
    from orange3_spark_tpu.parallel.launcher import MultihostLauncher as JLauncher
    from orange3_spark_tpu_torch.parallel.launcher import MultihostLauncher

    def put(d, rank, step, tag=0.0):
        with open(d / f"rank{rank}.ckpt", "wb") as f:
            pickle.dump({"step": step, "state": {"w": float(step) + tag}, "meta": None}, f)

    def states(d, n):
        out = []
        for r in range(n):
            with open(d / f"rank{r}.ckpt", "rb") as f:
                out.append(pickle.load(f))
        return out

    for d, align in ((tmp_path / "t", MultihostLauncher.align_checkpoints),
                     (tmp_path / "j", JLauncher.align_checkpoints)):
        d.mkdir()
        put(d, 0, 16)
        put(d, 1, 8)
        assert align(str(d), 2) == 8
        assert [b["step"] for b in states(d, 2)] == [8, 8]
        assert [b["state"] for b in states(d, 2)] == [{"w": 8.0}] * 2
        put(d, 0, 16)
        os.unlink(d / "rank1.ckpt")
        assert align(str(d), 2) == 0
        assert not os.path.exists(d / "rank0.ckpt")
    # model parallelism: a donor of the same model index, or none at all
    d = tmp_path / "mp"
    d.mkdir()
    for r, step in enumerate((16, 16, 8, 8)):
        put(d, r, step, tag=r % 2 / 10)
    assert MultihostLauncher.align_checkpoints(str(d), 4, model_parallel=2) == 8
    assert [b["state"]["w"] for b in states(d, 4)] == [8.0, 8.1, 8.0, 8.1]
    put(d, 0, 16)
    put(d, 2, 16)
    put(d, 1, 8)
    put(d, 3, 16)      # model index 0 has no rank at the common step 8
    assert MultihostLauncher.align_checkpoints(str(d), 4, model_parallel=2) == 0


def test_cross_process_probe_shape_and_reason():
    from orange3_spark_tpu_torch.parallel.launcher import cross_process_collectives_supported

    ok, reason = cross_process_collectives_supported()
    assert isinstance(ok, bool) and isinstance(reason, str)
    if not ok:
        assert torch.__version__ in reason
    t0 = time.perf_counter()
    assert cross_process_collectives_supported() == (ok, reason)
    if ok:      # a positive verdict is cached: the second call is instant
        assert time.perf_counter() - t0 < 1.0


def test_multihost_drill_two_ranks(tmp_path):
    """The drill on a real 2-rank gloo gang: the SIGKILL'd rank is detected
    typed, the gang restarts from the aligned epoch snapshot, loses 0 steps
    and converges bitwise to the uninterrupted reference, every rank's bits
    equal, with per-rank goodput and ledger attribution."""
    from orange3_spark_tpu_torch.parallel.drill import run_drill
    from orange3_spark_tpu_torch.parallel.launcher import cross_process_collectives_supported

    ok, why = cross_process_collectives_supported()
    if not ok:
        pytest.skip(why)
    out = run_drill(procs=2, rows=1024, epochs=3, chunk_rows=128, out_root=str(tmp_path),
                    device="cpu", env=RANK_ENV)
    assert out["hosts_lost"] == 1 and out["gang_restarts"] == 1
    assert out["resume_parity_bitwise"] is True and out["ranks_bitwise_equal"] is True
    assert out["lost_work_steps"] == 0
    assert out["resumed_from_step"] == 4         # one epoch = 512 local rows / 128
    assert out["ref_steps"] == 12
    for h in out["hosts"].values():
        assert "goodput" in h and "device_memory" in h and h["backend"] == "gloo"
