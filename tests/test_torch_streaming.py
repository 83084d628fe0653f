"""The port's Criteo ingest path against the JAX package's, on the CPU: the
native CSV engine built from the port's own copy of fastcsv, the Criteo
CSV generator (the same draws as bench.py's), rechunking and padding, the
prefetch pipeline, the device chunk cache's budget rule, and the whole
path: CSV -> fit_stream -> evaluate_device."""

import os
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

import bench
from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.io import native as jnative
from orange3_spark_tpu.io import streaming as jstream
from orange3_spark_tpu.models.hashed_linear import (
    StreamingHashedLinearEstimator as JEstimator,
)
from orange3_spark_tpu.models.hashed_linear import _split_chunk as j_split_chunk
from orange3_spark_tpu_torch import TorchSession
from orange3_spark_tpu_torch.datasets import CRITEO_COLUMNS, gen_criteo_csv
from orange3_spark_tpu_torch.exec.pipeline import PipelinedExecutor, PipelineStats
from orange3_spark_tpu_torch.io import native as tnative
from orange3_spark_tpu_torch.io import streaming as tstream
from orange3_spark_tpu_torch.models.hashed_linear import (
    StreamingHashedLinearEstimator, _split_chunk,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "orange3_spark_tpu_torch")


def test_fastcsv_builds_from_the_ports_own_copy():
    """The port compiles its copy of fastcsv.cpp into its own _build/, never
    the JAX package's source or library."""
    lib = tnative.library_path()
    assert tnative.SRC == tnative.SRC.resolve()
    assert str(tnative.SRC).startswith(PORT + os.sep)
    assert lib.parent == tnative.BUILD_DIR and str(lib).startswith(PORT + os.sep)
    tnative.get_lib()
    assert lib.exists()
    # the copy is the reference's file, byte for byte
    with open(jnative._SRC, "rb") as a, open(tnative.SRC, "rb") as b:
        assert a.read() == b.read()


def test_gen_criteo_csv_parses_alike_in_both_packages(tmp_path):
    """A CSV from the port's generator parses bitwise alike through both
    packages' readers, and equals bench.py's CSV of the same seed parsed by
    the reference: the same draws, written by another writer."""
    port_csv, bench_csv = str(tmp_path / "port.csv"), str(tmp_path / "bench.csv")
    gen_criteo_csv(port_csv, 2500, seed=3)
    bench.gen_criteo_csv(bench_csv, 2500, seed=3)
    with tnative.NativeCsvReader(port_csv) as r:
        got = r.read_all(chunk_rows=1000)
        assert r.colnames == CRITEO_COLUMNS
    with jnative.NativeCsvReader(port_csv) as r:
        ref = r.read_all(chunk_rows=1000)
    with jnative.NativeCsvReader(bench_csv) as r:
        bench_rows = r.read_all(chunk_rows=1000)
        assert r.colnames == CRITEO_COLUMNS
    assert got.shape == (2500, 40)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, bench_rows)
    assert set(np.unique(got[:, 0])) == {0.0, 1.0}
    assert not os.path.exists(port_csv + ".tmp")


def test_csv_raw_chunk_source_chunks_like_the_reference(tmp_path):
    path = str(tmp_path / "c.csv")
    gen_criteo_csv(path, 2300, seed=4)
    ours = list(tstream.csv_raw_chunk_source(path, chunk_rows=1024)())
    ref = list(jstream.csv_raw_chunk_source(path, chunk_rows=1024)())
    assert [c.shape for c in ours] == [c.shape for c in ref] == [
        (1024, 40), (1024, 40), (252, 40)]
    for a, b in zip(ours, ref):
        assert np.array_equal(a, b)
    # re-iterable: a second epoch reads the file again
    assert np.array_equal(np.concatenate(list(
        tstream.csv_raw_chunk_source(path, chunk_rows=700)())), np.concatenate(ours))


def test_write_csv_native_round_trip_and_missing_cells(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((300, 5)).astype(np.float32) * 1e3
    data[::7, 2] = np.nan                      # empty cells parse back as NaN
    path = str(tmp_path / "w.csv")
    tnative.write_csv_native(path, data, ["a", "b,c", 'd"e', "f", "g"])
    with tnative.NativeCsvReader(path) as r:
        assert r.colnames == ["a", "b,c", 'd"e', "f", "g"]
        back = r.read_all(chunk_rows=64)
    assert np.array_equal(back, data, equal_nan=True)
    with pytest.raises(ValueError, match="names"):
        tnative.write_csv_native(path, data, ["a"])
    with pytest.raises(ValueError, match="newline"):
        tnative.write_csv_native(path, data, ["a\n", "b", "c", "d", "e"])


def test_reader_categorical_columns_hash_strings(tmp_path):
    path = tmp_path / "cat.csv"
    path.write_text("label,c\n1,abc\n0,\n1,abc\n")
    with tnative.NativeCsvReader(str(path), categorical_cols=("c",)) as r:
        ours = r.read_all()
    with jnative.NativeCsvReader(str(path), categorical_cols=("c",)) as r:
        ref = r.read_all()
    assert np.array_equal(ours, ref)
    assert ours[0, 1] == ours[2, 1] and ours[1, 1] == 0.0   # crc32("") == 0
    with pytest.raises(FileNotFoundError):
        tnative.NativeCsvReader(str(tmp_path / "missing.csv"))


def _chunks_of(sizes, seed=0, d=3, weights=False):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        X = rng.standard_normal((n, d)).astype(np.float32)
        y = rng.integers(0, 2, n).astype(np.float32)
        out.append((X, y, rng.random(n).astype(np.float32)) if weights else (X, y))
    return out


@pytest.mark.parametrize("weights", [False, True])
def test_rechunk_and_pad_bitwise(weights):
    chunks = _chunks_of([5, 300, 1, 77, 256, 3], weights=weights)
    ours = list(tstream._rechunk(iter(chunks), 128))
    ref = list(jstream._rechunk(iter(chunks), 128))
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        for x, z in zip(a, b):
            assert (x is None and z is None) or np.array_equal(x, z)
        got = tstream._pad_chunk(a[0], a[1], a[2], 128, 3)
        want = jstream._pad_chunk(b[0], b[1], b[2], 128, 3)
        for x, z in zip(got, want):
            assert x.dtype == np.float32 and np.array_equal(x, z)
    with pytest.raises(ValueError, match="negative row weights"):
        list(tstream._rechunk(iter([(np.zeros((2, 1)), None, np.float32([1, -1]))]), 4))


@pytest.mark.parametrize("label_in_chunk", [True, False])
@pytest.mark.parametrize("impute", [True, False])
def test_split_chunk_bitwise(label_in_chunk, impute):
    """Label, dense and categorical columns and the row mask, with NaN cells
    and padding rows, as the reference's in-jit split gives them."""
    rng = np.random.default_rng(9)
    N, nd, nc, n_valid = 64, 3, 4, 50
    X = rng.standard_normal((N, int(label_in_chunk) + nd + nc)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    if label_in_chunk:
        X[:, 0] = rng.integers(0, 2, N)
    y = rng.integers(0, 2, N).astype(np.float32)
    w = (np.arange(N) < n_valid).astype(np.float32)
    kw = dict(label_in_chunk=label_in_chunk, n_dense=nd, impute_missing=impute)
    ours = _split_chunk(torch.from_numpy(X), n_valid, torch.from_numpy(y),
                        torch.from_numpy(w), **kw)
    yv, dense, cats, wv, _ = j_split_chunk(X, n_valid, y, w, **kw)
    for a, b in zip(ours, (yv, dense, cats, wv)):
        assert np.array_equal(a.numpy(), np.asarray(b), equal_nan=True)


def test_prefetch_keeps_order_and_reraises():
    stats = PipelineStats()
    out = list(tstream.prefetch_map(lambda x: x * x, iter(range(50)), depth=2,
                                    stats_into=stats))
    assert out == [x * x for x in range(50)]
    assert stats.items == 50 and 0.0 <= stats.overlap_pct <= 100.0

    def boom(x):
        if x == 3:
            raise KeyError("chunk 3")
        return x

    got = []
    with pytest.raises(KeyError, match="chunk 3"):
        for x in tstream.prefetch_map(boom, iter(range(10))):
            got.append(x)
    assert got == [0, 1, 2]


def test_prefetch_closed_early_stops_its_worker():
    before = threading.active_count()
    ex = PipelinedExecutor(lambda x: x, depth=1, name="test-prefetch")
    gen = ex.run(iter(range(10_000)))
    assert next(gen) == 0
    gen.close()
    for t in threading.enumerate():
        if t.name == "test-prefetch":
            t.join(timeout=5)
            assert not t.is_alive()
    assert ex.stats.done and threading.active_count() <= before


def _batch(nbytes):
    return (torch.zeros(nbytes // 4, dtype=torch.float32), 1, None, None)


def test_device_cache_budget_and_holdout_forgiveness():
    # everything fits: all batches cached, counted with the plan dict
    c = tstream._DeviceCache(True, 10_000)
    b = (torch.zeros(100), 5, None, None, {"row": torch.zeros(10, dtype=torch.int32)})
    c.offer(b)
    assert c.nbytes == 440 and c.batches == [b]
    # a miss outside the excludable tail drops the cache at once
    c = tstream._DeviceCache(True, 1000)
    for _ in range(3):
        c.offer(_batch(400))
    assert not c.enabled and c.degraded and c.batches == [] and c.nbytes == 0
    # misses inside the holdout tail are forgiven
    c = tstream._DeviceCache(True, 1000, may_exclude_tail=2)
    batches = [_batch(400) for _ in range(4)]
    for x in batches:
        c.offer(x)
    assert c.enabled and c.degraded and len(c.batches) == 2
    c.exclude({id(x[0]) for x in batches[-2:]})
    c.forgive_tail(2)
    c.settle()
    assert c.enabled and not c.degraded and len(c.batches) == 2 and c.nbytes == 800
    # a miss before the tail survives settle(): the cache drops whole
    c = tstream._DeviceCache(True, 1000, may_exclude_tail=3)
    for _ in range(4):
        c.offer(_batch(400))
    c.forgive_tail(1)
    c.settle()
    assert not c.enabled and c.degraded and c.batches == []


def test_cache_overflow_warns():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tstream.warn_cache_overflow(123, 4)
    assert "cache_device_bytes=123" in str(caught[0].message)


def test_csv_fit_and_evaluate_end_to_end(tmp_path):
    """csv_raw_chunk_source -> fit_stream(cache_device, holdout_chunks=2) ->
    evaluate_device(holdout), at the Criteo columns (13 + 26) and a small
    table: the holdout AUC within 1e-3 of the reference's, theta too."""
    cpu = TorchSession("cpu")
    jax_session = TpuSession(TpuSession.default_mesh(jax.devices()[:1]))
    path = str(tmp_path / "criteo.csv")
    gen_criteo_csv(path, 6500, seed=11)
    kw = dict(n_dims=1 << 14, n_dense=13, n_cat=26, chunk_rows=1024, epochs=4,
              step_size=0.04, reg_param=1e-5, label_in_chunk=True, loss="logistic",
              optim_update="sparse_adagrad", missing="zero", prefetch_depth=2)
    st: dict = {}
    model = StreamingHashedLinearEstimator(**kw).fit_stream(
        tstream.csv_raw_chunk_source(path, chunk_rows=1000), session=cpu, cache_device=True,
        holdout_chunks=2, stage_times=st)
    ref = JEstimator(**kw, fused_replay=False).fit_stream(
        jstream.csv_raw_chunk_source(path, chunk_rows=1000), session=jax_session, cache_device=True,
        holdout_chunks=2)
    ours = model.evaluate_device(model.holdout_chunks_)
    want = ref.evaluate_device(ref.holdout_chunks_)
    assert len(model.holdout_chunks_) == 2 and len(model.device_chunks_) == 5
    assert [c[1] for c in model.holdout_chunks_] == [1024, 356]
    assert model.n_steps_ == ref.n_steps_ == 20
    assert abs(ours["auc"] - want["auc"]) <= 1e-3
    assert ours["accuracy"] == pytest.approx(want["accuracy"], abs=1e-3)
    assert ours["logloss"] == pytest.approx(want["logloss"], rel=1e-4)
    for name, want_theta in ref.theta.items():
        np.testing.assert_allclose(model.theta[name].numpy(), np.asarray(want_theta),
                                   atol=1e-6, rtol=1e-5)
    assert st["optim_update"] == "sparse_adagrad" and st["sparse_lowering"] == "plan"
    assert st["cache_dtype"] == "f32" and st["cache_chunks"] == 5
    # fused_replay (the default): [epoch 1, the whole replay], as the reference
    assert len(st["epoch_s"]) == 2 and st["parse_s"] > 0 and st["h2d_s"] > 0
    assert st["epoch_s"][1] == st["replay_fused_s"]
    assert st["replay_source"] == "fused" and not st["cache_overflow"]
