"""The port's readers and writers (``io/readers.py``,
``io/native.read_csv_native``), ``ops/hashing.strings_to_u32`` and
``datasets.make_blobs`` against the JAX package's on the same files and
seeds.

Tolerances: none. The domain (variable types, names, category values and
their order) is equal, and X, Y, W and metas are bitwise; codes and draws
are bitwise. Where the reference falls back (its ``read_csv_native`` to
pyarrow, its ``write_csv`` to ``np.savetxt``) the port raises
``NativeUnavailable``.
"""

import csv
import sqlite3

import numpy as np
import pytest

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu import datasets as jdata
from orange3_spark_tpu.core import domain as jd
from orange3_spark_tpu.core.table import TpuTable
from orange3_spark_tpu.io import native as jnative
from orange3_spark_tpu.io import readers as JRd
from orange3_spark_tpu.ops import hashing as jhash
from orange3_spark_tpu_torch import TorchSession, TorchTable, datasets as tdata
from orange3_spark_tpu_torch.core import domain as td
from orange3_spark_tpu_torch.io import native as tnative
from orange3_spark_tpu_torch.io import readers as TRd
from orange3_spark_tpu_torch.ops import hashing as thash

from _torch_tables import assert_tables as _assert_tables


@pytest.fixture(scope="module")
def tsess():
    return TorchSession.builder_get_or_create("cpu")


def _mixed_csv(path, n=53, seed=0):
    """Numeric, low-cardinality string (with missing cells), high-
    cardinality string (a meta) and a string target."""
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fare", "pay", "note", "qty", "label"])
        for i in range(n):
            pay = "" if i % 9 == 4 else ["cash", "card", "dispute"][rng.integers(0, 3)]
            w.writerow([f"{rng.gamma(2, 7):.6g}", pay, f"note-{i}", int(rng.integers(0, 5)),
                        ["no", "yes"][rng.integers(0, 2)]])
    return str(path)


@pytest.mark.parametrize("class_col", ["", "label", "qty"])
def test_read_csv(session, tsess, tmp_path, class_col):
    path = _mixed_csv(tmp_path / "m.csv")
    ref = JRd.read_csv(path, class_col, session=session)
    got = TRd.read_csv(path, class_col, session=tsess)
    _assert_tables(ref, got)
    p = JRd.CsvReaderParams(path=path, class_col=class_col, delimiter=",")
    _assert_tables(ref, TRd.read_csv(params=TRd.CsvReaderParams(**p.to_dict()), session=tsess))


def test_read_csv_without_header_and_other_delimiter(session, tsess, tmp_path):
    path = tmp_path / "h.tsv"
    path.write_text("1\tx\t2.5\n2\ty\t\n3\tx\t-1e3\n")
    p = dict(path=str(path), header=False, delimiter="\t")
    _assert_tables(JRd.read_csv(params=JRd.CsvReaderParams(**p), session=session),
                   TRd.read_csv(params=TRd.CsvReaderParams(**p), session=tsess))
    with pytest.raises(ValueError, match="not found"):
        TRd.read_csv(str(path), "nope", session=tsess)


def _table_pair(session, tsess, n=41, seed=1):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.integers(0, 3, n), rng.normal(size=n), rng.integers(0, 2, n)], 1
                 ).astype(np.float32)
    X[[2, 7], 0] = np.nan
    X[5, 1] = np.nan
    Y = rng.integers(0, 2, n).astype(np.float32)
    W = (rng.random(n) > 0.2).astype(np.float32)
    out = []
    for mod, Table, sess in ((jd, TpuTable, session), (td, TorchTable, tsess)):
        dom = mod.Domain([mod.DiscreteVariable("pay", ("cash", "card", "none")),
                          mod.ContinuousVariable("tip"),
                          mod.DiscreteVariable("vendor", ("1", "2"))],
                         mod.DiscreteVariable("click", ("no", "yes")))
        out.append(Table.from_numpy(dom, X, Y, W=W, session=sess))
    return out


@pytest.mark.parametrize("drop_filtered", [True, False])
def test_parquet_round_trip(session, tsess, tmp_path, drop_filtered):
    j, t = _table_pair(session, tsess)
    JRd.write_parquet(j, str(tmp_path / "r.parquet"), drop_filtered=drop_filtered)
    TRd.write_parquet(t, str(tmp_path / "p.parquet"), drop_filtered=drop_filtered)
    for name in ("r", "p"):       # each package reads both files
        path = str(tmp_path / f"{name}.parquet")
        _assert_tables(JRd.read_parquet(path, "click", session=session),
                       TRd.read_parquet(path, "click", session=tsess))
    back = TRd.read_parquet(str(tmp_path / "p.parquet"), "click", session=tsess)
    assert back.domain == t.domain


@pytest.mark.parametrize("if_exists", ["replace", "append"])
def test_sql_round_trip(session, tsess, tmp_path, if_exists):
    j, t = _table_pair(session, tsess)
    for pkg, tb, db in ((JRd, j, tmp_path / "r.db"), (TRd, t, tmp_path / "p.db")):
        pkg.write_sql(tb, str(db), "trips")
        pkg.write_sql(tb, str(db), "Trips", if_exists=if_exists)
    dump = [sqlite3.connect(str(tmp_path / f"{n}.db")).execute(
        "SELECT * FROM trips").fetchall() for n in ("r", "p")]
    assert dump[0] == dump[1]
    for q in ("SELECT * FROM trips", "SELECT tip, pay FROM trips WHERE tip > 0"):
        _assert_tables(JRd.read_sql(q, str(tmp_path / "r.db"), session=session),
                       TRd.read_sql(q, str(tmp_path / "p.db"), session=tsess))
    _assert_tables(JRd.read_sql("SELECT * FROM trips", str(tmp_path / "r.db"), "click",
                                session=session),
                   TRd.read_sql("SELECT * FROM trips", str(tmp_path / "p.db"), "click",
                                session=tsess))
    with pytest.raises(ValueError, match="already exists"):
        TRd.write_sql(t, str(tmp_path / "p.db"), "TRIPS", if_exists="fail")
    with pytest.raises(ValueError, match="if_exists"):
        TRd.write_sql(t, str(tmp_path / "p.db"), "x", if_exists="merge")


def test_write_csv_then_read_csv_native_bitwise(session, tsess, tmp_path):
    """The native writer's shortest round-trip floats: the file reads back
    to the same float32 bits, and both packages write the same file."""
    rng = np.random.default_rng(4)
    X = np.stack([rng.gamma(2, 7, 300), rng.normal(size=300) * 1e-7,
                  rng.integers(0, 265, 300)], 1).astype(np.float32)
    X[3, 0] = np.nan
    X[4, 1] = np.inf
    j = TpuTable.from_arrays(X, X[:, 2] % 2, session=session)
    t = TorchTable.from_arrays(X, X[:, 2] % 2, session=tsess)
    JRd.write_csv(j, str(tmp_path / "r.csv"))
    TRd.write_csv(t, str(tmp_path / "p.csv"))
    assert (tmp_path / "r.csv").read_bytes() == (tmp_path / "p.csv").read_bytes()
    back = tnative.read_csv_native(str(tmp_path / "p.csv"), class_col="y", session=tsess)
    assert np.array_equal(back.to_numpy()[0].view(np.uint32), X.view(np.uint32))
    for cc in ("", "y"):
        _assert_tables(jnative.read_csv_native(str(tmp_path / "r.csv"), cc, session=session),
                       tnative.read_csv_native(str(tmp_path / "p.csv"), cc, session=tsess))
    with pytest.raises(ValueError, match="not in"):
        tnative.read_csv_native(str(tmp_path / "p.csv"), class_col="nope", session=tsess)


def test_native_unavailable_raises_where_the_reference_falls_back(tsess, tmp_path,
                                                                   monkeypatch):
    path = _mixed_csv(tmp_path / "m.csv")

    def no_engine():
        raise tnative.NativeUnavailable("no g++")

    monkeypatch.setattr(tnative, "get_lib", no_engine)
    with pytest.raises(tnative.NativeUnavailable):
        tnative.read_csv_native(path, session=tsess)
    t = TorchTable.from_arrays(np.ones((3, 2), np.float32), session=tsess)
    with pytest.raises(tnative.NativeUnavailable):
        TRd.write_csv(t, str(tmp_path / "out.csv"))
    assert not (tmp_path / "out.csv").exists()


def test_strings_to_u32_bitwise():
    rng = np.random.default_rng(0)
    hexes = np.asarray([f"{v:08x}" for v in rng.integers(0, 2**32, 500)])
    for arr in (hexes, hexes.reshape(50, 10), np.asarray(["", "a", "é", "a"]),
                np.asarray([1, 22, 1])):
        ref, got = jhash.strings_to_u32(arr), thash.strings_to_u32(arr)
        assert got.dtype == np.uint32 and np.array_equal(ref, got)
        assert (got <= thash.STRING_CODE_MASK).all()
    assert thash.STRING_CODE_MASK == jhash.STRING_CODE_MASK


@pytest.mark.parametrize("args", [(100, 3, 4, 0), (257, 5, 10, 7, 1.5)])
def test_make_blobs_bitwise(session, tsess, args):
    jt, ja = jdata.make_blobs(*args, session=session)
    tt, ta = tdata.make_blobs(*args, session=tsess)
    _assert_tables(jt, tt)
    assert np.array_equal(ja, ta)


def test_tlc_generators(tsess, tmp_path):
    """``make_tlc_trips`` / ``tlc_zone_lookup`` / ``write_tlc_sqlite``: the
    TLC columns and codes, the Zipf head, the missing shares, the zone
    counts a borough; the SQLite tables read back through ``read_sql``."""
    X = tdata.make_tlc_trips(200_000, seed=0)
    dom = tdata.tlc_domain()
    assert X.shape == (200_000, len(tdata.TLC_COLUMNS)) and X.dtype == np.float32
    assert [v.name for v in dom.attributes] == list(tdata.TLC_COLUMNS)
    pu = X[:, 1].astype(int)
    head = np.bincount(pu, minlength=265).max() / len(pu)
    assert 0.15 < head < 0.175 and pu.min() >= 0 and pu.max() < 265   # 1 / H_265 = 0.162
    assert 0.0005 < np.isnan(X[:, 3]).mean() < 0.0015          # payment_type 0.1 %
    assert 0.008 < np.isnan(X[:, 4]).mean() < 0.012             # passenger_count 1 %
    assert (X[:, 6] > 0).all() and (X[:, 7][X[:, 3] != 0] == 0).all()   # tips on cards only
    assert np.array_equal(X, tdata.make_tlc_trips(200_000, seed=0), equal_nan=True)
    zdom, Z = tdata.tlc_zone_lookup()
    counts = np.bincount(Z[:, 1].astype(int), minlength=7)
    assert dict(zip(zdom["Borough"].values, counts)) == dict(tdata.TLC_BOROUGHS)
    db = str(tmp_path / "t.db")
    tdata.write_tlc_sqlite(db, 3000, seed=2)
    trips = TRd.read_sql("SELECT * FROM trips", db, session=tsess)
    assert trips.n_rows == 3000
    assert trips.domain["payment_type"].values == tdata.TLC_PAYMENT_TYPES
    Xs = tdata.make_tlc_trips(3000, seed=2)
    got = trips.to_numpy()[0]
    assert np.array_equal(got[:, 1], Xs[:, 1] + 1)              # LocationID 1-265
    assert np.array_equal(got[:, 5:], Xs[:, 5:], equal_nan=True)
    zones = TRd.read_sql("SELECT * FROM zones", db, session=tsess)
    assert zones.n_rows == 265 and zones.domain["Borough"].values == tuple(
        sorted(b for b, _ in tdata.TLC_BOROUGHS))
