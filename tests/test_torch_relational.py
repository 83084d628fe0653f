"""The port's relational ops (``ops/relational.py``) against the JAX
package's on the same numpy inputs.

The reference runs on the 8-device CPU mesh of ``tests/conftest.py``, so
its tables are padded to a multiple of 8 rows; the port pads nothing. Row
counts here are mostly not multiples of 8. Tables with a live NaN value
are held against the reference on ONE device: on the mesh its group
min and max combine the devices' partial results with a min that is not
NaN-propagating, so whether a group's NaN survives depends on which
device its rows land on (ROADMAP queue 3, item 3); the port
gives the one-device answer, NaN.

Tolerances. Indices, orders, masks, counts, mins and maxs, joins, sorts,
samples and splits are bitwise. Sums and means are float32 sums taken in
another order (the reference's one-hot product against the port's sorted
segment sums), within ``SUM_RTOL`` = 256 * 2^-24 relative: every group
here has at most 256 rows of one sign, and each add rounds by at most
2^-24 of the group's total. NaN lands in the same places as the reference's in every case,
including the one-hot product's (ROADMAP queue 3, item 3): it spreads a
non-finite value to every other group's sum, and a NaN key counts in
group 0.
"""

import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.ops import relational as JR
from orange3_spark_tpu_torch import TorchSession
from orange3_spark_tpu_torch.ops import relational as TR
from orange3_spark_tpu_torch.ops import segment_sum as S

from _port_parity import assert_port_equal
from _torch_tables import assert_tables as _assert_tables, table_pair as _pair

SUM_RTOL = 256 * 2.0**-24
AGGS = [("v", "sum"), ("v", "mean"), ("v", "count"), ("v", "min"), ("v", "max")]


@pytest.fixture(scope="module")
def tsess():
    return TorchSession.builder_get_or_create("cpu")


@pytest.fixture(scope="module")
def jsess1():
    """The reference on one device (no cross-device combine)."""
    import jax

    from orange3_spark_tpu.core.session import TpuSession

    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


def _trips(session, tsess, n=203, seed=0, nonfinite=True, dead=0.1):
    """Keys k (4 values) and k2 (3 values), values v > 0 and u = -v, dead
    rows; with ``nonfinite`` (n > 20) NaN keys, an out-of-range code, an
    inf and a NaN value."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 4, n).astype(np.float32)
    k2 = rng.integers(0, 3, n).astype(np.float32)
    v = rng.gamma(2.0, 10.0, n).astype(np.float32)
    if nonfinite and n > 20:
        k[5], k2[9], k[7] = np.nan, np.nan, 9.0
        v[11], v[17] = np.inf, np.nan
    W = (rng.random(n) > dead).astype(np.float32)
    X = np.stack([k, k2, v, -v], 1)
    cols = [("k", ("a", "b", "c", "d")), ("k2", ("x", "y", "z")), ("v", None), ("u", None)]
    return _pair(session, tsess, cols, X, W=W)


# --------------------------------------------------------------- group_by
def test_one_hot_nan_spread_and_nan_key_in_group0(jsess1, tsess):
    """The reference's one-hot product: a NaN value in one group makes
    every group's sum and mean NaN; the NaN-key row counts in group 0."""
    X = np.array([[0, 1.0], [np.nan, 2.0], [1, np.nan], [2, 4.0], [1, 5.0]], np.float32)
    j, t = _pair(jsess1, tsess, [("k", ("a", "b", "c")), ("v", None)], X)
    ref, got = JR.group_by(j, "k", AGGS), TR.group_by(t, "k", AGGS)
    _assert_tables(ref, got)
    gX = got.to_numpy()[0]
    assert np.isnan(gX[:, 1]).all() and np.isnan(gX[:, 2]).all()     # sum, mean
    assert gX[:, 3].tolist() == [2.0, 2.0, 1.0]                      # count
    assert gX[0, 4:].tolist() == [1.0, 2.0]                          # the NaN key's 2.0
    assert np.isnan(gX[1, 4:]).all() and gX[2, 4:].tolist() == [4.0, 4.0]


@pytest.mark.parametrize("n", [203, 256, 1])
@pytest.mark.parametrize("nonfinite", [True, False])
def test_group_by_single_key(session, jsess1, tsess, n, nonfinite):
    j, t = _trips(jsess1 if nonfinite else session, tsess, n=n, nonfinite=nonfinite)
    _assert_tables(JR.group_by(j, "k", AGGS), TR.group_by(t, "k", AGGS), rtol=SUM_RTOL)


@pytest.mark.parametrize("nonfinite", [True, False])
def test_group_by_multi_key_pairs_and_empty_groups(session, jsess1, tsess, nonfinite):
    j, t = _trips(jsess1 if nonfinite else session, tsess, nonfinite=nonfinite)
    aggs = AGGS + [("u", "min"), ("u", "max"), ("u", "sum")]
    _assert_tables(JR.group_by(j, ["k", "k2"], aggs), TR.group_by(t, ["k", "k2"], aggs),
                   rtol=SUM_RTOL)
    # a filter that empties whole groups: count 0, NaN mean / min / max
    jf = j.filter(lambda tb: tb.column("k") != 1)
    tf = t.filter(lambda tb: tb.column("k") != 1)
    ref, got = JR.group_by(jf, ["k2", "k"], aggs), TR.group_by(tf, ["k2", "k"], aggs)
    _assert_tables(ref, got, rtol=SUM_RTOL)
    assert (got.to_numpy()[0][1::4, 4] == 0).all()


def test_group_by_global_and_dict_aggs(session, tsess):
    j, t = _trips(session, tsess, nonfinite=False)
    for key in (None, []):
        _assert_tables(JR.group_by(j, key, {"v": "sum", "u": "max"}),
                       TR.group_by(t, key, {"v": "sum", "u": "max"}), rtol=SUM_RTOL)
    _assert_tables(JR.group_by(j, "k2", {"v": "mean"}), TR.group_by(t, "k2", {"v": "mean"}),
                   rtol=SUM_RTOL)


def test_group_by_out_of_range_codes_follow_the_composite(session, tsess):
    """A code past its key's range shifts the row-major composite into
    another group (or past the last, where it counts nowhere), as the
    reference's int32 composite does; a negative code counts nowhere."""
    X = np.array([[0, 5, 1.0], [1, 1, 2.0], [3, 0, 4.0], [-1, 0, 8.0], [0, 2, 16.0]],
                 np.float32)
    j, t = _pair(session, tsess, [("a", ("p", "q")), ("b", ("x", "y", "z")), ("v", None)], X)
    _assert_tables(JR.group_by(j, ["a", "b"], AGGS), TR.group_by(t, ["a", "b"], AGGS))


def test_group_by_errors(session, tsess):
    _, t = _trips(session, tsess)
    with pytest.raises(ValueError, match="Discrete"):
        TR.group_by(t, "v", {"u": "sum"})
    with pytest.raises(ValueError, match="unknown agg"):
        TR.group_by(t, "k", {"v": "median"})
    with pytest.raises(ValueError, match="at least one agg"):
        TR.group_by(t, None, {})
    with pytest.raises(KeyError):
        TR.group_by(t, "k", {"nope": "sum"})


def test_grouped_pass_runs_the_segment_sum_plain_version_on_the_cpu(session, tsess):
    """On the CPU the grouped pass is ``segment_sum_sorted``'s plain
    version: the kernel's launch count does not move."""
    _, t = _trips(session, tsess)
    before = S.segment_sum_sorted.launches
    TR.group_by(t, "k", AGGS)
    assert S.segment_sum_sorted.launches == before
    slot = torch.tensor([2, 0, 2, 3, 1, 0], dtype=torch.int32)
    g = torch.arange(6, dtype=torch.float32)[:, None]
    assert TR.grouped_sums(slot, g, 3)[:, 0].tolist() == [6.0, 4.0, 2.0]


# ------------------------------------------------ pivot, rollup, cube
@pytest.mark.parametrize("values", [None, ["z", "x"]])
def test_pivot(jsess1, tsess, values):
    j, t = _trips(jsess1, tsess)
    for aggs in ({"v": "mean"}, [("v", "sum"), ("u", "min"), ("v", "count")]):
        _assert_tables(JR.pivot(j, "k", "k2", aggs, values=values),
                       TR.pivot(t, "k", "k2", aggs, values=values), rtol=SUM_RTOL)
    with pytest.raises(ValueError, match="not in"):
        TR.pivot(t, "k", "k2", {"v": "sum"}, values=["w"])


@pytest.mark.parametrize("fn", ["rollup", "cube"])
def test_rollup_and_cube(jsess1, tsess, fn):
    j, t = _trips(jsess1, tsess)
    aggs = [("u", "max"), ("v", "count"), ("v", "mean"), ("u", "min"), ("v", "sum")]
    _assert_tables(getattr(JR, fn)(j, ["k", "k2"], aggs),
                   getattr(TR, fn)(t, ["k", "k2"], aggs), rtol=SUM_RTOL)
    _assert_tables(getattr(JR, fn)(j, "k2", {"v": "sum"}),
                   getattr(TR, fn)(t, "k2", {"v": "sum"}), rtol=SUM_RTOL)


# ------------------------------------------------------- crosstab, counts
@pytest.mark.parametrize("nonfinite", [True, False])
def test_crosstab_value_counts_freq_items(session, tsess, nonfinite):
    j, t = _trips(session, tsess, nonfinite=nonfinite)
    assert_port_equal(JR.crosstab(j, "k", "k2"), TR.crosstab(t, "k", "k2"))
    assert_port_equal(JR.crosstab(j, "k2", "k"), TR.crosstab(t, "k2", "k"))
    assert JR.value_counts(j, "k") == TR.value_counts(t, "k")
    for support in (0.2, 0.26, 1e-4):
        assert JR.freq_items(j, ["k", "k2"], support) == TR.freq_items(t, ["k", "k2"], support)
    with pytest.raises(ValueError, match="support"):
        TR.freq_items(t, "k", 0.0)
    with pytest.raises(ValueError, match="not discrete"):
        TR.value_counts(t, "v")


# ------------------------------------------------------------------ joins
def _dim(session, tsess, rows, extra=("rate",), values=("a", "b", "c", "d")):
    cols = [("k", values)] + [(e, None) for e in extra]
    return _pair(session, tsess, cols, np.asarray(rows, np.float32))


@pytest.mark.parametrize("how", ["left", "inner"])
def test_join_dimension_table(session, tsess, how):
    j, t = _trips(session, tsess)
    # 'c' missing on the right; the right enumerates its values in another order
    jd_, td_ = _dim(session, tsess, [[0, 0.5], [1, 0.25], [3, 2.0]],
                    values=("d", "a", "x", "b"))
    _assert_tables(JR.join(j, jd_, "k", how), TR.join(t, td_, "k", how))


def test_join_errors(session, tsess):
    _, t = _trips(session, tsess)
    _, dup = _dim(session, tsess, [[0, 1.0], [0, 2.0]])
    with pytest.raises(ValueError, match="duplicate"):
        TR.join(t, dup, "k")
    _, clash = _dim(session, tsess, [[0, 1.0]], extra=("v",))
    with pytest.raises(ValueError, match="duplicate column names"):
        TR.join(t, clash, "k")
    with pytest.raises(ValueError, match="how"):
        TR.join(t, dup, "k", "outer")
    with pytest.raises(ValueError, match="duplicate column names"):
        TR.join_expand(t, clash, "k", max_matches=2)


@pytest.mark.parametrize("how", ["left", "inner"])
def test_join_expand(session, tsess, how):
    j, t = _trips(session, tsess, n=37)
    rows = [[0, 1.0, 5.0], [3, 2.0, 6.0], [0, 3.0, 7.0], [1, 4.0, 8.0]]
    jr, tr = _dim(session, tsess, rows, extra=("r1", "r2"))
    _assert_tables(JR.join_expand(j, jr, "k", max_matches=2, how=how),
                   TR.join_expand(t, tr, "k", max_matches=2, how=how))
    with pytest.raises(ValueError, match="max_matches=1"):
        TR.join_expand(t, tr, "k", max_matches=1)


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_join_host_with_class_and_metas(session, tsess, how):
    rng = np.random.default_rng(3)
    n = 29
    X = np.stack([rng.integers(0, 4, n), rng.normal(size=n)], 1).astype(np.float32)
    Y = rng.integers(0, 2, n).astype(np.float32)
    metas = np.asarray([[f"r{i}"] for i in range(n)], dtype=object)
    W = (rng.random(n) > 0.2).astype(np.float32)
    j, t = _pair(session, tsess, [("k", ("a", "b", "c", "d")), ("x", None)], X, W=W, Y=Y,
                 class_var=("y", ("no", "yes")), metas=metas, meta_names=("id",))
    rows = [[0, 1.0], [0, 2.0], [2, 3.0], [4, 9.0]]
    jr, tr = _dim(session, tsess, rows, extra=("r",), values=("a", "b", "c", "d", "e"))
    _assert_tables(JR.join_host(j, jr, "k", how), TR.join_host(t, tr, "k", how))


# ------------------------------------------------------------ sort, sample
@pytest.mark.parametrize("ascending", [True, False])
def test_sort_nan_inf_zero_signs_filtered_rows_and_metas(session, tsess, ascending):
    v = np.array([3.0, np.nan, -0.0, 0.0, np.inf, -np.inf, 1.0, np.nan, 0.0, -0.0, 2.0],
                 np.float32)
    X = np.stack([v, np.arange(len(v))], 1).astype(np.float32)
    W = np.array([1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0], np.float32)
    metas = np.asarray([[str(i)] for i in range(len(v))], dtype=object)
    j, t = _pair(session, tsess, [("v", None), ("i", None)], X, W=W, metas=metas,
                 meta_names=("m",))
    _assert_tables(JR.sort(j, "v", ascending), TR.sort(t, "v", ascending))


@pytest.mark.parametrize("n", [203, 256])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_sample_sample_by_and_splits_keep_the_reference_rows(session, tsess, n, seed):
    j, t = _trips(session, tsess, n=n)
    pairs = [
        (JR.sample(j, 0.37, seed), TR.sample(t, 0.37, seed)),
        (JR.sample_by(j, "k2", {"x": 0.5, "z": 1.0}, seed),
         TR.sample_by(t, "k2", {"x": 0.5, "z": 1.0}, seed)),
        *zip(JR.random_split(j, [0.7, 0.2, 0.1], seed), TR.random_split(t, [0.7, 0.2, 0.1], seed)),
        *zip(JR.train_test_split(j, 0.3, seed), TR.train_test_split(t, 0.3, seed)),
    ]
    for ref, got in pairs:
        _assert_tables(ref, got)
    parts = TR.random_split(t, [3, 1, 1], seed)
    assert sum(p.count() for p in parts) == t.count()


def test_sample_errors(session, tsess):
    _, t = _trips(session, tsess)
    with pytest.raises(ValueError, match="not in"):
        TR.sample_by(t, "k", {"q": 0.5})
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        TR.sample_by(t, "k", {"a": 1.5})
    with pytest.raises(ValueError, match="discrete"):
        TR.sample_by(t, "v", {"a": 0.5})
    with pytest.raises(ValueError, match="positive"):
        TR.random_split(t, [1.0, 0.0])


# --------------------------------------------- union, distinct, columns
def test_union_with_one_sided_metas(session, tsess):
    j1, t1 = _trips(session, tsess, n=11, seed=1)
    X = np.asarray(t1.to_numpy()[0][:5])
    metas = np.asarray([[f"m{i}"] for i in range(5)], dtype=object)
    cols = [("k", ("a", "b", "c", "d")), ("k2", ("x", "y", "z")), ("v", None), ("u", None)]
    j2, t2 = _pair(session, tsess, cols, X, metas=metas)
    _assert_tables(JR.union(j1, j2), TR.union(t1, t2))
    _assert_tables(JR.union(j2, j1), TR.union(t2, t1))
    _, other = _pair(session, tsess, [("k", ("a",))], np.zeros((2, 1), np.float32))
    with pytest.raises(ValueError, match="identical domains"):
        TR.union(t1, other)


@pytest.mark.parametrize("cols", [None, ["k", "k2"], ["y"]])
def test_distinct(session, tsess, cols):
    rng = np.random.default_rng(5)
    n = 61
    X = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)], 1).astype(np.float32)
    X[[3, 8], 1] = np.nan
    Y = rng.integers(0, 2, n).astype(np.float32)
    W = (rng.random(n) > 0.2).astype(np.float32)
    j, t = _pair(session, tsess, [("k", ("a", "b", "c")), ("k2", ("x", "y"))], X, W=W, Y=Y,
                 class_var=("y", ("0", "1")))
    _assert_tables(JR.distinct(j, cols), TR.distinct(t, cols))
    with pytest.raises(ValueError, match="not found"):
        TR.distinct(t, ["nope"])


@pytest.mark.parametrize("expr", ["v / u + 2 * v", "(v - 3) % 7", "-v ** 0.5",
                                  "(v > 10) and (u < -5) or (v == 2)", "v * 0 + 1.5"])
def test_with_column_expressions_bitwise(session, tsess, expr):
    """Arithmetic, comparisons and and/or over float32 columns and float32
    literals: the same operations in the same order, bitwise."""
    j, t = _trips(session, tsess)
    _assert_tables(JR.with_column(j, "r", expr), TR.with_column(t, "r", expr))
    _assert_tables(JR.with_column(j, "v", expr), TR.with_column(t, "v", expr))   # replaced


def test_with_column_transcendental_callable_array_and_drop(session, tsess):
    """log / exp / sqrt / sin / cos / abs: XLA's and PyTorch's CPU
    functions may differ in the last bit: within 4 * 2^-24 relative."""
    j, t = _trips(session, tsess, nonfinite=False)
    expr = "log(v) + exp(u / 50) + sqrt(v) + sin(v) * cos(u) + abs(u)"
    _assert_tables(JR.with_column(j, "r", expr), TR.with_column(t, "r", expr),
                   rtol=4 * 2.0**-24)
    col = np.arange(t.n_rows, dtype=np.float32)
    ref = JR.with_column(j, "r", np.pad(col, (0, j.n_pad - t.n_rows)))
    _assert_tables(ref, TR.with_column(t, "r", col))
    _assert_tables(ref, TR.with_column(t, "r", torch.from_numpy(col)))
    _assert_tables(ref, TR.with_column(t, "r", lambda tb: torch.from_numpy(col)))
    _assert_tables(JR.drop(j, ["u", "k2"]), TR.drop(t, ["u", "k2"]))
    _assert_tables(JR.drop(j, "v"), TR.drop(t, "v"))
    with pytest.raises(ValueError, match="unknown column"):
        TR.with_column(t, "r", "nope + 1")
    with pytest.raises(ValueError, match="cannot drop"):
        TR.drop(t, "nope")


def test_smoke_wrangle_phase_on_the_cpu(tsess, tmp_path, monkeypatch):
    """``chip_smoke.phase_wrangle`` rehearsed at 50,000 rows with the CPU
    standing for the card (its kernel check, which times captured CUDA
    graphs, left out): every call runs and compares."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "WRANGLE_ROWS", 50_000)
    monkeypatch.setattr(cs, "WRANGLE_CUT", 10_000)
    monkeypatch.setattr(cs, "WRANGLE_WARM_ROWS", 1_000)
    monkeypatch.setattr(cs, "_wrangle_kernel", lambda args, bw: {"k": args[0].shape[1]})
    line = cs.phase_wrangle(tsess, 3.35e12, str(tmp_path))
    assert line["kernel"] == {"k": 4}
    assert set(line["checks"]) == {n for n, *_ in cs._wrangle_calls()} | {"csv_round_trip"}
    assert all(cs._all_equal(c) for c in line["checks"].values())


@pytest.mark.parametrize("statement", [
    "SELECT *, v * 2 + u AS w, (v > 10) AS big FROM __THIS__",
    "SELECT v / u AS r, -v AS n FROM __THIS__ WHERE v > 15",
    "SELECT * FROM __THIS__ WHERE (v < 30) and (k >= 1)",
    "select *, sqrt(v) as s from __THIS__;"])
def test_sql_transformer_against_the_reference(session, tsess, statement):
    """``models/feature_extra.SQLTransformer``: the appended columns, the
    projection and the WHERE mask as the reference's (bitwise; sqrt is
    correctly rounded in both)."""
    from orange3_spark_tpu.models.feature_extra import SQLTransformer as JSQL
    from orange3_spark_tpu_torch.models.feature_extra import SQLTransformer as TSQL

    j, t = _trips(session, tsess, nonfinite=False)
    _assert_tables(JSQL(statement=statement).transform(j),
                   TSQL(statement=statement).transform(t))


def test_sql_transformer_errors(tsess, session):
    from orange3_spark_tpu_torch.models.feature_extra import SQLTransformer as TSQL

    _, t = _trips(session, tsess)
    for bad, match in (("SELECT v FROM __THIS__", "AS name"), ("DROP TABLE x", "SELECT"),
                       ("SELECT * , v ** q AS z FROM __THIS__", "unknown column"),
                       ("SELECT v @ v AS z FROM __THIS__", "unsupported")):
        with pytest.raises(ValueError, match=match):
            TSQL(statement=bad).transform(t)
