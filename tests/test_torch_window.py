"""The port's window functions (``ops/window.py``) against the JAX
package's on the same numpy inputs (the reference on the 8-device CPU mesh,
its rows padded to a multiple of 8; results compared on the table's rows).

Tolerances. Row numbers, lag and lead are bitwise (a permutation and a
shift, NaN in the same places). ``running_sum`` is one global prefix sum
less the partition's base in both packages, but ``jnp.cumsum`` and
``torch.cumsum`` add in other orders, so each value is held within
n * 2^-24 times the global prefix of |v| (float32 rounding of a running
sum of n terms), and its NaNs in the same places.
"""

import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core import domain as jd
from orange3_spark_tpu.core.table import TpuTable
from orange3_spark_tpu.ops import window as JW
from orange3_spark_tpu_torch import TorchSession, TorchTable
from orange3_spark_tpu_torch.core import domain as td
from orange3_spark_tpu_torch.ops import relational as TR
from orange3_spark_tpu_torch.ops import window as TW

from _port_parity import assert_port_equal


@pytest.fixture(scope="module")
def tsess():
    return TorchSession.builder_get_or_create("cpu")


def _tables(session, tsess, n, seed):
    """Partition key (3 cities, NaN keys), an order column with ties, NaN,
    -0.0 and +0.0, a fare with NaN values, dead rows."""
    rng = np.random.default_rng(seed)
    city = rng.integers(0, 3, n).astype(np.float32)
    t = rng.integers(0, n // 3 + 1, n).astype(np.float32)
    fare = rng.gamma(2.0, 7.0, n).astype(np.float32)
    city[rng.random(n) < 0.05] = np.nan
    t[rng.random(n) < 0.05] = np.nan
    t[rng.random(n) < 0.1] = 0.0
    t[rng.random(n) < 0.1] = -0.0
    fare[rng.random(n) < 0.05] = np.nan
    W = (rng.random(n) > 0.1).astype(np.float32)
    X = np.stack([city, t, fare], 1)
    jdom = jd.Domain([jd.DiscreteVariable("city", ("nyc", "sf", "la")),
                      jd.ContinuousVariable("t"), jd.ContinuousVariable("fare")])
    tdom = td.Domain([td.DiscreteVariable("city", ("nyc", "sf", "la")),
                      td.ContinuousVariable("t"), td.ContinuousVariable("fare")])
    return (TpuTable.from_numpy(jdom, X, W=W, session=session),
            TorchTable.from_numpy(tdom, X, W=W, session=tsess), fare, W)


@pytest.mark.parametrize("n", [5, 203, 1000])
@pytest.mark.parametrize("ascending", [True, False])
def test_window_functions_match_the_reference(session, tsess, n, ascending):
    j, t, fare, W = _tables(session, tsess, n, seed=n)
    jw = JW.Window(j, "city", "t", ascending=ascending)
    tw = TW.Window(t, "city", "t", ascending=ascending)
    assert_port_equal(np.asarray(jw.row_number())[:n], tw.row_number(), what="row_number")
    for off in (1, 2, 0):
        assert_port_equal(np.asarray(jw.lag("fare", off))[:n], tw.lag("fare", off), what="lag")
        assert_port_equal(np.asarray(jw.lead("fare", off))[:n], tw.lead("fare", off),
                          what="lead")
    bound = n * 2.0**-24 * float(np.nansum(np.abs(fare) * (W > 0)))
    assert_port_equal(np.asarray(jw.running_sum("fare"))[:n], tw.running_sum("fare"),
                      atol=bound, what="running_sum")


def test_one_shot_forms_and_with_column(session, tsess):
    n = 97
    j, t, fare, W = _tables(session, tsess, n, seed=1)
    for name, args in (("row_number", ("city", "t")), ("lag", ("fare", "city", "t")),
                       ("lead", ("fare", "city", "t"))):
        assert_port_equal(np.asarray(getattr(JW, name)(j, *args, ascending=False))[:n],
                          getattr(TW, name)(t, *args, ascending=False), what=name)
    assert_port_equal(np.asarray(JW.lag(j, "fare", "city", "t", offset=3))[:n],
                      TW.lag(t, "fare", "city", "t", offset=3))
    rs = TW.running_sum(t, "fare", "city", "t")
    out = TR.with_column(t, "running_fare", rs)
    live = W > 0
    got = out.to_numpy()[0][:, -1]
    assert np.array_equal(got[live], rs.numpy()[live], equal_nan=True)
    assert (got[~live] == 0).all()                 # with_column zeroes dead rows
    assert isinstance(rs, torch.Tensor) and rs.shape == (t.n_pad,)


def test_window_partition_must_be_discrete(session, tsess):
    _, t, _, _ = _tables(session, tsess, 20, seed=2)
    with pytest.raises(ValueError, match="discrete"):
        TW.Window(t, "fare", "t")
