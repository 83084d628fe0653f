"""Helpers of the port's wrangling tests: the same table built in both
packages from one numpy input (``table_pair``), and two tables compared
variable by variable and cell by cell (``assert_tables``)."""

import numpy as np

from orange3_spark_tpu.core import domain as jd
from orange3_spark_tpu.core.table import TpuTable
from orange3_spark_tpu_torch.core import domain as td
from orange3_spark_tpu_torch.core.table import TorchTable

from _port_parity import assert_port_equal


def domains(cols, class_var=None, metas=()):
    """(reference Domain, port Domain) of ``cols``: (name, category values
    or None for a continuous column) pairs."""
    def mk(mod, name, values):
        return mod.DiscreteVariable(name, values) if values else mod.ContinuousVariable(name)
    out = []
    for mod in (jd, td):
        out.append(mod.Domain([mk(mod, n, v) for n, v in cols],
                              None if class_var is None else mk(mod, *class_var),
                              [mod.StringVariable(m) for m in metas]))
    return out


def table_pair(session, tsess, cols, X, *, W=None, Y=None, class_var=None, metas=None,
               meta_names=()):
    """(TpuTable on ``session``, TorchTable on ``tsess``) of the same data."""
    jdom, tdom = domains(cols, class_var, meta_names)
    return (TpuTable.from_numpy(jdom, X, Y, metas, W, session=session),
            TorchTable.from_numpy(tdom, X, Y, metas, W, session=tsess))


def assert_tables(ref, got, *, rtol=0.0, what=""):
    """Same variables (type, name, values), X / Y / W and metas."""
    def spec(dom):
        return [(type(v).__name__, v.name, getattr(v, "values", None))
                for v in dom.attributes + dom.class_vars + dom.metas]
    assert spec(got.domain) == spec(ref.domain), what
    assert got.n_rows == ref.n_rows, what
    (rX, rY, rW), (gX, gY, gW) = ref.to_numpy(), got.to_numpy()
    assert_port_equal(rX, gX, rtol=rtol, what=f"{what} X")
    assert_port_equal(rW, gW, what=f"{what} W")
    assert (rY is None) == (gY is None)
    if rY is not None:
        assert_port_equal(rY, gY, what=f"{what} Y")
    if ref.metas is not None or got.metas is not None:
        assert np.array_equal(np.asarray(ref.metas)[:ref.n_rows], got.metas[:got.n_rows])
