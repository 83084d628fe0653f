"""The port's FPGrowth and PrefixSpan (``models/fpm.py``) against the JAX
package's, on the same seeded transactions and sequences (a few hundred),
with the ``interop`` converter and the widget.

Everything here is bitwise: supports are integer counts (float32 products
of 0/1 values, exact below 2^24, summed in float64), the itemsets, rules
(their confidence, lift and support are float64 quotients of the same
counts), the transform's binary predictions and PrefixSpan's patterns.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.models import fpm as JF
from orange3_spark_tpu_torch import interop
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.models import fpm as TF
from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY, OWTable
from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph

from _port_parity import to_np
from _torch_tables import table_pair


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession("cpu")


def baskets(n=300, items=12, seed=0):
    """Transactions drawn from a few overlapping patterns plus noise."""
    rng = np.random.default_rng(seed)
    patterns = [rng.choice(items, rng.integers(2, 5), replace=False) for _ in range(5)]
    out = []
    for _ in range(n):
        t = set(patterns[rng.integers(0, 5)].tolist())
        t |= set(rng.choice(items, rng.integers(0, 3), replace=False).tolist())
        out.append(sorted(f"i{j}" for j in t))
    return out


@pytest.fixture(scope="module")
def tx(jsess, tsess):
    b = baskets()
    metas = np.empty((len(b), 1), dtype=object)
    metas[:, 0] = b
    W = np.ones(len(b), np.float32)
    W[::17] = 0.0
    return table_pair(jsess, tsess, [("x", None)], np.zeros((len(b), 1), np.float32), W=W,
                      metas=metas, meta_names=("items",))


@pytest.mark.parametrize("kw", [dict(min_support=0.1, min_confidence=0.6),
                                dict(min_support=0.05, min_confidence=0.3,
                                     max_pattern_length=3)])
def test_fpgrowth(tx, kw):
    jt, tt = tx
    jm = JF.FPGrowth(items_col="items", **kw).fit(jt)
    tm = TF.FPGrowth(items_col="items", **kw).fit(tt)
    assert tm.item_names == jm.item_names
    assert tm.freq_itemsets_ == jm.freq_itemsets_ and len(tm.freq_itemsets_) > 12
    assert tm.freq_itemsets() == jm.freq_itemsets()
    assert tm.association_rules_ == jm.association_rules_ and tm.association_rules_
    ref, got = jm.transform(jt), tm.transform(tt)
    assert [v.name for v in got.domain.attributes] == [v.name for v in ref.domain.attributes]
    assert np.array_equal(to_np(ref.X), got.X.numpy())
    conv = interop.fpgrowth_model(jm.params.to_dict(), jm.item_names, jm.freq_itemsets_,
                                  jm.n_rows_weighted)
    assert conv.association_rules_ == jm.association_rules_
    assert np.array_equal(conv.transform(tt).X.numpy(), got.X.numpy())


def test_fpgrowth_binary_columns_and_chunks(jsess, tsess, monkeypatch):
    """Items as binary attribute columns; chunks of 64 rows and 10
    candidates give the same counts."""
    rng = np.random.default_rng(4)
    X = (rng.random((200, 8)) < 0.35).astype(np.float32)
    X[:, 1] = np.maximum(X[:, 1], X[:, 0])
    jt, tt = table_pair(jsess, tsess, [(f"c{j}", None) for j in range(8)], X)
    jm = JF.FPGrowth(min_support=0.1, min_confidence=0.5).fit(jt)
    tm = TF.FPGrowth(min_support=0.1, min_confidence=0.5).fit(tt)
    assert tm.freq_itemsets_ == jm.freq_itemsets_
    monkeypatch.setattr(TF, "SUPPORT_CHUNK_ROWS", 64)
    monkeypatch.setattr(TF, "SUPPORT_CHUNK_ELEMS", 640)
    assert TF.FPGrowth(min_support=0.1, min_confidence=0.5).fit(tt).freq_itemsets_ == \
        jm.freq_itemsets_
    members = torch.eye(8)[:5]
    B = torch.from_numpy(X)
    assert np.array_equal(TF.support_batch(B, torch.ones(200), members), X[:, :5].sum(0))


def test_prefix_span(jsess, tsess):
    rng = np.random.default_rng(9)
    seqs = []
    for _ in range(60):
        seqs.append([sorted(rng.choice(["a", "b", "c", "d", "e"], rng.integers(1, 3),
                                       replace=False).tolist())
                     for _ in range(rng.integers(1, 5))])
    metas = np.empty((len(seqs), 1), dtype=object)
    metas[:, 0] = seqs
    W = np.ones(len(seqs), np.float32)
    W[::7] = 0.0
    jt, tt = table_pair(jsess, tsess, [("x", None)], np.zeros((len(seqs), 1), np.float32), W=W,
                        metas=metas, meta_names=("sequence",))
    kw = dict(min_support=0.15, max_pattern_length=4)
    ref = JF.PrefixSpan(**kw).find_frequent_sequential_patterns(jt)
    got = TF.PrefixSpan(**kw).find_frequent_sequential_patterns(tt)
    assert got == ref and len(got) > 10


def test_fpgrowth_widget(tx):
    _, tt = tx
    g = WorkflowGraph()
    src = g.add(OWTable(tt))
    node = g.add(WIDGET_REGISTRY["OWFPGrowth"](items_col="items", min_support=0.1))
    g.connect(src, "data", node, "data")
    out = g.run()[node]
    assert out["model"].freq_itemsets_ and out["data"].n_rows == tt.n_rows
