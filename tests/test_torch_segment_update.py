"""The touched-row update of the 'sort' lowering after its sort
(``ops/segment_sum.segment_update_sorted``) on the CPU, where it is its plain
version ``segment_update_sorted_reference``:

* against the JAX package's ``sparse_embedding_update(lowering='sort')`` on
  the same numpy inputs, for the rules sgd, adagrad and ftrl, with and
  without the lazy decay, with and without dead (padding) rows, with a
  segment longer than 32 occurrences and with Zipf-law keys (dozens of
  them), for k = 1 and 3;
* against the op-by-op chain the 'sort' lowering ran before the kernel (a
  frozen copy below), called through the port's
  ``sparse_embedding_update``: bitwise;
* the wrapper: the plain version for CPU tensors, no launch counted, and a
  ValueError on a wrong dtype, shape, device, rule or slot set;
* ``chip_smoke.py``'s checks of the kernel against the plain version, with
  the plain version in the kernel's place: they pass it, fail it once an
  occurrence's gradient is lost from the sums, and their sum probe fails a
  plain version with one occurrence dropped or doubled; so do the checks of
  its ``criteo_zipf`` case on its own (smaller) Zipf-law keys, and its
  emulation of the kernels' order of adds on long segments
  (``_long_order_sums``) equals that order written out loop by loop.

The kernel itself runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s ``segment_update`` phase).

Tolerances. The segment sums are bitwise on every segment here, the long
one too: on the CPU both ``index_add_`` and XLA's sorted scatter-add add a
segment's occurrences one after another in stable-sorted order
(``tests/test_torch_segment_sum.py`` holds the sums alone bitwise). The
touched rows ``t`` are integers and bitwise. The table and the slots are
held to rtol 1e-6 and atol 1e-7 (a few float32 ulps): XLA:CPU compiles the
rule's ops into fused loops whose ``pow``, ``rsqrt``, ``sqrt`` and
contractions need not round as PyTorch's one-op-at-a-time kernels do (sgd
comes out bitwise, adagrad within one ulp). FTRL's ``z2 = z + g - σ·p``
carries ``σ = (√n2 - √n) / lr``, a difference of two square roots over lr:
one ulp of either root moves ``z`` by up to ``2·ulp(√n2)/lr·|p|``, so ftrl's
``z`` is held to that bound (atol ``2·ulp(2)/lr·max|p|``, 3.4e-5 here;
measured 6.4e-6) and its table, ``-shrunk / ((β + √n2)/lr + 2·reg)`` with
a denominator of at least 1/lr, to that bound times lr. Untouched rows are
bitwise (neither package writes them).
"""

import importlib.util
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.optim import sparse as jsparse
from orange3_spark_tpu_torch.ops import segment_sum as ss
from orange3_spark_tpu_torch.optim import sparse as tsparse

N, C, D = 96, 5, 512
LR, REG, L1 = 0.05, 1e-3, 1e-4
RTOL, ATOL = 1e-6, 1e-7
SLOTS = {"sgd": (), "adagrad": ("acc",), "ftrl": ("z", "n")}


#: rows of the Zipf-keyed case: each column's codes drawn from a Zipf law
#: (exponent 1.2), folded into the table: some 30 rows with over 32
#: occurrences
N_ZIPF = 2048


def _inputs(seed, kind, k, *, dead, long_rows, step=7):
    """A step's inputs from a numpy seed: the table, the rule's slots and
    the last-seen steps (with history, so the decay and the rule see
    nonzero state), the [N, k] logits gradient, the [N, C] occurrence rows
    (``long_rows`` of them on one row; ``"zipf"``: N_ZIPF rows of Zipf-law
    codes), ``n_valid`` (the last ``dead`` rows are padding) and the step."""
    rng = np.random.default_rng(seed)
    n = N_ZIPF if long_rows == "zipf" else N
    emb = rng.standard_normal((D, k)).astype(np.float32)
    slots = {n: rng.uniform(0.0, 2.0, (D, k)).astype(np.float32) for n in SLOTS[kind]}
    if kind == "ftrl":
        slots["z"] = rng.standard_normal((D, k)).astype(np.float32)
    t = rng.integers(0, step + 1, D).astype(np.int32)
    dl = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    if long_rows == "zipf":
        idx = ((rng.zipf(1.2, (n, C)) - 1) % D).astype(np.int32)
    else:
        idx = rng.integers(0, D, (n, C)).astype(np.int32)
    if long_rows and long_rows != "zipf":
        flat = idx.reshape(-1)
        flat[rng.choice((n - dead) * C, long_rows, replace=False)] = D // 3
    return emb, slots, t, dl, idx, n - dead, step


def _seed(*case) -> int:
    return zlib.crc32(repr(case).encode())


def _decay(use_decay):
    return float(np.float32(1.0) - np.float32(LR) * np.float32(REG)) if use_decay else 1.0


def _port_sorted(idx, n_valid):
    """The 'sort' lowering's own sort: dead occurrences take the sentinel D."""
    dead = tsparse.occurrence_dead(*idx.shape, n_valid, "cpu")
    return torch.sort(torch.from_numpy(idx).masked_fill(dead, D).reshape(-1), stable=True)


def _port(kind, emb, slots, t, dl, idx, n_valid, step, use_decay):
    s_idx, order = _port_sorted(idx, n_valid)
    e, tt, sl = (torch.from_numpy(emb.copy()), torch.from_numpy(t.copy()),
                 {n: torch.from_numpy(v.copy()) for n, v in slots.items()})
    out = ss.segment_update_sorted_reference(
        kind, s_idx, order, C, torch.from_numpy(dl), e, sl, tt,
        torch.tensor(step, dtype=torch.int32), LR, _decay(use_decay), REG, L1,
        use_decay=use_decay)
    assert out[0] is e and out[1] is tt and out[2] is sl      # in place
    return e.numpy(), tt.numpy(), {n: v.numpy() for n, v in sl.items()}


CASES = [(dead, long_rows) for dead in (0, 13) for long_rows in (0, 60)] + [(13, "zipf")]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dead,long_rows", CASES)
@pytest.mark.parametrize("use_decay", [False, True])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "ftrl"])
def test_plain_version_matches_the_reference_sort_update(kind, use_decay, dead, long_rows, k):
    emb, slots, t, dl, idx, n_valid, step = _inputs(
        _seed(kind, use_decay, dead, long_rows, k), kind, k, dead=dead,
        long_rows=long_rows)
    got = _port(kind, emb, slots, t, dl, idx, n_valid, step, use_decay)
    je, jt, jslots = jsparse.sparse_embedding_update(
        kind, jnp.asarray(emb), jnp.asarray(t),
        {n: jnp.asarray(v) for n, v in slots.items()}, jnp.asarray(dl), jnp.asarray(idx),
        LR, _decay(use_decay), REG, L1, jnp.int32(step), lowering="sort",
        use_decay=use_decay, n_valid=n_valid)
    want = (np.asarray(je), np.asarray(jt), {n: np.asarray(v) for n, v in jslots.items()})
    touched = np.zeros(D, bool)
    touched[idx[:n_valid].reshape(-1)] = True
    if long_rows:
        counts = np.bincount(idx[:n_valid].reshape(-1), minlength=D)
        assert (counts > 32).sum() >= (20 if long_rows == "zipf" else 1)
    np.testing.assert_array_equal(got[1], want[1])
    atol = dict.fromkeys(("emb",) + SLOTS[kind], ATOL)
    if kind == "ftrl":
        z_atol = 2 * float(np.spacing(np.float32(2.0))) / LR * float(np.abs(emb).max())
        atol.update(z=z_atol, emb=z_atol * LR)
    for name, a, b in [("emb", got[0], want[0])] + [(n, got[2][n], want[2][n])
                                                     for n in SLOTS[kind]]:
        np.testing.assert_array_equal(a[~touched], b[~touched], err_msg=name)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol[name], err_msg=name)
    # the inputs were not all fixed points: the touched rows moved
    assert not np.array_equal(got[0][touched], emb[touched])


def _chain_sort_update(kind, emb, t, slots, dl, idx, lr, decay, reg, l1, step, *,
                        use_decay, n_valid):
    """The 'sort' lowering as the op-by-op chain it was before the kernel,
    frozen: the plain version must reproduce it bit for bit."""
    D_ = emb.shape[0]
    N_, C_ = idx.shape
    U = tsparse.plan_slots(N_, C_, D_)
    dead = tsparse.occurrence_dead(N_, C_, n_valid, idx.device)
    s_idx, order = torch.sort(idx.masked_fill(dead, D_).reshape(-1), stable=True)
    start = torch.ones_like(s_idx, dtype=torch.bool)
    torch.ne(s_idx[1:], s_idx[:-1], out=start[1:])
    seg = torch.cumsum(start, 0) - 1
    g = dl.index_select(0, order // C_)
    sums = ss.segment_sum_sorted(g, seg, U, skip_last=s_idx[-1:] >= D_)
    uniq = torch.zeros(U, dtype=s_idx.dtype, device=idx.device).scatter_(0, seg, s_idx)
    n_live = (start & (s_idx < D_)).sum()
    src = torch.minimum(torch.arange(U, device=idx.device), n_live - 1)
    rid = uniq.index_select(0, src).to(torch.int64)
    p_rows, slot_rows = tsparse._touched_rows_update(
        kind, emb, t, slots, sums.index_select(0, src), rid, lr, decay, reg, l1, step,
        use_decay=use_decay)
    emb.index_copy_(0, rid, p_rows)
    for n, v in slot_rows.items():
        slots[n].index_copy_(0, rid, v)
    if use_decay:
        t.index_copy_(0, rid, (step + 1).to(t.dtype).expand(U))
    return emb, t, slots


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dead,long_rows", CASES)
@pytest.mark.parametrize("kind,use_decay", [("sgd", True), ("adagrad", True),
                                            ("adagrad", False), ("ftrl", False)])
def test_sort_lowering_on_the_cpu_keeps_the_chain_bits(kind, use_decay, dead, long_rows, k):
    """``sparse_embedding_update(lowering='sort')`` on the CPU, now through
    ``segment_update_sorted``, against the frozen chain: every bit of
    the table, the slots and ``t``; ``n_valid`` as an int and as a device
    scalar (a captured replay's)."""
    emb, slots, t, dl, idx, n_valid, step = _inputs(
        _seed(kind, use_decay, dead, long_rows, k, "chain"), kind, k, dead=dead,
        long_rows=long_rows)
    for nv in (n_valid, torch.tensor(n_valid, dtype=torch.int32)):
        runs = []
        for fn in (tsparse.sparse_embedding_update, _chain_sort_update):
            state = (torch.from_numpy(emb.copy()), torch.from_numpy(t.copy()),
                     {n: torch.from_numpy(v.copy()) for n, v in slots.items()})
            kw = dict(use_decay=use_decay, n_valid=nv)
            if fn is tsparse.sparse_embedding_update:
                kw["lowering"] = "sort"
            runs.append(fn(kind, *state, torch.from_numpy(dl), torch.from_numpy(idx), LR,
                           _decay(use_decay), REG, L1, torch.tensor(step, dtype=torch.int32),
                           **kw))
        (e1, t1, s1), (e2, t2, s2) = runs
        assert torch.equal(e1, e2) and torch.equal(t1, t2)
        assert s1.keys() == s2.keys() and all(torch.equal(s1[n], s2[n]) for n in s1)


def test_every_occurrence_dead_moves_no_row():
    """n_valid == 0 (an int): the early return, nothing sorted or written."""
    emb, slots, t, dl, idx, _, step = _inputs(3, "adagrad", 1, dead=0, long_rows=0)
    e, tt, sl = (torch.from_numpy(emb.copy()), torch.from_numpy(t.copy()),
                 {n: torch.from_numpy(v.copy()) for n, v in slots.items()})
    tsparse.sparse_embedding_update("adagrad", e, tt, sl, torch.from_numpy(dl),
                                    torch.from_numpy(idx), LR, _decay(True), REG, L1,
                                    torch.tensor(step, dtype=torch.int32), lowering="sort",
                                    use_decay=True, n_valid=0)
    assert np.array_equal(e.numpy(), emb) and np.array_equal(tt.numpy(), t)
    assert np.array_equal(sl["acc"].numpy(), slots["acc"])


def _wrapper_args(kind="adagrad", k=1):
    emb, slots, t, dl, idx, n_valid, step = _inputs(5, kind, k, dead=7, long_rows=0)
    s_idx, order = _port_sorted(idx, n_valid)
    return dict(kind=kind, s_idx=s_idx, order=order, C=C, dl=torch.from_numpy(dl),
                emb=torch.from_numpy(emb), slots={n: torch.from_numpy(v)
                                                  for n, v in slots.items()},
                t=torch.from_numpy(t), step=torch.tensor(step, dtype=torch.int32),
                lr=LR, decay=_decay(True), reg=REG, l1=L1, use_decay=True)


def _call(args):
    a = dict(args)
    kind, s_idx, order, C_, dl, emb, slots, t, step = (
        a.pop(n) for n in ("kind", "s_idx", "order", "C", "dl", "emb", "slots", "t", "step"))
    lr, decay, reg, l1 = (a.pop(n) for n in ("lr", "decay", "reg", "l1"))
    return ss.segment_update_sorted(kind, s_idx, order, C_, dl, emb, slots, t, step, lr,
                                    decay, reg, l1, **a)


@pytest.mark.parametrize("kind,k", [("sgd", 1), ("adagrad", 3), ("ftrl", 1)])
def test_wrapper_takes_the_plain_version_on_the_cpu(kind, k):
    args = _wrapper_args(kind, k)
    want = {n: (v.clone() if torch.is_tensor(v) else
                {m: w.clone() for m, w in v.items()} if isinstance(v, dict) else v)
            for n, v in args.items()}
    before = ss.segment_update_sorted.launches
    emb, t, slots = _call(args)
    assert ss.segment_update_sorted.launches == before      # no kernel ran
    ref = ss.segment_update_sorted_reference(
        want["kind"], want["s_idx"], want["order"], C, want["dl"], want["emb"],
        want["slots"], want["t"], want["step"], LR, want["decay"], REG, L1, use_decay=True)
    assert emb is args["emb"] and torch.equal(emb, ref[0]) and torch.equal(t, ref[1])
    assert all(torch.equal(slots[n], ref[2][n]) for n in slots)


BAD = [
    ("s_idx int64", lambda a: a.update(s_idx=a["s_idx"].long()), "s_idx"),
    ("order int32", lambda a: a.update(order=a["order"].int()), "order"),
    ("order short", lambda a: a.update(order=a["order"][:-1]), "order"),
    ("dl float64", lambda a: a.update(dl=a["dl"].double()), "dl"),
    ("dl wrong k", lambda a: a.update(dl=torch.zeros((N, 2))), "dl"),
    ("emb 1-d", lambda a: a.update(emb=a["emb"][:, 0]), "emb"),
    ("emb strided", lambda a: a.update(emb=torch.zeros((D, 2))[:, :1]), "emb"),
    ("acc wrong rows", lambda a: a["slots"].update(acc=torch.zeros((D - 1, 1))), "acc"),
    ("t int64", lambda a: a.update(t=a["t"].long()), "t"),
    ("step 1-d", lambda a: a.update(step=a["step"].reshape(1)), "step"),
    ("slots of ftrl", lambda a: a.update(slots={"z": a["emb"], "n": a["emb"]}), "slots"),
    ("unknown rule", lambda a: a.update(kind="adam"), "kind"),
    ("dl on meta", lambda a: a.update(dl=a["dl"].to("meta")), "dl"),
]


@pytest.mark.parametrize("what,mutate,word", BAD, ids=[b[0] for b in BAD])
def test_wrapper_raises_on_inputs_it_does_not_take(what, mutate, word):
    args = _wrapper_args()
    mutate(args)
    with pytest.raises(ValueError, match=word):
        _call(args)


def test_wrapper_has_no_kernel_for_other_devices():
    args = {n: (v.to("meta") if torch.is_tensor(v) else
                {m: w.to("meta") for m, w in v.items()} if isinstance(v, dict) else v)
            for n, v in _wrapper_args().items()}
    with pytest.raises(ValueError, match="no kernel for device"):
        _call(args)


def _smoke():
    """``chip_smoke.py`` as a module: its ``segment_update`` checks."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lossy_sums(g, seg, n_slots, *, skip_last=None):
    """The plain segment sum with the first occurrence's gradient lost."""
    out = ss.segment_sum_sorted_reference(g, seg, n_slots, skip_last=skip_last)
    out[seg[0]] -= g[0]
    return out


@pytest.mark.parametrize("long_rows", [0, 60])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "ftrl"])
def test_smoke_update_checks_pass_the_plain_version_and_fail_a_lost_occurrence(
        monkeypatch, kind, long_rows):
    # walk_max() reads the kernel's constant from the built library
    monkeypatch.setattr(ss, "walk_max", lambda: 32)
    cs = _smoke()
    emb, slots, t, dl, idx, n_valid, step = _inputs(
        _seed(kind, long_rows, "smoke"), kind, 1, dead=9, long_rows=long_rows)
    s_idx, order = _port_sorted(idx, n_valid)
    args = (kind, s_idx, order, C, torch.from_numpy(dl), torch.from_numpy(emb),
            {n: torch.from_numpy(v) for n, v in slots.items()}, torch.from_numpy(t),
            torch.tensor(step, dtype=torch.int32), LR, _decay(True), REG, L1)

    def update(segment_sum):
        def run(a):
            ss.segment_update_sorted_reference(*a, use_decay=True, segment_sum=segment_sum)
            return a
        return run

    chain = update(ss.segment_sum_sorted)
    long = cs._long_rows(s_idx, D)
    assert bool(long.any()) == bool(long_rows)
    line = cs._update_checks(update(ss.segment_sum_sorted_reference), chain, args, True, long)
    assert cs._update_case_ok(line), line
    assert line["sum_probe"]["mutation_caught"] == {"dropped": True, "doubled": True}
    if long_rows:
        assert line["sum_probe"]["long_rel_err"] == 0.0
    bad = cs._update_checks(update(_lossy_sums), chain, args, True, long)
    assert not cs._update_case_ok(bad)
    assert bad["sum_probe"]["mismatches"] > 0 and not bad["equal_chain"]


@pytest.mark.parametrize("long_rows", [0, 60])
def test_smoke_values_checks_pass_the_plain_version_and_fail_a_lost_occurrence(
        monkeypatch, long_rows):
    """The checks ``phase_values_update`` runs at a value-weighted step:
    the plain version given the pairs' values passes them (long segments
    within float32 summation's bound, ``long_bound=True``), one that loses
    an occurrence fails; the bound counts the values' 4 B an occurrence."""
    monkeypatch.setattr(ss, "walk_max", lambda: 32)
    cs = _smoke()
    emb, slots, t, dl, idx, n_valid, step = _inputs(
        _seed("values", long_rows, "smoke"), "adagrad", 1, dead=9, long_rows=long_rows)
    s_idx, order = _port_sorted(idx, n_valid)
    vals = np.random.default_rng(_seed("values", long_rows)).uniform(0.0, 2.0, s_idx.numel())
    vals = torch.from_numpy(np.where(np.arange(vals.size) % 7 == 0, 0.0, vals).astype(np.float32))
    args = ("adagrad", s_idx, order, C, torch.from_numpy(dl), torch.from_numpy(emb),
            {n: torch.from_numpy(v) for n, v in slots.items()}, torch.from_numpy(t),
            torch.tensor(step, dtype=torch.int32), LR, _decay(True), REG, L1)

    def update(segment_sum):
        def run(a):
            ss.segment_update_sorted_reference(*a, use_decay=True, vals=vals,
                                               segment_sum=segment_sum)
            return a
        return run

    chain = update(ss.segment_sum_sorted)
    long = cs._long_rows(s_idx, D)
    line = cs._update_checks(update(ss.segment_sum_sorted_reference), chain, args, True, long,
                             vals)
    assert cs._update_case_ok(line, long_bound=True), line
    assert line["sum_probe"]["mutation_caught"] == {"dropped": True, "doubled": True}
    if long_rows:
        assert line["sum_probe"]["long_err_over_bound"] == 0.0
    bad = cs._update_checks(update(_lossy_sums), chain, args, True, long, vals)
    assert not cs._update_case_ok(bad, long_bound=True)
    live, plain_bytes, plain_sectors = cs._update_bytes(args, True)
    assert live == int((s_idx[s_idx < D]).unique().numel())
    assert cs._update_bytes(args, True, vals) == (live, plain_bytes + 4 * s_idx.numel(),
                                                   plain_sectors + 4 * s_idx.numel())


def _order_by_loops(g, seg, n_slots):
    """The kernels' order of adds on each segment of more than 32 rows,
    written out loop by loop in float32 (numpy): each 32-row chunk (at
    multiples of 32) summed by the warp's xor tree over its lanes (+0.0 off
    the segment), then lane l adds chunks l, l + 32, ... of the segment in
    order from +0.0, and the same tree adds the lanes."""
    def tree(v):
        for o in (16, 8, 4, 2, 1):
            v = [np.float32(v[lane] + v[lane ^ o]) for lane in range(32)]
        return v[0]

    g, seg = g.numpy(), seg.numpy()
    out = np.zeros((n_slots, g.shape[1]), np.float32)
    keys, first, counts = np.unique(seg, return_index=True, return_counts=True)
    for key, s, n in zip(keys, first, counts):
        if n <= 32 or key >= n_slots:
            continue
        for c in range(g.shape[1]):
            parts = [tree([g[r, c] if s <= r < s + n else np.float32(0.0)
                           for r in range(32 * q, 32 * q + 32)])
                     for q in range(s // 32, (s + n - 1) // 32 + 1)]
            lanes = []
            for lane in range(32):
                acc = np.float32(0.0)
                for p in parts[lane::32]:
                    acc = np.float32(acc + p)
                lanes.append(acc)
            out[key, c] = tree(lanes)
    return torch.from_numpy(out)


@pytest.mark.parametrize("k", [1, 3])
def test_smoke_long_order_sums_follow_the_kernels_order(monkeypatch, k):
    """``chip_smoke._long_order_sums``, which the card's checks hold the
    kernels' long segments to bitwise, is the order the kernels document
    (``csrc/segment_sum.cu``), written out loop by loop: equal on every
    slot, with segments that start on and off chunk edges and slots past
    ``n_slots`` dropped; ``_long_order_equal`` fails a sum that lost an
    occurrence."""
    monkeypatch.setattr(ss, "walk_max", lambda: 32)
    cs = _smoke()
    rng = np.random.default_rng(k)
    lens = rng.integers(1, 40, 1500)
    lens[::40] = rng.integers(33, 2500, lens[::40].shape)
    lens[7], lens[8] = 32 * 5 - int(lens[:7].sum()) % 32 + 32, 33   # one starts on an edge
    seg = torch.from_numpy(np.repeat(np.arange(lens.size), lens))
    g = torch.from_numpy(rng.standard_normal((seg.numel(), k)).astype(np.float32))
    n_slots = lens.size - 2
    got = cs._long_order_sums(g, seg, n_slots)
    assert torch.equal(got, _order_by_loops(g, seg, n_slots))
    long_slots = torch.zeros(n_slots, dtype=torch.bool)
    long_slots[:] = torch.from_numpy(lens[:n_slots] > 32)
    assert int(long_slots.sum()) > 30 and (np.cumsum(lens)[6:8] % 32 == 0).any()
    assert cs._long_order_equal(got, g, seg, n_slots, long_slots)
    lossy = got.clone()
    lossy[int(np.argmax(lens[:n_slots]))] -= g[int(np.cumsum(lens)[np.argmax(lens[:n_slots])]) - 1]
    assert not cs._long_order_equal(lossy, g, seg, n_slots, long_slots)


@pytest.mark.parametrize("vals_seed", [None, 5])
def test_smoke_criteo_zipf_checks_pass_the_plain_version_and_fail_a_lost_occurrence(
        monkeypatch, vals_seed):
    """``phase_segment_update``'s ``criteo_zipf`` case at a small size: its
    keys (``_criteo_zipf_keys``: Zipf-law codes a column, hashed with the
    fit's salts) hold long segments; its checks (``_update_checks`` with
    float32's bound on long sums) pass the plain version, with and without
    values, and fail one that loses an occurrence; ``_long_stats`` counts
    the long segments."""
    from orange3_spark_tpu_torch.ops.hashing import column_salts

    monkeypatch.setattr(ss, "walk_max", lambda: 32)
    cs = _smoke()
    n, c, d = 3000, 26, 1 << 14
    s_idx, order = cs._criteo_zipf_keys(n, c, d, column_salts(c, 0), "cpu")
    assert s_idx.dtype == torch.int32 and s_idx.numel() == n * c
    assert torch.equal(torch.sort(s_idx, stable=True).values, s_idx)
    stats = cs._long_stats(s_idx, d)
    assert stats["long_segments"] > 100 and stats["longest_segment"] > 500
    rng = np.random.default_rng(3)
    emb = torch.from_numpy(rng.standard_normal((d, 1)).astype(np.float32))
    slots = {"acc": torch.from_numpy(rng.uniform(0.0, 2.0, (d, 1)).astype(np.float32))}
    t = torch.from_numpy(rng.integers(0, 8, d).astype(np.int32))
    dl = torch.from_numpy((rng.standard_normal((n, 1)) * 0.1).astype(np.float32))
    args = ("adagrad", s_idx, order, c, dl, emb, slots, t, torch.tensor(7, dtype=torch.int32),
            LR, _decay(True), REG, L1)
    vals = None if vals_seed is None else cs._draw_vals(s_idx.numel(), "cpu", vals_seed)

    def update(segment_sum):
        def run(a):
            ss.segment_update_sorted_reference(*a, use_decay=True, vals=vals,
                                               segment_sum=segment_sum)
            return a
        return run

    long = cs._long_rows(s_idx, d)
    assert int(long.sum()) == stats["long_segments"]
    chain = update(ss.segment_sum_sorted)
    line = cs._update_checks(update(ss.segment_sum_sorted_reference), chain, args, True, long,
                             vals)
    assert cs._update_case_ok(line, long_bound=True), line
    assert line["sum_probe"]["long_err_over_bound"] == 0.0
    bad = cs._update_checks(update(_lossy_sums), chain, args, True, long, vals)
    assert not cs._update_case_ok(bad, long_bound=True)
