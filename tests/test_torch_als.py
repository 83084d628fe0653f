"""The port's ALS (models/als.py, ops/normal_equations.py) against the JAX
package on the same seeded numpy ratings, and the twins of tests/test_als.py.

Tolerances (each measured on the CPU, torch 2.13 and jax 0.9, and kept with a
margin of about 5x):

* The plain normal equations follow the reference's chunk order: each
  chunk's sums from +0.0 in rating order, added to the running total. They
  are held BITWISE to a float32 loop written here in numpy (the order the
  CUDA kernel reproduces), and to float64 sums within float32 rounding.
* ``_solve_side`` against the reference's: the factors within 1.5e-6
  absolute (measured worst 3.0e-7, on factors up to 0.40). XLA fuses the
  reference's sums in its own ways (``b`` accumulates straight into the
  carry across chunks; the implicit weights round apart), so the normal
  equations agree within float32 rounding, not bitwise, and the two LAPACK
  LU solves round apart too.
* ``_als_fit`` for 8 iterations from the reference's initial factors
  (300 users x 200 items, 20,000 ratings, rank 6): factors within 3e-6
  (measured 6.0e-7) and predictions within 4e-6 (measured 7.2e-7): ALS
  contracts, so the half-steps' rounding differences do not grow. The
  implicit fit (rank 8, 5 iterations, factors up to 1.43) within 4e-5
  (measured 7.5e-6).
* ``_nnls_cd`` within 1e-6 (measured bitwise; a per-row sum of k
  products that either library may reorder).
* Predictions from the same factors (``interop.als_model``) within 2.5e-6
  absolute (measured 4.8e-7 on predictions up to ~5; a per-row sum in
  column order against XLA's reduction); recommended ids equal (distinct
  scores).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.models import als as JA
from orange3_spark_tpu_torch import interop
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.datasets import make_movielens_proxy, make_ratings
from orange3_spark_tpu_torch.models import als as TA
from orange3_spark_tpu_torch.models.als import ALS, ratings_table
from orange3_spark_tpu_torch.models.evaluation import RegressionEvaluator
from orange3_spark_tpu_torch.ops import normal_equations as NE
from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY, OWTable
from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph

from _port_parity import assert_port_equal, to_np


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def session():
    return TorchSession.builder_get_or_create("cpu")


def _arrays(ratings, w=None):
    """(user, item, rating, w) numpy columns as a table gives them."""
    u = ratings[:, 0].astype(np.int32)
    i = ratings[:, 1].astype(np.int32)
    r = ratings[:, 2].astype(np.float32)
    w = np.ones(len(ratings), np.float32) if w is None else w.astype(np.float32)
    return u, i, r, w


def _np_chunk_order(V, u, i, r, w, E, chunk, implicit, alpha=1.0):
    """The normal equations in the reference's chunk order, as float32
    numpy: per chunk, per entity, terms added from +0.0 in rating order;
    the chunk's sums added to the running total. Products rounded one by
    one: (V_i * V_j) * aw, V_i * bw."""
    f = np.float32
    if implicit:
        conf = f(1.0) + f(alpha) * np.abs(r)
        aw, bw = (conf - f(1.0)) * w, (conf * (r > 0).astype(f)) * w
    else:
        aw, bw = w, r * w
    k = V.shape[1]
    A, b, c = np.zeros((E, k, k), f), np.zeros((E, k), f), np.zeros(E, f)
    for c0 in range(0, len(u), chunk):
        pA, pb, pc = np.zeros_like(A), np.zeros_like(b), np.zeros_like(c)
        for n in range(c0, min(c0 + chunk, len(u))):
            v = V[i[n]]
            pA[u[n]] += (v[:, None] * v[None, :]) * aw[n]
            pb[u[n]] += v * bw[n]
            pc[u[n]] += w[n]
        A, b, c = A + pA, b + pb, c + pc
    return A, b, c


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("chunk", [3000, 700, 1 << 18])
def test_plain_normal_equations_follow_the_chunk_order(session, implicit, chunk):
    """The plain version (the CPU path, and what the CUDA kernel is held to
    on the card) sums in the reference's chunk order, bit for bit; with
    zero-weight ratings, out-of-range entities (dropped) and entities with
    no rating (zeros)."""
    ratings = make_ratings(40, 30, 3000, rank=3, seed=11, noise=0.1)
    u, i, r, w = _arrays(ratings)
    w[::5] = 0.0
    u[7], u[8] = -1, 45                       # dropped: outside [0, 45)
    rng = np.random.default_rng(3)
    V = rng.standard_normal((30, 4)).astype(np.float32)
    E = 45                                    # entities 40..44 have no rating
    plan = TA._side_plan(*(torch.from_numpy(x) for x in (u, i, r, w)), E, 30, implicit, 1.0)
    A, b, c = NE.normal_equations_sorted(torch.from_numpy(V), plan(chunk))
    # a dropped rating still takes its place in a chunk; here it is given
    # to entity 0 with weight 0, which adds ±0.0 and leaves every sum's bits
    live = (u >= 0) & (u < E)
    want = _np_chunk_order(V, np.where(live, u, 0), i, r, np.where(live, w, 0.0).astype(
        np.float32), E, chunk, implicit)
    for got, ref in zip((A, b, c), want):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert not A[40:].any() and not b[40:].any() and not c[40:].any()
    # and within float32 rounding of float64 sums
    V64 = V.astype(np.float64)
    aw = (np.abs(r) * w if implicit else w).astype(np.float64)
    A64 = np.zeros((E, 4, 4))
    np.add.at(A64, u[live], np.einsum("ni,nj->nij", V64[i[live]], V64[i[live]])
              * aw[live, None, None])
    np.testing.assert_allclose(A.numpy(), A64, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("chunk", [1, 2, 3, 6])
def test_sort_side_layout(session, implicit, chunk):
    """The 12-byte layout: stable by user (user 5 out of range, dropped),
    the item id clamped, bit 31 set exactly where ``pos // chunk`` changes
    inside a segment, cw carried only for implicit feedback; the work list
    one unit an entity, longest segment first."""
    u = torch.tensor([2, 0, 2, 5, 1, 0], dtype=torch.int32)
    i = torch.tensor([1, 3, 0, 2, 9, 4], dtype=torch.int32)
    f = torch.arange(6, dtype=torch.float32)
    lay = NE.sort_side(u, i, f, f + 10, f + 20 if implicit else None, 4, 5, chunk)
    pos = [1, 5, 4, 0, 2, 3]                                 # the stable order
    seg = [0, 0, 1, 2, 2, 4]                                 # 4: past the entities
    flag = [g > 0 and seg[g] == seg[g - 1] and pos[g] // chunk != pos[g - 1] // chunk
            for g in range(6)]
    oid = [3, 4, 4, 1, 0, 2]                                 # item 9 clamped to 4
    assert lay.key.tolist() == [o - (1 << 31) if fl else o for o, fl in zip(oid, flag)]
    assert (lay.key & 0x7FFFFFFF).tolist() == oid and lay.key.dtype == torch.int32
    assert lay.offsets.tolist() == [0, 2, 3, 5, 5] and lay.offsets.dtype == torch.int64
    assert lay.aw.tolist() == pos and lay.bw.tolist() == [p + 10 for p in pos]
    assert (lay.cw is not None) == implicit
    if implicit:
        assert lay.cw.tolist() == [p + 20 for p in pos]
    # the last column: every rating of the unit has aw == 1.0 (and cw ==
    # 1.0 for implicit feedback); only the empty user's does
    assert lay.units.tolist() == [[0, 2, 0, -1, -1, 0], [3, 2, 2, -1, -1, 0],
                                  [2, 1, 1, -1, -1, 0], [5, 0, 3, -1, -1, 1]]
    one = torch.ones(6)
    ones = NE.sort_side(u, i, one, f, one if implicit else None, 4, 5, chunk).units[:, 5]
    assert ones.tolist() == [1, 1, 1, 1]
    if implicit:
        assert NE.sort_side(u, i, one, f, f, 4, 5, chunk).units[:, 5].tolist() == [0, 0, 0, 1]
    assert lay.split_first_host == (0,) and lay.split_first.tolist() == [0]
    # explicit feedback: the count's weight is A's
    assert TA._side_weights(f, f, False, 1.0)[2] is None


def _position_layout(u, i, aw, bw, cw, E, n_other):
    """The layout before the 12-byte one: (oid, pos, aw, bw, cw, offsets),
    pos the original position of each sorted rating."""
    key = torch.where((u >= 0) & (u < E), u, E)
    s_key, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(s_key, torch.arange(E + 1, dtype=torch.int32))
    oid = i.clamp(0, n_other - 1).index_select(0, order)
    return (oid, order, aw.index_select(0, order), bw.index_select(0, order),
            cw.index_select(0, order), offsets)


def _position_plain(V, oid, pos, aw, bw, cw, offsets, chunk):
    """The plain normal equations on the layout before the 12-byte one:
    the sorted ratings put back in their original order, each chunk of
    ``chunk`` of them ``index_add_``ed into zeros and added to the sums."""
    k, M, E = V.shape[1], oid.shape[0], offsets.shape[0] - 1
    n_live = int(offsets[-1])
    ent = torch.full((M,), E, dtype=torch.int64)
    ent[:n_live] = torch.repeat_interleave(torch.arange(E), offsets[1:] - offsets[:-1])
    where = pos.long()

    def original(x):
        out = torch.empty_like(x)
        out[where] = x
        return out

    ent, oid, aw, bw, cw = (original(x) for x in (ent, oid.long(), aw, bw, cw))
    A = torch.zeros((E + 1, k * k))
    bc = torch.zeros((E + 1, k + 1))
    for c0 in range(0, M, chunk):
        sl = slice(c0, min(c0 + chunk, M))
        Vc = V.index_select(0, oid[sl])
        outer = ((Vc[:, :, None] * Vc[:, None, :]) * aw[sl, None, None]).reshape(-1, k * k)
        rhs = torch.cat([Vc * bw[sl, None], cw[sl, None]], dim=1)
        A = A + torch.zeros_like(A).index_add_(0, ent[sl], outer)
        bc = bc + torch.zeros_like(bc).index_add_(0, ent[sl], rhs)
    return A[:E].reshape(E, k, k), bc[:E, :k], bc[:E, k]


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("chunk", [1, 97, 1000, 4096, 1 << 18])
def test_plain_on_the_12_byte_layout_equals_the_position_layout(session, implicit, chunk):
    """The plain version on the 12-byte layout (chunk changes as bit 31 of
    the key) gives the bits the layout before it gave (the original
    positions, put back in order and cut into chunks), with dropped
    ratings, zero weights, empty entities and one heavy entity."""
    rng = np.random.default_rng(5)
    M, E, n_other, k = 6000, 70, 40, 5
    u = rng.integers(-1, E - 5, M).astype(np.int32)
    u[rng.permutation(M)[:1500]] = 3                      # a heavy entity
    i = rng.integers(0, n_other + 2, M).astype(np.int32)  # some clamped
    r = (rng.standard_normal(M) * 2).astype(np.float32)
    w = (rng.random(M) >= 0.1).astype(np.float32)
    V = torch.from_numpy(rng.standard_normal((n_other, k)).astype(np.float32))
    cols = [torch.from_numpy(x) for x in (u, i, r, w)]
    aw, bw, cw = TA._side_weights(cols[2], cols[3], implicit, 1.5)
    want = _position_plain(V, *_position_layout(cols[0], cols[1], aw, bw,
                                        aw if cw is None else cw, E, n_other), chunk)
    got = NE.normal_equations_sorted(V, TA._side_plan(*cols, E, n_other, implicit, 1.5)(chunk))
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def _kernel_order(V, lay, n_split):
    """The kernel's order of the adds, in float32 numpy: each unit of the
    work list (``lay.units``) a running total and a partial restarted at
    bit 31; the first ``n_split`` cut segments by pieces, whose partials
    are added in chunk order from +0.0 (the whole unit of a cut segment
    runs only when its pieces do not)."""
    f = np.float32
    V, key = V.numpy(), lay.key.numpy()
    aw, bw = lay.aw.numpy(), lay.bw.numpy()
    cw = aw if lay.cw is None else lay.cw.numpy()
    k, E = V.shape[1], lay.offsets.shape[0] - 1
    out = np.zeros((E, k * k + k + 1), f)
    partials = {}
    for start, n, ent, sid, piece, _ in lay.units.tolist():
        if (piece < 0 and 0 <= sid < n_split) or (piece >= 0 and sid >= n_split):
            continue
        tot, part = np.zeros(k * k + k + 1, f), np.zeros(k * k + k + 1, f)
        for g in range(start, start + n):
            if key[g] < 0:
                tot, part = tot + part, np.zeros_like(part)
            v = V[key[g] & 0x7FFFFFFF]
            part = part + np.concatenate([(np.outer(v, v) * aw[g]).ravel(), v * bw[g],
                                          [cw[g]]]).astype(f)
        if piece < 0:
            out[ent] = tot + part
        else:
            partials.setdefault(ent, {})[piece] = tot + part
    for ent, ps in partials.items():
        total = np.zeros(k * k + k + 1, f)
        for j in range(len(ps)):
            total = total + ps[j]
        out[ent] = total
    return out


@pytest.mark.parametrize("implicit", [False, True])
def test_work_list_cuts_long_segments_at_chunk_changes(session, monkeypatch, implicit):
    """Segments past ``SPLIT_MIN`` (here 150) are cut where their chunk
    changes, the longest first; the pieces and whole segments cover every
    live rating once; summed unit by unit in the kernel's order (pieces'
    partials added in chunk order) they give the plain version's bits, with
    all cut segments by pieces, some, or none (the scratch budget)."""
    monkeypatch.setattr(NE, "SPLIT_MIN", 150)
    monkeypatch.setattr(NE, "SPLIT_MAX", 3)
    rng = np.random.default_rng(11)
    M, E, n_other, k, chunk = 4000, 25, 30, 3, 500
    u = rng.integers(0, E - 2, M).astype(np.int32)
    u[rng.permutation(M)[:900]] = 4
    u[rng.permutation(M)[:700]] = 9
    u[u == 17] = -1                            # dropped
    u[:400] = 17                               # long, but in one chunk: never cut
    cols = [torch.from_numpy(x) for x in (
        u, rng.integers(0, n_other, M).astype(np.int32),
        (rng.standard_normal(M) * 2).astype(np.float32),
        (rng.random(M) >= 0.1).astype(np.float32))]
    V = torch.from_numpy(rng.standard_normal((n_other, k)).astype(np.float32))
    lay = TA._side_plan(*cols, E, n_other, implicit, 1.5)(chunk)
    units = lay.units.numpy()
    length = np.diff(lay.offsets.numpy())
    cut = units[units[:, 4] >= 0]
    assert sorted(set(cut[:, 2].tolist())) == [4, 9] and len(lay.split_first_host) == 3
    assert cut[0, 2] == 4                      # the longest first
    # every piece starts at a chunk change but the first, and they tile the segment
    for e in (4, 9):
        p = cut[cut[:, 2] == e]
        assert (p[:, 4] == np.arange(len(p))).all()
        assert p[0, 0] == lay.offsets[e] and p[-1, 0] + p[-1, 1] == lay.offsets[e + 1]
        assert (p[1:, 0] == p[:-1, 0] + p[:-1, 1]).all()
        assert (lay.key.numpy()[p[1:, 0]] < 0).all()
    whole = units[units[:, 4] < 0]
    assert sorted(whole[:, 2].tolist()) == list(range(E))
    assert (np.diff(whole[:, 1]) <= 0).all() and (whole[:, 1] == length[whole[:, 2]]).all()
    want = torch.cat([x.reshape(E, -1) for x in NE.normal_equations_sorted(V, lay)], dim=1)
    for n_split in (0, 1, 2):
        np.testing.assert_array_equal(_kernel_order(V, lay, n_split), want.numpy())
    assert NE._split_used(lay, 4 * 10 ** 9) == 0
    assert NE._split_used(lay, NE.SCRATCH_BYTES // lay.split_first_host[1]) == 1
    assert NE._split_used(lay, 4) == 2


@pytest.mark.parametrize("implicit,nonnegative,chunk", [
    (False, False, 20000), (False, False, 4096), (False, False, 1000),
    (True, False, 20000), (True, False, 3000), (False, True, 20000),
    (False, True, 4096), (True, True, 5000)])
def test_solve_side_matches_reference(session, implicit, nonnegative, chunk):
    ratings = make_ratings(300, 200, 20000, rank=6, seed=0, noise=0.05)
    u, i, r, w = _arrays(ratings)
    w[::9] = 0.0
    rng = np.random.default_rng(1)
    V = np.abs(rng.standard_normal((200, 6))).astype(np.float32)
    want = JA._solve_side(*(jnp.asarray(x) for x in (u, i, r, w, V)), 300, 0.01, implicit,
                          1.5, chunk, nonnegative, 48)
    plan = TA._side_plan(*(torch.from_numpy(x) for x in (u, i, r, w)), 300, 200, implicit,
                         1.5)
    got = TA._solve_side(plan, torch.from_numpy(V), 0.01, implicit, chunk, nonnegative, 48)
    assert_port_equal(want, got, atol=1.5e-6, what="factors")
    if nonnegative:
        assert got.min() >= 0.0


def test_als_fit_from_reference_init_matches_reference(session):
    """``_als_fit`` of both packages from the reference's own initial
    factors: 8 iterations at tests/test_als.py's size."""
    ratings = make_ratings(300, 200, 20000, rank=6, seed=0, noise=0.05)
    u, i, r, w = _arrays(ratings)
    U0, V0 = (np.asarray(x) for x in JA._als_init(1, 300, 200, 6))
    kw = dict(n_users=300, n_items=200, rank=6, max_iter=8, reg=0.01, implicit=False,
              alpha=1.0, chunk=8192)
    Uj, Vj = JA._als_fit(*(jnp.asarray(x) for x in (u, i, r, w, U0, V0)), **kw)
    Ut, Vt = TA._als_fit(*(torch.from_numpy(x.copy()) for x in (u, i, r, w, U0, V0)), **kw)
    assert_port_equal(Uj, Ut, atol=3e-6, what="user factors")
    assert_port_equal(Vj, Vt, atol=3e-6, what="item factors")
    pj = JA._predict_pairs(Uj, Vj, jnp.asarray(u), jnp.asarray(i))
    pt = TA._predict_pairs(Ut, Vt, torch.from_numpy(u).long(), torch.from_numpy(i).long())
    assert_port_equal(pj, pt, atol=4e-6, what="predictions")


@pytest.mark.parametrize("seed", [0, 3])
def test_als_init_draws_the_reference_init(seed):
    """``_als_init`` draws the reference's |normal|/sqrt(rank) from JAX's
    stream (``ops/prng.normal``): within 2 ulp of it."""
    U0, V0 = TA._als_init(seed, 70, 45, 5)
    Uj, Vj = (np.asarray(x) for x in JA._als_init(seed, 70, 45, 5))
    for got, want in ((U0.numpy(), Uj), (V0.numpy(), Vj)):
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= 2, ulps.max()


def test_seeded_als_fit_matches_reference(jsess, session):
    """``ALS(seed=...).fit`` of both packages with no injected factors: the
    port's init is the reference's draw (within 2 ulp), so the factors agree
    within the tolerance of the fits from one init above (3e-6) plus the
    init's few ulp carried through 6 iterations: 1e-5."""
    ratings = make_ratings(120, 80, 6000, rank=4, seed=2, noise=0.05)
    kw = dict(rank=4, max_iter=6, reg_param=0.02, seed=11)
    jm = JA.ALS(**kw).fit(JA.ratings_table(ratings, jsess))
    tm = ALS(**kw).fit(ratings_table(ratings, session))
    assert_port_equal(jm.user_factors, tm.user_factors, atol=1e-5, what="user factors")
    assert_port_equal(jm.item_factors, tm.item_factors, atol=1e-5, what="item factors")


def test_als_fit_implicit_from_reference_init(session):
    obs = make_ratings(60, 50, 4000, rank=4, seed=3, noise=0.0)
    obs[:, 2] = np.abs(obs[:, 2]) * 3 + 0.5
    obs[::4, 2] = -1.0                       # negative feedback
    u, i, r, w = _arrays(obs)
    U0, V0 = (np.asarray(x) for x in JA._als_init(2, 60, 50, 8))
    kw = dict(n_users=60, n_items=50, rank=8, max_iter=5, reg=0.05, implicit=True,
              alpha=2.0, chunk=1024)
    Uj, Vj = JA._als_fit(*(jnp.asarray(x) for x in (u, i, r, w, U0, V0)), **kw)
    Ut, Vt = TA._als_fit(*(torch.from_numpy(x.copy()) for x in (u, i, r, w, U0, V0)), **kw)
    assert_port_equal(Uj, Ut, atol=4e-5, what="user factors")
    assert_port_equal(Vj, Vt, atol=4e-5, what="item factors")


def test_nnls_cd_matches_reference_and_kkt(session):
    rng = np.random.default_rng(0)
    n, k = 64, 8
    G = rng.standard_normal((n, k, k)).astype(np.float32)
    A = np.einsum("nij,nkj->nik", G, G) + 0.1 * np.eye(k, dtype=np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    x0 = np.linalg.solve(A, b[..., None])[..., 0].astype(np.float32)
    want = JA._nnls_cd(jnp.asarray(A), jnp.asarray(b), jnp.asarray(x0), 64)
    x = TA._nnls_cd(torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(x0), 64)
    assert_port_equal(want, x, atol=1e-6, what="nnls")
    x = x.numpy()
    assert x.min() >= 0.0
    g = np.einsum("nij,nj->ni", A, x) - b
    active = x <= 1e-7
    assert (g[active] > -1e-3).all(), g[active].min()       # no descent blocked
    assert np.abs(g[~active]).max() < 1e-2                  # stationary free set


# ---------------------------------------------------- twins of tests/test_als.py
def _fit_rmse(session, n_users=300, n_items=200, n_ratings=20000, rank=6,
              fit_rank=6, max_iter=8, noise=0.05, implicit=False, seed=0):
    ratings = make_ratings(n_users, n_items, n_ratings, rank=rank, seed=seed, noise=noise)
    t = ratings_table(ratings, session)
    est = ALS(rank=fit_rank, max_iter=max_iter, reg_param=0.01,
              implicit_prefs=implicit, seed=1)
    model = est.fit(t)
    scored = model.transform(t)
    rmse = RegressionEvaluator(metric_name="rmse", label_col="rating").evaluate(scored)
    return model, rmse, ratings


def test_als_recovers_low_rank_structure(session):
    model, rmse, ratings = _fit_rmse(session)
    assert rmse < 0.1, f"rmse {rmse}"
    assert rmse < np.std(ratings[:, 2]) / 3
    assert model.user_factors.shape == (300, 6) and model.user_factors.dtype == torch.float32


def test_als_more_iters_help(session):
    _, rmse2, _ = _fit_rmse(session, max_iter=2)
    _, rmse8, _ = _fit_rmse(session, max_iter=8)
    assert rmse8 <= rmse2 + 1e-6


def test_als_predictions_correlate(session):
    model, _, ratings = _fit_rmse(session)
    t = ratings_table(ratings, session)
    pred = to_np(model.transform(t).column("prediction"))[: len(ratings)]
    assert np.corrcoef(pred, ratings[:, 2])[0, 1] > 0.95


def test_als_fit_is_repeatable_and_seeded(session):
    ratings = make_ratings(50, 40, 2000, rank=3, seed=4)
    t = ratings_table(ratings, session)
    a = ALS(rank=3, max_iter=3, seed=5).fit(t)
    b = ALS(rank=3, max_iter=3, seed=5).fit(t)
    c = ALS(rank=3, max_iter=3, seed=6).fit(t)
    assert torch.equal(a.user_factors, b.user_factors)
    assert torch.equal(a.item_factors, b.item_factors)
    assert not torch.equal(a.user_factors, c.user_factors)
    U0, V0 = TA._als_init(5, 50, 40, 3)
    assert (U0 >= 0).all() and (V0 >= 0).all() and U0.device.type == "cpu"


def test_als_cold_start_nan_and_drop(session):
    model, _, ratings = _fit_rmse(session, n_users=50, n_items=40, n_ratings=3000)
    bad = ratings.copy()[:10]
    bad[:, 0] = 9999  # unseen user
    bad[5:, 0] = ratings[5:10, 0]
    bad[5:, 1] = -3   # unseen item
    t = ratings_table(bad, session)
    scored = model.transform(t)
    pred = to_np(scored.column("prediction"))[:10]
    assert np.all(np.isnan(pred))
    assert [v.name for v in scored.domain.attributes][-1] == "prediction"
    model.params = model.params.replace(cold_start_strategy="drop")
    scored2 = model.transform(t)
    assert scored2.count() == 0  # all rows cold -> zero live rows
    assert np.isfinite(to_np(scored2.column("prediction"))).all()


def test_als_implicit_ranks_observed_higher(session):
    n_users, n_items = 60, 50
    obs = make_ratings(n_users, n_items, 4000, rank=4, seed=3, noise=0.0)
    obs[:, 2] = np.abs(obs[:, 2]) * 3 + 0.5  # positive "counts"
    t = ratings_table(obs, session)
    model = ALS(rank=8, max_iter=5, reg_param=0.05, implicit_prefs=True, alpha=2.0).fit(t)
    scores = to_np(model.user_factors @ model.item_factors.T)
    observed_pairs = {(int(u), int(i)) for u, i in obs[:, :2]}
    obs_scores = [scores[u, i] for (u, i) in list(observed_pairs)[:500]]
    assert np.mean(obs_scores) > scores.mean()


def test_als_recommend_topk(session):
    model, _, _ = _fit_rmse(session, n_users=40, n_items=30, n_ratings=2000)
    top = model.recommend_for_all_users(5)
    assert top.shape == (model.user_factors.shape[0], 5) and top.dtype == np.int32
    assert top.min() >= 0 and top.max() < model.item_factors.shape[0]
    scores = to_np(model.user_factors @ model.item_factors.T)
    np.testing.assert_array_equal(top[:, 0], scores.argmax(axis=1))
    items = model.recommend_for_all_items(3)
    np.testing.assert_array_equal(items[:, 0], scores.argmax(axis=0))


def test_als_nonnegative_factors_and_fit(session):
    rng = np.random.default_rng(5)
    n_u, n_i, n_r = 120, 80, 6000
    Ut = rng.uniform(0.1, 1.0, (n_u, 4)).astype(np.float32)
    Vt = rng.uniform(0.1, 1.0, (n_i, 4)).astype(np.float32)
    uu = rng.integers(0, n_u, n_r)
    ii = rng.integers(0, n_i, n_r)
    rr = np.einsum("nk,nk->n", Ut[uu], Vt[ii]) + 0.05 * rng.standard_normal(n_r)
    ratings = np.stack([uu, ii, rr], axis=1).astype(np.float32)
    t = ratings_table(ratings, session)
    model = ALS(rank=4, max_iter=8, reg_param=0.01, nonnegative=True).fit(t)
    assert float(model.user_factors.min()) >= 0.0
    assert float(model.item_factors.min()) >= 0.0
    rmse = RegressionEvaluator(metric_name="rmse", label_col="rating").evaluate(
        model.transform(t))
    assert rmse < 0.35 * np.std(ratings[:, 2]), rmse


def test_als_explicit_dims_and_range_check(session):
    ratings = make_ratings(50, 40, 1500, rank=3, seed=6)
    t = ratings_table(ratings, session)
    model = ALS(rank=3, max_iter=4, n_users=64, n_items=64).fit(t)
    assert tuple(model.user_factors.shape) == (64, 3)
    assert tuple(model.item_factors.shape) == (64, 3)
    with pytest.raises(ValueError, match="user index 49 out of range for n_users=10"):
        ALS(rank=3, max_iter=2, n_users=10, n_items=64).fit(t)
    with pytest.raises(ValueError, match="item index 39 out of range for n_items=5"):
        ALS(rank=3, max_iter=2, n_items=5).fit(t)


def test_als_respects_filter(session):
    """Zero-weight ratings must not influence the factors, and a filtered
    row's index does not count in the range check."""
    ratings = make_ratings(50, 40, 3000, rank=4, seed=6, noise=0.02)
    corrupt = ratings.copy()
    corrupt[2000:, 2] = 100.0  # absurd ratings, filtered below
    corrupt[2500, 0] = 500.0   # an index out of range, filtered too
    t = ratings_table(corrupt, session)
    filtered = t.filter(torch.arange(t.n_pad) < 2000)
    model = ALS(rank=4, max_iter=6, reg_param=0.01, seed=1, n_users=50).fit(filtered)
    clean = ratings_table(ratings[:2000], session)
    rmse = RegressionEvaluator(metric_name="rmse", label_col="rating").evaluate(
        model.transform(clean))
    assert rmse < 0.2, f"corrupt filtered rows leaked: rmse {rmse}"


def test_als_implicit_negative_feedback_stays_finite(session):
    ratings = make_ratings(40, 30, 1500, rank=4, seed=7, noise=0.0)
    ratings[::3, 2] = -3.0  # negative feedback
    t = ratings_table(ratings, session)
    model = ALS(rank=4, max_iter=4, implicit_prefs=True, alpha=1.0).fit(t)
    assert torch.isfinite(model.user_factors).all()
    assert torch.isfinite(model.item_factors).all()


def test_als_factor_sharding_flag(session):
    """One device, no mesh: 'auto' and 'replicated' fit the same factors,
    'model' raises for the missing model axis, a bogus value raises."""
    ratings = make_ratings(48, 32, 2000, rank=3, seed=9)
    t = ratings_table(ratings, session)
    with pytest.raises(ValueError, match="model axis"):
        ALS(rank=3, max_iter=2, factor_sharding="model").fit(t)
    with pytest.raises(ValueError, match="factor_sharding"):
        ALS(rank=3, max_iter=2, factor_sharding="bogus").fit(t)
    repl = ALS(rank=3, max_iter=3, seed=2, factor_sharding="replicated").fit(t)
    auto = ALS(rank=3, max_iter=3, seed=2).fit(t)
    assert torch.equal(repl.user_factors, auto.user_factors)


def test_als_params_mirror_the_reference():
    fields = [(f.name, f.default) for f in dataclasses.fields(TA.ALSParams)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JA.ALSParams)]


# ------------------------------------------------- weights across the packages
def test_interop_predictions_and_recommendations_match_reference(jsess, session,
                                                                  monkeypatch):
    rng = np.random.default_rng(8)
    U = rng.standard_normal((37, 5)).astype(np.float32)
    V = rng.standard_normal((23, 5)).astype(np.float32)
    params = dict(rank=5, seed=3)
    jm = JA.ALSModel(JA.ALSParams(**params), jnp.asarray(U), jnp.asarray(V))
    tm = interop.als_model({k: np.asarray(v) for k, v in jm.state_pytree.items()},
                           jm.params.to_dict())
    assert tm.params == TA.ALSParams(**params)
    pairs = np.stack([rng.integers(0, 40, 500), rng.integers(-2, 23, 500),
                      rng.standard_normal(500)], axis=1).astype(np.float32)
    pj = to_np(jm.transform(JA.ratings_table(pairs, jsess)).column("prediction"))[:500]
    pt = to_np(tm.transform(ratings_table(pairs, session)).column("prediction"))
    np.testing.assert_array_equal(np.isnan(pj), np.isnan(pt))
    assert np.isnan(pt).sum() > 0                      # cold rows on both sides
    assert_port_equal(pj, pt, atol=2.5e-6, what="predictions")
    want, want_items = jm.recommend_for_all_users(7), jm.recommend_for_all_items(4)
    np.testing.assert_array_equal(want, tm.recommend_for_all_users(7))
    for block in (1, 5, 36, 37, 100):         # row blocks of the product
        monkeypatch.setattr(TA, "RECOMMEND_BLOCK_BYTES", block * 23 * 4)
        np.testing.assert_array_equal(want, tm.recommend_for_all_users(7))
    monkeypatch.setattr(TA, "RECOMMEND_BLOCK_BYTES", 6 * 37 * 4)
    np.testing.assert_array_equal(want_items, tm.recommend_for_all_items(4))


@pytest.mark.parametrize("rank", [2, 5, 16])
def test_recommend_tie_order_matches_reference(jsess, session, monkeypatch, rank):
    """Tied scores come in ``lax.top_k``'s order, the lower id first, ties
    at the n-th place included: zero factor rows (an entity no training
    rating reaches) tie every score of theirs, and duplicated rows tie
    whole columns. The ids equal the JAX package's at every row block."""
    rng = np.random.default_rng(20 + rank)
    U = rng.standard_normal((41, rank)).astype(np.float32)
    V = rng.standard_normal((29, rank)).astype(np.float32)
    U[[3, 17, 40]] = 0.0                      # unrated users
    V[[0, 6, 21]] = 0.0                       # unrated items
    V[[9, 25]] = V[4]                         # three items tied for every user
    U[[12, 30]] = U[5]                        # three users tied for every item
    jm = JA.ALSModel(JA.ALSParams(rank=rank), jnp.asarray(U), jnp.asarray(V))
    tm = TA.ALSModel(TA.ALSParams(rank=rank), torch.from_numpy(U), torch.from_numpy(V))
    for n in (1, 4, 10, 29):
        want = jm.recommend_for_all_users(n)
        assert (want[3] == np.arange(n)).all()            # a zero row: ids in order
        for block in (1, 7, 41):
            monkeypatch.setattr(TA, "RECOMMEND_BLOCK_BYTES", block * 29 * 4)
            np.testing.assert_array_equal(tm.recommend_for_all_users(n), want)
    for n in (1, 6, 41):
        want = jm.recommend_for_all_items(n)
        for block in (1, 10, 29):
            monkeypatch.setattr(TA, "RECOMMEND_BLOCK_BYTES", block * 41 * 4)
            np.testing.assert_array_equal(tm.recommend_for_all_items(n), want)


def test_recommend_blocks_bound_the_temporary(session, monkeypatch):
    """The score temporary holds at most ``RECOMMEND_BLOCK_BYTES``: with a
    budget of 3 rows the ids are those of the whole product."""
    rng = np.random.default_rng(9)
    U = torch.from_numpy(rng.standard_normal((50, 4)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((20, 4)).astype(np.float32))
    model = TA.ALSModel(TA.ALSParams(rank=4), U, V)
    whole = torch.topk(U @ V.T, 6, dim=1).indices.numpy()
    for budget in (3 * 20 * 4, 1):            # three rows a block; one
        monkeypatch.setattr(TA, "RECOMMEND_BLOCK_BYTES", budget)
        np.testing.assert_array_equal(model.recommend_for_all_users(6), whole)


def test_movielens_proxy_is_bench_suites_generator():
    """``make_movielens_proxy`` is ``bench_suite.py``'s config 4 generator
    (:143-158) draw for draw, here at 5,000 ratings."""
    n = 5000
    rng = np.random.default_rng(1)
    Ut = rng.normal(0, 0.6, (162_541, 12)).astype(np.float32)
    Vt = rng.normal(0, 0.6, (59_047, 12)).astype(np.float32)
    uu = rng.integers(0, 162_541, n, dtype=np.int64)
    ii = rng.integers(0, 59_047, n, dtype=np.int64)
    rr = (np.einsum("nk,nk->n", Ut[uu], Vt[ii]) + 3.5
          + 0.3 * rng.standard_normal(n).astype(np.float32))
    want = np.stack([uu.astype(np.float32), ii.astype(np.float32), rr],
                    axis=1).astype(np.float32)
    got = make_movielens_proxy(n)
    assert got.dtype == np.float32 and got.shape == (n, 3)
    np.testing.assert_array_equal(got, want)


def test_make_ratings_is_the_reference_generator():
    from orange3_spark_tpu.datasets import make_ratings as jmake

    np.testing.assert_array_equal(make_ratings(30, 20, 500, rank=3, seed=2, noise=0.2),
                                  jmake(30, 20, 500, rank=3, seed=2, noise=0.2))


# ----------------------------------------------------------------- the widget
def test_owals_in_a_workflow_graph(jsess, session):
    """OWTable -> OWALS -> OWRegressionEvaluator: the widget fits ALS with
    its settings and scores the table; the graph saves to the reference's
    JSON and loads there."""
    from orange3_spark_tpu.widgets import catalog as jcat  # noqa: F401
    from orange3_spark_tpu.workflow.graph import WorkflowGraph as JGraph

    ratings = make_ratings(60, 40, 3000, rank=3, seed=12, noise=0.05)
    t = ratings_table(ratings, session)
    g = WorkflowGraph()
    src = g.add(OWTable(t))
    als = g.add(WIDGET_REGISTRY["OWALS"](rank=3, max_iter=6, reg_param=0.01, seed=4))
    ev = g.add(WIDGET_REGISTRY["OWRegressionEvaluator"](metric_name="rmse",
                                                        label_col="rating"))
    g.connect(src, "data", als, "data")
    g.connect(als, "data", ev, "data")
    out = g.run()
    model = out[als]["model"]
    assert isinstance(model, TA.ALSModel) and model.params.rank == 3
    direct = ALS(rank=3, max_iter=6, reg_param=0.01, seed=4).fit(t)
    assert torch.equal(model.user_factors, direct.user_factors)
    assert out[ev]["score"] < 0.1
    jg = JGraph.from_json(g.to_json())
    assert [n.widget.name for n in jg.nodes.values()] == ["OWTable", "OWALS",
                                                          "OWRegressionEvaluator"]
    assert jg.nodes[1].widget.params.rank == 3


# ------------------------------------------- chip_smoke.py's ALS helpers
def _smoke():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_als_helpers_run_on_the_cpu(session):
    """The smoke's checks, rehearsed with the CPU as the 'device' (both
    sides then run the plain version): the kernel case, the recommendation
    agreement, the held-out truth matrix, the stage split and the bound of
    config 4's user half-step."""
    smoke = _smoke()
    line = smoke._ne_case(16, 50, 60, 40, 2000, 256, 500, False, torch.device("cpu"))
    assert line["ok"] and line["ratings"] == 2500, line
    U, V = torch.randn(30, 4), torch.randn(20, 4)
    _, _, agree = smoke._recommend_agreement(U, V, 5, torch.device("cpu"))
    assert agree == {"rows": 30, "rows_differ": 0}
    truth, users = smoke._holdout_truth(np.array([3, 0, 3, 3]), np.array([7, 1, 2, 9]), 5)
    assert users.tolist() == [0, 3]
    assert truth.tolist() == [[1, -1, -1], [-1] * 3, [-1] * 3, [7, 2, 9], [-1] * 3]
    split = smoke._als_profile_split({
        "void (anonymous namespace)::normal_eq_sorted<1>(Args)": [50.0, 20],
        "void cub::DeviceRadixSortOnesweepKernel<...>": [2.0, 8],
        "void getrf_semiwarp<float, float, 4, 0, true>(...)": [6.0, 20],
        "void trsm_batch_left_upper_kernel<float>(...)": [2.0, 40],
        "void at::native::elementwise_kernel<128, 2>": [1.0, 20]})
    assert split == {"normal_equations": 0.05, "sort": 0.002, "solve": 0.008, "rest": 0.001}
    b = smoke._ne_bound(24_737_856, 162_541, 16, 59_047, 3.35e12, 67e12, 162_541)
    # 12 B a rating, the offsets, 20 B a unit, the item factors, A, b, cnt
    assert b["bytes"] == 482_679_208 and b["ops"] == 10_909_394_496
    # the bytes take 0.1441 ms, under the operations' 0.1628 at the float32
    # peak; products and adds that may not contract take twice that
    assert b["bound_by"] == "operations" and abs(b["bound_ms"] - 0.16283) < 1e-4
    assert abs(b["issue_bound_ms"] - 0.32565) < 1e-4
    assert smoke._ne_bound(10, 2, 3, 4, 1.0, 1.0, 2, implicit=True)["bytes_per_rating"] == 16


def test_chip_smoke_ne_tolerance_holds_and_catches_a_dropped_rating(session):
    """The smoke's bound on the kernel against the plain version at the
    main path's inputs: float64 sums and the yardstick's other order lie
    within it, and one rating dropped from a segment of ~400 lies outside."""
    smoke = _smoke()
    rng = np.random.default_rng(4)
    M, E, n_other, k, chunk = 40_000, 100, 60, 8, 4096
    u, i, r, w = (torch.from_numpy(x) for x in (
        rng.integers(0, E, M).astype(np.int32), rng.integers(0, n_other, M).astype(np.int32),
        (rng.standard_normal(M) * 2).astype(np.float32),
        (rng.random(M) >= 0.1).astype(np.float32)))
    V = torch.from_numpy(rng.standard_normal((n_other, k)).astype(np.float32))
    plan = TA._side_plan(u, i, r, w, E, n_other, False, 1.0)(chunk)
    oid, aw, off = plan.key & 0x7FFFFFFF, plan.aw, plan.offsets
    got = NE.normal_equations_sorted(V, plan)
    tol = smoke._ne_tolerance(V, plan)
    ent = torch.repeat_interleave(torch.arange(E), off[1:] - off[:-1])
    Vd = V.double()[oid.long()]
    exact = torch.zeros(E, k, k, dtype=torch.float64).index_add_(
        0, ent, (Vd[:, :, None] * Vd[:, None, :]) * aw.double()[:, None, None])
    assert ((got[0].double() - exact).abs() <= tol[0] / 2).all()
    A_yard, bc_yard = smoke._outer_index_add(V, plan)
    assert ((A_yard[:E].reshape(E, k, k).double() - got[0].double()).abs() <= tol[0]).all()
    assert ((bc_yard[:E, :k].double() - got[1].double()).abs() <= tol[1]).all()
    assert torch.equal(bc_yard[:E, k], got[2])            # 0/1 weights: exact counts
    aw2 = aw.clone()
    aw2[int(off[7])] = 1.0 - aw2[int(off[7])]               # one rating in or out
    bad = NE.normal_equations_sorted(V, plan._replace(aw=aw2))
    assert ((bad[0].double() - got[0].double()).abs() > tol[0]).any()


def test_served_transform_equals_raw(session):
    """ALSModel.transform through a ServingContext (padded to a rung of the
    ladder) equals the raw transform bitwise: a prediction is a per-row
    sum in column order, whatever the row count."""
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

    ratings = make_ratings(100, 80, 3000, rank=3, seed=1)
    model = ALS(rank=3, max_iter=3).fit(ratings_table(ratings, session))
    bad = ratings[:300].copy()
    bad[::7, 0] = 500                                     # cold rows: NaN
    tables = {n: ratings_table(bad[:n], session) for n in (5, 64, 100, 300)}
    raw = {n: model.transform(t).X.numpy() for n, t in tables.items()}
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=2048)) as ctx:
        served = {n: model.transform(t).X.numpy() for n, t in tables.items()}
        assert sorted({key[0] for key in ctx.cache.keys()}) == ["transform"]
    for n in tables:
        np.testing.assert_array_equal(served[n], raw[n])
