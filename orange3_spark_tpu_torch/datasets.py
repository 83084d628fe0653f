"""Datasets of the PyTorch package: the Iris table (BASELINE config 1),
generators that give the JAX package's draws from the same seed (the
HIGGS, taxi and MovieLens proxies, ``make_blobs``, ``make_ratings``), and
seeded stand-ins of public data at its size (a planted-partition graph of
com-LiveJournal's size, a Zipf corpus of 20 Newsgroups' documents,
T10I4D100K-shaped transactions)."""

from __future__ import annotations

import csv
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from orange3_spark_tpu_torch.core.domain import (
    ContinuousVariable, DiscreteVariable, Domain,
)
from orange3_spark_tpu_torch.core.table import TorchTable

IRIS_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "iris.csv")
IRIS_FEATURES = ("sepal length (cm)", "sepal width (cm)", "petal length (cm)",
                 "petal width (cm)")


def load_iris(session=None) -> TorchTable:
    """Iris-150 as a TorchTable (BASELINE config 1), from the package's own
    copy of scikit-learn's ``iris.csv`` (its header row: rows, features,
    the class names; then four measurements and a class index a row), read
    as scikit-learn reads it."""
    with open(IRIS_CSV, encoding="utf-8", newline="") as f:
        rows = csv.reader(f)
        head = next(rows)
        n, d, names = int(head[0]), int(head[1]), tuple(head[2:])
        X = np.empty((n, d), dtype=np.float64)
        y = np.empty((n,), dtype=np.int64)
        for i, row in enumerate(rows):
            X[i] = np.asarray(row[:-1], dtype=np.float64)
            y[i] = int(row[-1])
    domain = Domain([ContinuousVariable(c) for c in IRIS_FEATURES],
                    DiscreteVariable("iris", names))
    return TorchTable.from_numpy(domain, X, y, session=session)


def make_classification(n_rows: int, n_features: int, n_classes: int = 2, seed: int = 0,
                        noise: float = 1.0, session=None) -> TorchTable:
    """Linearly separable-ish classifier data: the argmax of X @ true_w plus
    noise, with the JAX package's ``make_classification`` draws."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_rows, n_features), dtype=np.float32)
    true_w = rng.standard_normal((n_features, n_classes)).astype(np.float32)
    logits = X @ true_w + noise * rng.standard_normal((n_rows, n_classes)).astype(np.float32)
    y = np.argmax(logits, axis=1).astype(np.float32)
    domain = Domain([ContinuousVariable(f"f{i}") for i in range(n_features)],
                    DiscreteVariable("label", tuple(str(c) for c in range(n_classes))))
    return TorchTable.from_numpy(domain, X, y, session=session)

def make_blobs(n_rows: int, n_features: int, n_centers: int, seed: int = 0,
               spread: float = 0.5, session=None) -> tuple[TorchTable, np.ndarray]:
    """Gaussian blobs for KMeans testing (the NYC-Taxi stand-in), the JAX
    package's ``make_blobs`` draws: centers uniform on [-5, 5], each row's
    center drawn, then ``spread`` times a standard normal added. Returns
    (table, each row's center)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, size=(n_centers, n_features)).astype(np.float32)
    assign = rng.integers(0, n_centers, size=n_rows)
    X = centers[assign] + spread * rng.standard_normal((n_rows, n_features)).astype(np.float32)
    domain = Domain([ContinuousVariable(f"f{i}") for i in range(n_features)])
    return TorchTable.from_numpy(domain, X, session=session), assign


HIGGS_FEATURES = 28


def make_higgs_proxy(n_rows: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """HIGGS-shaped binary data, the generator of ``bench_suite.py`` config 3:
    28 standard-normal features and a signal built from pairwise products
    and a radial term (tree-learnable, linear-model-opaque).
    Returns (X f32[n, 28], y f32[n])."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_rows, HIGGS_FEATURES), dtype=np.float32)
    z = (X[:, 0] * X[:, 1] - X[:, 2] * X[:, 3]
         + 0.8 * (X[:, 4] ** 2 - 1.0)
         + 0.6 * np.sign(X[:, 5]) * X[:, 6])
    y = (z + 0.5 * rng.standard_normal(n_rows).astype(np.float32) > 0
         ).astype(np.float32)
    return X, y


def higgs_domain() -> Domain:
    return Domain([ContinuousVariable(f"f{i}") for i in range(HIGGS_FEATURES)],
                  DiscreteVariable("signal", ("0", "1")))


TAXI_COLUMNS = ("dist", "dur", "fare", "lon", "lat", "hour", "dow", "pax")


def make_taxi_proxy(n_rows: int, seed: int = 2) -> np.ndarray:
    """The NYC-Taxi proxy of BASELINE config 5 (``bench_suite.py``'s and
    ``bench.py``'s ``bench_taxi_pipeline`` generator, draw for draw):
    [n_rows, 8] f32 trip features, lognormal distances and durations, a
    fare linear in both, pickup lon/lat uniform over the city, hour, day of
    week and passenger count."""
    rng = np.random.default_rng(seed)
    dist = rng.lognormal(0.5, 1.0, n_rows).astype(np.float32)
    dur = (dist * 3.2 + rng.lognormal(0, 0.4, n_rows)).astype(np.float32)
    fare = (2.5 + 1.8 * dist + 0.4 * dur + rng.standard_normal(n_rows)).astype(np.float32)
    return np.stack(
        [dist, dur, fare,
         rng.uniform(-74.05, -73.75, n_rows).astype(np.float32),
         rng.uniform(40.6, 40.9, n_rows).astype(np.float32),
         rng.integers(0, 24, n_rows).astype(np.float32),
         rng.integers(0, 7, n_rows).astype(np.float32),
         rng.integers(1, 7, n_rows).astype(np.float32)], axis=1)


def taxi_domain() -> Domain:
    return Domain([ContinuousVariable(c) for c in TAXI_COLUMNS])


#: the NYC TLC "Yellow Taxi Trip Records" columns of ``make_tlc_trips``
#: (names after the TLC data dictionary; the pickup as seconds into the month)
TLC_COLUMNS = ("VendorID", "PULocationID", "DOLocationID", "payment_type",
               "passenger_count", "trip_distance", "fare_amount", "tip_amount",
               "total_amount", "pickup_s")
#: the data dictionary's codes: VendorID 1-2 (Creative Mobile, VeriFone);
#: payment_type 1-6 (credit card, cash, no charge, dispute, unknown,
#: voided); LocationID 1-265 (the taxi zones)
TLC_VENDORS = ("1", "2")
TLC_PAYMENT_TYPES = ("1", "2", "3", "4", "5", "6")
TLC_ZONES = tuple(str(i) for i in range(1, 266))
#: the zone lookup's boroughs and their zone counts (taxi_zone_lookup.csv)
TLC_BOROUGHS = (("Bronx", 43), ("Brooklyn", 61), ("EWR", 1), ("Manhattan", 69),
                ("Queens", 69), ("Staten Island", 20), ("Unknown", 2))
TLC_SERVICE_ZONES = ("Airports", "Boro Zone", "EWR", "Yellow Zone")


def tlc_domain() -> Domain:
    d = {"VendorID": TLC_VENDORS, "PULocationID": TLC_ZONES, "DOLocationID": TLC_ZONES,
         "payment_type": TLC_PAYMENT_TYPES}
    return Domain([DiscreteVariable(c, d[c]) if c in d else ContinuousVariable(c)
                   for c in TLC_COLUMNS])


def make_tlc_trips(n_rows: int, seed: int = 0) -> np.ndarray:
    """A month of NYC yellow-taxi trips shaped after the TLC trip records:
    f32 [n_rows, 10] in ``TLC_COLUMNS`` order (``tlc_domain()``). Pickup and
    drop-off zones are drawn Zipf(1.0) over the zones' ranks (a seeded
    order of the 265 zones; the busiest takes about 16 % of the trips), the
    vendor 1 or 2, payment types 1-6 weighted as in the records (0.1 % of
    them missing, NaN), passenger counts 1-6 (1 % missing), lognormal
    distances, fares metered on distance, tips on card payments only, the
    pickup's second into a 31-day month (integral, so there are ties)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(TLC_ZONES) + 1)
    zipf = (1.0 / ranks) / np.sum(1.0 / ranks)
    zone_of_rank = rng.permutation(len(TLC_ZONES))
    pu = zone_of_rank[rng.choice(len(ranks), size=n_rows, p=zipf)]
    do = zone_of_rank[rng.choice(len(ranks), size=n_rows, p=zipf)]
    vendor = rng.integers(0, 2, n_rows)
    pay = rng.choice(6, size=n_rows, p=[0.70, 0.25, 0.02, 0.015, 0.01, 0.005]).astype(np.float32)
    pay[rng.random(n_rows) < 0.001] = np.nan
    pax = rng.integers(1, 7, n_rows).astype(np.float32)
    pax[rng.random(n_rows) < 0.01] = np.nan
    dist = rng.lognormal(0.6, 0.8, n_rows).astype(np.float32)
    fare = (3.0 + 2.5 * dist + rng.gamma(2.0, 0.5, n_rows)).astype(np.float32)
    tip = np.where(pay == 0, fare * rng.uniform(0.1, 0.3, n_rows), 0.0).astype(np.float32)
    total = (fare + tip + 3.3).astype(np.float32)
    pickup = rng.integers(0, 31 * 86400, n_rows).astype(np.float32)
    return np.stack([vendor, pu, do, pay, pax, dist, fare, tip, total, pickup],
                    axis=1).astype(np.float32)


def tlc_zone_lookup(seed: int = 0) -> tuple[Domain, np.ndarray]:
    """The 265-row taxi zone lookup: ``PULocationID`` (the LocationID,
    discrete over the 265 zones, named for the trips' join key),
    ``Borough`` (7 values, the real counts a borough, in a
    seeded order of the zones) and ``service_zone`` (4 values: EWR's zone
    'EWR', two Queens zones 'Airports', Manhattan 'Yellow Zone', the rest
    'Boro Zone'). Returns (domain, f32 [265, 3])."""
    rng = np.random.default_rng(seed)
    names = [b for b, _ in TLC_BOROUGHS]
    borough = rng.permutation(np.repeat(np.arange(len(names)), [c for _, c in TLC_BOROUGHS]))
    service = np.full(len(borough), TLC_SERVICE_ZONES.index("Boro Zone"))
    service[borough == names.index("EWR")] = TLC_SERVICE_ZONES.index("EWR")
    service[borough == names.index("Manhattan")] = TLC_SERVICE_ZONES.index("Yellow Zone")
    service[np.flatnonzero(borough == names.index("Queens"))[:2]] = \
        TLC_SERVICE_ZONES.index("Airports")
    domain = Domain([DiscreteVariable("PULocationID", TLC_ZONES),
                     DiscreteVariable("Borough", names),
                     DiscreteVariable("service_zone", TLC_SERVICE_ZONES)])
    X = np.stack([np.arange(len(borough)), borough, service], 1).astype(np.float32)
    return domain, X


def write_tlc_sqlite(path: str, n_rows: int, seed: int = 0) -> None:
    """``make_tlc_trips(n_rows, seed)`` and its zone lookup as a SQLite
    database at ``path``: a ``trips`` table (VendorID and payment_type as
    TEXT, so a SQL reader infers them discrete; the location ids INTEGER;
    missing cells NULL) and a ``zones`` table (LocationID INTEGER, Borough
    and service_zone TEXT), as the TLC publishes its lookup."""
    import sqlite3

    X = make_tlc_trips(n_rows, seed)
    zdom, Z = tlc_zone_lookup(seed=seed)
    text = {"VendorID": TLC_VENDORS, "payment_type": TLC_PAYMENT_TYPES}
    integral = ("PULocationID", "DOLocationID", "pickup_s")
    cols = []
    for j, c in enumerate(TLC_COLUMNS):
        v = X[:, j]
        if c in text:
            cells = np.asarray(text[c], dtype=object)[np.nan_to_num(v).astype(np.int64)]
            cols.append(np.where(np.isnan(v), None, cells))
        elif c in integral:
            cols.append((v.astype(np.int64) + (1 if "Location" in c else 0)).tolist())
        else:
            cols.append(np.where(np.isnan(v), None, v.astype(object)))
    rows = list(zip(*cols))
    kinds = ["TEXT" if c in text else "INTEGER" if c in integral else "REAL"
             for c in TLC_COLUMNS]
    boroughs, services = zdom["Borough"].values, zdom["service_zone"].values
    zones = [(int(r[0]) + 1, boroughs[int(r[1])], services[int(r[2])]) for r in Z]
    with sqlite3.connect(path) as conn:
        conn.execute("DROP TABLE IF EXISTS trips")
        conn.execute("DROP TABLE IF EXISTS zones")
        conn.execute("CREATE TABLE trips (" + ", ".join(
            f"{c} {k}" for c, k in zip(TLC_COLUMNS, kinds)) + ")")
        conn.executemany(f"INSERT INTO trips VALUES ({', '.join('?' * len(TLC_COLUMNS))})",
                         rows)
        conn.execute("CREATE TABLE zones (LocationID INTEGER PRIMARY KEY, Borough TEXT, "
                     "service_zone TEXT)")
        conn.executemany("INSERT INTO zones VALUES (?, ?, ?)", zones)
    conn.close()


def make_ratings(
    n_users: int, n_items: int, n_ratings: int, rank: int = 8, seed: int = 0,
    noise: float = 0.1,
) -> np.ndarray:
    """(user, item, rating) triples from a low-rank model (MovieLens stand-in),
    the JAX package's draws from the same seed.

    Returns a float32 [n_ratings, 3] array; duplicates possible like real logs.
    """
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n_users, rank)).astype(np.float32) / np.sqrt(rank)
    V = rng.standard_normal((n_items, rank)).astype(np.float32) / np.sqrt(rank)
    users = rng.integers(0, n_users, size=n_ratings)
    items = rng.integers(0, n_items, size=n_ratings)
    ratings = np.sum(U[users] * V[items], axis=1) + noise * rng.standard_normal(n_ratings).astype(np.float32)
    return np.stack([users.astype(np.float32), items.astype(np.float32), ratings], axis=1)


#: the MovieLens-25M proxy of BASELINE config 4: users, items, true rank
MOVIELENS_USERS, MOVIELENS_ITEMS, MOVIELENS_TRUE_RANK = 162_541, 59_047, 12


def make_movielens_proxy(n_ratings: int, seed: int = 1) -> np.ndarray:
    """The MovieLens-25M proxy of BASELINE config 4 (``bench_suite.py``'s
    ``bench_movielens_als`` generator, draw for draw): 162,541 users x
    59,047 items, true rank 12, N(0, 0.6) factors, ratings their product +
    3.5 + N(0, 0.3) noise. Returns float32 [n_ratings, 3] (user, item,
    rating)."""
    rng = np.random.default_rng(seed)
    Ut = rng.normal(0, 0.6, (MOVIELENS_USERS, MOVIELENS_TRUE_RANK)).astype(np.float32)
    Vt = rng.normal(0, 0.6, (MOVIELENS_ITEMS, MOVIELENS_TRUE_RANK)).astype(np.float32)
    uu = rng.integers(0, MOVIELENS_USERS, n_ratings, dtype=np.int64)
    ii = rng.integers(0, MOVIELENS_ITEMS, n_ratings, dtype=np.int64)
    rr = (np.einsum("nk,nk->n", Ut[uu], Vt[ii]) + 3.5
          + 0.3 * rng.standard_normal(n_ratings).astype(np.float32))
    return np.stack(
        [uu.astype(np.float32), ii.astype(np.float32), rr], axis=1
    ).astype(np.float32)


#: SNAP's com-LiveJournal: nodes and undirected edges
LIVEJOURNAL_NODES, LIVEJOURNAL_EDGES = 3_997_962, 34_681_189
#: 20 Newsgroups (the "bydate" split's two halves): documents
NEWSGROUPS_DOCS = 18_846
#: FIMI's T10I4D100K: transactions, items, mean transaction length
T10I4D100K = (100_000, 870, 10)


def make_planted_graph(n_nodes: int, n_edges: int, p_in: float = 0.9,
                       seed: int = 0, first_share: float | None = None,
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A seeded planted-partition similarity graph: two communities of
    half the nodes each, each edge's source uniform (or, with
    ``first_share``, in the first community with that probability and
    uniform within it, so the communities' mean degrees differ), its
    destination in the source's community with probability ``p_in``, its
    weight uniform in [0.1, 1.1). Returns (src int64, dst int64, weight
    f32) and nothing is symmetrised (PIC does that)."""
    rng = np.random.default_rng(seed)
    half = n_nodes // 2
    if first_share is None:
        src = rng.integers(0, n_nodes, n_edges, dtype=np.int64)
    else:
        upper = rng.random(n_edges) >= first_share
        src = np.where(upper, half + (rng.random(n_edges) * (n_nodes - half)).astype(np.int64),
                       (rng.random(n_edges) * half).astype(np.int64))
    same = rng.random(n_edges) < p_in
    side = (src >= half) == same                     # True: the upper community
    lo = np.where(side, half, 0)
    span = np.where(side, n_nodes - half, half)
    dst = lo + (rng.random(n_edges) * span).astype(np.int64)
    w = (rng.random(n_edges) + 0.1).astype(np.float32)
    return src, dst, w


def make_zipf_corpus(n_docs: int, mean_tokens: int = 200, vocab: int = 50_000,
                     seed: int = 0) -> np.ndarray:
    """A seeded corpus of ``n_docs`` documents of Poisson(``mean_tokens``)
    words drawn Zipf(1.0) over ``vocab`` word types ("w<rank>"; the
    default English stop words take the top ranks, so StopWordsRemover has
    work). Returns object [n_docs, 1] of strings, a meta column."""
    from orange3_spark_tpu_torch.models.text import _DEFAULT_STOP_WORDS

    rng = np.random.default_rng(seed)
    words = np.array(list(_DEFAULT_STOP_WORDS)
                     + [f"w{r}" for r in range(vocab - len(_DEFAULT_STOP_WORDS))], dtype=object)
    p = 1.0 / np.arange(1, vocab + 1)
    lengths = np.maximum(rng.poisson(mean_tokens, n_docs), 1)
    ids = rng.choice(vocab, size=int(lengths.sum()), p=p / p.sum())
    cuts = np.cumsum(lengths)[:-1]
    out = np.empty((n_docs, 1), dtype=object)
    out[:, 0] = [" ".join(words[d]) for d in np.split(ids, cuts)]
    return out


def make_transactions(n: int = T10I4D100K[0], n_items: int = T10I4D100K[1],
                      mean_len: int = T10I4D100K[2], n_patterns: int = 2000,
                      mean_pattern: int = 4, seed: int = 0) -> np.ndarray:
    """Transactions shaped after IBM Quest's generator (FIMI's T10I4D100K):
    ``n_patterns`` potential itemsets of Poisson(``mean_pattern``) items
    with Zipf-weighted popularity; a transaction of Poisson(``mean_len``)
    items takes whole patterns until it is full. Returns object [n, 1] of
    sorted item-name lists, a meta column."""
    rng = np.random.default_rng(seed)
    item_p = 1.0 / np.arange(1, n_items + 1)
    item_p /= item_p.sum()
    patterns = [np.unique(rng.choice(n_items, max(1, rng.poisson(mean_pattern)), p=item_p))
                for _ in range(n_patterns)]
    pat_p = rng.exponential(1.0, n_patterns)
    pat_p /= pat_p.sum()
    sizes = np.maximum(rng.poisson(mean_len, n), 1)
    picks = rng.choice(n_patterns, size=int(sizes.sum()), p=pat_p)
    out = np.empty((n, 1), dtype=object)
    at = 0
    for i, size in enumerate(sizes):
        items: set[int] = set()
        while len(items) < size:
            items.update(patterns[picks[at % len(picks)]].tolist())
            at += 1
        out[i, 0] = [f"i{j}" for j in sorted(items)]
    return out


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC AUC by the rank-sum formula (ties broken by sort order), as
    ``bench_suite.py`` computes it."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    npos = labels.sum()
    nneg = len(labels) - npos
    return float((ranks[labels > 0.5].sum() - npos * (npos + 1) / 2)
                 / (npos * nneg))


CRITEO_DENSE, CRITEO_CAT = 13, 26
CRITEO_COLUMNS = (["label"] + [f"i{j}" for j in range(CRITEO_DENSE)]
                  + [f"c{j}" for j in range(CRITEO_CAT)])


def gen_criteo_csv(path: str, n_rows: int, seed: int = 0) -> None:
    """Write a Criteo-shaped CSV: label + 13 skewed numerics + 26 categorical
    codes whose per-level latent effects drive the label (most signal lives
    in the categoricals, as in real click-through data).

    The generator of ``bench.py --config criteo``: the same
    ``default_rng(seed)`` draws in the same order, in blocks of 1M rows, so
    a seed gives the same parsed rows as that script's file. Blocks are
    written by the package's native CSV writer on worker threads (the
    writer releases the GIL), each to its own part file, and the parts are
    joined into ``path`` (written as ``path + '.tmp'`` first, then renamed:
    a killed run leaves no final file)."""
    from orange3_spark_tpu_torch.io.native import write_csv_native

    rng = np.random.default_rng(seed)
    card = 200_000           # per-column cardinality
    eff_card = 1024          # latent effects live on code % eff_card
    effects = rng.normal(0.0, 0.9, size=(CRITEO_CAT, eff_card)).astype(np.float32)
    w_dense = rng.normal(0.0, 0.4, size=CRITEO_DENSE).astype(np.float32)
    tmp = path + ".tmp"
    parts = []
    gen_chunk = 1_000_000
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        futures = []
        done = 0
        while done < n_rows:
            n = min(gen_chunk, n_rows - done)
            dense = rng.lognormal(0.0, 1.0, size=(n, CRITEO_DENSE)).astype(np.float32)
            cats = rng.integers(0, card, size=(n, CRITEO_CAT), dtype=np.int32)
            logit = (dense - 1.6) @ w_dense - 0.5
            for j in range(CRITEO_CAT):
                logit += effects[j, cats[:, j] % eff_card]
            y = (logit + 0.5 * rng.standard_normal(n).astype(np.float32) > 0)
            block = np.concatenate([y[:, None].astype(np.float32), dense,
                                    cats.astype(np.float32)], axis=1)
            part = f"{tmp}.{len(parts)}"
            parts.append(part)
            futures.append(pool.submit(write_csv_native, part, block,
                                       CRITEO_COLUMNS if done == 0 else None))
            done += n
        for f in futures:
            f.result()
    try:
        with open(tmp, "wb") as out:
            for part in parts:
                with open(part, "rb") as src:
                    shutil.copyfileobj(src, out, 16 << 20)
        os.replace(tmp, path)
    finally:
        for part in parts + [tmp]:
            if os.path.exists(part):
                os.unlink(part)
