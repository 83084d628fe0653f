"""Datasets of the PyTorch package: the Iris table (BASELINE config 1) and
generators that give the JAX package's draws from the same seed."""

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
