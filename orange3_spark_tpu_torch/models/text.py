"""The text feature pipeline: ``pyspark.ml.feature``'s Tokenizer,
RegexTokenizer, StopWordsRemover, NGram, HashingTF, CountVectorizer, IDF and
Word2Vec.

Port of ``orange3_spark_tpu/models/text.py``. Free text stays on the host in
``table.metas``, as in the reference: tokenizing, stop words, n-grams and
hashing (``zlib.crc32``, the same indices) are string work. Once text becomes
numbers (term counts, IDF weights, word vectors) it lives in the table's
``X`` on the device.

Word2Vec trains skip-gram with negative sampling as the reference does, a
full-batch step over the (center, context) pairs, ten steps an epoch, from
the reference's seeded start: the numpy draws of the pairs and the
``jax.random`` stream (``ops/prng``) of the initial table and the
negatives. The negatives are ``jax.random.categorical`` with a shape, one
launch of the hand-written ``categorical_gumbel`` on CUDA. The gradient is
written out (the reference takes it by autodiff), and its scatter into the
[V, D] tables is summed without float atomics: the ids are stably sorted
(the centers once a fit, the contexts and negatives each step) and summed
by ``segment_sum_sorted``, so two fits on the card give the same bits.
"""

from __future__ import annotations

import dataclasses
import re
import zlib

import numpy as np
import torch

from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain, StringVariable
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Estimator, Model, Params, Transformer
from orange3_spark_tpu_torch.ops import prng
from orange3_spark_tpu_torch.ops.segment_sum import segment_sum_sorted

# a compact default English stop list (the reference's)
_DEFAULT_STOP_WORDS = (
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with i me my we "
    "our you your he him his she her its them what which who whom am been "
    "being have has had having do does did doing would should could ought"
).split()


def _meta_col(table: TorchTable, name: str) -> np.ndarray:
    if table.metas is None:
        raise ValueError("table has no meta columns")
    names = [v.name for v in table.domain.metas]
    if name not in names:
        raise ValueError(f"no meta column {name!r} (have {names})")
    return table.metas[:, names.index(name)]


def _append_meta(table: TorchTable, name: str, values: np.ndarray) -> TorchTable:
    """New table with an extra host-side meta column (token lists etc.)."""
    col = np.empty((len(values), 1), dtype=object)
    col[:, 0] = values
    metas = col if table.metas is None else np.concatenate([table.metas, col], axis=1)
    domain = Domain(table.domain.attributes, table.domain.class_vars,
                    list(table.domain.metas) + [StringVariable(name)])
    return TorchTable(domain, table.X, table.Y, table.W, metas, table.n_rows, table.session)


def _append_x(table: TorchTable, names: list[str], cols) -> TorchTable:
    """Append numeric columns to X on its device: host-computed numpy
    columns (padded here), or a tensor of ``n_pad`` rows on X's device."""
    if isinstance(cols, np.ndarray):
        pad = np.zeros((table.n_pad, cols.shape[1]), dtype=np.float32)
        pad[: cols.shape[0]] = cols
        cols = torch.from_numpy(pad).to(table.X.device)
    domain = Domain(list(table.domain.attributes) + [ContinuousVariable(n) for n in names],
                    table.domain.class_vars, table.domain.metas)
    X = cols if table.X.shape[1] == 0 else torch.cat([table.X, cols], dim=1)
    return table.with_X(X, domain)


def _counts(table: TorchTable, rows: list, cols: list, width: int) -> torch.Tensor:
    """f32[n_pad, width] term counts on the table's device from one (row,
    column) pair an occurrence: integer sums, exact in any order."""
    dev = table.X.device
    out = torch.zeros((table.n_pad, width), dtype=torch.float32, device=dev)
    if rows:
        idx = (torch.tensor(rows, dtype=torch.int64, device=dev),
               torch.tensor(cols, dtype=torch.int64, device=dev))
        out.index_put_(idx, torch.ones(len(rows), dtype=torch.float32, device=dev),
                       accumulate=True)
    return out


def _tokens(ts) -> list:
    return ts if isinstance(ts, list) else str(ts).split()


# ---------------------------------------------------------------- tokenizers
@dataclasses.dataclass(frozen=True)
class TokenizerParams(Params):
    input_col: str = "text"
    output_col: str = "tokens"


class Tokenizer(Transformer):
    """MLlib Tokenizer: lowercase, split on whitespace."""

    ParamsCls = TokenizerParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        texts = _meta_col(table, p.input_col)
        toks = np.empty(len(texts), dtype=object)
        for i, t in enumerate(texts):
            toks[i] = str(t).lower().split()
        return _append_meta(table, p.output_col, toks)


@dataclasses.dataclass(frozen=True)
class RegexTokenizerParams(Params):
    input_col: str = "text"
    output_col: str = "tokens"
    pattern: str = r"\s+"         # MLlib pattern
    gaps: bool = True             # pattern matches gaps (split) vs tokens (findall)
    min_token_length: int = 1     # MLlib minTokenLength
    to_lowercase: bool = True     # MLlib toLowercase


class RegexTokenizer(Transformer):
    ParamsCls = RegexTokenizerParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        rx = re.compile(p.pattern)
        texts = _meta_col(table, p.input_col)
        toks = np.empty(len(texts), dtype=object)
        for i, t in enumerate(texts):
            s = str(t).lower() if p.to_lowercase else str(t)
            parts = rx.split(s) if p.gaps else rx.findall(s)
            toks[i] = [w for w in parts if len(w) >= p.min_token_length]
        return _append_meta(table, p.output_col, toks)


@dataclasses.dataclass(frozen=True)
class StopWordsRemoverParams(Params):
    input_col: str = "tokens"
    output_col: str = "filtered"
    stop_words: tuple = tuple(_DEFAULT_STOP_WORDS)  # MLlib stopWords
    case_sensitive: bool = False                    # MLlib caseSensitive


class StopWordsRemover(Transformer):
    ParamsCls = StopWordsRemoverParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        stop = set(p.stop_words if p.case_sensitive else (w.lower() for w in p.stop_words))
        toks = _meta_col(table, p.input_col)
        out = np.empty(len(toks), dtype=object)
        for i, ts in enumerate(toks):
            out[i] = [w for w in _tokens(ts)
                      if (w if p.case_sensitive else w.lower()) not in stop]
        return _append_meta(table, p.output_col, out)


@dataclasses.dataclass(frozen=True)
class NGramParams(Params):
    input_col: str = "tokens"
    output_col: str = "ngrams"
    n: int = 2  # MLlib n


class NGram(Transformer):
    ParamsCls = NGramParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        toks = _meta_col(table, p.input_col)
        out = np.empty(len(toks), dtype=object)
        for i, ts in enumerate(toks):
            ts = _tokens(ts)
            out[i] = [" ".join(ts[j: j + p.n]) for j in range(len(ts) - p.n + 1)]
        return _append_meta(table, p.output_col, out)


# ---------------------------------------------------------- vectorization
@dataclasses.dataclass(frozen=True)
class HashingTFParams(Params):
    input_col: str = "tokens"
    output_prefix: str = "tf"
    num_features: int = 1024  # MLlib numFeatures (dense columns here)
    binary: bool = False      # MLlib binary


class HashingTF(Transformer):
    """Feature hashing: term -> crc32(term) mod num_features (the
    reference's index, stable across processes)."""

    ParamsCls = HashingTFParams

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        toks = _meta_col(table, p.input_col)
        rows, cols = [], []
        for i, ts in enumerate(toks):
            for w in _tokens(ts):
                rows.append(i)
                cols.append(zlib.crc32(w.encode()) % p.num_features)
        counts = _counts(table, rows, cols, p.num_features)
        if p.binary:
            counts = (counts > 0).to(torch.float32)
        names = [f"{p.output_prefix}_{j}" for j in range(p.num_features)]
        return _append_x(table, names, counts)


@dataclasses.dataclass(frozen=True)
class CountVectorizerParams(Params):
    input_col: str = "tokens"
    output_prefix: str = "cv"
    vocab_size: int = 1024   # MLlib vocabSize
    min_df: float = 1.0      # MLlib minDF (>=1: count, <1: fraction of docs)
    min_tf: float = 1.0      # MLlib minTF (per-doc filter)
    binary: bool = False


class CountVectorizerModel(Model):
    def __init__(self, params, vocabulary):
        self.params = params
        self.vocabulary = tuple(vocabulary)

    @property
    def state_pytree(self):
        return {}

    def transform(self, table: TorchTable) -> TorchTable:
        p = self.params
        lut = {w: j for j, w in enumerate(self.vocabulary)}
        toks = _meta_col(table, p.input_col)
        rows, cols = [], []
        min_tf = np.zeros(table.n_pad)
        for i, ts in enumerate(toks):
            ts = _tokens(ts)
            for w in ts:
                j = lut.get(w)
                if j is not None:
                    rows.append(i)
                    cols.append(j)
            min_tf[i] = p.min_tf if p.min_tf >= 1.0 else p.min_tf * max(len(ts), 1)
        counts = _counts(table, rows, cols, len(self.vocabulary))
        thr = torch.from_numpy(min_tf).to(counts.device)
        counts = torch.where(counts.to(torch.float64) < thr[:, None], 0.0, counts)
        if p.binary:
            counts = (counts > 0).to(torch.float32)
        names = [f"{p.output_prefix}_{w}" for w in self.vocabulary]
        return _append_x(table, names, counts)


def _live(table: TorchTable, n: int) -> np.ndarray:
    return table.W[:n].cpu().numpy() > 0


class CountVectorizer(Estimator):
    ParamsCls = CountVectorizerParams
    params: CountVectorizerParams

    def _fit(self, table: TorchTable) -> CountVectorizerModel:
        p = self.params
        toks = _meta_col(table, p.input_col)
        live = _live(table, len(toks))
        tf: dict[str, float] = {}
        df: dict[str, int] = {}
        n_docs = 0
        for i, ts in enumerate(toks):
            if not live[i]:
                continue
            n_docs += 1
            ts = _tokens(ts)
            for w in ts:
                tf[w] = tf.get(w, 0.0) + 1.0
            for w in set(ts):
                df[w] = df.get(w, 0) + 1
        min_df = p.min_df if p.min_df >= 1.0 else p.min_df * max(n_docs, 1)
        eligible = [w for w in tf if df[w] >= min_df]
        # MLlib: the vocabulary by corpus term frequency, capped
        eligible.sort(key=lambda w: (-tf[w], w))
        return CountVectorizerModel(p, eligible[: p.vocab_size])


@dataclasses.dataclass(frozen=True)
class IDFParams(Params):
    input_cols: tuple = ()   # term-count attribute names; () => all attributes
    min_doc_freq: int = 0    # MLlib minDocFreq


class IDFModel(Model):
    def __init__(self, params, idf, col_idx):
        self.params = params
        self.idf = idf          # f32[m] per-term idf weights
        self.col_idx = col_idx  # i64[m] attribute indices scaled in place

    @property
    def state_pytree(self):
        return {"idf": self.idf}

    def transform(self, table: TorchTable) -> TorchTable:
        X = table.X.clone()
        X[:, self.col_idx] = X[:, self.col_idx] * self.idf[None, :]
        return table.with_X(X, table.domain)


class IDF(Estimator):
    """idf = log((n_docs + 1) / (df + 1)), MLlib's smoothed formula; the
    document frequencies are one masked column reduction on the device."""

    ParamsCls = IDFParams
    params: IDFParams

    def _fit(self, table: TorchTable) -> IDFModel:
        p = self.params
        names = [v.name for v in table.domain.attributes]
        cols = list(p.input_cols) if p.input_cols else names
        idx = torch.tensor([names.index(c) for c in cols], dtype=torch.int64,
                           device=table.X.device)
        X, W = table.X, table.W
        sub = X.index_select(1, idx)
        df = ((sub > 0) & (W[:, None] > 0)).to(torch.float32).sum(dim=0)
        n_docs = (W > 0).to(torch.float32).sum()
        idf = prng._xla_log((n_docs + 1.0) / (df + 1.0))
        idf = torch.where(df >= p.min_doc_freq, idf, 0.0)
        return IDFModel(p, idf, idx)


# ----------------------------------------------------------------- Word2Vec
@dataclasses.dataclass(frozen=True)
class Word2VecParams(Params):
    input_col: str = "tokens"
    output_prefix: str = "w2v"
    vector_size: int = 100    # MLlib vectorSize
    min_count: int = 5        # MLlib minCount
    window_size: int = 5      # MLlib windowSize
    max_iter: int = 1         # MLlib maxIter (epochs)
    step_size: float = 0.025  # MLlib stepSize
    negative: int = 5         # negative samples per pair
    max_pairs: int = 1 << 20  # cap on (center, context) pairs per epoch
    seed: int = 0


class Word2VecModel(Model):
    def __init__(self, params, vocabulary, vectors):
        self.params = params
        self.vocabulary = tuple(vocabulary)
        self.vectors = vectors  # f32[V, D]
        self._lut = {w: i for i, w in enumerate(self.vocabulary)}

    @property
    def state_pytree(self):
        return {"vectors": self.vectors}

    def get_vectors(self) -> np.ndarray:
        return self.vectors.cpu().numpy()

    def find_synonyms(self, word: str, num: int = 5):
        """MLlib findSynonyms: the most cosine-similar vocabulary words."""
        if word not in self._lut:
            raise ValueError(f"word {word!r} not in vocabulary")
        V = self.get_vectors()
        q = V[self._lut[word]]
        sims = V @ q / (np.linalg.norm(V, axis=1) * np.linalg.norm(q) + 1e-12)
        order = np.argsort(sims)[::-1]
        out = [(self.vocabulary[i], float(sims[i])) for i in order
               if self.vocabulary[i] != word]
        return out[:num]

    def transform(self, table: TorchTable) -> TorchTable:
        """Doc vector = mean of its words' vectors (MLlib's doc embedding)."""
        p = self.params
        toks = _meta_col(table, p.input_col)
        V = self.get_vectors()
        out = np.zeros((len(toks), p.vector_size), dtype=np.float32)
        for i, ts in enumerate(toks):
            ids = [self._lut[w] for w in _tokens(ts) if w in self._lut]
            if ids:
                out[i] = V[ids].mean(axis=0)
        names = [f"{p.output_prefix}_{j}" for j in range(p.vector_size)]
        return _append_x(table, names, out)


def skipgram_pairs(docs, lut, window_size: int, max_pairs: int, rng):
    """The reference's (center, context) pairs in its order, with its numpy
    draws: a window in [1, window_size] a center word (one vectorised draw
    gives the same numbers, and leaves the generator where the reference's
    word-by-word draws do), every other in-vocabulary word of the document
    within it in position order, then ``max_pairs`` of them without
    replacement when there are more. Vectorised over the corpus."""
    ids = [np.fromiter((lut[w] for w in ts if w in lut), dtype=np.int64) for ts in docs]
    lens = np.array([len(a) for a in ids], dtype=np.int64)
    flat = np.concatenate(ids) if len(ids) else np.zeros(0, np.int64)
    n = flat.shape[0]
    win = rng.integers(1, window_size + 1, size=n) if n else np.zeros(0, np.int64)
    start = np.repeat(np.cumsum(lens) - lens, lens)           # each word's document start
    pos = np.arange(n, dtype=np.int64) - start
    lo = start + np.maximum(0, pos - win)
    hi = start + np.minimum(np.repeat(lens, lens), pos + win + 1)
    span = hi - lo
    total = int(span.sum())
    if total - n <= 0:
        raise ValueError("no (center, context) pairs — docs too short?")
    owner = np.repeat(np.arange(n), span)
    k = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(span) - span, span) + lo[owner]
    keep = k != owner
    centers = flat[owner[keep]].astype(np.int32)
    contexts = flat[k[keep]].astype(np.int32)
    if len(centers) > max_pairs:
        sel = rng.choice(len(centers), max_pairs, replace=False)
        centers, contexts = centers[sel], contexts[sel]
    return centers, contexts


class SkipGramStep:
    """One full-batch skip-gram negative-sampling step of the reference's
    ``_sgns_epoch``: loss -mean(log σ(v_c·u_o) + Σ_n log σ(-v_c·u_n)), its
    gradient written out, and ``E - step_size · grad`` on both tables. The
    scatter of the per-pair gradient rows into the tables is a stable sort
    of the ids and ``segment_sum_sorted`` (the centers' order is fixed for
    the fit)."""

    def __init__(self, centers: torch.Tensor, contexts: torch.Tensor, logits: torch.Tensor,
                 V: int, negative: int, step_size: float):
        self.centers, self.contexts = centers.to(torch.int64), contexts.to(torch.int64)
        self.logits, self.V, self.negative = logits, V, negative
        self.step_size = float(np.float32(step_size))
        self.c_sorted, self.c_order = torch.sort(self.centers, stable=True)
        self.inv_p = float(np.float32(1.0) / np.float32(centers.shape[0]))

    def __call__(self, E_in: torch.Tensor, E_out: torch.Tensor, key):
        P, D, neg = self.centers.shape[0], E_in.shape[1], self.negative
        vc = E_in.index_select(0, self.centers)                            # [P, D]
        uo = E_out.index_select(0, self.contexts)                          # [P, D]
        negs = prng.categorical(key, self.logits, shape=(P, neg)).to(torch.int64)
        un = E_out.index_select(0, negs.reshape(-1)).reshape(P, neg, D)
        s = (vc * uo).sum(dim=1)
        t = (vc[:, None, :] * un).sum(dim=2)
        ds = -torch.sigmoid(-s) * self.inv_p                               # d loss / d s
        dt = torch.sigmoid(t) * self.inv_p                                 # d loss / d t
        g_vc = ds[:, None] * uo + (dt[:, :, None] * un).sum(dim=1)
        g_out = torch.cat([ds[:, None] * vc,
                           (dt[:, :, None] * vc[:, None, :]).reshape(P * neg, D)])
        g_in = segment_sum_sorted(g_vc.index_select(0, self.c_order).contiguous(),
                                  self.c_sorted, self.V)
        ids, order = torch.sort(torch.cat([self.contexts, negs.reshape(-1)]), stable=True)
        g_o = segment_sum_sorted(g_out.index_select(0, order).contiguous(), ids, self.V)
        return E_in - self.step_size * g_in, E_out - self.step_size * g_o


class Word2Vec(Estimator):
    ParamsCls = Word2VecParams
    params: Word2VecParams

    def _fit(self, table: TorchTable) -> Word2VecModel:
        p = self.params
        toks = _meta_col(table, p.input_col)
        live = _live(table, len(toks))
        counts: dict[str, int] = {}
        docs = []
        for i, ts in enumerate(toks):
            if not live[i]:
                continue
            ts = _tokens(ts)
            docs.append(ts)
            for w in ts:
                counts[w] = counts.get(w, 0) + 1
        vocab = sorted((w for w, c in counts.items() if c >= p.min_count),
                       key=lambda w: (-counts[w], w))
        if not vocab:
            raise ValueError(f"no words with count >= min_count={p.min_count}")
        lut = {w: i for i, w in enumerate(vocab)}
        rng = np.random.default_rng(p.seed)
        centers, contexts = skipgram_pairs(docs, lut, p.window_size, p.max_pairs, rng)
        dev = table.X.device
        # unigram^0.75 negative-sampling distribution (word2vec's)
        freq = np.asarray([counts[w] for w in vocab], dtype=np.float64) ** 0.75
        probs = torch.from_numpy((freq / freq.sum()).astype(np.float32)).to(dev)
        V, D = len(vocab), p.vector_size
        key = prng.PRNGKey(p.seed)
        key, k1 = prng.split(key)
        E_in = (prng.uniform(k1, (V, D), dev) - 0.5) / D
        E_out = torch.zeros((V, D), dtype=torch.float32, device=dev)
        step = SkipGramStep(torch.from_numpy(centers).to(dev),
                            torch.from_numpy(contexts).to(dev),
                            prng._xla_log(probs), V, p.negative, p.step_size)
        # several full-batch steps an "epoch", as the reference
        for _ in range(max(p.max_iter * 10, 10)):
            key, sub = prng.split(key)
            E_in, E_out = step(E_in, E_out, sub)
        return Word2VecModel(p, vocab, E_in)
