"""The port's text pipeline (``models/text.py``) against the JAX package's,
on the same seeded corpus (a hundred short documents), its widgets, and
``prng.categorical`` with a shape against ``jax.random.categorical``.

Tolerances, with their reasons:

- Tokens, stop words, n-grams, hashed indices, term counts and the
  vocabularies are host string work in both packages: equal.
- IDF: the document frequencies are exact counts and the log is XLA's
  form (``prng._xla_log``): bitwise.
- ``categorical(shape=)``: JAX's threefry words, uniform and gumbel
  arithmetic: bitwise, also for a draw whose flat index passes 2^32
  (compared by its rows).
- Word2Vec: the same pairs, initial table and negatives (bitwise); the
  gradient is written out where the reference takes it by autodiff, and
  the table sums run in another float32 order, so the vectors agree within
  atol 1e-6 (the table's entries are about 5e-3) after ten steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.models import text as JT
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.models import text as TT
from orange3_spark_tpu_torch.ops import prng
from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY

from _port_parity import assert_port_equal, to_np
from _torch_tables import table_pair

WORDS = np.array(["the", "a", "of", "data", "model", "tree", "spark", "tpu", "graph", "row",
                  "table", "fit", "is", "and", "zone", "fare", "trip", "text", "word", "vec"])


@pytest.fixture(scope="module")
def jsess():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession("cpu")


def corpus(n=100, seed=0):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    docs = [" ".join(WORDS[rng.choice(len(WORDS), rng.integers(3, 25), p=p)]).title()
            for _ in range(n)]
    return np.array(docs, dtype=object)[:, None]


@pytest.fixture(scope="module")
def docs(jsess, tsess):
    text = corpus()
    W = np.ones(len(text), np.float32)
    W[::9] = 0.0
    X = np.zeros((len(text), 1), np.float32)
    return table_pair(jsess, tsess, [("x", None)], X, W=W, metas=text, meta_names=("text",))


def _chain(mod, table, stages):
    for st in stages:
        table = st(mod).transform(table)
    return table


STRING_STAGES = [lambda m: m.Tokenizer(),
                 lambda m: m.RegexTokenizer(pattern=r"[a-z]+", gaps=False, output_col="rx",
                                            min_token_length=2),
                 lambda m: m.StopWordsRemover(),
                 lambda m: m.NGram(input_col="filtered", output_col="bigrams"),
                 lambda m: m.HashingTF(input_col="bigrams", num_features=64)]


def test_string_stages_and_hashing(docs):
    jt, tt = docs
    ref, got = _chain(JT, jt, STRING_STAGES), _chain(TT, tt, STRING_STAGES)
    assert [v.name for v in got.domain.metas] == [v.name for v in ref.domain.metas]
    for j in range(got.metas.shape[1]):
        assert list(got.metas[:, j]) == list(np.asarray(ref.metas)[:, j])
    assert np.array_equal(to_np(ref.X), got.X.numpy())


@pytest.mark.parametrize("kw", [dict(vocab_size=12), dict(vocab_size=50, min_df=0.1, min_tf=2.0),
                                dict(binary=True)])
def test_count_vectorizer_then_idf(docs, kw):
    jt, tt = (m.Tokenizer().transform(t) for m, t in zip((JT, TT), docs))
    jm, tm = JT.CountVectorizer(**kw).fit(jt), TT.CountVectorizer(**kw).fit(tt)
    assert jm.vocabulary == tm.vocabulary
    jc, tc = jm.transform(jt), tm.transform(tt)
    assert np.array_equal(to_np(jc.X), tc.X.numpy())
    cols = tuple(v.name for v in tc.domain.attributes[1:])
    ji, ti = JT.IDF(input_cols=cols, min_doc_freq=2).fit(jc), TT.IDF(input_cols=cols,
                                                                    min_doc_freq=2).fit(tc)
    assert np.array_equal(to_np(ji.idf), ti.idf.numpy())
    assert np.array_equal(to_np(ji.transform(jc).X), ti.transform(tc).X.numpy())


@pytest.mark.parametrize("shape,V", [((300, 5), 1000), ((70,), 33), ((2, 3, 4), 7)])
def test_categorical_with_a_shape_is_bitwise_jax(shape, V):
    rng = np.random.default_rng(V)
    p = rng.random(V).astype(np.float32)
    p[3] = 0.0                                  # a -inf logit
    p /= p.sum()
    lj = jnp.log(jnp.asarray(p))
    lt = prng._xla_log(torch.from_numpy(p))
    assert np.array_equal(np.asarray(lj), lt.numpy())
    key = jax.random.PRNGKey(V)
    ref = np.asarray(jax.random.categorical(key, lj[None, :], shape=shape))
    got = prng.categorical(prng.PRNGKey(V), lt[None, :], shape=shape).numpy()
    assert got.dtype == np.int32 and np.array_equal(ref, got)
    got1 = prng.categorical(prng.PRNGKey(V), lt, shape=shape).numpy()
    assert np.array_equal(got, got1)


def test_categorical_past_two_to_the_32():
    """A draw whose flat index passes 2^32 (rows x V > 2^32) is too large to
    hold, so windows of its rows around 2^32 are compared: JAX's own words
    at those flat indices (its threefry primitive on the hi and lo counter
    words, as ``jax.random`` forms them), its uniform, log and argmax under
    jit, against the port's plain version of the same rows."""
    from jax._src import prng as jprng

    V = 50_000
    rng = np.random.default_rng(1)
    p = rng.random(V).astype(np.float32)
    p /= p.sum()
    lj = jnp.log(jnp.asarray(p))
    lt = prng._xla_log(torch.from_numpy(p))
    tiny = jnp.float32(np.finfo(np.float32).tiny)
    k = jax.random.PRNGKey(7)

    @jax.jit
    def rows_of(hi, lo):
        b0, b1 = jprng.threefry2x32_p.bind(k[0], k[1], hi, lo)
        f = jax.lax.bitcast_convert_type((b0 ^ b1) >> 9 | jnp.uint32(0x3F800000),
                                         jnp.float32) - 1.0
        u = jnp.maximum(tiny, f * (jnp.float32(1.0) - tiny) + tiny)
        return jnp.argmax(-jnp.log(-jnp.log(u)).reshape(-1, V) + lj, axis=1)

    for r0 in (0, 85_897, 171_797):       # 85,899.35 · V = 2^32; 171,798.7 · V = 2^33
        i = np.arange(r0 * V, (r0 + 4) * V, dtype=np.uint64)
        ref = np.asarray(rows_of(jnp.asarray((i >> np.uint64(32)).astype(np.uint32)),
                                 jnp.asarray((i & np.uint64(0xFFFFFFFF)).astype(np.uint32))))
        got = prng.categorical_gumbel_reference(prng.PRNGKey(7), lt, 4, first_row=r0).numpy()
        assert np.array_equal(ref, got), r0
    full = np.asarray(jax.random.categorical(k, lj, shape=(4,)))
    assert np.array_equal(full, prng.categorical(prng.PRNGKey(7), lt, shape=(4,)).numpy())


@pytest.mark.parametrize("kw", [dict(vector_size=8, min_count=2, window_size=2, max_pairs=512,
                                     seed=3),
                                dict(vector_size=6, min_count=1, window_size=3, max_iter=2,
                                     negative=3)])
def test_word2vec(docs, kw):
    jt, tt = (m.Tokenizer().transform(t) for m, t in zip((JT, TT), docs))
    jm, tm = JT.Word2Vec(**kw).fit(jt), TT.Word2Vec(**kw).fit(tt)
    assert jm.vocabulary == tm.vocabulary
    assert_port_equal(to_np(jm.vectors), tm.vectors.numpy(), atol=1e-6, what="vectors")
    word = jm.vocabulary[0]
    assert [w for w, _ in jm.find_synonyms(word, 3)] == [w for w, _ in tm.find_synonyms(word, 3)]
    assert_port_equal(to_np(jm.transform(jt).X), tm.transform(tt).X.numpy(), atol=1e-6)


def test_word2vec_first_step_draws_the_reference_negatives(docs):
    """The first step's negatives are the reference's draw bitwise."""
    _, tt = docs
    key = prng.split(prng.split(prng.PRNGKey(0))[0])[1]
    logits = prng._xla_log(torch.tensor([0.5, 0.25, 0.25]))
    ref = np.asarray(jax.random.categorical(jnp.asarray(np.array(key, np.uint32)),
                                            jnp.log(jnp.asarray([0.5, 0.25, 0.25],
                                                                jnp.float32))[None, :],
                                            shape=(40, 5)))
    assert np.array_equal(ref, prng.categorical(key, logits[None, :], shape=(40, 5)).numpy())


@pytest.mark.parametrize("name", ["OWTokenizer", "OWRegexTokenizer", "OWStopWordsRemover",
                                  "OWNGram", "OWHashingTF", "OWCountVectorizer", "OWIDF",
                                  "OWWord2Vec"])
def test_text_widgets_registered(name):
    assert name in WIDGET_REGISTRY
