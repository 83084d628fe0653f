"""libsvm input and the value-weighted hashed fit, the port against the JAX
package on the CPU and the same numpy inputs: ``read_libsvm``,
``write_libsvm`` and ``libsvm_chunk_source`` bitwise; value-weighted fits
for every ``emb_update`` x rule x lowering; the hashed estimator's other
options that the port now runs (``missing='keep'``,
``compute_dtype='bfloat16'``); a value-weighted model carried across by
``interop``.

Fits are compared as ``tests/test_torch_hashed.py`` compares them: theta
within atol 1e-6, rtol 1e-5 (float32 rounding of XLA's fused sums and
products against PyTorch's; the segment sums add in the same order;
'per_column' sums the table gradient column by column, where XLA adds the
C columns' scatters in an order of its own, within that tolerance too).
Under ``compute_dtype='bfloat16'`` too: the dense rules' gradients are
bf16 in both packages, summed in the same order.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core.domain import ContinuousVariable as JVar
from orange3_spark_tpu.core.domain import Domain as JDomain
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.core.table import TpuTable
from orange3_spark_tpu.io import libsvm as jlib
from orange3_spark_tpu.io.streaming import array_chunk_source as j_array_source
from orange3_spark_tpu.models.hashed_linear import (
    StreamingHashedLinearEstimator as JEstimator,
)
from orange3_spark_tpu_torch import TorchSession, interop
from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.io import libsvm as tlib
from orange3_spark_tpu_torch.io.streaming import array_chunk_source
from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
from orange3_spark_tpu_torch.resilience.numerics import NumericalDivergenceError

ATOL, RTOL = 1e-6, 1e-5
NNZ = 5
VW = dict(n_dims=1 << 12, n_dense=0, n_cat=NNZ, value_weighted=True, epochs=3,
          step_size=0.05, chunk_rows=512)


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def cpu():
    return TorchSession("cpu")


# ------------------------------------------------------------------ files

LINES = [
    "1 3:0.5 7:1.25 10:2  # a comment",
    "",
    "0 1:1e-3 2:-4.5",
    "1",
    "0 4:3 5:0.125 6:1 8:2 9:0.3 11:7 12:1.5  ",
    "# only a comment",
    "2.5 2:1 16777217:3",
]


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("n_features", [None, 20])
def test_read_libsvm_bitwise(tmp_path, cpu, jax_session, n_features):
    path = _write(tmp_path / "a.svm", LINES[:-1] + ["1 2:1 21:3"])
    kw = dict(n_features=n_features)
    if n_features == 20:
        with pytest.raises(ValueError, match="exceeds n_features=20"):
            tlib.read_libsvm(path, session=cpu, **kw)
        with pytest.raises(ValueError, match="exceeds n_features=20"):
            jlib.read_libsvm(path, session=jax_session, **kw)
        kw["n_features"] = 21
    X, Y, _ = tlib.read_libsvm(path, session=cpu, **kw).to_numpy()
    Xr, Yr, _ = jlib.read_libsvm(path, session=jax_session, **kw).to_numpy()
    assert X.dtype == Xr.dtype and np.array_equal(X, Xr)
    assert np.array_equal(Y, Yr)
    zb = _write(tmp_path / "z.svm", ["1 0:2 3:1", "0 1:5"])
    assert np.array_equal(tlib.read_libsvm(zb, zero_based=True, session=cpu).to_numpy()[0],
                          jlib.read_libsvm(zb, zero_based=True,
                                           session=jax_session).to_numpy()[0])
    with pytest.raises(ValueError, match="zero_based=True"):
        tlib.read_libsvm(zb, session=cpu)


def test_write_libsvm_same_text(tmp_path, cpu, jax_session):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((30, 6)).astype(np.float32)
    X[rng.random(X.shape) < 0.5] = 0.0
    y = rng.integers(0, 3, 30).astype(np.float32)
    W = np.ones(30, np.float32)
    W[4] = 0.0                                  # a dead row is not written
    attrs = [f"f{i}" for i in range(6)]
    ours = TorchTable.from_numpy(Domain([ContinuousVariable(a) for a in attrs],
                                        ContinuousVariable("label")), X, y, W=W, session=cpu)
    ref = TpuTable.from_numpy(JDomain([JVar(a) for a in attrs], JVar("label")), X, y, W=W,
                              session=jax_session)
    for zero_based in (False, True):
        a, b = tmp_path / f"t{zero_based}.svm", tmp_path / f"r{zero_based}.svm"
        tlib.write_libsvm(ours, str(a), zero_based=zero_based)
        jlib.write_libsvm(ref, str(b), zero_based=zero_based)
        assert a.read_text() == b.read_text()
    back = tlib.read_libsvm(str(tmp_path / "tFalse.svm"), n_features=6, session=cpu)
    assert np.array_equal(back.to_numpy()[0], np.delete(X, 4, axis=0))


@pytest.mark.parametrize("nnz,chunk_rows", [(3, 2), (8, 4), (1, 100)])
def test_libsvm_chunk_source_bitwise(tmp_path, nnz, chunk_rows):
    """Fixed-nnz chunks: padding (-1, 0), truncation to the first pairs,
    comments and blank lines, chunks across read batches."""
    rng = np.random.default_rng(2)
    lines = LINES[:-1] * 3
    for _ in range(40):
        k = int(rng.integers(0, 12))
        idx = np.sort(rng.choice(1000, k, replace=False)) + 1
        lines.append(f"{rng.integers(0, 2)} " + " ".join(
            f"{i}:{v:.7g}" for i, v in zip(idx, rng.random(k) * 2)))
    path = _write(tmp_path / "c.svm", lines)
    kw = dict(nnz_per_row=nnz, chunk_rows=chunk_rows)
    ours = list(tlib.libsvm_chunk_source(path, **kw)())
    ref = list(jlib.libsvm_chunk_source(path, **kw)())
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_libsvm_errors_match_reference(tmp_path):
    big = _write(tmp_path / "big.svm", LINES)        # index 2^24 on the last line
    for lib in (tlib, jlib):
        with pytest.raises(ValueError, match=">= 2\\^24"):
            list(lib.libsvm_chunk_source(big, nnz_per_row=4)())
        with pytest.raises(ValueError, match="nnz_per_row"):
            lib.libsvm_chunk_source(big, nnz_per_row=0)
    bad = _write(tmp_path / "bad.svm", ["1 0:1"])
    for lib in (tlib, jlib):
        with pytest.raises(ValueError, match="index < 1"):
            list(lib.libsvm_chunk_source(bad, nnz_per_row=2)())
    odd = _write(tmp_path / "odd.svm", ["1 2:x1"])    # a malformed value
    for lib in (tlib, jlib):
        with pytest.raises(ValueError):
            list(lib.libsvm_chunk_source(odd, nnz_per_row=2)())
    lab, cnt, idx, val = tlib._parse_flat(["1 2:0.5 3:1", "0 1:2.5"], False)
    labels, rows = jlib._parse_lines(["1 2:0.5 3:1", "0 1:2.5"], False)
    assert lab.tolist() == labels and cnt.tolist() == [len(i) for i, _ in rows]
    assert np.array_equal(idx, np.concatenate([i for i, _ in rows]))
    assert np.array_equal(val, np.concatenate([v for _, v in rows]))


# ------------------------------------------------------------ value-weighted fits

@pytest.fixture(scope="module")
def vw_data():
    """[idx..., val...] pair chunks: Zipf-ish indices below 300, a few -1
    pads (value 0), values in (0, 2]; labels from per-feature effects."""
    rng = np.random.default_rng(11)
    n = 1800
    idx = np.minimum(rng.zipf(1.3, (n, NNZ)) - 1, 299).astype(np.float32)
    vals = rng.uniform(0.0, 2.0, (n, NNZ)).astype(np.float32) + np.float32(1e-3)
    pad = rng.random((n, NNZ)) < 0.15
    idx[pad], vals[pad] = -1.0, 0.0
    eff = rng.normal(0, 1.0, 300)
    logit = np.where(pad, 0.0, eff[np.maximum(idx, 0).astype(int)] * vals).sum(1)
    y = (logit + 0.3 * rng.standard_normal(n) > 0).astype(np.float32)
    return np.concatenate([idx, vals], axis=1), y


def _theta(model):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in model.theta.items()}


def _fit_pair(jax_session, cpu, X, y, base=VW, **kw):
    ours = StreamingHashedLinearEstimator(**{**base, **kw}).fit_stream(
        array_chunk_source(X, y, chunk_rows=500), session=cpu, cache_device=True)
    ref = JEstimator(**{**base, **kw}, fused_replay=False).fit_stream(
        j_array_source(X, y, chunk_rows=500), session=jax_session, cache_device=True)
    return ours, ref


def _close(ours, ref, *, rtol=RTOL, atol=ATOL):
    got, want = _theta(ours), _theta(ref)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=rtol, err_msg=name)
    assert np.abs(got["emb"]).max() > 1e-3            # the table really trained


_VW_CASES = ([(emb, rule, "auto") for emb in ("fused", "per_column", "sorted")
              for rule in ("adam", "dense_adagrad")]
             + [("fused", "sparse_adagrad", low) for low in ("plan", "sort")]
             + [("per_column", "sparse_sgd", "plan"), ("sorted", "sparse_ftrl", "sort")])


@pytest.mark.parametrize("emb_update,rule,lowering", _VW_CASES)
def test_value_weighted_fit_matches_reference(jax_session, cpu, vw_data, emb_update, rule,
                                              lowering):
    """Every emb_update with 'adam' and a dense twin (the lowering shapes
    their forward and table gradient), and the sparse rules on both
    lowerings (they take the fused forward whatever emb_update says): the
    -1 pads dead, each occurrence's gradient times its value."""
    X, y = vw_data
    kw = dict(emb_update=emb_update, optim_update=rule, sparse_lowering=lowering,
              reg_param=1e-3, l1_param=1e-4 if rule.endswith("ftrl") else 0.0)
    ours, ref = _fit_pair(jax_session, cpu, X, y, **kw)
    _close(ours, ref)
    assert ours.n_steps_ == ref.n_steps_ == 12


def test_value_weighted_libsvm_pipeline_and_interop(jax_session, cpu, tmp_path, vw_data):
    """libsvm file -> libsvm_chunk_source -> value-weighted fit with the
    label in the chunk, in both packages; the reference's model through
    ``interop.hashed_linear_model`` (one salt a model) gives its logits;
    the same pair in another slot gives the same logit."""
    X, y = vw_data
    lines = []
    for r in range(len(y)):
        live = X[r, :NNZ] >= 0
        pairs = sorted(zip(X[r, :NNZ][live].astype(int) + 1, X[r, NNZ:][live]))
        lines.append(f"{y[r]:.0f} " + " ".join(f"{i}:{v:.9g}" for i, v in pairs))
    path = _write(tmp_path / "vw.svm", lines)
    kw = dict(VW, label_in_chunk=True, optim_update="sparse_adagrad", reg_param=1e-4)
    ours = StreamingHashedLinearEstimator(**kw).fit_stream(
        tlib.libsvm_chunk_source(path, nnz_per_row=NNZ, chunk_rows=500), session=cpu,
        cache_device=True)
    ref = JEstimator(**kw, fused_replay=False).fit_stream(
        jlib.libsvm_chunk_source(path, nnz_per_row=NNZ, chunk_rows=500),
        session=jax_session, cache_device=True)
    _close(ours, ref)
    conv = interop.hashed_linear_model({k: np.asarray(v) for k, v in ref.state_pytree.items()},
                                       ref.params.to_dict(), ref.class_values, device="cpu")
    rows = X[:64]
    np.testing.assert_allclose(conv._logits(rows), ref._logits(rows), rtol=1e-5, atol=1e-6)
    assert np.array_equal(conv.predict(rows), ref.predict(rows))
    a = np.array([[7, -1, -1, -1, -1, 2.0, 0, 0, 0, 0]], np.float32)
    b = np.array([[-1, -1, 7, -1, -1, 0, 0, 2.0, 0, 0]], np.float32)
    assert np.array_equal(ours._logits(a), ours._logits(b))
    with pytest.raises(ValueError, match="pair chunks"):
        StreamingHashedLinearEstimator(**kw).fit(
            TorchTable.from_arrays(X, y, session=cpu))
    with pytest.raises(ValueError, match="n_dense must be 0"):
        StreamingHashedLinearEstimator(**{**kw, "n_dense": 2}).fit_stream(
            tlib.libsvm_chunk_source(path, nnz_per_row=NNZ), session=cpu)


# --------------------------------------------------- the other options

def _criteo_shaped(n=2000, n_dense=3, n_cat=4, card=40, seed=3):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, n_dense)).astype(np.float32)
    cats = rng.integers(0, card, size=(n, n_cat)).astype(np.float32)
    effects = rng.normal(0, 1.2, size=(n_cat, card))
    logit = dense[:, 0] + sum(effects[j, cats[:, j].astype(int)] for j in range(n_cat))
    y = (logit + 0.3 * rng.standard_normal(n) > 0).astype(np.float32)
    return np.concatenate([dense, cats], axis=1), y


HASHED = dict(n_dims=1 << 12, n_dense=3, n_cat=4, epochs=3, step_size=0.05, chunk_rows=512)


@pytest.mark.parametrize("lowering", ["sort", "plan"])
def test_missing_keep(jax_session, cpu, lowering):
    """'keep': NaN categorical codes hash as code 0 (XLA's conversion in the
    reference's device hash), so a fit over them equals the reference's
    'sort' fit on both of the port's lowerings; a NaN dense cell reaches the
    loss and the fit raises ``NumericalDivergenceError``."""
    X, y = _criteo_shaped()
    Xn = X.copy()
    Xn[::7, 4] = np.nan
    kw = dict(missing="keep", optim_update="sparse_adagrad", reg_param=1e-3)
    ours = StreamingHashedLinearEstimator(**HASHED, **kw, sparse_lowering=lowering).fit_stream(
        array_chunk_source(Xn, y, chunk_rows=500), session=cpu, cache_device=True)
    ref = JEstimator(**HASHED, **kw, sparse_lowering="sort", fused_replay=False).fit_stream(
        j_array_source(Xn, y, chunk_rows=500), session=jax_session, cache_device=True)
    _close(ours, ref)
    zero = StreamingHashedLinearEstimator(**HASHED, **dict(kw, missing="zero"),
                                          sparse_lowering=lowering).fit_stream(
        array_chunk_source(Xn, y, chunk_rows=500), session=cpu, cache_device=True)
    assert all(np.array_equal(u, v) for u, v in zip(_theta(ours).values(),
                                                     _theta(zero).values()))
    Xd = X.copy()
    Xd[10, 0] = np.nan
    with pytest.raises(NumericalDivergenceError):
        StreamingHashedLinearEstimator(**HASHED, **kw, sparse_lowering=lowering).fit_stream(
            array_chunk_source(Xd, y, chunk_rows=500), session=cpu, cache_device=True)


_BF16_CASES = [("fused", "adam", False), ("per_column", "adam", False),
               ("sorted", "dense_adagrad", False), ("per_column", "dense_adagrad", False),
               ("fused", "sparse_adagrad", False), ("per_column", "adam", True),
               ("sorted", "dense_adagrad", True)]


@pytest.mark.parametrize("emb_update,rule,pairs", _BF16_CASES)
def test_compute_dtype_bfloat16(jax_session, cpu, vw_data, emb_update, rule, pairs):
    """The step's operands rounded to bf16, products and sums in float32;
    'adam' and the dense twins differentiate through the rounded copies as
    the reference does (the coefficients' gradient rounded to bf16, the
    table's summed in bf16): every rule within the usual tolerance of the
    reference, on Criteo-shaped rows and on value-weighted pairs. The
    control: the port's float32 fit lies outside that tolerance of the
    reference's bf16 fit, so the comparison sees the compute dtype."""
    if pairs:
        X, y = vw_data
        base = VW
    else:
        X, y = _criteo_shaped()
        base = HASHED
    kw = dict(emb_update=emb_update, optim_update=rule, reg_param=1e-3)
    ours, ref = _fit_pair(jax_session, cpu, X, y, base=base, compute_dtype="bfloat16", **kw)
    _close(ours, ref)
    f32 = StreamingHashedLinearEstimator(**base, **kw).fit_stream(
        array_chunk_source(X, y, chunk_rows=500), session=cpu, cache_device=True)
    got, want = _theta(f32), _theta(ref)
    assert not all(np.allclose(got[n], want[n], atol=ATOL, rtol=RTOL) for n in want)


def test_hash_converts_codes_as_the_reference_device(cpu):
    """NaN and out-of-range float codes hash as XLA converts them on the
    reference's device (NaN -> 0, saturating), on the CPU too."""
    import jax.numpy as jnp

    from orange3_spark_tpu.ops import hashing as jhash
    from orange3_spark_tpu_torch.ops import hashing as thash

    codes = np.array([[np.nan, -1.0, 3e9, -3e9, np.inf, -np.inf, 5.7, -5.7]], np.float32)
    salts = thash.column_salts(8, seed=2)
    want = np.asarray(jhash.hash_columns(jnp.asarray(codes), salts, 1 << 20))
    got = thash.hash_columns(torch.from_numpy(codes), salts, 1 << 20).numpy()
    assert np.array_equal(got, want)


def test_chip_smoke_bf16_tolerance_sees_the_compute_dtype(cpu):
    """``chip_smoke._bf16_grad_err``, the card's tolerance for fits with
    bf16 gradients: a fit passes against itself and a float32-gradient fit
    fails it (nearly every touched entry past the float32 tolerance)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    X, y = _criteo_shaped()
    kw = dict(emb_update="per_column", optim_update="dense_adagrad", reg_param=1e-3)
    fits = {dt: StreamingHashedLinearEstimator(**HASHED, **kw, compute_dtype=dt).fit_stream(
        array_chunk_source(X, y, chunk_rows=500), session=cpu, cache_device=True)
        for dt in ("float32", "bfloat16")}
    bf16 = fits["bfloat16"]
    line, ok = cs._bf16_grad_err(bf16.theta, bf16.theta, HASHED["step_size"], bf16.n_steps_)
    assert ok and line["max_abs_err"]["emb"] == 0.0
    line, ok = cs._bf16_grad_err(fits["float32"].theta, bf16.theta, HASHED["step_size"],
                                 bf16.n_steps_)
    assert not ok and line["share_past_f32_tolerance"]["emb"] > 0.5, line
