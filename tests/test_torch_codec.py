"""The port's chunk codec, packed plans and disk spill against the JAX
package's, on the CPU and the same numpy inputs: bit packing at every
width (host words equal, device unpack equal), the bfloat16 encode bit for
bit (ties, subnormals, infinities, NaN), the encoded chunk, the codec
resolver, the packed touched-row plan, the cache byte estimate, and spill
files written by the JAX package read by the port record for record.

Everything here is exact: the codec and the spill move bits, so the
comparisons are bitwise.
"""

import json
import os
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_artifacts import artifact_dirs  # noqa: F401
from orange3_spark_tpu.core.session import TpuSession
from orange3_spark_tpu.io import codec as jcodec
from orange3_spark_tpu.io.streaming import DiskChunkCache as JDiskChunkCache
from orange3_spark_tpu.models import hashed_linear as jhl
from orange3_spark_tpu.optim import sparse as jsparse
from orange3_spark_tpu_torch import TorchSession
from orange3_spark_tpu_torch.io import codec as tcodec
from orange3_spark_tpu_torch.io.streaming import DiskChunkCache
from orange3_spark_tpu_torch.models import hashed_linear as thl
from orange3_spark_tpu_torch.ops.hashing import column_salts
from orange3_spark_tpu_torch.optim import sparse as tsparse


def _words_t(words: np.ndarray) -> torch.Tensor:
    """Host u32 words as the device holds them: int32, the same bits."""
    return torch.from_numpy(words.view(np.int32))


# ------------------------------------------------------------ bit packing

@pytest.mark.parametrize("bits", range(1, 32))
def test_pack_rows_every_width(bits):
    """Host words equal the reference's; the device unpack gives the
    values back and equals the reference's unpack (26 columns, so fields
    cross words at most widths)."""
    rng = np.random.default_rng(bits)
    vals = rng.integers(0, 1 << bits, size=(37, 26), dtype=np.int64)
    vals[0] = (1 << bits) - 1                     # every bit set
    words = tcodec.pack_rows_np(vals, bits)
    assert words.dtype == np.uint32
    np.testing.assert_array_equal(words, jcodec.pack_rows_np(vals, bits))
    got = tcodec.unpack_rows(_words_t(words), bits, 26)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), vals)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcodec.unpack_rows(jnp.asarray(words), bits, 26)))


@pytest.mark.parametrize("bits", range(1, 32))
def test_pack_flat_every_width(bits):
    """The plane layout: the same words (and word count) as the
    reference, and the device unpack inverts it; 1000 values leave a
    ragged last group of 32."""
    rng = np.random.default_rng(100 + bits)
    vals = rng.integers(0, 1 << bits, size=1000, dtype=np.int64)
    vals[-1] = (1 << bits) - 1
    words = tcodec.pack_flat_np(vals, bits)
    np.testing.assert_array_equal(words, jcodec.pack_flat_np(vals, bits))
    assert tcodec.flat_words(1000, bits) == jcodec.flat_words(1000, bits) == len(words)
    assert tcodec._planes(bits) == jcodec._planes(bits)
    np.testing.assert_array_equal(tcodec.unpack_flat(_words_t(words), bits, 1000).numpy(),
                                  vals)


def test_pack_rejects_bad_widths_and_bit_width():
    for bits in (0, 32):
        with pytest.raises(ValueError, match="bit width"):
            tcodec.pack_rows_np(np.zeros((2, 2)), bits)
        with pytest.raises(ValueError, match="bit width"):
            tcodec.pack_flat_np(np.zeros(2), bits)
    for n in (1, 2, 3, 1 << 22, (1 << 22) + 1):
        assert tcodec.bit_width(n) == jcodec.bit_width(n)


def test_criteo_width_unpacks_the_hash():
    """22-bit indices × 26 columns (2^22 dims): 18 words a row, and the
    unpacked indices are the hash of the codes, bitwise."""
    from orange3_spark_tpu_torch.ops.hashing import hash_columns_np

    rng = np.random.default_rng(7)
    codes = rng.integers(-(1 << 24), 1 << 24, size=(5000, 26)).astype(np.float32)
    salts = column_salts(26, seed=0)
    idx = hash_columns_np(codes, salts, 1 << 22)
    words = tcodec.pack_rows_np(idx, 22)
    assert words.shape == (5000, 18)
    np.testing.assert_array_equal(tcodec.unpack_rows(_words_t(words), 22, 26).numpy(), idx)


# --------------------------------------------------------------- bfloat16

def _bf16_cases() -> np.ndarray:
    """Ties (both rounding directions), subnormals, the largest finite
    values (which round to infinity), ±inf, NaN of both signs with
    payloads, and random words."""
    words = np.array([
        0x00000000, 0x80000000, 0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001,
        0x00000001, 0x00008000, 0x00018000, 0x807FFFFF, 0x007F8000,
        0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F800000, 0xFF800000,
        0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FBFFFFF, 0xFFFFFFFF,
    ], np.uint32)
    rng = np.random.default_rng(3)
    rand = rng.integers(0, 1 << 32, size=20000, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([words, rand]).view(np.float32)


def test_bf16_encode_bitwise():
    """The host encode equals ml_dtypes' (the reference's) bit for bit.
    NaN is held as the quiet NaN of its sign, 0x7FC0 / 0xFFC0, whatever
    its payload (torch's own float->bfloat16 cast writes other NaN bits,
    which is why the encode works on the bits); the device widen is
    exact."""
    x = _bf16_cases()
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = tcodec.bf16_bits_np(x)
    np.testing.assert_array_equal(got, want)
    nan = np.isnan(x)
    assert set(got[nan].tolist()) == {0x7FC0, 0xFFC0}
    widened = tcodec.bf16_to_f32(torch.from_numpy(got.view(np.int16))).numpy()
    np.testing.assert_array_equal(widened.view(np.uint32),
                                  want.view(ml_dtypes.bfloat16).astype(np.float32)
                                  .view(np.uint32))


def _params(**kw):
    base = dict(n_dims=1 << 12, n_dense=4, n_cat=6, label_in_chunk=True,
                optim_update="sparse_adagrad", cache_dtype="packed")
    base.update(kw)
    return base


@pytest.mark.parametrize("mode", ["bf16", "packed"])
@pytest.mark.parametrize("label_in_chunk", [True, False])
def test_encoded_chunk_bitwise(mode, label_in_chunk):
    """``_encode_chunk_np`` of a padded chunk with NaN cells: every block
    the same bits as the reference's (bf16 as uint16 bits), and the
    device decode gives the reference's decode."""
    rng = np.random.default_rng(11)
    N = 300
    kw = _params(cache_dtype=mode, label_in_chunk=label_in_chunk)
    cols = thl._chunk_cols(thl.HashedLinearParams(**kw))
    Xp = rng.standard_normal((N, cols)).astype(np.float32) * 100
    off = 1 if label_in_chunk else 0
    if label_in_chunk:
        Xp[:, 0] = rng.integers(0, 2, N)
    Xp[:, off + 4:] = rng.integers(-5000, 5000, (N, 6))
    Xp[rng.random((N, cols)) < 0.05] = np.nan
    if label_in_chunk:
        Xp[:, 0] = np.nan_to_num(Xp[:, 0])
    salts = column_salts(6, seed=0)
    tc = thl.resolve_chunk_codec(thl.HashedLinearParams(**kw), TorchSession("cpu"))
    jc = jhl.resolve_chunk_codec(jhl.HashedLinearParams(**kw))
    assert dataclasses_equal(tc, jc)
    ours = thl._encode_chunk_np(tc, Xp, salts)
    ref = jhl._encode_chunk_np(jc, Xp, salts)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        want = np.asarray(ref[k])
        if want.dtype == ml_dtypes.bfloat16:
            want = want.view(np.uint16)
        assert ours[k].dtype == want.dtype and ours[k].tobytes() == want.tobytes(), k
    # the device decode, against the reference's
    enc_t = {k: torch.from_numpy(thl._torch_view(v)) for k, v in ours.items()}
    n_valid = N - 17
    yv = wv = None
    if not label_in_chunk:
        yv = np.ones(N, np.float32)
        wv = (np.arange(N) < n_valid).astype(np.float32)
    got = thl._decode_chunk(tc, enc_t, n_valid,
                            None if yv is None else torch.from_numpy(yv),
                            None if wv is None else torch.from_numpy(wv),
                            thl.salts_tensor(salts, "cpu"))
    want = jhl._decode_chunk(jc, {k: jnp.asarray(v) for k, v in ref.items()},
                             jnp.int32(n_valid), yv, wv, jnp.asarray(salts))
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_label_u8_rejects_soft_labels():
    kw = _params()
    Xp = np.zeros((8, thl._chunk_cols(thl.HashedLinearParams(**kw))), np.float32)
    Xp[3, 0] = 0.5
    salts = column_salts(6)
    with pytest.raises(ValueError, match="u8"):
        thl._encode_chunk_np(
            thl.resolve_chunk_codec(thl.HashedLinearParams(**kw), TorchSession("cpu")),
            Xp, salts)
    with pytest.raises(ValueError, match="u8"):
        jhl._encode_chunk_np(jhl.resolve_chunk_codec(jhl.HashedLinearParams(**kw)),
                             Xp, salts)


@pytest.mark.parametrize("kw", [
    dict(cache_dtype="f32"), dict(cache_dtype="bf16"), dict(cache_dtype="packed"),
    dict(cache_dtype="auto"), dict(cache_dtype="packed", missing="keep"),
    dict(cache_dtype="packed", loss="squared"),
    dict(cache_dtype="packed", loss="logistic", n_classes=300),
    dict(cache_dtype="bf16", label_in_chunk=False)])
def test_resolve_chunk_codec_follows_reference(kw, monkeypatch):
    """The same codec (or None) as the reference's resolver, and the
    ``OTPU_CACHE_DTYPE`` override outranks the parameter."""
    jax_session = TpuSession(TpuSession.default_mesh(jax.devices()[:1]))
    tp, jp = thl.HashedLinearParams(**_params(**kw)), jhl.HashedLinearParams(**_params(**kw))
    assert TorchSession.default_cache_dtype == jax_session.default_cache_dtype == "packed"
    for env in (None, "f32", "bf16"):
        if env is None:
            monkeypatch.delenv("OTPU_CACHE_DTYPE", raising=False)
        else:
            monkeypatch.setenv("OTPU_CACHE_DTYPE", env)
        ours = thl.resolve_chunk_codec(tp, TorchSession("cpu"))
        ref = jhl.resolve_chunk_codec(jp, jax_session)
        assert (ours is None) == (ref is None), env
        if ours is not None:
            assert dataclasses_equal(ours, ref), env
    with tcodec.force_cache_dtype("f32"):
        assert thl.resolve_chunk_codec(tp, TorchSession("cpu")) is None
    assert os.environ["OTPU_CACHE_DTYPE"] == "bf16"     # restored after the arm
    monkeypatch.delenv("OTPU_CACHE_DTYPE")
    with pytest.raises(ValueError, match="cache_dtype"):
        tcodec.resolve_cache_dtype("fp8")


# ------------------------------------------------------------ packed plans

@pytest.mark.parametrize("N,C,D,n_valid", [(64, 3, 128, 50), (256, 6, 1 << 12, 256),
                                           (100, 26, 1 << 22, 7), (40, 4, 1, 40)])
def test_packed_plan_bitwise(N, C, D, n_valid):
    """``pack_plan_np`` gives the reference's words; ``unpack_plan`` gives
    the int32 plan back, equal to the reference's decode."""
    rng = np.random.default_rng(N + C)
    salts = column_salts(C, seed=2)
    cats = rng.integers(0, 300, (N, C)).astype(np.float32)
    plan = tsparse.build_plan_np(cats, salts, D, n_valid)
    ours = tsparse.pack_plan_np(plan, N, C, D)
    ref = jsparse.pack_plan_np(plan, N, C, D)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == np.uint32 and np.array_equal(ours[k], ref[k]), k
    shapes = tsparse.plan_packed_field_shapes(N, C, D)
    assert shapes == jsparse.plan_packed_field_shapes(N, C, D)
    assert all(ours[k].shape == shapes[k][0] for k in ours)
    assert tsparse.plan_pack_widths(N, C, D) == jsparse.plan_pack_widths(N, C, D)
    np.testing.assert_array_equal(tsparse._popcount_u32(ours["segb"]),
                                  jsparse._popcount_u32(ours["segb"]))
    got = tsparse.unpack_plan({k: _words_t(v) for k, v in ours.items()}, N, C, D)
    want = jsparse.unpack_plan({k: jnp.asarray(v) for k, v in ref.items()}, N, C, D)
    for k in plan:
        np.testing.assert_array_equal(got[k].numpy(), plan[k], err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("lowering", ["plan", "sort"])
@pytest.mark.parametrize("cache_dtype", ["f32", "bf16", "packed"])
def test_estimate_cached_chunk_bytes_matches_reference(cache_dtype, lowering):
    jax_session = TpuSession(TpuSession.default_mesh(jax.devices()[:1]))
    kw = _params(cache_dtype=cache_dtype, sparse_lowering=lowering, chunk_rows=1000,
                 n_dims=1 << 14)
    ours = thl.estimate_cached_chunk_bytes(thl.HashedLinearParams(**kw), TorchSession("cpu"))
    ref = jhl.estimate_cached_chunk_bytes(jhl.HashedLinearParams(**kw), jax_session)
    assert ours == ref > 0
    assert thl._raw_chunk_bytes(thl.HashedLinearParams(**kw), 1000, lowering == "plan") == \
        jhl._raw_chunk_bytes(jhl.HashedLinearParams(**kw), 1000, lowering == "plan")


# -------------------------------------------------------------- disk spill

def _spill_records(rng, n):
    """Records of the packed Criteo layout: u8 label, bf16 dense, u32 words."""
    return [(rng.integers(0, 2, 16).astype(np.uint8),
             tcodec.bf16_bits_np(rng.standard_normal((16, 13)).astype(np.float32)),
             rng.integers(0, 1 << 32, (16, 18), dtype=np.uint64).astype(np.uint32))
            for _ in range(n)]


def test_port_reads_a_reference_v2_spill(tmp_path):
    """The JAX package writes a v2 spill with bf16, u8 and u32 fields; the
    port attaches it and reads every record and live-row count, bitwise,
    and the records the port writes are the reference's bytes (the CRC
    included)."""
    rng = np.random.default_rng(0)
    recs = _spill_records(rng, 4)
    shapes = ((16,), (16, 13), (16, 18))
    ref = JDiskChunkCache(str(tmp_path / "j"), shapes,
                          (np.uint8, jcodec.BF16, np.uint32), keep_file=True)
    ours = DiskChunkCache(str(tmp_path / "t"), shapes, (np.uint8, np.uint16, np.uint32),
                          keep_file=True)
    for i, (lab, dense, cats) in enumerate(recs):
        ref.append((lab, dense.view(ml_dtypes.bfloat16), cats), 16 - i)
        ours.append((lab, dense, cats), 16 - i)
    ref.finalize()
    ours.finalize()
    att = DiskChunkCache.attach(ref.path)
    assert att._version == 2 and att.n_records == 4
    assert att.dtypes[1] == np.uint16                 # "bfloat16" -> its bits
    for i, rec in enumerate(recs):
        arrays, n = att.read(i)
        assert n == 16 - i
        for a, b in zip(arrays, rec):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(np.asarray(ours._mm[i]), np.asarray(ref._mm[i]))
    assert ours.record_bytes == ref.record_bytes and ours.payload_bytes == ref.payload_bytes
    att.delete()
    for c in (ours, ref):
        path = c.path
        c.delete()
        assert not os.path.exists(path)


def _v1_v0_files(tmp_path):
    """A version-1 file (header, no CRC) and a version-0 file (headerless
    f32), byte for byte as the reference's tests synthesize them."""
    arr = np.arange(24, dtype=np.float32).reshape(8, 3)
    header = json.dumps({"version": 1, "shapes": [[8, 3]], "dtypes": ["float32"]}).encode()
    head = b"OTPUSPL1" + struct.pack("<I", len(header)) + header
    head += b"\0" * (-len(head) % 8)
    v1, v0 = tmp_path / "v1.otpu", tmp_path / "v0.otpu"
    v1.write_bytes(head + struct.pack("<Ixxxx", 7) + arr.tobytes()
                   + struct.pack("<Ixxxx", 8) + (arr + 1).tobytes())
    v0.write_bytes(arr.tobytes() + (arr * 2).tobytes())
    return str(v1), str(v0)


@pytest.mark.parametrize("version", [0, 1])
def test_port_reads_v1_and_v0_like_the_reference(tmp_path, version):
    v1, v0 = _v1_v0_files(tmp_path)
    path, kw = (v1, {}) if version == 1 else (v0, {"shapes": ((8, 3),)})
    ours, ref = DiskChunkCache.attach(path, **kw), JDiskChunkCache.attach(path, **kw)
    assert ours._version == ref._version == version
    assert ours.n_records == ref.n_records == 2
    for i in range(2):
        (a,), n = ours.read(i)
        (b,), m = ref.read(i)
        assert n == m and np.array_equal(a, np.asarray(b))
    ours.delete()
    ref.delete()


def test_flipped_byte_raises_naming_the_record(tmp_path, monkeypatch):
    from orange3_spark_tpu_torch.io.codec import SpillCorruptionError

    cache = DiskChunkCache(str(tmp_path), ((8, 3), (8,)), keep_file=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        cache.append((rng.standard_normal((8, 3)).astype(np.float32),
                      rng.standard_normal(8).astype(np.float32)), 8 - i)
    cache.finalize()
    with open(cache.path, "r+b") as f:
        f.seek(cache._data_start + cache.record_bytes + cache._offsets[1] + 5)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x40]))
    att = DiskChunkCache.attach(cache.path)
    att.read(0)
    with pytest.raises(SpillCorruptionError, match="record 1 of 3"):
        att.read(1)
    monkeypatch.setenv("OTPU_RESILIENCE", "0")        # the check's off switch
    arrays, n = att.read(1)
    assert arrays[0].shape == (8, 3) and n == 7
    att.delete()
    # a file cut mid-record is refused when attached
    with open(cache.path, "r+b") as f:
        f.truncate(cache._data_start + cache.record_bytes + cache.record_bytes // 2)
    with pytest.raises(SpillCorruptionError, match="truncated"):
        DiskChunkCache.attach(cache.path)
    cache.delete()
