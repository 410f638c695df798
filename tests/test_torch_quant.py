"""The port's quantized tables (bf16 / int8) vs the JAX package on the
CPU: the codec (codes, scales and bf16 bits bitwise the reference's),
``RowCodec``, ``quant.npz`` read across packages, the quantized
``FixedShapeScorer`` for FM and FFM, the refusals, the convert tool,
``predict`` and ``serve()`` at ``serve_table_dtype = int8``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own: the scorer's ``rtol=1e-5,
atol=1e-6`` (``tests/test_pallas_ops.py``) and the served-score bounds
of quantized against fp32 tables, ``BF16_SERVE_TOL`` and
``INT8_SERVE_TOL`` (``tests/test_quant.py:43-44``).
"""

import json
import struct
import urllib.request

import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fast_tffm_tpu import obs as jax_obs
from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.ops import quant as jax_quant
from fast_tffm_tpu.serve.scorer import FixedShapeScorer as JaxScorer
from fast_tffm_tpu.train import checkpoint as jax_checkpoint
from fast_tffm_tpu.train.loop import predict as jax_predict
from fast_tffm_tpu_torch import cli, weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs.telemetry import Telemetry
from fast_tffm_tpu_torch.ops import quant
from fast_tffm_tpu_torch.serve import scorer as scorer_lib
from fast_tffm_tpu_torch.serve import wire
from fast_tffm_tpu_torch.serve.scorer import FixedShapeScorer
from fast_tffm_tpu_torch.serve.server import serve
from fast_tffm_tpu_torch.serve.textparse import parse_request
from fast_tffm_tpu_torch.tools import convert_checkpoint
from fast_tffm_tpu_torch.train import checkpoint
from fast_tffm_tpu_torch.train.loop import Trainer, predict
from tools import convert_checkpoint as jax_convert

SERVE_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_SERVE_TOL = 5e-3
INT8_SERVE_TOL = 2e-2
SERVE_BOUND = {"bf16": BF16_SERVE_TOL, "int8": INT8_SERVE_TOL}
V, F, K, P = 256, 4, 4, 3
CHUNK = 32


def _cfg_kw(field_num=0, **kw):
    out = dict(vocabulary_size=V, factor_num=K, max_features=F,
               field_num=field_num, serve_batch_sizes="16,64",
               quant_chunk=CHUNK, serve_poll_secs=0.0,
               max_batch_wait_ms=1.0)
    out.update(kw)
    return out


def _table(seed=0, dim=1 + K, outlier=False):
    """An f32 table at 50 times the default init range (the reference's
    tolerance test's magnitudes) with an all-zero chunk; ``outlier``
    adds a row 40 times larger, which flattens its chunk's precision."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.01, 0.01, (V, dim)).astype(np.float32) * 50
    table[:CHUNK] = 0.0
    if outlier:
        table[77] *= 40.0
    return table


def _examples(n, seed=1, field_num=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (n, F)).astype(np.int32)
    vals = rng.uniform(0.1, 1.5, (n, F)).astype(np.float32)
    vals[::3, -1] = 0.0
    fields = (rng.integers(0, field_num, (n, F)).astype(np.int32)
              if field_num else None)
    return ids, vals, fields


# ------------------------------------------------------------- codec


def _codec_rows():
    """203 rows (not a multiple of any chunk): random magnitudes, two
    all-zero groups' worth of zero rows, and one outlier row."""
    rng = np.random.default_rng(5)
    rows = (rng.normal(size=(203, 9))
            * rng.uniform(0.001, 3.0, (203, 1))).astype(np.float32)
    rows[:64] = 0.0
    rows[100] *= 1e4
    rows[150, 3] = 0.5  # a row of one non-zero element
    return rows


@pytest.mark.parametrize("chunk", [0, 1, 32, 64])
def test_quantize_int8_is_bitwise_the_reference(chunk):
    rows = _codec_rows()
    codes, scales = quant.quantize_int8(rows, chunk)
    want_codes, want_scales = jax_quant.quantize_int8(rows, chunk)
    assert codes.dtype == np.int8 and scales.dtype == np.float32
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(scales.view(np.uint32),
                                  want_scales.view(np.uint32))
    got = quant.dequantize_int8(codes, scales, chunk)
    want = jax_quant.dequantize_int8(want_codes, want_scales, chunk)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # All-zero groups store scale 0 and reproduce exactly.
    assert np.all(got[:64] == 0.0)


def _bits(*words):
    return np.frombuffer(struct.pack(f"<{len(words)}I", *words), np.float32)


def test_bf16_bits_are_ml_dtypes_round_to_nearest_even():
    special = _bits(
        0x3F808000, 0x3F818000, 0xBF808000, 0x3F807FFF, 0x3F808001,  # ties
        0x00000001, 0x00008000, 0x00018000, 0x0000FFFF, 0x807FFFFF,  # subn.
        0x007F8000, 0x007FFFFF,
        0x00000000, 0x80000000,  # +0, -0
        0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF, 0x7F7F8000, 0x7F000000,  # large
        0x7F800000, 0xFF800000,  # inf
        0x7FC00000, 0xFFC00001, 0x7F800001, 0xFF812345,  # NaN
    )
    rng = np.random.default_rng(11)
    random = rng.integers(0, 1 << 32, 100_000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    x = np.concatenate([special, random]).reshape(-1, 5)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = quant.f32_to_bf16_bits(x)
    assert got.dtype == np.uint16 and got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    # Widening is exact for every one of the 2^16 bit patterns.
    allbits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    np.testing.assert_array_equal(
        quant.bf16_bits_to_f32(allbits).view(np.uint32),
        allbits.view(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))
    # A bf16 tensor on the device side holds the same bits.
    t = quant.bf16_bits_to_torch(got)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(
        np.uint16), got)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quant_table_is_bitwise_the_reference(dtype):
    table = _table(3, outlier=True)
    qt = quant.quantize_table(table, dtype, CHUNK)
    ref = jax_quant.quantize_table(table, dtype, CHUNK)
    carried = weights.quant_from_jax(ref)
    for got in (qt, carried):
        assert got.dtype == ref.dtype and got.chunk == ref.chunk
        assert got.nbytes == ref.nbytes
        assert got.descriptor() == ref.descriptor()
        arrays = quant.table_to_arrays(got)
        want = jax_quant.table_to_arrays(ref)
        assert sorted(arrays) == sorted(want)
        for name in want:
            assert arrays[name].dtype == want[name].dtype
            np.testing.assert_array_equal(arrays[name], want[name])
    np.testing.assert_array_equal(
        quant.dequantize_table(qt).view(np.uint32),
        jax_quant.dequantize_table(ref).view(np.uint32))
    ids = np.random.default_rng(4).integers(0, V, (7, F))
    np.testing.assert_array_equal(
        quant.dequantize_rows(qt, ids).view(np.uint32),
        jax_quant.dequantize_rows(ref, ids).view(np.uint32))
    with pytest.raises(ValueError, match="fp32 tables are not quantized"):
        quant.quantize_table(table, "fp32")
    with pytest.raises(ValueError, match="unknown dtype"):
        quant.validate_dtype("fp16")


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_row_codec_is_bitwise_the_reference(dtype):
    rows = _codec_rows()
    codec = quant.RowCodec(dtype, rows.shape[1])
    ref = jax_quant.RowCodec(dtype, rows.shape[1])
    assert (codec.width, codec.bytes_per_row, codec.storage_dtype) == (
        ref.width, ref.bytes_per_row, ref.storage_dtype)
    assert codec.descriptor() == ref.descriptor()
    packed = codec.encode(rows)
    want = ref.encode(rows)
    assert packed.dtype == want.dtype and packed.shape == want.shape
    np.testing.assert_array_equal(packed.view(np.uint8), want.view(np.uint8))
    np.testing.assert_array_equal(
        codec.decode(packed).view(np.uint32),
        ref.decode(want).view(np.uint32))
    assert codec.empty(3).shape == ref.empty(3).shape


def test_dequant_gathered_matches_the_reference():
    rng = np.random.default_rng(8)
    codes = rng.integers(-127, 128, (6, F, 9)).astype(np.int8)
    scales = rng.uniform(0, 0.1, (6, F)).astype(np.float32)
    got = quant.dequant_gathered(torch.from_numpy(codes),
                                 torch.from_numpy(scales))
    want = np.asarray(jax_quant.dequant_gathered(jnp.asarray(codes),
                                                 jnp.asarray(scales)))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ quant.npz


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quant_npz_is_read_by_either_package(tmp_path, dtype, writer):
    table = _table(6, outlier=True)
    model_file = str(tmp_path / "m")
    ref_qt = jax_quant.quantize_table(table, dtype, CHUNK)
    if writer == "port":
        checkpoint.save_quant(model_file, 12, -0.25,
                              quant.quantize_table(table, dtype, CHUNK))
        step, w0, got = jax_checkpoint.restore_quant(model_file)
        want_arrays = jax_quant.table_to_arrays(got)
    else:
        jax_checkpoint.save_quant(model_file, 12, -0.25, ref_qt)
        step, w0, got = checkpoint.restore_quant(model_file)
        want_arrays = quant.table_to_arrays(got)
    assert (step, w0) == (12, -0.25)
    assert got.descriptor() == ref_qt.descriptor()
    for name, arr in jax_quant.table_to_arrays(ref_qt).items():
        np.testing.assert_array_equal(want_arrays[name], arr)
    with np.load(checkpoint.quant_path(model_file)) as z:
        assert sorted(z.files) == sorted(
            ["scalar/step", "scalar/w0", "quant/codes", "quant/descriptor"]
            + (["quant/scales"] if dtype == "int8" else []))
        assert str(z["quant/descriptor"]) == json.dumps(
            ref_qt.descriptor(), sort_keys=True)


def test_the_three_formats_are_exclusive(tmp_path):
    from fast_tffm_tpu_torch.train import tiered

    model_file = str(tmp_path / "m")
    model = weights.from_jax(0.0, _table(1), device="cpu")
    qt = quant.quantize_table(_table(1), "int8", CHUNK)
    store = tiered._virtual_store(FmConfig(**_cfg_kw()), "table")
    overlay = {"table": {**store.export(), "descriptor": store.descriptor}}
    checkpoint.save_params(model_file, model, step=1)
    checkpoint.save_quant(model_file, 2, 0.0, qt)
    assert checkpoint.exists_quant(model_file)
    assert not checkpoint.exists(model_file)
    checkpoint.save_tiered(model_file, 3, {"w0": np.float32(0)}, overlay)
    assert checkpoint.exists_tiered(model_file)
    assert not checkpoint.exists_quant(model_file)
    checkpoint.save_quant(model_file, 4, 0.0, qt)
    assert not checkpoint.exists_tiered(model_file)
    checkpoint.save_tiered(model_file, 5, {"w0": np.float32(0)}, overlay)
    checkpoint.save_params(model_file, model, step=6)
    assert checkpoint.exists(model_file)
    assert not checkpoint.exists_tiered(model_file)
    assert not checkpoint.exists_quant(model_file)


# ------------------------------------------------------------ scorer


def _scorers(dtype, table, field_num, telemetry=None, jax_tel=None,
             pre_quantized=False):
    """The port's and the reference's FixedShapeScorer at ``dtype`` on
    the same table (placement-quantized, or a quantized table handed
    over as ``(w0, QuantTable)``)."""
    kw = _cfg_kw(field_num, serve_table_dtype=dtype)
    w0 = np.float32(-0.1)
    if pre_quantized:
        ref_qt = jax_quant.quantize_table(table, dtype, CHUNK)
        port_model = (w0, weights.quant_from_jax(ref_qt))
        ref_model = (w0, ref_qt)
    else:
        port_model = weights.from_jax(w0, table, device="cpu")
        ref_model = jax_fm.FmParams(w0=jnp.asarray(w0),
                                    table=jnp.asarray(table))
    port = FixedShapeScorer(FmConfig(**kw), port_model, device="cpu",
                            telemetry=telemetry)
    ref = JaxScorer(JaxFmConfig(**kw), ref_model, telemetry=jax_tel)
    return port, ref


@pytest.mark.parametrize("field_num", [0, P], ids=["fm", "ffm"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantized_scorer_matches_the_reference(dtype, field_num):
    """At placement quantization: scores within the scorer's tolerance
    of the reference's; both within the pinned bound of their fp32
    scores; equal table bytes and probe errors."""
    dim = 1 + (field_num or 1) * K
    table = _table(2, dim)
    ids, vals, fields = _examples(100, field_num=field_num)
    tel, jax_tel = Telemetry(), jax_obs.Telemetry()
    port, ref = _scorers(dtype, table, field_num, tel, jax_tel)
    port.warmup()
    got = port.score(ids, vals, fields)
    want = ref.score(ids, vals, fields)
    np.testing.assert_allclose(got, want, **SERVE_TOL)
    port32, ref32 = _scorers("fp32", table, field_num)
    bound = SERVE_BOUND[dtype]
    assert np.abs(got - port32.score(ids, vals, fields)).max() <= bound
    assert np.abs(want - ref32.score(ids, vals, fields)).max() <= bound
    g, jg = tel.snapshot()["gauges"], jax_tel.snapshot()["gauges"]
    assert g["serve.table_bytes"] == jg["serve.table_bytes"]
    assert g["serve.table_bytes"] == (
        V * dim * 2 if dtype == "bf16" else V * dim + (V // CHUNK) * 4)
    assert 0 < g["serve.quant_error_max"] <= bound
    assert abs(g["serve.quant_error_max"]
               - jg["serve.quant_error_max"]) <= 1e-6


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_pre_quantized_table_scores_as_the_reference(dtype):
    """A reference QuantTable carried over (as a quant.npz would be)
    scores within tolerance of the reference scorer, reads -1 for its
    unknown error, and a hot swap to an fp32 model re-quantizes it."""
    table = _table(9)
    ids, vals, _ = _examples(70)
    tel = Telemetry()
    port, ref = _scorers(dtype, table, 0, tel, pre_quantized=True)
    np.testing.assert_allclose(port.score(ids, vals), ref.score(ids, vals),
                               **SERVE_TOL)
    assert tel.snapshot()["gauges"]["serve.quant_error_max"] == -1.0
    table2 = _table(10)
    port.swap(weights.from_jax(np.float32(-0.1), table2, device="cpu"),
              step=7)
    assert port.step == 7
    assert tel.snapshot()["gauges"]["serve.quant_error_max"] > 0
    fresh, ref2 = _scorers(dtype, table2, 0)
    np.testing.assert_array_equal(port.score(ids, vals),
                                  fresh.score(ids, vals))
    np.testing.assert_allclose(port.score(ids, vals), ref2.score(ids, vals),
                               **SERVE_TOL)


def _refusal_messages(case):
    """``(port error, reference error)`` of one refused placement."""
    table = _table(4)
    qt8 = jax_quant.quantize_table(table, "int8", CHUNK)
    qt16 = jax_quant.quantize_table(table, "bf16", CHUNK)
    w0 = np.float32(0.0)
    kw = {
        "fp32_over_quant": (_cfg_kw(serve_table_dtype="fp32"), qt8),
        "dtype": (_cfg_kw(serve_table_dtype="int8"), qt16),
        "chunk": (_cfg_kw(serve_table_dtype="int8", quant_chunk=16), qt8),
    }[case]
    errs = []
    with pytest.raises(ValueError) as e:
        FixedShapeScorer(FmConfig(**kw[0]), (w0, weights.quant_from_jax(
            kw[1])), device="cpu")
    errs.append(str(e.value))
    with pytest.raises(ValueError) as e:
        JaxScorer(JaxFmConfig(**kw[0]), (w0, kw[1]))
    errs.append(str(e.value))
    return errs


@pytest.mark.parametrize("case", ["fp32_over_quant", "dtype", "chunk"])
def test_scorer_refusals_match_the_reference(case):
    got, want = _refusal_messages(case)
    # The same words, up to the tool the message points at.
    assert got.replace(scorer_lib.CONVERT_TOOL, "python -m "
                       "tools.convert_checkpoint") == want


@pytest.mark.parametrize("case", ["shape", "dtype"])
def test_load_model_refuses_a_mismatched_quant_npz(tmp_path, case):
    model_file = str(tmp_path / "m")
    jax_checkpoint.save_quant(model_file, 1, 0.0,
                              jax_quant.quantize_table(_table(4), "int8",
                                                       CHUNK))
    kw = _cfg_kw(model_file=model_file, serve_table_dtype="int8")
    if case == "shape":
        kw["vocabulary_size"] = 2 * V
        match = r"table is \[256, 5\] but the config wants \[512, 5\]"
    else:
        kw["serve_table_dtype"] = "bf16"
        match = "is int8 but serve_table_dtype=bf16"
    with pytest.raises(ValueError, match=match):
        scorer_lib.load_model(FmConfig(**kw))
    from fast_tffm_tpu.serve import scorer as jax_scorer_lib

    with pytest.raises(ValueError, match=match):
        jax_scorer_lib.load_model(JaxFmConfig(**kw))


# ------------------------------------------------- trainer and tools


def _write_libsvm(path, n, seed=3):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            feats = " ".join(f"{rng.integers(0, V)}:{rng.uniform(0.1, 1):.3f}"
                             for _ in range(3))
            f.write(f"{i % 2} {feats}\n")


@pytest.mark.parametrize("fmt", ["quant", "tiered"])
def test_trainer_refuses_to_warm_start_over(tmp_path, fmt):
    from fast_tffm_tpu_torch.train import tiered

    _write_libsvm(tmp_path / "t.libsvm", 64)
    model_file = str(tmp_path / "m")
    cfg = FmConfig(**_cfg_kw(model_file=model_file, batch_size=16,
                             train_files=[str(tmp_path / "t.libsvm")]))
    if fmt == "quant":
        checkpoint.save_quant(model_file, 1, 0.0, quant.quantize_table(
            _table(1), "int8", CHUNK))
        match = (r"quant\.npz\); training cannot warm-start from it .*"
                 r"fast_tffm_tpu_torch\.tools\.convert_checkpoint <dir> "
                 r"--to fp32")
    else:
        store = tiered._virtual_store(cfg, "table")
        checkpoint.save_tiered(model_file, 1, {"w0": np.float32(0)}, {
            "table": {**store.export(), "descriptor": store.descriptor}})
        match = "holds a tiered overlay checkpoint"
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, device="cpu")


def _reference_dense(model_file, table, w0=0.125, step=9):
    """A dense fp32 checkpoint of ``table`` in the reference's Orbax
    dirs, which both packages read."""
    jax_checkpoint.save(model_file, step, jax_fm.FmParams(
        w0=jnp.asarray(np.float32(w0)), table=jnp.asarray(table)))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_convert_tool_writes_the_reference_tools_arrays(tmp_path, dtype,
                                                        capsys):
    table = _table(12, outlier=True)
    src = str(tmp_path / "src")
    _reference_dense(src, table)
    args = ["--to", dtype, "--chunk", str(CHUNK)]
    assert jax_convert.main([src, "--out", str(tmp_path / "ref")]
                            + args) == 0
    assert convert_checkpoint.main([src, "--out", str(tmp_path / "port")]
                                   + args) == 0
    out = capsys.readouterr().out
    assert "max |dequant - fp32| element error" in out
    with np.load(checkpoint.quant_path(str(tmp_path / "ref"))) as a, \
            np.load(checkpoint.quant_path(str(tmp_path / "port"))) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    # Back to fp32: the dequantized table, no optimizer state.
    back = str(tmp_path / "back")
    assert convert_checkpoint.main([str(tmp_path / "port"), "--to", "fp32",
                                    "--out", back]) == 0
    with np.load(checkpoint.params_path(back)) as z:
        assert sorted(z.files) == ["params/table", "scalar/step",
                                   "scalar/w0"]
        np.testing.assert_array_equal(
            z["params/table"], jax_quant.dequantize_table(
                jax_quant.quantize_table(table, dtype, CHUNK)))
        assert int(z["scalar/step"]) == 9


@pytest.mark.parametrize("case", ["in_place", "tiered"])
def test_convert_tool_refusals_match_the_reference(tmp_path, case):
    from fast_tffm_tpu.train import tiered as jax_tiered

    src = str(tmp_path / "src")
    if case == "in_place":
        _reference_dense(src, _table(1))
        argv = [src, "--to", "int8"]
    else:
        cfg = JaxFmConfig(**_cfg_kw())
        store = jax_tiered._virtual_store(cfg, "table")
        jax_checkpoint.save_tiered(src, 1, {"w0": np.float32(0)}, {
            "table": {**store.export(), "descriptor": store.descriptor}})
        argv = [src, "--to", "int8", "--out", str(tmp_path / "o")]
    with pytest.raises(SystemExit) as want:
        jax_convert.main(argv)
    with pytest.raises(SystemExit) as got:
        convert_checkpoint.main(argv)
    assert str(got.value) == str(want.value)


def test_predict_at_int8_matches_the_reference_predict(tmp_path):
    table = _table(13)
    model_file = str(tmp_path / "m")
    _reference_dense(model_file, table)
    _write_libsvm(tmp_path / "p.libsvm", 150, seed=21)
    kw = _cfg_kw(model_file=model_file, serve_table_dtype="int8",
                 batch_size=32, predict_files=[str(tmp_path / "p.libsvm")])
    assert predict(FmConfig(**kw, score_path=str(tmp_path / "port.txt")),
                   device="cpu") == 150
    jax_predict(JaxFmConfig(**kw, score_path=str(tmp_path / "ref.txt")))
    got = np.loadtxt(tmp_path / "port.txt")
    want = np.loadtxt(tmp_path / "ref.txt")
    assert got.shape == want.shape == (150,)
    assert np.abs(got - want).max() <= INT8_SERVE_TOL
    # Both quantize bitwise alike: beyond the bound, within the print.
    np.testing.assert_allclose(got, want, atol=1e-5)


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read()


def test_serve_and_predict_a_quant_npz_the_reference_tool_wrote(tmp_path):
    """The CLI's ``--serve_table_dtype int8`` over a quant.npz written by
    the reference's tools/convert_checkpoint.py: ``predict`` writes the
    reference scorer's scores; ``serve()`` answers both transports
    bitwise alike and reports the table's bytes and an unknown (-1)
    probe error on ``/status``."""
    table = _table(14)
    src, qdir = str(tmp_path / "src"), str(tmp_path / "q")
    _reference_dense(src, table)
    assert jax_convert.main([src, "--to", "int8", "--out", qdir,
                             "--chunk", str(CHUNK)]) == 0
    _write_libsvm(tmp_path / "p.libsvm", 40, seed=22)
    (tmp_path / "c.cfg").write_text(
        f"[General]\nvocabulary_size = {V}\nfactor_num = {K}\n"
        f"model_file = {qdir}\n[Predict]\npredict_files = "
        f"{tmp_path}/p.libsvm\nscore_path = {tmp_path}/s.txt\n"
        f"[Tpu]\nmax_features = {F}\nquant_chunk = {CHUNK}\n")
    assert cli.main(["predict", str(tmp_path / "c.cfg"), "--device", "cpu",
                     "--serve_table_dtype", "int8"]) == 0
    kw = _cfg_kw(model_file=qdir, serve_table_dtype="int8")
    _, w0, ref_qt = jax_checkpoint.restore_quant(qdir)
    ref = JaxScorer(JaxFmConfig(**kw), (np.float32(w0), ref_qt))
    from fast_tffm_tpu_torch.data.pipeline import BatchPipeline

    pcfg = FmConfig(**kw, predict_files=[str(tmp_path / "p.libsvm")])
    with BatchPipeline(pcfg.predict_files, pcfg, shuffle=False) as p:
        want = np.concatenate([ref.score(b.ids, b.vals)[b.weights > 0]
                               for b in p])
    np.testing.assert_allclose(np.loadtxt(tmp_path / "s.txt"), want,
                               atol=2e-6)
    handle = serve(FmConfig(**kw), device="cpu", port=0)
    try:
        ids, vals, _ = _examples(23, seed=5)
        text = "".join(
            "0 " + " ".join(f"{i}:{v:.6g}" for i, v in zip(r, x) if v)
            + "\n" for r, x in zip(ids, vals))
        got = _post(handle.port, "/score", text.encode()).decode()
        ids_p, vals_p, _, n, _ = parse_request(text, handle.cfg)
        assert n == 23
        bin_scores = wire.decode_bin_response(_post(
            handle.port, "/score_bin", wire.encode_bin_request(ids_p,
                                                               vals_p)))
        assert got == "".join(f"{s:.6f}\n" for s in bin_scores)
        np.testing.assert_allclose(bin_scores, ref.score(ids_p, vals_p),
                                   **SERVE_TOL)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{handle.port}/status", timeout=30) as r:
            status = json.loads(r.read())["serve"]
        assert status["quant_error_max"] == -1.0
        assert status["table_mb"] == round(ref_qt.nbytes / (1 << 20), 3)
    finally:
        handle.close()


def test_cli_takes_the_table_format_flags(tmp_path):
    args = cli.build_argparser().parse_args(
        ["serve", "x.cfg", "--serve_table_dtype", "bf16", "--quant_chunk",
         "8", "--table_tiering", "on", "--cold_dtype", "int8"])
    assert (args.serve_table_dtype, args.quant_chunk, args.table_tiering,
            args.cold_dtype) == ("bf16", 8, "on", "int8")
    # A cold dtype names the tiered cold store's format: the config's
    # own rule refuses it without table_tiering.
    (tmp_path / "c.cfg").write_text(
        f"[General]\nvocabulary_size = {V}\nmodel_file = {tmp_path}/m\n")
    with pytest.raises(ValueError, match="requires table_tiering=on"):
        cli.main(["serve", str(tmp_path / "c.cfg"), "--device", "cpu",
                  "--cold_dtype", "int8"])
