"""The port's tiered-table serving half vs the JAX package on the CPU: the
virtual cold store's hash init and gathers (bitwise the reference's, on
written and never-written ids, in every cold dtype), ``tiered.npz`` and
its shard sets read across packages with the reference's refusals, and
the ``OverlayScorer`` serving a checkpoint of the reference's tiered
trainer (virtual store forced at a tiny vocabulary, as
``tests/test_tiered_table.py`` does) within the scorer's ``rtol=1e-5,
atol=1e-6`` (``tests/test_pallas_ops.py``) of the reference's, for FM
and FFM, through ``make_scorer``, ``predict`` and ``serve()``.
"""

import json
import urllib.request

import numpy as np
import pytest

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.serve import scorer as jax_scorer_lib
from fast_tffm_tpu.train import checkpoint as jax_checkpoint
from fast_tffm_tpu.train import tiered as jax_tiered
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu.train.loop import predict as jax_predict
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs.telemetry import Telemetry
from fast_tffm_tpu_torch.serve import scorer as scorer_lib
from fast_tffm_tpu_torch.serve import wire
from fast_tffm_tpu_torch.serve.server import serve
from fast_tffm_tpu_torch.serve.textparse import parse_request
from fast_tffm_tpu_torch.train import checkpoint, tiered
from fast_tffm_tpu_torch.train.loop import predict

SERVE_TOL = dict(rtol=1e-5, atol=1e-6)
V, F, K, P = 256, 4, 4, 3


def _cfg_kw(**kw):
    out = dict(vocabulary_size=V, factor_num=K, max_features=F,
               serve_batch_sizes="16,64", serve_poll_secs=0.0,
               max_batch_wait_ms=1.0, seed=3)
    out.update(kw)
    return out


def _tiering(cold_dtype):
    return dict(table_tiering="on", hot_rows=160, cold_dtype=cold_dtype)


def _examples(n, seed=1, field_num=0, vocab=V):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, F)).astype(np.int32)
    vals = rng.uniform(0.1, 1.5, (n, F)).astype(np.float32)
    vals[::3, -1] = 0.0
    fields = (rng.integers(0, field_num, (n, F)).astype(np.int32)
              if field_num else None)
    return ids, vals, fields


@pytest.mark.parametrize("dim, seed, scale", [(9, 0, 0.01), (5, 7, 0.5),
                                              (33, 2**40 + 3, 1.0)])
def test_hash_uniform_is_bitwise_the_reference(dim, seed, scale):
    ids = np.concatenate([np.arange(300), [2**26 - 1, 2**31 + 5, 2**40]])
    got = tiered._hash_uniform(ids.astype(np.int64), dim, seed, scale)
    want = jax_tiered._hash_uniform(ids.astype(np.int64), dim, seed, scale)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", ["table", "acc", "z"])
@pytest.mark.parametrize("cold_dtype", ["fp32", "bf16", "int8"])
def test_virtual_store_gathers_bitwise_the_reference(cold_dtype, name):
    """Two writes (overlapping, the second newer) through the tail and a
    compaction; gathers of written and never-written ids, the export
    and a small dense materialization all bitwise the reference's."""
    kw = _cfg_kw(vocabulary_size=5000, optimizer="ftrl",
                 **_tiering(cold_dtype))
    port = tiered._virtual_store(FmConfig(**kw), name)
    ref = jax_tiered._virtual_store(JaxFmConfig(**kw), name)
    assert port.descriptor == ref.descriptor
    assert port.descriptor == tiered._virtual_descriptor(FmConfig(**kw),
                                                         name)
    rng = np.random.default_rng(9)
    for n in (3000, 5000):  # the second write compacts the tail
        ids = rng.choice(5000, n // 2, replace=False)
        rows = rng.normal(0, 0.05, (len(ids), 1 + K)).astype(np.float32)
        port.scatter(ids, rows)
        ref.scatter(ids, rows)
    probe = np.concatenate([rng.integers(0, 5000, 700), [0, 4999]])
    np.testing.assert_array_equal(port.gather(probe).view(np.uint32),
                                  ref.gather(probe).view(np.uint32))
    assert port.written_rows == ref.written_rows
    assert port.nbytes == ref.nbytes
    a, b = port.export(), ref.export()
    np.testing.assert_array_equal(a["ids"], b["ids"])
    np.testing.assert_array_equal(a["rows"], b["rows"])
    np.testing.assert_array_equal(port.to_dense().view(np.uint32),
                                  ref.to_dense().view(np.uint32))


def test_cold_store_refuses_what_the_reference_refuses():
    cfg = FmConfig(**_cfg_kw(vocabulary_size=1 << 26))
    store = tiered._virtual_store(cfg, "table")
    with pytest.raises(ValueError, match="too large to materialize"):
        store.to_dense()
    with pytest.raises(ValueError, match="packed rows have width"):
        store.import_overlay({"ids": np.arange(3),
                              "rows": np.zeros((3, 4), np.float32)})
    with pytest.raises(ValueError, match="unknown store"):
        tiered._virtual_descriptor(cfg, "bogus")
    dense = tiered.ColdStore.from_dense(
        np.ones((4, 1 + K), np.float32), {}, tiered.quant.RowCodec(
            "int8", 1 + K))
    assert dense.dense_backed and dense.cold_dtype == "int8"
    np.testing.assert_array_equal(dense.gather(np.arange(4)), 1.0)
    assert tiered._bucket(1) == 8 and tiered._bucket(9) == 16
    assert tiered.EXACT_BYTES_MAX == jax_tiered.EXACT_BYTES_MAX


def _overlay_payload(cfg, module, n=90, seed=4):
    store = module._virtual_store(cfg, "table")
    rng = np.random.default_rng(seed)
    ids = rng.choice(cfg.vocabulary_size, n, replace=False)
    store.scatter(ids, rng.normal(0, 0.3, (n, cfg.embedding_dim))
                  .astype(np.float32))
    return {"table": {**store.export(), "descriptor": store.descriptor}}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tiered_npz_is_read_by_either_package(tmp_path, writer):
    kw = _cfg_kw(**_tiering("int8"))
    model_file = str(tmp_path / "m")
    payload = _overlay_payload(JaxFmConfig(**kw), jax_tiered)
    save, restore = ((checkpoint.save_tiered, jax_checkpoint.restore_tiered)
                     if writer == "port" else
                     (jax_checkpoint.save_tiered, checkpoint.restore_tiered))
    save(model_file, 17, {"w0": np.float32(0.5),
                          "acc_w0": np.float32(0.1)}, payload)
    step, scalars, stores = restore(model_file)
    assert step == 17 and sorted(scalars) == ["acc_w0", "w0"]
    assert float(scalars["w0"]) == 0.5
    for key in ("ids", "rows"):
        np.testing.assert_array_equal(stores["table"][key],
                                      payload["table"][key])
    assert stores["table"]["descriptor"] == payload["table"]["descriptor"]


def _write_shards(model_file, shards, count, steps=None):
    kw = _cfg_kw()
    for s in shards:
        payload = _overlay_payload(JaxFmConfig(**kw), jax_tiered, n=10,
                                   seed=s)
        jax_checkpoint.save_tiered_shards(
            model_file, (steps or {}).get(s, 4), {"w0": np.float32(0)},
            {s: payload}, count, primary=False)


@pytest.mark.parametrize("case", ["complete", "mixed", "missing", "torn"])
def test_shard_sets_restore_or_refuse_as_the_reference(tmp_path, case):
    model_file = str(tmp_path / "m")
    if case == "complete":
        _write_shards(model_file, [0, 1], 2)
    elif case == "mixed":
        _write_shards(model_file, [0, 1], 2)
        _write_shards(model_file, [0], 3)
    elif case == "missing":
        _write_shards(model_file, [0, 2], 3)
    else:
        _write_shards(model_file, [0, 1], 2, steps={1: 5})
    assert checkpoint.exists_tiered(model_file)
    try:
        want = jax_checkpoint.restore_tiered(model_file)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            checkpoint.restore_tiered(model_file)
        assert str(got.value) == str(e)
        return
    assert case == "complete"
    step, scalars, stores = checkpoint.restore_tiered(model_file)
    assert step == want[0] == 4
    for key in ("ids", "rows"):
        np.testing.assert_array_equal(stores["table"][key],
                                      want[2]["table"][key])
    checkpoint.clear_tiered(model_file)
    assert not checkpoint.exists_tiered(model_file)


def _write_libsvm(path, n, seed=3, field_num=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            feats = " ".join(
                (f"{rng.integers(0, field_num)}:" if field_num else "")
                + f"{rng.integers(0, V)}:{rng.uniform(0.1, 1):.3f}"
                for _ in range(3))
            f.write(f"{i % 2} {feats}\n")


@pytest.fixture
def reference_tiered(tmp_path, monkeypatch):
    """``make(cold_dtype)``: a ``tiered.npz`` of the reference's tiered
    trainer (one epoch over 256 lines, eviction churn at 160 hot rows)
    with the virtual store forced, and the config it was trained with."""
    monkeypatch.setattr(jax_tiered, "EXACT_BYTES_MAX", 0)
    _write_libsvm(tmp_path / "train.libsvm", 256)

    def make(cold_dtype):
        kw = _cfg_kw(model_file=str(tmp_path / f"m_{cold_dtype}"),
                     batch_size=32, epoch_num=1, log_steps=0,
                     thread_num=1, steps_per_dispatch=2,
                     train_files=[str(tmp_path / "train.libsvm")],
                     **_tiering(cold_dtype))
        JaxTrainer(JaxFmConfig(**kw)).train()
        assert checkpoint.exists_tiered(kw["model_file"])
        assert not checkpoint.exists(kw["model_file"])
        return kw

    return make


@pytest.mark.parametrize("cold_dtype", ["fp32", "bf16", "int8"])
def test_overlay_scorer_serves_the_reference_tiered_trainers_checkpoint(
        reference_tiered, cold_dtype):
    kw = reference_tiered(cold_dtype)
    tel = Telemetry()
    port = scorer_lib.make_scorer(FmConfig(**kw), device="cpu",
                                  telemetry=tel)
    ref = jax_scorer_lib.make_scorer(JaxFmConfig(**kw))
    assert isinstance(port, scorer_lib.OverlayScorer)
    assert isinstance(ref, jax_scorer_lib.OverlayScorer)
    assert port.step == ref.step > 0
    port.warmup()
    for n in (1, 16, 50, 130):
        ids, vals, _ = _examples(n, seed=n)
        np.testing.assert_allclose(port.score(ids, vals),
                                   ref.score(ids, vals), **SERVE_TOL)
    snap = tel.snapshot()
    # Neither table gauge: the overlay's error was never measured.
    assert "serve.table_bytes" not in snap["gauges"]
    assert "serve.quant_error_max" not in snap["gauges"]
    assert snap["timers"]["serve.overlay_gather"]["count"] > 0


def test_overlay_scorer_serves_ffm_as_the_reference(tmp_path):
    """Field-aware FM over an overlay the reference wrote (D = 1 + P*K)."""
    kw = _cfg_kw(field_num=P, model_file=str(tmp_path / "m"),
                 **_tiering("bf16"))
    jax_checkpoint.save_tiered(
        kw["model_file"], 6, {"w0": np.float32(-0.2)},
        _overlay_payload(JaxFmConfig(**kw), jax_tiered, n=120))
    port = scorer_lib.make_scorer(FmConfig(**kw), device="cpu")
    ref = jax_scorer_lib.make_scorer(JaxFmConfig(**kw))
    ids, vals, fields = _examples(70, field_num=P)
    np.testing.assert_allclose(port.score(ids, vals, fields),
                               ref.score(ids, vals, fields), **SERVE_TOL)


@pytest.mark.parametrize("change", [{"seed": 4}, {"init_value_range": 0.02},
                                    {"cold_dtype": "bf16"}])
def test_overlay_with_another_descriptor_is_refused(tmp_path, change):
    kw = _cfg_kw(model_file=str(tmp_path / "m"), **_tiering("int8"))
    jax_checkpoint.save_tiered(
        kw["model_file"], 1, {"w0": np.float32(0)},
        _overlay_payload(JaxFmConfig(**kw), jax_tiered))
    kw.update(change)
    with pytest.raises(ValueError, match="different init"):
        scorer_lib.load_model(FmConfig(**kw))
    with pytest.raises(ValueError, match="different init"):
        jax_scorer_lib.load_model(JaxFmConfig(**kw))


def test_predict_and_serve_a_tiered_checkpoint(reference_tiered, tmp_path):
    """``predict`` over the reference trainer's overlay writes the
    reference predict's file; ``serve()`` answers both transports bitwise
    alike, with no table gauge on ``/status``."""
    kw = reference_tiered("int8")
    _write_libsvm(tmp_path / "p.libsvm", 70, seed=31)
    kw.update(predict_files=[str(tmp_path / "p.libsvm")])
    assert predict(FmConfig(**kw, score_path=str(tmp_path / "port.txt")),
                   device="cpu") == 70
    jax_predict(JaxFmConfig(**kw, score_path=str(tmp_path / "ref.txt")))
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port.txt"),
                               np.loadtxt(tmp_path / "ref.txt"), atol=2e-6)
    handle = serve(FmConfig(**kw), device="cpu", port=0)
    try:
        text = open(tmp_path / "p.libsvm").read()
        req = urllib.request.Request(
            f"http://127.0.0.1:{handle.port}/score", data=text.encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            got = resp.read().decode()
        ids, vals, _, n, _ = parse_request(text, handle.cfg)
        req = urllib.request.Request(
            f"http://127.0.0.1:{handle.port}/score_bin",
            data=wire.encode_bin_request(ids, vals), method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            bin_scores = wire.decode_bin_response(resp.read())
        assert n == 70 and got == "".join(f"{s:.6f}\n" for s in bin_scores)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{handle.port}/status", timeout=30) as r:
            status = json.loads(r.read())["serve"]
        assert "table_mb" not in status and "quant_error_max" not in status
        assert status["overlay_gather_p50_ms"] >= 0
    finally:
        handle.close()
