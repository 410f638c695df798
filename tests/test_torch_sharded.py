"""The port's multi-rank training vs the JAX package on the CPU: the
K-place and merge helpers, the exchange decisions, the hand-sharded step
on 2 x 2, 4 x 1 and 1 x 4 meshes, the multi-rank ``Trainer`` against
the single-process one, input sharding, the mesh and the CLI's
multi-rank flags.

The port's ranks are spawned processes (torch and the port only, gloo on
the CPU, rendezvous through a file under the test's ``tmp_path``), each
with a deadline: a rank that fails or hangs fails the test and every
rank is killed.  The reference runs in this process on the conftest's
8 virtual CPU devices, its Pallas kernels in interpret mode.  Inputs
are made with numpy from a seed; the JAX initial state is handed to the
port.  Tolerances are the reference's own (tests/test_shardmap_step.py,
tests/test_sparse_apply.py): scores ``rtol=1e-4, atol=1e-5``, table
``rtol=1e-4, atol=1e-6``, accumulator ``rtol=1e-4, atol=1e-5``, w0
``rtol=1e-5, atol=1e-7`` (sums taken in another order); K-place against
``dense_delta`` ``rtol=1e-5, atol=1e-5``.
"""

import argparse
import functools
import json
import os
import threading
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JaxMesh

from fast_tffm_tpu import cli as jax_cli
from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.data import pipeline as jax_pipeline
from fast_tffm_tpu.data.libsvm import Batch as JaxBatch
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.ops import sparse_apply as jax_sa
from fast_tffm_tpu.parallel import mesh as jax_mesh
from fast_tffm_tpu.train import shardmap_step as jax_shardmap
from fast_tffm_tpu.train import sparse as jax_sparse
from fast_tffm_tpu_torch import cli, weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import pipeline
from fast_tffm_tpu_torch.data.pipeline import BatchPipeline
from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.parallel import mesh as mesh_lib
from fast_tffm_tpu_torch.train import checkpoint, dist, shardmap_step
from fast_tffm_tpu_torch.train.loop import Trainer

from _torch_sharded_worker import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
ACC_TOL = dict(rtol=1e-4, atol=1e-5)
W0_TOL = dict(rtol=1e-5, atol=1e-7)
V, K, F, B = 2048, 8, 8, 64
D = K + 1


# ------------------------------------------------------ kernels' twins


@pytest.mark.parametrize("vocab, vocab_local, row_lo", [
    (2048, 2048, 0), (2048, 1024, 1024), (4096, 1024, 2048),
])
def test_kplace_plain_matches_jax_dense_delta(vocab, vocab_local, row_lo):
    rng = np.random.default_rng(vocab_local + row_lo)
    n = 700
    ids = rng.integers(0, vocab, n).astype(np.int32)
    ids[:90] = row_lo + 7  # a hot id inside the shard
    ids[90:130] = vocab  # sentinel occurrences
    g = rng.uniform(-1, 1, (n, D)).astype(np.float32)
    g[90:130] = 0.0
    want = jax_sa.dense_delta(jnp.asarray(ids), jnp.asarray(g), vocab=vocab,
                              vocab_local=vocab_local, row_lo=row_lo)
    before = sparse_apply.kplace_cuda.launches
    got = sparse_apply.dense_delta(torch.from_numpy(ids), torch.from_numpy(g),
                                   vocab_local=vocab_local, row_lo=row_lo)
    assert sparse_apply.kplace_cuda.launches == before  # CPU: plain
    assert got.shape == (vocab_local, 2 * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # The wrapper on CPU tensors is the plain version, entry for entry.
    meta = sparse_apply.sort_meta(torch.from_numpy(ids))
    urows, sums = sparse_apply.k1_dedup_plain(
        torch.from_numpy(g), torch.from_numpy(ids), meta.perm, meta.seg_start)
    assert torch.equal(
        sparse_apply.kplace_cuda(urows, sums, row_lo, vocab_local),
        sparse_apply.kplace_plain(urows, sums, row_lo, vocab_local))


def test_unique_entries_merge_k2_match_dense_delta():
    """unique_entries -> concatenate -> merge_entries -> K2 (SGD, lr=1)
    gives the dense K-place delta's totals, as the reference's own test
    (tests/test_sparse_apply.py) holds its helpers; the streams' rows
    and counts are the reference's exactly.  (The dense delta is held
    to JAX's in test_kplace_plain_matches_jax_dense_delta; here a hot
    id of 400 occurrences would add the reference K1's bf16 hi/lo
    split error, some 1e-6 of the segment's mass.)"""
    rng = np.random.default_rng(4)
    vocab = 2048
    cap = sparse_apply.entries_cap(600, vocab)
    assert cap == jax_sa.entries_cap(600, vocab)
    dense_sum = np.zeros((vocab, 2 * D), np.float32)
    rows_all, pay_all = [], []
    for _ in range(4):  # 4 data shards
        ids = rng.integers(0, vocab, 600).astype(np.int32)
        ids[:100] = 77  # a hot id on every shard
        ids[100:140] = vocab  # off-shard occurrences: the sentinel
        g = rng.uniform(-1, 1, (600, D)).astype(np.float32)
        g[100:140] = 0.0
        rows, pay, count = sparse_apply.unique_entries(
            torch.from_numpy(ids), torch.from_numpy(g), vocab=vocab, cap=cap)
        j_rows, _, j_count = jax_sa.unique_entries(
            jnp.asarray(ids), jnp.asarray(g), vocab=vocab, cap=cap)
        assert int(count) == int(j_count)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
        rows_all.append(rows)
        pay_all.append(pay)
        dense_sum += sparse_apply.dense_delta(
            torch.from_numpy(ids), torch.from_numpy(g), vocab_local=vocab,
            row_lo=0).numpy()
    before = sparse_apply.k1_merge_cuda.launches
    urows, sums = sparse_apply.merge_entries(
        torch.cat(rows_all), torch.cat(pay_all), vocab=vocab)
    assert sparse_apply.k1_merge_cuda.launches == before  # CPU: plain
    assert int(urows.max()) < vocab  # the sentinel never reaches K2
    table = torch.zeros((vocab, D))
    sparse_apply.k2_apply_cuda("sgd", urows, sums, (table,),
                               sparse_apply.Hyper(lr=1.0))
    np.testing.assert_allclose(table.numpy(), -dense_sum[:, :D], rtol=1e-5,
                               atol=1e-5)


def test_k1_merge_plain_sums_without_squaring():
    pay = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    ids = torch.tensor([9, 4, 9], dtype=torch.int32)
    meta = sparse_apply.sort_meta(ids)
    urows, sums = sparse_apply.k1_merge_cuda(pay, ids, meta.perm,
                                             meta.seg_start)
    # The whole slot: one row -1 (zero sums) past the two unique ids.
    assert urows.tolist() == [4, 9, -1]
    assert sums.tolist() == [[3.0, 4.0], [6.0, 8.0], [0.0, 0.0]]
    cut = sparse_apply.cut_slot(meta)
    urows, sums = sparse_apply.k1_merge_cuda(pay, ids, cut.perm,
                                             cut.seg_start)
    assert urows.tolist() == [4, 9]
    assert sums.tolist() == [[3.0, 4.0], [6.0, 8.0]]


# ------------------------------------------------ exchange decisions


_GRID = [
    (n_occ, vocab_local, d, shards)
    for n_occ in (8, 512, 513, 19968, 159744, 10223616)
    for vocab_local in (256, 2048, 1 << 21, 1 << 24)
    for d in (2, 9, 33)
    for shards in (1, 2, 4)
]


@pytest.mark.parametrize("mode", ["auto", "dense", "entries"])
def test_resolve_exchange_and_cap_match_the_reference(mode):
    for n_occ, vocab_local, d, shards in _GRID:
        kw = dict(n_local_occ=n_occ, vocab_local=vocab_local, d=d,
                  data_shards=shards)
        assert (sparse_apply.resolve_exchange(mode, **kw)
                == jax_sa.resolve_exchange(mode, **kw)), (mode, kw)
        assert (sparse_apply.entries_cap(n_occ, vocab_local)
                == jax_sa.entries_cap(n_occ, vocab_local))


def _jax_mesh(shape):
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return JaxMesh(devs, (jax_mesh.DATA_AXIS, jax_mesh.MODEL_AXIS))


@pytest.mark.parametrize("cfg_path, shape, exchange", [
    ("examples/criteo_1tb_dist.cfg", (4, 4), "entries"),
    ("examples/criteo_kaggle.cfg", (2, 2), "entries"),
    ("examples/criteo_kaggle.cfg", (2, 1), None),
    ("examples/criteo_kaggle.cfg", (1, 4), "entries"),
    ("examples/sample.cfg", (2, 2), None),
    ("examples/sample.cfg", (4, 2), None),
])
def test_exchange_mode_matches_the_reference(cfg_path, shape, exchange):
    from fast_tffm_tpu.config import load_config as jax_load
    from fast_tffm_tpu_torch.config import load_config

    path = os.path.join(REPO, cfg_path)
    over = {"mesh_data": shape[0], "mesh_model": shape[1]}
    cfg, jcfg = load_config(path, over), jax_load(path, over)
    mesh = mesh_lib.Mesh(*shape)
    n_occ = cfg.batch_size // shape[0] * cfg.max_features
    got = shardmap_step.exchange_mode(cfg, mesh, n_occ)
    if shape[0] * shape[1] <= len(jax.devices()):
        jm = _jax_mesh(shape)
        assert got == jax_shardmap.exchange_mode(jcfg, jm, n_occ)
        assert (shardmap_step.supports_shardmap(cfg, mesh)
                == jax_shardmap.supports_shardmap(jcfg, jm))
    else:  # 16 ranks: the reference's rule on its own inputs
        assert got == jax_sa.resolve_exchange(
            jcfg.sparse_exchange, n_local_occ=n_occ,
            vocab_local=jcfg.vocabulary_size // shape[1],
            d=jcfg.embedding_dim, data_shards=shape[0])
    if exchange is not None:
        assert got == exchange


# --------------------------------------- the sharded step vs JAX (CPU)


# (exchange, optimizer, extra config): L2 on adagrad, mse on sgd.
_CASES = [
    (exchange, optimizer, extra)
    for exchange in ("dense", "entries")
    for optimizer, extra in (
        ("adagrad", dict(factor_lambda=0.01, bias_lambda=0.002)),
        ("ftrl", {}),
        ("sgd", dict(loss_type="mse")),
    )
]
_STEPS = 2


def _case_cfg(optimizer, extra):
    return dict(vocabulary_size=V, factor_num=K, max_features=F,
                batch_size=B, optimizer=optimizer, learning_rate=0.05,
                ftrl_l1=0.01, ftrl_l2=0.1, l2_mode="batch", **extra)


def _case_batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(_STEPS):
        ids = rng.integers(0, V, (B, F)).astype(np.int32)
        ids[:8, 0] = 5  # a duplicated id across data blocks
        weights_ = rng.uniform(0.5, 2.0, B).astype(np.float32)
        weights_[-5:] = 0.0  # padded examples
        out.append(JaxBatch(
            labels=rng.integers(0, 2, B).astype(np.float32), ids=ids,
            vals=rng.uniform(0.1, 1.0, (B, F)).astype(np.float32),
            fields=np.zeros((B, F), np.int32), weights=weights_,
        ))
    return out


def _opt_arrays(optimizer, opt):
    if optimizer == "adagrad":
        return {"acc_w0": opt.acc.w0, "acc_table": opt.acc.table}
    if optimizer == "ftrl":
        return {"z_w0": opt.z.w0, "z_table": opt.z.table,
                "n_w0": opt.n.w0, "n_table": opt.n.table}
    return {}


def _jax_run(jcfg, params, opt, batches, mesh=None):
    if mesh is None:
        step = jax.jit(lambda p, o, b: jax_sparse.sparse_step(jcfg, p, o, b))
    else:
        step = jax.jit(lambda p, o, b: jax_shardmap.sparse_step_shardmap(
            jcfg, p, o, b, mesh))
    scores = []
    for batch in batches:
        params, opt, s = step(params, opt, jax.tree.map(jnp.asarray, batch))
        scores.append(np.asarray(s))
    return params, opt, np.stack(scores)


@functools.lru_cache(maxsize=None)
def _scatter_reference(optimizer, extra_items):
    extra = dict(extra_items)
    jcfg = JaxFmConfig(sparse_apply="scatter", **_case_cfg(optimizer, extra))
    params = jax_fm.init_params(jax.random.PRNGKey(0), jcfg)
    opt = jax_sparse.init_sparse_opt_state(jcfg, params)
    batches = _case_batches(1)
    return (params, opt, batches) + _jax_run(jcfg, params, opt, batches)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_sharded_step_matches_jax(shape, tmp_path):
    """Every case of one mesh shape in one spawned group of ranks: the
    port's sparse_step_shardmap against JAX's on the same mesh shape
    and against JAX's scatter step."""
    cases, refs = [], []
    for i, (exchange, optimizer, extra) in enumerate(_CASES):
        init_p, init_o, batches, sc_p, sc_o, sc_s = _scatter_reference(
            optimizer, tuple(sorted(extra.items())))
        kw = dict(_case_cfg(optimizer, extra), lookup="shardmap",
                  sparse_exchange=exchange, mesh_data=shape[0],
                  mesh_model=shape[1])
        jcfg = JaxFmConfig(**kw)
        jm = _jax_mesh(shape)
        assert jax_shardmap.exchange_mode(jcfg, jm, B // shape[0] * F) \
            == exchange
        sm = _jax_run(jcfg, init_p, init_o, batches, jm)
        refs.append((optimizer, sm, (sc_p, sc_o, sc_s)))
        cases.append({"cfg": kw, "steps": _STEPS})
        arrays = {"w0": np.asarray(init_p.w0),
                  "table": np.asarray(init_p.table)}
        arrays.update((k, np.asarray(v))
                      for k, v in _opt_arrays(optimizer, init_o).items())
        for s, b in enumerate(batches):
            arrays.update((f"b{s}_{f}", np.asarray(getattr(b, f)))
                          for f in JaxBatch._fields[:5])
        np.savez(tmp_path / f"case{i}.npz", **arrays)
    (tmp_path / "cases.json").write_text(json.dumps(cases))
    world = shape[0] * shape[1]
    run_ranks("step", world, tmp_path)
    mesh = mesh_lib.Mesh(*shape)
    for i, (optimizer, sm, sc) in enumerate(refs):
        outs = [np.load(tmp_path / f"out{i}_{r}.npz") for r in range(world)]
        table = weights.unshard_rows([outs[r]["table"] for r in range(
            mesh.model)])
        # Model-row peers agree; the scores come block by block.
        for r in range(world):
            row, col = divmod(r, shape[1])
            np.testing.assert_array_equal(outs[r]["table"],
                                          outs[col]["table"])
            np.testing.assert_array_equal(outs[r]["scores"],
                                          outs[row * shape[1]]["scores"])
        scores = np.concatenate(
            [outs[row * shape[1]]["scores"] for row in range(shape[0])],
            axis=1)
        opt_keys = list(_opt_arrays(optimizer, sm[1]))
        for params, opt, want_scores in (sm, sc):
            where = f"case {_CASES[i]} on {shape}"
            np.testing.assert_allclose(scores, want_scores, **SCORE_TOL,
                                       err_msg=where)
            np.testing.assert_allclose(table, np.asarray(params.table),
                                       **TABLE_TOL, err_msg=where)
            np.testing.assert_allclose(float(outs[0]["w0"]),
                                       float(params.w0), **W0_TOL,
                                       err_msg=where)
            want_opt = _opt_arrays(optimizer, opt)
            for key in opt_keys:
                got = outs[0][key]
                if key.endswith("table"):
                    got = weights.unshard_rows(
                        [outs[r][key] for r in range(mesh.model)])
                tol = ACC_TOL if key.endswith("table") else W0_TOL
                np.testing.assert_allclose(got, np.asarray(want_opt[key]),
                                           **tol, err_msg=f"{where} {key}")


# ------------------------------------------ Trainer across ranks (CPU)


def _write_files(tmp_path, n_lines=512, vocab=256):
    rng = np.random.default_rng(11)
    files = []
    for name in ("a", "b"):
        path = tmp_path / f"{name}.libsvm"
        with open(path, "w") as f:
            for _ in range(n_lines):
                toks = [str(rng.integers(0, 2))]
                toks += [f"{rng.integers(0, vocab)}:{rng.uniform(0.1, 1):.4f}"
                         for _ in range(6)]
                f.write(" ".join(toks) + "\n")
        files.append(str(path))
    return files


def test_multi_rank_trainer_matches_single_process(tmp_path):
    """Four ranks (2 x 2) train from libsvm files with strided input
    sharding and equal the single-process trainer over the same global
    batches; the one params.npz they write warm-starts a single process,
    and a single process's checkpoint warm-starts the ranks, which
    continue its stream from its saved position (``data_state.json``:
    epoch 1 of 2) as a single process does."""
    files = _write_files(tmp_path)
    base = dict(vocabulary_size=512, factor_num=4, max_features=8,
                batch_size=64, train_files=files, validation_files=files[1:],
                epoch_num=2, log_steps=3, seed=5, shuffle_buffer=100,
                learning_rate=0.1, factor_lambda=1e-3, bias_lambda=1e-3)
    runs = [
        dict(base, mesh_data=2, mesh_model=2, lookup="shardmap",
             sparse_exchange="dense", model_file=str(tmp_path / "m_dense")),
        dict(base, mesh_data=2, mesh_model=2, sparse_exchange="entries",
             optimizer="ftrl", model_file=str(tmp_path / "m_entries")),
        dict(base, mesh_data=2, mesh_model=2, lookup="shardmap",
             model_file=str(tmp_path / "m_warm")),
    ]
    # The third run warm-starts from a single-process checkpoint.
    Trainer(FmConfig(**dict(base, epoch_num=1,
                            model_file=str(tmp_path / "m_warm"))),
            device="cpu").train()
    warm0 = np.load(checkpoint.params_path(str(tmp_path / "m_warm")))
    warm0 = {k: warm0[k] for k in warm0.files}
    warm_ds = checkpoint.restore_data_state(str(tmp_path / "m_warm"))
    assert (warm_ds["epoch"], warm_ds["batches_done"]) == (1, 0)
    (tmp_path / "train.json").write_text(json.dumps(runs))
    run_ranks("train", 4, tmp_path)
    for i, run in enumerate(runs):
        results = [json.loads((tmp_path / f"train{i}_{r}.json").read_text())
                   for r in range(4)]
        metric = ("loss", "auc", "examples", "weight_sum")
        for res in results[1:]:  # every rank reports the global metrics
            assert res["validation"] == results[0]["validation"]
            assert ({m: res["train"][m] for m in metric + ("steps",)}
                    == {m: results[0]["train"][m] for m in metric + ("steps",)})
        # 2 files x 512 lines x 2 epochs in global batches of 64; the
        # warm run resumes at epoch 1 and trains its last epoch only.
        epochs = 1 if i == 2 else 2
        assert results[0]["train"]["steps"] == 16 * epochs
        assert results[0]["train"]["examples"] == 1024.0 * epochs
        single_dir = tmp_path / f"single{i}"
        if i == 2:
            os.makedirs(single_dir)
            np.savez(checkpoint.params_path(str(single_dir)), **warm0)
            with open(checkpoint.data_state_path(str(single_dir)), "w") as f:
                json.dump(warm_ds, f)
        single = Trainer(FmConfig(**dict(
            run, mesh_data=1, mesh_model=1, model_file=str(single_dir))),
            device="cpu")
        want = single.train()
        for key in ("train", "validation"):
            for m in metric:
                np.testing.assert_allclose(results[0][key][m], want[key][m],
                                           rtol=1e-5, err_msg=f"{i} {key}")
        with np.load(checkpoint.params_path(run["model_file"])) as got, \
                np.load(checkpoint.params_path(str(single_dir))) as ref:
            assert set(got.files) == set(ref.files)
            assert int(got["scalar/step"]) == int(ref["scalar/step"])
            for k in ref.files:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                           atol=1e-7, err_msg=f"{i} {k}")
    # The multi-rank checkpoint warm-starts one process (and serves).
    back = Trainer(FmConfig(**dict(runs[0], mesh_data=1, mesh_model=1)),
                   device="cpu")
    assert back._restored_step == 32
    assert back.model.table.shape == (512, 5)


def test_cli_trains_on_two_ranks(tmp_path):
    """Two ranks through the CLI: a 1 x 1 config with two ranks is a
    2 x 1 (all data) mesh; both print the same global metrics and one
    params.npz holds the trained steps."""
    files = _write_files(tmp_path, n_lines=128)
    cfg = tmp_path / "run.cfg"
    cfg.write_text(f"""
[General]
vocabulary_size = 512
factor_num = 4
model_file = {tmp_path}/model
[Train]
train_files = {files[0]}
batch_size = 32
log_steps = 0
[Tpu]
max_features = 8
""")
    (tmp_path / "cli.json").write_text(json.dumps(
        ["train", str(cfg), "--device", "cpu"]))
    run_ranks("cli", 2, tmp_path)
    lines = [[ln.split(" ex/s=")[0] for ln in (tmp_path / f"rank{r}.log")
              .read_text().splitlines() if ln.startswith("train logloss=")]
             for r in range(2)]
    assert len(lines[0]) == 1 and lines[0] == lines[1], lines
    with np.load(checkpoint.params_path(str(tmp_path / "model"))) as z:
        assert int(z["scalar/step"]) == 4  # 128 lines / 32 per step
        assert z["params/table"].shape == (512, 5)


# ------------------------------------------------------ smaller units


@pytest.mark.parametrize("n_items, shards", [
    (0, 2), (1, 2), (7, 2), (8, 2), (9, 4), (12, 4), (5, 1), (3, 3),
])
def test_strided_rounds_matches_the_reference(n_items, shards):
    for shard in range(shards):
        assert (list(pipeline._strided_rounds(range(n_items), shard, shards))
                == list(jax_pipeline._strided_rounds(range(n_items), shard,
                                                     shards)))


def test_sharded_pipelines_deal_out_the_global_batches(tmp_path):
    """On the line stream (``fast_ingest = false``), whose order does not
    depend on the batch size, the data blocks' local batches glue into
    the single pipeline's global ones.  The raw-window stream cuts its
    windows at whole local batches, as the reference's does, so there a
    mesh's global batches are not a single device's
    (tests/test_torch_pipeline.py holds each block's batches to the
    reference's)."""
    files = _write_files(tmp_path, n_lines=200)
    cfg = FmConfig(vocabulary_size=256, batch_size=32, max_features=8,
                   shuffle_buffer=64, seed=3, fast_ingest=False)
    local = FmConfig(vocabulary_size=256, batch_size=16, max_features=8,
                     shuffle_buffer=64, seed=3, fast_ingest=False)
    with BatchPipeline(files, cfg, epochs=2) as p:
        whole = list(p)
    parts = []
    for block in range(2):
        with BatchPipeline(files, local, epochs=2, shard=(block, 2)) as p:
            parts.append(list(p))
    assert len(parts[0]) == len(parts[1])
    # Each epoch: 400 lines = 12 full global batches and a tail of 16,
    # which is one local batch: its round is incomplete and drops.
    assert len(parts[0]) == 2 * 12
    glued = [np.concatenate([a.ids, b.ids]) for a, b in zip(*parts)]
    want = [b.ids for b in whole if b.weights.sum() == 32]
    assert len(glued) == len(want)
    for g, w in zip(glued, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("data, model, world", [
    (1, 1, 1), (1, 1, 4), (2, 2, 4), (4, 1, 4), (1, 4, 4), (2, 4, 8),
    (2, 2, 2), (4, 2, 4),
])
def test_mesh_and_data_partition_match_the_reference(data, model, world,
                                                     monkeypatch):
    cfg = JaxFmConfig(mesh_data=data, mesh_model=model)
    devices = jax.devices()[:world]
    if data * model > world:
        with pytest.raises(ValueError):
            jax_mesh.make_mesh(cfg, devices)
        with pytest.raises(ValueError):
            mesh_lib.mesh_shape(data, model, world)
        return
    jm = jax_mesh.make_mesh(cfg, devices)
    shape = mesh_lib.mesh_shape(data, model, world)
    assert shape == jm.devices.shape
    # One process per device, as the port has one per rank.
    procs = np.array([types.SimpleNamespace(process_index=r)
                      for r in range(world)]).reshape(shape)
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        want = jax_mesh.data_partition(types.SimpleNamespace(devices=procs))
        mesh = mesh_lib.Mesh(*shape, rank=rank)
        assert mesh_lib.data_partition(mesh) == want
        assert mesh.coords == divmod(rank, shape[1])
        lo, n = mesh.row_range(4096)
        assert (lo, n) == (rank % shape[1] * 4096 // shape[1],
                           4096 // shape[1])
        table = np.arange(4096 * 2).reshape(4096, 2)
        np.testing.assert_array_equal(weights.shard_rows(table, mesh, rank),
                                      table[lo:lo + n])


def test_mesh_smaller_than_the_world_raises():
    with pytest.raises(ValueError, match="every rank"):
        mesh_lib.mesh_shape(2, 1, 4)


@pytest.mark.parametrize("argv", [
    [],
    ["--coordinator", "h0:1234", "--num_processes", "4", "--process_id",
     "2"],
    ["--worker_hosts", "h0:1,h1:2,h2:3", "--task_index", "1"],
    ["--worker_hosts", "h0:1,h1:2", "--job_name", "worker"],
    ["--ps_hosts", "p:1", "--worker_hosts", "h0:1", "--job_name",
     "worker", "--task_index", "0"],
])
def test_cli_dist_flags_map_as_the_reference(argv):
    full = ["train", "x.cfg"] + argv
    got = cli._resolve_dist(cli.build_argparser().parse_args(full))
    want = jax_cli._resolve_dist(jax_cli.build_argparser().parse_args(full))
    assert got == want


@pytest.mark.parametrize("argv", [
    ["--job_name", "ps", "--ps_hosts", "p:1"],
    ["--coordinator", "h0:1"],
])
def test_cli_dist_flags_exit_as_the_reference(argv):
    full = ["train", "x.cfg"] + argv
    with pytest.raises(SystemExit) as got:
        cli._resolve_dist(cli.build_argparser().parse_args(full))
    with pytest.raises(SystemExit) as want:
        jax_cli._resolve_dist(jax_cli.build_argparser().parse_args(full))
    assert (got.value.code == 0) == (want.value.code == 0)


@pytest.mark.parametrize("mode", ["predict", "serve"])
def test_cli_refuses_multi_rank_predict_and_serve(mode, tmp_path):
    # Serve's message names the grid of one process's devices.
    cfg = tmp_path / "run.cfg"
    cfg.write_text("[General]\nvocabulary_size = 64\n")
    with pytest.raises(NotImplementedError,
                       match="grid" if mode == "serve" else "single-process"):
        cli.main([mode, str(cfg), "--device", "cpu", "--coordinator",
                  "h0:1", "--num_processes", "2", "--process_id", "0"])


def test_backend_rule():
    # criteo_1tb_dist's layout: 16 ranks on four hosts of four GPUs each.
    hosts = [f"h{r // 4}" for r in range(16)]
    assert [dist.local_rank(hosts, r) for r in range(16)] == \
        [0, 1, 2, 3] * 4
    own = [f"{h}/gpu{dist.local_rank(hosts, r)}"
           for r, h in enumerate(hosts)]
    assert dist.backend_for(own) == "nccl"
    # The same GPU index on two hosts is two GPUs.
    assert dist.backend_for(["h0/gpu0", "h1/gpu0"]) == "nccl"
    # Two ranks on one host's only GPU, or any rank on the CPU.
    assert dist.backend_for(own[:15] + ["h3/gpu0"]) == "gloo"
    assert dist.backend_for(["h0/gpu0"] * 4) == "gloo"
    assert dist.backend_for(["cpu"] * 4) == "gloo"
    assert dist.backend_for(own[:15] + ["cpu"]) == "gloo"
    # Hosts interleaved by rank: local ranks count each host on its own.
    mixed = ["a", "b", "a", "b", "b"]
    assert [dist.local_rank(mixed, r) for r in range(5)] == [0, 0, 1, 1, 2]


def test_ranks_exchange_placements_through_the_store():
    # Four ranks on two hosts meet in one store, as initialize's ranks do.
    store, world = torch.distributed.HashStore(), 4
    hosts = ["h0", "h1", "h0", "h1"]
    got = [None] * world

    def rank(r):
        seen = dist._exchange(store, "host", r, world, hosts[r])
        got[r] = (seen, dist.local_rank(seen, r))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert [g[0] for g in got] == [hosts] * world
    assert [g[1] for g in got] == [0, 0, 1, 1]


@pytest.mark.parametrize("kw, err", [
    # One data shard: nothing to overlap, the reference's ValueError.
    (dict(sparse_exchange_overlap="on"), ValueError),
    (dict(sparse_exchange_overlap="on", lookup="shardmap"), ValueError),
    (dict(mesh_data=2, mesh_model=2), ValueError),  # one rank here
])
def test_trainer_mesh_refusals(kw, err):
    with pytest.raises(err):
        Trainer(FmConfig(vocabulary_size=2048, **kw), device="cpu")


def test_psum_and_all_gather_are_identities_on_one_rank():
    mesh = mesh_lib.Mesh(1, 1)
    t = torch.arange(6.0).reshape(3, 2)
    for axis in (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS):
        assert mesh_lib.psum(t, axis, mesh) is t
        assert mesh_lib.all_gather(t, axis, mesh) is t


def test_argparse_namespace_is_what_the_reference_reads():
    # The two CLIs define the same multi-rank flags with the same defaults.
    names = ("coordinator", "num_processes", "process_id", "ps_hosts",
             "worker_hosts", "job_name", "task_index")
    got = cli.build_argparser().parse_args(["train", "x.cfg"])
    want = jax_cli.build_argparser().parse_args(["train", "x.cfg"])
    assert isinstance(got, argparse.Namespace)
    assert {n: getattr(got, n) for n in names} == \
        {n: getattr(want, n) for n in names}


def test_sort_meta_leaves_out_only_a_last_segment_at_or_past_drop_from():
    # The whole slot [n + 1]: the tail past the last real segment holds
    # n, or the left-out segment's first sorted position (every segment
    # from there on empty); cut to its non-empty segments it is the
    # [U + 1] prefix.
    ids = torch.tensor([7, 2, 9, 2, 9, 5], dtype=torch.int32)
    full = sparse_apply.sort_meta(ids)
    assert full.seg_start.tolist() == [0, 2, 3, 4, 6, 6, 6]
    assert sparse_apply.cut_slot(full).seg_start.tolist() == [0, 2, 3, 4, 6]
    drop = sparse_apply.sort_meta(ids, drop_from=9)
    assert drop.seg_start.tolist() == [0, 2, 3, 4, 4, 4, 4]
    assert sparse_apply.cut_slot(drop).seg_start.tolist() == [0, 2, 3, 4]
    assert sparse_apply.sort_meta(ids, drop_from=10).seg_start.tolist() \
        == [0, 2, 3, 4, 6, 6, 6]
    only = torch.full((4,), 9, dtype=torch.int32)
    meta = sparse_apply.sort_meta(only, drop_from=9)
    assert meta.seg_start.tolist() == [0] * 5
    urows, sums = sparse_apply.k1_dedup_cuda(torch.ones((4, 3)), only,
                                             meta.perm, meta.seg_start)
    assert urows.tolist() == [-1] * 4 and not sums.any()
    cut = sparse_apply.cut_slot(meta)
    urows, sums = sparse_apply.k1_dedup_cuda(torch.ones((4, 3)), only,
                                             cut.perm, cut.seg_start)
    assert urows.numel() == 0 and sums.shape == (0, 6)
