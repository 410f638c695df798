"""The port's sparse training slice vs the JAX package on the CPU: the
sparse step, the metrics, the pipeline, the checkpoint's optimizer state,
and the CLI's train -> predict -> serve round trip.

Parameters and optimizer state cross packages as numpy arrays
(``weights.from_jax`` / ``weights.opt_state_from_jax``); JAX's threefry
init cannot be reproduced in torch, so the JAX initial state is handed
to the port.  Tolerances are the reference's (tests/test_sparse_apply.py):
``rtol=1e-4, atol=1e-6`` on the table, ``atol=1e-4`` on optimizer
tables, ``rtol=1e-5, atol=1e-7`` on w0.  The port's multi-step loop is
held against the reference's scatter path and its K = 1 tile path.
"""

import logging
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.data.libsvm import Batch as JaxBatch
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.train import metrics as jax_metrics
from fast_tffm_tpu.train import sparse as jax_sparse
from fast_tffm_tpu_torch import cli, weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import libsvm
from fast_tffm_tpu_torch.data.pipeline import BatchPipeline
from fast_tffm_tpu_torch.models import fm
from fast_tffm_tpu_torch.serve.scorer import make_scorer
from fast_tffm_tpu_torch.train import checkpoint, metrics, sparse
from fast_tffm_tpu_torch.train.loop import Trainer

TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-4, atol=1e-4)
W0_TOL = dict(rtol=1e-5, atol=1e-7)
V, F, B = 2048, 8, 64
BASE = dict(
    vocabulary_size=V, factor_num=8, max_features=F, batch_size=B,
    learning_rate=0.05, adagrad_initial_accumulator=0.1, ftrl_l1=0.01,
    ftrl_l2=0.1, ftrl_beta=1.0, factor_lambda=1e-3, bias_lambda=1e-3,
    l2_mode="batch",
)


def _batches(n, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, V, (B, F)).astype(np.int32)
        ids[:8, 0] = 5  # a duplicated id across examples
        vals = rng.uniform(0.1, 1.0, (B, F)).astype(np.float32)
        vals[:, -2:] = 0.0
        ids[:, -2:] = 0
        out.append(libsvm.Batch(
            labels=rng.integers(0, 2, B).astype(np.float32), ids=ids,
            vals=vals, fields=np.zeros((B, F), np.int32),
            weights=np.where(np.arange(B) < B - 4, 1.0, 0.0)
            .astype(np.float32),
        ))
    return out


def _opt_arrays(optimizer, opt):
    if optimizer == "adagrad":
        return [opt.acc.w0, opt.acc.table]
    if optimizer == "ftrl":
        return [opt.z.w0, opt.z.table, opt.n.w0, opt.n.table]
    return []


@pytest.mark.parametrize("optimizer, mode", [
    ("adagrad", "scatter"), ("adagrad", "tile"), ("ftrl", "scatter"),
    ("sgd", "scatter"),
])
def test_three_sparse_steps_match_jax(optimizer, mode):
    _three_steps_match_jax(optimizer, mode, "float32")


@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl"])
def test_three_bf16_sparse_steps_match_jax(optimizer):
    """``compute_dtype = bfloat16``: the port's step (its plain bf16
    interaction on the CPU) against the reference's, whose Pallas
    kernels run in interpret mode, within the tile-vs-scatter bounds."""
    _three_steps_match_jax(optimizer, "scatter", "bfloat16")


def _three_steps_match_jax(optimizer, mode, dtype):
    jcfg = JaxFmConfig(optimizer=optimizer, sparse_apply=mode,
                       compute_dtype=dtype, **BASE)
    cfg = FmConfig(optimizer=optimizer, compute_dtype=dtype, **BASE)
    params = jax_fm.init_params(jax.random.PRNGKey(0), jcfg)
    opt = jax_sparse.init_sparse_opt_state(jcfg, params)
    model = weights.from_jax(np.asarray(params.w0), np.asarray(params.table),
                             device="cpu")
    opt_t = weights.opt_state_from_jax(
        optimizer, jax.tree.map(np.asarray, opt), device="cpu"
    )
    # The port's own FTRL/Adagrad init agrees with the reference's.
    for got, want in zip(sparse.init_sparse_opt_state(cfg, model),
                         _opt_arrays(optimizer, opt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    step = jax.jit(lambda p, o, b: jax_sparse.sparse_step(jcfg, p, o, b))
    for i, batch in enumerate(_batches(3)):
        jb = JaxBatch(*(jnp.asarray(a) for a in batch[:5]))
        params, opt, want_scores = step(params, opt, jb)
        # Host sort meta on odd steps, device prep on even ones.
        if i % 2:
            batch = batch._replace(sort_meta=libsvm.host_sort_meta(batch.ids))
        got_scores = sparse.sparse_step(cfg, model, opt_t,
                                        sparse.to_device(batch, "cpu"))
        np.testing.assert_allclose(got_scores.numpy(),
                                   np.asarray(want_scores), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(model.table.detach().numpy(),
                               np.asarray(params.table), **TABLE_TOL)
    np.testing.assert_allclose(float(model.w0.detach()), float(params.w0),
                               **W0_TOL)
    for got, want in zip(opt_t, _opt_arrays(optimizer, opt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPT_TOL)


def test_auc_and_weighted_loss_match_jax():
    rng = np.random.default_rng(9)
    state_j = jax_metrics.auc_init()
    state_t = metrics.auc_init(device="cpu")
    for _ in range(3):
        scores = rng.normal(0, 2, 300).astype(np.float32)
        labels = rng.integers(0, 2, 300).astype(np.float32)
        w = rng.uniform(0, 2, 300).astype(np.float32)
        w[-20:] = 0.0
        state_j = jax_metrics.auc_update(state_j, jnp.asarray(scores),
                                         jnp.asarray(labels), jnp.asarray(w))
        args = [torch.from_numpy(a) for a in (scores, labels, w)]
        metrics.auc_add_(state_t, *args)
        for loss_type in ("logistic", "mse"):
            got = metrics.weighted_loss(*args, loss_type)
            want = jax_metrics.weighted_loss(
                jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(w),
                loss_type,
            )
            for g, x in zip(got, want):
                np.testing.assert_allclose(float(g), float(x), rtol=1e-5)
    np.testing.assert_allclose(state_t.pos.numpy(), np.asarray(state_j.pos),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state_t.neg.numpy(), np.asarray(state_j.neg),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(metrics.auc_finalize(state_t)),
                               float(jax_metrics.auc_finalize(state_j)),
                               rtol=1e-5)


def _write_lines(path, rows):
    with open(path, "w") as f:
        f.writelines(rows)


def test_pipeline_batches_shuffle_and_host_meta(tmp_path):
    lines = [f"{i % 2} {i}:1 {i + 1}:0.5\n" for i in range(10)]
    _write_lines(tmp_path / "a.libsvm", lines)
    cfg = FmConfig(vocabulary_size=64, batch_size=4, max_features=3,
                   shuffle_buffer=8, seed=3, queue_size=2)
    files = [str(tmp_path / "*.libsvm")]

    def run(**kw):
        with BatchPipeline(files, cfg, **kw) as p:
            return list(p)

    ordered = run(epochs=1, shuffle=False)
    assert [int(b.weights.sum()) for b in ordered] == [4, 4, 2]
    np.testing.assert_array_equal(ordered[0].ids[:, 0], [0, 1, 2, 3])
    assert ordered[0].sort_meta is None
    shuffled = run(epochs=2, shuffle=True, host_meta=True)
    again = run(epochs=2, shuffle=True, host_meta=True)
    assert len(shuffled) == 6
    for a, b in zip(shuffled, again):  # seeded: the same stream twice
        np.testing.assert_array_equal(a.ids, b.ids)
    firsts = sorted(int(i) for b in shuffled[:3] for i, w in
                    zip(b.ids[:, 0], b.weights) if w > 0)
    assert firsts == list(range(10))  # each line once per epoch
    meta = shuffled[0].sort_meta
    np.testing.assert_array_equal(
        meta.seg_start, libsvm.host_sort_meta(shuffled[0].ids).seg_start
    )
    # weight_files: one weight per line, parallel to the data file.
    _write_lines(tmp_path / "a.weights", [f"{i / 10}\n" for i in range(10)])
    with BatchPipeline(files, cfg, shuffle=False,
                       weight_files=[str(tmp_path / "a.weights")]) as p:
        weighted = list(p)
    np.testing.assert_allclose(weighted[1].weights, [0.4, 0.5, 0.6, 0.7],
                               rtol=1e-6)
    _write_lines(tmp_path / "b.libsvm", ["1 3:1\n", "0 4:zz\n"])
    with pytest.raises(ValueError, match="b.libsvm:2"):
        run(epochs=1, shuffle=False)


def test_checkpoint_keeps_optimizer_state(tmp_path):
    cfg = FmConfig(optimizer="ftrl", **BASE)
    model = weights.from_jax(0.5, np.random.default_rng(1).uniform(
        -0.1, 0.1, (V, 9)).astype(np.float32), device="cpu")
    opt = sparse.init_sparse_opt_state(cfg, model)
    path = checkpoint.save_params(str(tmp_path), model, step=7,
                                  opt_state=opt)
    with np.load(path) as z:
        assert {"opt/z_w0", "opt/z_table", "opt/n_w0",
                "opt/n_table"} <= set(z.files)
    back = checkpoint.restore_opt_state(str(tmp_path), "ftrl", device="cpu")
    for a, b in zip(back, opt):
        assert torch.equal(a, b)
    assert checkpoint.restore_opt_state(str(tmp_path), "adagrad",
                                        device="cpu") is None
    assert checkpoint.restore_opt_state(str(tmp_path), "sgd",
                                        device="cpu") == ()


@pytest.mark.parametrize("kw, item", [
    (dict(sparse_update=False, mesh_data=2), "item 3"),
    (dict(optimizer="adam", mesh_data=2), "item 3"),
    (dict(field_num=2, mesh_data=2), "item 3"),
    (dict(mesh_data=2, compute_dtype="bfloat16"), "item 3"),
    (dict(table_tiering="on", tiered_partition="shards"), "item 3"),
    (dict(mesh_data=2, sparse_exchange_overlap="on"), "item 3"),
])
def test_trainer_refuses_unported_settings(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        Trainer(FmConfig(vocabulary_size=V, **kw), device="cpu")


def test_trainer_logs_the_interaction_knobs_as_inert(caplog):
    """``interaction`` and ``use_pallas`` choose among the reference's
    implementations; the port always runs its kernels and says so."""
    with caplog.at_level(logging.INFO):
        Trainer(FmConfig(vocabulary_size=V, interaction="jnp",
                         use_pallas=False), device="cpu")
    assert "does not act on interaction, use_pallas" in caplog.text


def test_sharded_step_refuses_ffm_naming_item_3():
    """A direct caller of the sharded step gets the queue item the
    trainer names for field-aware FM on a mesh."""
    from fast_tffm_tpu_torch.train.shardmap_step import sparse_step_shardmap

    with pytest.raises(NotImplementedError, match="item 3"):
        sparse_step_shardmap(FmConfig(vocabulary_size=V, field_num=2), None,
                             None, None, None)


@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl"])
def test_bf16_loss_tracks_f32(optimizer):
    """20 steps of bf16-compute training end within 1e-2 logloss of the
    same steps in f32 (the reference's ``tests/test_bf16.py::
    TestTrainingParity``), from one initial table."""
    shape = dict(vocabulary_size=2048, factor_num=8, max_features=16,
                 batch_size=256, learning_rate=0.05)
    init = fm.init_params(FmConfig(**shape),
                          torch.Generator().manual_seed(0), device="cpu")
    last = {}
    for dtype in ("float32", "bfloat16"):
        cfg = FmConfig(optimizer=optimizer, compute_dtype=dtype, **shape)
        model = fm.FmModel(init.w0.detach().clone(),
                           init.table.detach().clone())
        opt = sparse.init_sparse_opt_state(cfg, model)
        rng = np.random.default_rng(7)
        for _ in range(20):
            b, f, v = 256, 16, 2048
            batch = libsvm.Batch(
                labels=(rng.random(b) < 0.4).astype(np.float32),
                ids=rng.integers(0, v, size=(b, f)).astype(np.int32),
                vals=rng.uniform(0.1, 1.0, size=(b, f)).astype(np.float32),
                fields=np.zeros((b, f), np.int32),
                weights=np.ones((b,), np.float32),
            )
            scores = sparse.sparse_step(cfg, model, opt,
                                        sparse.to_device(batch, "cpu"))
            last[dtype] = float(fm.example_losses(
                scores, torch.from_numpy(batch.labels), "logistic").mean())
    assert abs(last["bfloat16"] - last["float32"]) < 1e-2


def _gen(path, n, rng, w, v, n_feat=10):
    """Planted-structure libsvm lines (examples/gen_sample_data.py)."""
    rows = []
    for _ in range(n):
        ids = rng.choice(len(w), size=n_feat, replace=False)
        vals = np.round(rng.uniform(0.2, 1.0, size=n_feat), 3)
        xv = v[ids] * vals[:, None]
        score = w[ids] @ vals + 0.5 * (xv.sum(0) @ xv.sum(0) - (xv ** 2).sum())
        label = int(rng.uniform() < 1.0 / (1.0 + np.exp(-2.5 * score)))
        rows.append(f"{label} " + " ".join(
            f"{i}:{x}" for i, x in zip(ids, vals)) + "\n")
    _write_lines(path, rows)


def test_cli_train_predict_then_serve_the_checkpoint(tmp_path, capsys):
    rng = np.random.default_rng(42)
    vocab = 300
    w = rng.normal(0, 0.5, vocab)
    v = rng.normal(0, 0.3, (vocab, 4))
    _gen(tmp_path / "train.libsvm", 3000, rng, w, v)
    _gen(tmp_path / "valid.libsvm", 500, rng, w, v)
    model_dir = tmp_path / "model"
    scores_path = tmp_path / "scores.txt"
    cfg_path = tmp_path / "run.cfg"
    cfg_path.write_text(f"""
[General]
vocabulary_size = {vocab}
factor_num = 4
model_file = {model_dir}
[Train]
train_files = {tmp_path}/train.libsvm
validation_files = {tmp_path}/valid.libsvm
epoch_num = 4
batch_size = 200
learning_rate = 0.5
adagrad.initial_accumulator = 0.01
optimizer = adagrad
factor_lambda = 0.0001
bias_lambda = 0.0001
init_value_range = 0.05
shuffle_buffer = 1000
log_steps = 20
[Predict]
predict_files = {tmp_path}/valid.libsvm
score_path = {scores_path}
[Tpu]
max_features = 12
""")
    assert cli.main(["train", str(cfg_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    val = [ln for ln in out.splitlines() if ln.startswith("validation")]
    assert val, out
    val_loss = float(val[0].split("logloss=")[1].split()[0])
    assert val_loss < 0.693, out
    with np.load(checkpoint.params_path(str(model_dir))) as z:
        assert int(z["scalar/step"]) == 60  # 4 epochs x 15 batches
        assert "opt/acc_table" in z.files
    assert cli.main(["predict", str(cfg_path), "--device", "cpu"]) == 0
    lines = scores_path.read_text().splitlines()
    assert len(lines) == 500
    got = np.array([float(s) for s in lines])
    assert np.all((got > 0) & (got < 1))
    # The serve scorer restores the trained checkpoint and scores the
    # predict file as predict did.
    from fast_tffm_tpu_torch.config import load_config

    cfg = load_config(str(cfg_path))
    scorer = make_scorer(cfg, device="cpu")
    with BatchPipeline(cfg.predict_files, cfg, shuffle=False) as p:
        served = np.concatenate([scorer.score(b.ids, b.vals)[b.weights > 0]
                                 for b in p])
    np.testing.assert_allclose(served, got, atol=5e-7)
    # A warm start resumes from the saved step and optimizer state.
    trainer = Trainer(cfg, device="cpu")
    assert trainer._restored_step == 60
    assert float(trainer.opt_state.acc_table.min()) >= 0.01
    assert os.path.isfile(checkpoint.params_path(str(model_dir)))


def test_cli_train_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    cfg_path = tmp_path / "run.cfg"
    cfg_path.write_text(f"[General]\nvocabulary_size = 64\n"
                        f"model_file = {tmp_path}/m\n"
                        f"[Train]\ntrain_files = {tmp_path}/none\n")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["train", str(cfg_path)])


def test_cli_trains_in_bf16_validates_and_saves_f32(tmp_path, capsys):
    """``compute_dtype = bfloat16`` through the CLI: training runs the
    bf16 interaction, validation scores in f32, and ``params.npz`` keeps
    f32 weights and optimizer state."""
    rng = np.random.default_rng(3)
    vocab = 200
    w = rng.normal(0, 0.5, vocab)
    v = rng.normal(0, 0.3, (vocab, 4))
    _gen(tmp_path / "train.libsvm", 1200, rng, w, v)
    _gen(tmp_path / "valid.libsvm", 300, rng, w, v)
    cfg_path = tmp_path / "run.cfg"
    cfg_path.write_text(f"""
[General]
vocabulary_size = {vocab}
factor_num = 4
model_file = {tmp_path}/model
[Train]
train_files = {tmp_path}/train.libsvm
validation_files = {tmp_path}/valid.libsvm
epoch_num = 3
batch_size = 100
learning_rate = 0.5
adagrad.initial_accumulator = 0.01
compute_dtype = bfloat16
[Tpu]
max_features = 12
""")
    assert cli.main(["train", str(cfg_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    val = [ln for ln in out.splitlines() if ln.startswith("validation")]
    assert val, out
    assert float(val[0].split("logloss=")[1].split()[0]) < 0.693, out
    with np.load(checkpoint.params_path(str(tmp_path / "model"))) as z:
        assert int(z["scalar/step"]) == 36
        for key in ("params/table", "scalar/w0", "opt/acc_table"):
            assert z[key].dtype == np.float32, key


def _snapshotting(trainer_cls, monkeypatch, which: int, snap: str):
    """Patch ``trainer_cls.save`` to copy the model directory, as a run
    interrupted right after its ``which``-th save would leave it."""
    import shutil

    orig = trainer_cls.save
    calls = [0]

    def save(self, stepno):
        out = orig(self, stepno)
        calls[0] += 1
        if calls[0] == which:
            shutil.copytree(self.cfg.model_file, snap)
        return out

    monkeypatch.setattr(trainer_cls, "save", save)


@pytest.mark.parametrize("k, which, position", [
    (1, 1, (0, 5)),   # saved mid-epoch 0 (step 5)
    (1, 3, (1, 3)),   # saved mid-epoch 1 (step 15)
    (3, 1, (0, 6)),   # K = 3: a super-batch boundary (step 6)
])
def test_resume_mid_epoch_matches_the_reference(tmp_path, monkeypatch, k,
                                                which, position):
    """A run saved every 5 steps, restarted from a mid-epoch checkpoint:
    the port continues the stream from the saved position
    (``data_state.json``) as the reference does from its own, and ends
    where the reference's restarted run ends; the port's restarted run
    ends where its uninterrupted run ended."""
    import dataclasses
    import json

    from fast_tffm_tpu.train.loop import Trainer as JaxTrainer

    rng = np.random.default_rng(42)
    vocab = 300
    w = rng.normal(0, 0.5, vocab)
    v = rng.normal(0, 0.3, (vocab, 4))
    path = str(tmp_path / "train.libsvm")
    _gen(path, 1500, rng, w, v)  # 12 batches of 128 an epoch
    common = dict(
        vocabulary_size=vocab, factor_num=4, max_features=12,
        batch_size=128, epoch_num=2, learning_rate=0.5,
        adagrad_initial_accumulator=0.01, optimizer="adagrad",
        factor_lambda=1e-4, bias_lambda=1e-4, init_value_range=0.05,
        shuffle_buffer=400, seed=7, train_files=[path], log_steps=0,
        save_steps=5, steps_per_dispatch=k, thread_num=2,
    )
    saved_step = 12 * position[0] + position[1]
    # The reference: the full run, its checkpoint after save `which`,
    # and a run restarted from that checkpoint.
    jcfg = JaxFmConfig(model_file=str(tmp_path / "jax_model"),
                       sparse_apply="scatter", **common)
    jt = JaxTrainer(jcfg)
    init = jax.tree.map(np.asarray, jt.state.params)
    _snapshotting(JaxTrainer, monkeypatch, which, str(tmp_path / "jax_snap"))
    jt.train()
    monkeypatch.undo()
    jr = JaxTrainer(dataclasses.replace(jcfg,
                                        model_file=str(tmp_path / "jax_snap")))
    jres = jr.train()
    # The port, from the reference's initial table.
    port_dir = str(tmp_path / "port_model")
    checkpoint.save_params(port_dir, weights.from_jax(init.w0, init.table,
                                                      device="cpu"))
    cfg = FmConfig(model_file=port_dir, **common)
    _snapshotting(Trainer, monkeypatch, which, str(tmp_path / "port_snap"))
    full = Trainer(cfg, device="cpu")
    full.train()
    monkeypatch.undo()
    snap = str(tmp_path / "port_snap")
    ds_path = os.path.join(snap, "data_state.json")
    saved = (json.loads(open(ds_path).read()) if os.path.exists(ds_path)
             else None)
    resumed = Trainer(dataclasses.replace(cfg, model_file=snap), device="cpu")
    assert resumed._restored_step == saved_step
    pres = resumed.train()
    assert pres["train"]["steps"] == jres["train"]["steps"] == 24 - saved_step
    assert pres["train"]["examples"] == jres["train"]["examples"]
    assert (saved["epoch"], saved["batches_done"]) == position
    assert saved["fingerprint"]["seed"] == 7
    ds = checkpoint.restore_data_state(snap)
    assert (ds["epoch"], ds["batches_done"]) == (2, 0)
    params = jr.state.params
    np.testing.assert_allclose(resumed.model.table.detach().numpy(),
                               np.asarray(params.table), **TABLE_TOL)
    np.testing.assert_allclose(float(resumed.model.w0.detach()),
                               float(params.w0), **W0_TOL)
    np.testing.assert_allclose(resumed.opt_state.acc_table.numpy(),
                               np.asarray(jr.state.opt_state.acc.table),
                               **OPT_TOL)
    # The interrupted run ends where the uninterrupted one did.
    np.testing.assert_array_equal(resumed.model.table.detach().numpy(),
                                  full.model.table.detach().numpy())
    np.testing.assert_array_equal(resumed.opt_state.acc_table.numpy(),
                                  full.opt_state.acc_table.numpy())


def test_resume_rules(tmp_path, caplog):
    """The reference's rules: a completed run's position trains
    ``epoch_num`` fresh epochs; a position saved under another stream
    (here another seed) is ignored with a warning; a position beside
    parameters that were not restored, or were saved at step 0
    (imported weights), is not used."""
    import dataclasses
    import json
    import logging

    rng = np.random.default_rng(1)
    _gen(tmp_path / "t.libsvm", 640, rng, rng.normal(0, 0.5, 100),
         rng.normal(0, 0.3, (100, 4)))
    cfg = FmConfig(vocabulary_size=100, factor_num=4, max_features=12,
                   batch_size=128, epoch_num=1, log_steps=0, seed=3,
                   train_files=[str(tmp_path / "t.libsvm")],
                   model_file=str(tmp_path / "m"))
    assert Trainer(cfg, device="cpu").train()["train"]["steps"] == 5
    assert Trainer(cfg, device="cpu").train()["train"]["steps"] == 5
    path = checkpoint.data_state_path(cfg.model_file)
    with open(path) as f:
        ds = json.load(f)
    ds.update(epoch=0, batches_done=3)
    with open(path, "w") as f:
        json.dump(ds, f)
    assert Trainer(cfg, device="cpu").train()["train"]["steps"] == 2
    with open(path, "w") as f:
        json.dump(ds, f)
    with caplog.at_level(logging.WARNING):
        steps = Trainer(dataclasses.replace(cfg, seed=4),
                        device="cpu").train()["train"]["steps"]
    assert steps == 5 and "different input config" in caplog.text
    # Weights saved at step 0 with no position leave the stale one in
    # place; it is not read (the reference gates on the restored step).
    _, model = checkpoint.restore_params(cfg.model_file, device="cpu")
    checkpoint.save_params(cfg.model_file, model, step=0)
    with open(path, "w") as f:
        json.dump(ds, f)
    assert Trainer(cfg, device="cpu").train()["train"]["steps"] == 5
    os.remove(checkpoint.params_path(cfg.model_file))
    with open(path, "w") as f:
        json.dump(ds, f)
    assert Trainer(cfg, device="cpu").train()["train"]["steps"] == 5


def test_validation_and_predict_match_the_reference(tmp_path):
    """From the reference's initial table, the port and the reference
    (scatter path, host sort meta) train two epochs of planted-structure
    lines, then validate and predict: the validation metrics agree
    within the tile-vs-scatter bounds' effect on the scores, the counts
    and ``truncated_features`` exactly, and the score files to their
    printed six decimals (one unit of the last digit: scores ~1e-7
    apart may round either way)."""
    from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
    from fast_tffm_tpu.train.loop import predict as jax_predict
    from fast_tffm_tpu_torch.train.loop import predict

    rng = np.random.default_rng(8)
    vocab = 300
    w = rng.normal(0, 0.5, vocab)
    v = rng.normal(0, 0.3, (vocab, 4))
    _gen(tmp_path / "train.libsvm", 1100, rng, w, v, n_feat=14)
    _gen(tmp_path / "valid.libsvm", 450, rng, w, v)
    common = dict(
        vocabulary_size=vocab, factor_num=4, max_features=12,
        batch_size=128, epoch_num=2, learning_rate=0.5,
        adagrad_initial_accumulator=0.01, optimizer="adagrad",
        factor_lambda=1e-4, bias_lambda=1e-4, init_value_range=0.05,
        shuffle_buffer=400, seed=9, log_steps=0, save_steps=0,
        train_files=[str(tmp_path / "train.libsvm")],
        validation_files=[str(tmp_path / "valid.libsvm")],
        predict_files=[str(tmp_path / "valid.libsvm")], host_sort=True,
    )
    jcfg = JaxFmConfig(model_file=str(tmp_path / "jax_model"),
                       score_path=str(tmp_path / "jax_scores.txt"),
                       sparse_apply="scatter", **common)
    jt = JaxTrainer(jcfg)
    init = jax.tree.map(np.asarray, jt.state.params)
    jres = jt.train()
    port_dir = str(tmp_path / "port_model")
    checkpoint.save_params(port_dir, weights.from_jax(init.w0, init.table,
                                                      device="cpu"))
    cfg = FmConfig(model_file=port_dir,
                   score_path=str(tmp_path / "port_scores.txt"), **common)
    pres = Trainer(cfg, device="cpu").train()
    for key in ("steps", "examples", "truncated_features"):
        assert pres["train"][key] == jres["train"][key], key
    assert pres["train"]["truncated_features"] > 0  # 14 features over 12
    got, want = pres["validation"], jres["validation"]
    assert got["examples"] == want["examples"] == 450
    assert got["weight_sum"] == want["weight_sum"]
    np.testing.assert_allclose(got["logloss"], want["logloss"], rtol=1e-5)
    np.testing.assert_allclose(got["auc"], want["auc"], atol=1e-4)
    assert jax_predict(jcfg) == 450
    assert predict(cfg, device="cpu") == 450
    port_scores = np.loadtxt(cfg.score_path)
    jax_scores = np.loadtxt(jcfg.score_path)
    np.testing.assert_allclose(port_scores, jax_scores, rtol=0, atol=1.01e-6)
