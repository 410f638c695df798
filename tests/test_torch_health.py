"""The port's training-health carry and ``nan_policy`` vs the JAX package
on the CPU.

The same libsvm stream and the reference's initial table (handed to the
port as a step-0 checkpoint) go through the reference's ``Trainer`` and
the port's: the exact health summary of a clean run and of a run whose
``w0`` is NaN before training agrees in ``nonfinite_steps``,
``first_nonfinite_step``, ``emb_rows_touched`` and ``emb_touch_events``
exactly, and in ``grad_norm`` and ``grad_norm_rms`` at ``rtol=1e-4`` (the
sparse apply's table bound), for the sparse and the dense path.  Then
the reference's ``nan_policy`` cases (``tests/test_tracing.py``) on the
port: ``halt`` within one dispatch with a final record naming the
exception, ``warn`` running to the end, per-run reporting on a second
``train()``, and a halt before a coinciding periodic save.  The steps'
health pairs are held against the reference's ``grad_health`` and
``_tree_grad_health``, the sharded steps' on a 1 x 1 mesh against the
one-device steps', and a 2 x 2 mesh's summary (four ranks) against one
device's.  Sizes are the reference tests': V = 50, factor_num
= 4, B = 32, 640 lines (20 steps).
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.train import loop as jax_loop
from fast_tffm_tpu.train import sparse as jax_sparse
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import libsvm
from fast_tffm_tpu_torch.train import checkpoint, dense, sparse
from fast_tffm_tpu_torch.train.loop import (
    HealthState, NonFiniteGradError, Trainer,
)

GRAD_TOL = dict(rtol=1e-4)
EXACT = ("nonfinite_steps", "first_nonfinite_step", "emb_rows_touched",
         "emb_touch_events")


def _write_libsvm(path, n_lines, vocab=50, n_feat=3, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_lines):
            feats = rng.choice(vocab, size=n_feat, replace=False)
            toks = " ".join(f"{i}:{rng.uniform(0.1, 1):.3f}" for i in feats)
            f.write(f"{rng.integers(0, 2)} {toks}\n")
    return str(path)


def _common(data, **kw):
    out = dict(vocabulary_size=50, factor_num=4, train_files=[data],
               epoch_num=1, batch_size=32, max_features=4, log_steps=0,
               thread_num=2, steps_per_dispatch=2, seed=3)
    out.update(kw)
    return out


@pytest.fixture(scope="module")
def train_file(tmp_path_factory):
    out = tmp_path_factory.mktemp("health_data")
    return _write_libsvm(out / "train.libsvm", 640)


def _jax_poison(trainer):
    trainer.state = trainer.state._replace(
        params=trainer.state.params._replace(
            w0=jnp.full((), jnp.nan, jnp.float32)))


def _poison(trainer):
    """``w0 = NaN`` in place: every later gradient is non-finite (a
    captured graph would keep reading the same tensor)."""
    with torch.no_grad():
        trainer.model.w0.detach().fill_(float("nan"))


def _pair(tmp_path, data, tag, **kw):
    """The reference's trainer and the port's, from the reference's
    initial table."""
    common = _common(data, **kw)
    jt = JaxTrainer(JaxFmConfig(model_file=str(tmp_path / f"jax_{tag}"),
                                sparse_apply="scatter", **common))
    init = jax.tree.map(np.asarray, jt.state.params)
    port_dir = str(tmp_path / f"port_{tag}")
    checkpoint.save_params(port_dir, weights.from_jax(init.w0, init.table,
                                                      device="cpu"))
    pt = Trainer(FmConfig(model_file=port_dir, **common), device="cpu")
    return jt, pt


def _assert_health_equal(port: dict, ref: dict) -> None:
    for key in EXACT:
        assert port[key] == ref[key], (key, port[key], ref[key])
    for key in ("grad_norm", "grad_norm_rms"):
        np.testing.assert_allclose(port[key], ref[key], **GRAD_TOL,
                                   err_msg=key)
    assert port["emb_row_occupancy"] == ref["emb_row_occupancy"]


@pytest.mark.parametrize("poisoned", [False, True], ids=["clean", "poisoned"])
@pytest.mark.parametrize("path", ["sparse", "dense"])
def test_health_summary_matches_the_reference(tmp_path, train_file, path,
                                              poisoned):
    kw = dict(nan_policy="warn")
    if path == "dense":
        kw.update(sparse_update=False, optimizer="adam", learning_rate=0.01)
    jt, pt = _pair(tmp_path, train_file, path, **kw)
    if poisoned:
        _jax_poison(jt)
        _poison(pt)
    ref = jt.train()["train"]["health"]
    port = pt.train()["train"]["health"]
    _assert_health_equal(port, ref)
    assert port["nonfinite_steps"] == (20 if poisoned else 0)
    assert port["first_nonfinite_step"] == (0 if poisoned else -1)
    assert port["emb_touch_events"] == 640 * 3


def test_step_health_pairs_match_the_references_reductions():
    """The sparse step's pair is ``grad_health`` over its own row
    gradients and ``dw0``, and over the whole table gradient the dense
    step's (the reference's ``_tree_grad_health``); an inf and a NaN
    count as the reference counts them."""
    rng = np.random.default_rng(0)
    g = rng.normal(0, 0.1, (96, 5)).astype(np.float32)
    g[3, 2] = np.inf
    g[7, 0] = np.nan
    dw0 = np.float32(0.25)
    gs_ref, nf_ref = jax_sparse.grad_health(jnp.asarray(g), jnp.asarray(dw0))
    gs, nf = sparse.grad_health(torch.from_numpy(g), torch.tensor(dw0))
    assert int(nf) == int(nf_ref) == 2 and nf.dtype == torch.int32
    assert np.isnan(float(gs)) and np.isnan(float(gs_ref))
    g[3, 2] = g[7, 0] = 0.5
    gs_ref, nf_ref = jax_sparse.grad_health(jnp.asarray(g), jnp.asarray(dw0))
    gs, nf = sparse.grad_health(torch.from_numpy(g), torch.tensor(dw0))
    assert int(nf) == int(nf_ref) == 0
    np.testing.assert_allclose(float(gs), float(gs_ref), **GRAD_TOL)
    table = rng.normal(0, 0.1, (50, 5)).astype(np.float32)
    gs_ref, nf_ref = jax_loop._tree_grad_health(
        (jnp.asarray(dw0), jnp.asarray(table)))
    gs, nf = sparse.grad_health(torch.from_numpy(table), torch.tensor(dw0))
    assert int(nf) == int(nf_ref) == 0
    np.testing.assert_allclose(float(gs), float(gs_ref), **GRAD_TOL)


def test_health_update_matches_the_references_carry():
    """Three steps of the carry's update against the reference's
    ``make_health_update`` on the same pairs and batches (padded slots
    drop out; the first bad step is stamped by the device counter)."""
    rng = np.random.default_rng(1)
    vocab = 50
    jcfg = JaxFmConfig(vocabulary_size=vocab)
    upd = jax_loop.make_health_update(jcfg)
    jh = jax_loop.HealthState.zeros(vocab)
    th = HealthState.zeros(vocab, "cpu")
    for step, (gs, nf) in enumerate(((0.5, 0), (0.25, 3), (2.0, 1))):
        ids = rng.integers(0, vocab, (8, 4)).astype(np.int32)
        vals = rng.uniform(0.1, 1.0, (8, 4)).astype(np.float32)
        vals[:, -1] = 0.0
        batch = libsvm.Batch(np.zeros(8, np.float32), ids, vals,
                             np.zeros((8, 4), np.int32),
                             np.ones(8, np.float32))
        state = jax_loop.TrainState(None, None, None,
                                    jnp.asarray(step + 1, jnp.int32))
        jh = upd(jh, state, jax.tree.map(jnp.asarray, batch),
                 (jnp.float32(gs), jnp.int32(nf)))
        th.update_(torch.tensor(gs, dtype=torch.float32),
                   torch.tensor(nf, dtype=torch.int32),
                   sparse.to_device(batch, "cpu"))
    assert int(th.nonfinite_steps) == int(jh.nonfinite_steps) == 2
    assert int(th.first_nonfinite_step) == int(jh.first_nonfinite_step) == 1
    assert float(th.grad_sq_last) == float(jh.grad_sq_last)
    assert float(th.grad_sq_sum) == float(jh.grad_sq_sum)
    assert float(th.touch_events) == float(jh.touch_events) == 72.0
    np.testing.assert_array_equal(th.rows_touched.numpy(),
                                  np.asarray(jh.rows_touched))
    assert int(th.step) == 3
    th.reset_()
    assert (int(th.step), int(th.first_nonfinite_step),
            int(th.rows_touched.sum())) == (0, -1, 0)


def test_sharded_step_health_is_the_one_device_steps(tmp_path):
    """On a 1 x 1 mesh (no process group: every sum over an axis is the
    identity) the sharded step's pair is the one-device step's, within
    the sharded step's own bounds."""
    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.parallel.mesh import Mesh
    from fast_tffm_tpu_torch.train import shardmap_step

    cfg = FmConfig(vocabulary_size=512, factor_num=4, max_features=8,
                   batch_size=32, learning_rate=0.05,
                   factor_lambda=0.01, bias_lambda=0.002)
    init = fm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 512, (32, 8)).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, (32, 8)).astype(np.float32)
    vals[:, -1] = 0.0
    batch = sparse.to_device(libsvm.Batch(
        rng.integers(0, 2, 32).astype(np.float32), ids, vals,
        np.zeros((32, 8), np.int32), np.ones(32, np.float32)), "cpu")
    pairs = []
    for step in (sparse.sparse_step, "sharded"):
        model = fm.FmModel(init.w0.detach().clone(),
                           init.table.detach().clone())
        opt = sparse.init_sparse_opt_state(cfg, model)
        if step == "sharded":
            _, pair = shardmap_step.sparse_step_shardmap(
                cfg, model, opt, batch, Mesh(1, 1), health=True)
        else:
            _, pair = step(cfg, model, opt, batch, health=True)
        pairs.append(pair)
    (gs_a, nf_a), (gs_b, nf_b) = pairs
    assert int(nf_a) == int(nf_b) == 0
    np.testing.assert_allclose(float(gs_b), float(gs_a), rtol=1e-5)


class TestNanPolicy:
    """The reference's ``tests/test_tracing.py::TestNanPolicy`` on the
    port."""

    def test_halt_raises_within_one_dispatch(self, train_file, tmp_path):
        k = 4
        mf = str(tmp_path / "halt.jsonl")
        t = Trainer(FmConfig(
            model_file=str(tmp_path / "m"), nan_policy="halt",
            metrics_file=mf, **_common(train_file, steps_per_dispatch=k)),
            device="cpu")
        _poison(t)
        with pytest.raises(NonFiniteGradError):
            t.train()
        # The poisoned dispatch is #0; its scalars are consumed right
        # after dispatch #1: at most 2K steps ever ran.
        assert 0 < int(t.health.step) <= 2 * k
        assert not checkpoint.exists(t.cfg.model_file)
        recs = [json.loads(line) for line in open(mf)]
        finals = [r for r in recs if r.get("record") == "final"]
        assert len(finals) == 1
        assert finals[0]["exception"] == "NonFiniteGradError"
        assert finals[0]["health"]["nonfinite_steps"] > 0
        assert finals[0]["health"]["first_nonfinite_step"] == 0

    def test_warn_completes_and_reports(self, train_file, tmp_path):
        mf = str(tmp_path / "warn.jsonl")
        t = Trainer(FmConfig(
            model_file=str(tmp_path / "m"), nan_policy="warn",
            metrics_file=mf, **_common(train_file, steps_per_dispatch=4)),
            device="cpu")
        _poison(t)
        health = t.train()["train"]["health"]  # must not raise
        assert health["nonfinite_steps"] == 20
        assert health["first_nonfinite_step"] == 0
        recs = [json.loads(line) for line in open(mf)]
        final = [r for r in recs if r.get("record") == "final"][-1]
        assert "exception" not in final
        assert final["health"]["nonfinite_steps"] == 20
        assert final["health"]["first_nonfinite_step"] == 0

    def test_health_reporting_is_per_run(self, train_file, tmp_path):
        t = Trainer(FmConfig(model_file=str(tmp_path / "m"),
                             nan_policy="warn", **_common(train_file)),
                    device="cpu")
        r1 = t.train()["train"]["health"]
        assert r1["nonfinite_steps"] == 0
        _poison(t)
        r2 = t.train()["train"]["health"]
        assert r2["nonfinite_steps"] == 20
        assert r2["first_nonfinite_step"] == 0  # the run's step base
        assert r2["emb_touch_events"] == r1["emb_touch_events"] == 1920.0

    def test_halt_blocks_periodic_save_of_poisoned_params(
            self, train_file, tmp_path):
        t = Trainer(FmConfig(
            model_file=str(tmp_path / "m"), nan_policy="halt",
            save_steps=4, **_common(train_file, steps_per_dispatch=4)),
            device="cpu")
        _poison(t)
        with pytest.raises(NonFiniteGradError):
            t.train()
        # The first save coincided with the poisoned dispatch; its
        # health was read first, so no checkpoint exists.
        assert not checkpoint.exists(t.cfg.model_file)

    def test_clean_save_survives_a_later_halt(self, train_file, tmp_path):
        """A periodic save of clean steps stays, and nothing newer is
        written once the poison trains: the halt comes at the next
        save boundary's forced read."""
        k = 2
        t = Trainer(FmConfig(
            model_file=str(tmp_path / "m"), nan_policy="halt",
            save_steps=k, **_common(train_file, steps_per_dispatch=k)),
            device="cpu")
        real = t.dispatch
        calls = []

        def poison_second(sb, pause=None):
            if len(calls) == 1:
                _poison(t)
            calls.append(sb.n)
            return real(sb, pause)

        t.dispatch = poison_second
        with pytest.raises(NonFiniteGradError):
            t.train()
        assert len(calls) == 2
        step, _ = checkpoint.restore_params(t.cfg.model_file, device="cpu")
        assert step == k  # the clean dispatch's save, nothing newer
        ds = json.loads(open(os.path.join(t.cfg.model_file,
                                          "data_state.json")).read())
        assert ds["batches_done"] == k


def test_dense_sharded_health_is_the_one_device_steps():
    """The dense mesh step's pair on a 1 x 1 mesh is the one-device dense
    step's (the whole gradient's squares, ``dw0`` included)."""
    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.parallel.mesh import Mesh
    from fast_tffm_tpu_torch.train import optimizers

    cfg = FmConfig(vocabulary_size=256, factor_num=4, max_features=8,
                   batch_size=32, learning_rate=0.01, optimizer="adam",
                   sparse_update=False, l2_mode="full", factor_lambda=1e-3,
                   bias_lambda=1e-3)
    init = fm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, (32, 8)).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, (32, 8)).astype(np.float32)
    host = libsvm.Batch(rng.integers(0, 2, 32).astype(np.float32), ids,
                        vals, np.zeros((32, 8), np.int32),
                        np.ones(32, np.float32))
    batch = sparse.to_device(host, "cpu")
    pairs = []
    for sharded in (False, True):
        model = fm.FmModel(init.w0.detach().clone(),
                           init.table.detach().clone())
        opt = optimizers.init_dense_opt_state(cfg, model)
        if sharded:
            _, pair = dense.dense_step_sharded(cfg, model, opt, batch,
                                               Mesh(1, 1), health=True)
        else:
            _, pair = dense.dense_step(cfg, model, opt, batch, health=True)
        pairs.append(pair)
    (gs_a, nf_a), (gs_b, nf_b) = pairs
    assert int(nf_a) == int(nf_b) == 0
    np.testing.assert_allclose(float(gs_b), float(gs_a), rtol=1e-5)


def test_device_step_and_train_step_carry_no_health(train_file, tmp_path):
    """As the reference's ``_train_step``: only ``train()``'s dispatches
    advance the carry."""
    t = Trainer(FmConfig(model_file=str(tmp_path / "m"),
                         **_common(train_file)), device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, (32, 4)).astype(np.int32)
    t.train_step(libsvm.Batch(
        np.zeros(32, np.float32), ids,
        rng.uniform(0.1, 1, (32, 4)).astype(np.float32),
        np.zeros((32, 4), np.int32), np.ones(32, np.float32)))
    assert int(t.health.step) == 0 and float(t.health.touch_events) == 0.0


def test_mesh_health_matches_one_device(tmp_path):
    """Four ranks (2 x 2) train with the dense and the entries exchange
    and the dense optax path: every rank reports the same health, the
    single process's over the same global batches (the counts exactly,
    the norms within the sharded step's bounds: its squares are summed
    in another order)."""
    from _torch_sharded_worker import run_ranks

    rng = np.random.default_rng(11)
    files = []
    for name in ("a", "b"):
        path = tmp_path / f"{name}.libsvm"
        with open(path, "w") as f:
            for _ in range(256):
                toks = [str(rng.integers(0, 2))]
                toks += [f"{rng.integers(0, 512)}:{rng.uniform(0.1, 1):.4f}"
                         for _ in range(6)]
                f.write(" ".join(toks) + "\n")
        files.append(str(path))
    base = dict(vocabulary_size=512, factor_num=4, max_features=8,
                batch_size=64, train_files=files, epoch_num=1, log_steps=0,
                seed=5, shuffle_buffer=100, learning_rate=0.1,
                factor_lambda=1e-3, bias_lambda=1e-3, mesh_data=2,
                mesh_model=2)
    runs = [
        dict(base, lookup="shardmap", sparse_exchange="dense",
             model_file=str(tmp_path / "m_dense")),
        dict(base, sparse_exchange="entries",
             model_file=str(tmp_path / "m_entries")),
        dict(base, sparse_update=False, optimizer="adam",
             learning_rate=0.01, model_file=str(tmp_path / "m_adam")),
    ]
    (tmp_path / "train.json").write_text(json.dumps(runs))
    run_ranks("train", 4, tmp_path)
    for i, run in enumerate(runs):
        results = [json.loads((tmp_path / f"train{i}_{r}.json").read_text())
                   for r in range(4)]
        health = results[0]["train"]["health"]
        assert all(r["train"]["health"] == health for r in results[1:])
        single = Trainer(FmConfig(**dict(
            run, mesh_data=1, mesh_model=1,
            model_file=str(tmp_path / f"single{i}"))), device="cpu")
        _assert_health_equal(health, single.train()["train"]["health"])
        assert health["nonfinite_steps"] == 0
        assert health["emb_touch_events"] == 512 * 6


def test_tiered_health_reports_logical_occupancy(train_file, tmp_path):
    """Under ``table_tiering = on`` the carry counts hot slots; the
    summary takes the tier manager's logical occupancy instead, as the
    reference does, and equals the dense run's (the tiered trainer
    trains the dense run's table)."""
    runs = {}
    for tag, kw in (("dense", {}),
                    ("tiered", dict(table_tiering="on", hot_rows=48))):
        t = Trainer(FmConfig(model_file=str(tmp_path / tag), nan_policy="halt",
                             **_common(train_file, steps_per_dispatch=1,
                                       **kw)), device="cpu")
        runs[tag] = t.train()["train"]["health"]
    dense_h, tiered_h = runs["dense"], runs["tiered"]
    assert tiered_h["hot_slots_resident"] > 0
    for key in ("emb_rows_touched", "emb_row_occupancy", "emb_touch_events",
                "nonfinite_steps", "first_nonfinite_step"):
        assert tiered_h[key] == dense_h[key], key
    np.testing.assert_allclose(tiered_h["grad_norm_rms"],
                               dense_h["grad_norm_rms"], rtol=1e-6)
