"""The port's dense optax path vs the JAX package on the CPU: the dense
updates against optax's and the reference's FTRL, the full-table L2,
three dense steps of each optimizer and L2 mode (FM, FFM, bf16) against
the reference's ``Trainer`` (``sparse_update = false``) from its initial
table, the trainer's sparse/dense choice, a K = 4 dispatch, a warm start
with Adam's state, and ``Trainer.train`` -> validation -> ``predict``.

The port runs its kernels' plain versions here (FmScorer and FmGrad,
K1's merge mode and K-place); the card holds the kernels against them
(``tests/test_torch_gpu.py``).  Tolerances are the reference's
(``tests/test_sparse.py``'s sparse-vs-dense pairing): ``rtol=1e-4,
atol=1e-6`` on the table, w0 and every optimizer leaf; bf16 compute at
``tests/test_bf16.py``'s bounds (scores ``rtol=2e-3, atol=1e-4``,
gradients and hence the Adam-normalised updates ``rtol=0.05,
atol=0.02``; the loss within 1e-2 of f32).
"""

import dataclasses
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.data.libsvm import Batch as JaxBatch
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu.train.optimizers import make_optimizer
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import libsvm
from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
from fast_tffm_tpu_torch.models import fm
from fast_tffm_tpu_torch.train import checkpoint, dense, optimizers, sparse
from fast_tffm_tpu_torch.train.loop import Trainer

TOL = dict(rtol=1e-4, atol=1e-6)
BF16_SCORE_TOL = dict(rtol=2e-3, atol=1e-4)
BF16_TOL = dict(rtol=0.05, atol=0.02)
V, F, B = 1024, 8, 32
BASE = dict(
    vocabulary_size=V, factor_num=4, max_features=F, batch_size=B,
    learning_rate=0.05, adagrad_initial_accumulator=0.1, ftrl_l1=0.01,
    ftrl_l2=0.1, ftrl_beta=1.0, factor_lambda=1e-3, bias_lambda=1e-3,
    sparse_update=False, log_steps=0, save_steps=0,
)
OPTIMIZERS = ("adagrad", "ftrl", "sgd", "adam")


def _batches(n, seed=4, field_num=0, vocab=V, b=B, unique=False):
    """Host batches with a duplicated id, padded slots and two
    zero-weight examples (``unique``: every id once across them all)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab)
    out = []
    for i in range(n):
        if unique:
            ids = perm[i * b * F:(i + 1) * b * F].reshape(b, F)
        else:
            ids = rng.integers(0, vocab, (b, F))
            ids[:8, 0] = 5
        ids = ids.astype(np.int32)
        vals = rng.uniform(0.1, 1.0, (b, F)).astype(np.float32)
        weights_ = np.ones(b, np.float32)
        if not unique:
            vals[:, -2:] = 0.0
            ids[:, -2:] = 0
            weights_[-2:] = 0.0
        fields = (rng.integers(0, field_num, (b, F)) if field_num
                  else np.zeros((b, F))).astype(np.int32)
        out.append(libsvm.Batch(
            labels=rng.integers(0, 2, b).astype(np.float32), ids=ids,
            vals=vals, fields=fields, weights=weights_))
    return out


def _ref_leaves(optimizer, opt):
    """The reference's optimizer leaves in the port's state order."""
    if optimizer == "adagrad":
        acc = opt[0].sum_of_squares
        return [acc.w0, acc.table]
    if optimizer == "ftrl":
        return [opt.z.w0, opt.z.table, opt.n.w0, opt.n.table]
    if optimizer == "adam":
        a = opt[0]
        return [a.mu.w0, a.mu.table, a.nu.w0, a.nu.table, a.count]
    return []


def _pair(tmp_path, **kw):
    """The reference's dense ``Trainer`` and the port's, the port's
    warm-started from the reference's initial parameters (step 0, so its
    optimizer state is its own fresh one)."""
    jt = JaxTrainer(JaxFmConfig(model_file=str(tmp_path / "jax"),
                                **{**BASE, **kw}))
    assert not jt.sparse
    init = jax.tree.map(np.asarray, jt.state.params)
    port_dir = str(tmp_path / "port")
    checkpoint.save_params(port_dir, weights.from_jax(init.w0, init.table,
                                                      device="cpu"))
    pt = Trainer(FmConfig(model_file=port_dir, **{**BASE, **kw}),
                 device="cpu")
    assert not pt.sparse
    return jt, pt


def _ref_step(jt, batch):
    jt.state = jt._train_step(jt.state, jt._put(JaxBatch(*batch[:5])))


def _assert_state(pt, jt, optimizer, tol):
    np.testing.assert_allclose(pt.model.table.detach().numpy(),
                               np.asarray(jt.state.params.table), **tol)
    np.testing.assert_allclose(float(pt.model.w0.detach()),
                               float(jt.state.params.w0), **tol)
    want = _ref_leaves(optimizer, jt.state.opt_state)
    assert len(want) == len(pt.opt_state)
    for got, ref in zip(pt.opt_state, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_dense_updates_match_optax(optimizer):
    """``optimizers.apply_dense`` against the reference's
    ``make_optimizer`` (optax Adagrad, SGD and Adam, the reference's
    FTRL) over three updates of given gradients, each with an exact zero
    and a gradient whose square underflows (optax's Adagrad ``where``
    gives it a zero update at a zero accumulator); the fresh states agree
    too."""
    rng = np.random.default_rng(3)
    kw = dict(BASE, optimizer=optimizer, adagrad_initial_accumulator=0.0
              if optimizer == "adagrad" else 0.1)
    jcfg, cfg = JaxFmConfig(**kw), FmConfig(**kw)
    w0 = np.float32(0.3)
    table = rng.uniform(-0.1, 0.1, (64, 9)).astype(np.float32)
    params = jax_fm.FmParams(jnp.asarray(w0), jnp.asarray(table))
    opt = make_optimizer(jcfg)
    state = opt.init(params)
    model = weights.from_jax(w0, table, device="cpu")
    ostate = optimizers.init_dense_opt_state(cfg, model)
    for got, want in zip(ostate, _ref_leaves(optimizer, state)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    for _ in range(3):
        g_table = rng.normal(0, 0.1, table.shape).astype(np.float32)
        g_table[0, 0], g_table[1, 1] = 0.0, 1e-30
        g_w0 = np.float32(rng.normal(0, 0.1))
        grads = jax_fm.FmParams(jnp.asarray(g_w0), jnp.asarray(g_table))
        updates, state = opt.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        optimizers.apply_dense(cfg, model, ostate, torch.tensor(g_w0),
                               torch.from_numpy(g_table))
    np.testing.assert_allclose(model.table.detach().numpy(),
                               np.asarray(params.table), **TOL)
    np.testing.assert_allclose(float(model.w0.detach()), float(params.w0),
                               **TOL)
    for got, want in zip(ostate, _ref_leaves(optimizer, state)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if optimizer == "adagrad":
        assert float(model.table.detach()[1, 1]) == table[1, 1]
    if optimizer == "adam":
        assert ostate.count.dtype == torch.int32 and int(ostate.count) == 3


def test_l2_penalty_full_matches_the_reference_and_its_closed_form():
    """``fm.l2_penalty_full`` equals the reference's, and the dense
    step's closed-form gradient (``2 lambda`` times the parameter,
    column 0 and w0 under ``bias_lambda``) is its autograd gradient."""
    rng = np.random.default_rng(1)
    w0, table = np.float32(0.7), rng.normal(0, 0.2, (50, 9)).astype(
        np.float32)
    want = jax_fm.l2_penalty_full(
        jax_fm.FmParams(jnp.asarray(w0), jnp.asarray(table)), 1e-3, 2e-3)
    w0_t = torch.tensor(w0, requires_grad=True)
    table_t = torch.from_numpy(table.copy()).requires_grad_()
    got = fm.l2_penalty_full(w0_t, table_t, 1e-3, 2e-3)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    dw0, dtable = torch.autograd.grad(got, (w0_t, table_t))
    lam = np.full(9, 2e-3, np.float32)
    lam[0] = 4e-3
    np.testing.assert_allclose(dtable.numpy(), table * lam, rtol=1e-6)
    np.testing.assert_allclose(float(dw0), 4e-3 * w0, rtol=1e-6)


@pytest.mark.parametrize("l2_mode", ["batch", "full"])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_three_dense_steps_match_the_reference(tmp_path, optimizer,
                                               l2_mode):
    """Three steps of the reference's dense optax ``Trainer`` and the
    port's (host sort meta on the second, device prep on the others):
    table, w0, every optimizer leaf (Adam's count too) and the metrics'
    loss sum."""
    jt, pt = _pair(tmp_path, optimizer=optimizer, l2_mode=l2_mode)
    for i, batch in enumerate(_batches(3)):
        _ref_step(jt, batch)
        if i == 1:
            batch = batch._replace(sort_meta=libsvm.host_sort_meta(batch.ids))
        pt.train_step(batch)
    _assert_state(pt, jt, optimizer, TOL)
    np.testing.assert_allclose(float(pt.metrics.loss_sum),
                               float(jt.state.metrics.loss_sum), rtol=1e-4)


def test_three_dense_ffm_steps_match_the_reference(tmp_path):
    """Field-aware FM (``field_num = 2``) with Adam and the full L2."""
    jt, pt = _pair(tmp_path, optimizer="adam", l2_mode="full", field_num=2)
    for batch in _batches(3, field_num=2):
        _ref_step(jt, batch)
        pt.train_step(batch)
    _assert_state(pt, jt, "adam", TOL)
    np.testing.assert_allclose(float(pt.metrics.loss_sum),
                               float(jt.state.metrics.loss_sum), rtol=1e-4)


def test_three_bf16_dense_steps_match_the_reference(tmp_path, monkeypatch):
    """``compute_dtype = bfloat16`` with Adam, three steps.  Each step is
    held to the reference on the port's parameters before it: its table
    and w0 gradients to the gradient of the reference's dense loss
    (``loss_and_metrics`` in bf16) at the bf16 gradient bound, its
    scores to the reference's FmScorer kernel (interpret mode), whose
    math the port's bf16 mode is, at the bf16 score bound.  (The
    reference's dense step scores through ``jnp``, which also rounds
    ``w0`` and the products to bf16: ``fast_tffm_tpu/models/fm.py::
    interaction_terms``, ``scores_from_rows``.)  Trajectories are not
    compared: Adam's update ``mu / sqrt(nu)`` is the sign of a gradient
    near zero, so a bf16 rounding that flips it moves an element by up
    to ``lr`` a step."""
    jt, pt = _pair(tmp_path, optimizer="adam", compute_dtype="bfloat16")
    applied = []
    apply_dense = dense.apply_dense

    def spy(cfg, model, opt_state, dw0, dtable):
        applied.append((dw0.clone(), dtable.clone()))
        apply_dense(cfg, model, opt_state, dw0, dtable)

    monkeypatch.setattr(dense, "apply_dense", spy)
    for batch in _batches(3):
        before = jax_fm.FmParams(*(jnp.asarray(t.detach().numpy()) for t in
                                   (pt.model.w0, pt.model.table)))
        want_scores = jax_fm.fm_scores(
            before, jnp.asarray(batch.ids), jnp.asarray(batch.vals),
            factor_num=BASE["factor_num"], compute_dtype=jnp.bfloat16,
            impl="pallas")
        want = jax.grad(lambda p, b=batch: jax_fm.loss_and_metrics(
            p, *(jnp.asarray(a) for a in b[:3]), None,
            jnp.asarray(b.weights), jt.cfg,
            compute_dtype=jnp.bfloat16)[0])(before)
        got = dense.dense_step(pt.cfg, pt.model, pt.opt_state,
                               sparse.to_device(batch, "cpu"))
        np.testing.assert_allclose(got.numpy(), np.asarray(want_scores),
                                   **BF16_SCORE_TOL)
        dw0, dtable = applied[-1]
        np.testing.assert_allclose(dtable.numpy(), np.asarray(want.table),
                                   **BF16_TOL)
        np.testing.assert_allclose(float(dw0), float(want.w0), **BF16_TOL)
    assert int(pt.opt_state.count) == 3


def test_bf16_dense_loss_tracks_f32():
    """20 dense Adam steps in bf16 compute end within 1e-2 logloss of the
    same steps in f32, from one initial table."""
    shape = dict(BASE, optimizer="adam", batch_size=64)
    init = fm.init_params(FmConfig(**shape),
                          torch.Generator().manual_seed(0), device="cpu")
    last = {}
    for dtype in ("float32", "bfloat16"):
        cfg = FmConfig(compute_dtype=dtype, **shape)
        model = fm.FmModel(init.w0.detach().clone(),
                           init.table.detach().clone())
        opt = optimizers.init_dense_opt_state(cfg, model)
        for batch in _batches(20, seed=7, b=64):
            scores = dense.dense_step(cfg, model, opt,
                                      sparse.to_device(batch, "cpu"))
            last[dtype] = float(fm.example_losses(
                scores, torch.from_numpy(batch.labels), "logistic").mean())
    assert abs(last["bfloat16"] - last["float32"]) < 1e-2


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_sparse_matches_dense_on_unique_ids(tmp_path, optimizer):
    """The reference's pairing (``tests/test_sparse.py``) on the port:
    with no id twice in a batch the sparse and the dense update are the
    same math."""
    cfg = FmConfig(model_file=str(tmp_path / "none"),
                   **dict(BASE, optimizer=optimizer))
    ts = Trainer(dataclasses.replace(cfg, sparse_update=True), device="cpu")
    td = Trainer(cfg, device="cpu")
    assert ts.sparse and not td.sparse
    for batch in _batches(3, unique=True):
        ts.train_step(batch)
        td.train_step(batch)
    for a, b in ((ts.model.table, td.model.table), (ts.model.w0, td.model.w0),
                 (ts.metrics.loss_sum, td.metrics.loss_sum)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **TOL)


def test_sparse_update_with_adam_falls_back_to_the_dense_path(tmp_path,
                                                              caplog):
    """``sparse_update = true`` with Adam logs the reference's line and
    trains, bitwise, what ``sparse_update = false`` trains."""
    cfg = FmConfig(model_file=str(tmp_path / "none"),
                   **dict(BASE, optimizer="adam"))
    with caplog.at_level(logging.INFO):
        fallback = Trainer(dataclasses.replace(cfg, sparse_update=True), device="cpu")
    assert ("sparse_update unsupported for optimizer=adam l2_mode=batch; "
            "using dense optax path") in caplog.text
    plain = Trainer(cfg, device="cpu")
    assert not fallback.sparse and not plain.sparse
    for batch in _batches(2):
        fallback.train_step(batch)
        plain.train_step(batch)
    for a, b in zip([fallback.model.table, fallback.model.w0,
                     *fallback.opt_state],
                    [plain.model.table, plain.model.w0, *plain.opt_state]):
        assert torch.equal(a, b)


def test_k4_dispatch_matches_k1(tmp_path):
    """Seven batches at ``steps_per_dispatch = 4`` (a full super-batch on
    the whole ``seg_start`` slot and a tail of three) through
    ``Trainer.dispatch`` train, bitwise, what seven K = 1 dispatches
    train: tables, Adam's state, w0 and the metrics."""
    cfg = FmConfig(model_file=str(tmp_path / "none"), seed=3,
                   **dict(BASE, optimizer="adam", l2_mode="full"))
    host = [b._replace(sort_meta=libsvm.host_sort_meta(b.ids))
            for b in _batches(7)]
    runs = []
    for k in (4, 1):
        trainer = Trainer(dataclasses.replace(cfg, steps_per_dispatch=k), device="cpu")
        losses = torch.cat([trainer.dispatch(sb) for sb in
                            DevicePrefetcher(host, k, "cpu", V)])
        assert trainer.eager_dispatches == -(-7 // k)
        m = trainer.metrics
        runs.append([losses, trainer.model.table, trainer.model.w0,
                     *trainer.opt_state, m.loss_sum, m.auc.pos, m.auc.neg])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_warm_start_with_adam_state_resumes_exactly(tmp_path):
    """Two steps, a save, a warm start and two more steps equal four
    steps bitwise: ``params.npz`` holds Adam's moments and its int32
    count, and predict's keys are the sparse trainer's."""
    cfg = FmConfig(model_file=str(tmp_path / "a"), seed=2,
                   **dict(BASE, optimizer="adam", l2_mode="full"))
    batches = _batches(4)
    whole = Trainer(dataclasses.replace(cfg, model_file=str(tmp_path / "b")),
                    device="cpu")
    for b in batches:
        whole.train_step(b)
    first = Trainer(cfg, device="cpu")
    for b in batches[:2]:
        first.train_step(b)
    path = first.save(2)
    with np.load(path) as z:
        assert {"scalar/step", "scalar/w0", "params/table", "opt/mu_w0",
                "opt/mu_table", "opt/nu_w0", "opt/nu_table",
                "opt/count"} == set(z.files)
        assert z["opt/count"].dtype == np.int32 and int(z["opt/count"]) == 2
    resumed = Trainer(cfg, device="cpu")
    assert isinstance(resumed.opt_state, optimizers.AdamState)
    assert int(resumed.opt_state.count) == 2
    for b in batches[2:]:
        resumed.train_step(b)
    for a, b in zip([whole.model.table, whole.model.w0, *whole.opt_state],
                    [resumed.model.table, resumed.model.w0,
                     *resumed.opt_state]):
        assert torch.equal(a, b)
    step, w0, table, opt = checkpoint.restore_host(cfg.model_file, "adam")
    assert step == 2 and opt.count.dtype == np.int32 and table.shape == (V, 5)


def _lines(path, n, rng, w, v, n_feat=10):
    """Planted-structure libsvm lines (``examples/gen_sample_data.py``)."""
    with open(path, "w") as f:
        for _ in range(n):
            ids = rng.choice(len(w), size=n_feat, replace=False)
            vals = np.round(rng.uniform(0.2, 1.0, size=n_feat), 3)
            xv = v[ids] * vals[:, None]
            score = w[ids] @ vals + 0.5 * (xv.sum(0) @ xv.sum(0)
                                           - (xv ** 2).sum())
            label = int(rng.uniform() < 1.0 / (1.0 + np.exp(-2.5 * score)))
            f.write(f"{label} " + " ".join(
                f"{i}:{x}" for i, x in zip(ids, vals)) + "\n")


def test_dense_train_validate_predict_match_the_reference(tmp_path):
    """From the reference's initial table, the port and the reference
    train two epochs of planted-structure lines on the dense path (Adam,
    full L2, host sort meta), then validate and predict: the counts
    exactly, the validation metrics and the score files as
    ``tests/test_torch_train.py``'s sparse run holds them."""
    from fast_tffm_tpu.train.loop import predict as jax_predict
    from fast_tffm_tpu_torch.train.loop import predict

    rng = np.random.default_rng(8)
    vocab = 300
    w = rng.normal(0, 0.5, vocab)
    v = rng.normal(0, 0.3, (vocab, 4))
    _lines(tmp_path / "train.libsvm", 1100, rng, w, v, n_feat=14)
    _lines(tmp_path / "valid.libsvm", 450, rng, w, v)
    common = dict(
        vocabulary_size=vocab, factor_num=4, max_features=12,
        batch_size=128, epoch_num=2, learning_rate=0.05,
        optimizer="adam", sparse_update=False, l2_mode="full",
        factor_lambda=1e-4, bias_lambda=1e-4, init_value_range=0.05,
        shuffle_buffer=400, seed=9, log_steps=0, save_steps=0,
        train_files=[str(tmp_path / "train.libsvm")],
        validation_files=[str(tmp_path / "valid.libsvm")],
        predict_files=[str(tmp_path / "valid.libsvm")], host_sort=True,
    )
    jcfg = JaxFmConfig(model_file=str(tmp_path / "jax_model"),
                       score_path=str(tmp_path / "jax_scores.txt"), **common)
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
    got, want = pres["validation"], jres["validation"]
    assert got["examples"] == want["examples"] == 450
    assert got["logloss"] < 0.69  # it learned
    np.testing.assert_allclose(got["logloss"], want["logloss"], rtol=1e-5)
    np.testing.assert_allclose(got["auc"], want["auc"], atol=1e-4)
    assert jax_predict(jcfg) == 450
    assert predict(cfg, device="cpu") == 450
    np.testing.assert_allclose(np.loadtxt(cfg.score_path),
                               np.loadtxt(jcfg.score_path), rtol=0,
                               atol=1.01e-6)
