"""The port's rank mesh in every trainer setting the JAX package runs on
one, on the CPU: field-aware FM, bf16 compute and the dense optax path.

- The FFM sharded step on 2 x 2, 4 x 1 and 1 x 4 meshes, both
  exchanges, Adagrad (with the batch L2) / FTRL / SGD (mse), against the
  reference's ``sparse_step_shardmap`` on the same mesh shape and its
  scatter step; on 2 x 2 also the bf16 FM sharded step against the
  reference's bf16 sharded step, and FFM in bf16 against the reference's
  f32 (the reference computes bf16 FFM in f32 off a TPU, the port rounds
  as its TPU program does: ROADMAP.md Queue 3, by design).
- The dense optax path on a 2 x 2 mesh: Adam, Adagrad, FTRL and SGD x
  ``l2_mode`` batch / full, FFM, and Adam in bf16, the multi-rank
  ``Trainer`` against the reference's ``Trainer`` on a jax mesh of the
  same shape (its GSPMD step) and against the port's single-process
  run, ``params.npz`` key for key; a warm start 2 x 2 -> 1 x 1 -> 1 x 4
  and one from the reference's Orbax ``opt/``.  Adam in bf16 also step
  by step on 2 x 2 (in the sharded steps' group): each step's scores,
  gradients and update against the reference's dense bf16 step from the
  parameters it started from.
- The multi-rank FFM trainer with validation against the single-process
  one, and the overlapped entries exchange bitwise the entries run; the
  FFM and bf16 fleet (tiering on a mesh) bitwise the dense mesh; the
  mesh check's tile-limit message.

The port's ranks are spawned processes (``tests/_torch_sharded_worker.py``,
gloo on the CPU), one group per mesh shape; the reference runs in this
process on the conftest's 8 virtual CPU devices.  Tolerances: the
sharded step's are the reference's (``tests/test_shardmap_step.py``):
scores ``rtol=1e-4, atol=1e-5``, table ``rtol=1e-4, atol=1e-6``,
accumulator ``rtol=1e-4, atol=1e-5``, w0 ``rtol=1e-5, atol=1e-7``; bf16
at ``tests/test_bf16.py``'s bounds (scores ``rtol=2e-3, atol=1e-4``,
parameters ``rtol=0.05, atol=0.02``); FFM in bf16 against f32
``rtol=2e-2, atol=2e-2``; the dense path at ``tests/test_torch_dense.py``'s
``TOL`` (``rtol=1e-4, atol=1e-6``) and ``BF16_TOL``.
"""

import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.data.libsvm import Batch as JaxBatch
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.parallel import mesh as jax_mesh
from fast_tffm_tpu.train import shardmap_step as jax_shardmap
from fast_tffm_tpu.train import sparse as jax_sparse
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu.train.optimizers import make_optimizer
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import libsvm
from fast_tffm_tpu_torch.train import checkpoint, orbax_read
from fast_tffm_tpu_torch.train.loop import Trainer

from _torch_sharded_worker import run_ranks

SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
ACC_TOL = dict(rtol=1e-4, atol=1e-5)
W0_TOL = dict(rtol=1e-5, atol=1e-7)
BF16_SCORE_TOL = dict(rtol=2e-3, atol=1e-4)
BF16_TOL = dict(rtol=0.05, atol=0.02)
FFM_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
TOL = dict(rtol=1e-4, atol=1e-6)
V, F, B, STEPS = 2048, 8, 64, 2

# (exchange, optimizer, extra config): L2 on adagrad, mse on sgd.
_OPTS = (("adagrad", dict(factor_lambda=0.01, bias_lambda=0.002)),
         ("ftrl", {}), ("sgd", dict(loss_type="mse")))
_FFM_CASES = [(ex, opt, dict(extra, field_num=2, factor_num=4))
              for ex in ("dense", "entries") for opt, extra in _OPTS]
# On 2 x 2 only: bf16 FM against the reference's bf16, FFM in bf16
# against the reference's f32.
_BF16_CASES = [
    (ex, "adagrad", dict(factor_lambda=0.01, bias_lambda=0.002,
                         factor_num=8, compute_dtype="bfloat16"))
    for ex in ("dense", "entries")
] + [("entries", "adagrad", dict(field_num=2, factor_num=4,
                                  compute_dtype="bfloat16"))]


def _jax_mesh(shape):
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return JaxMesh(devs, (jax_mesh.DATA_AXIS, jax_mesh.MODEL_AXIS))


def _step_cfg(optimizer, extra):
    return dict(vocabulary_size=V, max_features=F, batch_size=B,
                optimizer=optimizer, learning_rate=0.05, ftrl_l1=0.01,
                ftrl_l2=0.1, l2_mode="batch", **extra)


def _batches(n, seed, field_num=0, b=B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, V, (b, F)).astype(np.int32)
        ids[:8, 0] = 5  # a duplicated id across data blocks
        w = rng.uniform(0.5, 2.0, b).astype(np.float32)
        w[-5:] = 0.0  # padded examples
        vals = rng.uniform(0.1, 1.0, (b, F)).astype(np.float32)
        vals[:, -1] = 0.0  # an empty slot in every example
        out.append(JaxBatch(
            labels=rng.integers(0, 2, b).astype(np.float32), ids=ids,
            vals=vals, fields=rng.integers(0, max(field_num, 1), (b, F))
            .astype(np.int32), weights=w))
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
def _initial(optimizer, extra_items):
    """The reference's initial state and batches of a case, and its
    scatter step's run over them (in f32: the bf16 cases' oracle for
    FFM)."""
    extra = dict(extra_items)
    extra.pop("compute_dtype", None)
    jcfg = JaxFmConfig(sparse_apply="scatter", **_step_cfg(optimizer, extra))
    params = jax_fm.init_params(jax.random.PRNGKey(0), jcfg)
    opt = jax_sparse.init_sparse_opt_state(jcfg, params)
    batches = _batches(STEPS, 1, extra.get("field_num", 0))
    return (params, opt, batches) + _jax_run(jcfg, params, opt, batches)


def _write_case(path, params, opt, optimizer, batches):
    arrays = {"w0": np.asarray(params.w0), "table": np.asarray(params.table)}
    arrays.update((k, np.asarray(v))
                  for k, v in _opt_arrays(optimizer, opt).items())
    for s, b in enumerate(batches):
        arrays.update((f"b{s}_{f}", np.asarray(getattr(b, f)))
                      for f in JaxBatch._fields[:5])
    np.savez(path, **arrays)


def _gathered(outs, key, shape, axis=0):
    """The full table of ``key`` from the ranks' shards, their rows on
    ``axis`` (the ranks of one model column hold the same shard, bit for
    bit)."""
    world = shape[0] * shape[1]
    for r in range(world):
        np.testing.assert_array_equal(outs[r][key], outs[r % shape[1]][key])
    shards = [outs[c][key] for c in range(shape[1])]
    if axis:
        return np.concatenate(shards, axis=axis)
    return weights.unshard_rows(shards)


# Adam in bf16 on the dense optax path, one step at a time (2 x 2 only).
_DENSE_BF16_STEP = dict(
    _step_cfg("adam", dict(sparse_update=False, factor_lambda=0.01,
                           bias_lambda=0.002, factor_num=8,
                           compute_dtype="bfloat16")), l2_mode="full")
DENSE_BF16_STEPS = 3


def _check_dense_bf16_steps(outs, shape, batches, jcfg, where):
    """Each step of ``dense_step_sharded`` in bf16 held to the reference's
    dense step (``loss_and_metrics`` in bf16, the step its GSPMD
    ``Trainer`` partitions) from the parameters it started from, as
    ``tests/test_torch_dense.py::
    test_three_bf16_dense_steps_match_the_reference`` holds the
    one-device step.  Its scores are the reference's dense ``jnp`` scores
    once moved by the rounding of ``w0`` to bf16, which the reference
    makes and the port's steps do not (``train/dense.py``): the products
    round alike, so at the f32 sharded step's score bound.  The table
    and ``w0`` gradients it applied are ``jax.grad`` of the reference's
    bf16 dense loss at the bf16 gradient bound, and within 5 % of the
    largest gradient element, which a step that computes no gradient
    (error 1) fails.  The reference's optimizer (``make_optimizer``)
    given those gradients makes the parameters the mesh's next step
    started from, and its last ones, at ``TOL``."""
    w0_before = outs[0]["w0_before"]
    tables = _gathered(outs, "table_before", shape, axis=1)
    dtables = _gathered(outs, "dtable", shape, axis=1)
    for r in range(len(outs)):
        np.testing.assert_array_equal(outs[r]["w0_before"], w0_before)
        np.testing.assert_array_equal(outs[r]["dw0"], outs[0]["dw0"])
    opt = make_optimizer(jcfg)
    params = jax_fm.FmParams(jnp.asarray(w0_before[0]),
                             jnp.asarray(tables[0]))
    state = opt.init(params)
    for s in range(len(batches)):
        grads = jax_fm.FmParams(jnp.asarray(outs[0]["dw0"][s]),
                                jnp.asarray(dtables[s]))
        updates, state = opt.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        last = s + 1 == len(batches)
        np.testing.assert_allclose(
            _gathered(outs, "table", shape) if last else tables[s + 1],
            np.asarray(params.table), **TOL, err_msg=f"{where} update {s}")
        np.testing.assert_allclose(
            outs[0]["w0"] if last else w0_before[s + 1],
            np.asarray(params.w0), **TOL, err_msg=f"{where} update {s}")
    for s, batch in enumerate(batches):
        at = f"{where} step {s}"
        before = jax_fm.FmParams(jnp.asarray(w0_before[s]),
                                 jnp.asarray(tables[s]))
        scores = np.concatenate([outs[row * shape[1]]["scores"][s]
                                 for row in range(shape[0])])
        ids, vals = jnp.asarray(batch.ids), jnp.asarray(batch.vals)
        w0_rounding = float(jnp.asarray(w0_before[s]).astype(jnp.bfloat16)
                            .astype(jnp.float32)) - float(w0_before[s])
        np.testing.assert_allclose(
            scores + w0_rounding, np.asarray(jax_fm.fm_scores(
                before, ids, vals, factor_num=jcfg.factor_num,
                compute_dtype=jnp.bfloat16)), **SCORE_TOL, err_msg=at)
        want = jax.grad(lambda p: jax_fm.loss_and_metrics(
            p, jnp.asarray(batch.labels), ids, vals, None,
            jnp.asarray(batch.weights), jcfg,
            compute_dtype=jnp.bfloat16)[0])(before)
        for got, ref, name in ((dtables[s], want.table, "dtable"),
                               (outs[0]["dw0"][s], want.w0, "dw0")):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got, ref, **BF16_TOL,
                                       err_msg=f"{at} {name}")
            np.testing.assert_allclose(
                got, ref, rtol=BF16_TOL["rtol"],
                atol=0.05 * float(np.abs(ref).max()), err_msg=f"{at} {name}")


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_ffm_and_bf16_sharded_steps_match_jax(shape, tmp_path):
    """One spawned group per mesh shape: the FFM cases against the
    reference's sharded and scatter steps; on 2 x 2 the bf16 cases."""
    todo = [(c, "f32") for c in _FFM_CASES]
    if shape == (2, 2):
        todo += [(c, "bf16") for c in _BF16_CASES]
    jm = _jax_mesh(shape)
    cases, refs = [], []
    for i, ((exchange, optimizer, extra), kind) in enumerate(todo):
        init_p, init_o, batches, sc_p, sc_o, sc_s = _initial(
            optimizer, tuple(sorted(extra.items())))
        kw = dict(_step_cfg(optimizer, extra), lookup="shardmap",
                  sparse_exchange=exchange, mesh_data=shape[0],
                  mesh_model=shape[1])
        jcfg = JaxFmConfig(**kw)
        assert jax_shardmap.exchange_mode(jcfg, jm, B // shape[0] * F) \
            == exchange
        sm = _jax_run(jcfg, init_p, init_o, batches, jm)
        if kind == "f32":
            want = [(sm, SCORE_TOL, TABLE_TOL, ACC_TOL, W0_TOL),
                    ((sc_p, sc_o, sc_s), SCORE_TOL, TABLE_TOL, ACC_TOL,
                     W0_TOL)]
        elif extra.get("field_num"):  # the reference computes it in f32
            want = [(sm,) + (FFM_BF16_TOL,) * 4]
        else:
            want = [(sm, BF16_SCORE_TOL, BF16_TOL, BF16_TOL, BF16_TOL)]
        refs.append((optimizer, want))
        cases.append({"cfg": kw, "steps": STEPS})
        _write_case(tmp_path / f"case{i}.npz", init_p, init_o, optimizer,
                    batches)
    if shape == (2, 2):
        kw = dict(_DENSE_BF16_STEP, mesh_data=2, mesh_model=2)
        jcfg = JaxFmConfig(**kw)
        init_p = jax_fm.init_params(jax.random.PRNGKey(0), jcfg)
        dense_batches = _batches(DENSE_BF16_STEPS, 3)
        dense_case = len(cases)
        cases.append({"cfg": kw, "steps": DENSE_BF16_STEPS})
        _write_case(tmp_path / f"case{dense_case}.npz", init_p, None,
                    "adam", dense_batches)
    (tmp_path / "cases.json").write_text(json.dumps(cases))
    world = shape[0] * shape[1]
    run_ranks("step", world, tmp_path)
    if shape == (2, 2):
        outs = [np.load(tmp_path / f"out{dense_case}_{r}.npz")
                for r in range(world)]
        np.testing.assert_array_equal(
            _gathered(outs, "table_before", shape, axis=1)[0],
            np.asarray(init_p.table))
        _check_dense_bf16_steps(outs, shape, dense_batches, jcfg,
                                "dense bf16 Adam on (2, 2)")
    for i, (optimizer, want) in enumerate(refs):
        outs = [np.load(tmp_path / f"out{i}_{r}.npz") for r in range(world)]
        table = _gathered(outs, "table", shape)
        for r in range(world):  # a data row's ranks score alike
            np.testing.assert_array_equal(
                outs[r]["scores"], outs[r - r % shape[1]]["scores"])
        scores = np.concatenate([outs[row * shape[1]]["scores"]
                                 for row in range(shape[0])], axis=1)
        where = f"case {todo[i]} on {shape}"
        for (params, opt, ref_scores), s_tol, t_tol, a_tol, w_tol in want:
            np.testing.assert_allclose(scores, ref_scores, **s_tol,
                                       err_msg=where)
            np.testing.assert_allclose(table, np.asarray(params.table),
                                       **t_tol, err_msg=where)
            np.testing.assert_allclose(float(outs[0]["w0"]),
                                       float(params.w0), **w_tol,
                                       err_msg=where)
            for key, ref in _opt_arrays(optimizer, opt).items():
                got = (_gathered(outs, key, shape) if key.endswith("table")
                       else outs[0][key])
                tol = a_tol if key.endswith("table") else w_tol
                np.testing.assert_allclose(got, np.asarray(ref), **tol,
                                           err_msg=f"{where} {key}")


# ------------------------------------------- the dense optax path on a mesh


DENSE_BASE = dict(
    vocabulary_size=1024, factor_num=4, max_features=F, batch_size=32,
    learning_rate=0.05, adagrad_initial_accumulator=0.1, ftrl_l1=0.01,
    ftrl_l2=0.1, ftrl_beta=1.0, factor_lambda=1e-3, bias_lambda=1e-3,
    sparse_update=False, log_steps=0, save_steps=0,
)
_DENSE_CASES = (
    [dict(optimizer=o, l2_mode=m) for o in ("adam", "adagrad", "ftrl", "sgd")
     for m in ("batch", "full")]
    + [dict(optimizer="adam", l2_mode="full", field_num=2),
       dict(optimizer="adagrad", l2_mode="batch", field_num=2,
            lookup="shardmap"),
       # lr 1e-3: Adam's update is the sign of a gradient near zero, so a
       # bf16 rounding that flips it moves an element by lr.
       dict(optimizer="adam", compute_dtype="bfloat16", learning_rate=1e-3)]
)
DENSE_STEPS = 3
WARM = dict(optimizer="adam", l2_mode="full")


def _dense_batches(n, field_num=0, seed=4):
    out = _batches(n, seed, field_num, b=DENSE_BASE["batch_size"])
    return [b._replace(ids=b.ids % DENSE_BASE["vocabulary_size"])
            for b in out]


def _save_batches(path, batches):
    np.savez(path, **{f"b{s}_{f}": np.asarray(getattr(b, f))
                      for s, b in enumerate(batches)
                      for f in JaxBatch._fields[:5]})


def _ref_leaves(optimizer, opt):
    """The reference's dense optimizer leaves in the port's state order."""
    if optimizer == "adagrad":
        acc = opt[0].sum_of_squares
        return [acc.w0, acc.table]
    if optimizer == "ftrl":
        return [opt.z.w0, opt.z.table, opt.n.w0, opt.n.table]
    if optimizer == "adam":
        a = opt[0]
        return [a.mu.w0, a.mu.table, a.nu.w0, a.nu.table, a.count]
    return []


_OPT_KEYS = {"adagrad": ("acc_w0", "acc_table"),
             "ftrl": ("z_w0", "z_table", "n_w0", "n_table"), "sgd": (),
             "adam": ("mu_w0", "mu_table", "nu_w0", "nu_table", "count")}


def _npz(model_file):
    with np.load(checkpoint.params_path(model_file)) as z:
        return {k: z[k] for k in z.files}


def _assert_npz(got, want, tol, where):
    assert set(got) == set(want), where
    for k in want:
        if got[k].dtype.kind in "iu":
            assert got[k] == want[k], (where, k)
        else:
            np.testing.assert_allclose(got[k], want[k], **tol,
                                       err_msg=f"{where} {k}")


def _assert_ref(got, jt, optimizer, tol, where):
    state = jt.state
    np.testing.assert_allclose(got["params/table"],
                               np.asarray(state.params.table), **tol,
                               err_msg=where)
    np.testing.assert_allclose(got["scalar/w0"], np.asarray(state.params.w0),
                               **tol, err_msg=where)
    for key, ref in zip(_OPT_KEYS[optimizer],
                        _ref_leaves(optimizer, state.opt_state)):
        ref = np.asarray(ref)
        if ref.dtype.kind in "iu":
            assert got[f"opt/{key}"] == ref, (where, key)
        else:
            np.testing.assert_allclose(got[f"opt/{key}"], ref, **tol,
                                       err_msg=f"{where} {key}")


def _jax_dense(tmp_path, name, kw, shape):
    """The reference's dense ``Trainer`` on a jax mesh of ``shape`` and
    the port's initial checkpoint of its parameters (step 0)."""
    jt = JaxTrainer(JaxFmConfig(model_file=str(tmp_path / f"jax_{name}"),
                                mesh_data=shape[0], mesh_model=shape[1],
                                **kw))
    assert not jt.sparse
    assert dict(jt.mesh.shape) == {"data": shape[0], "model": shape[1]}
    init = jax.tree.map(np.asarray, jt.state.params)
    port_dir = str(tmp_path / f"init_{name}")
    checkpoint.save_params(port_dir, weights.from_jax(init.w0, init.table,
                                                      device="cpu"))
    return jt, port_dir


def _single(model_dir, kw, batches, first=0):
    """The port's single-process dense run over ``batches``, saved."""
    t = Trainer(FmConfig(model_file=model_dir, **kw), device="cpu")
    assert not t.sparse and not t.sharded
    for b in batches[first:]:
        t.train_step(b)
    t.save(len(batches) - first)
    return t


def test_dense_path_on_a_mesh_matches_the_reference_and_one_process(
        tmp_path):
    """Every case on 2 x 2 against the reference's GSPMD ``Trainer`` on a
    2 x 2 jax mesh and the port's single-process run (``params.npz`` key
    for key); then the warm start 2 x 2 -> 1 x 1 -> 1 x 4 (Adam, the full
    L2: its count and moments carry over) against one uninterrupted
    single-process run, and a 1 x 4 warm start from the reference's
    Orbax checkpoint (``params/``, ``opt/``) against the reference's
    continued run."""
    trainer_cases, checks = [], []
    for i, case in enumerate(_DENSE_CASES):
        kw = dict(DENSE_BASE, **case)
        batches = _dense_batches(DENSE_STEPS, kw.get("field_num", 0))
        _save_batches(tmp_path / f"batches{i}.npz", batches)
        jt, init_dir = _jax_dense(tmp_path, str(i), kw, (2, 2))
        for b in batches:
            jt.state = jt._train_step(jt.state, jt._put(b))
        mesh_dir = str(tmp_path / f"mesh{i}")
        shutil.copytree(init_dir, mesh_dir)
        trainer_cases.append({"cfg": dict(kw, model_file=mesh_dir,
                                          mesh_data=2, mesh_model=2),
                              "batches": f"batches{i}", "first": 0,
                              "steps": DENSE_STEPS})
        single_dir = str(tmp_path / f"single{i}")
        shutil.copytree(init_dir, single_dir)
        single = _single(single_dir, kw, [libsvm.Batch(*b) for b in batches])
        checks.append((case, jt, mesh_dir, single_dir,
                       single.global_metrics(single.metrics)))
    # The warm-start chain: its first leg on 2 x 2 in the same group.
    kw = dict(DENSE_BASE, **WARM)
    chain = [libsvm.Batch(*b) for b in _dense_batches(6, seed=9)]
    _save_batches(tmp_path / "chain.npz", chain)
    _, init_dir = _jax_dense(tmp_path, "chain", kw, (2, 2))
    warm_dir = str(tmp_path / "warm")
    shutil.copytree(init_dir, warm_dir)
    trainer_cases.append({"cfg": dict(kw, model_file=warm_dir, mesh_data=2,
                                      mesh_model=2),
                          "batches": "chain", "first": 0, "steps": 2})
    (tmp_path / "trainer.json").write_text(json.dumps(trainer_cases))
    run_ranks("trainer", 4, tmp_path)
    for i, (case, jt, mesh_dir, single_dir, metrics) in enumerate(checks):
        tol = BF16_TOL if case.get("compute_dtype") else TOL
        got = _npz(mesh_dir)
        where = f"dense case {case}"
        _assert_npz(got, _npz(single_dir), tol, where)
        _assert_ref(got, jt, case["optimizer"], tol, where)
        assert int(got["scalar/step"]) == DENSE_STEPS
        ranks = [json.loads((tmp_path / f"trainer{i}_{r}.json").read_text())
                 for r in range(4)]
        for res in ranks:  # every rank reports the global metrics
            assert res == ranks[0]
        np.testing.assert_allclose(ranks[0]["loss"], metrics["loss"],
                                   rtol=1e-5 if tol is TOL else 1e-2,
                                   err_msg=where)
    # 1 x 1: two more steps from the 2 x 2 save (count 2 -> 4).
    one = Trainer(FmConfig(model_file=warm_dir, **kw), device="cpu")
    assert one._restored_step == 2 and int(one.opt_state.count) == 2
    for b in chain[2:4]:
        one.train_step(b)
    one.save(2)
    # 1 x 4: two more (count 4 -> 6), and the Orbax warm start.
    jt, _ = _jax_dense(tmp_path, "orbax", kw, (1, 4))
    for b in chain[:2]:
        jt.state = jt._train_step(jt.state, jt._put(JaxBatch(*b[:5])))
    jt.save(2)
    orbax_dir = str(tmp_path / "orbax")
    shutil.copytree(tmp_path / "jax_orbax", orbax_dir)
    assert orbax_read.exists(orbax_dir)
    for b in chain[2:4]:
        jt.state = jt._train_step(jt.state, jt._put(JaxBatch(*b[:5])))
    group = [{"cfg": dict(kw, model_file=warm_dir, mesh_data=1,
                          mesh_model=4),
              "batches": "chain", "first": 4, "steps": 2},
             {"cfg": dict(kw, model_file=orbax_dir, mesh_data=1,
                          mesh_model=4),
              "batches": "chain", "first": 2, "steps": 2}]
    os.makedirs(tmp_path / "1x4")
    shutil.copy(tmp_path / "chain.npz", tmp_path / "1x4" / "chain.npz")
    (tmp_path / "1x4" / "trainer.json").write_text(json.dumps(group))
    run_ranks("trainer", 4, tmp_path / "1x4")
    whole_dir = str(tmp_path / "whole")
    shutil.copytree(init_dir, whole_dir)
    _single(whole_dir, kw, chain)
    got = _npz(warm_dir)
    assert int(got["scalar/step"]) == 6 and int(got["opt/count"]) == 6
    _assert_npz(got, _npz(whole_dir), TOL, "warm start chain")
    got = _npz(orbax_dir)
    assert int(got["scalar/step"]) == 4 and int(got["opt/count"]) == 4
    assert not orbax_read.exists(orbax_dir)
    _assert_ref(got, jt, "adam", TOL, "Orbax warm start")


# ------------------------------------------- the multi-rank FFM trainer


def _ffm_files(tmp_path, n_lines=384, vocab=1024, field_num=3):
    rng = np.random.default_rng(21)
    files = []
    for name in ("a", "b"):
        path = tmp_path / f"{name}.libsvm"
        with open(path, "w") as f:
            for _ in range(n_lines):
                toks = [str(rng.integers(0, 2))]
                toks += [f"{rng.integers(0, field_num)}:"
                         f"{rng.integers(0, vocab)}:{rng.uniform(0.1, 1):.4f}"
                         for _ in range(5)]
                f.write(" ".join(toks) + "\n")
        files.append(str(path))
    return files


def test_multi_rank_ffm_trainer_matches_single_process(tmp_path):
    """Four ranks (2 x 2) train FFM from libsvm files (the line stream,
    which deals out the single process's global batches) with
    validation: the entries exchange, the same with its id plane
    overlapped (two steps a dispatch; bitwise the entries run), and the
    dense exchange, each against the single-process trainer (metrics,
    and ``params.npz`` within the sharded step's bounds)."""
    files = _ffm_files(tmp_path)
    base = dict(vocabulary_size=1024, factor_num=4, field_num=3,
                max_features=8, batch_size=64, train_files=files,
                validation_files=files[1:], epoch_num=1, log_steps=0,
                seed=5, shuffle_buffer=100, learning_rate=0.1,
                factor_lambda=1e-3, bias_lambda=1e-3, fast_ingest=False,
                steps_per_dispatch=2, mesh_data=2, mesh_model=2)
    runs = [dict(base, sparse_exchange="entries",
                 sparse_exchange_overlap="off",
                 model_file=str(tmp_path / "entries")),
            dict(base, sparse_exchange="entries",
                 sparse_exchange_overlap="on",
                 model_file=str(tmp_path / "overlap")),
            dict(base, lookup="shardmap", sparse_exchange="dense",
                 optimizer="ftrl", model_file=str(tmp_path / "dense"))]
    (tmp_path / "train.json").write_text(json.dumps(runs))
    run_ranks("train", 4, tmp_path)
    results = [[json.loads((tmp_path / f"train{i}_{r}.json").read_text())
                for r in range(4)] for i in range(len(runs))]
    entries, overlap = _npz(runs[0]["model_file"]), _npz(
        runs[1]["model_file"])
    assert set(entries) == set(overlap)
    for k in entries:
        np.testing.assert_array_equal(overlap[k], entries[k], err_msg=k)
    for i, run in enumerate(runs):
        res = results[i]
        for r in res[1:]:
            assert r["validation"] == res[0]["validation"]
        assert res[0]["train"]["steps"] == 12
        single_dir = str(tmp_path / f"single{i}")
        want = Trainer(FmConfig(**dict(run, mesh_data=1, mesh_model=1,
                                       sparse_exchange_overlap="off",
                                       model_file=single_dir)),
                       device="cpu").train()
        for key in ("train", "validation"):
            for m in ("loss", "auc", "examples"):
                np.testing.assert_allclose(res[0][key][m], want[key][m],
                                           rtol=1e-5, err_msg=f"{i} {key}")
        got, ref = _npz(run["model_file"]), _npz(single_dir)
        assert set(got) == set(ref)
        np.testing.assert_allclose(got["params/table"], ref["params/table"],
                                   **TABLE_TOL)
        np.testing.assert_allclose(got["scalar/w0"], ref["scalar/w0"],
                                   **W0_TOL)
        for k in got:
            if k.startswith("opt/"):
                np.testing.assert_allclose(
                    got[k], ref[k], **(ACC_TOL if k.endswith("table")
                                       else W0_TOL), err_msg=k)


# --------------------------------------- the rank-sharded tiered table


def test_fleet_with_ffm_and_bf16_matches_the_dense_mesh_bitwise(tmp_path):
    """Tiering on a mesh runs FFM and bf16 compute where the reference
    runs them (its fleet takes any sparse config): two ranks, the 1 x 2
    fleet (``hot_rows = 512``, evicting) and the dense 1 x 2 mesh from
    the same seed end bit for bit alike for FFM (``field_num = 2``) and
    for bf16 FM: loss, AUC, w0 and its slot, and the table and
    accumulator merged from the shard files against ``params.npz``."""
    from test_torch_tiered_fleet import _bitwise, _logical

    rng = np.random.default_rng(30)
    path = tmp_path / "train.libsvm"
    with open(path, "w") as f:
        for i in range(384):
            f.write(f"{i % 2} " + " ".join(
                f"{rng.integers(0, 2)}:{rng.integers(0, 2048)}:"
                f"{rng.uniform(0.1, 1):.3f}" for _ in range(3)) + "\n")
    common = dict(vocabulary_size=2048, factor_num=4, max_features=4,
                  batch_size=32, train_files=[str(path)], epoch_num=2,
                  log_steps=0, thread_num=1, seed=3, steps_per_dispatch=2,
                  mesh_model=2)
    modes = {"ffm": dict(field_num=2), "bf16": dict(compute_dtype="bfloat16")}
    runs = []
    for name, kw in modes.items():
        runs.append(dict(common, **kw, model_file=str(tmp_path / name)))
        runs.append(dict(common, **kw, model_file=str(tmp_path / f"{name}_f"),
                         table_tiering="on", hot_rows=512))
    (tmp_path / "train.json").write_text(json.dumps(runs))
    run_ranks("train", 2, tmp_path)
    for i, name in enumerate(modes):
        res = [[json.loads((tmp_path / f"train{2 * i + j}_{r}.json")
                           .read_text()) for r in range(2)] for j in (0, 1)]
        for r in range(2):
            for m in ("loss", "auc", "examples", "steps"):
                assert res[1][r]["train"][m] == res[0][r]["train"][m], (
                    name, r, m)
        assert sum(res[1][r]["train"]["tiered"]["rows_evicted"]
                   for r in range(2)) > 0
        d_step, d_sc, d_st = _logical(tmp_path / name, "adagrad",
                                      **modes[name])
        f_step, f_sc, f_st = _logical(tmp_path / f"{name}_f", "adagrad",
                                      **modes[name])
        assert d_step == f_step == res[0][0]["train"]["steps"] == 24
        for key in ("w0", "acc_w0"):
            _bitwise(f_sc[key], d_sc[key], f"{name} {key}")
        for key in ("table", "acc"):
            _bitwise(f_st[key], d_st[key], f"{name} {key}")


@pytest.mark.parametrize("vocab, sparse_update", [
    (1024, True), (1024, False), (1000, True), (1000, False)])
def test_mesh_checks_name_the_tile_limit_not_the_optimizer(vocab,
                                                          sparse_update,
                                                          caplog):
    """``_check_mesh`` on a 2 x 2 mesh: a vocabulary that does not split
    into model shards of whole 256-row tiles gets the tile limit's own
    message, sparse or dense; the dense optax path passes where it
    does (with ``lookup = shardmap``, which the reference's dense step
    never reads) and is logged as the reference's GSPMD step."""
    import logging

    from fast_tffm_tpu_torch.parallel.mesh import Mesh
    from fast_tffm_tpu_torch.train import loop

    cfg = FmConfig(vocabulary_size=vocab, optimizer="adam" if not
                   sparse_update else "adagrad", lookup="shardmap",
                   batch_size=64)
    if vocab % 512:
        with pytest.raises(ValueError, match="whole 256-row tiles") as e:
            loop._check_mesh(cfg, cfg, Mesh(2, 2), sparse_update)
        assert "optimizer" not in str(e.value)
        return
    with caplog.at_level(logging.INFO):
        assert loop._check_mesh(cfg, cfg, Mesh(2, 2), sparse_update) is False
    want = "hand-sharded step" if sparse_update else "GSPMD step"
    assert want in caplog.text


# ------------------- dense Adam on a mesh: its gradient's rounding alone


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dense_adam_mesh_deviation_is_the_gradient_rounding(seed, tmp_path):
    """Path 12's dense Adam (``examples/criteo_kaggle.cfg``'s fields,
    ``l2_mode = full`` at 1e-4, Adam at lr 1e-3, the smoke's
    ``write_labelled`` lines) at V = 2^16 and B = 1024: one step on 2 x 2
    gloo ranks against one device.  Adam's first step moves a weight by
    ``lr g / (|g| + eps)``, whose slope ``lr eps / (|g| + eps)^2`` peaks
    at ``lr / eps`` (10^5) where the gradient cancels to near 0, so the
    float32 rounding of the mesh's differently ordered sums is passed on
    there: every table element within that slope times the difference
    of the two runs' gradients (read from ``mu = 0.1 g``) plus the
    roundings of the step, and the gradients themselves within the
    rounding of their sums."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    lines = str(tmp_path / "train.libsvm")
    chip_smoke.write_labelled(np, lines, rng, 1024,
                              rng.normal(0.0, 0.6, (13, 50)))
    lr, lam = 1e-3, 1e-4
    kw = dict(vocabulary_size=1 << 16, batch_size=1024, seed=seed,
              train_files=[lines], validation_files=[], log_steps=0,
              save_steps=0, fast_ingest=False, sparse_update=False,
              l2_mode="full", factor_lambda=lam, bias_lambda=lam,
              optimizer="adam", learning_rate=lr, thread_num=2)
    cfg_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "criteo_kaggle.cfg")
    from fast_tffm_tpu_torch.config import load_config

    one_dir, mesh_dir = str(tmp_path / "one"), str(tmp_path / "mesh")
    Trainer(load_config(cfg_path, dict(kw, model_file=one_dir)),
            device="cpu").train()
    mesh_cfg = load_config(cfg_path, dict(kw, model_file=mesh_dir,
                                          mesh_data=2, mesh_model=2))
    (tmp_path / "train.json").write_text(json.dumps(
        [dataclasses.asdict(mesh_cfg)]))
    run_ranks("train", 4, tmp_path)
    one, mesh = _npz(one_dir), _npz(mesh_dir)
    assert int(mesh["opt/count"]) == int(one["opt/count"]) == 1
    g1 = one["opt/mu_table"].astype(np.float64) / 0.1
    g2 = mesh["opt/mu_table"].astype(np.float64) / 0.1
    # The gradients: within 2^-14 of the largest (a row's sum has at most
    # 1024 occurrences' terms, each sum rounded in float32).
    scale = np.abs(g1).max()
    assert scale > 0
    np.testing.assert_allclose(g2, g1, rtol=0, atol=2.0**-14 * scale)
    # The table: slope x gradient difference (the slope's largest value
    # between the two gradients; lr / eps where their signs differ), each
    # gradient read back from mu within 2^-22 of itself, plus the roundings
    # of the update and of w - lr u (2^-22 of lr and of |w|).
    dg = np.abs(g1 - g2) + 2.0**-22 * (np.abs(g1) + np.abs(g2))
    low = np.where(np.sign(g1) == np.sign(g2),
                   np.maximum(np.minimum(np.abs(g1), np.abs(g2)) - dg, 0.0),
                   0.0)
    eps = 1e-8
    w1 = one["params/table"].astype(np.float64)
    bound = (lr * eps / (low + eps) ** 2 * dg + 2.0**-22 * lr
             + 2.0**-22 * np.abs(w1))
    dev = np.abs(mesh["params/table"] - w1)
    assert bool(np.all(dev <= bound)), (
        f"{int((dev > bound).sum())} table elements past Adam's slope "
        f"times the gradient difference; max {dev.max():.3e}")
    np.testing.assert_allclose(mesh["scalar/w0"], one["scalar/w0"],
                               **W0_TOL)
