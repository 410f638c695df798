"""BASELINE's evaluation configs 2, 3 and 4 on the port vs the JAX
package, on the CPU at small sizes.

- Config 2, ``examples/avazu.cfg`` (FM on Avazu: hashed string ids,
  ``max_features = 24`` over 22 fields): its fields with V cut to 2^12
  and B to 64, on seeded Avazu-shaped lines (the smoke's
  ``write_avazu``).  The port trains from the
  reference's initial table, validates and predicts, and serves the
  hashed tokens over ``/score``.
- Config 3, ``examples/sweep_optimizers.py``: the port's
  ``tools/sweep_optimizers.py``, cell by cell against the reference's
  ``Trainer`` on the cell's overrides, and its ``main()``.
- Config 4, ``examples/criteo_1tb_dist.cfg`` (``lookup = shardmap``,
  ``sparse_exchange = auto``): its fields at small V and B, on one
  device and on a 2 x 2 mesh of four gloo ranks, each against the
  reference's ``Trainer`` on the same data and mesh (conftest's 8
  virtual CPU devices), on the smoke's hashed Criteo-shaped lines.

JAX's threefry init cannot be reproduced in torch, so the reference's
initial table is handed to the port.  Tolerances are the reference's
(tests/test_sparse_apply.py, tests/test_pallas_ops.py): table ``rtol=1e-4,
atol=1e-6``, accumulator ``atol=1e-4``, w0 ``rtol=1e-5, atol=1e-7``,
scores ``rtol=1e-5, atol=1e-6``.
"""

import ast
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.parallel import mesh as jax_mesh
from fast_tffm_tpu.serve import textparse as jax_textparse
from fast_tffm_tpu.serve.scorer import FixedShapeScorer as JaxScorer
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu.train.loop import predict as jax_predict
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.serve.server import serve
from fast_tffm_tpu_torch.tools import sweep_optimizers
from fast_tffm_tpu_torch.train import checkpoint
from fast_tffm_tpu_torch.train.loop import Trainer, predict

import chip_smoke
from _torch_sharded_worker import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AVAZU_CFG = os.path.join(REPO, "examples", "avazu.cfg")
DIST_CFG = os.path.join(REPO, "examples", "criteo_1tb_dist.cfg")
SAMPLE_CFG = os.path.join(REPO, "examples", "sample.cfg")
SWEEP_EXAMPLE = os.path.join(REPO, "examples", "sweep_optimizers.py")
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-4, atol=1e-4)
W0_TOL = dict(rtol=1e-5, atol=1e-7)
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
# A printed six-decimal score: one unit of the last digit (scores ~1e-7
# apart may round either way).
PRINTED_ATOL = 1.01e-6


def _port_init(tmp_path, name, jt) -> str:
    """The port's model dir holding the reference trainer's initial
    parameters (step 0)."""
    init = jax.tree.map(np.asarray, jt.state.params)
    path = str(tmp_path / name)
    checkpoint.save_params(path, weights.from_jax(init.w0, init.table,
                                                  device="cpu"))
    return path


def _assert_state(port_table, port_acc, port_w0, jt, where):
    params = jt.state.params
    np.testing.assert_allclose(port_table, np.asarray(params.table),
                               **TABLE_TOL, err_msg=where)
    np.testing.assert_allclose(port_w0, float(params.w0), **W0_TOL,
                               err_msg=where)
    np.testing.assert_allclose(port_acc, np.asarray(jt.state.opt_state.acc
                                                    .table), **OPT_TOL,
                               err_msg=where)


# ------------------------------------------------ config 2: Avazu


@pytest.fixture(scope="module")
def avazu(tmp_path_factory):
    """Both packages trained on ``avazu.cfg``'s fields (V = 2^12, B = 64)
    from one initial table, validated and predicted."""
    tmp_path = tmp_path_factory.mktemp("avazu")
    rng = np.random.default_rng(27)
    train = str(tmp_path / "avazu_train.libsvm")
    valid = str(tmp_path / "avazu_valid.libsvm")
    chip_smoke.write_avazu(np, train, rng, 1280)
    chip_smoke.write_avazu(np, valid, rng, 320)
    over = dict(vocabulary_size=1 << 12, batch_size=64, train_files=[train],
                validation_files=[valid], predict_files=[valid],
                log_steps=0)
    jcfg = jax_load_config(AVAZU_CFG, dict(
        over, model_file=str(tmp_path / "jax_model"),
        score_path=str(tmp_path / "jax_scores.txt")))
    cfg = load_config(AVAZU_CFG, dict(
        over, model_file=str(tmp_path / "port_model"),
        score_path=str(tmp_path / "port_scores.txt")))
    assert (cfg.hash_feature_id, cfg.max_features, cfg.embedding_dim,
            cfg.optimizer, cfg.learning_rate) == (True, 24, 9, "adagrad", 0.1)
    jt = JaxTrainer(jcfg)
    shutil.move(_port_init(tmp_path, "init", jt), cfg.model_file)
    jres = jt.train()
    trainer = Trainer(cfg, device="cpu")
    pres = trainer.train()
    predicted = (jax_predict(jcfg), predict(cfg, device="cpu"))
    return dict(tmp=tmp_path, cfg=cfg, jcfg=jcfg, jt=jt, jres=jres,
                trainer=trainer, pres=pres, valid=valid, predicted=predicted)


def test_avazu_config_trains_as_the_reference(avazu):
    pres, jres, tr = avazu["pres"], avazu["jres"], avazu["trainer"]
    for key in ("steps", "examples", "truncated_features"):
        assert pres["train"][key] == jres["train"][key], key
    assert pres["train"]["steps"] == 20
    # 22 tokens a line in 24 slots: nothing truncated, two pads a line.
    assert pres["train"]["truncated_features"] == 0
    _assert_state(tr.model.table.detach().numpy(),
                  tr.opt_state.acc_table.numpy(),
                  float(tr.model.w0.detach()), avazu["jt"], "avazu")


def test_avazu_config_validates_and_predicts_as_the_reference(avazu):
    got, want = avazu["pres"]["validation"], avazu["jres"]["validation"]
    assert got["examples"] == want["examples"] == 320
    assert got["weight_sum"] == want["weight_sum"]
    np.testing.assert_allclose(got["logloss"], want["logloss"], rtol=1e-5)
    np.testing.assert_allclose(got["auc"], want["auc"], atol=1e-4)
    assert got["auc"] > 0.5  # the planted labels are learnable
    assert avazu["predicted"] == (320, 320)
    np.testing.assert_allclose(np.loadtxt(avazu["cfg"].score_path),
                               np.loadtxt(avazu["jcfg"].score_path),
                               rtol=0, atol=PRINTED_ATOL)


def test_avazu_hashed_score_matches_the_reference_scorer(avazu):
    """The port's server answers ``/score`` with the hashed Avazu tokens
    as the reference's scorer scores them on the same (the port's
    trained) table, and as the port's predict file."""
    cfg = avazu["cfg"]
    with open(avazu["valid"]) as f:
        lines = [ln.split(" ", 1)[1] for ln in f.read().splitlines()]
    text = "\n".join(lines) + "\n"
    handle = serve(cfg, device="cpu", port=0)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{handle.port}/score", data=text.encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            served = np.array(resp.read().decode().split(), np.float64)
    finally:
        handle.close()
    _, params = checkpoint.restore_params(cfg.model_file, device="cpu")
    jcfg = avazu["jcfg"]
    ids, vals, _, n, trunc = jax_textparse.parse_request(text, jcfg)
    assert (n, trunc) == (320, 0)
    ref = JaxScorer(jcfg, jax_fm.FmParams(
        w0=jnp.asarray(params.w0.detach().numpy()),
        table=jnp.asarray(params.table.detach().numpy()))).score(ids, vals)
    # Served text has six decimals: the tolerance plus half a unit.
    np.testing.assert_allclose(served, ref, rtol=SCORE_TOL["rtol"],
                               atol=SCORE_TOL["atol"] + 5e-7)
    np.testing.assert_allclose(served, np.loadtxt(cfg.score_path), rtol=0,
                               atol=PRINTED_ATOL)


# ------------------------------------------- config 4: criteo_1tb_dist


DIST_V, DIST_B = 4096, 64


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_criteo_1tb_dist_config_matches_the_reference(shape, tmp_path):
    """``criteo_1tb_dist.cfg``'s fields (F = 39, Adagrad at lr 0.05, L2
    1e-6, ``lookup = shardmap``, ``sparse_exchange = auto``, 16 parse
    threads) at V = 4096 and B = 64, on one device and on a 2 x 2 mesh of
    four ranks, each against the reference's ``Trainer`` on the same
    lines and mesh, from its initial table."""
    rng = np.random.default_rng(26)
    train = str(tmp_path / "criteo_day_0.libsvm")
    chip_smoke.write_labelled(np, train, rng, 512,
                              rng.normal(0.0, 0.6, (13, 50)))
    over = dict(vocabulary_size=DIST_V, batch_size=DIST_B,
                train_files=[train], mesh_data=shape[0], mesh_model=shape[1],
                log_steps=0)
    jcfg = jax_load_config(DIST_CFG, dict(
        over, model_file=str(tmp_path / "jax_model")))
    # One device is one device for the reference too (its 1 x 1 config
    # takes every visible device as data otherwise).
    jt = JaxTrainer(jcfg, mesh=jax_mesh.make_mesh(
        jcfg, jax.devices()[:shape[0] * shape[1]]))
    assert dict(jt.mesh.shape) == {"data": shape[0], "model": shape[1]}
    model_file = _port_init(tmp_path, "port_model", jt)
    jres = jt.train()["train"]
    cfg = dict(over, model_file=model_file)
    assert load_config(DIST_CFG, cfg).lookup == "shardmap"
    if shape == (1, 1):
        trainer = Trainer(load_config(DIST_CFG, cfg), device="cpu")
        assert not trainer.sharded
        res = trainer.train()["train"]
    else:
        # auto resolves to the entries exchange, as at the config's own
        # shape (2^26 rows, 262,144 lines over 2 data blocks).
        for v, b in ((DIST_V, DIST_B), (1 << 26, 262144)):
            assert sparse_apply.resolve_exchange(
                "auto", n_local_occ=b // 2 * 39, vocab_local=v // 2, d=9,
                data_shards=2) == "entries"

        fields = dataclasses.asdict(load_config(DIST_CFG, cfg))
        (tmp_path / "train.json").write_text(json.dumps([fields]))
        run_ranks("train", 4, tmp_path)
        results = [json.loads((tmp_path / f"train0_{r}.json").read_text())
                   for r in range(4)]
        for other in results[1:]:
            assert other["train"]["logloss"] == results[0]["train"]["logloss"]
        res = results[0]["train"]
    assert res["steps"] == jres["steps"] == 512 // DIST_B
    assert res["examples"] == jres["examples"]
    np.testing.assert_allclose(res["logloss"], jres["logloss"], rtol=1e-5)
    with np.load(checkpoint.params_path(model_file)) as z:
        assert int(z["scalar/step"]) == 512 // DIST_B
        _assert_state(z["params/table"], z["opt/acc_table"],
                      float(z["scalar/w0"]), jt, f"criteo_1tb_dist {shape}")


# ------------------------------------------------ config 3: the sweep


def _example_grid() -> list:
    """``GRID`` from the example's source text (the example imports the
    JAX package, so it is read, not imported)."""
    with open(SWEEP_EXAMPLE) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["GRID"]):
            return ast.literal_eval(node.value)
    raise AssertionError("no GRID in the example")


def test_sweep_grid_and_base_are_the_examples():
    assert sweep_optimizers.GRID == _example_grid()
    assert len(sweep_optimizers.GRID) == 6
    assert os.path.samefile(sweep_optimizers.DEFAULT_BASE, SAMPLE_CFG)


@pytest.fixture(scope="module")
def sweep_base(tmp_path_factory):
    """A copy of ``sample.cfg`` over ``gen_sample_data.py``-shaped data
    (its planted FM structure; 2000 training and 500 validation lines,
    two epochs)."""
    tmp = tmp_path_factory.mktemp("sweep")
    subprocess.run([sys.executable, os.path.join(REPO, "examples",
                                                 "gen_sample_data.py"),
                    "--out", str(tmp / "data"), "--train", "2000",
                    "--valid", "500"], check=True, capture_output=True)
    with open(SAMPLE_CFG) as f:
        text = f.read().replace("examples/data", str(tmp / "data"))
    text = text.replace("epoch_num = 10", "epoch_num = 2")
    path = tmp / "base.cfg"
    path.write_text(text)
    return str(path), tmp


@pytest.mark.parametrize("cell", range(6))
def test_sweep_cell_matches_the_reference(cell, sweep_base, tmp_path):
    """One cell through the tool's ``run_cell``, from the reference's
    initial table, against the reference's ``Trainer`` on the cell's
    overrides: validation logloss and AUC equal at the printed
    rounding."""
    base, _ = sweep_base
    overrides = sweep_optimizers.GRID[cell]
    jcfg = jax_load_config(base, {**overrides, "log_steps": 0,
                                  "model_file": str(tmp_path / "jax")})
    jt = JaxTrainer(jcfg)
    model_file = _port_init(tmp_path, "port", jt)
    m = jt.train()["validation"]
    want = {**overrides, "logloss": round(m["loss"], 6),
            "auc": round(m["auc"], 4)}
    got = sweep_optimizers.run_cell(base, overrides, model_file,
                                    device="cpu")
    assert got == want


def test_sweep_main_prints_six_rows_and_best(sweep_base):
    base, tmp = sweep_base
    out = io.StringIO()
    with redirect_stdout(out):
        assert sweep_optimizers.main([base, "--device", "cpu",
                                      "--model_root", str(tmp)]) == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 7 and lines[-1].startswith("best: ")
    rows = [json.loads(ln) for ln in lines[:6]]
    for row, overrides in zip(rows, sweep_optimizers.GRID):
        assert {k: row[k] for k in overrides} == overrides
        assert np.isfinite(row["logloss"]) and 0.0 < row["auc"] <= 1.0
    best = json.loads(lines[-1][len("best: "):])
    assert best == min(rows, key=lambda r: r["logloss"])
    for i in range(6):  # each cell's own model dir, trained
        assert os.path.exists(checkpoint.params_path(
            sweep_optimizers.model_dir(str(tmp), i)))
