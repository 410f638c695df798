"""The port's quality plane against the JAX package's on the CPU: the
sketches (``obs/sketch.py``), the monitors (``obs/quality.py``), the
trainer's drift sketches and scores feed, the manifest's skew reference
and the server's skew monitor.

- sketches: the same numpy inputs (made from a seed) give ``to_dict()``
  equal exactly, and PSI equal at ``rtol=1e-12``;
- ``QualityMonitor.block`` and ``ServeSkewMonitor.block`` equal on the
  same scores, labels and ids;
- both packages' ``Trainer.train()`` from one initial table (one parse
  thread, so the sketch order is the stream's): the manifests' feature
  sketches equal exactly, the score quantiles within FmScorer's
  ``rtol=1e-5, atol=1e-6``, and each package's ``ServeSkewMonitor``
  reads the other's manifest;
- the plane only observes: quality on and off train bitwise the same,
  in thread and pool mode; off, no block and no manifest key; cache
  replays are not sketched again; the pool's merged deltas count every
  parsed example once.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.obs import quality as jax_quality
from fast_tffm_tpu.obs import sketch as jax_sketch
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs import quality, sketch
from fast_tffm_tpu_torch.serve import server as serve_server
from fast_tffm_tpu_torch.train import checkpoint
from fast_tffm_tpu_torch.train.loop import Trainer
from fast_tffm_tpu_torch.train.manifest import read_manifest

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
PSI_TOL = dict(rtol=1e-12, atol=0)


def _ids_vals(rng, n=256, f=6, vocab=5000):
    ids = rng.integers(0, vocab, (n, f)).astype(np.int32)
    vals = rng.uniform(0.0, 2.0, (n, f)).astype(np.float32)
    vals[:, -2:] = 0.0  # padding slots
    weights = (rng.random(n) < 0.9).astype(np.float32)
    return ids, vals, weights


# ------------------------------------------------------------ sketches


@pytest.mark.parametrize("k", [16, 128])
def test_quantile_sketch_equals_the_reference(k):
    rng = np.random.default_rng(1)
    a, b = sketch.QuantileSketch(k), jax_sketch.QuantileSketch(k)
    for chunk in np.array_split(rng.normal(size=20000), 37):
        a.update(chunk)
        b.update(chunk)
    assert a.to_dict() == b.to_dict()
    for q in (0.01, 0.5, 0.99):
        assert a.quantile(q) == b.quantile(q)
    other = rng.normal(0.3, 1.2, 5000)
    c, d = sketch.QuantileSketch(k), jax_sketch.QuantileSketch(k)
    c.update(other)
    d.update(other)
    np.testing.assert_allclose(sketch.psi_quantile(a, c),
                               jax_sketch.psi_quantile(b, d), **PSI_TOL)
    assert a.merge(c).to_dict() == b.merge(d).to_dict()


def test_freq_sketch_and_sketch_set_equal_the_reference():
    rng = np.random.default_rng(2)
    pa, pb = sketch.SketchSet(), jax_sketch.SketchSet()
    for _ in range(12):
        ids, vals, w = _ids_vals(rng)
        pa.update_batch(ids, vals, w)
        pb.update_batch(ids, vals, w)
        s = rng.random(256)
        pa.update_scores(s)
        pb.update_scores(s)
    assert pa.to_dict() == pb.to_dict()
    assert json.dumps(pa.to_dict()) == json.dumps(pb.to_dict())
    qa, qb = sketch.SketchSet(), jax_sketch.SketchSet()
    ids, vals, w = _ids_vals(rng, vocab=300)  # a narrower id set: drift
    qa.update_batch(ids, vals, w)
    qb.update_batch(ids, vals, w)
    psi_a, psi_b = qa.psi_vs(pa), qb.psi_vs(pb)
    assert sorted(psi_a) == sorted(psi_b)
    for key in psi_a:
        np.testing.assert_allclose(psi_a[key], psi_b[key], **PSI_TOL)
    np.testing.assert_allclose(sketch.psi_freq(pa.ids, qa.ids),
                               jax_sketch.psi_freq(pb.ids, qb.ids),
                               **PSI_TOL)
    # Serialized across packages, both ways.
    assert sketch.SketchSet.from_dict(pb.to_dict()).to_dict() == \
        pa.to_dict()
    assert jax_sketch.SketchSet.from_dict(pa.to_dict()).to_dict() == \
        pb.to_dict()


# ------------------------------------------------------------ monitors


def test_quality_monitor_block_equals_the_reference():
    rng = np.random.default_rng(3)
    blocks = []
    for mod in (quality, jax_quality):
        sk = mod.StreamSketch(64)
        mon = mod.QualityMonitor(loss_type="logistic", window=300,
                                 sketch=sk)
        r = np.random.default_rng(4)
        for _ in range(9):
            ids, vals, w = _ids_vals(r, n=64)
            sk.update_batch(ids, vals, w)
            mon.observe(r.normal(size=(2, 32)), r.integers(0, 2, (2, 32)),
                        r.random((2, 32)) < 0.95)
        blocks.append(mon.block(force=True))
    assert blocks[0] == blocks[1]
    assert blocks[0]["window_examples"] == 300
    assert {"logloss", "auc", "calib_ratio"} <= set(blocks[0])
    del rng


def test_serve_skew_monitor_block_equals_the_reference():
    rng = np.random.default_rng(5)
    ref_a, ref_b = sketch.SketchSet(), jax_sketch.SketchSet()
    for _ in range(4):
        ids, vals, w = _ids_vals(rng)
        ref_a.update_batch(ids, vals, w)
        ref_b.update_batch(ids, vals, w)
        s = rng.random(256)
        ref_a.update_scores(s)
        ref_b.update_scores(s)
    blocks = []
    for mod, ref in ((quality, ref_a), (jax_quality, ref_b)):
        mon = mod.ServeSkewMonitor(window_examples=500)
        mon.set_reference(ref, step=7)
        r = np.random.default_rng(6)
        for _ in range(5):
            ids, vals, _ = _ids_vals(r, n=120, vocab=800)
            mon.observe_batch(ids, vals)
            mon.observe_scores(r.random(120) * 0.5)
        blocks.append(mon.block(force=True))
    assert sorted(blocks[0]) == sorted(blocks[1])
    for key, val in blocks[0].items():
        np.testing.assert_allclose(val, blocks[1][key], **PSI_TOL)
    assert blocks[0]["skew_examples"] > 0


# ------------------------------------------------------------ the trainer


def _write(path, rng, lines, vocab=400, feats=5):
    with open(path, "w") as f:
        for i in range(lines):
            toks = " ".join(f"{rng.integers(0, vocab)}:{rng.random():.4f}"
                            for _ in range(rng.integers(1, feats + 1)))
            f.write(f"{rng.integers(0, 2)} {toks}\n")


def _common(tmp_path, **kw):
    out = dict(
        vocabulary_size=512, factor_num=4, max_features=6, batch_size=32,
        epoch_num=2, learning_rate=0.1, seed=5, log_steps=0,
        thread_num=1, steps_per_dispatch=2, quality_window=256,
        train_files=[str(tmp_path / "train.libsvm")],
    )
    out.update(kw)
    return out


def test_trainer_sketches_and_scores_match_the_reference(tmp_path):
    """One parse thread on both sides: the manifests' feature sketches
    are equal exactly, the training score quantiles agree within the
    scorer's bound, both quality blocks count every trained example,
    and each package's skew monitor reads the other's manifest."""
    _write(tmp_path / "train.libsvm", np.random.default_rng(7), 700)
    jcfg = JaxFmConfig(model_file=str(tmp_path / "jax_model"),
                       sparse_apply="scatter", **_common(tmp_path))
    jt = JaxTrainer(jcfg)
    init = jax.tree.map(np.asarray, jt.state.params)
    jres = jt.train()
    port_dir = str(tmp_path / "port_model")
    checkpoint.save_params(port_dir, weights.from_jax(init.w0, init.table,
                                                      device="cpu"))
    pres = Trainer(FmConfig(model_file=port_dir, **_common(tmp_path)),
                   device="cpu").train()
    got, want = read_manifest(port_dir), read_manifest(jcfg.model_file)
    assert got["quality"]["examples"] == want["quality"]["examples"] == 1400
    gs, ws = got["quality"]["sketches"], want["quality"]["sketches"]
    for key in ("values", "lengths", "ids", "examples"):
        assert gs[key] == ws[key], key
    a = sketch.QuantileSketch.from_dict(gs["scores"])
    b = sketch.QuantileSketch.from_dict(ws["scores"])
    assert a.n == b.n == 1400
    for q in (0.05, 0.25, 0.5, 0.75, 0.95):
        np.testing.assert_allclose(a.quantile(q), b.quantile(q), **SCORE_TOL)
    pq, jq = pres["train"]["quality"], jres["train"]["quality"]
    assert pq["examples"] == jq["examples"] == 1400
    np.testing.assert_allclose(pq["logloss"], jq["logloss"], rtol=1e-5)
    # Cross-package skew references.
    for mod, model in ((quality, jcfg.model_file),
                       (jax_quality, port_dir)):
        def read(model=model):
            man = json.load(open(os.path.join(model,
                                              "serve_manifest.json")))
            return {"step": man["step"], **man["quality"]}

        mon = mod.ServeSkewMonitor(read_reference=read)
        assert mon.reload_reference()
        mon.observe_scores(np.full(64, 0.5))
        assert "skew_psi_scores" in mon.block(force=True)


def _tables(t):
    out = [t.model.w0.detach().clone(), t.model.table.detach().clone()]
    out += [x.detach().clone() for x in t.opt_state]
    return out


@pytest.mark.parametrize("mode", [
    dict(thread_num=2), dict(parse_processes=2),
    dict(thread_num=2, cache_epochs=True, epoch_num=3),
])
def test_quality_only_observes(tmp_path, mode):
    """Quality on and off train bitwise the same (tables, accumulator,
    w0 and the losses); off leaves no block and no manifest key; on,
    the pool's sketch deltas count every parsed example once, and a
    cache's replays are not sketched again."""
    _write(tmp_path / "train.libsvm", np.random.default_rng(8), 640)
    runs = {}
    for q in (False, True):
        t = Trainer(FmConfig(model_file=str(tmp_path / f"m{q}"),
                             **_common(tmp_path, quality=q, **mode)),
                    device="cpu")
        runs[q] = (t, t.train())
    for a, b in zip(_tables(runs[False][0]), _tables(runs[True][0])):
        assert torch.equal(a, b)
    assert runs[False][1]["train"]["loss"] == runs[True][1]["train"]["loss"]
    assert "quality" not in runs[False][1]["train"]
    assert "quality" not in read_manifest(str(tmp_path / "mFalse"))
    epochs = mode.get("epoch_num", 2)
    man = read_manifest(str(tmp_path / "mTrue"))["quality"]
    # Parsed examples: one epoch with the cache (the replays are not
    # sketched), every epoch otherwise.
    parsed = 640 * (1 if mode.get("cache_epochs") else epochs)
    assert man["examples"] == parsed
    block = runs[True][1]["train"]["quality"]
    assert block["examples"] == 640 * epochs  # every trained score
    assert block["sketch_examples"] == parsed


def test_server_reports_skew_against_the_port_manifest(tmp_path):
    """A port-trained checkpoint served by the port: the ``skew_*`` keys
    are present and finite after requests, and ``quality = false``
    serves without them."""
    import urllib.request

    _write(tmp_path / "train.libsvm", np.random.default_rng(9), 320)
    kw = _common(tmp_path, epoch_num=1)
    Trainer(FmConfig(model_file=str(tmp_path / "m"), **kw),
            device="cpu").train()
    lines = open(tmp_path / "train.libsvm").read().encode()
    for q in (True, False):
        cfg = FmConfig(model_file=str(tmp_path / "m"), quality=q,
                       serve_poll_secs=0.0, serve_batch_sizes="64", **kw)
        handle = serve_server.serve(cfg, device="cpu", port=0)
        try:
            for _ in range(4):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{handle.port}/score", data=lines,
                    method="POST")
                urllib.request.urlopen(req, timeout=30).read()
            block = handle._build("final")["serve"]
        finally:
            handle.close()
        skew = {k: v for k, v in block.items() if k.startswith("skew_")}
        if q:
            assert skew["skew_examples"] > 0
            assert all(np.isfinite(v) for v in skew.values())
            assert "skew_psi_ids" in skew
        else:
            assert skew == {}
