"""The port's field-aware FM (``field_num > 0``) vs the JAX package on the
CPU: the FFM op forward and backward, its padded slots, its bf16 mode,
the model's scores, carried weights, the trainer (Adagrad, FTRL and SGD;
host and device sort; K = 1 and 4), validation and predict, both serve
transports, and the epoch cache and process pool with fields.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own: the op's ``tests/test_ffm_op.py``
(forward ``rtol=1e-6, atol=1e-6``, backward ``rtol=1e-5, atol=1e-6``,
bf16 against f32 ``rtol=2e-2, atol=2e-2``: on the CPU the reference
computes bf16 FFM in f32, where the port rounds as the reference's TPU
program does), the trainer's tile-vs-scatter bounds
(``tests/test_sparse_apply.py``) and the scorer's ``rtol=1e-5,
atol=1e-6`` (``tests/test_pallas_ops.py``).
"""

import dataclasses
import importlib.util
import os
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.ops import interaction as jax_interaction
from fast_tffm_tpu.serve.scorer import FixedShapeScorer as JaxScorer
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu.train.loop import predict as jax_predict
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models import fm
from fast_tffm_tpu_torch.ops import interaction
from fast_tffm_tpu_torch.serve import textparse, wire
from fast_tffm_tpu_torch.serve.server import serve
from fast_tffm_tpu_torch.train import checkpoint, sparse
from fast_tffm_tpu_torch.train.loop import Trainer, predict

FWD_TOL = dict(rtol=1e-6, atol=1e-6)
BWD_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-4, atol=1e-4)
W0_TOL = dict(rtol=1e-5, atol=1e-7)
SERVE_TOL = dict(rtol=1e-5, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, P, K = 32, 8, 3, 4
D = 1 + P * K


def _op_data(seed, b=B, f=F, p=P, k=K):
    """``(rows, vals, fields, g)`` numpy arrays; the last two slots of
    every example are padding (``vals == 0``, field 0)."""
    rng = np.random.default_rng(seed)
    rows = rng.uniform(-0.5, 0.5, (b, f, 1 + p * k)).astype(np.float32)
    vals = rng.uniform(0.1, 1.0, (b, f)).astype(np.float32)
    fields = rng.integers(0, p, (b, f)).astype(np.int32)
    vals[:, -2:] = 0.0
    fields[:, -2:] = 0
    g = rng.uniform(-1, 1, (b,)).astype(np.float32)
    return rows, vals, fields, g


def _jax_op(rows, vals, fields, g, p=P, k=K):
    """The reference op's scores and its row gradient of ``sum(g * s)``."""
    args = (jnp.asarray(vals), jnp.asarray(fields), k, p)
    scores = jax_interaction.ffm_interaction(jnp.asarray(rows), *args)
    drows = jax.grad(lambda r: jnp.sum(
        jnp.asarray(g) * jax_interaction.ffm_interaction(r, *args)))(
        jnp.asarray(rows))
    return np.asarray(scores), np.asarray(drows)


def _port_op(rows, vals, fields, g, p=P, k=K, dtype=torch.float32,
             op=interaction.ffm_interaction):
    r = torch.from_numpy(rows).requires_grad_()
    scores = op(r, torch.from_numpy(vals), torch.from_numpy(fields), k, p,
                dtype)
    drows, = torch.autograd.grad((scores * torch.from_numpy(g)).sum(), r)
    return scores.detach(), drows


@pytest.mark.parametrize("b, f, p, k", [(32, 8, 3, 4), (7, 16, 8, 4),
                                        (5, 39, 4, 8)])
def test_ffm_op_matches_the_reference(b, f, p, k):
    """Forward and closed-form backward against the reference's
    ``ffm_interaction`` (its custom VJP), at ``ffm_sample.cfg``'s and
    the FFM-Criteo row widths too."""
    rows, vals, fields, g = _op_data(b + f, b, f, p, k)
    want_s, want_d = _jax_op(rows, vals, fields, g, p, k)
    got_s, got_d = _port_op(rows, vals, fields, g, p, k)
    assert got_s.dtype == got_d.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), want_s, **FWD_TOL)
    np.testing.assert_allclose(got_d.numpy(), want_d, **BWD_TOL)


def test_ffm_closed_form_matches_autograd_through_the_scores():
    """The op's closed-form backward against torch autograd through the
    port's own ``ffm_scores_from_rows`` (the reference's oracle)."""
    rows, vals, fields, g = _op_data(1)

    def oracle(r, v, fl, k, p, dtype):
        return fm.ffm_scores_from_rows(torch.zeros(()), r, v, fl, k, p,
                                       dtype)

    got_s, got_d = _port_op(rows, vals, fields, g)
    want_s, want_d = _port_op(rows, vals, fields, g, op=oracle)
    torch.testing.assert_close(got_s, want_s, **FWD_TOL)
    torch.testing.assert_close(got_d, want_d, **BWD_TOL)


def test_ffm_grad_zero_on_padded_slots():
    """Padded features (``val == 0``) get zero row gradients."""
    rows, vals, fields, g = _op_data(2)
    for dtype in (torch.float32, torch.bfloat16):
        _, drows = _port_op(rows, vals, fields, g, dtype=dtype)
        assert torch.equal(drows[:, -2:], torch.zeros_like(drows[:, -2:]))


def test_ffm_bf16_mode_tracks_the_reference_f32():
    """bf16 compute rounds the operands and the products ``w x`` and
    ``x x``, accumulates in f32: scores and the (f32) row gradient stay
    within bf16 rounding of the reference's f32 op, and differ from the
    f32 mode's (the operands were rounded)."""
    rows, vals, fields, g = _op_data(3)
    want_s, want_d = _jax_op(rows, vals, fields, g)
    got_s, got_d = _port_op(rows, vals, fields, g, dtype=torch.bfloat16)
    f32_s, _ = _port_op(rows, vals, fields, g)
    assert got_s.dtype == got_d.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), want_s, **BF16_TOL)
    np.testing.assert_allclose(got_d.numpy(), want_d, **BF16_TOL)
    assert not torch.equal(got_s, f32_s)
    # The backward rounds the operands alone: it is, bitwise, the f32
    # op's backward on the rows and values rounded to bf16 beforehand.
    _, want16 = _port_op(torch.from_numpy(rows).bfloat16().float().numpy(),
                         torch.from_numpy(vals).bfloat16().float().numpy(),
                         fields, g)
    assert torch.equal(got_d, want16)


def test_ffm_scores_match_the_reference_and_drop_fields_past_p():
    """``fm_scores`` / ``FmModel`` with ``field_num`` against the
    reference's ``fm_scores`` on a carried table; a field outside
    ``[0, P)`` (a caller-built batch) contributes no pairwise term in
    both, as the reference's one-hot drops it."""
    rng = np.random.default_rng(4)
    vocab = 50
    w0 = np.float32(0.2)
    table = rng.uniform(-0.3, 0.3, (vocab, D)).astype(np.float32)
    ids = rng.integers(0, vocab, (B, F)).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, (B, F)).astype(np.float32)
    fields = rng.integers(0, P, (B, F)).astype(np.int32)
    fields[::4, 0] = P  # out of range
    fields[1::4, 1] = P + 5
    want = np.asarray(jax_fm.fm_scores(
        jax_fm.FmParams(jnp.asarray(w0), jnp.asarray(table)),
        jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(fields),
        factor_num=K, field_num=P))
    model = weights.from_jax(w0, table, device="cpu")
    args = (torch.from_numpy(ids), torch.from_numpy(vals),
            torch.from_numpy(fields))
    with torch.no_grad():
        got = fm.fm_scores(model, *args, factor_num=K, field_num=P)
        assert torch.equal(model(*args, factor_num=K, field_num=P), got)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    with pytest.raises(ValueError, match="1 \\+ field_num"):
        fm.fm_scores(model, *args, factor_num=K + 1, field_num=P)
    with pytest.raises(ValueError, match="need fields"):
        fm.fm_scores(model, *args[:2], factor_num=K, field_num=P)


def test_weights_carry_an_ffm_table_across():
    """``from_jax`` / ``to_numpy`` / ``opt_state_from_jax`` / ``shard_rows``
    take a ``[V, 1 + P*k]`` table as any other, bitwise, and the carried
    table scores as the reference's."""
    from fast_tffm_tpu.train import sparse as jax_sparse
    from fast_tffm_tpu_torch.parallel.mesh import Mesh

    jcfg = JaxFmConfig(vocabulary_size=64, factor_num=K, field_num=P,
                       optimizer="ftrl")
    params = jax_fm.init_params(jax.random.PRNGKey(3), jcfg)
    assert params.table.shape == (64, D)
    model = weights.from_jax(params.w0, params.table, device="cpu")
    w0, table = weights.to_numpy(model)
    np.testing.assert_array_equal(table, np.asarray(params.table))
    assert w0 == np.asarray(params.w0)
    opt = weights.opt_state_from_jax(
        "ftrl", jax.tree.map(np.asarray,
                             jax_sparse.init_sparse_opt_state(jcfg, params)),
        device="cpu")
    assert opt.z_table.shape == opt.n_table.shape == (64, D)
    mesh = Mesh(data=1, model=2, rank=1)
    np.testing.assert_array_equal(weights.shard_rows(table, mesh, 1),
                                  table[32:])
    _, vals, fields, _ = _op_data(5)
    ids = np.random.default_rng(5).integers(0, 64, (B, F)).astype(np.int32)
    want = np.asarray(jax_fm.fm_scores(
        params, jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(fields),
        factor_num=K, field_num=P))
    with torch.no_grad():
        got = fm.fm_scores(model, torch.from_numpy(ids),
                           torch.from_numpy(vals), torch.from_numpy(fields),
                           factor_num=K, field_num=P)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


# -- training, validation, predict ---------------------------------------


def _gen_module():
    spec = importlib.util.spec_from_file_location(
        "gen_sample_data", os.path.join(REPO, "examples",
                                        "gen_sample_data.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def _ffm_lines(path, n, seed, vocab=300, factor=4, fields=P, n_feat=10):
    """``n`` ``field:id:val`` lines drawn with ``seed`` from one planted
    model (``examples/gen_sample_data.py --ffm``: field = id mod P)."""
    model = np.random.default_rng(42)
    w = model.normal(0, 0.5, size=vocab)
    v = model.normal(0, 0.3, size=(vocab, factor))
    _gen_module().gen(str(path), n, np.random.default_rng(seed), vocab,
                      n_feat, w, v, ffm=True, n_fields=fields)
    return str(path)


def _common(tmp_path, **kw):
    path = _ffm_lines(tmp_path / "train.libsvm", 1280, 5)
    out = dict(
        vocabulary_size=300, factor_num=4, field_num=P, max_features=12,
        batch_size=128, epoch_num=2, learning_rate=0.3,
        adagrad_initial_accumulator=0.01, ftrl_l1=0.01, ftrl_l2=0.1,
        factor_lambda=1e-4, bias_lambda=1e-4, init_value_range=0.05,
        shuffle_buffer=400, seed=7, train_files=[path], log_steps=0,
        save_steps=0,
    )
    out.update(kw)
    return out


def _port_from(tmp_path, jt, common, name="port_model"):
    """The port's trainer from the reference trainer's initial table."""
    init = jax.tree.map(np.asarray, jt.state.params)
    port_dir = str(tmp_path / name)
    checkpoint.save_params(port_dir, weights.from_jax(init.w0, init.table,
                                                      device="cpu"))
    return Trainer(FmConfig(model_file=port_dir, **common), device="cpu")


def _assert_trained_alike(trainer, jt, optimizer):
    params, opt = jt.state.params, jt.state.opt_state
    np.testing.assert_allclose(trainer.model.table.detach().numpy(),
                               np.asarray(params.table), **TABLE_TOL)
    np.testing.assert_allclose(float(trainer.model.w0.detach()),
                               float(params.w0), **W0_TOL)
    want = {"adagrad": lambda: [opt.acc.table],
            "ftrl": lambda: [opt.z.table, opt.n.table],
            "sgd": lambda: []}[optimizer]()
    got = sparse.opt_tables(trainer.opt_state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)


@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl", "sgd"])
@pytest.mark.parametrize("host_sort", [True, False])
@pytest.mark.parametrize("k", [1, 4])
def test_ffm_trainer_matches_the_reference_trainer(tmp_path, optimizer,
                                                   host_sort, k):
    """Two epochs of ten batches of ``field:id:val`` lines through
    ``Trainer.train()`` in both packages (the reference on its scatter
    path), from the reference's initial table: the same parameters,
    optimizer state and train logloss within the tile-vs-scatter
    bounds.  K = 4 ends each epoch on a tail of two."""
    common = _common(tmp_path, optimizer=optimizer, host_sort=host_sort,
                     steps_per_dispatch=k)
    jt = JaxTrainer(JaxFmConfig(model_file=str(tmp_path / "jax_model"),
                                sparse_apply="scatter", **common))
    trainer = _port_from(tmp_path, jt, common)
    jres = jt.train()
    tr = trainer.train()["train"]
    assert tr["steps"] == jres["train"]["steps"] == 20
    assert tr["dispatches"] == 2 * -(-10 // k)
    assert tr["examples"] == jres["train"]["examples"]
    _assert_trained_alike(trainer, jt, optimizer)
    np.testing.assert_allclose(tr["logloss"], jres["train"]["logloss"],
                               rtol=1e-4)


def test_ffm_trains_in_bf16_near_f32(tmp_path):
    """``compute_dtype = bfloat16`` with ``field_num``: 20 steps end
    within 1e-2 logloss of the same steps in f32 (the reference's
    ``tests/test_bf16.py::TestTrainingParity`` check), and the saved
    parameters are f32."""
    common = _common(tmp_path, epoch_num=2)
    last = {}
    for dtype in ("float32", "bfloat16"):
        cfg = FmConfig(model_file=str(tmp_path / dtype), compute_dtype=dtype,
                       **common)
        tr = Trainer(cfg, device="cpu").train()["train"]
        assert tr["steps"] == 20
        last[dtype] = tr["logloss"]
        with np.load(checkpoint.params_path(cfg.model_file)) as z:
            assert z["params/table"].dtype == np.float32
    assert abs(last["bfloat16"] - last["float32"]) < 1e-2


def test_ffm_validation_and_predict_match_the_reference(tmp_path):
    """From the reference's initial table both packages train two epochs
    (host sort meta), then validate and predict ``field:id:val`` lines:
    the validation metrics agree, the counts exactly, and the score files
    to their printed six decimals (one unit of the last digit)."""
    valid = _ffm_lines(tmp_path / "valid.libsvm", 450, 6)
    common = _common(tmp_path, validation_files=[valid],
                     predict_files=[valid], host_sort=True,
                     optimizer="adagrad")
    jcfg = JaxFmConfig(model_file=str(tmp_path / "jax_model"),
                       score_path=str(tmp_path / "jax_scores.txt"),
                       sparse_apply="scatter", **common)
    jt = JaxTrainer(jcfg)
    trainer = _port_from(tmp_path, jt, dict(
        common, score_path=str(tmp_path / "port_scores.txt")))
    jres = jt.train()
    pres = trainer.train()
    got, want = pres["validation"], jres["validation"]
    assert got["examples"] == want["examples"] == 450
    assert got["weight_sum"] == want["weight_sum"]
    np.testing.assert_allclose(got["logloss"], want["logloss"], rtol=1e-5)
    np.testing.assert_allclose(got["auc"], want["auc"], atol=1e-4)
    assert got["logloss"] < 0.693
    assert jax_predict(jcfg) == 450
    assert predict(trainer.cfg, device="cpu") == 450
    np.testing.assert_allclose(np.loadtxt(trainer.cfg.score_path),
                               np.loadtxt(jcfg.score_path), rtol=0,
                               atol=1.01e-6)


@pytest.mark.parametrize("mode", ["prestacked", "procs"])
def test_ffm_cache_and_process_pool_ship_the_fields(tmp_path, mode):
    """Three epochs at K = 2.  ``prestacked``: the epoch cache's packed
    groups (fields included) train what the reference's prestacked cache
    trains, from its initial table (the cache replays another order than
    streaming, so the reference is the yardstick).  ``procs``: two
    parse processes train, bitwise, what the parse threads train."""
    common = _common(tmp_path, epoch_num=3, steps_per_dispatch=2,
                     thread_num=2)
    if mode == "prestacked":
        common.update(cache_epochs=True, cache_prestacked=True)
        jt = JaxTrainer(JaxFmConfig(model_file=str(tmp_path / "jax_model"),
                                    sparse_apply="scatter", **common))
        trainer = _port_from(tmp_path, jt, common)
        jres = jt.train()
        tr = trainer.train()["train"]
        assert tr["ingest_cache"] == jres["train"]["ingest_cache"] == "cached"
        assert tr["steps"] == 30
        _assert_trained_alike(trainer, jt, "adagrad")
        return
    runs = []
    for procs in (0, 2):
        cfg = FmConfig(model_file=str(tmp_path / f"m{procs}"),
                       parse_processes=procs, **common)
        trainer = Trainer(cfg, device="cpu")
        runs.append((trainer, trainer.train()["train"]))
    (threads, t_tr), (pooled, p_tr) = runs
    assert t_tr["steps"] == p_tr["steps"] == 30
    assert t_tr["logloss"] == p_tr["logloss"]
    for a, b in zip([threads.model.table, threads.model.w0,
                     threads.opt_state.acc_table],
                    [pooled.model.table, pooled.model.w0,
                     pooled.opt_state.acc_table]):
        assert torch.equal(a, b)


# -- serving ---------------------------------------------------------------


SERVE = dict(vocabulary_size=211, factor_num=K, field_num=P, max_features=6,
             serve_batch_sizes="8,32", max_batch_wait_ms=1.0,
             serve_poll_secs=0.0)


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read()


def test_ffm_serves_both_transports_as_the_reference_scorer(tmp_path):
    """A carried FFM table served over ``/score`` (``field:id:val``
    text) and ``/score_bin`` (frames with fields) at every rung and past
    the largest: the transports agree bitwise, the scores match the
    reference's ``FixedShapeScorer`` on the same arrays, and a frame
    without fields scores as field 0 everywhere, as the reference's."""
    rng = np.random.default_rng(8)
    w0 = np.float32(-0.1)
    table = rng.uniform(-0.4, 0.4, (SERVE["vocabulary_size"], D)).astype(
        np.float32)
    model_file = str(tmp_path / "model")
    checkpoint.save_params(model_file,
                           weights.from_jax(w0, table, device="cpu"), step=2)
    cfg = FmConfig(model_file=model_file, **SERVE)
    jscorer = JaxScorer(
        JaxFmConfig(**SERVE),
        jax_fm.FmParams(w0=jnp.asarray(w0), table=jnp.asarray(table)))
    handle = serve(cfg, device="cpu", port=0)
    try:
        for n in (1, 5, 8, 20, 45):
            lines = []
            for _ in range(n):
                m = int(rng.integers(1, 9))  # up to 8 over max_features
                toks = [f"{rng.integers(0, 2 * P)}:{rng.integers(0, 400)}:"
                        f"{rng.uniform(0.1, 1.5):.3f}" for _ in range(m)]
                lines.append(f"{rng.integers(0, 2)} " + " ".join(toks))
            body = "\n".join(lines) + "\n"
            text = _post(handle.port, "/score", body.encode()).decode()
            ids, vals, fields, got_n, _ = textparse.parse_request(body, cfg)
            assert got_n == n and fields.max() < P
            frame = wire.encode_bin_request(ids, vals, fields)
            bin_scores = wire.decode_bin_response(
                _post(handle.port, "/score_bin", frame))
            assert text == "".join(f"{s:.6f}\n" for s in bin_scores)
            want = jscorer.score(ids, vals, fields)
            np.testing.assert_allclose(bin_scores, want, **SERVE_TOL)
        no_fields = wire.decode_bin_response(_post(
            handle.port, "/score_bin", wire.encode_bin_request(ids, vals)))
        np.testing.assert_allclose(no_fields, jscorer.score(ids, vals),
                                   **SERVE_TOL)
        assert not np.array_equal(no_fields, bin_scores)
        # The offline scorer behind predict: the same scores.
        np.testing.assert_array_equal(
            handle.scorer.score(ids, vals, fields), bin_scores)
    finally:
        handle.close()


def test_ffm_cli_trains_predicts_and_serves_the_sample_config(tmp_path,
                                                              capsys):
    """``examples/ffm_sample.cfg`` (its own widths and optimizer; the
    data of ``gen_sample_data.py --ffm``, cut to 2000 lines and two
    epochs) through the CLI on the CPU: train validates below 0.693,
    predict writes one probability a line, and the served checkpoint
    scores those lines as predict did."""
    from fast_tffm_tpu_torch import cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.pipeline import BatchPipeline
    from fast_tffm_tpu_torch.serve.scorer import make_scorer

    rng = np.random.default_rng(42)
    gen = _gen_module()
    w = rng.normal(0, 0.5, size=1000)
    v = rng.normal(0, 0.3, size=(1000, 4))
    for name, n in (("train_ffm", 2000), ("valid_ffm", 400)):
        gen.gen(str(tmp_path / f"{name}.libsvm"), n, rng, 1000, 13, w, v,
                ffm=True, n_fields=8)
    text = open(os.path.join(REPO, "examples", "ffm_sample.cfg")).read()
    text = (text.replace("examples/data", str(tmp_path))
            .replace("/tmp/fast_tffm_tpu_ffm_model", str(tmp_path / "model"))
            .replace("/tmp/fast_tffm_tpu_ffm_scores.txt",
                     str(tmp_path / "scores.txt"))
            .replace("epoch_num = 10", "epoch_num = 2"))
    cfg_path = tmp_path / "ffm.cfg"
    cfg_path.write_text(text)
    cfg = load_config(str(cfg_path))
    assert (cfg.field_num, cfg.factor_num, cfg.embedding_dim) == (8, 4, 33)
    assert cli.main(["train", str(cfg_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    val = [ln for ln in out.splitlines() if ln.startswith("validation")]
    assert val and float(val[0].split("logloss=")[1].split()[0]) < 0.693, out
    assert cli.main(["predict", str(cfg_path), "--device", "cpu"]) == 0
    got = np.loadtxt(tmp_path / "scores.txt")
    assert got.shape == (400,) and np.all((got > 0) & (got < 1))
    scorer = make_scorer(dataclasses.replace(cfg, serve_poll_secs=0.0),
                         device="cpu")
    with BatchPipeline(cfg.predict_files, cfg, shuffle=False) as p:
        served = np.concatenate([
            scorer.score(b.ids, b.vals, b.fields)[b.weights > 0] for b in p])
    np.testing.assert_allclose(served, got, atol=5e-7)
