"""The port's serving slice vs the JAX package, on the CPU at small
sizes: config parsing, the request decoders, ``FixedShapeScorer`` and
``serve()`` over both transports.  Parameters are made with numpy from a
seed and handed to both packages.  Scores agree within ``rtol=1e-5,
atol=1e-6`` (tests/test_pallas_ops.py's tolerance; the sigmoid only
shrinks the error); the port's two transports agree bitwise."""

import dataclasses
import glob
import http.client
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax.numpy as jnp

from fast_tffm_tpu import config as jax_config
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.serve import textparse as jax_textparse
from fast_tffm_tpu.serve import wire as jax_wire
from fast_tffm_tpu.serve.scorer import FixedShapeScorer as JaxScorer
from fast_tffm_tpu.train import checkpoint as jax_checkpoint
from fast_tffm_tpu_torch import cli, config, weights
from fast_tffm_tpu_torch.ops import quant
from fast_tffm_tpu_torch.serve import scorer as scorer_lib
from fast_tffm_tpu_torch.serve import textparse, wire
from fast_tffm_tpu_torch.serve.scorer import FixedShapeScorer
from fast_tffm_tpu_torch.serve.server import serve
from fast_tffm_tpu_torch.train import checkpoint

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, F, K = 211, 5, 4
CFG = dict(vocabulary_size=V, factor_num=K, max_features=F,
           serve_batch_sizes="8,32", max_batch_wait_ms=1.0,
           serve_poll_secs=0.0)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    w0 = np.float32(-0.1)
    table = rng.uniform(-0.4, 0.4, (V, 1 + K)).astype(np.float32)
    return w0, table


def _examples(n, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (n, F)).astype(np.int32)
    vals = rng.uniform(0.1, 1.5, (n, F)).astype(np.float32)
    vals[::3, -1] = 0.0
    return ids, vals


def _jax_scores(w0, table, ids, vals):
    scorer = JaxScorer(
        jax_config.FmConfig(**CFG),
        jax_fm.FmParams(w0=jnp.asarray(w0), table=jnp.asarray(table)),
    )
    return scorer.score(ids, vals)


@pytest.fixture
def served(tmp_path):
    """The port's serving stack on port 0 over a params.npz checkpoint,
    plus the parameters it serves."""
    w0, table = _params()
    model_file = str(tmp_path / "model")
    checkpoint.save_params(
        model_file, weights.from_jax(w0, table, device="cpu"), step=3
    )
    cfg = config.FmConfig(model_file=model_file, **CFG)
    handle = serve(cfg, device="cpu", port=0)
    try:
        yield handle, cfg, w0, table
    finally:
        handle.close()


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST"
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read()


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "examples", "*.cfg")))
)
def test_every_example_config_parses_the_same(path):
    want = dataclasses.asdict(jax_config.load_config(path))
    got = dataclasses.asdict(config.load_config(path))
    assert got == want


def test_request_decoders_match_jax():
    text = "1 3:1 5:0.5 250:2\n0 7:1 -3:2 1:1 2:1 4:1 6:1\n\n# c\n9:0.5\n"
    cfg_t, cfg_j = config.FmConfig(**CFG), jax_config.FmConfig(**CFG)
    got = textparse.parse_request(text, cfg_t)
    want = jax_textparse.parse_request(text, cfg_j)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    ids, vals = _examples(4)
    frame = wire.encode_bin_request(ids + V, vals, request_id="r-1")
    assert frame == jax_wire.encode_bin_request(ids + V, vals,
                                                request_id="r-1")
    for g, w in zip(wire.decode_bin_request(frame, cfg_t),
                    jax_wire.decode_bin_request(frame, cfg_j)):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("n", [1, 8, 29, 75])
def test_scorer_matches_jax_scorer(n):
    """Any n, including more than the largest rung (32), which both
    scorers split into chunks."""
    w0, table = _params()
    ids, vals = _examples(n)
    scorer = FixedShapeScorer(
        config.FmConfig(**CFG), weights.from_jax(w0, table, device="cpu"),
        device="cpu",
    )
    assert scorer.warmup() == 2
    got = scorer.score(ids, vals)
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, _jax_scores(w0, table, ids, vals), **TOL)
    assert scorer.slots_for(n) == sum(
        scorer.rung_for(min(32, n - p)) for p in range(0, n, 32)
    )


def test_scorer_pads_without_changing_scores_and_swaps():
    w0, table = _params()
    ids, vals = _examples(40)
    cfg = config.FmConfig(**CFG)
    scorer = FixedShapeScorer(cfg, weights.from_jax(w0, table, device="cpu"),
                              device="cpu")
    full = scorer.score(ids, vals)
    np.testing.assert_array_equal(full[:1], scorer.score(ids[:1], vals[:1]))
    np.testing.assert_array_equal(full[8:30], scorer.score(ids[8:30],
                                                           vals[8:30]))
    w0b, table_b = _params(9)
    scorer.swap(weights.from_jax(w0b, table_b, device="cpu"), step=5)
    assert scorer.step == 5
    np.testing.assert_allclose(scorer.score(ids, vals),
                               _jax_scores(w0b, table_b, ids, vals), **TOL)
    with pytest.raises(ValueError, match="feature ids"):
        scorer.score(ids + V, vals)


def test_serve_transports_agree_and_match_jax(served):
    handle, cfg, w0, table = served
    ids, vals = _examples(45, seed=4)
    lines = "".join(
        "1 " + " ".join(f"{i}:{v!r}" for i, v in zip(row_i, row_v)
                        if v != 0) + "\n"
        for row_i, row_v in zip(ids.tolist(), vals.tolist())
    )
    text = _post(handle.port, "/score", lines.encode()).decode()
    parsed = textparse.parse_request(lines, cfg)
    frame = wire.encode_bin_request(parsed[0], parsed[1])
    got = wire.decode_bin_response(_post(handle.port, "/score_bin", frame))
    assert text == "".join(f"{s:.6f}\n" for s in got)
    want = _jax_scores(w0, table, parsed[0], parsed[1])
    np.testing.assert_allclose(got, want, **TOL)


def test_serve_reduces_out_of_range_ids_like_jax(served):
    handle, cfg, w0, table = served
    ids, vals = _examples(10, seed=5)
    wild = ids.astype(np.int64)
    wild[::2] += 7 * V
    wild[1::2] -= 3 * V
    got = wire.decode_bin_response(_post(
        handle.port, "/score_bin",
        wire.encode_bin_request(wild.astype(np.int32), vals),
    ))
    same = wire.decode_bin_response(_post(
        handle.port, "/score_bin", wire.encode_bin_request(ids, vals)
    ))
    np.testing.assert_array_equal(got, same)
    # The text path reduces the same way (libsvm: id % vocabulary_size).
    line = " ".join(f"{i}:1" for i in wild[0].tolist())
    text = _post(handle.port, "/score", line.encode()).decode()
    want = _jax_scores(w0, table, ids[:1], np.ones((1, F), np.float32))
    np.testing.assert_allclose(float(text), want[0], atol=1e-6)


def test_serve_observability_routes(served):
    handle, _, _, _ = served
    with urllib.request.urlopen(
        f"http://127.0.0.1:{handle.port}/healthz", timeout=30
    ) as resp:
        assert resp.read() == b"ok\n"
    _post(handle.port, "/score", b"1 3:1\n")
    with urllib.request.urlopen(
        f"http://127.0.0.1:{handle.port}/metrics", timeout=30
    ) as resp:
        text = resp.read().decode()
    assert "tffm_serve_requests 1" in text
    assert "tffm_serve_kernel_launches" in text
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(handle.port, "/score", b"1 x:y:z:w\n")
    assert e.value.code == 400


@pytest.mark.parametrize("overrides", [
    {"serve_replicas": 3},
    {"serve_replicas": 2, "serve_poll_secs": 0.5},
    {"serve_replicas": 2},
    {"serve_replicas": 4, "serve_poll_secs": 0.0},
    {"serve_replicas": 2, "serve_canary": True, "serve_poll_secs": 1.0},
    {"serve_capture_file": "cap.tfc", "serve_capture_sample": 0.5},
])
def test_serve_refuses_unported_settings(tmp_path, overrides):
    """The settings an earlier slice refused now act as the reference's
    do: ``serve()`` serves one process whatever ``serve_replicas`` and
    ``serve_canary`` say (the fleet is ``serve/router.py``'s,
    tests/test_torch_fleet.py), and a capture file records the sampled
    requests in a TFC1 file both packages read."""
    w0, table = _params()
    model_file = str(tmp_path / "model")
    checkpoint.save_params(model_file,
                           weights.from_jax(w0, table, device="cpu"))
    if "serve_capture_file" in overrides:
        overrides = dict(overrides, serve_capture_file=str(
            tmp_path / overrides["serve_capture_file"]))
    cfg = config.FmConfig(model_file=model_file,
                          **{**CFG, **overrides})
    handle = serve(cfg, device="cpu", port=0)
    answered = []
    try:
        assert (handle.watcher is None) == (cfg.serve_poll_secs == 0)
        for seed in range(20):
            ids, vals = _examples(1 + seed % 7, seed=seed)
            got = _bin_scores(handle.port, ids, vals)
            np.testing.assert_allclose(
                got, _jax_scores(w0, table, ids, vals), **TOL)
            answered.append((ids, vals, got))
    finally:
        handle.close()
    if not cfg.serve_capture_file:
        return
    records = list(wire.read_capture(cfg.serve_capture_file))
    assert records == list(jax_wire.read_capture(cfg.serve_capture_file))
    # Sample 0.5 over 20 requests: some, not necessarily all, captured;
    # each record is a request the server answered, with its answer.
    assert 0 < len(records) <= 20
    for _, req, resp in records:
        ids, vals, _, n, _, _ = wire.decode_bin_request(req, cfg)
        match = [got for a_ids, a_vals, got in answered
                 if a_ids.shape[0] == n and np.array_equal(a_ids, ids)
                 and np.array_equal(a_vals, vals)]
        assert match and resp == wire.encode_bin_response(match[0])


def test_serve_refuses_checkpoint_without_params_npz(tmp_path):
    # The reference's ValueError (fast_tffm_tpu/serve/scorer.py::
    # load_model) for a directory with no checkpoint of any format.
    cfg = config.FmConfig(model_file=str(tmp_path / "empty"), **CFG)
    with pytest.raises(ValueError, match="no servable checkpoint"):
        serve(cfg, device="cpu", port=0)


@pytest.mark.parametrize("mode", ["train", "predict"])
def test_cli_refuses_later_slices(tmp_path, mode):
    # Field-aware FM trains and predicts on one device through the CLI,
    # predict from the reference's Orbax directories too; the later
    # slice refuses a multi-rank predict.  A rank mesh trains FFM
    # (tests/test_torch_mesh_modes.py): one process cannot form its
    # 2 x 1 mesh.
    model_file = str(tmp_path / "model")
    rng = np.random.default_rng(3)
    table = rng.uniform(-0.1, 0.1, (V, 1 + 2 * K)).astype(np.float32)
    checkpoint.save_params(model_file,
                           weights.from_jax(0.0, table, device="cpu"))
    lines = [f"{i % 2} " + " ".join(
        f"{j % 2}:{rng.integers(0, V)}:{rng.uniform(0.1, 1):.3f}"
        for j in range(4)) + "\n" for i in range(40)]
    (tmp_path / "ffm.libsvm").write_text("".join(lines))
    general = (f"[General]\nvocabulary_size = {V}\nfactor_num = {K}\n"
               f"field_num = 2\nmodel_file = {model_file}\n")
    rest = (f"[Train]\ntrain_files = {tmp_path}/ffm.libsvm\n"
            f"batch_size = 16\n"
            f"[Predict]\npredict_files = {tmp_path}/ffm.libsvm\n"
            f"score_path = {tmp_path}/scores.txt\n")
    path = tmp_path / "ffm.cfg"
    path.write_text(general + rest)
    assert cli.main([mode, str(path), "--device", "cpu"]) == 0
    if mode == "predict":
        scores = np.loadtxt(tmp_path / "scores.txt")
        assert scores.shape == (40,) and np.all((scores > 0) & (scores < 1))
        # The same table as the reference's Orbax save: the same scores.
        os.remove(checkpoint.params_path(model_file))
        jax_checkpoint.save(model_file, 5, jax_fm.FmParams(
            w0=jnp.float32(0.0), table=jnp.asarray(table)))
        os.rename(tmp_path / "scores.txt", tmp_path / "npz_scores.txt")
        assert cli.main([mode, str(path), "--device", "cpu"]) == 0
        assert (tmp_path / "scores.txt").read_bytes() == (
            tmp_path / "npz_scores.txt").read_bytes()
        flags, match = ["--coordinator", "localhost:1", "--num_processes",
                        "2", "--process_id", "0"], "single-process"
    else:
        with np.load(checkpoint.params_path(model_file)) as z:
            assert int(z["scalar/step"]) == 3
        path.write_text(general + rest + "[Tpu]\nmesh_data = 2\n")
        with pytest.raises(ValueError, match="needs 2 ranks"):
            cli.main([mode, str(path), "--device", "cpu"])
        return
    with pytest.raises(NotImplementedError, match=match):
        cli.main([mode, str(path), "--device", "cpu"] + flags)


# ----------------------------------------------------------------------
# the checkpoint watcher, the keep_prev swap and the admin routes
# ----------------------------------------------------------------------


def _wait_for(cond, timeout=30.0) -> bool:
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _bin_scores(port, ids, vals):
    return wire.decode_bin_response(
        _post(port, "/score_bin", wire.encode_bin_request(ids, vals)))


def _admin(port, path):
    """``(status, body)`` of an admin POST with an empty body."""
    try:
        return 200, json.loads(_post(port, path, b""))
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _save(model_file, seed, step):
    w0, table = _params(seed)
    checkpoint.save_params(
        model_file, weights.from_jax(w0, table, device="cpu"), step=step)
    return w0, table


def _port_scores(w0, table, ids, vals):
    """What the server scores from this table: the same scorer on the
    CPU (bitwise)."""
    return FixedShapeScorer(config.FmConfig(**CFG),
                            weights.from_jax(w0, table, device="cpu"),
                            device="cpu").score(ids, vals)


@pytest.fixture
def watched(tmp_path):
    """The serving stack with its watcher polling every 50 ms over a
    params.npz at step 3."""
    model_file = str(tmp_path / "model")
    w0, table = _save(model_file, 0, 3)
    cfg = config.FmConfig(model_file=model_file,
                          **{**CFG, "serve_poll_secs": 0.05})
    handle = serve(cfg, device="cpu", port=0)
    try:
        yield handle, cfg, w0, table
    finally:
        handle.close()


def test_watcher_swaps_when_a_port_save_publishes_and_close_joins(watched):
    handle, cfg, w0, table = watched
    ids, vals = _examples(20)
    old = _bin_scores(handle.port, ids, vals)
    np.testing.assert_array_equal(old, _port_scores(w0, table, ids, vals))
    w0b, table_b = _save(cfg.model_file, 9, 8)
    assert _wait_for(lambda: handle.scorer.step == 8)
    new = _bin_scores(handle.port, ids, vals)
    np.testing.assert_array_equal(new, _port_scores(w0b, table_b, ids, vals))
    np.testing.assert_allclose(new, _jax_scores(w0b, table_b, ids, vals),
                               **TOL)
    assert handle.watcher.reloads == 1
    handle.close()
    assert not handle.watcher._thread.is_alive()


def test_watcher_swaps_when_a_reference_trainer_saves(tmp_path):
    """The served directory holds the reference's Orbax checkpoint; the
    reference's ``Trainer`` warm-starts from it, trains and saves there,
    and the port's watcher swaps in what it saved."""
    from fast_tffm_tpu.train.loop import Trainer as JaxTrainer

    w0, table = _params()
    model_file = str(tmp_path / "model")
    jax_checkpoint.save(model_file, 0, jax_fm.FmParams(
        w0=jnp.asarray(w0), table=jnp.asarray(table)))
    cfg = config.FmConfig(model_file=model_file,
                          **{**CFG, "serve_poll_secs": 0.05})
    rng = np.random.default_rng(5)
    lines = [f"{i % 2} " + " ".join(
        f"{rng.integers(0, V)}:{rng.uniform(0.1, 1):.3f}" for _ in range(4))
        + "\n" for i in range(64)]
    (tmp_path / "train.libsvm").write_text("".join(lines))
    handle = serve(cfg, device="cpu", port=0)
    try:
        assert handle.scorer.step == 0
        jt = JaxTrainer(jax_config.FmConfig(
            **CFG, model_file=model_file, batch_size=32, log_steps=0,
            train_files=[str(tmp_path / "train.libsvm")]))
        jt.train()
        assert _wait_for(lambda: handle.scorer.step == 2)
        ids, vals = _examples(20)
        params = jt.state.params
        np.testing.assert_allclose(
            _bin_scores(handle.port, ids, vals),
            _jax_scores(np.asarray(params.w0), np.asarray(params.table),
                        ids, vals), **TOL)
    finally:
        handle.close()


def test_concurrent_requests_see_the_old_or_the_new_table(watched):
    """Four keep-alive clients post while a save lands: every response is
    the old table's scores or the new one's, bitwise, never a mix."""
    handle, cfg, w0, table = watched
    ids, vals = _examples(12)  # two requests fit one dispatch
    frame = wire.encode_bin_request(ids, vals)
    old = _port_scores(w0, table, ids, vals)
    seen, stop = [], threading.Event()

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                          timeout=30)
        while not stop.is_set():
            conn.request("POST", "/score_bin", body=frame,
                         headers={"Content-Length": str(len(frame))})
            seen.append(wire.decode_bin_response(conn.getresponse().read()))
        conn.close()

    threads = [threading.Thread(target=client) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        w0b, table_b = _save(cfg.model_file, 9, 8)
        assert _wait_for(lambda: handle.scorer.step == 8)
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    new = _port_scores(w0b, table_b, ids, vals)
    kinds = [0 if np.array_equal(s, old) else 1 if np.array_equal(s, new)
             else -1 for s in seen]
    assert -1 not in kinds
    assert kinds[0] == 0 and kinds[-1] == 1


def test_admin_reload_rollback_and_promote(tmp_path):
    """``/reload?keep_prev=1`` then ``/rollback`` serves the old table's
    scores bitwise; ``/promote`` closes the window (a ``/rollback`` after
    it, or with none open, is a 409); an open window stays anchored to
    the table before it across repeated keep_prev reloads; a plain
    reload keeps nothing; an unservable checkpoint is a 409."""
    model_file = str(tmp_path / "model")
    w0, table = _save(model_file, 0, 3)
    cfg = config.FmConfig(model_file=model_file, **CFG)  # no watcher
    handle = serve(cfg, device="cpu", port=0)
    try:
        port = handle.port
        assert handle.watcher is None
        ids, vals = _examples(20)
        old = _bin_scores(port, ids, vals)
        assert _admin(port, "/rollback")[0] == 409
        w0b, table_b = _save(model_file, 9, 8)
        new = _port_scores(w0b, table_b, ids, vals)
        assert _admin(port, "/reload?keep_prev=1") == (200, {"step": 8})
        np.testing.assert_array_equal(_bin_scores(port, ids, vals), new)
        assert _admin(port, "/rollback") == (200, {"step": 3})
        np.testing.assert_array_equal(_bin_scores(port, ids, vals), old)
        assert _admin(port, "/rollback")[0] == 409
        assert _admin(port, "/reload?keep_prev=1") == (200, {"step": 8})
        assert _admin(port, "/promote") == (200, {"step": 8})
        assert _admin(port, "/rollback")[0] == 409
        np.testing.assert_array_equal(_bin_scores(port, ids, vals), new)
        # Anchoring: two keep_prev reloads, one rollback to step 8.
        _save(model_file, 10, 9)
        assert _admin(port, "/reload?keep_prev=1") == (200, {"step": 9})
        _save(model_file, 11, 10)
        assert _admin(port, "/reload?keep_prev=1") == (200, {"step": 10})
        assert _admin(port, "/rollback") == (200, {"step": 8})
        np.testing.assert_array_equal(_bin_scores(port, ids, vals), new)
        # A plain reload keeps nothing to roll back to.
        assert _admin(port, "/reload") == (200, {"step": 10})
        assert _admin(port, "/rollback")[0] == 409
        # A bf16 quant.npz cannot serve at serve_table_dtype = fp32.
        checkpoint.save_quant(model_file, 12, w0,
                              quant.quantize_table(table, "bf16", 64))
        status, body = _admin(port, "/reload")
        assert status == 409 and "serve_table_dtype" in body
        assert handle.scorer.step == 10
    finally:
        handle.close()


def test_watcher_baselines_an_unservable_checkpoint_and_retries_errors(
        watched, monkeypatch):
    """A checkpoint the config cannot serve (ValueError) is loaded once
    and becomes the baseline, not reloaded at every poll; the next save
    swaps.  Any other error is retried at the next poll."""
    handle, cfg, w0, table = watched
    calls = []
    orig = scorer_lib.load_model

    def counting(c):
        calls.append(time.monotonic())
        if len(calls) == 2:
            raise OSError("a transient read error")
        return orig(c)

    monkeypatch.setattr(scorer_lib, "load_model", counting)
    checkpoint.save_quant(cfg.model_file, 9, w0,
                          quant.quantize_table(table, "bf16", 64))
    assert _wait_for(lambda: len(calls) == 1)
    time.sleep(0.5)  # ten polls
    assert len(calls) == 1 and handle.scorer.step == 3
    assert handle.watcher.reloads == 0
    _save(cfg.model_file, 9, 10)
    assert _wait_for(lambda: handle.scorer.step == 10)
    assert len(calls) == 3  # the OSError, then its retry
    assert handle.watcher.reloads == 1
