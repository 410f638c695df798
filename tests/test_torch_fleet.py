"""The port's serving fleet on the CPU: ``start_fleet`` with 2 replica
processes of the port's serving stack (``--device cpu``) behind the
port's router, over a checkpoint the JAX package's ``Trainer`` wrote.

Scores through the router are bitwise the port's single-process server
on the same requests over both transports (the same scorer on the same
device), and within FmScorer's ``rtol=1e-5, atol=1e-6``
(tests/test_pallas_ops.py) of the JAX package's ``FixedShapeScorer``.
The canary promotes a re-save of the same table and rolls back a
scaled one; the replicas' captures replay bitwise through the port's
replay tool and the repo's; a SIGKILLed replica is retried around,
respawned and readmitted; the CLI's SIGTERM leaves no replica process.
The fleet is module-scoped to limit spawns.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.serve.scorer import make_scorer as jax_make_scorer
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.serve import router as router_lib
from fast_tffm_tpu_torch.serve import wire
from fast_tffm_tpu_torch.serve.router import start_fleet
from fast_tffm_tpu_torch.serve.server import serve
from fast_tffm_tpu_torch.serve.textparse import parse_request
from fast_tffm_tpu_torch.train import checkpoint

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, K, F = 199, 4, 8
# One request per rung of 8 / 32 and one past the largest.
SIZES = (1, 5, 20, 45)


def _write_lines(path, n, rng):
    w = rng.normal(0, 0.6, V)
    rows = []
    for _ in range(n):
        k = int(rng.integers(2, F + 1))
        ids = rng.choice(V, size=k, replace=False)
        vals = np.round(rng.uniform(0.2, 1.0, size=k), 3)
        label = int(rng.uniform() < 1 / (1 + np.exp(-w[ids] @ vals)))
        rows.append(f"{label} " + " ".join(
            f"{i}:{x}" for i, x in zip(ids, vals)) + "\n")
    with open(path, "w") as f:
        f.writelines(rows)
    return rows


def _cfg_text(model, train, **extra):
    lines = [
        "[General]", f"vocabulary_size = {V}", f"factor_num = {K}",
        f"model_file = {model}",
        "[Train]", f"train_files = {train}", "batch_size = 32",
        "epoch_num = 1", "learning_rate = 0.5",
        "[Predict]", "serve_batch_sizes = 8,32", "max_batch_wait_ms = 1",
        "[Tpu]", f"max_features = {F}",
    ]
    lines += [f"{k} = {v}" for k, v in extra.items()]
    return "\n".join(lines) + "\n"


def _post(port, path, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.read()


def _wait(cond, timeout=60.0) -> bool:
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            return False
        time.sleep(0.05)
    return True


def _alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # A zombie still answers kill(0); read its state.
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ", 1)[1][0] != "Z"
    except OSError:
        return False


def _requests(cfg, rows):
    """(text body, binary frame) per size of SIZES, from the data's
    lines."""
    out = []
    pos = 0
    for n in SIZES:
        body = "".join(rows[pos:pos + n])
        pos += n
        ids, vals, _, got_n, _ = parse_request(body, cfg)
        assert got_n == n
        out.append((body.encode(), wire.encode_bin_request(ids, vals),
                    ids, vals))
    return out


def _score_both(port, requests):
    """Per request: (text scores as float32, binary scores)."""
    out = []
    for body, frame, _, _ in requests:
        st, text = _post(port, "/score", body)
        sb, raw = _post(port, "/score_bin", frame)
        assert st == sb == 200
        out.append((np.array(text.split(), np.float32),
                    wire.decode_bin_response(raw)))
    return out


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    rng = np.random.default_rng(20261018)
    train = str(tmp / "train.libsvm")
    rows = _write_lines(train, 400, rng)
    model = str(tmp / "model")
    JaxTrainer(JaxFmConfig(
        vocabulary_size=V, factor_num=K, max_features=F, batch_size=32,
        epoch_num=1, learning_rate=0.5, train_files=[train],
        model_file=model)).train()
    cfg_path = str(tmp / "fleet.cfg")
    cap = str(tmp / "cap.tfc")
    with open(cfg_path, "w") as f:
        # No deadline admission (serve_shed_deadline_ms = 0): on a loaded
        # host the one replica left in a kill window completes too few
        # requests a second for the default 50 ms budget, and the router
        # sheds with 429 by design (tests/test_torch_router.py holds the
        # shedding against the reference's); these tests are the fleet's
        # routing, retry and respawn.
        f.write(_cfg_text(
            model, train, serve_replicas=2, serve_canary="true",
            serve_poll_secs=0.2, serve_capture_sample=1,
            serve_capture_file=cap, serve_shed_deadline_ms=0))
    cfg = load_config(cfg_path)
    requests = _requests(cfg, rows)
    # The single-process server and the reference scorer, before any
    # test touches the checkpoint.
    single_cfg = load_config(cfg_path, {
        "serve_replicas": 0, "serve_canary": False, "serve_poll_secs": 0,
        "serve_capture_sample": 0, "serve_capture_file": ""})
    single = serve(single_cfg, device="cpu", port=0)
    try:
        want = _score_both(single.port, requests)
    finally:
        single.close()
    ref = jax_make_scorer(JaxFmConfig(
        vocabulary_size=V, factor_num=K, max_features=F,
        serve_batch_sizes="8,32", model_file=model))
    ref_scores = [ref.score(ids, vals) for _, _, ids, vals in requests]
    handle = start_fleet(cfg, cfg_path, port=0, device="cpu")
    pids = [r.pid for r in handle.replicas]
    try:
        yield dict(handle=handle, cfg=cfg, cfg_path=cfg_path, model=model,
                   cap=cap, requests=requests, want=want,
                   ref_scores=ref_scores, rows=rows, tmp=tmp)
    finally:
        pids += [r.pid for r in handle.replicas]
        handle.close()
        assert not [p for p in pids if _alive(p)], "a replica outlived"


def test_fleet_scores_match_the_single_process_server_and_reference(fleet):
    handle = fleet["handle"]
    for _ in range(3):  # enough sequential requests to reach both
        got = _score_both(handle.port, fleet["requests"])
        for (text, binary), (w_text, w_bin), ref in zip(
                got, fleet["want"], fleet["ref_scores"]):
            # Both transports, bitwise each other and the one process
            # (the text answer is %.6f of the same float32).
            assert binary.tobytes() == w_bin.tobytes()
            assert text.tobytes() == w_text.tobytes()
            np.testing.assert_array_equal(
                text, np.array([f"{s:.6f}" for s in binary], np.float32))
            np.testing.assert_allclose(binary, ref, **TOL)
    status = json.loads(_get(handle.port, "/status"))["serve"]
    routed = [p["routed"] for p in status["per_replica"]]
    assert sum(routed) == 3 * 2 * len(SIZES) and min(routed) > 0
    assert status["replicas_healthy"] == 2
    # Each replica answered what the router sent it.
    for rep, n in zip(handle.replicas, routed):
        blk = json.loads(_get(rep.port, "/status"))["serve"]
        assert blk["requests"] >= n
        assert blk["kernel_launches"] == 0  # the CPU runs the plain path


def test_fleet_status_and_metrics_aggregate_the_replicas(fleet):
    handle = fleet["handle"]
    _score_both(handle.port, fleet["requests"][:2])
    assert _wait(lambda: json.loads(_get(handle.port, "/status"))[
        "serve"]["replicas_scraped"] == 2)
    doc = json.loads(_get(handle.port, "/status"))
    blk = doc["serve"]
    assert blk["fleet_requests"] == sum(
        p.get("requests", 0) for p in blk["per_replica"])
    assert doc["resource"]["rss_mb"] > 0
    text = _get(handle.port, "/metrics").decode()
    for rep in handle.replicas:
        assert f'tffm_serve_replica_routed_total{{replica="{rep.index}"}}' \
            in text
    assert "tffm_serve_fleet_requests" in text
    assert _get(handle.port, "/healthz") == b"ok\n"


def test_fleet_capture_replays_bitwise(fleet):
    handle = fleet["handle"]
    _score_both(handle.port, fleet["requests"])
    _score_both(handle.port, fleet["requests"])
    files = sorted(glob.glob(fleet["cap"] + ".replica*"))
    assert [os.path.basename(f) for f in files] == [
        "cap.tfc.replica0", "cap.tfc.replica1"]
    env = dict(os.environ, PYTHONPATH=REPO)
    endpoint = f"http://127.0.0.1:{handle.port}"
    for path in files:
        assert len(list(wire.read_capture(path))) > 0
        proc = subprocess.run(
            [sys.executable, "-m", "fast_tffm_tpu_torch.tools.replay",
             path, "--endpoint", endpoint],
            capture_output=True, env=env, timeout=120)
        assert proc.returncode == 0, proc.stdout.decode()
        assert b"bitwise-identical" in proc.stdout
    # The repo's own replay tool re-drives the port's capture against a
    # port server.
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "replay.py"),
         files[0], "--endpoint",
         f"http://127.0.0.1:{handle.replicas[1].port}"],
        capture_output=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout.decode()


def test_fleet_respawns_a_killed_replica(fleet):
    handle = fleet["handle"]
    rep = handle.replicas[0]
    old_pid, old_port = rep.pid, rep.port
    requests = fleet["requests"]
    results = []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            body, frame, _, _ = requests[1]
            results.append(_post(handle.port, "/score_bin", frame))

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    os.kill(old_pid, signal.SIGKILL)
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join()
    # Every request was answered, and answered right.
    bad = [(s, b[:200]) for s, b in results if s != 200]
    assert results and not bad, (
        f"{len(bad)} of {len(results)} kill-window requests were not "
        f"answered 200: {bad}")
    want = fleet["want"][1][1].tobytes()
    assert all(wire.decode_bin_response(b).tobytes() == want
               for _, b in results)
    assert _wait(lambda: rep.healthy and rep.pid != old_pid, 120)
    assert not _alive(old_pid)
    status = json.loads(_get(handle.port, "/status"))["serve"]
    assert status["respawns"] >= 1 and status["evictions"] >= 1
    assert status["readmissions"] >= 1
    # The respawned replica scores bitwise as before.
    assert rep.port != old_port or rep.pid != old_pid
    got = _score_both(rep.port, requests)
    for (_, binary), (_, w_bin) in zip(got, fleet["want"]):
        assert binary.tobytes() == w_bin.tobytes()


def test_fleet_canary_promotes_a_same_table_step_and_rolls_back(fleet):
    handle = fleet["handle"]
    router = handle.router
    model = fleet["model"]
    step, w0, table = checkpoint.restore_arrays(model)

    def save(tab, s):
        checkpoint.save_params(
            model, weights.from_jax(w0, tab, device="cpu"), step=s)

    def traffic():
        for body, frame, _, _ in fleet["requests"]:
            assert _post(handle.port, "/score", body)[0] == 200
            assert _post(handle.port, "/score_bin", frame)[0] == 200

    counters = lambda: router._tel.snapshot()["counters"]  # noqa: E731
    traffic()
    save(table, step + 1)  # the same table, a new step: promoted
    assert _wait(lambda: router.step == step + 1), "never promoted"
    assert counters()["serve.canary_promotions"] == 1
    for rep in handle.replicas:
        assert json.loads(_get(rep.port, "/status"))["step"] == step + 1
    traffic()
    save(table * 3.0, step + 2)  # drifted: rolled back
    assert _wait(lambda: counters().get("serve.canary_rollbacks", 0) == 1)
    out_dir = os.path.join(model, "canary_compare", f"step_{step + 2}")
    with open(os.path.join(out_dir, "baseline.json")) as f:
        base = json.load(f)
    with open(os.path.join(out_dir, "canary.json")) as f:
        canary = json.load(f)
    assert base["score_n"] == canary["score_n"] > 0
    assert base["score_std"] != canary["score_std"]
    assert router.step == step + 1
    for rep in handle.replicas:
        assert json.loads(_get(rep.port, "/status"))["step"] == step + 1
    # The whole fleet still serves the vetted table, bitwise.
    for _ in range(2):
        for (_, binary), (_, w_bin) in zip(
                _score_both(handle.port, fleet["requests"]), fleet["want"]):
            assert binary.tobytes() == w_bin.tobytes()
    # Leave the checkpoint as the fixture found its table.
    save(table, step + 3)
    assert _wait(lambda: router.step == step + 3)


def test_fleet_start_fails_with_the_replicas_exit_code(tmp_path):
    cfg_path = str(tmp_path / "f.cfg")
    with open(cfg_path, "w") as f:
        f.write(_cfg_text(str(tmp_path / "empty"), "", serve_replicas=2))
    cfg = load_config(cfg_path)
    with pytest.raises(RuntimeError, match=r"exit code [1-9]"):
        start_fleet(cfg, cfg_path, port=0, device="cpu")


def test_fleet_start_names_the_exit_code_of_a_replica_that_dies_at_once(
        tmp_path, monkeypatch):
    # A replica's stdout closes before the replica can be reaped (the
    # child here holds that gap open for 0.2 s): the manager must wait
    # for it to name its exit code, not report the None of a poll()
    # taken at that EOF.
    cfg_path = str(tmp_path / "f.cfg")
    with open(cfg_path, "w") as f:
        f.write(_cfg_text(str(tmp_path / "empty"), "", serve_replicas=2))
    cfg = load_config(cfg_path)
    monkeypatch.setattr(
        router_lib, "_replica_command",
        lambda *a, **k: [sys.executable, "-c", "import os, sys, time; "
                         "os.close(1); time.sleep(0.2); sys.exit(3)"])
    for _ in range(20):
        with pytest.raises(RuntimeError, match=r"\(exit code 3\)"):
            router_lib.ReplicaManager(cfg, cfg_path, device="cpu")


def test_cli_fleet_routes_and_sigterm_leaves_no_replica(tmp_path):
    rng = np.random.default_rng(7)
    model = str(tmp_path / "model")
    checkpoint.save_params(model, weights.from_jax(
        0.1, rng.uniform(-0.3, 0.3, (V, 1 + K)).astype(np.float32),
        device="cpu"), step=2)
    cfg_path = str(tmp_path / "cli.cfg")
    with open(cfg_path, "w") as f:
        f.write(_cfg_text(model, ""))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fast_tffm_tpu_torch.cli", "serve",
         cfg_path, "--replicas", "2", "--device", "cpu",
         "--serve_port", "0"],
        stdout=subprocess.PIPE, env=env)
    try:
        line = proc.stdout.readline().decode()
        assert line.startswith("routing on 127.0.0.1:"), line
        port = int(line.split(":")[1].split()[0])
        status, text = _post(port, "/score", b"1 3:1 7:0.5\n0 11:1\n")
        assert status == 200 and len(text.split()) == 2
        pids = [p["pid"] for p in json.loads(_get(port, "/status"))[
            "serve"]["per_replica"]]
        assert len(pids) == 2 and all(_alive(p) for p in pids)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
        assert not [p for p in pids if _alive(p)]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
