"""The port's metrics stream, heartbeat, status endpoint and alerts vs
the JAX package on the CPU.

The reference's tests of these planes (``tests/test_telemetry.py``,
``tests/test_status_endpoint.py``, ``tests/test_alerts.py``,
``tests/test_tracing.py``'s crash case) run on the port's trainer: the
stream's schema and its exact wall-clock accounting, the run header's
config fingerprint against the reference's ``_config_fingerprint``, both
report tools (the repo's ``tools/report.py`` and the port's) summarizing
the port's stream with the same alert section, ``/status`` and
``/metrics`` mid-run, a taken port, the endpoint on being bitwise the
endpoint off, the warn and halt rules, and a crashed run's single final
record.  The port's copies of the alert grammar and engine are held to
the reference's on the same rule sets and synthetic heartbeat streams,
the server's and the router's streams are read back, and every
instrument the port registers is in ``OBSERVABILITY.md``'s schema table.
Sizes are the reference tests': V = 50, factor_num = 4, B = 32.
"""

import http.client
import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from fast_tffm_tpu import obs as jax_obs
from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.train import loop as jax_loop
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs import alerts, heartbeat
from fast_tffm_tpu_torch.obs.status import QuietHandler, StatusServer
from fast_tffm_tpu_torch.obs.telemetry import Telemetry
from fast_tffm_tpu_torch.serve import router
from fast_tffm_tpu_torch.tools import report as port_report
from fast_tffm_tpu_torch.train import checkpoint
from fast_tffm_tpu_torch.train.loop import Trainer, config_fingerprint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(REPO, "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import check_obs  # noqa: E402
import report as repo_report  # noqa: E402
from obs_smoke import check_prometheus  # noqa: E402


def _write_libsvm(path, n_lines, vocab=50, n_feat=3, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_lines):
            feats = rng.choice(vocab, size=n_feat, replace=False)
            toks = " ".join(f"{i}:{rng.uniform(0.1, 1):.3f}" for i in feats)
            f.write(f"{rng.integers(0, 2)} {toks}\n")
    return str(path)


def _cfg(data, tmp_path, tag, **kw):
    defaults = dict(
        vocabulary_size=50, factor_num=4,
        model_file=str(tmp_path / f"model_{tag}"), train_files=[data],
        epoch_num=1, batch_size=32, max_features=4, log_steps=0,
        thread_num=2, steps_per_dispatch=4, seed=3,
    )
    defaults.update(kw)
    return FmConfig(**defaults)


@pytest.fixture(scope="module")
def train_file(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs_data")
    return _write_libsvm(out / "train.libsvm", 640)


@pytest.fixture(scope="module")
def small_file(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs_small")
    return _write_libsvm(out / "train.libsvm", 320)


def _throttle(trainer, delay_s: float):
    """Slow each dispatch so heartbeats (and the rules riding them) get
    their chances to fire mid-run."""
    real = trainer.dispatch

    def slow(sb, pause=None):
        time.sleep(delay_s)
        return real(sb, pause)

    trainer.dispatch = slow


def _records(path):
    return [json.loads(line) for line in open(path)]


def _get(port: int, route: str, timeout: float = 5.0) -> tuple:
    try:
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{port}{route}", timeout=timeout)
        return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _state(t):
    return ([t.model.table, t.model.w0, *[x for x in t.opt_state]]
            + [t.metrics.loss_sum, t.metrics.weight_sum, t.metrics.count,
               t.metrics.auc.pos, t.metrics.auc.neg])


# ---------------------------------------------------------------------------
# The metrics stream (tests/test_telemetry.py::TestTrainerTelemetry)
# ---------------------------------------------------------------------------


def test_metrics_stream_schema_and_final_accounting(small_file, tmp_path,
                                                    capsys):
    mf = str(tmp_path / "metrics.jsonl")
    kw = dict(validation_files=[small_file], validation_steps=8,
              metrics_file=mf, heartbeat_secs=0.05, epoch_num=2,
              log_steps=4, steps_per_dispatch=2,
              alert_rules="step > 0 : warn")
    cfg = _cfg(small_file, tmp_path, "hb", **kw)
    t = Trainer(cfg, device="cpu")
    _throttle(t, 0.05)
    result = t.train()
    records = _records(mf)
    kinds = [r.get("record") for r in records]
    assert all(k is not None for k in kinds), "untyped record emitted"
    assert kinds[0] == "run_header"
    header = records[0]
    for key in ("config_fingerprint", "steps_per_dispatch", "ingest_mode",
                "torch_version", "backend", "mesh", "batch_size",
                "resume_step", "nan_policy", "alert_rules"):
        assert key in header, key
    assert header["ingest_mode"] == "threads"
    assert header["backend"] == "cpu" and header["device"] == "cpu"
    assert header["torch_version"] == torch.__version__
    # The same config hashes alike in both packages.
    jcfg = JaxFmConfig(**{
        k: getattr(cfg, k) for k in JaxFmConfig.__dataclass_fields__})
    assert header["config_fingerprint"] == jax_loop._config_fingerprint(jcfg)
    assert header["config_fingerprint"] == config_fingerprint(cfg)
    trains = [r for r in records if r["record"] == "train"]
    valids = [r for r in records if r["record"] == "validation"]
    assert trains and valids
    for r in trains + valids:
        for key in ("step", "examples", "loss", "auc", "elapsed"):
            assert key in r, key
    beats = [r for r in records if r["record"] == "heartbeat"]
    assert beats
    for key in ("step", "elapsed", "ingest_wait_frac", "wait_input_s",
                "dispatch_s", "other_s", "stages", "truncated_features",
                "out_of_range_batches", "ingest_cache", "health", "alerts"):
        assert key in beats[-1], key
    # The heartbeat's health is the host cache of the delayed readback.
    assert {"grad_norm", "grad_norm_rms", "nonfinite_steps"} <= set(
        beats[-1]["health"])
    alerts_ = [r for r in records if r["record"] == "alert"]
    assert len(alerts_) == 1 and alerts_[0]["rule"] == "step>0"
    finals = [r for r in records if r["record"] == "final"]
    assert len(finals) == 1 and kinds[-1] == "final"
    final = finals[0]
    total = final["wait_input_s"] + final["dispatch_s"] + final["other_s"]
    assert total == pytest.approx(final["elapsed"], abs=0.02)
    assert 0.0 <= final["ingest_wait_frac"] <= 1.0
    timers = final["stages"]["timers"]
    for stage in ("ingest.parse", "prefetch.stack", "prefetch.device_put",
                  "train.wait_input", "train.dispatch"):
        assert stage in timers, stage
        assert timers[stage]["count"] > 0
    counters = final["stages"]["counters"]
    assert counters["ingest.batches"] == 20  # 10 batches x 2 epochs
    assert counters["ingest.examples"] == 640
    assert counters["prefetch.super_batches"] == 10
    depths = final["stages"]["depths"]
    for q in ("ingest.work_q_depth", "ingest.out_q_depth",
              "prefetch.out_q_depth"):
        assert depths[q]["count"] > 0, q
        assert "buckets" in depths[q], q
    health = final["health"]
    assert health["emb_touch_events"] == 1920.0
    assert health["nonfinite_steps"] == 0
    tm = result["train"]
    for key in ("truncated_features", "out_of_range_batches",
                "ingest_cache", "ingest_wait_frac", "wait_input_s",
                "dispatch_s", "health"):
        assert key in tm, key
    assert tm["health"] == health
    # Both report tools summarize the port's stream, naming the alert.
    capsys.readouterr()
    assert repo_report.main([mf]) == 0
    repo_out = capsys.readouterr().out
    assert port_report.main([mf]) == 0
    port_out = capsys.readouterr().out
    for out in (repo_out, port_out):
        assert "alerts (1 fired)" in out and "step>0" in out
        assert "training health" in out
    assert "torch_version" in port_out
    # The per-rank merge over the stream and a copy of it as rank 1.
    other = str(tmp_path / "metrics.jsonl.rank1")
    with open(other, "w") as f:
        for r in records:
            if r["record"] == "run_header":
                r = dict(r, rank=1)
            f.write(json.dumps(r) + "\n")
    assert port_report.main([mf, other]) == 0
    assert "merged 2 rank streams: 0, 1" in capsys.readouterr().out
    assert heartbeat.rank_suffix_path(mf, 1) == other
    assert heartbeat.rank_suffix_path(mf, 0) == mf


def test_no_telemetry_still_beats_and_trains_bitwise(train_file, tmp_path):
    """``telemetry = false``: no-op instruments (empty ``stages``) but
    live heartbeats, and the same parameters."""
    states = {}
    for tag, tel in (("on", True), ("off", False)):
        mf = str(tmp_path / f"{tag}.jsonl")
        t = Trainer(_cfg(train_file, tmp_path, tag, telemetry=tel,
                         metrics_file=mf, heartbeat_secs=0.05),
                    device="cpu")
        _throttle(t, 0.05)
        t.train()
        states[tag] = _state(t)
        beats = [r for r in _records(mf) if r["record"] == "heartbeat"]
        assert beats
        if not tel:
            assert beats[-1]["stages"] == {}
    assert all(torch.equal(a, b) for a, b in zip(states["on"],
                                                 states["off"]))


def test_crashed_run_writes_one_final_record(train_file, tmp_path, capsys):
    """tests/test_tracing.py::TestCrashTruthfulFinal on the port."""
    mf = str(tmp_path / "crash.jsonl")
    t = Trainer(_cfg(train_file, tmp_path, "crash", metrics_file=mf,
                     steps_per_dispatch=2), device="cpu")
    real = t.dispatch
    count = {"n": 0}

    def dying(sb, pause=None):
        if count["n"] >= 2:
            raise KeyboardInterrupt("simulated preemption")
        count["n"] += 1
        return real(sb, pause)

    t.dispatch = dying
    with pytest.raises(KeyboardInterrupt):
        t.train()
    finals = [r for r in _records(mf) if r.get("record") == "final"]
    assert len(finals) == 1
    final = finals[0]
    assert final["exception"] == "KeyboardInterrupt"
    assert final["step"] == 4  # partial counters survived
    assert "stages" in final and "health" in final
    assert final["health"]["emb_touch_events"] == 4 * 32 * 3
    assert not checkpoint.exists(t.cfg.model_file)
    capsys.readouterr()
    for tool in (repo_report, port_report):
        assert tool.main([mf]) == 0
        assert "KeyboardInterrupt" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The status endpoint (tests/test_status_endpoint.py)
# ---------------------------------------------------------------------------


def test_status_endpoint_serves_metrics_and_status_mid_run(train_file,
                                                           tmp_path):
    port = _free_port()
    t = Trainer(_cfg(train_file, tmp_path, "live", status_port=port),
                device="cpu")
    _throttle(t, 0.05)
    got: dict = {}

    def poll():
        deadline = time.time() + 60
        while time.time() < deadline and "metrics" not in got:
            try:
                code, sbody = _get(port, "/status", timeout=1)
                if code != 200:
                    continue
                code, mbody = _get(port, "/metrics", timeout=1)
                if code != 200:
                    continue
                got["status"], got["metrics"] = sbody, mbody
                got["healthz"] = _get(port, "/healthz", timeout=1)
                got["threadz"] = _get(port, "/debug/threadz", timeout=1)
                got["profile"] = _get(port, "/profile", timeout=1)
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=1)
                conn.request("POST", "/incident", body=b"")
                got["incident"] = conn.getresponse().status
                conn.close()
            except Exception:
                time.sleep(0.02)

    poller = threading.Thread(target=poll)
    poller.start()
    t.train()
    poller.join()
    assert "metrics" in got, "endpoint never answered mid-run"
    rec = json.loads(got["status"])
    assert rec["record"] == "status"
    for key in ("step", "elapsed", "health", "stages", "truncated_features",
                "build_info"):
        assert key in rec, key
    if rec["step"] == 0:
        assert rec.get("warming_up") is True
        assert "ingest_wait_frac" not in rec
    else:
        assert "ingest_wait_frac" in rec
    text = got["metrics"].decode()
    assert check_prometheus(text) > 0
    assert "tffm_counter_ingest_examples_total" in text
    assert got["healthz"][0] == 200
    assert got["threadz"][0] == 200 and b"tffm-status" in got["threadz"][1]
    # The profiler and the flight recorder are not in the port.
    assert got["profile"][0] == 404 and got["incident"] == 404
    with pytest.raises((urllib.error.URLError, OSError)):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=1)


def test_status_before_the_first_dispatch_is_warming_up(train_file,
                                                        tmp_path):
    """``/status`` answers before any dispatch, without the wall-clock
    split (start-up is not starvation)."""
    port = _free_port()
    t = Trainer(_cfg(train_file, tmp_path, "warm", status_port=port),
                device="cpu")
    real = t.dispatch
    seen = {}

    def first(sb, pause=None):
        if not seen:
            seen["rec"] = json.loads(_get(port, "/status")[1])
        return real(sb, pause)

    t.dispatch = first
    t.train()
    rec = seen["rec"]
    assert rec["step"] == 0 and rec["warming_up"] is True
    for key in ("wait_input_s", "dispatch_s", "other_s", "ingest_wait_frac"):
        assert key not in rec


def test_taken_status_port_warns_and_trains_anyway(train_file, tmp_path,
                                                   caplog):
    blocker = socket.socket()
    blocker.bind(("0.0.0.0", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    try:
        with caplog.at_level("WARNING",
                             logger="fast_tffm_tpu_torch.train.loop"):
            result = Trainer(_cfg(train_file, tmp_path, "taken",
                                  status_port=port), device="cpu").train()
        assert result["train"]["steps"] == 20
        assert any("status endpoint failed to bind" in r.message
                   for r in caplog.records)
    finally:
        blocker.close()


def test_endpoint_off_is_bit_identical_to_on(train_file, tmp_path):
    states = {}
    for tag, port in (("on", _free_port()), ("off", 0)):
        t = Trainer(_cfg(train_file, tmp_path, f"bit_{tag}",
                         status_port=port), device="cpu")
        stop = threading.Event()
        scraper = None
        if port:
            def scrape():
                while not stop.wait(0.01):
                    try:
                        _get(port, "/metrics", timeout=1)
                    except Exception:
                        pass

            scraper = threading.Thread(target=scrape, daemon=True)
            scraper.start()
        t.train()
        if scraper is not None:
            stop.set()
            scraper.join()
        states[tag] = _state(t) + list(t.health)
    assert all(torch.equal(a, b) for a, b in zip(states["on"],
                                                 states["off"]))


def test_status_server_alone_serves_the_routes():
    tel = Telemetry()
    tel.counter("ingest.batches").add(3)
    server = StatusServer(0, lambda: {"record": "status", "step": 7,
                                      "stages": tel.snapshot()},
                          telemetry=tel)
    try:
        code, body = _get(server.port, "/status")
        assert code == 200 and json.loads(body)["step"] == 7
        code, body = _get(server.port, "/metrics")
        assert code == 200 and check_prometheus(body.decode()) > 0
        assert "tffm_counter_ingest_batches_total 3" in body.decode()
        assert _get(server.port, "/nope")[0] == 404
        assert tel.snapshot()["counters"]["status.requests"] == 3
    finally:
        server.close()
        server.close()  # idempotent


# ---------------------------------------------------------------------------
# Alerts (tests/test_alerts.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "step > 0 : warn",
    "ingest_wait_frac > 0.5 for 3 : warn ; grad_norm_drift > 10 : halt",
    "x > 1 : warn\nx > 1 for 3 : halt",
    "health.grad_norm < 1e-3 : WARN",
    "stages.gauges.ingest.oor_batches > 0 : halt",
])
def test_parse_rules_match_the_reference(spec):
    assert ([dataclasses_tuple(r) for r in alerts.parse_rules(spec)]
            == [dataclasses_tuple(r) for r in jax_obs.parse_rules(spec)])


def dataclasses_tuple(rule) -> tuple:
    return (rule.signal, rule.op, rule.threshold, rule.sustain, rule.action,
            rule.name)


@pytest.mark.parametrize("spec", [
    "step > 0", "step >> 0 : warn", "step > x : warn",
    "step > 0 for 0 : warn", "step > 0 for z : halt", "step > 0 : page",
])
def test_bad_rules_refused_like_the_reference(spec):
    with pytest.raises(ValueError) as ours:
        alerts.parse_rules(spec)
    with pytest.raises(ValueError) as ref:
        jax_obs.parse_rules(spec)
    assert str(ours.value) == str(ref.value)


def test_alert_engine_matches_the_reference_on_a_stream():
    spec = ("grad_norm_drift > 3 : warn ; beat_gap_s > 5 : warn ; "
            "health.grad_norm > 1 for 2 : halt ; "
            "ingest_out_empty_frac > 0.5 : warn ; hot_hit_frac < 0.9 : warn")
    stream = []
    for i in range(12):
        gn = 0.1 if i < 6 else (5.0 if i % 3 else 0.2)
        stream.append({
            "step": i, "health": {"grad_norm": gn},
            "tiered": {"hot_hit_frac": 0.95 if i % 4 else 0.5},
            "stages": {"depths": {"ingest.out_q_depth": {
                "count": 10, "buckets": {"0": 2 + i % 5}}}},
        })
    outs = []
    for mod in (alerts, jax_obs):
        clock = iter(float(t) for t in (0, 1, 2, 9, 10, 11, 12, 13, 20, 21,
                                        22, 23))
        engine = mod.AlertEngine(mod.parse_rules(spec),
                                 clock=lambda: next(clock))
        fired = []
        for rec in stream:
            fired += [(a["rule"], a["step"], a["value"], a["action"])
                      for a in engine.observe(rec)]
        outs.append((fired, engine.active_snapshot(),
                     engine.halted is not None))
    assert outs[0] == outs[1]
    assert outs[0][2]  # the halt rule fired


def test_config_refuses_rules_like_the_reference():
    for kw in (dict(alert_rules="step > 0 : halt"),
               dict(alert_rules="rss_mb > 1 : warn", heartbeat_secs=1,
                    resource_metrics=False),
               dict(alert_rules="psi_max > 1 : warn", heartbeat_secs=1,
                    quality=False),
               dict(alert_rules="straggler_ratio > 2 : warn",
                    heartbeat_secs=1),
               dict(alert_rules="step > zero : warn", heartbeat_secs=1)):
        with pytest.raises(ValueError) as ours:
            FmConfig(**kw)
        with pytest.raises(ValueError) as ref:
            JaxFmConfig(**kw)
        assert str(ours.value) == str(ref.value)


def test_warn_rule_fires_into_metrics_stream(train_file, tmp_path, capsys):
    mf = str(tmp_path / "warn.jsonl")
    t = Trainer(_cfg(train_file, tmp_path, "warnrule", heartbeat_secs=0.05,
                     metrics_file=mf, alert_rules="step > 0 : warn"),
                device="cpu")
    _throttle(t, 0.05)
    result = t.train()
    assert result["train"]["steps"] == 20
    recs = _records(mf)
    fired = [r for r in recs if r.get("record") == "alert"]
    assert len(fired) == 1  # one breach episode, one record
    assert fired[0]["rule"] == "step>0" and fired[0]["action"] == "warn"
    header = [r for r in recs if r.get("record") == "run_header"][0]
    assert header["alert_rules"] == "step > 0 : warn"
    hb = [r for r in recs if r.get("record") == "heartbeat"][-1]
    assert "grad_norm_rms" in hb["health"] and "grad_norm" in hb["health"]
    assert hb["alerts"]["fired_total"] == 1
    capsys.readouterr()
    for tool in (repo_report, port_report):
        assert tool.main([mf]) == 0
        out = capsys.readouterr().out
        assert "alerts (1 fired)" in out and "step>0" in out


def test_halt_rule_stops_run_without_checkpoint(train_file, tmp_path):
    mf = str(tmp_path / "halt.jsonl")
    t = Trainer(_cfg(train_file, tmp_path, "haltrule", heartbeat_secs=0.05,
                     metrics_file=mf, alert_rules="step > 0 : halt"),
                device="cpu")
    _throttle(t, 0.05)
    with pytest.raises(alerts.AlertHaltError, match="step>0"):
        t.train()
    assert int(t.health.step) < 20
    assert not checkpoint.exists(t.cfg.model_file)
    recs = _records(mf)
    final = [r for r in recs if r.get("record") == "final"][-1]
    assert final["exception"] == "AlertHaltError"
    assert any(r.get("record") == "alert" and r["action"] == "halt"
               for r in recs)


# ---------------------------------------------------------------------------
# The server's and the router's streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_model(train_file, tmp_path_factory):
    out = tmp_path_factory.mktemp("obs_model")
    cfg = _cfg(train_file, out, "served")
    Trainer(cfg, device="cpu").train()
    return cfg


def test_server_writes_header_heartbeats_alert_and_final(trained_model,
                                                         train_file,
                                                         tmp_path, capsys):
    import dataclasses

    from fast_tffm_tpu_torch.serve.server import serve

    mf = str(tmp_path / "serve.jsonl")
    cfg = dataclasses.replace(
        trained_model, metrics_file=mf, heartbeat_secs=0.05,
        alert_rules="elapsed > 0 : warn", serve_poll_secs=0.0,
        serve_port=0, serve_batch_sizes="8,32")
    handle = serve(cfg, device="cpu", port=0)
    try:
        body = "".join(open(train_file).readlines()[:20]).encode()
        conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                          timeout=30)
        conn.request("POST", "/score", body=body)
        assert len(conn.getresponse().read().split()) == 20
        conn.close()
        deadline = time.time() + 30
        while time.time() < deadline and not any(
                r["record"] == "heartbeat" for r in _records(mf)[2:]):
            time.sleep(0.05)
    finally:
        handle.close()
    recs = _records(mf)
    kinds = [r["record"] for r in recs]
    assert kinds[0] == "run_header" and recs[0]["mode"] == "serve"
    assert recs[0]["torch_version"] == torch.__version__
    assert kinds.count("alert") == 1 and kinds.count("final") == 1
    assert kinds[-1] == "final" and "heartbeat" in kinds
    beat = [r for r in recs if r["record"] == "heartbeat"][-1]
    assert beat["serve"]["requests"] >= 1 and "alerts" in beat
    assert recs[-1]["serve"]["requests"] == 1
    capsys.readouterr()
    for tool in (repo_report, port_report):
        assert tool.main([mf]) == 0
        out = capsys.readouterr().out
        assert "alerts (1 fired)" in out and "serving run" in out


def test_serve_forever_halts_on_a_halt_rule(trained_model, tmp_path):
    import dataclasses

    from fast_tffm_tpu_torch.serve.server import serve_forever

    mf = str(tmp_path / "halt.jsonl")
    cfg = dataclasses.replace(
        trained_model, metrics_file=mf, heartbeat_secs=0.05,
        alert_rules="elapsed > 0 : halt", serve_poll_secs=0.0,
        serve_port=0, serve_batch_sizes="8")
    assert serve_forever(cfg, device="cpu") == 1
    final = _records(mf)[-1]
    assert final["record"] == "final"
    assert final["exception"] == "AlertHaltError"


class _FakeReplica:
    """A stdlib stand-in for a replica: ``/healthz`` and a ``/status``
    serve block, which the router's health loop and scrape read."""

    def __init__(self):
        class Handler(QuietHandler):
            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._send(200, b"ok\n", "text/plain")
                elif self.path == "/status":
                    doc = {"record": "status",
                           "serve": {"qps": 1.0, "requests": 1}}
                    self._send(200, json.dumps(doc).encode(),
                               "application/json")
                else:
                    self._send(404, b"no\n", "text/plain")

        from fast_tffm_tpu_torch.obs.status import ObsHTTPServer

        self._httpd = ObsHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._thread.join()
        self._httpd.server_close()


def test_router_writes_header_heartbeats_alert_and_final(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    fakes = [_FakeReplica(), _FakeReplica()]

    class FakeManager:
        def __init__(self, cfg, cfg_path, overrides=None, device=None):
            self.replicas = [router.Replica(i, "127.0.0.1", f.port)
                             for i, f in enumerate(fakes)]

        def respawn(self, index):
            return None

        def close(self):
            pass

    monkeypatch.setattr(router, "ReplicaManager", FakeManager)
    mf = str(tmp_path / "router.jsonl")
    cfg = FmConfig(vocabulary_size=50, model_file=str(tmp_path / "m"),
                   serve_replicas=2, metrics_file=mf, heartbeat_secs=0.05,
                   alert_rules="serve.replicas_healthy < 5 : halt")
    try:
        handle = router.start_fleet(cfg, "x.cfg", port=0)
        deadline = time.time() + 30
        while time.time() < deadline and handle.alert_engine.halted is None:
            time.sleep(0.05)
        assert handle.alert_engine.halted is not None
        with pytest.raises(alerts.AlertHaltError):
            alerts.run_until_halt(handle.alert_engine, poll_s=0.01)
        handle.exception = alerts.halt_error(handle.alert_engine.halted)
        handle.close()
    finally:
        for f in fakes:
            f.close()
    recs = _records(mf)
    kinds = [r["record"] for r in recs]
    assert kinds[0] == "run_header" and recs[0]["mode"] == "serve_router"
    assert recs[0]["replica_ports"] == [f.port for f in fakes]
    assert "heartbeat" in kinds and kinds.count("alert") == 1
    assert kinds[-1] == "final"
    assert recs[-1]["exception"] == "AlertHaltError"
    assert recs[-1]["serve"]["replicas"] == 2
    capsys.readouterr()
    for tool in (repo_report, port_report):
        assert tool.main([mf]) == 0
        assert "1 HALT" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Instrument names (tools/check_obs.py)
# ---------------------------------------------------------------------------


def test_every_port_instrument_is_in_the_schema_table():
    names = check_obs.registered_names(os.path.join(REPO,
                                                    "fast_tffm_tpu_torch"))
    documented = check_obs.documented_names(os.path.join(REPO,
                                                         "OBSERVABILITY.md"))
    assert set(names) - documented == {"serve.overlay_gather"}
    for name in ("ingest.batches", "ingest.examples", "ingest.parse",
                 "ingest.reader_block", "ingest.out_block",
                 "ingest.work_q_depth", "ingest.out_q_depth",
                 "ingest.cache_replay_batches", "ingest.cache_bytes",
                 "ingest.ring_windows", "ingest.ring_fallback_windows",
                 "ingest.ring_window_bytes", "ingest.ring_bytes",
                 "ingest.ring_free_slots", "prefetch.stack",
                 "prefetch.device_put", "prefetch.out_block",
                 "prefetch.out_q_depth", "prefetch.super_batches",
                 "prefetch.prestack_hits", "train.wait_input",
                 "train.dispatch", "train.migrate", "status.requests"):
        assert name in names, name


def test_process_pool_and_cache_instruments(train_file, tmp_path):
    """The pool's ring and the epoch cache report under the reference's
    names."""
    mf = str(tmp_path / "procs.jsonl")
    t = Trainer(_cfg(train_file, tmp_path, "procs", parse_processes=2,
                     epoch_num=2, metrics_file=mf), device="cpu")
    t.train()
    final = _records(mf)[-1]
    counters = final["stages"]["counters"]
    assert counters["ingest.batches"] == 40
    assert counters["ingest.ring_windows"] > 0
    assert final["stages"]["gauges"]["ingest.ring_bytes"] == 0  # torn down
    assert final["stages"]["timers"]["ingest.parse"]["count"] == 40
    mf2 = str(tmp_path / "cache.jsonl")
    t = Trainer(_cfg(train_file, tmp_path, "cache", cache_epochs=True,
                     epoch_num=3, metrics_file=mf2), device="cpu")
    t.train()
    final = _records(mf2)[-1]
    assert final["stages"]["counters"]["ingest.cache_replay_batches"] == 40
    assert final["stages"]["gauges"]["ingest.cache_bytes"] > 0
    assert final["ingest_cache"] == "cached"
