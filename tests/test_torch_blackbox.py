"""The port's flight recorder (``obs/blackbox.py``) against the JAX
package's on the CPU.

- the recorder: the same records and alerts give the same bundle (its
  artifact set and manifest keys), fixed-memory rings, the ordinal retry
  and the bundle cap, as the reference's recorder;
- the trainer: ``nan_policy = halt`` leaves a ``crash_NonFiniteGradError``
  bundle, an alert leaves ``alert_<rule>``, and ``POST /incident`` on
  the status endpoint one named by its ``reason``; ``blackbox = false``
  answers 503 and writes nothing; blackbox on and off train bitwise the
  same;
- the server: ``POST /incident`` dumps a bundle with the capture's tail,
  503 with the blackbox off;
- the report: each package's ``--incident`` reads the other's bundles.
"""

import http.client
import json
import os
import sys

import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.obs import blackbox as jax_blackbox
from fast_tffm_tpu.train.loop import NonFiniteGradError as JaxNonFinite
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs import blackbox
from fast_tffm_tpu_torch.serve import server as serve_server
from fast_tffm_tpu_torch.tools import report as port_report
from fast_tffm_tpu_torch.train.loop import NonFiniteGradError, Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import report as repo_report  # noqa: E402

V = 256


def _write_data(path, rng, lines=256, vocab=V):
    with open(path, "w") as f:
        for i in range(lines):
            f.write(f"{i % 2} {rng.integers(0, vocab)}:1 "
                    f"{rng.integers(0, vocab)}:0.5 "
                    f"{rng.integers(0, vocab)}:0.25\n")


def _kw(tmp_path, tag, **kw):
    out = dict(
        vocabulary_size=V, factor_num=4, max_features=4, batch_size=32,
        train_files=[str(tmp_path / "train.libsvm")],
        model_file=str(tmp_path / tag), epoch_num=1, log_steps=0,
        thread_num=1, seed=3, steps_per_dispatch=2,
        serve_batch_sizes="32,64", max_batch_wait_ms=1.0,
    )
    out.update(kw)
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bb")
    _write_data(tmp / "train.libsvm", np.random.default_rng(0))
    return tmp


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bundles(root):
    root = str(root)
    if not os.path.isdir(root):
        return []
    return sorted(os.listdir(root))


def _incident_out(tool, path, capsys):
    assert tool.main(["--incident", path]) == 0
    return capsys.readouterr().out


# ------------------------------------------------------------ the recorder


def test_recorder_bundles_as_the_reference(tmp_path):
    """The same rings and reason give the same bundle in either
    package: the same artifacts, the same manifest keys and counts, and
    the same ring contents; rings stay fixed-size; a same-second dump
    takes an ordinal; the cap holds."""
    recs = [{"record": "heartbeat", "step": i, "elapsed": float(i),
             "health": {"grad_norm": 0.1 * i}} for i in range(100)]
    alert = {"record": "alert", "rule": "step > 3", "signal": "step",
             "value": 99, "op": ">", "threshold": 3, "action": "warn",
             "step": 99}
    out = {}
    for name, mod in (("port", blackbox), ("ref", jax_blackbox)):
        bb = mod.Blackbox(str(tmp_path / name), suffix="rank0",
                          records=16, alerts=4, max_bundles=2,
                          run_header={"config_fingerprint": "x"},
                          metrics_render=lambda: "tffm_x 1\n",
                          trace_tail_fn=lambda n=256: [
                              {"name": "train.dispatch", "ph": "X",
                               "ts": 1, "dur": 2, "pid": 1, "tid": 1,
                               "args": {"sb": 0}}])
        for r in recs:
            bb.observe_record(r)
        bb.observe_alert(alert)
        a = bb.incident("manual check")
        b = bb.incident("manual check")
        assert bb.incident("third") is None  # the cap
        assert a != b and os.path.basename(b).endswith("-2")
        man = json.load(open(os.path.join(a, "manifest.json")))
        rows = [json.loads(x) for x in open(os.path.join(a,
                                                         "records.jsonl"))]
        out[name] = (sorted(os.listdir(a)), sorted(man), man["reason"],
                     man.get("counts"), rows)
        assert len(rows) == 16 and rows[-1]["step"] == 99
    assert out["port"] == out["ref"]


# ------------------------------------------------------------ the trainer


def _poison(trainer):
    with torch.no_grad():
        trainer.model.table[:] = float("nan")


def test_halt_leaves_a_bundle_both_reports_read(data, tmp_path, capsys):
    """``nan_policy = halt`` on either package leaves a crash bundle
    under ``<model_file>/incidents``; each report's ``--incident`` reads
    both bundles the same."""
    t = Trainer(FmConfig(**_kw(data, "port_halt", nan_policy="halt",
                               model_file=str(tmp_path / "p"))),
                device="cpu")
    _poison(t)
    with pytest.raises(NonFiniteGradError):
        t.train()
    jt = JaxTrainer(JaxFmConfig(**_kw(data, "ref_halt", nan_policy="halt",
                                      model_file=str(tmp_path / "r"))))
    import jax.numpy as jnp

    jt.state = jt.state._replace(params=jt.state.params._replace(
        table=jnp.full_like(jt.state.params.table, jnp.nan)))
    with pytest.raises(JaxNonFinite):
        jt.train()
    pb = _bundles(tmp_path / "p" / "incidents")
    rb = _bundles(tmp_path / "r" / "incidents")
    assert len(pb) == len(rb) == 1
    assert pb[0].endswith("_crash_NonFiniteGradError_rank0")
    assert rb[0].endswith("_crash_NonFiniteGradError_rank0")
    p_dir = str(tmp_path / "p" / "incidents" / pb[0])
    r_dir = str(tmp_path / "r" / "incidents" / rb[0])
    assert sorted(os.listdir(p_dir)) == sorted(os.listdir(r_dir))
    for path in (p_dir, r_dir):
        outs = [_incident_out(tool, path, capsys)
                for tool in (port_report, repo_report)]
        assert outs[0] == outs[1]
        assert "incident: crash_NonFiniteGradError" in outs[0]


def test_alert_and_post_incident_bundles(data, tmp_path):
    """An alert rule's bundle and a ``POST /incident`` bundle on the
    trainer's status endpoint; ``blackbox = false`` answers 503 and
    dumps nothing."""
    import threading
    import time

    for on in (True, False):
        model = tmp_path / f"m{on}"
        kw = _kw(data, "x", model_file=str(model), blackbox=on,
                 status_port=_free_port(), heartbeat_secs=0.05,
                 epoch_num=6,
                 alert_rules="step > 0 : warn" if on else "")
        t = Trainer(FmConfig(**kw), device="cpu")
        real = t.dispatch
        t.dispatch = lambda sb, pause=None: (time.sleep(0.05),
                                             real(sb, pause))[1]
        codes = []

        def poke():
            deadline = time.time() + 60
            while not codes and time.time() < deadline:
                port = t.status_port
                if not port:
                    time.sleep(0.02)
                    continue
                try:
                    c = http.client.HTTPConnection("127.0.0.1", port,
                                                   timeout=30)
                    c.request("POST", "/incident?reason=oncall", body=b"")
                    codes.append(c.getresponse().status)
                    c.close()
                except OSError:
                    time.sleep(0.02)

        th = threading.Thread(target=poke)
        th.start()
        t.train()
        th.join()
        got = _bundles(model / "incidents")
        if on:
            assert codes == [200]
            assert any("_oncall_rank0" in b for b in got)
            assert any("_alert_" in b for b in got)
        else:
            assert codes == [503] and got == []


def test_blackbox_only_observes(data, tmp_path):
    res = {}
    for on in (False, True):
        t = Trainer(FmConfig(**_kw(data, f"o{on}", blackbox=on,
                                   model_file=str(tmp_path / f"o{on}"))),
                    device="cpu")
        res[on] = (t, t.train())
    a, b = res[False][0], res[True][0]
    assert torch.equal(a.model.table, b.model.table)
    assert torch.equal(a.model.w0, b.model.w0)
    for x, y in zip(a.opt_state, b.opt_state):
        assert torch.equal(x, y)
    assert res[False][1]["train"]["loss"] == res[True][1]["train"]["loss"]


# ------------------------------------------------------------ the server


def test_server_post_incident(data, tmp_path, capsys):
    kw = _kw(data, "srv", model_file=str(tmp_path / "srv"))
    Trainer(FmConfig(**kw), device="cpu").train()
    for on in (True, False):
        cfg = FmConfig(**dict(kw, blackbox=on, serve_poll_secs=0.0,
                              serve_capture_sample=1.0 if on else 0.0,
                              serve_capture_file=(str(tmp_path / "c.tfc")
                                                  if on else "")))
        handle = serve_server.serve(cfg, device="cpu", port=0)
        try:
            c = http.client.HTTPConnection("127.0.0.1", handle.port,
                                           timeout=30)
            c.request("POST", "/score", body=b"1 3:1\n0 4:0.5\n")
            assert c.getresponse().read()
            c.request("POST", "/incident?reason=drill", body=b"")
            resp = c.getresponse()
            body = resp.read()
            c.close()
        finally:
            handle.close()
        if not on:
            assert resp.status == 503
            continue
        assert resp.status == 200
        path = json.loads(body)["incident_dir"]
        assert "requests.capture" in os.listdir(path)
        outs = [_incident_out(tool, path, capsys)
                for tool in (port_report, repo_report)]
        assert outs[0] == outs[1] and "incident: drill" in outs[0]
