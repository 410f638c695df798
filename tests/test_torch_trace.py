"""The port's trace (``obs/trace.py``) and its report modes against the
JAX package's on the CPU.

- the tracer: complete events with args, flows, the disabled no-op,
  shipped events, the event cap and rotation windows, each as the
  reference's tracer records them;
- a traced ``Trainer.train()`` of the port, in thread mode, in pool mode
  (the workers' ``parse.batch`` spans shipped back with the results) and
  from the prestacked cache: every dispatched super-batch has one
  complete chain read -> parse -> deliver -> stack -> H2D -> dispatch,
  and the port's ``tools/report.py`` and the repo's find the same chains
  and span names in the port's trace, and in the reference trainer's;
- trace on and off train bitwise the same;
- a served request with ``serve_trace_sample = 1`` has a complete chain
  queue -> coalesce -> dispatch -> respond in either report's
  ``--serve-trace``.
"""

import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.obs import trace as jax_trace
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs import trace
from fast_tffm_tpu_torch.serve import server as serve_server
from fast_tffm_tpu_torch.tools import report as port_report
from fast_tffm_tpu_torch.train.loop import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import report as repo_report  # noqa: E402

TRAINER_SPANS = {"read.item", "parse.batch", "ingest.deliver",
                 "prefetch.stack", "prefetch.h2d", "train.dispatch",
                 "train.wait_input"}


def _write_libsvm(path, n_lines, vocab=50, n_feat=3, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_lines):
            feats = rng.choice(vocab, size=n_feat, replace=False)
            toks = " ".join(f"{i}:{rng.uniform(0.1, 1):.3f}" for i in feats)
            f.write(f"{rng.integers(0, 2)} {toks}\n")
    return str(path)


def _kw(data, tmp_path, tag, **kw):
    out = dict(
        vocabulary_size=50, factor_num=4, model_file=str(tmp_path / tag),
        train_files=[data], epoch_num=1, batch_size=32, max_features=4,
        log_steps=0, thread_num=2, steps_per_dispatch=4, seed=3,
    )
    out.update(kw)
    return out


@pytest.fixture(scope="module")
def train_file(tmp_path_factory):
    return _write_libsvm(tmp_path_factory.mktemp("trace_data")
                         / "train.libsvm", 640)


def _names(events):
    return {e["name"] for e in events if e.get("ph") == "X"}


# ------------------------------------------------------------ the tracer


@pytest.mark.parametrize("mod", [trace, jax_trace],
                         ids=["port", "reference"])
def test_tracer_records_as_the_reference(mod, tmp_path):
    """The same calls on either package's tracer give the same events
    (names, phases, args, flow ids), the same file layout, the same cap
    accounting and the same rotation windows."""
    t = mod.Tracer(enabled=True, process_name="p")
    with t.span("a.span", args={"sb": 3}, flow=("s", "sb3")):
        pass
    t.emit("b.emit", 1.0, 0.5, args={"seq": 7})
    t.point("c.point", args={"batch": 0, "n": 2, "seq": None})
    t.add_raw([{"name": "w.span", "ph": "X", "ts": 1, "dur": 1,
                "pid": 99, "tid": 1}])
    path = str(tmp_path / "t.json")
    n = t.dump(path)
    doc = json.load(open(path))
    evs = doc["traceEvents"]
    assert n >= 5
    xs = {e["name"]: e for e in evs if e.get("ph") == "X"}
    assert set(xs) == {"a.span", "b.emit", "c.point", "w.span"}
    assert xs["a.span"]["args"] == {"sb": 3}
    assert xs["b.emit"]["dur"] == 500000
    flows = [e for e in evs if e.get("cat") == "tffm_flow"]
    assert [(f["ph"], f["id"]) for f in flows] == [("s", "sb3")]
    ref_doc = json.loads(json.dumps(doc))
    assert sorted(ref_doc) == sorted(doc)
    off = mod.Tracer(enabled=False)
    with off.span("x"):
        off.emit("y", 0.0, 1.0)
    assert off.take() == [] and not off.enabled
    # The cap drops and counts; rotation writes numbered windows.
    capped = mod.Tracer(enabled=True, max_events=3)
    for i in range(5):
        capped.emit("e", float(i), 0.1)
    assert capped.dropped_events == 2
    rot = mod.Tracer(enabled=True, rotate_events=4,
                     rotate_path=str(tmp_path / "r.json"))
    for i in range(10):
        rot.emit("e", float(i), 0.1, args={"i": i})
    rot.dump(str(tmp_path / "r.json"))
    rot.close()
    assert rot.windows_written == 3
    assert os.path.exists(rot.window_path(0))
    assert os.path.basename(rot.window_path(2)) == "r.2.json"


def test_port_and_reference_tracers_write_one_layout(tmp_path):
    files = {}
    for name, mod in (("port", trace), ("ref", jax_trace)):
        t = mod.Tracer(enabled=True, process_name="trainer rank0")
        t.name_thread("train-loop")
        with t.span("train.dispatch", args={"sb": 0, "k": 4, "step0": 0},
                    flow=("f", "sb0")):
            pass
        path = str(tmp_path / f"{name}.json")
        t.dump(path)
        files[name] = json.load(open(path))
    a, b = files["port"], files["ref"]
    assert sorted(a) == sorted(b)
    assert sorted(a.get("otherData", {})) == sorted(b.get("otherData", {}))

    def shape(doc):
        return sorted((e["ph"], e.get("name"), e.get("cat"),
                       tuple(sorted((e.get("args") or {})))) for e in
                      doc["traceEvents"])

    assert shape(a) == shape(b)


# ------------------------------------------------------------ the trainer


@pytest.fixture(scope="module", params=[
    dict(thread_num=2), dict(parse_processes=2),
    dict(cache_epochs=True, cache_prestacked=True, epoch_num=2),
], ids=["threads", "pool", "prestacked"])
def traced(request, train_file, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traced")
    path = str(tmp / "trace.json")
    t = Trainer(FmConfig(**_kw(train_file, tmp, "m", trace_file=path,
                               **request.param)), device="cpu")
    res = t.train()
    return {"trace": path, "res": res, "tmp": tmp, "mode": request.param}


def test_every_dispatch_has_one_complete_chain(traced):
    events = json.load(open(traced["trace"]))["traceEvents"]
    # A prestacked group ships with no fill: its h2d span carries the
    # batch range instead of a stack span.
    want = TRAINER_SPANS - ({"prefetch.stack"}
                            if "cache_prestacked" in traced["mode"] else
                            set())
    assert want <= _names(events)
    dispatches = traced["res"]["train"]["dispatches"]
    for tool in (port_report, repo_report):
        chains = tool.trace_chains(events)
        assert len(chains) == dispatches
        assert all(c["complete"] for c in chains), [
            c["sb"] for c in chains if not c["complete"]]
    if "parse_processes" in traced["mode"]:
        # The workers' spans came back under their own pids.
        pids = {e["pid"] for e in events if e.get("name") == "parse.batch"}
        assert pids and os.getpid() not in pids


def test_both_reports_read_the_port_trace(traced, capsys):
    out = {}
    for name, tool in (("port", port_report), ("repo", repo_report)):
        assert tool.main(["--trace", traced["trace"], "-o",
                          str(traced["tmp"] / f"{name}.merged.json")]) == 0
        out[name] = capsys.readouterr().out
    n = traced["res"]["train"]["dispatches"]
    line = (f"super-batch chains: {n} dispatched, {n} with a complete "
            "read->parse->deliver->h2d->dispatch chain")
    assert line in out["port"] and line in out["repo"]


def test_port_report_reads_the_reference_trace(train_file, tmp_path):
    """The reference trainer's trace (pool mode): the port's report
    finds the chains and span names the repo's finds."""
    path = str(tmp_path / "ref_trace.json")
    JaxTrainer(JaxFmConfig(**_kw(train_file, tmp_path, "ref",
                                 trace_file=path,
                                 parse_processes=2))).train()
    events = json.load(open(path))["traceEvents"]
    a = port_report.trace_chains(events)
    b = repo_report.trace_chains(events)
    assert len(a) == len(b) > 0
    assert [c["complete"] for c in a] == [c["complete"] for c in b]
    assert all(c["complete"] for c in a)
    merged_a = port_report.merge_traces([path])[0]
    merged_b = repo_report.merge_traces([path])[0]
    assert _names(merged_a) == _names(merged_b)


def test_trace_only_observes(train_file, tmp_path):
    """Trace on and off train bitwise the same; off writes no file."""
    out = {}
    for on in (False, True):
        path = str(tmp_path / f"t{on}.json")
        t = Trainer(FmConfig(**_kw(train_file, tmp_path, f"m{on}",
                                   trace_file=path if on else "")),
                    device="cpu")
        res = t.train()
        out[on] = (t, res)
        assert os.path.exists(path) == on
    ta, tb = out[False][0], out[True][0]
    assert torch.equal(ta.model.table, tb.model.table)
    assert torch.equal(ta.model.w0, tb.model.w0)
    for x, y in zip(ta.opt_state, tb.opt_state):
        assert torch.equal(x, y)
    assert out[False][1]["train"]["loss"] == out[True][1]["train"]["loss"]


# ------------------------------------------------------------ serving


def test_served_requests_have_complete_chains(train_file, tmp_path, capsys):
    kw = _kw(train_file, tmp_path, "served")
    Trainer(FmConfig(**kw), device="cpu").train()
    path = str(tmp_path / "serve_trace.json")
    cfg = FmConfig(**dict(kw, trace_file=path, serve_trace_sample=1.0,
                          serve_poll_secs=0.0, serve_batch_sizes="8"))
    handle = serve_server.serve(cfg, device="cpu", port=0)
    rids = []
    try:
        for body in (b"1 3:1\n0 2:0.5\n", b"1 4:1\n"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{handle.port}/score", data=body,
                method="POST")
            with urllib.request.urlopen(req, timeout=30) as resp:
                rids.append(resp.headers["X-Request-Id"])
    finally:
        handle.close()
    assert all(rids)
    events = json.load(open(path))["traceEvents"]
    for tool in (port_report, repo_report):
        chains = {c["rid"]: c for c in tool.serve_request_chains(events)}
        for rid in rids:
            assert chains[rid]["complete"], sorted(chains[rid]["spans"])
        assert tool.main(["--serve-trace", path]) == 0
        assert "sampled requests:" in capsys.readouterr().out
