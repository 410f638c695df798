"""The port's training-fleet scrape, compile sentinel and profiler window
against the JAX package's on the CPU.

- ``TrainFleet.block``, ``rank_rows`` and ``metrics_lines`` equal the
  reference's on the same scraped ``/status`` records;
- ``CompileSentinel.snapshot`` equals the reference's on the same
  compile events, and the ``record: compile`` entries it writes read the
  same in both reports;
- the build ledger counts a parser build; a trainer's ``resource``
  block carries the sentinel's counts and the builds;
- ``profile_dir`` writes one Chrome trace of the window, and profiling
  trains bitwise the same as not profiling;
- two gloo ranks with ``train_fleet_scrape``: rank 0's ``fleet`` block
  has both ranks' rows, ``exchange_frac`` in [0, 1] from the
  ``train.exchange`` probe, and both ranks train as without the scrape.
"""

import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

from fast_tffm_tpu.obs import fleet as jax_fleet
from fast_tffm_tpu.obs import resource as jax_resource
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs import fleet, resource
from fast_tffm_tpu_torch.obs.heartbeat import JsonlWriter
from fast_tffm_tpu_torch.obs.telemetry import Telemetry
from fast_tffm_tpu_torch.tools import report as port_report
from fast_tffm_tpu_torch.train.loop import Trainer

from _torch_sharded_worker import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import report as repo_report  # noqa: E402


def _status(rank, step, wait_s, disp_s, exch_s, elapsed, n):
    def timer(total, count):
        return {"count": count, "total_s": total,
                "mean_ms": round(1e3 * total / count, 3),
                "p99_ms": round(2e3 * total / count, 3)}

    return {
        "record": "status", "rank": rank, "step": step, "elapsed": elapsed,
        "examples_in": 32 * step, "ingest_wait_frac": wait_s / elapsed,
        "tiered": {"cold_store_bytes": 1024 * (rank + 1),
                   "num_shards": 2, "owned_shards": 1},
        "stages": {"timers": {
            "train.dispatch": timer(disp_s, n),
            "train.wait_input": timer(wait_s, n),
            "train.exchange": timer(exch_s, n),
        }},
    }


@pytest.mark.parametrize("records", [
    [_status(0, 40, 0.2, 1.5, 0.01, 3.0, 10),
     _status(1, 36, 0.4, 2.5, 0.30, 3.1, 9)],
    [_status(0, 8, 0.0, 0.1, 0.0, 0.5, 2)],
])
def test_train_fleet_block_equals_the_reference(records):
    targets = [f"127.0.0.1:{9000 + i}" for i in range(len(records))]
    by_target = dict(zip(targets, records))
    out = []
    for mod in (fleet, jax_fleet):
        f = mod.TrainFleet(targets, fetch=by_target.__getitem__,
                           start=False)
        assert f.scrape_once() == len(records)
        now = 1e9
        out.append((f.block(now), f.rank_rows(now), f.metrics_lines(now)))
        f.close()
    for a, b in zip(*out):
        # The scrape age is relative to each fleet's own scrape time.
        if isinstance(a, dict):
            a, b = dict(a), dict(b)
            a.pop("scrape_age_max_s"), b.pop("scrape_age_max_s")
            assert a == b
        elif isinstance(a, list):
            strip = [{k: v for k, v in r.items() if k != "scrape_age_s"}
                     for r in a]
            assert strip == [{k: v for k, v in r.items()
                              if k != "scrape_age_s"} for r in b]
        else:
            keep = [line for line in a.splitlines() if "scrape_age" not in line]
            assert keep == [line for line in b.splitlines()
                            if "scrape_age" not in line]
    block = out[0][0]
    assert block["ranks_scraped"] == len(records)
    assert 0.0 <= block["exchange_frac"] <= 1.0


def test_compile_sentinel_equals_the_reference(tmp_path, capsys):
    events = [(1.25, 4, True, 0), (0.5, 2, True, 40), (0.75, 3, False, 44)]
    snaps, paths = [], []
    for name, mod in (("port", resource), ("ref", jax_resource)):
        tel = Telemetry(enabled=True)
        s = mod.CompileSentinel(telemetry=tel, expected_k=4)
        path = str(tmp_path / f"{name}.jsonl")
        w = JsonlWriter(path)
        s.set_writer(w)
        for wall, k, expected, step in events:
            s.record(wall, k, expected, step=step)
        s.reclassify_unexpected(2, step=40)
        w.close()
        snaps.append(s.snapshot())
        assert tel.timer("train.compile").snapshot()["count"] == 3
        paths.append(path)
    assert snaps[0] == snaps[1]
    assert snaps[0] == {"compiles": 3, "compile_s": 2.5,
                        "recompiles_unexpected": 2}
    outs = []
    for tool in (port_report, repo_report):
        for path in paths:
            assert tool.main([path]) == 0
            outs.append(capsys.readouterr().out)
    assert len(set(outs)) == 1 and "compiles (3, 2.50s total, 1 UNEXPECTED)" \
        in outs[0]


def _write(path, n=640, vocab=50, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            feats = rng.choice(vocab, size=3, replace=False)
            toks = " ".join(f"{i}:{rng.uniform(0.1, 1):.3f}" for i in feats)
            f.write(f"{rng.integers(0, 2)} {toks}\n")
    return str(path)


def _kw(tmp_path, tag, **kw):
    out = dict(vocabulary_size=512, factor_num=4, max_features=4,
               batch_size=32, train_files=[str(tmp_path / "train.libsvm")],
               model_file=str(tmp_path / tag), epoch_num=1, log_steps=0,
               thread_num=2, steps_per_dispatch=4, seed=3)
    out.update(kw)
    return out


def test_build_ledger_and_resource_block(tmp_path, monkeypatch):
    """A parser build is one ledger entry; the trainer's ``resource``
    block carries the sentinel's keys and the builds (none on the CPU:
    no graph capture)."""
    from fast_tffm_tpu_torch.data import native

    before = resource.build_block()["builds"]
    lib = str(tmp_path / "libfm_parser.so")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIB_PATH", lib)
    native._build()
    assert os.path.exists(lib)
    got = resource.build_block()
    assert got["builds"] == before + 1 and got["build_s"] > 0
    native._build()  # up to date: no build
    assert resource.build_block()["builds"] == before + 1
    _write(tmp_path / "train.libsvm")
    res = Trainer(FmConfig(**_kw(tmp_path, "m")), device="cpu").train()
    block = res["train"]["resource"]
    assert block["compiles"] == 0 and block["recompiles_unexpected"] == 0
    assert block["builds"] == resource.build_block()["builds"]
    off = Trainer(FmConfig(**_kw(tmp_path, "n", resource_metrics=False)),
                  device="cpu").train()
    assert "resource" not in off["train"]


def test_profile_dir_writes_one_trace_and_only_observes(tmp_path):
    _write(tmp_path / "train.libsvm")
    res = {}
    for on in (False, True):
        prof = str(tmp_path / "prof") if on else ""
        t = Trainer(FmConfig(**_kw(tmp_path, f"p{on}", epoch_num=2,
                                   profile_dir=prof, profile_start_step=4,
                                   profile_steps=8)), device="cpu")
        res[on] = (t, t.train())
    files = os.listdir(tmp_path / "prof")
    assert files == ["trace_rank0.json"]
    doc = json.load(open(tmp_path / "prof" / files[0]))
    assert doc["traceEvents"]
    a, b = res[False][0], res[True][0]
    assert torch.equal(a.model.table, b.model.table)
    for x, y in zip(a.opt_state, b.opt_state):
        assert torch.equal(x, y)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_two_ranks_scrape_the_fleet(tmp_path):
    """Two gloo ranks (an all-data mesh) with ``train_fleet_scrape``:
    rank 0's final ``fleet`` block has both ranks' rows and an
    ``exchange_frac`` in [0, 1] from the probe; rank 1 has no block;
    the scrape leaves the training as it was without it."""
    _write(tmp_path / "train.libsvm", n=1280)
    ports = _free_ports(2)
    base = _kw(tmp_path, "plain", mesh_data=2, epoch_num=2, thread_num=1)
    scraped = dict(base, model_file=str(tmp_path / "scraped"),
                   heartbeat_secs=0.05, _status_ports=ports,
                   _throttle_s=0.05,
                   train_fleet_scrape=",".join(f"127.0.0.1:{p}"
                                               for p in ports))
    (tmp_path / "train.json").write_text(json.dumps([base, scraped]))
    run_ranks("train", 2, tmp_path)
    res = [[json.loads((tmp_path / f"train{i}_{r}.json").read_text())
            for r in range(2)] for i in range(2)]
    blk = res[1][0]["train"]["fleet"]
    assert blk["ranks_scraped"] == 2
    assert 0.0 <= blk["exchange_frac"] <= 1.0
    assert "rank_step_skew" in blk
    assert "fleet" not in res[1][1]["train"]
    assert res[0][0]["train"]["loss"] == res[1][0]["train"]["loss"]
    a = np.load(tmp_path / "plain" / "params.npz")
    b = np.load(tmp_path / "scraped" / "params.npz")
    np.testing.assert_array_equal(a["params/table"], b["params/table"])
