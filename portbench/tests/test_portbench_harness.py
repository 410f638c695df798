"""The harness: every cell loads, a new configuration, traffic mix or
metric is found by its name alone, and a run at a tiny size on the CPU is
correct, while the control and each fault the timed path can have are
not."""

import json
import os
import re
import shutil

import pytest
import torch

import portbench.metrics
from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.train import metrics as metrics_lib
from fast_tffm_tpu_torch.train import sparse
from portbench import run

from .conftest import CELLS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_loads_and_names_its_files():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    for path in bench["paths"]:
        assert os.path.isdir(os.path.join(run.ROOT, path))
    for cell in CELLS:
        spec = run.load_cell(cell)
        assert spec["cell"]["chips"] == 1
        assert len(spec["cell"]["why"]) <= 200
        assert {m["name"] for m in spec["end_to_end"]} == {
            "train_examples_per_s", "peak_device_gib", "setup_s"}
        assert len(spec["per_layer"]) == 6
        flat = {k: v for keys in spec["config"]["cfg"].values()
                for k, v in keys.items()}
        assert spec["config"]["epoch_lines"] % (int(flat["batch_size"]) * int(
            flat["steps_per_dispatch"])) == 0
        assert spec["config"]["reduced"] == ["epoch_lines"]
        assert len(spec["config"]["schema"]["fields"]) <= int(
            flat["max_features"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"])
        assert os.path.exists(os.path.join(
            run.ROOT, "portbench", "metrics", m["name"] + ".py"))
    for m in bench["per_layer"]:
        assert m["moves"] == "train_examples_per_s"
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path,
                                                         monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(run.ROOT, "portbench", "configs"),
                    root / "portbench" / "configs")
    shutil.copytree(os.path.join(run.ROOT, "portbench", "traffic"),
                    root / "portbench" / "traffic")
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = json.loads((root / "portbench/configs/avazu.json").read_text())
    (root / "portbench/configs/avazu_wide.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/cached_flat.json").write_text(json.dumps(
        {"categorical": "zipf", "cfg": {"Train": {"cache_epochs": "false"}}}))
    bench["configs"].append({"name": "avazu_wide", "source": "x",
                             "file": "portbench/configs/avazu_wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "avazu_wide.cached_flat",
                               "config": "avazu_wide",
                               "traffic": "cached_flat", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "extra_ratio", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.load_cell("avazu_wide.cached_flat", str(root))
    assert spec["traffic"]["cfg"] == {"Train": {"cache_epochs": "false"}}
    assert spec["config"]["cfg"] == cfg["cfg"]
    names = [m["name"] for m in spec["per_layer"]]
    assert names == ["extra_ratio"]  # the others list their cells
    extra = tmp_path / "more_metrics"
    extra.mkdir()
    (extra / "extra_ratio.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx['setup_s']\n")
    monkeypatch.setattr(portbench.metrics, "__path__",
                        [*portbench.metrics.__path__, str(extra)])
    got = run.read_metrics(spec["per_layer"], {"setup_s": 1.5})
    assert got == {"extra_ratio": {"value": 3.0, "unit": "%"}}


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    spec = run.load_cell(CELLS[0])
    got = run.read_metrics(spec["per_layer"], {"window": None})
    assert got == {}


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct(tiny_run, cell):
    result, checks = tiny_run(cell)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_examples_per_s", "setup_s"}
    for value, limit in checks.values():
        assert value <= limit


@pytest.mark.parametrize("train", [{"cache_epochs": "false"},
                                   {"cache_prestacked": "false"}])
def test_other_ingest_modes_are_followed_by_the_reference(train):
    """A mix that streams every epoch from text, or replays single
    batches, needs only its data file."""
    from .conftest import SEED, TINY

    spec = run.load_cell(CELLS[0])
    spec["traffic"] = dict(spec["traffic"], cfg={"Train": train})
    result, checks = run.run_cell(spec, SEED, 0.2, False, "cpu", dict(TINY))
    assert result["correct"], checks


def test_a_traced_tiny_run_reads_its_per_layer_metrics(tiny_run,
                                                       monkeypatch):
    monkeypatch.setattr(run, "TRACE_DISPATCHES", 4)
    result, _ = tiny_run(CELLS[1], trace=True)
    assert result["correct"]
    # No device on the CPU: the trace's device metrics stay silent.
    assert set(result["metrics"]) == {"input_wait_frac", "dispatch_host_ms",
                                      "train_mfu"}
    assert result["busy_s"] == 0.0 and result["window_s"] > 0
    assert result["breakdown"]["idle_gaps"]


def test_the_control_is_not_correct(tiny_run):
    """The port's own bf16 compute path in the program's place."""
    result, checks = tiny_run(CELLS[0], compute_dtype="bfloat16")
    assert not result["correct"], checks


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(sparse_apply, "apply", lambda *a, **k: None)
    monkeypatch.setattr(sparse, "apply_w0", lambda *a, **k: None)


def _half_batch(monkeypatch):
    real = sparse.rows_loss

    def half(cfg, w0, rows, batch, impl="pallas"):
        keep = torch.ones_like(batch.weights)
        keep[keep.shape[0] // 2:] = 0
        return real(cfg, w0, rows, batch._replace(
            weights=batch.weights * keep), impl)

    monkeypatch.setattr(sparse, "rows_loss", half)


def _altered_answer(monkeypatch):
    real = metrics_lib.weighted_loss

    def altered(scores, labels, weights, loss_type):
        lsum, wsum = real(scores, labels, weights, loss_type)
        return lsum * 1.001, wsum

    monkeypatch.setattr(metrics_lib, "weighted_loss", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer])
def test_a_broken_timed_path_is_not_correct(tiny_run, monkeypatch, fault):
    fault(monkeypatch)
    result, checks = tiny_run(CELLS[0])
    assert not result["correct"], checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_on_the_card(tiny_run, cell):
    """The same tiny cell through the kernels and the CUDA graph, and its
    control."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    result, checks = tiny_run(cell, device="cuda", trace=True)
    assert result["correct"], checks
    assert result["busy_s"] > 0
    assert {"step_device_ms", "device_idle_frac"} <= set(result["metrics"])
    result, checks = tiny_run(cell, device="cuda", compute_dtype="bfloat16")
    assert not result["correct"], checks
