"""The yardstick's arithmetic on hand-made numbers: the union of device
intervals, the slice's reduction, the counts and the check's leaf gap;
and that the harness loads nothing of JAX or the JAX package."""

import json
import os
import subprocess
import sys

import pytest

from portbench import check, counts, run, trace


def test_union_counts_overlap_once_and_finds_the_gaps():
    # Two streams: [0, 10) and [5, 12) overlap; [20, 25) alone; clipped
    # to the window [2, 30).
    busy, gaps = trace.union([0, 5, 20], [10, 12, 25], 2, 30)
    assert busy == pytest.approx(10 + 5)
    assert gaps == [(12, 20), (25, 30)]
    busy, gaps = trace.union([], [], 0, 4)
    assert busy == 0 and gaps == [(0, 4)]
    # Nested and touching intervals merge.
    busy, gaps = trace.union([0, 1, 3], [3, 2, 6], 0, 6)
    assert busy == 6 and gaps == []


def _ev(name, cat, ts, dur, tid=1, pid=0):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": pid}


def test_reduce_slice_on_a_hand_made_trace(tmp_path):
    events = [
        _ev("portbench.slice_open", "user_annotation", 100, 1),
        _ev("void k1_kernel<float>(int)", "kernel", 110, 20, tid=7),
        _ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 120, 30, tid=9),
        _ev("void k2_kernel<1>(int)", "kernel", 170, 10, tid=7),
        _ev("void k2_kernel<1>(int)", "kernel", 50, 10, tid=7),  # before
        _ev("cudaEventSynchronize", "cuda_runtime", 150, 15),
        _ev("portbench.slice_close", "user_annotation", 200, 1),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace.load(str(path))
    # The port's spans on perf_counter (µs): 1000 there is 100 here.
    spans = [{"ph": "X", "name": "train.wait_input", "ts": 1045, "dur": 25},
             {"ph": "X", "name": "train.dispatch", "ts": 1070, "dur": 30}]
    red = trace.reduce_slice(got, "portbench.slice_open",
                             "portbench.slice_close", 1000.0, spans)
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["busy_s"] == pytest.approx((150 - 110 + 10) * 1e-6)
    # Gaps, each labelled at its midpoint: [100, 110) in nothing, [150,
    # 170) in train.wait_input and the runtime call, [180, 200) in
    # train.dispatch.
    gaps = dict((k, v) for k, v in red["idle_gaps"])
    assert gaps["between spans / python"] == pytest.approx(10e-6)
    assert gaps["train.wait_input / cudaEventSynchronize"] == pytest.approx(
        20e-6)
    assert gaps["train.dispatch / python"] == pytest.approx(20e-6)
    ops = dict((k, v) for k, v in red["device_ops"])
    assert ops["Memcpy HtoD"] == pytest.approx(30e-6)
    ks = trace.kernel_seconds(got, counts.KERNELS, red["lo"], red["hi"])
    assert ks["k1_kernel"] == pytest.approx(20e-6)
    assert ks["k2_kernel"] == pytest.approx(10e-6)


def test_counts_by_hand():
    b, f, d, u = 2, 3, 9, 4
    n = b * f
    nbytes, ops = counts.kernel_work(b, f, d, u)
    assert nbytes == 4 * (n + n + (u + 1) + u) + 16 * u * d
    k = d - 1
    assert ops == (n * (4 * k + 2) + b * (3 * k + 2) + n * (3 * k + 2)
                   + 3 * n * d + 6 * u * d)
    sbytes, sops = counts.step_work(b, f, d, u)
    assert sbytes == nbytes + 4 * (n + 2 * b - u)
    assert sops == ops + 8 * b + 2 * n * d + 8
    t, which = counts.bound(3.35e12, 1.0)
    assert (t, which) == (pytest.approx(1.0), "bytes")
    t, which = counts.bound(1.0, 67e12 * 2)
    assert (t, which) == (pytest.approx(2.0), "operations")


def test_leaf_gap_takes_the_worst_leaf_against_the_median():
    ref = {"w0": 0.01, "table": 10.0}
    # The median leaf is 5.005: w0's gap of 0.005 reads 0.005 / 5.005.
    got = check.leaf_gap({"w0": 0.015, "table": 10.0}, ref)
    assert got == pytest.approx(0.005 / 5.005)
    got = check.leaf_gap({"w0": 0.01, "table": 11.0}, ref)
    assert got == pytest.approx(0.1)
    assert check.leaf_gap({"w0": 0.0, "table": 0.0}, ref, ["table"]) == 1.0


def test_the_harness_loads_no_jax_and_the_reference_no_port():
    code = (
        "import sys\n"
        "import portbench.reference.fm, portbench.check, portbench.gen, "
        "portbench.counts, portbench.trace\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('fast_tffm_tpu_torch', 'fast_tffm_tpu', 'jax', 'jaxlib', "
        "'flax')], 'the reference loaded the port or JAX'\n"
        "import portbench.run, portbench.spread\n"
        "import importlib, os\n"
        "for f in os.listdir('portbench/metrics'):\n"
        "    if f.endswith('.py'):\n"
        "        importlib.import_module('portbench.metrics.' + f[:-3])\n"
        "import fast_tffm_tpu_torch.train.loop\n"
        "print(portbench.run.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    done = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"
