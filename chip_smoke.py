#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fast_tffm_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py           # one GPU: every phase below
    python3 chip_smoke.py --nccl    # >= 4 GPUs: phases 1-3 and 9 only,
                                    # one rank per GPU over NCCL

Phases, in order; any failed check ends the run with a non-zero exit:

1. Print the card's name and power limit (``nvidia-smi``).
2. Build every CUDA kernel from ``fast_tffm_tpu_torch/ops/csrc`` with
   ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, in parallel) and
   time the build.
3. Data: write seeded synthetic labelled Criteo-shaped lines (13
   ``I<j>_<bucket>`` and 26 ``C<j>_<hex>`` tokens, hashed by the parser;
   labels planted from a fixed rule on the integer buckets) for
   training (16 batches of 4096), validation and predict.
4. Kernel phase: every kernel against its plain PyTorch version on the
   card — ``fm_scores`` at the serving rungs and at a parsed training
   batch (B = 4096: train step, validation, predict), ``fm_grad`` at B in
   {1, 1000, 4096}, both again in their bf16-input mode (FmScorer at the
   rungs 64/256/1024 and the parsed batch, FmGrad bitwise), K1 and K2
   (adagrad, ftrl, sgd) at the training shapes of a parsed batch and with one id of >= 5000 occurrences (K1
   also at the probe's stream), K-place at the sharded path's shapes
   (``vocab_local = 2^21``, ``row_lo = 2^21``, a parsed local batch of
   2048 lines with sentinel ids) and K1's merge mode on two data blocks'
   entry streams (both exact: ``max_abs_err`` 0) — then kernel, plain
   and library call timed in CUDA graphs at the main paths' shapes (the
   bf16 modes at the training batch, with the bf16 step's three casts),
   and K1 at its hot and probe streams too; beside them the launch floor,
   a one-element in-place PyTorch op timed the same way.
5. Train phase (main path 1): ``Trainer(cfg).train()`` on
   ``examples/criteo_kaggle.cfg`` at full width (V = 2^22, F = 39,
   D = 9, B = 4096, Adagrad, batch L2, host sort meta), 16 steps, then
   validation on one file and ``predict``.  Checks: at least one launch
   per step of ``fm_grad``, ``k1_dedup`` and ``k2_apply``; the logloss
   of the last steps below the first step's; one finite probability per
   predict line.
6. bf16 train phase (main path 1 with ``compute_dtype = bfloat16``):
   the same config on one train file, 8 steps in f32 and then 8 in
   bf16 from the same initial table on the same batches, the bf16 run
   validated (in f32).  Checks: every step launched the bf16 FmScorer
   and FmGrad, K1 and K2, and no f32 FmGrad; the last step's logloss
   within 1e-2 of the f32 run's (the reference's
   ``tests/test_bf16.py::TestTrainingParity`` check); an f32
   ``params.npz``.
7. Parity phase, f32 and bf16 compute: 3 steps through the kernels vs
   3 through the plain path from the same initial weights: each step's
   scores (``rtol=1e-5, atol=1e-5``), the tables (``rtol=1e-4,
   atol=1e-6`` table, ``atol=1e-4`` accumulator) and what the steps
   changed in each (``delta_check``); and host sort meta vs device sort
   meta (bitwise, f32).  Then an f32 and a bf16 step, timed in turns:
   each one's p50 (host clock, synchronised), device time by op and
   idle share from ``torch.profiler``, and the peak memory.
8. Serve phase (main path 2): serve the checkpoint the train phase
   wrote over ``/score`` and ``/score_bin``, every rung plus one request
   larger than the largest; the two transports agree bitwise, scores
   match the plain path on the card, out-of-range ids reduce like the
   text path, the kernel ran.  Request latency and dispatch per rung.
9. Sharded phase (main path 3): four ranks of a 2 x 2 (data x model)
   mesh, ``lookup = shardmap``, each a process of this script
   (``--sharded-rank``) sharing the card over gloo (or one GPU each over
   NCCL with ``--nccl``), train 8 global batches of the line stream
   (``fast_ingest = false``, whose order does not depend on the local
   batch size) through
   ``Trainer.train()`` twice: ``sparse_exchange = dense`` (K-place
   every step on every rank) and ``auto`` (must resolve to ``entries``:
   K1's merge mode every step, no K-place).  Checks: every rank reports
   the same global metrics; the table rank 0 saves matches a
   single-device run over the same global batches (table, accumulator,
   w0, ``delta_check``).  Each rank's step p50 and the share of it
   spent in the step's collectives (host clock, synchronised around
   each collective, staging copies included).
10. Probe phase (path 4, the table-layout probe): K2T (transposed
   ``[9, V]`` table) and K2P (packed ``[V/8, 128]``) against their plain
   versions on the card (``TABLE_TOL``, ``OPT_TOL``, ``delta_check``),
   bitwise against K2's elements on the same stream, untouched rows and
   pad slots as they were, at a training batch's K1 stream and at the
   probe's (638,976 uniform ids), each with one id of 5000 occurrences;
   K2, K2T and K2P timed in CUDA graphs at both; then
   ``fast_tffm_tpu_torch.tools.micro_probe.main`` at full size (its own
   parity checks raise), whose run gives K2T's and K2P's launches.

Output: progress lines and JSON records, then a ``{"kernels": [...]}``
JSON line, the ``nvidia-smi`` line, and last ``{"ok": true, "device":
{...}}``.  Exits non-zero, printing no result, without a CUDA GPU or
without the package beside this script.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CFG_PATH = os.path.join(REPO, "examples", "criteo_kaggle.cfg")
SEED = 20261016
# NVIDIA H100 SXM data sheet peaks (at the full 700 W power limit):
# HBM3 bandwidth and the non-tensor-core float32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Kernel vs plain: both accumulate in f32 and differ only in summation
# order and FMA contraction; at these inputs (|rows| ~ 0.3, 39 features)
# that is a few f32 ulps of |s1^2| and |s2| (~3), i.e. below 1e-5.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# K1 is held to its plain version run in float64 within the error its
# order of summation allows (sparse_apply.k1_error_bound); the float32
# plain version sums with atomics in an order that changes from run to
# run.  Sparse apply and training steps, kernels vs plain: the
# reference's tile-vs-scatter bounds (tests/test_sparse_apply.py).
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-4, atol=1e-4)
# A step changes a weight by ~1e-6 and an accumulator by ~1e-8, far
# inside those bounds, so the parity steps also hold the changes
# themselves to each other (delta_check).
DELTA_RTOL = 1e-3
# Served scores vs the plain path on the card: the repo's FmScorer
# tolerance (tests/test_pallas_ops.py); the sigmoid only shrinks errors.
SERVE_TOL = dict(rtol=1e-5, atol=1e-6)
# Train phase: 16 steps of 4096 lines in two files, one validation and
# one predict file of 4096 lines each.
TRAIN_FILES, BATCHES_PER_FILE, LINES = 2, 8, 4096
INT_BUCKETS = 50
# Sharded phase: the mesh, its ranks' deadline, and the K-place check's
# shard (the upper half of the Criteo-Kaggle table).
SHARDED_MESH = (2, 2)
RANK_TIMEOUT_S = 300
KPLACE_ROW_LO = KPLACE_VOCAB_LOCAL = 1 << 21
# Probe phase: the micro-probe's id count (16384 x 39 uniform ids), and
# the occurrences of the one hot id added to each K2T/K2P check's ids.
PROBE_N = 16384 * 39
HOT_OCCURRENCES = 5000


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0].strip()


def p50(xs) -> float:
    xs = sorted(xs)
    return xs[(len(xs) - 1) // 2]


def graph_ms(torch, fn, calls: int = 100, reps: int = 7) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    the graph replayed between CUDA events, the median of ``reps``
    replays over ``calls``.  The replay issues the launches itself, so
    the Python host cost of a call is out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return p50(times)


def time_per_call_ms(torch, fn, iters: int = 200, warm: int = 20) -> float:
    """CUDA-event time per call over a loop of eager calls (device
    timeline, so it includes whatever host issue time the loop cannot
    hide)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_times_ms(torch, fn, iters: int = 50):
    """Per-call device time by op from torch.profiler over ``iters``
    calls, the host wall per call, and the host (CPU) self time per call
    of the ten costliest host ops: ``({name: ms}, wall_ms, {name: ms})``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out, host = {}, {}
    for ev in prof.key_averages():
        cpu_us = getattr(ev, "self_cpu_time_total", 0.0)
        if cpu_us > 0:
            host[ev.key[:60]] = cpu_us / 1e3 / iters
        # Device-side activities only (kernels, copies): a host range
        # (an aten:: op, an autograd Function) reports the kernels it
        # launched again as its own device time.
        if ev.device_type == DeviceType.CPU or "Activity Buffer" in ev.key:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and dev_us > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].strip()[:60]
            out[name] = out.get(name, 0.0) + dev_us / 1e3 / iters
    top = dict(sorted(host.items(), key=lambda kv: -kv[1])[:10])
    return out, wall * 1e3 / iters, top


def bound(nbytes: float, ops: float):
    """``(ms, "bytes" | "operations")``: the larger of the bytes over
    HBM bandwidth and the f32 operations over the f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fm_bound_ms(b: int, f: int, d: int, elt: int = 4):
    """FmScorer forward: rows and vals read (``elt`` bytes an element:
    4 in f32, 2 in bf16), f32 scores and s1 written."""
    k = d - 1
    return bound(elt * (b * f * d + b * f) + 4 * (b + b * k),
                 b * (f * (2 + 4 * k) + 3 * k + 2))


def fm_grad_bound_ms(b: int, f: int, d: int, elt: int = 4):
    """FmGrad: rows, vals (``elt`` bytes an element), f32 s1 and dscores
    read; drows written in the rows' type.  Per (b, f): g*x, then per
    factor v*x, a subtraction and a product."""
    k = d - 1
    return bound(elt * (2 * b * f * d + b * f) + 4 * (b * k + b),
                 b * f * (1 + 3 * k))


def cast_bound_ms(n: int, elt_in: int, elt_out: int):
    """An elementwise cast of ``n`` elements: read once, written once."""
    return bound(n * (elt_in + elt_out), 0)


def k1_bound_ms(n: int, u: int, d: int):
    """K1: g_rows and perm read, ids once per unique id (at its
    segment's first occurrence), seg_start read; urows and sums written.
    Per occurrence and column: g, g*g, two adds."""
    return bound(4 * (n * d + n + u + (u + 1) + u + 2 * d * u), 3 * n * d)


def delta_check(torch, name: str, kern, plain, start) -> dict:
    """Holds what the parity steps changed in one table, kernel path vs
    plain path, both from ``start``.  Per element the two changes agree
    within ``DELTA_RTOL`` of the plain change plus two roundings of the
    stored float32 value (``2^-23`` of it each: the paths may round
    nearly equal sums to neighbouring floats); over the table the norm
    of the difference is within ``DELTA_RTOL`` of the plain change's
    norm, which a table the kernel never wrote fails (error 1)."""
    dk = kern.detach().double() - start.double()
    dp = plain.detach().double() - start.double()
    diff = (dk - dp).abs()
    ulp = 2.0**-23 * torch.maximum(kern.detach().abs(),
                                   plain.detach().abs()).double()
    check(bool(torch.all(diff <= DELTA_RTOL * dp.abs() + 2 * ulp)),
          f"{name}: kernel and plain steps changed it differently, max "
          f"|diff| {float(diff.max()):.3e}")
    norm = float(torch.linalg.vector_norm(dp))
    check(norm > 0, f"{name}: the plain steps left it unchanged")
    rel = float(torch.linalg.vector_norm(dk - dp)) / norm
    check(rel <= DELTA_RTOL, f"{name}: change differs by {rel:.3e} of its "
          f"norm")
    return {"changed": int((dp != 0).sum()), "max_abs_change":
            float(dp.abs().max()), "change_max_abs_err": float(diff.max()),
            "change_rel_err": rel}


def k1_merge_bound_ms(n: int, u: int, p: int):
    """K1 merge mode over the ``n`` real entries (the sentinel's padding
    is never read): their payload and perm read, ids once per unique
    row, seg_start read; urows and sums written.  One add per entry and
    column."""
    return bound(4 * (n * p + n + u + (u + 1) + u + p * u), n * p)


def kplace_bound_ms(u: int, w: int, vocab_local: int):
    """K-place: the ``u`` entries inside the shard read once (the
    others are never read: a block finds its own by binary search), the
    dense delta written once; no arithmetic."""
    return bound(4 * (u * (w + 1) + vocab_local * w), 0)


def k2_bound_ms(u: int, d: int):
    """K2 Adagrad: the entry stream (urows, sums) read; table and
    accumulator read and written at the U touched rows.  Per element:
    two adds, a reciprocal square root, two products, a subtraction."""
    return bound(4 * (u + 2 * d * u + 4 * d * u), 6 * u * d)


def k2_sector_ms(u: int, d: int, size: int = 32) -> float:
    """K2 Adagrad counted in ``size``-byte units of device memory, at HBM
    bandwidth: each row of the table and of the accumulator read and
    written whole units at a time, the entry stream (urows, sums) as it
    is.  A row of ``d`` floats starts at one of the ``size / 4`` 4-byte
    offsets of a unit (in turn, for odd ``d``) and spans ``ceil((offset +
    4d) / size)`` units: at d = 9 two 32-byte sectors at every offset
    (64 bytes for 36), and 1.5 64-byte units on average."""
    units = sum(-(-(o + 4 * d) // size) for o in range(0, size, 4)) / (
        size // 4)
    nbytes = 4 * size * units * u + 4 * (u + 2 * d * u)
    return nbytes / PEAK_BYTES_PER_S * 1e3


# -- synthetic data ----------------------------------------------------


def criteo_body(rng, n: int) -> str:
    """``n`` label-less libsvm lines shaped like hashed Criteo-Kaggle
    rows: 13 integer features ``I<j>_<bucket>:<value>`` and 26
    categorical ``C<j>_<hex>:1`` tokens (39 features per line)."""
    lines = []
    for _ in range(n):
        ints = rng.integers(0, INT_BUCKETS, 13)
        ivals = rng.uniform(0.0, 3.0, 13)
        cats = rng.integers(0, 1 << 32, 26)
        toks = [f"I{j + 1}_{ints[j]}:{ivals[j]:.4f}" for j in range(13)]
        toks += [f"C{j + 1}_{cats[j]:08x}:1" for j in range(26)]
        lines.append(" ".join(toks))
    return "\n".join(lines) + "\n"


def write_labelled(np, path: str, rng, n: int, w_true) -> None:
    """``n`` labelled Criteo-shaped lines.  The label is planted:
    ``P(y = 1) = sigmoid(sum_j w_true[j, bucket_j])`` over the 13
    integer features, so a model that learns the bucket weights lowers
    the logloss; the 26 categorical tokens are noise."""
    ints = rng.integers(0, INT_BUCKETS, (n, 13))
    ivals = rng.uniform(0.5, 1.5, (n, 13))
    cats = rng.integers(0, 1 << 32, (n, 26))
    score = w_true[np.arange(13), ints].sum(axis=1)
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-score))).astype(int)
    with open(path, "w") as f:
        for i in range(n):
            toks = [f"I{j + 1}_{ints[i, j]}:{ivals[i, j]:.4f}"
                    for j in range(13)]
            toks += [f"C{j + 1}_{cats[i, j]:08x}:1" for j in range(26)]
            f.write(f"{labels[i]} {' '.join(toks)}\n")


def post(conn, path: str, body: bytes) -> bytes:
    conn.request("POST", path, body=body,
                 headers={"Content-Length": str(len(body))})
    resp = conn.getresponse()
    data = resp.read()
    check(resp.status == 200, f"{path} answered {resp.status}: {data[:200]!r}")
    return data


# -- sharded phase (main path 3) -----------------------------------------


def rank_main(argv) -> int:
    """One rank of the sharded phase:
    ``chip_smoke.py --sharded-rank RANK WORLD INIT_URL SPEC OUT``.
    Joins the rank group, trains through ``Trainer.train()`` with the
    spec's config overrides and writes its record to OUT."""
    rank, world, url, spec_path, out_path = (int(argv[0]), int(argv[1]),
                                             argv[2], argv[3], argv[4])
    import torch

    sys.path.insert(0, REPO)
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.ops import fm_kernels, sparse_apply
    from fast_tffm_tpu_torch.tools import micro_probe
    from fast_tffm_tpu_torch.train import dist, shardmap_step
    from fast_tffm_tpu_torch.train.loop import Trainer

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format=f"%(asctime)s rank{rank} %(name)s %(message)s")
    with open(spec_path) as f:
        spec = json.load(f)
    dev = dist.initialize(url, world, rank)
    try:
        cfg = load_config(CFG_PATH, spec["overrides"])

        coll_s = [0.0]

        def timed(collective):
            """``collective`` timed on the host clock, synchronised on
            both sides (the smoke's measurement only)."""
            def call(t, axis, mesh):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = collective(t, axis, mesh)
                torch.cuda.synchronize()
                coll_s[0] += time.perf_counter() - t0
                return out
            return call

        # Every collective of a train step is the sharded step's.
        shardmap_step.psum = timed(shardmap_step.psum)
        shardmap_step.all_gather = timed(shardmap_step.all_gather)

        class TimedTrainer(Trainer):
            """Times each step (synchronised) and its collectives."""

            def __init__(self, *args, **kwargs):
                self.step_s, self.coll_s = [], []
                super().__init__(*args, **kwargs)

            def train_step(self, batch):
                c0 = coll_s[0]
                t0 = time.perf_counter()
                loss = super().train_step(batch)
                torch.cuda.synchronize()
                self.step_s.append(time.perf_counter() - t0)
                self.coll_s.append(coll_s[0] - c0)
                return loss

        trainer = TimedTrainer(cfg, device=dev)
        kernels = kernel_fns(fm_kernels, sparse_apply, micro_probe)
        torch.cuda.reset_peak_memory_stats()
        zero_launches(kernels)
        t0 = time.perf_counter()
        result = trainer.train()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        mesh = trainer.mesh
        steps = trainer.step_s[1:]  # the first step warms up
        record = {
            "rank": rank, "coords": list(mesh.coords), "device": str(dev),
            "backend": mesh.backend,
            "exchange": shardmap_step.exchange_mode(
                cfg, mesh, cfg.batch_size // mesh.data * cfg.max_features),
            "launches": launches, "train": result["train"],
            "validation": result["validation"],
            "step_p50_ms": p50(steps) * 1e3,
            "collective_share": sum(trainer.coll_s[1:]) / sum(steps),
            "step_ms": [x * 1e3 for x in trainer.step_s],
            "train_wall_s": wall,
            "peak_device_mb": torch.cuda.max_memory_allocated() / 2**20,
        }
        with open(out_path, "w") as f:
            json.dump(record, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def kernel_fns(fm_kernels, sparse_apply, micro_probe) -> dict:
    """Every kernel of the port by name: its wrapper and the wrapper's
    attribute that counts its launches (FmScorer's and FmGrad's wrappers
    count their f32 and bf16 modes apart)."""
    return {
        "fm_scores": (fm_kernels.fm_scores_cuda, "launches"),
        "fm_grad": (fm_kernels.fm_grad_cuda, "launches"),
        "fm_scores_bf16": (fm_kernels.fm_scores_cuda, "launches_bf16"),
        "fm_grad_bf16": (fm_kernels.fm_grad_cuda, "launches_bf16"),
        "k1_dedup": (sparse_apply.k1_dedup_cuda, "launches"),
        "k1_merge": (sparse_apply.k1_merge_cuda, "launches"),
        "k2_apply": (sparse_apply.k2_apply_cuda, "launches"),
        "kplace": (sparse_apply.kplace_cuda, "launches"),
        "k2t_apply": (micro_probe.k2t_apply, "launches"),
        "k2p_apply": (micro_probe.k2p_apply, "launches"),
    }


def zero_launches(kernels: dict) -> None:
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)


def read_launches(kernels: dict) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in kernels.items()}


def spawn_ranks(tmp: str, tag: str, overrides: dict, world: int,
                one_card: bool) -> list:
    """Run ``world`` ranks of this script with the config ``overrides``
    and return their records.  ``one_card`` shows every rank only the
    first visible GPU (so they share it).  A rank that fails, or the
    deadline, ends the smoke; every rank is stopped either way."""
    spec = os.path.join(tmp, f"{tag}.json")
    with open(spec, "w") as f:
        json.dump({"overrides": overrides}, f)
    env = dict(os.environ)
    if one_card:
        visible = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        env["CUDA_VISIBLE_DEVICES"] = visible or "0"
    url = f"file://{tmp}/{tag}.rendezvous"
    outs = [os.path.join(tmp, f"{tag}.rank{r}.json") for r in range(world)]
    logs = [open(os.path.join(tmp, f"{tag}.rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank",
         str(r), str(world), url, spec, outs[r]],
        cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT,
    ) for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            time.sleep(0.1)
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = bad[0]
            elif time.monotonic() > deadline:
                failed = "deadline"
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed is None and bad:
            failed = bad[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        tails = []
        for r, log in enumerate(logs):
            log.seek(0)
            tails.append(log.read()[-4000:])
            log.close()
    if failed is not None:
        which = (f"rank {failed} exited {procs[failed].returncode}"
                 if failed != "deadline"
                 else f"ranks still running after {RANK_TIMEOUT_S} s")
        r = failed if failed != "deadline" else 0
        print(f"chip_smoke: sharded {tag}: {which}; its log:\n{tails[r]}",
              file=sys.stderr)
        check(False, f"sharded run {tag}: {which}")
    records = []
    for path in outs:
        with open(path) as f:
            records.append(json.load(f))
    return records


def sharded_phase(np, torch, tmp: str, card: str, train_file: str,
                  valid_file: str, one_card: bool):
    """Main path 3: the 2 x 2 mesh's dense and auto (entries) runs
    against a single-device run over the same global batches.  Returns
    the phase's record and the launches of each kernel summed over the
    ranks of both runs."""
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.train.loop import Trainer

    dev = torch.device("cuda")
    # The line stream (fast_ingest off): its order does not depend on
    # the batch size, so the data blocks' local batches make up the
    # single device's global ones.  The raw-window stream cuts its
    # windows at whole local batches, as the reference's does.
    base = {"train_files": [train_file], "validation_files": [valid_file],
            "seed": SEED, "log_steps": 4, "serve_poll_secs": 0.0,
            "serve_port": 0, "fast_ingest": False}
    ref_dir = os.path.join(tmp, "sharded_ref")
    t0 = time.perf_counter()
    ref = Trainer(load_config(CFG_PATH, dict(base, model_file=ref_dir))
                  ).train()
    ref_s = time.perf_counter() - t0
    steps = ref["train"]["steps"]
    rcfg = load_config(CFG_PATH, base)
    init = fm.init_params(rcfg, torch.Generator(device=dev).manual_seed(SEED),
                          device=dev).table.detach()

    def load(path):
        with np.load(os.path.join(path, "params.npz")) as z:
            return {k: torch.from_numpy(z[k]).to(dev) for k in z.files}

    want = load(ref_dir)
    world = SHARDED_MESH[0] * SHARDED_MESH[1]
    runs, launches = {}, {}
    for exchange in ("dense", "auto"):
        model_dir = os.path.join(tmp, f"sharded_{exchange}")
        t0 = time.perf_counter()
        recs = spawn_ranks(tmp, f"sharded_{exchange}", dict(
            base, model_file=model_dir, mesh_data=SHARDED_MESH[0],
            mesh_model=SHARDED_MESH[1], lookup="shardmap",
            sparse_exchange=exchange,
        ), world, one_card)
        wall = time.perf_counter() - t0
        r0 = recs[0]
        for rec in recs:
            check(rec["train"]["steps"] == steps,
                  f"{exchange}: rank {rec['rank']} ran "
                  f"{rec['train']['steps']} steps, the single device {steps}")
            for part in ("train", "validation"):
                for m in ("loss", "auc", "examples"):
                    a, b = rec[part][m], r0[part][m]
                    check(abs(a - b) <= 1e-6 * abs(b),
                          f"{exchange}: rank {rec['rank']} {part} {m} {a} "
                          f"!= rank 0's {b}")
            got = rec["launches"]
            if exchange == "dense":
                check(rec["exchange"] == "dense" and got["kplace"] >= steps,
                      f"dense: rank {rec['rank']} launched K-place "
                      f"{got['kplace']} times in {steps} steps")
            else:
                check(rec["exchange"] == "entries",
                      f"auto resolved to {rec['exchange']}, not entries")
                check(got["k1_merge"] >= steps and got["kplace"] == 0,
                      f"entries: rank {rec['rank']} launched K1 merge "
                      f"{got['k1_merge']} and K-place {got['kplace']} times")
            check(got["fm_grad"] >= steps and got["k1_dedup"] >= steps
                  and (exchange == "dense" or got["k2_apply"] >= steps),
                  f"{exchange}: rank {rec['rank']} launches {got}")
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
        have = load(model_dir)
        check(set(have) == set(want), f"{exchange}: checkpoint keys")
        torch.testing.assert_close(have["params/table"], want["params/table"],
                                   **TABLE_TOL)
        torch.testing.assert_close(have["opt/acc_table"],
                                   want["opt/acc_table"], **OPT_TOL)
        torch.testing.assert_close(have["scalar/w0"], want["scalar/w0"],
                                   rtol=1e-5, atol=1e-7)
        changes = {
            "table": delta_check(torch, f"{exchange} table",
                                 have["params/table"], want["params/table"],
                                 init),
            "acc_table": delta_check(
                torch, f"{exchange} acc_table", have["opt/acc_table"],
                want["opt/acc_table"],
                torch.full_like(init, rcfg.adagrad_initial_accumulator)),
        }
        runs[exchange] = {
            "wall_s": wall, "resolved": r0["exchange"],
            "backend": r0["backend"],
            "table_max_abs_err": float(
                (have["params/table"] - want["params/table"]).abs().max()),
            "acc_max_abs_err": float(
                (have["opt/acc_table"] - want["opt/acc_table"]).abs().max()),
            "changes": changes,
            "train_logloss": r0["train"]["logloss"],
            "validation_logloss": r0["validation"]["logloss"],
            "validation_auc": r0["validation"]["auc"],
            "ranks": [{k: rec[k] for k in (
                "rank", "coords", "device", "launches", "step_p50_ms",
                "collective_share", "train_wall_s", "peak_device_mb")}
                for rec in recs],
        }
        del have
    transport = (
        f"gloo through pinned host memory, {world} ranks sharing one card "
        f"(not NCCL)" if one_card else f"one rank per GPU, {r0['backend']}"
    )
    record = {"sharded": {
        "card": card, "mesh": list(SHARDED_MESH), "steps": steps,
        "global_batch": rcfg.batch_size, "transport": transport,
        "single_device": {"wall_s": ref_s,
                          "train_logloss": ref["train"]["logloss"],
                          "validation_logloss": ref["validation"]["logloss"],
                          "validation_auc": ref["validation"]["auc"]},
        **runs,
    }}
    return record, launches


def probe_phase(torch, card: str, gen, table0, hot_ids, hyper, err: dict,
                kernels: dict):
    """Path 4, the table-layout probe.  K2T and K2P against their plain
    versions and against K2's elements, at a training batch's K1 stream
    (``hot_ids``) and at the probe's, each with one hot id; K2, K2T and
    K2P timed in CUDA graphs at both; then ``micro_probe.main`` at full
    size with every launch count set to 0 just before.  Returns the
    phase's record, K2T's and K2P's kernel timing at the probe's stream
    and the launches of every kernel in ``main``."""
    from fast_tffm_tpu_torch.ops.sparse_apply import (
        k1_dedup_cuda, k2_apply_cuda, sort_meta,
    )
    from fast_tffm_tpu_torch.tools import micro_probe

    dev = table0.device
    v, d = table0.shape
    lr, eps = hyper.lr, hyper.eps
    acc0 = torch.empty_like(table0).uniform_(0.1, 1.0, generator=gen)
    probe_ids = torch.randint(0, v, (PROBE_N,), generator=gen, device=dev,
                              dtype=torch.int32)
    probe_ids[:HOT_OCCURRENCES] = 54321
    layouts = {  # layout -> (tables in it, their [V, D] view)
        "k2t": (lambda t: t.t().contiguous(), torch.t),
        "k2p": (lambda t: micro_probe.pack_table(t, d),
                lambda t: micro_probe.unpack_table(t, d)),
    }
    streams, checks = {}, {}
    for shape, ids in (("batch", hot_ids), ("probe", probe_ids)):
        ids = ids.to(torch.int32).contiguous()
        g = torch.randn((ids.numel(), d), generator=gen, device=dev) * 0.1
        meta = sort_meta(ids)
        urows, sums = k1_dedup_cuda(g, ids, meta.perm, meta.seg_start)
        streams[shape] = (urows, sums)
        row_major = (table0.clone(), acc0.clone())
        k2_apply_cuda("adagrad", urows, sums, row_major, hyper)
        untouched = torch.ones(v, dtype=torch.bool, device=dev)
        untouched[urows.long()] = False
        for layout, (to_layout, rows) in layouts.items():
            entries = getattr(micro_probe, f"{layout}_entries")
            start = (to_layout(table0), to_layout(acc0))
            kern = tuple(t.clone() for t in start)
            plain = tuple(t.clone() for t in start)
            entries(urows, sums, *kern, lr=lr, eps=eps)
            entries(urows, sums, *plain, lr=lr, eps=eps, plain=True)
            torch.cuda.synchronize()
            what = f"{layout} ({shape})"
            torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
            torch.testing.assert_close(kern[1], plain[1], **OPT_TOL)
            changes = {
                tab: delta_check(torch, f"{what} {tab}", rows(k), rows(p),
                                 rows(s0))
                for tab, k, p, s0 in zip(("table", "acc"), kern, plain, start)
            }
            for k, s0, want in zip(kern, start, row_major):
                check(torch.equal(rows(k)[untouched], rows(s0)[untouched]),
                      f"{what} changed an untouched row")
                check(torch.equal(rows(k), want),
                      f"{what} differs from K2's elements on the same stream")
                if layout == "k2p":
                    check(torch.equal(k.view(-1, 16)[:, d:],
                                      s0.view(-1, 16)[:, d:]),
                          f"{what} wrote a pad slot")
            diff = max(float((a - b).abs().max()) for a, b in zip(kern, plain))
            err[f"{layout}_apply"] = max(err.get(f"{layout}_apply", 0.0), diff)
            checks[f"{layout}_{shape}"] = {
                "unique_rows": urows.numel(), "max_abs_err": diff,
                "changes": changes,
            }
            del start, kern, plain
        del row_major

    # K2, K2T and K2P on each stream in CUDA graphs; in turns (K2 first
    # and last, each layout plain, kernel, kernel, plain).
    graphs = {}
    for shape, (urows, sums) in streams.items():
        k2_tabs = (table0.clone(), acc0.clone())

        def k2():
            k2_apply_cuda("adagrad", urows, sums, k2_tabs, hyper)

        entry = {"unique_rows": urows.numel(),
                 "k2_graph_ms": [graph_ms(torch, k2)]}
        for layout, (to_layout, _) in layouts.items():
            tabs = (to_layout(table0), to_layout(acc0))
            fn = getattr(micro_probe, f"{layout}_entries")
            pa, ka, kb, pb = (
                graph_ms(torch, lambda p=p: fn(urows, sums, *tabs, lr=lr,
                                               eps=eps, plain=p))
                for p in (True, False, False, True)
            )
            entry[layout] = {"graph_ms": [ka, kb], "plain_graph_ms": [pa, pb]}
            del tabs
        entry["k2_graph_ms"].append(graph_ms(torch, k2))
        entry["bound_ms"], entry["bound_by"] = k2_bound_ms(urows.numel(), d)
        entry["sector_ms"] = k2_sector_ms(urows.numel(), d)
        entry["granule64_ms"] = k2_sector_ms(urows.numel(), d, 64)
        graphs[shape] = entry
        del k2_tabs
    probe = graphs["probe"]
    timing = {f"{layout}_apply": {
        "ms": min(probe[layout]["graph_ms"]),
        "plain_ms": min(probe[layout]["plain_graph_ms"]),
        "bound_ms": probe["bound_ms"], "bound_by": probe["bound_by"],
        "library_ms": None,
    } for layout in layouts}
    del streams, acc0, probe_ids
    torch.cuda.empty_cache()

    # The path: the probe at full size, its counts from 0.
    zero_launches(kernels)
    t0 = time.perf_counter()
    rc = micro_probe.main([])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = read_launches(kernels)
    check(rc == 0, f"micro_probe.main returned {rc}")
    for name in ("k2t_apply", "k2p_apply", "k1_dedup", "k2_apply"):
        check(launches[name] >= 1, f"the probe never launched {name}")
    record = {"probe": {"card": card, "checks": checks, "graphs": graphs,
                        "main_wall_s": main_s, "main_launches": launches}}
    return record, timing, launches


def nccl_main() -> int:
    """``--nccl``: the sharded phase alone, one rank per GPU (needs at
    least four), so the backend rule picks NCCL."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible to PyTorch", file=sys.stderr)
        return 2
    world = SHARDED_MESH[0] * SHARDED_MESH[1]
    check(torch.cuda.device_count() >= world,
          f"--nccl needs {world} GPUs, have {torch.cuda.device_count()}")
    sys.path.insert(0, REPO)
    from fast_tffm_tpu_torch.ops import _build

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    card = card_line()
    t_start = time.perf_counter()
    _build.build(force=True)
    rng = np.random.default_rng(SEED)
    w_true = rng.normal(0.0, 0.6, (13, INT_BUCKETS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train_file = os.path.join(tmp, "train_0.libsvm")
        valid_file = os.path.join(tmp, "valid.libsvm")
        write_labelled(np, train_file, rng, BATCHES_PER_FILE * LINES, w_true)
        write_labelled(np, valid_file, rng, LINES, w_true)
        record, _ = sharded_phase(np, torch, tmp, card, train_file,
                                  valid_file, one_card=False)
    print(json.dumps(record), flush=True)
    print(json.dumps({"smoke_wall_s": time.perf_counter() - t_start}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible to PyTorch; this smoke "
              "runs only on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.libsvm import (
        host_sort_meta, make_batch, parse_lines,
    )
    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.ops import _build, fm_kernels, sparse_apply
    from fast_tffm_tpu_torch.ops.fm_kernels import (
        fm_grad_cuda, fm_grad_plain, fm_scores_cuda, fm_scores_plain,
    )
    from fast_tffm_tpu_torch.ops.sparse_apply import (
        k1_dedup_cuda, k1_dedup_plain, k1_error_bound, k1_merge_cuda,
        k1_merge_plain, k2_apply_cuda, k2_apply_plain, kplace_cuda,
        kplace_plain,
    )
    from fast_tffm_tpu_torch.serve import wire
    from fast_tffm_tpu_torch.serve.server import serve
    from fast_tffm_tpu_torch.serve.textparse import parse_request
    from fast_tffm_tpu_torch.tools import micro_probe
    from fast_tffm_tpu_torch.train import checkpoint, sparse
    from fast_tffm_tpu_torch.train.loop import Trainer, predict

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t_start = time.perf_counter()
    phase_wall = {}
    phase_t0 = [t_start]

    def phase_end(name: str) -> None:
        now = time.perf_counter()
        phase_wall[name] = now - phase_t0[0]
        phase_t0[0] = now
        print(f"phase {name}: {phase_wall[name]:.1f} s", flush=True)

    # -- build ---------------------------------------------------------
    t0 = time.perf_counter()
    log = _build.build(force=True)
    build_s = time.perf_counter() - t0
    _build.load()
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            print(f"ptxas: {line.strip()}")
    print(f"build: {build_s:.3f} s ({card})", flush=True)

    cfg = load_config(CFG_PATH, {"serve_poll_secs": 0.0, "serve_port": 0})
    F, D, B = cfg.max_features, cfg.embedding_dim, cfg.batch_size
    V = cfg.vocabulary_size
    check((V, F, D, B) == (1 << 22, 39, 9, 4096),
          f"unexpected Criteo-Kaggle shape {V, F, D, B}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    tmp_ctx = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmp_ctx.name
    err = {}  # kernel -> max |kernel - plain| over its checks

    phase_end("build")

    # -- data ----------------------------------------------------------
    t0 = time.perf_counter()
    w_true = rng.normal(0.0, 0.6, (13, INT_BUCKETS))
    train_files = []
    for i in range(TRAIN_FILES):
        path = os.path.join(tmp, f"train_{i}.libsvm")
        write_labelled(np, path, rng, BATCHES_PER_FILE * LINES, w_true)
        train_files.append(path)
    valid_file = os.path.join(tmp, "valid.libsvm")
    predict_file = os.path.join(tmp, "predict.libsvm")
    write_labelled(np, valid_file, rng, LINES, w_true)
    write_labelled(np, predict_file, rng, LINES, w_true)
    with open(train_files[0]) as f:
        head = [next(f) for _ in range(3 * LINES)]
    batches = [
        make_batch(parse_lines(head[i * LINES:(i + 1) * LINES], V,
                               cfg.hash_feature_id), B, F)
        for i in range(3)
    ]
    batches = [b._replace(sort_meta=host_sort_meta(b.ids)) for b in batches]
    print(f"data: {TRAIN_FILES * BATCHES_PER_FILE * LINES} train + "
          f"{2 * LINES} validation/predict lines written, 3 batches parsed "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    phase_end("data")

    # -- kernel phase: fm_scores (serving rungs, training batch) -------
    for b in (1, 64, 256, 1000, 1024, B):
        rows = torch.randn((b, F, D), generator=gen, device=dev) * 0.3
        if b == B:  # train step, validation and predict: a parsed batch
            vals = torch.from_numpy(batches[0].vals).to(dev)
        else:
            vals = torch.rand((b, F), generator=gen, device=dev)
            lens = torch.randint(1, F + 1, (b, 1), generator=gen,
                                 device=dev)
            vals = vals * (torch.arange(F, device=dev)[None, :] < lens)
        s_k, s1_k = fm_scores_cuda(rows, vals)
        s_p, s1_p = fm_scores_plain(rows, vals)
        torch.cuda.synchronize()
        torch.testing.assert_close(s_k, s_p, **KERNEL_TOL)
        torch.testing.assert_close(s1_k, s1_p, **KERNEL_TOL)
        err["fm_scores"] = max(err.get("fm_scores", 0.0),
                               float((s_k - s_p).abs().max()),
                               float((s1_k - s1_p).abs().max()))
    # -- fm_grad at B in {1, 1000, 4096} -------------------------------
    for b in (1, 1000, B):
        rows = torch.randn((b, F, D), generator=gen, device=dev) * 0.3
        vals = torch.rand((b, F), generator=gen, device=dev)
        _, s1 = fm_scores_plain(rows, vals)
        g = torch.randn((b,), generator=gen, device=dev)
        got = fm_grad_cuda(rows, vals, s1, g)
        want = fm_grad_plain(rows, vals, s1, g)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        err["fm_grad"] = max(err.get("fm_grad", 0.0),
                             float((got - want).abs().max()))
    # -- bf16-input mode: fm_scores at the rungs and a parsed training
    # batch, fm_grad bitwise at B in {1, 1000, 4096} -------------------
    bf16 = torch.bfloat16
    for b in (64, 256, 1024, B):
        rows = (torch.randn((b, F, D), generator=gen, device=dev) * 0.3
                ).to(bf16)
        if b == B:  # the bf16 train step's: a parsed batch, rounded
            vals = torch.from_numpy(batches[0].vals).to(dev).to(bf16)
        else:
            lens = torch.randint(1, F + 1, (b, 1), generator=gen,
                                 device=dev)
            vals = (torch.rand((b, F), generator=gen, device=dev)
                    * (torch.arange(F, device=dev)[None, :] < lens)
                    ).to(bf16)
        s_k, s1_k = fm_scores_cuda(rows, vals)
        s_p, s1_p = fm_scores_plain(rows, vals)
        torch.cuda.synchronize()
        torch.testing.assert_close(s_k, s_p, **KERNEL_TOL)
        torch.testing.assert_close(s1_k, s1_p, **KERNEL_TOL)
        err["fm_scores_bf16"] = max(err.get("fm_scores_bf16", 0.0),
                                    float((s_k - s_p).abs().max()),
                                    float((s1_k - s1_p).abs().max()))
    for b in (1, 1000, B):
        rows = (torch.randn((b, F, D), generator=gen, device=dev) * 0.3
                ).to(bf16)
        vals = torch.rand((b, F), generator=gen, device=dev).to(bf16)
        _, s1 = fm_scores_plain(rows, vals)
        g = torch.randn((b,), generator=gen, device=dev)
        got = fm_grad_cuda(rows, vals, s1, g)
        want = fm_grad_plain(rows, vals, s1, g)
        torch.cuda.synchronize()
        check(got.dtype == bf16 and torch.equal(got.view(torch.int16),
                                                want.view(torch.int16)),
              f"bf16 FmGrad differs from its plain version at B = {b}")
        err["fm_grad_bf16"] = max(err.get("fm_grad_bf16", 0.0), float(
            (got.float() - want.float()).abs().max()))
    # -- K1 and K2 at the training shapes ------------------------------
    ids0 = torch.from_numpy(batches[0].ids).to(dev).reshape(-1)
    n = ids0.numel()
    hot = ids0.clone()
    hot[:HOT_OCCURRENCES] = 12345
    g_rows = torch.randn((n, D), generator=gen, device=dev) * 0.1
    meta0 = sparse_apply.sort_meta(ids0)
    # K1's three streams: a parsed batch, the same with one hot id, and
    # the probe's (uniform ids over the table, one hot id).
    probe_ids = torch.randint(0, V, (PROBE_N,), generator=gen, device=dev,
                              dtype=torch.int32)
    probe_ids[:HOT_OCCURRENCES] = 54321
    k1_streams = {
        "batch": (g_rows, ids0.to(torch.int32), meta0),
        "hot": (g_rows, hot.to(torch.int32), sparse_apply.sort_meta(hot)),
        "probe": (torch.randn((PROBE_N, D), generator=gen, device=dev) * 0.1,
                  probe_ids, sparse_apply.sort_meta(probe_ids)),
    }
    k2_shapes = {}
    for name, (g, ids, meta) in k1_streams.items():
        args = (g, ids, meta.perm, meta.seg_start)
        urows, sums = k1_dedup_cuda(*args)
        urows_p, sums_p = k1_dedup_plain(g.double(), *args[1:])
        _, mass = k1_dedup_plain(g.abs().double(), *args[1:])
        torch.cuda.synchronize()
        check(torch.equal(urows, urows_p), f"K1 row ids ({name})")
        diff = (sums.double() - sums_p).abs()
        check(bool(torch.all(diff <= k1_error_bound(meta.seg_start, mass))),
              f"K1 sums vs plain ({name}): max err {float(diff.max()):.3e}")
        err["k1_dedup"] = max(err.get("k1_dedup", 0.0), float(diff.max()))
        if name != "probe":
            k2_shapes[name] = (urows, sums)
        del urows_p, sums_p, mass, diff
    hyper = sparse.hyper(cfg)._replace(l1=0.01, l2=0.1)
    table0 = torch.empty((V, D), device=dev).uniform_(-0.01, 0.01,
                                                      generator=gen)
    for optimizer, extra in (("adagrad", 1), ("ftrl", 2), ("sgd", 0)):
        for name, (urows, sums) in k2_shapes.items():
            state = [torch.empty((V, D), device=dev).uniform_(
                0.1, 1.0, generator=gen) for _ in range(extra)]
            kern = tuple([table0.clone()] + state)
            plain = tuple(t.clone() for t in kern)
            k2_apply_cuda(optimizer, urows, sums, kern, hyper)
            k2_apply_plain(optimizer, urows, sums, plain, hyper)
            torch.cuda.synchronize()
            torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
            for a, b_ in zip(kern[1:], plain[1:]):
                torch.testing.assert_close(a, b_, **OPT_TOL)
            err["k2_apply"] = max(err.get("k2_apply", 0.0), *(
                float((a - b_).abs().max()) for a, b_ in zip(kern, plain)
            ))
            del kern, plain, state
    # -- K-place and K1's merge mode at the sharded path's shapes -----
    # A data block of the 2 x 2 mesh: 2048 parsed lines; the model
    # shard: rows [2^21, 2^22).  Global ids, a tenth of them the
    # sentinel V (off-shard occurrences), and every id below the shard
    # is dropped too.
    b_loc = B // SHARDED_MESH[0]
    ids_loc = torch.from_numpy(batches[0].ids[:b_loc]).to(dev).reshape(-1)
    n_loc = ids_loc.numel()
    ids_kp = ids_loc.clone()
    ids_kp[torch.randperm(n_loc, generator=gen, device=dev)[:n_loc // 10]] = V
    g_kp = torch.randn((n_loc, D), generator=gen, device=dev) * 0.1
    meta_kp = sparse_apply.sort_meta(ids_kp)
    urows_kp, sums_kp = k1_dedup_cuda(g_kp, ids_kp, meta_kp.perm,
                                      meta_kp.seg_start)
    check(int(urows_kp[-1]) == V, "no sentinel among the K-place entries")
    delta_k = kplace_cuda(urows_kp, sums_kp, KPLACE_ROW_LO,
                          KPLACE_VOCAB_LOCAL)
    delta_p = kplace_plain(urows_kp, sums_kp, KPLACE_ROW_LO,
                           KPLACE_VOCAB_LOCAL)
    torch.cuda.synchronize()
    err["kplace"] = float((delta_k - delta_p).abs().max())
    check(err["kplace"] == 0.0 and torch.equal(delta_k, delta_p),
          f"K-place vs plain: max err {err['kplace']:.3e} (a placement "
          f"must be exact)")
    # The entries inside the shard: all K-place must read.
    placed = int(((urows_kp >= KPLACE_ROW_LO) & (
        urows_kp < KPLACE_ROW_LO + KPLACE_VOCAB_LOCAL)).sum())
    del delta_k, delta_p
    # Both data blocks' padded entry streams for that model shard, as
    # the entries exchange gathers them, merged as merge_entries does
    # (the sentinel's padding left out): at most two entries per row.
    cap = sparse_apply.entries_cap(n_loc, KPLACE_VOCAB_LOCAL)
    streams = []
    for blk in range(SHARDED_MESH[0]):
        ids_b = torch.from_numpy(
            batches[0].ids[blk * b_loc:(blk + 1) * b_loc]).to(dev).reshape(-1)
        own = (ids_b >= KPLACE_ROW_LO) & (
            ids_b < KPLACE_ROW_LO + KPLACE_VOCAB_LOCAL)
        lids = torch.where(own, ids_b - KPLACE_ROW_LO, KPLACE_VOCAB_LOCAL)
        g_b = torch.randn((n_loc, D), generator=gen, device=dev) * 0.1
        streams.append(sparse_apply.unique_entries(
            lids, g_b * own[:, None], vocab=KPLACE_VOCAB_LOCAL, cap=cap))
    rows_m = torch.cat([r for r, _, _ in streams])
    pay_m = torch.cat([p for _, p, _ in streams])
    meta_m = sparse_apply.sort_meta(rows_m, drop_from=KPLACE_VOCAB_LOCAL)
    merge_args = (pay_m, rows_m, meta_m.perm, meta_m.seg_start)
    urows_m, sums_m = k1_merge_cuda(*merge_args)
    urows_mp, sums_mp = k1_merge_plain(*merge_args)
    torch.cuda.synchronize()
    check(torch.equal(urows_m, urows_mp), "K1 merge row ids")
    err["k1_merge"] = float((sums_m - sums_mp).abs().max())
    check(err["k1_merge"] == 0.0, f"K1 merge vs plain: max err "
          f"{err['k1_merge']:.3e} (at most two terms per row)")
    print("kernel check: fm_scores, fm_grad (f32 and bf16, bf16 FmGrad "
          "bitwise), k1_dedup, k2_apply (adagrad, ftrl, sgd), kplace, "
          "k1_merge == their plain versions; "
          "max_abs_err " + json.dumps(err), flush=True)

    phase_end("kernel_check")

    # -- kernel timing at the main paths' shapes -----------------------
    timing = {}
    b_serve = max(cfg.serve_ladder)
    rows = torch.randn((b_serve, F, D), generator=gen, device=dev) * 0.3
    vals = torch.rand((b_serve, F), generator=gen, device=dev)
    rows_t = torch.randn((B, F, D), generator=gen, device=dev) * 0.01
    vals_t = torch.from_numpy(batches[0].vals).to(dev)
    _, s1_t = fm_scores_plain(rows_t, vals_t)
    dsc = torch.randn((B,), generator=gen, device=dev) * 0.1
    # The bf16 step's inputs: the f32 training rows and values rounded.
    rows_t16, vals_t16 = rows_t.to(bf16), vals_t.to(bf16)
    _, s1_t16 = fm_scores_plain(rows_t16, vals_t16)
    drows_t16 = fm_grad_plain(rows_t16, vals_t16, s1_t16, dsc)
    urows, sums = k2_shapes["batch"]
    u = urows.numel()
    acc0 = torch.full((V, D), 0.1, device=dev)
    table_k, acc_k = table0.clone(), acc0.clone()
    ids32 = ids0.to(torch.int32)

    def k1_library(g, meta):
        """K1's library yardstick: one ``index_add_`` of the ``[g | g^2]``
        payload over each occurrence's segment (unsorted order)."""
        u_s = meta.seg_start.numel() - 1
        seg_sorted = torch.repeat_interleave(
            torch.arange(u_s, device=dev),
            (meta.seg_start[1:] - meta.seg_start[:-1]).long(),
            output_size=g.shape[0],
        )
        seg_of_occ = torch.empty_like(seg_sorted)
        seg_of_occ[meta.perm.long()] = seg_sorted
        payload = torch.cat([g, g * g], dim=1)
        out = torch.zeros((u_s, 2 * D), device=dev)
        return lambda: out.index_add_(0, seg_of_occ, payload)

    # K1 merge's library yardstick, as K1's: one index_add_ of the real
    # entries' payload (the sentinel's padding left out, as the kernel
    # leaves it) over each entry's segment.
    n_real = int(meta_m.seg_start[-1])
    merge_seg = torch.repeat_interleave(
        torch.arange(urows_m.numel(), device=dev),
        (meta_m.seg_start[1:] - meta_m.seg_start[:-1]).long(),
        output_size=n_real,
    )
    pay_real = pay_m.index_select(0, meta_m.perm[:n_real].long())
    lib_merge = torch.zeros((urows_m.numel(), 2 * D), device=dev)
    cases = {
        "fm_scores": (lambda: fm_scores_cuda(rows, vals),
                      lambda: fm_scores_plain(rows, vals), None,
                      fm_bound_ms(b_serve, F, D)),
        "fm_grad": (lambda: fm_grad_cuda(rows_t, vals_t, s1_t, dsc),
                    lambda: fm_grad_plain(rows_t, vals_t, s1_t, dsc), None,
                    fm_grad_bound_ms(B, F, D)),
        "fm_scores_bf16": (lambda: fm_scores_cuda(rows_t16, vals_t16),
                           lambda: fm_scores_plain(rows_t16, vals_t16), None,
                           fm_bound_ms(B, F, D, elt=2)),
        "fm_grad_bf16": (
            lambda: fm_grad_cuda(rows_t16, vals_t16, s1_t16, dsc),
            lambda: fm_grad_plain(rows_t16, vals_t16, s1_t16, dsc), None,
            fm_grad_bound_ms(B, F, D, elt=2)),
        "k1_dedup": (
            lambda: k1_dedup_cuda(g_rows, ids32, meta0.perm, meta0.seg_start),
            lambda: k1_dedup_plain(g_rows, ids32, meta0.perm,
                                   meta0.seg_start),
            k1_library(g_rows, meta0),
            k1_bound_ms(n, u, D),
        ),
        "k2_apply": (
            lambda: k2_apply_cuda("adagrad", urows, sums, (table_k, acc_k),
                                  hyper),
            lambda: k2_apply_plain("adagrad", urows, sums, (table_k, acc_k),
                                   hyper),
            None, k2_bound_ms(u, D),
        ),
        "kplace": (
            lambda: kplace_cuda(urows_kp, sums_kp, KPLACE_ROW_LO,
                                KPLACE_VOCAB_LOCAL),
            lambda: kplace_plain(urows_kp, sums_kp, KPLACE_ROW_LO,
                                 KPLACE_VOCAB_LOCAL),
            None,
            kplace_bound_ms(placed, 2 * D, KPLACE_VOCAB_LOCAL),
        ),
        "k1_merge": (
            lambda: k1_merge_cuda(*merge_args),
            lambda: k1_merge_plain(*merge_args),
            lambda: lib_merge.index_add_(0, merge_seg, pay_real),
            k1_merge_bound_ms(n_real, urows_m.numel(), 2 * D),
        ),
    }
    for name, (kern, plain, lib, (b_ms, b_by)) in cases.items():
        # In turns: plain, kernel, kernel, plain.  K-place writes a
        # 151 MB delta per call: fewer calls per graph.
        calls = 20 if name == "kplace" else 100
        pa, ka, kb, pb = (graph_ms(torch, fn, calls=calls) for fn in
                          (plain, kern, kern, plain))
        timing[name] = {
            "ms": min(ka, kb), "plain_ms": min(pa, pb),
            "graph_ms": [ka, kb], "plain_graph_ms": [pa, pb],
            "library_ms": None if lib is None else graph_ms(torch, lib),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    # K1 at its other two streams (the kernels line keeps the batch's).
    timing["k1_dedup"]["streams"] = {}
    for name in ("hot", "probe"):
        g, ids, meta = k1_streams[name]
        args = (g, ids, meta.perm, meta.seg_start)
        pa, ka, kb, pb = (graph_ms(torch, lambda f=f: f(*args)) for f in (
            k1_dedup_plain, k1_dedup_cuda, k1_dedup_cuda, k1_dedup_plain))
        u_s = meta.seg_start.numel() - 1
        b_ms, b_by = k1_bound_ms(g.shape[0], u_s, D)
        timing["k1_dedup"]["streams"][name] = {
            "occurrences": g.shape[0], "unique_rows": u_s,
            "graph_ms": [ka, kb], "plain_graph_ms": [pa, pb],
            "library_ms": graph_ms(torch, k1_library(g, meta)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    del k1_streams, probe_ids
    kern_dev, _, _ = device_times_ms(torch, cases["fm_scores"][0])
    timing["fm_scores"]["profiler_device_ms"] = sum(
        v for k, v in kern_dev.items() if "fm_scores" in k
    )
    timing["fm_scores"]["eager_call_ms"] = time_per_call_ms(
        torch, cases["fm_scores"][0]
    )
    timing["fm_scores"]["train_batch"] = {
        "graph_ms": graph_ms(torch, lambda: fm_scores_cuda(rows_t, vals_t)),
        "bound_ms": fm_bound_ms(B, F, D)[0],
    }
    # The bf16 step's casts around the two kernels: the gathered rows
    # and the values to bf16 before FmScorer, FmGrad's bf16 drows back
    # to f32 before K1.
    casts = {
        "rows_to_bf16": (lambda: rows_t.to(bf16), rows_t.numel(), 4, 2),
        "vals_to_bf16": (lambda: vals_t.to(bf16), vals_t.numel(), 4, 2),
        "drows_to_f32": (lambda: drows_t16.float(), drows_t16.numel(), 2,
                         4),
    }
    timing["bf16_casts"] = {
        name: {"graph_ms": graph_ms(torch, fn),
               "bound_ms": cast_bound_ms(n, a, b_)[0]}
        for name, (fn, n, a, b_) in casts.items()
    }
    timing["fm_scores"]["per_rung"] = {
        b: {"graph_ms": graph_ms(
                torch, lambda b=b: fm_scores_cuda(rows[:b], vals[:b])),
            "bound_ms": fm_bound_ms(b, F, D)[0]}
        for b in cfg.serve_ladder
    }
    # The launch floor: a one-element in-place op, timed as the kernels.
    one = torch.zeros(1, device=dev)
    floor_ms = graph_ms(torch, lambda: one.add_(1.0))
    timing["launch_floor_ms"] = floor_ms
    print("kernel ms vs launch floor (" + card + "): " + json.dumps({
        "launch_floor_ms": floor_ms,
        **{name: timing[name]["ms"] for name in cases},
        "fm_scores_per_rung": {b: r["graph_ms"] for b, r in
                               timing["fm_scores"]["per_rung"].items()},
        "fm_scores_train_batch": timing["fm_scores"]["train_batch"][
            "graph_ms"],
    }), flush=True)
    del table_k, acc_k, lib_merge
    print(json.dumps({"kernel_timing": {
        "card": card, "serve_B": b_serve, "train_B": B, "occurrences": n,
        "unique_rows": u, "kplace_entries": urows_kp.numel(),
        "kplace_rows_placed": placed, "merge_entries": rows_m.numel(),
        "merge_real_entries": n_real, "merge_unique_rows": urows_m.numel(),
        **timing,
    }}), flush=True)

    phase_end("kernel_timing")

    # -- train phase (main path 1) -------------------------------------
    model_dir = os.path.join(tmp, "model")
    tcfg = load_config(CFG_PATH, {
        "train_files": train_files, "validation_files": [valid_file],
        "predict_files": [predict_file], "model_file": model_dir,
        "score_path": os.path.join(tmp, "scores.txt"), "log_steps": 4,
        "seed": SEED, "serve_poll_secs": 0.0, "serve_port": 0,
    })
    check(tcfg.host_sort and tcfg.optimizer == "adagrad"
          and tcfg.l2_mode == "batch" and tcfg.sparse_update,
          "the main path's config is not the default sparse Adagrad")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = kernel_fns(fm_kernels, sparse_apply, micro_probe)
    zero_launches(kernels)

    class LossTrainer(Trainer):
        """Keeps each step's loss, a device scalar, for the falling-loss
        check."""

        def __init__(self, cfg):
            self.step_losses = []
            super().__init__(cfg)

        def train_step(self, batch):
            loss = super().train_step(batch)
            self.step_losses.append(loss)
            return loss

    t0 = time.perf_counter()
    trainer = LossTrainer(tcfg)
    result = trainer.train()
    train_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_pred = predict(tcfg)
    predict_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    train_launches = read_launches(kernels)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    tr = result["train"]
    steps = tr["steps"]
    check(steps == TRAIN_FILES * BATCHES_PER_FILE,
          f"trained {steps} steps")
    for name in ("fm_grad", "k1_dedup", "k2_apply"):
        check(train_launches[name] >= steps,
              f"{name} launched {train_launches[name]} times in "
              f"{steps} steps")
    losses = [float(x) for x in trainer.step_losses]
    last = float(np.mean(losses[-4:]))
    check(all(np.isfinite(losses)), "non-finite step loss")
    check(last < losses[0], f"logloss did not fall: first {losses[0]:.4f}, "
          f"last 4 {last:.4f}")
    val = result["validation"]
    check(np.isfinite(val["logloss"]) and 0 < val["auc"] <= 1,
          f"validation {val}")
    with open(tcfg.score_path) as f:
        scores_txt = [float(s) for s in f.read().split()]
    check(n_pred == LINES and len(scores_txt) == LINES,
          f"predict wrote {n_pred} scores for {LINES} lines")
    check(all(0.0 < s < 1.0 for s in scores_txt), "predict scores not in (0,1)")
    print(json.dumps({"train": {
        "card": card, "steps": steps, "batch_size": B,
        "launches": train_launches, "step_logloss": losses,
        "first_step_logloss": losses[0], "last4_mean_logloss": last,
        "train_logloss": tr["logloss"], "train_auc": tr["auc"],
        "validation_logloss": val["logloss"], "validation_auc": val["auc"],
        "train_wall_s": train_wall, "predict_wall_s": predict_wall,
        "predict_scores": n_pred,
        "examples_per_sec_end_to_end": tr["examples_per_sec"],
        "ingest_wait_frac": tr["ingest_wait_frac"],
        "peak_device_mb": peak_mb,
    }}), flush=True)
    del trainer

    phase_end("train")

    # -- bf16 train phase (main path 1 with compute_dtype = bfloat16) --
    # One file (8 steps), the f32 run first on the same batches (same
    # seed, same initial table) for the loss check, then the bf16 run
    # with every count from 0, then its validation.
    runs = {}
    for dtype in ("float32", "bfloat16"):
        dcfg = load_config(CFG_PATH, {
            "train_files": train_files[:1],
            "validation_files": [valid_file] if dtype == "bfloat16" else [],
            "model_file": os.path.join(tmp, f"model_{dtype}"),
            "log_steps": 4, "seed": SEED, "compute_dtype": dtype,
            "serve_poll_secs": 0.0, "serve_port": 0,
        })
        torch.cuda.synchronize()
        zero_launches(kernels)
        t0 = time.perf_counter()
        trainer = LossTrainer(dcfg)
        result = trainer.train()
        torch.cuda.synchronize()
        runs[dtype] = {
            "launches": read_launches(kernels), "result": result,
            "wall_s": time.perf_counter() - t0,
            "step_logloss": [float(x) for x in trainer.step_losses],
        }
        del trainer
    bf, f32 = runs["bfloat16"], runs["float32"]
    bf16_launches = bf["launches"]
    steps = bf["result"]["train"]["steps"]
    check(steps == BATCHES_PER_FILE == f32["result"]["train"]["steps"],
          f"bf16 phase trained {steps} steps")
    for name in ("fm_scores_bf16", "fm_grad_bf16", "k1_dedup", "k2_apply"):
        check(bf16_launches[name] >= steps,
              f"bf16 run: {name} launched {bf16_launches[name]} times in "
              f"{steps} steps")
    check(bf16_launches["fm_grad"] == 0 and f32["launches"]["fm_grad_bf16"]
          == 0, f"a run took the other mode's FmGrad: {bf16_launches}")
    check(all(np.isfinite(bf["step_logloss"])), "non-finite bf16 loss")
    loss_diff = abs(bf["step_logloss"][-1] - f32["step_logloss"][-1])
    check(loss_diff < 1e-2, f"bf16 last logloss {bf['step_logloss'][-1]} vs "
          f"f32 {f32['step_logloss'][-1]}")
    bval = bf["result"]["validation"]
    check(np.isfinite(bval["logloss"]) and 0 < bval["auc"] <= 1,
          f"bf16 validation {bval}")
    with np.load(os.path.join(tmp, "model_bfloat16", "params.npz")) as z:
        dtypes = {k: str(z[k].dtype) for k in z.files if k != "scalar/step"}
    check(set(dtypes.values()) == {"float32"},
          f"the bf16 run saved {dtypes}")
    print(json.dumps({"bf16_train": {
        "card": card, "steps": steps, "batch_size": B,
        "launches": bf16_launches, "step_logloss": bf["step_logloss"],
        "f32_step_logloss": f32["step_logloss"],
        "last_logloss_abs_diff": loss_diff,
        "train_logloss": bf["result"]["train"]["logloss"],
        "f32_train_logloss": f32["result"]["train"]["logloss"],
        "validation_logloss": bval["logloss"], "validation_auc": bval["auc"],
        "train_wall_s": bf["wall_s"], "f32_train_wall_s": f32["wall_s"],
        "examples_per_sec_end_to_end":
            bf["result"]["train"]["examples_per_sec"],
        "checkpoint_dtypes": sorted(set(dtypes.values())),
    }}), flush=True)
    del runs, bf, f32

    phase_end("bf16_train")

    # -- parity phase --------------------------------------------------
    def put(batch, with_meta=True):
        b = sparse.to_device(batch, dev)
        return b if with_meta else b._replace(sort_meta=None)

    dev_batches = [put(b) for b in batches]
    init = fm.init_params(tcfg, torch.Generator(device=dev).manual_seed(7),
                          device=dev)

    def fresh():
        m = fm.FmModel(init.w0.detach().clone(), init.table.detach().clone())
        return m, sparse.init_sparse_opt_state(tcfg, m)

    parity = {}
    for dtype in ("float32", "bfloat16"):
        pcfg = dataclasses.replace(tcfg, compute_dtype=dtype)
        (mk, ok), (mp, op) = fresh(), fresh()
        score_err = 0.0
        for b in dev_batches:
            s_k = sparse.sparse_step(pcfg, mk, ok, b)
            s_p = sparse.sparse_step(pcfg, mp, op, b, plain=True)
            torch.testing.assert_close(s_k, s_p, **KERNEL_TOL)
            score_err = max(score_err, float((s_k - s_p).abs().max()))
        torch.cuda.synchronize()
        torch.testing.assert_close(mk.table, mp.table, **TABLE_TOL)
        torch.testing.assert_close(ok.acc_table, op.acc_table, **OPT_TOL)
        torch.testing.assert_close(mk.w0, mp.w0, rtol=1e-5, atol=1e-7)
        parity[dtype] = {
            "steps": len(dev_batches),
            "table_max_abs_err": float(
                (mk.table - mp.table).detach().abs().max()),
            "acc_max_abs_err": float(
                (ok.acc_table - op.acc_table).abs().max()),
            "scores_max_abs_err": score_err,
            "changes": {
                "table": delta_check(torch, f"{dtype} table", mk.table,
                                     mp.table, init.table.detach()),
                "acc_table": delta_check(
                    torch, f"{dtype} acc_table", ok.acc_table, op.acc_table,
                    torch.full_like(ok.acc_table,
                                    tcfg.adagrad_initial_accumulator),
                ),
            },
        }
        del mp, op
        if dtype == "float32":
            mh, oh = fresh()  # host meta (the pipeline's) vs device prep
            for b in dev_batches:
                sparse.sparse_step(tcfg, mh, oh, b._replace(sort_meta=None))
            torch.cuda.synchronize()
            check(torch.equal(mh.table, mk.table)
                  and torch.equal(oh.acc_table, ok.acc_table)
                  and torch.equal(mh.w0, mk.w0),
                  "host sort meta and device sort meta trained different "
                  "tables")
            parity[dtype]["host_vs_device_meta"] = "bitwise equal"
            del mh, oh
        del mk, ok
    print(json.dumps({"parity": parity}), flush=True)

    phase_end("parity")

    # -- one train step: host clock, profiler --------------------------
    # f32 and bf16 compute, each from a fresh model, timed in turns.
    steppers = {dtype: Trainer(load_config(CFG_PATH, {
        "model_file": os.path.join(tmp, f"fresh_{dtype}"), "seed": SEED,
        "compute_dtype": dtype,
    })) for dtype in ("float32", "bfloat16")}
    times = {dtype: [] for dtype in steppers}
    for i in range(24):
        for dtype, stepper in steppers.items():
            t0 = time.perf_counter()
            stepper.train_step(batches[i % 3])
            torch.cuda.synchronize()
            times[dtype].append(time.perf_counter() - t0)
    for dtype, stepper in steppers.items():
        step_ms = p50(times[dtype][4:]) * 1e3
        prof = iter(range(1 << 30))
        step_dev, step_wall, step_host = device_times_ms(
            torch, lambda: stepper.train_step(batches[next(prof) % 3]),
            iters=12,
        )
        busy = sum(step_dev.values())
        key = "train_step" if dtype == "float32" else "train_step_bf16"
        print(json.dumps({key: {
            "card": card, "B": B, "compute_dtype": dtype, "p50_ms": step_ms,
            "examples_per_sec_step_alone": B / (step_ms / 1e3),
            "profiler_wall_ms": step_wall, "device_busy_ms": busy,
            "device_idle_frac": max(0.0, 1.0 - busy / step_wall),
            "device_ms_by_op": step_dev, "host_self_ms_top10": step_host,
            "max_memory_allocated_mb":
                torch.cuda.max_memory_allocated() / 2**20,
        }}), flush=True)
    del steppers, stepper

    phase_end("train_step")

    # -- serve phase (main path 2): the trained checkpoint -------------
    scfg = load_config(CFG_PATH, {
        "serve_poll_secs": 0.0, "serve_port": 0, "model_file": model_dir,
    })
    _, ref = checkpoint.restore_params(model_dir, device=dev)
    fm_scores_cuda.launches = 0  # count the serve path only
    handle = serve(scfg, port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                          timeout=120)
        # Request sizes: one per rung (64, 256, 1024) and one larger
        # than the largest rung, which the scorer splits.
        sizes = (1, 37, 200, 1000, 1500)
        served = []
        for n_req in sizes:
            body = criteo_body(rng, n_req)
            text = post(conn, "/score", body.encode()).decode()
            ids, vals_np, _, got_n, trunc = parse_request(body, scfg)
            check(got_n == n_req and trunc == 0, f"parse of {n_req} lines")
            frame = wire.encode_bin_request(ids, vals_np)
            bin_scores = wire.decode_bin_response(
                post(conn, "/score_bin", frame)
            )
            check(bin_scores.shape == (n_req,), f"{n_req} binary scores")
            check(text == "".join(f"{s:.6f}\n" for s in bin_scores),
                  f"/score and /score_bin disagree at n={n_req}")
            served.append((ids, vals_np, bin_scores))
        # Unreduced ids (>= V and negative) reduce modulo V exactly like
        # the text path; on the card an unreduced id would be a
        # device-side assert.
        ids, vals_np, want = served[2]
        wild = ids.astype(np.int64)
        wild[::2] += 3 * V
        wild[1::2] -= V
        got = wire.decode_bin_response(post(
            conn, "/score_bin",
            wire.encode_bin_request(wild.astype(np.int32), vals_np),
        ))
        check(np.array_equal(got, want),
              "out-of-range ids did not reduce modulo the vocabulary")

        # Request latency on the card, keep-alive, one client.
        latency = {}
        for n_req in (1, 1024):
            body = criteo_body(rng, n_req).encode()
            ids, vals_np, _, _, _ = parse_request(body.decode(), scfg)
            frame = wire.encode_bin_request(ids, vals_np)
            for path, payload_b in (("/score", body), ("/score_bin", frame)):
                times = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    post(conn, path, payload_b)
                    times.append(time.perf_counter() - t0)
                latency[f"{path}_n{n_req}_p50_ms"] = p50(times) * 1e3
        conn.close()
        # The main path ends here; the launches below only time it.
        serve_launches = fm_scores_cuda.launches

        # Dispatch time per rung, straight through the scorer.
        scorer = handle.scorer
        ids_all, vals_all, _ = served[-1]
        dispatch = {}
        for b in scorer.ladder:
            times = []
            for _ in range(50):
                t0 = time.perf_counter()
                scorer.score_rung(ids_all[:b], vals_all[:b], None, b)
                times.append(time.perf_counter() - t0)
            dispatch[b] = p50(times) * 1e3
        ids_b, vals_b = ids_all[:b_serve], vals_all[:b_serve]
        breakdown, wall_ms, _ = device_times_ms(
            torch, lambda: scorer.score_rung(ids_b, vals_b, None, b_serve),
        )
    finally:
        handle.close()

    check(serve_launches > 0, "the serve path never launched the kernel")
    # Served scores vs the plain path on the card, same weights.
    with torch.inference_mode():
        for ids, vals_np, got in served:
            ids_t = torch.from_numpy(ids).to(dev).long()
            rows_t = ref.table[ids_t]
            s, _ = fm_scores_plain(rows_t, torch.from_numpy(vals_np).to(dev))
            want_t = torch.sigmoid(ref.w0 + s).cpu()
            torch.testing.assert_close(torch.from_numpy(got), want_t,
                                       **SERVE_TOL)
            check(bool(np.isfinite(got).all()), "non-finite score")
    busy = sum(breakdown.values())
    print(json.dumps({"serve": {
        "card": card, "requests": sizes, "kernel_launches": serve_launches,
        "dispatch_p50_ms": dispatch, "latency_p50_ms": latency,
        "rung_1024_device_ms": breakdown, "rung_1024_wall_ms": wall_ms,
        "rung_1024_device_idle_frac": max(0.0, 1.0 - busy / wall_ms),
    }}), flush=True)
    print("serve check: the trained checkpoint serves; transports agree "
          "bitwise, scores match the plain path on the card, out-of-range "
          "ids reduce", flush=True)
    phase_end("serve")

    # -- sharded phase (main path 3) -----------------------------------
    del ref, scorer, handle
    torch.cuda.empty_cache()
    sharded, sharded_launches = sharded_phase(
        np, torch, tmp, card, train_files[0], valid_file, one_card=True)
    print(json.dumps(sharded), flush=True)
    print("sharded check: dense and entries runs of a 2 x 2 mesh match the "
          "single-device run; every rank reports the same metrics",
          flush=True)
    phase_end("sharded")
    tmp_ctx.cleanup()

    # -- probe phase (main path 4): the table-layout probe -------------
    probe, probe_timing, probe_launches = probe_phase(
        torch, card, gen, table0, hot, hyper, err, kernels)
    timing.update(probe_timing)
    print(json.dumps(probe), flush=True)
    print("probe check: K2T and K2P == their plain versions and K2's "
          "elements at both streams; micro_probe.main ran at full size",
          flush=True)
    phase_end("probe")

    # Launches on the main paths: train (path 1), serve (path 2, the
    # only fm_scores count), the sharded runs' ranks (path 3), the
    # probe (path 4, the only K2T and K2P counts), and the bf16 train
    # run (path 1 with compute_dtype = bfloat16, the only count of the
    # bf16 modes).
    launches = {name: train_launches[name] + sharded_launches[name]
                for name in kernels}
    launches["fm_scores"] = serve_launches
    for name in ("fm_scores_bf16", "fm_grad_bf16"):
        launches[name] = bf16_launches[name]  # path 1 in bf16
    for name in ("k2t_apply", "k2p_apply"):
        launches[name] = probe_launches[name]
    sources = {
        "fm_scores": ("fm_scorer.cu", "fast_tffm_tpu/ops/fm_pallas.py:110"),
        "fm_grad": ("fm_grad.cu", "fast_tffm_tpu/ops/fm_pallas.py:127"),
        "fm_scores_bf16": ("fm_scorer.cu",
                           "fast_tffm_tpu/ops/fm_pallas.py:110"),
        "fm_grad_bf16": ("fm_grad.cu", "fast_tffm_tpu/ops/fm_pallas.py:127"),
        "k1_dedup": ("sparse_apply.cu",
                     "fast_tffm_tpu/ops/sparse_apply.py:136"),
        "k1_merge": ("sparse_apply.cu",
                     "fast_tffm_tpu/ops/sparse_apply.py:136"),
        "k2_apply": ("sparse_apply.cu",
                     "fast_tffm_tpu/ops/sparse_apply.py:322"),
        "kplace": ("sparse_apply.cu",
                   "fast_tffm_tpu/ops/sparse_apply.py:469"),
        "k2t_apply": ("layout_probe.cu", "tools/micro_probe.py:46"),
        "k2p_apply": ("layout_probe.cu", "tools/micro_probe.py:102"),
    }
    print(json.dumps({"phase_wall_s": phase_wall}), flush=True)
    print(json.dumps({"smoke_wall_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"fast_tffm_tpu_torch/ops/csrc/{src}",
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": err[name],
        "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
    } for name, (src, replaces) in sources.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    if sys.argv[1:] == ["--nccl"]:
        sys.exit(nccl_main())
    if sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]} [--nccl]")
    sys.exit(main())
