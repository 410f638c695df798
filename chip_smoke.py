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
   the native parser from ``fast_tffm_tpu_torch/data/_src`` with
   ``g++``, and time both builds.
3. Data: write seeded synthetic labelled Criteo-shaped lines (13
   ``I<j>_<bucket>`` and 26 ``C<j>_<hex>`` tokens, hashed by the parser;
   labels planted from a fixed rule on the integer buckets) for
   training (16 batches of 4096), validation and predict.
4. Kernel phase: every kernel against its plain PyTorch version on the
   card — ``fm_scores`` at the serving rungs and at a parsed training
   batch (B = 4096: train step, validation, predict), ``fm_grad`` bitwise
   at B in {1, 1000, 4096}, both again in their bf16-input mode (FmScorer
   at the rungs 64/256/1024 and the parsed batch, FmGrad bitwise), K1 and K2
   (adagrad, ftrl, sgd) at the training shapes of a parsed batch and with one id of >= 5000 occurrences (K1
   also at the probe's stream), K1 and K2 again on the whole ``[n + 1]``
   ``seg_start`` slot at the first two (bitwise the cut slot's kernels on
   the first U rows, row -1 after), K-place at the sharded path's shapes
   (``vocab_local = 2^21``, ``row_lo = 2^21``, a parsed local batch of
   2048 lines with sentinel ids) and K1's merge mode on two data blocks'
   entry streams (both exact: ``max_abs_err`` 0) — then kernel, plain
   and library call timed in CUDA graphs at the main paths' shapes (the
   bf16 modes at the training batch, with the bf16 step's three casts;
   FmGrad, whose bytes fit the L2, on 32 copies of its inputs in turn,
   the L2-resident times kept beside), and K1 at its hot and probe
   streams too; beside them the launch floor, a one-element in-place
   PyTorch op timed the same way.
5. Train phase (main path 1): ``Trainer(cfg).train()`` on
   ``examples/criteo_kaggle.cfg`` at full width (V = 2^22, F = 39,
   D = 9, B = 4096, Adagrad, batch L2, host sort meta, ``thread_num =
   8`` parse threads on the native parser, one pinned copy a
   super-batch, every dispatch after the first one replay of the CUDA
   graph of its steps), 16 steps, then validation on one file and
   ``predict``.  Checks: at least one launch per step of ``fm_scores``,
   ``fm_grad``, ``k1_dedup`` and ``k2_apply`` (a replay adds the
   launches its graph holds); one eager dispatch and the rest
   graphed; every batch parsed by
   the native parser and every dispatch shipped by the transfer stage
   (their counters); the logloss of the last steps below the first
   step's; one finite probability per predict line.
5b. Ingest phase (main path 1 again): ``BatchPipeline`` drained alone
   over the train files (lines/s) with the Python parser on one thread,
   the native parser on 1 and 8 threads and on 2, 4 and 8 spawned
   worker processes (the shared-memory ring on), the streams checked
   bitwise equal; the free bytes of ``/dev/shm`` beside the ring's
   size; then ``Trainer.train()`` for 4 epochs of the same files (64
   steps) in six modes: 8 threads with the epoch cache off, on
   (``cache_epochs``) and prestacked (``cache_prestacked``), and 2, 4
   and 8 workers with the cache off; each from fresh models as it runs
   (end to end examples/s, with and without the first dispatch, and
   ``ingest_wait_frac``) and with each step synchronised (its p50
   during the run), and the first mode also under ``torch.profiler``
   with no checkpoint write (the device's idle share, host-to-device
   copies per super-batch, ``cudaMemcpyAsync`` host time per step), all
   through ``fast_tffm_tpu_torch/tools/ingest_bench.py``.  Each run is
   checked as phase 5's, with the counts exact for its mode: a cached run
   parses epoch 0 alone (16 batches) and replays 48, reports
   ``ingest_cache`` ``cached``, and prestacked packs epoch 0's groups
   once and ships every dispatch with no fill; a pooled run's workers
   parse every batch and the trainer's own parser none, and its table,
   accumulator and w0 are bitwise the threads run's; no segment of the
   run's pipelines is left in ``/dev/shm``.
6. bf16 train phase (main path 1 with ``compute_dtype = bfloat16``):
   the same config on one train file, 8 steps in f32 and then 8 in
   bf16 from the same initial table on the same batches, the bf16 run
   validated (in f32).  Checks: every step launched the bf16 FmScorer
   and FmGrad, K1 and K2, and no f32 FmGrad; the last step's logloss
   within 1e-2 of the f32 run's (the reference's
   ``tests/test_bf16.py::TestTrainingParity`` check); an f32
   ``params.npz``.
6b. Graph phase (main path 1's dispatch): ``Trainer.train()`` over the
   train files and the validation file (17 steps, so K = 4 ends on an
   eager tail) for f32 and bf16 compute x Adagrad, FTRL, SGD x K = 1, 4,
   each graphed and eager (the trainer's ``graph`` set to None) from the
   same seeded table: tables, optimizer state, w0 and the metrics
   bitwise equal, replays in the graphed run only.  Then at f32 Adagrad, K = 1 and 4, a super-batch
   already on the card dispatched again and again, eager and graphed: the
   step's p50 (a synchronised dispatch over K), the device's idle share
   and the host time in ``cudaLaunchKernel`` and ``cudaGraphLaunch`` from
   ``torch.profiler``, the capture's time and the graph pool's bytes.
7. Parity phase, f32 and bf16 compute: 3 steps through the kernels vs
   3 through the plain path from the same initial weights: each step's
   scores (``rtol=1e-5, atol=1e-5``), the tables (``rtol=1e-4,
   atol=1e-6`` table, ``atol=1e-4`` accumulator) and what the steps
   changed in each (``delta_check``); and host sort meta vs device sort
   meta (bitwise, f32).  Then an f32 and a bf16 step, timed in turns:
   each one's p50 (host clock, synchronised; from a host batch through
   ``train_step``, and the f32 step's on a batch already on the device),
   device time by op and idle share from ``torch.profiler``, and the
   peak memory.
8. Serve phase (main path 2): serve the checkpoint the train phase
   wrote over ``/score`` and ``/score_bin``, every rung plus one request
   larger than the largest; the two transports agree bitwise, scores
   match the plain path on the card, out-of-range ids reduce like the
   text path, the kernel ran.  Request latency and dispatch per rung.
8b. Quant phase (path 6): the same checkpoint served again through
   ``serve()``: in fp32, as the bf16 and the int8 (chunk 64)
   ``quant.npz`` that ``fast_tffm_tpu_torch/tools/convert_checkpoint.py``
   writes (its seconds timed), and as the fp32 ``params.npz`` at
   ``serve_table_dtype = int8`` (quantized at placement), each on the
   same requests.  Checks: the transports bitwise; the scores within
   the reference's bounds of the fp32 server's (bf16 5e-3, int8 2e-2,
   ``tests/test_quant.py:43-44``) and within ``KERNEL_TOL`` of the plain
   path on the dequantized rows; ``serve.table_bytes`` the codes plus
   scales (37,748,736 + 262,144 B int8, 75,497,472 B bf16, 150,994,944 B
   fp32) and the device memory the placement added the same;
   ``/status``'s ``quant_error_max`` -1 for a ``quant.npz``, in (0,
   bound] at placement, 0 for fp32; FmScorer launches counted.  Dispatch
   p50 per rung and the placement seconds of each table.
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
   K2, K2T and K2P timed in CUDA graphs at both, beside K2T's own
   sector figure (``k2t_sector_ms``, counted from each stream's ids); then
   ``fast_tffm_tpu_torch.tools.micro_probe.main`` at full size (its own
   parity checks raise), whose run gives K2T's and K2P's launches.
11. FFM phase (path 5, field-aware FM): FFM-Criteo,
   ``examples/criteo_kaggle.cfg`` with ``field_num = 4`` (V = 2^22,
   F = 39, k = 8, P = 4, D = 1 + P*k = 33, B = 4096), on synthetic
   ``field:token:val`` lines (column j on field j mod 4).  K1 and K2
   (Adagrad, FTRL, SGD) at D = 33 against their plain versions on a
   parsed batch and with one hot id, cut and whole slot (the same bounds
   and ``delta_check``), then timed in CUDA graphs beside their bounds,
   plain versions and K1's ``index_add_``; the FFM op's forward and
   closed-form backward against autograd through
   ``ffm_scores_from_rows`` (f32 ``rtol=1e-5, atol=1e-6``; bf16 against
   f32 ``rtol=2e-2, atol=2e-2``, and its backward bitwise the f32 one on
   pre-rounded operands); 16 steps through ``Trainer.train()`` (eight
   threads, host sort, graphed, every count from 0: the path's launches),
   validation and predict; the same run eager, and graphed and eager at
   K = 4, bitwise equal; 3 steps through the kernels against 3 through
   the plain path; 8 bf16 steps within 1e-2 logloss of 8 f32 steps; the
   checkpoint served over ``/score`` and ``/score_bin`` at every rung and
   past the largest (transports bitwise, scores against the plain path);
   the step on a device batch graphed and eager (p50, device time by op,
   idle share) and its four einsums alone; then ``python -m
   fast_tffm_tpu_torch.cli train|predict|serve`` on
   ``examples/ffm_sample.cfg`` as subprocesses on the data of
   ``examples/gen_sample_data.py --ffm`` (validation logloss below
   0.693; the server's ``/score`` equal to the predict file).  Between
   serving and the step, the checkpoint is served in fp32 and at
   ``serve_table_dtype = int8`` with path 6's checks (138,412,032 +
   262,144 B against 553,648,128).
12. Overlay phase (path 7): a ``tiered.npz`` at
   ``examples/criteo_1tb_dist.cfg``'s V = 2^26, D = 9 (its mesh, lookup
   and batch size overridden for one device; the record lists the
   overrides), written by ``save_tiered`` from a virtual ``ColdStore`` of
   2^20 seeded rows, in cold dtype fp32 and int8, served through
   ``serve()`` (the ``OverlayScorer``).  Checks: the transports bitwise;
   the scores within ``KERNEL_TOL`` of the plain path on the store's
   rows, written and never written; no table gauge on ``/status``; the
   peak device memory the stack added within its staging and one bucket
   of the largest rung (no ``[V, D]`` allocation); FmScorer launches
   counted.  Dispatch p50 and the host gather a dispatch, per rung.
13. Tiered phase (path 8, the tiered trainer, ``table_tiering = on``):
   (a) phase 5's config and files with ``hot_rows = 2^18`` (a step's
   159,744 occurrences fit, 16 steps evict), through ``Trainer.train()``
   from the same seed: the merged logical table, accumulator, w0 and its
   slot against phase 5's dense run (bitwise expected and reported;
   ``TABLE_TOL`` / ``OPT_TOL`` required), evictions and ``0 <
   hot_hit_frac < 1``, FmScorer, FmGrad, K1 and K2 each exactly once a
   step with K1 and K2 on the cut ``[U + 1]`` slot (every dispatch
   eager), validation within 1e-6 of phase 5's, and ``python -m
   fast_tffm_tpu_torch.cli predict`` of the saved ``params.npz`` within
   one printed digit of phase 5's predict file; (b) the reference
   bench's tiered section (``bench.py::_bench_tiered``: V = 2^28,
   ``hot_rows`` = 2^20, D = 9, F = 39, B = 4096, K = 8, 12 batches of
   Zipf(1.1) lines an epoch, the prestacked cache, a virtual cold
   store): 8 epochs in fp32 cold rows, saved as ``tiered.npz`` and
   served through ``serve()`` (scores against the plain path on the cold
   store's rows), and 2 epochs each in bf16 and int8 cold rows; the
   peak device memory under a 16th of one dense table.  Each run's
   examples/s, ``ingest_wait_frac``, tier counters, host plan ms a
   super-batch and migration device ms a dispatch.
14. Dense phase (path 9, the dense optax path: ``sparse_update =
   false``, ``l2_mode = full``, both lambdas 1e-4): phase 5's config,
   files and 16 steps with Adam and with Adagrad through
   ``Trainer.train()``, graphed (every count from 0: FmScorer, FmGrad,
   K1's merge mode and K-place once a step, no K1 dedup or K2) and each
   bitwise its eager twin (table, w0, moments or accumulator, Adam's
   count, metrics); the Adam run validated, its ``params.npz``
   predicted through ``python -m fast_tffm_tpu_torch.cli predict`` and
   served over ``/score`` (equal to the predict file), then
   warm-started (its saved count 16, moments bitwise) for 4 steps; 4
   bf16 Adam steps within 1e-2 logloss of 4 f32 ones; 4 Adam steps of
   FFM-Criteo (D = 33: K1's merge mode and K-place only); 3 steps of
   ``train.dense.dense_step`` through the kernels against 3 through the
   plain versions (Adam and Adagrad, ``KERNEL_TOL`` scores,
   ``TABLE_TOL`` table, ``OPT_TOL`` state); the Adam step on a device
   batch eager and graphed (p50, device time by op, idle share), the
   whole-table update alone (``train.optimizers.apply_dense``, Adam and
   Adagrad) in CUDA graphs and by op against its byte bound, and the
   gradient's K1 merge, K-place and full-L2 term at the step's shapes;
   each run's peak device memory (and over what the process held
   before it) and graph/eager dispatches.

Output: progress lines and JSON records, then a ``{"kernels": [...]}``
JSON line, the ``nvidia-smi`` line, and last ``{"ok": true, "device":
{...}}``.  Exits non-zero, printing no result, without a CUDA GPU or
without the package beside this script.
"""

from __future__ import annotations

import dataclasses
import gc
import http.client
import itertools
import json
import logging
import os
import re
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
# Ingest phase: the process pool's sizes (each beside eight threads).
INGEST_PROCS = (2, 4, 8)
INT_BUCKETS = 50
# Sharded phase: the mesh, its ranks' deadline, and the K-place check's
# shard (the upper half of the Criteo-Kaggle table).
SHARDED_MESH = (2, 2)
RANK_TIMEOUT_S = 300
KPLACE_ROW_LO = KPLACE_VOCAB_LOCAL = 1 << 21
# Kernel timing: the copies of FmGrad's inputs taken in turn, so that its
# time is not the L2's (32 x 6.5 MB f32, 32 x 3.3 MB bf16).
FM_GRAD_COPIES = 32
# Probe phase: the micro-probe's id count (16384 x 39 uniform ids), and
# the occurrences of the one hot id added to each K2T/K2P check's ids.
PROBE_N = 16384 * 39
HOT_OCCURRENCES = 5000
# FFM phase: FFM-Criteo's fields (examples/criteo_kaggle.cfg with
# field_num = 4, the reference's tools/tpu_validate.py FFM shape); the
# FFM op against autograd through the scores at tests/test_ffm_op.py's
# bound, and its bf16 mode against f32 at that file's bf16 bound.
FFM_FIELDS = 4
FFM_OP_TOL = dict(rtol=1e-5, atol=1e-6)
FFM_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# Quantized serving (path 6): the int8 scale chunk, and the reference's
# pinned bounds of served quantized scores against fp32 ones
# (tests/test_quant.py:43-44); the request sizes every served table
# answers (one per rung of 64/256/1024 and one past the largest).
QUANT_CHUNK = 64
SERVE_BOUND = {"bf16": 5e-3, "int8": 2e-2}
SERVE_SIZES = (1, 37, 200, 1000, 1500)
# Overlay serving (path 7): Criteo-1TB's table (V = 2^26, D = 9) as a
# tiered overlay of this many written rows.
DIST_CFG_PATH = os.path.join(REPO, "examples", "criteo_1tb_dist.cfg")
OVERLAY_ROWS = 1 << 20
# Tiered training (path 8): (a) the main config's hot table (one step's
# 159,744 occurrences fit, 16 steps evict); (b) the reference bench's
# tiered section (bench.py::_bench_tiered): 12 batches of 4096 Zipf
# lines an epoch, 8 epochs in fp32 cold rows and fewer in bf16 and int8.
TIERED_HOT = 1 << 18
TIERED_BATCHES = 12
TIERED_EPOCHS = 8
TIERED_SHORT_EPOCHS = 2
# The dense optax path (path 9): both L2 lambdas of the full-table L2,
# the short runs' steps (bf16, FFM-Criteo, the warm start), the lines of
# the predict file served, and the timed dispatches of one step.
DENSE_LAMBDA = 1e-4
# Adam's learning rate (the config's 0.1 is Adagrad's: Adam moves every
# touched weight by about the learning rate a step, and 16 steps at 0.1
# saturate the scores), and the relative gradient difference up to which
# Adam's table is held to the plain step's: its update mu / sqrt(nu) is
# scale-free, so a gradient that nearly cancels passes its whole
# relative rounding on into the step.
DENSE_ADAM_LR = 1e-3
DENSE_GRAD_RTOL = 1e-4
DENSE_SHORT_STEPS = 4
DENSE_SERVE_LINES = 300
DENSE_TIMED_STEPS = 40
# Profiler windows: the host's pause after tracing starts and before it
# stops.  The trace drops a kernel whose traced time falls outside the
# window, and the window can open ms after `prof.step()` returns, losing
# the first calls' kernels; fast_tffm_tpu_torch/tools/profiler_window.py
# counts the windows that lose kernels with and without the pause.
PROFILE_MARGIN_S = 0.1


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


def device_times_ms(torch, fn, iters: int = 50, top: int = 10,
                    counts: dict = None):
    """Per-call device time by op from torch.profiler over ``iters``
    calls, the host wall per call, and the host (CPU) self time per call
    of the ``top`` costliest host ops (every op when ``top`` is 0):
    ``({name: ms}, wall_ms, {name: ms})``.  ``counts``, if given, gets
    each device op's number of runs over the ``iters`` calls.  One more
    call is traced first and dropped (the schedule's warm-up), and the
    host pauses ``PROFILE_MARGIN_S`` after the window opens and before it
    closes, so that no kernel of the ``iters`` calls falls outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
        prof.step()
    out, host = {}, {}
    for ev in prof.key_averages():
        cpu_us = getattr(ev, "self_cpu_time_total", 0.0)
        if cpu_us > 0 and not ev.key.startswith("ProfilerStep"):
            host[ev.key[:60]] = cpu_us / 1e3 / iters
        # Device-side activities only (kernels, copies): a host range
        # (an aten:: op, an autograd Function) reports the kernels it
        # launched again as its own device time, and so does the
        # schedule's step range on the device timeline.
        if (ev.device_type == DeviceType.CPU or "Activity Buffer" in ev.key
                or ev.key.startswith("ProfilerStep")):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and dev_us > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].strip()[:60]
            out[name] = out.get(name, 0.0) + dev_us / 1e3 / iters
            if counts is not None:
                counts[name] = counts.get(name, 0) + ev.count
    ranked = sorted(host.items(), key=lambda kv: -kv[1])
    return out, wall * 1e3 / iters, dict(ranked[:top] if top else ranked)


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


def k1_bound_ms(n: int, u: int, d: int, slot: int = 0):
    """K1: g_rows and perm read, ids once per unique id (at its
    segment's first occurrence), ``seg_start`` read and a row id written
    for each of the ``slot`` segments it covers (``u`` on the cut slot,
    the default; ``n`` on the whole slot); the ``u`` rows of sums
    written (nothing reads sums past U, and the kernel writes none).
    Per occurrence and column: g, g*g, two adds."""
    slot = slot or u
    return bound(4 * (n * d + n + u + (slot + 1) + slot + 2 * d * u),
                 3 * n * d)


def full_slot(torch, seg_start, n: int):
    """``seg_start [U + 1]`` padded with ``n`` to the whole ``[n + 1]``
    slot the transfer stage ships (the graphed step's K1 reads it
    whole)."""
    slot = torch.full((n + 1,), n, dtype=torch.int32,
                      device=seg_start.device)
    slot[:seg_start.numel()] = seg_start
    return slot


def k1_library(torch, g, meta):
    """K1's library yardstick: one ``index_add_`` of the ``[g | g^2]``
    payload over each occurrence's segment (unsorted order)."""
    u_s = meta.seg_start.numel() - 1
    seg_sorted = torch.repeat_interleave(
        torch.arange(u_s, device=g.device),
        (meta.seg_start[1:] - meta.seg_start[:-1]).long(),
        output_size=g.shape[0],
    )
    seg_of_occ = torch.empty_like(seg_sorted)
    seg_of_occ[meta.perm.long()] = seg_sorted
    payload = torch.cat([g, g * g], dim=1)
    out = torch.zeros((u_s, 2 * g.shape[1]), device=g.device)
    return lambda: out.index_add_(0, seg_of_occ, payload)


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


def k2_bound_ms(u: int, d: int, rows: int = 0):
    """K2 Adagrad: the ``rows`` row ids read (``u`` by default; ``n`` on
    the whole slot, whose rows -1 are skipped) and the U rows' sums;
    table and accumulator read and written at the U touched rows.  Per
    element: two adds, a reciprocal square root, two products, a
    subtraction."""
    return bound(4 * ((rows or u) + 2 * d * u + 4 * d * u), 6 * u * d)


def k2t_sector_ms(torch, urows, d: int, v: int) -> float:
    """K2T counted in 32-byte sectors of device memory, at HBM bandwidth:
    the distinct sectors ``(c * v + urows) // 8`` that the stream's ids
    touch in the transposed ``[d, v]`` table, each read and written in
    the table and in the accumulator, and the entry stream (urows, sums)
    as it is."""
    cols = torch.arange(d, device=urows.device, dtype=torch.int64) * v
    sectors = torch.unique((cols[:, None] + urows.long()[None, :]) // 8)
    u = urows.numel()
    nbytes = 4 * 32 * sectors.numel() + 4 * (u + 2 * d * u)
    return nbytes / PEAK_BYTES_PER_S * 1e3


def k2p_sector_ms(u: int, d: int) -> float:
    """K2P counted in 32-byte sectors of device memory, at HBM bandwidth:
    a packed row starts on a 64-byte boundary, so its ``d`` columns span
    ``ceil(d / 8)`` sectors, each read and written in the table and in
    the accumulator; the entry stream (urows, sums) as it is."""
    nbytes = 4 * 32 * -(-d // 8) * u + 4 * (u + 2 * d * u)
    return nbytes / PEAK_BYTES_PER_S * 1e3


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


def field_tags(field_num: int) -> list:
    """Each of the 39 columns' token prefix: ``"<j mod P>:"`` for
    field-aware FM with ``field_num = P`` (column j on field j mod P),
    else none."""
    return [f"{j % field_num}:" if field_num else "" for j in range(39)]


def criteo_body(rng, n: int, field_num: int = 0) -> str:
    """``n`` label-less libsvm lines shaped like hashed Criteo-Kaggle
    rows: 13 integer features ``I<j>_<bucket>:<value>`` and 26
    categorical ``C<j>_<hex>:1`` tokens (39 features per line), each
    ``field:token:val`` with ``field_num``."""
    tag = field_tags(field_num)
    lines = []
    for _ in range(n):
        ints = rng.integers(0, INT_BUCKETS, 13)
        ivals = rng.uniform(0.0, 3.0, 13)
        cats = rng.integers(0, 1 << 32, 26)
        toks = [f"{tag[j]}I{j + 1}_{ints[j]}:{ivals[j]:.4f}"
                for j in range(13)]
        toks += [f"{tag[13 + j]}C{j + 1}_{cats[j]:08x}:1" for j in range(26)]
        lines.append(" ".join(toks))
    return "\n".join(lines) + "\n"


def write_labelled(np, path: str, rng, n: int, w_true,
                   field_num: int = 0) -> None:
    """``n`` labelled Criteo-shaped lines (``field:token:val`` with
    ``field_num``).  The label is planted: ``P(y = 1) = sigmoid(sum_j
    w_true[j, bucket_j])`` over the 13 integer features, so a model that
    learns the bucket weights lowers the logloss; the 26 categorical
    tokens are noise."""
    tag = field_tags(field_num)
    ints = rng.integers(0, INT_BUCKETS, (n, 13))
    ivals = rng.uniform(0.5, 1.5, (n, 13))
    cats = rng.integers(0, 1 << 32, (n, 26))
    score = w_true[np.arange(13), ints].sum(axis=1)
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-score))).astype(int)
    with open(path, "w") as f:
        for i in range(n):
            toks = [f"{tag[j]}I{j + 1}_{ints[i, j]}:{ivals[i, j]:.4f}"
                    for j in range(13)]
            toks += [f"{tag[13 + j]}C{j + 1}_{cats[i, j]:08x}:1"
                     for j in range(26)]
            f.write(f"{labels[i]} {' '.join(toks)}\n")


def post(conn, path: str, body: bytes) -> bytes:
    conn.request("POST", path, body=body,
                 headers={"Content-Length": str(len(body))})
    resp = conn.getresponse()
    data = resp.read()
    check(resp.status == 200, f"{path} answered {resp.status}: {data[:200]!r}")
    return data


def get_json(conn, path: str) -> dict:
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    check(resp.status == 200, f"{path} answered {resp.status}")
    return json.loads(data)


# -- quantized and overlay serving (paths 6 and 7) ------------------------


def requested_bytes(torch, which: str = "current") -> int:
    """The device bytes PyTorch's allocator was asked for (``current``
    or ``peak``), before its rounding: a block reused from its cache can
    count up to 1 MiB more in ``memory_allocated``."""
    return int(torch.cuda.memory_stats()[f"requested_bytes.all.{which}"])


def plain_served(torch, w0: float, rows, vals, fields=None,
                 factor_num: int = 0, field_num: int = 0):
    """The plain PyTorch score on the card of gathered f32 ``rows``
    (numpy ``[n, F, D]``): sigmoid(w0 + FM), or FFM's einsums."""
    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.ops.fm_kernels import fm_scores_plain

    dev = torch.device("cuda")
    rows_t = torch.from_numpy(rows).to(dev)
    vals_t = torch.from_numpy(vals).to(dev)
    w0_t = torch.tensor(float(w0), device=dev)
    with torch.inference_mode():
        if field_num:
            s = fm.ffm_scores_from_rows(
                w0_t, rows_t, vals_t, torch.from_numpy(fields).to(dev),
                factor_num, field_num)
        else:
            s = w0_t + fm_scores_plain(rows_t, vals_t)[0]
        return torch.sigmoid(s).cpu().numpy()


def serve_table(np, torch, cfg, requests, plain_rows, label: str) -> dict:
    """Serve ``cfg`` through ``serve()`` and post each request (``(text
    body, ids, vals, fields)``) over ``/score`` and ``/score_bin``: the
    transports must agree bitwise and the scores lie within KERNEL_TOL of
    :func:`plain_served` on ``plain_rows(ids)``.  Then each rung's
    dispatch p50 (50 dispatches straight through the scorer; the
    overlay's mean host gather a dispatch beside it).  Returns the
    record: the served scores, the FmScorer f32 launches of the
    requests alone, ``/status``'s serve block, the device memory the
    stack added (placement and warmup) and its peak during the requests
    (:func:`requested_bytes`), the scorer's staging bytes and placement
    seconds."""
    from fast_tffm_tpu_torch.ops.fm_kernels import fm_scores_cuda
    from fast_tffm_tpu_torch.serve import wire
    from fast_tffm_tpu_torch.serve.scorer import OverlayScorer
    from fast_tffm_tpu_torch.serve.server import serve

    k, pn = cfg.factor_num, cfg.field_num
    # The plain path once on this thread first: FFM's einsums allocate
    # the thread's cuBLAS workspace (32 MiB) at first use, which the
    # scorer's warmup would otherwise do inside the count.
    _, ids, vals, fields = requests[0]
    plain_served(torch, 0.0, plain_rows(ids[:1]), vals[:1],
                 None if fields is None else fields[:1], k, pn)
    # A closed stack's scorer can wait in a reference cycle for the
    # collector: collect first, so it is not freed inside the count.
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = requested_bytes(torch)
    t0 = time.perf_counter()
    handle = serve(cfg, port=0)
    up_s = time.perf_counter() - t0
    added = requested_bytes(torch) - base
    try:
        scorer = handle.scorer
        fm_scores_cuda.launches = 0
        conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                          timeout=120)
        served = []
        for body, ids, vals, fields in requests:
            frame = wire.encode_bin_request(ids, vals, fields)
            bin_scores = wire.decode_bin_response(
                post(conn, "/score_bin", frame))
            check(bin_scores.shape == (len(ids),), f"{label}: scores shape")
            if body is not None:
                text = post(conn, "/score", body.encode()).decode()
                check(text == "".join(f"{x:.6f}\n" for x in bin_scores),
                      f"{label}: /score and /score_bin disagree at "
                      f"n={len(ids)}")
            check(bool(np.isfinite(bin_scores).all()),
                  f"{label}: non-finite score")
            served.append(bin_scores)
        launches = fm_scores_cuda.launches
        status = get_json(conn, "/status")["serve"]
        conn.close()
        peak = requested_bytes(torch, "peak") - base
        dispatch, gather = {}, {}
        # The overlay's host gather a dispatch, from its own timer.
        gather_t = (handle.telemetry.timer("serve.overlay_gather")
                    if isinstance(scorer, OverlayScorer) else None)
        ids_all, vals_all, fields_all = requests[-1][1:]
        for b in scorer.ladder:
            times = []
            if gather_t is not None:
                n0, s0 = gather_t.count, gather_t.total_s
            for _ in range(50):
                t0 = time.perf_counter()
                scorer.score_rung(ids_all[:b], vals_all[:b],
                                  None if fields_all is None
                                  else fields_all[:b], b)
                times.append(time.perf_counter() - t0)
            dispatch[b] = p50(times) * 1e3
            if gather_t is not None:
                gather[b] = ((gather_t.total_s - s0)
                             / (gather_t.count - n0) * 1e3)
        record = {
            "launches": launches, "status": status,
            "dispatch_p50_ms": dispatch, "gather_ms": gather,
            "serve_up_s": up_s,
            "device_bytes_added": added, "peak_bytes_added": peak,
            "staging_bytes": scorer.staging_bytes(),
            "place_s": getattr(scorer, "place_wall_s", None),
            "warmup_s": scorer.warmup_wall_s, "scores": served,
            "telemetry": handle.telemetry,
        }
    finally:
        handle.close()
    worst = 0.0
    for (_, ids, vals, fields), got in zip(requests, served):
        want = plain_served(torch, plain_rows.w0, plain_rows(ids), vals,
                            fields, k, pn)
        np.testing.assert_allclose(got, want, **KERNEL_TOL)
        worst = max(worst, float(np.abs(got - want).max()))
    record["max_abs_err_vs_plain"] = worst
    del handle, scorer
    gc.collect()
    torch.cuda.empty_cache()
    return record


class Rows:
    """``rows(ids)``: the f32 rows ``[n, F, D]`` of ``ids [n, F]`` as
    ``gather`` (flat int64 ids -> ``[m, D]``) gives them on the host;
    ``w0`` the model's bias."""

    def __init__(self, w0: float, gather):
        self.w0, self._gather = w0, gather

    def __call__(self, ids):
        return self._gather(ids.reshape(-1).astype("int64")).reshape(
            *ids.shape, -1)


def check_table_record(np, name: str, rec: dict, fp32_scores, bound: float,
                       table_bytes: int, err_range) -> dict:
    """The checks a dense table's serve record must pass: scores within
    ``bound`` of the fp32 server's, ``serve.table_bytes`` and the device
    memory the placement added equal to ``table_bytes`` (beside the
    rungs' staging and w0) and ``/status``'s probe error in
    ``err_range`` (``(x, x)``: equal to x)."""
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(rec["scores"], fp32_scores))
    check(diff <= bound, f"{name}: {diff} from the fp32 server's scores, "
                         f"bound {bound}")
    gauges = rec["telemetry"].snapshot()["gauges"]
    check(gauges["serve.table_bytes"] == table_bytes,
          f"{name}: serve.table_bytes {gauges['serve.table_bytes']} != "
          f"{table_bytes}")
    extra = rec["device_bytes_added"] - table_bytes - rec["staging_bytes"]
    check(0 <= extra <= 64 << 10,
          f"{name}: placement added {rec['device_bytes_added']} B for a "
          f"{table_bytes} B table and {rec['staging_bytes']} B of staging")
    err = rec["status"]["quant_error_max"]
    lo, hi = err_range
    check((err == lo) if lo == hi else (lo < err <= hi),
          f"{name}: quant_error_max {err} outside {err_range}")
    return {
        "max_abs_diff_vs_fp32": diff, "bound": bound,
        "table_bytes": gauges["serve.table_bytes"],
        "table_mb_status": rec["status"]["table_mb"],
        "quant_error_max": err,
        "device_bytes_added": rec["device_bytes_added"],
        "staging_bytes": rec["staging_bytes"],
        "place_s": rec["place_s"], "warmup_s": rec["warmup_s"],
        "serve_up_s": rec["serve_up_s"],
        "dispatch_p50_ms": rec["dispatch_p50_ms"],
        "fm_scores_launches": rec["launches"],
        "max_abs_err_vs_plain": rec["max_abs_err_vs_plain"],
    }


def serve_requests(np, rng, cfg, field_num: int = 0) -> list:
    """One text request of each of SERVE_SIZES: ``(body, ids, vals,
    fields)`` as the server parses it."""
    from fast_tffm_tpu_torch.serve.textparse import parse_request

    out = []
    for n_req in SERVE_SIZES:
        body = criteo_body(rng, n_req, field_num)
        ids, vals, fields, got_n, trunc = parse_request(body, cfg)
        check(got_n == n_req and trunc == 0, f"parse of {n_req} lines")
        out.append((body, ids, vals, fields if field_num else None))
    return out


def dense_tables(np, torch, cfg32, model_dir: str, tmp: str, requests,
                 label: str, dtypes) -> tuple:
    """Serve the fp32 ``params.npz`` under ``model_dir``, then each of
    ``dtypes``: ``("bf16" | "int8", "quant.npz" | "placed")``, a
    ``quant.npz`` the port's convert tool writes (timed) or the fp32
    checkpoint quantized at placement, on the same requests.  Returns
    ``(record, FmScorer f32 launches of the requests)``."""
    from fast_tffm_tpu_torch.ops import quant
    from fast_tffm_tpu_torch.tools import convert_checkpoint
    from fast_tffm_tpu_torch.train import checkpoint

    V, D = cfg32.vocabulary_size, cfg32.embedding_dim
    _, model = checkpoint.restore_params(model_dir, device="cpu")
    w0 = float(model.w0.detach())
    table = model.table.detach().numpy()
    del model
    rec = serve_table(np, torch, cfg32, requests,
                      Rows(w0, lambda ids: table[ids]), f"{label} fp32")
    fp32_scores = rec["scores"]
    record = {"fp32": check_table_record(np, f"{label} fp32", rec,
                                         fp32_scores, 0.0, V * D * 4,
                                         (0.0, 0.0))}
    launches = rec["launches"]
    convert_s = {}
    for dtype, source in dtypes:
        name = f"{dtype}_{source.split('.')[0]}"
        cfg = dataclasses.replace(cfg32, serve_table_dtype=dtype,
                                  quant_chunk=QUANT_CHUNK)
        if source == "quant.npz":
            out = os.path.join(tmp, f"{label}_{dtype}")
            t0 = time.perf_counter()
            check(convert_checkpoint.main([
                model_dir, "--to", dtype, "--out", out,
                "--chunk", str(QUANT_CHUNK)]) == 0, f"convert to {dtype}")
            convert_s[dtype] = time.perf_counter() - t0
            cfg = dataclasses.replace(cfg, model_file=out)
            _, qw0, qt = checkpoint.restore_quant(out)
            err_range = (-1.0, -1.0)
        else:
            qw0, qt = w0, quant.quantize_table(table, dtype, QUANT_CHUNK)
            err_range = (0.0, SERVE_BOUND[dtype])
        rec = serve_table(
            np, torch, cfg, requests,
            Rows(qw0, lambda ids, qt=qt: quant.dequantize_rows(qt, ids)),
            f"{label} {name}")
        record[name] = check_table_record(
            np, f"{label} {name}", rec, fp32_scores, SERVE_BOUND[dtype],
            qt.nbytes, err_range)
        launches += rec["launches"]
    record["convert_s"] = convert_s
    del table
    return record, launches


def quant_phase(np, torch, card: str, rng, model_dir: str,
                tmp: str) -> tuple:
    """Phase 8b, path 6: the main run's checkpoint (Criteo-Kaggle, V =
    2^22, D = 9) served in fp32, as the bf16 and the int8 (chunk 64)
    ``quant.npz`` the port's convert tool writes, and quantized to int8
    at placement.  Returns ``(record, FmScorer f32 launches)``."""
    from fast_tffm_tpu_torch.config import load_config

    cfg32 = load_config(CFG_PATH, {"serve_poll_secs": 0.0, "serve_port": 0,
                                   "model_file": model_dir})
    requests = serve_requests(np, rng, cfg32)
    record, launches = dense_tables(
        np, torch, cfg32, model_dir, tmp, requests, "quant",
        (("bf16", "quant.npz"), ("int8", "quant.npz"), ("int8", "placed")))
    for name in ("fp32", "bf16_quant", "int8_quant", "int8_placed"):
        check(record[name]["fm_scores_launches"] > 0,
              f"quant {name}: the FmScorer never launched")
    record["card"] = card
    record["fm_scores_launches"] = launches
    return record, launches


def overlay_phase(np, torch, card: str, rng) -> tuple:
    """Phase 12, path 7: a ``tiered.npz`` at ``examples/
    criteo_1tb_dist.cfg``'s V = 2^26, D = 9 (its mesh, lookup and batch
    overridden for one device), written by ``save_tiered`` from a
    virtual ``ColdStore`` holding OVERLAY_ROWS seeded rows, in cold
    dtype fp32 and int8, served through ``serve()``.  Returns
    ``(record, FmScorer f32 launches)``."""
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.train import checkpoint, tiered

    tmp_ctx = tempfile.TemporaryDirectory(prefix="chip_smoke_overlay_")
    overrides = {"mesh_data": 1, "mesh_model": 1, "lookup": "auto",
                 "batch_size": 4096, "serve_poll_secs": 0.0,
                 "serve_port": 0, "table_tiering": "on"}
    record = {"card": card, "config": "examples/criteo_1tb_dist.cfg",
              "overrides": dict(overrides), "written_rows": OVERLAY_ROWS}
    launches = 0
    for cold in ("fp32", "int8"):
        cfg = load_config(DIST_CFG_PATH, {
            **overrides, "cold_dtype": cold,
            "model_file": os.path.join(tmp_ctx.name, f"tiered_{cold}")})
        V, F, D = cfg.vocabulary_size, cfg.max_features, cfg.embedding_dim
        check((V, F, D) == (1 << 26, 39, 9),
              f"unexpected Criteo-1TB shape {V, F, D}")
        gen = np.random.default_rng(SEED)  # the same rows in each dtype
        written = gen.choice(V, OVERLAY_ROWS, replace=False)
        rows = gen.uniform(-0.05, 0.05, (OVERLAY_ROWS, D)).astype(
            np.float32)
        w0 = -0.05
        store = tiered._virtual_store(cfg, "table")
        t0 = time.perf_counter()
        store.scatter(written, rows)
        scatter_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        path = checkpoint.save_tiered(
            cfg.model_file, 1, {"w0": np.float32(w0)},
            {"table": {**store.export(), "descriptor": store.descriptor}})
        save_s = time.perf_counter() - t0
        del rows
        # Text requests (hashed tokens: almost all never written) and
        # binary ones half of written ids, the last at the largest size.
        requests = serve_requests(np, rng, cfg)
        for n_req in (64, 256, 1024, 1500):
            hit = rng.random((n_req, F)) < 0.5
            ids = np.where(hit, written[rng.integers(0, OVERLAY_ROWS,
                                                     (n_req, F))],
                           rng.integers(0, V, (n_req, F))).astype(np.int32)
            vals = rng.uniform(0.1, 1.5, (n_req, F)).astype(np.float32)
            requests.append((None, ids, vals, None))
        rec = serve_table(np, torch, cfg, requests, Rows(w0, store.gather),
                          f"overlay {cold}")
        check(rec["launches"] > 0,
              f"overlay {cold}: the FmScorer never launched")
        check("table_mb" not in rec["status"]
              and "quant_error_max" not in rec["status"],
              f"overlay {cold}: a table gauge on /status")
        largest = tiered._bucket(max(cfg.serve_ladder) * F) * D * 4
        check(rec["peak_bytes_added"] <= rec["staging_bytes"] + largest,
              f"overlay {cold}: peak {rec['peak_bytes_added']} B past the "
              f"staging {rec['staging_bytes']} B and a bucket of "
              f"{largest} B")
        check(rec["peak_bytes_added"] < V * D * 4 // 64,
              f"overlay {cold}: a table-sized allocation")
        record[cold] = {
            "scatter_s": scatter_s, "save_s": save_s,
            "file_bytes": os.path.getsize(path),
            "host_store_bytes": store.nbytes,
            "dispatch_p50_ms": rec["dispatch_p50_ms"],
            "gather_ms_per_dispatch": rec["gather_ms"],
            "overlay_gather_p50_ms": rec["status"].get(
                "overlay_gather_p50_ms"),
            "peak_bytes_added": rec["peak_bytes_added"],
            "staging_bytes": rec["staging_bytes"],
            "largest_bucket_bytes": largest,
            "serve_up_s": rec["serve_up_s"], "warmup_s": rec["warmup_s"],
            "fm_scores_launches": rec["launches"],
            "max_abs_err_vs_plain": rec["max_abs_err_vs_plain"],
        }
        launches += rec["launches"]
        del store, written, requests
    tmp_ctx.cleanup()
    record["fm_scores_launches"] = launches
    return record, launches


# -- tiered phase (path 8) ----------------------------------------------


def timed_trainer(torch, trainer_cls):
    """``trainer_cls`` keeping the host seconds of each tiered plan (on
    the transfer thread) and a CUDA event pair around each migration (on
    the dispatch stream)."""

    class Timed(trainer_cls):
        def __init__(self, cfg):
            self.plan_s, self.migration_events = [], []
            super().__init__(cfg)

        def _plan_group(self, group):
            t0 = time.perf_counter()
            out = super()._plan_group(group)
            self.plan_s.append(time.perf_counter() - t0)
            return out

        def _apply_migration(self, shipment):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = super()._apply_migration(shipment)
            b.record()
            self.migration_events.append((a, b))
            return out

        def timings(self) -> dict:
            torch.cuda.synchronize()
            mig = [a.elapsed_time(b) for a, b in self.migration_events]
            return {"plans": len(self.plan_s),
                    "plan_ms_mean": 1e3 * sum(self.plan_s) / max(
                        len(self.plan_s), 1),
                    "plan_ms_max": 1e3 * max(self.plan_s, default=0.0),
                    "migration_device_ms_mean": sum(mig) / max(len(mig), 1),
                    "migration_device_ms_max": max(mig, default=0.0)}

    return Timed


def slot_spies(sparse_apply, n: int):
    """Wrap K1's and K2's wrappers (the module attributes the step calls)
    to note whether each call took the cut ``[U + 1]`` slot (``U < n``)
    or the whole ``[n + 1]`` one.  A wrapper counts its launches on the
    module attribute, the spy meanwhile: ``restore`` adds them back to
    the wrapped function's count.  Returns ``(notes, restore)``."""
    notes = {"k1_cut": 0, "k1_whole": 0, "k2_cut": 0, "k2_whole": 0}
    k1, k2 = sparse_apply.k1_dedup_cuda, sparse_apply.k2_apply_cuda

    def k1_spy(g_rows, ids, perm, seg_start):
        notes["k1_cut" if seg_start.numel() <= n else "k1_whole"] += 1
        return k1(g_rows, ids, perm, seg_start)

    def k2_spy(optimizer, urows, sums, tables, hyper):
        notes["k2_cut" if urows.numel() < n else "k2_whole"] += 1
        return k2(optimizer, urows, sums, tables, hyper)

    k1_spy.launches = k2_spy.launches = 0
    sparse_apply.k1_dedup_cuda, sparse_apply.k2_apply_cuda = k1_spy, k2_spy

    def restore():
        sparse_apply.k1_dedup_cuda, sparse_apply.k2_apply_cuda = k1, k2
        k1.launches += k1_spy.launches
        k2.launches += k2_spy.launches

    return notes, restore


def write_zipf_lines(np, paths, rng, lines: int, vocab: int) -> np.ndarray:
    """The reference bench's tiered data (``bench.py::_zipf_ids``,
    ``_gen_libsvm_files``): ``lines`` labelled lines split over
    ``paths``, 39 Zipf(1.1) ids hash-spread over ``vocab`` each, values
    ``0.<4 digits>``.  Returns the ids ``[lines, 39]``."""
    z = rng.zipf(1.1, size=(lines, 39)).astype(np.uint64)
    ids = ((z * np.uint64(0x9E3779B97F4A7C15)) % np.uint64(vocab)).astype(
        np.int64)
    val4 = rng.integers(1000, 10000, size=(lines, 39))
    labels = rng.integers(0, 2, size=lines)
    per = lines // len(paths)
    for k, path in enumerate(paths):
        with open(path, "w") as f:
            for i in range(k * per, (k + 1) * per):
                f.write(f"{labels[i]} " + " ".join(
                    f"{a}:0.{b}" for a, b in zip(ids[i].tolist(),
                                                 val4[i].tolist())) + "\n")
    return ids


def tiered_parity(np, torch, card: str, tcfg, main: dict, tmp: str,
                  kernels: dict, valid_file: str) -> tuple:
    """Path 8 (a): ``examples/criteo_kaggle.cfg`` with ``table_tiering =
    on`` and ``hot_rows = TIERED_HOT`` over the main run's 16 steps,
    held against the main run's dense trainer from the same seed (the
    merged table, accumulator, w0 and its slot: bitwise expected, the
    tile-vs-scatter bounds required), then validated against the main
    run's validation and predicted through the CLI against its predict
    file.  Returns ``(record, launches)``."""
    from fast_tffm_tpu_torch import cli
    from fast_tffm_tpu_torch.ops import sparse_apply
    from fast_tffm_tpu_torch.train import checkpoint
    from fast_tffm_tpu_torch.train.loop import Trainer

    model_dir = os.path.join(tmp, "tiered_model")
    acfg = dataclasses.replace(
        tcfg, table_tiering="on", hot_rows=TIERED_HOT, model_file=model_dir,
        validation_files=[], predict_files=[])
    n = acfg.batch_size * acfg.max_features
    zero_launches(kernels)
    notes, restore = slot_spies(sparse_apply, n)
    try:
        t0 = time.perf_counter()
        trainer = timed_trainer(torch, Trainer)(acfg)
        res = trainer.train()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        restore()
    launches = read_launches(kernels)
    tr, snap = res["train"], res["train"]["tiered"]
    steps = tr["steps"]
    check(steps == main["steps"], f"tiered trained {steps} steps")
    for name in ("fm_scores", "fm_grad", "k1_dedup", "k2_apply"):
        check(launches[name] == steps,
              f"tiered: {name} launched {launches[name]} times in {steps} "
              f"steps")
    check(notes["k1_cut"] == notes["k2_cut"] == steps
          and notes["k1_whole"] == notes["k2_whole"] == 0,
          f"tiered: K1/K2 not on the cut slot every step: {notes}")
    check(tr["graph_dispatches"] == 0 and tr["eager_dispatches"] == steps,
          f"tiered dispatches: {tr['graph_dispatches']} graphed")
    check(snap["rows_evicted"] > 0 and 0.0 < snap["hot_hit_frac"] < 1.0,
          f"tiered: no eviction churn: {snap}")
    merged = trainer.tiered.merged_dense(trainer._hot_host_tables())
    got = {"table": merged[0], "acc": merged[1],
           "w0": trainer.model.w0.detach().cpu().numpy(),
           "acc_w0": trainer.opt_state.acc_w0.cpu().numpy()}
    cmp = {}
    for name, tol in (("table", TABLE_TOL), ("acc", OPT_TOL),
                      ("w0", TABLE_TOL), ("acc_w0", OPT_TOL)):
        a, b = np.asarray(got[name]), np.asarray(main[name])
        check(a.shape == b.shape, f"tiered {name} shape {a.shape}")
        np.testing.assert_allclose(a, b, **tol)
        cmp[name] = {"bitwise": bool(np.array_equal(
            a.view(np.uint32), b.view(np.uint32))),
            "max_abs_diff": float(np.abs(a - b).max())}
    t0 = time.perf_counter()
    val = trainer.evaluate([valid_file])
    val_s = time.perf_counter() - t0
    for key in ("logloss", "auc"):
        check(abs(val[key] - main["validation"][key]) <= 1e-6,
              f"tiered validation {key} {val[key]} against the dense "
              f"{main['validation'][key]}")
    check(checkpoint.exists(model_dir)
          and not checkpoint.exists_tiered(model_dir),
          "tiered (a) did not save the merged params.npz")
    with open(CFG_PATH) as f:
        text = f.read()
    scores = os.path.join(tmp, "tiered_scores.txt")
    for key, value in (("model_file", model_dir),
                       ("predict_files", main["predict_file"]),
                       ("score_path", scores)):
        text = re.sub(rf"(?m)^{key} = .*$", f"{key} = {value}", text)
    cfg_path = os.path.join(tmp, "tiered_predict.cfg")
    with open(cfg_path, "w") as f:
        f.write(text)
    t0 = time.perf_counter()
    check(cli.main(["predict", cfg_path]) == 0, "tiered cli predict failed")
    predict_s = time.perf_counter() - t0
    with open(scores) as f:
        predicted = f.read()
    diff = max(abs(float(a) - float(b)) for a, b in zip(
        predicted.split(), main["scores_text"].split()))
    check(len(predicted.split()) == len(main["scores_text"].split())
          and diff <= 1.01e-6,
          f"tiered cli predict differs from the dense run's by {diff}")
    record = {
        "card": card, "config": "examples/criteo_kaggle.cfg",
        "hot_rows": TIERED_HOT, "steps": steps, "train_wall_s": wall,
        "examples_per_sec_end_to_end": tr["examples_per_sec"],
        "ingest_wait_frac": tr["ingest_wait_frac"],
        "launches": launches, "slots": notes, "tiered": snap,
        "vs_dense": cmp, "validation": {"logloss": val["logloss"],
                                        "auc": val["auc"]},
        "validation_equal": all(val[k] == main["validation"][k]
                                for k in ("logloss", "auc")),
        "validation_s": val_s, "cli_predict_s": predict_s,
        "predict_max_abs_diff": diff,
        "predict_file_equal": predicted == main["scores_text"],
        **trainer.timings(),
    }
    del trainer, merged, got
    gc.collect()
    torch.cuda.empty_cache()
    return record, launches


def tiered_bench(np, torch, card: str, tmp: str, kernels: dict) -> tuple:
    """Path 8 (b): the reference bench's tiered shape (``bench.py::
    _bench_tiered``): V = 2^28, ``hot_rows`` = 2^20, D = 9, F = 39,
    B = 4096, K = 8, ``learning_rate`` 0.05, the prestacked epoch cache
    over 12 batches of Zipf(1.1) lines, a virtual cold store; fp32 over
    TIERED_EPOCHS epochs (saved as ``tiered.npz`` and served through
    ``serve()``'s ``OverlayScorer`` against a host scoring of the cold
    store's rows), bf16 and int8 cold rows over TIERED_SHORT_EPOCHS.
    Returns ``(record, launches)``."""
    from fast_tffm_tpu_torch.config import FmConfig
    from fast_tffm_tpu_torch.train import checkpoint
    from fast_tffm_tpu_torch.train.loop import Trainer

    vocab, hot, batch, k = 1 << 28, 1 << 20, 4096, 8
    rng = np.random.default_rng(SEED + 11)
    files = [os.path.join(tmp, f"zipf_{i}.libsvm") for i in range(2)]
    t0 = time.perf_counter()
    ids = write_zipf_lines(np, files, rng, TIERED_BATCHES * batch, vocab)
    data_s = time.perf_counter() - t0
    record = {"card": card, "source": "bench.py::_bench_tiered",
              "vocab": vocab, "hot_rows": hot, "batch_size": batch,
              "steps_per_dispatch": k, "data_s": data_s,
              "batches_per_epoch": TIERED_BATCHES,
              "dense_table_bytes": vocab * 9 * 4,
              "reduced": {"epochs_bf16_int8": TIERED_SHORT_EPOCHS}}
    totals = dict.fromkeys(kernels, 0)
    Timed = timed_trainer(torch, Trainer)
    for dtype, epochs in (("fp32", TIERED_EPOCHS),
                          ("bf16", TIERED_SHORT_EPOCHS),
                          ("int8", TIERED_SHORT_EPOCHS)):
        cfg = FmConfig(
            vocabulary_size=vocab, factor_num=8, max_features=39,
            batch_size=batch, learning_rate=0.05,
            model_file=os.path.join(tmp, f"tiered_{dtype}"), log_steps=0,
            thread_num=8, epoch_num=epochs, steps_per_dispatch=k,
            cache_epochs=True, cache_prestacked=True,
            cache_max_bytes=4 << 30, train_files=files, save_steps=0,
            table_tiering="on", hot_rows=hot, cold_dtype=dtype, seed=SEED,
            serve_poll_secs=0.0, serve_port=0)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_launches(kernels)
        t0 = time.perf_counter()
        trainer = Timed(cfg)
        res = trainer.train()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = read_launches(kernels)
        tr, snap = res["train"], res["train"]["tiered"]
        steps = tr["steps"]
        check(steps == epochs * TIERED_BATCHES,
              f"tiered {dtype}: {steps} steps")
        for name in ("fm_scores", "fm_grad", "k1_dedup", "k2_apply"):
            check(launches[name] == steps,
                  f"tiered {dtype}: {name} launched {launches[name]} times "
                  f"in {steps} steps")
            totals[name] += launches[name]
        check(peak < vocab * 9 * 4 // 16,
              f"tiered {dtype}: peak device memory {peak} B")
        check(checkpoint.exists_tiered(cfg.model_file)
              and not checkpoint.exists(cfg.model_file),
              f"tiered {dtype}: no tiered.npz saved")
        check(snap["cold_dtype"] == dtype and snap["hot_hit_frac"] > 0,
              f"tiered {dtype}: {snap}")
        rec = {"epochs": epochs, "steps": steps, "wall_s": wall,
               "examples_per_sec_end_to_end": tr["examples_per_sec"],
               "ingest_wait_frac": tr["ingest_wait_frac"],
               "dispatches": tr["dispatches"],
               "first_dispatch_s": tr["first_dispatch_s"],
               "peak_device_bytes": peak, "tiered": snap,
               "file_bytes": os.path.getsize(
                   checkpoint.tiered_path(cfg.model_file)),
               # The result's counters are taken before the final save;
               # after it every row the run touched is in the store.
               "cold_store_bytes_after_save":
                   trainer.tiered.snapshot()["cold_store_bytes"],
               **trainer.timings()}
        if dtype == "fp32":
            store = trainer.tiered.stores[0]
            w0 = float(trainer.model.w0.detach())
            seen = ids[rng.integers(0, len(ids), 1500)]
            requests = []
            for n_req in (64, 1500):
                hit = rng.random((n_req, 39)) < 0.5
                rids = np.where(hit, seen[:n_req],
                                rng.integers(0, vocab, (n_req, 39)))
                vals = rng.uniform(0.1, 1.0, (n_req, 39)).astype(np.float32)
                requests.append((None, rids.astype(np.int32), vals, None))
            served = serve_table(np, torch, cfg, requests, Rows(w0, store.gather),
                                 "tiered fp32")
            check(served["launches"] > 0, "tiered serve: FmScorer never ran")
            check(served["peak_bytes_added"] < vocab * 9 * 4 // 16,
                  "tiered serve: a table-sized allocation")
            rec["serve"] = {
                "fm_scores_launches": served["launches"],
                "max_abs_err_vs_plain": served["max_abs_err_vs_plain"],
                "dispatch_p50_ms": served["dispatch_p50_ms"],
                "gather_ms_per_dispatch": served["gather_ms"],
                "peak_bytes_added": served["peak_bytes_added"],
                "serve_up_s": served["serve_up_s"]}
            totals["fm_scores"] += served["launches"]
            del store
        record[dtype] = rec
        del trainer
    return record, totals


# -- sharded phase (main path 3) -----------------------------------------


# -- dense phase (path 9) -----------------------------------------------


def dense_update_bound_ms(optimizer: str, v: int, d: int):
    """The whole-table update of ``apply_dense``: each ``[V, D]`` f32
    table it reads counted once, each it writes once (Adam reads the table, the gradient and both moments and writes the
    table and both moments; Adagrad reads the table, the gradient and
    its accumulator and writes two).  Operations an element: Adam's two
    moments (five), the bias corrections and the quotient (five), the
    step (two); Adagrad's accumulator (two), ``rsqrt`` and its select
    (three), the step (three)."""
    reads, writes, ops = {"adam": (4, 3, 12), "adagrad": (3, 2, 8)}[optimizer]
    return bound(4 * v * d * (reads + writes), ops * v * d)


def dense_parity(torch, fm, optimizers, dense, cfg, dev_batches,
                 applied: list) -> dict:
    """Path 9's 3 steps of ``dense_step`` through the kernels against 3
    through their plain versions from one seeded table: each step's
    scores at ``KERNEL_TOL`` and the gradient it applies (``applied``
    gets each step's ``(dw0, dtable)``) at ``TABLE_TOL``.  Adagrad runs
    free, its table at ``TABLE_TOL`` and its state at ``OPT_TOL`` after
    the three steps.  Adam's plain run restarts each step from the
    kernel run's state, so a step's difference is its own: the moments
    at ``OPT_TOL``, the count equal, the table at ``TABLE_TOL`` wherever
    the step's gradients agree to ``DENSE_GRAD_RTOL`` (at most a
    hundredth of the table may not; those elements are counted and
    their largest difference kept)."""
    dev = torch.device("cuda")
    adam = cfg.optimizer == "adam"
    init = fm.init_params(cfg, torch.Generator(device=dev).manual_seed(7),
                          device=dev)
    models = [fm.FmModel(init.w0.detach().clone(),
                         init.table.detach().clone()) for _ in range(2)]
    opts = [optimizers.init_dense_opt_state(cfg, m) for m in models]

    def leaves(i):
        return [models[i].table, models[i].w0, *opts[i]]

    rec = {"steps": len(dev_batches), "scores_max_abs_err": 0.0,
           "grad_max_abs_err": 0.0, "table_max_abs_err": 0.0,
           "state_max_abs_err": 0.0}
    if adam:
        rec.update(ill_conditioned=0, ill_conditioned_max_abs_err=0.0)
    for b in dev_batches:
        if adam:
            with torch.no_grad():
                for a, b_ in zip(leaves(0), leaves(1)):
                    b_.copy_(a)
        s_k = dense.dense_step(cfg, models[0], opts[0], b)
        s_p = dense.dense_step(cfg, models[1], opts[1], b, plain=True)
        (gw_k, g_k), (gw_p, g_p) = applied[-2:]
        torch.testing.assert_close(s_k, s_p, **KERNEL_TOL)
        torch.testing.assert_close(g_k, g_p, **TABLE_TOL)
        torch.testing.assert_close(gw_k, gw_p, **TABLE_TOL)
        rec["scores_max_abs_err"] = max(rec["scores_max_abs_err"],
                                        float((s_k - s_p).abs().max()))
        rec["grad_max_abs_err"] = max(rec["grad_max_abs_err"],
                                      float((g_k - g_p).abs().max()))
        if adam:
            t_k, t_p = models[0].table.detach(), models[1].table.detach()
            ok = (g_k - g_p).abs() <= DENSE_GRAD_RTOL * g_p.abs()
            check(int((~ok).sum()) <= ok.numel() // 100,
                  f"Adam: {int((~ok).sum())} gradient elements differ by "
                  f"more than {DENSE_GRAD_RTOL} of themselves")
            torch.testing.assert_close(t_k[ok], t_p[ok], **TABLE_TOL)
            rec["table_max_abs_err"] = max(rec["table_max_abs_err"], float(
                (t_k[ok] - t_p[ok]).abs().max()))
            rec["ill_conditioned"] += int((~ok).sum())
            if not bool(ok.all()):
                rec["ill_conditioned_max_abs_err"] = max(
                    rec["ill_conditioned_max_abs_err"],
                    float((t_k[~ok] - t_p[~ok]).abs().max()))
            check_state(torch, rec, opts)
        del applied[:]
    torch.cuda.synchronize()
    if not adam:
        torch.testing.assert_close(models[0].table, models[1].table,
                                   **TABLE_TOL)
        torch.testing.assert_close(models[0].w0, models[1].w0, **TABLE_TOL)
        rec["table_max_abs_err"] = float(
            (models[0].table - models[1].table).detach().abs().max())
        check_state(torch, rec, opts)
    rec["elements"] = models[0].table.numel()
    return rec


def check_state(torch, rec: dict, opts) -> None:
    """Two optimizer states alike: floating leaves at ``OPT_TOL`` (the
    largest difference kept in ``rec``), integer ones equal."""
    for a, b in zip(*opts):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, **OPT_TOL)
            rec["state_max_abs_err"] = max(rec["state_max_abs_err"],
                                           float((a - b).abs().max()))
        else:
            check(torch.equal(a, b), f"optimizer counts {a} and {b}")


def dense_phase(np, torch, card: str, rng, files, valid_file: str,
                predict_file: str, batches, tmp: str, kernels: dict) -> tuple:
    """Phase 14, path 9: the dense optax path (``sparse_update = false``,
    ``l2_mode = full`` with both lambdas 1e-4) on
    ``examples/criteo_kaggle.cfg`` at full width, over phase 5's 16 steps
    of synthetic lines.  (1) Adam and Adagrad in f32 through
    ``Trainer.train()``, every count from 0 (the path's launches): each
    step FmScorer, FmGrad, K1's merge mode and K-place, no K1 dedup or
    K2; one eager dispatch and 15 graph replays; each run's eager twin
    (the trainer's ``graph`` set to None) bitwise equal (table, w0,
    every optimizer leaf, Adam's count, metrics); the Adam run validated.
    (2) ``python -m fast_tffm_tpu_torch.cli predict`` of the Adam run's
    ``params.npz`` (one probability a line), and its ``/score`` through
    ``serve()`` equal to the predict file.  (3) A warm start from that
    file continues at the saved count (16, bitwise moments) for 4 more
    steps.  (4) 4 bf16 Adam steps beside 4 f32 ones on the same batches
    (the bf16 kernels every step, the last logloss within 1e-2).  (5) 4
    Adam steps of FFM-Criteo (``field_num = 4``, D = 33): K1's merge mode
    and K-place every step, no FmScorer or FmGrad.  (6) 3 steps of
    ``train.dense.dense_step`` through the kernels against 3 through the
    plain versions, Adam and Adagrad (``dense_parity``).  (7) The Adam step on a device
    batch, eager and graphed (p50, device time by op, idle share); the
    whole-table update alone (``optimizers.apply_dense``, Adam and
    Adagrad) timed in CUDA graphs and by op against its byte bound, and
    the gradient's K1 merge and K-place at the step's shapes.  Returns
    ``(record, launches)``: the launches of (1), (4) and (5)."""
    from fast_tffm_tpu_torch import cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.ops import sparse_apply
    from fast_tffm_tpu_torch.serve.server import serve
    from fast_tffm_tpu_torch.train import dense, optimizers, sparse
    from fast_tffm_tpu_torch.train.loop import Trainer

    dev = torch.device("cuda")
    record = {"card": card, "config": "examples/criteo_kaggle.cfg",
              "overrides": {"sparse_update": False, "l2_mode": "full",
                            "factor_lambda": DENSE_LAMBDA,
                            "bias_lambda": DENSE_LAMBDA},
              "adam_learning_rate": DENSE_ADAM_LR}
    launches = dict.fromkeys(kernels, 0)

    def config(**kw):
        if kw.get("optimizer") == "adam":
            kw.setdefault("learning_rate", DENSE_ADAM_LR)
        return load_config(CFG_PATH, {
            **record["overrides"], "train_files": list(files),
            "validation_files": [], "predict_files": [],
            "model_file": os.path.join(tmp, "dense_model"),
            "log_steps": 0, "save_steps": 0, "seed": SEED,
            "serve_poll_secs": 0.0, "serve_port": 0, **kw})

    class LossTrainer(Trainer):
        def __init__(self, cfg):
            self.step_losses = []
            super().__init__(cfg)

        def dispatch(self, sb, pause=None):
            losses = super().dispatch(sb, pause)
            self.step_losses.append(losses.clone())
            return losses

    def run(cfg, graphs: bool = True, count: bool = False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # What the process holds already (earlier phases' tensors): the
        # run's own peak is the peak over it.
        held = torch.cuda.memory_allocated()
        zero_launches(kernels)
        t0 = time.perf_counter()
        trainer = LossTrainer(cfg)
        check(not trainer.sparse, "the dense config trained sparse")
        if not graphs:
            trainer.graph = None
        res = trainer.train()
        torch.cuda.synchronize()
        got = read_launches(kernels)
        if count:
            for name in launches:
                launches[name] += got[name]
        tr = res["train"]
        losses = torch.cat(trainer.step_losses).tolist()
        check(all(np.isfinite(losses)), f"non-finite dense loss {losses}")
        return trainer, res, {
            "steps": tr["steps"], "launches": got,
            "dispatches": tr["dispatches"],
            "graph_dispatches": tr["graph_dispatches"],
            "eager_dispatches": tr["eager_dispatches"],
            "step_logloss": losses, "train_logloss": tr["logloss"],
            "wall_s": time.perf_counter() - t0,
            "examples_per_sec_end_to_end": tr["examples_per_sec"],
            "peak_device_mb": torch.cuda.max_memory_allocated() / 2**20,
            "peak_added_device_mb":
                (torch.cuda.max_memory_allocated() - held) / 2**20,
        }

    def state(trainer):
        m = trainer.metrics
        return [trainer.model.table, trainer.model.w0, *trainer.opt_state,
                m.loss_sum, m.weight_sum, m.count, m.auc.pos, m.auc.neg]

    def check_path(what, rec, steps, mode="", fm_kernels=True):
        got, n = rec["launches"], rec["steps"]
        check(n == steps, f"{what}: trained {n} steps")
        want = {f"fm_scores{mode}": n if fm_kernels else 0,
                f"fm_grad{mode}": n if fm_kernels else 0,
                "k1_merge": n, "kplace": n, "k1_dedup": 0, "k2_apply": 0}
        check(all(got[k] == v for k, v in want.items()),
              f"{what}: launches {got}, want {want}")
        check(rec["eager_dispatches"] == 1
              and rec["graph_dispatches"] == rec["dispatches"] - 1 > 0,
              f"{what}: {rec['graph_dispatches']} graph and "
              f"{rec['eager_dispatches']} eager dispatches")

    # -- (1) Adam and Adagrad, graphed and eager ------------------------
    steps = TRAIN_FILES * BATCHES_PER_FILE
    adam_dir = os.path.join(tmp, "dense_adam")
    runs = {}
    for optimizer in ("adam", "adagrad"):
        model_dir = os.path.join(tmp, f"dense_{optimizer}")
        cfg = config(optimizer=optimizer, model_file=model_dir)
        check(cfg.steps_per_dispatch == 1 and cfg.host_sort,
              "the dense phase's config is not K = 1 with the host sort")
        graphed, _, g_rec = run(cfg, count=True)
        # Validation is the graphed run's own (its fm_scores launches
        # are counted after the check of the step's).
        check_path(f"dense {optimizer}", g_rec, steps)
        eager, _, e_rec = run(dataclasses.replace(
            cfg, model_file=model_dir + "_eager"), graphs=False)
        check(e_rec["eager_dispatches"] == e_rec["dispatches"] == steps,
              f"dense {optimizer} eager twin: {e_rec}")
        check(all(torch.equal(a, b) for a, b in
                  zip(state(graphed), state(eager))),
              f"dense {optimizer}: the graphed run is not bitwise the "
              f"eager one")
        if optimizer == "adam":
            check(int(graphed.opt_state.count) == steps,
                  f"Adam's count {int(graphed.opt_state.count)}")
            zero_launches(kernels)
            val = graphed.evaluate([valid_file])
            for name, n in read_launches(kernels).items():
                launches[name] += n
            check(np.isfinite(val["logloss"]) and 0 < val["auc"] <= 1,
                  f"dense validation {val}")
            g_rec["validation"] = {"logloss": val["logloss"],
                                   "auc": val["auc"]}
        g_rec["graph_pool_bytes"] = graphed.graph.pool_bytes()
        g_rec["capture_s"] = graphed.graph.capture_s
        g_rec["eager_twin"] = {
            "bitwise": True, "wall_s": e_rec["wall_s"],
            "peak_added_device_mb": e_rec["peak_added_device_mb"]}
        runs[optimizer] = g_rec
        del graphed, eager
        gc.collect()
        torch.cuda.empty_cache()
    record["runs"] = runs

    # -- (2) CLI predict and a /score round trip ------------------------
    with open(CFG_PATH) as f:
        text = f.read()
    scores_path = os.path.join(tmp, "dense_scores.txt")
    for key, value in (("model_file", adam_dir),
                       ("predict_files", predict_file),
                       ("score_path", scores_path)):
        text = re.sub(rf"(?m)^{key} = .*$", f"{key} = {value}", text)
    cfg_path = os.path.join(tmp, "dense_predict.cfg")
    with open(cfg_path, "w") as f:
        f.write(text)
    zero_launches(kernels)
    t0 = time.perf_counter()
    check(cli.main(["predict", cfg_path]) == 0, "dense cli predict failed")
    predict_s = time.perf_counter() - t0
    with open(scores_path) as f:
        predicted = f.read().split()
    check(len(predicted) == LINES
          and all(0.0 < float(s) < 1.0 for s in predicted),
          f"dense cli predict wrote {len(predicted)} scores")
    with open(predict_file) as f:
        lines = [next(f) for _ in range(DENSE_SERVE_LINES)]
    handle = serve(config(model_file=adam_dir), port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                          timeout=120)
        served = post(conn, "/score", "".join(lines).encode()).decode()
        conn.close()
    finally:
        handle.close()
    serve_diff = max(abs(float(a) - float(b)) for a, b in
                     zip(served.split(), predicted))
    check(len(served.split()) == DENSE_SERVE_LINES and serve_diff <= 2e-6,
          f"dense /score differs from the predict file by {serve_diff}")
    launches["fm_scores"] += read_launches(kernels)["fm_scores"]
    record["predict"] = {"cli_predict_s": predict_s, "scores": LINES,
                         "served_lines": DENSE_SERVE_LINES,
                         "serve_vs_predict_max_abs_diff": serve_diff}

    # -- (3) a warm start continues at the saved count ------------------
    short = os.path.join(tmp, "dense_short.libsvm")
    with open(files[0]) as src, open(short, "w") as dst:
        for _ in range(DENSE_SHORT_STEPS * LINES):
            dst.write(next(src))
    with np.load(os.path.join(adam_dir, "params.npz")) as z:
        saved_count = int(z["opt/count"])
        saved_mu = torch.from_numpy(z["opt/mu_table"]).to(dev)
    wcfg = config(optimizer="adam", model_file=adam_dir,
                  train_files=[short])
    warm = Trainer(wcfg)
    check(saved_count == steps and int(warm.opt_state.count) == steps
          and torch.equal(warm.opt_state.mu_table, saved_mu),
          f"the warm start restored count {int(warm.opt_state.count)} "
          f"(saved {saved_count})")
    warm_res = warm.train()["train"]
    check(int(warm.opt_state.count) == steps + warm_res["steps"]
          and warm_res["steps"] == DENSE_SHORT_STEPS,
          f"the warm start ended at count {int(warm.opt_state.count)}")
    record["warm_start"] = {"restored_count": saved_count,
                            "count_after": int(warm.opt_state.count),
                            "steps": warm_res["steps"]}
    del warm, saved_mu
    gc.collect()
    torch.cuda.empty_cache()

    # -- (4) bf16 beside f32, 4 steps -----------------------------------
    short_runs = {}
    for dtype in ("float32", "bfloat16"):
        _, _, rec = run(config(
            optimizer="adam", train_files=[short], compute_dtype=dtype,
            model_file=os.path.join(tmp, f"dense_{dtype}")),
            count=dtype == "bfloat16")
        short_runs[dtype] = rec
    bf, f32 = short_runs["bfloat16"], short_runs["float32"]
    check_path("dense bf16", bf, DENSE_SHORT_STEPS, mode="_bf16")
    check(bf["launches"]["fm_grad"] == 0,
          f"the bf16 run took the f32 FmGrad: {bf['launches']}")
    bf16_diff = abs(bf["step_logloss"][-1] - f32["step_logloss"][-1])
    check(bf16_diff < 1e-2, f"dense bf16 last logloss "
          f"{bf['step_logloss'][-1]} vs f32 {f32['step_logloss'][-1]}")
    bf["f32_step_logloss"] = f32["step_logloss"]
    bf["last_logloss_abs_diff"] = bf16_diff
    record["bf16"] = bf

    # -- (5) FFM-Criteo, 4 steps ----------------------------------------
    w_true = rng.normal(0.0, 0.6, (13, INT_BUCKETS))
    ffm_file = os.path.join(tmp, "dense_ffm.libsvm")
    write_labelled(np, ffm_file, rng, DENSE_SHORT_STEPS * LINES, w_true,
                   FFM_FIELDS)
    fcfg = config(optimizer="adam", train_files=[ffm_file],
                  field_num=FFM_FIELDS,
                  model_file=os.path.join(tmp, "dense_ffm"))
    check(fcfg.embedding_dim == 33, f"FFM-Criteo D = {fcfg.embedding_dim}")
    ffm_trainer, _, ffm_rec = run(fcfg, count=True)
    check_path("dense ffm", ffm_rec, DENSE_SHORT_STEPS, fm_kernels=False)
    check(int(ffm_trainer.opt_state.count) == DENSE_SHORT_STEPS,
          "dense ffm: Adam's count")
    record["ffm"] = ffm_rec
    del ffm_trainer
    gc.collect()
    torch.cuda.empty_cache()

    # -- (6) kernels against their plain versions, 3 steps ---------------
    # The gradient each step applies, kernel and plain: the optimizer's
    # input, taken from the module attribute the step calls.
    applied = []
    apply_dense = dense.apply_dense

    def spy(cfg, model, opt_state, dw0, dtable):
        applied.append((dw0.clone(), dtable.clone()))
        apply_dense(cfg, model, opt_state, dw0, dtable)

    dev_batches = [sparse.to_device(b, dev) for b in batches]
    parity = {}
    dense.apply_dense = spy
    try:
        for optimizer in ("adam", "adagrad"):
            parity[optimizer] = dense_parity(
                torch, fm, optimizers, dense, config(optimizer=optimizer),
                dev_batches, applied)
    finally:
        dense.apply_dense = apply_dense
    del applied
    record["kernel_vs_plain"] = parity

    # -- (7) the step and the whole-table update, timed -----------------
    cfg = config(optimizer="adam")
    V, D = cfg.vocabulary_size, cfg.embedding_dim
    sb = next(iter(DevicePrefetcher(batches[:1], 1, "cuda", V)))
    timing = {}
    for graphs in (False, True):
        trainer = Trainer(dataclasses.replace(
            cfg, model_file=os.path.join(tmp, "dense_timed")))
        if not graphs:
            trainer.graph = None
        times = []
        for _ in range(DENSE_TIMED_STEPS):
            t0 = time.perf_counter()
            trainer.dispatch(sb)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        dev_ms, wall_ms, host_ms = device_times_ms(
            torch, lambda: trainer.dispatch(sb), iters=20)
        busy = sum(dev_ms.values())
        key = "graphed" if graphs else "eager"
        timing[key] = {
            "step_p50_ms": p50(times[2:]) * 1e3,
            "device_busy_ms": busy,
            "device_idle_frac": max(0.0, 1.0 - busy / wall_ms),
            "device_ms_by_op": dict(sorted(
                dev_ms.items(), key=lambda kv: -kv[1])[:12]),
            "host_self_ms_top10": host_ms,
        }
        if graphs:
            check(trainer.graph_dispatches > 0, "the timed step never "
                  "replayed its graph")
            timing[key]["graph_pool_bytes"] = trainer.graph.pool_bytes()
        del trainer
        gc.collect()
    update = {}
    model = fm.init_params(cfg, torch.Generator(device=dev).manual_seed(8),
                           device=dev)
    dtable = torch.randn((V, D), device=dev) * 1e-3
    dw0 = torch.tensor(1e-3, device=dev)
    for optimizer in ("adam", "adagrad"):
        ocfg = config(optimizer=optimizer)
        opt = optimizers.init_dense_opt_state(ocfg, model)

        def step(ocfg=ocfg, opt=opt):
            optimizers.apply_dense(ocfg, model, opt, dw0, dtable)

        by_op, _, _ = device_times_ms(torch, step, iters=20)
        b_ms, b_by = dense_update_bound_ms(optimizer, V, D)
        ms = graph_ms(torch, step, calls=20)
        update[optimizer] = {"graph_ms": ms, "bound_ms": b_ms,
                             "bound_by": b_by, "of_bound": b_ms / ms,
                             "device_ms_by_op": by_op}
        del opt
    # The dense gradient's kernels at the step's shapes: K1's merge mode
    # on the whole slot of a parsed batch's row gradients, K-place into
    # the [V, D] table gradient.
    b0 = dev_batches[0]
    n = b0.ids.numel()
    g_rows = torch.randn((n, D), device=dev) * 1e-3
    g_table = torch.zeros_like(dtable)
    lam = torch.full((D,), 2 * DENSE_LAMBDA, device=dev)
    ids32 = b0.ids.reshape(-1)
    meta = b0.sort_meta
    u = int((meta.seg_start[1:] > meta.seg_start[:-1]).sum())
    m_rows, m_sums = sparse_apply.k1_merge_cuda(g_rows, ids32, meta.perm,
                                                meta.seg_start)
    grad_kernels = {
        "k1_merge": (lambda: sparse_apply.k1_merge_cuda(
            g_rows, ids32, meta.perm, meta.seg_start),
            k1_merge_bound_ms(n, u, D)),
        "kplace": (lambda: sparse_apply.kplace_cuda(m_rows, m_sums, 0, V),
                   kplace_bound_ms(u, D, V)),
        # The full L2's closed-form term: read the gradient and the
        # table, write the gradient; a product and a sum an element.
        "l2_full_grad": (lambda: g_table.addcmul_(model.table.detach(), lam),
                         bound(4 * V * D * 3, 2 * V * D)),
    }
    for name, (fn, (b_ms, b_by)) in grad_kernels.items():
        ms = graph_ms(torch, fn, calls=20)
        update[name] = {"graph_ms": ms, "bound_ms": b_ms, "bound_by": b_by}
    del model, dtable, g_rows, g_table, m_rows, m_sums, dev_batches, sb
    gc.collect()
    torch.cuda.empty_cache()
    timing["unique_rows"] = u
    timing["update"] = update
    record["step"] = timing
    return record, launches


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
            """Times each dispatch (synchronised) and its collectives,
            over its steps."""

            def __init__(self, *args, **kwargs):
                self.step_s, self.coll_s = [], []
                super().__init__(*args, **kwargs)

            def dispatch(self, sb, pause=None):
                c0 = coll_s[0]
                t0 = time.perf_counter()
                losses = super().dispatch(sb, pause)
                torch.cuda.synchronize()
                self.step_s.append((time.perf_counter() - t0) / sb.n)
                self.coll_s.append((coll_s[0] - c0) / sb.n)
                return losses

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


def ingest_counters(native, prefetcher_cls, pipeline_cls) -> dict:
    """The ingest path's counters, as ``kernel_fns`` gives the kernels'
    (zeroed and read by ``zero_launches`` and ``read_launches``): batches
    the native parser parsed in this process, super-batches the transfer
    stage shipped, of them those it filled itself and the packed groups
    it shipped with no fill, batches replayed from an epoch cache, and
    batches the process workers' parsers parsed."""
    return {"native_batches": (native.NativeParser, "batches"),
            "fused_ships": (prefetcher_cls, "ships"),
            "fills": (prefetcher_cls, "fills"),
            "prestack_hits": (prefetcher_cls, "prestack_hits"),
            "replays": (pipeline_cls, "replays"),
            "worker_batches": (pipeline_cls, "worker_batches")}


def check_train_path(tr: dict, launches: dict, ingest: dict,
                     extra_batches: int = 0, epochs: int = 1,
                     cache: str = "off", procs: int = 0) -> None:
    """A training run (with no epoch tail) went its ingest path, the CUDA
    graph and the kernels: every dispatch but the first a graph replay,
    every kernel of the step launched at least once a step, replays
    included, and every dispatch one shipped super-batch.  The parse
    counts are exact for the mode: with the epoch cache (``cache`` ``on``
    or ``prestacked``) only epoch 0 parses and the rest are replays; on
    ``procs`` workers the workers' parsers parse it all and the
    process's own parser only the ``extra_batches`` of the validation
    files.  The stage fills every group it ships itself, except with the
    prestacked cache: there every dispatch ships a packed group (epoch
    0's, packed once as it parses, then their replays) with no fill."""
    steps, dispatches = tr["steps"], tr["dispatches"]
    for name in ("fm_scores", "fm_grad", "k1_dedup", "k2_apply"):
        check(launches[name] >= steps,
              f"{name} launched {launches[name]} times in {steps} steps")
    check(tr["eager_dispatches"] == 1
          and tr["graph_dispatches"] == dispatches - 1 > 0,
          f"{tr['graph_dispatches']} graph and {tr['eager_dispatches']} "
          f"eager dispatches of {dispatches}")
    parsed = steps // epochs if cache != "off" else steps
    here = extra_batches if procs else parsed + extra_batches
    check(ingest["native_batches"] == here
          and ingest["worker_batches"] == (parsed if procs else 0),
          f"{cache} cache, {procs} workers: the parser here parsed "
          f"{ingest['native_batches']} batches (want {here}), the workers "
          f"{ingest['worker_batches']}, for {steps} steps")
    check(ingest["fused_ships"] == dispatches > 0,
          f"{ingest['fused_ships']} fused ships for {dispatches} "
          f"dispatches")
    check(tr["ingest_cache"] == ("off" if cache == "off" else "cached"),
          f"ingest_cache {tr['ingest_cache']} with the cache {cache}")
    check(ingest["replays"] == steps - parsed,
          f"{ingest['replays']} batches replayed of {steps}")
    hits = dispatches if cache == "prestacked" else 0
    fills = dispatches - hits
    check(ingest["fills"] == fills and ingest["prestack_hits"] == hits,
          f"{ingest['fills']} fills and {ingest['prestack_hits']} prestack "
          f"hits of {dispatches} dispatches ({cache} cache)")


def trained_state(sparse, trainer) -> list:
    """What a training run leaves: tables, optimizer state, w0 and the
    streaming metrics (compared bitwise between twin runs)."""
    m = trainer.metrics
    return ([trainer.model.table, trainer.model.w0,
             *sparse.opt_tables(trainer.opt_state)]
            + [t for t in trainer.opt_state if t.dim() == 0]
            + [m.loss_sum, m.weight_sum, m.count, m.auc.pos, m.auc.neg])


def graph_phase(torch, tcfg, card: str, files, steps: int,
                host_batches) -> dict:
    """The CUDA graph of the K steps (``train/dispatch.py``) against the
    same steps run eagerly.  (1) For f32 and bf16 compute, Adagrad, FTRL
    and SGD, and K = 1 and 4: ``Trainer.train()`` over ``files``
    (``steps`` batches: 17, so at K = 4 the epoch ends on a tail of one)
    from the same seeded table, once eager (the trainer's ``graph`` set
    to None) and once graphed; the tables, optimizer state, w0 and
    metrics must be bitwise equal, with graph dispatches in the graphed
    run and none in the eager one.  (2)
    At f32 Adagrad and K = 1 and 4, one super-batch already on the card
    (the first K of ``host_batches``, shipped by the transfer stage)
    dispatched again and again, eager and graphed: each step's p50 (a
    synchronised dispatch over K), and under ``torch.profiler`` the
    device's idle share, the host time in ``cudaLaunchKernel`` and
    ``cudaGraphLaunch`` a step, and the runs of each of the step's four
    kernels, which must be K a dispatch (a replay's launches measured,
    not only counted); the capture's time and the graph pool's bytes.
    Returns the ``graph`` record."""
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
    from fast_tffm_tpu_torch.train import sparse
    from fast_tffm_tpu_torch.train.loop import Trainer

    class NoSaveTrainer(Trainer):
        def save(self, stepno):
            return None

    def trainer_for(cfg, graphs: bool):
        trainer = NoSaveTrainer(cfg)
        if not graphs:
            trainer.graph = None  # every dispatch eager
        return trainer

    step_kernels = ("void fm_scores_fwd_kernel", "void fm_grad_bwd_kernel",
                    "void k1_kernel", "void k2_kernel")

    parity = {}
    for dtype in ("float32", "bfloat16"):
        for optimizer in ("adagrad", "ftrl", "sgd"):
            for k in (1, 4):
                cfg = dataclasses.replace(
                    tcfg, train_files=list(files), validation_files=[],
                    compute_dtype=dtype, optimizer=optimizer,
                    steps_per_dispatch=k, log_steps=0, save_steps=0)
                runs = {}
                for graphs in (False, True):
                    trainer = trainer_for(cfg, graphs)
                    tr = trainer.train()["train"]
                    torch.cuda.synchronize()
                    runs[graphs] = (trainer, tr)
                (eager, e_tr), (graphed, g_tr) = runs[False], runs[True]
                what = f"{dtype} {optimizer} K = {k}"
                tails = int(steps % k > 0)
                check(g_tr["steps"] == e_tr["steps"] == steps,
                      f"{what}: {g_tr['steps']} / {e_tr['steps']} steps")
                check(e_tr["graph_dispatches"] == 0
                      and g_tr["eager_dispatches"] == 1 + tails
                      and g_tr["graph_dispatches"] == g_tr["dispatches"]
                      - 1 - tails > 0,
                      f"{what}: dispatches eager {e_tr} graphed {g_tr}")
                check(all(torch.equal(a, b) for a, b in
                          zip(trained_state(sparse, graphed),
                              trained_state(sparse, eager))),
                      f"{what}: the graphed run is not bitwise the eager one")
                parity[what] = {
                    "steps": steps, "dispatches": g_tr["dispatches"],
                    "graph_dispatches": g_tr["graph_dispatches"],
                    "first_dispatch_s": {"eager": e_tr["first_dispatch_s"],
                                         "graphed": g_tr["first_dispatch_s"]},
                    "capture_s": graphed.graph.capture_s,
                    "wall_s": {"eager": e_tr["wall_s"],
                               "graphed": g_tr["wall_s"]},
                    "train_logloss": g_tr["logloss"],
                }
                del runs, eager, graphed
    print(f"graph check: {len(parity)} graphed runs bitwise their eager "
          f"twins (tables, optimizer state, w0, loss and weight sums, AUC "
          f"histogram)", flush=True)

    step = {}
    for k in (1, 4):
        cfg = dataclasses.replace(tcfg, steps_per_dispatch=k, log_steps=0,
                                  save_steps=0)
        sb = next(iter(DevicePrefetcher(host_batches[:k], k, "cuda",
                                        cfg.vocabulary_size)))
        for graphs in (False, True):
            trainer = trainer_for(cfg, graphs)
            t0 = time.perf_counter()
            trainer.dispatch(sb)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            times = []
            for _ in range(40):
                t0 = time.perf_counter()
                trainer.dispatch(sb)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) / k)
            kernel_runs = {}
            dev_ms, wall_ms, host_ms = device_times_ms(
                torch, lambda: trainer.dispatch(sb), iters=20, top=0,
                counts=kernel_runs)
            busy = sum(dev_ms.values())
            key = f"k{k}_{'graphed' if graphs else 'eager'}"
            check(all(kernel_runs.get(name) == 20 * k
                      for name in step_kernels),
                  f"{key}: the step's kernels ran "
                  f"{ {n: kernel_runs.get(n) for n in step_kernels} } times "
                  f"in 20 dispatches of {k} steps")
            step[key] = {
                "step_p50_ms": p50(times[2:]) * 1e3,
                "first_dispatch_s": first_s,
                "device_busy_ms_per_step": busy / k,
                "device_idle_frac": max(0.0, 1.0 - busy / wall_ms),
                "launch_kernel_host_ms_per_step":
                    host_ms.get("cudaLaunchKernel", 0.0) / k,
                "graph_launch_host_ms_per_step":
                    host_ms.get("cudaGraphLaunch", 0.0) / k,
                "device_ms_by_op_per_step": {
                    name: ms / k for name, ms in sorted(
                        dev_ms.items(), key=lambda kv: -kv[1])[:12]},
                "kernel_runs_per_dispatch": {
                    name: kernel_runs[name] / 20 for name in step_kernels},
            }
            if graphs:
                step[key]["capture_s"] = trainer.graph.capture_s
                step[key]["graph_pool_bytes"] = trainer.graph.pool_bytes()
                check(trainer.graph_dispatches == 40 + 22,
                      f"K = {k}: {trainer.graph_dispatches} replays")
            del trainer
        del sb
    return {"card": card, "batch_size": tcfg.batch_size, "parity": parity,
            "device_batch_step": step}


def shm_segments() -> list:
    """This process's pipelines' segments left in ``/dev/shm``."""
    mine = f"tffm{os.getpid()}p"
    return sorted(n for n in os.listdir("/dev/shm") if n.startswith(mine))


def ingest_phase(torch, tcfg, card: str, train_files, kernels: dict,
                 counters: dict) -> dict:
    """Phase 5b through ``tools/ingest_bench.py``: the parsers drained
    alone, then ``Trainer.train()`` for 4 epochs three times in each mode
    (each run checked as phase 5's, the counts exact for the mode).
    Returns the ``ingest`` record."""
    from fast_tffm_tpu_torch.data.pipeline import ring_slot_bytes
    from fast_tffm_tpu_torch.tools import ingest_bench

    epochs = 4
    drains = [ingest_bench.drain(train_files, tcfg, threads, use_native,
                                 n_ep, procs)
              for threads, use_native, n_ep, procs in (
                  (1, False, 1, 0), (1, True, epochs, 0),
                  (8, True, epochs, 0)) + tuple(
                  (8, True, epochs, p) for p in INGEST_PROCS)]
    check(len({d["digest"] for d in drains}) == 1,
          f"the parsers' streams differ: {drains}")
    check(not shm_segments(), f"segments left: {shm_segments()}")
    print(f"ingest drain lines/s ({card}, {os.cpu_count()} cores; threads "
          f"1 python, 1, 8, then {INGEST_PROCS} workers): "
          + json.dumps([d["lines_per_s"] for d in drains]), flush=True)
    shm = os.statvfs("/dev/shm")
    ring_bytes = tcfg.ring_slots * ring_slot_bytes(tcfg, True)
    print(f"/dev/shm: {shm.f_bavail * shm.f_frsize} bytes free; the ring "
          f"{ring_bytes} bytes ({tcfg.ring_slots} slots)", flush=True)

    steps_want = epochs * TRAIN_FILES * BATCHES_PER_FILE
    modes = [("off", 0), ("on", 0), ("prestacked", 0)] + [
        ("off", p) for p in INGEST_PROCS]
    baseline = {}
    runs = []
    for cache, procs in modes:
        def on_start():
            zero_launches(kernels)
            zero_launches(counters)

        def on_end(run, result, trainer, cache=cache, procs=procs):
            tr = result["train"]
            check(tr["steps"] == steps_want,
                  f"ingest run {run} ({cache}, {procs}): {tr['steps']} "
                  f"steps")
            check_train_path(tr, read_launches(kernels),
                             read_launches(counters), epochs=epochs,
                             cache=cache, procs=procs)
            check(not shm_segments(), f"segments left: {shm_segments()}")
            if run != "plain" or cache != "off":
                return
            state = (trainer.model.table.detach().clone(),
                     trainer.opt_state.acc_table.clone(),
                     trainer.model.w0.detach().clone())
            if not procs:
                baseline["state"] = state
                return
            # The workers' batches are the threads': the same training.
            for name, a, b in zip(("table", "acc", "w0"), state,
                                  baseline["state"]):
                check(torch.equal(a, b), f"{procs} workers: {name} differs "
                      f"from the threads run's")

        icfg = ingest_bench.with_mode(
            dataclasses.replace(tcfg, epoch_num=epochs), cache,
            tcfg.thread_num, procs, tcfg.steps_per_dispatch)
        # The profiler traces the threads run alone (as before the cache
        # and the pool): each mode's idle share is the bench's to take.
        record = ingest_bench.train_runs(
            icfg, torch.device("cuda"), on_start=on_start, on_end=on_end,
            profiled=(cache, procs) == ("off", 0))
        runs.append(record)
        print(f"ingest {cache} cache, {procs or tcfg.thread_num} "
              f"{'workers' if procs else 'threads'} ({card}, "
              f"{os.cpu_count()} cores): " + json.dumps({
                  key: record.get(key) for key in (
                      "examples_per_sec_after_first_dispatch",
                      "examples_per_sec_end_to_end", "first_dispatch_s",
                      "ingest_wait_frac", "step_p50_ms_in_train")}),
              flush=True)
    baseline.clear()
    return {"card": card, "cpu_count": os.cpu_count(),
            "lines": TRAIN_FILES * BATCHES_PER_FILE * LINES,
            "drain": [{k: v for k, v in d.items() if k != "digest"}
                      for d in drains],
            "streams_bitwise_equal": True, "epochs": epochs,
            "shm_free_bytes": shm.f_bavail * shm.f_frsize,
            "ring_bytes": ring_bytes, "runs": runs}


def ffm_kernels(np, torch, gen, batch, cfg, err: dict) -> dict:
    """Phase 11 (1): K1 and K2 (Adagrad, FTRL, SGD) at the FFM row width
    D = 33 on a parsed FFM-Criteo batch and on the same ids with one id
    of ``HOT_OCCURRENCES``, cut slot and whole slot, against their plain
    versions (K1 within ``k1_error_bound``, K2 to the tile-vs-scatter
    bounds and ``delta_check``; the whole slot bitwise the cut slot on
    the first U rows); then both timed in CUDA graphs on the whole slot
    (the graphed step's) beside their bounds, plain versions and K1's
    ``index_add_``.  Returns the timing record (``err`` gains the
    ``k1_dedup_d33`` and ``k2_apply_d33`` errors)."""
    from fast_tffm_tpu_torch.ops import sparse_apply
    from fast_tffm_tpu_torch.ops.sparse_apply import (
        k1_dedup_cuda, k1_dedup_plain, k1_error_bound, k2_apply_cuda,
        k2_apply_plain,
    )
    from fast_tffm_tpu_torch.train import sparse

    dev = torch.device("cuda")
    V, D = cfg.vocabulary_size, cfg.embedding_dim
    ids0 = torch.from_numpy(batch.ids).to(dev).reshape(-1)
    n = ids0.numel()
    hot = ids0.clone()
    hot[:HOT_OCCURRENCES] = 12345
    g_rows = torch.randn((n, D), generator=gen, device=dev) * 0.1
    outs = {}
    for name, ids in (("batch", ids0), ("hot", hot)):
        meta = sparse_apply.sort_meta(ids)
        u = meta.seg_start.numel() - 1
        for slot_name, slot in (("cut", meta.seg_start),
                                ("whole", full_slot(torch, meta.seg_start,
                                                    n))):
            args = (g_rows, ids, meta.perm, slot)
            urows, sums = k1_dedup_cuda(*args)
            urows_p, sums_p = k1_dedup_plain(g_rows.double(), *args[1:])
            _, mass = k1_dedup_plain(g_rows.abs().double(), *args[1:])
            torch.cuda.synchronize()
            what = f"K1 at D = {D} ({name}, {slot_name} slot)"
            check(torch.equal(urows, urows_p), f"{what}: row ids")
            diff = (sums[:u].double() - sums_p[:u]).abs()
            check(bool(torch.all(diff <= k1_error_bound(meta.seg_start,
                                                        mass[:u]))),
                  f"{what}: max err {float(diff.max()):.3e}")
            err["k1_dedup_d33"] = max(err.get("k1_dedup_d33", 0.0),
                                      float(diff.max()))
            outs[name, slot_name] = (urows, sums, meta)
            del urows_p, sums_p, mass, diff
        (c_rows, c_sums, _), (w_rows, w_sums, _) = (
            outs[name, "cut"], outs[name, "whole"])
        check(torch.equal(w_rows[:u], c_rows) and torch.equal(w_sums[:u],
                                                              c_sums)
              and bool((w_rows[u:] == -1).all()),
              f"K1 at D = {D} ({name}): the whole slot is not the cut "
              f"slot's on the first U rows and -1 after")
    hyper = sparse.hyper(cfg)._replace(l1=0.01, l2=0.1)
    table0 = torch.empty((V, D), device=dev).uniform_(-0.01, 0.01,
                                                      generator=gen)
    changes = {}
    for optimizer, extra in (("adagrad", 1), ("ftrl", 2), ("sgd", 0)):
        for name in ("batch", "hot"):
            c_rows, c_sums, _ = outs[name, "cut"]
            w_rows, w_sums, _ = outs[name, "whole"]
            start = [table0] + [torch.empty((V, D), device=dev).uniform_(
                0.1, 1.0, generator=gen) for _ in range(extra)]
            kern, cut, plain = ([t.clone() for t in start] for _ in range(3))
            k2_apply_cuda(optimizer, w_rows, w_sums, kern, hyper)
            k2_apply_cuda(optimizer, c_rows, c_sums, cut, hyper)
            k2_apply_plain(optimizer, w_rows, w_sums, plain, hyper)
            torch.cuda.synchronize()
            what = f"K2 at D = {D} ({optimizer}, {name})"
            check(all(torch.equal(a, b) for a, b in zip(kern, cut)),
                  f"{what}: the whole slot is not bitwise the cut slot's")
            torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
            for a, b in zip(kern[1:], plain[1:]):
                torch.testing.assert_close(a, b, **OPT_TOL)
            err["k2_apply_d33"] = max(err.get("k2_apply_d33", 0.0), *(
                float((a - b).abs().max()) for a, b in zip(kern, plain)))
            changes[f"{optimizer} {name}"] = [
                delta_check(torch, f"{what} table {i}", a, b, s0)
                for i, (a, b, s0) in enumerate(zip(kern, plain, start))]
            del kern, cut, plain, start
    print(f"ffm kernel check: K1 and K2 (adagrad, ftrl, sgd) at D = {D} == "
          f"their plain versions, whole slot bitwise the cut slot; "
          f"max_abs_err {err['k1_dedup_d33']:.3e} / "
          f"{err['k2_apply_d33']:.3e}", flush=True)

    # Timing: the whole slot, as the graphed FFM step runs them.
    c_rows, c_sums, meta0 = outs["batch", "cut"]
    w_rows, w_sums, _ = outs["batch", "whole"]
    u = c_rows.numel()
    slot0 = full_slot(torch, meta0.seg_start, n)
    table_k = table0.clone()
    acc_k = torch.full((V, D), 0.1, device=dev)
    cases = {
        "k1_dedup_d33": (
            lambda: k1_dedup_cuda(g_rows, ids0, meta0.perm, slot0),
            lambda: k1_dedup_plain(g_rows, ids0, meta0.perm, slot0),
            k1_library(torch, g_rows, meta0), k1_bound_ms(n, u, D, slot=n),
            (lambda: k1_dedup_cuda(g_rows, ids0, meta0.perm,
                                   meta0.seg_start),
             k1_bound_ms(n, u, D))),
        "k2_apply_d33": (
            lambda: k2_apply_cuda("adagrad", w_rows, w_sums,
                                  (table_k, acc_k), hyper),
            lambda: k2_apply_plain("adagrad", w_rows, w_sums,
                                   (table_k, acc_k), hyper),
            None, k2_bound_ms(u, D, rows=n),
            (lambda: k2_apply_cuda("adagrad", c_rows, c_sums,
                                   (table_k, acc_k), hyper),
             k2_bound_ms(u, D))),
    }
    timing = {}
    for name, (kern, plain, lib, (b_ms, b_by), (cut, (c_ms, _))) in (
            cases.items()):
        pa, ka, kb, pb = (graph_ms(torch, fn) for fn in
                          (plain, kern, kern, plain))
        timing[name] = {
            "ms": min(ka, kb), "plain_ms": min(pa, pb),
            "graph_ms": [ka, kb], "plain_graph_ms": [pa, pb],
            "library_ms": None if lib is None else graph_ms(torch, lib),
            "bound_ms": b_ms, "bound_by": b_by,
            "cut_slot": {"graph_ms": graph_ms(torch, cut), "bound_ms": c_ms},
            "occurrences": n, "unique_rows": u, "width": D,
        }
    del table_k, acc_k, table0, outs
    return {"timing": timing, "changes": changes}


def ffm_phase(np, torch, card: str, gen, rng, kernels: dict, counters: dict,
              err: dict) -> dict:
    """Phase 11, path 5: field-aware FM at FFM-Criteo
    (``examples/criteo_kaggle.cfg`` with ``field_num = 4``: V = 2^22,
    F = 39, k = 8, P = 4, D = 33, B = 4096) on ``field:token:val`` lines,
    column j on field j mod 4.  (1) ``ffm_kernels``.  (2) The FFM op's
    forward and closed-form backward against autograd through
    ``ffm_scores_from_rows`` on the card.  (3) Training: the main run (16
    graphed steps at K = 1 with the counts from 0, validation, predict);
    its eager twin and a graphed and an eager run at K = 4, all bitwise
    the main run's; 3 steps through the kernels against 3 through the
    plain path; 8 bf16 steps beside 8 f32 steps.  (4) Serving the
    checkpoint over both transports; (4b) in fp32 and at int8 (path 6's
    ``dense_tables``).  (5) The step on a device batch,
    graphed and eager, its device time by op.  (6) ``python -m
    fast_tffm_tpu_torch.cli train|predict|serve`` on
    ``examples/ffm_sample.cfg``.  Returns ``(record, launches of the
    main run, timing)``."""
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.libsvm import (
        host_sort_meta, make_batch, parse_lines,
    )
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.ops import interaction
    from fast_tffm_tpu_torch.serve import wire
    from fast_tffm_tpu_torch.serve.server import serve
    from fast_tffm_tpu_torch.serve.textparse import parse_request
    from fast_tffm_tpu_torch.train import checkpoint, sparse
    from fast_tffm_tpu_torch.train.loop import Trainer, predict

    dev = torch.device("cuda")
    tmp_ctx = tempfile.TemporaryDirectory(prefix="chip_smoke_ffm_")
    tmp = tmp_ctx.name
    record = {"card": card}
    # -- data: FFM-Criteo lines -----------------------------------------
    w_true = rng.normal(0.0, 0.6, (13, INT_BUCKETS))
    files = []
    for i in range(TRAIN_FILES):
        path = os.path.join(tmp, f"train_{i}.libsvm")
        write_labelled(np, path, rng, BATCHES_PER_FILE * LINES, w_true,
                       FFM_FIELDS)
        files.append(path)
    valid_file = os.path.join(tmp, "valid.libsvm")
    predict_file = os.path.join(tmp, "predict.libsvm")
    write_labelled(np, valid_file, rng, LINES, w_true, FFM_FIELDS)
    write_labelled(np, predict_file, rng, LINES, w_true, FFM_FIELDS)
    model_dir = os.path.join(tmp, "model")
    cfg = load_config(CFG_PATH, {
        "field_num": FFM_FIELDS, "train_files": files,
        "validation_files": [valid_file], "predict_files": [predict_file],
        "model_file": model_dir, "score_path": os.path.join(tmp, "scores"),
        "log_steps": 4, "seed": SEED, "serve_poll_secs": 0.0,
        "serve_port": 0,
    })
    V, F, B, D = (cfg.vocabulary_size, cfg.max_features, cfg.batch_size,
                  cfg.embedding_dim)
    P, k = cfg.field_num, cfg.factor_num
    check((V, F, B, D, P, k) == (1 << 22, 39, 4096, 33, 4, 8)
          and cfg.host_sort and cfg.thread_num == 8,
          f"unexpected FFM-Criteo shape {(V, F, B, D, P, k)}")
    with open(files[0]) as f:
        head = [next(f) for _ in range(4 * LINES)]
    batches = [make_batch(parse_lines(head[i * LINES:(i + 1) * LINES], V,
                                      cfg.hash_feature_id, P), B, F)
               for i in range(4)]
    batches = [b._replace(sort_meta=host_sort_meta(b.ids)) for b in batches]
    check(all(np.array_equal(b.fields[:, :F], np.tile(np.arange(F) % P,
                                                      (B, 1)))
              for b in batches), "the parsed fields are not column mod 4")

    # -- (1) K1 and K2 at D = 33 ----------------------------------------
    kern = ffm_kernels(np, torch, gen, batches[0], cfg, err)
    record["kernel_changes"] = kern["changes"]
    record["kernel_timing"] = kern["timing"]

    # -- (2) the FFM op against autograd through the scores --------------
    # Rows ~ N(0, 0.1^2): FFM-Criteo scores up to ~4 in magnitude, where
    # bf16's rounding of the operands stays inside the bf16 bound.
    rows = torch.randn((B, F, D), generator=gen, device=dev) * 0.1
    vals = torch.from_numpy(batches[0].vals).to(dev)
    fields = torch.from_numpy(batches[0].fields).to(dev)
    g = torch.randn((B,), generator=gen, device=dev)

    def fwd_bwd(fn, r0, v, compute):
        r = r0.clone().requires_grad_()
        s = fn(r, v, fields, k, P, compute)
        d, = torch.autograd.grad((s * g).sum(), r)
        return s.detach(), d

    def oracle(r, v, f_, kk, pp, compute):
        return fm.ffm_scores_from_rows(torch.zeros((), device=dev), r, v,
                                       f_, kk, pp, compute)

    op = interaction.ffm_interaction
    s_op, d_op = fwd_bwd(op, rows, vals, torch.float32)
    s_or, d_or = fwd_bwd(oracle, rows, vals, torch.float32)
    torch.testing.assert_close(s_op, s_or, **FFM_OP_TOL)
    torch.testing.assert_close(d_op, d_or, **FFM_OP_TOL)
    s16, d16 = fwd_bwd(op, rows, vals, torch.bfloat16)
    torch.testing.assert_close(s16, s_or, **FFM_BF16_TOL)
    torch.testing.assert_close(d16, d_or, **FFM_BF16_TOL)
    # The bf16 backward rounds its operands alone: bitwise the f32 op's
    # on the rows and values rounded beforehand.
    _, d_pre = fwd_bwd(op, rows.bfloat16().float(), vals.bfloat16().float(),
                       torch.float32)
    check(torch.equal(d16, d_pre), "the bf16 FFM backward is not the f32 "
          "backward on pre-rounded operands")
    record["op"] = {
        "f32_scores_max_abs_err": float((s_op - s_or).abs().max()),
        "f32_drows_max_abs_err": float((d_op - d_or).abs().max()),
        "bf16_scores_max_abs_err": float((s16 - s_or).abs().max()),
        "bf16_drows_max_abs_err": float((d16 - d_or).abs().max()),
        "max_abs_score": float(s_or.abs().max()),
    }
    del rows, g, s_op, d_op, s_or, d_or, s16, d16, d_pre
    print("ffm op check: FfmInteraction == autograd through "
          "ffm_scores_from_rows (f32), bf16 within its bound; "
          + json.dumps(record["op"]), flush=True)

    # -- (3) training --------------------------------------------------
    class FfmTrainer(Trainer):
        """Keeps each dispatch's step losses; saves only when asked."""

        def __init__(self, cfg, graphs=True, saves=False):
            self.step_losses, self._saves = [], saves
            super().__init__(cfg)
            if not graphs:
                self.graph = None

        def dispatch(self, sb, pause=None):
            losses = super().dispatch(sb, pause)
            self.step_losses.append(losses.clone())
            return losses

        def save(self, stepno):
            return super().save(stepno) if self._saves else None

    steps = TRAIN_FILES * BATCHES_PER_FILE
    torch.cuda.synchronize()
    before_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    zero_launches(counters)
    t0 = time.perf_counter()
    main_run = FfmTrainer(cfg, saves=True)
    result = main_run.train()
    train_wall = time.perf_counter() - t0
    ingest = read_launches(counters)
    t0 = time.perf_counter()
    n_pred = predict(cfg)
    predict_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    tr = result["train"]
    check(tr["steps"] == steps, f"FFM trained {tr['steps']} steps")
    for name in ("k1_dedup", "k2_apply"):
        check(launches[name] >= steps,
              f"FFM: {name} launched {launches[name]} times in {steps} steps")
    check(all(launches[name] == 0 for name in kernels
              if name.startswith("fm_")),
          f"the FFM run launched an FM kernel: {launches}")
    check(tr["eager_dispatches"] == 1
          and tr["graph_dispatches"] == tr["dispatches"] - 1 > 0,
          f"FFM: {tr['graph_dispatches']} graph and "
          f"{tr['eager_dispatches']} eager dispatches")
    check(ingest["native_batches"] == steps + 1
          and ingest["fused_ships"] == tr["dispatches"],
          f"FFM ingest counts {ingest}")
    losses = torch.cat(main_run.step_losses).tolist()
    last = float(np.mean(losses[-4:]))
    check(all(np.isfinite(losses)) and last < losses[0],
          f"FFM logloss did not fall: first {losses[0]:.4f}, last 4 "
          f"{last:.4f}")
    val = result["validation"]
    check(np.isfinite(val["logloss"]) and 0 < val["auc"] <= 1,
          f"FFM validation {val}")
    with open(cfg.score_path) as f:
        scores_txt = [float(x) for x in f.read().split("\n") if x]
    check(n_pred == LINES == len(scores_txt)
          and all(0.0 < x < 1.0 for x in scores_txt),
          f"FFM predict wrote {n_pred} scores for {LINES} lines")
    record["train"] = {
        "steps": steps, "launches": {n: launches[n] for n in
                                     ("k1_dedup", "k2_apply")},
        "step_logloss": losses, "first_step_logloss": losses[0],
        "last4_mean_logloss": last, "train_logloss": tr["logloss"],
        "validation_logloss": val["logloss"], "validation_auc": val["auc"],
        "train_wall_s": train_wall, "predict_wall_s": predict_wall,
        "examples_per_sec_end_to_end": tr["examples_per_sec"],
        "ingest_wait_frac": tr["ingest_wait_frac"],
        "dispatches": tr["dispatches"],
        "graph_dispatches": tr["graph_dispatches"],
        "first_dispatch_s": tr["first_dispatch_s"],
        "peak_device_mb": peak_mb,
        # Held by the earlier phases when the run started (in the peak).
        "allocated_before_mb": before_mb,
    }
    print("ffm train: " + json.dumps(record["train"]), flush=True)

    # Graphed against eager, K = 1 and 4, from the same seeded table.
    twins = {}
    # The twins start from the seed, as the main run did: no checkpoint.
    quiet = dataclasses.replace(cfg, validation_files=[], log_steps=0,
                                model_file=os.path.join(tmp, "none"))
    for kk in (1, 4):
        kcfg = dataclasses.replace(quiet, steps_per_dispatch=kk)
        pair = {}
        for graphs in (True, False):
            if kk == 1 and graphs:
                pair[graphs] = (main_run, tr)
                continue
            trainer = FfmTrainer(kcfg, graphs=graphs)
            pair[graphs] = (trainer, trainer.train()["train"])
        torch.cuda.synchronize()
        (graphed, g_tr), (eager, e_tr) = pair[True], pair[False]
        check(e_tr["graph_dispatches"] == 0 and g_tr["eager_dispatches"] == 1
              and g_tr["graph_dispatches"] == steps // kk - 1,
              f"FFM K = {kk}: dispatches graphed {g_tr} eager {e_tr}")
        check(all(torch.equal(a, b) for a, b in zip(
            trained_state(sparse, graphed), trained_state(sparse, eager))),
            f"FFM K = {kk}: the graphed run is not bitwise the eager one")
        check(torch.equal(torch.cat(graphed.step_losses),
                          torch.cat(eager.step_losses)),
              f"FFM K = {kk}: step losses differ")
        twins[f"k{kk}"] = {"graph_dispatches": g_tr["graph_dispatches"],
                           "capture_s": graphed.graph.capture_s,
                           "wall_s": {"graphed": g_tr["wall_s"],
                                      "eager": e_tr["wall_s"]}}
        del pair, graphed, eager
    record["graph_parity"] = twins
    del main_run
    print("ffm graph check: graphed runs at K = 1 and 4 bitwise their "
          "eager twins", flush=True)

    # Kernels against the plain path: 3 steps from one initial table.
    init = fm.init_params(cfg, torch.Generator(device=dev).manual_seed(7),
                          device=dev)
    dev_batches = [sparse.to_device(b, dev) for b in batches[:3]]
    paths = []
    for plain in (False, True):
        m = fm.FmModel(init.w0.detach().clone(), init.table.detach().clone())
        paths.append((m, sparse.init_sparse_opt_state(cfg, m), plain))
    score_err = 0.0
    for b in dev_batches:
        s_k, s_p = (sparse.sparse_step(cfg, m, o, b, plain=pl)
                    for m, o, pl in paths)
        torch.testing.assert_close(s_k, s_p, **KERNEL_TOL)
        score_err = max(score_err, float((s_k - s_p).abs().max()))
    torch.cuda.synchronize()
    (mk, ok, _), (mp, op, _) = paths
    torch.testing.assert_close(mk.table, mp.table, **TABLE_TOL)
    torch.testing.assert_close(ok.acc_table, op.acc_table, **OPT_TOL)
    torch.testing.assert_close(mk.w0, mp.w0, rtol=1e-5, atol=1e-7)
    record["parity"] = {
        "steps": 3, "scores_max_abs_err": score_err,
        "table_max_abs_err": float((mk.table - mp.table).detach().abs()
                                   .max()),
        "acc_max_abs_err": float((ok.acc_table - op.acc_table).abs().max()),
        "changes": {
            "table": delta_check(torch, "FFM table", mk.table, mp.table,
                                 init.table.detach()),
            "acc_table": delta_check(
                torch, "FFM acc_table", ok.acc_table, op.acc_table,
                torch.full_like(ok.acc_table,
                                cfg.adagrad_initial_accumulator)),
        },
    }
    del paths, mk, ok, mp, op, init

    # bf16 beside f32: 8 steps of one file each, the same batches.
    bf16 = {}
    for dtype in ("float32", "bfloat16"):
        trainer = FfmTrainer(dataclasses.replace(
            quiet, train_files=files[:1], compute_dtype=dtype))
        bf16[dtype] = (trainer.train()["train"],
                       torch.cat(trainer.step_losses).tolist())
        del trainer
    diff = abs(bf16["bfloat16"][1][-1] - bf16["float32"][1][-1])
    check(bf16["bfloat16"][0]["steps"] == BATCHES_PER_FILE
          and all(np.isfinite(bf16["bfloat16"][1])) and diff < 1e-2,
          f"FFM bf16 last logloss {bf16['bfloat16'][1][-1]} vs f32 "
          f"{bf16['float32'][1][-1]}")
    record["bf16"] = {"step_logloss": bf16["bfloat16"][1],
                      "f32_step_logloss": bf16["float32"][1],
                      "last_logloss_abs_diff": diff}
    print("ffm parity: " + json.dumps({"parity": record["parity"],
                                        "bf16": record["bf16"]}), flush=True)

    # -- (4) serving the checkpoint ---------------------------------------
    scfg = dataclasses.replace(cfg, model_file=model_dir)
    _, ref = checkpoint.restore_params(model_dir, device=dev)
    handle = serve(scfg, port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                          timeout=120)
        served = []
        for n_req in (1, 37, 64, 200, 256, 1000, 1024, 1500):
            body = criteo_body(rng, n_req, P)
            text = post(conn, "/score", body.encode()).decode()
            ids, vals_np, fields_np, got_n, trunc = parse_request(body, scfg)
            check(got_n == n_req and trunc == 0
                  and np.array_equal(fields_np, np.tile(np.arange(F) % P,
                                                        (n_req, 1))),
                  f"FFM parse of {n_req} lines")
            bin_scores = wire.decode_bin_response(post(
                conn, "/score_bin",
                wire.encode_bin_request(ids, vals_np, fields_np)))
            check(bin_scores.shape == (n_req,)
                  and text == "".join(f"{s:.6f}\n" for s in bin_scores),
                  f"FFM /score and /score_bin disagree at n={n_req}")
            served.append((ids, vals_np, fields_np, bin_scores))
        latency = {}
        for b in handle.scorer.ladder:
            body = criteo_body(rng, b, P).encode()
            ids, vals_np, fields_np, _, _ = parse_request(body.decode(),
                                                          scfg)
            frame = wire.encode_bin_request(ids, vals_np, fields_np)
            for path, payload in (("/score", body), ("/score_bin", frame)):
                times = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    post(conn, path, payload)
                    times.append(time.perf_counter() - t0)
                latency[f"{path}_n{b}_p50_ms"] = p50(times) * 1e3
        conn.close()
        scorer = handle.scorer
        ids_all, vals_all, fields_all, _ = served[-1]
        dispatch = {}
        for b in scorer.ladder:
            times = []
            for _ in range(50):
                t0 = time.perf_counter()
                scorer.score_rung(ids_all[:b], vals_all[:b], fields_all[:b],
                                  b)
                times.append(time.perf_counter() - t0)
            dispatch[b] = p50(times) * 1e3
    finally:
        handle.close()
    with torch.inference_mode():
        for ids, vals_np, fields_np, got in served:
            rows_t = ref.table[torch.from_numpy(ids).to(dev).long()]
            want = torch.sigmoid(fm.ffm_scores_from_rows(
                ref.w0, rows_t, torch.from_numpy(vals_np).to(dev),
                torch.from_numpy(fields_np).to(dev), k, P)).cpu()
            torch.testing.assert_close(torch.from_numpy(got), want,
                                       **SERVE_TOL)
            check(bool(np.isfinite(got).all()), "non-finite FFM score")
    record["serve"] = {"latency_p50_ms": latency, "dispatch_p50_ms": dispatch}
    print("ffm serve: transports agree bitwise, scores match the plain "
          "path; " + json.dumps(record["serve"]), flush=True)
    del ref, handle, scorer

    # -- (4b) the checkpoint at serve_table_dtype = int8 (path 6) --------
    torch.cuda.empty_cache()
    record["serve_int8"], _ = dense_tables(
        np, torch, scfg, model_dir, tmp, serve_requests(np, rng, scfg, P),
        "ffm", (("int8", "placed"),))
    print("ffm int8: " + json.dumps(record["serve_int8"]), flush=True)

    # -- (5) the step on a device batch, graphed and eager ---------------
    step = {}
    for kk in (1, 4):
        kcfg = dataclasses.replace(quiet, steps_per_dispatch=kk)
        sb = next(iter(DevicePrefetcher(batches[:kk], kk, "cuda", V,
                                        with_fields=True)))
        for graphs in (False, True):
            trainer = FfmTrainer(kcfg, graphs=graphs)
            trainer.dispatch(sb)
            trainer.dispatch(sb)  # graphed: the capture's eager first
            torch.cuda.synchronize()
            times = []
            for _ in range(30):
                t0 = time.perf_counter()
                trainer.dispatch(sb)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) / kk)
            runs = {}
            dev_ms, wall_ms, host_ms = device_times_ms(
                torch, lambda: trainer.dispatch(sb), iters=20, top=0,
                counts=runs)
            busy = sum(dev_ms.values())
            key = f"k{kk}_{'graphed' if graphs else 'eager'}"
            for name in ("void k1_kernel", "void k2_kernel"):
                check(runs.get(name) == 20 * kk,
                      f"FFM {key}: {name} ran {runs.get(name)} times in 20 "
                      f"dispatches of {kk} steps")
            step[key] = {
                "step_p50_ms": p50(times) * 1e3,
                "examples_per_sec_step_alone": B / p50(times),
                "device_busy_ms_per_step": busy / kk,
                "device_idle_frac": max(0.0, 1.0 - busy / wall_ms),
                "device_ms_by_op_per_step": {
                    name: ms / kk for name, ms in sorted(
                        dev_ms.items(), key=lambda kv: -kv[1])[:16]},
                "k1_k2_runs_per_dispatch": {
                    name: runs.get(name, 0) / 20
                    for name in ("void k1_kernel", "void k2_kernel")},
            }
            if graphs:
                step[key]["graph_pool_bytes"] = trainer.graph.pool_bytes()
            del trainer
        del sb
    record["device_batch_step"] = step
    # The step's four einsums alone at these shapes (what the profile's
    # GEMM and GEMV kernels are), each beside its bytes over HBM
    # bandwidth: S, v_i^{f_i} (forward and again in the backward), the
    # cross term, and the backward's T.
    x = torch.from_numpy(batches[0].vals).to(dev)
    oh = (torch.from_numpy(batches[0].fields).to(dev)[..., None]
          == torch.arange(P, dtype=torch.int32, device=dev)).float()
    v = torch.randn((B, F, P, k), generator=gen, device=dev) * 0.1
    ohx = oh * x[..., None]
    s_ = torch.einsum("bfp,bfqk->bpqk", ohx, v)
    n_bfp, n_v, n_s = B * F * P, B * F * P * k, B * P * P * k
    einsums = {
        "s": (lambda: torch.einsum("bfp,bfqk->bpqk", ohx, v),
              n_bfp + n_v + n_s),
        "v_own": (lambda: torch.einsum("bfq,bfqk->bfk", oh, v),
                  n_bfp + n_v + B * F * k),
        "cross": (lambda: torch.einsum("bpqk,bqpk->b", s_, s_), n_s + B),
        "t": (lambda: torch.einsum("bqpk,bfp->bfqk", s_, oh),
              n_s + n_bfp + n_v),
    }
    record["einsum_ms"] = {
        name: {"graph_ms": graph_ms(torch, fn),
               "bound_ms": bound(4 * elems, 0)[0]}
        for name, (fn, elems) in einsums.items()}
    del x, oh, v, ohx, s_
    print("ffm step: " + json.dumps(step) + " einsums: "
          + json.dumps(record["einsum_ms"]), flush=True)

    # -- (6) the CLI round trip on examples/ffm_sample.cfg ----------------
    record["cli"] = ffm_cli(np, os.path.join(tmp, "cli"))
    tmp_ctx.cleanup()
    return record, launches, kern["timing"]


def ffm_cli(np, tmp: str) -> dict:
    """``python -m fast_tffm_tpu_torch.cli train|predict|serve`` on
    ``examples/ffm_sample.cfg`` (its widths and schedule; paths into
    ``tmp``), on the data of ``examples/gen_sample_data.py --ffm``, each
    a subprocess on the card.  Checks: validation logloss below 0.693,
    one probability a predict line, and ``/score`` of validation lines
    answering what predict wrote for them."""
    data = os.path.join(tmp, "data")
    subprocess.run([sys.executable, os.path.join(REPO, "examples",
                                                 "gen_sample_data.py"),
                    "--ffm", "--out", data], check=True, timeout=300,
                   capture_output=True)
    with open(os.path.join(REPO, "examples", "ffm_sample.cfg")) as f:
        text = f.read()
    scores = os.path.join(tmp, "scores.txt")
    text = (text.replace("examples/data", data)
            .replace("/tmp/fast_tffm_tpu_ffm_model",
                     os.path.join(tmp, "model"))
            .replace("/tmp/fast_tffm_tpu_ffm_scores.txt", scores))
    cfg_path = os.path.join(tmp, "ffm_sample.cfg")
    with open(cfg_path, "w") as f:
        f.write(text)
    cli = [sys.executable, "-m", "fast_tffm_tpu_torch.cli"]
    out = {}
    for mode in ("train", "predict"):
        t0 = time.perf_counter()
        r = subprocess.run(cli + [mode, cfg_path], cwd=REPO, timeout=600,
                           capture_output=True, text=True)
        out[f"{mode}_wall_s"] = time.perf_counter() - t0
        check(r.returncode == 0, f"cli {mode} exited {r.returncode}: "
              f"{r.stderr[-2000:]}")
        out[f"{mode}_stdout"] = r.stdout.strip().splitlines()
    val = [ln for ln in out["train_stdout"] if ln.startswith("validation")]
    check(bool(val), f"cli train printed no validation: {out}")
    out["validation_logloss"] = float(val[0].split("logloss=")[1].split()[0])
    check(out["validation_logloss"] < 0.693,
          f"cli validation logloss {out['validation_logloss']}")
    with open(scores) as f:
        predicted = f.read().split("\n")[:-1]
    with open(os.path.join(data, "valid_ffm.libsvm")) as f:
        lines = f.read().split("\n")[:-1]
    check(len(predicted) == len(lines) > 0
          and all(0.0 < float(x) < 1.0 for x in predicted),
          f"cli predict wrote {len(predicted)} scores for {len(lines)} lines")
    proc = subprocess.Popen(cli + ["serve", cfg_path, "--serve_port", "0",
                                   "--serve_poll_secs", "0"], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    try:
        line = proc.stdout.readline()  # "serving on host:port"
        check(line.startswith("serving on"), f"cli serve printed {line!r}")
        port = int(line.rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        body = "\n".join(lines[:300]) + "\n"
        served = post(conn, "/score", body.encode()).decode().split()
        conn.close()
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    err = max(abs(float(a) - float(b)) for a, b in zip(served, predicted))
    check(len(served) == 300 and err <= 2e-6,
          f"cli serve scores differ from predict's by {err}")
    out["serve_vs_predict_max_abs_diff"] = err
    out["serve_exit"] = proc.returncode
    print("ffm cli: " + json.dumps({k: v for k, v in out.items()
                                     if not k.endswith("stdout")}),
          flush=True)
    return out


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
        entry["k2t_sector_ms"] = k2t_sector_ms(torch, urows, d, v)
        entry["k2p_sector_ms"] = k2p_sector_ms(urows.numel(), d)
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
    from fast_tffm_tpu_torch.data import native
    from fast_tffm_tpu_torch.data.libsvm import (
        host_sort_meta, make_batch, parse_lines,
    )
    from fast_tffm_tpu_torch.data.pipeline import BatchPipeline
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
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
    # The native parser, from its source in the checkout.
    if os.path.exists(native.LIB_PATH):
        os.remove(native.LIB_PATH)
    t0 = time.perf_counter()
    native.load()
    print(f"parser build: {time.perf_counter() - t0:.3f} s", flush=True)

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
    # -- fm_grad bitwise at B in {1, 1000, 4096} -----------------------
    for b in (1, 1000, B):
        rows = torch.randn((b, F, D), generator=gen, device=dev) * 0.3
        vals = torch.rand((b, F), generator=gen, device=dev)
        _, s1 = fm_scores_plain(rows, vals)
        g = torch.randn((b,), generator=gen, device=dev)
        got = fm_grad_cuda(rows, vals, s1, g)
        want = fm_grad_plain(rows, vals, s1, g)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"FmGrad differs from its plain version at B = {b}")
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
    # -- K1 and K2 on the whole slot (the graphed step's) --------------
    # The whole [n + 1] seg_start slot, its tail padded with n as the
    # transfer stage ships it: bitwise the cut slot's kernels above on
    # the first U rows (row -1 after, no other table row written), and
    # held to the plain versions as they are.
    whole_shapes = {}
    for name in ("batch", "hot"):
        g, ids, meta = k1_streams[name]
        slot = full_slot(torch, meta.seg_start, n)
        args = (g, ids, meta.perm, slot)
        w_rows, w_sums = k1_dedup_cuda(*args)
        p_rows, p_sums = k1_dedup_plain(g.double(), *args[1:])
        _, mass = k1_dedup_plain(g.abs().double(), *args[1:])
        urows, sums = k2_shapes[name]
        u_s = urows.numel()
        torch.cuda.synchronize()
        check(torch.equal(w_rows[:u_s], urows)
              and torch.equal(w_sums[:u_s], sums),
              f"K1 on the whole slot ({name}) is not bitwise the cut "
              f"slot's on the first U rows")
        check(bool((w_rows[u_s:] == -1).all()),
              f"K1 on the whole slot ({name}): a row past U is not -1")
        check(torch.equal(w_rows, p_rows), f"K1 whole-slot row ids ({name})")
        diff = (w_sums[:u_s].double() - p_sums[:u_s]).abs()
        check(bool(torch.all(diff <= k1_error_bound(meta.seg_start,
                                                    mass[:u_s]))),
              f"K1 whole-slot sums vs plain ({name}): max err "
              f"{float(diff.max()):.3e}")
        err["k1_dedup"] = max(err["k1_dedup"], float(diff.max()))
        whole_shapes[name] = (w_rows, w_sums)
        del p_rows, p_sums, mass, diff
    for optimizer, extra in (("adagrad", 1), ("ftrl", 2), ("sgd", 0)):
        for name, (w_rows, w_sums) in whole_shapes.items():
            urows, sums = k2_shapes[name]
            state = [torch.empty((V, D), device=dev).uniform_(
                0.1, 1.0, generator=gen) for _ in range(extra)]
            start = tuple([table0] + state)
            kern, cut, plain = ([t.clone() for t in start] for _ in range(3))
            k2_apply_cuda(optimizer, w_rows, w_sums, kern, hyper)
            k2_apply_cuda(optimizer, urows, sums, cut, hyper)
            k2_apply_plain(optimizer, w_rows, w_sums, plain, hyper)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(kern, cut)),
                  f"K2 on the whole slot ({optimizer}, {name}) is not "
                  f"bitwise the cut slot's")
            torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
            for a, b_ in zip(kern[1:], plain[1:]):
                torch.testing.assert_close(a, b_, **OPT_TOL)
            err["k2_apply"] = max(err["k2_apply"], *(
                float((a - b_).abs().max()) for a, b_ in zip(kern, plain)))
            del kern, cut, plain, state, start
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
          "bitwise), k1_dedup, k2_apply (adagrad, ftrl, sgd; on the whole "
          "slot bitwise the cut slot's on the first U rows), kplace, "
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
    w_rows, w_sums = whole_shapes["batch"]
    slot0 = full_slot(torch, meta0.seg_start, n)
    acc0 = torch.full((V, D), 0.1, device=dev)
    table_k, acc_k = table0.clone(), acc0.clone()
    ids32 = ids0.to(torch.int32)

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
        # K1 and K2 on the whole slot, as the graphed train step runs
        # them; on the cut slot (the device sort's) after the loop.
        "k1_dedup": (
            lambda: k1_dedup_cuda(g_rows, ids32, meta0.perm, slot0),
            lambda: k1_dedup_plain(g_rows, ids32, meta0.perm, slot0),
            k1_library(torch, g_rows, meta0),
            k1_bound_ms(n, u, D, slot=n),
        ),
        "k2_apply": (
            lambda: k2_apply_cuda("adagrad", w_rows, w_sums,
                                  (table_k, acc_k), hyper),
            lambda: k2_apply_plain("adagrad", w_rows, w_sums,
                                   (table_k, acc_k), hyper),
            None, k2_bound_ms(u, D, rows=n),
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
    # FmGrad's inputs and output (12.3 MB, bf16 6.2 MB) stay in the 50 MB
    # L2 across a graph's replays, where it ran below its HBM bound.  Its
    # line's times are taken again, kernel and plain alike, on copies of
    # the inputs in turn whose bytes pass twice the L2 (209 / 107 MB);
    # the L2-resident ones stay in the record as l2_graph_ms.
    for name, args in (("fm_grad", (rows_t, vals_t, s1_t, dsc)),
                       ("fm_grad_bf16", (rows_t16, vals_t16, s1_t16, dsc))):
        copies = [tuple(t.clone() for t in args)
                  for _ in range(FM_GRAD_COPIES)]

        def in_turn(fn, copies=copies):
            turn = itertools.cycle(copies)
            return lambda: fn(*next(turn))

        pa, ka, kb, pb = (
            graph_ms(torch, in_turn(fn), calls=3 * FM_GRAD_COPIES)
            for fn in (fm_grad_plain, fm_grad_cuda, fm_grad_cuda,
                       fm_grad_plain))
        t = timing[name]
        t["l2_graph_ms"], t["l2_plain_graph_ms"] = (t["graph_ms"],
                                                    t["plain_graph_ms"])
        t.update(ms=min(ka, kb), plain_ms=min(pa, pb), graph_ms=[ka, kb],
                 plain_graph_ms=[pa, pb], input_copies=FM_GRAD_COPIES)
        del copies
    # K1 and K2 on the batch's cut slot [U + 1] (the device sort's).
    for name, kern, plain, (b_ms, b_by) in (
            ("k1_dedup",
             lambda: k1_dedup_cuda(g_rows, ids32, meta0.perm,
                                   meta0.seg_start),
             lambda: k1_dedup_plain(g_rows, ids32, meta0.perm,
                                    meta0.seg_start),
             k1_bound_ms(n, u, D)),
            ("k2_apply",
             lambda: k2_apply_cuda("adagrad", urows, sums, (table_k, acc_k),
                                   hyper),
             lambda: k2_apply_plain("adagrad", urows, sums,
                                    (table_k, acc_k), hyper),
             k2_bound_ms(u, D))):
        pa, ka, kb, pb = (graph_ms(torch, fn) for fn in
                          (plain, kern, kern, plain))
        timing[name]["cut_slot"] = {
            "graph_ms": [ka, kb], "plain_graph_ms": [pa, pb],
            "bound_ms": b_ms, "bound_by": b_by}
    # K1 at its other two streams, on their cut slots (the kernels line
    # keeps the batch's).
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
            "library_ms": graph_ms(torch, k1_library(torch, g, meta)),
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
    counters = ingest_counters(native, DevicePrefetcher, BatchPipeline)
    zero_launches(kernels)
    zero_launches(counters)

    class LossTrainer(Trainer):
        """Keeps each dispatch's step losses (device tensors: a replay's
        are the graph's own, so a copy) for the falling-loss check."""

        def __init__(self, cfg):
            self.step_losses = []
            super().__init__(cfg)

        def dispatch(self, sb, pause=None):
            losses = super().dispatch(sb, pause)
            self.step_losses.append(losses.clone())
            return losses

    t0 = time.perf_counter()
    trainer = LossTrainer(tcfg)
    result = trainer.train()
    train_wall = time.perf_counter() - t0
    train_ingest = read_launches(counters)
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
    check_train_path(tr, train_launches, train_ingest,
                     extra_batches=1)  # the validation file parses too
    losses = torch.cat(trainer.step_losses).tolist()
    last = float(np.mean(losses[-4:]))
    check(all(np.isfinite(losses)), "non-finite step loss")
    check(last < losses[0], f"logloss did not fall: first {losses[0]:.4f}, "
          f"last 4 {last:.4f}")
    val = result["validation"]
    check(np.isfinite(val["logloss"]) and 0 < val["auc"] <= 1,
          f"validation {val}")
    with open(tcfg.score_path) as f:
        main_scores_text = f.read()
    scores_txt = [float(s) for s in main_scores_text.split()]
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
        "native_batches": train_ingest["native_batches"],
        "fused_ships": train_ingest["fused_ships"],
        "dispatches": tr["dispatches"],
        "graph_dispatches": tr["graph_dispatches"],
        "eager_dispatches": tr["eager_dispatches"],
        "first_dispatch_s": tr["first_dispatch_s"],
        "peak_device_mb": peak_mb,
    }}), flush=True)
    # The dense run path 8's tiered run is held against (host copies).
    main_state = {
        "steps": steps, "validation": val, "predict_file": predict_file,
        "scores_text": main_scores_text,
        "table": trainer.model.table.detach().cpu().numpy(),
        "acc": trainer.opt_state.acc_table.cpu().numpy(),
        "w0": trainer.model.w0.detach().cpu().numpy(),
        "acc_w0": trainer.opt_state.acc_w0.cpu().numpy(),
    }
    del trainer

    phase_end("train")

    # -- ingest phase (main path 1 again): the native ingest path -------
    print(json.dumps({"ingest": ingest_phase(
        torch, tcfg, card, train_files, kernels, counters)}), flush=True)
    phase_end("ingest")

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
            "step_logloss": torch.cat(trainer.step_losses).tolist(),
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
    check(bf["result"]["train"]["graph_dispatches"] > 0,
          "the bf16 run replayed no graph")
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

    # -- graph phase: the K-step CUDA graph against the eager steps ----
    # The train files and the validation file: 17 batches.
    print(json.dumps({"graph": graph_phase(
        torch, tcfg, card, train_files + [valid_file],
        TRAIN_FILES * BATCHES_PER_FILE + 1, batches + batches[:1])}),
        flush=True)
    phase_end("graph")

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
    times_dev = []  # the f32 step on a batch already on the device
    for i in range(24):
        for dtype, stepper in steppers.items():
            t0 = time.perf_counter()
            stepper.train_step(batches[i % 3])
            torch.cuda.synchronize()
            times[dtype].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        steppers["float32"].device_step(dev_batches[i % 3])
        torch.cuda.synchronize()
        times_dev.append(time.perf_counter() - t0)
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
            **({"p50_ms_device_batch": p50(times_dev[4:]) * 1e3}
               if dtype == "float32" else {}),
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

    # -- quant phase (path 6): the checkpoint's quantized tables -------
    del ref, scorer, handle
    torch.cuda.empty_cache()
    quant_rec, quant_launches = quant_phase(np, torch, card, rng, model_dir,
                                            tmp)
    print(json.dumps({"quant": quant_rec}), flush=True)
    print("quant check: bf16 and int8 quant.npz and int8 placement serve "
          "within their bounds of fp32; transports bitwise; scores match "
          "the plain path on the dequantized rows; table bytes, placed "
          "bytes and quant_error_max as expected", flush=True)
    phase_end("quant")

    # -- sharded phase (main path 3) -----------------------------------
    sharded, sharded_launches = sharded_phase(
        np, torch, tmp, card, train_files[0], valid_file, one_card=True)
    print(json.dumps(sharded), flush=True)
    print("sharded check: dense and entries runs of a 2 x 2 mesh match the "
          "single-device run; every rank reports the same metrics",
          flush=True)
    phase_end("sharded")

    # -- probe phase (main path 4): the table-layout probe -------------
    probe, probe_timing, probe_launches = probe_phase(
        torch, card, gen, table0, hot, hyper, err, kernels)
    timing.update(probe_timing)
    print(json.dumps(probe), flush=True)
    print("probe check: K2T and K2P == their plain versions and K2's "
          "elements at both streams; micro_probe.main ran at full size",
          flush=True)
    phase_end("probe")

    # -- FFM phase (path 5): field-aware FM at FFM-Criteo -----------------
    ffm, ffm_launches, ffm_timing = ffm_phase(np, torch, card, gen, rng,
                                              kernels, counters, err)
    timing.update(ffm_timing)
    print(json.dumps({"ffm": ffm}), flush=True)
    print("ffm check: K1 and K2 at D = 33 == their plain versions; the op "
          "== autograd; graphed runs bitwise eager; kernel steps == plain "
          "steps; bf16 near f32; transports bitwise; the CLI round trip",
          flush=True)
    phase_end("ffm")

    # -- overlay phase (path 7): a tiered.npz at Criteo-1TB's V ---------
    overlay, overlay_launches = overlay_phase(np, torch, card, rng)
    print(json.dumps({"overlay": overlay}), flush=True)
    print("overlay check: fp32 and int8 overlays serve; transports bitwise; "
          "scores match the plain path on the store's rows; no [V, D] "
          "allocation", flush=True)
    phase_end("overlay")

    # -- tiered phase (path 8): the tiered trainer ----------------------
    tiered_a, tiered_launches = tiered_parity(
        np, torch, card, tcfg, main_state, tmp, kernels, valid_file)
    del main_state
    print(json.dumps({"tiered": tiered_a}), flush=True)
    tiered_b, tiered_b_launches = tiered_bench(np, torch, card, tmp, kernels)
    print(json.dumps({"tiered_bench": tiered_b}), flush=True)
    for name in tiered_launches:
        tiered_launches[name] += tiered_b_launches[name]
    print("tiered check: merged tables against the dense run "
          f"(bitwise: {tiered_a['vs_dense']['table']['bitwise']}), "
          "evictions, K1/K2 on the cut slot once a step, validation and "
          "CLI predict; V = 2^28 trained, saved as tiered.npz and served "
          "with no [V, D] allocation, in fp32, bf16 and int8 cold rows",
          flush=True)
    phase_end("tiered")

    # -- dense phase (path 9): the dense optax path ---------------------
    dense_rec, dense_launches = dense_phase(
        np, torch, card, rng, train_files, valid_file, predict_file,
        batches, tmp, kernels)
    print(json.dumps({"dense": dense_rec}), flush=True)
    step_rec = dense_rec["step"]
    print("dense (" + card + "): " + json.dumps({
        "step_p50_ms": {k: step_rec[k]["step_p50_ms"]
                        for k in ("graphed", "eager")},
        "update_ms": {k: step_rec["update"][k]["graph_ms"]
                      for k in ("adam", "adagrad")},
        "update_bound_ms": {k: step_rec["update"][k]["bound_ms"]
                            for k in ("adam", "adagrad")},
        "peak_device_mb": {k: [r["peak_device_mb"], r["peak_added_device_mb"]]
                           for k, r in dense_rec["runs"].items()},
        "dispatches": {k: [r["graph_dispatches"], r["eager_dispatches"]]
                       for k, r in dense_rec["runs"].items()},
    }), flush=True)
    print("dense check: Adam and Adagrad graphed bitwise their eager "
          "twins (table, moments, count); FmScorer, FmGrad, K1 merge and "
          "K-place once a step, no K1 dedup or K2; kernels within the "
          "bounds of their plain versions over 3 steps; validation, CLI "
          "predict and /score of params.npz; the warm start continues at "
          "the saved count; bf16 near f32; FFM-Criteo at D = 33",
          flush=True)
    phase_end("dense")
    tmp_ctx.cleanup()  # the main run's files, which paths 8 and 9 read

    # Launches on the main paths: train (path 1), serve (paths 2, 6 and
    # 7, with path 8 the only fm_scores count), the sharded runs' ranks
    # (path 3), the probe (path 4, the only K2T and K2P counts), the
    # bf16 train run (path 1 with compute_dtype = bfloat16), the tiered
    # runs (path 8: training, and the fp32 bench run's serving) and the
    # dense runs (path 9).
    launches = {name: train_launches[name] + sharded_launches[name]
                for name in kernels}
    for name in ("fm_grad", "k1_dedup", "k2_apply"):  # path 8
        launches[name] += tiered_launches[name]
    # FmScorer f32: the serve path, the quantized tables (path 6) and
    # the overlay (path 7).
    launches["fm_scores"] = (serve_launches + quant_launches
                             + overlay_launches + tiered_launches["fm_scores"])
    for name in ("fm_scores_bf16", "fm_grad_bf16"):
        launches[name] = bf16_launches[name]  # path 1 in bf16
    for name in ("k2t_apply", "k2p_apply"):
        launches[name] = probe_launches[name]
    for name in ("k1_dedup", "k2_apply"):  # path 5, at D = 33
        launches[f"{name}_d33"] = ffm_launches[name]
    # Path 9, the dense optax path: FmScorer (steps, validation, predict,
    # serve) and FmGrad in both modes, K1's merge mode and K-place (the
    # FFM-Criteo run's at D = 33 among them).
    for name in ("fm_scores", "fm_grad", "fm_scores_bf16", "fm_grad_bf16",
                 "k1_merge", "kplace"):
        launches[name] += dense_launches[name]
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
        "k1_dedup_d33": ("sparse_apply.cu",
                         "fast_tffm_tpu/ops/sparse_apply.py:136"),
        "k2_apply_d33": ("sparse_apply.cu",
                         "fast_tffm_tpu/ops/sparse_apply.py:322"),
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
