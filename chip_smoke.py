#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fast_tffm_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py           # one GPU: every phase below
    python3 chip_smoke.py --nccl    # >= 4 GPUs: phases 1-3, 9, 16 and
                                    # 17 only, one rank per GPU over NCCL

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
   Every run's health carry is compared bitwise too.
6c. Obs phase (main path 1 with the health carry and the observability
   planes, K = 4 graphed): (a) the 16 steps with ``metrics_file``,
   ``heartbeat_secs = 0.05``, a free ``status_port``, ``alert_rules =
   step > 0 : warn`` and ``nan_policy = halt``: a ``run_header`` first,
   heartbeats, one alert and one ``final`` record whose wait, dispatch
   and other seconds sum to ``elapsed`` within 0.02 s; ``/status`` and
   ``/metrics`` scraped after a dispatch (the Prometheus text parses);
   ``emb_rows_touched`` and ``emb_touch_events`` equal to the host's
   count over the same lines, no non-finite step; the kernels and
   replays of phase 5; tables, accumulator, w0 and the carry bitwise
   those of the same run with none of those planes.  (b) ``w0`` filled
   with NaN in place after the capture: ``NonFiniteGradError`` within
   one dispatch of the poisoned replay, the last checkpoint the clean
   save before it (``save_steps = K``), the final record naming the
   exception, and one ``crash_NonFiniteGradError`` blackbox bundle.
   (c) ``step > 0 : halt``: ``AlertHaltError`` and no
   checkpoint.  (d) Phase 5's checkpoint served with a stream, a
   heartbeat, a warn rule, ``serve_trace_sample = 1`` and the skew
   monitor: its ``run_header`` (``mode: serve``), heartbeats and one
   alert; after 64 ``/score_bin`` requests of the training lines the
   ``skew_*`` keys present and finite, and every request a complete
   chain in the port's ``report --serve-trace``.  (e) The graphed
   step's p50 (host clock, synchronised) and its device time (CUDA
   events) at K = 1 and 4 with the carry and from a graph of the same
   steps without it, and path 9's graphed Adam step the same way.
   (f) One graphed run with every 4c plane on (quality, trace,
   blackbox, ``profile_dir`` over the second dispatch, a status port
   answering ``/profile?secs=0.2`` and ``POST /incident`` after that
   window): tables, accumulator, ``w0`` and the carry bitwise (a)'s
   twin with every plane off; the manifest's ``quality`` payload
   counting the lines trained; one complete trace chain a dispatch;
   a Chrome trace naming FmScorer, FmGrad, K1 and K2; one expected
   capture in the compile sentinel; a bundle ``report --incident``
   reads.  (g) The default-on quality plane's cost, printed: examples/s
   over 4 epochs (``tools/ingest_bench.py``, 8 threads, cache off) with
   quality on and off in turns, and the graphed step with the scores
   copy and without at K = 1 and 4.
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
8a. Serve-fleet phase (path 13, ``serve_replicas = 2``): two replica
   processes on the card behind the router, over a copy of the
   checkpoint.  Through the CLI (``serve --replicas 2``): every rung
   and one request past the largest over both transports, bitwise the
   serve phase's answers, each replica's ``/status`` kernel launches
   grown; the ``/score_bin`` p50 per rung direct to a replica and
   through the router; requests a second of 8 client processes against
   one replica and through the router (twice each, in turns); each
   replica's device memory (``nvidia-smi --query-compute-apps``); a
   burst over a second router at a 1 ms shedding budget (429 +
   ``Retry-After``, every 200 right); a replica SIGKILLed under load
   (every request answered right, seconds to readmission, the respawned
   replica bitwise); SIGTERM leaves no replica.  Through
   ``start_fleet`` with the canary and capture at sample 1: each
   replica's capture replays with exit 0, a re-save of the same table
   is promoted to both replicas, one scaled x3 is rolled back with its
   compare artifacts kept; no replica outlives the fleet.
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
   K1's merge mode every step, no K-place; this run also scrapes the
   training fleet, ``train_fleet_scrape`` over the four ranks' status
   ports, and rank 0's ``fleet`` block must count 4 ranks and an
   ``exchange_frac`` in [0, 1]).  Checks: every rank reports
   the same global metrics; the table rank 0 saves matches a
   single-device run over the same global batches (table, accumulator,
   w0, ``delta_check``).  Then a third run: ``lookup = auto``,
   ``sparse_exchange = entries``, ``sparse_exchange_overlap = on`` and
   two steps a dispatch (each step's id plane gathered while the step
   before it runs): its checkpoint bitwise the ``auto`` run's.  Each
   rank's step p50 and the share of it spent in the step's collectives
   (host clock, synchronised around each collective, staging copies
   included; the overlap's id-plane gather at its start and its wait).
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
   gradient's K1 merge, K-place (bitwise its plain version, and in turns
   with it and its library yardstick) and full-L2 term at the step's
   shapes; each run's peak device memory (and over what the process held
   before it) and graph/eager dispatches.
15. Orbax-serve phase (path 10): (a) the JAX package's Orbax
   checkpoints committed in ``tests/data/orbax`` (FM with the sparse
   Adagrad state, a table row-sharded over a 2 x 4 mesh, FFM with FTRL,
   FM with Adam; written by ``tests/make_orbax_fixtures.py``), read
   without jax and served through ``make_scorer`` in fp32 (the FM one
   also at int8 placement): scores within ``rtol=1e-5, atol=1e-6`` of
   the reference scorer's stored ones (int8 within 2e-2) and within
   ``KERNEL_TOL`` of the plain path; ``cli predict`` from the FM
   fixture; a warm start from it (table, w0 and accumulators bitwise
   the fixture's) for 16 graphed steps, then 3 sparse steps from its
   state through the kernels against 3 through the plain versions.  (b)
   The hot swap at full width: phase 5's checkpoint served with
   ``serve_poll_secs = 0.2`` while one keep-alive ``/score_bin`` client
   posts 256 lines continuously; a trainer warm-started from it (eager:
   it shares the server's process) trains 16 more steps and saves; the
   watcher swaps (seconds from the publish, placement wall time), every
   response is the old or the new table's bitwise, ``/score`` then
   equals the new predict file; ``/reload?keep_prev=1`` of the old
   ``params.npz``, ``/rollback``, ``/reload?keep_prev=1``,
   ``/promote`` and a ``/rollback`` answering 409; the keep_prev
   window's peak device memory and the dispatch p50 during and after
   the swap.
16. Fleet phase (path 11, the rank-sharded tiered table,
   ``tiered_partition = shards``): (a) phase 5's config and files with
   ``table_tiering = on``, ``hot_rows = 2^18`` (2^17 a rank),
   ``mesh_data = 1``, ``mesh_model = 2``, ``lookup = auto`` and no
   validation files, two ranks of this script sharing the card over
   gloo (four, one per GPU over NCCL, with ``--nccl``), against the dense
   ``1 x 2`` mesh over the same lines and seed: each rank's loss and AUC,
   w0 and its slot, and the table and accumulator merged from the two
   ``tiered.shard{s}of2.npz`` against the dense ``params.npz``, all
   bitwise; evictions; FmGrad, K1 and K2 every step on every rank.  Each
   rank's plan ms a super-batch, migration device ms a dispatch, tier
   counters, step p50 and collective share, and peak device memory.
   (b) The shard set served through ``serve()`` and predicted through
   ``python -m fast_tffm_tpu_torch.cli predict`` on one device, within
   ``SERVE_TOL`` of the dense ``params.npz`` served and predicted the
   same way; then warm-started on one device (2 shards -> 1: every saved
   row back bitwise through ``gather_logical``) and trained 4 steps.
   Each rank's peak device memory counts from before its trainer is
   built (the exact store's draw inside it).
16b. Autotune phase (path 14, ``ops/autotune.py`` at Criteo-Kaggle
   width): ``resolve(auto)`` measures ``reference``, ``pallas`` and
   ``packed`` in the train context at B = 4096 (a CUDA graph of one
   forward and backward each; the eager times beside) and in the serve
   context at the max rung for fp32, bf16 and int8 tables: every
   candidate runs, passes the parity gate and is printed with its times
   and error, and a second resolve hits the cache with no measurement;
   a doubled ``packed`` is gated out on the card; five steps (one eager
   and captured, four replayed) with each pin and with ``auto`` from one
   seeded table on one set of batches: each bitwise its eager twin,
   FmScorer and FmGrad once a step under ``pallas`` and never under the
   other two, the tables within ``rtol=1e-5, atol=1e-6`` of each other,
   ``auto`` (a cache hit) bitwise its winner; ``python -m
   fast_tffm_tpu_torch.tools.autotune`` fills the cache beside the model
   and ``--check`` exits 0; ``serve()`` of an ``auto`` config starts
   from that file with no measurement (its ``record: autotune`` says
   ``cache``), and its ``/score_bin`` agrees with ``predict``.
17. Mesh-modes phase (path 12, the trainer's rank-mesh settings): four
   ranks of a 2 x 2 mesh sharing the card over gloo (one GPU each with
   ``--nccl``), one group of ranks training seven runs in turn on the
   line stream, each against the one-device run of the same setting
   over the same global batches from the same seed: (a) FFM-Criteo
   (``field_num = 4``, D = 33) with ``sparse_exchange = entries`` (4
   steps), the same with ``sparse_exchange_overlap = on`` (bitwise the
   entries run) and ``dense`` (2 steps: a 554 MB delta a rank summed
   through host memory), within the tile-vs-scatter bounds, and the
   entries run's ``params.npz`` served by one process (no FmScorer);
   (b) FM in ``compute_dtype = bfloat16`` and in f32 (8 steps each):
   the bf16 logloss within 1e-2 of the f32 mesh's, its parameters within
   ``rtol=0.05, atol=0.02`` of the one-device bf16 run and its table's
   change within 0.05 of that run's change (in norm), the f32 FmGrad,
   K1 and K2 once a step on every rank and no bf16 FmGrad; (c) path 9's
   dense optax config, Adam and Adagrad (4 steps): parameters and
   optimizer state within ``rtol=1e-4, atol=1e-6``, Adam's count exact,
   K1's merge mode and K-place once a step on every rank and no K1
   dedup or K2.  Each rank's step p50, collective share, launches and
   peak device memory (from before its trainer is built).  Then the
   path's new kernel shapes on a data block of the mesh, against their
   plain versions and timed in CUDA graphs beside their bounds: K1 at
   D = 33 on a model shard (the sentinel's segment dropped; its
   ``index_add_`` over the owned occurrences alone), K-place at W = 66
   and W = 9 (bitwise; its library yardstick ``zero_()`` and one
   ``index_copy_``), K1's merge mode at W = 66 and 9, K2 at D = 33 on
   the merged rows.

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
import math
import os
import re
import shutil
import signal
import socket
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
# Rank-sharded tiering (path 11): the fleet's global hot table (2^17
# rows a rank on two ranks) and the steps of its one-device warm start.
FLEET_HOT = 1 << 18
FLEET_WARM_STEPS = 4
# Path 12 (the rank mesh's FFM, bf16 and dense optax runs): steps of
# each run (depth cut to keep the phase near 90 s on one card), the
# bf16 bounds of tests/test_bf16.py and the group's deadline (seven
# runs in one group of ranks).
MESH_FFM_STEPS, MESH_FFM_DENSE_STEPS = 4, 2
MESH_BF16_STEPS, MESH_DENSE_STEPS = 8, 4
BF16_PARAM_TOL = dict(rtol=0.05, atol=0.02)
MESH_MODES_TIMEOUT_S = 600
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
# Path 13, the serving fleet: the load clients (one process each) and
# their seconds, the timed requests per rung, and the shedding burst's
# admission budget.
FLEET_CLIENTS = 8
FLEET_LOAD_S = 3.0
FLEET_TIMED = 30
FLEET_SHED_MS = 1.0
# The obs phase (main path 1 with the observability planes): its
# dispatch's steps, the hold before each dispatch of its throttled runs
# (heartbeats at 0.05 s and the scrapes then fall between dispatches),
# and the timed dispatches of each step with and without the carry.
OBS_K = 4
OBS_THROTTLE_S = 0.1
OBS_TIMED = 40
# The obs phase's server (d): /score_bin requests of the training lines,
# and each one's rows.
SERVE_BIN_REQUESTS = 64
SERVE_BIN_ROWS = 64
# The profiler trace of (f) must name the main path's four kernels.
PATH_KERNEL_SYMBOLS = ("fm_scores_fwd_kernel", "fm_grad_bwd_kernel",
                       "k1_kernel", "k2_kernel")


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


def time_cases(torch, cases: dict, calls: dict = None) -> dict:
    """Each case's kernel and plain version timed in CUDA graphs in
    turns (plain, kernel, kernel, plain), and its library call where it
    has one, beside its bound.  ``cases``: name -> ``(kernel, plain,
    library or None, (bound_ms, bound_by))``; ``calls``: the calls a
    graph holds, by name (100 where absent)."""
    timing = {}
    for name, (kern, plain, lib, (b_ms, b_by)) in cases.items():
        n = (calls or {}).get(name, 100)
        pa, ka, kb, pb = (graph_ms(torch, fn, calls=n) for fn in
                          (plain, kern, kern, plain))
        timing[name] = {
            "ms": min(ka, kb), "plain_ms": min(pa, pb),
            "graph_ms": [ka, kb], "plain_graph_ms": [pa, pb],
            "library_ms": None if lib is None else graph_ms(torch, lib),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    return timing


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
    others are never read: a block finds its own by a search of the
    ascending rows), the dense delta written once; no arithmetic."""
    return bound(4 * (u * (w + 1) + vocab_local * w), 0)


def kplace_library(torch, plain, urows, sums, row_lo: int, vocab_local: int):
    """K-place's library yardstick, two PyTorch calls on a delta
    allocated beforehand: ``zero_()``, then one ``index_copy_`` of the
    entries inside the shard (their rows and sums cut beforehand).
    Checked bitwise against ``plain`` (its plain version) here."""
    inside = (urows >= row_lo) & (urows < row_lo + vocab_local)
    idx = (urows[inside].long() - row_lo).contiguous()
    vals = sums[inside].contiguous()
    delta = torch.empty((vocab_local, sums.shape[1]), device=sums.device)

    def call():
        return delta.zero_().index_copy_(0, idx, vals)

    check(torch.equal(call(), plain(urows, sums, row_lo, vocab_local)),
          "K-place's library yardstick does not compute its function")
    return call


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
        s_p = dense.dense_step(cfg, models[1], opts[1], b, plain=True,
                               impl="jnp")
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
    the gradient's K1 merge and K-place at the step's shapes (K-place
    bitwise its plain version, timed with it and its library
    yardstick).  Returns
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
    check(torch.equal(sparse_apply.kplace_cuda(m_rows, m_sums, 0, V),
                      sparse_apply.kplace_plain(m_rows, m_sums, 0, V)),
          "dense: K-place at [V, D] is not bitwise its plain version")
    grad_kernels = {
        "k1_merge": (lambda: sparse_apply.k1_merge_cuda(
            g_rows, ids32, meta.perm, meta.seg_start),
            k1_merge_bound_ms(n, u, D)),
        # The full L2's closed-form term: read the gradient and the
        # table, write the gradient; a product and a sum an element.
        "l2_full_grad": (lambda: g_table.addcmul_(model.table.detach(), lam),
                         bound(4 * V * D * 3, 2 * V * D)),
    }
    for name, (fn, (b_ms, b_by)) in grad_kernels.items():
        ms = graph_ms(torch, fn, calls=20)
        update[name] = {"graph_ms": ms, "bound_ms": b_ms, "bound_by": b_by}
    # K-place in turns with its plain version and its library yardstick.
    update.update(time_cases(torch, {"kplace": (
        lambda: sparse_apply.kplace_cuda(m_rows, m_sums, 0, V),
        lambda: sparse_apply.kplace_plain(m_rows, m_sums, 0, V),
        kplace_library(torch, sparse_apply.kplace_plain, m_rows, m_sums, 0,
                       V),
        kplace_bound_ms(u, D, V))}, calls={"kplace": 20}))
    del model, dtable, g_rows, g_table, m_rows, m_sums, dev_batches, sb
    gc.collect()
    torch.cuda.empty_cache()
    timing["unique_rows"] = u
    timing["update"] = update
    record["step"] = timing
    return record, launches


ORBAX_FIXTURES = os.path.join(REPO, "tests", "data", "orbax")
ORBAX_WARM_B = 256  # the Adagrad fixture's warm start: 16 batches of it
ORBAX_POLL_S = 0.2  # the full-width hot swap's watcher poll
ORBAX_REQUEST_LINES = 256


def fixture_lines(np, rng, n: int, vocab: int, feats: int = 10) -> list:
    """Labelled ``id:val`` lines over a small vocabulary."""
    out = []
    for _ in range(n):
        ids = rng.choice(vocab, size=feats, replace=False)
        vals = rng.uniform(0.1, 1.0, feats)
        out.append(f"{int(rng.integers(0, 2))} " + " ".join(
            f"{i}:{v:.4f}" for i, v in zip(ids, vals)) + "\n")
    return out


def post_status(conn, path: str, body: bytes = b"") -> tuple:
    conn.request("POST", path, body=body,
                 headers={"Content-Length": str(len(body))})
    resp = conn.getresponse()
    return resp.status, resp.read()


def orbax_fixtures(np, torch, rng, tmp: str, kernels: dict) -> tuple:
    """Path 10 (a): the committed Orbax fixtures (``tests/data/orbax``,
    written by the JAX package; read here without jax) on the card.
    Each is served through ``make_scorer`` in fp32 (``fm_adagrad`` also
    at int8 placement): scores within ``SERVE_TOL`` of the reference
    scorer's stored ones (fp32) or within the int8 bound of them, and
    within ``KERNEL_TOL`` of the plain path on the fixture's (or the
    dequantized) rows.  ``python -m fast_tffm_tpu_torch.cli predict``
    from ``fm_adagrad``.  A warm start from ``fm_adagrad``: the trainer's
    initial table, w0 and accumulators bitwise the fixture's arrays, 16
    graphed steps.  Returns the record, the launches of all that, and
    what the kernel-vs-plain steps need (checked by the caller after the
    count is read)."""
    from fast_tffm_tpu_torch import cli
    from fast_tffm_tpu_torch.config import FmConfig
    from fast_tffm_tpu_torch.ops import quant
    from fast_tffm_tpu_torch.serve.scorer import make_scorer
    from fast_tffm_tpu_torch.train import checkpoint, orbax_read
    from fast_tffm_tpu_torch.train.loop import Trainer

    with open(os.path.join(ORBAX_FIXTURES, "fixtures.json")) as f:
        specs = json.load(f)
    rec = {"served": {}}
    zero_launches(kernels)
    for name, spec in sorted(specs.items()):
        model_file = os.path.join(ORBAX_FIXTURES, name)
        req = np.load(os.path.join(ORBAX_FIXTURES, f"{name}.npz"))
        ids, vals = req["ids"], req["vals"]
        fields = req["fields"] if spec["cfg"]["field_num"] else None
        step, w0, table = checkpoint.restore_arrays(model_file)
        for dtype in ("fp32", "int8") if name == "fm_adagrad" else ("fp32",):
            cfg = FmConfig(model_file=model_file, serve_table_dtype=dtype,
                           quant_chunk=QUANT_CHUNK, **spec["cfg"])
            t0 = time.perf_counter()
            scorer = make_scorer(cfg)
            load_s = time.perf_counter() - t0
            check(scorer.step == spec["step"] == step,
                  f"{name}: served step {scorer.step}")
            got = scorer.score(ids, vals, fields)
            rows = table[ids] if dtype == "fp32" else quant.dequantize_rows(
                quant.quantize_table(table, "int8", QUANT_CHUNK), ids)
            plain = plain_served(torch, w0, rows, vals, fields,
                                 cfg.factor_num, cfg.field_num)
            np.testing.assert_allclose(got, plain, **KERNEL_TOL)
            dev = float(np.abs(got - req["scores"]).max())
            if dtype == "fp32":
                np.testing.assert_allclose(got, req["scores"], **SERVE_TOL)
            else:
                check(dev <= SERVE_BOUND["int8"],
                      f"{name} int8: {dev} from the reference's fp32")
            rec["served"][f"{name}_{dtype}"] = {
                "step": scorer.step, "load_and_place_s": load_s,
                "max_abs_vs_reference": dev,
                "max_abs_vs_plain": float(np.abs(got - plain).max())}
            del scorer
    # The CLI's predict from the FM fixture.
    spec = specs["fm_adagrad"]["cfg"]
    fixture = os.path.join(ORBAX_FIXTURES, "fm_adagrad")
    req = np.load(fixture + ".npz")
    pred_file = os.path.join(tmp, "orbax_predict.libsvm")
    with open(pred_file, "w") as f:
        for row_ids, row_vals in zip(req["ids"], req["vals"]):
            f.write("0 " + " ".join(f"{i}:{v!r}" for i, v in zip(
                row_ids, row_vals.tolist()) if v != 0) + "\n")
    cfg_path = os.path.join(tmp, "orbax_fixture.cfg")
    with open(cfg_path, "w") as f:
        f.write("[General]\n" + "".join(
            f"{k} = {str(v).lower() if isinstance(v, bool) else v}\n"
            for k, v in spec.items()) + f"model_file = {fixture}\n"
            f"[Predict]\npredict_files = {pred_file}\n"
            f"score_path = {tmp}/orbax_scores.txt\n")
    check(cli.main(["predict", cfg_path]) == 0, "CLI predict of fm_adagrad")
    cli_scores = np.loadtxt(os.path.join(tmp, "orbax_scores.txt"))
    np.testing.assert_allclose(cli_scores, req["scores"], rtol=1e-5,
                               atol=1e-6)
    rec["cli_predict_lines"] = len(cli_scores)
    # A warm start from the Adagrad fixture: 16 graphed steps.
    warm_dir = os.path.join(tmp, "orbax_warm")
    shutil.copytree(fixture, warm_dir)
    data = os.path.join(tmp, "orbax_train.libsvm")
    with open(data, "w") as f:
        f.writelines(fixture_lines(np, rng, 16 * ORBAX_WARM_B,
                                   spec["vocabulary_size"]))
    wcfg = FmConfig(**{**spec, "model_file": warm_dir, "train_files": [data],
                       "batch_size": ORBAX_WARM_B, "thread_num": 2,
                       "log_steps": 0})
    trainer = Trainer(wcfg)
    _, want_w0, want_table, _ = orbax_read.read_params(fixture)
    want_acc = orbax_read.read_opt(fixture, "adagrad")
    start = {"table": trainer.model.table.detach().cpu().numpy(),
             "w0": trainer.model.w0.detach().cpu().numpy(),
             "acc_table": trainer.opt_state.acc_table.cpu().numpy(),
             "acc_w0": trainer.opt_state.acc_w0.cpu().numpy()}
    for key, want in (("table", want_table), ("w0", want_w0),
                      ("acc_table", want_acc["acc_table"]),
                      ("acc_w0", want_acc["acc_w0"])):
        check(start[key].tobytes() == np.asarray(want).tobytes(),
              f"warm start from fm_adagrad: {key} is not the fixture's")
    check(trainer._restored_step == specs["fm_adagrad"]["step"],
          "warm start step")
    res = trainer.train()["train"]
    check(res["steps"] == 16 and res["graph_dispatches"] == 15
          and res["eager_dispatches"] == 1,
          f"warm start: {res['steps']} steps, {res['graph_dispatches']} "
          f"graphed, {res['eager_dispatches']} eager")
    torch.cuda.synchronize()
    rec["warm_start"] = {"steps": res["steps"],
                         "graph_dispatches": res["graph_dispatches"],
                         "eager_dispatches": res["eager_dispatches"],
                         "logloss": res["logloss"],
                         "initial_state": "bitwise the fixture's"}
    launches = read_launches(kernels)
    with open(data) as f:
        head = [next(f) for _ in range(3 * ORBAX_WARM_B)]
    return rec, launches, (wcfg, start, head)


def orbax_parity(np, torch, fm, sparse, make_batch, parse_lines,
                 host_sort_meta, wcfg, start, head) -> dict:
    """Path 10 (a), last: 3 sparse steps from the Adagrad fixture's state
    through the kernels against 3 through the plain versions (scores
    ``KERNEL_TOL``, table ``TABLE_TOL``, accumulator ``OPT_TOL``)."""
    dev = torch.device("cuda")

    def fresh():
        def put(key):
            return torch.tensor(start[key], device=dev)  # a copy

        return (fm.FmModel(put("w0"), put("table")),
                sparse.SparseAdagradState(put("acc_w0"), put("acc_table")))

    b, v, f = wcfg.batch_size, wcfg.vocabulary_size, wcfg.max_features
    batches = []
    for i in range(3):
        batch = make_batch(parse_lines(head[i * b:(i + 1) * b], v,
                                       wcfg.hash_feature_id), b, f)
        batches.append(sparse.to_device(
            batch._replace(sort_meta=host_sort_meta(batch.ids)), dev))
    (mk, ok), (mp, op) = fresh(), fresh()
    score_err = 0.0
    for batch in batches:
        s_k = sparse.sparse_step(wcfg, mk, ok, batch)
        s_p = sparse.sparse_step(wcfg, mp, op, batch, plain=True,
                                 impl="jnp")
        torch.testing.assert_close(s_k, s_p, **KERNEL_TOL)
        score_err = max(score_err, float((s_k - s_p).abs().max()))
    torch.cuda.synchronize()
    torch.testing.assert_close(mk.table, mp.table, **TABLE_TOL)
    torch.testing.assert_close(ok.acc_table, op.acc_table, **OPT_TOL)
    return {"steps": 3, "scores_max_abs_err": score_err,
            "table_max_abs_err": float(
                (mk.table - mp.table).detach().abs().max()),
            "acc_max_abs_err": float(
                (ok.acc_table - op.acc_table).abs().max())}


def orbax_hot_swap(np, torch, card: str, tcfg, model_dir: str,
                   predict_file: str, tmp: str, kernels: dict) -> tuple:
    """Path 10 (b): the main run's Criteo-Kaggle checkpoint served with
    ``serve_poll_secs = 0.2`` while one keep-alive ``/score_bin`` client
    posts the predict file's first 256 lines continuously; a trainer
    warm-started from that checkpoint trains 16 more steps and saves
    (publishing the manifest): the watcher's swap lands (seconds from the
    publish to the swap, the placement's wall time), every response is
    the old table's scores or the new one's bitwise, and after the swap
    ``/score`` equals the new checkpoint's predict file.  Then
    ``/reload?keep_prev=1`` of the old ``params.npz`` (put back without a
    publish) serves the old scores bitwise and ``/rollback`` the new ones
    again; ``/reload?keep_prev=1``, ``/promote``, and a ``/rollback``
    answers 409.  The peak device memory of the keep_prev window and
    the dispatch p50 during and after the swap."""
    import threading

    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.serve import wire
    from fast_tffm_tpu_torch.serve.server import serve
    from fast_tffm_tpu_torch.serve.textparse import parse_request
    from fast_tffm_tpu_torch.train import checkpoint
    from fast_tffm_tpu_torch.train.loop import Trainer, predict
    from fast_tffm_tpu_torch.train.manifest import read_manifest

    old_npz = os.path.join(tmp, "old_params.npz")
    shutil.copy(checkpoint.params_path(model_dir), old_npz)
    scfg = load_config(CFG_PATH, {"model_file": model_dir, "serve_port": 0,
                                  "serve_poll_secs": ORBAX_POLL_S})
    with open(predict_file) as f:
        text = "".join(next(f) for _ in range(ORBAX_REQUEST_LINES))
    ids, vals, _, n, _ = parse_request(text, scfg)
    check(n == ORBAX_REQUEST_LINES, "request parse")
    frame = wire.encode_bin_request(ids, vals)
    zero_launches(kernels)
    handle = serve(scfg)
    dispatches = []  # (end time, seconds) of every scorer dispatch
    scorer = handle.scorer
    orig_dispatch = scorer._dispatch

    def timed_dispatch(rung):
        t0 = time.perf_counter()
        out = orig_dispatch(rung)
        dispatches.append((time.perf_counter(), time.perf_counter() - t0))
        return out

    scorer._dispatch = timed_dispatch
    responses, stop = [], threading.Event()

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                          timeout=120)
        while not stop.is_set():
            responses.append((time.perf_counter(), post(conn, "/score_bin",
                                                        frame)))
        conn.close()

    rec = {"card": card, "poll_s": ORBAX_POLL_S,
           "request_examples": ORBAX_REQUEST_LINES}
    thread = threading.Thread(target=client)
    try:
        old_step = scorer.step
        thread.start()
        t_end = time.perf_counter() + 60
        while not responses:
            check(thread.is_alive() and time.perf_counter() < t_end,
                  "the /score_bin client got no answer")
            time.sleep(0.01)
        old = responses[0][1]
        t_train = time.perf_counter()
        trainer = Trainer(dataclasses.replace(tcfg, epoch_num=2))
        check(trainer._restored_step == old_step, "warm start step")
        # Eager: this trainer shares its process with the server, whose
        # threads a graph capture would have to exclude.
        trainer.graph = None
        res = trainer.train()["train"]
        del trainer
        check(res["steps"] == 16, f"the warm start trained {res['steps']}")
        published = read_manifest(model_dir)
        t_pub = time.perf_counter() - (time.time() - published["published"])
        check(published["step"] == old_step + 16, f"manifest {published}")
        t_end = time.perf_counter() + 60
        while scorer.step != published["step"]:
            check(time.perf_counter() < t_end, "the watcher never swapped")
            time.sleep(0.005)
        t_swap = time.perf_counter()
        time.sleep(0.5)
        stop.set()
        thread.join()
        place_s = scorer.place_wall_s
        new = responses[-1][1]
        check(new != old, "the swap changed no score")
        kinds = [0 if r == old else 1 if r == new else -1
                 for _, r in responses]
        check(-1 not in kinds, "a response mixed the two tables")
        check(all(k == 1 for (t, _), k in zip(responses, kinds)
                  if t > t_swap + 0.05), "an old score after the swap")
        # After the swap /score equals the new checkpoint's predict file.
        pcfg = dataclasses.replace(tcfg, score_path=os.path.join(
            tmp, "swap_scores.txt"))
        predict(pcfg)
        with open(pcfg.score_path) as f:
            want_text = "".join(next(f) for _ in range(ORBAX_REQUEST_LINES))
        conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                          timeout=120)
        check(post(conn, "/score", text.encode()).decode() == want_text,
              "/score after the swap differs from the new predict file")
        # The admin routes: the old params.npz back without a publish.
        os.replace(old_npz, checkpoint.params_path(model_dir))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        status, body = post_status(conn, "/reload?keep_prev=1")
        check(status == 200 and json.loads(body)["step"] == old_step,
              f"/reload?keep_prev=1: {status} {body!r}")
        window_peak = torch.cuda.max_memory_allocated()
        window_held = torch.cuda.memory_allocated()
        check(post(conn, "/score_bin", frame) == old,
              "/reload?keep_prev=1 did not serve the old scores")
        status, body = post_status(conn, "/rollback")
        check(status == 200 and json.loads(body)["step"] == published["step"]
              and post(conn, "/score_bin", frame) == new,
              f"/rollback: {status} {body!r}")
        status, _ = post_status(conn, "/reload?keep_prev=1")
        status2, body = post_status(conn, "/promote")
        check(status == status2 == 200 and json.loads(body)["step"]
              == old_step, "/reload then /promote")
        status, _ = post_status(conn, "/rollback")
        check(status == 409, f"a second /rollback answered {status}")
        conn.close()
        swaps = handle.telemetry.snapshot()["counters"].get("serve.swaps")
    finally:
        stop.set()
        if thread.is_alive():
            thread.join()
        handle.close()
    launches = read_launches(kernels)
    during = [d for t, d in dispatches if t_train <= t <= t_swap]
    after = [d for t, d in dispatches if t_swap < t]
    rec.update({
        "swap_landed": True, "old_step": old_step,
        "new_step": published["step"], "publish_to_swap_s": t_swap - t_pub,
        "trainer_dispatch": "eager",
        "placement_wall_s": place_s, "responses": len(responses),
        "responses_old": kinds.count(0), "responses_new": kinds.count(1),
        "dispatch_p50_ms_during_swap": p50(during) * 1e3 if during else None,
        "dispatch_p50_ms_after_swap": p50(after) * 1e3 if after else None,
        "dispatches_during": len(during), "dispatches_after": len(after),
        "keep_prev_window_peak_device_mb": window_peak / 2**20,
        "keep_prev_window_added_mb": (window_held - before) / 2**20,
        "device_mb_before_window": before / 2**20,
        "swaps": swaps, "warm_start_steps": res["steps"],
    })
    return rec, launches


# -- serving fleet phase (path 13) --------------------------------------


def fleet_client_main(argv) -> int:
    """One load client: ``chip_smoke.py --fleet-client PORT FRAME WANT
    START SECONDS``.  POSTs the ``/score_bin`` frame in file FRAME over
    one kept-alive connection from unix time START for SECONDS and
    prints a JSON line: requests made, their status codes, the
    ``Retry-After`` values of the 429s, and how many 200s differed from
    the bytes in file WANT.  Imports nothing past the standard library,
    so the processes start in milliseconds."""
    port, frame_path, want_path, start, seconds = argv
    with open(frame_path, "rb") as f:
        frame = f.read()
    with open(want_path, "rb") as f:
        want = f.read()
    time.sleep(max(0.0, float(start) - time.time()))
    end = float(start) + float(seconds)
    conn = http.client.HTTPConnection("127.0.0.1", int(port), timeout=120)
    codes, retry, wrong, n, errors = {}, set(), 0, 0, 0
    while time.time() < end:
        try:
            conn.request("POST", "/score_bin", body=frame, headers={
                "Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException):
            errors += 1
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", int(port),
                                              timeout=120)
            continue
        n += 1
        key = str(resp.status)
        codes[key] = codes.get(key, 0) + 1
        if resp.status == 200:
            wrong += data != want
        elif resp.status == 429:
            retry.add(resp.getheader("Retry-After") or "")
        if resp.will_close:
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", int(port),
                                              timeout=120)
    conn.close()
    print(json.dumps({"n": n, "codes": codes, "retry_after": sorted(retry),
                      "wrong": wrong, "errors": errors}), flush=True)
    return 0


def load_run(port: int, frame_path: str, want_path: str,
             clients: int = None, seconds: float = None,
             during=None) -> dict:
    """``clients`` load-client processes against ``port`` for
    ``seconds``, started together; ``during()`` runs in this process
    while they load.  Returns their merged counts and requests a
    second."""
    clients = clients or FLEET_CLIENTS
    seconds = seconds or FLEET_LOAD_S
    start = time.time() + 1.5
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fleet-client",
         str(port), frame_path, want_path, f"{start:.6f}", str(seconds)],
        stdout=subprocess.PIPE) for _ in range(clients)]
    extra = None
    try:
        if during is not None:
            time.sleep(max(0.0, start - time.time()))
            extra = during()
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=seconds + 300)
            check(p.returncode == 0, f"a load client exited {p.returncode}")
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = {}
    for o in outs:
        for k, v in o["codes"].items():
            codes[k] = codes.get(k, 0) + v
    n = sum(o["n"] for o in outs)
    return {"clients": clients, "seconds": seconds, "requests": n,
            "rps": n / seconds, "codes": codes,
            "retry_after": sorted({r for o in outs
                                   for r in o["retry_after"]}),
            "wrong": sum(o["wrong"] for o in outs),
            "errors": sum(o["errors"] for o in outs), "during": extra}


def write_fleet_cfg(tmp: str, name: str, model_file: str, **predict) -> str:
    """``examples/criteo_kaggle.cfg`` with ``model_file`` and the given
    ``[Predict]`` settings, written to ``tmp/name``."""
    import configparser

    parser = configparser.ConfigParser()
    parser.read(CFG_PATH)
    parser["General"]["model_file"] = model_file
    for key, val in predict.items():
        parser["Predict"][key] = str(val)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        parser.write(f)
    return path


def pid_alive(pid: int) -> bool:
    """Whether ``pid`` is a live (not zombie) process."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(") ", 1)[1][0] != "Z"
    except (OSError, IndexError):
        return False


def read_line(proc, timeout: float) -> str:
    """The first line ``proc`` prints, or "" at EOF or after
    ``timeout`` seconds."""
    import threading

    box = []
    t = threading.Thread(target=lambda: box.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    return box[0].decode() if box else ""


def replica_status(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        return get_json(conn, "/status")
    finally:
        conn.close()


def app_memory_mib() -> dict:
    """pid -> used device MiB of the card's compute processes, as
    ``nvidia-smi --query-compute-apps`` lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout
    mem = {}
    for line in out.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            mem[int(parts[0])] = int(parts[1])
    return mem


def serve_fleet_phase(np, torch, card: str, tmp: str, model_dir: str,
                      served, bodies) -> tuple:
    """Path 13, the serving fleet: two replica processes of the port's
    serving stack on the card behind the router, over a copy of path 1's
    checkpoint.  Fleet T runs through the CLI (``serve --replicas 2``,
    the router in its own process): every rung and one request past the
    largest over both transports, bitwise path 2's answers (``served``,
    ``bodies``), each replica's kernel launches grown; the ``/score_bin``
    p50 direct to a replica and through the router per rung; requests a
    second of FLEET_CLIENTS client processes against one replica and
    through the router; each replica's device memory; a burst over a
    second router at FLEET_SHED_MS (429 + Retry-After, every 200 right);
    a replica SIGKILLed under load (every request answered right, the
    seconds to readmission, the respawned replica bitwise); SIGTERM
    leaves no replica.  Fleet C (``start_fleet``, canary and capture at
    sample 1): the captures replay bitwise through the port's replay
    tool, a re-save of the same table is promoted to both replicas, a
    table scaled x3 is rolled back with its compare artifacts kept.
    Returns the record and the kernel launches of the main path."""
    from fast_tffm_tpu_torch import weights
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.obs.telemetry import Telemetry
    from fast_tffm_tpu_torch.serve import wire
    from fast_tffm_tpu_torch.serve.router import (
        Replica, ServeRouter, start_fleet,
    )
    from fast_tffm_tpu_torch.train import checkpoint

    rec = {"card": card}
    fmodel = os.path.join(tmp, "fleet_model")
    shutil.copytree(model_dir, fmodel)
    env = dict(os.environ, PYTHONPATH=REPO)
    frames = [wire.encode_bin_request(ids, vals) for ids, vals, _ in served]
    wants = [wire.encode_bin_response(want) for _, _, want in served]
    texts = ["".join(f"{s:.6f}\n" for s in want) for _, _, want in served]

    def used_mib() -> float:
        """The card's used memory, every process's (cudaMemGetInfo)."""
        free, total = torch.cuda.mem_get_info()
        return (total - free) / (1 << 20)

    def drive(port: int, rounds: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        for _ in range(rounds):
            for body, frame, want, text in zip(bodies, frames, wants, texts):
                check(post(conn, "/score", body).decode() == text,
                      f"/score through port {port} differs from path 2")
                check(post(conn, "/score_bin", frame) == want,
                      f"/score_bin through port {port} is not bitwise "
                      "path 2's")
        conn.close()

    # -- fleet T: the CLI -----------------------------------------------
    # Shedding off (0): the throughput runs and the kill under load count
    # answered requests only; the burst below sheds through its own router.
    # A kept-alive connection holds a handler thread, so each replica's
    # pool covers the router's FLEET_CLIENTS connections (or the clients
    # of the direct runs) plus the router's health probe and scrape: at
    # 8 threads the probes starve under load and evict a live replica.
    cfg_t = write_fleet_cfg(tmp, "fleet_t.cfg", fmodel, serve_replicas=2,
                            serve_poll_secs=0, serve_port=0,
                            serve_shed_deadline_ms=0,
                            serve_http_threads=2 * FLEET_CLIENTS)
    log_path = os.path.join(tmp, "fleet_t.log")
    mem0 = used_mib()
    t0 = time.perf_counter()
    with open(log_path, "wb") as log_f:
        cli = subprocess.Popen(
            [sys.executable, "-m", "fast_tffm_tpu_torch.cli", "serve",
             cfg_t], stdout=subprocess.PIPE, stderr=log_f, env=env,
            cwd=REPO)
    pids = []
    try:
        line = read_line(cli, 600)
        if not line.startswith("routing on"):
            with open(log_path, "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            check(False, f"the fleet CLI printed {line!r} (exit "
                         f"{cli.poll()}); its log ends:\n{tail}")
        rec["start_s"] = time.perf_counter() - t0
        port = int(line.split()[2].rsplit(":", 1)[1])
        per = replica_status(port)["serve"]["per_replica"]
        check(len(per) == 2 and all(p["healthy"] for p in per),
              f"fleet T's replicas: {per}")
        rep_ports = [p["port"] for p in per]
        pids = [p["pid"] for p in per]
        base = [replica_status(p)["serve"]["kernel_launches"]
                for p in rep_ports]
        drive(port, 3)  # the main path
        grown = [replica_status(p)["serve"]["kernel_launches"] - b
                 for p, b in zip(rep_ports, base)]
        check(all(g > 0 for g in grown),
              f"a replica launched no FmScorer on the main path: {grown}")
        rec["launches"] = {"warmup": base, "main_path": grown}
        launches = sum(grown)

        # /score_bin p50, direct to replica 0 and through the router.
        lat = {"direct": {}, "router": {}}
        for where, p in (("direct", rep_ports[0]), ("router", port)):
            conn = http.client.HTTPConnection("127.0.0.1", p, timeout=120)
            for frame, (ids, _, _) in zip(frames[1:4], served[1:4]):
                times = []
                for _ in range(FLEET_TIMED):
                    t1 = time.perf_counter()
                    post(conn, "/score_bin", frame)
                    times.append(time.perf_counter() - t1)
                lat[where][f"n{len(ids)}"] = p50(times) * 1e3
            conn.close()
        rec["bin_p50_ms"] = lat

        # Requests a second: the rung-64 request from concurrent clients.
        frame_path = os.path.join(tmp, "fleet_frame.bin")
        want_path = os.path.join(tmp, "fleet_want.bin")
        with open(frame_path, "wb") as f:
            f.write(frames[1])
        with open(want_path, "wb") as f:
            f.write(wants[1])
        rps = {}
        for name, p in (("one_replica_direct", rep_ports[0]),
                        ("two_via_router", port),
                        ("one_replica_direct_again", rep_ports[0]),
                        ("two_via_router_again", port)):
            run = load_run(p, frame_path, want_path)
            check(run["codes"] == {"200": run["requests"]}
                  and run["wrong"] == 0 and run["errors"] == 0,
                  f"load {name}: {run}")
            rps[name] = run["rps"]
        rec["rps"] = dict(rps, clients=FLEET_CLIENTS,
                          request_examples=len(served[1][0]),
                          seconds=FLEET_LOAD_S)
        # The card's used memory with the two replicas up, over what it
        # was before the CLI started (the router holds no CUDA context),
        # and nvidia-smi's per-process list (whose PIDs may be another PID
        # namespace's, as in a container).
        mem_up = used_mib()
        per_replica = (mem_up - mem0) / 2
        mem = app_memory_mib()
        rec["device_mib"] = {
            "before_fleet": mem0, "fleet_up": mem_up,
            "per_replica": per_replica,
            "compute_apps": {
                "replicas": [mem.get(p) for p in pids],
                "smoke_process": mem.get(os.getpid()), "listed": mem}}
        # Each holds at least its 144 MiB table (2^22 x 9 x 4 B).
        check(per_replica > 144, f"two replicas added {mem_up - mem0} MiB")

        # Shedding: a second router over the same replicas, tiny budget.
        scfg = load_config(cfg_t, {"serve_shed_deadline_ms": FLEET_SHED_MS})
        shed_router = ServeRouter(
            0, [Replica(i, "127.0.0.1", p) for i, p in enumerate(rep_ports)],
            scfg, telemetry=Telemetry())
        try:
            burst = load_run(shed_router.port, frame_path, want_path,
                             seconds=2.0)
        finally:
            shed_router.close()
        check(set(burst["codes"]) <= {"200", "429"}
              and burst["codes"].get("429", 0) > 0
              and burst["codes"].get("200", 0) > 0
              and burst["retry_after"] == ["1"] and burst["wrong"] == 0
              and burst["errors"] == 0, f"shedding burst: {burst}")
        rec["shed"] = {k: burst[k] for k in ("codes", "rps", "retry_after")}
        rec["shed"].update(deadline_ms=FLEET_SHED_MS,
                           answered_rps=burst["codes"]["200"] / 2.0)

        # Respawn: SIGKILL replica 0 under load, time its readmission.
        before = replica_status(port)["serve"]

        def kill_and_wait():
            time.sleep(1.0)
            t_kill = time.perf_counter()
            os.kill(pids[0], signal.SIGKILL)
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=60)
            deadline = time.perf_counter() + 300
            while time.perf_counter() < deadline:
                r0 = get_json(conn, "/status")["serve"]["per_replica"][0]
                if r0["healthy"] and r0["pid"] != pids[0]:
                    conn.close()
                    return {"readmit_s": time.perf_counter() - t_kill,
                            "pid": r0["pid"], "port": r0["port"]}
                time.sleep(0.05)
            check(False, "the killed replica was never readmitted")

        run = load_run(port, frame_path, want_path, seconds=4.0,
                       during=kill_and_wait)
        check(run["codes"] == {"200": run["requests"]} and run["wrong"] == 0
              and run["errors"] == 0, f"load across the kill: {run}")
        check(not pid_alive(pids[0]), "the killed replica is still there")
        new = run["during"]
        pids.append(new["pid"])
        drive(new["port"], 1)  # the respawned replica, bitwise
        st = replica_status(port)["serve"]
        # The dead replica's context no longer holds the card: the card
        # uses what it did with two replicas up, not a third's worth.
        mem_respawned = used_mib()
        rec["respawn"] = dict(
            readmit_s=new["readmit_s"], requests_during=run["requests"],
            used_mib=mem_respawned, **{
                k: st[k] - before[k] for k in (
                    "evictions", "respawns", "readmissions", "retries")})
        check(all(rec["respawn"][k] == 1 for k in (
                  "evictions", "respawns", "readmissions")),
              f"respawn counters: {rec['respawn']}")
        check(mem_respawned - mem_up < per_replica / 2,
              f"the card holds {mem_respawned} MiB after the respawn, "
              f"{mem_up} before the kill")
        cli.send_signal(signal.SIGTERM)
        check(cli.wait(120) == 0, "the fleet CLI did not exit 0 on SIGTERM")
        check(not [p for p in pids if pid_alive(p)],
              f"a replica of fleet T outlived its router: {pids}")
        t1 = time.perf_counter()
        while (used_mib() - mem0 > per_replica / 2
               and time.perf_counter() - t1 < 30):
            time.sleep(0.1)
        rec["device_mib"]["after_teardown"] = used_mib()
        check(rec["device_mib"]["after_teardown"] - mem0 < per_replica / 2,
              f"the card still holds {rec['device_mib']} after teardown")
    finally:
        # After a failed check: SIGTERM lets the router stop its
        # replicas; a router that must be killed leaves them behind, so
        # they are killed by pid.
        if cli.poll() is None:
            cli.send_signal(signal.SIGTERM)
            try:
                cli.wait(60)
            except subprocess.TimeoutExpired:
                cli.kill()
                cli.wait()
        for pid in pids:
            if pid_alive(pid):
                os.kill(pid, signal.SIGKILL)
        cli.stdout.close()

    # -- fleet C: start_fleet, canary and capture --------------------------
    cap = os.path.join(tmp, "fleet_capture.tfc")
    cfg_c = write_fleet_cfg(tmp, "fleet_c.cfg", fmodel, serve_replicas=2,
                            serve_canary="true", serve_poll_secs=0.25,
                            serve_capture_sample=1, serve_capture_file=cap)
    handle = start_fleet(load_config(cfg_c), cfg_c, port=0)
    pids = [r.pid for r in handle.replicas]
    try:
        router = handle.router
        counters = lambda: handle.telemetry.snapshot()["counters"]  # noqa: E731
        drive(handle.port, 2)
        # Replay first: the canary's shadow scores of a rejected table
        # are captured too.
        replays = {}
        for i in range(2):
            path = f"{cap}.replica{i}"
            n_rec = sum(1 for _ in wire.read_capture(path))
            check(n_rec > 0, f"{path} holds no records")
            proc = subprocess.run(
                [sys.executable, "-m", "fast_tffm_tpu_torch.tools.replay",
                 path, "--endpoint", f"http://127.0.0.1:{handle.port}"],
                capture_output=True, env=env, timeout=300)
            check(proc.returncode == 0,
                  f"replay of {path} exited {proc.returncode}: "
                  f"{proc.stdout.decode()[-500:]}")
            replays[f"replica{i}"] = n_rec
        rec["capture_records"] = replays
        step, w0, table = checkpoint.restore_arrays(fmodel)
        t1 = time.perf_counter()
        checkpoint.save_params(fmodel, weights.from_jax(w0, table,
                                                        device="cpu"),
                               step=step + 1)
        deadline = time.perf_counter() + 300
        while router.step != step + 1 and time.perf_counter() < deadline:
            time.sleep(0.05)
        check(router.step == step + 1, "the same-table canary was not promoted")
        promote_s = time.perf_counter() - t1
        for r in handle.replicas:
            check(replica_status(r.port)["step"] == step + 1,
                  f"replica {r.index} is not at the promoted step")
        drive(handle.port, 1)
        t1 = time.perf_counter()
        checkpoint.save_params(fmodel, weights.from_jax(w0, table * 3.0,
                                                        device="cpu"),
                               step=step + 2)
        while (counters().get("serve.canary_rollbacks", 0) < 1
               and time.perf_counter() < deadline + 300):
            time.sleep(0.05)
        check(counters().get("serve.canary_rollbacks", 0) == 1,
              "the scaled table was not rolled back")
        rollback_s = time.perf_counter() - t1
        out_dir = os.path.join(fmodel, "canary_compare", f"step_{step + 2}")
        stats = {}
        for name in ("baseline", "canary"):
            with open(os.path.join(out_dir, f"{name}.json")) as f:
                stats[name] = json.load(f)
        check(router.step == step + 1
              and counters().get("serve.canary_promotions", 0) == 1,
              "the rollback moved the fleet's step")
        for r in handle.replicas:
            check(replica_status(r.port)["step"] == step + 1,
                  f"replica {r.index} did not roll back")
        drive(handle.port, 1)  # the vetted table, bitwise
        rec["canary"] = {
            "step": step, "promote_s": promote_s, "rollback_s": rollback_s,
            "compare": {k: {s: v[s] for s in ("score_n", "score_mean",
                                              "score_std", "score_p50")}
                        for k, v in stats.items()}}
    finally:
        handle.close()
    check(not [p for p in pids if pid_alive(p)],
          f"a replica of fleet C outlived its router: {pids}")
    return rec, launches


def rank_main(argv) -> int:
    """One rank of a multi-rank phase:
    ``chip_smoke.py --sharded-rank RANK WORLD INIT_URL SPEC OUT``.
    Joins the rank group, then for each config override set of the spec
    (``runs``) trains through ``Trainer.train()`` in turn, and writes
    their records to OUT (a list)."""
    rank, world, url, spec_path, out_path = (int(argv[0]), int(argv[1]),
                                             argv[2], argv[3], argv[4])
    import torch

    sys.path.insert(0, REPO)
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.ops import fm_kernels, sparse_apply
    from fast_tffm_tpu_torch.tools import micro_probe
    from fast_tffm_tpu_torch.train import dense, dist, loop, shardmap_step
    from fast_tffm_tpu_torch.train.loop import Trainer

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format=f"%(asctime)s rank{rank} %(name)s %(message)s")
    with open(spec_path) as f:
        spec = json.load(f)
    dev = dist.initialize(url, world, rank)
    try:
        coll_s = [0.0]

        def timed(collective):
            """``collective`` timed on the host clock, synchronised on
            both sides (the smoke's measurement only)."""
            def call(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = collective(*args)
                torch.cuda.synchronize()
                coll_s[0] += time.perf_counter() - t0
                return out
            return call

        # Every collective of a train step is the sharded steps', and
        # the overlap's id-plane gather is the trainer's prefetch: its
        # start (the id plane's sort and, under gloo, the copy to the
        # host) and its wait are timed the same way.
        shardmap_step.psum = timed(shardmap_step.psum)
        shardmap_step.all_gather = timed(shardmap_step.all_gather)
        dense.psum = timed(dense.psum)
        prefetch = loop.entries_prefetch

        def timed_prefetch(*args):
            pending = timed(prefetch)(*args)
            pending.wait = timed(pending.wait)
            return pending

        loop.entries_prefetch = timed_prefetch

        class TimedTrainer(Trainer):
            """Times each dispatch (synchronised) and its collectives,
            over its steps; under fleet tiering also each plan's host
            seconds (on the transfer thread) and each migration's device
            time (a CUDA event pair on the dispatch stream)."""

            def __init__(self, *args, **kwargs):
                self.step_s, self.coll_s = [], []
                self.plan_s, self.migration_events = [], []
                super().__init__(*args, **kwargs)

            def _plan_group(self, group):
                t0 = time.perf_counter()
                out = super()._plan_group(group)
                self.plan_s.append(time.perf_counter() - t0)
                return out

            def _apply_migration_fleet(self, shipment):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = super()._apply_migration_fleet(shipment)
                b.record()
                self.migration_events.append((a, b))
                return out

            def dispatch(self, sb, pause=None):
                c0 = coll_s[0]
                t0 = time.perf_counter()
                losses = super().dispatch(sb, pause)
                torch.cuda.synchronize()
                self.step_s.append((time.perf_counter() - t0) / sb.n)
                self.coll_s.append((coll_s[0] - c0) / sb.n)
                return losses

        kernels = kernel_fns(fm_kernels, sparse_apply, micro_probe)
        records = []
        for overrides in spec["runs"]:
            overrides = dict(overrides)
            ports = overrides.pop("_status_ports", None)  # one a rank
            if ports:
                overrides["status_port"] = ports[rank]
            cfg = load_config(CFG_PATH, overrides)
            gc.collect()
            torch.cuda.empty_cache()
            # The peak counts from before the trainer is built: its
            # table draw (and a fleet's exact store) is inside it.
            torch.cuda.reset_peak_memory_stats()
            trainer = TimedTrainer(cfg, device=dev)
            zero_launches(kernels)
            t0 = time.perf_counter()
            result = trainer.train()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = read_launches(kernels)
            mesh = trainer.mesh
            steps = trainer.step_s[1:]  # the first step warms up
            mig = [a.elapsed_time(b) for a, b in trainer.migration_events]
            record = {
                "rank": rank, "coords": list(mesh.coords),
                "device": str(dev), "backend": mesh.backend,
                "exchange": (shardmap_step.exchange_mode(
                    trainer.dcfg, mesh,
                    cfg.batch_size // mesh.data * cfg.max_features)
                    if trainer.sparse else "dense_optax"),
                "overlap": trainer.overlap,
                "launches": launches, "train": result["train"],
                "validation": result.get("validation"),
                "step_p50_ms": p50(steps) * 1e3,
                "collective_share": sum(trainer.coll_s[1:]) / sum(steps),
                "step_ms": [x * 1e3 for x in trainer.step_s],
                "train_wall_s": wall,
                "peak_device_mb": torch.cuda.max_memory_allocated() / 2**20,
            }
            if trainer.fleet is not None:
                record["fleet"] = {
                    "plans": len(trainer.plan_s),
                    "plan_ms_mean": 1e3 * sum(trainer.plan_s) / max(
                        len(trainer.plan_s), 1),
                    "plan_ms_max": 1e3 * max(trainer.plan_s, default=0.0),
                    "migration_device_ms_mean": sum(mig) / max(len(mig), 1),
                    "migration_device_ms_max": max(mig, default=0.0),
                }
            records.append(record)
            del trainer
        with open(out_path, "w") as f:
            json.dump(records, f)
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
    """What a training run leaves: tables, optimizer state, w0, the
    streaming metrics and the health carry (compared bitwise between
    twin runs)."""
    m = trainer.metrics
    return ([trainer.model.table, trainer.model.w0,
             *sparse.opt_tables(trainer.opt_state)]
            + [t for t in trainer.opt_state if t.dim() == 0]
            + [m.loss_sum, m.weight_sum, m.count, m.auc.pos, m.auc.neg]
            + list(trainer.health))


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
          f"histogram, health carry)", flush=True)

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


# Prometheus text exposition: one sample a line (tools/obs_smoke.py's
# rule), comments and blank lines aside.
_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
    r"[-+]?(\d+\.?\d*([eE][-+]?\d+)?|\.\d+|[Ii]nf|[Nn]a[Nn])$")


def prometheus_samples(text: str) -> int:
    """The sample count of a ``/metrics`` body; fails on a line that is
    not Prometheus text."""
    samples = 0
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        check(bool(_PROM_SAMPLE.match(line)),
              f"/metrics line is not Prometheus text: {line!r}")
        samples += 1
    return samples


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def health_state(trainer) -> list:
    """Tables, optimizer state, w0 and the health carry of a trainer."""
    return ([trainer.model.table, trainer.model.w0, *trainer.opt_state]
            + list(trainer.health))


def step_with_and_without_carry(torch, trainer, sb, k: int) -> dict:
    """The graphed step's p50 on a device super-batch ``sb``: through
    ``Trainer.dispatch`` (the carry's update in each captured step), and
    through a graph of the same steps without it that this function
    captures (``Trainer.device_step``, which carries no health), in
    turns (with, without, without, with; a synchronised dispatch over
    K, host clock), and the device time of one replay of each (CUDA
    events, median of OBS_TIMED)."""
    from fast_tffm_tpu_torch.train.dispatch import GraphedSteps

    trainer.dispatch(sb)  # eager, then captured
    trainer.dispatch(sb)
    bare = GraphedSteps(k)

    def bare_steps(s):
        return torch.stack([trainer.device_step(s.step(i))
                            for i in range(s.n)])

    bare_steps(sb)  # warm, as the trainer's first dispatch
    torch.cuda.synchronize()
    bare.capture(sb, bare_steps)
    runs = {"with": lambda: trainer.dispatch(sb),
            "without": lambda: bare.replay(sb)}
    host = {"with": [], "without": []}
    for mode in ("with", "without", "without", "with"):
        for _ in range(OBS_TIMED):
            t0 = time.perf_counter()
            runs[mode]()
            torch.cuda.synchronize()
            host[mode].append((time.perf_counter() - t0) / k)
    dev = {}
    for mode, fn in runs.items():
        ms = []
        for _ in range(OBS_TIMED):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b) / k)
        dev[mode] = ms
    return {
        "step_p50_ms_with_carry": p50(host["with"]) * 1e3,
        "step_p50_ms_without_carry": p50(host["without"]) * 1e3,
        "device_ms_per_step_with_carry": p50(dev["with"]),
        "device_ms_per_step_without_carry": p50(dev["without"]),
        "replays": trainer.graph_dispatches,
    }


def planes_run(np, torch, base, tmp: str, held_cls, off_state) -> dict:
    """Phase 6c (f): one graphed K = 4 run of main path 1 with every 4c
    plane on (``quality`` at its default window, ``trace_file``,
    ``blackbox``, ``profile_dir`` over the second dispatch, and a
    ``status_port``), its third dispatch held until ``/profile?secs=0.2``
    (after ``profile_dir``'s window) and ``POST /incident`` have
    answered.  Checks: the tables, accumulator, ``w0`` and the carry
    bitwise ``off_state`` (the run with every plane off); the manifest's
    ``quality`` payload counting the lines trained; one complete trace
    chain per dispatch in the port's report; a Chrome trace in
    ``profile_dir`` naming the path's four kernels; one expected capture
    in the sentinel; a bundle the port's ``report --incident`` reads."""
    import contextlib
    import io
    import threading

    from fast_tffm_tpu_torch.tools import report
    from fast_tffm_tpu_torch.train.manifest import read_manifest

    k = OBS_K
    port = free_port()
    prof_dir = os.path.join(tmp, "obs_planes_profile")
    trace_path = os.path.join(tmp, "obs_planes_trace.json")
    mf = os.path.join(tmp, "obs_planes.jsonl")
    cfg = dataclasses.replace(
        base, model_file=os.path.join(tmp, "obs_planes"), metrics_file=mf,
        quality=True, blackbox=True, trace_file=trace_path,
        profile_dir=prof_dir, profile_start_step=k, profile_steps=k,
        status_port=port, heartbeat_secs=0.05, log_steps=0)
    got: dict = {}
    answered = threading.Event()

    def side():
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=120)
            conn.request("GET", "/profile?secs=0.2")
            resp = conn.getresponse()
            got["profile"] = (resp.status, resp.read().decode())
            conn.request("POST", "/incident?reason=smoke_drill", body=b"")
            resp = conn.getresponse()
            got["incident"] = (resp.status, resp.read().decode())
            conn.close()
        except (OSError, http.client.HTTPException) as e:
            got["error"] = repr(e)
        finally:
            answered.set()

    calls = []

    def hook(trainer):
        calls.append(trainer.graph.captured)
        if len(calls) == 3:  # profile_dir's window closed after dispatch 1
            threading.Thread(target=side, daemon=True).start()
            answered.wait(300)

    trainer = held_cls(cfg)
    trainer.hook = hook
    t0 = time.perf_counter()
    res = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(health_state(trainer),
                                                 off_state)),
          "the run with every 4c plane on is not bitwise the run with "
          "every plane off")
    tr = res["train"]
    check(tr["graph_dispatches"] == len(calls) - 1 == 3,
          f"(f) dispatches: {calls}, {tr['graph_dispatches']} replays")
    check("error" not in got and got["profile"][0] == 200
          and got["incident"][0] == 200, f"(f) routes: {got}")
    lines = int(tr["examples"])
    man = read_manifest(cfg.model_file)
    check(man.get("quality", {}).get("examples") == lines
          and tr["quality"]["examples"] == lines,
          f"(f) quality: manifest {man.get('quality', {}).get('examples')},"
          f" block {tr.get('quality')}, {lines} lines trained")
    chains = report.trace_chains(json.load(open(trace_path))["traceEvents"])
    check(len(chains) == tr["dispatches"]
          and all(c["complete"] for c in chains),
          f"(f) trace: {len(chains)} chains for {tr['dispatches']} "
          f"dispatches, complete {[c['complete'] for c in chains]}")
    prof_files = sorted(os.listdir(prof_dir))
    check(prof_files == ["trace_rank0.json"], f"(f) profile: {prof_files}")
    prof_text = open(os.path.join(prof_dir, prof_files[0])).read()
    named = {sym: sym in prof_text for sym in PATH_KERNEL_SYMBOLS}
    check(all(named.values()), f"(f) the profile names {named}")
    resource = tr["resource"]
    compiles = [r for r in jsonl(mf) if r["record"] == "compile"]
    check(resource["compiles"] == 1 and resource["recompiles_unexpected"]
          == 0 and len(compiles) == 1 and compiles[0]["k"] == k
          and compiles[0]["expected"],
          f"(f) sentinel: {resource}, {compiles}")
    bundle = json.loads(got["incident"][1])["incident_dir"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = report.main(["--incident", bundle])
    check(rc == 0 and "incident: smoke_drill" in out.getvalue(),
          f"(f) report --incident: {rc}, {out.getvalue()[:300]}")
    ondemand = os.listdir(os.path.join(tmp, "tffm_profile_ondemand"))
    check(len(ondemand) == 1, f"(f) /profile captures: {ondemand}")
    return {
        "wall_s": wall, "lines": lines, "quality": tr["quality"],
        "trace_chains": len(chains), "profile_kernels": named,
        "profile_bytes": len(prof_text),
        "sentinel": {key: resource[key] for key in (
            "compiles", "compile_s", "recompiles_unexpected", "builds",
            "build_s")},
        "incident": os.path.basename(bundle),
        "bitwise_plane_off": True,
    }


def step_with_and_without_scores(torch, cfg, sb, k: int) -> dict:
    """The quality plane's scores copy: the graphed step on a device
    super-batch ``sb`` (shipped with its host labels and weights) with
    the copy (each captured step writes its scores into the trainer's
    ``[K, B]`` buffer, and each dispatch is followed by the non-blocking
    copy into a pinned slot and the monitor's feed one dispatch late)
    and without (a trainer with the plane off), in turns (with, without,
    without, with; a synchronised dispatch over K, host clock), and the
    device time of one dispatch of each (CUDA events around the dispatch
    and its copy, median of OBS_TIMED)."""
    from fast_tffm_tpu_torch.obs.quality import QualityMonitor
    from fast_tffm_tpu_torch.train.loop import Trainer

    with_t, without_t = Trainer(cfg), Trainer(cfg)
    with_t._quality = QualityMonitor(window=cfg.quality_window)
    pending = [None]
    count = [0]

    def run_with():
        with_t.dispatch(sb)
        started = with_t._scores_readback(sb, count[0] % 2)
        count[0] += 1
        with_t._feed_quality(pending[0])
        pending[0] = started

    runs = {"with": run_with, "without": lambda: without_t.dispatch(sb)}
    for fn in runs.values():  # eager and captured, then a replay
        fn()
        fn()
    torch.cuda.synchronize()
    host = {"with": [], "without": []}
    for mode in ("with", "without", "without", "with"):
        for _ in range(OBS_TIMED):
            t0 = time.perf_counter()
            runs[mode]()
            torch.cuda.synchronize()
            host[mode].append((time.perf_counter() - t0) / k)
    dev = {}
    for mode, fn in runs.items():
        ms = []
        for _ in range(OBS_TIMED):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b) / k)
        dev[mode] = ms
    check(with_t.graph_dispatches > 0 and without_t.graph_dispatches > 0,
          "the scores-copy timing ran no replay")
    check(with_t._quality.block(force=True)["examples"] > 0,
          "the timed scores copy fed the monitor nothing")
    out = {
        "step_p50_ms_with_scores": p50(host["with"]) * 1e3,
        "step_p50_ms_without_scores": p50(host["without"]) * 1e3,
        "device_ms_per_step_with_scores": p50(dev["with"]),
        "device_ms_per_step_without_scores": p50(dev["without"]),
    }
    del with_t, without_t
    gc.collect()
    return out


def planes_cost(torch, base, host_batches) -> dict:
    """Phase 6c (g), printed and not gated: the default-on quality
    plane's cost.  Examples/s end to end over 4 epochs of
    ``tools/ingest_bench.py``'s runs (8 parse threads, cache off) with
    ``quality`` on and off in turns (on, off, off, on), and the graphed
    step with the scores copy and without at K = 1 and 4."""
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
    from fast_tffm_tpu_torch.tools import ingest_bench

    keys = ("examples_per_sec_end_to_end",
            "examples_per_sec_after_first_dispatch", "step_p50_ms_in_train",
            "ingest_wait_frac", "synced_examples_per_sec")
    runs = {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        icfg = ingest_bench.with_mode(
            dataclasses.replace(base, epoch_num=4, quality=mode == "on",
                                log_steps=0),
            "off", 8, 0, OBS_K)
        got = ingest_bench.train_runs(icfg, torch.device("cuda"),
                                      profiled=False)
        runs[mode].append({key: got.get(key) for key in keys})
    out = {"ingest_bench_4_epochs_8_threads": runs}
    for kk in (1, 4):
        cfg = dataclasses.replace(base, steps_per_dispatch=kk, log_steps=0)
        sb = next(iter(DevicePrefetcher(host_batches[:kk], kk, "cuda",
                                        cfg.vocabulary_size,
                                        host_targets=True)))
        out[f"scores_copy_k{kk}"] = step_with_and_without_scores(
            torch, cfg, sb, kk)
        del sb
        gc.collect()
    return out


def obs_phase(np, torch, card: str, tcfg, train_files, model_dir: str,
              tmp: str, host_batches, kernels: dict, counters: dict) -> tuple:
    """The health carry and the observability planes on main path 1 at
    full width (``examples/criteo_kaggle.cfg``, V = 2^22, B = 4096,
    Adagrad, host sort, K = 4, graphed).  (a) A clean run of the 16
    steps with ``metrics_file``, ``heartbeat_secs = 0.05``, a free
    ``status_port``, ``alert_rules = step > 0 : warn`` and ``nan_policy =
    halt`` (each dispatch held OBS_THROTTLE_S so that beats and scrapes
    fall mid-run): the stream (a ``run_header`` first, heartbeats, one
    alert, one ``final`` whose split sums to ``elapsed`` within 0.02 s),
    ``/status`` and ``/metrics`` scraped mid-run (the Prometheus text
    parses), the touched rows and occurrences equal to the host's count
    over the same lines, no non-finite step, the kernels and replays of
    phase 5, and tables, accumulator, w0 and the carry bitwise those of
    the same run with none of those planes.  (b) A poisoned run: ``w0``
    filled with NaN in place after the graph is captured; the halt comes
    within one dispatch, nothing newer than the last clean save
    (``save_steps = K``) is on disk, the final record names the
    exception.  (c) ``step > 0 : halt``: AlertHaltError, no checkpoint.
    (d) The single-replica server of phase 5's checkpoint with a stream,
    a heartbeat and a warn rule.  (e) The graphed step with and without
    the carry at K = 1 and 4, and path 9's graphed Adam step the same
    way.  Returns the ``obs`` record and (a)'s launches."""
    import threading

    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.pipeline import BatchPipeline
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
    from fast_tffm_tpu_torch.obs.alerts import AlertHaltError
    from fast_tffm_tpu_torch.serve import wire
    from fast_tffm_tpu_torch.serve.server import serve
    from fast_tffm_tpu_torch.tools import report
    from fast_tffm_tpu_torch.train import checkpoint
    from fast_tffm_tpu_torch.train.loop import NonFiniteGradError, Trainer

    k = OBS_K
    rec = {"card": card, "steps_per_dispatch": k}
    base = dataclasses.replace(
        tcfg, train_files=list(train_files), validation_files=[],
        steps_per_dispatch=k, log_steps=4, save_steps=0, nan_policy="halt")

    class Held(Trainer):
        """Each dispatch held ``hold_s`` before it runs, so that beats
        and scrapes fall between dispatches; ``hook`` sees each call."""

        hold_s = 0.0
        hook = None

        def dispatch(self, sb, pause=None):
            if self.hook is not None:
                self.hook(self)
            time.sleep(self.hold_s)
            return super().dispatch(sb, pause)

    # The host's count of what the carry counts: the real occurrences
    # and the distinct rows of the same lines.
    touches, seen = 0, []
    with BatchPipeline(train_files, tcfg, epochs=1, shuffle=False) as p:
        for b in p:
            real = b.vals != 0
            touches += int(real.sum())
            seen.append(np.unique(b.ids[real]))
    host_rows = int(np.unique(np.concatenate(seen)).size)

    # -- (a) the clean run, and its twin with no planes -----------------
    mf = os.path.join(tmp, "obs_clean.jsonl")
    port = free_port()
    cfg_a = dataclasses.replace(
        base, model_file=os.path.join(tmp, "obs_clean"), metrics_file=mf,
        heartbeat_secs=0.05, status_port=port,
        alert_rules="step > 0 : warn")
    scraped: dict = {}
    stop = threading.Event()

    def get(conn, path: str):
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()

    def scrape():
        while not stop.is_set() and "metrics" not in scraped:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=2)
                code, body = get(conn, "/status")
                status = json.loads(body) if code == 200 else {}
                if status.get("step", 0) > 0:
                    code, body = get(conn, "/metrics")
                    if code == 200:
                        scraped["status"], scraped["metrics"] = status, body
                conn.close()
            except (OSError, http.client.HTTPException, ValueError):
                pass
            stop.wait(0.01)

    torch.cuda.synchronize()
    zero_launches(kernels)
    zero_launches(counters)
    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    t0 = time.perf_counter()
    clean = Held(cfg_a)
    clean.hold_s = OBS_THROTTLE_S
    res_a = clean.train()
    torch.cuda.synchronize()
    rec["clean_wall_s"] = time.perf_counter() - t0
    stop.set()
    scraper.join()
    launches = read_launches(kernels)
    tr = res_a["train"]
    check(tr["steps"] == TRAIN_FILES * BATCHES_PER_FILE,
          f"obs run trained {tr['steps']} steps")
    check_train_path(tr, launches, read_launches(counters))
    # The twin runs with every plane off (the 4c planes included), and
    # its state is (f)'s reference too.
    twin = Trainer(dataclasses.replace(
        base, model_file=os.path.join(tmp, "obs_twin"), quality=False,
        blackbox=False))
    twin.train()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(health_state(clean),
                                                 health_state(twin))),
          "the run with a stream, heartbeat, endpoint and rules is not "
          "bitwise the run without them")
    off_state = [t.detach().clone() for t in health_state(twin)]
    del twin
    records = jsonl(mf)
    kinds = [r["record"] for r in records]
    final = records[-1]
    split = final["wait_input_s"] + final["dispatch_s"] + final["other_s"]
    # The warn alert's blackbox bundle is an `incident` record mid-run.
    check(kinds[0] == "run_header" and kinds[-1] == "final"
          and kinds.count("final") == 1 and kinds.count("alert") == 1
          and kinds.count("incident") == 1
          and kinds.count("heartbeat") > 0 and kinds.count("train") == 4,
          f"obs stream: {kinds}")
    check(abs(split - final["elapsed"]) <= 0.02,
          f"wait + dispatch + other = {split} against elapsed "
          f"{final['elapsed']}")
    health = tr["health"]
    check(health == final["health"], "result and final health differ")
    check(health["nonfinite_steps"] == 0
          and health["first_nonfinite_step"] == -1,
          f"non-finite steps in the clean run: {health}")
    check(health["emb_touch_events"] == touches
          and health["emb_rows_touched"] == host_rows,
          f"carry counted {health['emb_touch_events']} occurrences and "
          f"{health['emb_rows_touched']} rows, the host {touches} and "
          f"{host_rows}")
    check("metrics" in scraped, "the status endpoint was never scraped "
          "after a dispatch")
    n_samples = prometheus_samples(scraped["metrics"])
    check("tffm_counter_ingest_examples_total" in scraped["metrics"]
          and scraped["status"]["record"] == "status"
          and "health" in scraped["status"],
          "the scrape lacks the ingest counter or the health block")
    rec["clean"] = {
        "records": {kind: kinds.count(kind) for kind in sorted(set(kinds))},
        "final_split_s": {key: final[key] for key in (
            "elapsed", "wait_input_s", "dispatch_s", "other_s",
            "ingest_wait_frac")},
        "health": health, "host_touch_events": touches,
        "host_rows_touched": host_rows,
        "scraped_status_step": scraped["status"]["step"],
        "metrics_samples": n_samples, "launches": launches,
        "graph_dispatches": tr["graph_dispatches"],
        "eager_dispatches": tr["eager_dispatches"],
        "run_header": {key: records[0][key] for key in (
            "config_fingerprint", "torch_version", "device", "backend",
            "nan_policy", "alert_rules", "heartbeat_secs")},
    }
    del clean

    # -- (f) every 4c plane on, against the twin with them off ---------
    rec["planes"] = planes_run(np, torch, base, tmp, Held, off_state)
    del off_state
    gc.collect()

    # -- (b) a poisoned replay under nan_policy = halt ------------------
    mf_b = os.path.join(tmp, "obs_poison.jsonl")
    cfg_b = dataclasses.replace(
        base, model_file=os.path.join(tmp, "obs_poison"), metrics_file=mf_b,
        save_steps=k, log_steps=0)
    calls = []

    def poison(trainer):
        # After the capture (dispatch 0 eager and captured, 1 a
        # replay): dispatch 2's replay trains the poison.
        if len(calls) == 2 and trainer.graph.captured:
            with torch.no_grad():
                trainer.model.w0.detach().fill_(float("nan"))
        calls.append(trainer.graph.captured)

    poisoned = Held(cfg_b)
    poisoned.hook = poison
    try:
        poisoned.train()
        check(False, "the poisoned run did not halt")
    except NonFiniteGradError as e:
        halt_msg = str(e)
    saved, _ = checkpoint.restore_params(cfg_b.model_file, device="cpu")
    records_b = jsonl(mf_b)
    # The crash's blackbox bundle: its `incident` record comes just
    # before the final record, as the reference's trainer writes them.
    final_b = records_b[-1]
    bundles_b = sorted(os.listdir(os.path.join(cfg_b.model_file,
                                               "incidents")))
    check(len(bundles_b) == 1
          and bundles_b[0].endswith("_crash_NonFiniteGradError_rank0")
          and records_b[-2]["record"] == "incident"
          and records_b[-2]["reason"] == "crash_NonFiniteGradError",
          f"the poisoned run's bundles: {bundles_b}, records "
          f"{[r['record'] for r in records_b[-3:]]}")
    check(calls == [False, True, True] and poisoned.graph_dispatches == 2,
          f"the poison was not trained by a replay: {calls}")
    check(saved == 2 * k, f"the last checkpoint is step {saved}, not the "
          f"clean save at {2 * k}")
    check(final_b["record"] == "final"
          and final_b["exception"] == "NonFiniteGradError"
          and final_b["health"]["first_nonfinite_step"] == 2 * k,
          f"the poisoned run's final record: {final_b.get('exception')}, "
          f"{final_b.get('health')}")
    rec["poisoned"] = {
        "dispatches": len(calls), "poisoned_dispatch": 2,
        "last_saved_step": saved, "halt": halt_msg,
        "final_health": final_b["health"], "bundle": bundles_b[0],
    }
    del poisoned

    # -- (c) a halt rule ------------------------------------------------
    mf_c = os.path.join(tmp, "obs_halt.jsonl")
    cfg_c = dataclasses.replace(
        base, model_file=os.path.join(tmp, "obs_halt"), metrics_file=mf_c,
        heartbeat_secs=0.05, alert_rules="step > 0 : halt", log_steps=0)
    halted = Held(cfg_c)
    halted.hold_s = OBS_THROTTLE_S
    try:
        halted.train()
        check(False, "the halt rule did not stop the run")
    except AlertHaltError as e:
        halt_rule = str(e)
    records_c = jsonl(mf_c)
    final_c = records_c[-1]
    check(not checkpoint.exists(cfg_c.model_file),
          "the halted run wrote a checkpoint")
    check(final_c["exception"] == "AlertHaltError"
          and any(r["record"] == "alert" and r["action"] == "halt"
                  for r in records_c), "the halt's stream")
    rec["halt_rule"] = {"message": halt_rule, "steps": final_c["step"]}
    del halted

    # -- (d) the single-replica server ----------------------------------
    mf_d = os.path.join(tmp, "obs_serve.jsonl")
    trace_d = os.path.join(tmp, "obs_serve_trace.json")
    scfg = load_config(CFG_PATH, {
        "serve_poll_secs": 0.0, "serve_port": 0, "model_file": model_dir,
        "metrics_file": mf_d, "heartbeat_secs": 0.05,
        "alert_rules": "elapsed > 0 : warn", "trace_file": trace_d,
        "serve_trace_sample": 1.0})
    handle = serve(scfg, port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                          timeout=60)
        rng = np.random.default_rng(SEED)
        for n_req in (37, 1000):
            text = post(conn, "/score", criteo_body(rng, n_req).encode())
            check(len(text.split()) == n_req, f"{n_req} served scores")
        # The skew monitor's traffic: the training lines themselves.
        for i in range(SERVE_BIN_REQUESTS):
            hb = host_batches[i % len(host_batches)]
            lo = (i // len(host_batches)) * SERVE_BIN_ROWS
            body = wire.encode_bin_request(hb.ids[lo:lo + SERVE_BIN_ROWS],
                                           hb.vals[lo:lo + SERVE_BIN_ROWS])
            got = wire.decode_bin_response(post(conn, "/score_bin", body))
            check(len(got) == SERVE_BIN_ROWS, "/score_bin scores")
        conn.close()
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                if any(r["record"] == "heartbeat" for r in jsonl(mf_d)):
                    break
            except ValueError:  # a line being written
                pass
            time.sleep(0.02)
    finally:
        handle.close()
    records_d = jsonl(mf_d)
    kinds_d = [r["record"] for r in records_d]
    check(kinds_d[0] == "run_header" and records_d[0]["mode"] == "serve"
          and kinds_d.count("alert") == 1 and "heartbeat" in kinds_d
          and kinds_d[-1] == "final", f"serve stream: {kinds_d}")
    rec["serve"] = {kind: kinds_d.count(kind) for kind in sorted(
        set(kinds_d))}
    rec["serve"]["requests"] = records_d[-1]["serve"]["requests"]
    skew = {key: v for key, v in records_d[-1]["serve"].items()
            if key.startswith("skew_")}
    check({"skew_examples", "skew_psi_max", "skew_psi_ids",
           "skew_psi_scores"} <= set(skew)
          and all(math.isfinite(v) for v in skew.values())
          and skew["skew_examples"] > 0, f"the server's skew keys: {skew}")
    chains = report.serve_request_chains(
        json.load(open(trace_d))["traceEvents"])
    done = [c for c in chains if c["complete"]]
    check(len(done) == len(chains) == 2 + SERVE_BIN_REQUESTS,
          f"serve trace: {len(done)} complete chains of {len(chains)}, "
          f"{2 + SERVE_BIN_REQUESTS} requests")
    rec["serve"]["skew"] = skew
    rec["serve"]["trace_chains"] = len(done)

    # -- (e) the graphed step with and without the carry ---------------
    timing = {}
    for kk in (1, 4):
        cfg_e = dataclasses.replace(
            base, steps_per_dispatch=kk, log_steps=0,
            model_file=os.path.join(tmp, "obs_timed"))
        sb = next(iter(DevicePrefetcher(host_batches[:kk], kk, "cuda",
                                        cfg_e.vocabulary_size)))
        trainer = Trainer(cfg_e)
        timing[f"sparse_k{kk}"] = step_with_and_without_carry(
            torch, trainer, sb, kk)
        del trainer, sb
        gc.collect()
    dense_cfg = dataclasses.replace(
        base, steps_per_dispatch=1, log_steps=0, sparse_update=False,
        optimizer="adam", learning_rate=DENSE_ADAM_LR, l2_mode="full",
        factor_lambda=DENSE_LAMBDA, bias_lambda=DENSE_LAMBDA,
        model_file=os.path.join(tmp, "obs_dense"))
    sb = next(iter(DevicePrefetcher(host_batches[:1], 1, "cuda",
                                    dense_cfg.vocabulary_size)))
    trainer = Trainer(dense_cfg)
    check(not trainer.sparse, "path 9's config trained sparse")
    timing["dense_adam_k1"] = step_with_and_without_carry(
        torch, trainer, sb, 1)
    del trainer, sb
    gc.collect()
    rec["step_timing"] = timing
    rec["planes_cost"] = planes_cost(torch, base, host_batches)
    return rec, launches


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
    timing = time_cases(torch, {k: c[:4] for k, c in cases.items()})
    for name, (*_, (cut, (c_ms, _))) in cases.items():
        timing[name].update(
            cut_slot={"graph_ms": graph_ms(torch, cut), "bound_ms": c_ms},
            occurrences=n, unique_rows=u, width=D)
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
        s_k, s_p = (sparse.sparse_step(cfg, m, o, b, plain=pl,
                                       impl="jnp" if pl else "pallas")
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


def spawn_runs(tmp: str, tag: str, runs: list, world: int, one_card: bool,
               timeout_s: float = RANK_TIMEOUT_S) -> list:
    """Run ``world`` ranks of this script, which train one run for each
    config override set of ``runs`` in turn, and return each rank's list
    of records.  ``one_card`` shows every rank only the first visible GPU
    (so they share it).  A rank that fails, or the deadline, ends the
    smoke; every rank is stopped either way."""
    spec = os.path.join(tmp, f"{tag}.json")
    with open(spec, "w") as f:
        json.dump({"runs": runs}, f)
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
    deadline = time.monotonic() + timeout_s
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
                 else f"ranks still running after {timeout_s} s")
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
    against a single-device run over the same global batches, and the
    overlapped entries exchange (``lookup = auto``, ``sparse_exchange =
    entries``, ``sparse_exchange_overlap = on``, two steps a dispatch so
    that a step's id plane is gathered while the one before it runs),
    whose checkpoint must be the auto run's bit for bit.  Returns the
    phase's record and the launches of each kernel summed over the ranks
    of all three runs."""
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
    mesh = {"mesh_data": SHARDED_MESH[0], "mesh_model": SHARDED_MESH[1]}
    # The entries run also scrapes the training fleet: rank 0 reads the
    # four ranks' /status, and every rank times the exchange probe.
    ports = [free_port() for _ in range(world)]
    scrape = dict(heartbeat_secs=0.05, _status_ports=ports,
                  train_fleet_scrape=",".join(f"127.0.0.1:{p}"
                                              for p in ports))
    for exchange, extra in (
        ("dense", dict(lookup="shardmap", sparse_exchange="dense")),
        ("auto", dict(lookup="shardmap", sparse_exchange="auto",
                      **scrape)),
        ("overlap", dict(lookup="auto", sparse_exchange="entries",
                         sparse_exchange_overlap="on",
                         steps_per_dispatch=2)),
    ):
        model_dir = os.path.join(tmp, f"sharded_{exchange}")
        t0 = time.perf_counter()
        recs = [r[0] for r in spawn_runs(tmp, f"sharded_{exchange}", [dict(
            base, model_file=model_dir, **mesh, **extra)], world, one_card)]
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
            check(rec["overlap"] == (exchange == "overlap"),
                  f"{exchange}: rank {rec['rank']} overlap {rec['overlap']}")
            if exchange == "dense":
                check(rec["exchange"] == "dense" and got["kplace"] >= steps,
                      f"dense: rank {rec['rank']} launched K-place "
                      f"{got['kplace']} times in {steps} steps")
            else:
                check(rec["exchange"] == "entries",
                      f"{exchange} resolved to {rec['exchange']}, not "
                      f"entries")
                check(got["k1_merge"] >= steps and got["kplace"] == 0,
                      f"entries: rank {rec['rank']} launched K1 merge "
                      f"{got['k1_merge']} and K-place {got['kplace']} times")
            check(got["fm_grad"] >= steps and got["k1_dedup"] >= steps
                  and (exchange == "dense" or got["k2_apply"] >= steps),
                  f"{exchange}: rank {rec['rank']} launches {got}")
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
        if exchange == "auto":
            blk = r0["train"].get("fleet", {})
            check(blk.get("ranks_scraped") == world
                  and 0.0 <= blk.get("exchange_frac", -1.0) <= 1.0
                  and all("fleet" not in rec["train"] for rec in recs[1:]),
                  f"the entries run's fleet block: {blk}")
        have = load(model_dir)
        check(set(have) == set(want), f"{exchange}: checkpoint keys")
        if exchange == "overlap":
            auto = load(os.path.join(tmp, "sharded_auto"))
            for key, t in have.items():
                check(torch.equal(t, auto[key]),
                      f"overlap: {key} differs from the entries run's")
            del auto
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
            "overlap": r0["overlap"],
            "overrides": {key: v for key, v in extra.items()
                          if key != "_status_ports"},
            "backend": r0["backend"],
            "table_max_abs_err": float(
                (have["params/table"] - want["params/table"]).abs().max()),
            "acc_max_abs_err": float(
                (have["opt/acc_table"] - want["opt/acc_table"]).abs().max()),
            "changes": changes,
            "train_logloss": r0["train"]["logloss"],
            "validation_logloss": r0["validation"]["logloss"],
            "validation_auc": r0["validation"]["auc"],
            "fleet_block": r0["train"].get("fleet"),
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


def fleet_phase(np, torch, tmp: str, card: str, rng, train_files,
                predict_file: str, kernels: dict, world: int,
                one_card: bool) -> tuple:
    """Path 11, the rank-sharded tiered table: (a) the main config over
    the main run's files (16 steps) with ``table_tiering = on``,
    ``hot_rows = FLEET_HOT``, a ``1 x world`` mesh and ``lookup = auto``
    (no validation files: the fleet refuses them), each rank a process of
    this script, against the dense ``1 x world`` run from the same seed:
    each rank's loss and AUC, w0 and its slot, and the table and
    accumulator merged from the shard files against the dense
    ``params.npz``, all bit for bit; (b) the shard set served through
    ``serve()`` and predicted through the CLI on one device, both within
    ``SERVE_TOL`` of the dense ``params.npz`` served and predicted the
    same way, then warm-started on one device (S = world -> 1), every
    saved row back bit for bit, and trained ``FLEET_WARM_STEPS`` steps.
    Returns ``(record, launches)``: the fleet ranks' kernels summed, and
    the FmScorer's serving and predicting the shard set, and the warm
    start's steps' (the dense baseline's are left out)."""
    from fast_tffm_tpu_torch import cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.serve import scorer as serve_scorer
    from fast_tffm_tpu_torch.train import checkpoint
    from fast_tffm_tpu_torch.train import tiered as tiered_lib
    from fast_tffm_tpu_torch.train.loop import Trainer

    base = {"train_files": train_files, "validation_files": [],
            "seed": SEED, "log_steps": 4, "serve_poll_secs": 0.0,
            "serve_port": 0, "mesh_data": 1, "mesh_model": world}
    runs = {}
    for name, extra in (("dense", {}),
                        ("fleet", {"table_tiering": "on",
                                   "hot_rows": FLEET_HOT})):
        model_dir = os.path.join(tmp, f"fleet_{name}_{world}")
        t0 = time.perf_counter()
        recs = [r[0] for r in spawn_runs(
            tmp, f"fleet_{name}_{world}",
            [dict(base, model_file=model_dir, **extra)], world, one_card)]
        runs[name] = {"recs": recs, "wall_s": time.perf_counter() - t0,
                      "dir": model_dir}
    dense, fleet = runs["dense"]["recs"], runs["fleet"]["recs"]
    steps = dense[0]["train"]["steps"]
    check(steps == TRAIN_FILES * BATCHES_PER_FILE,
          f"fleet baseline trained {steps} steps")
    launches = {name: 0 for name in kernels}
    for d, f in zip(dense, fleet):
        for m in ("loss", "auc", "examples", "steps"):
            check(f["train"][m] == d["train"][m],
                  f"fleet: rank {f['rank']} {m} {f['train'][m]} != the "
                  f"dense mesh's {d['train'][m]}")
        snap = f["train"]["tiered"]
        check(snap["num_shards"] == world and snap["owned_shards"] == 1,
              f"fleet: rank {f['rank']} shards {snap}")
        got = f["launches"]
        check(min(got["fm_grad"], got["k1_dedup"], got["k2_apply"]) >= steps,
              f"fleet: rank {f['rank']} launches {got}")
        for name, n in got.items():
            launches[name] += n
    evicted = sum(f["train"]["tiered"]["rows_evicted"] for f in fleet)
    check(evicted > 0, "fleet: no eviction churn")
    fleet_dir, dense_dir = runs["fleet"]["dir"], runs["dense"]["dir"]
    names = sorted(os.listdir(fleet_dir))
    check(names == sorted(["data_state.json", "serve_manifest.json"] + [
        f"tiered.shard{s}of{world}.npz" for s in range(world)]),
        f"fleet checkpoint files {names}")
    step, scalars, stores = checkpoint.restore_tiered(fleet_dir)
    vs_dense = {}
    with np.load(os.path.join(dense_dir, "params.npz")) as z:
        check(step == int(z["scalar/step"]) == steps, f"fleet step {step}")
        for name, key in (("table", "params/table"), ("acc", "opt/acc_table"),
                          ("w0", "scalar/w0"), ("acc_w0", "opt/acc_w0")):
            want = z[key]
            if name in stores:
                check(stores[name]["descriptor"]["kind"] == "dense",
                      f"fleet store {name}: {stores[name]['descriptor']}")
                have = np.empty_like(want)
                have[stores[name]["ids"]] = stores[name]["rows"]
            else:
                have = np.asarray(scalars[name], np.float32)
            check(np.array_equal(have.view(np.uint32),
                                 want.astype(np.float32).view(np.uint32)),
                  f"fleet {name} is not the dense mesh's bit for bit")
            vs_dense[name] = "bitwise"
        table, w0 = z["params/table"], float(z["scalar/w0"])
    # (b) The shard set served and predicted on one device.
    scfg = load_config(CFG_PATH, dict(base, mesh_model=1,
                                      model_file=fleet_dir))
    requests = serve_requests(np, rng, scfg)
    served = {}
    for name, model_dir in (("fleet", fleet_dir), ("dense", dense_dir)):
        rec = serve_table(np, torch, dataclasses.replace(
            scfg, model_file=model_dir), requests,
            Rows(w0, lambda ids: table[ids]), f"fleet {name} served")
        served[name] = rec
    launches["fm_scores"] += served["fleet"]["launches"]
    for a, b in zip(served["fleet"]["scores"], served["dense"]["scores"]):
        np.testing.assert_allclose(a, b, **SERVE_TOL)
    with open(CFG_PATH) as f:
        text = f.read()
    predicted = {}
    t0 = time.perf_counter()
    for name, model_dir in (("fleet", fleet_dir), ("dense", dense_dir)):
        zero_launches(kernels)
        scores = os.path.join(tmp, f"fleet_{name}_scores.txt")
        body = text
        for key, value in (("model_file", model_dir),
                           ("predict_files", predict_file),
                           ("score_path", scores)):
            body = re.sub(rf"(?m)^{key} = .*$", f"{key} = {value}", body)
        path = os.path.join(tmp, f"fleet_{name}_predict.cfg")
        with open(path, "w") as f:
            f.write(body)
        check(cli.main(["predict", path]) == 0, f"fleet {name} predict")
        predicted[name] = np.loadtxt(scores)
        if name == "fleet":
            launches["fm_scores"] += read_launches(kernels)["fm_scores"]
    predict_s = time.perf_counter() - t0
    check(predicted["fleet"].shape == (LINES,), "fleet predict lines")
    # The files print 6 digits: one digit more than SERVE_TOL allows.
    predict_diff = float(np.abs(predicted["fleet"]
                                - predicted["dense"]).max())
    check(np.allclose(predicted["fleet"], predicted["dense"], rtol=1e-5,
                      atol=SERVE_TOL["atol"] + 1.01e-6),
          f"fleet predict differs from the dense one's by {predict_diff}")
    # S = world -> 1: the shard set warm-starts one device.
    warm_dir = os.path.join(tmp, f"fleet_warm_{world}")
    shutil.copytree(fleet_dir, warm_dir)
    warm_file = os.path.join(tmp, "fleet_warm.libsvm")
    with open(train_files[0]) as src, open(warm_file, "w") as dst:
        for _ in range(FLEET_WARM_STEPS * LINES):
            dst.write(next(src))
    wcfg = load_config(CFG_PATH, dict(
        base, mesh_model=1, model_file=warm_dir, train_files=[warm_file],
        table_tiering="on", hot_rows=FLEET_HOT))
    zero_launches(kernels)
    t0 = time.perf_counter()
    warm = Trainer(wcfg)
    check(isinstance(warm.tiered, tiered_lib.TieredTable)
          and warm._restored_step == steps,
          f"warm start: {type(warm.tiered).__name__} at step "
          f"{warm._restored_step}")
    ids = stores["table"]["ids"]
    back = warm.tiered.gather_logical(ids)
    check(np.array_equal(back.view(np.uint32),
                         stores["table"]["rows"].view(np.uint32)),
          "warm start: the saved rows did not come back bit for bit")
    wres = warm.train()["train"]
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wl = read_launches(kernels)
    check(wres["steps"] == FLEET_WARM_STEPS and np.isfinite(wres["loss"]),
          f"warm start trained {wres['steps']} steps, loss {wres['loss']}")
    for name in ("fm_scores", "fm_grad", "k1_dedup", "k2_apply"):
        check(wl[name] == FLEET_WARM_STEPS,
              f"warm start: {name} launched {wl[name]} times")
        launches[name] += wl[name]
    del warm, back, table, stores
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("rank", "device", "backend", "launches", "step_p50_ms",
            "collective_share", "train_wall_s", "peak_device_mb")
    tier_keys = ("hot_hit_frac", "rows_loaded", "rows_evicted",
                 "writeback_rows", "cold_store_bytes", "resident_rows",
                 "hot_rows", "vocab")
    record = {
        "card": card, "config": "examples/criteo_kaggle.cfg",
        "mesh": [1, world], "hot_rows": FLEET_HOT, "steps": steps,
        "transport": (f"gloo through pinned host memory, {world} ranks "
                      "sharing one card" if one_card
                      else f"one rank per GPU, {fleet[0]['backend']}"),
        "train_loss": fleet[0]["train"]["loss"],
        "train_auc": fleet[0]["train"]["auc"],
        "vs_dense_mesh": vs_dense,
        "wall_s": {k: v["wall_s"] for k, v in runs.items()},
        "ranks": [{**{k: f[k] for k in keys}, **f["fleet"],
                   **{k: f["train"]["tiered"][k] for k in tier_keys}}
                  for f in fleet],
        "dense_ranks": [{k: d[k] for k in keys} for d in dense],
        "served": {name: {"dispatch_p50_ms": rec["dispatch_p50_ms"],
                          "fm_scores_launches": rec["launches"],
                          "peak_bytes_added": rec["peak_bytes_added"],
                          "max_abs_err_vs_plain":
                              rec["max_abs_err_vs_plain"]}
                   for name, rec in served.items()},
        "served_max_abs_diff": max(
            float(np.abs(a - b).max()) for a, b in zip(
                served["fleet"]["scores"], served["dense"]["scores"])),
        "predict_max_abs_diff": predict_diff, "predict_s": predict_s,
        "warm_start": {"restored_step": steps, "rows_back": len(ids),
                       "steps": wres["steps"], "loss": wres["loss"],
                       "wall_s": warm_s, "launches": wl},
    }
    return record, launches


def mesh_modes_phase(np, torch, card: str, rng, world: int,
                     one_card: bool) -> tuple:
    """Path 12, the trainer's rank-mesh modes on a ``2 x 2`` mesh (four
    ranks of this script in one group, each training its runs in turn),
    each run from the one-device run's initial table (the same seed) on
    the same global batches (the line stream), held against the port's
    one-device run of the same setting:

    (a) FFM-Criteo (``field_num = 4``: D = 33) with ``sparse_exchange =
        entries`` and again with its id plane overlapped (bitwise the
        entries run), ``MESH_FFM_STEPS`` steps, then ``dense`` (its
        554 MB delta summed through host memory under gloo) for
        ``MESH_FFM_DENSE_STEPS``; within the tile-vs-scatter bounds; the
        entries run's ``params.npz`` served by one process;
    (b) FM in ``compute_dtype = bfloat16``, ``MESH_BF16_STEPS`` steps:
        the logloss within 1e-2 of the mesh's f32 run, the parameters
        within ``BF16_PARAM_TOL`` of the one-device bf16 run and the
        table's change within its rtol of that run's (in norm); the f32
        FmGrad, K1 and K2 every step on every rank, no bf16 FmGrad;
    (c) the dense optax path (path 9's config: ``l2_mode = full``, Adam
        at ``DENSE_ADAM_LR`` and Adagrad), ``MESH_DENSE_STEPS`` steps:
        parameters and optimizer state within ``TABLE_TOL`` (the
        reference's sparse-vs-dense tolerance), Adam's count exact; K1's
        merge mode and K-place once a step on every rank, no K1 dedup or
        K2.

    Returns ``(record, launches summed over the ranks)``."""
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.train.loop import Trainer

    dev = torch.device("cuda")
    tmp_ctx = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    tmp = tmp_ctx.name
    w_true = rng.normal(0.0, 0.6, (13, INT_BUCKETS))
    files = {}
    for name, batches, fields in (("ffm", MESH_FFM_STEPS, FFM_FIELDS),
                                  ("fm", MESH_BF16_STEPS, 0)):
        files[name] = os.path.join(tmp, f"{name}.libsvm")
        write_labelled(np, files[name], rng, batches * LINES, w_true, fields)
    # The shorter runs read the head of the same lines.
    for name, src, batches in (("ffm_dense", "ffm", MESH_FFM_DENSE_STEPS),
                               ("dense", "fm", MESH_DENSE_STEPS)):
        files[name] = os.path.join(tmp, f"{name}.libsvm")
        with open(files[src]) as f, open(files[name], "w") as out:
            out.writelines(itertools.islice(f, batches * LINES))
    # The line stream (fast_ingest off) deals the single device's global
    # batches out to the data blocks.
    base = {"validation_files": [], "seed": SEED, "log_steps": 0,
            "save_steps": 0, "serve_poll_secs": 0.0, "serve_port": 0,
            "fast_ingest": False}
    dense_kw = {"sparse_update": False, "l2_mode": "full",
                "factor_lambda": DENSE_LAMBDA, "bias_lambda": DENSE_LAMBDA}
    ffm_kw = {"field_num": FFM_FIELDS}
    settings = {
        "ffm_entries": (dict(ffm_kw, train_files=[files["ffm"]],
                             sparse_exchange="entries",
                             sparse_exchange_overlap="off"), "ffm"),
        "ffm_overlap": (dict(ffm_kw, train_files=[files["ffm"]],
                             sparse_exchange="entries",
                             sparse_exchange_overlap="on",
                             steps_per_dispatch=2), "ffm"),
        "ffm_dense": (dict(ffm_kw, train_files=[files["ffm_dense"]],
                           lookup="shardmap", sparse_exchange="dense"),
                      "ffm_dense"),
        "fm_f32": (dict(train_files=[files["fm"]],
                        sparse_exchange="entries"), "fm_f32"),
        "fm_bf16": (dict(train_files=[files["fm"]],
                         sparse_exchange="entries",
                         compute_dtype="bfloat16"), "fm_bf16"),
        "dense_adam": (dict(dense_kw, train_files=[files["dense"]],
                            optimizer="adam",
                            learning_rate=DENSE_ADAM_LR), "dense_adam"),
        "dense_adagrad": (dict(dense_kw, train_files=[files["dense"]],
                               optimizer="adagrad"), "dense_adagrad"),
    }
    # The one-device runs of each setting (the overlap's is the entries
    # run's).
    single = {}
    t0 = time.perf_counter()
    for name, (kw, ref) in settings.items():
        if ref != name and ref in single:
            continue
        model_dir = os.path.join(tmp, f"single_{ref}")
        kw = {**base, **kw, "model_file": model_dir,
              "sparse_exchange_overlap": "off"}
        res = Trainer(load_config(CFG_PATH, kw)).train()
        single[ref] = {"dir": model_dir, "train": res["train"]}
        gc.collect()
        torch.cuda.empty_cache()
    single_s = time.perf_counter() - t0
    mesh = {"mesh_data": SHARDED_MESH[0], "mesh_model": SHARDED_MESH[1]}
    runs = [{**base, **kw, **mesh,
             "model_file": os.path.join(tmp, f"mesh_{name}")}
            for name, (kw, _) in settings.items()]
    t0 = time.perf_counter()
    per_rank = spawn_runs(tmp, "mesh_modes", runs, world, one_card,
                          timeout_s=MESH_MODES_TIMEOUT_S)
    mesh_s = time.perf_counter() - t0

    loaded = {}

    def load(path):
        """A checkpoint's arrays on the card (read once)."""
        if path not in loaded:
            with np.load(os.path.join(path, "params.npz")) as z:
                loaded[path] = {k: torch.from_numpy(z[k]).to(dev)
                                for k in z.files}
        return loaded[path]

    by_run, out = {}, {}
    for i, name in enumerate(settings):
        recs = [per_rank[r][i] for r in range(world)]
        ref = settings[name][1]
        steps = single[ref]["train"]["steps"]
        r0 = recs[0]
        for rec in recs:
            check(rec["train"]["steps"] == steps,
                  f"{name}: rank {rec['rank']} ran {rec['train']['steps']} "
                  f"steps, the single device {steps}")
            for m in ("loss", "auc", "examples"):
                a, b = rec["train"][m], r0["train"][m]
                check(abs(a - b) <= 1e-6 * abs(b),
                      f"{name}: rank {rec['rank']} train {m} {a} != rank "
                      f"0's {b}")
            got = rec["launches"]
            if name.startswith("ffm"):
                want_k = {"k1_dedup": steps,
                          "k2_apply": 0 if name == "ffm_dense" else steps,
                          "kplace": steps if name == "ffm_dense" else 0,
                          "fm_grad": 0}
            elif name.startswith("fm"):
                want_k = {"fm_grad": steps, "k1_dedup": steps,
                          "k2_apply": steps, "fm_grad_bf16": 0,
                          "kplace": 0}
            else:
                want_k = {"k1_merge": steps, "kplace": steps, "k1_dedup": 0,
                          "k2_apply": 0, "fm_grad": steps}
            for k, n in want_k.items():
                check(got[k] == n, f"{name}: rank {rec['rank']} launched "
                      f"{k} {got[k]} times in {steps} steps, want {n}")
            for k, n in got.items():
                by_run.setdefault(name, {}).setdefault(k, 0)
                by_run[name][k] += n
        have, want = load(runs[i]["model_file"]), load(single[ref]["dir"])
        check(set(have) == set(want), f"{name}: checkpoint keys "
              f"{sorted(set(have) ^ set(want))} differ")
        errs = {}
        for key in sorted(want):
            a, b = have[key], want[key]
            if not a.is_floating_point():
                check(torch.equal(a, b), f"{name}: {key} {a} != {b}")
                continue
            errs[key] = float((a - b).abs().max())
            if name == "fm_bf16":
                t = BF16_PARAM_TOL
            elif name.startswith("dense") or key == "params/table":
                t = TABLE_TOL  # tests/test_torch_dense.py's TOL
            elif key == "scalar/w0":
                t = dict(rtol=1e-5, atol=1e-7)
            else:
                t = OPT_TOL
            check(torch.allclose(a, b, **t),
                  f"{name}: {key} off the one-device run's by "
                  f"{errs[key]:.3e} (bound {t})")
        out[name] = {
            "steps": steps, "resolved": r0["exchange"],
            "overlap": r0["overlap"], "backend": r0["backend"],
            "train_logloss": r0["train"]["logloss"],
            "single_train_logloss": single[ref]["train"]["logloss"],
            "max_abs_err_vs_single": errs,
            "ranks": [{k: rec[k] for k in (
                "rank", "coords", "launches", "step_p50_ms",
                "collective_share", "train_wall_s", "peak_device_mb")}
                for rec in recs],
        }
    check(out["ffm_entries"]["resolved"] == "entries"
          and out["ffm_dense"]["resolved"] == "dense"
          and out["ffm_overlap"]["overlap"]
          and not out["ffm_entries"]["overlap"],
          f"path 12 exchanges: {[(k, v['resolved'], v['overlap']) for k, v in out.items()]}")
    entries, overlap = (load(runs[i]["model_file"]) for i in (0, 1))
    for key, t in overlap.items():
        check(torch.equal(t, entries[key]),
              f"ffm overlap: {key} differs from the entries run's")
    gap = abs(out["fm_bf16"]["train_logloss"] - out["fm_f32"]["train_logloss"])
    check(gap < 1e-2, f"bf16 mesh logloss {gap} from the f32 mesh's")
    # (b)'s table change against the one-device bf16 run's, both from the
    # seeded initial table: the norm of their difference within
    # BF16_PARAM_TOL's rtol of the one-device change's norm, which a
    # mesh that never wrote the table fails (1).
    start = fm.init_params(
        load_config(CFG_PATH, {**base, **settings["fm_bf16"][0]}),
        torch.Generator(device=dev).manual_seed(SEED),
        device=dev).table.detach()
    d_mesh = (load(runs[list(settings).index("fm_bf16")]["model_file"])
              ["params/table"] - start)
    d_one = load(single["fm_bf16"]["dir"])["params/table"] - start
    norm = float(torch.linalg.vector_norm(d_one))
    change_rel = float(torch.linalg.vector_norm(d_mesh - d_one)) / norm
    check(norm > 0 and change_rel <= BF16_PARAM_TOL["rtol"],
          f"bf16 mesh table change {change_rel:.3e} of the one-device "
          f"run's norm {norm:.3e} from it")
    out["fm_bf16"]["table_change_rel_err"] = change_rel
    del start, d_mesh, d_one
    # The FFM mesh checkpoint served by one process (FFM scores through
    # its einsums: no FmScorer).
    scfg = load_config(CFG_PATH, dict(base, **ffm_kw,
                                      model_file=runs[0]["model_file"]))
    table = entries["params/table"].cpu().numpy()
    w0 = float(entries["scalar/w0"])
    del loaded, entries, overlap
    gc.collect()
    torch.cuda.empty_cache()
    served = serve_table(np, torch, scfg,
                         serve_requests(np, rng, scfg, FFM_FIELDS),
                         Rows(w0, lambda ids: table[ids]),
                         "mesh FFM served")
    check(served["launches"] == 0, "the FFM server launched FmScorer")
    del table
    # The launches by the kernel shape they ran at (the kernels line's
    # entries): FFM's at D = 33 (its entries payload 66 wide, its dense
    # exchange's delta too), the dense gradient's at W = 9, FM's as the
    # main path's.
    launches = {}

    def add(key, run, kernel):
        launches[key] = launches.get(key, 0) + by_run[run].get(kernel, 0)

    for run in ("ffm_entries", "ffm_overlap", "ffm_dense"):
        add("k1_dedup_d33_shard", run, "k1_dedup")
        add("k2_apply_d33_shard", run, "k2_apply")
        add("k1_merge_w66", run, "k1_merge")
        add("kplace_w66", run, "kplace")
    for run in ("fm_f32", "fm_bf16", "dense_adam", "dense_adagrad"):
        for kernel in ("fm_grad", "fm_grad_bf16", "k1_dedup", "k2_apply"):
            add(kernel, run, kernel)
    for run in ("fm_f32", "fm_bf16"):
        add("k1_merge", run, "k1_merge")
    for run in ("dense_adam", "dense_adagrad"):
        add("k1_merge_w9", run, "k1_merge")
        add("kplace_w9", run, "kplace")
    tmp_ctx.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    record = {
        "card": card, "config": "examples/criteo_kaggle.cfg",
        "mesh": list(SHARDED_MESH),
        "transport": (f"gloo through pinned host memory, {world} ranks "
                      "sharing one card" if one_card
                      else f"one rank per GPU, {per_rank[0][0]['backend']}"),
        "runs": out, "bf16_logloss_gap": gap,
        "single_device_s": single_s, "mesh_s": mesh_s,
        "served": {"dispatch_p50_ms": served["dispatch_p50_ms"],
                   "fm_scores_launches": served["launches"],
                   "max_abs_err_vs_plain": served["max_abs_err_vs_plain"]},
    }
    return record, launches


def mesh_modes_timing(np, torch, gen, rng, err: dict) -> dict:
    """Path 12's new kernel shapes against their plain versions and
    timed in CUDA graphs beside their bounds (plain versions and K1's
    ``index_add_`` too): a data block of the 2 x 2 mesh (2048 lines) on
    model shard 1 (rows ``[2^21, 2^22)``), FFM-Criteo's D = 33 with the
    off-shard occurrences at the sentinel ``vocab_local``:
    ``k1_dedup_d33_shard`` (the sentinel's segment dropped),
    ``kplace_w66`` (the FFM dense exchange's ``[2^21, 66]`` delta,
    bitwise), ``k1_merge_w66`` (two blocks' entry streams),
    ``k2_apply_d33_shard`` (Adagrad at the merged rows), and at D = 9
    ``k1_merge_w9`` and ``kplace_w9`` (the dense mesh step's gradient).
    The ids are a parsed batch of FFM-Criteo lines' (data block 1, and
    block 0 for the second entry stream).  Sets ``err`` for each;
    returns the timing records."""
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.libsvm import make_batch, parse_lines
    from fast_tffm_tpu_torch.ops import sparse_apply as sa

    dev = torch.device("cuda")
    cfg = load_config(CFG_PATH, {"field_num": FFM_FIELDS})
    vloc = cfg.vocabulary_size // SHARDED_MESH[1]
    b_loc = LINES // SHARDED_MESH[0]
    n = b_loc * cfg.max_features
    hyper = sa.Hyper(lr=0.05)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_block_") as tmp:
        path = os.path.join(tmp, "block.libsvm")
        write_labelled(np, path, rng, LINES,
                       rng.normal(0.0, 0.6, (13, INT_BUCKETS)), FFM_FIELDS)
        with open(path) as f:
            lines = f.readlines()
    ids = torch.from_numpy(make_batch(parse_lines(
        lines, cfg.vocabulary_size, cfg.hash_feature_id, FFM_FIELDS),
        LINES, cfg.max_features).ids).to(dev)
    blocks = [ids[b_loc:].reshape(-1), ids[:b_loc].reshape(-1)]

    def local_ids(block: int):
        """A data block's ids in model shard 1's coordinates, the
        off-shard ones at the sentinel ``vloc``."""
        own = blocks[block] >= vloc
        return (torch.where(own, blocks[block] - vloc, vloc)
                .to(torch.int32), own)

    timing, cases = {}, {}
    for d in (33, 9):
        lids, own = local_ids(0)
        g = torch.randn((n, d), generator=gen, device=dev) * 0.1 * own[:, None]
        meta = sa.sort_meta(lids, drop_from=vloc)
        u = meta.seg_start.numel() - 1
        args = (g, lids, meta.perm, meta.seg_start)
        if d == 33:
            urows, sums = sa.k1_dedup_cuda(*args)
            urows_p, sums_p = sa.k1_dedup_plain(g.double(), *args[1:])
            _, mass = sa.k1_dedup_plain(g.abs().double(), *args[1:])
            check(torch.equal(urows, urows_p), "K1 D=33 shard: row ids")
            check(int(urows.max()) < vloc, "K1 D=33 shard: the sentinel "
                  "segment was not dropped")
            diff = (sums.double() - sums_p).abs()
            err["k1_dedup_d33_shard"] = float(diff.max())
            check(bool(torch.all(diff <= sa.k1_error_bound(meta.seg_start,
                                                           mass))),
                  f"K1 D=33 shard vs plain: {err['k1_dedup_d33_shard']}")
            # K1's library yardstick: one index_add_ of the owned
            # occurrences' [g | g^2] payload, in their own order, over
            # their segments; the off-shard ones, which the kernel never
            # reads, are left out.  It computes K1's sums: within one
            # rounding of the segment's mass per term, in any order.
            n_own = int(meta.seg_start[-1])
            counts = (meta.seg_start[1:] - meta.seg_start[:-1]).long()
            seg = torch.full((n,), -1, dtype=torch.long, device=dev)
            seg[meta.perm[:n_own].long()] = torch.repeat_interleave(
                torch.arange(u, device=dev), counts, output_size=n_own)
            own_pos = torch.nonzero(own).squeeze(1)
            seg_own = seg.index_select(0, own_pos)
            check(own_pos.numel() == n_own and bool((seg_own >= 0).all()),
                  "K1 D=33 shard: the owned occurrences are not the "
                  "sort's first segments")
            pay_own = torch.cat([g, g * g], dim=1).index_select(0, own_pos)
            lib_k1 = torch.zeros((u, 2 * d), device=dev)
            lib_k1.index_add_(0, seg_own, pay_own)
            check(bool(torch.all((lib_k1.double() - sums_p).abs() <= 1.01
                                 * 2.0**-24 * counts[:, None] * mass)),
                  "K1 D=33 shard: the index_add_ yardstick does not "
                  "compute K1's sums")
            del urows_p, sums_p, mass, diff
            cases["k1_dedup_d33_shard"] = (
                lambda a=args: sa.k1_dedup_cuda(*a),
                lambda a=args: sa.k1_dedup_plain(*a),
                lambda: lib_k1.index_add_(0, seg_own, pay_own),
                k1_bound_ms(n_own, u, d))
            kp = (urows, sums, 0, vloc)
            name = "kplace_w66"
            # Two blocks' entry streams, merged as the entries exchange
            # merges them; K2 applies the merge at the touched rows.
            cap = sa.entries_cap(n, vloc)
            streams = [sa.unique_entries(lids, g, vocab=vloc, cap=cap)]
            lids2, own2 = local_ids(1)
            g2 = torch.randn((n, d), generator=gen, device=dev) * 0.1
            streams.append(sa.unique_entries(lids2, g2 * own2[:, None],
                                             vocab=vloc, cap=cap))
            rows_m = torch.cat([r for r, _, _ in streams])
            pay_m = torch.cat([p for _, p, _ in streams])
            w_merge = 2 * d
        else:
            rows_m, pay_m = lids, g
            w_merge = d
        meta_m = sa.sort_meta(rows_m, drop_from=vloc)
        margs = (pay_m, rows_m, meta_m.perm, meta_m.seg_start)
        urows_m, sums_m = sa.k1_merge_cuda(*margs)
        mname = f"k1_merge_w{w_merge}"
        # Against the plain version in float64, within the error K1's
        # order of summation allows; at W = 66 (at most two terms a row)
        # also bitwise the float32 plain version.
        urows_mp, sums_mp = sa.k1_merge_plain(pay_m.double(), *margs[1:])
        _, mass_m = sa.k1_merge_plain(pay_m.abs().double(), *margs[1:])
        check(torch.equal(urows_m, urows_mp), f"{mname}: row ids")
        diff = (sums_m.double() - sums_mp).abs()
        err[mname] = float(diff.max())
        check(bool(torch.all(diff <= sa.k1_error_bound(meta_m.seg_start,
                                                       mass_m))),
              f"{mname} vs plain: max err {err[mname]:.3e}")
        del urows_mp, sums_mp, mass_m, diff
        n_real = int(meta_m.seg_start[-1])
        if d == 33:
            check(torch.equal(sums_m, sa.k1_merge_plain(*margs)[1]),
                  f"{mname}: not bitwise its plain version (at most two "
                  f"terms a row)")
        else:
            kp = (urows_m, sums_m, 0, vloc)
            name = "kplace_w9"
        merge_seg = torch.repeat_interleave(
            torch.arange(urows_m.numel(), device=dev),
            (meta_m.seg_start[1:] - meta_m.seg_start[:-1]).long(),
            output_size=n_real)
        pay_real = pay_m.index_select(0, meta_m.perm[:n_real].long())
        lib_out = torch.zeros((urows_m.numel(), w_merge), device=dev)
        cases[mname] = (
            lambda a=margs: sa.k1_merge_cuda(*a),
            lambda a=margs: sa.k1_merge_plain(*a),
            lambda s=merge_seg, p=pay_real, o=lib_out: o.index_add_(0, s, p),
            k1_merge_bound_ms(n_real, urows_m.numel(), w_merge))
        delta_k, delta_p = sa.kplace_cuda(*kp), sa.kplace_plain(*kp)
        torch.cuda.synchronize()
        err[name] = float((delta_k - delta_p).abs().max())
        check(torch.equal(delta_k, delta_p),
              f"{name} vs plain: max err {err[name]} (a placement is exact)")
        del delta_k, delta_p
        cases[name] = (lambda a=kp: sa.kplace_cuda(*a),
                       lambda a=kp: sa.kplace_plain(*a),
                       kplace_library(torch, sa.kplace_plain, *kp),
                       kplace_bound_ms(kp[0].numel(), kp[1].shape[1], vloc))
        if d == 33:
            table = torch.randn((vloc, d), generator=gen, device=dev) * 0.01
            acc = torch.full((vloc, d), 0.1, device=dev)
            kern = (table.clone(), acc.clone())
            plain = (table.clone(), acc.clone())
            sa.k2_apply_cuda("adagrad", urows_m, sums_m, kern, hyper)
            sa.k2_apply_plain("adagrad", urows_m, sums_m, plain, hyper)
            torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
            torch.testing.assert_close(kern[1], plain[1], **OPT_TOL)
            err["k2_apply_d33_shard"] = max(
                float((a - b).abs().max()) for a, b in zip(kern, plain))
            cases["k2_apply_d33_shard"] = (
                lambda t=kern, r=urows_m, s=sums_m: sa.k2_apply_cuda(
                    "adagrad", r, s, t, hyper),
                lambda t=plain, r=urows_m, s=sums_m: sa.k2_apply_plain(
                    "adagrad", r, s, t, hyper),
                None, k2_bound_ms(urows_m.numel(), d))
    # K-place writes up to 554 MB a call: fewer calls a graph.
    timing = time_cases(torch, cases, calls={
        name: 10 for name in cases if name.startswith("kplace")})
    torch.cuda.empty_cache()
    return timing


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


# Autotune phase (path 14): the serve requests of (e), and the steps of
# (d) (one eager and captured, AUTOTUNE_GRAPHED replayed).
AUTOTUNE_SERVE_LINES = 1024
AUTOTUNE_GRAPHED = 4


def autotune_phase(np, torch, card: str, tcfg, tmp: str, model_dir: str,
                   predict_file: str, host_batches, kernels: dict) -> tuple:
    """Path 14, the interaction autotuner on the card at Criteo-Kaggle
    width (``ops/autotune.py``).  (a) ``resolve(auto, context="train")``
    measures ``reference``, ``pallas`` and ``packed`` at B = 4096: every
    candidate runs and passes the parity gate; each one's eager and
    graphed times, parity error and the winner printed; a second resolve
    hits the cache with no new measurement.  (b) The same in the serve
    context at the max rung for fp32, bf16 and int8 tables.  (c) A
    ``packed`` candidate that doubles the scores is gated out on the card;
    a ``pallas`` that doubles them, and one that raises, make the
    measurement raise with its name (no hand-written kernel is dropped).
    (d) ``1 + AUTOTUNE_GRAPHED`` steps (``Trainer.dispatch``, K = 1: the
    first eager and captured, the rest replays) with each pin from one
    seeded table on one set of batches, graphed and eager: each pin's
    state bitwise its eager twin's; ``pallas`` launches FmScorer and
    FmGrad once a step and the others neither; the three tables within
    ``rtol=1e-5, atol=1e-6`` of each other; an ``auto`` trainer (a cache
    hit of (a)) bitwise the run of its winner.  (e) ``python -m
    fast_tffm_tpu_torch.tools.autotune <cfg>`` fills the cache beside the
    model and ``--check`` exits 0; ``serve()`` with ``interaction_impl =
    auto`` and an emptied in-process cache starts from that file with no
    measurement (its record says ``cache``), and its ``/score_bin`` of the
    predict file's lines agrees with ``predict`` (pinned to the served
    impl) within ``SERVE_TOL`` and the file's six printed decimals.
    Returns ``(record, launches of (d) and (e))``."""
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
    from fast_tffm_tpu_torch.ops import autotune
    from fast_tffm_tpu_torch.serve import wire
    from fast_tffm_tpu_torch.serve.server import serve
    from fast_tffm_tpu_torch.train import sparse
    from fast_tffm_tpu_torch.train.loop import Trainer, predict

    rec = {"card": card}
    dev = torch.device("cuda")
    every = ("reference", "pallas", "packed")
    # A fresh model directory: every trainer of (d) starts from the
    # same seeded table, and none of them saves.
    acfg = dataclasses.replace(
        tcfg, interaction_impl="auto", validation_files=[],
        model_file=os.path.join(tmp, "autotune_model"))
    checks = os.path.join(tmp, "autotune_checks.json")

    def measured(what: str, cfg, context: str, batch) -> dict:
        """Resolve ``auto`` (it must measure every candidate and gate none
        out), then again (a cache hit, no new measurement)."""
        d = autotune.resolve(cfg, context=context, batch=batch,
                             cache_path=checks, device=dev)
        check(d.source == "measured" and tuple(d.candidates) == every,
              f"{what}: {d.source} over {d.candidates}")
        check(set(d.times_ms) == set(every),
              f"{what}: a candidate was excluded: times {d.times_ms}, "
              f"parity {d.parity_err}")
        for name in every:
            err = d.parity_err[name]
            check(math.isfinite(err) and err <= autotune.PARITY_TOL,
                  f"{what}: {name} parity error {err}")
        out = {"winner": d.impl, "times_ms": d.times_ms,
               "parity_err": d.parity_err, "measure_s": d.measure_s}
        if d.eager_ms:
            out["eager_ms"] = d.eager_ms
        n = autotune.measurement_count()
        again = autotune.resolve(cfg, context=context, batch=batch,
                                 cache_path=checks, device=dev)
        check(again.source == "cache" and again.impl == d.impl
              and autotune.measurement_count() == n,
              f"{what}: the second resolve was {again.source}")
        print(f"autotune {what} ({card}): " + json.dumps(out), flush=True)
        return out

    # (a) train context, (b) serve context at the max rung.
    t0 = time.perf_counter()
    rec["train"] = measured("train", acfg, "train", None)
    train_winner = rec["train"]["winner"]
    rung = max(acfg.serve_ladder)
    rec["serve"] = {
        dtype: measured(f"serve {dtype} at {rung}",
                        dataclasses.replace(acfg, serve_table_dtype=dtype),
                        "serve", rung)
        for dtype in ("fp32", "bf16", "int8")}
    # (c) a wrong candidate on the card.
    make, args = autotune._candidate_fns(acfg, "train", acfg.batch_size,
                                         "fp32", dev)

    def wrong(user_impl):
        fn = make(user_impl)
        if user_impl != "packed":
            return fn
        return lambda *a: tuple(2.0 * t for t in fn(*a))

    # The measurement itself: (a)'s decision for this key is cached.
    winner, times, parity, _ = autotune._measure(
        acfg, "train", acfg.batch_size, "fp32", every, dev,
        candidate_fns=(wrong, args))
    check(winner in ("reference", "pallas")
          and parity["packed"] > autotune.PARITY_TOL
          and "packed" not in times,
          f"the doubled packed candidate was not gated: {winner} "
          f"{times} {parity}")
    rec["wrong_candidate_parity_err"] = parity["packed"]

    def broken_pallas(how):
        def make_broken(user_impl):
            fn = make(user_impl)
            if user_impl != "pallas":
                return fn
            if how == "wrong":
                return lambda *a: tuple(2.0 * t for t in fn(*a))

            def f(*a):
                raise RuntimeError("injected launch failure")
            return f
        return make_broken

    for how in ("wrong", "raises"):
        try:
            autotune._measure(acfg, "train", acfg.batch_size, "fp32", every,
                              dev, candidate_fns=(broken_pallas(how), args))
        except RuntimeError as e:
            check("candidate pallas" in str(e),
                  f"a {how} pallas raised without its name: {e}")
        else:
            check(False, f"a {how} pallas candidate was dropped, not raised")
    rec["kernel_candidate_failures_raise"] = True
    rec["measure_wall_s"] = time.perf_counter() - t0

    # (d) graphed steps with each pin, and auto.
    zero_launches(kernels)
    hb = host_batches[:1 + AUTOTUNE_GRAPHED]
    runs, launches_by = {}, {}
    for impl in every + ("auto",):
        for graphs in (True, False):
            cfg = dataclasses.replace(acfg, interaction_impl=impl)
            before = read_launches(kernels)
            trainer = Trainer(cfg)
            if not graphs:
                trainer.graph = None
            for sb in DevicePrefetcher(hb, 1, dev, cfg.vocabulary_size):
                trainer.dispatch(sb)
            torch.cuda.synchronize()
            after = read_launches(kernels)
            n = {k: after[k] - before[k] for k in after}
            check(trainer.graph_dispatches == (AUTOTUNE_GRAPHED if graphs
                                               else 0),
                  f"{impl}: {trainer.graph_dispatches} graph dispatches")
            runs[(impl, graphs)] = [t.detach().clone() for t in
                                    trained_state(sparse, trainer)]
            launches_by[(impl, graphs)] = n
            if impl == "auto":
                check(trainer._autotune.source == "cache"
                      and trainer.kernel_impl == train_winner,
                      f"auto trainer: {trainer._autotune.source}, "
                      f"{trainer.kernel_impl} (winner {train_winner})")
            del trainer
    steps = len(hb)
    for impl in every + ("auto",):
        check(all(torch.equal(a, b) for a, b in zip(runs[(impl, True)],
                                                    runs[(impl, False)])),
              f"{impl}: the graphed run is not bitwise its eager twin")
        want = steps if (impl if impl != "auto" else train_winner) == (
            "pallas") else 0
        for graphs in (True, False):
            n = launches_by[(impl, graphs)]
            check(n["fm_scores"] == n["fm_grad"] == want
                  and n["k1_dedup"] == n["k2_apply"] == steps,
                  f"{impl} (graphed {graphs}): launches {n}")
    for a in ("reference", "packed"):
        for x, y in zip(runs[(a, True)][:3], runs[("pallas", True)][:3]):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    check(all(torch.equal(a, b) for a, b in zip(
        runs[("auto", True)], runs[(train_winner, True)])),
        "the auto run is not bitwise the run of its winner")
    rec["graphed_steps"] = {"steps": steps, "replays": AUTOTUNE_GRAPHED,
                            "launches": {f"{i}_{'graph' if g else 'eager'}":
                                         launches_by[(i, g)]
                                         for i, g in launches_by}}
    del runs

    # (e) the tool, then a served auto config from its file.
    cfg_path = write_fleet_cfg(tmp, "autotune.cfg", model_dir)
    tool = [sys.executable, "-m", "fast_tffm_tpu_torch.tools.autotune"]
    cache = os.path.join(os.path.dirname(model_dir), "autotune_cache.json")
    for extra in ([], ["--check"]):
        t0 = time.perf_counter()
        r = subprocess.run(tool + [cfg_path] + extra, cwd=REPO, timeout=600,
                           capture_output=True, text=True)
        check(r.returncode == 0, f"tools.autotune {extra} exited "
              f"{r.returncode}: {r.stdout[-1000:]} {r.stderr[-2000:]}")
        rec["tool" + "_check" * bool(extra) + "_s"] = (
            time.perf_counter() - t0)
        rec["tool" + "_check" * bool(extra) + "_stdout"] = (
            r.stdout.strip().splitlines())
    entries = autotune.load_cache(cache)
    check(sorted(k.split("|")[0] for k in entries) == ["serve", "train"],
          f"the tool's cache holds {list(entries)}")
    stream = os.path.join(tmp, "autotune_serve.jsonl")
    scfg = load_config(cfg_path, {
        "interaction_impl": "auto", "serve_port": 0,
        "serve_poll_secs": 0.0, "metrics_file": stream})
    autotune._MEM_CACHE.clear()
    n = autotune.measurement_count()
    handle = serve(scfg, port=0)
    try:
        check(autotune.measurement_count() == n,
              "the served auto config measured")
        served_impl = handle.scorer.kernel_impl
        with open(predict_file) as f:
            lines = [next(f) for _ in range(AUTOTUNE_SERVE_LINES)]
        from fast_tffm_tpu_torch.data.libsvm import make_batch, parse_lines

        b = make_batch(parse_lines(lines, scfg.vocabulary_size,
                                   scfg.hash_feature_id),
                       AUTOTUNE_SERVE_LINES, scfg.max_features)
        conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                          timeout=120)
        got = wire.decode_bin_response(post(
            conn, "/score_bin", wire.encode_bin_request(b.ids, b.vals)))
        conn.close()
    finally:
        handle.close()
    records = [r for r in jsonl(stream) if r.get("record") == "autotune"]
    check(len(records) == 1 and records[0]["source"] == "cache"
          and records[0]["context"] == "serve"
          and records[0]["impl"] == served_impl,
          f"the served auto config's autotune records: {records}")
    pcfg = dataclasses.replace(
        tcfg, interaction_impl=served_impl,
        score_path=os.path.join(tmp, "autotune_scores.txt"))
    predict(pcfg)
    with open(pcfg.score_path) as f:
        want = np.array([float(next(f)) for _ in range(AUTOTUNE_SERVE_LINES)])
    diff = float(np.abs(got - want).max())
    # SERVE_TOL, plus half a unit of the file's sixth decimal.
    check(np.allclose(got, want, rtol=SERVE_TOL["rtol"],
                      atol=SERVE_TOL["atol"] + 5e-7),
          f"/score_bin differs from predict by {diff}")
    rec["served"] = {"impl": served_impl, "source": records[0]["source"],
                     "max_abs_diff_vs_predict": diff}
    launches = read_launches(kernels)
    rec["launches"] = launches
    return rec, launches


def nccl_main() -> int:
    """``--nccl``: the sharded phase (its three 2 x 2 runs), path 11 as
    a ``1 x 4`` fleet against the dense ``1 x 4`` mesh and path 12's
    2 x 2 runs, one rank per GPU (needs at least four), so the backend
    rule picks NCCL."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible to PyTorch", file=sys.stderr)
        return 2
    world = SHARDED_MESH[0] * SHARDED_MESH[1]
    check(torch.cuda.device_count() >= world,
          f"--nccl needs {world} GPUs, have {torch.cuda.device_count()}")
    sys.path.insert(0, REPO)
    from fast_tffm_tpu_torch.ops import _build, fm_kernels, sparse_apply
    from fast_tffm_tpu_torch.tools import micro_probe

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    card = card_line()
    t_start = time.perf_counter()
    _build.build(force=True)
    rng = np.random.default_rng(SEED)
    w_true = rng.normal(0.0, 0.6, (13, INT_BUCKETS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train_files = [os.path.join(tmp, f"train_{i}.libsvm")
                       for i in range(TRAIN_FILES)]
        for path in train_files:
            write_labelled(np, path, rng, BATCHES_PER_FILE * LINES, w_true)
        valid_file = os.path.join(tmp, "valid.libsvm")
        predict_file = os.path.join(tmp, "predict.libsvm")
        write_labelled(np, valid_file, rng, LINES, w_true)
        write_labelled(np, predict_file, rng, LINES, w_true)
        record, _ = sharded_phase(np, torch, tmp, card, train_files[0],
                                  valid_file, one_card=False)
        print(json.dumps(record), flush=True)
        kernels = kernel_fns(fm_kernels, sparse_apply, micro_probe)
        fleet, _ = fleet_phase(np, torch, tmp, card, rng, train_files,
                               predict_file, kernels, world=world,
                               one_card=False)
        print(json.dumps({"fleet": fleet}), flush=True)
        mesh_rec, _ = mesh_modes_phase(np, torch, card, rng, world=world,
                                       one_card=False)
        print(json.dumps({"mesh_modes": mesh_rec}), flush=True)
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
            kplace_library(torch, kplace_plain, urows_kp, sums_kp,
                           KPLACE_ROW_LO, KPLACE_VOCAB_LOCAL),
            kplace_bound_ms(placed, 2 * D, KPLACE_VOCAB_LOCAL),
        ),
        "k1_merge": (
            lambda: k1_merge_cuda(*merge_args),
            lambda: k1_merge_plain(*merge_args),
            lambda: lib_merge.index_add_(0, merge_seg, pay_real),
            k1_merge_bound_ms(n_real, urows_m.numel(), 2 * D),
        ),
    }
    # K-place writes a 151 MB delta per call: fewer calls per graph.
    timing.update(time_cases(torch, cases, calls={"kplace": 20}))
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

    # -- obs phase (main path 1 with the health carry and the planes) ---
    obs_rec, obs_launches = obs_phase(
        np, torch, card, tcfg, train_files, model_dir, tmp,
        batches + batches[:1], kernels, counters)
    print(json.dumps({"obs": obs_rec}), flush=True)
    print("obs (" + card + "): " + json.dumps(obs_rec["step_timing"]),
          flush=True)
    print("obs check: a clean K = 4 graphed run with a metrics stream, "
          "heartbeat, status endpoint and warn rule is bitwise the run "
          "without them; its stream, scrape, touched rows and occurrences "
          "hold; a poisoned replay halts within one dispatch with the "
          "clean save kept; a halt rule stops the run with no checkpoint; "
          "the server's stream has its header, heartbeats and alert",
          flush=True)
    phase_end("obs")

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
            s_p = sparse.sparse_step(pcfg, mp, op, b, plain=True,
                                     impl="jnp")
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
        served, bodies = [], []
        for n_req in sizes:
            body = criteo_body(rng, n_req)
            bodies.append(body.encode())
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
    del ref, scorer, handle
    torch.cuda.empty_cache()

    # -- serve_fleet phase (path 13): replicas behind the router ---------
    sfleet_rec, sfleet_launches = serve_fleet_phase(
        np, torch, card, tmp, model_dir, served, bodies)
    print(json.dumps({"serve_fleet": sfleet_rec}), flush=True)
    print("serve_fleet (" + card + "): " + json.dumps({
        k: sfleet_rec[k] for k in ("start_s", "bin_p50_ms", "rps",
                                   "respawn")}), flush=True)
    print("serve_fleet check: two replicas on the card behind the router "
          "answer every rung over both transports bitwise path 2's; both "
          "launched the kernel; a tiny budget sheds with 429 + Retry-After "
          "and every 200 is right; a SIGKILLed replica cost no request, "
          "was respawned, readmitted and scores bitwise; the captures "
          "replay bitwise; the same table is promoted, a scaled one rolled "
          "back; no replica outlives its router", flush=True)
    phase_end("serve_fleet")

    # -- quant phase (path 6): the checkpoint's quantized tables -------
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

    # -- orbax_serve phase (path 10): JAX-written checkpoints, hot swap --
    orbax_rec, orbax_launches, warm = orbax_fixtures(np, torch, rng, tmp,
                                                     kernels)
    orbax_rec["parity"] = orbax_parity(np, torch, fm, sparse, make_batch,
                                       parse_lines, host_sort_meta, *warm)
    swap_rec, swap_launches = orbax_hot_swap(np, torch, card, tcfg,
                                             model_dir, predict_file, tmp,
                                             kernels)
    orbax_rec["hot_swap"] = swap_rec
    for name in orbax_launches:
        orbax_launches[name] += swap_launches[name]
    for name in ("fm_scores", "fm_grad", "k1_dedup", "k2_apply"):
        check(orbax_launches[name] > 0, f"path 10 never launched {name}")
    orbax_rec["launches"] = orbax_launches
    print(json.dumps({"orbax_serve": orbax_rec}), flush=True)
    print("orbax_serve (" + card + "): " + json.dumps({
        k: swap_rec[k] for k in (
            "publish_to_swap_s", "placement_wall_s",
            "dispatch_p50_ms_during_swap", "dispatch_p50_ms_after_swap",
            "keep_prev_window_peak_device_mb", "keep_prev_window_added_mb",
            "responses_old", "responses_new")}), flush=True)
    print("orbax_serve check: the JAX-written fixtures serve on the card "
          "within the reference's scores and the plain path (fp32, int8); "
          "CLI predict; the Adagrad fixture warm-starts bitwise and trains "
          "16 graphed steps, kernel steps == plain steps; at full width the "
          "watcher swaps in a warm-started trainer's save under traffic, "
          "every response old or new bitwise, /score equal to the new "
          "predict file; /reload?keep_prev=1, /rollback, /promote, 409",
          flush=True)
    phase_end("orbax_serve")

    # -- fleet phase (path 11): the rank-sharded tiered table -----------
    fleet_rec, fleet_launches = fleet_phase(
        np, torch, tmp, card, rng, train_files, predict_file, kernels,
        world=2, one_card=True)
    print(json.dumps({"fleet": fleet_rec}), flush=True)
    print("fleet (" + card + "): " + json.dumps({
        "ranks": [{k: r[k] for k in (
            "rank", "step_p50_ms", "collective_share", "plan_ms_mean",
            "migration_device_ms_mean", "hot_hit_frac", "rows_evicted",
            "writeback_rows", "cold_store_bytes", "peak_device_mb")}
            for r in fleet_rec["ranks"]],
        "served_max_abs_diff": fleet_rec["served_max_abs_diff"]}),
        flush=True)
    print("fleet check: a 1 x 2 fleet of two ranks trains bitwise the "
          "dense 1 x 2 mesh (loss, AUC, w0, the merged table and "
          "accumulator); its shard set serves and predicts within "
          "SERVE_TOL of the dense params.npz, warm-starts one device with "
          "every saved row bitwise and trains on", flush=True)
    phase_end("fleet")

    # -- autotune phase (path 14): the interaction choice on the card ---
    autotune_rec, autotune_launches = autotune_phase(
        np, torch, card, tcfg, tmp, model_dir, predict_file,
        batches + batches[:2], kernels)
    print(json.dumps({"autotune": autotune_rec}), flush=True)
    print("autotune check: reference, pallas and packed each measured and "
          "parity-gated in the train context and the serve context (fp32, "
          "bf16, int8), a cache hit after each; a doubled candidate gated "
          "out; graphed steps of each pin bitwise their eager twins, "
          "FmScorer and FmGrad only under pallas, the tables within "
          "1e-5 of each other, auto bitwise its winner; the tool fills the "
          "cache, --check passes, a served auto config starts from the "
          "file and agrees with predict", flush=True)
    phase_end("autotune")
    tmp_ctx.cleanup()  # the main run's files, which paths 8-11 and 14 read

    # -- mesh_modes phase (path 12): FFM, bf16, dense optax on a mesh ---
    mesh_rec, mesh_launches = mesh_modes_phase(np, torch, card, rng,
                                               world=4, one_card=True)
    mesh_timing = mesh_modes_timing(np, torch, gen, rng, err)
    timing.update(mesh_timing)
    mesh_rec["kernel_timing"] = mesh_timing
    print(json.dumps({"mesh_modes": mesh_rec}), flush=True)
    print("mesh_modes (" + card + "): " + json.dumps({
        name: {"step_p50_ms": [r["step_p50_ms"] for r in run["ranks"]],
               "collective_share": [r["collective_share"]
                                    for r in run["ranks"]],
               "peak_device_mb": [r["peak_device_mb"] for r in run["ranks"]]}
        for name, run in mesh_rec["runs"].items()}), flush=True)
    print("mesh_modes (" + card + ") kernels: " + json.dumps({
        name: {k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                 "library_ms")}
        for name, t in mesh_timing.items()}), flush=True)
    print("mesh_modes check: on a 2 x 2 mesh FFM-Criteo (entries, overlap "
          "bitwise entries, dense exchange), bf16 FM and the dense optax "
          "path (Adam, Adagrad) within their bounds of the one-device "
          "runs; each kernel once a step on every rank; the FFM mesh "
          "checkpoint served; K-place at W = 66 and 9 bitwise its plain "
          "version", flush=True)
    phase_end("mesh_modes")

    # Launches on the main paths: train (path 1), serve (paths 2, 6 and
    # 7, with path 8 the only fm_scores count), the sharded runs' ranks
    # (path 3), the probe (path 4, the only K2T and K2P counts), the
    # bf16 train run (path 1 with compute_dtype = bfloat16), the tiered
    # runs (path 8: training, and the fp32 bench run's serving), the
    # dense runs (path 9) and the Orbax and hot-swap runs (path 10).
    launches = {name: train_launches[name] + sharded_launches[name]
                + obs_launches[name] for name in kernels}
    for name in ("fm_grad", "k1_dedup", "k2_apply"):  # path 8
        launches[name] += tiered_launches[name]
    # FmScorer f32: the serve path, the quantized tables (path 6), the
    # overlay (path 7) and the fleet's replicas on their main path (path
    # 13, read from each replica's /status).
    launches["fm_scores"] = (serve_launches + quant_launches
                             + overlay_launches + tiered_launches["fm_scores"]
                             + sfleet_launches)
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
    # Path 10: the fixtures served and predicted, the warm start's 16
    # steps, and the full-width hot swap's warm start, serving and
    # predict.
    for name in ("fm_scores", "fm_grad", "k1_dedup", "k2_apply"):
        launches[name] += orbax_launches[name]
    # Path 11: the fleet ranks' steps (FmGrad, K1, K2; the sharded step
    # scores without FmScorer), the shard set served and predicted, and
    # the one-device warm start's steps.
    for name in ("fm_scores", "fm_grad", "k1_dedup", "k2_apply"):
        launches[name] += fleet_launches[name]
    # Path 12: the mesh's FM runs (f32 and bf16 compute, the f32 FmGrad
    # in both) and the dense runs' FmGrad on the main entries; its new
    # shapes on their own.
    for name, n in mesh_launches.items():
        launches[name] = launches.get(name, 0) + n
    # Path 14: the pinned and auto graphed steps of the autotune phase,
    # its served requests and predict.
    for name in ("fm_scores", "fm_grad", "k1_dedup", "k2_apply"):
        launches[name] += autotune_launches[name]
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
        "k1_dedup_d33_shard": ("sparse_apply.cu",
                               "fast_tffm_tpu/ops/sparse_apply.py:136"),
        "k2_apply_d33_shard": ("sparse_apply.cu",
                               "fast_tffm_tpu/ops/sparse_apply.py:322"),
        "k1_merge_w66": ("sparse_apply.cu",
                         "fast_tffm_tpu/ops/sparse_apply.py:136"),
        "k1_merge_w9": ("sparse_apply.cu",
                        "fast_tffm_tpu/ops/sparse_apply.py:136"),
        "kplace_w66": ("sparse_apply.cu",
                       "fast_tffm_tpu/ops/sparse_apply.py:469"),
        "kplace_w9": ("sparse_apply.cu",
                      "fast_tffm_tpu/ops/sparse_apply.py:469"),
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
    if sys.argv[1:2] == ["--fleet-client"]:
        sys.exit(fleet_client_main(sys.argv[2:]))
    if sys.argv[1:] == ["--nccl"]:
        sys.exit(nccl_main())
    if sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]} [--nccl]")
    sys.exit(main())
