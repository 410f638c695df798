"""Typed configuration, loadable from the reference's INI ``.cfg`` surface.

The PyTorch port's own copy of ``fast_tffm_tpu/config.py``: the same
``FmConfig`` fields, defaults, validation and INI key map, so every
``.cfg`` file parses to the same values in both packages.  Two things
differ: ``alert_rules`` is checked for its heartbeat requirement but its
rule grammar is not parsed (the port has no alert engine yet), and the
``compute_jnp_dtype`` and ``interaction_resolved`` properties are absent
(the port has one interaction path: the CUDA kernel on the GPU).
"""

from __future__ import annotations

import configparser
import dataclasses
import glob as _glob
import logging
from typing import Optional

log = logging.getLogger(__name__)

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def _parse_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"not a boolean: {s!r}")


def _parse_files(s: str) -> list[str]:
    """Comma/semicolon-separated list of file patterns, glob-expanded."""
    out: list[str] = []
    for part in s.replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        hits = sorted(_glob.glob(part))
        out.extend(hits if hits else [part])
    return out


@dataclasses.dataclass
class FmConfig:
    # --- [General] (reference keys, SURVEY.md §2 #12) ---
    vocabulary_size: int = 2**20
    # Kept for config compatibility: the reference used it to split the table
    # into N variables for parameter servers.  Here sharding is mesh-driven;
    # the value is accepted and ignored (mesh_model plays its role).
    vocabulary_block_num: int = 1
    hash_feature_id: bool = False
    factor_num: int = 8
    model_file: str = "./fm_model"
    log_file: str = ""
    # Field-aware FM extension: number of fields (0 = plain FM).
    field_num: int = 0

    # --- [Train] ---
    train_files: list[str] = dataclasses.field(default_factory=list)
    weight_files: list[str] = dataclasses.field(default_factory=list)
    validation_files: list[str] = dataclasses.field(default_factory=list)
    epoch_num: int = 1
    batch_size: int = 1024
    learning_rate: float = 0.01
    adagrad_initial_accumulator: float = 0.1
    optimizer: str = "adagrad"  # adagrad | ftrl | sgd | adam
    loss_type: str = "logistic"  # logistic | mse
    factor_lambda: float = 0.0
    bias_lambda: float = 0.0
    # FTRL extras
    ftrl_l1: float = 0.0
    ftrl_l2: float = 0.0
    ftrl_beta: float = 1.0
    init_value_range: float = 0.01
    # Input-pipeline knobs (reference queue knobs, SURVEY.md §2 #6).
    thread_num: int = 4
    queue_size: int = 64
    # Parse in this many spawned worker PROCESSES instead of thread_num
    # in-process threads (0 = threads).  Escapes the GIL entirely —
    # required for the pure-Python parse fallback to scale at all, and
    # frees the trainer process's interpreter on the native path too.
    # Parsed batches return over POSIX shared memory (data.procpool).
    parse_processes: int = 0
    # Multi-epoch parsed-batch cache (the tf.data .cache() pattern):
    # epoch 0 parses, epochs 1..E-1 replay the cached batches in a
    # seeded per-epoch permutation — no re-read/re-parse.  Cross-epoch
    # remixing drops to batch granularity (the documented tradeoff).
    # cache_max_bytes bounds host memory; overflowing it falls back to
    # re-parsing later epochs (cache_result = "overflow").
    cache_epochs: bool = False
    cache_max_bytes: int = 1 << 30
    # Store the epoch cache as PRE-STACKED [K, ...] super-batches
    # (K = steps_per_dispatch), stacked once at epoch-0 group boundaries:
    # replay epochs hand whole super-batches to the transfer stage, which
    # skips its per-dispatch np.stack entirely.  Cross-epoch remixing
    # drops to SUPER-batch granularity (the next step of the cache_epochs
    # tradeoff); only engages when cache_epochs is on.
    cache_prestacked: bool = False
    # Inbound shared-memory ring for parse_processes: raw windows are
    # written into one of this many fixed SHM slots and workers parse in
    # place — only slot descriptors cross the worker queue (0 = ship
    # window bytes over the queue like before).  Slot capacity is sized
    # from the shuffle window; an oversized window falls back to the
    # queue path (counted as ingest.ring_fallback_windows).
    ring_slots: int = 4
    # Kept for config compatibility: the reference ran N shuffle-queue
    # threads between its reader and parser queues.  Here shuffling is a
    # window permutation inside the (single, sequential-IO) reader thread
    # — it costs one rng permutation per window, so there is nothing to
    # parallelize; parsing parallelism is thread_num.  Accepted and
    # ignored, like vocabulary_block_num.
    shuffle_threads: int = 1
    shuffle_buffer: int = 10000
    save_steps: int = 0  # 0 = only at end of training
    log_steps: int = 100
    # Run validation every N steps during training (0 = only at the end)
    # — the reference printed periodic step/loss/validation-loss
    # (SURVEY.md §5 metrics row).
    validation_steps: int = 0
    seed: int = 0

    # --- [Predict] ---
    predict_files: list[str] = dataclasses.field(default_factory=list)
    score_path: str = "./scores.txt"
    # Online serving (run_tffm.py serve; fast_tffm_tpu/serve): an HTTP
    # scoring endpoint (POST /score, libsvm lines in, one score per
    # line out) over a compiled fixed-shape scorer.  0 with the serve
    # mode = an OS-assigned port (logged, and printed as
    # "serving on host:port").
    serve_port: int = 0
    # Bind address for the scoring endpoint.  Loopback by default for
    # the same reason as status_host: the endpoint is unauthenticated.
    serve_host: str = "127.0.0.1"
    # The fixed microbatch shape ladder: requests pad/coalesce into the
    # smallest of these example counts that holds them, and every rung
    # is AOT-precompiled at startup — steady-state serving never
    # compiles.  Comma-separated, ascending after parse.
    serve_batch_sizes: str = "64,256,1024"
    # Request-coalescing deadline: a microbatch dispatches when the
    # largest rung fills OR this many ms pass since its first request —
    # the latency/throughput dial.  0 = dispatch immediately (lowest
    # latency, worst fill).
    max_batch_wait_ms: float = 2.0
    # Warm checkpoint hot-swap: poll the trainer-published
    # serve_manifest.json every this-many seconds and swap new params
    # in between dispatches (zero recompiles, no dropped requests).
    # 0 = serve the startup checkpoint forever.
    serve_poll_secs: float = 2.0
    # Scale-out serving (serve/router.py): run this many shared-nothing
    # replica serve processes (each the full scorer/batcher/server
    # stack on its own port) behind a power-of-two-choices router on
    # serve_port.  0 or 1 = the classic single-process server, no
    # router.  See SERVING.md "Scale-out".
    serve_replicas: int = 0
    # Router admission control: a request is shed with a fast 429 (+
    # Retry-After) when the fleet's projected queue delay — in-flight
    # requests over the measured completion rate — exceeds this budget,
    # so admitted-request p99 stays bounded instead of collapsing under
    # a traffic spike.  0 = admit everything (latency grows unboundedly
    # under overload).
    serve_shed_deadline_ms: float = 50.0
    # Rolling manifest promotion: instead of every replica self-swapping
    # on the manifest poll, the ROUTER canaries one replica on the new
    # checkpoint, shadow-scores a recent traffic sample against a
    # baseline replica, compares the score distributions via
    # `tools/report.py --compare`, and only then promotes the fleet
    # (or rolls the canary back).  Requires serve_replicas >= 2.
    serve_canary: bool = False
    # Which request transports the scoring endpoints accept: "text"
    # (POST /score, libsvm lines), "bin" (POST /score_bin,
    # length-prefixed little-endian id/value/field arrays — skips text
    # parsing on the hot path entirely), or "both" (default).
    serve_transport: str = "both"
    # Per-request distributed tracing sample rate for the serving path
    # (0 = off, 1 = every request).  A sampled request gets a request
    # id (client-supplied X-Request-Id or minted), the id propagates
    # router -> replica (HTTP header for /score, the flags-gated frame
    # trailer for /score_bin) and is echoed in the response header,
    # and a connected span chain (admit -> proxy -> queue -> coalesce
    # -> dispatch -> respond) lands in the trace files.  Requires
    # trace_file (the spans need somewhere to go); the unsampled path
    # is byte-identical to sampling off.  See OBSERVABILITY.md.
    serve_trace_sample: float = 0.0
    # Serving SLO: the latency objective in ms.  A completed request
    # slower than this counts against the error budget (alongside
    # sheds and 5xx responses).  0 = latency does not enter the SLO.
    serve_slo_p99_ms: float = 0.0
    # Serving SLO: the availability objective (e.g. 0.999).  Defines
    # the error budget 1 - availability; the serving path computes the
    # rolling burn rate bad_frac / budget over a sliding window and
    # exposes it as the `serve.burn_rate` gauge + serve-block key (an
    # alert signal: "burn_rate > 10 : warn").  0 = no burn-rate
    # accounting (slo_bad_frac still reports when serve_slo_p99_ms is
    # set).  See OBSERVABILITY.md "Serving SLO & burn rate".
    serve_slo_availability: float = 0.0
    # Text-parse engine for POST /score: "vec" (default) runs the
    # batch parser (serve/textparse.py — one regex validation pass +
    # strided/vectorized conversion over the whole body, with
    # automatic per-line fallback on out-of-grammar input), "legacy"
    # forces the per-line libsvm.parse_line loop.  Both are pinned
    # bitwise-identical (arrays AND error text) by test; the knob
    # exists for bisection and as the fallback's direct spelling.
    serve_parse_mode: str = "vec"
    # HTTP front-end worker pool for the scoring endpoints (server AND
    # router): this many persistent handler threads serve accepted
    # connections from a bounded hand-off queue instead of spawning a
    # thread per connection.  Size it >= the expected concurrent
    # kept-alive connections (a kept-alive peer holds a worker until
    # it closes or the 60 s socket timeout fires).  0 = the
    # thread-per-connection mode, byte-identical serving behavior.
    serve_http_threads: int = 8
    # Accept-loop count for the pooled front end: N > 1 adds N-1 extra
    # accept loops, each on its own SO_REUSEPORT listener when the
    # kernel supports it (feature-probed; portable fallback shares the
    # primary socket).  Only meaningful with serve_http_threads > 0.
    serve_http_acceptors: int = 1

    # --- observability (SURVEY.md §5: tracing/metrics rebuild) ---
    # Directory for a jax.profiler trace of steps
    # [profile_start_step, profile_start_step + profile_steps). Empty = off.
    profile_dir: str = ""
    profile_start_step: int = 10
    profile_steps: int = 5
    # JSONL stream of per-interval training metrics (step, examples,
    # loss, auc, examples_per_sec, elapsed). Empty = off.  Every record
    # carries a "record" type ("run_header" | "train" | "validation" |
    # "heartbeat" | "final") so one file is self-describing.
    metrics_file: str = ""
    # Run-wide telemetry (obs.Telemetry): per-stage counters/gauges/
    # timing histograms across reader, parse workers, the transfer
    # thread, and the dispatch loop.  Near-zero hot-path overhead (one
    # perf_counter + one uncontended lock per BATCH event); disabling it
    # swaps in no-op instruments — zero behavior change either way.
    telemetry: bool = True
    # Heartbeat cadence in seconds: a background thread periodically
    # writes one structured JSONL record (into metrics_file when set)
    # with the telemetry snapshot + ingest_wait_frac, and logs a
    # one-line summary — any run self-reports its bottleneck.  0 = off.
    heartbeat_secs: float = 0.0
    # Causal batch tracing: write a Chrome-trace-format (Perfetto-
    # loadable) span file here — per-window read, SHM ring slot
    # acquire/release, per-batch parse (thread AND process workers),
    # prefetcher stack / staging-wait / H2D, and train-loop wait/
    # dispatch, all correlated by batch/super-batch id so one super-
    # batch's life is a connected chain from file read to fused-scan
    # dispatch.  Empty = off (no-op tracer; bit-identical training).
    # Multi-host ranks > 0 suffix the path with .rankN; merge with
    # `python tools/report.py --trace <files>`.
    trace_file: str = ""
    # What to do when a dispatch produces a non-finite (NaN/inf)
    # gradient (detected on-device by the scan-carry health monitors,
    # checked one dispatch delayed so detection costs no pipeline
    # bubble): "warn" logs once and keeps counting (the final record
    # carries the totals); "halt" raises NonFiniteGradError without
    # overwriting the checkpoint with poisoned params.
    nan_policy: str = "warn"
    # Live status endpoint (obs.StatusServer): serve /metrics
    # (Prometheus text exposition of every telemetry snapshot + the
    # health/tiered blocks) and /status (the heartbeat JSON record, on
    # demand) from an in-process stdlib HTTP server on this port.
    # 0 = off (no server exists; training is bit-identical).  The
    # endpoint is read-only and never touches the hot path — requests
    # read the same thread-safe snapshots a heartbeat does.
    status_port: int = 0
    # Bind address for the status endpoint.  Loopback by default: the
    # endpoint is unauthenticated, so serving other hosts (a real
    # Prometheus scrape) is an explicit opt-in ("0.0.0.0").
    status_host: str = "127.0.0.1"
    # Declarative alert watchdog riding the heartbeat thread (needs
    # heartbeat_secs > 0): ';'-separated rules of the form
    # "signal > threshold [for N] : warn|halt" evaluated against every
    # heartbeat record (signals: any record path like ingest_wait_frac
    # / health.grad_norm / tiered.hot_hit_frac, plus derived
    # grad_norm_drift, beat_gap_s, prefetch_out_empty_frac — see
    # OBSERVABILITY.md).  Breaches emit `record: alert` JSONL entries;
    # action halt raises AlertHaltError at the next dispatch boundary
    # without overwriting the checkpoint.  "" = off.
    alert_rules: str = ""
    # Resource & compile observability (obs/resource.py): a `resource`
    # block in every heartbeat/status/final record — process RSS +
    # peak-RSS, the component host-memory ledger (SHM ring, staging
    # pool, epoch cache, tiered cold store, trace buffer byte gauges),
    # device memory (backend memory_stats where supported, a
    # shape-derived table+optimizer estimate elsewhere), and the
    # compile sentinel: the train-step compile path runs through an
    # AOT (.lower().compile()) cache that counts compilations, records
    # wall time + XLA cost analysis per compile (`record: compile`
    # JSONL entries), and flags any recompile beyond the documented
    # epoch-tail K'=leftover as `recompiles_unexpected` (warn by
    # default; alert signal of the same name).  Off = no sentinel, no
    # resource block, the historical jit dispatch path — bit-identical
    # training, same contract as every other obs knob.
    resource_metrics: bool = True
    # Model-quality & data-drift observability (obs/quality.py): the
    # plane that watches the MODEL where telemetry/resource watch the
    # system.  On (default): parse workers maintain fixed-memory
    # distribution sketches over feature values / example lengths /
    # id occupancy (obs/sketch.py; process workers ship deltas back
    # like parse timings), the trainer computes windowed online eval
    # (rolling logloss / AUC / calibration ratio from its own
    # scores+labels, consumed one-dispatch-delayed like the health
    # monitors) and adjacent-window PSI drift signals — all riding
    # heartbeat/final/train-results as a `quality` block resolvable by
    # alert_rules (e.g. "quality.psi_values > 0.2 for 3 : warn") —
    # and every save publishes the cumulative sketches into
    # serve_manifest.json so the serving fleet can detect
    # training->serving skew (the serve block's `skew_*` keys /
    # tffm_serve_skew_* series).  Off: no sketches, no scores readback,
    # no quality block, no manifest payload — bitwise-identical
    # training and byte-identical serving (pinned by test, same
    # contract as telemetry/trace/resource).
    quality: bool = True
    # Examples per quality window: the rotation cadence of the drift
    # sketches (PSI compares adjacent windows) AND the size of the
    # online-eval ring (windowed logloss/AUC describe the most recent
    # this-many examples).  Smaller = faster drift detection, noisier
    # statistics.
    quality_window: int = 65536
    # Live training-fleet aggregation plane (obs/fleet.py): comma-
    # separated host:port status endpoints, one per rank in rank order
    # (each rank's own --status_port surface).  When set, rank 0
    # scrapes every target's /status on the heartbeat cadence, merges
    # the per-rank records into a `fleet` block on its heartbeat/
    # status/final records (summed examples, weighted wait fractions,
    # MAX-merged tails, scrape staleness) with live straggler
    # attribution (straggler_ratio, slowest_rank + share,
    # rank_step_skew, exchange_frac — all alertable), appends per-rank
    # tffm_train_rank_* labeled series to its /metrics, and the
    # multi-device dispatch loop times the cross-rank collective
    # barrier (train.exchange, one-dispatch-delayed — no pipeline
    # bubble).  Requires heartbeat_secs > 0 (the scrape cadence).
    # "" = off: no scrape thread, no probe, bitwise-identical
    # training — same contract as every other obs knob.
    train_fleet_scrape: str = ""
    # Windowed trace rotation: when the tracer's buffer reaches this
    # many events it dumps and resets, producing trace.0.json,
    # trace.1.json, ... (merge with tools/report.py --trace) — removes
    # the in-memory event cap for multi-hour traced runs.  0 = off
    # (single trace_file, 1M-event cap).  Requires trace_file.
    trace_rotate_events: int = 0

    # --- [Tpu] (new; not in reference) ---
    # Max features per example; batches are padded to this static shape.
    max_features: int = 64
    # Mesh axes: data-parallel x model-parallel (table row-sharding).
    mesh_data: int = 1
    mesh_model: int = 1
    # Sharded-lookup strategy: "auto" (GSPMD decides from shardings) or
    # "shardmap" (explicit mod-sharded lookup + psum, SURVEY.md §7 step 4).
    lookup: str = "auto"
    # Compute dtype for the interaction term ("float32" | "bfloat16").
    compute_dtype: str = "float32"
    # Use the Pallas kernel for the scorer when on TPU.
    use_pallas: bool = True
    # Interaction implementation: '' derives from use_pallas (True ->
    # 'pallas', False -> 'jnp'); 'flat' selects the pure-XLA flat-layout
    # one-hot-matmul variant (same math as the Pallas kernels, fused by
    # XLA instead).  Applies to plain FM; field-aware FM (field_num > 0)
    # always uses its closed-form op (ops.interaction.ffm_interaction;
    # FAST_TFFM_FFM_AUTODIFF=1 forces the autodiff einsum oracle).
    interaction: str = ""
    # Kernel autotuner surface (ops/autotune.py): "auto" benchmarks the
    # candidate interaction implementations at the run's actual shapes,
    # parity-gates them against reference, and promotes the fastest
    # (persisted per backend/shape in autotune_cache.json so later runs
    # and the serve fleet skip measurement); "reference" | "pallas" |
    # "packed" pin an impl with zero measurement ("packed" is the flat
    # one-hot-matmul layout, see EMBEDDING.md).  "" keeps the legacy
    # interaction/use_pallas derivation, bit-identical to before the
    # autotuner existed.  Routes training (the fused scan step) AND the
    # compiled serving rungs; FFM (field_num > 0) always uses its
    # closed-form op regardless.
    interaction_impl: str = ""
    # Persistent XLA compilation cache directory (jax's
    # jax_compilation_cache_dir): restarts and replica spawns reuse
    # compiled executables from disk instead of paying warmup compiles
    # again.  "" = off.  platform.enable_compile_cache() is the one
    # wiring point; platform.compile_cache_stats() counts hits/misses.
    compile_cache_dir: str = ""
    # Sparse row updates (IndexedSlices-style): optimizer touches only the
    # rows in the batch. Falls back to dense when the optimizer/l2_mode
    # combination requires it (see train.sparse.supports_sparse).
    sparse_update: bool = True
    # How sparse updates hit the table: "scatter" uses XLA row scatter
    # (general but slow on TPU), "tile" the Pallas sort+tile-scan kernels
    # (ops.sparse_apply), "auto" picks tile when supported.
    sparse_apply: str = "auto"
    # Fast ingest: read files as raw binary chunks, C++ line scan + parse,
    # no Python string per line. Shuffling permutes lines within
    # shuffle_buffer-line windows (same mixing window as the line path's
    # reservoir). Line path is used for weight_files or when the native
    # parser is unavailable.
    fast_ingest: bool = True
    # Host-side sparse-apply prep: pipeline threads sort each batch's ids
    # and precompute the tile-apply metadata in C++ (saves ~11 ms/step of
    # on-device XLA sort at Criteo shapes).  Only engages on the
    # single-process tile path with the native lib available.
    host_sort: bool = True
    # L2 mode: "batch" regularizes only the rows touched by the batch
    # (sparse-friendly); "full" regularizes the whole table (dense grads,
    # only sane for small vocabularies).
    l2_mode: str = "batch"
    # Device-resident multi-step training: one dispatch trains this many
    # batches via jax.lax.scan over a stacked super-batch — no Python or
    # host round-trip between the K steps.  1 = the classic one dispatch
    # per batch.  Logging / validation / save / profiler cadences and the
    # checkpointed mid-epoch position all move to super-batch granularity
    # (a resume always lands on a super-batch boundary).
    steps_per_dispatch: int = 1
    # How many stacked super-batches the transfer stage keeps in flight:
    # super-batch n+1 is stacked and shipped (shard_batch/device_put) on a
    # background thread while n trains.  Bounds host+device memory for
    # staged input at prefetch_super_batches * steps_per_dispatch batches.
    prefetch_super_batches: int = 2
    # Two-tier embedding table (train.tiered): "on" keeps only the
    # hottest rows device-resident (params + optimizer slots for
    # hot_rows rows) over a host-RAM cold store holding the full
    # logical vocabulary_size table, with occupancy-driven LRU
    # migration planned per super-batch in the prefetch stage.  Unlocks
    # V >= 2^28 vocabularies that cannot exist as a dense device table;
    # requires the sparse update path (adagrad/ftrl/sgd, batch L2) and
    # a single process.  "off" = the classic dense device table.
    table_tiering: str = "off"  # off | on
    # Device-resident hot rows when table_tiering=on.  Must hold every
    # unique id of one super-batch (steps_per_dispatch * batch_size *
    # max_features is a safe upper bound); clamped to vocabulary_size.
    hot_rows: int = 1 << 22
    # Storage dtype of the tiered COLD store's rows (table_tiering=on):
    # "fp32" (default; bit-exact, the pre-quantization behavior),
    # "bf16" (half the host bytes per cold row), or "int8" (symmetric
    # codes + one fp32 scale per row — rows migrate hot<->cold
    # individually, so scales are per-row here; see ops/quant.py and
    # EMBEDDING.md).  Cold rows are stored compact, dequantized on
    # hot-load, re-quantized on write-back; the device hot table (and
    # training math) stays float32.  Non-fp32 training is parity-
    # within-tolerance vs fp32, not bitwise (pinned by
    # tests/test_quant.py).
    cold_dtype: str = "fp32"
    # Storage dtype of the device-resident SERVING table (serve mode +
    # offline predict through the ladder): "fp32" | "bf16" | "int8".
    # Quantized tables hold 2-4x more rows per byte of device memory —
    # replica density — with dequant fused into the compiled rungs
    # (served scores stay within a pinned tolerance of fp32; the
    # steady-state zero-compile contract is unchanged).  See
    # SERVING.md.
    serve_table_dtype: str = "fp32"
    # int8 scale granularity for DENSE quantized tables (the serving
    # table and the quant.npz checkpoint): this many consecutive rows
    # share one fp32 scale (0 = one scale per row).  64 amortizes the
    # scale to ~0.06 B/row (the ~4x point at D=9) while bounding an
    # outlier row's precision blast radius to its own chunk.  The
    # tiered cold store always uses per-row scales regardless.
    quant_chunk: int = 64
    # How multi-device sparse updates are exchanged over the data axis
    # (both the shardmap step and the GSPMD sharded tile apply; the
    # reference's IndexedSlices push, SURVEY.md §3.2): "dense" psums
    # a [vocab_local, 2D] delta (O(vocab), simple, best at small vocab /
    # large batch); "entries" all-gathers only the deduped touched-row
    # entry streams (batch-proportional, vocab-independent — the scaling
    # property the reference's PS push had); "auto" picks whichever moves
    # fewer bytes for the static shapes.
    sparse_exchange: str = "auto"
    # Double-buffer the entries exchange's ID PLANE one super-batch
    # step ahead (ops/sparse_apply.entries_prefetch): the deduped
    # touched-row streams for scan step k+1 are computed and
    # all-gathered while step k's local apply runs, so only the
    # payload gather stays on the critical path — compute-overlapped
    # cross-rank merge, bitwise-identical parameters (the id plane is a
    # pure function of the batch ids; pinned by test).  "auto" (default)
    # overlaps whenever the GSPMD sharded entries exchange is actually
    # active (multi-shard data axis, entries mode, fused scan); "on"
    # REQUIRES that path and refuses loudly otherwise (the
    # silently-inert-knob discipline); "off" never overlaps — the
    # diagnostic A/B mode, under which the train.exchange probe blocks
    # synchronously and so measures the UN-overlapped exchange window
    # (see OBSERVABILITY.md).
    sparse_exchange_overlap: str = "auto"  # auto | on | off
    # How tiered-table ownership is partitioned across the mesh
    # (train.tiered_fleet): "global" is the classic single-process
    # host-global hot-slot map; "shards" splits id range + hot slots +
    # cold stores + write-back ledger by MODEL column, each rank
    # planning/migrating/checkpointing ONLY the shards whose columns it
    # owns (~1/R host bytes and migration traffic per rank — the
    # multi-process tiering mode).  "auto" picks shards when
    # process_count > 1, else global.  Sharded tiering requires every
    # model column to live on one process (canonically mesh_data=1,
    # mesh_model=R), identical global batches on every rank, and
    # vocabulary/hot_rows divisible by mesh_model.
    tiered_partition: str = "auto"  # auto | global | shards
    # Incident flight recorder (obs/blackbox.py; OBSERVABILITY.md
    # "Incidents & capture"): every long-running process (trainer rank,
    # serve replica, router) keeps fixed-memory rings of recent
    # heartbeat records / alerts / trace tail, and dumps an
    # incidents/<ts>_<reason>/ forensic bundle on any alert breach,
    # crash-truthful final, or manual POST /incident.  Rings are a few
    # hundred KB and touch no disk until an incident fires, so the
    # recorder is on by default; off = no rings, no bundles, the
    # /incident route answers 503 — bitwise-identical training and
    # byte-identical serving (pinned by test).
    blackbox: bool = True
    # Where incident bundles land; "" derives <model_file>/incidents
    # (training) or the serving checkpoint dir's incidents/ (serve).
    # Setting it with blackbox off is refused (inert-knob discipline).
    incident_dir: str = ""
    # Serve traffic capture (serve/wire.py CaptureWriter): fraction of
    # scored requests whose canonical request+response frames are
    # appended to serve_capture_file in the TFC1 container (SERVING.md
    # "Capture & replay") — replayable bit-for-bit by tools/replay.py
    # against a live endpoint.  0 = off (byte-identical serving).
    serve_capture_sample: float = 0.0
    # TFC1 capture output path; rotates to <path>.1 at 64 MiB.  With
    # --replicas N the router gives each managed replica its own
    # <path>.replicaI.  Requires serve_capture_sample > 0 and vice
    # versa (a capture file nothing samples into, or a sample rate with
    # nowhere to land, is the silently-inert-knob bug).
    serve_capture_file: str = ""

    def __post_init__(self) -> None:
        if self.vocabulary_size <= 0:
            raise ValueError("vocabulary_size must be positive")
        if self.factor_num <= 0:
            raise ValueError("factor_num must be positive")
        if self.optimizer not in ("adagrad", "ftrl", "sgd", "adam"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.loss_type not in ("logistic", "mse"):
            raise ValueError(f"unknown loss_type {self.loss_type!r}")
        if self.lookup not in ("auto", "shardmap"):
            raise ValueError(f"unknown lookup {self.lookup!r}")
        if self.l2_mode not in ("batch", "full"):
            raise ValueError(f"unknown l2_mode {self.l2_mode!r}")
        if self.sparse_apply not in ("auto", "tile", "scatter"):
            raise ValueError(f"unknown sparse_apply {self.sparse_apply!r}")
        if self.sparse_exchange not in ("auto", "dense", "entries"):
            raise ValueError(
                f"unknown sparse_exchange {self.sparse_exchange!r}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.interaction not in ("", "pallas", "jnp", "flat"):
            raise ValueError(f"unknown interaction {self.interaction!r}")
        if self.interaction_impl not in (
            "", "auto", "reference", "pallas", "packed"
        ):
            raise ValueError(
                f"unknown interaction_impl {self.interaction_impl!r} "
                "(want auto | reference | pallas | packed, or '' for "
                "the legacy interaction/use_pallas surface)"
            )
        if self.interaction_impl and self.interaction:
            # Inert-knob discipline: interaction_impl supersedes the
            # legacy knob, so a run setting both would silently ignore
            # one of them — refuse at startup instead.
            raise ValueError(
                f"interaction_impl={self.interaction_impl!r} and the "
                f"legacy interaction={self.interaction!r} are both set; "
                "interaction_impl would silently win — drop one"
            )
        if self.steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {self.steps_per_dispatch}"
            )
        if self.prefetch_super_batches < 1:
            raise ValueError(
                "prefetch_super_batches must be >= 1, got "
                f"{self.prefetch_super_batches}"
            )
        if self.parse_processes < 0:
            raise ValueError(
                f"parse_processes must be >= 0, got {self.parse_processes}"
            )
        if self.heartbeat_secs < 0:
            raise ValueError(
                f"heartbeat_secs must be >= 0, got {self.heartbeat_secs}"
            )
        if self.nan_policy not in ("warn", "halt"):
            raise ValueError(f"unknown nan_policy {self.nan_policy!r}")
        if not 0 <= self.status_port < 65536:
            raise ValueError(
                f"status_port must be in [0, 65535], got {self.status_port}"
            )
        if self.quality_window < 32:
            # 32 == obs.quality._MIN_PSI_EXAMPLES (pinned equal by
            # test): below it no window ever reaches judgeable mass,
            # so the PSI drift signals would silently never appear —
            # the inert-knob hazard, failed loudly at startup instead.
            raise ValueError(
                "quality_window must be >= 32 (windows below the "
                "minimum judgeable mass would silently disable the "
                f"PSI drift signals), got {self.quality_window}"
            )
        if self.trace_rotate_events < 0:
            raise ValueError(
                "trace_rotate_events must be >= 0, got "
                f"{self.trace_rotate_events}"
            )
        if self.trace_rotate_events and not self.trace_file:
            raise ValueError(
                "trace_rotate_events requires trace_file (it is a "
                "storage policy of the trace output)"
            )
        if self.train_fleet_scrape:
            # The aggregator scrapes on the heartbeat cadence and its
            # `fleet` block rides the heartbeat-shaped records; with
            # no heartbeat the plane would be configured but silently
            # dead — same inertness rule as alert_rules below.
            if self.heartbeat_secs <= 0:
                raise ValueError(
                    "train_fleet_scrape requires heartbeat_secs > 0 "
                    "(rank 0 scrapes the fleet on the heartbeat "
                    "cadence; without one the plane would never run)"
                )
            for target in self.train_fleet_scrape.split(","):
                target = target.strip()
                if not target:
                    continue
                host, sep, port = target.rpartition(":")
                if not sep or not host or not port.isdigit() \
                        or not 0 < int(port) < 65536:
                    raise ValueError(
                        "train_fleet_scrape targets must be host:port "
                        f"pairs, got {target!r}"
                    )
        if self.alert_rules and self.heartbeat_secs <= 0:
            # The watchdog rides the heartbeat thread: rules without a
            # heartbeat would NEVER evaluate.  Fail at startup, as the
            # reference config does.
            raise ValueError(
                "alert_rules requires heartbeat_secs > 0 (the "
                "watchdog evaluates rules on the heartbeat "
                "thread; without one no rule would ever fire)"
            )
        if not 0 <= self.serve_port < 65536:
            raise ValueError(
                f"serve_port must be in [0, 65535], got {self.serve_port}"
            )
        if self.max_batch_wait_ms < 0:
            raise ValueError(
                "max_batch_wait_ms must be >= 0, got "
                f"{self.max_batch_wait_ms}"
            )
        if self.serve_poll_secs < 0:
            raise ValueError(
                f"serve_poll_secs must be >= 0, got {self.serve_poll_secs}"
            )
        if self.serve_replicas < 0:
            raise ValueError(
                f"serve_replicas must be >= 0, got {self.serve_replicas}"
            )
        if self.serve_shed_deadline_ms < 0:
            raise ValueError(
                "serve_shed_deadline_ms must be >= 0, got "
                f"{self.serve_shed_deadline_ms}"
            )
        if self.serve_transport not in ("text", "bin", "both"):
            raise ValueError(
                f"unknown serve_transport {self.serve_transport!r}"
            )
        if self.serve_canary and self.serve_replicas < 2:
            # The silently-inert-knob discipline (same as cold_dtype /
            # alert_rules): canary promotion shadow-compares one
            # replica against another, so without a >= 2-replica fleet
            # the knob could never do anything.
            raise ValueError(
                "serve_canary requires serve_replicas >= 2 (promotion "
                "shadow-scores the canary against a baseline replica)"
            )
        if not 0.0 <= self.serve_trace_sample <= 1.0:
            raise ValueError(
                "serve_trace_sample must be in [0, 1], got "
                f"{self.serve_trace_sample}"
            )
        if self.serve_trace_sample > 0 and not self.trace_file:
            # The silently-inert-knob discipline: a sampled request's
            # span chain needs a trace file to land in; without one the
            # knob could never do anything.
            raise ValueError(
                "serve_trace_sample > 0 requires trace_file (sampled "
                "request chains are written to the trace output)"
            )
        if not 0.0 <= self.serve_capture_sample <= 1.0:
            raise ValueError(
                "serve_capture_sample must be in [0, 1], got "
                f"{self.serve_capture_sample}"
            )
        if self.serve_capture_sample > 0 and not self.serve_capture_file:
            # The silently-inert-knob discipline: sampled captures need
            # a file to land in.
            raise ValueError(
                "serve_capture_sample > 0 requires serve_capture_file "
                "(captured request/response frames are appended there)"
            )
        if self.serve_capture_file and self.serve_capture_sample <= 0:
            raise ValueError(
                "serve_capture_file is set but serve_capture_sample is "
                "0 — nothing would ever be captured; set a sample rate "
                "or drop the file"
            )
        if self.incident_dir and not self.blackbox:
            raise ValueError(
                "incident_dir is set but blackbox is off — no incident "
                "bundle could ever land there; enable blackbox or drop "
                "incident_dir"
            )
        if self.serve_slo_p99_ms < 0:
            raise ValueError(
                "serve_slo_p99_ms must be >= 0, got "
                f"{self.serve_slo_p99_ms}"
            )
        if not 0.0 <= self.serve_slo_availability < 1.0:
            raise ValueError(
                "serve_slo_availability must be in [0, 1) — it is the "
                "fraction of requests the SLO promises (0 = off), got "
                f"{self.serve_slo_availability}"
            )
        if self.serve_canary and self.serve_poll_secs <= 0:
            # Same hazard one knob over: the router's canary watcher
            # polls the manifest at serve_poll_secs, so 0 means no
            # promotion could ever start.
            raise ValueError(
                "serve_canary requires serve_poll_secs > 0 (the "
                "router's promotion watcher polls the manifest at "
                "that cadence)"
            )
        if self.serve_parse_mode not in ("vec", "legacy"):
            raise ValueError(
                f"unknown serve_parse_mode {self.serve_parse_mode!r} "
                "(expected 'vec' or 'legacy')"
            )
        if self.serve_http_threads < 0:
            raise ValueError(
                "serve_http_threads must be >= 0 (0 = thread-per-"
                f"connection), got {self.serve_http_threads}"
            )
        if self.serve_http_acceptors < 1:
            raise ValueError(
                "serve_http_acceptors must be >= 1, got "
                f"{self.serve_http_acceptors}"
            )
        if self.serve_http_acceptors > 1 and self.serve_http_threads == 0:
            # The silently-inert-knob discipline: extra accept loops
            # only exist in the pooled front end; with the pool off the
            # knob could never do anything.
            raise ValueError(
                "serve_http_acceptors > 1 requires serve_http_threads "
                "> 0 (extra accept loops feed the pooled front end)"
            )
        self.serve_ladder  # parse/validate serve_batch_sizes at startup
        if self.cache_max_bytes <= 0:
            raise ValueError(
                f"cache_max_bytes must be positive, got {self.cache_max_bytes}"
            )
        if self.ring_slots < 0:
            raise ValueError(
                f"ring_slots must be >= 0, got {self.ring_slots}"
            )
        if self.table_tiering not in ("off", "on"):
            raise ValueError(
                f"unknown table_tiering {self.table_tiering!r}"
            )
        if self.hot_rows < 1:
            raise ValueError(f"hot_rows must be >= 1, got {self.hot_rows}")
        if self.cold_dtype not in ("fp32", "bf16", "int8"):
            raise ValueError(f"unknown cold_dtype {self.cold_dtype!r}")
        if self.serve_table_dtype not in ("fp32", "bf16", "int8"):
            raise ValueError(
                f"unknown serve_table_dtype {self.serve_table_dtype!r}"
            )
        if self.quant_chunk < 0:
            raise ValueError(
                f"quant_chunk must be >= 0, got {self.quant_chunk}"
            )
        if self.sparse_exchange_overlap not in ("auto", "on", "off"):
            raise ValueError(
                "unknown sparse_exchange_overlap "
                f"{self.sparse_exchange_overlap!r}"
            )
        if self.sparse_exchange_overlap == "on" \
                and self.sparse_exchange == "dense":
            # Inert-knob discipline: the overlap double-buffers the
            # ENTRIES exchange's id plane; under the dense psum there
            # is no id plane to prefetch.  (The remaining "on"
            # requirements — sharded apply, multi-shard data axis —
            # need the mesh and are enforced at Trainer build.)
            raise ValueError(
                "sparse_exchange_overlap=on requires the entries "
                "exchange; sparse_exchange=dense has no id plane to "
                "overlap"
            )
        if self.tiered_partition not in ("auto", "global", "shards"):
            raise ValueError(
                f"unknown tiered_partition {self.tiered_partition!r}"
            )
        if self.tiered_partition != "auto" and self.table_tiering != "on":
            # tiered_partition names how the tiered table's ownership
            # splits across ranks; without tiering there is nothing to
            # partition (silently-inert-knob discipline).
            raise ValueError(
                "tiered_partition requires table_tiering=on (it "
                "partitions the tiered table's hot-slot ownership)"
            )
        if self.cold_dtype != "fp32" and self.table_tiering != "on":
            # The silently-inert-knob hazard (same discipline as
            # alert_rules-without-heartbeat): cold_dtype names the
            # tiered cold store's storage format, and without tiering
            # there is no cold store for it to apply to.
            raise ValueError(
                "cold_dtype != fp32 requires table_tiering=on (it is "
                "the storage dtype of the tiered cold store)"
            )
        if self.cache_prestacked and not self.cache_epochs:
            raise ValueError(
                "cache_prestacked requires cache_epochs (it is a storage "
                "format of the epoch cache)"
            )
        if self.weight_files and len(self.weight_files) != len(self.train_files):
            raise ValueError(
                "weight_files must parallel train_files "
                f"({len(self.weight_files)} vs {len(self.train_files)})"
            )

    @property
    def serve_ladder(self) -> tuple:
        """``serve_batch_sizes`` parsed into an ascending tuple of
        unique positive ints (the serving microbatch shape ladder)."""
        try:
            sizes = tuple(sorted({
                int(p) for p in self.serve_batch_sizes.split(",")
                if p.strip()
            }))
        except ValueError:
            raise ValueError(
                "serve_batch_sizes must be comma-separated ints, got "
                f"{self.serve_batch_sizes!r}"
            ) from None
        if not sizes or any(s <= 0 for s in sizes):
            raise ValueError(
                "serve_batch_sizes needs at least one positive size, "
                f"got {self.serve_batch_sizes!r}"
            )
        return sizes

    @property
    def embedding_dim(self) -> int:
        """Width of one table row: 1 linear weight + factor vector(s)."""
        k = self.factor_num
        return 1 + (k * self.field_num if self.field_num else k)


# INI key -> (dataclass field, parser).  Keys match the reference cfg surface
# (SURVEY.md §2 #12); dotted keys like ``adagrad.initial_accumulator`` are the
# reference spelling.
_KEYMAP = {
    "vocabulary_size": ("vocabulary_size", int),
    "vocabulary_block_num": ("vocabulary_block_num", int),
    "hash_feature_id": ("hash_feature_id", _parse_bool),
    "factor_num": ("factor_num", int),
    "field_num": ("field_num", int),
    "model_file": ("model_file", str),
    "log_file": ("log_file", str),
    "train_files": ("train_files", _parse_files),
    "weight_files": ("weight_files", _parse_files),
    "validation_files": ("validation_files", _parse_files),
    "epoch_num": ("epoch_num", int),
    "batch_size": ("batch_size", int),
    "learning_rate": ("learning_rate", float),
    "adagrad.initial_accumulator": ("adagrad_initial_accumulator", float),
    "adagrad_initial_accumulator": ("adagrad_initial_accumulator", float),
    "optimizer": ("optimizer", str),
    "loss_type": ("loss_type", str),
    "factor_lambda": ("factor_lambda", float),
    "bias_lambda": ("bias_lambda", float),
    "ftrl.l1": ("ftrl_l1", float),
    "ftrl.l2": ("ftrl_l2", float),
    "ftrl.beta": ("ftrl_beta", float),
    "ftrl_l1": ("ftrl_l1", float),
    "ftrl_l2": ("ftrl_l2", float),
    "ftrl_beta": ("ftrl_beta", float),
    "init_value_range": ("init_value_range", float),
    "thread_num": ("thread_num", int),
    "queue_size": ("queue_size", int),
    "shuffle_threads": ("shuffle_threads", int),
    "shuffle_buffer": ("shuffle_buffer", int),
    "save_steps": ("save_steps", int),
    "log_steps": ("log_steps", int),
    "validation_steps": ("validation_steps", int),
    "seed": ("seed", int),
    "predict_files": ("predict_files", _parse_files),
    "score_path": ("score_path", str),
    "serve_port": ("serve_port", int),
    "serve_host": ("serve_host", str),
    "serve_batch_sizes": ("serve_batch_sizes", str),
    "max_batch_wait_ms": ("max_batch_wait_ms", float),
    "serve_poll_secs": ("serve_poll_secs", float),
    "serve_replicas": ("serve_replicas", int),
    "serve_shed_deadline_ms": ("serve_shed_deadline_ms", float),
    "serve_canary": ("serve_canary", _parse_bool),
    "serve_transport": ("serve_transport", str),
    "serve_trace_sample": ("serve_trace_sample", float),
    "serve_slo_p99_ms": ("serve_slo_p99_ms", float),
    "serve_slo_availability": ("serve_slo_availability", float),
    "serve_parse_mode": ("serve_parse_mode", str),
    "serve_http_threads": ("serve_http_threads", int),
    "serve_http_acceptors": ("serve_http_acceptors", int),
    "profile_dir": ("profile_dir", str),
    "profile_start_step": ("profile_start_step", int),
    "profile_steps": ("profile_steps", int),
    "metrics_file": ("metrics_file", str),
    "telemetry": ("telemetry", _parse_bool),
    "heartbeat_secs": ("heartbeat_secs", float),
    "trace_file": ("trace_file", str),
    "nan_policy": ("nan_policy", str),
    "status_port": ("status_port", int),
    "status_host": ("status_host", str),
    "alert_rules": ("alert_rules", str),
    "resource_metrics": ("resource_metrics", _parse_bool),
    "quality": ("quality", _parse_bool),
    "quality_window": ("quality_window", int),
    "trace_rotate_events": ("trace_rotate_events", int),
    "train_fleet_scrape": ("train_fleet_scrape", str),
    "max_features": ("max_features", int),
    "mesh_data": ("mesh_data", int),
    "mesh_model": ("mesh_model", int),
    "lookup": ("lookup", str),
    "compute_dtype": ("compute_dtype", str),
    "use_pallas": ("use_pallas", _parse_bool),
    "interaction": ("interaction", str),
    "interaction_impl": ("interaction_impl", str),
    "compile_cache_dir": ("compile_cache_dir", str),
    "sparse_update": ("sparse_update", _parse_bool),
    "sparse_apply": ("sparse_apply", str),
    "fast_ingest": ("fast_ingest", _parse_bool),
    "host_sort": ("host_sort", _parse_bool),
    "l2_mode": ("l2_mode", str),
    "sparse_exchange": ("sparse_exchange", str),
    "sparse_exchange_overlap": ("sparse_exchange_overlap", str),
    "tiered_partition": ("tiered_partition", str),
    "steps_per_dispatch": ("steps_per_dispatch", int),
    "prefetch_super_batches": ("prefetch_super_batches", int),
    "parse_processes": ("parse_processes", int),
    "cache_epochs": ("cache_epochs", _parse_bool),
    "cache_max_bytes": ("cache_max_bytes", int),
    "cache_prestacked": ("cache_prestacked", _parse_bool),
    "ring_slots": ("ring_slots", int),
    "table_tiering": ("table_tiering", str),
    "hot_rows": ("hot_rows", int),
    "cold_dtype": ("cold_dtype", str),
    "serve_table_dtype": ("serve_table_dtype", str),
    "quant_chunk": ("quant_chunk", int),
    "blackbox": ("blackbox", _parse_bool),
    "incident_dir": ("incident_dir", str),
    "serve_capture_sample": ("serve_capture_sample", float),
    "serve_capture_file": ("serve_capture_file", str),
}


def load_config(path: str, overrides: Optional[dict] = None) -> FmConfig:
    """Load an INI ``.cfg`` file (reference-compatible) into an FmConfig."""
    parser = configparser.ConfigParser()
    read = parser.read(path)
    if not read:
        raise FileNotFoundError(path)
    values: dict = {}
    for section in parser.sections():
        for key, raw in parser.items(section):
            key = key.strip().lower()
            if key not in _KEYMAP:
                log.warning("ignoring unknown config key [%s] %s", section, key)
                continue
            field, fn = _KEYMAP[key]
            values[field] = fn(raw)
    if overrides:
        values.update(overrides)
    return FmConfig(**values)
