"""CLI: ``python -m fast_tffm_tpu_torch.cli train|predict|serve <cfg>`` —
the PyTorch port's entry point, taking the same INI files as
``run_tffm.py``.

``train`` runs the trainer (``train/loop.py``: the sparse step, or the
dense optax path for ``sparse_update = false``, Adam or ``l2_mode =
full``) and prints its train and validation metrics; ``predict`` writes
one score per line of ``predict_files`` to ``score_path``; ``serve``
starts the scoring endpoint, and ``serve --replicas N`` (N >= 2) a
fleet of N replica processes behind the power-of-two-choices router
(``serve/router.py``; the router process imports no torch).
``predict`` and ``serve`` read ``params.npz``, ``quant.npz``
(``--serve_table_dtype bf16|int8``) or a ``tiered.npz`` overlay; the
checkpoints convert with ``python -m
fast_tffm_tpu_torch.tools.convert_checkpoint``.  Runs on the GPU unless
``--device cpu`` is given.

Multi-rank training: every rank runs the same ``train`` command with
``--coordinator host:port --num_processes N --process_id R`` (or the
reference's legacy ``--worker_hosts/--task_index``; ``--job_name=ps``
exits with a notice), which joins the rank group (``train/dist.py``)
before the trainer starts on the config's ``mesh_data x mesh_model``
mesh.
"""

from __future__ import annotations

import argparse
import logging
import sys

__all__ = ["build_argparser", "main"]

log = logging.getLogger(__name__)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fast_tffm_tpu_torch.cli",
        description="factorization machine training and scoring on an "
                    "NVIDIA GPU (PyTorch/CUDA)",
    )
    p.add_argument("mode", choices=["train", "predict", "serve"])
    p.add_argument("cfg", help="INI config file (same format as run_tffm.py)")
    p.add_argument(
        "--device", default=None, choices=["cuda", "cpu"],
        help="device to run on (default cuda; a host without a GPU "
             "needs --device cpu)",
    )
    p.add_argument(
        "--serve_port", type=int, default=None,
        help="HTTP scoring endpoint port (0 = OS-assigned, printed at "
             "startup)",
    )
    p.add_argument(
        "--serve_host", default=None, metavar="ADDR",
        help="bind address for --serve_port (default 127.0.0.1; the "
             "endpoint is unauthenticated, 0.0.0.0 is an explicit "
             "opt-in)",
    )
    p.add_argument(
        "--replicas", type=int, default=None, dest="serve_replicas",
        help="serve mode: run N shared-nothing replica serve processes "
             "behind a power-of-two-choices router on --serve_port "
             "(0/1 = the single-process server)",
    )
    p.add_argument(
        "--serve_shed_deadline_ms", type=float, default=None,
        help="router admission budget: shed with a fast 429 when the "
             "projected queue delay exceeds this many ms (0 = admit "
             "everything)",
    )
    p.add_argument(
        "--serve_canary", action="store_true", default=None,
        help="canary checkpoint promotion: the router reloads ONE "
             "replica on a new manifest, shadow-compares its score "
             "distribution against a baseline replica (python -m "
             "fast_tffm_tpu_torch.tools.report --compare), and only then "
             "promotes the fleet (requires --replicas >= 2)",
    )
    p.add_argument(
        "--no_serve_canary", action="store_true",
        help="force canary promotion OFF regardless of the cfg file "
             "(the fleet launcher passes this to every replica so an "
             "INI-configured canary fleet doesn't trip each child's "
             "serve_canary-requires-a-fleet validation)",
    )
    p.add_argument(
        "--serve_capture_sample", type=float, default=None,
        help="serve mode: append this fraction of scored requests "
             "(request + response as canonical binary frames) to "
             "--serve_capture_file for replay (python -m "
             "fast_tffm_tpu_torch.tools.replay; 0 = off)",
    )
    p.add_argument(
        "--serve_capture_file", default=None, metavar="PATH",
        help="TFC1 capture output path for --serve_capture_sample "
             "(rotates to PATH.1 at 64 MiB; a fleet gives each replica "
             "PATH.replicaN)",
    )
    p.add_argument(
        "--serve_slo_p99_ms", type=float, default=None,
        help="serving SLO latency objective: a completed request "
             "slower than this many ms counts against the error "
             "budget (0 = latency not in the SLO)",
    )
    p.add_argument(
        "--serve_slo_availability", type=float, default=None,
        help="serving SLO availability objective (e.g. 0.999): "
             "defines the error budget the rolling burn_rate divides "
             "by (0 = no burn-rate accounting)",
    )
    # Dispatch, transfer and ingest knobs (override the cfg file; the
    # INI keys of the same name are the durable spelling).
    p.add_argument(
        "--steps_per_dispatch", type=int, default=None,
        help="train K batches per dispatch: one CUDA graph replay of the "
             "K steps on the GPU (1 = one batch a dispatch)",
    )
    p.add_argument(
        "--prefetch_super_batches", type=int, default=None,
        help="shipped super-batches the transfer stage keeps in flight",
    )
    p.add_argument(
        "--parse_processes", type=int, default=None,
        help="parse in this many spawned worker processes (GIL-free) "
             "instead of thread_num in-process threads (0 = threads)",
    )
    p.add_argument(
        "--cache_epochs", action="store_true", default=None,
        help="parse epoch 0 once and replay later epochs from a host-"
             "memory batch cache (multi-epoch runs whose parsed data "
             "fits in cache_max_bytes)",
    )
    p.add_argument(
        "--cache_max_bytes", type=int, default=None,
        help="byte budget for the epoch cache; overflowing falls back "
             "to re-parsing later epochs",
    )
    p.add_argument(
        "--cache_prestacked", action="store_true", default=None,
        help="store the epoch cache as packed groups of K batches "
             "(packed once; replay epochs ship them with no fill) — "
             "requires --cache_epochs",
    )
    p.add_argument(
        "--ring_slots", type=int, default=None,
        help="inbound shared-memory ring slots for parse_processes "
             "(raw windows parsed in place; 0 = pickle windows over "
             "the worker queue)",
    )
    # Observability knobs (override the cfg file).
    p.add_argument(
        "--heartbeat_secs", type=float, default=None,
        help="emit a structured telemetry heartbeat (JSONL record into "
             "metrics_file + one-line log summary with ingest_wait_frac) "
             "every N seconds (0 = off)",
    )
    p.add_argument(
        "--no_telemetry", action="store_true",
        help="disable the run-wide telemetry layer entirely (no-op "
             "instruments; heartbeats report nothing)",
    )
    p.add_argument(
        "--trace", nargs="?", const="./tffm_trace.json", default=None,
        metavar="PATH", dest="trace_file",
        help="Chrome-trace span file (accepted; the port does not write "
             "it yet)",
    )
    p.add_argument(
        "--nan_policy", choices=["warn", "halt"], default=None,
        help="on a non-finite (NaN/inf) gradient: warn and keep "
             "counting, or halt without overwriting the checkpoint",
    )
    p.add_argument(
        "--status_port", type=int, default=None,
        help="serve a live status endpoint on this port while training: "
             "/metrics (Prometheus text of the telemetry snapshot and the "
             "health block) and /status (the heartbeat JSON record on "
             "demand); read-only, off the hot path (0 = off)",
    )
    p.add_argument(
        "--status_host", default=None, metavar="ADDR",
        help="bind address for --status_port (default 127.0.0.1; the "
             "endpoint is unauthenticated, so 0.0.0.0 — serving a "
             "remote Prometheus — is an explicit opt-in)",
    )
    p.add_argument(
        "--alert_rules", default=None, metavar="RULES",
        help="alert watchdog rules riding the heartbeat, e.g. "
             "'ingest_wait_frac > 0.5 for 3 : warn; "
             "grad_norm_drift > 10 : halt' — breaches emit "
             "`record: alert` JSONL entries; halt stops the run "
             "without overwriting the checkpoint",
    )
    p.add_argument(
        "--train_fleet_scrape", default=None, metavar="H:P,H:P,...",
        help="training-fleet scrape targets (accepted; the port does "
             "not run the fleet plane yet)",
    )
    p.add_argument(
        "--no_quality", action="store_true",
        help="disable the model-quality & data-drift plane (the port "
             "does not run it yet)",
    )
    p.add_argument(
        "--quality_window", type=int, default=None,
        help="examples per quality window (accepted; the port does not "
             "run the quality plane yet)",
    )
    p.add_argument(
        "--no_resource_metrics", action="store_true",
        help="disable the resource block (RSS, open files, uptime) of "
             "the heartbeat, status and final records",
    )
    p.add_argument(
        "--no_blackbox", action="store_true",
        help="disable the incident flight recorder (the port does not "
             "run it yet)",
    )
    p.add_argument(
        "--incident_dir", default=None, metavar="DIR",
        help="where incident bundles land (accepted; the port does not "
             "run the flight recorder yet)",
    )
    p.add_argument(
        "--trace_rotate_events", type=int, default=None,
        help="rotate the trace every N events (accepted; the port does "
             "not write the trace yet)",
    )
    p.add_argument(
        "--metrics_file", default=None, metavar="PATH",
        help="JSONL metrics stream path (overrides the cfg; a rank > 0 "
             "writes PATH.rankN, a multi-replica fleet suffixes each "
             "replica's stream .replicaN)",
    )
    p.add_argument(
        "--interaction_impl", default=None,
        choices=["auto", "reference", "pallas", "packed"],
        help="interaction path for the FM hot loop: 'auto' measures "
             "the candidates at this run's shapes and promotes the "
             "fastest that matches reference (decision cached in "
             "autotune_cache.json); a named impl pins it with no "
             "measurement ('pallas': the FmScorer/FmGrad kernels)",
    )
    p.add_argument(
        "--compile_cache_dir", default=None, metavar="DIR",
        help="persistent compilation cache directory (accepted; the "
             "port builds its kernels once per checkout)",
    )
    # Serving front-end knobs.
    p.add_argument(
        "--serve_transport", choices=["text", "bin", "both"],
        default=None,
        help="request transports the scoring endpoints accept: libsvm "
             "text (POST /score), the binary frame (POST /score_bin), "
             "or both",
    )
    p.add_argument(
        "--serve_trace_sample", type=float, default=None,
        help="fraction of requests traced (accepted; the port does not "
             "trace requests yet)",
    )
    p.add_argument(
        "--serve_parse_mode", choices=["vec", "legacy"], default=None,
        help="POST /score text-parse engine: the vectorized batch "
             "parser (default) or the per-line legacy loop (both "
             "bitwise-identical)",
    )
    p.add_argument(
        "--serve_http_threads", type=int, default=None,
        help="HTTP front-end worker pool size for the scoring "
             "endpoints (0 = thread-per-connection mode); size >= "
             "expected concurrent kept-alive connections",
    )
    p.add_argument(
        "--serve_http_acceptors", type=int, default=None,
        help="accept loops for the pooled front end (>1 uses "
             "SO_REUSEPORT listeners when the kernel supports it, "
             "shared-socket fallback otherwise)",
    )
    p.add_argument(
        "--serve_batch_sizes", default=None, metavar="N,N,...",
        help="fixed microbatch shape ladder (example counts) requests "
             "pad/coalesce into",
    )
    p.add_argument(
        "--max_batch_wait_ms", type=float, default=None,
        help="request-coalescing deadline: dispatch a microbatch when "
             "the largest rung fills or this many ms pass",
    )
    p.add_argument(
        "--serve_poll_secs", type=float, default=None,
        help="checkpoint hot-swap poll period in seconds (serve: the "
             "watcher swaps in each save that publishes "
             "serve_manifest.json; 0 serves the startup checkpoint only)",
    )
    # Table formats (override the cfg file; see ops/quant.py).
    p.add_argument(
        "--serve_table_dtype", choices=["fp32", "bf16", "int8"],
        default=None,
        help="device-resident serving-table dtype (serve and predict): "
             "bf16 halves and int8 (with per-chunk fp32 scales) quarters "
             "the table's bytes; an fp32 checkpoint is quantized at "
             "placement, a quant.npz must already be in this dtype",
    )
    p.add_argument(
        "--quant_chunk", type=int, default=None,
        help="int8 scale granularity for dense quantized tables: this "
             "many consecutive rows share one fp32 scale (0 = one "
             "scale per row)",
    )
    p.add_argument(
        "--table_tiering", choices=["off", "on"], default=None,
        help="two-tier embedding table: train keeps --hot_rows rows on "
             "the device over a host cold store of the full vocabulary "
             "(sparse optimizers only); serve and predict read a "
             "tiered.npz overlay whatever this says",
    )
    p.add_argument(
        "--hot_rows", type=int, default=None,
        help="device-resident rows when --table_tiering on (must cover "
             "one super-batch's unique ids)",
    )
    p.add_argument(
        "--tiered_partition", choices=["auto", "global", "shards"],
        default=None,
        help="tier-manager ownership: global (one host-global manager, "
             "what a single process runs) or shards (one per model "
             "column, on a 1 x R rank mesh); auto = shards on more than "
             "one rank, else global",
    )
    p.add_argument(
        "--cold_dtype", choices=["fp32", "bf16", "int8"], default=None,
        help="storage dtype of the tiered cold store's rows (requires "
             "--table_tiering on): bf16 halves and int8 (per-row scale) "
             "quarters the host bytes; the trainer stores its cold rows "
             "in it, and serve/predict need the dtype the tiered.npz "
             "overlay was written in",
    )
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address of a multi-rank run (rank 0's "
                        "host); every rank passes the same one")
    p.add_argument("--num_processes", type=int, default=None,
                   help="number of ranks of a multi-rank run")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank in [0, num_processes)")
    # Legacy reference flags, mapped as the JAX package's CLI maps them.
    p.add_argument("--ps_hosts", default=None, help="legacy; ps tasks exit")
    p.add_argument("--worker_hosts", default=None,
                   help="legacy; maps to --num_processes")
    p.add_argument("--job_name", default=None, choices=[None, "ps", "worker"])
    p.add_argument("--task_index", type=int, default=None,
                   help="legacy; maps to --process_id")
    return p


def _resolve_dist(args):
    """``(coordinator, num_processes, process_id)`` from the new or the
    legacy flags, None for a single-process run; a ps task exits 0."""
    if args.job_name == "ps":
        log.warning(
            "parameter-server tasks are obsolete: the table is row-sharded "
            "across the ranks. This ps task exits; remove ps entries from "
            "your launch scripts."
        )
        sys.exit(0)
    if args.coordinator is not None:
        if args.num_processes is None or args.process_id is None:
            raise SystemExit(
                "--coordinator requires --num_processes and --process_id"
            )
        return args.coordinator, args.num_processes, args.process_id
    if args.worker_hosts is not None:
        workers = [h for h in args.worker_hosts.split(",") if h]
        task = args.task_index or 0
        coordinator = workers[0]
        log.warning(
            "legacy --worker_hosts mapped to a multi-rank run: "
            "coordinator=%s num_processes=%d process_id=%d",
            coordinator, len(workers), task,
        )
        return coordinator, len(workers), task
    return None


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from fast_tffm_tpu_torch.config import load_config

    overrides = {
        key: getattr(args, key)
        for key in ("steps_per_dispatch", "prefetch_super_batches",
                    "parse_processes", "cache_epochs", "cache_max_bytes",
                    "cache_prestacked", "ring_slots", "heartbeat_secs",
                    "trace_file", "nan_policy", "table_tiering", "hot_rows",
                    "tiered_partition", "cold_dtype", "serve_table_dtype",
                    "quant_chunk", "status_port", "status_host",
                    "alert_rules", "train_fleet_scrape",
                    "trace_rotate_events", "serve_port", "serve_host",
                    "serve_batch_sizes", "max_batch_wait_ms",
                    "serve_poll_secs", "serve_replicas",
                    "serve_shed_deadline_ms", "serve_canary",
                    "serve_transport", "serve_trace_sample",
                    "serve_slo_p99_ms", "serve_slo_availability",
                    "serve_parse_mode", "serve_http_threads",
                    "serve_http_acceptors", "interaction_impl",
                    "compile_cache_dir", "incident_dir",
                    "serve_capture_sample", "serve_capture_file",
                    "quality_window", "metrics_file")
        if getattr(args, key) is not None
    }
    for flag, key in (("no_telemetry", "telemetry"),
                      ("no_resource_metrics", "resource_metrics"),
                      ("no_quality", "quality"),
                      ("no_serve_canary", "serve_canary"),
                      ("no_blackbox", "blackbox")):
        if getattr(args, flag):
            overrides[key] = False
    cfg = load_config(args.cfg, overrides or None)
    handlers = [logging.StreamHandler(sys.stderr)]
    if cfg.log_file:
        handlers.append(logging.FileHandler(cfg.log_file))
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        handlers=handlers, force=True,
    )
    dist = _resolve_dist(args)
    if dist is not None and args.mode == "predict":
        # As the JAX package's predict refuses a multi-process run.
        raise NotImplementedError(
            "predict runs single-process; run it without the multi-rank "
            "flags: a multi-rank checkpoint is one params.npz"
        )
    if dist is not None and args.mode == "serve":
        raise NotImplementedError(
            "serving across ranks (a scorer over several devices) is "
            "ROADMAP.md port queue item 3; serve the multi-rank "
            "checkpoint (one params.npz) from a single process"
        )
    if args.mode == "train":
        from fast_tffm_tpu_torch.train.loop import Trainer

        device = args.device
        if dist is not None:
            import torch.distributed

            from fast_tffm_tpu_torch.train import dist as dist_lib

            device = dist_lib.initialize(*dist, device=args.device)
        try:
            result = Trainer(cfg, device=device).train()
        finally:
            if dist is not None:
                torch.distributed.destroy_process_group()
        loss_name = "mse" if cfg.loss_type == "mse" else "logloss"
        m = result["train"]
        print(f"train {loss_name}={m['loss']:.6f} auc={m['auc']:.4f} "
              f"ex/s={m['examples_per_sec']:.0f}")
        if "validation" in result:
            m = result["validation"]
            print(f"validation {loss_name}={m['loss']:.6f} "
                  f"auc={m['auc']:.4f}")
        return 0
    if args.mode == "predict":
        from fast_tffm_tpu_torch.train.loop import predict

        n = predict(cfg, device=args.device)
        print(f"wrote {n} scores to {cfg.score_path}")
        return 0
    if cfg.serve_replicas >= 2:
        from fast_tffm_tpu_torch.serve.router import serve_fleet

        return serve_fleet(cfg, args.cfg, overrides, device=args.device)
    from fast_tffm_tpu_torch.serve.server import serve_forever

    return serve_forever(cfg, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
