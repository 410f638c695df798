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
    # Observability planes the port does not act on yet (logged as inert
    # when set); the fleet launcher passes them to its replicas.
    p.add_argument(
        "--serve_trace_sample", type=float, default=None,
        help="fraction of requests traced (not wired in the port yet)",
    )
    p.add_argument(
        "--alert_rules", default=None, metavar="RULES",
        help="alert watchdog rules (not wired in the port yet)",
    )
    p.add_argument(
        "--metrics_file", default=None, metavar="PATH",
        help="JSONL metrics stream path (not wired in the port yet)",
    )
    p.add_argument(
        "--trace", nargs="?", const="./tffm_trace.json", default=None,
        metavar="PATH", dest="trace_file",
        help="Chrome-trace span file (not wired in the port yet)",
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
             "what a single process runs) or shards (per model column; "
             "not in the port yet); auto = global on one process",
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
        for key in ("serve_port", "serve_host", "serve_batch_sizes",
                    "max_batch_wait_ms", "serve_poll_secs",
                    "serve_replicas", "serve_shed_deadline_ms",
                    "serve_canary", "serve_capture_sample",
                    "serve_capture_file", "serve_slo_p99_ms",
                    "serve_slo_availability", "serve_trace_sample",
                    "alert_rules", "metrics_file", "trace_file",
                    "serve_table_dtype", "quant_chunk",
                    "table_tiering", "hot_rows", "tiered_partition",
                    "cold_dtype")
        if getattr(args, key) is not None
    }
    if args.no_serve_canary:
        overrides["serve_canary"] = False
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
