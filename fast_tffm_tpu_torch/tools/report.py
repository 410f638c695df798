"""Summarize a metrics stream, or ratio-diff two runs.

``python -m fast_tffm_tpu_torch.tools.report METRICS.jsonl [...]`` (the
default mode): the run header, the train and validation progression,
the alerts, and the final record's breakdown (the wall-clock split,
the data-integrity counters, the training-health block, the resource,
serve and tiered blocks, the stage timers, gauges, counters and queue
depths), or the last heartbeat of a run that died without one.  With
several streams (a fleet's ``metrics_file`` and its ``.rankN`` files)
it prints a per-rank table and the slowest rank's breakdown.

``python -m fast_tffm_tpu_torch.tools.report --compare A B [--threshold
FLOAT|KEY=FLOAT ...]``:

A and B are metrics JSONLs or bench-style JSONs (one object with a
``metric`` key, like the canary's shadow-score statistics that
``serve/router.py`` writes).  Every numeric key the two share is shown
with its ratio B/A and flagged where it moved past ``--threshold``
(default 5%) in its regressing direction: rates regress when they fall,
times and losses when they rise, and the canary's score-distribution
keys in either direction.  Exit codes: 0 within threshold, 2 when any
key regressed, 1 when the two files share no numeric key.

The PyTorch port's copy of the summary and ``--compare`` modes of the
repo's ``tools/report.py`` (the canary gate runs ``--compare``), with
the same sections, direction vocabulary, output lines and exit codes
(the header names ``torch_version`` where the repo's names
``jax_version``); the trace, timeline and incident modes are not in the
port.  Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["compare_mode", "load", "main", "parse_thresholds",
           "summary_mode"]


def _classify(rec: dict) -> str:
    """Record type, inferring for legacy streams without `record`."""
    kind = rec.get("record")
    if kind:
        return kind
    if "validation_loss" in rec:
        return "validation"
    if "loss" in rec:
        return "train"
    return "unknown"


def load(path: str) -> dict:
    """Group a JSONL file's records by type (order preserved)."""
    groups: dict = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                print(f"  ! line {lineno}: not JSON, skipped",
                      file=sys.stderr)
                continue
            groups.setdefault(_classify(rec), []).append(rec)
    return groups



# ---------------------------------------------------------------------------
# the summary of a metrics stream (the default mode)
# ---------------------------------------------------------------------------


def _fmt_rate(v: float) -> str:
    if v >= 1e6:
        return f"{v / 1e6:.2f}M"
    if v >= 1e3:
        return f"{v / 1e3:.1f}k"
    return f"{v:.0f}"


def _print_header(header: dict) -> None:
    print("run:")
    for key in (
        "mode", "model_file", "serve_batch_sizes", "max_batch_wait_ms",
        "serve_poll_secs",
        "rank", "config_fingerprint", "steps_per_dispatch", "ingest_mode",
        "fast_ingest", "cache_epochs", "cache_prestacked", "ring_slots",
        "batch_size", "epoch_num",
        "optimizer", "backend", "torch_version", "device", "mesh",
        "telemetry",
        "resource_metrics",
        "heartbeat_secs", "resume_step", "resume_epoch", "resume_skip",
    ):
        if key in header:
            print(f"  {key:20s} {header[key]}")


def _print_progress(trains: list, valids: list, limit: int) -> None:
    if trains:
        print(f"\ntrain records ({len(trains)}; showing last {limit}):")
        print(f"  {'step':>8} {'examples':>12} {'loss':>9} {'auc':>7} "
              f"{'ex/s':>9}")
        for r in trains[-limit:]:
            print(
                f"  {r.get('step', 0):>8} {r.get('examples', 0):>12.0f} "
                f"{r.get('loss', float('nan')):>9.5f} "
                f"{r.get('auc', float('nan')):>7.4f} "
                f"{_fmt_rate(r.get('examples_per_sec', 0.0)):>9}"
            )
    if valids:
        print(f"\nvalidation records ({len(valids)}; showing last {limit}):")
        for r in valids[-limit:]:
            loss = r.get("validation_loss", r.get("loss", float("nan")))
            auc = r.get("validation_auc", r.get("auc", float("nan")))
            print(f"  step {r.get('step', '?'):>8}  loss {loss:.5f}  "
                  f"auc {auc:.4f}")


def _print_breakdown(rec: dict) -> None:
    kind = rec.get("record", "final")
    wall = max(rec.get("elapsed", 0.0), 1e-9)
    wait = rec.get("wait_input_s", 0.0)
    disp = rec.get("dispatch_s", 0.0)
    other = rec.get("other_s", max(0.0, wall - wait - disp))
    frac = rec.get("ingest_wait_frac", wait / wall)
    if rec.get("exception"):
        print(f"\n  !! run DIED with {rec['exception']}: "
              f"{rec.get('exception_msg', '')}")
    # Serve streams carry no training attribution (no ingest, no
    # dispatch loop) — the serve section below is their breakdown.
    training_rec = "wait_input_s" in rec or "serve" not in rec
    if training_rec:
        print(f"\nwall-clock attribution ({kind} record, step "
              f"{rec.get('step', '?')}, {wall:.1f}s):")
        print(f"  waiting for input   {wait:>9.2f}s  "
              f"({100 * wait / wall:5.1f}%)"
              f"   <- starvation: ingest too slow")
        print(f"  dispatch            {disp:>9.2f}s  "
              f"({100 * disp / wall:5.1f}%)"
              f"   <- enqueue + device backpressure")
        print(f"  other               {other:>9.2f}s  "
              f"({100 * other / wall:5.1f}%)   <- logging/validation/save")
        verdict = (
            "INGEST-BOUND (grow thread_num/parse_processes, or "
            "cache_epochs)"
            if frac > 0.25 else "compute-bound (ingest keeps up)"
        )
        print(f"  ingest_wait_frac    {frac:>9.3f}    -> {verdict}")
    else:
        print(f"\nserving run ({kind} record, checkpoint step "
              f"{rec.get('step', '?')}, {wall:.1f}s up)")
    for key in ("truncated_features", "out_of_range_batches",
                "ingest_cache", "examples_in"):
        if key in rec:
            print(f"  {key:22s} {rec[key]}")
    health = rec.get("health") or {}
    if health:
        print("\ntraining health (scan-carry monitors):")
        for key in ("grad_norm", "grad_norm_rms", "nonfinite_steps",
                    "first_nonfinite_step", "emb_rows_touched",
                    "emb_row_occupancy", "emb_touch_events"):
            if key in health:
                print(f"  {key:22s} {health[key]}")
        if health.get("nonfinite_steps", 0):
            print("  !! non-finite gradients occurred — the model is "
                  "numerically unhealthy (see nan_policy)")
    if rec.get("trace_dropped_events"):
        print(f"\n  !! trace TRUNCATED: {rec['trace_dropped_events']} "
              "event(s) dropped at the buffer cap — chains stop mid-run")
    resource = rec.get("resource")
    if resource:
        print("\nmemory & compile (resource block):")
        for key in ("rss_mb", "peak_rss_mb", "device_bytes_in_use",
                    "device_peak_bytes", "device_bytes_est"):
            if key in resource:
                print(f"  {key:22s} {resource[key]}")
        comps = [
            (k, resource[k]) for k in (
                "ring_bytes", "staging_bytes", "cache_bytes",
                "cold_store_bytes", "trace_buffer_bytes",
            ) if resource.get(k)
        ]
        if comps:
            print("  component host-memory ledger:")
            for name, v in comps:
                print(f"    {name:20s} {v / (1 << 20):10.1f} MiB")
        for key in ("compiles", "compile_s", "recompiles_unexpected",
                    "flops_per_dispatch", "bytes_per_dispatch",
                    "arithmetic_intensity", "model_flops_per_s"):
            if key in resource:
                print(f"  {key:22s} {resource[key]}")
        if resource.get("recompiles_unexpected"):
            print("  !! UNEXPECTED recompile(s) mid-run — the input "
                  "stream changed shape under the trainer (only the "
                  "epoch-tail K' compile is whitelisted)")
    else:
        print("\nmemory & compile: n/a (stream has no resource block — "
              "pre-resource run or resource_metrics=off)")
    serve = rec.get("serve")
    if serve:
        print("\nserving (latency under load):")
        for key in ("requests", "examples", "batches", "qps",
                    "p50_ms", "p95_ms", "p99_ms", "max_ms",
                    "parse_p50_ms", "batch_fill", "swaps", "compiles",
                    "steady_compiles", "recompiles_unexpected",
                    "table_mb", "quant_error_max",
                    "shed", "shed_frac", "replicas",
                    "replicas_healthy", "evictions", "respawns",
                    "replicas_scraped", "fleet_qps", "fleet_p50_ms",
                    "fleet_p99_ms", "fleet_scrape_age_max_s",
                    "slo_bad_frac", "burn_rate"):
            if key in serve:
                print(f"  {key:22s} {serve[key]}")
        if serve.get("steady_compiles"):
            print("  !! compiles happened AFTER warmup — a request "
                  "shape escaped the serve_batch_sizes ladder (a "
                  "multi-second latency cliff on the hot path)")
        if serve.get("burn_rate", 0) > 1:
            print("  !! SLO error budget is burning faster than it "
                  "accrues (burn_rate > 1) — the fleet is out of SLO")
    else:
        print("\nserving: n/a (stream has no serve block — training "
              "run or pre-serve stream)")
    quality = rec.get("quality")
    if quality:
        print("\nquality & drift (model-quality block):")
        for key in ("examples", "window_examples", "logloss", "auc",
                    "score_mean", "label_rate", "calib_ratio",
                    "logloss_drift", "psi_values", "psi_lengths",
                    "psi_ids", "psi_scores", "psi_max",
                    "sketch_examples"):
            if key in quality:
                print(f"  {key:22s} {quality[key]}")
        if quality.get("psi_max", 0.0) > 0.25:
            print("  !! adjacent-window PSI above 0.25 — the input "
                  "distribution SHIFTED mid-run (0.1-0.25 reads as "
                  "drifting, > 0.25 as shifted)")
        calib = quality.get("calib_ratio")
        if calib is not None and not 0.8 <= calib <= 1.25:
            print("  !! calibration ratio far from 1.0 — mean "
                  "predicted rate disagrees with the observed label "
                  "rate")
    else:
        print("\nquality & drift: n/a (stream has no quality block — "
              "pre-quality run or quality=off)")
    tiered = rec.get("tiered") or {}
    if tiered:
        print("\ntiered embedding table (hot/cold migration):")
        for key in ("hot_rows", "vocab", "resident_rows", "rows_seen",
                    "hot_hit_frac", "hit_occurrences", "miss_occurrences",
                    "rows_loaded", "rows_evicted", "writeback_rows",
                    "oor_occurrences", "cold_store_bytes"):
            if key in tiered:
                print(f"  {key:22s} {tiered[key]}")
        if tiered.get("hot_hit_frac", 1.0) < 0.9:
            print("  !! hot-set hit fraction is low — the hot table is "
                  "churning; consider raising hot_rows")
    stages = rec.get("stages") or {}
    timers = stages.get("timers") or {}
    if timers:
        print("\nstage timers:")
        print(f"  {'stage':24} {'count':>8} {'total_s':>9} {'p50_ms':>8} "
              f"{'p95_ms':>8} {'max_ms':>8}")
        for name in sorted(timers):
            t = timers[name]
            print(
                f"  {name:24} {t.get('count', 0):>8} "
                f"{t.get('total_s', 0.0):>9.2f} {t.get('p50_ms', 0.0):>8.2f} "
                f"{t.get('p95_ms', 0.0):>8.2f} {t.get('max_ms', 0.0):>8.2f}"
            )
    gauges = stages.get("gauges") or {}
    if gauges:
        print("\ngauges (at snapshot time):")
        for name in sorted(gauges):
            print(f"  {name:24} {gauges[name]}")
    counters = stages.get("counters") or {}
    if counters:
        print("\ncounters:")
        for name in sorted(counters):
            print(f"  {name:24} {counters[name]}")
    depths = stages.get("depths") or {}
    depths = {k: d for k, d in depths.items() if d.get("count")}
    if depths:
        print("\nqueue depths (per put/get histogram):")
        print(f"  {'queue':24} {'events':>8} {'mean':>6} {'max':>5}  "
              f"occupancy")
        for name in sorted(depths):
            d = depths[name]
            buckets = " ".join(
                f"{k}:{v}" for k, v in (d.get("buckets") or {}).items()
            )
            print(
                f"  {name:24} {d['count']:>8} {d.get('mean', 0):>6} "
                f"{d.get('max', 0):>5}  {buckets}"
            )


def _print_alerts(alerts: list, limit: int = 8) -> None:
    """Watchdog summary: per-rule fire counts + the most recent
    alerts.  A halt rule is the headline — it is why the run stopped."""
    if not alerts:
        return
    per_rule: dict = {}
    for a in alerts:
        per_rule.setdefault(a.get("rule", "?"), []).append(a)
    n_halt = sum(1 for a in alerts if a.get("action") == "halt")
    print(f"\nalerts ({len(alerts)} fired"
          + (f", {n_halt} HALT" if n_halt else "") + "):")
    print(f"  {'rule':36} {'fires':>6} {'action':>6}  last value")
    for rule in sorted(per_rule):
        rows = per_rule[rule]
        last = rows[-1]
        print(
            f"  {rule:36} {len(rows):>6} {last.get('action', '?'):>6}  "
            f"{last.get('signal')}={last.get('value')} at step "
            f"{last.get('step')}"
        )
    for a in alerts[-limit:]:
        print(
            f"    step {a.get('step', '?'):>6}  {a.get('rule')}: "
            f"{a.get('signal')}={a.get('value')} {a.get('op')} "
            f"{a.get('threshold')} -> {a.get('action')}"
        )


def _stream_rank(groups: dict, fallback: int) -> int:
    headers = groups.get("run_header", [])
    if headers and "rank" in headers[-1]:
        return int(headers[-1]["rank"])
    return fallback


def _merge_ranks(streams: list) -> int:
    """Fleet view over per-rank metrics files: a rank attribution table
    + the slowest rank's full breakdown."""
    rows = []
    for path, groups in streams:
        rank = _stream_rank(groups, len(rows))
        final = (groups.get("final") or groups.get("heartbeat") or [None])
        rows.append((rank, path, groups, final[-1]))
    rows.sort(key=lambda r: r[0])
    print(f"merged {len(rows)} rank streams: "
          f"{', '.join(str(r[0]) for r in rows)}")
    headers = rows[0][2].get("run_header", [])
    if headers:
        _print_header(headers[-1])
        fps = {
            (r[2].get("run_header") or [{}])[-1].get("config_fingerprint")
            for r in rows
        }
        if len(fps) > 1:
            print("  ! config fingerprints DIFFER across ranks:", fps)
    print("\nper-rank attribution:")
    print(f"  {'rank':>4} {'step':>8} {'elapsed':>9} {'wait_frac':>9} "
          f"{'examples_in':>12} {'alerts':>6}  verdict")
    slowest = None
    for rank, path, groups, final in rows:
        if final is None:
            print(f"  {rank:>4} {'?':>8} {'?':>9} {'?':>9} {'?':>12} "
                  f"{'?':>6}  no final/heartbeat record ({path})")
            continue
        frac = final.get("ingest_wait_frac", 0.0)
        verdict = "ingest-bound" if frac > 0.25 else "compute-bound"
        print(
            f"  {rank:>4} {final.get('step', 0):>8} "
            f"{final.get('elapsed', 0.0):>9.1f} {frac:>9.3f} "
            f"{final.get('examples_in', 0):>12} "
            f"{len(groups.get('alert', [])):>6}  {verdict}"
        )
        if slowest is None or frac > slowest[1].get("ingest_wait_frac", 0):
            slowest = (rank, final)
    if slowest is not None:
        print(f"\nslowest rank: {slowest[0]} (the step waits for every "
              f"host — this rank sets the fleet's pace)")
        _print_breakdown(slowest[1])
    return 0


# ---------------------------------------------------------------------------
# --compare: ratio-diff two runs (metrics JSONLs or bench JSONs)
# ---------------------------------------------------------------------------

# Direction heuristics: which way is a regression?  Rates and hit
# fractions regress when they FALL; times, losses, waits, drops regress
# when they RISE.  Anything unclassified is shown without a flag.
_HIGHER_BETTER = (
    "_per_sec", "_frac", "vs_baseline", "_vs_step_only", "value",
    "examples", "auc", "steps",
)
_LOWER_BETTER = (
    "_ms", "_s", "loss", "logloss", "mse", "ingest_wait_frac",
    "truncated_features", "out_of_range_batches", "nonfinite_steps",
    "elapsed", "dispatch_overhead",
)
# Keys where the heuristic suffixes collide or mislead.
_DIRECTION_OVERRIDES = {
    "ingest_wait_frac": "low", "wait_input_s": "low",
    "telemetry_on_vs_off": None, "trace_overhead": "low",
    "ring_zero_copy_frac": "high", "prestack_hit_frac": "high",
    "h2d_overlap_frac": "high",
    # Tiered table: a FALLING hot-set hit fraction is the regression
    # (the *_frac rise-is-bad heuristic points the wrong way here).
    "tiered.hot_hit_frac": "high",
    "tiered.rows_evicted": None, "tiered.rows_loaded": None,
    "trace_dropped_events": "low",
    # Live observability plane: endpoint overhead is a cost ratio
    # (off/on, like trace_overhead — rising means the endpoint slows
    # training); rotated windows are informational; a run that starts
    # ALERTING regressed even when its rates held.
    "status_endpoint_overhead": "low",
    "trace_windows": None,
    "alerts_total": "low", "alerts_halt": "low",
    # Resource plane: memory footprints and compile costs
    # regress when they RISE; sustained device FLOP/s regresses when
    # it FALLS; the resource_overhead probe is a cost ratio like the
    # telemetry/trace/status ones.  Bare spellings gate bench JSONs,
    # `resource.`-prefixed ones the flattened metrics-stream block.
    "peak_rss_mb": "low", "resource.peak_rss_mb": "low",
    "rss_mb": None, "resource.rss_mb": None,
    "compile_s": "low", "resource.compile_s": "low",
    "recompiles_unexpected": "low",
    "resource.recompiles_unexpected": "low",
    "model_flops_per_s": "high", "resource.model_flops_per_s": "high",
    "resource.compiles": None,
    "resource_overhead": "low",
    # Serving path: tail latency regresses when it RISES (the
    # _ms suffix already says so; bench keys listed for clarity),
    # throughput and batch fill when they FALL; any compile after
    # warmup is a latency cliff.  Bare spellings gate bench JSONs,
    # `serve.`-prefixed ones the flattened metrics-stream block.
    "serve_p50_ms": "low", "serve_p99_ms": "low",
    "serve_qps": "high", "serve.qps": "high",
    "serve_batch_fill": "high", "serve.batch_fill": "high",
    "serve_steady_compiles": "low", "serve.steady_compiles": "low",
    "serve.recompiles_unexpected": "low",
    "serve.requests": None, "serve.swaps": None, "serve.compiles": None,
    # Quantized tables: table bytes regress when they RISE
    # (compactness is the feature), quant error when it RISES (served
    # scores drifting from fp32), and the quantized step-rate fraction
    # (dtype rate / fp32 rate at the bench tiered config) when it
    # FALLS — quantization must buy bytes, not cost throughput.  The
    # per-section _frac/_mb spellings need overrides because the
    # suffix heuristics miss or misread them.
    "serve_table_mb": "low", "serve.table_mb": "low",
    "serve_quant_error_max_int8": "low", "serve.quant_error_max": "low",
    "quant_table_bytes_frac_bf16": "low",
    "quant_table_bytes_frac_int8": "low",
    "quant_step_rate_frac_bf16": "high",
    "quant_step_rate_frac_int8": "high",
    # Scale-out serving: router throughput regresses when it
    # FALLS, router tail latency / shed fraction / binary-decode cost
    # when they RISE (shed_frac is measured under the bench's fixed
    # 4x-offered-load burst, so more shedding at the same offered load
    # means less capacity).  The burst p99 is the ADMITTED-request
    # tail under overload — the graceful-degradation number.
    "serve_router_qps": "high", "serve_router_p99_ms": "low",
    "serve_router_p50_ms": "low",
    "serve_shed_frac": "low", "serve.shed_frac": "low",
    "serve_burst_p99_ms": "low", "serve_burst_p99_x": "low",
    "serve_bin_p50_ms": "low", "serve.parse_bin_p50_ms": "low",
    "serve.shed": None, "serve.retries": None,
    "serve.evictions": None, "serve.readmissions": None,
    "serve.inflight": None,
    "serve.canary_promotions": None, "serve.canary_rollbacks": None,
    "serve.replicas": None, "serve.replicas_healthy": None,
    # Fleet observability: the SLO burn rate regresses when
    # it RISES (the error budget is burning faster), as do respawns
    # (managed replicas are dying), dropped trace events (the trace
    # lies by omission) and the sampled-tracing overhead ratio (off/on
    # qps, same shape as trace_overhead); fleet_scrape_ms is the
    # router's scrape-sweep cost.  Staleness fluctuates with the
    # scrape cadence — informational, not gated.
    "serve_burn_rate": "low", "serve.burn_rate": "low",
    "serve_respawns": "low", "serve.respawns": "low",
    "serve_trace_dropped": "low",
    "serve_trace_overhead": "low",
    "fleet_scrape_ms": "low",
    "serve_slo_bad_frac": "low", "serve.slo_bad_frac": "low",
    "serve.fleet_scrape_age_max_s": None,
    "serve.slo_good": None, "serve.slo_bad": None,
    # Canary shadow-score distribution keys (serve/router.py writes
    # them as bench-style JSONs): the canary gate flags a DRIFT in
    # EITHER direction — "both" is the two-sided direction compare_mode
    # implements for exactly this.
    "score_mean": "both", "score_std": "both",
    "score_p10": "both", "score_p50": "both", "score_p90": "both",
    "score_n": None,
    # Model quality & drift: windowed logloss and every PSI
    # axis regress when they RISE, windowed AUC when it FALLS; the
    # calibration ratio is two-sided like the canary score stats (a
    # systematic over- OR under-prediction is the regression) — so is
    # logloss_drift in principle, but a RISING window loss is the
    # page-worthy direction.  Counts are informational.  Bench keys:
    # quality_overhead is a cost ratio like the other obs probes;
    # quality_psi_identity is the self-skew floor (identity traffic
    # must read ~0, so any rise is a sketch/PSI correctness drift).
    "quality.logloss": "low", "quality.auc": "high",
    "quality.calib_ratio": "both",
    "quality.logloss_drift": "low",
    "quality.psi_values": "low", "quality.psi_lengths": "low",
    "quality.psi_ids": "low", "quality.psi_scores": "low",
    "quality.psi_max": "low",
    "quality.examples": None, "quality.window_examples": None,
    "serve.skew_psi_values": "low", "serve.skew_psi_lengths": "low",
    "serve.skew_psi_ids": "low", "serve.skew_psi_scores": "low",
    "serve.skew_psi_max": "low", "serve.skew_examples": None,
    "quality_overhead": "low", "quality_psi_identity": "low",
    # Static-analysis cleanliness: bench preflight runs
    # `python -m tools.lint` and records the NEW-finding count — a PR
    # that introduces one regresses the bench compare like any perf
    # key (0 -> N flags via the inf ratio).  The baselined count is
    # informational: it should only ever burn DOWN, but shrinking it
    # must never flag, so no direction.
    "lint_findings_new": "low", "lint_findings_baselined": None,
    # Serve hot path: the text-parse p50 and the vectorized
    # parser's speedup over the legacy per-line loop gate the request
    # hot path (parse time regresses when it RISES, the speedup when
    # it FALLS below ~1).  The pooled-accept toggle keys are
    # informational: which accept model ran, its worker count, and the
    # paired legacy-accept window (pooled_x is box-sensitive on small
    # hosts — the gated axis is serve_qps itself).
    "serve_parse_p50_ms": "low", "serve.parse_p50_ms": "low",
    "serve_parse_vec_speedup": "high",
    "serve_accept_pooled": None, "serve_accept_pooled_x": None,
    "serve_qps_legacy_accept": None, "serve_http_threads": None,
    "serve.parse_scratch_reuse": None,
    "serve.parse_scratch_bytes": None,
    # Kernel autotuner: the paired reference/auto step-rate
    # ratio regresses when it RISES (the <= 1.05 overhead budget), and
    # the persistent-compile-cache warm compile regresses when it
    # RISES (a warm replica spawn re-lowering from scratch reads as
    # warm ~= cold).  Cold compile time is box- and XLA-version-bound
    # noise, the hit count and which impl won are informational
    # (kernel_impl is a string, so it never reaches the compare
    # anyway — it shows in the autotune summary section instead).
    "autotune_overhead": "low",
    "compile_s_warm": "low",
    "compile_s_cold": None,
    "compile_cache_hits": None,
    # Concurrent ladder warmup: the serve wall time to ready regresses
    # when it RISES back toward the serial sum; the compile-second sum
    # itself is the same work either way (informational).
    "serve.warmup_wall_s": "low",
    "serve.warmup_compile_s": None,
    # Training-fleet observability: straggler ratio / skews
    # / the exchange barrier fraction regress when they RISE (one rank
    # slowing the fleet), as does the paired fleet-scrape overhead
    # ratio (off/on rate, same shape as the other obs cost probes).
    # Which rank is slowest, how many answered, and the scrape
    # staleness (cadence-bound) are informational.
    "fleet.straggler_ratio": "low", "fleet.rank_step_skew": "low",
    "fleet.exchange_frac": "low",
    "fleet.dispatch_skew_ms": "low", "fleet.wait_skew_ms": "low",
    "fleet.dispatch_p99_ms": "low", "fleet.wait_p99_ms": "low",
    "fleet.exchange_p99_ms": "low",
    "fleet.slowest_rank": None, "fleet.slowest_rank_share": None,
    "fleet.ranks_scraped": None, "fleet.scrape_age_max_s": None,
    "fleet.examples_in": None, "fleet.ingest_wait_frac": "low",
    "fleet_scrape_overhead": "low",
    # Rank-sharded tiering + overlapped exchange: the
    # synchronous exchange window fraction and its overlapped
    # counterpart regress when they RISE (overlap stops hiding the
    # merge); the per-rank device-bytes fraction vs the host-global
    # baseline regresses when it RISES back toward 1.0 (sharding
    # stopped shedding table+optimizer memory); the sharded step rate
    # is a plain throughput axis.  The geometry echoes (shards, the
    # off-run rate) are informational.
    "fleet_exchange_frac": "low",
    "fleet_exchange_overlap_frac": "low",
    "fleet_shard_bytes_frac": "low",
    "fleet_cold_bytes_frac": "low",
    "fleet_sharded_examples_per_sec": "high",
    "fleet_global_examples_per_sec": None,
    "fleet_tier_shards": None,
    # Bench preflight (--timeline over the BENCH_r*.json stack): any
    # key whose trend already crossed its threshold counts here — a
    # new one appearing is itself a regression signal.
    "timeline_regressions": "low",
    # Incident flight recorder: the traffic-capture cost
    # ratio (off/on qps, same paired shape as the trace/quality/fleet
    # probes) regresses when it RISES past the 1.05 budget; how many
    # requests the capture window recorded and how many bundles a run
    # dumped are informational (a run that ALERTS more already flags
    # via alerts_total).
    "capture_overhead": "low",
    "capture_requests": None,
    "serve.capture_requests": None,
    "obs.incidents": None,
}


def _direction(key: str):
    if key in _DIRECTION_OVERRIDES:
        return _DIRECTION_OVERRIDES[key]
    # Watchdog per-rule fire counts (alert.<rule-name>): more fires of
    # any rule is the regression, whatever signal the rule watches.
    if key.startswith("alert."):
        return "low"
    for suffix in _LOWER_BETTER:
        if key.endswith(suffix) or key == suffix:
            return "low"
    for suffix in _HIGHER_BETTER:
        if key.endswith(suffix) or key == suffix:
            return "high"
    return None


def _comparable_metrics(path: str) -> dict:
    """Flatten one artifact into {key: number}.

    Bench JSONs (one object with a ``metric`` key, e.g. BENCH_rN.json)
    contribute their numeric top-level keys.  Metrics JSONLs contribute
    the final record's attribution + health and the last train record's
    rate/loss/auc.
    """
    with open(path) as f:
        first = f.readline()
        rest = f.read()
    try:
        doc = json.loads(first + rest)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "metric" in doc:  # bench JSON
        return {
            k: float(v) for k, v in doc.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
    groups = load(path)
    out: dict = {}
    final = (groups.get("final") or groups.get("heartbeat") or [{}])[-1]
    for key in ("elapsed", "wait_input_s", "dispatch_s", "other_s",
                "ingest_wait_frac", "truncated_features",
                "out_of_range_batches", "examples_in", "step"):
        if key in final:
            out[key] = float(final[key])
    for key, val in (final.get("health") or {}).items():
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[f"health.{key}"] = float(val)
    for key in ("hot_hit_frac", "rows_evicted", "rows_loaded"):
        val = (final.get("tiered") or {}).get(key)
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[f"tiered.{key}"] = float(val)
    # Resource block: gate the memory/compile axes.  Streams
    # WITHOUT the block (pre-resource runs, resource_metrics=off)
    # simply contribute no resource.* keys — --compare works on the
    # shared set, so old baselines never KeyError.
    for key in ("peak_rss_mb", "rss_mb", "compile_s", "compiles",
                "recompiles_unexpected", "model_flops_per_s"):
        val = (final.get("resource") or {}).get(key)
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[f"resource.{key}"] = float(val)
    # Serving block: latency/throughput axes of a serve stream.
    # Training streams carry no serve block and contribute no serve.*
    # keys — same shared-set back-compat as the resource block.
    for key in ("qps", "p50_ms", "p95_ms", "p99_ms", "batch_fill",
                "requests", "swaps", "compiles", "steady_compiles",
                "recompiles_unexpected", "shed", "shed_frac",
                "burn_rate", "slo_bad_frac", "respawns", "evictions",
                "retries", "warmup_wall_s", "warmup_compile_s"):
        val = (final.get("serve") or {}).get(key)
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[f"serve.{key}"] = float(val)
    # Quality block: the model-quality/drift axes.  Streams
    # without the block (pre-quality runs, quality=off) contribute no
    # quality.* keys — same shared-set back-compat as resource/serve.
    for key in ("logloss", "auc", "calib_ratio", "logloss_drift",
                "psi_values", "psi_lengths", "psi_ids", "psi_scores",
                "psi_max", "examples", "window_examples"):
        val = (final.get("quality") or {}).get(key)
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[f"quality.{key}"] = float(val)
    # Training-fleet block: rank 0's merged cross-rank view
    # plus the straggler attribution.  Single-process streams carry no
    # fleet block and contribute no fleet.* keys — the shared-set
    # back-compat every block follows.
    for key, val in (final.get("fleet") or {}).items():
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[f"fleet.{key}"] = float(val)
    # Serving skew keys live inside the serve block (skew_*).
    for key in ("skew_psi_values", "skew_psi_lengths", "skew_psi_ids",
                "skew_psi_scores", "skew_psi_max", "skew_examples"):
        val = (final.get("serve") or {}).get(key)
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[f"serve.{key}"] = float(val)
    if "trace_dropped_events" in final:
        out["trace_dropped_events"] = float(final["trace_dropped_events"])
    # Watchdog output: total fires, halts, and per-rule counts — all
    # present (0) whenever the stream has records at all, so a run that
    # STARTS alerting flags against a clean baseline (a key missing
    # from one side would silently drop out of the comparison).
    alerts = groups.get("alert", [])
    out["alerts_total"] = float(len(alerts))
    out["alerts_halt"] = float(
        sum(1 for a in alerts if a.get("action") == "halt")
    )
    for a in alerts:
        key = f"alert.{a.get('rule', '?')}"
        out[key] = out.get(key, 0.0) + 1.0
    if final.get("elapsed") and final.get("examples_in"):
        out["examples_in_per_sec"] = (
            final["examples_in"] / final["elapsed"]
        )
    trains = groups.get("train") or []
    if trains:
        last = trains[-1]
        for key in ("examples_per_sec", "loss", "auc"):
            if key in last:
                out[f"train.{key}"] = float(last[key])
    valids = groups.get("validation") or []
    if valids:
        last = valids[-1]
        for key in ("loss", "auc"):
            if key in last:
                out[f"validation.{key}"] = float(last[key])
    return out


def parse_thresholds(values) -> dict:
    """``--threshold`` values -> {key_or_"default": fraction}.

    Accepted forms (repeatable, later wins): a bare float (``0.07`` —
    sets the default, the historical spelling), ``default=0.05``, and
    per-key overrides (``ingest_wait_frac=0.10``).  The watchdog and
    the bench gates share one regression vocabulary this way: the same
    key names that appear in ``--compare`` output key the overrides.
    """
    out = {"default": 0.05}
    for raw in values or []:
        raw = raw.strip()
        if "=" in raw:
            key, _, val = raw.partition("=")
            key = key.strip()
        else:
            key, val = "default", raw
        try:
            out[key] = float(val)
        except ValueError:
            raise SystemExit(
                f"--threshold {raw!r}: expected FLOAT or KEY=FLOAT"
            ) from None
    return out


def compare_mode(path_a: str, path_b: str, thresholds: dict) -> int:
    a, b = _comparable_metrics(path_a), _comparable_metrics(path_b)
    shared = sorted(set(a) & set(b))
    if not shared:
        print("no comparable numeric keys shared by the two files")
        return 1
    default = thresholds.get("default", 0.05)
    overrides = {k: v for k, v in thresholds.items() if k != "default"}
    print(f"comparing A={path_a}  ->  B={path_b} "
          f"(flag threshold {default:.0%}"
          + (f", {len(overrides)} per-key override(s)" if overrides
             else "") + ")")
    print(f"  {'key':40} {'A':>12} {'B':>12} {'B/A':>8}  flag")
    regressions = []
    for key in shared:
        va, vb = a[key], b[key]
        if va == 0 and vb == 0:
            continue
        ratio = vb / va if va else float("inf")
        direction = _direction(key)
        threshold = thresholds.get(key, default)
        flag = ""
        if direction == "high" and ratio < 1 - threshold:
            flag = "REGRESSION"
        elif direction == "low" and ratio > 1 + threshold:
            flag = "REGRESSION"
        elif direction == "both" and not (
            1 - threshold <= ratio <= 1 + threshold
        ):
            # Two-sided keys (canary score distributions): movement in
            # EITHER direction is the regression — there is no
            # "improved" side to a score drift.
            flag = "REGRESSION"
        elif direction == "high" and ratio > 1 + threshold:
            flag = "improved"
        elif direction == "low" and ratio < 1 - threshold:
            flag = "improved"
        if flag and key in thresholds:
            flag += f" (thr {threshold:g})"
        if flag.startswith("REGRESSION"):
            regressions.append(key)
        rs = f"{ratio:8.3f}" if ratio != float("inf") else "     inf"
        print(f"  {key:40} {va:>12.4g} {vb:>12.4g} {rs}  {flag}")
    if regressions:
        print(f"\n{len(regressions)} REGRESSION(s): "
              f"{', '.join(regressions)}")
        return 2
    print("\nno regressions beyond threshold")
    return 0


def summary_mode(paths: list, limit: int = 8) -> int:
    """The default mode: one stream's header, progression, alerts and
    end-of-run breakdown, or with several paths the per-rank merge."""
    streams = []
    for path in paths:
        groups = load(path)
        if groups:
            streams.append((path, groups))
        else:
            print(f"{path}: no records")
    if not streams:
        return 1
    if len(streams) > 1:
        return _merge_ranks(streams)
    groups = streams[0][1]
    headers = groups.get("run_header", [])
    if headers:
        _print_header(headers[-1])
    _print_progress(
        groups.get("train", []), groups.get("validation", []), limit
    )
    _print_alerts(groups.get("alert", []), limit)
    # The final record is the exact end-of-run report; fall back to the
    # last heartbeat for a run that died mid-flight.
    final = groups.get("final") or groups.get("heartbeat")
    if final:
        _print_breakdown(final[-1])
        hbs = groups.get("heartbeat", [])
        if hbs:
            print(f"\nheartbeats: {len(hbs)} "
                  f"(last at elapsed {hbs[-1].get('elapsed', 0.0):.1f}s)")
    else:
        print("\nno heartbeat/final records (heartbeat_secs=0 and the run "
              "died before the final record)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fast_tffm_tpu_torch.tools.report",
        description="summarize metrics JSONLs, or ratio-diff two runs",
    )
    ap.add_argument("paths", nargs="+",
                    help="metrics_file JSONL(s) (one per rank to merge "
                         "a fleet); exactly two artifacts with --compare")
    ap.add_argument("--limit", type=int, default=8,
                    help="train/validation rows and alerts to show "
                         "(default 8)")
    ap.add_argument("--compare", action="store_true",
                    help="ratio-diff exactly two runs (metrics JSONLs "
                         "or bench JSONs); exit 2 on regression")
    ap.add_argument("--threshold", action="append", default=None,
                    metavar="FLOAT|KEY=FLOAT",
                    help="--compare: regression flag threshold "
                         "(default 0.05 = 5%%); repeat for per-key "
                         "overrides, e.g. --threshold "
                         "ingest_wait_frac=0.10 --threshold "
                         "default=0.05")
    args = ap.parse_args(argv)
    if not args.compare:
        return summary_mode(args.paths, args.limit)
    if len(args.paths) != 2:
        ap.error("--compare takes exactly two paths")
    return compare_mode(
        args.paths[0], args.paths[1], parse_thresholds(args.threshold),
    )


if __name__ == "__main__":
    sys.exit(main())
