"""Ratio-diff two runs: ``python -m fast_tffm_tpu_torch.tools.report
--compare A B [--threshold FLOAT|KEY=FLOAT ...]``.

A and B are metrics JSONLs or bench-style JSONs (one object with a
``metric`` key, like the canary's shadow-score statistics that
``serve/router.py`` writes).  Every numeric key the two share is shown
with its ratio B/A and flagged where it moved past ``--threshold``
(default 5%) in its regressing direction: rates regress when they fall,
times and losses when they rise, and the canary's score-distribution
keys in either direction.  Exit codes: 0 within threshold, 2 when any
key regressed, 1 when the two files share no numeric key.

The PyTorch port's copy of the ``--compare`` mode of the repo's
``tools/report.py`` (the canary gate runs it), with the same direction
vocabulary, output lines and exit codes; the summary, trace, timeline
and incident modes are not in the port.  Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["compare_mode", "main", "parse_thresholds"]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fast_tffm_tpu_torch.tools.report",
        description="ratio-diff two runs (metrics JSONLs or bench JSONs)",
    )
    ap.add_argument("paths", nargs="+",
                    help="exactly two artifacts with --compare")
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
        ap.error("only --compare is in the port; the other modes are "
                 "the repo's tools/report.py")
    if len(args.paths) != 2:
        ap.error("--compare takes exactly two paths")
    return compare_mode(
        args.paths[0], args.paths[1], parse_thresholds(args.threshold),
    )


if __name__ == "__main__":
    sys.exit(main())
