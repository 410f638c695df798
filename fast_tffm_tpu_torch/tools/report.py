"""Summarize the port's observability artifacts: metrics streams, traces,
incident bundles, and ratio-diffs and trends of runs.

``python -m fast_tffm_tpu_torch.tools.report METRICS.jsonl [...]`` (the
default mode): the run header, the train and validation progression,
the alerts, the compiles (the sentinel's ``record: compile`` entries:
the port's CUDA graph captures) and the autotune decisions (none in the
port: it prints n/a), and the final record's breakdown (the wall-clock
split, the data-integrity counters, the training-health block, the
resource, quality, fleet, serve and tiered blocks, the stage timers,
gauges, counters and queue depths), or the last heartbeat of a run
that died without one.  With several streams (a fleet's
``metrics_file`` and its ``.rankN`` files) it prints a per-rank table
and the slowest rank's breakdown.

``--trace TRACE.json [...]``: merges Chrome-trace span files (a
trainer's ``trace_file`` and its ``.rankN`` files, rotated windows
re-joined) into one Perfetto-loadable file (``-o``, default
``<first>.merged.json``) and prints the per-stage span totals and each
dispatched super-batch's chain read -> parse -> deliver -> stack ->
H2D -> dispatch, the slowest broken down segment by segment, with a
straggler section over several ranks.

``--serve-trace TRACE [...]``: the serving traces (the router's and its
``trace_file.replicaN`` family, or one server's): each sampled
request's chain admit -> queue -> coalesce -> dispatch -> respond, with
the slowest replica named.

``--compare A B [--threshold FLOAT|KEY=FLOAT ...]``: A and B are
metrics JSONLs or bench-style JSONs (one object with a ``metric`` key,
like the canary's shadow-score statistics that ``serve/router.py``
writes).  Every numeric key the two share is shown with its ratio B/A
and flagged where it moved past ``--threshold`` (default 5%) in its
regressing direction.  Exit codes: 0 within threshold, 2 when any key
regressed, 1 when the two files share no numeric key.

``--timeline A B C ...``: the trend over a stack of bench JSONs, per
key, with the first regression named.

``--incident DIR``: one blackbox bundle (``incidents/<ts>_<reason>/``):
the rule that fired or the crash, the breached signals' trajectory over
the ringed records, the trace tail's critical path and the slowest
rank or replica.

The PyTorch port's copy of the repo's ``tools/report.py``, with the
same sections, direction vocabulary, output lines and exit codes (the
header names ``torch_version`` and ``device`` where the repo's names
``jax_version``), so either tool reads the other package's artifacts.
Stdlib only.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import sys
import time

__all__ = ["compare_mode", "incident_mode", "load", "main", "merge_traces",
           "parse_thresholds", "serve_trace_mode", "summary_mode",
           "timeline_mode", "trace_chains", "trace_mode"]


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


def _print_compiles(compiles: list) -> None:
    """Compile-sentinel stream summary: every `record: compile` entry is
    one actual train-step compilation (wall time + XLA cost captured at
    compile time); an unexpected one is the headline."""
    if not compiles:
        return
    total_s = sum(c.get("compile_s", 0.0) for c in compiles)
    bad = [c for c in compiles if not c.get("expected", True)]
    print(f"\ncompiles ({len(compiles)}, {total_s:.2f}s total"
          + (f", {len(bad)} UNEXPECTED" if bad else "") + "):")
    for c in compiles:
        flag = "" if c.get("expected", True) else "  << UNEXPECTED"
        flops = c.get("flops")
        extra = f"  {flops:.3g} flops" if flops else ""
        if c.get("where") == "serve":
            # Serving-ladder compile: identified by rung shape, not a
            # training step.
            print(f"  serve shape {str(c.get('shape', '?')):>10} "
                  f"{c.get('compile_s', 0.0):7.2f}s{flag}")
            continue
        print(f"  step {c.get('step', '?'):>6}  k={c.get('k', '?'):<4} "
              f"{c.get('compile_s', 0.0):7.2f}s{extra}{flag}")


def _print_autotune(entries: list) -> None:
    """Kernel-autotune summary: every `record: autotune` entry is one
    interaction-impl decision (per context) — which impl the run
    actually executed, where the decision came from (pin / cache /
    measurement), and the per-candidate medians when a measurement
    ran.  Streams written before the autotuner existed (or runs with
    a pinned impl, which skip the record) print n/a, not nothing —
    the reader should know the section was consulted."""
    if not entries:
        print("\nautotune: n/a (stream has no autotune records — "
              "pre-autotune run, or interaction_impl was pinned)")
        return
    print(f"\nautotune (interaction-impl decisions, {len(entries)}):")
    for e in entries:
        times = " ".join(
            f"{k}={v}ms"
            for k, v in sorted((e.get("times_ms") or {}).items())
        )
        gated = [
            k for k, v in (e.get("parity_err") or {}).items()
            if k not in (e.get("times_ms") or {})
        ]
        print(f"  {e.get('context', '?'):6} {e.get('impl', '?'):10} "
              f"({e.get('source', '?')}"
              + (f"; {times}" if times else "") + ")")
        if gated:
            print(f"    parity-gated out: {', '.join(sorted(gated))}")


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
# --trace: merge Chrome-trace span files + critical-path summary
# ---------------------------------------------------------------------------


def load_trace(path: str) -> tuple[list, dict]:
    """(events, otherData) from one trace file (object or bare-array
    Chrome trace format)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):  # bare traceEvents array
        return doc, {}
    return doc.get("traceEvents", []), doc.get("otherData", {})


def merge_traces(paths: list) -> tuple[list, list, list]:
    """Merge per-rank/per-process trace files onto ONE timeline.

    Timestamps are perf_counter µs — already shared across processes of
    one host.  Across hosts each file's ``otherData`` anchors give the
    wall-clock offset; events are shifted onto the wall timeline and
    re-zeroed at the earliest event.  Returns (events, notes,
    per_file) — ``per_file`` entries are ``(path, events, otherData)``
    with the UNSHIFTED original events, for chain reconstruction (which
    is per-rank and only needs intra-file deltas), so a near-cap 250 MB
    trace is parsed once.
    """
    notes = []
    all_events = []
    per_file = []
    for path in paths:
        events, other = load_trace(path)
        per_file.append((path, events, other))
        shift = 0
        if "wall_anchor" in other and "perf_anchor" in other:
            shift = int(
                (other["wall_anchor"] - other["perf_anchor"]) * 1e6
            )
        dropped = other.get("dropped_events", 0)
        if dropped:
            notes.append(f"{path}: {dropped} events were dropped at "
                         "record time (buffer cap)")
        for ev in events:
            if "ts" in ev:
                ev = dict(ev)
                ev["ts"] += shift
            all_events.append(ev)
    tss = [ev["ts"] for ev in all_events if "ts" in ev]
    if tss:
        t0 = min(tss)
        for ev in all_events:
            if "ts" in ev:
                ev["ts"] -= t0
    return all_events, notes, per_file


def group_streams(per_file: list) -> list:
    """Re-join rotated trace windows into per-run streams.

    A rotated tracer (``trace_rotate_events``) dumps one run as
    ``trace.0.json .. trace.N.json``; every window carries the SAME
    clock anchors + pid and its ``window`` index in ``otherData``.
    Windows sharing (pid, wall_anchor, perf_anchor) are one stream —
    concatenated in window order so chains that span a rotation
    boundary reconnect.  Files without a ``window`` key (unrotated
    traces, one per rank) each stay their own stream, preserving the
    per-rank chain contract (sb/seq ids restart per rank).

    Returns ``[(label, events), ...]``.
    """
    singles = []
    windowed: dict = {}
    for path, events, other in per_file:
        if "window" in other:
            key = (
                other.get("pid"),
                other.get("wall_anchor"),
                other.get("perf_anchor"),
            )
            windowed.setdefault(key, []).append(
                (other["window"], path, events)
            )
        else:
            singles.append((path, events))
    streams = list(singles)
    for key in sorted(windowed, key=str):
        wins = sorted(windowed[key], key=lambda w: w[0])
        events: list = []
        for _, _, evs in wins:
            events.extend(evs)
        label = f"{wins[0][1]} (+{len(wins) - 1} window(s))" \
            if len(wins) > 1 else wins[0][1]
        streams.append((label, events))
    return streams


def _straggler_section(stream_chains: list, limit: int = 8) -> None:
    """Slowest-rank attribution per chain segment.

    ``stream_chains`` is ``[(label, chains), ...]`` — one entry per
    rank stream.  For each stream the mean duration of every chain
    segment (parse / stack / h2d / dispatch) and the mean end-to-end
    chain latency are tabulated; the slowest rank per segment is named.
    In a synchronous-update fleet the step waits for every host, so
    the slowest rank per segment is where fleet time actually goes —
    the groundwork for straggler detection (ROADMAP direction 4).
    """
    segs = ("parse", "stack", "h2d", "dispatch")
    rows = []
    for label, chains in stream_chains:
        if not chains:
            continue
        sums = {s: 0.0 for s in segs}
        counts = {s: 0 for s in segs}
        lat = 0.0
        for c in chains:
            lat += c["latency_us"]
            for name, (_, dur) in _chain_segments(c).items():
                sums[name] += dur
                counts[name] += 1
        rows.append({
            "label": label,
            "chains": len(chains),
            "lat_ms": lat / len(chains) / 1e3,
            **{
                s: (sums[s] / counts[s] / 1e3 if counts[s] else 0.0)
                for s in segs
            },
        })
    if len(rows) < 2:
        return
    print("\nstraggler attribution (mean ms per chain segment, "
          "per rank stream):")
    print(f"  {'stream':40} {'chains':>6} "
          + "".join(f"{s:>9}" for s in segs) + f" {'latency':>9}")
    for r in rows[:limit]:
        label = r["label"]
        if len(label) > 40:
            label = "..." + label[-37:]
        print(
            f"  {label:40} {r['chains']:>6} "
            + "".join(f"{r[s]:>9.2f}" for s in segs)
            + f" {r['lat_ms']:>9.2f}"
        )
    for s in segs + ("lat_ms",):
        worst = max(rows, key=lambda r: r[s])
        if worst[s] <= 0:
            continue
        name = "latency" if s == "lat_ms" else s
        print(f"  slowest {name:9}: {worst['label']} "
              f"({worst[s]:.2f} ms mean)")


def trace_chains(events: list) -> list:
    """Reconstruct each dispatched super-batch's span chain.

    Join keys (see obs/trace.py): ``train.dispatch`` and the
    prefetcher's ``prefetch.stack``/``prefetch.h2d`` spans share ``sb``;
    the stack span names its batch range (``batch0``, ``n``);
    ``ingest.deliver`` points bridge ``batch`` -> ``seq`` (one point may
    cover ``n`` batches — a prestacked SuperBatch delivers whole);
    ``seq`` joins ``parse.batch``, ``ring.slot_acquire``, and
    ``read.item``.  Returns one dict per dispatch: {sb, dispatch, stack,
    h2d, batches: [{batch, seq, deliver, parse, read}...], complete,
    latency_us}.

    Contract: ``events`` must come from ONE rank's trace (sb/seq/batch
    ids restart per rank); ``trace_mode`` therefore builds chains per
    input file before merging the timeline.
    """
    by_name: dict = {}
    for ev in events:
        if ev.get("ph") == "X":
            by_name.setdefault(ev.get("name"), []).append(ev)

    def args_index(name, key):
        out = {}
        for ev in by_name.get(name, []):
            a = ev.get("args") or {}
            if key in a:
                out[a[key]] = ev
        return out

    dispatches = args_index("train.dispatch", "sb")
    stacks = args_index("prefetch.stack", "sb")
    h2ds = args_index("prefetch.h2d", "sb")
    parses = args_index("parse.batch", "seq")
    reads = args_index("read.item", "seq")
    delivers = {}
    for ev in by_name.get("ingest.deliver", []):
        a = ev.get("args") or {}
        if "batch" in a:
            # One deliver point covers its whole batch range (n > 1 for
            # prestacked SuperBatches delivered whole).
            for i in range(a["batch"], a["batch"] + a.get("n", 1)):
                delivers[i] = ev
    # ring windows: sorted seq0 list; a batch seq belongs to the last
    # window at or before it (bisect — a near-cap trace can hold 1e5
    # windows x 1e6 batches, so per-batch linear scans would hang the
    # tool on exactly the traces it exists for).  Sort on the seq key
    # only (tuple comparison would fall through to the event dicts on
    # ties).
    rings = sorted(
        (
            (ev.get("args", {}).get("seq"), ev)
            for ev in by_name.get("ring.slot_acquire", [])
            if ev.get("args", {}).get("seq") is not None
        ),
        key=lambda pair: pair[0],
    )
    ring_seqs = [s0 for s0, _ in rings]

    def ring_for(seq):
        i = bisect.bisect_right(ring_seqs, seq)
        return rings[i - 1][1] if i else None

    chains = []
    for sb, disp in sorted(dispatches.items()):
        stack = stacks.get(sb)
        h2d = h2ds.get(sb)
        # Prestacked super-batches have no transfer-stage stack; their
        # h2d span carries the batch range instead.
        rng_ev = stack if stack is not None else h2d
        batches = []
        if rng_ev is not None:
            a = rng_ev.get("args") or {}
            b0, n = a.get("batch0"), a.get("n")
            if b0 is not None and n is not None:
                for b in range(b0, b0 + n):
                    dv = delivers.get(b)
                    seq = (dv.get("args") or {}).get("seq") if dv else None
                    batches.append({
                        "batch": b, "seq": seq, "deliver": dv,
                        "parse": parses.get(seq) if seq is not None
                        else None,
                        "read": reads.get(seq) if seq is not None
                        else None,
                        "ring": ring_for(seq) if seq is not None
                        else None,
                    })
        # A chain is complete when the dispatch connects through h2d to
        # its batch range and every batch connects to a deliver point;
        # parse/read links are required only for batches that name a seq
        # (cached replays legitimately deliver with seq=None — their
        # parse happened in a previous epoch's chain).
        complete = (
            h2d is not None and batches
            and all(b["deliver"] is not None for b in batches)
            and all(
                b["parse"] is not None and b["read"] is not None
                for b in batches if b["seq"] is not None
            )
        )
        starts = [disp["ts"]]
        for b in batches:
            for k in ("read", "parse", "deliver"):
                if b[k] is not None:
                    starts.append(b[k]["ts"])
        if h2d is not None:
            starts.append(h2d["ts"])
        if stack is not None:
            starts.append(stack["ts"])
        chains.append({
            "sb": sb, "dispatch": disp, "stack": stack, "h2d": h2d,
            "batches": batches, "complete": bool(complete),
            "latency_us": disp["ts"] + disp.get("dur", 0) - min(starts),
        })
    return chains


def _chain_segments(chain: dict) -> dict:
    """Stage timing along one chain, for the critical-path breakdown:
    the LAST-finishing batch's read/parse spans, the stack/h2d spans,
    and the dispatch — plus the gaps between them."""
    segs = {}
    last_parse = None
    for b in chain["batches"]:
        if b["parse"] is not None:
            end = b["parse"]["ts"] + b["parse"].get("dur", 0)
            if last_parse is None or end > last_parse["ts"] + \
                    last_parse.get("dur", 0):
                last_parse = b["parse"]
    for name, ev in (
        ("parse", last_parse), ("stack", chain["stack"]),
        ("h2d", chain["h2d"]), ("dispatch", chain["dispatch"]),
    ):
        if ev is not None:
            segs[name] = (ev["ts"], ev.get("dur", 0))
    return segs


# Serve-path request chain: sequential segments (the critical path a
# request walks) in order, plus the router spans that wrap them.
_SERVE_SEGMENTS = ("admit", "queue_wait", "coalesce", "dispatch",
                   "respond")


def serve_request_chains(events: list) -> list:
    """Reconstruct per-request span chains from serving traces.

    Join key: the ``rid`` arg every serve-path span carries
    (``serve.admit`` / ``serve.proxy`` on the router,
    ``serve.queue_wait`` / ``serve.coalesce`` / ``serve.dispatch`` /
    ``serve.respond`` on the replica).  Unlike super-batch chains, rid
    uniqueness is fleet-global (pid + boot time + counter), so chains
    join across ALL files at once.  Returns one dict per rid:
    {rid, replica, spans: {name: ev}, latency_us, complete}.
    """
    by_rid: dict = {}
    routed = False
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        if not name.startswith("serve."):
            continue
        rid = (ev.get("args") or {}).get("rid")
        if rid is None:
            continue
        seg = name[len("serve."):]
        if seg in ("admit", "proxy"):
            routed = True
        by_rid.setdefault(rid, {})[seg] = ev
    chains = []
    for rid, spans in by_rid.items():
        starts = [ev["ts"] for ev in spans.values()]
        ends = [ev["ts"] + ev.get("dur", 0) for ev in spans.values()]
        # A shed request legitimately ends at the admit decision; a
        # scored one must carry the full replica chain (and, behind a
        # router, the proxy span).
        decision = (spans.get("admit", {}).get("args") or {}).get(
            "decision", "admit"
        )
        if decision != "admit":
            complete = "admit" in spans
        else:
            need = {"queue_wait", "coalesce", "dispatch", "respond"}
            if routed:
                need |= {"admit", "proxy"}
            complete = need <= set(spans)
        replica = None
        for seg in ("proxy", "dispatch", "admit"):
            a = spans.get(seg, {}).get("args") or {}
            if isinstance(a.get("replica"), int) and a["replica"] >= 0:
                replica = a["replica"]
                break
        chains.append({
            "rid": rid, "replica": replica, "spans": spans,
            "decision": decision,
            "latency_us": max(ends) - min(starts),
            "complete": complete,
        })
    return chains


def serve_trace_mode(paths: list, out: str, limit: int) -> int:
    """``--serve-trace``: per-request critical-path breakdown across
    the router + replica trace family, with slowest-replica
    attribution."""
    events, notes, _per_file = merge_traces(paths)
    if not events:
        print("no trace events")
        return 1
    if out:
        with open(out, "w") as f:
            json.dump(
                {"traceEvents": events, "displayTimeUnit": "ms"}, f
            )
        print(f"merged {len(paths)} file(s), {len(events)} events -> "
              f"{out}")
    for note in notes:
        print(f"  ! {note}")
    chains = serve_request_chains(events)
    if not chains:
        print("no sampled serve requests in this trace "
              "(serve_trace_sample = 0, or a training trace?)")
        return 1
    n_ok = sum(1 for c in chains if c["complete"])
    n_shed = sum(1 for c in chains if c["decision"] != "admit")
    print(f"\nsampled requests: {len(chains)} traced, {n_ok} with a "
          f"complete chain"
          + (f", {n_shed} shed/unrouted" if n_shed else ""))
    if n_ok < len(chains):
        bad = [c["rid"] for c in chains if not c["complete"]][:5]
        print(f"  ! incomplete chains (first 5 rids): {bad}")
        print("    (a SIGKILLed replica's spans die with it — its "
              "requests retried elsewhere keep only the router half)")

    slowest = sorted(chains, key=lambda c: -c["latency_us"])[:limit]
    print(f"\ncritical path — slowest {len(slowest)} request(s) "
          f"(admit -> queue -> coalesce -> dispatch -> respond):")
    for c in slowest:
        parts = []
        prev_end = None
        for seg in _SERVE_SEGMENTS:
            ev = c["spans"].get(seg)
            if ev is None:
                continue
            ts, dur = ev["ts"], ev.get("dur", 0)
            if prev_end is not None and ts > prev_end:
                parts.append(f"(+{(ts - prev_end) / 1e3:.2f} gap)")
            parts.append(f"{seg} {dur / 1e3:.2f}")
            prev_end = ts + dur
        proxy = c["spans"].get("proxy")
        if proxy is not None:
            parts.append(f"| proxy {proxy.get('dur', 0) / 1e3:.2f}")
        rep = f" r{c['replica']}" if c["replica"] is not None else ""
        print(f"  {c['rid'][-14:]:>14}{rep}: "
              f"{c['latency_us'] / 1e3:9.2f} ms  "
              f"[ms: {' -> '.join(parts)}]")

    # Slowest-replica attribution: in a P2C fleet every replica sees
    # comparable traffic, so a replica whose mean dispatch/queue time
    # stands out is where fleet latency actually goes.
    per_rep: dict = {}
    for c in chains:
        if c["replica"] is None or not c["complete"]:
            continue
        row = per_rep.setdefault(
            c["replica"],
            {s: [0.0, 0] for s in _SERVE_SEGMENTS + ("latency",)},
        )
        row["latency"][0] += c["latency_us"]
        row["latency"][1] += 1
        for seg in _SERVE_SEGMENTS:
            ev = c["spans"].get(seg)
            if ev is not None:
                row[seg][0] += ev.get("dur", 0)
                row[seg][1] += 1
    if len(per_rep) >= 2:
        segs = _SERVE_SEGMENTS + ("latency",)
        print("\nslowest-replica attribution (mean ms per segment):")
        print(f"  {'replica':>8} {'chains':>7} "
              + "".join(f"{s:>11}" for s in segs))
        means: dict = {}
        for rep in sorted(per_rep):
            row = per_rep[rep]
            means[rep] = {
                s: (row[s][0] / row[s][1] / 1e3 if row[s][1] else 0.0)
                for s in segs
            }
            print(f"  {rep:>8} {row['latency'][1]:>7} "
                  + "".join(f"{means[rep][s]:>11.2f}" for s in segs))
        for s in segs:
            worst = max(means, key=lambda r: means[r][s])
            if means[worst][s] > 0:
                print(f"  slowest {s:10}: replica {worst} "
                      f"({means[worst][s]:.2f} ms mean)")
    return 0


def trace_mode(paths: list, out: str, limit: int) -> int:
    events, notes, per_file = merge_traces(paths)
    if not events:
        print("no trace events")
        return 1
    out = out or (paths[0] + ".merged.json")
    with open(out, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    print(f"merged {len(paths)} file(s), {len(events)} events -> {out}")
    print("open in https://ui.perfetto.dev (or chrome://tracing)")
    for note in notes:
        print(f"  ! {note}")
    # Chains are reconstructed PER RANK STREAM: sb/seq/batch ids
    # restart per rank, so joining across the merged pool would
    # cross-wire the ranks' super-batches.  Rotated windows of one run
    # (shared clock anchors + a window index) are first re-joined into
    # their stream so chains spanning a rotation boundary reconnect.
    streams = group_streams(per_file)
    if len(streams) < len(per_file):
        print(f"  re-joined {len(per_file)} file(s) into "
              f"{len(streams)} stream(s) (rotated trace windows)")
    stream_chains = [
        (label, trace_chains(evs)) for label, evs in streams
    ]
    chains = []
    for _, cs in stream_chains:
        chains.extend(cs)

    spans: dict = {}
    for ev in events:
        if ev.get("ph") == "X":
            tot, cnt, mx = spans.get(ev["name"], (0, 0, 0))
            d = ev.get("dur", 0)
            spans[ev["name"]] = (tot + d, cnt + 1, max(mx, d))
    print(f"\nstage spans ({sum(c for _, c, _ in spans.values())} total):")
    print(f"  {'span':24} {'count':>7} {'total_ms':>10} {'mean_ms':>9} "
          f"{'max_ms':>9}")
    for name in sorted(spans, key=lambda n: -spans[n][0]):
        tot, cnt, mx = spans[name]
        print(f"  {name:24} {cnt:>7} {tot / 1e3:>10.2f} "
              f"{tot / cnt / 1e3:>9.3f} {mx / 1e3:>9.3f}")

    if not chains:
        print("\nno dispatched super-batches in this trace")
        return 0
    n_ok = sum(1 for c in chains if c["complete"])
    print(f"\nsuper-batch chains: {len(chains)} dispatched, {n_ok} with "
          f"a complete read->parse->deliver->h2d->dispatch chain")
    if n_ok < len(chains):
        bad = [c["sb"] for c in chains if not c["complete"]][:10]
        print(f"  ! incomplete chains (first 10 sb ids): {bad}")
    slowest = sorted(chains, key=lambda c: -c["latency_us"])[:limit]
    print(f"\ncritical path — slowest {len(slowest)} chain(s) "
          f"(end-to-end latency, first event -> dispatch done):")
    for c in slowest:
        segs = _chain_segments(c)
        parts = []
        prev_end = None
        for name in ("parse", "stack", "h2d", "dispatch"):
            if name not in segs:
                continue
            ts, dur = segs[name]
            if prev_end is not None and ts > prev_end:
                parts.append(f"(+{(ts - prev_end) / 1e3:.2f} gap)")
            parts.append(f"{name} {dur / 1e3:.2f}")
            prev_end = ts + dur
        print(f"  sb {c['sb']:>5}: {c['latency_us'] / 1e3:9.2f} ms  "
              f"[ms: {' -> '.join(parts)}]")
    _straggler_section(stream_chains, limit)
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
    # Resource plane (PR 8): memory footprints and compile costs
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
    # Serving path (PR 9): tail latency regresses when it RISES (the
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
    # Quantized tables (PR 11): table bytes regress when they RISE
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
    # Scale-out serving (PR 12): router throughput regresses when it
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
    # Fleet observability (ISSUE 14): the SLO burn rate regresses when
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
    # Model quality & drift (ISSUE 15): windowed logloss and every PSI
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
    # Static-analysis cleanliness (PR 10): bench preflight runs
    # `python -m tools.lint` and records the NEW-finding count — a PR
    # that introduces one regresses the bench compare like any perf
    # key (0 -> N flags via the inf ratio).  The baselined count is
    # informational: it should only ever burn DOWN, but shrinking it
    # must never flag, so no direction.
    "lint_findings_new": "low", "lint_findings_baselined": None,
    # Serve hot path (ISSUE 16): the text-parse p50 and the vectorized
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
    # Kernel autotuner (ISSUE 17): the paired reference/auto step-rate
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
    # Training-fleet observability (ISSUE 18): straggler ratio / skews
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
    # Rank-sharded tiering + overlapped exchange (ISSUE 19): the
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
    # Incident flight recorder (ISSUE 20): the traffic-capture cost
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
    # Resource block (PR 8): gate the memory/compile axes.  Streams
    # WITHOUT the block (pre-resource runs, resource_metrics=off)
    # simply contribute no resource.* keys — --compare works on the
    # shared set, so old baselines never KeyError.
    for key in ("peak_rss_mb", "rss_mb", "compile_s", "compiles",
                "recompiles_unexpected", "model_flops_per_s"):
        val = (final.get("resource") or {}).get(key)
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[f"resource.{key}"] = float(val)
    # Serving block (PR 9): latency/throughput axes of a serve stream.
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
    # Quality block (ISSUE 15): the model-quality/drift axes.  Streams
    # without the block (pre-quality runs, quality=off) contribute no
    # quality.* keys — same shared-set back-compat as resource/serve.
    for key in ("logloss", "auc", "calib_ratio", "logloss_drift",
                "psi_values", "psi_lengths", "psi_ids", "psi_scores",
                "psi_max", "examples", "window_examples"):
        val = (final.get("quality") or {}).get(key)
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[f"quality.{key}"] = float(val)
    # Training-fleet block (ISSUE 18): rank 0's merged cross-rank view
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


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(vals: list) -> str:
    lo, hi = min(vals), max(vals)
    if hi == lo:
        return _SPARK_BLOCKS[3] * len(vals)
    span = hi - lo
    return "".join(
        _SPARK_BLOCKS[
            min(len(_SPARK_BLOCKS) - 1,
                int((v - lo) / span * len(_SPARK_BLOCKS)))
        ]
        for v in vals
    )


def _bench_order(path: str):
    """Sort key putting BENCH_r2 before BENCH_r10 (numeric round when
    the name carries one, lexical otherwise)."""
    m = re.search(r"_r(\d+)\D*\.json$", os.path.basename(path))
    return (0, int(m.group(1)), path) if m else (1, 0, path)


def _timeline_series(paths: list, log=None) -> tuple:
    """Load a bench-JSON stack into ``(labels, {key: [(label, val),
    ...]})`` — numeric top-level keys only, unreadable/stub rounds
    skipped (``log`` gets one line per skip when provided)."""
    series: dict = {}
    labels = []
    for path in sorted(paths, key=_bench_order):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            if log:
                log(f"{path}: unreadable ({e}); skipped")
            continue
        if not isinstance(doc, dict) or "metric" not in doc:
            # Harness stubs from rounds where the bench never ran
            # (rc!=0 wrappers) carry no metric keys — skip, don't
            # fake a flat round.
            if log:
                log(f"{os.path.basename(path)}: no bench metrics; "
                    f"skipped")
            continue
        label = os.path.basename(path)
        labels.append(label)
        for key, val in doc.items():
            if isinstance(val, (int, float)) and not isinstance(
                val, bool
            ):
                series.setdefault(key, []).append((label, float(val)))
    return labels, series


def timeline_regressions(paths: list, thresholds: dict = None) -> dict:
    """Machine-readable first-regression attribution over a bench-JSON
    stack — the same adjacent-step rule ``--timeline`` prints, for
    callers that gate on it (bench.py preflight records the count).
    Returns ``{"rounds": N, "regressions": {key: "rA -> rB (1.23x)"}}``
    (empty regressions when fewer than two readable rounds)."""
    thresholds = thresholds or {}
    default = thresholds.get("default", 0.05)
    labels, series = _timeline_series(paths)
    out: dict = {"rounds": len(labels), "regressions": {}}
    if len(labels) < 2:
        return out
    for key in sorted(series):
        points = series[key]
        if len(points) < 2:
            continue
        direction = _direction(key)
        threshold = thresholds.get(key, default)
        for (lab_a, va), (lab_b, vb) in zip(points, points[1:]):
            if va == 0 and vb == 0:
                continue
            ratio = vb / va if va else float("inf")
            if (
                (direction == "low" and ratio > 1 + threshold)
                or (direction == "high" and ratio < 1 - threshold)
                or (direction == "both" and not (
                    1 - threshold <= ratio <= 1 + threshold))
            ):
                rs = (f"{ratio:.2f}x" if ratio != float("inf")
                      else "inf")
                out["regressions"][key] = f"{lab_a} -> {lab_b} ({rs})"
                break
    return out


def timeline_mode(paths: list, thresholds: dict) -> int:
    """Trend view over a stack of bench JSONs (BENCH_rN.json): one
    sparkline row per shared key plus first-regression attribution —
    the earliest round whose step beyond ``--threshold`` moved in the
    regressing direction for that key (same direction vocabulary as
    ``--compare``).  Informational: always exits 0."""
    default = thresholds.get("default", 0.05)
    labels, series = _timeline_series(paths, log=print)
    if len(labels) < 2:
        print("--timeline needs at least two readable bench JSONs")
        return 1
    culprits = timeline_regressions(paths, thresholds)["regressions"]
    print(f"timeline over {len(labels)} rounds: "
          f"{labels[0]} .. {labels[-1]} "
          f"(step threshold {default:.0%})")
    print(f"  {'key':34} {'trend':>{max(5, len(labels))}} "
          f"{'first':>10} {'last':>10} {'l/f':>7}  first regression")
    for key in sorted(series):
        points = series[key]
        if len(points) < 2:
            continue
        vals = [v for _lab, v in points]
        # First-regression attribution: the earliest adjacent step
        # whose ratio moved beyond the threshold the WRONG way
        # (timeline_regressions is the single rule source).
        culprit = culprits.get(key, "")
        lf = vals[-1] / vals[0] if vals[0] else float("inf")
        lfs = f"{lf:7.3f}" if lf != float("inf") else "    inf"
        print(f"  {key:34} {_sparkline(vals):>{max(5, len(labels))}} "
              f"{vals[0]:>10.4g} {vals[-1]:>10.4g} {lfs}  {culprit}")
    return 0


def _dig_numeric(rec: dict, dotted: str):
    """Resolve a dotted signal path (``serve.qps``) against one
    record; bare spellings fall back to the standard blocks the alert
    aliases resolve into.  Returns a float or None."""

    def walk(cur, parts):
        for part in parts:
            if not isinstance(cur, dict) or part not in cur:
                return None
            cur = cur[part]
        return cur

    val = walk(rec, dotted.split("."))
    if val is None and "." not in dotted:
        for block in ("resource", "serve", "health", "fleet",
                      "tiered", "quality"):
            val = walk(rec, [block, dotted])
            if val is not None:
                break
    if isinstance(val, bool) or not isinstance(val, (int, float)):
        return None
    return float(val)


def incident_mode(path: str, limit: int = 8) -> int:
    """Render one blackbox bundle (``incidents/<ts>_<reason>/``) as a
    human incident summary.  Informational: exits 1 only when the
    manifest itself is unreadable."""
    man_path = os.path.join(path, "manifest.json")
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        print(f"{man_path}: unreadable incident manifest ({e})")
        return 1

    def _jsonl(name: str) -> list:
        rows = []
        try:
            with open(os.path.join(path, name)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        try:
                            rows.append(json.loads(line))
                        except ValueError:
                            pass
        except OSError:
            pass
        return rows

    records = _jsonl("records.jsonl")
    alerts = _jsonl("alerts.jsonl")
    when = manifest.get("time")
    stamp = (
        time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime(when))
        if isinstance(when, (int, float)) else "?"
    )
    landed = sorted(
        name for name, ok in (manifest.get("files") or {}).items() if ok
    )
    print(f"incident: {manifest.get('reason', '?')}  ({stamp})")
    print(f"  bundle:  {path}")
    print(f"  process: {manifest.get('suffix') or '-'}")
    print(f"  rings:   {len(records)} record(s), {len(alerts)} "
          f"alert(s); artifacts: {', '.join(landed) or 'none'}")

    if alerts:
        print(f"\nalerts (last {min(len(alerts), limit)} of "
              f"{len(alerts)}):")
        for a in alerts[-limit:]:
            print(
                f"  {a.get('rule', '?'):30} action={a.get('action', '?')}"
                f"  value={a.get('value', '?')} (threshold "
                f"{a.get('op', '?')} {a.get('threshold', '?')}, "
                f"step {a.get('step', '?')})"
            )

    # Signal trajectory: the breached signals first, then the standard
    # page-one vitals, each sparklined across the ringed records.
    signals = []
    for a in alerts:
        sig = a.get("signal")
        if sig and sig not in signals:
            signals.append(sig)
    for sig in ("serve.qps", "serve.p99_ms", "ingest_wait_frac",
                "resource.rss_mb", "resource.open_fds", "step"):
        if sig not in signals:
            signals.append(sig)
    rows = []
    for sig in signals:
        vals = [v for v in (_dig_numeric(r, sig) for r in records)
                if v is not None]
        if len(vals) >= 2:
            rows.append((sig, vals))
    if rows:
        print("\nsignal trajectory (oldest -> newest):")
        for sig, vals in rows:
            print(f"  {sig:28} {_sparkline(vals)}  "
                  f"{vals[0]:.4g} -> {vals[-1]:.4g}")

    # Critical path from the trace-buffer tail: the longest complete
    # spans right before the dump.
    trace_path = os.path.join(path, "trace_tail.json")
    if os.path.exists(trace_path):
        try:
            with open(trace_path) as f:
                events = (json.load(f) or {}).get("traceEvents") or []
        except (OSError, ValueError):
            events = []
        spans = [
            e for e in events
            if isinstance(e, dict) and e.get("ph") == "X"
            and isinstance(e.get("dur"), (int, float))
        ]
        spans.sort(key=lambda e: e["dur"], reverse=True)
        if spans:
            print(f"\ntrace tail critical path (top "
                  f"{min(len(spans), limit)} of {len(spans)} spans):")
            for e in spans[:limit]:
                print(f"  {e.get('name', '?'):32} "
                      f"{e['dur'] / 1e3:10.3f} ms")

    # Who was slowest when the incident fired: the trainer's fleet
    # block or the router's per-replica scrape detail, whichever the
    # last ringed record carries.
    last = records[-1] if records else {}
    fleet = last.get("fleet")
    if isinstance(fleet, dict) and fleet:
        keys = [k for k in ("slowest_rank", "slowest_rank_share",
                            "straggler_ratio", "rank_step_skew",
                            "dispatch_skew_ms", "wait_skew_ms",
                            "ranks_scraped") if k in fleet]
        if keys:
            print("\nfleet attribution (last record):")
            for k in keys:
                print(f"  {k:24} {fleet[k]}")
    per = (last.get("serve") or {}).get("per_replica")
    if isinstance(per, list) and per:
        slowest = max(
            (p for p in per if isinstance(p.get("p99_ms"), (int, float))),
            key=lambda p: p["p99_ms"], default=None,
        )
        print("\nreplica attribution (last record):")
        for p in per:
            mark = (" <- slowest" if slowest is not None
                    and p is slowest else "")
            print(
                f"  replica {p.get('index', '?')}: "
                f"healthy={p.get('healthy', '?')} "
                f"inflight={p.get('inflight', '?')} "
                f"p99_ms={p.get('p99_ms', 'n/a')}{mark}"
            )
    return 0


def summary_mode(paths: list, limit: int = 8) -> int:
    """The default mode: one stream's header, progression, alerts,
    compiles and end-of-run breakdown, or with several paths the
    per-rank merge."""
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
    _print_compiles(groups.get("compile", []))
    _print_autotune(groups.get("autotune", []))
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
        print("\nno heartbeat/final records (pre-telemetry stream or "
              "heartbeat_secs=0 and the run died before the final record)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fast_tffm_tpu_torch.tools.report",
        description="summarize metrics JSONLs, merge trace files, read "
                    "an incident bundle, or ratio-diff two runs"
    )
    ap.add_argument("paths", nargs="+",
                    help="metrics_file JSONL(s) (one per rank to merge "
                         "a fleet); trace JSON files with --trace; "
                         "exactly two artifacts with --compare")
    ap.add_argument("--limit", type=int, default=8,
                    help="train/validation rows (or slowest chains) to "
                         "show (default 8)")
    ap.add_argument("--trace", action="store_true",
                    help="treat paths as Chrome-trace span files: merge "
                         "onto one timeline and print the critical-path "
                         "summary")
    ap.add_argument("--serve-trace", action="store_true",
                    dest="serve_trace",
                    help="treat paths as SERVING trace files (router + "
                         "trace_file.replicaN family): per-request "
                         "critical-path breakdown (admit -> queue -> "
                         "coalesce -> dispatch -> respond) with "
                         "slowest-replica attribution")
    ap.add_argument("-o", "--out", default=None,
                    help="--trace: merged trace output path (default "
                         "<first>.merged.json)")
    ap.add_argument("--compare", action="store_true",
                    help="ratio-diff exactly two runs (metrics JSONLs "
                         "or bench JSONs); exit 2 on regression")
    ap.add_argument("--timeline", action="store_true",
                    help="trend view over a stack of bench JSONs "
                         "(BENCH_r*.json): per-key sparkline + "
                         "first-regression attribution using the "
                         "--compare direction vocabulary")
    ap.add_argument("--incident", action="store_true",
                    help="treat the single path as a blackbox incident "
                         "bundle dir (incidents/<ts>_<reason>/): print "
                         "the rule fired, signal trajectories, the "
                         "trace-tail critical path, and slowest rank/"
                         "replica attribution")
    ap.add_argument("--threshold", action="append", default=None,
                    metavar="FLOAT|KEY=FLOAT",
                    help="--compare: regression flag threshold "
                         "(default 0.05 = 5%%); repeat for per-key "
                         "overrides, e.g. --threshold "
                         "ingest_wait_frac=0.10 --threshold "
                         "default=0.05")
    args = ap.parse_args(argv)
    if args.incident:
        if len(args.paths) != 1:
            ap.error("--incident takes exactly one bundle directory")
        return incident_mode(args.paths[0], args.limit)
    if args.serve_trace:
        return serve_trace_mode(args.paths, args.out, args.limit)
    if args.trace:
        return trace_mode(args.paths, args.out, args.limit)
    if args.timeline:
        return timeline_mode(
            args.paths, parse_thresholds(args.threshold)
        )
    if args.compare:
        if len(args.paths) != 2:
            ap.error("--compare takes exactly two paths")
        return compare_mode(
            args.paths[0], args.paths[1],
            parse_thresholds(args.threshold),
        )
    return summary_mode(args.paths, args.limit)


if __name__ == "__main__":
    sys.exit(main())
