"""Runs of one cell in turn, each a process of its own, and their spread:

    python3 -m portbench.spread --workload <cell> --seeds <n> ... \\
        [--sets 2] [--seconds S] [--trace 0|1] [--compute-dtype bfloat16] \\
        [--out runs.jsonl]

The seeds are cut into ``--sets`` equal sets, run in order.  Each run's
record (its seed, exit code, wall seconds, result line, the end of its
standard error) goes to ``--out`` as one JSON line; then one summary line
per metric and per set: the median and the spread, the distance between
the first and third quartiles (``statistics.quantiles(values, n=4)``) as
a share of the median, and each compared number's largest reading.
``--seconds`` defaults to ``BENCHMARK.json``'s ``run_seconds``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values: list) -> float:
    """The quartiles' distance over the median (0 for fewer than 2)."""
    if len(values) < 2:
        return 0.0
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("inf")


def one_run(args, seed: int) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload",
           args.workload, "--seed", str(seed), "--seconds",
           str(args.seconds), "--trace", str(args.trace)]
    if args.compute_dtype:
        cmd += ["--compute-dtype", args.compute_dtype]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          check=False)
    rec = {"seed": seed, "rc": done.returncode,
           "wall_s": time.perf_counter() - t0,
           "stderr_tail": done.stderr[-2000:]}
    lines = done.stdout.strip().splitlines()
    if done.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def summarize(records: list, sets: int) -> list:
    out = []
    size = len(records) // sets
    for i in range(sets):
        part = [r["result"] for r in records[i * size:(i + 1) * size]
                if "result" in r]
        names = sorted({m for r in part for m in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in part
                    if name in r["metrics"]]
            out.append({"set": i, "metric": name, "n": len(vals),
                        "median": statistics.median(vals),
                        "spread": spread(vals), "values": vals})
        checks = sorted({c for r in part for c in r.get("checks", {})})
        out.append({"set": i, "correct": sum(r["correct"] for r in part),
                    "runs": len(part),
                    "checks_max": {c: max(r["checks"][c]["value"]
                                          for r in part) for c in checks}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.seconds is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            args.seconds = json.load(f)["run_seconds"]
    records = []
    for seed in args.seeds:
        rec = one_run(args, seed)
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec[k] for k in ("seed", "rc", "wall_s")}),
              flush=True)
    for row in summarize(records, args.sets):
        print(json.dumps(row), flush=True)
    return 0 if all(r["rc"] == 0 for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
