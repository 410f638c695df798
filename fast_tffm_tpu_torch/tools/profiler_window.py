"""How many kernels ``torch.profiler`` loses at the edges of its window.

    python -m fast_tffm_tpu_torch.tools.profiler_window \\
        [--seconds 120] [--margins 0 0.05 0.1] [--iters 20]

Traces, in turns for the ``--seconds`` given, a window of ``--iters``
calls of a small eager step (an elementwise op, a scan, a reduction and
a sort on the GPU) under the schedule ``chip_smoke.py``'s
``device_times_ms`` uses (one warm-up call traced and dropped), the host
pausing each ``--margins`` value in seconds after the window opens and
before it closes.  A window is short when its kernels' runs differ from
those of a window traced first with a half-second pause.  Prints one
JSON line per margin: the windows, the short ones, the first short
window's counts, and the least gap in ms between the host's first launch
and the first kernel's traced start (negative: the trace puts the kernel
before its launch).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

CALIBRATION_MARGIN_S = 0.5


def _step(a: torch.Tensor, b: torch.Tensor) -> None:
    a.add_(1.0)
    torch.cumsum(b, 0)
    a.sum()
    torch.sort(b)


def window(a: torch.Tensor, b: torch.Tensor, margin_s: float,
           iters: int) -> tuple[dict, float]:
    """One traced window: ``({kernel: runs}, first start - launch ms)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    _step(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        _step(a, b)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(margin_s)
        launched_ns = time.time_ns()
        for _ in range(iters):
            _step(a, b)
        torch.cuda.synchronize()
        time.sleep(margin_s)
        prof.step()
    runs = {ev.key[:60]: ev.count for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not ev.key.startswith("ProfilerStep")}
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    gap_ms = (min(starts) - launched_ns) / 1e6 if starts else float("nan")
    return runs, gap_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--margins", type=float, nargs="+",
                    default=[0.0, 0.05, 0.1])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_window: needs a CUDA GPU", file=sys.stderr)
        return 1
    a = torch.zeros(1 << 16, device="cuda")
    b = torch.rand(1 << 12, device="cuda")
    # What every window should count: one traced with a wide margin.
    want, _ = window(a, b, CALIBRATION_MARGIN_S, args.iters)
    if not want or any(n % args.iters for n in want.values()):
        print(f"profiler_window: the calibration window is short: {want}",
              file=sys.stderr)
        return 1
    seen = {m: {"margin_s": m, "windows": 0, "short": 0,
                "first_short": None, "min_gap_ms": float("inf")}
            for m in args.margins}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        for m in args.margins:
            runs, gap_ms = window(a, b, m, args.iters)
            rec = seen[m]
            rec["windows"] += 1
            rec["min_gap_ms"] = min(rec["min_gap_ms"], gap_ms)
            if runs != want:
                rec["short"] += 1
                if rec["first_short"] is None:
                    rec["first_short"] = runs
    for rec in seen.values():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
