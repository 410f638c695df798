"""The FmScorer kernel's time across embedding widths, in both modes.

    python -m fast_tffm_tpu_torch.tools.fm_widths

Needs a CUDA device.  At F = 39 features, for each mode (f32, bf16),
width D in {2, 9, 17, 33} and batch B in {64, 1024, 4096}, the same
seeded inputs go through ``ops.fm_kernels.fm_scores_cuda``.  It prints
the card's name and power limit, then one JSON line: per shape the
kernel's time per call in a CUDA graph (the median of 7 replays of a
graph of 100 calls; every shape timed once, then again in the reverse
order) and a SHA-256 of its outputs (scores, then ``s1``).

To compare two trees of this package on one card, run the script file
of either tree with the other tree first on the path, in turns
(``PYTHONPATH=TREE python fast_tffm_tpu_torch/tools/fm_widths.py``):
equal digests mean bitwise-equal outputs.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

F = 39
WIDTHS = (2, 9, 17, 33)
BATCHES = (64, 1024, 4096)
MODES = {"f32": torch.float32, "bf16": torch.bfloat16}


def graph_ms(fn, calls: int = 100, reps: int = 7) -> float:
    """Device milliseconds per call: ``calls`` calls captured in one CUDA
    graph, the median of ``reps`` replays between CUDA events."""
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
    return statistics.median(times)


def inputs(b: int, d: int, dtype, dev):
    """Rows ``[b, F, d]`` and vals ``[b, F]`` (each example's tail of
    features padded with value 0), made from a seed, in ``dtype``."""
    rng = np.random.default_rng(1000 * d + b)
    rows = (rng.normal(size=(b, F, d)) * 0.3).astype(np.float32)
    vals = rng.uniform(0.0, 1.0, size=(b, F)).astype(np.float32)
    vals[np.arange(F)[None, :] >= rng.integers(1, F + 1, size=(b, 1))] = 0.0
    return (torch.from_numpy(rows).to(dev, dtype),
            torch.from_numpy(vals).to(dev, dtype))


def main() -> int:
    if not torch.cuda.is_available():
        print("fm_widths: needs a CUDA device", file=sys.stderr)
        return 1
    from fast_tffm_tpu_torch.ops.fm_kernels import fm_scores_cuda

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(card, flush=True)
    shapes = {f"{mode}_d{d}_b{b}": inputs(b, d, dtype, dev)
              for mode, dtype in MODES.items() for d in WIDTHS
              for b in BATCHES}
    out = {}
    for name, (rows, vals) in shapes.items():
        scores, s1 = fm_scores_cuda(rows, vals)
        digest = hashlib.sha256(scores.cpu().numpy().tobytes()
                                + s1.cpu().numpy().tobytes()).hexdigest()
        out[name] = {"graph_ms": [], "sha256": digest}
    for order in (list(shapes), list(reversed(shapes))):
        for name in order:
            rows, vals = shapes[name]
            out[name]["graph_ms"].append(
                graph_ms(lambda: fm_scores_cuda(rows, vals)))
    print(json.dumps({"fm_widths": out, "F": F, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
