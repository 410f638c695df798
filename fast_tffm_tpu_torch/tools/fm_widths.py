"""The FmScorer and FmGrad kernels' times across embedding widths, in
both modes.

    python -m fast_tffm_tpu_torch.tools.fm_widths

Needs a CUDA device.  At F = 39 features, for each mode (f32, bf16),
width D in {2, 9, 17, 33} and batch B in {64, 1024, 4096}, the same
seeded inputs go through ``ops.fm_kernels.fm_scores_cuda`` (rows and
values) and ``ops.fm_kernels.fm_grad_cuda`` (rows, values and seeded
f32 ``s1`` and ``dscores``).  It prints the card's name and power limit,
then one JSON line: per kernel and shape the kernel's time per call in a
CUDA graph (the median of 7 replays of a graph of 100 calls; every shape
of both kernels timed once, then again in the reverse order) and a
SHA-256 of its outputs (the FmScorer's scores, then ``s1``; FmGrad's
``drows`` in the rows' type), and for FmGrad whether ``drows`` equals
its plain version's bit for bit.

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
    features padded with value 0) in ``dtype``, and FmGrad's f32 ``s1
    [b, d-1]`` and ``dscores [b]``, made from a seed."""
    rng = np.random.default_rng(1000 * d + b)
    rows = (rng.normal(size=(b, F, d)) * 0.3).astype(np.float32)
    vals = rng.uniform(0.0, 1.0, size=(b, F)).astype(np.float32)
    vals[np.arange(F)[None, :] >= rng.integers(1, F + 1, size=(b, 1))] = 0.0
    s1 = rng.normal(size=(b, d - 1)).astype(np.float32)
    dscores = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    return (torch.from_numpy(rows).to(dev, dtype),
            torch.from_numpy(vals).to(dev, dtype),
            torch.from_numpy(s1).to(dev), torch.from_numpy(dscores).to(dev))


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in turn (bf16 as its 16-bit
    patterns)."""
    h = hashlib.sha256()
    for t in tensors:
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    if not torch.cuda.is_available():
        print("fm_widths: needs a CUDA device", file=sys.stderr)
        return 1
    from fast_tffm_tpu_torch.ops.fm_kernels import (
        fm_grad_cuda, fm_grad_plain, fm_scores_cuda,
    )

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(card, flush=True)
    shapes = {f"{mode}_d{d}_b{b}": inputs(b, d, dtype, dev)
              for mode, dtype in MODES.items() for d in WIDTHS
              for b in BATCHES}
    calls = {}  # (kernel, shape) -> the call
    out = {"fm_scores": {}, "fm_grad": {}}
    for name, (rows, vals, s1, dscores) in shapes.items():
        calls["fm_scores", name] = (
            lambda r=rows, v=vals: fm_scores_cuda(r, v))
        calls["fm_grad", name] = (
            lambda r=rows, v=vals, s=s1, g=dscores: fm_grad_cuda(r, v, s, g))
        out["fm_scores"][name] = {"graph_ms": [], "sha256": digest(
            *fm_scores_cuda(rows, vals))}
        drows = fm_grad_cuda(rows, vals, s1, dscores)
        out["fm_grad"][name] = {
            "graph_ms": [], "sha256": digest(drows),
            "equals_plain": digest(drows) == digest(
                fm_grad_plain(rows, vals, s1, dscores)),
        }
    for order in (list(calls), list(reversed(calls))):
        for kernel, name in order:
            out[kernel][name]["graph_ms"].append(
                graph_ms(calls[kernel, name]))
    print(json.dumps({"fm_widths": out, "F": F, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
