"""The FmScorer and FmGrad kernels' times across embedding widths, in
both modes, and the layout probe's K2P across row widths.

    python -m fast_tffm_tpu_torch.tools.fm_widths

Needs a CUDA device.  At F = 39 features, for each mode (f32, bf16),
width D in {2, 9, 17, 33} and batch B in {64, 1024, 4096}, the same
seeded inputs go through ``ops.fm_kernels.fm_scores_cuda`` (rows and
values) and ``ops.fm_kernels.fm_grad_cuda`` (rows, values and seeded
f32 ``s1`` and ``dscores``).  K2P (``tools.micro_probe.k2p_entries``)
takes packed ``[V/8, 128]`` tables (V = 2^22) at D in {2, 4, 8, 9, 12,
16} and two seeded streams of uniform ids with one hot id: a training
batch's (B = 4096 x F ids) and the probe's (16384 x F).  It prints the
card's name and power limit, then one JSON line: per kernel and shape
the kernel's time per call in a CUDA graph (the median of 7 replays of
a graph of 100 calls; every shape of every kernel timed once, then
again in the reverse order) and a SHA-256 of its outputs (the
FmScorer's scores, then ``s1``; FmGrad's ``drows`` in the rows' type;
K2P's two tables after one call on fresh copies), and for FmGrad
whether ``drows`` equals its plain version's bit for bit.

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
K2P_VOCAB = 1 << 22
K2P_WIDTHS = (2, 4, 8, 9, 12, 16)
K2P_STREAMS = {"batch": 4096 * F, "probe": 16384 * F}
K2P_HOT = 5000  # occurrences of the hot id


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


def k2p_stream(n: int, d: int, dev):
    """K1's stream of ``n`` uniform ids over the table, the first
    ``K2P_HOT`` one id: ``urows [U]`` i32 and ``sums [U, 2D]`` =
    ``[g | g^2 + noise]``, made from a seed."""
    rng = np.random.default_rng(n + d)
    ids = rng.integers(0, K2P_VOCAB, n)
    ids[:K2P_HOT] = 54321
    urows = np.unique(ids).astype(np.int32)
    g = rng.normal(size=(urows.size, d)) * 0.1
    g2 = g * g + rng.uniform(0.0, 0.01, size=g.shape)
    sums = np.concatenate([g, g2], axis=1).astype(np.float32)
    return torch.from_numpy(urows).to(dev), torch.from_numpy(sums).to(dev)


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
    from fast_tffm_tpu_torch.tools.micro_probe import k2p_entries

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
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = (torch.rand((K2P_VOCAB // 8, 128), generator=gen,
                         device=dev) * 0.2 - 0.1,
              torch.rand((K2P_VOCAB // 8, 128), generator=gen,
                         device=dev) * 0.9 + 0.1)
    work = tuple(t.clone() for t in tables)  # the timed calls' tables
    out["k2p"] = {}
    for d in K2P_WIDTHS:
        for stream, n in K2P_STREAMS.items():
            name = f"d{d}_{stream}"
            urows, sums = k2p_stream(n, d, dev)
            fresh = tuple(t.clone() for t in tables)
            k2p_entries(urows, sums, *fresh, lr=0.05, eps=1e-7)
            out["k2p"][name] = {"unique_rows": urows.numel(),
                                "graph_ms": [], "sha256": digest(*fresh)}
            del fresh
            calls["k2p", name] = (
                lambda u=urows, s=sums: k2p_entries(u, s, *work, lr=0.05,
                                                    eps=1e-7))
    for order in (list(calls), list(reversed(calls))):
        for kernel, name in order:
            out[kernel][name]["graph_ms"].append(
                graph_ms(calls[kernel, name]))
    print(json.dumps({"fm_widths": out, "F": F, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
