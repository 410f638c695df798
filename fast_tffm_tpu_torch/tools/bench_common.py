"""What the smoke (``chip_smoke.py``) and the kernel benchmarks
(``tools/k1_bench.py``, ``tools/kplace_bench.py``) share: the card's
peak rates, a kernel's bound, the copies of its inputs that send its
reads to HBM, K1's bound and its ``index_add_`` yardstick, and an
``nvcc`` build of one source.  Importing this module imports neither
``torch`` nor the kernels.
"""

from __future__ import annotations

import ctypes
import itertools
import math
import os
import subprocess

# NVIDIA H100 SXM data sheet peaks (at the full 700 W power limit):
# HBM3 bandwidth and the non-tensor-core float32 rate; and its L2.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
L2_BYTES = 50 * 2**20

__all__ = [
    "L2_BYTES", "PEAK_BYTES_PER_S", "PEAK_F32_FLOPS", "bound", "build_lib",
    "in_turn", "k1_bound_ms", "k1_library", "l2_copies",
]


def bound(nbytes: float, ops: float):
    """``(ms, "bytes" | "operations")``: the larger of the bytes over
    HBM bandwidth and the f32 operations over the f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def l2_copies(bound_ms: float) -> int:
    """The copies of a call's inputs to take in turn so that its timed
    reads come from HBM, not the L2: enough that the bytes its bound
    counts (``bound_ms`` at HBM bandwidth) pass twice the L2 before a
    copy comes round again."""
    return max(1, math.ceil(2 * L2_BYTES / (bound_ms * 1e-3
                                             * PEAK_BYTES_PER_S)))


def in_turn(fn, copies: list):
    """A call of ``fn`` on the next of ``copies`` (argument tuples)."""
    turn = itertools.cycle(copies)
    return lambda: fn(*next(turn))


def k1_bound_ms(n: int, u: int, d: int, slot: int = 0,
                square: bool = True):
    """K1 over ``n`` real occurrences (a sentinel's are never read) of a
    ``[., d]`` payload: the payload and perm read, ids once per unique id
    (at its segment's first occurrence), ``seg_start`` read and a row id
    written for each of the ``slot`` segments it covers (``u`` on the cut
    slot, the default; ``n`` on the whole slot); the ``u`` rows of sums
    written (nothing reads sums past U, and the kernel writes none).  Per
    occurrence and column, in dedup mode (``square``): g, g*g, two adds;
    in merge mode one add."""
    slot = slot or u
    w = (2 if square else 1) * d
    return bound(4 * (n * d + n + u + (slot + 1) + slot + w * u),
                 (3 if square else 1) * n * d)


def k1_library(payload, perm, seg_start, square: bool = True):
    """K1's library yardstick: a call of one ``index_add_`` of the real
    occurrences' payload (``[g | g^2]`` in dedup mode) over their
    segments, in their own (unsorted) order, into ``[U, W]`` sums
    allocated beforehand."""
    import torch

    dev = payload.device
    u = seg_start.numel() - 1
    n_real = int(seg_start[-1])
    seg_sorted = torch.repeat_interleave(
        torch.arange(u, device=dev), (seg_start[1:] - seg_start[:-1]).long(),
        output_size=n_real)
    if square:
        payload = torch.cat([payload, payload * payload], dim=1)
    if n_real == payload.shape[0]:
        seg = torch.empty_like(seg_sorted)
        seg[perm.long()] = seg_sorted
    else:
        # A sentinel's occurrences (past seg_start[U]) are left out.
        seg = torch.full((payload.shape[0],), -1, dtype=torch.long,
                         device=dev)
        seg[perm[:n_real].long()] = seg_sorted
        own = torch.nonzero(seg >= 0).squeeze(1)
        payload, seg = payload.index_select(0, own), seg.index_select(0, own)
    out = torch.zeros((u, payload.shape[1]), device=dev)
    return lambda: out.index_add_(0, seg, payload)


def build_lib(out_dir: str, name: str, src: str, include: str = ""):
    """``nvcc`` one source (for the kernels' arch, with ``ptxas -v``)
    into ``out_dir/lib<name>.so`` and load it: ``(lib, log)``, the log
    being ``nvcc``'s output."""
    from fast_tffm_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}.so")
    cmd = [_build._nvcc(), _build._ARCH, "-std=c++17", "-O3", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-shared", "-o", lib, src]
    if include:
        cmd[1:1] = ["-I", include]
    done = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if done.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{done.stdout}"
                           f"{done.stderr}")
    return ctypes.CDLL(lib), done.stdout + done.stderr
