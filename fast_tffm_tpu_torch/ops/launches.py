"""The train step's kernel launch counters, and the one way the port
captures a CUDA graph with them kept honest.

Each kernel wrapper counts its launches in Python, so a capture counts
launches that did not run and a replay counts none.  :func:`capture`
takes the capture's counts back and returns them, and the caller adds
them again at each replay (:func:`add_counts`): a counter still counts
the launches that ran.  ``train/dispatch.py::GraphedSteps`` (the K-step
dispatch) and ``ops/autotune.py`` (the train context timed as a replay)
both capture through it.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from fast_tffm_tpu_torch.ops import fm_kernels, sparse_apply

__all__ = ["COUNTERS", "add_counts", "capture", "counts"]

# Every kernel wrapper a train step can launch, with its launch counter.
COUNTERS = (
    (fm_kernels.fm_scores_cuda, "launches"),
    (fm_kernels.fm_scores_cuda, "launches_bf16"),
    (fm_kernels.fm_grad_cuda, "launches"),
    (fm_kernels.fm_grad_cuda, "launches_bf16"),
    (sparse_apply.k1_dedup_cuda, "launches"),
    (sparse_apply.k2_apply_cuda, "launches"),
    (sparse_apply.k1_merge_cuda, "launches"),
    (sparse_apply.kplace_cuda, "launches"),
)


def counts() -> list:
    """Each counter of :data:`COUNTERS`, in order."""
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def add_counts(delta) -> None:
    """Add ``delta`` (one number per counter) to the counters."""
    for (fn, attr), n in zip(COUNTERS, delta):
        setattr(fn, attr, getattr(fn, attr) + n)


def capture(fn, pause=None):
    """``fn()`` captured as one CUDA graph, inside ``pause`` (a context
    manager that holds every other thread's CUDA calls), if given.
    Returns ``(graph, out, counted)``: ``out`` is what ``fn`` returned
    (tensors of the graph, which each replay rewrites) and ``counted``
    the launches one replay makes, which the capture took back.

    The capture is taken with ``capture_error_mode="thread_local"``, so
    that the autograd engine's device thread, which runs a backward into
    the capturing stream, is not held to the capturing thread's rules;
    and with Python's garbage collector off, so that no unreachable CUDA
    graph or event of an earlier capture is destroyed inside it.  A
    capture that fails raises."""
    before = counts()
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()  # torch.cuda.graph collects once before it captures
    try:
        with pause or contextlib.nullcontext(), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    counted = [a - b for a, b in zip(counts(), before)]
    add_counts([-n for n in counted])  # the capture ran nothing
    return graph, out, counted
