"""Timing helpers of the port's probes — the counterpart of
``tools/timing.py``, with its protocol: two warm calls, each drained,
then ``steps`` calls on the host clock, the last one drained.

Draining waits until a result is computed: ``torch.cuda.synchronize()``
on the device of each CUDA tensor in it, nothing on the CPU (a CPU op
returns when its work is done).  A timed function returns what it
computed, the tensors it updated in place included, so there is
something to drain.
"""

from __future__ import annotations

import time

import torch

__all__ = ["bench", "drain"]


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def drain(tree) -> None:
    """Wait for every CUDA tensor in ``tree`` (a tensor, or nested
    tuples and lists of them)."""
    devices = {leaf.device for leaf in _leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def bench(fn, *args, steps=20) -> float:
    """Host-clock milliseconds per call of ``fn(*args)``."""
    for _ in range(2):
        drain(fn(*args))
    t0 = time.perf_counter()
    r = None
    for _ in range(steps):
        r = fn(*args)
    drain(r)
    return (time.perf_counter() - t0) * 1e3 / steps
