"""The fused K-step dispatch as one CUDA graph — the port's counterpart of
the reference's ``make_scan_train_step`` (``fast_tffm_tpu/train/loop.py``),
which compiles the K steps of a super-batch into one device program under
``lax.scan``, with no host round trip between them.

:class:`GraphedSteps` holds that program for the single-device sparse or
dense step, with the host sort meta (``host_sort = true``, the default)
or the device's (``host_sort = false``: ``ops/sparse_apply.py::
sort_meta`` is static):

- **The step it captures** is the trainer's own: ``steps(sb)`` runs the K
  steps of a super-batch on its views (``SuperBatch.step``: the whole
  ``seg_start`` slot, so no shape of K1's, K2's or K-place's depends on
  a batch's unique count), with the metrics and the health carry
  (``train/loop.py::HealthState``: each step's gradient-health pair, the
  touched rows and the device step counter) updated in place, so one
  replay advances the carry K times.  Nothing in it reads the device
  from the host.  The eager
  dispatches run the same function, so a replay is bitwise the K eager
  steps it stands for (the AUC histogram's float atomics are exact for
  0/1 weights only; the tables never depend on them).
- **Eager first.**  The first full super-batch runs eagerly: it trains,
  and it warms up everything the capture then records (the kernels'
  first launches, the autograd engine's device thread).  Then the K
  steps are captured on the views of a buffer of the graph's own;
  capture runs nothing, so no step trains twice.
- **Replay.**  Each later full super-batch is one ``copy_`` of its
  shipped buffer into that buffer (about 2.6 MB a step at B = 4096) and
  one ``replay()``, both on the current stream, after the stream's wait
  on the super-batch's copy event.
- **Capture beside the transfer thread.**  The transfer stage
  (``data/prefetch.py``) allocates pinned and device memory, copies on
  its own stream and waits on events; any of these on another thread
  can invalidate a capture in progress.  The stage is paused: the
  capture runs inside the ``pause`` context it is given (the trainer
  gives ``DevicePrefetcher.paused()``; the stage's parsing goes on).  The
  capture is taken
  by ``ops/launches.py::capture`` (thread-local capture errors, Python's
  garbage collector off).  ``GraphedSteps`` keeps no
  reference to the trainer, whose graph is then freed with it.
- **Launch counts.**  The kernels' wrappers count in Python, so the
  capture counts launches that did not run and a replay counts none.
  The capture's counts are taken back (``ops/launches.py``) and added
  again at each replay: ``.launches`` still counts the launches that
  ran.  A step of the
  ``jnp`` or ``flat`` interaction (``interaction_impl = reference`` or
  ``packed``) captures plain ops, and ``flat`` its two ``torch.matmul``
  products, in place of FmScorer and FmGrad: such a graph counts no
  FmScorer or FmGrad launch, and its K1 and K2 (or K1's merge mode and
  K-place) as any other.
- **Failures raise.**  A capture or replay that fails raises; nothing
  falls back to the eager steps.

An epoch tail (K' < K) runs eagerly, as do the tiered trainer (its
migration's plan buffers change with each super-batch), a rank mesh
(gloo stages every collective through pinned host memory; under NCCL
the process group's teardown hung after a graphed run) and the CPU
(``train/loop.py::Trainer._eager_reason`` decides).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from fast_tffm_tpu_torch.data.prefetch import SuperBatch, rebase
from fast_tffm_tpu_torch.ops import launches
from fast_tffm_tpu_torch.ops.launches import COUNTERS

__all__ = ["COUNTERS", "GraphedSteps"]


class GraphedSteps:
    """The K steps of a full super-batch as one CUDA graph, captured from
    the first full super-batch it is given."""

    def __init__(self, k: int):
        self.k = k
        self._graph = None
        self._input = None  # the graph's own super-batch views
        self._losses = None
        self._launches = None  # launches of each counter in one replay
        self.capture_s = 0.0

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def capture(self, sb: SuperBatch,
                steps: Callable[[SuperBatch], torch.Tensor],
                pause=None) -> None:
        """Capture ``steps`` (super-batch -> its steps' losses ``[K]``) on
        the views of a new buffer of ``sb``'s layout, inside ``pause``
        (a context manager that holds every other thread's CUDA calls:
        the transfer stage's ``paused()``), if given.  Runs nothing on the
        device."""
        if sb.n != self.k or sb.buffer is None or not sb.buffer.is_cuda:
            raise ValueError(
                f"GraphedSteps captures a shipped CUDA super-batch of "
                f"{self.k} steps, got {sb.n} steps on "
                f"{None if sb.buffer is None else sb.buffer.device}")
        t0 = time.perf_counter()
        views = rebase(sb, torch.empty_like(sb.buffer))
        graph, losses, counted = launches.capture(lambda: steps(views),
                                                  pause)
        self._graph, self._input, self._losses = graph, views, losses
        self._launches = counted
        self.capture_s = time.perf_counter() - t0

    def replay(self, sb: SuperBatch) -> torch.Tensor:
        """Train ``sb``'s K steps: one copy into the graph's input, one
        replay.  Returns the steps' losses ``[K]``, a tensor of the graph
        that the next replay overwrites."""
        self._input.buffer.copy_(sb.buffer)
        self._graph.replay()
        launches.add_counts(self._launches)
        return self._losses

    def pool_bytes(self) -> int:
        """Bytes the graph's private memory pool holds on the device."""
        pool = self._graph.pool()
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
