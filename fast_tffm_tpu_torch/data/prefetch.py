"""The transfer stage: parsed batches -> device super-batches, one copy each.

The port's counterpart of the reference's ``DevicePrefetcher``
(``fast_tffm_tpu/data/pipeline.py``), its ``_StagingPool`` and
``parallel/mesh.py::FusedShipper``, as one stage.  A background thread
takes batches from the source (a :class:`~.pipeline.BatchPipeline`)
and groups ``steps_per_dispatch = K`` of them; each group becomes one
:class:`SuperBatch`:

1. **staging**: every leaf of the K batches is written straight into
   ONE ``uint8`` host buffer, pinned when the device is ``cuda``, at
   128-byte-aligned offsets (:func:`layout`): labels, ids, vals, fields
   (only when ``with_fields``: plain FM never reads them), weights, and
   with the host sort meta ``perm [K, n]`` and ``seg_start`` in a slot
   of ``n + 1`` per batch (its first ``U + 1`` entries the batch's, the
   rest ``n``);
2. **copy**: ONE ``copy_(..., non_blocking=True)`` of that buffer into a
   device ``uint8`` buffer on a copy stream of the stage's own, and an
   event recorded after it;
3. **device side**: the leaves are views of the device buffer
   (``view(dtype)``, then ``view(shape)``): no kernel, no arithmetic.
   :meth:`SuperBatch.step` gives step ``i``'s :class:`Batch` of views,
   with the whole ``seg_start`` slot, which K1's and K2's static modes
   take (the shapes depend on ``n`` alone, not on the batch's unique
   count: a CUDA graph can hold them).  :func:`rebase` gives a
   super-batch's views of another buffer of its layout (a CUDA graph's
   fixed input).

The consumer's stream waits on a super-batch's event before its first
step reads it, and the device buffer is recorded on that stream, so the
allocator reuses it only after the steps that read it have run.  A
pinned staging buffer is refilled only after its copy's event has
completed: at most ``depth`` copies are in flight before the oldest is
waited for.  On the CPU the "copy" is the staging buffer itself (an
alias), so no staging buffer is ever recycled there.  A failure to pin
memory on ``cuda`` raises.

At most ``depth`` (``prefetch_super_batches``) shipped super-batches
wait for the consumer.  An :class:`~.pipeline.EpochEnd` marker from the
source flushes the pending group, which ships as a short super-batch
(K' = leftover), and is passed on, so a super-batch never spans two
epochs.  The range check of the ids (``feature ids must lie in [0,
vocabulary_size)``: an id outside would be a device-side assert) runs
here, off the training thread.  Exceptions from the source or the stage
re-raise in the consumer; :meth:`DevicePrefetcher.close` stops the
source and joins the thread.  :meth:`DevicePrefetcher.paused` holds the
stage between its CUDA calls (its parsing and filling go on) for as long
as the caller needs no other thread's CUDA call to run.

:func:`stack_batches` is the plain version: the same super-batch stacked
with numpy, which the views are held against in the tests.
``DevicePrefetcher.ships`` counts the super-batches every stage of the
process shipped, as the kernels' wrappers count launches.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from fast_tffm_tpu_torch.data.libsvm import Batch, SortMeta
from fast_tffm_tpu_torch.data.pipeline import EpochEnd
from fast_tffm_tpu_torch.data.queues import (
    CANCELLED, SENTINEL, ClosableQueue, WorkerError,
)
from fast_tffm_tpu_torch.platform import resolve_device

__all__ = ["DevicePrefetcher", "SuperBatch", "layout", "rebase",
           "stack_batches"]

_ALIGN = 128  # byte alignment of each leaf in the staging buffer


class SuperBatch(NamedTuple):
    """K batches stacked on a leading axis (numpy on the host, views of
    one device buffer once shipped).  ``sort_meta`` holds ``perm [K, n]``
    and ``seg_start [K, n + 1]`` (each row's first ``U + 1`` entries the
    batch's, the rest ``n``); ``fields`` is None when not shipped;
    ``buffer`` is the one ``uint8`` buffer the shipped leaves view (None
    for :func:`stack_batches`)."""

    batch: Batch
    n: int  # K, or an epoch tail's K' < K
    buffer: Optional[torch.Tensor] = None

    def step(self, i: int) -> Batch:
        """Step ``i``'s batch: views of the stacked leaves, with the
        whole ``seg_start`` slot ``[n + 1]`` (its tail past U padded with
        ``n``), so no shape depends on the batch's U."""
        b = self.batch
        meta = None
        if b.sort_meta is not None:
            meta = SortMeta(b.sort_meta.perm[i], b.sort_meta.seg_start[i])
        return Batch(b.labels[i], b.ids[i], b.vals[i],
                     None if b.fields is None else b.fields[i],
                     b.weights[i], meta)


def layout(k: int, bsz: int, f: int, with_fields: bool, with_meta: bool):
    """``([(name, dtype, shape, offset, nbytes), ...], total bytes)`` of a
    K-batch staging buffer."""
    n = bsz * f
    spec = [("labels", np.float32, (k, bsz)), ("ids", np.int32, (k, bsz, f)),
            ("vals", np.float32, (k, bsz, f))]
    if with_fields:
        spec.append(("fields", np.int32, (k, bsz, f)))
    spec.append(("weights", np.float32, (k, bsz)))
    if with_meta:
        spec += [("perm", np.int32, (k, n)),
                 ("seg_start", np.int32, (k, n + 1))]
    out, off = [], 0
    for name, dtype, shape in spec:
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        out.append((name, np.dtype(dtype), shape, off, nbytes))
        off += -(-nbytes // _ALIGN) * _ALIGN
    return out, off


def _cols(group: Sequence[Batch], name: str) -> list:
    if name in ("perm", "seg_start"):
        return [getattr(b.sort_meta, name) for b in group]
    return [getattr(b, name) for b in group]


def _fill(dst: np.ndarray, name: str, cols: list) -> None:
    """Write one leaf of every batch into its ``[K, ...]`` slot."""
    if name != "seg_start":
        for i, c in enumerate(cols):
            dst[i] = c
        return
    for i, c in enumerate(cols):
        dst[i, :c.shape[0]] = c
        dst[i, c.shape[0]:] = dst.shape[1] - 1  # n


def _assemble(leaves: dict, k: int, buffer=None) -> SuperBatch:
    meta = None
    if "perm" in leaves:
        meta = SortMeta(leaves["perm"], leaves["seg_start"])
    return SuperBatch(Batch(leaves["labels"], leaves["ids"], leaves["vals"],
                            leaves.get("fields"), leaves["weights"], meta),
                      k, buffer)


def _views(buffer: torch.Tensor, spec) -> dict:
    """Every leaf of ``spec`` as a view of the ``uint8`` ``buffer``."""
    return {name: buffer[off:off + nbytes].view(_TORCH[dtype]).view(shape)
            for name, dtype, shape, off, nbytes in spec}


def rebase(sb: SuperBatch, buffer: torch.Tensor) -> SuperBatch:
    """``sb``'s leaves as views of ``buffer``, another ``uint8`` buffer of
    the same layout (what a CUDA graph reads: its input at a fixed
    address, refilled by one copy of ``sb.buffer``)."""
    b = sb.batch
    spec, total = layout(sb.n, *b.ids.shape[1:], b.fields is not None,
                         b.sort_meta is not None)
    if buffer.dtype != torch.uint8 or tuple(buffer.shape) != (total,):
        raise ValueError(
            f"rebase takes a uint8 buffer of {total} bytes, got "
            f"{buffer.dtype} {tuple(buffer.shape)}")
    return _assemble(_views(buffer, spec), sb.n, buffer)


def stack_batches(group: Sequence[Batch],
                  with_fields: bool = True) -> SuperBatch:
    """The plain version of a shipped super-batch: the group's leaves
    stacked with numpy, ``seg_start`` padded to ``n + 1`` as the staging
    buffer holds it.  The sort meta rides along when every batch has
    one."""
    if not group:
        raise ValueError("stack_batches needs at least one batch")
    b0 = group[0]
    with_meta = all(b.sort_meta is not None for b in group)
    spec, _ = layout(len(group), *b0.ids.shape, with_fields, with_meta)
    leaves = {}
    for name, dtype, shape, _, _ in spec:
        leaves[name] = np.empty(shape, dtype)
        _fill(leaves[name], name, _cols(group, name))
    return _assemble(leaves, len(group))


class DevicePrefetcher:
    """Ships ``source``'s batches to ``device`` as super-batches of
    ``steps_per_dispatch``; iterate for :class:`SuperBatch` es of device
    views (and the source's :class:`~.pipeline.EpochEnd` markers)."""

    ships = 0  # super-batches shipped by every stage of the process

    def __init__(self, source, steps_per_dispatch: int, device,
                 vocabulary_size: int, depth: int = 2,
                 with_fields: bool = False):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._k = max(1, steps_per_dispatch)
        self._vocab = vocabulary_size
        self._depth = max(1, depth)
        self._with_fields = with_fields
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self._cuda else None)
        # Held around each of the stage's CUDA calls (pinned and device
        # allocation, copy, event record and wait), and by paused().
        self._cuda_calls = threading.Lock()
        self._free: dict = {}  # total bytes -> [pinned staging buffer]
        self._inflight: deque = deque()  # (event, total, staging)
        self._source = source
        self._out = ClosableQueue(self._depth)
        self._thread = threading.Thread(
            target=self._run, args=(iter(source),), daemon=True,
            name="tffm-torch-prefetch")
        self._thread.start()

    # -- the transfer thread -------------------------------------------

    def _run(self, it) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            group: list = []
            for item in it:
                if isinstance(item, EpochEnd):
                    if group and not self._ship(group):
                        return
                    group = []
                    if not self._out.put(item):
                        return
                    continue
                group.append(item)
                if len(group) == self._k:
                    if not self._ship(group):
                        return
                    group = []
            if group:
                self._ship(group)  # the stream's tail: K' = leftover
        except BaseException as e:  # surfaces in the consumer
            self._out.put(WorkerError(e))
        finally:
            self._out.put(SENTINEL)
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _check_ids(self, group) -> None:
        for b in group:
            if b.ids.size and (b.ids.min() < 0 or b.ids.max() >= self._vocab):
                # The parser reduces ids modulo the vocabulary; an id
                # outside it would be a device-side assert on the GPU.
                raise ValueError(
                    f"feature ids must lie in [0, {self._vocab})")

    def _staging(self, total: int) -> torch.Tensor:
        free = self._free.get(total)
        if free:
            return free.pop()
        # Pinned on cuda (a failure to pin raises); the CPU needs none.
        return torch.empty((total,), dtype=torch.uint8,
                           pin_memory=self._cuda)

    def _retire(self, event, total: int, staging: torch.Tensor) -> None:
        """Queue a staging buffer behind its copy; recycle the oldest
        once more than ``depth`` copies are in flight."""
        self._inflight.append((event, total, staging))
        while len(self._inflight) > self._depth:
            ev, t, buf = self._inflight.popleft()
            ev.synchronize()
            self._free.setdefault(t, []).append(buf)

    def _ship(self, group) -> bool:
        self._check_ids(group)
        with_meta = all(b.sort_meta is not None for b in group)
        k = len(group)
        spec, total = layout(k, *group[0].ids.shape, self._with_fields,
                             with_meta)
        with self._cuda_calls:
            staging = self._staging(total)
        host = staging.numpy()
        for name, dtype, shape, off, nbytes in spec:
            _fill(host[off:off + nbytes].view(dtype).reshape(shape), name,
                  _cols(group, name))
        event = None
        if self._cuda:
            with self._cuda_calls, torch.cuda.stream(self._stream):
                dev = torch.empty((total,), dtype=torch.uint8,
                                  device=self.device)
                dev.copy_(staging, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
                self._retire(event, total, staging)
        else:
            dev = staging  # an alias: never recycled
        sb = _assemble(_views(dev, spec), k, dev)
        DevicePrefetcher.ships += 1
        return self._out.put((sb, event, dev))

    # -- the consumer --------------------------------------------------

    def paused(self):
        """A context manager that holds the stage between its CUDA calls
        for the body of the ``with``: no allocation, copy, event record or
        wait of the stage's runs meanwhile."""
        return self._cuda_calls

    def __iter__(self):
        try:
            while True:
                got = self._out.get()
                if got is SENTINEL or got is CANCELLED:
                    return
                if isinstance(got, WorkerError):
                    raise got.exc
                if isinstance(got, EpochEnd):
                    yield got
                    continue
                sb, event, dev = got
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    dev.record_stream(stream)
                yield sb
        finally:
            self.close()

    def close(self) -> None:
        """Stop the source and the transfer thread and wait for them
        (idempotent)."""
        self._out.cancel()
        close = getattr(self._source, "close", None)
        if close is not None:
            close()
        if self._thread is not threading.current_thread():
            self._thread.join()


_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(np.int32): torch.int32}
