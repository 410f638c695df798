"""The transfer stage: parsed batches -> device super-batches, one copy each.

The port's counterpart of the reference's ``DevicePrefetcher``
(``fast_tffm_tpu/data/pipeline.py``), its ``_StagingPool`` and
``parallel/mesh.py::FusedShipper``, as one stage.  A background thread
takes batches from the source (a :class:`~.pipeline.BatchPipeline`)
and groups ``steps_per_dispatch = K`` of them; each group becomes one
:class:`SuperBatch`:

1. **staging** (:class:`Packer`): every leaf of the K batches is
   written straight into ONE ``uint8`` host buffer, pinned when the
   device is ``cuda``, at 128-byte-aligned offsets (:func:`layout`):
   labels, ids, vals, fields (only when ``with_fields``: plain FM never
   reads them), weights, and with the host sort meta ``perm [K, n]``
   and ``seg_start`` in a slot of ``n + 1`` per batch (its first ``U +
   1`` entries the batch's, the rest ``n``);
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

**The prestacked ship.**  With the prestacked epoch cache
(``cache_prestacked``) the source delivers :class:`PackedGroup` s: groups
the pipeline packed once, through the same :class:`Packer`, at epoch
0's group boundaries, and replays in later epochs.  The stage ships
such a group with no fill and no range check (both ran at its packing):
one copy of its buffer, which it holds until the copy's event and never
recycles or refills, since the cache owns it.  A pending group of plain
batches (a resume's tail) ships first, as a short super-batch.

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
process shipped, as the kernels' wrappers count launches: ``fills``
those it filled itself and ``prestack_hits`` the packed groups.  A
``telemetry`` registry given to the stage gets the reference's
instruments: ``prefetch.stack`` (a fill), ``prefetch.device_put`` (the
copy's enqueue), ``prefetch.out_block`` (waiting for the consumer),
``prefetch.out_q_depth``, ``prefetch.super_batches`` and
``prefetch.prestack_hits``.  A ``tracer`` (``obs/trace.py``) gets the
reference's spans, joined by super-batch id ``sb`` (ships in order, as
the consumer dispatches them): ``prefetch.stack`` (the plan and the fill;
``batch0`` and ``n`` name the delivered batches it holds) and
``prefetch.h2d`` (the copy's enqueue; a prestacked group's carries the
batch range itself), linked by ``sb<N>`` flows to the trainer's
``train.dispatch``, and ``prefetch.staging_wait`` when the stage waits
for an old copy before recycling its buffer.  With ``host_targets`` each
super-batch carries host copies of its labels and weights
(:attr:`SuperBatch.host`), taken from the staging buffer before it can
be recycled.

**The tiered plan** (``table_tiering = on``).  A ``plan_hook`` is called
on each group after the range check of its LOGICAL ids (at the
logical vocabulary) and before the fill: ``hook(group) -> (group',
plan)`` gives the group with its ids remapped to hot slots and a
``train.tiered.Plan``, whose arrays (``plan.leaves()``: the padded load
slots, each store's loaded rows, the evict slots) are packed into the
same staging buffer after the batch's leaves and ride the same single
copy, so one event covers all of it.  The stage then puts
``plan.ship(super-batch, views)``, a ``train.tiered.Shipment``, in
place of the super-batch.  A packed group of the prestacked cache
holds logical ids and its buffer belongs to the cache, so under a hook
its batches take the ordinary fill (``fills`` counts it,
``prestack_hits`` does not); the stream's order stays the cache's.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from fast_tffm_tpu_torch.data.libsvm import Batch, SortMeta
from fast_tffm_tpu_torch.data.pipeline import EpochEnd
from fast_tffm_tpu_torch.data.queues import (
    CANCELLED, SENTINEL, ClosableQueue, WorkerError,
)
from fast_tffm_tpu_torch.obs.telemetry import NULL, Telemetry
from fast_tffm_tpu_torch.obs.trace import NULL_TRACER
from fast_tffm_tpu_torch.platform import resolve_device

__all__ = ["DevicePrefetcher", "PackedGroup", "Packer", "SuperBatch",
           "layout", "rebase", "stack_batches"]

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
    # ``(labels [n, B], weights [n, B])`` host copies taken from the
    # staging buffer when the stage ships ``host_targets`` (the quality
    # plane reads them one dispatch late, never from the device).
    host: Optional[tuple] = None

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


def layout(k: int, bsz: int, f: int, with_fields: bool, with_meta: bool,
           extra: Sequence = ()):
    """``([(name, dtype, shape, offset, nbytes), ...], total bytes)`` of a
    K-batch staging buffer; ``extra`` (``[(name, array), ...]``: a tiered
    plan's arrays) follows the batch's leaves."""
    n = bsz * f
    spec = [("labels", np.float32, (k, bsz)), ("ids", np.int32, (k, bsz, f)),
            ("vals", np.float32, (k, bsz, f))]
    if with_fields:
        spec.append(("fields", np.int32, (k, bsz, f)))
    spec.append(("weights", np.float32, (k, bsz)))
    if with_meta:
        spec += [("perm", np.int32, (k, n)),
                 ("seg_start", np.int32, (k, n + 1))]
    spec += [(name, a.dtype, a.shape) for name, a in extra]
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


def _host_views(buffer: torch.Tensor, spec) -> dict:
    """Every leaf of ``spec`` as a numpy view of the host ``buffer``."""
    host = buffer.numpy()
    return {name: host[off:off + nbytes].view(dtype).reshape(shape)
            for name, dtype, shape, off, nbytes in spec}


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


class PackedGroup(NamedTuple):
    """``n`` parsed batches packed once into one ``uint8`` host buffer
    (pinned on ``cuda``) in :func:`layout` form: the prestacked epoch
    cache's unit, which the transfer stage ships with no fill and never
    recycles."""

    buffer: torch.Tensor
    spec: list  # layout(...)[0]
    n: int

    @property
    def nbytes(self) -> int:
        return self.buffer.numel()

    def batches(self, start: int = 0) -> list:
        """Steps ``start .. n - 1`` as host :class:`Batch` views of the
        buffer (each with the whole ``seg_start`` slot): the tail a resume
        inside the group delivers."""
        sb = _assemble(_host_views(self.buffer, self.spec), self.n)
        return [sb.step(i) for i in range(start, self.n)]


class Packer:
    """Packs a group of parsed batches into one staging buffer in
    :func:`layout` form, pinned when the device is ``cuda`` (a failure to
    pin raises), after the range check of its ids (``feature ids must lie
    in [0, vocabulary_size)``: an id outside would be a device-side
    assert).  The transfer stage fills its recycled staging buffers
    through it, and the prestacked epoch cache packs each group once
    with :meth:`pack` (``BatchPipeline(prestack=(k, packer.pack))``), so
    the check runs once on every freshly parsed group and never on a
    replay.  ``lock`` is held around each CUDA call of the packer and of
    the stage that uses it."""

    def __init__(self, device, vocabulary_size: int,
                 with_fields: bool = False):
        self.pin = resolve_device(device).type == "cuda"
        self.vocabulary_size = vocabulary_size
        self.with_fields = with_fields
        self.lock = threading.Lock()

    def layout_of(self, group: Sequence[Batch], extra: Sequence = ()):
        """:func:`layout` of ``group`` (and ``extra``): ``(spec, total
        bytes)``."""
        with_meta = all(b.sort_meta is not None for b in group)
        return layout(len(group), *group[0].ids.shape, self.with_fields,
                      with_meta, extra)

    def alloc(self, total: int) -> torch.Tensor:
        with self.lock:
            return torch.empty((total,), dtype=torch.uint8,
                               pin_memory=self.pin)

    def check(self, group: Sequence[Batch]) -> None:
        """The range check of ``group``'s ids."""
        vocab = self.vocabulary_size
        for b in group:
            if b.ids.size and (b.ids.min() < 0 or b.ids.max() >= vocab):
                # The parser reduces ids modulo the vocabulary; an id
                # outside it would be a device-side assert on the GPU.
                raise ValueError(f"feature ids must lie in [0, {vocab})")

    def fill(self, group: Sequence[Batch], buffer: torch.Tensor, spec,
             extra: Sequence = (), checked: bool = False) -> None:
        """Write ``group`` (range-checked here unless ``checked``) and
        ``extra``'s arrays into ``buffer`` (of ``spec``'s layout)."""
        if not checked:
            self.check(group)
        arrays = dict(extra)
        for name, leaf in _host_views(buffer, spec).items():
            if name in arrays:
                leaf[...] = arrays[name]
            else:
                _fill(leaf, name, _cols(group, name))

    def pack(self, group: Sequence[Batch]) -> PackedGroup:
        """``group`` in a buffer of its own (never recycled)."""
        spec, total = self.layout_of(group)
        buffer = self.alloc(total)
        self.fill(group, buffer, spec)
        return PackedGroup(buffer, spec, len(group))


class DevicePrefetcher:
    """Ships ``source``'s batches to ``device`` as super-batches of
    ``steps_per_dispatch``; iterate for :class:`SuperBatch` es of device
    views (and the source's :class:`~.pipeline.EpochEnd` markers)."""

    ships = 0  # super-batches shipped by every stage of the process
    fills = 0  # of them, groups the stage filled itself
    prestack_hits = 0  # and packed groups it shipped with no fill

    def __init__(self, source, steps_per_dispatch: int, device,
                 vocabulary_size: int, depth: int = 2,
                 with_fields: bool = False,
                 packer: Optional[Packer] = None,
                 plan_hook=None, telemetry: Optional[Telemetry] = None,
                 tracer=None, host_targets: bool = False):
        self.device = resolve_device(device)
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._host_targets = host_targets
        self._sb = 0  # the next super-batch's id
        self._batch0 = 0  # the delivered index of its first batch
        self._plan_hook = plan_hook
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._k = max(1, steps_per_dispatch)
        self._depth = max(1, depth)
        self._packer = packer if packer is not None else Packer(
            self.device, vocabulary_size, with_fields)
        if self._packer.pin != self._cuda:
            raise ValueError("the packer pins for another device")
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self._cuda else None)
        # Held around each of the stage's CUDA calls (pinned and device
        # allocation, copy, event record and wait), and by paused().
        self._cuda_calls = self._packer.lock
        self._free: dict = {}  # total bytes -> [pinned staging buffer]
        self._inflight: deque = deque()  # (event, host buffer, recycle)
        self._source = source
        tel = telemetry if telemetry is not None else NULL
        self._out = ClosableQueue(
            self._depth, hist=tel.depth_hist("prefetch.out_q_depth"))
        self._t_stack = tel.timer("prefetch.stack")
        self._t_put = tel.timer("prefetch.device_put")
        self._t_out_block = tel.timer("prefetch.out_block")
        self._c_super = tel.counter("prefetch.super_batches")
        self._c_prestack = tel.counter("prefetch.prestack_hits")
        self._thread = threading.Thread(
            target=self._run, args=(iter(source),), daemon=True,
            name="tffm-torch-prefetch")
        self._thread.start()

    # -- the transfer thread -------------------------------------------

    def _run(self, it) -> None:
        try:
            self._tracer.name_thread("prefetch")
            if self._cuda:
                torch.cuda.set_device(self.device)
            group: list = []
            for item in it:
                if isinstance(item, (EpochEnd, PackedGroup)):
                    # A pending group (a resume's tail) ships first.
                    if group and not self._ship(group):
                        return
                    group = []
                    if isinstance(item, PackedGroup):
                        if not self._ship_packed(item):
                            return
                    elif not self._out.put(item):
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
            # The source's own close (a pipeline's is safe from any
            # thread), else the iterator's.
            close = (getattr(self._source, "close", None)
                     or getattr(it, "close", None))
            if close is not None:
                close()

    def _staging(self, total: int) -> torch.Tensor:
        free = self._free.get(total)
        if free:
            return free.pop()
        return self._packer.alloc(total)

    def _retire(self, event, staging: torch.Tensor, recycle: bool) -> None:
        """Hold a host buffer behind its copy; once more than ``depth``
        copies are in flight, wait for the oldest and recycle its buffer
        if it is the stage's own (a packed group's is only let go)."""
        self._inflight.append((event, staging, recycle))
        if len(self._inflight) <= self._depth:
            return
        with self._tracer.span("prefetch.staging_wait",
                               args={"inflight": len(self._inflight)}):
            while len(self._inflight) > self._depth:
                ev, buf, mine = self._inflight.popleft()
                ev.synchronize()
                if mine:
                    self._free.setdefault(buf.numel(), []).append(buf)

    def _ship(self, group) -> bool:
        """Fill a recycled staging buffer with ``group`` and ship it.
        With a ``plan_hook`` the ids are range-checked as they came, then
        the hook remaps them and its plan's arrays ride the same buffer
        and copy."""
        plan, extra = None, ()
        sb = self._sb
        with self._tracer.span(
                "prefetch.stack",
                args={"sb": sb, "batch0": self._batch0, "n": len(group)},
                flow=("s", f"sb{sb}")):
            if self._plan_hook is not None:
                self._packer.check(group)
                group, plan = self._plan_hook(group)
                extra = plan.leaves()
            with self._t_stack.time():
                spec, total = self._packer.layout_of(group, extra)
                staging = self._staging(total)
                self._packer.fill(group, staging, spec, extra,
                                  checked=plan is not None)
        DevicePrefetcher.fills += 1
        return self._copy(staging, spec, len(group), recycle=True, plan=plan,
                          h2d=({"sb": sb}, "t"))

    def _ship_packed(self, packed: PackedGroup) -> bool:
        """Ship a group the prestacked cache packed: no fill, no range
        check (done at its packing), and its buffer never recycled.  With
        a ``plan_hook`` its ids must be remapped, and the cache's buffer
        must not be written: its batches go through :meth:`_ship`."""
        if self._plan_hook is not None:
            return self._ship(packed.batches())
        DevicePrefetcher.prestack_hits += 1
        self._c_prestack.add(1)
        return self._copy(packed.buffer, packed.spec, packed.n,
                          recycle=False,
                          h2d=({"sb": self._sb, "batch0": self._batch0,
                                "n": packed.n, "prestacked": True}, "s"))

    def _copy(self, staging: torch.Tensor, spec, k: int,
              recycle: bool, plan=None, h2d: tuple = ({}, "t")) -> bool:
        """Copy ``staging`` to the device (the ``prefetch.h2d`` span with
        ``h2d``'s args and flow phase) and queue the super-batch."""
        event = None
        t0 = time.perf_counter()
        host = None
        if self._host_targets:
            hv = _host_views(staging, spec)
            host = (hv["labels"][:k].copy(), hv["weights"][:k].copy())
        sb_id = self._sb
        self._sb += 1
        self._batch0 += k
        with self._tracer.span("prefetch.h2d", args=h2d[0],
                               flow=(h2d[1], f"sb{sb_id}")):
            if self._cuda:
                total = staging.numel()
                with self._cuda_calls, torch.cuda.stream(self._stream):
                    dev = torch.empty((total,), dtype=torch.uint8,
                                      device=self.device)
                    dev.copy_(staging, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self._stream)
                    self._retire(event, staging, recycle)
            else:
                dev = staging  # an alias: never recycled
        views = _views(dev, spec)
        sb = _assemble(views, k, dev)._replace(host=host)
        item = sb if plan is None else plan.ship(sb, views)
        self._t_put.observe(time.perf_counter() - t0)
        DevicePrefetcher.ships += 1
        self._c_super.add(1)
        t0 = time.perf_counter()
        ok = self._out.put((item, event, dev))
        self._t_out_block.observe(time.perf_counter() - t0)
        return ok

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
                item, event, dev = got
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    dev.record_stream(stream)
                yield item
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
