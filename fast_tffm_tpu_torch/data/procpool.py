"""Spawned parse workers and their shared-memory transport.

The port's counterpart of ``fast_tffm_tpu/data/procpool.py``:
``parse_processes > 0`` moves parsing out of the trainer's interpreter
into a pool of SPAWNED worker processes (never forked: the parent holds
a CUDA context, which a forked child would inherit broken).  A worker
imports only numpy and the port's data layer (``data/native.py``,
``data/libsvm.py``, ``data/pipeline.py``, ``config.py``,
``data/queues.py``), never torch: :func:`start_workers` hides the
parent's ``__main__`` while the children start, so a child does not
re-import a script or module that imports torch.

Both directions are backed by ``/dev/shm``:

- **inbound** (:class:`ShmRing`): the pipeline's reader writes each raw
  window (its text, then the ``int64`` line extents) into a free slot
  of one fixed segment, with its file marks (to name a malformed line),
  and puts one small DESCRIPTOR per batch on the work queue (slot, text
  length, line count, the batch's range of extents); a worker parses
  the batch in place from its own mapping of the slot.  The consumer
  hands the slot back once every batch of the window has come back, so
  the batches of one window spread over all workers.  A window larger
  than a slot, and the line stream, go through the queue pickled (the
  window whole, or one batch's lines);
- **outbound** (:func:`ship_batch` / :func:`attach_batch`): a worker
  writes a parsed batch's arrays (and its host sort meta, ``perm [n]``
  and ``seg_start [U + 1]``) into ONE new segment and ships its name;
  the parent maps it, unlinks the name at once and wraps views whose
  mapping lives as long as the last of them.

Every segment a pipeline creates carries its unique tag
(:func:`make_shm_tag`), so teardown sweeps whatever a crashed worker
left (:func:`sweep_segments`).  Segments are plain files of
``/dev/shm`` opened with ``os.open`` and mapped with :mod:`mmap`:
Python 3.12's ``multiprocessing.shared_memory`` registers every
segment with a resource tracker (it has no ``track=False``), which the
reference works around by unregistering by hand; here no tracker is
involved.  The ring's pages are reserved at creation
(``posix_fallocate``), so a full ``/dev/shm`` raises there, naming the
size, and never as a ``SIGBUS`` on a later write; a batch segment is
written with ``os.write``, which fails with ``ENOSPC`` the same way.

The quality plane's sketches and the trace's spans ride the result
messages, as the reference's do: with ``spec.trace`` a worker records
``parse.batch`` spans in a tracer of its own (``obs/trace.py``, stdlib)
and ships the new events with each batch; with ``spec.sketch_every > 0``
it folds each parsed batch into a local ``obs/sketch.py::SketchSet`` and
ships its serialized delta every ``sketch_every`` batches (None in
between) and the remainder with its ``done`` message.  The port ships one
descriptor a batch, so a delta rides one batch's message in
``SKETCH_SHIP_EVERY``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import mmap
import os
import pickle
import queue as _queue
import sys
import time
import types
from typing import Optional

import numpy as np

from fast_tffm_tpu_torch.data.libsvm import Batch, SortMeta

__all__ = [
    "ShmRing", "WorkerSpec", "attach_batch", "discard_segment",
    "get_with_stop", "make_shm_tag", "parse_worker_main", "put_with_stop",
    "ship_batch", "start_workers", "sweep_segments",
]

SHM_DIR = "/dev/shm"
_pipe_ids = itertools.count()
_ship_ids = itertools.count()
_CORE = ("labels", "ids", "vals", "fields", "weights")
# Batches a worker sketches between two shipped deltas: one pickled
# sketch per batch would undo the descriptor-only queue discipline.
SKETCH_SHIP_EVERY = 16


def make_shm_tag() -> str:
    """A unique name prefix for every segment of one pipeline.  The
    trailing delimiter keeps pipeline p1's sweep from matching p10's
    segments."""
    return f"tffm{os.getpid()}p{next(_pipe_ids)}_"


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """What a spawned worker needs to parse (picklable, no FmConfig)."""

    vocabulary_size: int
    max_features: int
    hash_feature_id: bool
    field_num: int
    batch_size: int
    host_meta: bool  # attach the C++ sort meta to each batch
    shm_tag: str
    ring_name: Optional[str] = None  # the inbound ring (None: off)
    ring_slots: int = 0
    ring_slot_bytes: int = 0
    trace: bool = False  # record parse spans and ship them back
    sketch_every: int = 0  # ship a sketch delta every this many batches


def _layout(spec: WorkerSpec, meta_len: int):
    """``[(name, shape, dtype)]`` of a shipped batch: the core arrays,
    then, with ``meta_len > 0``, ``perm [n]`` and ``seg_start
    [meta_len]`` (U + 1 entries)."""
    b, f = spec.batch_size, spec.max_features
    fields = [("labels", (b,), np.float32), ("ids", (b, f), np.int32),
              ("vals", (b, f), np.float32), ("fields", (b, f), np.int32),
              ("weights", (b,), np.float32)]
    if meta_len:
        fields += [("perm", (b * f,), np.int32),
                   ("seg_start", (meta_len,), np.int32)]
    return fields


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _shm_path(name: str) -> str:
    return os.path.join(SHM_DIR, name)


def _map(name: str) -> mmap.mmap:
    """A read-write shared mapping of the whole segment ``name``."""
    fd = os.open(_shm_path(name), os.O_RDWR)
    try:
        return mmap.mmap(fd, os.fstat(fd).st_size)
    finally:
        os.close(fd)


class ShmRing:
    """The inbound ring: ``slots`` x ``slot_bytes`` of one segment.  A
    slot holds ``[text][pad to 8][starts int64 x n][ends int64 x n]
    [pickled marks]``.  The parent creates it (:meth:`create`) and
    removes it (:meth:`destroy`); each worker maps it once
    (:meth:`attach`)."""

    def __init__(self, name: str, mm: mmap.mmap, slots: int,
                 slot_bytes: int):
        self.name = name
        self._mm = mm
        self.slots = slots
        self.slot_bytes = slot_bytes

    @classmethod
    def create(cls, tag: str, slots: int, slot_bytes: int) -> "ShmRing":
        """The ring, its pages reserved now: a ``/dev/shm`` too small
        raises here, naming the bytes asked for."""
        name = f"{tag}ring"
        size = max(1, slots * slot_bytes)
        fd = os.open(_shm_path(name), os.O_CREAT | os.O_EXCL | os.O_RDWR,
                     0o600)
        try:
            os.ftruncate(fd, size)
            os.posix_fallocate(fd, 0, size)
            mm = mmap.mmap(fd, size)
        except OSError as e:
            os.unlink(_shm_path(name))
            free = os.statvfs(SHM_DIR)
            raise RuntimeError(
                f"the shared-memory ring could not reserve {size} bytes "
                f"({slots} slots of {slot_bytes}) in {SHM_DIR} "
                f"({free.f_bavail * free.f_frsize} bytes free): {e}"
            ) from e
        finally:
            os.close(fd)
        return cls(name, mm, slots, slot_bytes)

    @classmethod
    def attach(cls, name: str, slots: int, slot_bytes: int) -> "ShmRing":
        return cls(name, _map(name), slots, slot_bytes)

    @staticmethod
    def need_bytes(text_len: int, n_lines: int, marks_len: int = 0) -> int:
        return _pad8(text_len) + 16 * n_lines + marks_len

    def write(self, slot: int, text: bytes, starts: np.ndarray,
              ends: np.ndarray, marks: bytes = b"") -> None:
        """Lay one window into ``slot``: its text, its line extents and
        its pickled file marks (read only to name a malformed line)."""
        base = slot * self.slot_bytes
        n = len(starts)
        if self.need_bytes(len(text), n, len(marks)) > self.slot_bytes:
            raise ValueError(f"a window of {len(text)} bytes and {n} lines "
                             f"outgrows a {self.slot_bytes}-byte slot")
        self._mm[base:base + len(text)] = text
        off = base + _pad8(len(text))
        dst = np.frombuffer(self._mm, np.int64, count=2 * n, offset=off)
        dst[:n] = starts
        dst[n:] = ends
        del dst  # no buffer export outlives the call
        off += 16 * n
        self._mm[off:off + len(marks)] = marks

    def read(self, slot: int, text_len: int, n: int, marks_len: int = 0):
        """``(text, starts, ends, marks)``: views of the slot, no copy,
        and the marks unpickled."""
        base = slot * self.slot_bytes
        text = np.frombuffer(self._mm, np.uint8, count=text_len, offset=base)
        off = base + _pad8(text_len)
        ext = np.frombuffer(self._mm, np.int64, count=2 * n, offset=off)
        off += 16 * n
        marks = pickle.loads(self._mm[off:off + marks_len]) if marks_len \
            else []
        return text, ext[:n], ext[n:], marks

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:  # a view still exported: the mapping stays
            pass

    def destroy(self) -> None:
        """The parent's teardown (idempotent): unlink and unmap."""
        with contextlib.suppress(FileNotFoundError):
            os.unlink(_shm_path(self.name))
        self.close()


def sweep_segments(tag: str) -> int:
    """Unlink every ``/dev/shm`` segment named with ``tag`` (called once
    the pool is reaped, so none is still in use); returns how many."""
    removed = 0
    for name in os.listdir(SHM_DIR):
        if name.startswith(tag):
            with contextlib.suppress(FileNotFoundError):
                os.unlink(_shm_path(name))
                removed += 1
    return removed


def _write_all(fd: int, data) -> None:
    mv = memoryview(data).cast("B")
    while mv:
        mv = mv[os.write(fd, mv):]


def ship_batch(spec: WorkerSpec, batch: Batch) -> tuple:
    """Worker side: write ``batch`` into a new segment; returns ``(name,
    meta_len)`` for :func:`attach_batch`."""
    meta_len = 0 if batch.sort_meta is None else len(
        batch.sort_meta.seg_start)
    values = {name: getattr(batch, name) for name in _CORE}
    if meta_len:
        values.update(perm=batch.sort_meta.perm,
                      seg_start=batch.sort_meta.seg_start)
    name = f"{spec.shm_tag}o{os.getpid()}x{next(_ship_ids)}"
    fd = os.open(_shm_path(name), os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                 0o600)
    try:
        for key, shape, dt in _layout(spec, meta_len):
            arr = np.ascontiguousarray(values[key], dt)
            if arr.shape != shape:
                raise ValueError(f"{key} has shape {arr.shape}, not {shape}")
            _write_all(fd, arr)
    except OSError as e:
        os.close(fd)
        os.unlink(_shm_path(name))
        size = sum(int(np.prod(s)) * np.dtype(d).itemsize
                   for _, s, d in _layout(spec, meta_len))
        raise RuntimeError(f"a {size}-byte batch segment could not be "
                           f"written to {SHM_DIR}: {e}") from e
    except BaseException:
        os.close(fd)
        os.unlink(_shm_path(name))
        raise
    os.close(fd)
    return name, meta_len


def attach_batch(spec: WorkerSpec, name: str, meta_len: int) -> Batch:
    """Parent side: the shipped batch as views of its mapping.  The name
    is unlinked at once; the pages go when the last view does."""
    mm = _map(name)
    os.unlink(_shm_path(name))
    out, off = {}, 0
    for key, shape, dt in _layout(spec, meta_len):
        count = int(np.prod(shape))
        out[key] = np.frombuffer(mm, dt, count=count, offset=off).reshape(
            shape)
        off += count * np.dtype(dt).itemsize
    meta = SortMeta(out["perm"], out["seg_start"]) if meta_len else None
    return Batch(*(out[k] for k in _CORE), sort_meta=meta)


def discard_segment(name: str) -> None:
    """Teardown: unlink a shipped segment nobody will attach."""
    with contextlib.suppress(FileNotFoundError):
        os.unlink(_shm_path(name))


def put_with_stop(q, item, stop) -> bool:
    """``q.put`` that gives up once ``stop`` is set (an mp queue cannot be
    cancelled: the poll period bounds shutdown)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False


def get_with_stop(q, stop):
    """``q.get`` that gives up (None) once ``stop`` is set."""
    while not stop.is_set():
        try:
            return q.get(timeout=0.1)
        except _queue.Empty:
            continue
    return None


def _safe_exc(e: BaseException) -> BaseException:
    """``e``, or a RuntimeError naming it when it would not survive the
    result queue's pickling (the failure would vanish)."""
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


@contextlib.contextmanager
def _bare_main():
    """Hide the parent's ``__main__`` from spawn's preparation data: a
    child then re-imports no script or ``-m`` module (which may import
    torch), only the worker function's own module."""
    main = sys.modules["__main__"]
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        yield
    finally:
        sys.modules["__main__"] = main


def start_workers(ctx, n: int, spec: WorkerSpec, work, out, stop) -> list:
    """Start ``n`` spawned :func:`parse_worker_main` processes."""
    procs = [ctx.Process(target=parse_worker_main,
                         args=(spec, work, out, stop), daemon=True,
                         name=f"tffm-torch-parse-proc-{i}")
             for i in range(n)]
    with _bare_main():
        for p in procs:
            p.start()
    return procs


def parse_worker_main(spec: WorkerSpec, work, out, stop) -> None:
    """One spawned parse worker.

    Work messages (the pipeline's reader):
      ``("slot", seq, slot, text_len, n_lines, lo, hi, marks_len)``: one
          raw batch, lines ``lo:hi`` of the window in ring slot
          ``slot``;
      ``("raw", seq0, buf, [starts...], [ends...], marks)``: a window
          sent pickled, batch ``j`` with sequence number ``seq0 + j``;
      ``("lines", seq, group)``: one batch of the line stream;
      ``("mark", seq, epoch)``: an epoch's end, echoed;
      ``None``: the end.

    Results: ``("batch", seq, segment, meta_len, truncated, parse_s,
    spans, sketch_delta)`` (``parse_s`` the batch's parse and sort-meta
    seconds; ``spans`` the trace events since the last message, empty
    untraced; ``sketch_delta`` a serialized ``SketchSet`` or None),
    ``("mark", seq, epoch)``, ``("err", exception)`` and at the end
    ``("done", batches this worker's parser parsed, seconds, spans,
    sketch_delta)``: ``seconds`` the worker's wall time waiting for work
    (``idle``), parsing with the sort meta (``parse``) and writing
    batches out (``ship``), the reference's per-batch ``parse_s`` summed.
    """
    ring = None
    try:
        from fast_tffm_tpu_torch.data import native
        from fast_tffm_tpu_torch.data.pipeline import _Window, parse_native

        parser = native.NativeParser(
            spec.vocabulary_size, spec.max_features, spec.hash_feature_id,
            spec.field_num, num_threads=1)
        if spec.ring_name is not None:
            ring = ShmRing.attach(spec.ring_name, spec.ring_slots,
                                  spec.ring_slot_bytes)
    except BaseException as e:
        put_with_stop(out, ("err", _safe_exc(e)), stop)
        return

    seconds = dict.fromkeys(("idle", "parse", "ship"), 0.0)
    from fast_tffm_tpu_torch.obs.trace import Tracer

    tracer = Tracer(enabled=spec.trace,
                    process_name=f"parse-worker {os.getpid()}")
    if spec.trace:
        tracer.name_thread("parse-worker")
    sketch = None
    pending = 0  # batches in ``sketch`` not shipped yet
    if spec.sketch_every > 0:
        from fast_tffm_tpu_torch.obs.sketch import SketchSet

        sketch = SketchSet()

    def take_delta(force: bool = False):
        """The sketch delta to ship now (None: not yet, or nothing)."""
        nonlocal sketch, pending
        if sketch is None or not pending or (
                not force and pending < spec.sketch_every):
            return None
        delta = sketch.to_dict()
        sketch = SketchSet()
        pending = 0
        return delta

    def emit(seq: int, raw: bool, group) -> bool:
        nonlocal sketch, pending
        before = parser.truncated_features
        t0 = time.perf_counter()
        batch = parse_native(parser, group, raw, spec.batch_size)
        if spec.host_meta:
            batch = batch._replace(sort_meta=native.sort_meta(
                batch.ids, spec.vocabulary_size))
        t1 = time.perf_counter()
        tracer.emit("parse.batch", t0, t1 - t0, args={"seq": seq})
        if sketch is not None:
            try:  # observe-only: a failure drops this worker's sketches
                sketch.update_batch(batch.ids, batch.vals, batch.weights)
                pending += 1
            except Exception:  # noqa: BLE001
                sketch = None
        name, meta_len = ship_batch(spec, batch)
        seconds["parse"] += t1 - t0
        seconds["ship"] += time.perf_counter() - t1
        if put_with_stop(out, ("batch", seq, name, meta_len,
                               parser.truncated_features - before,
                               t1 - t0, tracer.take(), take_delta()),
                         stop):
            return True
        discard_segment(name)  # teardown raced the ship
        return False

    try:
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                msg = work.get(timeout=0.1)
            except _queue.Empty:
                continue
            finally:
                seconds["idle"] += time.perf_counter() - t0
            if msg is None:
                put_with_stop(out, ("done", native.NativeParser.batches,
                                    seconds, tracer.take(),
                                    take_delta(force=True)), stop)
                return
            try:
                kind = msg[0]
                if kind == "mark":
                    ok = put_with_stop(out, msg, stop)
                elif kind == "slot":
                    _, seq, slot, text_len, n_lines, lo, hi, n_marks = msg
                    text, starts, ends, marks = ring.read(
                        slot, text_len, n_lines, n_marks)
                    win = _Window(text, starts, ends, marks)
                    ok = emit(seq, True, (win, starts[lo:hi], ends[lo:hi]))
                elif kind == "raw":
                    _, seq0, buf, starts_list, ends_list, marks = msg
                    win = _Window(buf, None, None, marks)
                    ok = True
                    for j, (s, e) in enumerate(zip(starts_list, ends_list)):
                        ok = emit(seq0 + j, True, (win, s, e))
                        if not ok:
                            break
                else:  # lines
                    ok = emit(msg[1], False, msg[2])
                if not ok:
                    return
            except BaseException as e:
                if not put_with_stop(out, ("err", _safe_exc(e)), stop):
                    return
    finally:
        if ring is not None:
            ring.close()
