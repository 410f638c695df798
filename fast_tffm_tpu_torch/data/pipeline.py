"""Batch pipeline: libsvm files -> fixed-shape :class:`Batch` es.

The counterpart of ``fast_tffm_tpu/data/pipeline.py::BatchPipeline``
with ``ordered=True``, fed the reference's own stream of lines, so the
same config, files and seed give the same batches in both packages.
Like the reference, it picks one of two streams:

- **the raw-window stream** (``fast_ingest`` on and no weight files,
  the reference's default ``_raw_groups`` path): the files are read as
  ONE binary stream in ``4 << 20``-byte chunks (a ``\\n`` put in at a
  file boundary that lacks one), gathered into windows of about
  ``max(shuffle_buffer, batch_size)`` lines (a byte target from a
  running bytes-per-line estimate; mid-stream a window holds a whole
  number of batches, the last one the rest), each window permuted with
  ``numpy.random.default_rng(r.getrandbits(63))``, ``r =
  random.Random(seed + epoch)``, and cut into batches.  A blank or
  ``#`` line keeps its place as a weight-0 example;
- **the line stream** (weight files, or ``fast_ingest`` off): the
  lines of every file in order, blank and ``#`` lines left out, through
  the reference's reservoir shuffle of ``shuffle_buffer`` lines fed by
  ``random.Random(seed + epoch)``, cut into batches.

Unshuffled, the raw stream's windows hold one batch each.  One pipeline
spans the run's epochs: a reader thread walks the stream (epoch ``e``
seeded with ``seed + e``) and hands sequence-numbered groups of lines
through a bounded work queue to ``thread_num`` parse workers; the
consumer puts their batches back into reader order (the reference's
``_iter_stream_threads`` with ``ordered=True``), so the batches never
depend on the number of workers.  Each worker owns a
:class:`~fast_tffm_tpu_torch.data.native.NativeParser` (one C++ thread,
the GIL released while it parses): the raw-window stream parses with
``parse_raw`` straight out of the window's buffer at the permuted line
extents, the line stream with ``parse_batch``.  With ``host_meta`` the
worker also attaches the host sort meta the sparse apply takes, from
the C++ stable sort (``native.sort_meta``).  ``native=False`` asks for
the port's Python parser (``libsvm.parse_line`` + ``make_batch`` +
``host_sort_meta``) by name instead: the plain version the native path
is held against; nothing falls back to it.  A line that does not parse
raises ``ValueError`` naming its file and line; the tail batch of each
epoch is padded with weight-0 examples; ``truncated_features`` sums the
feature occurrences ``max_features`` cut off.

``start_epoch`` / ``skip_batches`` name a resume position: the epochs
``[start_epoch, epochs)`` are delivered, the first ``skip_batches`` of
``start_epoch`` left unparsed (skipped after sharding, as the
reference's ``_epoch_items``).  With ``epoch_marks`` an
:class:`EpochEnd` marker follows each epoch's last batch.

``shard=(index, count)`` is the multi-rank input split (the reference's
``_strided_rounds``): the stream of batch-sized line groups, the same on
every rank, is dealt out round-robin, and this pipeline parses only
every ``count``-th group from ``index`` on, and only from complete
rounds, so every data block yields the same number of batches.  The
reference's ``drop_remainder`` filter has no caller there and is not
carried.

**The process stream** (``parse_processes > 0``, the reference's
``_iter_stream_procs``): the same reader feeds a pool of spawned worker
processes (``data/procpool.py``) instead of threads, each with its own
native parser; batches come back as shared-memory segments and are
delivered in reader order, so they are element-wise the threads'.
With ``ring_slots > 0`` the raw-window stream's windows cross to the
workers through a shared-memory ring, one descriptor a batch on the
work queue; the line stream, and a window larger than a slot, go
pickled.  The workers' truncation counts come back with their batches,
and their parsers' batch counts at their end (``worker_batches``).

**The epoch cache** (``cache_epochs``, when ``epochs > 1`` and the
pipeline is not sharded; the reference's ``_iter_cached``): epoch 0
streams as usual and keeps every delivered batch; epochs ``1..E-1``
replay them in ``random.Random(seed + epoch).shuffle`` order (in order
unshuffled) and parse nothing.  Past ``cache_max_bytes`` the cache is
dropped and every later epoch streams under its own seed, so the stream
depends only on whether the budget was crossed.  A resume inside a
later epoch re-parses epoch 0 to rebuild the cache, delivering none of
it.  ``cache_result`` reports ``off``, ``cached`` or ``overflow``;
``truncated_features`` adds epoch 0's truncation once per replayed
epoch.  With ``prestack=(k, pack)`` (``cache_prestacked``, the
reference's ``_iter_cached_prestacked``) epoch 0's batches are packed
once per group of ``k`` (an epoch's tail at its leftover) by ``pack``,
the transfer stage's packer (``data/prefetch.py::Packer``), and each
packed group is delivered and cached; the replays permute whole groups
and deliver the packed groups themselves, which the transfer stage
ships with no fill.  A resume inside a group delivers the group's tail
as plain batches.  This module imports no torch (the spawned workers
import it): ``pack`` is handed in, and a packed group is used only
through its ``n``, ``nbytes`` and ``batches(start)``.

**Telemetry.**  A ``telemetry`` registry (``obs/telemetry.py``; the
shared no-op ``NULL`` when none is given, and then nothing is timed or
counted) gets the reference's instruments under its names:
``ingest.batches`` and ``ingest.examples`` at the one delivery exit,
``ingest.parse``, ``ingest.reader_block`` and ``ingest.out_block``, the
work and output queues' ``ingest.work_q_depth`` and
``ingest.out_q_depth``, ``ingest.cache_replay_batches`` and
``ingest.cache_bytes``, the process pool's ``ingest.ring_*`` and
``ingest.work_msg_bytes``, and the ``ingest.truncated_features``
sample.  :meth:`BatchPipeline.stats` is the data-integrity block every
self-report carries.

**Trace and drift sketches.**  A ``tracer`` (``obs/trace.py``) gets the
reference's spans under its names and ``args``: ``read.item`` (the
reader producing one work item, ``seq``), ``parse.batch`` (a parse
thread's or a process worker's batch, ``seq``; a worker records its
spans in a tracer of its own and ships them back with each batch) and
the ``ingest.deliver`` point at the one delivery exit (``batch``, the
delivered index, ``n`` and the ``seq`` it came from; a cache replay
delivers with ``seq`` None).  A ``quality`` accumulator
(``obs/quality.py::StreamSketch``) sketches every PARSED batch's ids,
values and weights: on the parse threads, or in each process worker,
which ships its sketch delta every ``procpool.SKETCH_SHIP_EVERY``
batches it parsed (the port ships one descriptor a batch, so the delta
rides one batch's result message in that many) and its remainder with
its ``done`` message, for the parent to absorb.  Cache replays are not
sketched again: a replay's distribution is epoch 0's.  A sketching
failure disables the plane and never stops the stream.

``BatchPipeline.replays`` and ``BatchPipeline.worker_batches`` count,
over every pipeline of the process, the batches replayed from a cache
and the batches the process workers parsed.  The transfer of parsed
batches to the device is ``data/prefetch.py``.
"""

from __future__ import annotations

import bisect
import glob
import logging
import multiprocessing as mp
import pickle
import queue
import random
import threading
import time
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs.telemetry import NULL, Telemetry
from fast_tffm_tpu_torch.obs.trace import NULL_TRACER
from fast_tffm_tpu_torch.data import native as native_lib
from fast_tffm_tpu_torch.data import procpool
from fast_tffm_tpu_torch.data.libsvm import (
    Batch, host_sort_meta, make_batch, parse_line,
)
from fast_tffm_tpu_torch.data.queues import (
    CANCELLED, SENTINEL, ClosableQueue, WorkerError,
)

__all__ = ["BatchPipeline", "EpochEnd", "expand_files", "parse_native",
           "ring_slot_bytes"]

log = logging.getLogger(__name__)

# Bytes read from a file at a time by the raw-window stream (the
# reference's ``_CHUNK_BYTES``; a window takes at least one chunk).
_CHUNK_BYTES = 4 << 20


class EpochEnd(NamedTuple):
    """In-band marker after the last batch of ``epoch``
    (``epoch_marks=True``)."""

    epoch: int


def expand_files(patterns: Sequence[str]) -> list:
    """Glob each pattern (sorted); a pattern that matches nothing is kept
    as a path, so opening it names the missing file."""
    out = []
    for pat in patterns:
        hits = sorted(glob.glob(pat))
        out.extend(hits if hits else [pat])
    return out


def _strided_rounds(it, shard_id: int, num_shards: int):
    """Yield every ``num_shards``-th item from ``shard_id`` on, but only
    from complete rounds (``fast_tffm_tpu/data/pipeline.py::
    _strided_rounds``): a rank that ran one extra step would deadlock the
    others in the step's collectives, so an item is held back until an
    item of the next round arrives, and a partial tail round is
    dropped."""
    pending = None  # (round, item) candidate from this shard's slot
    last_idx = -1
    for idx, item in enumerate(it):
        last_idx = idx
        r = idx // num_shards
        if pending is not None and r > pending[0]:
            yield pending[1]
            pending = None
        if idx % num_shards == shard_id:
            pending = (r, item)
    if (pending is not None
            and last_idx >= pending[0] * num_shards + num_shards - 1):
        yield pending[1]


# -- the line stream -----------------------------------------------------


def _weight_lines(path: str) -> list:
    # Every line, blanks too, so weight line i pairs with data line i.
    with open(path) as f:
        return [line.strip() for line in f]


def _iter_lines(files: Sequence[str], weight_files: Sequence[str]):
    """``(path, line_no, text, weight)`` for every line of ``files`` that
    is neither blank nor a ``#`` comment (``fast_tffm_tpu/data/
    pipeline.py::iter_lines``); weight-file line i belongs to data line
    i, and only the kept lines' weights are read."""
    for i, path in enumerate(files):
        weights = _weight_lines(weight_files[i]) if weight_files else None
        with open(path) as f:
            for no, line in enumerate(f, 1):
                if not line.strip() or line.lstrip().startswith("#"):
                    continue
                w = 1.0
                if weights is not None:
                    try:
                        w = float(weights[no - 1])
                    except (IndexError, ValueError) as e:
                        raise ValueError(
                            f"weight file {weight_files[i]} line {no} does "
                            f"not pair with data file {path}: {e}"
                        ) from e
                yield path, no, line, w


def _shuffled(it, buffer_size: int, rng: random.Random):
    """Reservoir shuffle (``fast_tffm_tpu/data/pipeline.py::_shuffled``):
    each new item takes a random slot of a full buffer, whose old
    occupant is yielded; the buffer is shuffled out at the end."""
    buf: list = []
    for item in it:
        if len(buf) < buffer_size:
            buf.append(item)
            continue
        j = rng.randrange(buffer_size)
        yield buf[j]
        buf[j] = item
    rng.shuffle(buf)
    yield from buf


# -- the raw-window stream -------------------------------------------------


class _Window(NamedTuple):
    """Whole lines of the raw stream: ``buf[starts[i]:ends[i]]`` is line
    i; ``marks`` are ``(offset in buf, path, byte offset in that file)``
    at each chunk's start, ascending, for naming a line's file and
    number.  ``buf`` is ``bytes``, or in a process worker a ``uint8``
    view of its ring slot."""

    buf: object
    starts: np.ndarray
    ends: np.ndarray
    marks: list

    def locate(self, start: int) -> tuple:
        """``(path, line number)`` of the line that starts at ``start``:
        the newlines of its file before it are counted only here, when
        a line is named, never on the stream's path."""
        j = bisect.bisect_right([m[0] for m in self.marks], start) - 1
        off, path, pos = self.marks[j]
        with open(path, "rb") as f:
            head = f.read(pos + start - off)
        return path, head.count(b"\n") + 1


def _raw_chunk_stream(files: Sequence[str], chunk_bytes: int):
    """``(chunk, path, its byte offset in the file)`` over all files as
    ONE stream (``fast_tffm_tpu/data/pipeline.py::_raw_chunk_stream``):
    a ``\\n`` is put in at a file boundary where the file lacks a
    trailing newline, so lines never merge across files.  A chunk never
    spans two files."""
    for path in files:
        last, pos = b"\n", 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(chunk_bytes)
                if not chunk:
                    break
                last = chunk[-1:]
                yield chunk, path, pos
                pos += len(chunk)
        if last != b"\n":
            yield b"\n", path, pos


def _line_starts(buf: bytes, end: int) -> np.ndarray:
    """Offsets of the lines that start in ``buf[:end]``: 0, then the byte
    after each ``\\n`` except a trailing one (the reference's
    ``fm_parser_find_lines``)."""
    after_nl = np.flatnonzero(np.frombuffer(buf, np.uint8, count=end) == 10)
    after_nl += 1
    return np.concatenate([[0], after_nl[after_nl < end]]).astype(np.int64)


def _rebase(marks: list, cut: int) -> list:
    """``marks`` of ``buf[cut:]``."""
    j = bisect.bisect_right([m[0] for m in marks], cut) - 1
    off, path, pos = marks[j]
    return [(0, path, pos + cut - off)] + [
        (o - cut, p, q) for o, p, q in marks[j + 1:]]


def _iter_raw_windows(files: Sequence[str], batch_size: int,
                      window_lines: int, chunk_bytes: int = _CHUNK_BYTES,
                      line_starts=_line_starts):
    """:class:`_Window` s of whole raw lines, the reference's
    ``_iter_raw_windows``: chunks are gathered up to a byte target of
    ``window_lines`` times a running bytes-per-line estimate (at least
    one chunk a round); mid-stream a window keeps a multiple of
    ``batch_size`` lines and carries the rest, and any incomplete tail,
    into the next, across file boundaries; the last window flushes
    everything.  ``line_starts(buf, end)`` finds the lines (the native
    path passes the C++ scan, ``native.find_line_offsets``)."""
    window_lines = max(window_lines, batch_size)
    stream = _raw_chunk_stream(files, chunk_bytes)
    pending, pending_marks = b"", []
    est_bpl = 80.0  # running bytes-per-line estimate
    at_eof = False
    while not at_eof:
        target = int(window_lines * est_bpl) + 1
        parts, marks = [pending], list(pending_marks)
        size = len(pending)
        first = True
        while size < target or first:
            first = False
            nxt = next(stream, None)
            if nxt is None:
                at_eof = True
                break
            chunk, path, pos = nxt
            marks.append((size, path, pos))
            parts.append(chunk)
            size += len(chunk)
        buf = b"".join(parts)
        pending, pending_marks = b"", []
        if not buf:
            continue  # at_eof: the loop ends
        buf_end = len(buf) if at_eof else buf.rfind(b"\n") + 1
        if buf_end == 0:  # not one complete line yet: read more
            pending, pending_marks = buf, marks
            est_bpl *= 2.0
            continue
        starts = line_starts(buf, buf_end)
        n = len(starts)
        est_bpl = buf_end / n
        ends = np.append(starts[1:], buf_end)
        if at_eof:
            n_keep = n  # flush everything, a partial group included
        else:
            n_keep = (n // batch_size) * batch_size
            if n_keep == 0:  # fewer lines than one batch: read more
                pending, pending_marks = buf, marks
                continue
            cut = int(starts[n_keep]) if n_keep < n else buf_end
            if cut < len(buf):
                pending, pending_marks = buf[cut:], _rebase(marks, cut)
        yield _Window(buf, starts[:n_keep], ends[:n_keep], marks)




def parse_native(parser, group, raw: bool, batch_size: int) -> Batch:
    """``group``'s batch by the native ``parser``: a raw group ``(window,
    starts, ends)`` or a line group of ``(path, line_no, text, weight)``
    records.  A malformed line raises ``ValueError`` naming its file and
    line (the parse threads and the process workers alike)."""
    if raw:
        win, starts, ends = group
        try:
            return parser.parse_raw(win.buf, starts, ends, batch_size)
        except native_lib.MalformedLineError as err:
            s = int(starts[err.index])
            text = bytes(win.buf[s:int(ends[err.index])])
            raise ValueError("{}:{}: malformed libsvm input: {!r}".format(
                *win.locate(s), text)) from None
    try:
        return parser.parse_batch([text for _, _, text, _ in group],
                                  batch_size, [w for _, _, _, w in group])
    except native_lib.MalformedLineError as err:
        path, no, text, _ = group[err.index]
        raise ValueError(
            f"{path}:{no}: malformed libsvm input: {text!r}") from None


def _batch_nbytes(batch: Batch) -> int:
    """A cached batch's bytes (the reference's ``_batch_nbytes`` over the
    port's :class:`Batch`, whose sort meta is ``perm`` and ``seg_start``
    only)."""
    arrays = [batch.labels, batch.ids, batch.vals, batch.fields,
              batch.weights]
    if batch.sort_meta is not None:
        arrays.extend(batch.sort_meta)
    return sum(a.nbytes for a in arrays if a is not None)


def ring_slot_bytes(cfg: FmConfig, shuffle: bool) -> int:
    """A ring slot's bytes for ``cfg``'s raw windows (the reference's
    ``_ring_slot_bytes``): the window's lines at 1 KB of text and 16
    bytes of extents each, plus two read chunks of overshoot, within
    [1 MiB, 64 MiB].  A window that outgrows it goes pickled."""
    lines = (max(cfg.shuffle_buffer, cfg.batch_size) if shuffle
             else cfg.batch_size)
    want = lines * (1024 + 16) + 2 * _CHUNK_BYTES
    return min(max(want, 1 << 20), 64 << 20)


def _msg_bytes(msg) -> int:
    """A work message's size for ``work_msg_bytes``: a descriptor
    (``slot``, ``mark``) pickled exactly; a message carrying a window or
    lines estimated from its text, not pickled a second time."""
    kind = msg[0]
    if kind == "raw":
        return len(msg[2]) + 16 * sum(len(s) for s in msg[3])
    if kind == "lines":
        return sum(len(rec[2]) + 16 for rec in msg[2])
    return len(pickle.dumps(msg))


class BatchPipeline:
    """Iterate over the parsed batches of ``files`` for ``epochs``
    epochs (and, with ``epoch_marks``, :class:`EpochEnd` markers; with
    ``prestack``, packed groups).  Use as a context manager (or call
    :meth:`close`, from any thread) so the reader, the parse threads or
    processes and their shared memory go when the consumer stops
    early."""

    replays = 0  # batches replayed from an epoch cache, every pipeline
    worker_batches = 0  # batches parsed by process workers, as reported
    _count_lock = threading.Lock()

    def __init__(self, files: Sequence[str], cfg: FmConfig, epochs: int = 1,
                 shuffle: bool = True, host_meta: bool = False,
                 weight_files: Optional[Sequence[str]] = None,
                 shard: tuple = (0, 1), start_epoch: int = 0,
                 skip_batches: int = 0, native: bool = True,
                 epoch_marks: bool = False, cache_epochs: bool = False,
                 cache_max_bytes: int = 1 << 30,
                 prestack: Optional[tuple] = None,
                 telemetry: Optional[Telemetry] = None,
                 tracer=None, quality=None):
        self.files = expand_files(files)
        if not self.files:
            raise ValueError("no input files")
        self.weight_files = expand_files(weight_files or [])
        if self.weight_files and len(self.weight_files) != len(self.files):
            raise ValueError(
                f"weight_files must parallel the input files "
                f"({len(self.weight_files)} vs {len(self.files)})"
            )
        if not 0 <= shard[0] < shard[1]:
            raise ValueError(f"bad shard {shard}")
        if not 0 <= start_epoch < max(1, epochs):
            raise ValueError(
                f"start_epoch {start_epoch} outside [0, {epochs})")
        if cfg.parse_processes > 0 and not native:
            raise ValueError("parse_processes needs the native parser")
        self.shard = tuple(shard)
        self.cfg = cfg
        self.epochs = epochs
        self.shuffle = shuffle
        self.host_meta = host_meta
        self.start_epoch = start_epoch
        self.skip_batches = skip_batches
        self.native = native
        self.epoch_marks = epoch_marks
        # The reference's stream choice: weight files need line pairing.
        self.raw = cfg.fast_ingest and not self.weight_files
        # The reference's condition (fast_tffm_tpu/data/pipeline.py:544).
        self._cache = cache_epochs and epochs > 1 and self.shard == (0, 1)
        self.cache_max_bytes = cache_max_bytes
        self._prestack = prestack if self._cache else None
        self.cache_result = "off"
        # The process stream's transport, for the tests and the bench.
        self.shm_tag = None
        self.ring_windows = self.ring_fallback_windows = 0
        self.ring_window_bytes = self.work_msg_bytes = 0
        self.worker_seconds: dict = {}  # summed over the workers'
        # "done" messages: waiting for work, parsing, shipping
        self._parsers: list = []  # each native parse thread's parser
        self._py_truncated = 0  # the Python parser's cut-off features
        self._trunc_extra = 0  # process workers' and cache replays'
        self._trunc_lock = threading.Lock()
        self._queues: list = []  # the running thread stream's
        self._stop = None  # the running process stream's stop event
        self._closed = False
        self._gen = None
        self._finished = threading.Event()
        self._started = False
        # The reference's instruments (obs/telemetry.py's NULL when none
        # is given: every call below is a no-op).
        self.telemetry = telemetry if telemetry is not None else NULL
        tel = self.telemetry
        self._c_batches = tel.counter("ingest.batches")
        self._c_examples = tel.counter("ingest.examples")
        self._c_cache_replays = tel.counter("ingest.cache_replay_batches")
        self._t_parse = tel.timer("ingest.parse")
        self._t_reader_block = tel.timer("ingest.reader_block")
        self._t_out_block = tel.timer("ingest.out_block")
        self._c_ring_windows = tel.counter("ingest.ring_windows")
        self._c_ring_fallback = tel.counter("ingest.ring_fallback_windows")
        self._c_ring_bytes = tel.counter("ingest.ring_window_bytes")
        self._c_q_msg_bytes = tel.counter("ingest.work_msg_bytes")
        self._g_cache_bytes = tel.gauge("ingest.cache_bytes")
        self._g_ring_bytes = tel.gauge("ingest.ring_bytes")
        tel.sample("ingest.truncated_features",
                   lambda: self.truncated_features)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._quality = quality  # a StreamSketch, or None: off
        self._sketch_warned = False
        self._last_seq = None  # the seq of the batch delivered last
        self._deliver_idx = 0

    def _sketch(self, batch: Batch) -> None:
        """Fold a parsed batch into the drift sketches; a failure turns
        the plane off for the rest of the run (an observer never stops
        the training it observes)."""
        q = self._quality
        if q is None:
            return
        try:
            q.update_batch(batch.ids, batch.vals, batch.weights)
        except Exception as e:  # noqa: BLE001
            self._quality = None
            log.warning(
                "quality sketching disabled: update_batch failed (%s: %s); "
                "training continues without ingest drift sketches",
                type(e).__name__, e)

    def _absorb(self, delta) -> None:
        """A process worker's sketch delta (None: none this message)."""
        if delta is not None and self._quality is not None:
            self._quality.absorb(delta)

    def _traced_items(self, it):
        """The reader's ``(seq, item)`` stream with a ``read.item`` span
        for producing each work item (a plain pass-through untraced)."""
        tracer = self.tracer
        if not tracer.enabled:
            yield from it
            return
        tracer.name_thread("ingest-reader")
        while True:
            t0 = time.perf_counter()
            nxt = next(it, None)
            if nxt is None:
                return
            seq, item = nxt
            if not isinstance(item, EpochEnd):
                tracer.emit("read.item", t0, time.perf_counter() - t0,
                            args={"seq": seq})
            yield seq, item

    def stats(self) -> dict:
        """Point-in-time data-integrity snapshot that every self-report
        (heartbeat, final record, ``/status``) carries: callable from any
        thread at any time, after shutdown too.  The parser reduces ids
        modulo the vocabulary, so no batch is out of range."""
        return {
            "truncated_features": int(self.truncated_features),
            "out_of_range_batches": 0,
            "ingest_cache": self.cache_result,
        }

    @property
    def truncated_features(self) -> int:
        """Feature occurrences ``max_features`` cut off so far."""
        return (self._py_truncated + self._trunc_extra
                + sum(p.truncated_features for p in self._parsers))

    # -- the reader's stream -------------------------------------------

    def _line_groups(self, rng: random.Random):
        """The line stream in groups of ``batch_size`` records ``(path,
        line_no, text, weight)``, the last group shorter."""
        bs = self.cfg.batch_size
        it = _iter_lines(self.files, self.weight_files)
        if self.shuffle:
            it = _shuffled(it, max(1, self.cfg.shuffle_buffer), rng)
        group = []
        for rec in it:
            group.append(rec)
            if len(group) == bs:
                yield group
                group = []
        if group:
            yield group

    def _raw_groups(self, rng: random.Random):
        """The raw-window stream in groups ``(window, starts, ends)`` of
        at most ``batch_size`` lines."""
        cfg = self.cfg
        bs = cfg.batch_size
        window = max(cfg.shuffle_buffer, bs) if self.shuffle else bs
        scan = native_lib.find_line_offsets if self.native else _line_starts
        for win in _iter_raw_windows(self.files, bs, window,
                                     line_starts=scan):
            starts, ends = win.starts, win.ends
            n = len(starts)
            if self.shuffle and n > 1:
                perm = np.random.default_rng(
                    rng.getrandbits(63)).permutation(n)
                starts, ends = starts[perm], ends[perm]
            for i in range(0, n, bs):
                yield win, starts[i:i + bs], ends[i:i + bs]

    def _epoch_items(self, n_epochs: int, first_epoch: int, skip: int):
        """``(seq, group or EpochEnd)`` over epochs ``first_epoch ..
        first_epoch + n_epochs - 1``: each reseeded with ``seed +
        epoch``, sharded, and ``skip`` groups left out of the first after
        sharding (``fast_tffm_tpu/data/pipeline.py::_epoch_items``)."""
        seq = 0
        for epoch in range(first_epoch, first_epoch + n_epochs):
            rng = random.Random(self.cfg.seed + epoch)
            groups = (self._raw_groups(rng) if self.raw
                      else self._line_groups(rng))
            if self.shard[1] > 1:
                groups = _strided_rounds(groups, *self.shard)
            to_skip = skip if epoch == first_epoch else 0
            for group in groups:
                if to_skip > 0:
                    to_skip -= 1
                    continue
                yield seq, group
                seq += 1
            yield seq, EpochEnd(epoch)
            seq += 1

    # -- a parse thread's batch ----------------------------------------

    def _example(self, text: str, counted: list):
        """The line's example (None for a blank or ``#`` line), counting
        the features ``max_features`` cuts off into ``counted[0]``."""
        cfg = self.cfg
        ex = parse_line(text, cfg.vocabulary_size, cfg.hash_feature_id,
                        cfg.field_num)
        if ex is not None and len(ex.ids) > cfg.max_features:
            counted[0] += len(ex.ids) - cfg.max_features
        return ex

    def _parse_python(self, group) -> Batch:
        """The plain version: the port's line parser, line by line."""
        examples, weights, counted = [], [], [0]
        if self.raw:
            win, starts, ends = group
            for s, e in zip(starts.tolist(), ends.tolist()):
                try:
                    ex = self._example(win.buf[s:e].decode(), counted)
                except ValueError as err:
                    raise ValueError(
                        "{}:{}: {}".format(*win.locate(s), err)) from None
                examples.append(ex)
                weights.append(0.0 if ex is None else 1.0)
        else:
            for path, no, text, w in group:
                try:
                    examples.append(self._example(text, counted))
                except ValueError as err:
                    raise ValueError(f"{path}:{no}: {err}") from None
                weights.append(w)
        with self._trunc_lock:
            self._py_truncated += counted[0]
        cfg = self.cfg
        return make_batch(examples, cfg.batch_size, cfg.max_features, weights)

    def _new_parser(self):
        """A parse thread's own parser (None: the Python parser)."""
        if not self.native:
            return None
        cfg = self.cfg
        parser = native_lib.NativeParser(
            cfg.vocabulary_size, cfg.max_features, cfg.hash_feature_id,
            cfg.field_num, num_threads=1)
        with self._trunc_lock:
            self._parsers.append(parser)
        return parser

    def _batch(self, parser, group) -> Batch:
        if parser is None:
            batch = self._parse_python(group)
            if self.host_meta:
                batch = batch._replace(sort_meta=host_sort_meta(batch.ids))
            return batch
        batch = parse_native(parser, group, self.raw, self.cfg.batch_size)
        if self.host_meta:
            batch = batch._replace(sort_meta=native_lib.sort_meta(
                batch.ids, self.cfg.vocabulary_size))
        return batch

    # -- the streams: threads or processes -----------------------------

    def _iter_stream(self, n_epochs: int, first_epoch: int = 0,
                     skip: int = 0) -> Iterator:
        """Batches and :class:`EpochEnd` markers of ``n_epochs`` epochs
        from ``first_epoch``, in reader order."""
        if n_epochs <= 0 or self._closed:
            return
        if self.cfg.parse_processes > 0:
            yield from self._iter_stream_procs(n_epochs, first_epoch, skip)
        else:
            yield from self._iter_stream_threads(n_epochs, first_epoch,
                                                 skip)

    def _iter_stream_threads(self, n_epochs: int, first_epoch: int,
                             skip: int) -> Iterator:
        cfg = self.cfg
        tel = self.telemetry
        work = ClosableQueue(max(2, cfg.queue_size),
                             hist=tel.depth_hist("ingest.work_q_depth"))
        out = ClosableQueue(max(2, cfg.queue_size),
                            hist=tel.depth_hist("ingest.out_q_depth"))
        n_workers = max(1, cfg.thread_num)
        tracer = self.tracer
        tracing = tracer.enabled
        timed = tel.enabled
        if self.native:
            native_lib.load()  # a failed build raises here, in the caller

        def reader():
            try:
                for item in self._traced_items(
                        self._epoch_items(n_epochs, first_epoch, skip)):
                    t0 = time.perf_counter()
                    if not work.put(item):
                        return
                    if timed:
                        self._t_reader_block.observe(
                            time.perf_counter() - t0)
            except BaseException as e:  # surfaces in the consumer
                out.put(WorkerError(e))
            finally:
                for _ in range(n_workers):
                    if not work.put(SENTINEL):
                        break

        def worker():
            if tracing:
                tracer.name_thread("parse-worker")
            try:
                parser = self._new_parser()
            except BaseException as e:  # surfaces in the consumer
                out.put(WorkerError(e))
                return
            while True:
                got = work.get()
                if got is CANCELLED:
                    return
                if got is SENTINEL:
                    out.put(SENTINEL)
                    return
                seq, group = got
                if isinstance(group, EpochEnd):
                    out.put(got)
                    continue
                t0 = time.perf_counter()
                try:
                    item = (seq, self._batch(parser, group))
                except BaseException as e:
                    item = WorkerError(e)
                t1 = time.perf_counter()
                if tracing and not isinstance(item, WorkerError):
                    tracer.emit("parse.batch", t0, t1 - t0,
                                args={"seq": seq})
                if not isinstance(item, WorkerError):
                    self._sketch(item[1])
                t2 = time.perf_counter()
                if not out.put(item):
                    return
                if timed:
                    self._t_parse.observe(t1 - t0)
                    self._t_out_block.observe(time.perf_counter() - t2)

        threads = [threading.Thread(target=reader, daemon=True,
                                    name="tffm-torch-read")]
        threads += [threading.Thread(target=worker, daemon=True,
                                     name=f"tffm-torch-parse-{i}")
                    for i in range(n_workers)]
        self._queues = [work, out]
        if self._closed:  # a close() that came before the queues
            return
        for t in threads:
            t.start()
        finished, next_seq, held = 0, 0, {}
        try:
            while finished < n_workers:
                got = out.get()
                if got is CANCELLED:
                    return
                if got is SENTINEL:
                    finished += 1
                    continue
                if isinstance(got, WorkerError):
                    raise got.exc
                seq, obj = got
                # Parsing is parallel; delivery follows reader order.
                held[seq] = obj
                while next_seq in held:
                    obj = held.pop(next_seq)
                    self._last_seq = next_seq
                    next_seq += 1
                    yield obj
        finally:
            work.cancel()
            out.cancel()
            for t in threads:
                t.join()

    def _iter_stream_procs(self, n_epochs: int, first_epoch: int,
                           skip: int) -> Iterator:
        """The reference's ``_iter_stream_procs``: the reader thread
        feeds ``parse_processes`` spawned workers (``data/procpool.py``)
        and the batches come back as shared-memory segments, delivered
        in reader order.  With the ring, a window's batches go out one
        descriptor each and its slot comes back when all of them have."""
        native_lib.load()  # built once, here, before any worker starts
        cfg = self.cfg
        ctx = mp.get_context("spawn")
        n_workers = cfg.parse_processes
        tag = procpool.make_shm_tag()
        self.shm_tag = tag
        work = ctx.Queue(maxsize=max(2, min(cfg.queue_size, 2 * n_workers)))
        out = ctx.Queue(maxsize=max(2, cfg.queue_size))
        stop = ctx.Event()
        self._stop = stop
        ring = spec = None
        free: queue.Queue = queue.Queue()  # ring slots the reader may fill
        slot_lock = threading.Lock()
        slot_left: dict = {}  # slot -> its window's batches not back yet
        seq_slot: dict = {}  # seq -> the slot its batch is parsed from
        reader_err: list = []
        procs: list = []
        rt = None
        tel = self.telemetry
        h_work = tel.depth_hist("ingest.work_q_depth")
        h_out = tel.depth_hist("ingest.out_q_depth")
        h_ring = tel.depth_hist("ingest.ring_free_slots")

        def put_work(msg) -> bool:
            nbytes = _msg_bytes(msg)
            self.work_msg_bytes += nbytes
            self._c_q_msg_bytes.add(nbytes)
            h_work.observe(work.qsize())
            t0 = time.perf_counter()
            ok = procpool.put_with_stop(work, msg, stop)
            self._t_reader_block.observe(time.perf_counter() - t0)
            return ok

        def flush(pend) -> bool:
            """Send one window's batches: through a ring slot, one
            descriptor each, or pickled whole when it outgrows a slot."""
            if pend is None:
                return True
            win, seq0, starts_list, ends_list = pend
            n_lines = sum(len(s) for s in starts_list)
            marks = pickle.dumps(win.marks)
            if (ring is not None and procpool.ShmRing.need_bytes(
                    len(win.buf), n_lines, len(marks)) <= ring.slot_bytes):
                h_ring.observe(free.qsize())
                slot = procpool.get_with_stop(free, stop)
                if slot is None:
                    return False
                ring.write(slot, win.buf, np.concatenate(starts_list),
                           np.concatenate(ends_list), marks)
                with slot_lock:
                    slot_left[slot] = len(starts_list)
                    for j in range(len(starts_list)):
                        seq_slot[seq0 + j] = slot
                self.ring_windows += 1
                self.ring_window_bytes += len(win.buf)
                self._c_ring_windows.add(1)
                self._c_ring_bytes.add(len(win.buf))
                lo = 0
                for j, s in enumerate(starts_list):
                    if not put_work(("slot", seq0 + j, slot, len(win.buf),
                                     n_lines, lo, lo + len(s), len(marks))):
                        return False
                    lo += len(s)
                return True
            self.ring_fallback_windows += 1
            self._c_ring_fallback.add(1)
            return put_work(("raw", seq0, win.buf, starts_list, ends_list,
                             win.marks))

        def reader():
            pend = None  # [window, seq0, [starts...], [ends...]]
            try:
                for seq, item in self._traced_items(self._epoch_items(
                        n_epochs, first_epoch, skip)):
                    if isinstance(item, EpochEnd):
                        if not flush(pend):
                            return
                        pend = None
                        if not put_work(("mark", seq, item.epoch)):
                            return
                    elif self.raw:
                        win, s, e = item
                        if pend is not None and pend[0] is not win:
                            if not flush(pend):
                                return
                            pend = None
                        if pend is None:
                            pend = [win, seq, [s], [e]]
                        else:
                            pend[2].append(s)
                            pend[3].append(e)
                    elif not put_work(("lines", seq, item)):
                        return
                flush(pend)
            except BaseException as e:  # surfaces in the consumer
                reader_err.append(e)
            finally:
                for _ in range(n_workers):
                    if not procpool.put_with_stop(work, None, stop):
                        break

        try:
            if self.raw and cfg.ring_slots > 0:
                ring = procpool.ShmRing.create(
                    tag, cfg.ring_slots, ring_slot_bytes(cfg, self.shuffle))
                for i in range(cfg.ring_slots):
                    free.put(i)
                self._g_ring_bytes.set(cfg.ring_slots * ring.slot_bytes)
            spec = procpool.WorkerSpec(
                vocabulary_size=cfg.vocabulary_size,
                max_features=cfg.max_features,
                hash_feature_id=cfg.hash_feature_id,
                field_num=cfg.field_num, batch_size=cfg.batch_size,
                host_meta=self.host_meta, shm_tag=tag,
                ring_name=None if ring is None else ring.name,
                ring_slots=cfg.ring_slots,
                ring_slot_bytes=0 if ring is None else ring.slot_bytes,
                trace=self.tracer.enabled,
                sketch_every=(procpool.SKETCH_SHIP_EVERY
                              if self._quality is not None else 0))
            if self._closed:
                return
            procs = procpool.start_workers(ctx, n_workers, spec, work, out,
                                           stop)
            rt = threading.Thread(target=reader, daemon=True,
                                  name="tffm-torch-read")
            rt.start()
            done, next_seq, held = 0, 0, {}
            while done < n_workers:
                if self._closed:
                    return
                if reader_err:
                    raise reader_err.pop()
                h_out.observe(out.qsize())
                try:
                    msg = out.get(timeout=0.1)
                except queue.Empty:
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"parse worker {dead[0].name} (pid "
                            f"{dead[0].pid}) died (exitcode "
                            f"{dead[0].exitcode})")
                    continue
                kind = msg[0]
                if kind == "done":
                    done += 1
                    with BatchPipeline._count_lock:
                        BatchPipeline.worker_batches += msg[1]
                    for key, sec in msg[2].items():
                        self.worker_seconds[key] = (
                            self.worker_seconds.get(key, 0.0) + sec)
                    # Spans that ended after the worker's last batch, and
                    # its sketch remainder.
                    self.tracer.add_raw(msg[3])
                    self._absorb(msg[4])
                    continue
                if kind == "err":
                    raise msg[1]
                if kind == "mark":
                    seq, obj = msg[1], EpochEnd(msg[2])
                else:  # ("batch", seq, segment, meta_len, truncated,
                    #      parse_s, spans, sketch delta)
                    seq = msg[1]
                    obj = procpool.attach_batch(spec, msg[2], msg[3])
                    self._t_parse.observe(msg[5])
                    self.tracer.add_raw(msg[6])
                    self._absorb(msg[7])
                    with self._trunc_lock:
                        self._trunc_extra += msg[4]
                    with slot_lock:
                        slot = seq_slot.pop(seq, None)
                        if slot is not None:
                            slot_left[slot] -= 1
                            if not slot_left[slot]:
                                del slot_left[slot]
                                free.put(slot)
                held[seq] = obj
                while next_seq in held:
                    obj = held.pop(next_seq)
                    self._last_seq = next_seq
                    next_seq += 1
                    yield obj
            if reader_err:
                raise reader_err.pop()
        finally:
            self._teardown_procs(stop, rt, procs, out, work, ring, tag)

    def _teardown_procs(self, stop, rt, procs, out, work, ring, tag) -> None:
        """Stop the reader and the workers, reap them while draining what
        they shipped, and leave no segment of ``tag`` in ``/dev/shm``."""
        stop.set()
        self._stop = None
        if rt is not None:
            rt.join()

        def drain():
            while True:
                try:
                    msg = out.get_nowait()
                except queue.Empty:
                    return
                if msg[0] == "batch":
                    procpool.discard_segment(msg[2])

        deadline = time.monotonic() + 10.0
        while (any(p.is_alive() for p in procs)
               and time.monotonic() < deadline):
            drain()
            for p in procs:
                p.join(timeout=0.05)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        drain()
        if ring is not None:
            ring.destroy()
            self._g_ring_bytes.set(0)  # the allocation is gone
        for q in (work, out):
            q.close()
            q.cancel_join_thread()
        leaked = procpool.sweep_segments(tag)
        if leaked:
            log.warning("swept %d orphaned /dev/shm segment(s) tagged %s "
                        "(a parse worker died mid-ship)", leaked, tag)

    def _emit_stream(self, n_epochs: int, first_epoch: int, skip: int):
        """:meth:`_iter_stream` with the markers kept per
        ``epoch_marks``."""
        for item in self._iter_stream(n_epochs, first_epoch, skip):
            if self.epoch_marks or not isinstance(item, EpochEnd):
                yield item

    # -- the epoch cache -----------------------------------------------

    def _over_budget(self, size: int) -> bool:
        if size <= self.cache_max_bytes:
            return False
        log.info("ingest cache over budget (%d > %d bytes); re-parsing "
                 "later epochs", size, self.cache_max_bytes)
        self.cache_result = "overflow"
        self._g_cache_bytes.set(0)  # retains nothing
        return True

    def _after_overflow(self, deliver: bool, skip: int):
        """The epochs after an overflow, streamed under their own seeds
        (the uninterrupted run's stream)."""
        E, e0 = self.epochs, self.start_epoch
        if deliver:
            yield from self._emit_stream(E - 1, 1, 0)
        else:
            yield from self._emit_stream(E - e0, e0, skip)

    def _replay_order(self, n: int, epoch: int) -> list:
        order = list(range(n))
        if self.shuffle:
            random.Random(self.cfg.seed + epoch).shuffle(order)
        return order

    def _iter_cached(self):
        """The reference's ``_iter_cached``: epoch 0 parsed once and kept
        (re-parsed, delivering nothing, on a resume past it), then epochs
        ``1..E-1`` replayed from the cache."""
        E, e0, skip = self.epochs, self.start_epoch, self.skip_batches
        cache: Optional[list] = []
        size = 0
        self.cache_result = "cached"
        deliver = e0 == 0
        trunc_start = self.truncated_features
        n_seen = 0
        stream = self._iter_stream(1, 0, 0)
        try:
            for item in stream:
                if isinstance(item, EpochEnd):
                    if deliver and self.epoch_marks:
                        yield item
                    continue
                if cache is not None:
                    size += _batch_nbytes(item)
                    if self._over_budget(size):
                        cache = None
                        if not deliver:
                            break  # a rebuild that overflows stops early
                    else:
                        cache.append(item)
                        self._g_cache_bytes.set(size)
                n_seen += 1
                if deliver and n_seen > skip:
                    yield item
        finally:
            stream.close()
        if self._closed:
            return
        if cache is None:
            yield from self._after_overflow(deliver, skip)
            return
        epoch0_trunc = self.truncated_features - trunc_start
        for epoch in range(max(1, e0), E):
            order = self._replay_order(len(cache), epoch)
            for i in order[skip if epoch == e0 else 0:]:
                with BatchPipeline._count_lock:
                    BatchPipeline.replays += 1
                self._c_cache_replays.add(1)
                self._last_seq = None  # a replay: parsed in epoch 0
                yield cache[i]
            with self._trunc_lock:
                self._trunc_extra += epoch0_trunc
            if self.epoch_marks:
                yield EpochEnd(epoch)

    def _iter_cached_prestacked(self):
        """The reference's ``_iter_cached_prestacked``: as
        :meth:`_iter_cached`, with epoch 0 packed once per group of ``k``
        (the tail at its leftover), the packed groups delivered and
        cached, and the replays permuting whole groups.  A resume inside
        a group delivers its tail as plain batches."""
        E, e0, skip = self.epochs, self.start_epoch, self.skip_batches
        k, pack = self._prestack
        cache: Optional[list] = []
        size = 0
        self.cache_result = "cached"
        deliver = e0 == 0
        trunc_start = self.truncated_features
        n_seen = 0  # batches taken from epoch 0's stream
        group: list = []

        def flush() -> list:
            """Pack the pending group once; what of it to deliver."""
            nonlocal cache, group, size
            if not group:
                return []
            packed = pack(group)
            first = n_seen - len(group)
            group = []
            if cache is not None:
                size += packed.nbytes
                if self._over_budget(size):
                    cache = None
                else:
                    cache.append(packed)
                    self._g_cache_bytes.set(size)
            if not deliver or n_seen <= skip:
                return []
            return [packed] if first >= skip else packed.batches(skip - first)

        stream = self._iter_stream(1, 0, 0)
        try:
            for item in stream:
                if isinstance(item, EpochEnd):
                    yield from flush()  # the epoch's tail
                    if deliver and self.epoch_marks:
                        yield item
                else:
                    group.append(item)
                    n_seen += 1
                    if len(group) == k:
                        yield from flush()
                if cache is None and not deliver:
                    break  # a rebuild that overflows stops early
        finally:
            stream.close()
        if self._closed:
            return
        if cache is None:
            yield from self._after_overflow(deliver, skip)
            return
        epoch0_trunc = self.truncated_features - trunc_start
        for epoch in range(max(1, e0), E):
            rem = skip if epoch == e0 else 0
            for gi in self._replay_order(len(cache), epoch):
                packed = cache[gi]
                if rem >= packed.n:
                    rem -= packed.n
                    continue
                with BatchPipeline._count_lock:
                    BatchPipeline.replays += packed.n - rem
                self._c_cache_replays.add(packed.n - rem)
                self._last_seq = None  # a replay: parsed in epoch 0
                if rem:
                    yield from packed.batches(rem)
                else:
                    yield packed
                rem = 0
            with self._trunc_lock:
                self._trunc_extra += epoch0_trunc
            if self.epoch_marks:
                yield EpochEnd(epoch)

    # -- delivery --------------------------------------------------------

    def _deliver(self) -> Iterator:
        try:
            if self._prestack is not None:
                yield from self._iter_cached_prestacked()
            elif self._cache:
                yield from self._iter_cached()
            else:
                yield from self._emit_stream(
                    self.epochs - self.start_epoch, self.start_epoch,
                    self.skip_batches)
        finally:
            self._finished.set()

    def _counted(self) -> Iterator:
        """:meth:`_deliver` with the delivery accounting at its one exit,
        so every path (threads, processes, cache replays, packed groups)
        counts alike.  The O(batch) example count runs only when the
        registry is live."""
        counting = self.telemetry.enabled
        tracer = self.tracer
        inner = self._deliver()
        try:
            for item in inner:
                if isinstance(item, EpochEnd):
                    yield item
                    continue
                if isinstance(item, Batch):
                    n = 1
                    if counting:
                        self._c_examples.add(
                            int(np.count_nonzero(item.weights > 0)))
                else:  # a packed group
                    n = item.n
                    if counting:
                        self._c_examples.add(sum(
                            int((b.weights > 0).sum())
                            for b in item.batches()))
                self._c_batches.add(n)
                if tracer.enabled:
                    tracer.point("ingest.deliver", args={
                        "batch": self._deliver_idx, "n": n,
                        "seq": self._last_seq})
                self._deliver_idx += n
                yield item
        finally:
            inner.close()

    def __iter__(self) -> Iterator:
        if self._started:
            raise RuntimeError("a BatchPipeline is iterated once")
        self._started = True
        self._gen = self._counted()
        return self._gen

    def close(self) -> None:
        """Stop the stream and release its threads, processes and shared
        memory, and wait for that (from any thread; idempotent)."""
        self._closed = True
        stop = self._stop
        if stop is not None:
            stop.set()
        for q in self._queues:
            q.cancel()
        gen = self._gen
        if gen is None:
            return
        try:
            gen.close()
        except ValueError:  # running in another thread, which sees the stop
            self._finished.wait()

    def __enter__(self) -> "BatchPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
