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

The reference's process pool (``parse_processes``, with its
shared-memory ring ``ring_slots``) and its epoch cache are ROADMAP.md
port queue item 7a's next parts; the transfer of parsed batches to the
device is ``data/prefetch.py``.
"""

from __future__ import annotations

import bisect
import glob
import random
import threading
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import native as native_lib
from fast_tffm_tpu_torch.data.libsvm import (
    Batch, host_sort_meta, make_batch, parse_line,
)
from fast_tffm_tpu_torch.data.queues import (
    CANCELLED, SENTINEL, ClosableQueue, WorkerError,
)

__all__ = ["BatchPipeline", "EpochEnd", "expand_files"]

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
    number."""

    buf: bytes
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


class BatchPipeline:
    """Iterate over the parsed batches of ``files`` for ``epochs``
    epochs (and, with ``epoch_marks``, :class:`EpochEnd` markers).  Use
    as a context manager (or call :meth:`close`) so the reader and parse
    threads end when the consumer stops early."""

    def __init__(self, files: Sequence[str], cfg: FmConfig, epochs: int = 1,
                 shuffle: bool = True, host_meta: bool = False,
                 weight_files: Optional[Sequence[str]] = None,
                 shard: tuple = (0, 1), start_epoch: int = 0,
                 skip_batches: int = 0, native: bool = True,
                 epoch_marks: bool = False):
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
        self._parsers: list = []  # each native worker's parser
        self._py_truncated = 0  # the Python parser's cut-off features
        self._trunc_lock = threading.Lock()
        self._queues: list = []
        self._threads: list = []
        self._started = False

    @property
    def truncated_features(self) -> int:
        """Feature occurrences ``max_features`` cut off so far."""
        return self._py_truncated + sum(p.truncated_features
                                        for p in self._parsers)

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

    def _epoch_items(self):
        """``(seq, group or EpochEnd)`` over the epochs to deliver: each
        epoch reseeded with ``seed + epoch``, sharded, and the resume
        skip taken from the first epoch after sharding
        (``fast_tffm_tpu/data/pipeline.py::_epoch_items``)."""
        seq = 0
        for epoch in range(self.start_epoch, self.epochs):
            rng = random.Random(self.cfg.seed + epoch)
            groups = (self._raw_groups(rng) if self.raw
                      else self._line_groups(rng))
            if self.shard[1] > 1:
                groups = _strided_rounds(groups, *self.shard)
            to_skip = self.skip_batches if epoch == self.start_epoch else 0
            for group in groups:
                if to_skip > 0:
                    to_skip -= 1
                    continue
                yield seq, group
                seq += 1
            yield seq, EpochEnd(epoch)
            seq += 1

    # -- a parse worker's batch ----------------------------------------

    def _parse_native(self, parser, group) -> Batch:
        bs = self.cfg.batch_size
        if self.raw:
            win, starts, ends = group
            try:
                return parser.parse_raw(win.buf, starts, ends, bs)
            except native_lib.MalformedLineError as err:
                s = int(starts[err.index])
                text = win.buf[s:int(ends[err.index])]
                raise ValueError("{}:{}: malformed libsvm input: {!r}".format(
                    *win.locate(s), text)) from None
        try:
            return parser.parse_batch([text for _, _, text, _ in group], bs,
                                      [w for _, _, _, w in group])
        except native_lib.MalformedLineError as err:
            path, no, text, _ = group[err.index]
            raise ValueError(
                f"{path}:{no}: malformed libsvm input: {text!r}") from None

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
        """A parse worker's own parser (None: the Python parser)."""
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
        batch = self._parse_native(parser, group)
        if self.host_meta:
            batch = batch._replace(sort_meta=native_lib.sort_meta(
                batch.ids, self.cfg.vocabulary_size))
        return batch

    # -- threads -------------------------------------------------------

    def _stream(self) -> Iterator:
        cfg = self.cfg
        work = ClosableQueue(max(2, cfg.queue_size))
        out = ClosableQueue(max(2, cfg.queue_size))
        n_workers = max(1, cfg.thread_num)
        if self.native:
            native_lib.load()  # a failed build raises here, in the caller

        def reader():
            try:
                for item in self._epoch_items():
                    if not work.put(item):
                        return
            except BaseException as e:  # surfaces in the consumer
                out.put(WorkerError(e))
            finally:
                for _ in range(n_workers):
                    if not work.put(SENTINEL):
                        break

        def worker():
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
                try:
                    item = (seq, self._batch(parser, group))
                except BaseException as e:
                    item = WorkerError(e)
                if not out.put(item):
                    return

        threads = [threading.Thread(target=reader, daemon=True,
                                    name="tffm-torch-read")]
        threads += [threading.Thread(target=worker, daemon=True,
                                     name=f"tffm-torch-parse-{i}")
                    for i in range(n_workers)]
        self._queues, self._threads = [work, out], threads
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
                    next_seq += 1
                    if self.epoch_marks or not isinstance(obj, EpochEnd):
                        yield obj
        finally:
            self.close()

    def __iter__(self) -> Iterator:
        if self._started:
            raise RuntimeError("a BatchPipeline is iterated once")
        self._started = True
        return self._stream()

    def close(self) -> None:
        """Stop the reader and parse threads and wait for them (from any
        thread; idempotent)."""
        for q in self._queues:
            q.cancel()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join()

    def __enter__(self) -> "BatchPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
