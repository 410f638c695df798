"""Batch pipeline: libsvm files -> fixed-shape :class:`Batch` es.

A minimal counterpart of ``fast_tffm_tpu/data/pipeline.py::
BatchPipeline``, fed the reference's own stream of lines, so the same
config, files and seed give the same batches in both packages.  Like
the reference, it picks one of two streams:

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

Unshuffled, the raw stream's windows hold one batch each.  One
background thread parses each batch's lines with the port's own line
parser (``data.libsvm.parse_line``), pads them into ``[batch_size,
max_features]`` batches (the tail batch of each epoch padded with
weight-0 examples) and, when asked, attaches the host sort meta the
sparse apply takes.  A line that does not parse raises ``ValueError``
naming its file and line.  The consumer iterates; a bounded queue
(``queue_size`` batches) keeps the parser at most that far ahead.  With
one parse thread the batches always come in input order, which is the
order the reference's trainer asks for with ``ordered=True``.

``shard=(index, count)`` is the multi-rank input split (the reference's
``_strided_rounds``): the stream of batch-sized line groups, the same on
every rank, is dealt out round-robin, and this pipeline parses only
every ``count``-th group from ``index`` on, and only from complete
rounds, so every data block yields the same number of batches.  The
reference's ``drop_remainder`` filter has no caller there and is not
carried.

The reference's process pool, C++ parser, epoch cache, shared-memory
ring and ``DevicePrefetcher`` are later items (ROADMAP.md, port queue).
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import queue
import random
import threading
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.libsvm import (
    Batch, host_sort_meta, make_batch, parse_line,
)

__all__ = ["BatchPipeline", "expand_files"]

_END = object()
# Bytes read from a file at a time by the raw-window stream (the
# reference's ``_CHUNK_BYTES``; a window takes at least one chunk).
_CHUNK_BYTES = 4 << 20


class _Failure:
    def __init__(self, exc: Exception):
        self.exc = exc


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
    i; ``marks`` are ``(offset in buf, path, newlines of that file
    before the offset)`` at each chunk's start, ascending, for naming a
    line's file and number."""

    buf: bytes
    starts: np.ndarray
    ends: np.ndarray
    marks: list

    def locate(self, start: int) -> tuple:
        """``(path, line number)`` of the line that starts at ``start``."""
        j = bisect.bisect_right([m[0] for m in self.marks], start) - 1
        off, path, nl = self.marks[j]
        return path, nl + self.buf.count(b"\n", off, start) + 1


def _raw_chunk_stream(files: Sequence[str], chunk_bytes: int):
    """``(chunk, path, newlines before it in its file)`` over all files
    as ONE stream (``fast_tffm_tpu/data/pipeline.py::_raw_chunk_stream``):
    a ``\\n`` is put in at a file boundary where the file lacks a
    trailing newline, so lines never merge across files.  A chunk never
    spans two files."""
    for path in files:
        last, nl = b"\n", 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(chunk_bytes)
                if not chunk:
                    break
                last = chunk[-1:]
                yield chunk, path, nl
                nl += chunk.count(b"\n")
        if last != b"\n":
            yield b"\n", path, nl


def _line_starts(buf: bytes, end: int) -> np.ndarray:
    """Offsets of the lines that start in ``buf[:end]``: 0, then the byte
    after each ``\\n`` except a trailing one (the reference's
    ``fm_parser_find_lines``)."""
    after_nl = np.flatnonzero(np.frombuffer(buf, np.uint8, count=end) == 10)
    after_nl += 1
    return np.concatenate([[0], after_nl[after_nl < end]]).astype(np.int64)


def _rebase(buf: bytes, marks: list, cut: int) -> list:
    """``marks`` of ``buf[cut:]``."""
    j = bisect.bisect_right([m[0] for m in marks], cut) - 1
    off, path, nl = marks[j]
    head = [(0, path, nl + buf.count(b"\n", off, cut))]
    return head + [(o - cut, p, n) for o, p, n in marks[j + 1:]]


def _iter_raw_windows(files: Sequence[str], batch_size: int,
                      window_lines: int, chunk_bytes: int = _CHUNK_BYTES):
    """:class:`_Window` s of whole raw lines, the reference's
    ``_iter_raw_windows``: chunks are gathered up to a byte target of
    ``window_lines`` times a running bytes-per-line estimate (at least
    one chunk a round); mid-stream a window keeps a multiple of
    ``batch_size`` lines and carries the rest, and any incomplete tail,
    into the next, across file boundaries; the last window flushes
    everything."""
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
            chunk, path, nl = nxt
            marks.append((size, path, nl))
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
        starts = _line_starts(buf, buf_end)
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
                pending, pending_marks = buf[cut:], _rebase(buf, marks, cut)
        yield _Window(buf, starts[:n_keep], ends[:n_keep], marks)


class BatchPipeline:
    """Iterate over the parsed batches of ``files`` for ``epochs``
    epochs.  Use as a context manager (or call :meth:`close`) so the
    parse thread ends when the consumer stops early."""

    def __init__(self, files: Sequence[str], cfg: FmConfig, epochs: int = 1,
                 shuffle: bool = True, host_meta: bool = False,
                 weight_files: Optional[Sequence[str]] = None,
                 shard: tuple = (0, 1)):
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
        self.shard = tuple(shard)
        self.cfg = cfg
        self.epochs = epochs
        self.shuffle = shuffle
        self.host_meta = host_meta
        # The reference's stream choice: weight files need line pairing.
        self.raw = cfg.fast_ingest and not self.weight_files
        self.truncated_features = 0  # feature occurrences over max_features
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.queue_size))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- producer (background thread) ----------------------------------

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
        for win in _iter_raw_windows(self.files, bs, window):
            starts, ends = win.starts, win.ends
            n = len(starts)
            if self.shuffle and n > 1:
                perm = np.random.default_rng(
                    rng.getrandbits(63)).permutation(n)
                starts, ends = starts[perm], ends[perm]
            for i in range(0, n, bs):
                yield win, starts[i:i + bs], ends[i:i + bs]

    def _example(self, text: str):
        """The line's example (None for a blank or ``#`` line), counting
        the features ``max_features`` cuts off."""
        cfg = self.cfg
        ex = parse_line(text, cfg.vocabulary_size, cfg.hash_feature_id,
                        cfg.field_num)
        if ex is not None and len(ex.ids) > cfg.max_features:
            self.truncated_features += len(ex.ids) - cfg.max_features
        return ex

    def _batch(self, group) -> Batch:
        """A group's batch; a line that does not parse raises naming its
        file and line number."""
        examples, weights = [], []
        if self.raw:
            win, starts, ends = group
            for s, e in zip(starts.tolist(), ends.tolist()):
                try:
                    ex = self._example(win.buf[s:e].decode())
                except ValueError as err:
                    raise ValueError(
                        "{}:{}: {}".format(*win.locate(s), err)) from None
                examples.append(ex)
                weights.append(0.0 if ex is None else 1.0)
        else:
            for path, no, text, w in group:
                try:
                    examples.append(self._example(text))
                except ValueError as err:
                    raise ValueError(f"{path}:{no}: {err}") from None
                weights.append(w)
        cfg = self.cfg
        batch = make_batch(examples, cfg.batch_size, cfg.max_features,
                           weights)
        if self.host_meta:
            batch = batch._replace(sort_meta=host_sort_meta(batch.ids))
        return batch

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for epoch in range(self.epochs):
                rng = random.Random(self.cfg.seed + epoch)
                groups = (self._raw_groups(rng) if self.raw
                          else self._line_groups(rng))
                if self.shard[1] > 1:
                    groups = _strided_rounds(groups, *self.shard)
                for group in groups:
                    if not self._put(self._batch(group)):
                        return
            self._put(_END)
        except Exception as e:  # handed to the consumer, re-raised there
            self._put(_Failure(e))

    # -- consumer ------------------------------------------------------

    def __iter__(self) -> Iterator[Batch]:
        if self._thread is not None:
            raise RuntimeError("a BatchPipeline is iterated once")
        self._thread = threading.Thread(
            target=self._produce, name="tffm-torch-parse", daemon=True
        )
        self._thread.start()
        while True:
            item = self._q.get()
            if item is _END:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield item

    def close(self) -> None:
        """Stop the parse thread and wait for it."""
        self._stop.set()
        if self._thread is not None:
            while self._thread.is_alive():
                with contextlib.suppress(queue.Empty):
                    self._q.get(timeout=0.05)
                self._thread.join(timeout=0.05)

    def __enter__(self) -> "BatchPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
