"""Batch pipeline: libsvm files -> fixed-shape :class:`Batch` es.

A minimal counterpart of ``fast_tffm_tpu/data/pipeline.py::
BatchPipeline``: one background thread reads the files in order, shuffles
lines inside windows of ``shuffle_buffer`` lines (an explicit
``numpy.random.Generator`` seeded with ``seed + epoch``), parses them
with the port's own line parser (``data.libsvm.parse_line``), pads them
into ``[batch_size, max_features]`` batches (the tail batch of each
epoch padded with weight-0 examples) and, when asked, attaches the host
sort meta the sparse apply takes.  The consumer iterates; a bounded
queue (``queue_size`` batches) keeps the parser at most that far ahead.
With one parse thread the batches always come in input order, so the
reference's ``ordered`` flag has nothing to select.

``shard=(index, count)`` is the multi-rank input split (the reference's
``_strided_rounds``): the stream of batch-sized line groups, the same on
every rank, is dealt out round-robin, and this pipeline parses only
every ``count``-th group from ``index`` on, and only from complete
rounds, so every data block yields the same number of batches.

The reference's process pool, C++ parser, epoch cache, shared-memory
ring and ``DevicePrefetcher`` are later items (ROADMAP.md, port queue).
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.libsvm import (
    Batch, host_sort_meta, make_batch, parse_line,
)

__all__ = ["BatchPipeline", "expand_files"]

_END = object()
# Lines parsed per step when not shuffling (shuffling uses the window).
_READ_WINDOW = 4096


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
        self.truncated_features = 0  # feature occurrences over max_features
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.queue_size))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- producer (background thread) ----------------------------------

    def _lines(self, epoch_rng):
        """``(path, line_no, text, weight)`` for every line, shuffled
        within windows when ``shuffle``."""
        window = self.cfg.shuffle_buffer if self.shuffle else _READ_WINDOW
        window = max(1, window)
        for i, path in enumerate(self.files):
            wpath = self.weight_files[i] if self.weight_files else None
            with open(path) as f, (
                open(wpath) if wpath else contextlib.nullcontext()
            ) as wf:
                numbered = (
                    (path, no, line, self._weight(wf, wpath, no))
                    for no, line in enumerate(f, 1)
                )
                while True:
                    chunk = list(itertools.islice(numbered, window))
                    if not chunk:
                        break
                    if self.shuffle:
                        order = epoch_rng.permutation(len(chunk))
                        chunk = [chunk[j] for j in order]
                    yield from chunk

    @staticmethod
    def _weight(wf, wpath, no) -> float:
        if wf is None:
            return 1.0
        text = wf.readline()
        if not text:
            raise ValueError(f"{wpath} ends before line {no} of its data")
        return float(text)

    def _emit(self, examples, weights) -> bool:
        cfg = self.cfg
        batch = make_batch(examples, cfg.batch_size, cfg.max_features,
                           weights)
        if self.host_meta:
            batch = batch._replace(sort_meta=host_sort_meta(batch.ids))
        return self._put(batch)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _groups(self, epoch_rng):
        """The epoch's lines in groups of ``batch_size`` (the last one
        shorter), blank and comment lines (which parse to nothing) left
        out: one group per batch."""
        group = []
        for rec in self._lines(epoch_rng):
            text = rec[2].strip()
            if not text or text.startswith("#"):
                continue
            group.append(rec)
            if len(group) == self.cfg.batch_size:
                yield group
                group = []
        if group:
            yield group

    def _produce(self) -> None:
        cfg = self.cfg
        try:
            for epoch in range(self.epochs):
                rng = np.random.default_rng(cfg.seed + epoch)
                groups = self._groups(rng)
                if self.shard[1] > 1:
                    groups = _strided_rounds(groups, *self.shard)
                for group in groups:
                    examples, weights = [], []
                    for path, no, line, w in group:
                        try:
                            ex = parse_line(line, cfg.vocabulary_size,
                                            cfg.hash_feature_id,
                                            cfg.field_num)
                        except ValueError as e:
                            raise ValueError(f"{path}:{no}: {e}") from None
                        if len(ex.ids) > cfg.max_features:
                            self.truncated_features += (
                                len(ex.ids) - cfg.max_features
                            )
                        examples.append(ex)
                        weights.append(w)
                    if not self._emit(examples, weights):
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
