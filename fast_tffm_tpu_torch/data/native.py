"""ctypes wrapper around the port's C++ batch parser (``_src/fm_parser.cc``).

The port's counterpart of ``fast_tffm_tpu/data/native.py``.  The shared
library is built with ``g++`` at first use into ``data/_build/`` (again
whenever the source is newer than the library); nothing is built when
the module is imported.  Several processes may start the build at once
(a test run under ``xdist``): each compiles to a file named for its own
process and thread and moves it into place with ``os.replace``.  A
failed build raises with the compiler's output: the port has no silent
fall-back to its Python parser, which runs only where a caller asks for
it by name (``BatchPipeline(..., native=False)``).

- :class:`NativeParser`: ``parse_batch`` (lines as strings, the line
  stream's) and ``parse_raw`` (``[start, end)`` extents into a raw
  buffer, in any order: the raw-window stream's), each bitwise the
  Python parser's ``parse_line`` + ``make_batch``;
- :func:`sort_meta`: the port's :class:`~.libsvm.SortMeta` by the C++
  stable radix sort, bitwise :func:`~.libsvm.host_sort_meta`;
- :func:`find_line_offsets`, :func:`murmur64_native`.

``NativeParser.batches`` counts the batches every parser of the process
parsed (both entry points), as the kernels' wrappers count launches.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from fast_tffm_tpu_torch.data.libsvm import Batch, SortMeta

__all__ = [
    "BUILD_DIR", "LIB_PATH", "MalformedLineError", "NativeParser",
    "OutOfRangeIdsError", "find_line_offsets", "load", "murmur64_native",
    "sort_meta",
]

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_PATH = os.path.join(_HERE, "_src", "fm_parser.cc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libfm_parser.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class OutOfRangeIdsError(ValueError):
    """Batch ids outside ``[0, vocabulary_size)``: the input data and the
    vocabulary disagree (the reference's ``native.OutOfRangeIdsError``)."""


class MalformedLineError(ValueError):
    """A line the parser rejects; ``index`` is its row in the batch."""

    def __init__(self, msg: str, index: int):
        super().__init__(msg)
        self.index = index


def _build() -> str:
    """The library's path, built first when missing or older than the
    source.  Raises RuntimeError with the compiler's output on failure."""
    if (os.path.isfile(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC_PATH)):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           SRC_PATH, "-o", tmp]
    log.info("building the native parser: %s", " ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native parser build could not run g++: {e}") \
            from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"native parser build failed ({proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The loaded library (built first when needed)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        i64, i32, f32 = (
            np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS")
            for t in (np.int64, np.int32, np.float32)
        )
        outs = [f32, i32, f32, i32, f32, ctypes.c_void_p]
        lib.fm_parser_create.restype = ctypes.c_void_p
        lib.fm_parser_create.argtypes = [
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.fm_parser_destroy.argtypes = [ctypes.c_void_p]
        lib.fm_parser_parse.restype = ctypes.c_int64
        lib.fm_parser_parse.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, i64, ctypes.c_int64] + outs
        lib.fm_parser_parse_raw.restype = ctypes.c_int64
        # buf as void*: bytes convert to a pointer for c_void_p too.
        lib.fm_parser_parse_raw.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64, i64, ctypes.c_int64] + outs
        lib.fm_parser_murmur64.restype = ctypes.c_uint64
        lib.fm_parser_murmur64.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.fm_parser_find_lines.restype = ctypes.c_int64
        lib.fm_parser_find_lines.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i64, ctypes.c_int64]
        lib.fm_sort_meta.restype = ctypes.c_int64
        lib.fm_sort_meta.argtypes = [i32, ctypes.c_int64, ctypes.c_int64,
                                     i32, i32]
        _lib = lib
        return lib


def sort_meta(ids, vocab: int) -> SortMeta:
    """:class:`SortMeta` of ``ids`` (any shape, flattened) by the C++
    stable sort: bitwise :func:`~.libsvm.host_sort_meta`.  An id outside
    ``[0, vocab)`` raises :class:`OutOfRangeIdsError`."""
    lib = load()
    flat = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int32)
    n = flat.shape[0]
    perm = np.empty((n,), np.int32)
    seg_start = np.empty((n + 1,), np.int32)
    u = lib.fm_sort_meta(flat, n, vocab, perm, seg_start)
    if u < 0:
        lo = int(flat.min()) if n else 0
        hi = int(flat.max()) if n else 0
        raise OutOfRangeIdsError(
            f"out-of-range batch ids (outside [0, {vocab})): min={lo} "
            f"max={hi}; the input data and vocabulary_size disagree"
        )
    return SortMeta(perm, seg_start[:u + 1])


def find_line_offsets(buf: bytes, length: Optional[int] = None,
                      guess: Optional[int] = None) -> np.ndarray:
    """Line-start offsets in ``buf[:length]``: 0, then the byte after each
    ``\\n`` but a trailing one (a C++ ``memchr`` scan)."""
    lib = load()
    n_len = len(buf) if length is None else length
    guess = max(16, n_len // 64 if guess is None else guess)
    while True:
        out = np.empty((guess,), np.int64)
        n = lib.fm_parser_find_lines(buf, n_len, out, guess)
        if n <= guess:
            return out[:n]
        guess = n


def murmur64_native(data: bytes) -> int:
    """MurmurHash64A of ``data`` (seed 0), as ``libsvm.murmur64``."""
    return load().fm_parser_murmur64(data, len(data))


class NativeParser:
    """Parses batches of libsvm/ffm lines with the C++ library
    (``num_threads`` C++ threads a batch; the pipeline's workers take
    one each)."""

    batches = 0  # batches parsed by every parser of the process
    _count_lock = threading.Lock()

    def __init__(self, vocabulary_size: int, max_features: int,
                 hash_feature_id: bool = False, field_num: int = 0,
                 num_threads: int = 1):
        self._lib = load()
        self.max_features = max_features
        self.truncated_features = 0  # feature occurrences cut off
        self._trunc_lock = threading.Lock()
        self._handle = self._lib.fm_parser_create(
            vocabulary_size, max_features, int(hash_feature_id), field_num,
            num_threads,
        )
        if not self._handle:
            raise ValueError(
                f"vocabulary_size {vocabulary_size} out of range (must be "
                f"in [1, 2^59) for the native parser)"
            )

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.fm_parser_destroy(handle)
            self._handle = None

    def _outputs(self, batch_size: int):
        f = self.max_features
        return (np.zeros((batch_size,), np.float32),
                np.zeros((batch_size, f), np.int32),
                np.zeros((batch_size, f), np.float32),
                np.zeros((batch_size, f), np.int32),
                np.zeros((batch_size,), np.float32))

    def _done(self, dropped: int, out, text_of) -> Batch:
        if dropped < 0:
            bad = -int(dropped) - 1
            raise MalformedLineError(
                f"malformed libsvm input at batch line {bad}: "
                f"{text_of(bad)!r}", bad)
        with self._trunc_lock:
            self.truncated_features += int(dropped)
        with NativeParser._count_lock:
            NativeParser.batches += 1
        return Batch(*out)

    def parse_batch(self, lines: Sequence[str], batch_size: int,
                    weights: Optional[Sequence[float]] = None) -> Batch:
        """The batch of ``lines`` (blank and ``#`` lines at weight 0),
        padded to ``batch_size`` rows; ``weights`` one per line."""
        n = len(lines)
        if n > batch_size:
            raise ValueError(f"{n} lines > batch_size {batch_size}")
        encoded = [s.encode("utf-8") for s in lines]
        buf = b"\n".join(encoded)
        offsets = np.zeros((n + 1,), np.int64)
        np.cumsum(np.fromiter((len(e) + 1 for e in encoded), np.int64,
                              count=n), out=offsets[1:])
        if n:
            offsets[n] -= 1  # the last line has no separator after it
        w_ptr, w_in = None, None
        if weights is not None:
            w_in = np.ascontiguousarray(weights, np.float32)
            if w_in.shape != (n,):
                raise ValueError("weights must have one entry per line")
            w_ptr = w_in.ctypes.data_as(ctypes.c_void_p)
        out = self._outputs(batch_size)
        dropped = self._lib.fm_parser_parse(self._handle, buf, offsets, n,
                                            *out, w_ptr)
        return self._done(dropped, out, lambda i: lines[i])

    def parse_raw(self, buf, starts: np.ndarray, ends: np.ndarray,
                  batch_size: int) -> Batch:
        """The batch of lines ``buf[starts[i]:ends[i]]``, in any order and
        not necessarily contiguous (a permuted window), straight out of
        ``buf`` with no string per line; blank and ``#`` lines become
        weight-0 rows.  ``buf`` is ``bytes`` or any other buffer (a
        ``uint8`` view of a shared-memory ring slot: the parse workers
        read it in place, passed by address)."""
        n = len(starts)
        if n > batch_size:
            raise ValueError(f"{n} lines > batch_size {batch_size}")
        if len(ends) != n:
            raise ValueError(f"starts/ends length mismatch: {n}/{len(ends)}")
        starts = np.ascontiguousarray(starts, np.int64)
        ends = np.ascontiguousarray(ends, np.int64)
        view = buf if isinstance(buf, bytes) else np.frombuffer(buf, np.uint8)
        if n and (starts.min() < 0 or ends.max() > len(view)
                  or (starts > ends).any()):
            raise ValueError(
                f"line extents outside the {len(view)}-byte buffer")
        arg = buf if isinstance(buf, bytes) else view.ctypes.data
        out = self._outputs(batch_size)
        dropped = self._lib.fm_parser_parse_raw(self._handle, arg, starts,
                                                ends, n, *out, None)
        return self._done(dropped, out,
                          lambda i: bytes(buf[starts[i]:ends[i]]))
