"""libsvm/ffm text parsing and fixed-shape batches.

The PyTorch port's own copy of ``fast_tffm_tpu/data/libsvm.py``'s line
grammar and feature hashing (``parse_line``, ``hash_bucket``), so a line
maps to the same bucket ids in both packages, and of its ``Batch``,
``parse_lines`` and ``make_batch``.  Padded feature slots carry
``val == 0`` and contribute nothing to the FM score or its gradient.

``SortMeta`` / :func:`host_sort_meta` are the port's own host prep for
the sparse apply (``ops/sparse_apply.py``): a stable sort of a batch's
flat ids, by numpy here (the plain version); the parse workers compute
the same arrays with the C++ sort (``data/native.py::sort_meta``).  The
reference's CHUNK/TILE-shaped meta exists for its TPU kernels and is not
carried over.

Supported line formats:
  - libsvm:  ``label id:val id:val ...``
  - ffm:     ``label field:id:val ...`` (field-aware FM extension)
  - ids are integers, or arbitrary strings when ``hash_feature_id`` is on.
"""

from __future__ import annotations

import re
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np

# Strict numeric token grammar, shared spec with the C++ parser: plain
# Python float()/int() accept forms C parsing rejects (underscore
# literals "1_0", Unicode digits), and C's strtof accepts forms Python
# rejects (hex floats "0x10", nan payloads "nan(x)").  Both sides pin to
# the ASCII intersection; a fuzz test (test_native_parser) found the
# divergences.
_FLOAT_RE = re.compile(
    r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|[+-]?(?:inf(?:inity)?|nan)",
    re.IGNORECASE | re.ASCII,
)
_INT_RE = re.compile(r"[+-]?\d+", re.ASCII)


def _strict_float(token: str) -> float:
    if not _FLOAT_RE.fullmatch(token):
        raise ValueError(f"could not convert string to float: {token!r}")
    return float(token)


def _strict_int(token: str) -> int:
    if not _INT_RE.fullmatch(token):
        raise ValueError(f"invalid literal for int(): {token!r}")
    return int(token)

_MASK64 = (1 << 64) - 1
_M = 0xC6A4A7935BD1E995
_R = 47


def murmur64(data: bytes, seed: int = 0) -> int:
    """MurmurHash64A — matches the C++ implementation bit-for-bit."""
    length = len(data)
    h = (seed ^ ((length * _M) & _MASK64)) & _MASK64
    n_blocks = length // 8
    for i in range(n_blocks):
        k = int.from_bytes(data[i * 8 : i * 8 + 8], "little")
        k = (k * _M) & _MASK64
        k ^= k >> _R
        k = (k * _M) & _MASK64
        h ^= k
        h = (h * _M) & _MASK64
    tail = data[n_blocks * 8 :]
    if tail:
        t = int.from_bytes(tail, "little")
        h ^= t
        h = (h * _M) & _MASK64
    h ^= h >> _R
    h = (h * _M) & _MASK64
    h ^= h >> _R
    return h


def hash_bucket(token: str, vocabulary_size: int) -> int:
    return murmur64(token.encode("utf-8")) % vocabulary_size


class Example(NamedTuple):
    label: float
    ids: list[int]
    vals: list[float]
    fields: list[int]


def parse_line(
    line: str,
    vocabulary_size: int,
    hash_feature_id: bool = False,
    field_num: int = 0,
) -> Optional[Example]:
    """Parse one libsvm/ffm line. Returns None for blank/comment lines."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    parts = line.split()
    label = _strict_float(parts[0])
    # The reference trains logistic loss on CTR labels; accept {-1,1} and
    # {0,1} conventions by folding -1 to 0.
    if label == -1.0:
        label = 0.0
    ids: list[int] = []
    vals: list[float] = []
    fields: list[int] = []
    for tok in parts[1:]:
        pieces = tok.split(":")
        if len(pieces) == 3:
            field_s, id_s, val_s = pieces
            field = _strict_int(field_s)
        elif len(pieces) == 2:
            field = 0
            id_s, val_s = pieces
        elif len(pieces) == 1:
            # Bare feature id => implicit value 1.0 (binary features).
            field, id_s, val_s = 0, pieces[0], "1"
        else:
            raise ValueError(f"malformed feature token {tok!r}")
        if hash_feature_id:
            fid = hash_bucket(id_s, vocabulary_size)
        else:
            fid = _strict_int(id_s) % vocabulary_size
        if field_num:
            field = field % field_num
        ids.append(fid)
        vals.append(_strict_float(val_s))
        fields.append(field)
    return Example(label, ids, vals, fields)


def parse_lines(
    lines: Iterable[str],
    vocabulary_size: int,
    hash_feature_id: bool = False,
    field_num: int = 0,
) -> list[Example]:
    """Parse ``lines`` with :func:`parse_line`, skipping blank ones."""
    out = []
    for line in lines:
        ex = parse_line(line, vocabulary_size, hash_feature_id, field_num)
        if ex is not None:
            out.append(ex)
    return out


class SortMeta(NamedTuple):
    """Sparse-apply prep for one batch's flat ids ``[n]`` (numpy on the
    host, or tensors once moved to the device)."""

    perm: np.ndarray  # [n] i32: occurrence index of each sorted position
    seg_start: np.ndarray  # [U + 1] i32: first sorted position of each
    #                        unique id, then n


def host_sort_meta(ids: np.ndarray) -> SortMeta:
    """:class:`SortMeta` of ``ids`` (any shape, flattened) by a stable
    numpy sort: the same arrays as ``ops.sparse_apply.sort_meta`` gives
    on the device."""
    flat = np.asarray(ids).reshape(-1)
    n = flat.shape[0]
    perm = np.argsort(flat, kind="stable")
    s = flat[perm]
    cuts = np.flatnonzero(s[1:] != s[:-1]) + 1
    seg_start = np.concatenate([[0], cuts, [n] if n else []])
    return SortMeta(perm.astype(np.int32), seg_start.astype(np.int32))


class Batch(NamedTuple):
    """A fixed-shape parsed batch (numpy on the host, or tensors once
    moved to the device).

    Padded feature slots have ``vals == 0`` (and ``ids == 0``), which makes
    them mathematically inert in the FM score and gradient.
    """

    labels: np.ndarray  # [B] float32, in {0, 1} for logistic loss
    ids: np.ndarray  # [B, F] int32 bucket ids
    vals: np.ndarray  # [B, F] float32 feature values (0 = padding)
    fields: np.ndarray  # [B, F] int32 field ids (all 0 for plain FM)
    weights: np.ndarray  # [B] float32 per-example weights
    sort_meta: Optional[SortMeta] = None  # host prep for the sparse apply


def make_batch(
    examples: Sequence[Optional[Example]],
    batch_size: int,
    max_features: int,
    weights: Optional[Sequence[float]] = None,
) -> Batch:
    """Pad/truncate examples into a static-shape Batch.

    Short batches (end of epoch) are padded with weight-0 examples so the
    shapes never change; features beyond ``max_features`` are dropped.
    A ``None`` example (a blank or comment line of the raw-window
    stream) keeps its row, all zeros, with weight 0, as the reference's
    C++ ``fm_parser_parse_raw`` writes it.
    """
    n = len(examples)
    if n > batch_size:
        raise ValueError(f"{n} examples > batch_size {batch_size}")
    labels = np.zeros((batch_size,), np.float32)
    ids = np.zeros((batch_size, max_features), np.int32)
    vals = np.zeros((batch_size, max_features), np.float32)
    fields = np.zeros((batch_size, max_features), np.int32)
    w = np.zeros((batch_size,), np.float32)
    for i, ex in enumerate(examples):
        if ex is None:
            continue
        labels[i] = ex.label
        k = min(len(ex.ids), max_features)
        ids[i, :k] = ex.ids[:k]
        vals[i, :k] = ex.vals[:k]
        fields[i, :k] = ex.fields[:k]
        w[i] = 1.0 if weights is None else weights[i]
    return Batch(labels, ids, vals, fields, w)
