"""libsvm/ffm text parsing: the per-line parser the serving text path uses.

The PyTorch port's own copy of ``fast_tffm_tpu/data/libsvm.py``'s line
grammar and feature hashing (``parse_line``, ``hash_bucket``), so a request
line maps to the same bucket ids in both packages.  Padded feature slots
carry ``val == 0`` and contribute nothing to the FM score.

Supported line formats:
  - libsvm:  ``label id:val id:val ...``
  - ffm:     ``label field:id:val ...`` (field-aware FM extension)
  - ids are integers, or arbitrary strings when ``hash_feature_id`` is on.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

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
