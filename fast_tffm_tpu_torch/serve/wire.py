"""Binary request transport: the wire codec both scoring endpoints and
the router share.

The hot path's text cost is the per-request libsvm parse (the
``serve.parse`` timer measures it); this frame format is
the zero-parse alternative: the handler's whole decode is a header
unpack + ``np.frombuffer`` views.  One frame per request, all fields
LITTLE-ENDIAN (documented in SERVING.md "Binary frame layout"):

    request:   magic  u8[4]  = b"TFB1"
               n      u32    examples in the frame (0 allowed)
               f      u32    features per example AS SENT
               flags  u8     bit 0 = a fields array follows
                             bit 1 = a request-id trailer follows
               ids    i32[n*f]   row-major [n, f]
               vals   f32[n*f]
               fields i32[n*f]   present iff flags bit 0
               ridlen u16        present iff flags bit 1
               rid    u8[ridlen] utf-8 request id (distributed-trace
                                 correlation; <= 128 bytes)

    response:  magic  u8[4]  = b"TFB1"
               n      u32
               scores f32[n]     same order as the request's examples

The request-id trailer is the binary transport's spelling of the
``X-Request-Id`` header (SERVING.md "Request ids & distributed
tracing"): the router appends it to SAMPLED frames so the id rides the
frame itself across the proxy hop, and clients may set it directly.
It sits AFTER the arrays so the zero-copy ``np.frombuffer`` views are
untouched, and a frame without it is bit-for-bit the pre-trailer
layout — unsampled proxying stays byte-identical.

``f`` may differ from the server's ``max_features``: narrower frames
zero-pad (``vals == 0`` slots are mathematically inert), wider ones
truncate and count the dropped nonzero occurrences (the same
data-integrity semantics as the text path).  Ids reduce modulo
``vocabulary_size`` exactly like ``libsvm.parse_line``, so ``/score``
and ``/score_bin`` are bitwise-interchangeable for the same examples.

This is the PyTorch port's own copy of ``fast_tffm_tpu/serve/wire.py``'s
codec (numpy + stdlib only), byte-compatible with it: a frame one package
encodes, the other decodes to the same arrays.  The traffic-capture
container and the router's request-id helpers are not in the port yet.
"""

from __future__ import annotations

import struct

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig

__all__ = [
    "BIN_MAGIC", "MAX_BODY_BYTES", "MAX_REQUEST_ID_BYTES",
    "decode_bin_request", "decode_bin_response",
    "encode_bin_request", "encode_bin_response", "valid_request_id",
]

# POST body cap shared by every scoring endpoint (text and binary, the
# replicas and the router): far above any sane scoring request (a
# 64 MiB libsvm body is ~1M examples), far below what would hurt the
# host.
MAX_BODY_BYTES = 64 << 20

BIN_MAGIC = b"TFB1"
_BIN_HDR = struct.Struct("<4sIIB")
_BIN_RESP_HDR = struct.Struct("<4sI")
_RID_LEN = struct.Struct("<H")

# Frame flag bits.
_FLAG_FIELDS = 1
_FLAG_RID = 2

# Request-id cap (header values and frame trailers): ids are short
# correlation tokens, and an unauthenticated endpoint must not let a
# client inflate every span/log line with an arbitrary-length blob.
MAX_REQUEST_ID_BYTES = 128


def _rid_bytes(request_id: str) -> bytes:
    raw = request_id.encode("utf-8")
    if not raw or len(raw) > MAX_REQUEST_ID_BYTES:
        raise ValueError(
            f"request id must be 1..{MAX_REQUEST_ID_BYTES} utf-8 "
            f"bytes, got {len(raw)}"
        )
    return raw


def encode_bin_request(ids, vals, fields=None,
                       request_id=None) -> bytes:
    """``[n, f]`` arrays -> one request frame (the client half; tests,
    bench and the smoke build frames with it or from the documented
    layout directly).  ``request_id`` adds the flags-bit-1 trailer."""
    ids = np.ascontiguousarray(ids, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    if ids.shape != vals.shape or ids.ndim != 2:
        raise ValueError(
            f"ids/vals must be matching [n, f] arrays, got "
            f"{ids.shape} vs {vals.shape}"
        )
    n, f = ids.shape
    flags = (_FLAG_FIELDS if fields is not None else 0) | (
        _FLAG_RID if request_id is not None else 0
    )
    parts = [
        _BIN_HDR.pack(BIN_MAGIC, n, f, flags),
        ids.tobytes(), vals.tobytes(),
    ]
    if fields is not None:
        fields = np.ascontiguousarray(fields, np.int32)
        if fields.shape != ids.shape:
            raise ValueError(
                f"fields shape {fields.shape} != ids shape {ids.shape}"
            )
        parts.append(fields.tobytes())
    if request_id is not None:
        raw = _rid_bytes(request_id)
        parts.append(_RID_LEN.pack(len(raw)) + raw)
    return b"".join(parts)


def _trailer_rid(data: bytes, arrays_end: int):
    """Decode the flags-bit-1 request-id trailer starting at
    ``arrays_end``; returns the id string.  Raises ValueError on a
    malformed trailer (wrong length accounting, empty/oversized id,
    non-utf-8 bytes)."""
    if len(data) < arrays_end + _RID_LEN.size:
        raise ValueError(
            "frame flags announce a request-id trailer but the body "
            "ends before its length field"
        )
    (ridlen,) = _RID_LEN.unpack_from(data, arrays_end)
    if not 0 < ridlen <= MAX_REQUEST_ID_BYTES:
        raise ValueError(
            f"request-id trailer length {ridlen} outside "
            f"(0, {MAX_REQUEST_ID_BYTES}]"
        )
    end = arrays_end + _RID_LEN.size + ridlen
    if len(data) != end:
        raise ValueError(
            f"frame length {len(data)} != {end} expected with a "
            f"{ridlen}-byte request-id trailer"
        )
    try:
        return data[arrays_end + _RID_LEN.size:end].decode("utf-8")
    except UnicodeDecodeError:
        raise ValueError(
            "request-id trailer is not valid utf-8"
        ) from None


def decode_bin_request(data: bytes, cfg: FmConfig):
    """One request frame -> ``(ids, vals, fields, n, truncated, rid)``
    with the arrays padded/truncated to ``[n, cfg.max_features]`` — the
    same contract as ``server.parse_request``, minus the text parse.
    ``rid`` is the request-id trailer (None without flags bit 1).
    Raises ValueError (-> HTTP 400) on a malformed frame."""
    if len(data) < _BIN_HDR.size:
        raise ValueError(
            f"frame too short for the header ({len(data)} bytes)"
        )
    magic, n, f, flags = _BIN_HDR.unpack_from(data)
    if magic != BIN_MAGIC:
        raise ValueError(
            f"bad frame magic {magic!r} (want {BIN_MAGIC!r})"
        )
    has_fields = bool(flags & _FLAG_FIELDS)
    if n and not f:
        # Zero features per example would make the length check
        # vacuous: an n-of-billions header over a 13-byte body must
        # not reach the [n, max_features] allocation below.
        raise ValueError(f"frame claims n={n} examples with f=0")
    cells = n * f
    want = _BIN_HDR.size + cells * (12 if has_fields else 8)
    rid = None
    if flags & _FLAG_RID:
        rid = _trailer_rid(data, want)
    elif len(data) != want:
        raise ValueError(
            f"frame length {len(data)} != {want} expected for n={n} "
            f"f={f} fields={has_fields}"
        )
    off = _BIN_HDR.size
    ids = np.frombuffer(data, np.int32, cells, off).reshape(n, f)
    off += cells * 4
    vals = np.frombuffer(data, np.float32, cells, off).reshape(n, f)
    off += cells * 4
    fields = (
        np.frombuffer(data, np.int32, cells, off).reshape(n, f)
        if has_fields else None
    )
    F = cfg.max_features
    truncated = 0
    if f > F:
        # Same data-integrity semantics as the text path: a dropped
        # NONZERO occurrence means the example scores as a different
        # example; all-zero tails are plain padding.
        truncated = int(np.count_nonzero(vals[:, F:]))
        ids, vals = ids[:, :F], vals[:, :F]
        if fields is not None:
            fields = fields[:, :F]
    elif f < F:
        # Zero-pad by slice-assign into fresh buffers (np.pad's
        # generality costs real microseconds at request sizes, and
        # this path IS the latency path).
        pids = np.zeros((n, F), np.int32)
        pids[:, :f] = ids
        pvals = np.zeros((n, F), np.float32)
        pvals[:, :f] = vals
        ids, vals = pids, pvals
        if fields is not None:
            pf = np.zeros((n, F), np.int32)
            pf[:, :f] = fields
            fields = pf
    # The text path reduces every id modulo the vocabulary
    # (libsvm.parse_line); the binary path must agree or the two
    # transports would score out-of-range ids differently.  In-range
    # frames (every well-behaved client) pay two reductions and zero
    # copies.
    ids = _reduce_mod(ids, cfg.vocabulary_size)
    if fields is not None and cfg.field_num:
        fields = _reduce_mod(fields, cfg.field_num)
    return ids, vals, fields, int(n), truncated, rid


def _reduce_mod(arr: np.ndarray, modulus: int) -> np.ndarray:
    """``arr % modulus`` with Python's nonnegative-remainder
    semantics, skipping the copy when every value is already in
    range."""
    if arr.size == 0 or (
        0 <= int(arr.min()) and int(arr.max()) < modulus
    ):
        return arr
    if modulus <= 0x7FFFFFFF:
        return np.mod(arr, np.int32(modulus))
    return (arr.astype(np.int64) % modulus).astype(np.int32)


def valid_request_id(rid) -> bool:
    """A usable client-supplied request id: non-empty, within the byte
    cap, printable ASCII only.  The id is echoed in a response HEADER:
    CR/LF would be response splitting, and anything http.server's
    latin-1-strict header encoder can't write would corrupt the
    kept-alive stream mid-response — so both the header path and the
    binary frame's trailer are screened through this before the id is
    ever reflected."""
    if not rid or len(rid) > MAX_REQUEST_ID_BYTES:
        return False
    return all(0x20 <= ord(ch) <= 0x7E for ch in rid)


def encode_bin_response(scores) -> bytes:
    scores = np.ascontiguousarray(scores, np.float32)
    return _BIN_RESP_HDR.pack(BIN_MAGIC, len(scores)) + scores.tobytes()


def decode_bin_response(data: bytes) -> np.ndarray:
    if len(data) < _BIN_RESP_HDR.size:
        raise ValueError(f"response frame too short ({len(data)} bytes)")
    magic, n = _BIN_RESP_HDR.unpack_from(data)
    if magic != BIN_MAGIC:
        raise ValueError(f"bad response magic {magic!r}")
    if len(data) != _BIN_RESP_HDR.size + 4 * n:
        raise ValueError(
            f"response frame length {len(data)} != header + {n} scores"
        )
    return np.frombuffer(data, np.float32, n, _BIN_RESP_HDR.size).copy()
