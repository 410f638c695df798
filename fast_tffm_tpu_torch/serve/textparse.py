"""Vectorized libsvm/ffm request parsing for the serving hot path.

The reference system exists because per-example Python parsing was too
slow — its ``FmParser`` is a native *batch* parser precisely so the
per-example cost is amortized (PAPER.md §1).  The serving endpoint
re-introduced that class of cost: ``parse_request`` walked the request
body one line at a time through :func:`libsvm.parse_line`, paying a
``tok.split(":")`` + two regex fullmatches + three list appends per
feature token (``serve.parse`` p50 ≈ 2.7x the binary transport's
``serve.parse_bin`` decode on the bench bodies).

This module is the batch rewrite, in the style of ``serve/wire.py``'s
binary decode: tokenize the WHOLE body once, validate every token with
ONE compiled-regex scan, recover the token structure with an
``np.frombuffer`` byte scan (space/colon masks -> token ids -> per-token
colon counts), convert ids/values/fields with ``np.fromiter`` over the
builtin ``int``/``float`` (bit-identical to the per-token conversions),
and scatter into the padded ``(ids, vals, fields)`` arrays with one
fancy-indexed assignment.

The contract is BITWISE equality with the legacy parser — including the
first-token-is-label rule, comment/blank skipping, ``max_features``
truncation counting, and per-line ``ValueError`` attribution.  The fast
path is *optimistic*: its validation grammar is exactly the accepted
language (with narrow digit-count caps for int64 safety), and on ANY
anomaly — a malformed token, an oversized integer literal, a vocabulary
that cannot index an int32 table — it falls back to re-parsing the whole
body through the legacy path, which reproduces the legacy behavior (and
the legacy error text, naming the offending line) by construction.
Errors are not the hot path; correctness there is worth a reparse.

:class:`ParseScratchPool` is the allocation-discipline half: recycled
per-request ``(ids, vals, fields)`` scratch bucketed by power-of-two row
capacity, the scorer's per-rung staging-buffer idiom applied to request
parsing, so steady-state text scoring allocates near-zero per request.
Lifecycle: the HTTP handler acquires through ``parse_request(...,
pool=...)`` and hands an ``on_done`` release callback to the batcher;
the dispatcher fires it exactly once after the microbatch copy and the
quality fold — the last readers of the request arrays.

This is the PyTorch port's own copy of ``fast_tffm_tpu/serve/textparse.py``
(numpy + the hash oracle only), so a request body parses to the same
arrays in both packages.
"""

from __future__ import annotations

import logging
import re
import threading
from typing import Optional

import numpy as np

from fast_tffm_tpu_torch.data import libsvm

log = logging.getLogger(__name__)

__all__ = ["ParseScratchPool", "parse_request"]


class _Fallback(Exception):
    """Internal: the fast path declined; re-parse through legacy."""


# The accepted token language, mirroring libsvm.py's strict ASCII
# grammar (_FLOAT_RE / _INT_RE) exactly — anything outside it must fall
# back so the LEGACY path raises the legacy error text.  The only
# narrowing: integer literals are capped at 18 digits (ids) / 9 digits
# (fields) so the vectorized int64/int32 conversions cannot overflow;
# longer literals are valid legacy input and simply take the fallback.
_FLOAT = (
    r"(?:[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    r"|[+-]?(?:inf(?:inity)?|nan))"
)
_FIELD = r"[+-]?\d{1,9}"
_INT_ID = r"[+-]?\d{1,18}"
_HASH_ID = r"[^\s:]*"

_LABELS_RE = re.compile(
    f"{_FLOAT}(?: {_FLOAT})*", re.IGNORECASE | re.ASCII
)


def _feats_re(hash_mode: bool) -> re.Pattern:
    # Alternatives per token: field:id:val | id:val | bare id.  Ordered
    # 2-piece first (the dominant production traffic shape).  Tokens
    # contain no whitespace (they come from str.split), so the joined
    # validation string maps one token to exactly one alternative.
    if hash_mode:
        one = (
            f"(?:{_HASH_ID}:{_FLOAT}|{_FIELD}:{_HASH_ID}:{_FLOAT}"
            f"|[^\\s:]+)"
        )
    else:
        one = (
            f"(?:{_INT_ID}:{_FLOAT}|{_FIELD}:{_INT_ID}:{_FLOAT}"
            f"|{_INT_ID})"
        )
    return re.compile(f"{one}(?: {one})*", re.IGNORECASE | re.ASCII)


_FEATS_RE = _feats_re(False)
_FEATS_HASH_RE = _feats_re(True)

# Uniform fast lanes: production scoring traffic is overwhelmingly
# homogeneous `id:val` (or ffm `field:id:val`) tokens, and a body that
# matches one of these shapes end-to-end needs NO per-token structure
# recovery — the flat piece list alternates with a fixed stride, so the
# byte scan, bincount, and object-array gathers all collapse into list
# slicing.  On 1-line bodies this is the difference between beating the
# per-line parser and losing to numpy call overhead.
_UNI2_RE = re.compile(
    f"{_INT_ID}:{_FLOAT}(?: {_INT_ID}:{_FLOAT})*",
    re.IGNORECASE | re.ASCII,
)
_UNI2_HASH_RE = re.compile(
    f"{_HASH_ID}:{_FLOAT}(?: {_HASH_ID}:{_FLOAT})*",
    re.IGNORECASE | re.ASCII,
)
_UNI3_RE = re.compile(
    f"{_FIELD}:{_INT_ID}:{_FLOAT}(?: {_FIELD}:{_INT_ID}:{_FLOAT})*",
    re.IGNORECASE | re.ASCII,
)
_UNI3_HASH_RE = re.compile(
    f"{_FIELD}:{_HASH_ID}:{_FLOAT}(?: {_FIELD}:{_HASH_ID}:{_FLOAT})*",
    re.IGNORECASE | re.ASCII,
)

_INT32_MAX = np.iinfo(np.int32).max


class ParseScratchPool:
    """Recycled per-request parse scratch (ids/vals/fields triples).

    Buffers are bucketed by power-of-two row capacity and zero-filled
    on acquire (padding slots must stay inert).  Requests above
    ``max_pooled_rows`` get fresh untracked arrays — a single giant
    request must not pin its high-water footprint forever.  ``release``
    takes any of the returned row views and recovers the backing
    buffer; releasing an untracked (or already-released) array is a
    no-op, so the release callback is safe to fire from any failure
    path.  Thread-safe: handlers on different pool workers acquire
    concurrently.

    Telemetry (optional): ``serve.parse_scratch_reuse`` counts recycled
    acquires (the steady state should be all-reuse, the analogue of
    ``prefetch.staging_reuse``), ``serve.parse_scratch_bytes`` gauges
    the pool-owned buffer bytes (free + leased).
    """

    def __init__(self, max_features: int, telemetry=None,
                 max_pooled_rows: int = 4096,
                 max_free_per_bucket: int = 32):
        self._F = max(1, int(max_features))
        self._max_rows = int(max_pooled_rows)
        self._max_free = int(max_free_per_bucket)
        self._free: dict = {}    # cap -> [bufs, ...]
        self._leased: dict = {}  # id(ids buffer) -> (cap, bufs)
        self._bytes = 0
        self._lock = threading.Lock()
        self._c_reuse = (
            telemetry.counter("serve.parse_scratch_reuse")
            if telemetry is not None else None
        )
        self._g_bytes = (
            telemetry.gauge("serve.parse_scratch_bytes")
            if telemetry is not None else None
        )

    def _alloc(self, rows: int):
        return (
            np.zeros((rows, self._F), np.int32),
            np.zeros((rows, self._F), np.float32),
            np.zeros((rows, self._F), np.int32),
        )

    def acquire(self, n: int):
        """Zero-filled ``(ids, vals, fields)`` views of shape
        ``(n, max_features)`` backed by recycled buffers."""
        if n > self._max_rows:
            return self._alloc(n)
        cap = 1
        while cap < n:
            cap <<= 1
        with self._lock:
            stack = self._free.get(cap)
            bufs = stack.pop() if stack else None
        if bufs is None:
            bufs = self._alloc(cap)
            with self._lock:
                self._bytes += sum(b.nbytes for b in bufs)
                if self._g_bytes is not None:
                    self._g_bytes.set(self._bytes)
        else:
            if self._c_reuse is not None:
                self._c_reuse.add()
            for b in bufs:
                b[:n].fill(0)
        with self._lock:
            self._leased[id(bufs[0])] = (cap, bufs)
        return bufs[0][:n], bufs[1][:n], bufs[2][:n]

    def release(self, ids_view) -> None:
        """Return a leased buffer (identified by any row view of its
        ids array) to the free list.  No-op for untracked arrays."""
        base = ids_view.base if ids_view.base is not None else ids_view
        with self._lock:
            entry = self._leased.pop(id(base), None)
            if entry is None:
                return
            cap, bufs = entry
            stack = self._free.setdefault(cap, [])
            if len(stack) < self._max_free:
                stack.append(bufs)
            else:
                self._bytes -= sum(b.nbytes for b in bufs)
                if self._g_bytes is not None:
                    self._g_bytes.set(self._bytes)

    @property
    def leased(self) -> int:
        with self._lock:
            return len(self._leased)


def _acquire(pool: Optional[ParseScratchPool], n: int, F: int):
    if pool is not None:
        return pool.acquire(n)
    return (
        np.zeros((n, F), np.int32),
        np.zeros((n, F), np.float32),
        np.zeros((n, F), np.int32),
    )


def _parse_legacy(text: str, cfg, pool: Optional[ParseScratchPool]):
    """The per-line oracle path: one :func:`libsvm.parse_line` per
    line, filling the padded arrays DIRECTLY (one sliced assignment per
    row — the old intermediate ``examples`` list and its second
    row-by-row copy are gone).  Also the fast path's fallback, so its
    behavior — including error text — IS the parse contract."""
    F = cfg.max_features
    rows = []
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        rows.append((lineno, stripped))
    n = len(rows)
    ids, vals, fields = _acquire(pool, n, F)
    truncated = 0
    try:
        for i, (lineno, stripped) in enumerate(rows):
            if ":" in stripped.split(None, 1)[0]:
                # First token carries ':' -> label-less client line;
                # graft the ignored label column parse_line expects.
                stripped = "0 " + stripped
            try:
                ex = libsvm.parse_line(
                    stripped, cfg.vocabulary_size, cfg.hash_feature_id,
                    cfg.field_num,
                )
            except ValueError as e:
                raise ValueError(f"line {lineno}: {e}") from e
            k = min(len(ex.ids), F)
            truncated += len(ex.ids) - k
            ids[i, :k] = ex.ids[:k]
            vals[i, :k] = ex.vals[:k]
            fields[i, :k] = ex.fields[:k]
    except BaseException:
        if pool is not None:
            pool.release(ids)
        raise
    return ids, vals, fields, n, truncated


def _conv_ids(id_strs, hash_mode: bool, vocab: int, count: int):
    """Feature-id strings -> int64 bucket array, bit-identical to the
    per-token legacy conversion (numpy ``%`` with a positive divisor
    matches Python's sign convention)."""
    if hash_mode:
        hb = libsvm.hash_bucket
        return np.fromiter(
            (hb(s, vocab) for s in id_strs), np.int64, count=count
        )
    return np.fromiter(map(int, id_strs), np.int64, count=count) % vocab


def _parse_vec(text: str, cfg, pool: Optional[ParseScratchPool]):
    """The optimistic batch path.  Raises :class:`_Fallback` (never a
    user-facing error) whenever the body strays from the fast grammar;
    acquires scratch only after the last fallible step, so a fallback
    leaks nothing."""
    F = cfg.max_features
    vocab = cfg.vocabulary_size
    if vocab > _INT32_MAX:
        raise _Fallback  # legacy owns the (crashing) overflow behavior
    hash_mode = cfg.hash_feature_id
    labels: list = []
    feats: list = []
    nfeat: list = []
    for line in text.splitlines():
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        toks = s.split()
        if ":" in toks[0]:
            nfeat.append(len(toks))
            feats.extend(toks)
        else:
            labels.append(toks[0])
            nfeat.append(len(toks) - 1)
            feats.extend(toks[1:])
    n = len(nfeat)
    if labels and _LABELS_RE.fullmatch(" ".join(labels)) is None:
        raise _Fallback
    ntok = len(feats)
    if ntok == 0:
        ids, vals, fields = _acquire(pool, n, F)
        return ids, vals, fields, n, 0
    joined = " ".join(feats)
    # Uniform lanes first: the total colon count is a one-pass
    # discriminator (ntok colons <-> possibly all id:val, 2*ntok <->
    # possibly all field:id:val), confirmed by the matching uniform
    # regex.  A confirmed uniform body needs no structure recovery at
    # all — the flat piece list strides by 2 (or 3).  ``fields_t is
    # None`` means "all fields zero": the scratch is already
    # zero-filled, and 0 stays 0 under any field_num fold.
    ncolon = joined.count(":")
    fids = vals_t = fields_t = None
    try:
        if ncolon == ntok and (
            _UNI2_HASH_RE if hash_mode else _UNI2_RE
        ).fullmatch(joined) is not None:
            parts = joined.replace(":", " ").split(" ")
            fids = _conv_ids(parts[0::2], hash_mode, vocab, ntok)
            vals_t = np.fromiter(
                map(float, parts[1::2]), np.float64, count=ntok
            )
        elif ncolon == 2 * ntok and (
            _UNI3_HASH_RE if hash_mode else _UNI3_RE
        ).fullmatch(joined) is not None:
            parts = joined.replace(":", " ").split(" ")
            fids = _conv_ids(parts[1::3], hash_mode, vocab, ntok)
            vals_t = np.fromiter(
                map(float, parts[2::3]), np.float64, count=ntok
            )
            fields_t = np.fromiter(
                map(int, parts[0::3]), np.int64, count=ntok
            )
            if cfg.field_num:
                fields_t %= cfg.field_num
    except (ValueError, OverflowError):
        raise _Fallback from None
    if fids is None:
        fids, vals_t, fields_t = _parse_mixed(joined, ntok, cfg)
    # Scatter into the padded rows; slots beyond max_features are the
    # truncation the legacy loop counts with len(ex.ids) - k.
    if n == 1:
        k = ntok if ntok <= F else F
        ids, vals, fields = _acquire(pool, 1, F)
        ids[0, :k] = fids[:k]
        vals[0, :k] = vals_t[:k]
        if fields_t is not None:
            fields[0, :k] = fields_t[:k]
        return ids, vals, fields, 1, ntok - k
    L = nfeat[0]
    if ntok == n * L and nfeat.count(L) == n:
        # Equal-length lines (the common batch shape): one reshaped
        # block assignment per array instead of a fancy-index scatter.
        k = L if L <= F else F
        ids, vals, fields = _acquire(pool, n, F)
        ids[:, :k] = fids.reshape(n, L)[:, :k]
        vals[:, :k] = vals_t.reshape(n, L)[:, :k]
        if fields_t is not None:
            fields[:, :k] = fields_t.reshape(n, L)[:, :k]
        return ids, vals, fields, n, (L - k) * n
    nfeat_a = np.asarray(nfeat, np.int64)
    cum0 = np.zeros(n, np.int64)
    np.cumsum(nfeat_a[:-1], out=cum0[1:])
    line_of = np.repeat(np.arange(n), nfeat_a)
    slot = np.arange(ntok, dtype=np.int64) - cum0[line_of]
    keep = slot < F
    truncated = ntok - int(keep.sum())
    if truncated:
        line_of = line_of[keep]
        slot = slot[keep]
        fids = fids[keep]
        vals_t = vals_t[keep]
        if fields_t is not None:
            fields_t = fields_t[keep]
    ids, vals, fields = _acquire(pool, n, F)
    ids[line_of, slot] = fids
    vals[line_of, slot] = vals_t
    if fields_t is not None:
        fields[line_of, slot] = fields_t
    return ids, vals, fields, n, truncated


def _parse_mixed(joined: str, ntok: int, cfg):
    """Mixed-shape lane: full alternation validation, then structure
    recovery wire.py-style with one byte scan of the joined tokens.
    ' ' (0x20) and ':' (0x3a) bytes never occur inside UTF-8 multibyte
    sequences, so byte masks are exact even for hashed unicode ids.
    Returns flat ``(fids, vals_t, fields_t_or_None)`` token arrays."""
    vocab = cfg.vocabulary_size
    pat = _FEATS_HASH_RE if cfg.hash_feature_id else _FEATS_RE
    if pat.fullmatch(joined) is None:
        raise _Fallback
    buf = np.frombuffer(joined.encode("utf-8"), np.uint8)
    tok_of = np.cumsum(buf == 0x20)
    ncol = np.bincount(tok_of[buf == 0x3A], minlength=ntok)
    pieces = np.array(
        joined.replace(":", " ").split(" "), dtype=object
    )
    if len(pieces) != ntok + int(ncol.sum()):
        raise _Fallback  # cannot happen post-validation; stay safe
    starts = np.zeros(ntok, np.int64)
    np.cumsum(ncol[:-1] + 1, out=starts[1:])
    three = ncol == 2
    try:
        # ids: 2nd piece of field:id:val tokens, 1st piece otherwise.
        fids = _conv_ids(
            pieces[starts + three], cfg.hash_feature_id, vocab, ntok
        )
        # values: last piece when any colon, else the implicit 1.0 of
        # a bare feature id.  map(float) keeps the double->float32
        # rounding bit-identical to the per-token legacy conversion.
        vals_t = np.ones(ntok, np.float64)
        has_val = ncol >= 1
        nv = int(has_val.sum())
        if nv == ntok:
            vals_t = np.fromiter(
                map(float, pieces[starts + ncol]), np.float64,
                count=ntok,
            )
        elif nv:
            vals_t[has_val] = np.fromiter(
                map(float, pieces[(starts + ncol)[has_val]]),
                np.float64, count=nv,
            )
        fields_t = None
        n3 = int(three.sum())
        if n3:
            fields_t = np.zeros(ntok, np.int64)
            fields_t[three] = np.fromiter(
                map(int, pieces[starts[three]]), np.int64, count=n3
            )
            if cfg.field_num:
                fields_t %= cfg.field_num
    except (ValueError, OverflowError):
        raise _Fallback from None
    return fids, vals_t, fields_t


def parse_request(text: str, cfg,
                  pool: Optional[ParseScratchPool] = None):
    """Request body -> ``(ids, vals, fields, n, truncated)`` arrays.

    One example per non-blank, non-comment line, ``predict_files``
    format.  A line whose FIRST token contains ``:`` is treated as
    label-less (scoring clients rarely have labels); anything else
    reads its first token as the label, so request files and predict
    files are interchangeable.  NOTE the inherent libsvm ambiguity this
    rule resolves deterministically: a line of BARE feature ids
    ("123 456 789") is indistinguishable from a labeled line, so its
    first token is always read as the label — bare-id clients must
    send an explicit label column (or ``id:1`` tokens); documented in
    SERVING.md.  Raises ValueError (-> HTTP 400) on a malformed line,
    naming the line.  ``truncated`` counts feature occurrences dropped
    by ``max_features`` — a truncated example scores as a DIFFERENT
    example, the same data-integrity event the ingest path surfaces as
    ``ingest.truncated_features`` (the server counts it as
    ``serve.truncated_features``).

    ``cfg.serve_parse_mode`` picks the engine: ``"vec"`` (default) runs
    the vectorized batch parser with automatic legacy fallback on any
    out-of-grammar input; ``"legacy"`` forces the per-line oracle.
    Both produce bitwise-identical arrays and errors (pinned by test).
    ``pool`` (optional) recycles the returned arrays' backing buffers;
    the caller owns the lease and releases via ``pool.release(ids)``
    once the batcher is done reading them.
    """
    if getattr(cfg, "serve_parse_mode", "vec") != "legacy":
        try:
            return _parse_vec(text, cfg, pool)
        except _Fallback:
            pass
    return _parse_legacy(text, cfg, pool)
