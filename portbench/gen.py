"""The benchmark's one traffic generator: seeded, labelled libsvm lines of a
configuration's field schema, drawn as a traffic mix says.

A configuration's ``schema`` (``configs/<config>.json``) lists its fields
in line order, each ``[name, kind, size]``:

- ``bucket``: an integer field cut into ``size`` buckets, written
  ``<name>_<bb>:<v.vvvv>`` (two-digit bucket, a value uniform in
  [0.5, 1.5) at four decimals);
- ``categorical``: a string field of ``size`` distinct values, written
  ``<name>_<8 hex digits>:1``.

its ``label``: ``P(y = 1) = sigmoid(bias + sum of terms)``, each term
``{"field", "kind": "table", "sd"}`` (a seeded N(0, sd) weight per bucket)
or ``{"field", "kind": "cos", "w"}`` (``w * cos(value + 1)``, the value
being a categorical field's rank); and its ``zipf_exponent`` ``a``.  A
mix (``traffic/<mix>.json``) says how categorical values are drawn:
``"categorical": "zipf"`` takes rank ``r`` of the continuous ``1 / r^a``
law over the field's distinct count, spread over 32-bit hex by a fixed
odd multiplier.

The exponent is the configuration's, worked out from its dataset's
published counts by :func:`implied_exponent`: for each field whose
distinct values number a million or more (ids that keep arriving: users,
devices, sites, ads), the exponent of the unbounded law under which the
dataset's line count draws that many distinct values; the median of
those fields' exponents is the configuration's.

Frozen from two writers of the port's tree, and departing from them only
as said: ``fast_tffm_tpu_torch/tools/ingest_bench.py::write_files`` (13
bucketed integer fields with a label planted on their buckets, uniform
32-bit categorical values; here with the Zipf draw over each field's own
distinct count in their place) and ``chip_smoke.py::write_avazu`` (Zipf
ranks over the field's distinct count, ``rank * 2654435761 + j * 40503``
modulo 2^32, the cosine-planted label).  Buckets are written with two
digits, so every line of a configuration has the same length, and the
text is assembled as one byte matrix in numpy.

Everything follows from the seed: one ``numpy.random.default_rng(seed)``
draws the label tables, then each field in order, then the labels.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Lines", "expected_distinct", "implied_exponent",
           "make_lines"]

_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)
_SPREAD = 2654435761
_FIELD_STEP = 40503


@dataclasses.dataclass
class Lines:
    """``n`` generated lines: ``text [n, L]`` uint8 (each row one line,
    ``\\n`` included); per field the token's id part ``keys[j] [n, Lj]``
    uint8 (what the parser hashes) and its value ``vals[j] [n]`` float32
    as parsed; ``labels [n]`` in {0, 1}."""

    text: np.ndarray
    keys: list
    vals: list
    labels: np.ndarray

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.text.tobytes())


def _digits(values: np.ndarray, width: int, base: int) -> np.ndarray:
    """``values`` as ``width`` ASCII digits of ``base``, most significant
    first: ``[n, width]`` uint8."""
    out = np.empty((values.shape[0], width), np.uint8)
    v = values.astype(np.uint64)
    for i in range(width - 1, -1, -1):
        out[:, i] = _HEX[(v % np.uint64(base)).astype(np.int64)]
        v //= np.uint64(base)
    return out


def _zipf_ranks(rng, n: int, card: int, a: float) -> np.ndarray:
    """Ranks in [0, card) of the continuous ``1 / r^a`` law (a > 1)."""
    u = rng.uniform(size=n)
    r = (1.0 - u * (1.0 - (card + 1.0) ** (1.0 - a))) ** (-1.0 / (a - 1.0))
    return np.minimum(r.astype(np.int64) - 1, card - 1)


def _hit(r: np.ndarray, a: float, lines: float) -> np.ndarray:
    """The chance that rank ``r`` (from 1) of the unbounded law is drawn
    at least once in ``lines`` draws."""
    p = r ** (1.0 - a) * -np.expm1((1.0 - a) * np.log1p(1.0 / r))
    return -np.expm1(lines * np.log1p(-np.minimum(p, 1.0 - 1e-16)))


def expected_distinct(a: float, lines: float, head: int = 1 << 16
                      ) -> float:
    """Expected distinct ranks in ``lines`` draws of the unbounded
    ``1 / r^a`` law (a > 1): the first ``head`` ranks summed, the rest
    integrated on a logarithmic grid."""
    near = _hit(np.arange(1, head + 1, dtype=float), a, lines).sum()
    r = np.logspace(np.log10(head + 0.5), 22, 4000)
    y = _hit(r, a, lines)
    return float(near + 0.5 * ((y[1:] + y[:-1]) * np.diff(r)).sum())


def implied_exponent(distinct: int, lines: int) -> float:
    """The exponent ``a`` under which ``lines`` draws of the unbounded
    law give ``distinct`` distinct values (bisection)."""
    lo, hi = 1.0 + 1e-4, 40.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if expected_distinct(mid, lines) > distinct:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def make_lines(schema: dict, mix: dict, n: int, seed: int) -> Lines:
    """``n`` lines of ``schema`` drawn per ``mix`` from ``seed``."""
    rng = np.random.default_rng(seed)
    fields = schema["fields"]
    names = [f[0] for f in fields]
    label = schema["label"]
    tables = {}
    for term in label["terms"]:
        if term["kind"] == "table":
            size = fields[names.index(term["field"])][2]
            tables[term["field"]] = rng.normal(0.0, term["sd"], size)
    pieces = [None]  # the label's digit, filled in last
    keys, vals, value_of = [], [], {}
    for j, (name, kind, size) in enumerate(fields):
        prefix = np.frombuffer(f"{name}_".encode(), np.uint8)
        if kind == "bucket":
            bucket = rng.integers(0, size, n)
            tenths = rng.integers(5000, 15000, n)
            key = np.hstack([np.broadcast_to(prefix, (n, prefix.size)),
                             _digits(bucket, 2, 10)])
            val_text = np.hstack([
                _digits(tenths // 10000, 1, 10),
                np.full((n, 1), ord("."), np.uint8),
                _digits(tenths % 10000, 4, 10)])
            vals.append((tenths / 10000.0).astype(np.float32))
            value_of[name] = bucket
        elif kind == "categorical":
            if mix["categorical"] != "zipf":
                raise ValueError(
                    f"unknown categorical draw {mix['categorical']!r}")
            rank = _zipf_ranks(rng, n, size, schema["zipf_exponent"])
            value = (rank * _SPREAD + j * _FIELD_STEP) % (1 << 32)
            key = np.hstack([np.broadcast_to(prefix, (n, prefix.size)),
                             _digits(value, 8, 16)])
            val_text = np.full((n, 1), ord("1"), np.uint8)
            vals.append(np.ones(n, np.float32))
            value_of[name] = rank
        else:
            raise ValueError(f"unknown field kind {kind!r}")
        keys.append(np.ascontiguousarray(key))
        pieces += [np.full((n, 1), ord(" "), np.uint8), key,
                   np.full((n, 1), ord(":"), np.uint8), val_text]
    logit = np.full(n, float(label.get("bias", 0.0)))
    for term in label["terms"]:
        v = value_of[term["field"]]
        if term["kind"] == "table":
            logit += tables[term["field"]][v]
        elif term["kind"] == "cos":
            logit += term["w"] * np.cos(v + 1.0)
        else:
            raise ValueError(f"unknown label term {term['kind']!r}")
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logit))).astype(
        np.int8)
    pieces[0] = (labels[:, None] + ord("0")).astype(np.uint8)
    pieces.append(np.full((n, 1), ord("\n"), np.uint8))
    return Lines(np.hstack(pieces), keys, vals, labels)
