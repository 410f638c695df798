"""Mergeable streaming distribution sketches: the fixed-memory summaries
the model-quality plane is built on (obs/quality.py).

The PyTorch port's copy of ``fast_tffm_tpu/obs/sketch.py``: the
same sketches, bit for bit (no RNG, so both packages' ``to_dict()``
agree exactly on one stream), and the same serialized form, so either
package's manifest reference reads in the other.

Two primitives, chosen for the three properties every consumer here
needs — FIXED memory however long the stream runs, MERGEABILITY
(per-worker / per-process partial sketches combine into one stream
summary; the training run's sketch ships to the serving fleet inside
``serve_manifest.json``), and cheap JSON serialization:

- :class:`QuantileSketch` — a KLL-style compactor hierarchy over float
  streams (feature values, example lengths, predicted scores).  Level
  ``i`` holds at most ``k`` items, each standing for ``2^i`` stream
  elements; a full level sorts and keeps every other item (alternating
  offset, deterministic — no RNG, so identical streams produce
  identical sketches and resume/replay stays reproducible).  Memory is
  O(k · log(n/k)); the rank error of any quantile estimate is a few
  percent at the default ``k`` (pinned empirically by
  tests/test_quality.py, not just claimed).
- :class:`FreqSketch` — a hashed occupancy histogram over id streams
  (which rows of the embedding table traffic touches).  Ids mix
  through a multiplicative hash into ``buckets`` counters; merge is
  exact (vector add).  It answers "did the ID DISTRIBUTION move", not
  "what is id 17's count" — exactly the drift question.  Sensitivity
  caveat, stated honestly: it sees changes in the occupancy SHAPE
  (mass concentrating on fewer/different-density rows — the common
  CTR drift), and it resolves disjoint-set swaps only while distinct
  ids per bucket stay small; two equal-density uniform id sets wider
  than ~buckets·lots converge to the hash's own profile and read as
  similar.  Such a swap still fires the trainer's `ids` axis at
  ingest (the window's distinct-id density shifts) but a skew
  comparison of two huge matched-density uniform sets is genuinely
  out of this sketch's reach.

Distribution distance is PSI (population stability index), the CTR-ops
standard: ``psi = Σ (q_i − p_i) · ln(q_i / p_i)`` over binned masses,
with the conventional reading psi < 0.1 stable, 0.1–0.25 drifting,
> 0.25 shifted.  Quantile distributions bin at the REFERENCE sketch's
equal-mass cut points (so the reference contributes ~uniform mass per
bin and the live distribution's movement is what the number measures);
frequency distributions compare bucket masses directly.

numpy-only (no torch): updates run inside parse workers — thread AND
spawned process — the serving batcher's dispatcher thread, and the
torch-free router would be free to import it.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

__all__ = [
    "FreqSketch", "QuantileSketch", "SketchSet", "psi_freq",
    "psi_quantile", "DEFAULT_K", "DEFAULT_BUCKETS", "PSI_BINS",
]

DEFAULT_K = 128  # per-level capacity: ~2-3% rank error, ~KBs of state
DEFAULT_BUCKETS = 512  # FreqSketch occupancy histogram width
PSI_BINS = 10  # equal-mass bins for quantile-sketch PSI
_PSI_EPS = 1e-4  # mass smoothing so an empty bin never yields inf


def _round6(x: float) -> float:
    """Compact JSON spelling (~6 significant digits) — the manifest
    carries thousands of these and full float64 repr would triple it."""
    return float(f"{x:.6g}")


class QuantileSketch:
    """KLL-style mergeable quantile sketch over a float stream."""

    def __init__(self, k: int = DEFAULT_K):
        if k < 8:
            raise ValueError(f"k must be >= 8, got {k}")
        self.k = int(k)
        self.n = 0  # total stream elements represented
        self._levels: List[list] = [[]]  # level i item weight = 2^i
        self._flip: List[bool] = [False]  # alternating compaction offset
        self._min = math.inf
        self._max = -math.inf
        # Memoized (sorted values, cumulative weights): a PSI computes
        # dozens of rank()/quantile() queries against the same state,
        # and re-sorting the retained items per query was the dominant
        # cost of a drift check.  Invalidated by update/merge.
        self._weighted_cache = None

    # -- updates -------------------------------------------------------

    # One update() folds at most this many items into the compactor;
    # larger arrays contribute a deterministic strided subsample (plus
    # exact n/min/max).  A 4096-sample draw of one batch already pins
    # its distribution far below the sketch's own rank error, and the
    # cap keeps the per-batch cost flat however large batches get —
    # the quality plane's overhead budget is 5%, not a function of
    # batch_size * max_features.  Caveat for foreign callers: a capped
    # update contributes mass proportional to its INSERTED count, so
    # mixing very large and very small updates skews their relative
    # weight — the pipelines here feed homogeneous batch shapes, where
    # the effect is nil (one short tail batch per epoch).
    UPDATE_CAP = 4096

    def update(self, values) -> None:
        """Fold an array (or scalar) of values into the sketch."""
        arr = np.asarray(values, np.float64).reshape(-1)
        if arr.size == 0:
            return
        arr = arr[np.isfinite(arr)]
        if arr.size == 0:
            return
        self.n += int(arr.size)
        self._weighted_cache = None
        self._min = min(self._min, float(arr.min()))
        self._max = max(self._max, float(arr.max()))
        if arr.size > self.UPDATE_CAP:
            # Deterministic stride with a rotating offset (the level-0
            # flip bit doubles as the rotation) so periodic batch
            # layouts can't alias into the subsample.
            stride = -(-arr.size // self.UPDATE_CAP)
            off = (self.n + stride - 1) % stride
            arr = arr[off::stride]
        lvl0 = self._levels[0]
        lvl0.extend(arr.tolist())
        if len(lvl0) >= 2 * self.k:
            self._compact_from(0)

    def _compact_from(self, i: int) -> None:
        while i < len(self._levels) and len(self._levels[i]) >= 2 * self.k:
            items = sorted(self._levels[i])
            off = 1 if self._flip[i] else 0
            self._flip[i] = not self._flip[i]
            # An odd survivor stays at this level so no weight is lost
            # beyond the compaction's inherent halving.
            keep = items[off::2]
            self._levels[i] = []
            if i + 1 == len(self._levels):
                self._levels.append([])
                self._flip.append(False)
            self._levels[i + 1].extend(keep)
            i += 1

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (in place; returns self).  Sketches
        of different ``k`` merge at the smaller capacity's error."""
        if other.n == 0:
            return self
        self.n += other.n
        self._weighted_cache = None
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        while len(self._levels) < len(other._levels):
            self._levels.append([])
            self._flip.append(False)
        for i, items in enumerate(other._levels):
            self._levels[i].extend(items)
        self._compact_from(0)
        # A merge can overfill upper levels directly; sweep them all.
        for i in range(len(self._levels)):
            self._compact_from(i)
        return self

    # -- queries -------------------------------------------------------

    def _weighted(self):
        """(sorted values, cumulative weights) over all levels —
        memoized until the next update/merge."""
        if self._weighted_cache is not None:
            return self._weighted_cache
        vals: list = []
        wts: list = []
        for i, items in enumerate(self._levels):
            vals.extend(items)
            wts.extend([1 << i] * len(items))
        if not vals:
            self._weighted_cache = (None, None)
            return self._weighted_cache
        v = np.asarray(vals, np.float64)
        w = np.asarray(wts, np.float64)
        order = np.argsort(v, kind="stable")
        self._weighted_cache = (v[order], np.cumsum(w[order]))
        return self._weighted_cache

    def quantile(self, q: float) -> Optional[float]:
        """Estimated value at rank fraction ``q`` in [0, 1]."""
        if self.n == 0:
            return None
        if q <= 0:
            return self._min
        if q >= 1:
            return self._max
        v, cw = self._weighted()
        target = q * cw[-1]
        idx = int(np.searchsorted(cw, target, side="left"))
        return float(v[min(idx, len(v) - 1)])

    def rank(self, x: float) -> float:
        """Estimated fraction of the stream <= x (the CDF)."""
        if self.n == 0:
            return 0.0
        v, cw = self._weighted()
        idx = int(np.searchsorted(v, x, side="right"))
        if idx == 0:
            return 0.0
        return float(cw[idx - 1] / cw[-1])

    @property
    def retained(self) -> int:
        """Items held across all levels — the memory bound under test."""
        return sum(len(lvl) for lvl in self._levels)

    # -- serialization -------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "k": self.k,
            "n": self.n,
            "min": _round6(self._min) if self.n else None,
            "max": _round6(self._max) if self.n else None,
            "levels": [
                [_round6(x) for x in lvl] for lvl in self._levels
            ],
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "QuantileSketch":
        sk = cls(k=int(doc.get("k", DEFAULT_K)))
        sk.n = int(doc.get("n", 0))
        sk._levels = [list(map(float, lvl))
                      for lvl in doc.get("levels", [[]])] or [[]]
        sk._flip = [False] * len(sk._levels)
        if sk.n:
            sk._min = float(doc["min"])
            sk._max = float(doc["max"])
        return sk


class FreqSketch:
    """Hashed id-occupancy histogram: exact-merge frequency sketch."""

    # Fibonacci multiplicative hash: consecutive ids (the common CTR
    # vocab layout) spread across buckets instead of aliasing mod-B.
    _MIX = np.uint64(0x9E3779B97F4A7C15)

    def __init__(self, buckets: int = DEFAULT_BUCKETS):
        if buckets < 8:
            raise ValueError(f"buckets must be >= 8, got {buckets}")
        self.buckets = int(buckets)
        self.counts = np.zeros(self.buckets, np.int64)
        self.n = 0

    def update(self, ids) -> None:
        arr = np.asarray(ids).reshape(-1)
        if arr.size == 0:
            return
        with np.errstate(over="ignore"):
            h = (arr.astype(np.uint64) * self._MIX) >> np.uint64(17)
        # bincount, not add.at: one histogram pass instead of a
        # scattered-index loop (matters at batch_size * max_features
        # ids per parsed batch).
        self.counts += np.bincount(
            (h % np.uint64(self.buckets)).astype(np.int64),
            minlength=self.buckets,
        )
        self.n += int(arr.size)

    def merge(self, other: "FreqSketch") -> "FreqSketch":
        if other.buckets != self.buckets:
            raise ValueError(
                f"cannot merge FreqSketch buckets {other.buckets} into "
                f"{self.buckets}"
            )
        self.counts += other.counts
        self.n += other.n
        return self

    def to_dict(self) -> dict:
        return {"buckets": self.buckets, "n": self.n,
                "counts": self.counts.tolist()}

    @classmethod
    def from_dict(cls, doc: dict) -> "FreqSketch":
        sk = cls(buckets=int(doc.get("buckets", DEFAULT_BUCKETS)))
        counts = doc.get("counts")
        if counts:
            sk.counts = np.asarray(counts, np.int64)
        sk.n = int(doc.get("n", 0))
        return sk


def _debias(psi: float, dof: int, n_ref: int, n_live: int) -> float:
    """Remove the expected under-null sampling noise from a raw PSI.

    Two finite samples of the SAME distribution still produce a
    positive PSI — asymptotically ``dof · (1/n_ref + 1/n_live)`` (the
    chi-square mean of the symmetrized divergence).  Subtracting it
    (clamped at 0) makes identity read ~0 even over small windows,
    while a real shift's PSI (O(1)) is barely touched — so alert
    thresholds mean the same thing at every window size."""
    return max(0.0, psi - dof * (1.0 / max(n_ref, 1)
                                 + 1.0 / max(n_live, 1)))


def psi_freq(ref: FreqSketch, live: FreqSketch) -> Optional[float]:
    """Noise-debiased PSI between two frequency sketches' bucket-mass
    distributions."""
    if ref.n == 0 or live.n == 0 or ref.buckets != live.buckets:
        return None
    p = ref.counts / ref.n + _PSI_EPS
    q = live.counts / live.n + _PSI_EPS
    p /= p.sum()
    q /= q.sum()
    psi = float(np.sum((q - p) * np.log(q / p)))
    return _debias(psi, ref.buckets - 1, ref.n, live.n)


def psi_quantile(ref: QuantileSketch, live: QuantileSketch,
                 bins: int = PSI_BINS) -> Optional[float]:
    """PSI between two quantile sketches, binned at the REFERENCE's
    equal-mass cut points.  Degenerate references (a near-constant
    stream collapses the cut points) fall back to fewer bins; a fully
    constant reference compares point masses at its single value."""
    if ref.n == 0 or live.n == 0:
        return None
    edges = []
    for i in range(1, bins):
        e = ref.quantile(i / bins)
        if e is not None and (not edges or e > edges[-1]):
            edges.append(e)
    if not edges:
        # Constant reference: the only question is how much live mass
        # sits at (<=) that value vs beyond it.
        edges = [ref.quantile(0.5)]
    cuts = [-math.inf] + edges + [math.inf]
    p = np.asarray([
        max(0.0, ref.rank(b) - ref.rank(a)) if b != math.inf
        else max(0.0, 1.0 - ref.rank(a))
        for a, b in zip(cuts[:-1], cuts[1:])
    ])
    q = np.asarray([
        max(0.0, live.rank(b) - live.rank(a)) if b != math.inf
        else max(0.0, 1.0 - live.rank(a))
        for a, b in zip(cuts[:-1], cuts[1:])
    ])
    p = p + _PSI_EPS
    q = q + _PSI_EPS
    p /= p.sum()
    q /= q.sum()
    psi = float(np.sum((q - p) * np.log(q / p)))
    return _debias(psi, len(edges), ref.n, live.n)


class SketchSet:
    """The model-quality sketch bundle over one example stream.

    Four axes, each one drift question:

    - ``values``  — nonzero feature VALUES (quantile): did the numeric
      inputs move (a broken upstream scaler, a log/linear flip)?
    - ``lengths`` — real features per example (quantile): did example
      SHAPE move (a joiner dropping a feature family)?
    - ``ids``     — feature-id occupancy (frequency): did traffic move
      to different embedding rows (new campaign mix, vocab shift)?
    - ``scores``  — predicted scores (quantile; probabilities for
      logistic models): did the model's OUTPUT distribution move
      (updated separately — features come from the parse path, scores
      from the dispatch/serve path)?

    ``update_batch`` takes the padded ``[n, F]`` id/value arrays every
    layer here already holds (ingest Batch, serve request) — a zero
    value marks a padded slot, exactly the convention the parsers and
    the serving pad path share.
    """

    AXES = ("values", "lengths", "ids", "scores")

    def __init__(self, k: int = DEFAULT_K,
                 buckets: int = DEFAULT_BUCKETS):
        self.values = QuantileSketch(k)
        self.lengths = QuantileSketch(k)
        self.ids = FreqSketch(buckets)
        self.scores = QuantileSketch(k)
        self.examples = 0

    def update_batch(self, ids, vals, weights=None) -> None:
        ids = np.asarray(ids)
        vals = np.asarray(vals)
        if vals.ndim == 1:
            ids = ids.reshape(1, -1)
            vals = vals.reshape(1, -1)
        if weights is not None:
            rows = np.asarray(weights).reshape(-1) > 0
            ids, vals = ids[rows], vals[rows]
        if vals.shape[0] == 0:
            return
        real = vals != 0
        self.values.update(vals[real])
        self.lengths.update(real.sum(axis=1))
        self.ids.update(ids[real])
        self.examples += int(vals.shape[0])

    def update_scores(self, scores) -> None:
        self.scores.update(scores)

    def merge(self, other: "SketchSet") -> "SketchSet":
        self.values.merge(other.values)
        self.lengths.merge(other.lengths)
        self.ids.merge(other.ids)
        self.scores.merge(other.scores)
        self.examples += other.examples
        return self

    def copy(self) -> "SketchSet":
        return SketchSet.from_dict(self.to_dict())

    def psi_vs(self, ref: "SketchSet") -> dict:
        """{psi_values, psi_lengths, psi_ids, psi_scores, psi_max}
        of SELF (the live stream) against ``ref`` — axes without mass
        on both sides are simply absent."""
        out: dict = {}
        for axis, fn in (("values", psi_quantile),
                         ("lengths", psi_quantile),
                         ("ids", psi_freq),
                         ("scores", psi_quantile)):
            v = fn(getattr(ref, axis), getattr(self, axis))
            if v is not None:
                out[f"psi_{axis}"] = round(v, 6)
        psis = [v for k, v in out.items() if k.startswith("psi_")]
        if psis:
            out["psi_max"] = round(max(psis), 6)
        return out

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "examples": self.examples,
            "values": self.values.to_dict(),
            "lengths": self.lengths.to_dict(),
            "ids": self.ids.to_dict(),
            "scores": self.scores.to_dict(),
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "SketchSet":
        sk = cls.__new__(cls)
        sk.values = QuantileSketch.from_dict(doc.get("values", {}))
        sk.lengths = QuantileSketch.from_dict(doc.get("lengths", {}))
        sk.ids = FreqSketch.from_dict(doc.get("ids", {}))
        sk.scores = QuantileSketch.from_dict(doc.get("scores", {}))
        sk.examples = int(doc.get("examples", 0))
        return sk
