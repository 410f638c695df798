"""Model-quality & data-drift observability: the plane that watches the
MODEL, where everything else in obs/ watches the SYSTEM.

The PyTorch port's copy of ``fast_tffm_tpu/obs/quality.py`` (the same
blocks and keys; numpy only, no torch).  The trainer feeds
:class:`QualityMonitor` from a pinned host slot of each dispatch's
scores, read one dispatch late (``train/loop.py``).

Three instruments built on the mergeable sketches of obs/sketch.py:

- :class:`StreamSketch` — the ingest-path accumulator.  Parse workers
  (thread and process) fold every parsed batch's feature values /
  example lengths / id occupancy into it; process workers ship
  serialized deltas back on their result messages (the same channel as
  parse timings) and the parent absorbs them here.  It keeps THREE
  views: a run-cumulative ``total`` (published into
  ``serve_manifest.json`` as the training→serving skew reference), and
  a rotating ``window``/``prev`` pair — PSI between the two adjacent
  windows is the run's own drift signal (``quality.psi_*``), a rolling
  baseline that needs no configuration and self-heals after a
  legitimate regime change (the new regime becomes the next baseline).

- :class:`QualityMonitor` — windowed online eval over the training
  stream's own scores+labels, consumed one-dispatch-delayed from the
  same async D2H discipline as ``HealthState`` (the dispatch loop hands
  it host arrays; it never touches a device).  A fixed ring of the most
  recent examples yields EXACT windowed logloss / AUC / calibration
  ratio (mean predicted vs. observed label rate — the canonical CTR
  health number), plus ``logloss_drift`` against a rolling baseline of
  previous windows (same shape as the alert plane's
  ``grad_norm_drift``).  ``block()`` builds the ``quality`` record
  block heartbeats / ``/status`` / the final record carry, memoized for
  a short interval so an aggressive scrape cadence cannot turn the
  window statistics into measurable overhead.

- :class:`ServeSkewMonitor` — the replica-side training→serving skew
  detector.  It holds the trainer-published reference sketches (from
  the manifest; refreshed on every hot swap) and a rotating live-window
  sketch of the actual request traffic + served scores, and reports
  PSI per axis plus quantile deltas as the ``skew_*`` keys of the serve
  block (``tffm_serve_skew_*`` on ``/metrics``; the router's fleet
  scrape max-merges them so one scrape sees the fleet's worst skew).

Suggested reading of the PSI numbers (the industry-standard bands):
< 0.1 stable, 0.1–0.25 drifting (warn), > 0.25 shifted (page).

numpy-only, torch-free, like sketch.py — every consumer is a host-side
thread (parse workers, the heartbeat builder, the serve dispatcher).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from fast_tffm_tpu_torch.obs.sketch import SketchSet

__all__ = ["QualityMonitor", "ServeSkewMonitor", "StreamSketch"]

# Rolling-baseline shape for logloss_drift: mirror the alert plane's
# grad_norm_drift (obs/alerts.py BASELINE_WINDOW/BASELINE_MIN).
_BASELINE_WINDOW = 16
_BASELINE_MIN = 3
# Below this much mass a PSI between two windows is noise, not signal.
# FmConfig refuses quality_window below this value (pinned equal by
# tests/test_quality.py) so the drift signals can't be silently
# disabled by a too-small window.
_MIN_PSI_EXAMPLES = 32
# block() memo: /status can be scraped every 200 ms (the bench does);
# the window statistics only need to refresh at human cadence.
_BLOCK_MEMO_S = 0.5


class StreamSketch:
    """Thread-safe windowed + cumulative SketchSet accumulator."""

    def __init__(self, window_examples: int = 65536):
        if window_examples < 1:
            raise ValueError(
                f"window_examples must be >= 1, got {window_examples}"
            )
        self.window_examples = int(window_examples)
        self._lock = threading.Lock()
        self.total = SketchSet()
        self.window = SketchSet()
        # The two most recent COMPLETED windows: psi() prefers the
        # live window vs prev, but right after a rotation the live
        # window is near-empty — prev vs prev2 keeps the drift signal
        # defined at every instant instead of flapping to absent.
        self.prev: Optional[SketchSet] = None
        self.prev2: Optional[SketchSet] = None
        self.rotations = 0

    def _maybe_rotate_locked(self) -> None:
        if self.window.examples >= self.window_examples:
            self.prev2 = self.prev
            self.prev = self.window
            self.window = SketchSet()
            self.rotations += 1

    def update_batch(self, ids, vals, weights=None) -> None:
        """One parsed batch's features (thread-worker path)."""
        with self._lock:
            self.total.update_batch(ids, vals, weights)
            self.window.update_batch(ids, vals, weights)
            self._maybe_rotate_locked()

    def update_scores(self, scores) -> None:
        with self._lock:
            self.total.update_scores(scores)
            self.window.update_scores(scores)

    def absorb(self, delta: dict) -> None:
        """Merge a serialized SketchSet DELTA a process worker shipped
        (workers reset their local sketch at each ship, so absorbing
        every delta exactly once reconstructs the stream).  One
        deserialization feeds both views — merge() never mutates its
        argument."""
        sk = SketchSet.from_dict(delta)
        with self._lock:
            self.total.merge(sk)
            self.window.merge(sk)
            self._maybe_rotate_locked()

    def psi(self) -> dict:
        """Adjacent-window drift: the current window vs the previous
        one, falling back to the two previous COMPLETED windows while
        the current one is still filling ({} until two windows with
        enough mass exist)."""
        with self._lock:
            if self.prev is None or \
                    self.prev.examples < _MIN_PSI_EXAMPLES:
                return {}
            if self.window.examples >= _MIN_PSI_EXAMPLES:
                return self.window.psi_vs(self.prev)
            if self.prev2 is not None and \
                    self.prev2.examples >= _MIN_PSI_EXAMPLES:
                return self.prev.psi_vs(self.prev2)
            return {}

    def export(self) -> Optional[dict]:
        """Serialized cumulative sketches (the manifest payload), or
        None when nothing has been observed yet."""
        with self._lock:
            if self.total.examples == 0 and self.total.scores.n == 0:
                return None
            return self.total.to_dict()

    @property
    def examples(self) -> int:
        return self.total.examples


def window_logloss(scores, labels, weights) -> float:
    """Exact weighted logloss over probability scores."""
    p = np.clip(scores, 1e-7, 1 - 1e-7)
    ll = -(labels * np.log(p) + (1 - labels) * np.log(1 - p))
    return float(np.sum(ll * weights) / max(np.sum(weights), 1e-12))


def window_mse(scores, labels, weights) -> float:
    d = scores - labels
    return float(np.sum(d * d * weights) / max(np.sum(weights), 1e-12))


def window_auc(scores, labels, weights) -> Optional[float]:
    """Exact weighted ROC AUC via average ranks (ties handled); None
    when the window is single-class."""
    pos = weights * (labels > 0)
    neg = weights * (labels <= 0)
    wp, wn = float(pos.sum()), float(neg.sum())
    if wp <= 0 or wn <= 0:
        return None
    order = np.argsort(scores, kind="stable")
    s = scores[order]
    w = weights[order]
    # Weighted midranks: an element's rank is the total weight strictly
    # below its tie group plus half the group's weight.  Then the
    # Mann-Whitney identity AUC = (Σ_pos w·midrank − wp²/2) / (wp·wn)
    # is EXACT with ties — the parity target for the windowed test.
    cw = np.cumsum(w)
    below = cw - w
    is_new = np.empty(len(s), bool)
    is_new[0] = True
    is_new[1:] = s[1:] != s[:-1]
    group = np.cumsum(is_new) - 1
    n_groups = int(group[-1]) + 1
    # Sorted order makes each group's first element carry its minimal
    # "weight below" — that IS the group's strictly-below weight.
    g_start = np.full(n_groups, np.inf)
    np.minimum.at(g_start, group, below)
    g_w = np.zeros(n_groups)
    np.add.at(g_w, group, w)
    midrank = g_start[group] + g_w[group] / 2.0
    pos_rank_sum = float(np.sum(midrank * pos[order]))
    return float((pos_rank_sum - wp * wp / 2.0) / (wp * wn))


class QualityMonitor:
    """Windowed online eval + the ``quality`` record block."""

    def __init__(self, loss_type: str = "logistic",
                 window: int = 65536,
                 sketch: Optional[StreamSketch] = None):
        self.loss_type = loss_type
        self.window = int(max(1, window))
        self.sketch = sketch
        self._lock = threading.Lock()
        self._scores = np.zeros(self.window, np.float64)
        self._labels = np.zeros(self.window, np.float64)
        self._weights = np.zeros(self.window, np.float64)
        self._idx = 0
        self._seen = 0  # examples observed (cumulative)
        self._hist: deque = deque(maxlen=_BASELINE_WINDOW)
        self._hist_marked = 0  # examples count at last baseline append
        self._memo: Optional[dict] = None
        self._memo_t = 0.0

    # -- dispatch-loop side --------------------------------------------

    def observe(self, scores, labels, weights) -> None:
        """One consumed dispatch's host arrays (any shape; flattened).
        ``scores`` are raw model outputs — logistic models are squashed
        to probabilities here so the window, the score sketch, and the
        serving path all live in the same space."""
        s = np.asarray(scores, np.float64).reshape(-1)
        y = np.asarray(labels, np.float64).reshape(-1)
        w = np.asarray(weights, np.float64).reshape(-1)
        real = w > 0
        if not real.any():
            return
        s, y, w = s[real], y[real], w[real]
        if self.loss_type == "logistic":
            s = 1.0 / (1.0 + np.exp(-s))
        if self.sketch is not None:
            self.sketch.update_scores(s)
        with self._lock:
            n = len(s)
            if n >= self.window:
                self._scores[:] = s[-self.window:]
                self._labels[:] = y[-self.window:]
                self._weights[:] = w[-self.window:]
                self._idx = 0
            else:
                i = self._idx
                end = min(i + n, self.window)
                first = end - i
                self._scores[i:end] = s[:first]
                self._labels[i:end] = y[:first]
                self._weights[i:end] = w[:first]
                if first < n:
                    rest = n - first
                    self._scores[:rest] = s[first:]
                    self._labels[:rest] = y[first:]
                    self._weights[:rest] = w[first:]
                self._idx = (i + n) % self.window
            self._seen += n
            # The block memo is deliberately NOT invalidated here: it
            # is purely TTL'd (_BLOCK_MEMO_S).  A hot training loop
            # observes every dispatch, and recomputing the window
            # statistics per dispatch — instead of per heartbeat-ish
            # interval — was a measured 2x e2e overhead at small
            # batches.  A block is at most the TTL stale.

    # -- record-builder side -------------------------------------------

    def _window_arrays(self):
        n = min(self._seen, self.window)
        return (self._scores[:n], self._labels[:n], self._weights[:n])

    def block(self, now: Optional[float] = None,
              force: bool = False) -> dict:
        """The ``quality`` record block (flat, numeric, host-only).
        Memoized for ``_BLOCK_MEMO_S`` so a hot dispatch loop + scrape
        storms don't pay the window sort repeatedly.  ``force=True``
        (the FINAL record) bypasses the memo: end-of-run values must
        be exact, not up-to-TTL stale — a sub-second run's final block
        once reported its first heartbeat's counts."""
        now = time.time() if now is None else now
        with self._lock:
            if not force and self._memo is not None and \
                    now - self._memo_t < _BLOCK_MEMO_S:
                return dict(self._memo)
            out: dict = {"examples": int(self._seen)}
            s, y, w = self._window_arrays()
            if len(s):
                out["window_examples"] = int(len(s))
                loss = (window_mse(s, y, w)
                        if self.loss_type == "mse"
                        else window_logloss(s, y, w))
                out["logloss"] = round(loss, 6)
                auc = window_auc(s, y, w)
                if auc is not None:
                    out["auc"] = round(auc, 6)
                wsum = max(float(w.sum()), 1e-12)
                label_rate = float(np.sum(y * w) / wsum)
                mean_pred = float(np.sum(s * w) / wsum)
                out["score_mean"] = round(mean_pred, 6)
                out["label_rate"] = round(label_rate, 6)
                if label_rate > 0:
                    # mean predicted / observed rate: 1.0 = calibrated,
                    # the two-sided signal ("both" in report --compare).
                    out["calib_ratio"] = round(
                        mean_pred / label_rate, 6
                    )
                # Rolling logloss baseline: one sample per FRESH window
                # of examples (not per block() call — scrape cadence
                # must not dilute the baseline).
                if self._seen - self._hist_marked >= self.window:
                    self._hist.append(loss)
                    self._hist_marked = self._seen
                if len(self._hist) >= _BASELINE_MIN:
                    base = sum(self._hist) / len(self._hist)
                    if base > 0:
                        out["logloss_drift"] = round(loss / base, 6)
            if self.sketch is not None:
                out.update(self.sketch.psi())
                out["sketch_examples"] = int(self.sketch.examples)
            self._memo = dict(out)
            self._memo_t = now
            return out


class ServeSkewMonitor:
    """Training→serving skew: live request traffic vs the trainer's
    manifest-published reference sketches."""

    def __init__(self, window_examples: int = 65536, telemetry=None,
                 read_reference=None):
        """``read_reference`` is a zero-arg callable returning the
        manifest's ``quality`` payload dict (or None) — kept as a
        callable so this module stays import-light (no train/ import;
        the server passes a lambda over train.manifest.read_manifest).
        """
        self.window_examples = int(max(1, window_examples))
        self._read_reference = read_reference
        self._lock = threading.Lock()
        self._ref: Optional[SketchSet] = None
        self._ref_step = -1
        self._ref_stash = (None, -1)  # pre-reload reference (rollback)
        self.live = SketchSet()
        self._prev: Optional[SketchSet] = None
        self._memo: Optional[dict] = None
        self._memo_t = 0.0
        # Registered gauges (check_obs-pinned): the fleet-scrape /
        # alert-friendly summary series next to the full skew_* block.
        tel = telemetry
        self._g_psi_max = (
            tel.gauge("serve.skew_psi_max") if tel is not None else None
        )
        self._g_examples = (
            tel.gauge("serve.skew_examples") if tel is not None else None
        )

    # -- reference lifecycle -------------------------------------------

    def reload_reference(self) -> bool:
        """(Re)read the manifest's quality payload — called at startup
        and after every hot swap, so the reference always matches the
        checkpoint being served.  Returns True when a reference is
        loaded.

        A readable manifest WITHOUT a quality payload (a --no_quality
        retrain, an in-place checkpoint conversion) CLEARS the current
        reference: the served model changed and the old sketches no
        longer describe it — judging new traffic (and the new model's
        scores) against them would manufacture phantom skew.  Absence
        means no reference, never a stale one (the SERVING.md
        contract).  Only a TORN read (exception mid-swap) keeps the
        current reference and retries later."""
        if self._read_reference is None:
            return False
        try:
            doc = self._read_reference()
        except Exception:  # noqa: BLE001 - a torn manifest read
            return False
        ref, step = None, -1
        if isinstance(doc, dict) and "sketches" in doc:
            try:
                ref = SketchSet.from_dict(doc["sketches"])
                step = int(doc.get("step", -1))
            except Exception:  # noqa: BLE001 - foreign/corrupt payload
                ref, step = None, -1
        with self._lock:
            # Stash the outgoing reference so a canary /rollback can
            # restore it (the pre-canary manifest is gone from disk).
            self._ref_stash = (self._ref, self._ref_step)
            self._ref = ref
            self._ref_step = step
            self._memo = None
        return ref is not None

    def restore_previous_reference(self) -> None:
        """Undo the last :meth:`reload_reference` — the canary
        /rollback path: the served params just reverted to the
        pre-canary checkpoint, whose manifest no longer exists on
        disk, so the reference reverts from the stash instead (or to
        no-reference when there is none — honest absence either
        way)."""
        with self._lock:
            self._ref, self._ref_step = getattr(
                self, "_ref_stash", (None, -1)
            )
            self._memo = None

    def set_reference(self, sketches: SketchSet, step: int = -1) -> None:
        """Direct injection (tests, embedders)."""
        with self._lock:
            self._ref = sketches
            self._ref_step = int(step)
            self._memo = None

    # -- request path (serve dispatcher thread) ------------------------

    def observe_batch(self, ids, vals) -> None:
        with self._lock:
            self.live.update_batch(ids, vals)
            if self.live.examples >= self.window_examples:
                self._prev = self.live
                self.live = SketchSet()
                # A completed window is one of the two events worth
                # breaking the TTL memo for: a whole new traffic wave
                # just became judgeable (per-request invalidation
                # would re-pay the PSI on every dispatch — the
                # measured-2x hazard the TTL exists to prevent).
                self._memo = None
            elif (
                self._memo is not None
                and "skew_psi_max" not in self._memo
                and self.live.examples >= _MIN_PSI_EXAMPLES
            ):
                # ...the other: the live window just crossed the
                # minimum judgeable mass while the memo still says
                # "nothing to compare" — the first real psi must not
                # hide behind a pre-threshold snapshot.
                self._memo = None

    def observe_scores(self, scores) -> None:
        with self._lock:
            self.live.update_scores(np.asarray(scores, np.float64))

    # -- record-builder side -------------------------------------------

    def _recent_locked(self) -> SketchSet:
        """The live window judged against the reference: the current
        window plus (when present) the previous one, so a freshly
        rotated window never momentarily blinds the detector."""
        recent = self.live.copy()
        if self._prev is not None:
            recent.merge(self._prev.copy())
        return recent

    def block(self, now: Optional[float] = None,
              force: bool = False) -> dict:
        """``skew_*`` keys for the serve record block.  Without a
        reference (pre-quality manifest) only ``skew_ref_step = -1``
        is reported — absence of the psi keys IS the signal that no
        comparison is possible, never a lying 0.  ``force=True`` (the
        final record) bypasses the TTL memo — same exactness contract
        as QualityMonitor.block."""
        now = time.time() if now is None else now
        with self._lock:
            if not force and self._memo is not None and \
                    now - self._memo_t < _BLOCK_MEMO_S:
                return dict(self._memo)
            out: dict = {"skew_ref_step": self._ref_step}
            recent = self._recent_locked()
            out["skew_examples"] = int(recent.examples)
            if self._ref is not None and (
                recent.examples >= _MIN_PSI_EXAMPLES
                or recent.scores.n >= _MIN_PSI_EXAMPLES
            ):
                psi = recent.psi_vs(self._ref)
                out.update({f"skew_{k}": v for k, v in psi.items()})
                for axis, keys in (
                    ("scores", ("p50", "p99")),
                    ("values", ("p50",)),
                    ("lengths", ("p50",)),
                ):
                    ref_q = getattr(self._ref, axis)
                    live_q = getattr(recent, axis)
                    if ref_q.n == 0 or live_q.n == 0:
                        continue
                    for key in keys:
                        q = int(key[1:]) / 100.0
                        rv, lv = ref_q.quantile(q), live_q.quantile(q)
                        if rv is not None and lv is not None:
                            out[f"skew_{axis}_{key}_delta"] = round(
                                lv - rv, 6
                            )
            if self._g_psi_max is not None:
                self._g_psi_max.set(out.get("skew_psi_max", 0.0))
                self._g_examples.set(out["skew_examples"])
            self._memo = dict(out)
            self._memo_t = now
            return out
