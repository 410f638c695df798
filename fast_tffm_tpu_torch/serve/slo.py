"""Serving SLO ledger: rolling error-budget burn rate.

An SLO is a promise ("99.9% of requests answered, under 50 ms"); the
number an operator pages on is not the raw error rate but how fast the
ERROR BUDGET (1 - availability) is being spent — the burn rate.  Burn
rate 1 means the service is exactly on budget; 10 means the monthly
budget burns in ~3 days; the classic multi-window alert thresholds
(14.4 / 6 / 1) all key off this one number.

:class:`SloTracker` is the ledger both serving processes share:

- the ROUTER observes every front-door outcome (admitted request
  latency + status, sheds, no-healthy-replica 503s) — the fleet-level
  SLO;
- a single-process server's batcher observes its own per-request
  latency/errors — the same accounting without a router.

``observe(ok, latency_s)`` appends one outcome to a sliding time
window; a request is GOOD iff it was admitted, answered below 500, and
(when ``serve_slo_p99_ms`` > 0) completed within the latency
objective.  ``snapshot()`` returns the window's ``good`` / ``bad`` /
``bad_frac`` and — when ``serve_slo_availability`` > 0 — ``burn_rate``
= bad_frac / (1 - availability), and refreshes the ``serve.burn_rate``
/ ``serve.slo_bad_frac`` gauges so /metrics scrapes see the live
values.

Stdlib-only (no torch, no numpy): the router process imports it.

The PyTorch port's copy of ``fast_tffm_tpu/serve/slo.py``, the same
ledger and the same snapshot keys.
"""

from __future__ import annotations

import collections
import threading
import time

__all__ = ["SloTracker", "WINDOW_S"]

# Sliding-window length for the burn-rate computation.  Short enough
# that a regression shows within a minute of beats, long enough that a
# single slow request on a trickle-load service doesn't read as a
# budget fire.
WINDOW_S = 60.0


class SloTracker:
    """Sliding-window good/bad request ledger -> burn-rate gauges."""

    def __init__(self, slo_p99_ms: float, slo_availability: float,
                 telemetry=None, window_s: float = WINDOW_S):
        self.slo_p99_ms = float(slo_p99_ms)
        self.slo_availability = float(slo_availability)
        self.enabled = self.slo_p99_ms > 0 or self.slo_availability > 0
        self._window_s = float(window_s)
        self._lock = threading.Lock()
        # (timestamp, bad) outcome ledger, pruned at both ends of use.
        self._ledger: collections.deque = collections.deque()
        self._g_burn = self._g_bad_frac = None
        if telemetry is not None and self.enabled:
            if self.slo_availability > 0:
                self._g_burn = telemetry.gauge("serve.burn_rate")
            self._g_bad_frac = telemetry.gauge("serve.slo_bad_frac")

    def observe(self, ok: bool, latency_s=None,
                now: float = None) -> None:
        """One request outcome.  ``ok`` is the transport-level verdict
        (admitted and answered < 500); a latency above the objective
        demotes an otherwise-ok request to bad."""
        if not self.enabled:
            return
        bad = not ok
        if (
            not bad and self.slo_p99_ms > 0 and latency_s is not None
            and latency_s * 1e3 > self.slo_p99_ms
        ):
            bad = True
        t = time.monotonic() if now is None else now
        with self._lock:
            self._ledger.append((t, bad))
            self._prune(t)

    def _prune(self, now: float) -> None:
        horizon = now - self._window_s
        led = self._ledger
        while led and led[0][0] < horizon:
            led.popleft()

    def snapshot(self, now: float = None) -> dict:
        """Window stats (empty dict when no SLO knob is set).  Also
        refreshes the registered gauges, so building a record keeps
        /metrics' gauge spellings in step with the block keys."""
        if not self.enabled:
            return {}
        t = time.monotonic() if now is None else now
        with self._lock:
            self._prune(t)
            total = len(self._ledger)
            bad = sum(1 for _, b in self._ledger if b)
        bad_frac = bad / total if total else 0.0
        out = {
            "slo_window_s": self._window_s,
            "slo_good": total - bad,
            "slo_bad": bad,
            "slo_bad_frac": round(bad_frac, 6),
        }
        if self.slo_p99_ms > 0:
            out["slo_p99_ms"] = self.slo_p99_ms
        if self.slo_availability > 0:
            budget = 1.0 - self.slo_availability
            burn = bad_frac / budget if budget > 0 else 0.0
            out["slo_availability"] = self.slo_availability
            out["burn_rate"] = round(burn, 4)
            if self._g_burn is not None:
                self._g_burn.set(round(burn, 4))
        if self._g_bad_frac is not None:
            self._g_bad_frac.set(round(bad_frac, 6))
        return out
