"""Alert-rule watchdog: heartbeat-derived signals -> warn/halt actions.

The heartbeat stream already carries everything an operator would page
on — starvation (``ingest_wait_frac``), numerical health (grad norms,
non-finite counts), hot-set churn (``tiered.hot_hit_frac``), trace
truncation — but until now a human had to watch it.  This module makes
the run watch itself: a small declarative rule set (the ``alert_rules``
INI key) is evaluated against every heartbeat record ON the heartbeat
thread, and breaches emit self-describing ``record: alert`` JSONL
entries (summarized by ``tools/report.py``, regression-gated by
``--compare``) and either warn or halt the run.

Rule grammar (rules split on ``;`` or newlines)::

    alert_rules = ingest_wait_frac > 0.5 for 3 : warn ;
                  grad_norm_drift > 10 : halt

    rule   := SIGNAL OP THRESHOLD ["for" N] ":" ACTION
    OP     := ">" | "<"
    N      := consecutive breaching heartbeats required (default 1)
    ACTION := "warn" | "halt"

Signals resolve against the heartbeat record by dotted path
(``health.grad_norm``, ``tiered.hot_hit_frac``,
``stages.gauges.ingest.oor_batches`` — segment matching is greedy, so
instrument names containing dots resolve too), with short aliases for
the common ones and a few DERIVED signals the records don't carry
directly:

- ``grad_norm_drift`` — current ``health.grad_norm`` divided by the
  rolling mean of the previous :data:`BASELINE_WINDOW` heartbeat
  values (needs :data:`BASELINE_MIN` history first).  Catches a
  diverging run long before the loss moves.
- ``beat_gap_s`` — seconds since the previous heartbeat evaluation; a
  gap far above ``heartbeat_secs`` means the heartbeat thread (or the
  whole process) is stalling.
- ``ingest_out_empty_frac`` / ``prefetch_out_empty_frac`` — fraction
  of queue put/get events that saw the respective output queue EMPTY
  (from the DepthHist occupancy buckets): sustained emptiness of the
  prefetch output queue is dispatch starvation even when wait
  fractions look small over the whole run.

A rule whose signal is absent from a record (telemetry off, tiering
off, pre-first-dispatch) simply does not evaluate that beat — and its
breach streak resets, so ``for N`` always means N *consecutive
evaluable* breaches.

Actions: ``warn`` logs and keeps counting; ``halt`` records the alert
and arms :attr:`AlertEngine.halted` — the DISPATCH loop (not the
heartbeat thread) raises :class:`AlertHaltError` at the next boundary,
so halting follows the same path as ``nan_policy=halt``: no checkpoint
overwrite, a crash-truthful final record naming the exception.  The
boundary check is also the mechanism's limit: a loop wedged INSIDE
``next()`` (a fully deadlocked ingest) never reaches the next
boundary, so a halt on a staleness/starvation signal is best-effort
there — the alert record and warning still land in the stream, but an
external supervisor must do the killing (same property as
``nan_policy=halt``, which checks at the same boundary).

Each breach episode fires ONCE (when the streak first reaches the
rule's ``for N``); the rule re-arms after a non-breaching evaluation,
so a flapping signal produces one alert per flap, not one per beat.

The PyTorch port's own copy of ``fast_tffm_tpu/obs/alerts.py``
(stdlib only, no torch, no numpy).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Callable, List, Optional

__all__ = [
    "AlertRule", "AlertEngine", "AlertHaltError", "halt_error",
    "parse_rules", "resolved_signal", "run_until_halt",
    "BASELINE_WINDOW", "BASELINE_MIN",
]

log = logging.getLogger(__name__)

# Rolling-baseline shape for grad_norm_drift: mean over up to
# BASELINE_WINDOW previous heartbeat grad norms, evaluable once
# BASELINE_MIN samples exist (a 2-beat-old baseline would make the
# drift ratio pure noise).
BASELINE_WINDOW = 16
BASELINE_MIN = 4

_ACTIONS = ("warn", "halt")

# Short spellings for the signals rules most commonly watch.
_ALIASES = {
    "grad_norm": "health.grad_norm",
    "grad_norm_rms": "health.grad_norm_rms",
    "nonfinite_steps": "health.nonfinite_steps",
    "hot_hit_frac": "tiered.hot_hit_frac",
    # Resource plane (the heartbeat's `resource` block): an unexpected
    # mid-run recompile or a climbing RSS are exactly the signals an
    # operator writes one-line rules for.
    "recompiles_unexpected": "resource.recompiles_unexpected",
    "peak_rss_mb": "resource.peak_rss_mb",
    "rss_mb": "resource.rss_mb",
    "compile_s": "resource.compile_s",
    "open_fds": "resource.open_fds",
    "uptime_s": "resource.uptime_s",
    # Serving plane (the `serve` block a serve/router heartbeat
    # carries): the SLO burn rate, the router's shed fraction and
    # eviction count, and fleet-scrape staleness — the one-line-rule
    # signals a serving operator pages on (OBSERVABILITY.md "Serving
    # SLO & burn rate").
    # Model-quality plane (the heartbeat's `quality` block,
    # obs/quality.py): the drift signals a modeling operator writes
    # one-line rules for — windowed-logloss drift vs its rolling
    # baseline, the calibration ratio, and the worst adjacent-window
    # PSI across the sketched axes.
    "logloss_drift": "quality.logloss_drift",
    "calib_ratio": "quality.calib_ratio",
    "psi_max": "quality.psi_max",
    "burn_rate": "serve.burn_rate",
    "slo_bad_frac": "serve.slo_bad_frac",
    "shed_frac": "serve.shed_frac",
    "evictions": "serve.evictions",
    "respawns": "serve.respawns",
    "fleet_scrape_age_max_s": "serve.fleet_scrape_age_max_s",
    # Training-fleet plane (the `fleet` block rank 0's records carry
    # when train_fleet_scrape is set — obs/fleet.py): live straggler
    # attribution, step desync, and the cross-rank collective's share
    # of the wall.
    "straggler_ratio": "fleet.straggler_ratio",
    "rank_step_skew": "fleet.rank_step_skew",
    "exchange_frac": "fleet.exchange_frac",
}

# Signals that exist on MORE than one plane under different spellings:
# the serve block says `fleet_scrape_age_max_s`, the train fleet block
# says `scrape_age_max_s` (its block already names the plane).  The
# primary alias keeps the historical serve path; when that resolves to
# nothing on a record, these alternates are tried in order — so one
# staleness rule works against either plane's records.
_FALLBACKS = {
    "fleet_scrape_age_max_s": ("fleet.scrape_age_max_s",),
}


def resolved_signal(signal: str) -> str:
    """The dotted heartbeat path a rule's signal resolves to (alias
    expansion only — derived and already-dotted signals pass through
    unchanged).  Lets config validation reason about WHERE a rule
    reads from, e.g. refusing resource-plane rules when the resource
    block is disabled."""
    return _ALIASES.get(signal, signal)


class AlertHaltError(RuntimeError):
    """Raised by the dispatch loop when an ``action: halt`` rule fired.
    Training stops without overwriting the checkpoint; the final
    metrics record carries this exception type (same crash-truthful
    contract as ``nan_policy=halt``)."""


def halt_error(alert: dict) -> AlertHaltError:
    """The one spelling of a halt alert's exception message — the
    training dispatch loop and both serving watch loops raise it, so
    the format can't drift between them."""
    return AlertHaltError(
        f"alert rule {alert['rule']} fired with action=halt"
        + (f" at step {alert['step']}"
           if alert.get("step") is not None else "")
        + f": {alert['signal']}={alert['value']} {alert['op']} "
          f"{alert['threshold']} (sustained {alert['sustain']} "
          "heartbeat(s))"
    )


def run_until_halt(engine: Optional["AlertEngine"],
                   poll_s: float = 1.0) -> None:
    """Block the calling (main) thread until an ``action: halt`` rule
    fires — then raise :class:`AlertHaltError` — or forever.  The
    serving entrypoints' watch loop: with no engine there is nothing
    to poll and the wait is the historical zero-wake block
    (interrupted only by KeyboardInterrupt / a signal handler)."""
    stop = threading.Event()
    while not stop.wait(poll_s if engine is not None else None):
        if engine is not None and engine.halted is not None:
            raise halt_error(engine.halted)


@dataclasses.dataclass(frozen=True)
class AlertRule:
    signal: str
    op: str  # ">" | "<"
    threshold: float
    sustain: int = 1
    action: str = "warn"

    @property
    def name(self) -> str:
        return f"{self.signal}{self.op}{self.threshold:g}"

    def breached(self, value: float) -> bool:
        return value > self.threshold if self.op == ">" \
            else value < self.threshold


def parse_rules(spec: str) -> List[AlertRule]:
    """Parse an ``alert_rules`` value; raises ValueError with the
    offending fragment on any grammar error (a silently dropped alert
    rule is the one config bug this module must never have)."""
    rules: List[AlertRule] = []
    for raw in spec.replace("\n", ";").split(";"):
        text = raw.strip()
        if not text:
            continue
        head, sep, action = text.rpartition(":")
        action = action.strip().lower()
        if not sep or action not in _ACTIONS:
            raise ValueError(
                f"alert rule {text!r}: must end with ': warn' or "
                "': halt'"
            )
        sustain = 1
        parts = head.split()
        if len(parts) >= 2 and parts[-2].lower() == "for":
            try:
                sustain = int(parts[-1])
            except ValueError:
                raise ValueError(
                    f"alert rule {text!r}: 'for' needs an integer "
                    "heartbeat count"
                ) from None
            if sustain < 1:
                raise ValueError(
                    f"alert rule {text!r}: 'for N' must be >= 1"
                )
            parts = parts[:-2]
        if len(parts) != 3 or parts[1] not in (">", "<"):
            raise ValueError(
                f"alert rule {text!r}: expected 'signal > threshold' "
                "or 'signal < threshold'"
            )
        signal, op, thr = parts
        try:
            threshold = float(thr)
        except ValueError:
            raise ValueError(
                f"alert rule {text!r}: threshold {thr!r} is not a "
                "number"
            ) from None
        rules.append(AlertRule(signal, op, threshold, sustain, action))
    return rules


def _resolve(rec, path: str) -> Optional[float]:
    """Greedy dotted-path lookup tolerating dots INSIDE keys (telemetry
    instrument names): try the whole remaining path as a key first,
    then every split point left to right."""
    if not isinstance(rec, dict):
        return None
    if path in rec:
        v = rec[path]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        return float(v)
    i = path.find(".")
    while i != -1:
        head, rest = path[:i], path[i + 1:]
        if head in rec:
            v = _resolve(rec[head], rest)
            if v is not None:
                return v
        i = path.find(".", i + 1)
    return None


def _empty_frac(rec: dict, depth_name: str) -> Optional[float]:
    snap = ((rec.get("stages") or {}).get("depths") or {}).get(depth_name)
    if not snap or not snap.get("count"):
        return None
    return (snap.get("buckets") or {}).get("0", 0) / snap["count"]


class AlertEngine:
    """Evaluate a rule set against successive heartbeat records.

    ``observe(record)`` is called by the heartbeat's record callable
    with each beat's record (and by tests with synthetic streams); it
    returns the alert records emitted for that beat, after writing them
    to ``writer`` (the run's JsonlWriter) and logging.  ``halted`` holds
    the first ``action: halt`` alert record once one fires — the
    dispatch loop polls it between dispatches.
    """

    def __init__(self, rules: List[AlertRule], writer=None,
                 clock: Callable[[], float] = time.time,
                 on_alert: Optional[Callable[[dict], None]] = None):
        self.rules = list(rules)
        self.halted: Optional[dict] = None
        self.fired_total = 0
        self._writer = writer
        self._clock = clock
        # Per-alert listener (the blackbox flight recorder): called on
        # the heartbeat thread with each emitted alert record, AFTER
        # the record is written/logged.  Exceptions are swallowed — a
        # broken forensics hook must never cost the beat.
        self._on_alert = on_alert
        # Breach state is keyed by rule POSITION, not rule.name: two
        # rules can share a name while differing in sustain/action
        # (e.g. "x > 1 : warn ; x > 1 for 3 : halt" as an escalation
        # pair), and name-keyed state would let the first swallow the
        # second's halt forever.
        self._streak = [0] * len(self.rules)
        self._active = [False] * len(self.rules)
        self._grad_hist: deque = deque(maxlen=BASELINE_WINDOW)
        self._last_beat_t: Optional[float] = None

    # ------------------------------------------------------------------

    def _signal(self, rec: dict, name: str,
                now: float) -> Optional[float]:
        if name == "grad_norm_drift":
            gn = _resolve(rec, "health.grad_norm")
            if gn is None or len(self._grad_hist) < BASELINE_MIN:
                return None
            base = sum(self._grad_hist) / len(self._grad_hist)
            if base <= 0:
                return None
            return gn / base
        if name == "beat_gap_s":
            if self._last_beat_t is None:
                return None
            return now - self._last_beat_t
        if name == "ingest_out_empty_frac":
            return _empty_frac(rec, "ingest.out_q_depth")
        if name == "prefetch_out_empty_frac":
            return _empty_frac(rec, "prefetch.out_q_depth")
        value = _resolve(rec, _ALIASES.get(name, name))
        if value is None:
            for alt in _FALLBACKS.get(name, ()):
                value = _resolve(rec, alt)
                if value is not None:
                    break
        return value

    def observe(self, record: dict) -> List[dict]:
        now = self._clock()
        emitted: List[dict] = []
        for i, rule in enumerate(self.rules):
            value = self._signal(record, rule.signal, now)
            if value is None:
                # Not evaluable this beat: streak resets so "for N"
                # always means N consecutive EVALUABLE breaches.
                self._streak[i] = 0
                self._active[i] = False
                continue
            if not rule.breached(value):
                self._streak[i] = 0
                self._active[i] = False
                continue
            self._streak[i] += 1
            if self._streak[i] < rule.sustain or self._active[i]:
                continue
            self._active[i] = True
            alert = {
                "record": "alert",
                "time": now,
                "step": record.get("step"),
                "rule": rule.name,
                "signal": rule.signal,
                "value": round(value, 6),
                "threshold": rule.threshold,
                "op": rule.op,
                "sustain": rule.sustain,
                "action": rule.action,
            }
            emitted.append(alert)
            self.fired_total += 1
            log.warning(
                "ALERT %s: %s=%.6g %s %g (sustained %d beat(s); "
                "action=%s)",
                rule.name, rule.signal, value, rule.op, rule.threshold,
                rule.sustain, rule.action,
            )
            if self._writer is not None:
                try:
                    self._writer.write(alert)
                except Exception as e:  # noqa: BLE001 - never kill a beat
                    log.warning("alert record write failed: %s", e)
            if rule.action == "halt" and self.halted is None:
                self.halted = alert
            if self._on_alert is not None:
                try:
                    self._on_alert(alert)
                except Exception as e:  # noqa: BLE001 - never kill a beat
                    log.warning("alert listener failed: %s", e)
        # Update derived-signal state AFTER evaluation so rules see the
        # baseline/gap that excludes the current beat.
        gn = _resolve(record, "health.grad_norm")
        if gn is not None:
            self._grad_hist.append(gn)
        self._last_beat_t = now
        return emitted

    def active_snapshot(self) -> dict:
        """Live alert state as an ``alerts`` block for heartbeat/status
        records: armed rule count, cumulative fires, the halt latch,
        and per-rule ``active``/``streak`` (rendered by
        ``render_prometheus`` as ``tffm_alert_active{rule="..."}`` so a
        Prometheus scrape can see a currently-firing alert, not just
        the JSONL stream)."""
        return {
            "armed": len(self.rules),
            "fired_total": self.fired_total,
            "halted": int(self.halted is not None),
            "rules": [
                {
                    "rule": rule.name,
                    "action": rule.action,
                    "active": int(self._active[i]),
                    "streak": self._streak[i],
                }
                for i, rule in enumerate(self.rules)
            ],
        }
