"""Run-wide telemetry core: counters, gauges, ring-buffer timings.

The trainer's stages (reader/parsers, the stacking/H2D transfer thread,
the dispatch loop) live on different threads — and, with
``parse_processes``, different processes — so the only way to attribute a
run's wall-clock is a shared, thread-safe registry every stage writes
into.  This module is that registry:

- :class:`Counter` — monotonic totals (batches parsed, examples
  delivered, cache replays, out-of-range batches);
- :class:`Gauge` — last-value instruments;
- :class:`Timing` — a lock-guarded ring of recent durations with
  monotonic count/total, reporting p50/p95/p99/max over the window (the
  fixed ring bounds memory for million-step runs; totals stay exact);
- :class:`DepthHist` — a per-event queue-depth histogram over
  power-of-two buckets.  Point-sampled depth gauges only see the queue
  at heartbeat instants; a bottleneck that flaps faster than the
  cadence (full↔empty between beats) is invisible to them.  Observing
  the depth at every put/get costs one integer bucket increment and
  makes the full occupancy distribution part of every snapshot.

Everything hangs off a :class:`Telemetry` instance.  A disabled instance
(``Telemetry(enabled=False)``, or the module-level :data:`NULL`) hands
out shared no-op instruments, so instrumented code calls them
unconditionally — no ``if telemetry:`` branches in hot paths, and
disabling telemetry is behaviorally invisible.

Enabled overhead per event is one ``perf_counter`` call plus one
uncontended lock acquire (~100 ns); events fire per *batch*, not per
example.

This is the PyTorch port's own copy of ``fast_tffm_tpu/obs/telemetry.py``
(stdlib only), minus the jax profiler annotation helper.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

__all__ = [
    "Counter", "Gauge", "Timing", "DepthHist", "Telemetry", "NULL",
]

_RING = 512  # recent-window size for percentile estimates


class Counter:
    """Thread-safe monotonic counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Thread-safe last-value instrument."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        return self._value


class _TimingScope:
    """Context manager recording its own wall time into a Timing."""

    __slots__ = ("_timing", "_t0")

    def __init__(self, timing: "Timing") -> None:
        self._timing = timing

    def __enter__(self) -> "_TimingScope":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._timing.observe(time.perf_counter() - self._t0)


class Timing:
    """Duration histogram: monotonic count/total + a ring of recent
    observations for p50/p95/max.

    The ring holds the last :data:`_RING` durations — percentiles
    describe *recent* behavior (what a heartbeat wants: "is the parse
    slowing down NOW"), while ``count``/``total_s`` stay exact over the
    whole run so rates and wall-clock attribution never drift.
    """

    __slots__ = ("_lock", "_ring", "_idx", "_count", "_total")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ring: list = [0.0] * _RING
        self._idx = 0
        self._count = 0
        self._total = 0.0

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._ring[self._idx % _RING] = seconds
            self._idx += 1
            self._count += 1
            self._total += seconds

    def time(self) -> _TimingScope:
        """``with timing.time(): ...`` records the block's wall time."""
        return _TimingScope(self)

    @property
    def count(self) -> int:
        return self._count

    @property
    def total_s(self) -> float:
        return self._total

    def snapshot(self) -> dict:
        with self._lock:
            n = min(self._count, _RING)
            window = sorted(self._ring[:n])
            count, total = self._count, self._total
        if not count:
            return {"count": 0, "total_s": 0.0}
        # p50/p95/p99/max all describe the recent window (a cold-start
        # outlier ages out of max_ms once the ring turns over);
        # count/total_s are run-exact.  p99 exists for the serving path
        # (tail latency is the SLO number) but every timer reports it.
        p50 = window[int(0.50 * (n - 1))] if n else 0.0
        p95 = window[int(0.95 * (n - 1))] if n else 0.0
        p99 = window[int(0.99 * (n - 1))] if n else 0.0
        return {
            "count": count,
            # How many samples the percentiles below actually describe
            # (the ring, not the run): a p99 over 3 samples and one
            # over 30k are different claims, and only this number
            # distinguishes them — rendered as the `_window_count`
            # companion of every percentile series on /metrics.
            "window_n": n,
            "total_s": round(total, 6),
            "mean_ms": round(1e3 * total / count, 4),
            "p50_ms": round(1e3 * p50, 4),
            "p95_ms": round(1e3 * p95, 4),
            "p99_ms": round(1e3 * p99, 4),
            "max_ms": round(1e3 * window[-1], 4) if n else 0.0,
        }


_DEPTH_BUCKETS = 16  # bucket i holds depths with bit_length() == i; last open


def _depth_bucket_label(i: int) -> str:
    if i == 0:
        return "0"
    lo, hi = 1 << (i - 1), (1 << i) - 1
    if i == _DEPTH_BUCKETS - 1:
        return f"{lo}+"
    return str(lo) if lo == hi else f"{lo}-{hi}"


class DepthHist:
    """Per-event queue-depth histogram (power-of-two buckets).

    ``observe(depth)`` is called at every queue put/get with the depth
    the event saw; the histogram accumulates how often the queue sat at
    each occupancy band.  Unlike a snapshot-time gauge this catches
    bottlenecks that flap between heartbeats: a queue pinned full 40%
    of events and empty 60% reports exactly that, where a point sample
    would report whichever extreme the beat landed on.
    """

    __slots__ = ("_lock", "_counts", "_max", "_total", "_n")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = [0] * _DEPTH_BUCKETS
        self._max = 0
        self._total = 0
        self._n = 0

    def observe(self, depth: int) -> None:
        d = int(depth)
        if d < 0:  # an mp.Queue qsize that raised degrades to -1
            return
        i = min(d.bit_length(), _DEPTH_BUCKETS - 1)
        with self._lock:
            self._counts[i] += 1
            self._n += 1
            self._total += d
            if d > self._max:
                self._max = d

    @property
    def count(self) -> int:
        return self._n

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            n, total, mx = self._n, self._total, self._max
        if not n:
            return {"count": 0}
        return {
            "count": n,
            "mean": round(total / n, 2),
            "max": mx,
            "buckets": {
                _depth_bucket_label(i): c
                for i, c in enumerate(counts) if c
            },
        }


class _NullCounter:
    __slots__ = ()

    def add(self, n: int = 1) -> None:
        pass

    value = 0


class _NullGauge:
    __slots__ = ()

    def set(self, v: float) -> None:
        pass

    value = 0.0


class _NullTiming:
    __slots__ = ()
    count = 0
    total_s = 0.0

    def observe(self, seconds: float) -> None:
        pass

    def time(self):
        return _NULL_CTX

    def snapshot(self) -> dict:
        return {"count": 0, "total_s": 0.0}


class _NullDepthHist:
    __slots__ = ()
    count = 0

    def observe(self, depth: int) -> None:
        pass

    def snapshot(self) -> dict:
        return {"count": 0}


_NULL_CTX = contextlib.nullcontext()
_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_TIMING = _NullTiming()
_NULL_DEPTH = _NullDepthHist()


class Telemetry:
    """Named-instrument registry shared across a run's stages.

    ``counter/gauge/timer`` create-or-return by dotted name (idempotent,
    thread-safe), so independent components — pipeline, prefetcher,
    trainer, bench — agree on instruments without passing them around.
    A disabled registry hands out shared no-op instruments and snapshots
    to ``{}``; callers never branch on ``enabled``.
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._timers: Dict[str, Timing] = {}
        self._depths: Dict[str, DepthHist] = {}

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER  # type: ignore[return-value]
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE  # type: ignore[return-value]
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def timer(self, name: str) -> Timing:
        if not self.enabled:
            return _NULL_TIMING  # type: ignore[return-value]
        with self._lock:
            return self._timers.setdefault(name, Timing())

    def depth_hist(self, name: str) -> DepthHist:
        if not self.enabled:
            return _NULL_DEPTH  # type: ignore[return-value]
        with self._lock:
            return self._depths.setdefault(name, DepthHist())

    def snapshot(self) -> dict:
        """One nested dict of everything: counters, gauges, timer and
        depth histograms.  Safe to call from any
        thread at any time, including after the run's stages shut down."""
        if not self.enabled:
            return {}
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            timers = dict(self._timers)
            depths = dict(self._depths)
        out: dict = {
            "counters": {k: c.value for k, c in counters.items()},
            "gauges": {k: g.value for k, g in gauges.items()},
            "timers": {k: t.snapshot() for k, t in timers.items()},
            "depths": {k: d.snapshot() for k, d in depths.items()},
        }
        return out


NULL = Telemetry(enabled=False)
