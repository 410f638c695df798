"""Structured per-batch event tracing in Chrome-trace (Perfetto) format.

The PyTorch port's copy of ``fast_tffm_tpu/obs/trace.py``: the same
event format, span names and file layout, so either package's
``tools/report.py --trace`` reads the other's traces.  The port's
``train.dispatch`` span is a host span: the CUDA work it enqueues runs
asynchronously, as XLA's does in the reference, so the span covers the
enqueue and any back-pressure block, not the kernels.

The telemetry layer (telemetry.py) answers "where did the run's
wall-clock go IN AGGREGATE" — p50/p95 timers, wait-vs-dispatch totals.
It cannot answer CAUSAL questions: which stage did THIS slow super-batch
stall in, was the prefetcher thread blocked on staging-buffer reuse, did
the parse workers sit idle while the reader rebuilt a window?  Those
need per-event spans ordered on a timeline.  This module is that layer:
a low-overhead structured tracer whose output loads directly into
Perfetto (https://ui.perfetto.dev) or chrome://tracing.

Design constraints, shared with telemetry.py:

- stdlib only (no torch, no numpy): spawned parse workers run a
  :class:`Tracer` of their own and ship their events back over the
  existing result messages, so this module must import clean in a
  process that never loads torch;
- one shared no-op instance per disabled tracer (:data:`NULL_TRACER`):
  instrumented code never branches — ``tracer.span(...)`` on a disabled
  tracer returns a cached null context manager, and ``emit`` returns
  immediately;
- enabled overhead is two ``perf_counter`` calls plus one lock-guarded
  list append per span; events fire per batch / window / dispatch, not
  per example.

Event model (Chrome trace "X" complete events plus flow events):

- every span carries ``pid``/``tid`` so each execution context — the
  reader thread, every parse worker (thread or spawned process), the
  transfer thread, the train loop — renders as its own lane;
- correlation ids ride ``args``: ``seq`` (reader work-item sequence
  number) joins ``read.item`` → ``ring.slot_acquire`` → ``parse.batch``;
  the pipeline's delivery point bridges ``seq`` → ``batch`` (delivered
  batch index), and the prefetcher groups batches into ``sb``
  (super-batch id) which the train loop's ``train.dispatch`` span
  closes — one super-batch's life is a connected chain from file read
  to fused-scan dispatch (tools/report.py --trace walks it);
- flow arrows (``ph: s/t/f`` with id ``sb<N>``) visually link each
  super-batch's stack → H2D → dispatch across lanes.

Timestamps are ``time.perf_counter`` microseconds (CLOCK_MONOTONIC on
Linux — one clock shared by every process on the host, so worker spans
merge without alignment).  Each dump records a wall-clock anchor so
``tools/report.py --trace`` can also merge traces from DIFFERENT hosts
(multi-rank fleets) onto one timeline.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import threading
import time
from typing import Optional

__all__ = ["Tracer", "NULL_TRACER", "SpanHandle"]

log = logging.getLogger(__name__)

# Backstop against unbounded growth on very long runs: ~1M events is
# ~250 MB of JSON — far beyond what Perfetto loads comfortably anyway.
# Past the cap new events are dropped and counted (reported in dump()).
# Runs that legitimately trace past it should ROTATE instead
# (``rotate_events``): the buffer dumps and resets at the watermark,
# producing trace.0.json, trace.1.json, ... that tools/report.py
# --trace stitches back into one stream — no cap, no drops.
_MAX_EVENTS = 1_000_000

_NULL_CTX = contextlib.nullcontext()


def _us(t: float) -> int:
    return int(t * 1e6)


class SpanHandle:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_flow", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args, flow):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._flow = flow

    def __enter__(self) -> "SpanHandle":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self._tracer.emit(
            self._name, self._t0, t1 - self._t0,
            args=self._args, flow=self._flow,
        )


class Tracer:
    """Thread-safe in-memory Chrome-trace event collector.

    ``span(name, args=..., flow=(phase, id))`` times a block;
    ``point(name, args=...)`` marks an instant (rendered as a 1 µs
    slice so report tooling treats every event uniformly);
    ``emit(...)`` records a span from explicit timestamps (used to
    re-emit worker-shipped spans under the worker's pid);
    ``take()`` drains the buffered raw events (what a parse worker
    ships back); ``add_raw`` ingests such a shipment;
    ``dump(path)`` writes the Perfetto-loadable JSON.
    """

    def __init__(self, enabled: bool = True,
                 process_name: Optional[str] = None,
                 max_events: int = _MAX_EVENTS,
                 rotate_events: int = 0,
                 rotate_path: Optional[str] = None):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: list = []
        self._dropped = 0
        self._max = max_events
        # Windowed rotation (rotate_events > 0): when the buffer reaches
        # the watermark, it is swapped out under the lock and handed to
        # a dedicated background WRITER thread — the instrumented
        # thread that crossed the watermark never pays the window's
        # json-serialize+write (tens of MB at production watermarks; an
        # inline dump would inject a periodic stall into whichever
        # pipeline stage happened to cross).
        # With rotation on, the drop cap does not apply at all: the
        # buffer resets every window, so memory is bounded by the
        # watermark (plus one in-flight shipment), and applying the
        # cap anywhere near the watermark would drop events rotation
        # exists to preserve (a worker-shipped batch crossing the cap
        # used to truncate before the rotation check could run).
        # _rotate_cfg is the configured watermark (never changes);
        # _rotate_events is the LIVE value — close() zeroes it so
        # post-close stragglers fall back to the capped buffer, and
        # reset() re-arms it for the next run of a warm owner.
        self._rotate_cfg = int(rotate_events or 0)
        self._rotate_events = self._rotate_cfg
        self._rotate_path = rotate_path
        self._windows = 0
        self._dropped_reported = 0
        self._rotate_q: Optional[queue.Queue] = None
        self._rotate_thread: Optional[threading.Thread] = None
        if self._rotate_events and enabled:
            self._start_writer()
        self._pid = os.getpid()
        self._named_tids: set = set()
        self._process_name = process_name
        self._wall_anchor = time.time()
        self._perf_anchor = time.perf_counter()
        if enabled and process_name:
            self.name_process(process_name)

    # ------------------------------------------------------------------
    # metadata
    # ------------------------------------------------------------------

    def name_process(self, name: str) -> None:
        if not self.enabled:
            return
        self._append({
            "ph": "M", "name": "process_name", "pid": self._pid, "tid": 0,
            "args": {"name": name},
        })

    def name_thread(self, name: str) -> None:
        """Label the CURRENT thread's lane (idempotent per thread)."""
        if not self.enabled:
            return
        tid = threading.get_ident()
        with self._lock:
            if tid in self._named_tids:
                return
            self._named_tids.add(tid)
        self._append({
            "ph": "M", "name": "thread_name", "pid": self._pid, "tid": tid,
            "args": {"name": name},
        })

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------

    def span(self, name: str, args: Optional[dict] = None, flow=None):
        """``with tracer.span("stage", args={"sb": 3}): ...``

        ``flow`` is an optional ``(phase, id)`` pair with phase in
        ``{"s", "t", "f"}`` (flow start / step / end) — the arrow that
        visually links this span to the others sharing the id.
        """
        if not self.enabled:
            return _NULL_CTX
        return SpanHandle(self, name, args, flow)

    def emit(self, name: str, t0: float, dur_s: float,
             args: Optional[dict] = None, pid: Optional[int] = None,
             tid: Optional[int] = None, flow=None) -> None:
        """Record one complete event from explicit perf_counter times."""
        if not self.enabled:
            return
        pid = self._pid if pid is None else pid
        tid = threading.get_ident() if tid is None else tid
        ts = _us(t0)
        ev = {
            "ph": "X", "name": name, "cat": "tffm", "ts": ts,
            "dur": max(1, _us(dur_s)), "pid": pid, "tid": tid,
        }
        if args:
            ev["args"] = args
        self._append(ev)
        if flow is not None:
            phase, fid = flow
            fev = {
                "ph": phase, "name": "sb", "cat": "tffm_flow",
                "id": str(fid), "ts": ts, "pid": pid, "tid": tid,
            }
            if phase == "f":
                fev["bp"] = "e"  # bind the flow end to the enclosing slice
            self._append(fev)

    def point(self, name: str, args: Optional[dict] = None) -> None:
        """Mark an instant (1 µs slice, so report tooling sees one event
        shape everywhere)."""
        if not self.enabled:
            return
        self.emit(name, time.perf_counter(), 0.0, args=args)

    def _append(self, ev: dict) -> None:
        with self._lock:
            if not self._rotate_events and len(self._events) >= self._max:
                self._dropped += 1
                return
            self._events.append(ev)
            rotate = (
                self._rotate_events
                and len(self._events) >= self._rotate_events
            )
        if rotate:
            self._maybe_rotate()

    # In-memory cost of one buffered event dict, estimated: a span is a
    # small dict of short strings/ints (~120-250 B serialized) whose
    # CPython representation (dict + boxed values) runs ~2x that.  The
    # resource ledger wants an order-of-magnitude byte figure without
    # sizeof-walking a million events under the append lock.
    _EVENT_EST_BYTES = 400

    @property
    def buffer_bytes(self) -> int:
        """Estimated host bytes held by the in-memory event buffer —
        the tracer's entry in the component memory ledger (rotation
        bounds it at ~rotate_events * 400 B; unrotated traces grow to
        the cap)."""
        with self._lock:
            return len(self._events) * self._EVENT_EST_BYTES

    @property
    def dropped_events(self) -> int:
        """Events discarded at the buffer cap so far.  A nonzero value
        means the trace is TRUNCATED — chains silently stop mid-run —
        so the count is surfaced (dump() warning + the trainer's final
        metrics record) instead of only living in the dump metadata."""
        with self._lock:
            return self._dropped

    # ------------------------------------------------------------------
    # cross-process shipping
    # ------------------------------------------------------------------

    def take(self) -> list:
        """Drain and return the buffered raw events (worker side: ship
        these with the next result message)."""
        if not self.enabled:
            return []
        with self._lock:
            evs, self._events = self._events, []
        return evs

    def tail(self, n: int = 256) -> list:
        """The last ``n`` buffered events WITHOUT draining them — the
        blackbox flight recorder's view of "what was the process doing
        just now".  Shallow copies, safe to serialize after the tracer
        moves on."""
        if not self.enabled or n <= 0:
            return []
        with self._lock:
            return [dict(ev) for ev in self._events[-n:]]

    def add_raw(self, events) -> None:
        """Ingest events shipped from another Tracer (they already carry
        their own pid/tid; perf_counter is host-wide, so no shifting)."""
        if not self.enabled or not events:
            return
        with self._lock:
            if self._rotate_events:
                # No cap under rotation: a shipped batch must never
                # truncate on its way into a window (zero-drop
                # contract); the rotation below bounds memory.
                self._events.extend(events)
                rotate = len(self._events) >= self._rotate_events
            else:
                room = self._max - len(self._events)
                if room <= 0:
                    self._dropped += len(events)
                    return
                self._events.extend(events[:room])
                self._dropped += max(0, len(events) - room)
                rotate = False
        if rotate:
            self._maybe_rotate()

    # ------------------------------------------------------------------
    # windowed rotation
    # ------------------------------------------------------------------

    @property
    def windows_written(self) -> int:
        """Rotated window files dumped so far (excluding the final one
        :meth:`dump` writes)."""
        with self._lock:
            return self._windows

    def window_path(self, idx: int) -> str:
        """``trace.json`` -> ``trace.<idx>.json`` (other extensions get
        ``<path>.<idx>.json`` appended — rank-suffixed paths stay
        greppable as one family)."""
        base = self._rotate_path or "trace.json"
        stem, ext = os.path.splitext(base)
        if ext == ".json":
            return f"{stem}.{idx}.json"
        return f"{base}.{idx}.json"

    def _start_writer(self) -> None:
        self._rotate_q = queue.Queue()
        self._rotate_thread = threading.Thread(
            target=self._writer_loop, name="trace-rotate", daemon=True,
        )
        self._rotate_thread.start()

    def _writer_loop(self) -> None:
        q = self._rotate_q  # bound once: close() clears the attribute
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                self._write_window(*item)
            finally:
                q.task_done()

    def _maybe_rotate(self) -> None:
        """Swap the full buffer out under the lock and enqueue it for
        the writer thread.  Instrumented threads only ever pay the
        swap; the file write happens off the hot path.  A losing racer
        sees the already-reset buffer and returns.  The queue is
        captured UNDER the lock (close() clears it under the same
        lock), so a racing close() can never strand swapped-out events
        on a writerless queue or null-deref here."""
        with self._lock:
            q = self._rotate_q
            if (
                q is None
                or not self._rotate_events
                or len(self._events) < self._rotate_events
            ):
                return  # lost the race (rotation closed or buffer reset)
            events, self._events = self._events, []
            idx = self._windows
            self._windows += 1
            dropped = self._dropped - self._dropped_reported
            self._dropped_reported = self._dropped
        q.put((idx, events, dropped))

    def _write_window(self, idx: int, events: list,
                      dropped: int) -> None:
        """One window file.  All windows of a run share the clock
        anchors (the run stays ONE timeline); ``window`` + the shared
        anchors are how ``tools/report.py --trace`` re-joins a rotated
        stream before chain reconstruction."""
        path = self.window_path(idx)
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "wall_anchor": self._wall_anchor,
                "perf_anchor": self._perf_anchor,
                "pid": self._pid,
                "window": idx,
                "dropped_events": dropped,
            },
        }
        try:
            with open(path, "w") as f:
                json.dump(doc, f)
        except OSError as e:  # pragma: no cover - full volume
            log.warning("trace window dump failed (%s): %s", path, e)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def close(self) -> None:
        """Stop the rotation writer thread (idempotent; no-op without
        rotation).  Pending windows are flushed first.  A Tracer used
        to be leaked-by-design here — every rotating Tracer left a
        daemon ``trace-rotate`` thread alive for the life of the
        process, one more per run in a long-lived embedder (serve
        mode, test suites); flagged by tffm-lint TL005."""
        with self._lock:
            # Cleared under the append lock so a racing _maybe_rotate
            # either sees the live queue (its window will be drained by
            # the q.join() below) or sees None and backs off — never a
            # swap onto a writerless queue.  Post-close stragglers fall
            # back to the capped in-memory buffer; reset() re-arms.
            q = self._rotate_q
            self._rotate_events = 0
            self._rotate_q = None
        if q is not None:
            q.join()
            q.put(None)
        if self._rotate_thread is not None:
            self._rotate_thread.join()
            self._rotate_thread = None

    def reset(self) -> None:
        """Drop buffered events and re-anchor (per-run accounting, like
        Telemetry.reset).  The process-name metadata survives — it names
        the lane, not the run."""
        if self._rotate_q is not None:
            # A previous run's windows must finish writing before the
            # counters restart, or run-2's window 0 could interleave
            # with run-1's tail.
            self._rotate_q.join()
        with self._lock:
            self._events = []
            self._dropped = 0
            self._dropped_reported = 0
            self._windows = 0
            self._named_tids = set()
        self._wall_anchor = time.time()
        self._perf_anchor = time.perf_counter()
        # A close()d tracer re-arms for the next run: a warm owner's
        # second train() must rotate exactly like the first (close()
        # only stops the PREVIOUS run's writer thread).
        if self._rotate_cfg and self.enabled and self._rotate_q is None:
            self._rotate_events = self._rotate_cfg
            self._start_writer()
        if self.enabled and self._process_name:
            self.name_process(self._process_name)

    def dump(self, path: str) -> int:
        """Write the Perfetto-loadable JSON; returns the event count.

        With rotation configured, ``path`` is ignored in favor of the
        next window file — the run's ENTIRE output is the uniform
        ``trace.0.json .. trace.N.json`` family (the final window holds
        whatever was buffered past the last watermark crossing).

        ``otherData`` carries the wall/perf clock anchors so
        ``tools/report.py --trace`` can place traces from different
        hosts (multi-rank runs) on one wall-clock timeline.
        """
        with self._lock:
            q = self._rotate_q if self._rotate_events else None
            if q is not None:
                events, self._events = self._events, []
                idx = self._windows
                self._windows += 1
                dropped = self._dropped - self._dropped_reported
                self._dropped_reported = self._dropped
        if q is not None:
            q.put((idx, events, dropped))
            # End of run: every window must be on disk when dump
            # returns (the caller logs the family and may exit).
            q.join()
            return len(events)
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        if dropped:
            log.warning(
                "trace buffer overflowed: %d event(s) dropped past the "
                "%d-event cap — %s is TRUNCATED (chains stop mid-run); "
                "trace shorter runs, raise max_events, or rotate "
                "windows (trace_rotate_events)",
                dropped, self._max, path,
            )
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "wall_anchor": self._wall_anchor,
                "perf_anchor": self._perf_anchor,
                "pid": self._pid,
                "dropped_events": dropped,
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)


NULL_TRACER = Tracer(enabled=False)
