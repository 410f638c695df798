"""Structured heartbeat: a run that self-reports its bottleneck.

The PyTorch port's own copy of ``fast_tffm_tpu/obs/heartbeat.py``
(stdlib only).

:class:`JsonlWriter` is the ONE writer for the ``metrics_file`` stream —
the train loop's interval records, validation records, the run header,
heartbeats, alerts and the final summary all go through it, serialized
by a lock (the heartbeat emitter runs on its own thread).

:class:`Heartbeat` wakes every ``interval_s``, asks the owner for a
record (a callable, so the trainer composes step/elapsed/telemetry
snapshot without this module knowing about torch or the loop), writes
it as one JSONL line, and logs a one-line human summary.  The callable
runs on the heartbeat thread: it must stay host-only (counters, gauges,
timers — never a device readback, which would force a sync mid-dispatch
and perturb the run it is measuring).
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Callable, Optional

__all__ = ["Heartbeat", "JsonlWriter", "rank_suffix_path"]

log = logging.getLogger(__name__)


def rank_suffix_path(path: str, rank: int) -> str:
    """The one spelling of per-rank JSONL/trace output paths: rank 0
    owns the configured path, ranks > 0 suffix ``.rank{N}``.  Every
    multi-host writer (metrics stream, trace file) routes through this
    so two ranks can never append into one stream and double-count a
    merged report (``tools/report.py`` groups the family back
    together by the suffix + each record's ``rank`` tag)."""
    if rank <= 0 or not path:
        return path
    return f"{path}.rank{rank}"


class JsonlWriter:
    """Lock-serialized line-per-record JSON writer (append mode)."""

    def __init__(self, path: str):
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def write(self, record: dict) -> None:
        line = json.dumps(record)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class Heartbeat:
    """Periodic emitter thread.

    ``build`` returns the record dict for one beat (or None to skip —
    e.g. before the first dispatch there is nothing to report);
    ``writer`` is an optional :class:`JsonlWriter` (no metrics_file →
    log-only heartbeats).  ``close()`` stops the thread deterministically
    (event wakeup, no poll latency) and is idempotent; it does NOT emit
    a final beat — the owner writes its own final record with exact
    end-of-run values.
    """

    def __init__(
        self,
        interval_s: float,
        build: Callable[[], Optional[dict]],
        writer: Optional[JsonlWriter] = None,
    ):
        self._interval = interval_s
        self._build = build
        self._writer = writer
        self._write_warned = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="telemetry-heartbeat", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.beat()

    def beat(self) -> None:
        """Emit one heartbeat now (also used by tests for determinism)."""
        try:
            record = self._build()
        except Exception as e:  # pragma: no cover - must never kill a run
            log.warning("heartbeat build failed: %s", e)
            return
        if record is None:
            return
        if self._writer is not None:
            try:
                self._writer.write(record)
            except Exception as e:
                # A full/unwritable metrics volume must not kill the
                # heartbeat thread — the log-line summary below is
                # exactly the channel that still works.  Warn once.
                if not self._write_warned:
                    self._write_warned = True
                    log.warning(
                        "heartbeat record write failed (%s: %s); "
                        "log-only heartbeats from here on",
                        type(e).__name__, e,
                    )
        log.info(
            "heartbeat step %s elapsed %.1fs ingest_wait_frac %.3f "
            "dispatch %.1fs wait %.1fs",
            record.get("step", "?"), record.get("elapsed", 0.0),
            record.get("ingest_wait_frac", 0.0),
            record.get("dispatch_s", 0.0), record.get("wait_input_s", 0.0),
        )

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
