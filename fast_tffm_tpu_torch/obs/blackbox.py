"""Incident flight recorder ("blackbox"): fixed-memory evidence rings
plus alert-triggered forensic bundles.

The PyTorch port's copy of ``fast_tffm_tpu/obs/blackbox.py``: the same
bundle layout, so either package's ``tools/report.py --incident`` reads
the other's bundles.

Every long-running process (trainer rank, serve replica, router) keeps
a :class:`Blackbox`: three bounded rings — the last N heartbeat/status-
shaped records, the last M ``record: alert`` entries, and (via a
callable) the trace-buffer tail — costing a few hundred KB regardless
of run length.  Nothing is written to disk until an *incident* fires:

- an ``alert_rules`` breach (warn or halt) via ``Blackbox.on_alert``
  wired into ``AlertEngine(on_alert=...)``;
- a crash-truthful final (``NonFiniteGradError`` / ``AlertHaltError`` /
  any unhandled exception) — the host's teardown path calls
  ``incident("crash_<ExcType>")``;
- a manual ``POST /incident?reason=...`` admin route on any status/
  serve/router endpoint.

An incident dumps an ``incidents/<ts>_<reason>[_<suffix>]/`` bundle:

====================  ==================================================
``manifest.json``     the ``record: incident`` manifest (reason, time,
                      counts, which artifacts landed)
``records.jsonl``     the heartbeat/status ring, oldest first
``alerts.jsonl``      the alert ring
``trace_tail.json``   Chrome-trace events from the tracer tail
``threadz.txt``       all-thread stack dump (``/debug/threadz`` style)
``run_header.json``   run header / config fingerprint
``metrics.prom``      rendered ``/metrics`` snapshot at dump time
``requests.capture``  (serving) last K sampled request/response frames
                      in the TFC1 capture format (see serve/wire.py)
====================  ==================================================

Dump failures degrade per-artifact (a broken metrics renderer still
yields the rings) and NEVER propagate into the host process — the
recorder observes crashes, it must not cause them.  ``suffix`` keeps
concurrent dumpers (ranks, replicas, the router) collision-free;
same-second same-reason dumps from ONE process retry with a ``-2``/
``-3`` ordinal.  Stdlib-only, same as the rest of obs/.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import threading
import time

log = logging.getLogger("fast_tffm.obs")

__all__ = ["Blackbox", "NULL_BLACKBOX"]

_REASON_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def _sanitize_reason(reason: str) -> str:
    """Filesystem-safe incident reason: collapse anything outside
    ``[A-Za-z0-9_.-]`` to ``_``, cap the length, never empty."""
    out = _REASON_RE.sub("_", str(reason)).strip("._-")
    return (out or "incident")[:64]


class Blackbox:
    """Fixed-memory flight recorder + incident bundle dumper.

    Parameters
    ----------
    incident_dir:
        Root directory bundles land under (created lazily on the first
        incident — an incident-free run leaves no trace on disk).
    suffix:
        Per-process discriminator appended to every bundle dir name
        (``rank0``, ``pid4242``, ``router``) so concurrent processes
        sharing one ``incident_dir`` never collide.
    records / alerts / trace_tail:
        Ring capacities.  Memory is bounded by these regardless of run
        length (pinned by test).
    run_header:
        Dict snapshot written as ``run_header.json`` (config
        fingerprint, build info).
    metrics_render / trace_tail_fn / capture_tail_fn:
        Optional callables evaluated AT DUMP TIME: a Prometheus text
        renderer, ``Tracer.tail``-shaped event source, and a
        ``CaptureWriter.tail_bytes``-shaped raw capture source.
    writer:
        Optional JsonlWriter — the incident manifest is also appended
        to the metrics stream so bundles are discoverable from JSONL
        alone.
    telemetry:
        Optional registry; bumps the ``obs.incidents`` counter per
        bundle dumped.
    max_bundles:
        Hard cap on bundles this process may dump (an alert flapping
        every heartbeat must not fill the disk).
    """

    def __init__(
        self,
        incident_dir: str,
        *,
        suffix: str = "",
        records: int = 64,
        alerts: int = 32,
        trace_tail: int = 256,
        run_header: dict | None = None,
        metrics_render=None,
        trace_tail_fn=None,
        capture_tail_fn=None,
        writer=None,
        telemetry=None,
        max_bundles: int = 16,
        enabled: bool = True,
        clock=time.time,
    ):
        self.enabled = enabled
        self.incident_dir = incident_dir
        self.suffix = suffix
        self._records = collections.deque(maxlen=max(1, records))
        self._alerts = collections.deque(maxlen=max(1, alerts))
        self._trace_tail_n = max(0, trace_tail)
        self._run_header = dict(run_header) if run_header else {}
        self._metrics_render = metrics_render
        self._trace_tail_fn = trace_tail_fn
        self._capture_tail_fn = capture_tail_fn
        self._writer = writer
        self._max_bundles = max_bundles
        self._clock = clock
        self._lock = threading.Lock()
        self.dumped = 0
        self._c_incidents = None
        if telemetry is not None:
            self._c_incidents = telemetry.counter("obs.incidents")

    # ------------------------------------------------------------------
    # Ring feeds (hot path: one lock + one deque append, no allocation
    # beyond the reference — records are shared, not copied).

    def observe_record(self, rec) -> None:
        if not self.enabled or not isinstance(rec, dict):
            return
        with self._lock:
            self._records.append(rec)

    def observe_alert(self, alert) -> None:
        if not self.enabled or not isinstance(alert, dict):
            return
        with self._lock:
            self._alerts.append(alert)

    def on_alert(self, alert) -> None:
        """``AlertEngine(on_alert=...)`` hook: ring the alert, then
        dump a bundle named after the breached rule."""
        if not self.enabled:
            return
        self.observe_alert(alert)
        rule = alert.get("rule", "rule") if isinstance(alert, dict) else "rule"
        self.incident(f"alert_{rule}")

    # ------------------------------------------------------------------
    # Incident dump

    def incident(self, reason: str, extra: dict | None = None):
        """Dump a forensic bundle; returns the bundle dir, or ``None``
        when disabled / bundle-capped / the dump itself failed."""
        if not self.enabled:
            return None
        try:
            return self._dump(reason, extra)
        except Exception as e:  # never let forensics kill the host
            log.warning("blackbox: incident dump failed: %s", e)
            return None

    def _dump(self, reason: str, extra: dict | None):
        with self._lock:
            if self.dumped >= self._max_bundles:
                log.warning(
                    "blackbox: bundle cap (%d) reached, dropping "
                    "incident %r", self._max_bundles, reason,
                )
                return None
            records = list(self._records)
            alerts = list(self._alerts)
            self.dumped += 1
        now = self._clock()
        clean = _sanitize_reason(reason)
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(now))
        base = f"{stamp}_{clean}" + (f"_{self.suffix}" if self.suffix else "")
        out = self._make_dir(base)
        if out is None:
            return None

        files = {}

        def _artifact(name, fn):
            try:
                fn(os.path.join(out, name))
                files[name] = True
            except Exception as e:
                log.warning("blackbox: %s failed: %s", name, e)
                files[name] = False

        def _jsonl(path, rows):
            with open(path, "w", encoding="utf-8") as f:
                for row in rows:
                    f.write(json.dumps(row, default=str) + "\n")

        _artifact("records.jsonl", lambda p: _jsonl(p, records))
        _artifact("alerts.jsonl", lambda p: _jsonl(p, alerts))
        _artifact("threadz.txt", self._write_threadz)
        if self._run_header:
            _artifact(
                "run_header.json",
                lambda p: _jsonl(p, [self._run_header]),
            )
        if self._trace_tail_fn is not None:
            _artifact("trace_tail.json", self._write_trace_tail)
        if self._metrics_render is not None:
            _artifact("metrics.prom", self._write_metrics)
        if self._capture_tail_fn is not None:
            _artifact("requests.capture", self._write_capture)

        manifest = {
            "record": "incident",
            "time": now,
            "reason": clean,
            "suffix": self.suffix,
            "incident_dir": out,
            "records": len(records),
            "alerts": len(alerts),
            "files": files,
        }
        if extra:
            manifest.update(extra)
        with open(
            os.path.join(out, "manifest.json"), "w", encoding="utf-8"
        ) as f:
            json.dump(manifest, f, indent=2, default=str)
            f.write("\n")
        if self._writer is not None:
            try:
                self._writer.write(manifest)
            except Exception:
                pass
        if self._c_incidents is not None:
            self._c_incidents.add()
        log.warning("blackbox: incident %r dumped to %s", clean, out)
        return out

    def _make_dir(self, base: str):
        """Create the bundle dir; ordinal-retry same-name collisions
        (two same-second incidents from this process)."""
        for ordinal in range(1, 10):
            name = base if ordinal == 1 else f"{base}-{ordinal}"
            path = os.path.join(self.incident_dir, name)
            try:
                os.makedirs(path, exist_ok=False)
                return path
            except FileExistsError:
                continue
        log.warning("blackbox: could not allocate bundle dir for %r", base)
        return None

    def _write_threadz(self, path: str) -> None:
        # Lazy sibling import: blackbox must stay importable whatever
        # order obs/__init__ wires the plane up in.
        from fast_tffm_tpu_torch.obs.status import thread_dump

        with open(path, "w", encoding="utf-8") as f:
            f.write(thread_dump())

    def _write_trace_tail(self, path: str) -> None:
        events = self._trace_tail_fn(self._trace_tail_n) or []
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": events}, f, default=str)
            f.write("\n")

    def _write_metrics(self, path: str) -> None:
        text = self._metrics_render() or ""
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)

    def _write_capture(self, path: str) -> None:
        data = self._capture_tail_fn() or b""
        with open(path, "wb") as f:
            f.write(data)


#: Shared disabled instance — every observe/incident is a cheap no-op,
#: mirroring ``NULL_TRACER`` / ``obs.NULL``.
NULL_BLACKBOX = Blackbox("", enabled=False)
