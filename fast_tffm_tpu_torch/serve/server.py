"""The scoring endpoint: HTTP front door, hot-swap watcher, lifecycle.

The counterpart of ``fast_tffm_tpu/serve/server.py`` for a single
replica, with the same request and response formats:

- ``POST /score`` — body is libsvm/ffm text, one example per line in
  exactly the ``predict_files`` format (label column present but
  ignored; lines whose first token contains ``:`` are accepted
  label-less).  Response: one score per non-blank line, ``%.6f``.
- ``POST /score_bin`` — the binary request transport: one
  length-prefixed little-endian frame of id/value/field arrays
  (``serve/wire.py``); scores come back as one binary frame,
  bitwise-identical to ``/score``'s for the same examples.
  ``serve_transport`` gates which of the two are enabled.
- ``POST /reload`` / ``/promote`` / ``/rollback`` — the admin swap
  routes: reload the current checkpoint (``/reload?keep_prev=1`` keeps
  the replaced table for a rollback), close that window, or restore the
  table it kept.  Each answers ``{"step": ...}``; a rollback with no
  window open, and a checkpoint the config cannot serve, answer 409.
- ``GET /metrics`` / ``/status`` / ``/healthz`` (and ``/debug/threadz``)
  — the observability routes; all ``serve.*`` instruments plus a
  ``serve`` record block show up as ``tffm_serve_*`` series.

:class:`CheckpointWatcher` (``serve_poll_secs > 0``, the default 2 s)
polls the ``serve_manifest.json`` every save of either package
publishes after its files land, and hot-swaps the scorer when it
changes (:func:`reload_scorer`: placed off the dispatch lock, then one
reference swap).  A checkpoint the config cannot serve is taken as the
new baseline, so it is not reloaded at every poll; any other failure is
retried at the next one.

:func:`serve` builds the stack from an :class:`FmConfig` (scorer ->
warmup -> batcher -> watcher -> HTTP) and returns a :class:`ServeHandle`;
:func:`serve_forever` is the CLI entry.  The SLO ledger
(``serve_slo_p99_ms`` / ``serve_slo_availability``, ``serve/slo.py``)
adds its ``slo_*`` and ``burn_rate`` keys to the ``serve`` block, and
traffic capture (``serve_capture_sample`` / ``serve_capture_file``)
appends sampled request/response frame pairs to a TFC1 file
(``serve/wire.py``) that ``python -m fast_tffm_tpu_torch.tools.replay``
re-drives.  ``serve_replicas`` is the fleet's (``serve/router.py``):
this module serves one process whatever it says, as the reference's
does.  The server reports as the reference's does: a ``metrics_file``
stream opened by a ``run_header`` record (``mode: serve``), a
``heartbeat`` record every ``heartbeat_secs`` (the ``build`` that
``/status`` answers with), an :class:`~fast_tffm_tpu_torch.obs.alerts.
AlertEngine` of ``alert_rules`` on the heartbeat (a ``halt`` rule stops
:func:`serve_forever`), and one ``final`` record at close.  None of the
planes below changes a score:

- **skew** (``quality``, on by default): a ``ServeSkewMonitor`` holds the
  trainer-published reference sketches of ``serve_manifest.json`` and a
  live window of the requests' ids, values and served scores, and adds
  the ``skew_*`` keys to the ``serve`` block; the watcher's hot swap,
  ``/reload`` and ``/promote`` re-read the reference, ``/rollback``
  restores the one before;
- **trace** (``trace_file``, ``serve_trace_sample``): a sampled request
  (or one that arrives with an id) gets the handler's ``serve.respond``
  span and the batcher's queue, coalesce and dispatch spans, joined by
  its ``rid``; the trace is written at close;
- **blackbox** (on by default): the record and alert rings, and a bundle
  (with the capture's tail) on an alert, on ``POST /incident`` and on a
  crash.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs.alerts import (
    AlertEngine, AlertHaltError, parse_rules, run_until_halt,
)
from fast_tffm_tpu_torch.obs.blackbox import Blackbox
from fast_tffm_tpu_torch.obs.heartbeat import Heartbeat, JsonlWriter
from fast_tffm_tpu_torch.obs.resource import basic_block
from fast_tffm_tpu_torch.obs.quality import ServeSkewMonitor
from fast_tffm_tpu_torch.obs.status import (
    ObsHTTPServer, PooledHTTPServer, QuietHandler, render_prometheus,
)
from fast_tffm_tpu_torch.obs.telemetry import Telemetry
from fast_tffm_tpu_torch.obs.trace import NULL_TRACER, Tracer
from fast_tffm_tpu_torch.ops import fm_kernels
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.serve import scorer as scorer_lib
from fast_tffm_tpu_torch.serve import wire
from fast_tffm_tpu_torch.serve.batcher import ServeBatcher
from fast_tffm_tpu_torch.serve.slo import SloTracker
from fast_tffm_tpu_torch.serve.textparse import (
    ParseScratchPool, parse_request,
)
from fast_tffm_tpu_torch.train.manifest import read_manifest

log = logging.getLogger(__name__)

__all__ = ["CheckpointWatcher", "ServeHandle", "ServeServer",
           "reload_scorer", "serve", "serve_forever"]

# Settings whose non-default value the port's server does not act on:
# none of them changes a score.  The XLA compile cache has no
# counterpart; ``compile_cache_dir`` only places the interaction
# autotuner's ``autotune_cache.json`` (``ops/autotune.py``).
_INERT_KNOBS = ("compile_cache_dir",)


def _warn_inert(cfg: FmConfig) -> None:
    """Log the settings the port's server does not act on (none of them
    changes a score)."""
    defaults = FmConfig()
    inert = [
        k for k in _INERT_KNOBS
        if getattr(cfg, k) != getattr(defaults, k)
    ]
    if inert:
        log.warning(
            "the PyTorch port's server does not act on %s beyond placing "
            "the autotuner's autotune_cache.json; scores are unaffected",
            ", ".join(inert),
        )


def reload_scorer(cfg: FmConfig, scorer, keep_prev: bool = False) -> int:
    """Reload ``cfg.model_file``'s checkpoint into the running scorer
    (placed off the dispatch lock, then one reference swap) and return
    its step.  Raises ValueError where the config cannot serve it,
    a change between the dense (or quantized) and the tiered format
    included: a running scorer cannot cross it.  The watcher and the
    ``/reload`` route share it."""
    fmt, step, model = scorer_lib.load_model(cfg)
    if fmt == "tiered" and isinstance(scorer, scorer_lib.OverlayScorer):
        scorer.swap(*model, step=step, keep_prev=keep_prev)
    elif fmt in ("dense", "quant") and isinstance(
            scorer, scorer_lib.FixedShapeScorer):
        scorer.swap(model, step=step, keep_prev=keep_prev)
    else:
        raise ValueError(
            f"checkpoint at {cfg.model_file} changed FORMAT ({fmt}) "
            "mid-serve; a running server cannot cross dense<->tiered "
            "— restart to pick it up"
        )
    return step


class CheckpointWatcher:
    """Poll the save path's manifest; hot-swap the scorer on a new one.

    ``seen`` is the manifest the served table came from: the owner reads
    it BEFORE loading the checkpoint (:func:`serve` does), so a save that
    lands during the load and warmup is picked up at the first poll.
    None reads it at construction.  ``close`` stops and joins the
    thread.
    """

    def __init__(self, cfg: FmConfig, scorer, poll_secs: float,
                 seen=None, on_swap=None):
        self._cfg = cfg
        self._scorer = scorer
        self._on_swap = on_swap  # called with the new step after a swap
        self._poll = max(0.05, float(poll_secs))
        self._seen = (seen if seen is not None
                      else read_manifest(cfg.model_file))
        self.reloads = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="tffm-serve-watcher", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                self._check_once()
            except Exception as e:  # noqa: BLE001 - retry next poll
                log.warning(
                    "checkpoint watcher: reload failed (%s); will retry "
                    "next poll", e)

    def _check_once(self) -> None:
        man = read_manifest(self._cfg.model_file)
        if man is None or man == self._seen:
            return
        try:
            step = reload_scorer(self._cfg, self._scorer)
        except ValueError as e:
            # A contradiction between the config and the checkpoint
            # (dtype, chunk, shape, overlay descriptor, format) that
            # re-reading would not fix: keep serving, wait for the next
            # publish.
            log.warning(
                "checkpoint at %s cannot be served under this config "
                "(%s); keeping the current params until the next save",
                self._cfg.model_file, e)
            self._seen = man
            return
        self._seen = man
        self.reloads += 1
        if self._on_swap is not None:
            self._on_swap(step)

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


class ServeServer:
    """HTTP front door: ``POST /score`` (libsvm text), ``POST
    /score_bin`` (the binary frame transport, gated by
    ``serve_transport``), the admin swap routes ``/reload``,
    ``/promote`` and ``/rollback`` on ``scorer``, and the observability
    routes.  ``slo`` (a :class:`SloTracker`) counts a request the
    batcher failed to answer; ``capture`` (a ``wire.CaptureWriter``)
    records sampled scored requests.  ``tracer`` and ``sampler`` trace
    the sampled requests; ``on_reload`` runs after ``/reload`` and
    ``/promote``, ``on_rollback`` after ``/rollback``; ``incident`` is
    the blackbox's bundle call behind ``POST /incident`` (503 without
    it)."""

    def __init__(self, port: int, batcher: ServeBatcher, cfg: FmConfig,
                 build, telemetry: Telemetry, host: str = "127.0.0.1",
                 timeout_s: float = 30.0, scorer=None, slo=None,
                 capture=None, tracer=None, sampler=None, on_reload=None,
                 on_rollback=None, incident=None):
        tracer = tracer if tracer is not None else NULL_TRACER
        # Request-id mint and the trace sampler's coin for direct
        # traffic (a router stamps its sampled requests' ids).
        sampler = sampler if sampler is not None else wire.RequestSampler(
            cfg.serve_trace_sample, enabled=tracer.enabled, tag="s")
        requests_c = telemetry.counter("serve.http_requests")
        truncated_c = telemetry.counter("serve.truncated_features")
        parse_t = telemetry.timer("serve.parse")
        parse_bin_t = telemetry.timer("serve.parse_bin")
        # Recycled per-request parse scratch: the text path's arrays
        # come from here and go back via the batcher's on_done hook.
        parse_pool = ParseScratchPool(cfg.max_features, telemetry=telemetry)
        # One admin swap at a time: a reload places a whole table, and two
        # at once would race the rollback window.
        admin_lock = threading.Lock()

        def encode_text(scores):
            return "text/plain", "".join(
                f"{s:.6f}\n" for s in scores
            ).encode()

        def encode_bin(scores):
            return ("application/octet-stream",
                    wire.encode_bin_response(scores))

        class Handler(QuietHandler):
            def do_POST(self) -> None:  # noqa: N802 - http.server API
                requests_c.add()
                path, _, query = self.path.partition("?")
                if path in ("/reload", "/promote", "/rollback"):
                    self._do_admin(path, query)
                    return
                if path == "/incident":
                    self._post_incident(query, incident)
                    return
                if path not in ("/score", "/score_bin"):
                    self._send(404, b"not found\n", "text/plain")
                    return
                want = "text" if path == "/score" else "bin"
                if cfg.serve_transport not in (want, "both"):
                    self._send(
                        404, f"transport {want!r} disabled "
                             f"(serve_transport="
                             f"{cfg.serve_transport})\n".encode(),
                        "text/plain",
                    )
                    return
                body = self._read_body(wire.MAX_BODY_BYTES)
                if body is None:
                    return  # error response already sent
                # Request id: the X-Request-Id header, overridden by a
                # valid binary frame trailer; echoed in the response.
                # Invalid ids are ignored, never reflected.
                rid = self.headers.get("X-Request-Id")
                if rid is not None and not wire.valid_request_id(rid):
                    rid = None
                on_done = None
                try:
                    if path == "/score":
                        with parse_t.time():
                            ids, vals, fields, n, truncated = parse_request(
                                body.decode(), cfg, pool=parse_pool
                            )
                        on_done = lambda i=ids: parse_pool.release(i)  # noqa: E731
                        encode = encode_text
                    else:
                        with parse_bin_t.time():
                            (ids, vals, fields, n, truncated,
                             frame_rid) = wire.decode_bin_request(body, cfg)
                        if frame_rid is not None and \
                                wire.valid_request_id(frame_rid):
                            rid = frame_rid
                        encode = encode_bin
                except (ValueError, UnicodeDecodeError) as e:
                    self._send(
                        400, f"bad request: {e}\n".encode(), "text/plain"
                    )
                    return
                if rid is None and sampler.sample():
                    # Direct traffic with no upstream id: this server is
                    # the front door, so it mints (and samples) itself.
                    rid = sampler.mint()
                headers = {"X-Request-Id": rid} if rid is not None else None
                if truncated:
                    # A truncated example scores as a different example.
                    truncated_c.add(truncated)
                if n == 0:
                    if on_done is not None:
                        on_done()
                    ctype, out = encode(np.zeros((0,), np.float32))
                    self._send(200, out, ctype, headers=headers)
                    return
                # Traffic capture: the request frame is encoded now,
                # while this handler still owns the arrays (the batcher
                # releases pooled text-parse scratch as soon as its
                # dispatcher stops reading them).  The canonical form
                # (padded, ids reduced) makes a replay's decode
                # idempotent, so it reproduces the response bitwise.
                # An unsampled request pays one attribute compare.
                cap_req = None
                if capture is not None and capture.sample():
                    try:
                        cap_req = wire.encode_bin_request(
                            ids[:n], vals[:n],
                            fields[:n]
                            if (cfg.field_num and fields is not None)
                            else None,
                        )
                    except Exception as e:  # noqa: BLE001 - forensics
                        log.warning("capture encode failed: %s", e)
                try:
                    scores = batcher.score(
                        ids, vals, fields if cfg.field_num else None,
                        timeout=timeout_s, rid=rid, on_done=on_done,
                    )
                except Exception as e:  # noqa: BLE001 - report, don't die
                    if slo is not None:
                        # The batcher's ledger sees only what its
                        # dispatcher finishes; a timeout or a closed
                        # batcher is a 503 the client saw.
                        slo.observe(False)
                    self._send(
                        503, f"scoring failed: {e}\n".encode(),
                        "text/plain", headers=headers,
                    )
                    return
                if cap_req is not None:
                    capture.write(cap_req, wire.encode_bin_response(scores))
                t_r0 = time.perf_counter()
                ctype, out = encode(scores)
                self._send(200, out, ctype, headers=headers)
                if rid is not None:
                    # The chain's tail; the flow end binds the arrow
                    # from the dispatch step to this span.
                    tracer.emit("serve.respond", t_r0,
                                time.perf_counter() - t_r0,
                                args={"rid": rid, "n": n}, flow=("f", rid))

            def _do_admin(self, path: str, query: str) -> None:
                """``/reload`` swaps in the current checkpoint; only
                ``/reload?keep_prev=1`` keeps the replaced table for
                ``/rollback`` (a plain reload must not pin a second
                table on the card).  ``/promote`` closes the window;
                ``/rollback`` without one is a 409."""
                if scorer is None:
                    self._send(503, b"no admin scorer on this endpoint\n",
                               "text/plain")
                    return
                # Read a (normally empty) body so keep-alive holds.
                if self._read_body(wire.MAX_BODY_BYTES) is None:
                    return
                with admin_lock:
                    try:
                        if path == "/reload":
                            reload_scorer(cfg, scorer,
                                          keep_prev="keep_prev=1" in query)
                            if on_reload is not None:
                                # The skew reference follows the served
                                # checkpoint's manifest.
                                on_reload()
                        elif path == "/promote":
                            scorer.promote()
                            if on_reload is not None:
                                on_reload()
                        elif not scorer.rollback():
                            self._send(
                                409, b"nothing to roll back to (no "
                                     b"keep-prev swap is open)\n",
                                "text/plain")
                            return
                        elif on_rollback is not None:
                            # Back to the pre-canary checkpoint: its
                            # manifest is gone, so the stashed reference
                            # comes back.
                            on_rollback()
                    except ValueError as e:
                        self._send(409, f"{e}\n".encode(), "text/plain")
                        return
                    except Exception as e:  # noqa: BLE001 - report
                        self._send(500, f"{path} failed: {e}\n".encode(),
                                   "text/plain")
                        return
                    body = (json.dumps({"step": scorer.step}) + "\n"
                            ).encode()
                self._send(200, body, "application/json")

            def do_GET(self) -> None:  # noqa: N802 - http.server API
                requests_c.add()
                path = self.path.partition("?")[0]
                if self._get_observability(path, build):
                    return
                self._send(404, b"not found\n", "text/plain")

        self.parse_pool = parse_pool
        if cfg.serve_http_threads > 0:
            self._httpd = PooledHTTPServer(
                (host, port), Handler,
                pool_size=cfg.serve_http_threads,
                acceptors=cfg.serve_http_acceptors,
            )
        else:
            self._httpd = ObsHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tffm-serve-http",
            daemon=True,
        )
        self._thread.start()
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._thread.join()
        self._httpd.server_close()


class ServeHandle:
    """One running serving stack; ``close()`` tears it down in order
    (HTTP stops accepting, the watcher's thread stops, the batcher
    drains and fails what is left, the heartbeat stops, the final record
    is written (naming :attr:`exception` when one stopped the server)
    and ringed, a crash leaves a blackbox bundle, then the capture file
    and the stream close and the trace is written).  ``alert_engine`` is
    the ``alert_rules`` watchdog (None without rules): an embedder polls
    its ``halted``."""

    def __init__(self, cfg: FmConfig, scorer, batcher, server,
                 telemetry: Telemetry, watcher=None, capture=None,
                 writer=None, heartbeat=None, build=None,
                 alert_engine=None, tracer=None, blackbox=None):
        self.cfg = cfg
        self.scorer = scorer
        self.batcher = batcher
        self.server = server
        self.watcher = watcher
        self.capture = capture
        self.telemetry = telemetry
        self.port = server.port
        self.alert_engine = alert_engine
        self.blackbox = blackbox
        self.exception: Optional[BaseException] = None
        self._writer = writer
        self._heartbeat = heartbeat
        self._build = build
        self._tracer = tracer
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.server.close()
        if self.watcher is not None:
            self.watcher.close()
        self.batcher.close()
        if self._heartbeat is not None:
            self._heartbeat.close()
        if self._writer is not None or self.blackbox is not None:
            try:
                final = self._build("final")
                if self.exception is not None:
                    final["exception"] = type(self.exception).__name__
                    final["exception_msg"] = str(self.exception)
                if self._writer is not None:
                    self._writer.write(final)
                if self.blackbox is not None:
                    self.blackbox.observe_record(final)
            except Exception as e:  # noqa: BLE001 - teardown best-effort
                log.warning("serve final record write failed: %s", e)
        # A crash's bundle, before the stream closes so its manifest
        # reaches the stream; a clean close dumps nothing.
        if (self.blackbox is not None and self.exception is not None
                and not isinstance(self.exception, KeyboardInterrupt)):
            self.blackbox.incident("crash_" + type(self.exception).__name__)
        if self.capture is not None:
            self.capture.close()
        if self._writer is not None:
            self._writer.close()
        if self._tracer is not None and self._tracer.enabled:
            try:
                n = self._tracer.dump(self.cfg.trace_file)
                self._tracer.close()
                log.info("serve trace written to %s (%d events)",
                         self.cfg.trace_file, n)
            except Exception as e:  # noqa: BLE001 - teardown best-effort
                log.warning("serve trace dump failed: %s", e)


def _serve_block(snap: dict, scorer, batcher, wall: float) -> dict:
    """The ``serve`` record block: flat, numeric, host-side only —
    rendered as ``tffm_serve_*`` by /metrics."""
    counters = snap.get("counters") or {}
    timers = snap.get("timers") or {}
    gauges = snap.get("gauges") or {}
    lat = timers.get("serve.latency") or {}
    requests = int(counters.get("serve.requests", 0))
    out = {
        "requests": requests,
        "examples": int(counters.get("serve.examples", 0)),
        "batches": int(counters.get("serve.batches", 0)),
        "qps": round(requests / wall, 2) if wall > 0 else 0.0,
        "inflight": int(gauges.get("serve.inflight", 0)),
        "batch_fill": round(batcher.batch_fill, 6),
        "swaps": int(counters.get("serve.swaps", 0)),
        "truncated_features": int(
            counters.get("serve.truncated_features", 0)
        ),
        "warmup_wall_s": round(scorer.warmup_wall_s, 4),
        "kernel_launches": int(fm_kernels.fm_scores_cuda.launches),
        # Which interaction the rungs run (ops/autotune.py): a string,
        # which /metrics skips and the JSONL block keeps.
        "kernel_impl": getattr(scorer, "kernel_impl", "pallas"),
    }
    # Emitted only when the scorer owns the gauges (FixedShapeScorer):
    # the placed table's bytes and the probe's max |score_fp32 -
    # score_quant| (0: fp32, -1: unknown).  The OverlayScorer registers
    # neither.
    if "serve.table_bytes" in gauges:
        out["table_mb"] = round(gauges["serve.table_bytes"] / (1 << 20), 3)
    if "serve.quant_error_max" in gauges:
        out["quant_error_max"] = round(
            float(gauges["serve.quant_error_max"]), 6)
    for key in ("mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms"):
        if key in lat:
            out[key] = lat[key]
    for name, key in (("serve.parse", "parse_p50_ms"),
                      ("serve.parse_bin", "parse_bin_p50_ms"),
                      ("serve.dispatch", "dispatch_p50_ms"),
                      ("serve.overlay_gather", "overlay_gather_p50_ms")):
        snap_t = timers.get(name) or {}
        if "p50_ms" in snap_t:
            out[key] = snap_t["p50_ms"]
    return out


def serve(cfg: FmConfig,
          device: Optional[Union[str, torch.device]] = None,
          port: Optional[int] = None) -> ServeHandle:
    """Build and start the serving stack from a config, on ``device``
    (the GPU unless asked otherwise).  ``port`` overrides
    ``cfg.serve_port`` (0 = OS-assigned; the bound port is
    ``handle.port``)."""
    _warn_inert(cfg)
    dev = resolve_device(device)
    telemetry = Telemetry(enabled=cfg.telemetry)
    # Per-request tracing (serve_trace_sample); trace_file unset: the
    # shared no-op tracer.
    tracer = (Tracer(enabled=True, process_name="serve",
                     rotate_events=cfg.trace_rotate_events,
                     rotate_path=cfg.trace_file or None)
              if cfg.trace_file else NULL_TRACER)
    # Training-to-serving skew: live requests against the reference the
    # trainer published beside the served checkpoint.
    skew = None
    if cfg.quality:
        def _read_skew_reference(_model=cfg.model_file):
            man = read_manifest(_model)
            if not isinstance(man, dict) or "quality" not in man:
                return None
            return {"step": man.get("step", -1), **man["quality"]}

        skew = ServeSkewMonitor(window_examples=cfg.quality_window,
                                telemetry=telemetry,
                                read_reference=_read_skew_reference)
        skew.reload_reference()
    # The watcher's baseline is read BEFORE the load: a checkpoint
    # published while the scorer loads and warms up must look new to the
    # first poll.
    manifest_baseline = read_manifest(cfg.model_file)
    # Opened before the scorer, which writes its interaction decision
    # (`record: autotune`) into it.
    writer = JsonlWriter(cfg.metrics_file) if cfg.metrics_file else None
    try:
        scorer = scorer_lib.make_scorer(cfg, device=dev,
                                        telemetry=telemetry, writer=writer)
        n_rungs = scorer.warmup()
    except BaseException:
        if writer is not None:
            writer.close()
        tracer.close()
        raise
    log.info(
        "scorer ready on %s: checkpoint step %d, ladder %s, %d rung(s) "
        "warmed in %.3fs", dev, scorer.step, list(scorer.ladder), n_rungs,
        scorer.warmup_wall_s,
    )
    slo = SloTracker(
        cfg.serve_slo_p99_ms, cfg.serve_slo_availability,
        telemetry=telemetry,
    )
    batcher = ServeBatcher(
        scorer, max_batch_wait_ms=cfg.max_batch_wait_ms,
        queue_size=cfg.queue_size, telemetry=telemetry, slo=slo,
        tracer=tracer, quality=skew,
    )
    # Live-traffic capture: FmConfig guarantees both knobs are set
    # together; unset = None = byte-identical serving.
    capture = None
    if cfg.serve_capture_file:
        capture = wire.CaptureWriter(
            cfg.serve_capture_file, sample=cfg.serve_capture_sample,
            telemetry=telemetry,
        )
    t0 = time.time()

    def build(kind: str = "status") -> dict:
        now = time.time()
        wall = max(now - t0, 1e-9)
        # The SLO gauges refresh before the snapshot, so one scrape's
        # gauges and block keys agree.
        slo_block = slo.snapshot()
        skew_block = (skew.block(force=(kind == "final"))
                      if skew is not None else {})
        snap = telemetry.snapshot()
        serve_block = _serve_block(snap, scorer, batcher, wall)
        serve_block.update(slo_block)
        serve_block.update(skew_block)
        rec = {
            "record": kind,
            "time": now,
            "elapsed": round(wall, 3),
            "step": scorer.step,
            "serve": serve_block,
            "stages": snap,
        }
        if cfg.resource_metrics:
            rec["resource"] = basic_block(t0)
        if alert_engine is not None:
            rec["alerts"] = alert_engine.active_snapshot()
        if tracer.enabled:
            rec["trace_dropped_events"] = tracer.dropped_events
            if cfg.trace_rotate_events:
                rec["trace_windows"] = tracer.windows_written
        return rec

    run_header = {
            "record": "run_header",
            "mode": "serve",
            "time": t0,
            "model_file": cfg.model_file,
            "resume_step": scorer.step,
            "serve_batch_sizes": list(scorer.ladder),
            "max_batch_wait_ms": cfg.max_batch_wait_ms,
            "serve_poll_secs": cfg.serve_poll_secs,
            "serve_transport": cfg.serve_transport,
            "serve_parse_mode": cfg.serve_parse_mode,
            "serve_http_threads": cfg.serve_http_threads,
            "serve_http_acceptors": cfg.serve_http_acceptors,
            "serve_request_queue_size": ObsHTTPServer.request_queue_size,
            "batch_size": cfg.batch_size,
            "telemetry": cfg.telemetry,
            "heartbeat_secs": cfg.heartbeat_secs,
            "alert_rules": cfg.alert_rules,
            "torch_version": torch.__version__,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "serve_capture_sample": cfg.serve_capture_sample,
            "quality": cfg.quality,
            "blackbox": cfg.blackbox,
    }
    if writer is not None:
        writer.write(run_header)
    # The flight recorder: the pid suffix keeps replicas sharing one
    # incident_dir apart.
    blackbox = None
    if cfg.blackbox:
        blackbox = Blackbox(
            cfg.incident_dir or os.path.join(cfg.model_file, "incidents"),
            suffix=f"pid{os.getpid()}", run_header=run_header,
            metrics_render=lambda: render_prometheus(build("status")),
            trace_tail_fn=tracer.tail if tracer.enabled else None,
            capture_tail_fn=(capture.tail_bytes if capture is not None
                             else None),
            writer=writer, telemetry=telemetry)
    # Alert watchdog on the serve heartbeat (FmConfig guarantees
    # heartbeat_secs > 0 when rules are set): breaches write `record:
    # alert` and reach the blackbox; a halt rule arms
    # alert_engine.halted, which serve_forever raises.
    alert_engine = (AlertEngine(
        parse_rules(cfg.alert_rules), writer=writer,
        on_alert=blackbox.on_alert if blackbox is not None else None)
        if cfg.alert_rules else None)

    def heartbeat_build():
        rec = build("heartbeat")
        # Ringed before the rules see it: an alert's bundle holds the
        # record that tripped it.
        if blackbox is not None:
            blackbox.observe_record(rec)
        if alert_engine is not None:
            alert_engine.observe(rec)
        return rec

    heartbeat = (Heartbeat(cfg.heartbeat_secs, heartbeat_build, writer=writer)
                 if cfg.heartbeat_secs > 0 else None)
    watcher = None
    try:
        if cfg.serve_poll_secs > 0:
            watcher = CheckpointWatcher(
                cfg, scorer, cfg.serve_poll_secs, seen=manifest_baseline,
                on_swap=((lambda step: skew.reload_reference())
                         if skew is not None else None))
        server = ServeServer(
            cfg.serve_port if port is None else port, batcher, cfg,
            build, telemetry, host=cfg.serve_host, scorer=scorer,
            slo=slo, capture=capture, tracer=tracer,
            on_reload=skew.reload_reference if skew is not None else None,
            on_rollback=(skew.restore_previous_reference
                         if skew is not None else None),
            incident=blackbox.incident if blackbox is not None else None,
        )
    except BaseException:
        # A taken port must not leak the watcher's, the batcher's or the
        # heartbeat's thread, or the capture file and the stream.
        if watcher is not None:
            watcher.close()
        batcher.close()
        if heartbeat is not None:
            heartbeat.close()
        if capture is not None:
            capture.close()
        if writer is not None:
            writer.close()
        tracer.close()
        raise
    log.info(
        "scoring endpoint listening on %s:%d (POST /score, /score_bin, "
        "/reload, /promote, /rollback; GET /metrics, /status, /healthz)",
        cfg.serve_host, server.port,
    )
    return ServeHandle(cfg, scorer, batcher, server, telemetry,
                       watcher=watcher, capture=capture, writer=writer,
                       heartbeat=heartbeat, build=build,
                       alert_engine=alert_engine, tracer=tracer,
                       blackbox=blackbox)


def serve_forever(cfg: FmConfig,
                  device: Optional[Union[str, torch.device]] = None) -> int:
    """CLI entry: serve until interrupted.  SIGTERM and SIGINT both
    close cleanly (the final record is written); an armed ``action:
    halt`` alert rule stops the server with a final record naming
    :class:`AlertHaltError` and exit code 1."""
    handle = serve(cfg, device=device)
    print(f"serving on {cfg.serve_host}:{handle.port}", flush=True)

    def _sigterm(signum, frame):  # pragma: no cover - signal path
        raise KeyboardInterrupt

    prev = signal.signal(signal.SIGTERM, _sigterm)
    code = 0
    try:
        run_until_halt(handle.alert_engine)
    except KeyboardInterrupt:
        log.info("interrupted; shutting down the scoring endpoint")
    except AlertHaltError as e:
        log.error("HALT: %s", e)
        handle.exception = e
        code = 1
    finally:
        handle.close()
        signal.signal(signal.SIGTERM, prev)
    return code
