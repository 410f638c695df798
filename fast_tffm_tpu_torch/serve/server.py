"""The scoring endpoint: HTTP front door and lifecycle.

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
- ``GET /metrics`` / ``/status`` / ``/healthz`` (and ``/debug/threadz``)
  — the observability routes; all ``serve.*`` instruments plus a
  ``serve`` record block show up as ``tffm_serve_*`` series.

:func:`serve` builds the stack from an :class:`FmConfig` (scorer ->
warmup -> batcher -> HTTP) and returns a :class:`ServeHandle`;
:func:`serve_forever` is the CLI entry.  Settings that would change the
result or need a later slice of the port raise NotImplementedError
naming the ROADMAP.md item; observability planes that never touch a
score (metrics stream, heartbeat, trace, alerts, skew, blackbox) are
not wired yet and are logged as inert when set.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs.status import (
    ObsHTTPServer, PooledHTTPServer, QuietHandler,
)
from fast_tffm_tpu_torch.obs.telemetry import Telemetry
from fast_tffm_tpu_torch.ops import fm_kernels
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.serve import scorer as scorer_lib
from fast_tffm_tpu_torch.serve import wire
from fast_tffm_tpu_torch.serve.batcher import ServeBatcher
from fast_tffm_tpu_torch.serve.textparse import (
    ParseScratchPool, parse_request,
)

log = logging.getLogger(__name__)

__all__ = ["ServeHandle", "ServeServer", "serve", "serve_forever"]

# Settings whose non-default value the port's server does not act on yet:
# none of them changes a score (ROADMAP.md, port queue item 4).
_INERT_KNOBS = (
    "metrics_file", "heartbeat_secs", "trace_file", "trace_rotate_events",
    "alert_rules", "serve_trace_sample", "serve_slo_p99_ms",
    "serve_slo_availability", "incident_dir", "compile_cache_dir",
    "interaction_impl",
)


def _check_supported(cfg: FmConfig) -> None:
    """Refuse settings that would change the result or need a later
    slice of the port, naming the ROADMAP.md port-queue item."""
    unported = []
    if cfg.serve_replicas >= 2:
        unported.append(("serve_replicas >= 2 (router and fleet)", 4))
    if cfg.serve_poll_secs > 0:
        unported.append((
            "serve_poll_secs > 0 (checkpoint hot-swap watcher; set "
            "serve_poll_secs = 0)", 4,
        ))
    if cfg.serve_canary:
        unported.append(("serve_canary (canary promotion)", 4))
    if cfg.serve_capture_file:
        unported.append(("serve_capture_file (traffic capture)", 4))
    if unported:
        what = "; ".join(
            f"{name} is ROADMAP.md port queue item {item}"
            for name, item in unported
        )
        raise NotImplementedError(
            f"not in the PyTorch port yet: {what}"
        )
    defaults = FmConfig()
    inert = [
        k for k in _INERT_KNOBS
        if getattr(cfg, k) != getattr(defaults, k)
    ]
    if inert:
        log.warning(
            "the PyTorch port's server does not act on %s yet (ROADMAP.md "
            "port queue item 4); scores are unaffected", ", ".join(inert),
        )


class ServeServer:
    """HTTP front door: ``POST /score`` (libsvm text), ``POST
    /score_bin`` (the binary frame transport, gated by
    ``serve_transport``) and the observability routes."""

    def __init__(self, port: int, batcher: ServeBatcher, cfg: FmConfig,
                 build, telemetry: Telemetry, host: str = "127.0.0.1",
                 timeout_s: float = 30.0):
        requests_c = telemetry.counter("serve.http_requests")
        truncated_c = telemetry.counter("serve.truncated_features")
        parse_t = telemetry.timer("serve.parse")
        parse_bin_t = telemetry.timer("serve.parse_bin")
        # Recycled per-request parse scratch: the text path's arrays
        # come from here and go back via the batcher's on_done hook.
        parse_pool = ParseScratchPool(cfg.max_features, telemetry=telemetry)

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
                path = self.path.partition("?")[0]
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
                try:
                    scores = batcher.score(
                        ids, vals, fields if cfg.field_num else None,
                        timeout=timeout_s, on_done=on_done,
                    )
                except Exception as e:  # noqa: BLE001 - report, don't die
                    self._send(
                        503, f"scoring failed: {e}\n".encode(),
                        "text/plain", headers=headers,
                    )
                    return
                ctype, out = encode(scores)
                self._send(200, out, ctype, headers=headers)

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
    (HTTP stops accepting, then the batcher drains and fails what is
    left)."""

    def __init__(self, cfg: FmConfig, scorer, batcher, server,
                 telemetry: Telemetry):
        self.cfg = cfg
        self.scorer = scorer
        self.batcher = batcher
        self.server = server
        self.telemetry = telemetry
        self.port = server.port
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.server.close()
        self.batcher.close()


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
    _check_supported(cfg)
    dev = resolve_device(device)
    telemetry = Telemetry(enabled=cfg.telemetry)
    scorer = scorer_lib.make_scorer(cfg, device=dev, telemetry=telemetry)
    n_rungs = scorer.warmup()
    log.info(
        "scorer ready on %s: checkpoint step %d, ladder %s, %d rung(s) "
        "warmed in %.3fs", dev, scorer.step, list(scorer.ladder), n_rungs,
        scorer.warmup_wall_s,
    )
    batcher = ServeBatcher(
        scorer, max_batch_wait_ms=cfg.max_batch_wait_ms,
        queue_size=cfg.queue_size, telemetry=telemetry,
    )
    t0 = time.time()

    def build(kind: str = "status") -> dict:
        now = time.time()
        wall = max(now - t0, 1e-9)
        snap = telemetry.snapshot()
        return {
            "record": kind,
            "time": now,
            "elapsed": round(wall, 3),
            "step": scorer.step,
            "serve": _serve_block(snap, scorer, batcher, wall),
            "stages": snap,
        }

    try:
        server = ServeServer(
            cfg.serve_port if port is None else port, batcher, cfg,
            build, telemetry, host=cfg.serve_host,
        )
    except BaseException:
        # A taken port must not leak the batcher's dispatcher thread.
        batcher.close()
        raise
    log.info(
        "scoring endpoint listening on %s:%d (POST /score, /score_bin; "
        "GET /metrics, /status, /healthz)", cfg.serve_host, server.port,
    )
    return ServeHandle(cfg, scorer, batcher, server, telemetry)


def serve_forever(cfg: FmConfig,
                  device: Optional[Union[str, torch.device]] = None) -> int:
    """CLI entry: serve until interrupted.  SIGTERM and SIGINT both
    close cleanly."""
    handle = serve(cfg, device=device)
    print(f"serving on {cfg.serve_host}:{handle.port}", flush=True)

    def _sigterm(signum, frame):  # pragma: no cover - signal path
        raise KeyboardInterrupt

    prev = signal.signal(signal.SIGTERM, _sigterm)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        log.info("interrupted; shutting down the scoring endpoint")
    finally:
        handle.close()
        signal.signal(signal.SIGTERM, prev)
    return 0
