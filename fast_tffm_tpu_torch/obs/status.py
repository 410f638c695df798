"""HTTP plumbing the scoring endpoint mounts: the server classes, the
shared handler base and the Prometheus renderer.

The PyTorch port's own copy of the serving-side parts of
``fast_tffm_tpu/obs/status.py`` (stdlib only):

- :class:`ObsHTTPServer` / :class:`PooledHTTPServer` — the
  thread-per-connection and fixed-worker-pool HTTP servers;
- :class:`QuietHandler` — silenced access log, the one response helper,
  the bounded body reader and the shared ``/healthz``, ``/metrics``,
  ``/status`` and ``/debug/threadz`` routes;
- :func:`render_prometheus` — one record as Prometheus text exposition.

The trainer's ``StatusServer`` and the ``/incident`` route are not in the
port yet.
"""

from __future__ import annotations

import json
import queue
import re
import select
import socket
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = [
    "ObsHTTPServer", "PooledHTTPServer", "QuietHandler",
    "probe_reuseport", "render_prometheus", "thread_dump",
]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitize a dotted instrument name into a Prometheus metric name
    (``ingest.out_q_depth`` -> ``ingest_out_q_depth``)."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


_LABEL_ESC = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _label_value(v) -> str:
    return "".join(_LABEL_ESC.get(ch, ch) for ch in str(v))


def thread_dump() -> str:
    """One text block per live thread: name/ident/daemon + its current
    stack (``sys._current_frames``).  Pure stdlib, read-only, safe to
    call from a request handler at any time — the tool you want when a
    multi-thread pipeline stops making progress."""
    frames = sys._current_frames()
    lines = []
    for t in sorted(threading.enumerate(), key=lambda t: t.name):
        lines.append(
            f"--- thread {t.name!r} (ident={t.ident}, "
            f"daemon={t.daemon}, alive={t.is_alive()}) ---"
        )
        frame = frames.get(t.ident)
        if frame is None:
            lines.append("  <no frame (not started or already gone)>")
        else:
            lines.extend(
                ln.rstrip("\n")
                for ln in traceback.format_stack(frame)
            )
        lines.append("")
    return "\n".join(lines) + "\n"


def render_prometheus(record: dict) -> str:
    """Render one heartbeat-shaped record as Prometheus text exposition.

    Layout (all names prefixed ``tffm_``):

    - record scalars -> gauges (``tffm_step``, ``tffm_ingest_wait_frac``);
    - ``stages.counters`` -> ``tffm_counter_<name>_total`` counters;
    - ``stages.gauges`` -> ``tffm_gauge_<name>`` gauges;
    - ``stages.timers`` -> ``tffm_timer_<name>_count`` /
      ``_seconds_total`` counters + ``_p50_ms``/``_p95_ms``/``_p99_ms``
      /``_max_ms``/``_mean_ms`` gauges (the percentiles describe the
      recent ring — see telemetry.Timing) + the ``_window_count``
      gauge naming how many ring samples those percentiles summarize;
    - ``stages.depths`` -> ``tffm_depth_<name>_events_total`` /
      ``_mean`` / ``_max`` plus per-band ``_bucket{band="1-3"}`` gauges
      (occupancy bands, not cumulative ``le`` buckets);
    - ``health.*`` -> ``tffm_health_<key>`` gauges;
    - ``tiered.*`` -> ``tffm_tiered_<key>`` gauges;
    - ``resource.*`` -> ``tffm_resource_<key>`` gauges (RSS, component
      byte ledger, compile counters, FLOPs attribution);
    - ``serve.*`` -> ``tffm_serve_<key>`` gauges (qps, latency
      percentiles, batch fill, steady_compiles — the serving
      endpoint's record block, including the ``skew_*`` keys as
      ``tffm_serve_skew_*``);
    - ``quality.*`` -> ``tffm_quality_<key>`` gauges (windowed online
      eval + drift signals — the model-quality record block);
    - ``build_info`` (a dict of strings) -> one ``tffm_build_info``
      info-style gauge whose LABELS carry the run identity (jax
      version, backend, mesh, K), value always 1 — the Prometheus
      idiom for making every scrape self-identifying across runs.
    """
    lines: list = []

    def emit(name: str, value, mtype: str = "gauge", help_: str = "",
             labels: str = "") -> None:
        if not _num(value):
            return
        if help_:
            lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{labels} {value}")

    for key, val in record.items():
        if _num(val):
            emit(f"tffm_{_prom_name(key)}", val,
                 help_="record scalar from the live status snapshot")
    stages = record.get("stages") or {}
    for name, val in sorted((stages.get("counters") or {}).items()):
        emit(f"tffm_counter_{_prom_name(name)}_total", val, "counter")
    for name, val in sorted((stages.get("gauges") or {}).items()):
        emit(f"tffm_gauge_{_prom_name(name)}", val)
    for name, snap in sorted((stages.get("timers") or {}).items()):
        base = f"tffm_timer_{_prom_name(name)}"
        emit(f"{base}_count", snap.get("count", 0), "counter")
        emit(f"{base}_seconds_total", snap.get("total_s", 0.0), "counter")
        if "window_n" in snap:
            # Sample-count companion of the percentile gauges: how many
            # ring samples p50/p95/p99 summarize — a p99 over 3 samples
            # must be distinguishable from one over 30k.
            emit(f"{base}_window_count", snap["window_n"])
        for pkey in ("mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms"):
            if pkey in snap:
                emit(f"{base}_{pkey}", snap[pkey])
    for name, snap in sorted((stages.get("depths") or {}).items()):
        if not snap.get("count"):
            continue
        base = f"tffm_depth_{_prom_name(name)}"
        emit(f"{base}_events_total", snap["count"], "counter")
        emit(f"{base}_mean", snap.get("mean", 0.0))
        emit(f"{base}_max", snap.get("max", 0))
        buckets = snap.get("buckets") or {}
        if buckets:
            lines.append(f"# TYPE {base}_bucket gauge")
            for band, n in buckets.items():
                lines.append(f'{base}_bucket{{band="{band}"}} {n}')
    for block in ("health", "tiered", "resource", "serve", "quality",
                  "fleet", "alerts"):
        for key, val in sorted((record.get(block) or {}).items()):
            emit(f"tffm_{block}_{_prom_name(key)}", val)
    # The alerts block's per-rule state renders as one labeled gauge per
    # armed rule — the live-breach surface a Prometheus scrape needs
    # (the JSONL stream only shows the breach EDGE, not the episode).
    rules = (record.get("alerts") or {}).get("rules") or []
    if rules:
        lines.append("# HELP tffm_alert_active 1 while the rule's "
                     "breach episode is live (0 = armed and quiet)")
        lines.append("# TYPE tffm_alert_active gauge")
        for rule in rules:
            lines.append(
                f'tffm_alert_active{{rule="'
                f'{_label_value(rule.get("rule", ""))}"}} '
                f'{int(rule.get("active") or 0)}'
            )
    info = record.get("build_info")
    if isinstance(info, dict) and info:
        labels = ",".join(
            f'{_prom_name(str(k))}="{_label_value(v)}"'
            for k, v in sorted(info.items())
        )
        lines.append("# HELP tffm_build_info run identity labels "
                     "(value is always 1)")
        lines.append("# TYPE tffm_build_info gauge")
        lines.append(f"tffm_build_info{{{labels}}} 1")
    return "\n".join(lines) + "\n"


class ObsHTTPServer(ThreadingHTTPServer):
    """The HTTP server every in-process endpoint mounts: handler
    threads are daemons (an endpoint must never pin process exit), and
    the accept backlog is deep — socketserver's default of 5 turns a
    connection SPIKE into dropped SYNs and ~1 s retransmit latency
    cliffs, the exact failure mode the serving router's burst probe
    measures."""

    daemon_threads = True
    request_queue_size = 128


def probe_reuseport() -> bool:
    """True when this platform both DEFINES ``SO_REUSEPORT`` and
    accepts it on a stream socket (the constant exists on some kernels
    that still reject the setsockopt) — the feature probe behind
    ``PooledHTTPServer``'s multi-listener mode.  Pure capability check:
    binds nothing."""
    if not hasattr(socket, "SO_REUSEPORT"):
        return False
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        return True
    except OSError:
        return False


class PooledHTTPServer(ObsHTTPServer):
    """:class:`ObsHTTPServer` with a FIXED pool of persistent handler
    workers instead of a thread spawn per connection.

    Thread-per-connection pays a spawn + teardown on every accepted
    socket and funnels every accept through the one ``serve_forever``
    loop; under the router's burst traffic both show up directly in
    ``serve_burst_p99_x``.  Here accepted connections land in a bounded
    hand-off queue and ``pool_size`` long-lived workers serve them —
    the router's backend connection pool lands on warm handlers, and a
    connection spike backpressures into the TCP backlog (blocking
    ``put``) instead of spawning unbounded threads.

    ``acceptors > 1`` adds N-1 extra accept loops.  When the kernel
    supports ``SO_REUSEPORT`` (:func:`probe_reuseport`), each extra
    loop gets its OWN listener socket bound to the same address — the
    kernel load-balances connections across listeners and the accept
    path stops serializing on one socket lock.  Portable fallback:
    the extra loops ``accept()`` on the shared primary socket.  The
    effective mode is published as ``self.reuseport``.

    Keep-alive interacts with pooling the obvious way: a kept-alive
    connection HOLDS its worker until the peer closes or the 60 s
    handler socket timeout fires (exactly like a handler thread did,
    but now from a finite pool) — so ``pool_size`` must cover the
    expected concurrent kept-alive connections; SERVING.md has the
    sizing rule.  The request-level discipline (60 s timeout,
    keep-alive, TCP_NODELAY, Content-Length) is the handler class's
    and is untouched.

    ``server_close()`` tears the whole shape down deterministically:
    stops the accept loops, drops queued-but-unserved connections
    (a queued slow peer must not pin close for its socket timeout),
    aborts in-flight reads with ``SHUT_RDWR``, then joins every worker
    and acceptor — zero leaked threads, pinned by test and the TL007
    lint rule.
    """

    def __init__(self, server_address, RequestHandlerClass,
                 pool_size: int = 8, acceptors: int = 1,
                 bind_and_activate: bool = True):
        self.pool_size = max(1, int(pool_size))
        self.acceptors = max(1, int(acceptors))
        self.reuseport = False
        self._stop_accept = threading.Event()
        self._pool_closed = False
        self._active: set = set()
        self._active_lock = threading.Lock()
        self._conn_q: queue.Queue = queue.Queue(
            maxsize=max(32, 2 * self.pool_size)
        )
        self._extra_socks: list = []
        self._acceptors: list = []
        self._workers = [
            threading.Thread(
                target=self._worker, name=f"tffm-http-worker-{i}",
                daemon=True,
            )
            for i in range(self.pool_size)
        ]
        # server_bind (called by super().__init__) reads self.acceptors
        # to decide on SO_REUSEPORT, so state init precedes it.
        super().__init__(server_address, RequestHandlerClass,
                         bind_and_activate=bind_and_activate)
        for t in self._workers:
            t.start()
        if bind_and_activate:
            self._start_extra_acceptors()

    # -- accept side ---------------------------------------------------

    def server_bind(self) -> None:
        if self.acceptors > 1 and probe_reuseport():
            try:
                self.socket.setsockopt(
                    socket.SOL_SOCKET, socket.SO_REUSEPORT, 1
                )
                self.reuseport = True
            except OSError:
                self.reuseport = False
        super().server_bind()

    def _start_extra_acceptors(self) -> None:
        for i in range(self.acceptors - 1):
            sock = self.socket
            if self.reuseport:
                try:
                    s = socket.socket(
                        self.address_family, self.socket_type
                    )
                    s.setsockopt(
                        socket.SOL_SOCKET, socket.SO_REUSEPORT, 1
                    )
                    # server_address is the RESOLVED one (port-0 safe).
                    s.bind(self.server_address)
                    s.listen(self.request_queue_size)
                    self._extra_socks.append(s)
                    sock = s
                except OSError:
                    sock = self.socket  # shared-socket fallback
            t = threading.Thread(
                target=self._accept_loop, args=(sock,),
                name=f"tffm-http-accept-{i + 1}", daemon=True,
            )
            self._acceptors.append(t)
            t.start()

    def _accept_loop(self, sock) -> None:
        """One extra acceptor: select (so shutdown is prompt) ->
        accept -> the same verify/process contract as BaseServer's
        ``_handle_request_noblock``."""
        while not self._stop_accept.is_set():
            try:
                ready, _, _ = select.select([sock], [], [], 0.5)
            except OSError:
                break  # socket closed under us: shutting down
            if not ready:
                continue
            try:
                request, client_address = sock.accept()
            except OSError:
                continue
            if self.verify_request(request, client_address):
                try:
                    self.process_request(request, client_address)
                except Exception:  # noqa: BLE001 - keep accepting
                    self.handle_error(request, client_address)
                    self.shutdown_request(request)
            else:
                self.shutdown_request(request)

    def process_request(self, request, client_address) -> None:
        """Hand the accepted connection to the pool.  The put BLOCKS
        when every worker is busy and the queue is full — backpressure
        lands in the TCP backlog, which is the overload surface the
        router's shed discipline already reasons about."""
        self._conn_q.put((request, client_address))

    # -- worker side ---------------------------------------------------

    def _worker(self) -> None:
        while True:
            item = self._conn_q.get()
            if item is None:
                return
            request, client_address = item
            with self._active_lock:
                if self._pool_closed:
                    # Raced server_close's drain: drop, don't serve.
                    dropped = True
                else:
                    self._active.add(request)
                    dropped = False
            if dropped:
                self._shutdown_quiet(request)
                continue
            try:
                self.finish_request(request, client_address)
            except Exception:  # noqa: BLE001 - mirror ThreadingMixIn
                self.handle_error(request, client_address)
            finally:
                with self._active_lock:
                    self._active.discard(request)
                self._shutdown_quiet(request)

    def _shutdown_quiet(self, request) -> None:
        try:
            self.shutdown_request(request)
        except OSError:
            pass

    # -- teardown ------------------------------------------------------

    def shutdown(self) -> None:
        self._stop_accept.set()
        super().shutdown()

    def server_close(self) -> None:
        # Belt and braces: owners call shutdown() first, but a server
        # whose serve_forever never ran is closed without it (and
        # BaseServer.shutdown would block forever there).
        self._stop_accept.set()
        super().server_close()
        for s in self._extra_socks:
            try:
                s.close()
            except OSError:
                pass
        # Acceptors exit promptly: sockets are closed and the stop
        # event is set; a put-blocked acceptor unblocks because the
        # workers below keep draining until their sentinel.
        with self._active_lock:
            self._pool_closed = True
            active = list(self._active)
        while True:
            try:
                item = self._conn_q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._shutdown_quiet(item[0])
        for request in active:
            # Abort in-flight reads so a worker parked in a blocking
            # recv (kept-alive idle, slow peer) wakes NOW instead of
            # at its socket timeout.  The worker still owns the close.
            try:
                request.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for _ in self._workers:
            self._conn_q.put(None)
        for t in self._workers:
            t.join()
        for t in self._acceptors:
            t.join()


class QuietHandler(BaseHTTPRequestHandler):
    """Shared handler base for the in-process endpoints (this status
    server and the serving endpoint): silenced access log, the one
    response helper, and the common observability GET routes — so the
    surface both endpoints promise lives in one place."""

    # Keep-alive: every response carries Content-Length (see _send), so
    # HTTP/1.1 is safe and spares latency-critical clients a TCP
    # connect + handler-thread spawn per request.
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY on every accepted connection: the response is two
    # writes (buffered headers, then the body through the unbuffered
    # wfile), and with Nagle on, the body write stalls behind the
    # peer's delayed ACK of the headers segment — measured as a flat
    # ~40 ms p50 on kept-alive connections (the router's proxy path),
    # which is 10x the whole scoring dispatch.
    disable_nagle_algorithm = True
    # Socket timeout: a peer that stalls mid-read (short body behind a
    # larger Content-Length, half-open connection) must release the
    # handler thread instead of pinning it forever.
    timeout = 60

    def log_message(self, *args) -> None:  # quiet access log
        pass

    def _send(self, code: int, body: bytes, ctype: str,
              headers: Optional[dict] = None,
              keep_alive: bool = False) -> None:
        if code >= 400 and not keep_alive:
            # Error paths may not have consumed the request body; a
            # kept-alive connection would misparse the leftover bytes
            # as the next request.  A caller that DID consume the body
            # passes keep_alive=True — the router's 429 shed path
            # does, because tearing down TCP connections is exactly
            # the wrong reflex under overload (every shed would force
            # a reconnect storm).
            self.close_connection = True
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for key, val in (headers or {}).items():
            self.send_header(key, val)
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self, max_bytes: int) -> Optional[bytes]:
        """Read a POST body per ``Content-Length``; returns the bytes,
        or None with the error response ALREADY SENT.  The length is
        untrusted input on an unauthenticated endpoint: absent -> 411
        (a chunked body is unreadable by length and answering 200-empty
        would silently drop the request), malformed or negative -> 400
        (a negative length would read-to-EOF, pinning the handler
        thread until the client hangs up), over ``max_bytes`` -> 413."""
        if "Content-Length" not in self.headers:
            self._send(
                411, b"Content-Length required (chunked transfer is "
                     b"not supported)\n", "text/plain",
            )
            return None
        try:
            length = int(self.headers["Content-Length"])
        except ValueError:
            self._send(400, b"bad Content-Length\n", "text/plain")
            return None
        if length < 0:
            self._send(400, b"bad Content-Length\n", "text/plain")
            return None
        if length > max_bytes:
            self._send(
                413, f"request body over the {max_bytes >> 20} MiB "
                     f"cap; split it\n".encode(), "text/plain",
            )
            return None
        return self.rfile.read(length)

    def _get_observability(self, path: str, build) -> bool:
        """Answer the shared routes (``/healthz``, ``/debug/threadz``,
        ``/metrics``, ``/status``); returns False for anything else so
        the subclass can dispatch its own.  ``build`` is the owner's
        on-demand record callable; its failures degrade to 500 — an
        observability endpoint reports errors, it never dies of them."""
        if path == "/healthz":
            self._send(200, b"ok\n", "text/plain")
            return True
        if path == "/debug/threadz":
            self._send(200, thread_dump().encode(), "text/plain")
            return True
        if path not in ("/metrics", "/status"):
            return False
        try:
            record = build() or {}
        except Exception as e:  # noqa: BLE001 - report, don't die
            self._send(
                500, f"status record failed: {e}\n".encode(), "text/plain"
            )
            return True
        if path == "/status":
            self._send(
                200, (json.dumps(record) + "\n").encode(),
                "application/json",
            )
        else:
            self._send(
                200, render_prometheus(record).encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        return True
