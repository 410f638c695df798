"""Scale-out serving: N shared-nothing replicas behind a small router.

``python -m fast_tffm_tpu_torch.cli serve <cfg> --replicas N`` runs N
replica processes, each the port's single-process serving stack
(scorer, batcher and HTTP server of ``serve/server.py``, with its
FmScorer kernel on the card) on an OS-assigned port, behind one router
on ``serve_port``.  All stdlib + numpy: the router process imports
neither torch nor jax; the replicas own the device.

- :class:`ReplicaManager` spawns ``serve_replicas`` replica serve
  subprocesses (each announces its bound port on stdout) and owns their
  teardown (terminate, wait, kill after a grace period) and respawn.
- :class:`ServeRouter` is the HTTP front door on ``serve_port``, doing
  **power-of-two-choices** dispatch: pick two healthy replicas at
  random, send to the one with fewer router-tracked in-flight requests.
  Health comes from the replicas' ``/healthz`` (plus process liveness
  and proxy failures): an unhealthy replica is EVICTED from routing and
  readmitted when it answers again; a request caught on a dying replica
  retries on another.  A died managed replica is relaunched with a
  capped exponential backoff.
- **Overload discipline**: admission control with a per-request
  deadline budget (``serve_shed_deadline_ms``).  The projected queue
  delay is the in-flight requests over the measured completion rate
  (Little's law); a request that could not be answered inside the
  budget is shed with a fast ``429`` + ``Retry-After`` instead of
  queuing, so the p99 of ADMITTED requests stays bounded.
- **Canary promotion** (``serve_canary``): replicas run with their
  manifest watcher OFF; the router watches ``serve_manifest.json``
  itself, reloads ONE replica on a new checkpoint (keeping the replaced
  table restorable), shadow-scores a recent traffic sample on it and on
  a baseline replica, compares the two score distributions with
  ``python -m fast_tffm_tpu_torch.tools.report --compare``, and only
  then rolls the reload across the fleet, or rolls the canary back.

Transport is pass-through: the router proxies ``POST /score`` (libsvm
text) and ``POST /score_bin`` (the binary frame, ``serve/wire.py``)
verbatim over kept-alive connections to each replica.  ``GET
/status``, ``/metrics`` and ``/healthz`` report the router's own
counters, the SLO ledger over every front-door outcome, and the fleet
aggregates of the replicas' scraped ``/status`` blocks.

The PyTorch port's copy of ``fast_tffm_tpu/serve/router.py``.  It
differs in two ways only: the child command is ``-m
fast_tffm_tpu_torch.cli serve``, and ``--device`` reaches every replica
when the fleet was started with one.  Its metrics stream (a
``run_header`` of ``mode: serve_router``, ``heartbeat`` records built by
:meth:`ServeRouter._build`, a ``final`` record at close), its
``alert_rules`` watchdog on the heartbeat (a ``halt`` rule stops
:func:`serve_fleet`), its trace (the front door owns the sampling coin
and the request-id mint: ``serve.admit`` and ``serve.proxy`` spans, the
flow on the rid that the replica's spans continue; written to
``trace_file`` at close, the replicas writing ``trace_file.replicaN``)
and its blackbox (the fleet heartbeats' ring, a bundle on an alert, a
crash or ``POST /incident``) are the reference's.
"""

from __future__ import annotations

import collections
import http.client
import json
import logging
import os
import random
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.obs.alerts import (
    AlertEngine, AlertHaltError, parse_rules, run_until_halt,
)
from fast_tffm_tpu_torch.obs.fleet import MergeSpec, labeled_lines, merge_blocks
from fast_tffm_tpu_torch.obs.heartbeat import Heartbeat, JsonlWriter
from fast_tffm_tpu_torch.obs.blackbox import Blackbox
from fast_tffm_tpu_torch.obs.resource import basic_block
from fast_tffm_tpu_torch.obs.status import (
    ObsHTTPServer, PooledHTTPServer, QuietHandler, render_prometheus,
)
from fast_tffm_tpu_torch.obs.telemetry import NULL, Telemetry
from fast_tffm_tpu_torch.obs.trace import NULL_TRACER, Tracer
from fast_tffm_tpu_torch.serve import wire
from fast_tffm_tpu_torch.serve.slo import SloTracker
from fast_tffm_tpu_torch.train import manifest

log = logging.getLogger(__name__)

__all__ = [
    "FleetHandle", "Replica", "ReplicaManager", "ServeRouter",
    "serve_fleet", "start_fleet",
]

# The checkout's root: children and the canary's compare run `-m
# fast_tffm_tpu_torch...` with it on PYTHONPATH (the parent may have
# found the package through its script directory, which the environment
# does not carry).
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))

# The replica CLI announces its bound port with this exact line
# (server.serve_forever's print) — the manager parses it instead of
# pre-allocating ports, so there is no bind race.
_PORT_RE = re.compile(r"serving on [^\s:]+:(\d+)")

# Longest wait for a replica whose stdout ended without a port to be
# reaped, so that its exit code can be reported (the health loop's
# respawn check waits no longer than this either).
_EXIT_WAIT_S = 5.0

# Consecutive /healthz failures before the health loop evicts (proxy
# failures evict immediately — they already cost a request a retry).
_FAIL_EVICT = 2

# Largest request body the canary shadow-scoring ring retains (bounds
# the ring at maxlen * this many bytes).
_SAMPLE_BODY_MAX = 256 << 10

# Router settings whose non-default value the port does not act on:
# the XLA compile cache has no counterpart (none changes a score); the
# replicas, which get ``compile_cache_dir`` passed through, read and
# write the interaction autotuner's ``autotune_cache.json`` there.
_INERT_KNOBS = ("compile_cache_dir",)


def _child_env() -> dict:
    env = os.environ.copy()
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


class Replica:
    """Router-side state for one backend replica.

    ``proc`` is the managed subprocess (None for an externally-run
    backend, e.g. tests pointing the router at fake replicas).
    ``inflight``/``routed``/``healthy``/``fails``/``quarantined`` are
    guarded by the router's lock.  A QUARANTINED replica is one whose
    params can no longer be trusted (a rejected canary whose rollback
    failed): alive is not enough to readmit it — the health loop skips
    it until a later successful promotion reloads it onto a vetted
    checkpoint.
    """

    __slots__ = ("index", "host", "port", "proc", "inflight", "routed",
                 "healthy", "fails", "quarantined", "respawn_fails",
                 "respawn_pending", "next_respawn_t")

    def __init__(self, index: int, host: str, port: int, proc=None):
        self.index = index
        self.host = host
        self.port = port
        self.proc = proc
        self.inflight = 0
        self.routed = 0
        self.healthy = True
        self.fails = 0
        self.quarantined = False
        # Respawn state (health-loop thread only): the in-flight
        # _ReplicaProc of a relaunch, consecutive failed relaunches,
        # and the earliest monotonic time the next attempt may start.
        self.respawn_fails = 0
        self.respawn_pending = None
        self.next_respawn_t = 0.0

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"


class _ReplicaProc:
    """One spawned replica subprocess: stdout port announcement +
    ordered teardown.  The stdout pipe is drained for the process's
    lifetime so a chatty child can never block on a full pipe."""

    def __init__(self, index: int, cmd: list, env: dict):
        self.index = index
        self.port: Optional[int] = None
        self.ready = threading.Event()
        self.proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
        )
        self._thread = threading.Thread(
            target=self._drain, name=f"tffm-replica-stdout-{index}",
            daemon=True,
        )
        self._thread.start()

    def _drain(self) -> None:
        try:
            for raw in self.proc.stdout:
                if self.port is None:
                    m = _PORT_RE.search(raw.decode("utf-8", "replace"))
                    if m:
                        self.port = int(m.group(1))
                        self.ready.set()
        finally:
            self.ready.set()  # EOF with no port = startup failure

    def close(self, grace_s: float = 10.0) -> None:
        """Terminate and reap; SIGKILL after the grace period.  A
        replica that already died (or was killed externally) just gets
        reaped."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(grace_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        else:
            self.proc.wait()
        self._thread.join()
        if self.proc.stdout is not None:
            self.proc.stdout.close()


# CLI overrides the fleet launcher consumes itself (or forces per
# replica) rather than passing through.  trace_file and
# serve_trace_sample are fleet-level: the launcher re-renders the
# trace path with a per-replica suffix (N replicas dumping to ONE
# path would clobber each other) and pins replica self-sampling OFF —
# the ROUTER is the fleet's front door and owns the sampling decision.
_NO_PASSTHROUGH = {
    "serve_replicas", "serve_port", "serve_host", "serve_canary",
    "serve_poll_secs", "metrics_file", "trace_file",
    "serve_trace_sample", "alert_rules", "serve_capture_file",
}

# Respawn backoff: a died MANAGED replica relaunches after
# min(_RESPAWN_CAP_S, _RESPAWN_BASE_S * 2^k) where k counts consecutive
# failed relaunches (a replica that dies before announcing its port).
# The first death respawns immediately; a crash-looping one backs off
# to the cap.
_RESPAWN_BASE_S = 1.0
_RESPAWN_CAP_S = 30.0


def _passthrough_flags(overrides: Optional[dict]) -> list:
    """Re-render the router invocation's CLI overrides as replica
    flags, so ``serve --replicas 2 --serve_table_dtype int8`` means the
    same thing on every replica as it would single-process."""
    args: list = []
    for key, val in sorted((overrides or {}).items()):
        if key in _NO_PASSTHROUGH or val is None:
            continue
        if key == "telemetry":
            if val is False:
                args.append("--no_telemetry")
            continue
        if key == "resource_metrics":
            if val is False:
                args.append("--no_resource_metrics")
            continue
        if key == "trace_file":
            args += ["--trace", str(val)]
            continue
        flag = "--" + key
        if val is True:
            args.append(flag)
        elif val is not False:
            args += [flag, str(val)]
    return args


def _replica_command(cfg: FmConfig, cfg_path: str, index: int,
                     overrides: Optional[dict],
                     device: Optional[str] = None) -> list:
    cmd = [
        sys.executable, "-m", "fast_tffm_tpu_torch.cli", "serve", cfg_path,
        # --replicas 0 pins the child single-process even when the cfg
        # file itself sets serve_replicas (a fleet must never recurse),
        # and --no_serve_canary force-clears an INI serve_canary so the
        # child doesn't trip its own canary-requires-a-fleet
        # validation.
        "--replicas", "0", "--no_serve_canary",
        "--serve_port", "0", "--serve_host", "127.0.0.1",
        # Canary mode turns the replicas' own manifest watchers OFF —
        # the router drives every swap; otherwise replicas self-swap on
        # their usual poll cadence.
        "--serve_poll_secs",
        "0" if cfg.serve_canary else str(cfg.serve_poll_secs),
        # The router owns trace sampling and the alert watchdog; forced
        # here so INI-configured values cannot leak into the children
        # (same neutralization as --no_serve_canary).
        "--serve_trace_sample", "0",
        "--alert_rules", "",
    ]
    if device is not None:
        cmd += ["--device", str(device)]
    if cfg.metrics_file:
        # One stream per process: N replicas appending to the router's
        # configured path would interleave into garbage.
        cmd += ["--metrics_file", f"{cfg.metrics_file}.replica{index}"]
    if cfg.trace_file:
        # Same one-file-per-process rule for traces.
        cmd += ["--trace", f"{cfg.trace_file}.replica{index}"]
    if cfg.serve_capture_file:
        # Same one-file-per-process rule for TFC1 captures: replicas
        # score (and therefore capture) the traffic, each into its own
        # rotating file; the port's tools/replay.py re-drives any of
        # them.
        cmd += [
            "--serve_capture_file",
            f"{cfg.serve_capture_file}.replica{index}",
        ]
    return cmd + _passthrough_flags(overrides)


def _exit_code(proc, wait_s: float) -> Optional[int]:
    """The exit code of a replica whose stdout ended without a port.  A
    child's stdout closes before the kernel lets its parent reap it, so
    ``poll()`` at that EOF can still say None: wait for the process, at
    most ``min(wait_s, _EXIT_WAIT_S)`` seconds.  None when it is still
    running after that."""
    code = proc.poll()
    if code is None:
        try:
            code = proc.wait(min(wait_s, _EXIT_WAIT_S))
        except subprocess.TimeoutExpired:
            pass
    return code


class ReplicaManager:
    """Spawn and own ``cfg.serve_replicas`` shared-nothing replica
    serve subprocesses.

    Each replica is the full serving stack (``python -m
    fast_tffm_tpu_torch.cli serve`` on an OS-assigned port, on
    ``device``: None is the card); startup blocks until every replica
    announces its port (which serve_forever prints only after the ladder
    is warmed, so a ready replica is a WARM replica).  A replica that
    exits first fails the start with its exit code.  ``close()`` tears
    every process down terminate->wait->kill.
    """

    def __init__(self, cfg: FmConfig, cfg_path: str,
                 overrides: Optional[dict] = None,
                 startup_timeout_s: float = 300.0,
                 device: Optional[str] = None):
        if cfg.serve_replicas < 2:
            raise ValueError(
                "ReplicaManager needs serve_replicas >= 2 (a single "
                "process does not want a router)"
            )
        self._cfg = cfg
        self._cfg_path = cfg_path
        self._overrides = overrides
        self._device = device
        self._env = _child_env()
        self._lock = threading.Lock()
        self._closed = False
        self._procs: list = []
        self.replicas: list = []
        try:
            for i in range(cfg.serve_replicas):
                self._procs.append(_ReplicaProc(i, self._command(i),
                                                self._env))
            deadline = time.time() + startup_timeout_s
            for rp in self._procs:
                rp.ready.wait(max(0.0, deadline - time.time()))
                if rp.port is None:
                    left = max(0.0, deadline - time.time())
                    raise RuntimeError(
                        f"replica {rp.index} did not announce a "
                        f"serving port within {startup_timeout_s:.0f}s "
                        f"(exit code {_exit_code(rp.proc, left)})"
                    )
                self.replicas.append(
                    Replica(rp.index, "127.0.0.1", rp.port, proc=rp.proc)
                )
            log.info(
                "replica fleet up: %s",
                ", ".join(f"#{r.index}@{r.address}" for r in
                          self.replicas),
            )
        except BaseException:
            self.close()
            raise

    def _command(self, index: int) -> list:
        return _replica_command(self._cfg, self._cfg_path, index,
                                self._overrides, device=self._device)

    def respawn(self, index: int):
        """Relaunch replica ``index``'s subprocess.  The dead
        predecessor is reaped first; the fresh :class:`_ReplicaProc` is
        adopted into ``_procs`` immediately (the manager owns every
        child it ever spawned) and returned NON-blocking: the router's
        health loop polls its ``ready``/``port`` and re-points the
        :class:`Replica` at the announced port.  Returns None once the
        manager is closed (a teardown racing a death must not spawn an
        orphan)."""
        with self._lock:
            if self._closed:
                return None
            old = self._procs[index]
            try:
                old.close(grace_s=0.0)  # already dead: reap + join
            except Exception as e:  # noqa: BLE001 - reap best-effort
                log.warning("replica %d reap failed: %s", index, e)
            fresh = _ReplicaProc(index, self._command(index), self._env)
            self._procs[index] = fresh
        log.info("respawning replica %d (pid %d)", index,
                 fresh.proc.pid)
        return fresh

    def close(self) -> None:
        with self._lock:
            self._closed = True
            procs, self._procs = self._procs, []
        for rp in procs:
            try:
                rp.close()
            except Exception as e:  # noqa: BLE001 - teardown best-effort
                log.warning("replica %d teardown failed: %s",
                            rp.index, e)


class _ProxyError(Exception):
    """A connection-level failure talking to a replica (the replica is
    presumed dying; the request is retried elsewhere)."""


class ServeRouter:
    """The HTTP front door: P2C dispatch + overload discipline + the
    canary promotion protocol, over any list of :class:`Replica`."""

    def __init__(self, port: int, replicas, cfg: FmConfig,
                 telemetry=None, host: str = "127.0.0.1",
                 health_secs: float = 0.5,
                 manifest_seen: Optional[dict] = None,
                 proxy_timeout_s: float = 30.0, tracer=None,
                 sampler=None, respawner=None):
        self.cfg = cfg
        # The fleet's front door owns the sampling coin and the
        # request-id mint; no trace_file: the shared no-op tracer.
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._sampler = sampler if sampler is not None else (
            wire.RequestSampler(cfg.serve_trace_sample,
                                enabled=self._tracer.enabled, tag="rt"))
        tel = telemetry if telemetry is not None else NULL
        self._tel = tel
        self._c_requests = tel.counter("serve.router_requests")
        self._c_shed = tel.counter("serve.shed")
        self._c_evictions = tel.counter("serve.evictions")
        self._c_readmissions = tel.counter("serve.readmissions")
        self._c_retries = tel.counter("serve.retries")
        self._c_promotions = tel.counter("serve.canary_promotions")
        self._c_rollbacks = tel.counter("serve.canary_rollbacks")
        self._c_respawns = tel.counter("serve.respawns")
        self._c_scrape_errors = tel.counter("serve.scrape_errors")
        self._g_inflight = tel.gauge("serve.inflight")
        self._t_proxy = tel.timer("serve.proxy")
        self._t_scrape = tel.timer("serve.fleet_scrape")
        self._replicas = list(replicas)
        self._lock = threading.Lock()
        self._rng = random.Random(0xF00D)
        self._deadline_s = cfg.serve_shed_deadline_ms / 1e3
        self._proxy_timeout_s = proxy_timeout_s
        # SLO ledger: every front-door outcome (admitted latency +
        # status, sheds, no-replica 503s) -> rolling burn rate.
        self._slo = SloTracker(
            cfg.serve_slo_p99_ms, cfg.serve_slo_availability,
            telemetry=tel,
        )
        # Respawn policy: relaunch died MANAGED replicas (callable
        # index -> _ReplicaProc-shaped handle, normally
        # ReplicaManager.respawn).  None = evict only (unmanaged
        # host:port replicas always are).
        self._respawner = respawner
        # Completion timestamps inside a sliding window: the measured
        # service rate the admission budget divides by (Little's law).
        self._rate_window_s = 1.0
        self._completions: collections.deque = collections.deque()
        # Idle kept-alive connections per replica index.
        self._conns: dict = {r.index: [] for r in self._replicas}
        # Latest per-replica /status scrape: index -> (wall time,
        # serve block dict).  The health loop doubles as the fleet
        # metrics scraper; /metrics re-exposes these as fleet
        # aggregates + per-replica labeled series.
        self._scrapes: dict = {}
        # Recent request bodies, the canary shadow-scoring sample.
        self._sample: collections.deque = collections.deque(maxlen=32)
        self._health_secs = max(0.05, float(health_secs))
        self.step = int((manifest_seen or {}).get("step", 0))
        # start_fleet mounts these after construction, when asked for.
        self.alert_engine = None
        self.blackbox = None
        self._seen = manifest_seen
        self._t0 = time.time()
        self._stop = threading.Event()
        router = self

        class Handler(QuietHandler):
            def do_POST(self) -> None:  # noqa: N802 - http.server API
                router._c_requests.add()
                path = self.path.partition("?")[0]
                if path == "/incident":
                    # The ROUTER's rings: fleet scrapes, shed state.
                    bb = router.blackbox
                    self._post_incident(
                        self.path.partition("?")[2],
                        bb.incident if bb is not None else None)
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
                ctype = self.headers.get(
                    "Content-Type",
                    "text/plain" if want == "text"
                    else "application/octet-stream",
                )
                # Request id: a valid client-supplied X-Request-Id
                # propagates to the replica and echoes back; otherwise
                # the sampling coin decides whether to mint one.  An
                # unsampled id-less request does no id work and proxies
                # byte-identical.
                rid = self.headers.get("X-Request-Id")
                if rid is not None and not wire.valid_request_id(rid):
                    rid = None
                if rid is None and router._sampler.sample():
                    rid = router._sampler.mint()
                status, data, rctype, headers = router._handle(
                    path, body, ctype, rid=rid
                )
                if rid is not None:
                    headers = dict(headers or {})
                    headers["X-Request-Id"] = rid
                # The body was fully consumed above, so even an error
                # status is keep-alive-safe — and a shedding router
                # MUST keep connections open (closing them turns every
                # 429 into a client reconnect under peak load).
                self._send(
                    status, data, rctype, headers=headers,
                    keep_alive=True,
                )

            def do_GET(self) -> None:  # noqa: N802 - http.server API
                path = self.path.partition("?")[0]
                if path == "/metrics":
                    # /metrics grows per-replica labeled series the
                    # flat record rendering cannot express, so the
                    # router renders it itself.
                    self._send(
                        200, router._render_metrics().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    return
                if self._get_observability(path, router._build):
                    return
                self._send(404, b"not found\n", "text/plain")

        # Every attribute a handler can touch must exist BEFORE the
        # HTTP thread starts: on a fixed, well-known port a retrying
        # client can connect the instant the socket binds.
        self._closed = False
        self._canary_thread = (
            threading.Thread(
                target=self._canary_loop, name="tffm-router-canary",
                daemon=True,
            )
            if cfg.serve_canary else None
        )
        self._health_thread = threading.Thread(
            target=self._health_loop, name="tffm-router-health",
            daemon=True,
        )
        # The router front door shares the serve endpoints' pooled
        # accept path (serve_http_threads > 0, the default); 0 keeps
        # thread-per-connection.
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
            target=self._httpd.serve_forever, name="tffm-router-http",
            daemon=True,
        )
        self._thread.start()
        self._health_thread.start()
        if self._canary_thread is not None:
            self._canary_thread.start()

    # -- dispatch --------------------------------------------------------

    def _completion_rate(self) -> float:
        """Completions/sec over the sliding window (caller holds the
        lock)."""
        now = time.perf_counter()
        dq = self._completions
        while dq and now - dq[0] > self._rate_window_s:
            dq.popleft()
        return len(dq) / self._rate_window_s

    def _admit(self):
        """(replica, None) when admitted — in-flight already counted —
        or (None, "shed" | "none")."""
        with self._lock:
            healthy = [r for r in self._replicas if r.healthy]
            if not healthy:
                return None, "none"
            total = sum(r.inflight for r in healthy)
            if self._deadline_s > 0:
                # Deadline-budget admission: with I requests in flight
                # completing at X/sec, a new arrival waits ~I/X before
                # its turn (Little's law).  The 2-per-replica floor
                # always admits at trickle load, where the rate window
                # has nothing in it.
                floor = 2 * len(healthy)
                if total >= floor:
                    rate = self._completion_rate()
                    if rate > 0 and (total + 1) / rate > self._deadline_s:
                        return None, "shed"
            if len(healthy) >= 2:
                a, b = self._rng.sample(healthy, 2)
                rep = a if a.inflight <= b.inflight else b
            else:
                rep = healthy[0]
            rep.inflight += 1
            rep.routed += 1
            self._g_inflight.set(total + 1)
            return rep, None

    def _pick_retry(self, exclude):
        """Re-pick after a proxy failure (least-loaded healthy replica
        other than the failed one); counts the in-flight slot."""
        with self._lock:
            healthy = [
                r for r in self._replicas
                if r.healthy and r is not exclude
            ]
            if not healthy:
                return None
            rep = min(healthy, key=lambda r: r.inflight)
            rep.inflight += 1
            rep.routed += 1
            return rep

    def _dec(self, rep: Replica) -> None:
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)
            self._g_inflight.set(
                sum(r.inflight for r in self._replicas)
            )

    def _handle(self, path: str, body: bytes, ctype: str, rid=None):
        """Route one scoring request; returns (status, body, ctype,
        headers-or-None) for the front handler to send.  ``rid`` (a
        sampled or client-supplied request id) propagates to the
        replica and opens the request's router-side span chain."""
        t_admit = time.perf_counter()
        rep, why = self._admit()
        traced = rid is not None and self._tracer.enabled
        if traced:
            # The admit or shed decision: where a shed request's chain
            # ends.
            self._tracer.emit(
                "serve.admit", t_admit, time.perf_counter() - t_admit,
                args={"rid": rid, "decision": why or "admit",
                      "replica": rep.index if rep is not None else -1})
        if rep is None:
            self._slo.observe(False)
            if why == "shed":
                self._c_shed.add()
                return (
                    429,
                    b"overloaded: projected queue delay exceeds "
                    b"serve_shed_deadline_ms; retry\n",
                    "text/plain", {"Retry-After": "1"},
                )
            return 503, b"no healthy replica\n", "text/plain", None
        t0 = time.perf_counter()
        while True:
            try:
                status, data, rctype = self._forward(
                    rep, path, body, ctype, rid=rid, traced=traced,
                )
                break
            except _ProxyError as e:
                # The replica died under the request: evict it and
                # retry the (idempotent) scoring request elsewhere —
                # a SIGKILLed replica costs its in-flight requests one
                # retry, not an error.
                self._dec(rep)
                self._evict(rep, f"proxy failure: {e}")
                self._c_retries.add()
                rep = self._pick_retry(exclude=rep)
                if rep is None:
                    self._slo.observe(False)
                    return (503, b"no healthy replica\n", "text/plain",
                            None)
        self._dec(rep)
        now = time.perf_counter()
        self._t_proxy.observe(now - t0)
        if traced:
            # The proxy span opens the cross-process flow: the replica's
            # serve.dispatch steps it, serve.respond ends it.
            self._tracer.emit(
                "serve.proxy", t0, now - t0,
                args={"rid": rid, "replica": rep.index, "status": status},
                flow=("s", rid))
        # SLO verdict: admitted and answered below 500 is transport-ok
        # (a 4xx is the client's malformed request, not lost
        # availability); the latency objective can still demote it.
        self._slo.observe(status < 500, now - t0)
        with self._lock:
            self._completions.append(now)
        if (
            self._canary_thread is not None and status == 200
            and len(body) <= _SAMPLE_BODY_MAX
        ):
            # Shadow-scoring sample; the size guard bounds the ring at
            # maxlen * _SAMPLE_BODY_MAX bytes (bodies can legally be
            # up to the 64 MiB cap).
            self._sample.append((path, body))
        return status, data, rctype, None

    # -- replica connections ----------------------------------------------

    def _conn_acquire(self, rep: Replica):
        """(connection, reused) — a pooled kept-alive connection when
        one is idle, else a fresh one."""
        with self._lock:
            pool = self._conns.get(rep.index) or []
            if pool:
                return pool.pop(), True
        return http.client.HTTPConnection(
            rep.host, rep.port, timeout=self._proxy_timeout_s
        ), False

    def _conn_release(self, rep: Replica, conn) -> None:
        with self._lock:
            if rep.healthy:
                self._conns.setdefault(rep.index, []).append(conn)
                return
        conn.close()

    def _forward(self, rep: Replica, path: str, body: bytes,
                 ctype: str, rid=None, traced: bool = False):
        """One proxied POST.  A failure on a REUSED connection retries
        once on a fresh one (an idle kept-alive socket the replica
        timed out is stale, not a dead replica); a fresh-connection
        failure raises _ProxyError.

        ``rid`` propagates to the replica as the ``X-Request-Id``
        header; a TRACED ``/score_bin`` request also carries it as the
        frame's request-id trailer, and an untraced frame is proxied
        byte-identical to what the client sent."""
        if traced and path == "/score_bin":
            body = wire.with_bin_request_id(body, rid)
        headers = {"Content-Type": ctype}
        if rid is not None:
            headers["X-Request-Id"] = rid
        for attempt in (0, 1):
            conn, reused = self._conn_acquire(rep)
            if attempt and reused:
                # Second pass must be a real liveness probe.
                conn.close()
                conn, reused = http.client.HTTPConnection(
                    rep.host, rep.port, timeout=self._proxy_timeout_s
                ), False
            try:
                conn.request(
                    "POST", path, body=body, headers=headers,
                )
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                if reused:
                    continue  # stale pooled socket; try fresh
                raise _ProxyError(f"{type(e).__name__}: {e}") from e
            rctype = resp.getheader("Content-Type") or "text/plain"
            if resp.will_close or resp.status >= 400:
                conn.close()
            else:
                self._conn_release(rep, conn)
            return resp.status, data, rctype
        raise _ProxyError("unreachable")  # pragma: no cover

    # -- health ------------------------------------------------------------

    def _evict(self, rep: Replica, reason: str,
               quarantine: bool = False) -> None:
        with self._lock:
            if quarantine:
                rep.quarantined = True
            if not rep.healthy:
                return
            rep.healthy = False
            rep.fails = 0
            stale = self._conns.get(rep.index) or []
            self._conns[rep.index] = []
        for conn in stale:
            conn.close()
        self._c_evictions.add()
        log.warning(
            "replica %d (%s) EVICTED from routing: %s",
            rep.index, rep.address, reason,
        )

    def _readmit(self, rep: Replica) -> None:
        with self._lock:
            # A quarantined replica is ALIVE but serving unvetted
            # params (rejected canary, failed rollback): answering
            # /healthz must not put it back in rotation — only a later
            # successful promotion clears the quarantine.
            if rep.healthy or rep.quarantined:
                return
            rep.healthy = True
            rep.fails = 0
            # Back in service resets the respawn backoff: the next
            # death is a fresh incident, not attempt k+1 of this one.
            rep.respawn_fails = 0
        self._c_readmissions.add()
        log.info("replica %d (%s) readmitted to routing",
                 rep.index, rep.address)

    def _probe_health(self, rep: Replica) -> bool:
        try:
            with urllib.request.urlopen(
                f"http://{rep.address}/healthz", timeout=1.0
            ) as resp:
                return resp.status == 200
        except (urllib.error.URLError, OSError):
            return False

    def _health_loop(self) -> None:
        while not self._stop.wait(self._health_secs):
            for rep in self._replicas:
                if self._stop.is_set():
                    return
                if rep.respawn_pending is not None:
                    self._respawn_poll(rep)
                if rep.proc is not None and rep.proc.poll() is not None:
                    self._evict(
                        rep, f"process exited {rep.proc.poll()}"
                    )
                    self._respawn_step(rep)
                    continue
                if self._probe_health(rep):
                    with self._lock:
                        rep.fails = 0
                    self._readmit(rep)
                else:
                    with self._lock:
                        rep.fails += 1
                        dead = rep.healthy and rep.fails >= _FAIL_EVICT
                    if dead:
                        self._evict(
                            rep,
                            f"{rep.fails} consecutive /healthz "
                            "failures",
                        )
            self._scrape_fleet()

    # -- respawn policy ----------------------------------------------------

    def _respawn_step(self, rep: Replica) -> None:
        """Relaunch a died MANAGED replica (health-loop thread).  The
        launch is non-blocking — _respawn_poll watches the fresh
        process's port announcement over subsequent ticks — and each
        attempt backs off exponentially (capped) until a readmission
        resets the counter.  Unmanaged host:port replicas (proc None)
        and routers without a respawner only evict."""
        if (
            self._respawner is None or rep.proc is None
            or rep.respawn_pending is not None
        ):
            return
        now = time.monotonic()
        if now < rep.next_respawn_t:
            return
        rep.next_respawn_t = now + min(
            _RESPAWN_CAP_S, _RESPAWN_BASE_S * (2 ** rep.respawn_fails)
        )
        rep.respawn_fails += 1
        try:
            pending = self._respawner(rep.index)
        except Exception as e:  # noqa: BLE001 - retry at the backoff
            log.warning("replica %d respawn launch failed: %s",
                        rep.index, e)
            return
        if pending is None:  # manager closing; no orphan spawned
            return
        rep.respawn_pending = pending
        self._c_respawns.add()

    def _respawn_poll(self, rep: Replica) -> None:
        """Adopt a pending respawn once its port is announced (the
        replica prints it only after the ladder is warm, so an adopted
        replica is a WARM replica); a relaunch that died without
        announcing counts against the backoff and retries."""
        pending = rep.respawn_pending
        if not pending.ready.is_set():
            return
        rep.respawn_pending = None
        if pending.port is None:
            log.warning(
                "respawned replica %d died before announcing a port "
                "(exit %s); next attempt in %.0fs",
                rep.index, _exit_code(pending.proc, _EXIT_WAIT_S),
                max(0.0, rep.next_respawn_t - time.monotonic()),
            )
            return
        with self._lock:
            rep.port = pending.port
            rep.proc = pending.proc
            # Any pooled connection still points at the OLD port.
            stale = self._conns.get(rep.index) or []
            self._conns[rep.index] = []
        for conn in stale:
            conn.close()
        log.info(
            "replica %d respawned on %s (pid %s); awaiting the health "
            "loop's readmission", rep.index, rep.address, rep.pid,
        )

    # -- fleet metrics scrape ----------------------------------------------

    def _scrape_fleet(self) -> None:
        """Pull each healthy replica's /status serve block (the health
        loop doubles as the fleet metrics scraper).  Results feed the
        fleet aggregates + per-replica labeled series on the router's
        /metrics; a failed scrape keeps the previous block and lets its
        staleness age (``fleet_scrape_age_max_s``)."""
        with self._t_scrape.time():
            for rep in self._replicas:
                if self._stop.is_set():
                    return
                with self._lock:
                    healthy = rep.healthy
                if not healthy:
                    continue
                try:
                    with urllib.request.urlopen(
                        f"http://{rep.address}/status", timeout=2.0
                    ) as resp:
                        doc = json.loads(resp.read())
                except (urllib.error.URLError, OSError, ValueError):
                    self._c_scrape_errors.add()
                    continue
                block = doc.get("serve")
                if isinstance(block, dict):
                    with self._lock:
                        self._scrapes[rep.index] = (time.time(), block)

    # -- canary promotion ---------------------------------------------------

    def _admin(self, rep: Replica, route: str) -> dict:
        """POST an admin route on a replica; returns the JSON doc.
        Raises _ProxyError on connection failure and ValueError on a
        4xx/5xx (the replica refused — e.g. an unservable checkpoint)."""
        status, data, _ = self._forward(
            rep, route, b"", "application/octet-stream"
        )
        if status != 200:
            raise ValueError(
                f"replica {rep.index} {route} answered {status}: "
                f"{data[:200].decode(errors='replace')}"
            )
        return json.loads(data)

    def _canary_loop(self) -> None:
        poll = max(0.05, self.cfg.serve_poll_secs)
        while not self._stop.wait(poll):
            try:
                self._canary_check()
            except Exception as e:  # noqa: BLE001 - retry next poll
                log.warning(
                    "canary watcher: promotion attempt failed (%s); "
                    "will retry next poll", e,
                )

    def _canary_check(self) -> None:
        man = manifest.read_manifest(self.cfg.model_file)
        if man is None or man == self._seen:
            return
        with self._lock:
            healthy = [r for r in self._replicas if r.healthy]
        if len(healthy) < 2:
            # Promotion needs a canary AND a baseline; retry the next
            # poll (the manifest stays un-baselined, so an evicted
            # replica coming back resumes promotion).
            log.warning(
                "canary: new checkpoint published but only %d healthy "
                "replica(s); deferring promotion", len(healthy),
            )
            return
        canary, baseline = healthy[0], healthy[1]
        try:
            # keep_prev=1 opens the replica's rollback window (and
            # anchors it across a retried reload); the fleet-roll and
            # quarantine-recovery reloads below stay plain — they are
            # promoted immediately, so retaining a standby table would
            # only pin memory.
            step = int(self._admin(
                canary, "/reload?keep_prev=1"
            ).get("step", 0))
        except ValueError as e:
            # The replica REFUSED the checkpoint (dtype/shape/format
            # contradiction): permanent for this manifest — baseline
            # it like the single-process watcher does instead of
            # re-reading a multi-GB table every poll.
            log.warning(
                "canary reload refused (%s); keeping the current "
                "fleet, will pick up the next save", e,
            )
            self._seen = man
            return
        ok, detail = self._shadow_compare(canary, baseline, step)
        if ok:
            try:
                self._admin(canary, "/promote")
            except ValueError as e:  # pragma: no cover - defensive
                log.warning("canary promote failed: %s", e)
            promoted = 1
            for rep in healthy[1:]:
                try:
                    self._admin(rep, "/reload")
                    self._admin(rep, "/promote")
                    promoted += 1
                except (ValueError, _ProxyError) as e:
                    log.warning(
                        "rolling promotion: replica %d failed to "
                        "reload (%s) — it keeps serving the OLD "
                        "params until the next manifest", rep.index, e,
                    )
            self._c_promotions.add()
            self.step = step
            log.info(
                "canary promotion to step %d complete (%d/%d "
                "replicas; %s)", step, promoted, len(healthy), detail,
            )
            # A quarantined replica (rejected canary whose rollback
            # failed) can rejoin ONLY by landing on a vetted
            # checkpoint: reload it onto the step the fleet just
            # promoted, then clear the quarantine so the health loop
            # may readmit it.
            with self._lock:
                quarantined = [
                    r for r in self._replicas if r.quarantined
                ]
            for rep in quarantined:
                try:
                    self._admin(rep, "/reload")
                    self._admin(rep, "/promote")
                    with self._lock:
                        rep.quarantined = False
                    log.info(
                        "quarantined replica %d reloaded onto the "
                        "promoted step %d; eligible for readmission",
                        rep.index, step,
                    )
                except (ValueError, _ProxyError) as e:
                    log.warning(
                        "quarantined replica %d could not reload the "
                        "promoted checkpoint (%s); it stays out of "
                        "routing", rep.index, e,
                    )
        else:
            try:
                self._admin(canary, "/rollback")
            except (ValueError, _ProxyError) as e:
                log.warning(
                    "canary ROLLBACK FAILED on replica %d (%s) — "
                    "QUARANTINING it rather than serving an unvetted "
                    "table (a later successful promotion reloads and "
                    "readmits it)", canary.index, e,
                )
                self._evict(
                    canary,
                    "rollback failed after a rejected canary",
                    quarantine=True,
                )
            self._c_rollbacks.add()
            log.warning(
                "canary REJECTED at step %d: %s — rolled back; this "
                "manifest is baselined (republish to retry)",
                step, detail,
            )
        self._seen = man

    def _shadow_score(self, rep: Replica, path: str, body: bytes):
        """Replay one sampled request directly against a replica;
        returns its scores (list of float) or None on failure."""
        try:
            status, data, _ = self._forward(
                rep, path,
                body,
                "text/plain" if path == "/score"
                else "application/octet-stream",
            )
        except _ProxyError:
            return None
        if status != 200:
            return None
        try:
            if path == "/score":
                return [float(tok) for tok in data.split()]
            return [float(s) for s in wire.decode_bin_response(data)]
        except ValueError:
            return None

    def _gate_scale(self, scores) -> np.ndarray:
        """Scores on a ratio-stable scale for the drift gate.

        Logistic serving already answers sigmoid probabilities in
        (0, 1), where a ratio IS relative drift.  mse serving answers
        RAW scores, which routinely sit near (or straddle) zero — a
        raw-ratio gate there turns negligible absolute drift into
        huge ratios (or inf, or sign-flipped ratios), spuriously
        rejecting canaries.  Squashing raw scores through the same
        sigmoid gives a bounded positive scale that is monotone in
        the score, so real drift still moves every quantile.
        """
        arr = np.asarray(scores, np.float64)
        if self.cfg.loss_type != "logistic":
            arr = 1.0 / (1.0 + np.exp(-arr))
        return arr

    @staticmethod
    def _dist_stats(scores: np.ndarray) -> dict:
        return {
            "metric": "canary_shadow_scores",
            "score_n": int(len(scores)),
            "score_mean": float(np.mean(scores)),
            "score_std": float(np.std(scores)),
            "score_p10": float(np.percentile(scores, 10)),
            "score_p50": float(np.percentile(scores, 50)),
            "score_p90": float(np.percentile(scores, 90)),
        }

    def _shadow_compare(self, canary: Replica, baseline: Replica,
                        step: int):
        """Shadow-score the sampled traffic on the canary and a
        baseline replica and judge the two score distributions with
        ``python -m fast_tffm_tpu_torch.tools.report --compare`` (exit
        0 = within threshold; 2 = drifted, and any other exit is a
        tooling failure: both reject).  Returns (ok, detail)."""
        sample = list(self._sample)
        if not sample:
            return True, ("no traffic sample collected; promoting "
                          "without a shadow compare")
        c_scores: list = []
        b_scores: list = []
        for path, body in sample:
            sc = self._shadow_score(canary, path, body)
            sb = self._shadow_score(baseline, path, body)
            if sc is None or sb is None or len(sc) != len(sb):
                continue
            c_scores.extend(sc)
            b_scores.extend(sb)
        if not c_scores:
            return True, ("shadow replay produced no comparable "
                          "scores; promoting")
        stats_b = self._dist_stats(self._gate_scale(b_scores))
        stats_c = self._dist_stats(self._gate_scale(c_scores))
        out_dir = os.path.join(
            os.path.abspath(self.cfg.model_file), "canary_compare",
            f"step_{step}",
        )
        os.makedirs(out_dir, exist_ok=True)
        path_b = os.path.join(out_dir, "baseline.json")
        path_c = os.path.join(out_dir, "canary.json")
        with open(path_b, "w") as f:
            json.dump(stats_b, f, indent=1)
        with open(path_c, "w") as f:
            json.dump(stats_c, f, indent=1)
        proc = subprocess.run(
            [sys.executable, "-m", "fast_tffm_tpu_torch.tools.report",
             "--compare", path_b, path_c, "--threshold", "default=0.05"],
            capture_output=True, timeout=60, env=_child_env(),
        )
        tail = proc.stdout.decode(errors="replace").strip(
        ).splitlines()[-1:] or [""]
        detail = (
            f"report --compare exit {proc.returncode} "
            f"({tail[0]}; artifacts in {out_dir})"
        )
        return proc.returncode == 0, detail

    # -- record / metrics ----------------------------------------------------

    # Scraped serve-block keys re-exposed per replica as labeled
    # series on the router's /metrics (plus the scrape's own age).
    _REPLICA_SERIES = (
        ("requests", "tffm_serve_replica_requests_total", "counter"),
        ("qps", "tffm_serve_replica_qps", "gauge"),
        ("p50_ms", "tffm_serve_replica_p50_ms", "gauge"),
        ("p99_ms", "tffm_serve_replica_p99_ms", "gauge"),
        ("batch_fill", "tffm_serve_replica_batch_fill", "gauge"),
        ("steady_compiles", "tffm_serve_replica_steady_compiles",
         "gauge"),
        ("skew_psi_max", "tffm_serve_replica_skew_psi_max", "gauge"),
    )

    # The serving fleet's merge over scraped replica serve blocks —
    # sums for the monotonic counters and rates, a request-weighted
    # mean for p50, MAX for the tails (a merged p99 cannot be computed
    # from per-replica percentiles; the max is the honest conservative
    # bound), a plain mean for batch fill, and the skew PSIs MAX-merged
    # under their SAME key names with skew_examples summed.
    _FLEET_SPEC = MergeSpec(
        sums=("requests", "examples", "batches", "qps",
              "steady_compiles", "recompiles_unexpected"),
        weighted=("p50_ms",),
        weight_key="requests",
        tails=("p95_ms", "p99_ms", "max_ms"),
        means=("batch_fill",),
        max_same=("skew_psi_values", "skew_psi_lengths",
                  "skew_psi_ids", "skew_psi_scores", "skew_psi_max"),
        sum_same_int=("skew_examples",),
        prefix="fleet_",
        count_key="replicas_scraped",
        age_key="fleet_scrape_age_max_s",
    )

    def _fleet_aggregates(self, per: list, scrapes: dict,
                          now: float) -> dict:
        """Fleet-level aggregates over the latest per-replica /status
        scrapes, folded per ``_FLEET_SPEC`` (including the scrape
        staleness age)."""
        return merge_blocks(
            ServeRouter._FLEET_SPEC,
            [scrapes[p["index"]] for p in per if p["index"] in scrapes],
            now,
        )

    def _build(self, kind: str = "status") -> dict:
        now = time.time()
        wall = max(now - self._t0, 1e-9)
        # SLO gauges refresh BEFORE the snapshot so one scrape's gauge
        # spellings agree with its serve-block keys.
        slo_block = self._slo.snapshot()
        snap = self._tel.snapshot()
        counters = snap.get("counters") or {}
        timers = snap.get("timers") or {}
        with self._lock:
            scrapes = dict(self._scrapes)
            per = [
                {
                    "index": r.index, "port": r.port, "pid": r.pid,
                    "healthy": r.healthy,
                    "quarantined": r.quarantined,
                    "respawning": r.respawn_pending is not None,
                    "inflight": r.inflight, "routed": r.routed,
                }
                for r in self._replicas
            ]
        for p in per:
            scraped = scrapes.get(p["index"])
            if scraped is not None:
                t, b = scraped
                p["scrape_age_s"] = round(now - t, 3)
                for key in ("qps", "p50_ms", "p99_ms", "requests",
                            "batch_fill", "steady_compiles"):
                    if key in b:
                        p[key] = b[key]
        requests = int(counters.get("serve.router_requests", 0))
        shed = int(counters.get("serve.shed", 0))
        block = {
            "requests": requests,
            "shed": shed,
            "shed_frac": round(shed / requests, 6) if requests else 0.0,
            "qps": round(requests / wall, 2),
            "inflight": sum(p["inflight"] for p in per),
            "replicas": len(per),
            "replicas_healthy": sum(1 for p in per if p["healthy"]),
            "evictions": int(counters.get("serve.evictions", 0)),
            "readmissions": int(
                counters.get("serve.readmissions", 0)
            ),
            "retries": int(counters.get("serve.retries", 0)),
            "respawns": int(counters.get("serve.respawns", 0)),
            "canary_promotions": int(
                counters.get("serve.canary_promotions", 0)
            ),
            "canary_rollbacks": int(
                counters.get("serve.canary_rollbacks", 0)
            ),
            "per_replica": per,  # /status detail; non-numeric, so the
        }                        # Prometheus rendering skips it
        block.update(self._fleet_aggregates(per, scrapes, now))
        block.update(slo_block)
        proxy = timers.get("serve.proxy") or {}
        for key in ("mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms"):
            if key in proxy:
                block[key] = proxy[key]
        rec = {
            "record": kind,
            "time": now,
            "elapsed": round(wall, 3),
            "step": self.step,
            "serve": block,
            "stages": snap,
        }
        if self.cfg.resource_metrics:
            rec["resource"] = basic_block(self._t0)
        if self.alert_engine is not None:
            rec["alerts"] = self.alert_engine.active_snapshot()
        if self._tracer.enabled:
            rec["trace_dropped_events"] = self._tracer.dropped_events
        return rec

    def _render_metrics(self) -> str:
        record = self._build("status")
        per = record["serve"]["per_replica"]
        lines = [render_prometheus(record).rstrip("\n")]
        lines.extend(labeled_lines(
            "tffm_serve_replica_healthy", "gauge",
            [({"replica": p["index"], "port": p["port"]},
              1 if p["healthy"] else 0) for p in per],
        ))
        lines.extend(labeled_lines(
            "tffm_serve_replica_inflight", "gauge",
            [({"replica": p["index"]}, p["inflight"]) for p in per],
        ))
        lines.extend(labeled_lines(
            "tffm_serve_replica_routed_total", "counter",
            [({"replica": p["index"]}, p["routed"]) for p in per],
        ))
        # Fleet scrape re-exposition: the per-replica serve blocks the
        # health loop pulled, as labeled series — one router scrape
        # sees the whole fleet.
        for key, name, mtype in self._REPLICA_SERIES:
            lines.extend(labeled_lines(name, mtype, [
                ({"replica": p["index"]}, p[key])
                for p in per if key in p
            ]))
        lines.extend(labeled_lines(
            "tffm_serve_replica_scrape_age_s", "gauge",
            [({"replica": p["index"]}, p["scrape_age_s"])
             for p in per if "scrape_age_s" in p],
        ))
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._httpd.shutdown()
        self._thread.join()
        self._httpd.server_close()
        self._health_thread.join()
        if self._canary_thread is not None:
            self._canary_thread.join()
        with self._lock:
            pools = list(self._conns.values())
            self._conns = {}
        for pool in pools:
            for conn in pool:
                conn.close()


class FleetHandle:
    """One running router + replica fleet; ``close()`` tears it down in
    order (the heartbeat stops, the router stops routing, the replicas
    terminate, then the final record is written, naming
    :attr:`exception` when one stopped the fleet, a crash leaves a
    blackbox bundle, and the router's trace is written)."""

    def __init__(self, cfg, manager, router, telemetry, writer=None,
                 heartbeat=None, alert_engine=None, tracer=None):
        self.cfg = cfg
        self.manager = manager
        self.router = router
        self.replicas = router._replicas
        self.telemetry = telemetry
        self.port = router.port
        self.alert_engine = alert_engine
        self.exception: Optional[BaseException] = None
        self._writer = writer
        self._heartbeat = heartbeat
        self._tracer = tracer
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._heartbeat is not None:
            self._heartbeat.close()
        self.router.close()
        if self.manager is not None:
            self.manager.close()
        blackbox = self.router.blackbox
        if self._writer is not None or blackbox is not None:
            try:
                final = self.router._build("final")
                if self.exception is not None:
                    final["exception"] = type(self.exception).__name__
                    final["exception_msg"] = str(self.exception)
                if self._writer is not None:
                    self._writer.write(final)
                if blackbox is not None:
                    blackbox.observe_record(final)
            except Exception as e:  # noqa: BLE001 - teardown best-effort
                log.warning("router final record write failed: %s", e)
        # A crash's bundle, before the stream closes so its manifest
        # reaches the stream.
        if (blackbox is not None and self.exception is not None
                and not isinstance(self.exception, KeyboardInterrupt)):
            blackbox.incident("crash_" + type(self.exception).__name__)
        if self._writer is not None:
            self._writer.close()
        if self._tracer is not None and self._tracer.enabled:
            try:
                n = self._tracer.dump(self.cfg.trace_file)
                self._tracer.close()
                log.info("router trace written to %s (%d events)",
                         self.cfg.trace_file, n)
            except Exception as e:  # noqa: BLE001 - teardown best-effort
                log.warning("router trace dump failed: %s", e)


def start_fleet(cfg: FmConfig, cfg_path: str,
                overrides: Optional[dict] = None,
                port: Optional[int] = None,
                device: Optional[str] = None) -> FleetHandle:
    """Spawn the replica fleet and mount the router over it.

    ``port`` overrides ``cfg.serve_port`` (tests pass 0); ``device``
    reaches every replica as ``--device`` (None: the card).  The
    manifest baseline is captured BEFORE the replicas spawn, so a
    checkpoint published during their warmup still looks new to the
    canary watcher's first poll.
    """
    defaults = FmConfig()
    inert = [k for k in _INERT_KNOBS
             if getattr(cfg, k) != getattr(defaults, k)]
    if inert:
        log.warning(
            "the PyTorch port's router does not act on %s (its replicas "
            "keep the autotuner's autotune_cache.json there); scores are "
            "unaffected", ", ".join(inert),
        )
    writer = JsonlWriter(cfg.metrics_file) if cfg.metrics_file else None
    telemetry = Telemetry(enabled=cfg.telemetry)
    # The router's half of the distributed trace; the replicas write
    # their own trace_file.replicaN halves, and report --serve-trace
    # joins the family.
    tracer = (Tracer(enabled=True, process_name="router",
                     rotate_events=cfg.trace_rotate_events,
                     rotate_path=cfg.trace_file or None)
              if cfg.trace_file else NULL_TRACER)
    manifest_seen = manifest.read_manifest(cfg.model_file)
    manager = router = heartbeat = alert_engine = None
    try:
        manager = ReplicaManager(cfg, cfg_path, overrides=overrides,
                                 device=device)
        router = ServeRouter(
            cfg.serve_port if port is None else port,
            manager.replicas, cfg, telemetry=telemetry,
            host=cfg.serve_host, manifest_seen=manifest_seen,
            tracer=tracer, respawner=manager.respawn,
        )
        run_header = {
                "record": "run_header",
                "mode": "serve_router",
                "time": time.time(),
                "model_file": cfg.model_file,
                "resume_step": router.step,
                "batch_size": cfg.batch_size,
                "telemetry": cfg.telemetry,
                "heartbeat_secs": cfg.heartbeat_secs,
                "serve_replicas": cfg.serve_replicas,
                "serve_shed_deadline_ms": cfg.serve_shed_deadline_ms,
                "serve_canary": cfg.serve_canary,
                "serve_transport": cfg.serve_transport,
                "serve_poll_secs": cfg.serve_poll_secs,
                "serve_trace_sample": cfg.serve_trace_sample,
                "serve_slo_p99_ms": cfg.serve_slo_p99_ms,
                "serve_slo_availability": cfg.serve_slo_availability,
                "serve_parse_mode": cfg.serve_parse_mode,
                "serve_http_threads": cfg.serve_http_threads,
                "serve_http_acceptors": cfg.serve_http_acceptors,
                "serve_request_queue_size":
                    ObsHTTPServer.request_queue_size,
                "alert_rules": cfg.alert_rules,
                "trace_file": cfg.trace_file,
                "replica_ports": [r.port for r in manager.replicas],
                "blackbox": cfg.blackbox,
        }
        if writer is not None:
            writer.write(run_header)
        # The router's flight recorder: its rings hold the fleet
        # heartbeats, per-replica scrape detail included.
        if cfg.blackbox:
            router.blackbox = Blackbox(
                cfg.incident_dir or os.path.join(cfg.model_file,
                                                 "incidents"),
                suffix="router", run_header=run_header,
                metrics_render=router._render_metrics,
                trace_tail_fn=tracer.tail if tracer.enabled else None,
                writer=writer, telemetry=telemetry)
        # The watchdog on the ROUTER's heartbeat: the serve-signal rules
        # (shed_frac, burn_rate, evictions, ...) evaluate against every
        # fleet heartbeat; a halt rule stops serve_fleet, and every
        # alert reaches the blackbox.
        if cfg.alert_rules:
            alert_engine = AlertEngine(
                parse_rules(cfg.alert_rules), writer=writer,
                on_alert=(router.blackbox.on_alert
                          if router.blackbox is not None else None))
            router.alert_engine = alert_engine

        def heartbeat_build():
            rec = router._build("heartbeat")
            if router.blackbox is not None:
                router.blackbox.observe_record(rec)
            if alert_engine is not None:
                alert_engine.observe(rec)
            return rec

        if cfg.heartbeat_secs > 0:
            heartbeat = Heartbeat(cfg.heartbeat_secs, heartbeat_build,
                                  writer=writer)
    except BaseException:
        # A failed mount must not leak replica processes or threads.
        if router is not None:
            router.close()
        if manager is not None:
            manager.close()
        if writer is not None:
            writer.close()
        tracer.close()
        raise
    log.info(
        "router listening on %s:%d over %d replicas (POST /score, "
        "/score_bin; GET /metrics, /status, /healthz)",
        cfg.serve_host, router.port, len(manager.replicas),
    )
    return FleetHandle(cfg, manager, router, telemetry, writer=writer,
                       heartbeat=heartbeat, alert_engine=alert_engine,
                       tracer=tracer)


def serve_fleet(cfg: FmConfig, cfg_path: str,
                overrides: Optional[dict] = None,
                device: Optional[str] = None) -> int:
    """CLI entry for ``serve <cfg> --replicas N``: route until
    interrupted.  SIGTERM and SIGINT both tear the fleet down — the
    replica subprocesses must never outlive their router.  An armed
    ``action: halt`` alert rule stops the fleet with a final record
    naming :class:`AlertHaltError` and exit code 1."""
    handle = start_fleet(cfg, cfg_path, overrides=overrides, device=device)
    print(
        f"routing on {cfg.serve_host}:{handle.port} across "
        f"{len(handle.replicas)} replica(s)", flush=True,
    )

    def _sigterm(signum, frame):  # pragma: no cover - signal path
        raise KeyboardInterrupt

    prev = signal.signal(signal.SIGTERM, _sigterm)
    code = 0
    try:
        run_until_halt(handle.alert_engine)
    except KeyboardInterrupt:
        log.info("interrupted; shutting down the fleet")
    except AlertHaltError as e:
        log.error("HALT: %s", e)
        handle.exception = e
        code = 1
    finally:
        handle.close()
        signal.signal(signal.SIGTERM, prev)
    return code
