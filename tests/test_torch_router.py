"""The port's serving fleet pieces against the JAX package's, on the CPU:
the router (``serve/router.py``), the SLO ledger (``serve/slo.py``), the
TFC1 capture container (``serve/wire.py``), the canary's compare gate
(``tools/report.py --compare``) and the fleet launcher's replica command.

Each router scenario runs the JAX package's ``ServeRouter`` and the
port's over the same kind of FAKE replicas (tiny stdlib HTTP servers
speaking the replica surface the router uses: ``/score``,
``/score_bin``, ``/healthz``, ``/status`` and the admin swap routes) and
must give the same observable outcome: the same responses, per-replica
routed counts, counters, SLO block, canary decisions and artifacts.  The
real fleet (replica processes of the port's serving stack) is in
tests/test_torch_fleet.py.
"""

from __future__ import annotations

import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from fast_tffm_tpu import obs as jax_obs
from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.serve import router as jax_router
from fast_tffm_tpu.serve import wire as jax_wire
from fast_tffm_tpu.serve.slo import SloTracker as JaxSloTracker
from fast_tffm_tpu_torch import cli
from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.obs.status import ObsHTTPServer, QuietHandler
from fast_tffm_tpu_torch.obs.telemetry import Telemetry
from fast_tffm_tpu_torch.serve import router
from fast_tffm_tpu_torch.serve import wire
from fast_tffm_tpu_torch.serve.slo import SloTracker
from fast_tffm_tpu_torch.train import manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = ("jax", "torch")
_PKG = {
    "jax": (jax_router, jax_obs.Telemetry, JaxFmConfig),
    "torch": (router, Telemetry, FmConfig),
}


class FakeReplica:
    """A stdlib stand-in for one replica serve process (a copy of
    tests/test_router.py's).

    Scores every example ``self.score`` (so which table "version" a
    response came from is readable off the wire), counts requests and
    distinct connections, and implements the admin swap surface with
    the same keep-prev/rollback semantics as the real scorer.
    """

    def __init__(self, score=0.5, delay_s=0.0, status_block=None):
        self.score = score
        self.delay_s = delay_s
        self.healthy = True
        self.step = 0
        self.pending = None      # (score, step) the next /reload installs
        self.prev = None         # what /rollback restores
        self.reload_calls = 0
        self.promote_calls = 0
        self.rollback_calls = 0
        self.requests = 0
        self.connections = 0
        self.reload_status = 200
        self.rollback_status = 200
        # The serve block /status answers (None = 503); the router's
        # fleet scraper consumes it.
        self.status_block = status_block
        self.last_body = None     # raw bytes of the last scoring POST
        self.last_headers = None  # its headers (dict)
        fake = self

        class Handler(QuietHandler):
            def setup(self) -> None:
                fake.connections += 1
                super().setup()

            def do_GET(self) -> None:  # noqa: N802
                if self.path == "/healthz" and fake.healthy:
                    self._send(200, b"ok\n", "text/plain")
                elif (
                    self.path == "/status"
                    and fake.status_block is not None
                    and fake.healthy
                ):
                    doc = {"record": "status",
                           "serve": dict(fake.status_block)}
                    self._send(
                        200, (json.dumps(doc) + "\n").encode(),
                        "application/json",
                    )
                else:
                    self._send(503, b"unhealthy\n", "text/plain")

            def do_POST(self) -> None:  # noqa: N802
                body = self._read_body(wire.MAX_BODY_BYTES)
                if body is None:
                    return
                fake.requests += 1
                if self.path.partition("?")[0] in ("/score",
                                                   "/score_bin"):
                    fake.last_body = body
                    fake.last_headers = dict(self.headers)
                if fake.delay_s:
                    time.sleep(fake.delay_s)
                path, _, query = self.path.partition("?")
                self.path = path
                if self.path == "/score":
                    n = len([
                        line for line in body.decode().splitlines()
                        if line.strip()
                    ])
                    out = "".join(f"{fake.score:.6f}\n" for _ in
                                  range(n))
                    self._send(200, out.encode(), "text/plain")
                elif self.path == "/score_bin":
                    (_ids, _vals, _f, n, _tr,
                     _rid) = wire.decode_bin_request(
                        body, FakeReplica._CFG
                    )
                    self._send(
                        200,
                        wire.encode_bin_response(
                            np.full((n,), fake.score, np.float32)
                        ),
                        "application/octet-stream",
                    )
                elif self.path == "/reload":
                    fake.reload_calls += 1
                    if fake.reload_status != 200:
                        self._send(
                            fake.reload_status, b"refused\n",
                            "text/plain",
                        )
                        return
                    if fake.pending is not None:
                        # Same contract as the real scorer: only a
                        # keep_prev reload opens (or anchors) the
                        # rollback window.
                        if "keep_prev=1" in query:
                            if fake.prev is None:
                                fake.prev = (fake.score, fake.step)
                        else:
                            fake.prev = None
                        fake.score, fake.step = fake.pending
                    self._send(
                        200,
                        (json.dumps({"step": fake.step}) + "\n"
                         ).encode(),
                        "application/json",
                    )
                elif self.path == "/promote":
                    fake.promote_calls += 1
                    fake.prev = None
                    self._send(
                        200,
                        (json.dumps({"step": fake.step}) + "\n"
                         ).encode(),
                        "application/json",
                    )
                elif self.path == "/rollback":
                    fake.rollback_calls += 1
                    if fake.rollback_status != 200:
                        self._send(
                            fake.rollback_status, b"broken\n",
                            "text/plain",
                        )
                        return
                    if fake.prev is None:
                        self._send(409, b"nothing to roll back\n",
                                   "text/plain")
                        return
                    fake.score, fake.step = fake.prev
                    fake.prev = None
                    self._send(
                        200,
                        (json.dumps({"step": fake.step}) + "\n"
                         ).encode(),
                        "application/json",
                    )
                else:
                    self._send(404, b"not found\n", "text/plain")

        self._httpd = ObsHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
        )
        self._thread.start()

    _CFG = FmConfig(vocabulary_size=256, factor_num=4, max_features=4)

    def close(self) -> None:
        self._httpd.shutdown()
        self._thread.join()
        self._httpd.server_close()


class Fleet:
    """One package's router over its own fakes; a context manager that
    closes both."""

    def __init__(self, impl, tmp_path, fakes, health_secs=10.0,
                 respawner=None, **cfg_kw):
        mod, tel_cls, cfg_cls = _PKG[impl]
        model = tmp_path / impl / "model"
        model.mkdir(parents=True, exist_ok=True)
        kw = dict(
            vocabulary_size=256, factor_num=4, max_features=4,
            model_file=str(model), serve_replicas=max(2, len(fakes)),
        )
        kw.update(cfg_kw)
        self.mod = mod
        self.model = str(model)
        self.fakes = fakes
        self.reps = [mod.Replica(i, "127.0.0.1", f.port)
                     for i, f in enumerate(fakes)]
        self.tel = tel_cls()
        self.router = mod.ServeRouter(
            0, self.reps, cfg_cls(**kw), telemetry=self.tel,
            health_secs=health_secs, respawner=respawner,
        )
        self.port = self.router.port

    def counters(self) -> dict:
        return self.tel.snapshot()["counters"]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.router.close()
        for f in self.fakes:
            f.close()


def _both(scenario) -> dict:
    """Run ``scenario(impl)`` for both packages; the outcomes."""
    return {impl: scenario(impl) for impl in IMPLS}


def _post(port, path, body, headers=None, timeout=30):
    """(status, body, response headers); HTTPError codes return."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers=headers or {},
    )
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _wait(cond, timeout=20.0) -> bool:
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            return False
        time.sleep(0.02)
    return True


def _frame(n, rid=None):
    ids = np.arange(n * 4, dtype=np.int32).reshape(n, 4) % 256
    vals = np.ones((n, 4), np.float32)
    return wire.encode_bin_request(ids, vals, request_id=rid)


# ----------------------------------------------------------------------
# dispatch, keep-alive, health, shedding
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n_replicas", [2, 3])
def test_sequential_stream_routes_as_the_reference(tmp_path, n_replicas):
    """Power-of-two-choices on the shared seed: a sequential stream
    lands on the same replicas, request by request, in both routers."""

    def scenario(impl):
        fakes = [FakeReplica(score=0.25 + 0.25 * i)
                 for i in range(n_replicas)]
        with Fleet(impl, tmp_path, fakes) as fl:
            answers = []
            for i in range(24):
                if i % 2:
                    status, body, _ = _post(fl.port, "/score_bin",
                                            _frame(1 + i % 3))
                    answers.append((status, wire.decode_bin_response(
                        body).tolist()))
                else:
                    status, body, _ = _post(fl.port, "/score",
                                            b"1 3:1\n0 5:1\n")
                    answers.append((status, body))
            blk = fl.router._build()["serve"]
            return {
                "answers": answers,
                "routed": [p["routed"] for p in blk["per_replica"]],
                "fake_requests": [f.requests for f in fakes],
                "requests": blk["requests"],
                "replicas_healthy": blk["replicas_healthy"],
            }

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    assert sum(out["torch"]["routed"]) == 24
    assert out["torch"]["fake_requests"] == out["torch"]["routed"]


def test_p2c_picks_the_less_loaded_of_two(tmp_path):
    def scenario(impl):
        with Fleet(impl, tmp_path, [FakeReplica(), FakeReplica()]) as fl:
            fl.reps[0].inflight = 20
            picks = [fl.router._admit()[0].index for _ in range(10)]
            with fl.router._lock:
                fl.reps[1].inflight = 50
            picks.append(fl.router._admit()[0].index)
            return picks

    out = _both(scenario)
    assert out["torch"] == out["jax"] == [1] * 10 + [0]


def test_keepalive_reuses_replica_connections(tmp_path):
    def scenario(impl):
        fakes = [FakeReplica(), FakeReplica()]
        with Fleet(impl, tmp_path, fakes) as fl:
            conn = http.client.HTTPConnection("127.0.0.1", fl.port,
                                              timeout=10)
            kept = []
            for _ in range(10):
                conn.request("POST", "/score", body=b"1 3:1\n",
                             headers={"Content-Type": "text/plain"})
                resp = conn.getresponse()
                resp.read()
                kept.append((resp.status, resp.will_close))
            conn.close()
            return {
                "kept": kept,
                "backend_requests": sum(f.requests for f in fakes),
                # Health probes are off: every backend connection is a
                # proxy connection, pooled well below one per request.
                "few_conns": sum(f.connections for f in fakes) <= 4,
            }

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    assert out["torch"] == {"kept": [(200, False)] * 10,
                            "backend_requests": 10, "few_conns": True}


@pytest.mark.parametrize("transport", ["text", "bin"])
def test_transport_knob_gates_routes(tmp_path, transport):
    def scenario(impl):
        with Fleet(impl, tmp_path, [FakeReplica(), FakeReplica()],
                   serve_transport=transport) as fl:
            text = _post(fl.port, "/score", b"1 3:1\n")
            binary = _post(fl.port, "/score_bin", _frame(1))
            other = _post(fl.port, "/nope", b"")
            return [(s, b) for s, b, _ in (text, binary, other)]

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    codes = [s for s, _ in out["torch"]]
    assert codes == ([200, 404, 404] if transport == "text"
                     else [404, 200, 404])


def test_eviction_and_readmission(tmp_path):
    def scenario(impl):
        fakes = [FakeReplica(), FakeReplica()]
        with Fleet(impl, tmp_path, fakes, health_secs=0.05) as fl:
            fakes[0].healthy = False
            evicted = _wait(lambda: not fl.reps[0].healthy)
            codes = [_post(fl.port, "/score", b"1 3:1\n")[0]
                     for _ in range(5)]
            served_by_sick = fakes[0].requests
            fakes[0].healthy = True
            readmitted = _wait(lambda: fl.reps[0].healthy)
            c = fl.counters()
            return {
                "evicted": evicted, "codes": codes,
                "served_by_sick": served_by_sick,
                "survivor": fakes[1].requests >= 5,
                "readmitted": readmitted,
                "evictions": c["serve.evictions"],
                "readmissions": c["serve.readmissions"],
            }

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    assert out["torch"] == {
        "evicted": True, "codes": [200] * 5, "served_by_sick": 0,
        "survivor": True, "readmitted": True, "evictions": 1,
        "readmissions": 1,
    }


def test_dead_replica_request_retries_transparently(tmp_path):
    def scenario(impl):
        fakes = [FakeReplica(), FakeReplica()]
        fl = Fleet(impl, tmp_path, fakes)
        try:
            fakes[0].close()
            codes = [_post(fl.port, "/score", b"1 3:1\n")[0]
                     for _ in range(10)]
            c = fl.counters()
            return {"codes": codes, "evictions": c["serve.evictions"],
                    "retried": c.get("serve.retries", 0) >= 1,
                    "healthy": [r.healthy for r in fl.reps]}
        finally:
            fl.router.close()
            fakes[1].close()

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    assert out["torch"] == {"codes": [200] * 10, "evictions": 1,
                            "retried": True, "healthy": [False, True]}


def test_no_healthy_replica_is_503(tmp_path):
    def scenario(impl):
        with Fleet(impl, tmp_path, [FakeReplica(), FakeReplica()]) as fl:
            with fl.router._lock:
                for r in fl.reps:
                    r.healthy = False
            status, body, _ = _post(fl.port, "/score", b"1 3:1\n")
            return status, body

    out = _both(scenario)
    assert out["torch"] == out["jax"] == (503, b"no healthy replica\n")


def _force_overload(fl):
    """6 in flight over 2 healthy replicas (the 2-per-replica floor)
    completing at ~100/s: a 7th projects a 70 ms wait."""
    now = time.perf_counter()
    with fl.router._lock:
        fl.reps[0].inflight = 3
        fl.reps[1].inflight = 3
        for i in range(100):
            fl.router._completions.append(now - i * 0.01)


@pytest.mark.parametrize("deadline_ms", [10.0, 0.0])
def test_admission_sheds_past_the_deadline_budget(tmp_path, deadline_ms):
    def scenario(impl):
        with Fleet(impl, tmp_path, [FakeReplica(), FakeReplica()],
                   serve_shed_deadline_ms=deadline_ms) as fl:
            _force_overload(fl)
            over = fl.router._admit()[1]
            with fl.router._lock:
                fl.reps[0].inflight = 1
                fl.reps[1].inflight = 1
            under = fl.router._admit()[1]
            return over, under

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    assert out["torch"] == (("shed" if deadline_ms else None), None)


def test_shed_is_fast_429_with_retry_after(tmp_path):
    """Overload through HTTP: a forced ledger sheds with 429 +
    Retry-After on a kept-alive connection; a live burst against slow
    replicas sheds some requests and answers the rest."""

    def scenario(impl):
        fakes = [FakeReplica(delay_s=0.2), FakeReplica(delay_s=0.2)]
        with Fleet(impl, tmp_path, fakes,
                   serve_shed_deadline_ms=5.0) as fl:
            _force_overload(fl)
            conn = http.client.HTTPConnection("127.0.0.1", fl.port,
                                              timeout=10)
            conn.request("POST", "/score", body=b"1 3:1\n")
            resp = conn.getresponse()
            forced = (resp.status, resp.getheader("Retry-After"),
                      resp.read(), resp.will_close)
            conn.close()
            with fl.router._lock:
                fl.reps[0].inflight = fl.reps[1].inflight = 0
            results = []
            lock = threading.Lock()

            def client():
                end = time.perf_counter() + 1.5
                while time.perf_counter() < end:
                    status, _, hdrs = _post(fl.port, "/score", b"1 3:1\n")
                    with lock:
                        results.append((status, hdrs.get("Retry-After")))
                    if status == 429:
                        time.sleep(0.02)

            threads = [threading.Thread(target=client) for _ in range(10)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            codes = [c for c, _ in results]
            blk = fl.router._build()["serve"]
            return {
                "forced": forced,
                "some_200": codes.count(200) >= 1,
                "some_429": codes.count(429) >= 1,
                "only_200_429": set(codes) <= {200, 429},
                "retry_after": {h for c, h in results if c == 429},
                "shed_counted": blk["shed"] == codes.count(429) + 1,
                "shed_frac_positive": blk["shed_frac"] > 0,
            }

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    assert out["torch"]["forced"][:2] == (429, "1")
    assert not out["torch"]["forced"][3]  # the shed kept the connection
    assert all(v for k, v in out["torch"].items()
               if k not in ("forced", "retry_after"))
    assert out["torch"]["retry_after"] == {"1"}


# ----------------------------------------------------------------------
# canary promotion
# ----------------------------------------------------------------------


def _canary_fleet(impl, tmp_path, fakes, **kw):
    cfg = dict(serve_canary=True, serve_replicas=2, serve_poll_secs=0.05)
    cfg.update(kw)
    return Fleet(impl, tmp_path, fakes, **cfg)


def _traffic(port, n=6):
    for _ in range(n):
        assert _post(port, "/score", b"1 3:1\n1 5:1\n")[0] == 200


def _artifacts(model, step):
    out = {}
    for name in ("baseline.json", "canary.json"):
        path = os.path.join(model, "canary_compare", f"step_{step}", name)
        with open(path) as f:
            out[name] = json.load(f)
    return out


def test_canary_promotion_rolls_the_fleet(tmp_path):
    def scenario(impl):
        fakes = [FakeReplica(score=0.5), FakeReplica(score=0.5)]
        for f in fakes:
            f.pending = (0.5000001, 7)  # new step, same distribution
        with _canary_fleet(impl, tmp_path, fakes) as fl:
            _traffic(fl.port)
            manifest.publish_manifest(fl.model, 7, "dense")
            done = _wait(lambda: fl.router.step == 7)
            c = fl.counters()
            return {
                "done": done,
                "calls": [(f.reload_calls, f.promote_calls,
                           f.rollback_calls) for f in fakes],
                "promotions": c.get("serve.canary_promotions", 0),
                "rollbacks": c.get("serve.canary_rollbacks", 0),
                "artifacts": _artifacts(fl.model, 7),
            }

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    assert out["torch"]["done"]
    assert out["torch"]["calls"] == [(1, 1, 0), (1, 1, 0)]
    assert (out["torch"]["promotions"], out["torch"]["rollbacks"]) == (1, 0)


def test_drifted_canary_rolls_back(tmp_path):
    def scenario(impl):
        fakes = [FakeReplica(score=0.5), FakeReplica(score=0.5)]
        fakes[0].pending = fakes[1].pending = (0.9, 9)
        with _canary_fleet(impl, tmp_path, fakes) as fl:
            _traffic(fl.port)
            manifest.publish_manifest(fl.model, 9, "dense")
            done = _wait(lambda: fakes[0].rollback_calls > 0)
            calls = fakes[0].reload_calls
            time.sleep(0.3)  # several polls: the manifest is baselined
            c = fl.counters()
            return {
                "done": done, "restored": fakes[0].score,
                "canary_calls": (fakes[0].reload_calls,
                                 fakes[0].rollback_calls),
                "baselined": fakes[0].reload_calls == calls,
                "fleet_untouched": fakes[1].reload_calls == 0,
                "step": fl.router.step,
                "promotions": c.get("serve.canary_promotions", 0),
                "rollbacks": c.get("serve.canary_rollbacks", 0),
                "artifacts": _artifacts(fl.model, 9),
            }

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    got = out["torch"]
    assert got["done"] and got["baselined"] and got["fleet_untouched"]
    assert got["restored"] == 0.5 and got["step"] == 0
    assert got["canary_calls"] == (1, 1)
    assert (got["promotions"], got["rollbacks"]) == (0, 1)


def test_refused_reload_baselines_the_manifest(tmp_path):
    def scenario(impl):
        fakes = [FakeReplica(score=0.5), FakeReplica(score=0.5)]
        fakes[0].reload_status = 409  # unservable checkpoint
        with _canary_fleet(impl, tmp_path, fakes) as fl:
            manifest.publish_manifest(fl.model, 11, "dense")
            _wait(lambda: fakes[0].reload_calls > 0)
            time.sleep(0.3)
            return fakes[0].reload_calls, fl.router.step

    out = _both(scenario)
    assert out["torch"] == out["jax"] == (1, 0)


def test_failed_rollback_quarantines_until_next_promotion(tmp_path):
    def scenario(impl):
        fakes = [FakeReplica(score=0.5) for _ in range(3)]
        fakes[0].pending = (0.9, 13)
        fakes[0].rollback_status = 500
        with _canary_fleet(impl, tmp_path, fakes, serve_replicas=3,
                           health_secs=0.05) as fl:
            _traffic(fl.port)
            manifest.publish_manifest(fl.model, 13, "dense")
            quarantined = _wait(lambda: fl.reps[0].quarantined)
            time.sleep(0.3)
            held_out = not fl.reps[0].healthy
            fakes[0].rollback_status = 200
            for f in fakes:
                f.pending = (0.5000001, 14)
            _traffic(fl.port)
            manifest.publish_manifest(fl.model, 14, "dense")
            recovered = _wait(lambda: not fl.reps[0].quarantined
                              and fl.reps[0].healthy)
            return {"quarantined": quarantined, "held_out": held_out,
                    "recovered": recovered, "score": fakes[0].score,
                    "step": fl.router.step}

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    assert out["torch"] == {"quarantined": True, "held_out": True,
                            "recovered": True, "score": 0.5000001,
                            "step": 14}


# ----------------------------------------------------------------------
# request ids and the binary trailer
# ----------------------------------------------------------------------


def test_request_id_passthrough_and_binary_trailer(tmp_path):
    def scenario(impl):
        fakes = [FakeReplica(), FakeReplica()]
        with Fleet(impl, tmp_path, fakes) as fl:
            out = []
            for path, body, hdrs in (
                ("/score", b"1 3:1\n", {"X-Request-Id": "client-abc-1"}),
                ("/score_bin", _frame(2), {"X-Request-Id": "client-abc-2"}),
                ("/score_bin", _frame(2, rid="trailer-7"), {}),
                ("/score", b"1 3:1\n", {"X-Request-Id": "x" * 300}),
                ("/score_bin", _frame(3), {}),
            ):
                for f in fakes:
                    f.last_body = f.last_headers = None
                status, _, rh = _post(fl.port, path, body, headers=hdrs)
                fake = next(f for f in fakes if f.last_body is not None)
                out.append({
                    "status": status,
                    "echo": rh.get("X-Request-Id"),
                    "upstream_id": fake.last_headers.get("X-Request-Id"),
                    # The frame reaches the replica byte-identical, a
                    # client's own trailer included.
                    "verbatim": fake.last_body == body,
                    "trailer": (wire.peek_bin_request_id(fake.last_body)
                                if path == "/score_bin" else None),
                })
            return out

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    got = out["torch"]
    assert [g["echo"] for g in got] == [
        "client-abc-1", "client-abc-2", None, None, None]
    assert [g["upstream_id"] for g in got] == [
        "client-abc-1", "client-abc-2", None, None, None]
    assert all(g["verbatim"] and g["status"] == 200 for g in got)
    assert got[2]["trailer"] == "trailer-7"


@pytest.mark.parametrize("fields", [False, True])
def test_wire_request_id_helpers_match_the_reference(fields):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, (3, 4)).astype(np.int32)
    vals = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    fl = ids % 3 if fields else None
    frame = wire.encode_bin_request(ids, vals, fl)
    assert frame == jax_wire.encode_bin_request(ids, vals, fl)
    stamped = wire.with_bin_request_id(frame, "rt-1-2-3")
    assert stamped == jax_wire.with_bin_request_id(frame, "rt-1-2-3")
    assert wire.peek_bin_request_id(stamped) == "rt-1-2-3"
    assert wire.peek_bin_request_id(frame) is None
    # A frame that already carries a trailer keeps the client's id.
    assert wire.with_bin_request_id(stamped, "other") == stamped
    for bad in (stamped[:-1], stamped + b"x"):
        with pytest.raises(ValueError):
            wire.peek_bin_request_id(bad)
        with pytest.raises(ValueError):
            jax_wire.peek_bin_request_id(bad)
    assert wire.with_bin_request_id(b"short", "x") == b"short"


def test_request_sampler_mints_unique_ids_and_samples_like_the_reference():
    for rate in (0.0, 0.3, 1.0):
        ours = wire.RequestSampler(rate, tag="t")
        ref = jax_wire.RequestSampler(rate, tag="t")
        assert [ours.sample() for _ in range(200)] == \
            [ref.sample() for _ in range(200)]
    off = wire.RequestSampler(1.0, enabled=False)
    assert not off.sample()
    ids = set()
    sampler = wire.RequestSampler(1.0, tag="rt")

    def mint():
        for _ in range(500):
            ids.add(sampler.mint())

    threads = [threading.Thread(target=mint) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(ids) == 2000
    assert all(i.startswith(f"rt-{os.getpid():x}-") for i in ids)


# ----------------------------------------------------------------------
# the fleet scrape, the SLO ledger, respawn
# ----------------------------------------------------------------------

_BLOCK = {
    "requests": 5, "examples": 10, "batches": 2, "qps": 2.5,
    "p50_ms": 1.0, "p95_ms": 2.0, "p99_ms": 3.0, "max_ms": 4.0,
    "batch_fill": 0.5, "steady_compiles": 0,
}


def test_fleet_scrape_metrics_lines_match_the_reference(tmp_path):
    def scenario(impl):
        fakes = [FakeReplica(status_block=dict(_BLOCK)),
                 FakeReplica(status_block=dict(_BLOCK, qps=7.5, p99_ms=9.0,
                                               requests=15))]
        with Fleet(impl, tmp_path, fakes, health_secs=0.05) as fl:
            assert _wait(lambda: len(fl.router._scrapes) == 2)
            _post(fl.port, "/score", b"1 3:1\n")
            fl.router.close()  # freeze the scrapes and the counters
            blk = fl.router._build()["serve"]
            lines = fl.router._render_metrics().splitlines()
            # The replicas' ports differ between the two fleets.
            keep = [
                re.sub(r',port="\d+"', "", line) for line in lines
                if line.startswith(("tffm_serve_replica_",
                                    "tffm_serve_fleet_",
                                    "tffm_serve_replicas",
                                    "# TYPE tffm_serve_replica_"))
                and "scrape_age" not in line
            ]
            ages = [line for line in lines if "scrape_age" in line]
            return {
                "lines": keep,
                "age_lines": [line.rsplit(" ", 1)[0] for line in ages],
                "fleet": {k: v for k, v in blk.items()
                          if k.startswith("fleet_") and "age" not in k},
            }

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    lines = out["torch"]["lines"]
    assert 'tffm_serve_replica_qps{replica="1"} 7.5' in lines
    assert "tffm_serve_fleet_requests 20" in lines
    assert "tffm_serve_fleet_p99_ms 9.0" in lines
    # The request-weighted p50: (1.0 * 5 + 1.0 * 15) / 20.
    assert out["torch"]["fleet"]["fleet_p50_ms"] == 1.0


def test_statusless_replicas_degrade_to_no_aggregates(tmp_path):
    def scenario(impl):
        with Fleet(impl, tmp_path, [FakeReplica(), FakeReplica()],
                   health_secs=0.05) as fl:
            _wait(lambda: fl.counters().get("serve.scrape_errors"))
            blk = fl.router._build()["serve"]
            return blk["replicas_scraped"], "fleet_requests" in blk

    out = _both(scenario)
    assert out["torch"] == out["jax"] == (0, False)


# Observation sequences: (ok, latency_s or None, t) per outcome, then
# the snapshot times.
_SLO_CASES = {
    "burn": ((50.0, 0.9), [(True, 0.001, 1000.0)] * 8
             + [(True, 0.2, 1000.0), (False, None, 1000.0)],
             [1000.0, 1030.0, 1120.0]),
    "latency_only": ((20.0, 0.0), [(True, 0.01, 5.0), (True, 0.03, 6.0),
                                   (False, None, 40.0)],
                     [40.0, 70.0]),
    "availability_only": ((0.0, 0.999), [(True, 5.0, 1.0)] * 3
                          + [(False, None, 2.0)], [2.0, 100.0]),
    "off": ((0.0, 0.0), [(True, 0.001, 1.0)], [1.0]),
}


@pytest.mark.parametrize("case", sorted(_SLO_CASES))
def test_slo_tracker_snapshots_equal_the_reference(case):
    (p99, avail), obs_seq, snaps = _SLO_CASES[case]
    tel_a, tel_b = jax_obs.Telemetry(), Telemetry()
    ref = JaxSloTracker(p99, avail, telemetry=tel_a)
    ours = SloTracker(p99, avail, telemetry=tel_b)
    for ok, lat, t in obs_seq:
        ref.observe(ok, lat, now=t)
        ours.observe(ok, lat, now=t)
    for t in snaps:
        assert ours.snapshot(now=t) == ref.snapshot(now=t)
        assert tel_b.snapshot()["gauges"] == tel_a.snapshot()["gauges"]


def test_router_burn_rate_counts_sheds(tmp_path):
    slo_keys = ("slo_window_s", "slo_good", "slo_bad", "slo_bad_frac",
                "slo_p99_ms", "slo_availability", "burn_rate")

    def scenario(impl):
        with Fleet(impl, tmp_path, [FakeReplica(), FakeReplica()],
                   serve_shed_deadline_ms=10.0,
                   serve_slo_p99_ms=10_000.0,
                   serve_slo_availability=0.9) as fl:
            codes = [_post(fl.port, "/score", b"1 3:1\n")[0]
                     for _ in range(8)]
            _force_overload(fl)
            codes.append(_post(fl.port, "/score", b"1 3:1\n")[0])
            blk = fl.router._build()["serve"]
            gauges = fl.tel.snapshot()["gauges"]
            return {"codes": codes,
                    "slo": {k: blk[k] for k in slo_keys},
                    "burn_gauge": gauges["serve.burn_rate"]}

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    got = out["torch"]
    assert got["codes"] == [200] * 8 + [429]
    assert got["slo"]["slo_bad"] == 1 and got["slo"]["slo_good"] == 8
    assert got["burn_gauge"] == got["slo"]["burn_rate"] == pytest.approx(
        (1 / 9) / 0.1, abs=1e-4)


class _FakePendingProc:
    """A _ReplicaProc-shaped handle for the respawn state machine."""

    def __init__(self, index):
        self.index = index
        self.port = None
        self.ready = threading.Event()
        self.proc = _FakePopen()

    def announce(self, port):
        self.port = port
        self.proc._alive = True
        self.ready.set()

    def die(self):
        self.proc._alive = False
        self.ready.set()


class _FakePopen:
    def __init__(self, alive=False):
        self._alive = alive
        self.pid = 4242

    def poll(self):
        return None if self._alive else 1


def test_respawn_readopts_and_backs_off_like_the_reference(tmp_path):
    def scenario(impl):
        fakes = [FakeReplica(), FakeReplica()]
        spawned = []

        def respawner(index):
            p = _FakePendingProc(index)
            spawned.append(p)
            return p

        with Fleet(impl, tmp_path, fakes, respawner=respawner) as fl:
            rep = fl.reps[0]
            rep.proc = _FakePopen(alive=False)  # a died managed replica
            fl.router._evict(rep, "test: process died")
            # Backoff: each relaunch that dies before announcing a port
            # doubles the next delay, up to the cap.
            delays = []
            for _ in range(7):
                rep.next_respawn_t = 0.0
                t0 = time.monotonic()
                fl.router._respawn_step(rep)
                delays.append(round(rep.next_respawn_t - t0))
                spawned[-1].die()
                fl.router._respawn_poll(rep)
            rep.next_respawn_t = time.monotonic() + 60
            fl.router._respawn_step(rep)  # not due: no attempt
            attempts = len(spawned)
            # A relaunch that announces is adopted and readmitted.
            rep.next_respawn_t = 0.0
            fl.router._respawn_step(rep)
            fl.router._respawn_poll(rep)  # not ready: a no-op
            pending_kept = rep.respawn_pending is spawned[-1]
            spawned[-1].announce(fakes[0].port)
            fl.router._respawn_poll(rep)
            adopted = (rep.respawn_pending is None
                       and rep.port == fakes[0].port
                       and rep.proc is spawned[-1].proc)
            fl.router._readmit(rep)
            # An unmanaged replica only evicts.
            fl.reps[1].proc = None
            fl.router._respawn_step(fl.reps[1])
            return {
                "delays": delays, "attempts": attempts,
                "pending_kept": pending_kept, "adopted": adopted,
                "readmitted": (rep.healthy, rep.respawn_fails),
                "respawns": fl.counters()["serve.respawns"],
                "spawned": len(spawned),
            }

    out = _both(scenario)
    assert out["torch"] == out["jax"]
    assert out["torch"] == {
        "delays": [1, 2, 4, 8, 16, 30, 30], "attempts": 7,
        "pending_kept": True, "adopted": True, "readmitted": (True, 0),
        "respawns": 8, "spawned": 8,
    }


# ----------------------------------------------------------------------
# the TFC1 capture container
# ----------------------------------------------------------------------


def _capture_frames(n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = 1 + i % 4
        ids = rng.integers(0, 256, (k, 4)).astype(np.int32)
        vals = rng.uniform(0, 1, (k, 4)).astype(np.float32)
        fl = (ids % 3) if i % 3 == 0 else None
        req = wire.encode_bin_request(ids, vals, fl)
        resp = wire.encode_bin_response(rng.uniform(0, 1, k))
        out.append((req, resp))
    return out


def _clock():
    t = [1_700_000_000.0]

    def now():
        t[0] += 0.125
        return t[0]

    return now


@pytest.mark.parametrize("sample,rotate", [(1.0, 64 << 20), (1.0, 700),
                                           (0.5, 64 << 20), (0.5, 900)])
def test_capture_files_are_byte_equal_to_the_reference(tmp_path, sample,
                                                       rotate):
    frames = _capture_frames(24)
    writers, written = {}, {}
    for impl, mod in (("jax", jax_wire), ("torch", wire)):
        w = mod.CaptureWriter(str(tmp_path / impl / "cap.tfc"),
                              sample=sample, rotate_bytes=rotate,
                              tail=5, clock=_clock())
        written[impl] = []
        for req, resp in frames:
            if w.sample():
                w.write(req, resp)
                written[impl].append((req, resp))
        writers[impl] = w
    assert writers["torch"].count == writers["jax"].count > 0
    assert writers["torch"].tail_bytes() == writers["jax"].tail_bytes()
    for w in writers.values():
        w.close()
        w.close()  # idempotent
        w.write(*frames[0])  # after close: dropped
    for suffix in ("", ".1"):
        paths = [str(tmp_path / impl / ("cap.tfc" + suffix))
                 for impl in IMPLS]
        assert os.path.exists(paths[0]) == os.path.exists(paths[1])
        if os.path.exists(paths[0]):
            with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
                assert a.read() == b.read()
    # The writers sample with a seed of the process id, so which frames
    # were written (and at sample 0.5 whether the file ever passed
    # `rotate`) depends on the pid: the rotation asserted is the one the
    # written bytes imply by the writer's own rule (a rotation once the
    # file, header included, reaches `rotate` bytes, then a fresh
    # header).  Every frame is written at sample 1.0, where `rotate <
    # 1000` must rotate.
    assert written["torch"] == written["jax"]
    size, rotated = wire._CAP_HDR.size, False
    for req, resp in written["torch"]:
        size += wire._CAP_REC.size + len(req) + len(resp)
        if size >= rotate:
            size, rotated = wire._CAP_HDR.size, True
    if sample >= 1.0:
        assert rotated == (rotate < 1000)
    assert os.path.exists(str(tmp_path / "torch" / "cap.tfc.1")) == rotated
    # Each package reads the other's file.
    path = str(tmp_path / "torch" / "cap.tfc")
    assert list(jax_wire.read_capture(path)) == list(wire.read_capture(
        str(tmp_path / "jax" / "cap.tfc")))


def test_read_capture_drops_a_truncated_final_record(tmp_path):
    frames = _capture_frames(4)
    path = str(tmp_path / "cap.tfc")
    w = wire.CaptureWriter(path, clock=_clock())
    for req, resp in frames:
        w.write(req, resp)
    w.close()
    with open(path, "rb") as f:
        data = f.read()
    for cut in (1, 10, len(frames[-1][1]) + 3):
        trunc = str(tmp_path / f"cut{cut}.tfc")
        with open(trunc, "wb") as f:
            f.write(data[:-cut])
        ours = list(wire.read_capture(trunc))
        assert ours == list(jax_wire.read_capture(trunc))
        assert [(r, s) for _, r, s in ours] == frames[:3]
    bad = str(tmp_path / "bad.tfc")
    with open(bad, "wb") as f:
        f.write(b"TFCX" + data[4:])
    for mod in (wire, jax_wire):
        with pytest.raises(ValueError, match="magic"):
            list(mod.read_capture(bad))


# ----------------------------------------------------------------------
# the canary's compare gate
# ----------------------------------------------------------------------

_BASE = {"metric": "canary_shadow_scores", "score_n": 64,
         "score_mean": 0.41, "score_std": 0.12, "score_p10": 0.25,
         "score_p50": 0.4, "score_p90": 0.58}
_COMPARE_CASES = {
    "within": dict(_BASE, score_mean=0.412, score_p90=0.57),
    "drifted": dict(_BASE, score_mean=0.6, score_p10=0.2),
    "missing_key": {k: v for k, v in _BASE.items() if k != "score_p90"},
    "nothing_shared": {"metric": "other", "qps_x": "n/a"},
}


@pytest.mark.parametrize("case", sorted(_COMPARE_CASES))
def test_report_compare_matches_the_repo_tool(tmp_path, case):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    with open(a, "w") as f:
        json.dump(_BASE, f)
    with open(b, "w") as f:
        json.dump(_COMPARE_CASES[case], f)
    env = dict(os.environ, PYTHONPATH=REPO)
    args = ["--compare", a, b, "--threshold", "default=0.05"]
    ours = subprocess.run(
        [sys.executable, "-m", "fast_tffm_tpu_torch.tools.report", *args],
        capture_output=True, env=env, timeout=60)
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "report.py"), *args],
        capture_output=True, env=env, timeout=60)
    assert ours.returncode == ref.returncode == {
        "within": 0, "drifted": 2, "missing_key": 0,
        "nothing_shared": 1}[case]
    assert ours.stdout.decode().splitlines() == \
        ref.stdout.decode().splitlines()


def test_report_compare_reads_metrics_streams_like_the_repo_tool(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import report as ref_report
    finally:
        sys.path.pop(0)
    from fast_tffm_tpu_torch.tools import report

    recs = [{"record": "run_header", "mode": "serve"},
            {"record": "train", "loss": 0.5, "examples_per_sec": 1e4},
            {"record": "final", "elapsed": 12.0, "examples_in": 4096,
             "serve": {"qps": 120.0, "p99_ms": 4.0, "shed_frac": 0.01},
             "resource": {"peak_rss_mb": 900.0}},
            {"record": "alert", "rule": "burn", "action": "warn"}]
    path = str(tmp_path / "m.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in recs) + "\n")
    assert report._comparable_metrics(path) == \
        ref_report._comparable_metrics(path)
    for key in ("serve.qps", "train.loss", "score_p50", "alert.x",
                "resource.peak_rss_mb", "tiered.hot_hit_frac", "odd"):
        assert report._direction(key) == ref_report._direction(key)
    for vals in ([], ["0.1"], ["default=0.02", "serve.qps=0.3"]):
        assert report.parse_thresholds(vals) == \
            ref_report.parse_thresholds(vals)


# ----------------------------------------------------------------------
# the fleet launcher
# ----------------------------------------------------------------------


def test_replica_command_neutralizes_fleet_knobs(tmp_path):
    """A fleet's child parses the fleet's cfg with the launcher's flags
    without error: --replicas 0 and --no_serve_canary neutralise an
    INI-configured canary fleet."""
    cfg_path = tmp_path / "fleet.cfg"
    cfg_path.write_text(
        "[General]\nvocabulary_size = 64\nfactor_num = 4\n"
        f"model_file = {tmp_path}/model\n"
        "[Predict]\nserve_replicas = 2\nserve_canary = true\n"
        "serve_poll_secs = 1.0\nserve_capture_sample = 0.5\n"
        f"serve_capture_file = {tmp_path}/cap.tfc\n"
    )
    cfg = load_config(str(cfg_path))
    cmd = router._replica_command(cfg, str(cfg_path), 1, {}, device="cpu")
    assert cmd[1:4] == ["-m", "fast_tffm_tpu_torch.cli", "serve"]
    assert "--no_serve_canary" in cmd
    assert cmd[cmd.index("--replicas") + 1] == "0"
    assert cmd[cmd.index("--serve_poll_secs") + 1] == "0"
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--serve_capture_file") + 1] == \
        f"{tmp_path}/cap.tfc.replica1"
    # The child's own parse: argparse over the replica flags, then
    # main()'s override assembly, then load_config.
    args = cli.build_argparser().parse_args(cmd[3:])
    overrides = {
        key: getattr(args, key)
        for key in ("serve_replicas", "serve_port", "serve_host",
                    "serve_poll_secs", "serve_trace_sample",
                    "alert_rules", "serve_capture_file")
        if getattr(args, key) is not None
    }
    assert args.no_serve_canary and args.device == "cpu"
    overrides["serve_canary"] = False
    child = load_config(str(cfg_path), overrides)  # must not raise
    assert (child.serve_replicas, child.serve_canary,
            child.serve_poll_secs) == (0, False, 0)


@pytest.mark.parametrize("overrides", [
    {},
    {"serve_table_dtype": "int8", "serve_batch_sizes": "8,32",
     "serve_port": 9000, "serve_replicas": 3, "serve_canary": True},
    {"max_batch_wait_ms": 0.5, "serve_slo_p99_ms": 20.0,
     "serve_shed_deadline_ms": 5.0, "trace_file": "t.json",
     "metrics_file": "m.jsonl", "serve_trace_sample": 0.5},
])
def test_replica_command_is_the_references_but_for_module_and_device(
        tmp_path, overrides):
    kw = dict(vocabulary_size=64, factor_num=4,
              model_file=str(tmp_path / "m"), serve_replicas=2,
              serve_canary=True, metrics_file="fleet.jsonl")
    ours = router._replica_command(FmConfig(**kw), "x.cfg", 0, overrides)
    ref = jax_router._replica_command(JaxFmConfig(**kw), "x.cfg", 0,
                                      overrides)
    assert ours[2] == "fast_tffm_tpu_torch.cli"
    assert ref[2] == "fast_tffm_tpu.cli"
    assert ours[:2] + ours[3:] == ref[:2] + ref[3:]
    with_dev = router._replica_command(FmConfig(**kw), "x.cfg", 0,
                                       overrides, device="cuda")
    i = with_dev.index("--device")
    assert with_dev[i + 1] == "cuda"
    assert with_dev[:i] + with_dev[i + 2:] == ours
    # Every flag a replica receives is one the port's CLI parses.
    cli.build_argparser().parse_args(ours[3:])


def test_router_process_imports_neither_torch_nor_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import fast_tffm_tpu_torch.cli\n"
         "import fast_tffm_tpu_torch.serve.router\n"
         "import fast_tffm_tpu_torch.serve.wire\n"
         "import fast_tffm_tpu_torch.train.manifest\n"
         "import fast_tffm_tpu_torch.tools.report\n"
         "import fast_tffm_tpu_torch.tools.replay\n"
         "heavy = [m for m in ('torch', 'jax', 'fast_tffm_tpu')\n"
         "         if m in sys.modules]\n"
         "assert not heavy, f'router import pulled {heavy}'\n"],
        capture_output=True, timeout=120, env=env,
    )
    assert proc.returncode == 0, proc.stderr.decode()
