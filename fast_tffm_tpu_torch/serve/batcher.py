"""Request-batching front end: coalesce concurrent requests into
fixed-shape microbatches.

One scoring dispatch amortizes over every example in it, so serving
throughput lives or dies on batch fill — but a request must not wait
forever for company.  :class:`ServeBatcher` is the standard tradeoff
dial: concurrent requests land in a bounded queue (depth-histogrammed
as ``serve.queue_depth``), and a single dispatcher thread coalesces
them into one microbatch until either the largest ladder rung fills or
``max_batch_wait_ms`` expires — whichever comes first.  An idle server
costs a lone request at most the deadline; a saturated server fills
rungs and the deadline never fires.

The dispatcher fills its own recycled per-rung staging buffers
directly (one row copy per example, no per-request concatenation),
runs ONE scorer dispatch, then splits the scores back per request and
releases the waiting client threads.  Because dispatches are serial
and the scorer resolves its model reference once per dispatch, a hot
swap can never interleave old and new params inside one microbatch.

Instruments (all ``serve.*``): ``requests`` / ``examples`` /
``batches`` counters, the ``latency`` timer (enqueue -> scores
delivered), the ``batch_fill`` gauge (cumulative filled/dispatched
slots), the ``inflight`` gauge and the ``queue_depth`` histogram.

The PyTorch port's own copy of ``fast_tffm_tpu/serve/batcher.py``,
with the queue helpers it imports from the reference's input pipeline;
the per-request trace spans, the SLO ledger and the skew sketches are
not in the port yet.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from fast_tffm_tpu_torch.obs.telemetry import NULL

log = logging.getLogger(__name__)

__all__ = ["ScoreRequest", "ServeBatcher"]

_CANCELLED = object()
_TIMEOUT = object()  # _ClosableQueue.get(timeout=...) expired empty


class _ClosableQueue:
    """Bounded queue whose ``cancel()`` wakes every blocked producer and
    consumer immediately — deterministic shutdown with no timed polling.

    ``put`` returns False (instead of blocking) once cancelled; ``get``
    returns the module-level ``_CANCELLED`` sentinel.  ``hist`` (a
    telemetry DepthHist) records the depth every put/get saw.
    """

    def __init__(self, maxsize: int, hist=None):
        self._items: deque = deque()
        self._max = max(1, maxsize)
        self._cv = threading.Condition()
        self._cancelled = False
        self._hist = hist if hist is not None else NULL.depth_hist("")

    def put(self, item) -> bool:
        with self._cv:
            while len(self._items) >= self._max and not self._cancelled:
                self._cv.wait()
            if self._cancelled:
                return False
            self._items.append(item)
            self._hist.observe(len(self._items))
            self._cv.notify_all()
            return True

    def get(self, timeout: Optional[float] = None):
        """Next item; blocks until one arrives, the queue is cancelled
        (``_CANCELLED``), or — with ``timeout`` — the deadline passes
        with the queue still empty (``_TIMEOUT``).  The timed form is
        the batcher's coalescing wait."""
        deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        with self._cv:
            while not self._items and not self._cancelled:
                if deadline is None:
                    self._cv.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return _TIMEOUT
                self._cv.wait(remaining)
            if not self._items:
                return _CANCELLED
            self._hist.observe(len(self._items))
            item = self._items.popleft()
            self._cv.notify_all()
            return item

    def cancel(self):
        with self._cv:
            self._cancelled = True
            self._items.clear()
            self._cv.notify_all()


class ScoreRequest:
    """One in-flight scoring request (a future the client waits on).

    ``on_done`` is the scratch-release hook for pooled parse buffers
    (serve/textparse.py): the batcher fires it exactly once when it is
    DONE READING ``ids``/``vals``/``fields`` — after the microbatch
    copy on the success path, after stamping the error on every
    failure path.  The client's ``result()`` wait is NOT the release
    point: a client timeout abandons a request the dispatcher still
    holds, and releasing then would let the pool hand the buffer to a
    new request while the dispatcher reads it."""

    __slots__ = ("ids", "vals", "fields", "n", "event", "scores",
                 "error", "t0", "on_done")

    def __init__(self, ids, vals, fields, on_done=None):
        self.ids = ids
        self.vals = vals
        self.fields = fields
        self.n = len(ids)
        self.event = threading.Event()
        self.scores: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t0 = time.perf_counter()
        self.on_done = on_done

    def finish(self) -> None:
        """Fire ``on_done`` exactly once (swap-to-None makes repeated
        calls from overlapping failure paths safe)."""
        cb, self.on_done = self.on_done, None
        if cb is not None:
            try:
                cb()
            except Exception as e:  # noqa: BLE001 - release must not
                log.warning("on_done release hook failed: %s", e)


class ServeBatcher:
    """Coalesce requests into microbatches under a latency deadline."""

    def __init__(self, scorer, max_batch_wait_ms: float = 2.0,
                 queue_size: int = 1024, telemetry=None):
        self._scorer = scorer
        self._wait_s = max(0.0, float(max_batch_wait_ms)) / 1e3
        tel = telemetry if telemetry is not None else NULL
        self._c_requests = tel.counter("serve.requests")
        self._c_examples = tel.counter("serve.examples")
        self._c_batches = tel.counter("serve.batches")
        self._t_latency = tel.timer("serve.latency")
        self._g_fill = tel.gauge("serve.batch_fill")
        # Live in-flight count (accepted, scores not yet delivered).
        self._g_inflight = tel.gauge("serve.inflight")
        self._q = _ClosableQueue(
            queue_size, hist=tel.depth_hist("serve.queue_depth")
        )
        # The batcher's OWN recycled per-rung staging buffers.  It must
        # not borrow the scorer's pools: those are guarded by the
        # scorer's dispatch lock, and the dispatcher fills buffers
        # BEFORE taking that lock — sharing them would let a direct
        # scorer.score() caller race the fill.
        self._pools: dict = {}
        # Fill accounting (dispatcher thread only): real examples vs
        # padded slots over every dispatched rung.
        self._slots = 0
        self._filled = 0
        # Outstanding requests, so close() can fail the ones a queue
        # cancel() discards instead of leaving clients blocked forever.
        self._outstanding: set = set()
        self._out_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="tffm-serve-batcher", daemon=True
        )
        self._thread.start()

    # -- client side ---------------------------------------------------

    def submit(self, ids, vals, fields=None,
               on_done=None) -> ScoreRequest:
        """Enqueue ``[n, max_features]`` arrays; returns the request
        future.  Raises RuntimeError once the batcher is closed.
        ``on_done`` (optional) fires exactly once when the batcher no
        longer reads the arrays — including on every rejection path of
        this call, so a pooled caller never leaks a lease."""
        req = ScoreRequest(
            np.ascontiguousarray(ids, np.int32),
            np.ascontiguousarray(vals, np.float32),
            (np.ascontiguousarray(fields, np.int32)
             if fields is not None else None),
            on_done=on_done,
        )
        with self._out_lock:
            if self._closed:
                req.finish()
                raise RuntimeError("ServeBatcher is closed")
            self._outstanding.add(req)
            self._g_inflight.set(len(self._outstanding))
        if not self._q.put(req):
            with self._out_lock:
                self._outstanding.discard(req)
                self._g_inflight.set(len(self._outstanding))
            req.finish()
            raise RuntimeError("ServeBatcher is closed")
        self._c_requests.add()
        return req

    @property
    def inflight(self) -> int:
        """Requests accepted but not yet answered (live load)."""
        with self._out_lock:
            return len(self._outstanding)

    def result(self, req: ScoreRequest,
               timeout: float = 30.0) -> np.ndarray:
        """Block until the request's scores arrive (or raise)."""
        if not req.event.wait(timeout):
            raise TimeoutError(
                f"scoring request ({req.n} examples) timed out after "
                f"{timeout}s"
            )
        if req.error is not None:
            raise req.error
        return req.scores

    def score(self, ids, vals, fields=None, timeout: float = 30.0,
              on_done=None) -> np.ndarray:
        """submit + result in one call (the HTTP handler's path)."""
        return self.result(
            self.submit(ids, vals, fields, on_done=on_done), timeout,
        )

    @property
    def batch_fill(self) -> float:
        return self._filled / self._slots if self._slots else 0.0

    def _pool(self, b: int):
        bufs = self._pools.get(b)
        if bufs is None:
            F = self._scorer.cfg.max_features
            bufs = (
                np.zeros((b, F), np.int32),
                np.zeros((b, F), np.float32),
                np.zeros((b, F), np.int32),
            )
            self._pools[b] = bufs
        return bufs

    # -- dispatcher thread ---------------------------------------------

    def _run(self) -> None:
        max_b = self._scorer.max_rung
        pending: Optional[ScoreRequest] = None
        while True:
            first = pending if pending is not None else self._q.get()
            pending = None
            if first is _CANCELLED:
                break
            group = [first]
            total = first.n
            deadline = time.monotonic() + self._wait_s
            while total < max_b:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                nxt = self._q.get(timeout=remaining)
                if nxt is _TIMEOUT or nxt is _CANCELLED:
                    break
                if total + nxt.n > max_b:
                    # Doesn't fit this rung: dispatch what we have and
                    # seed the next microbatch (keeps every coalesced
                    # group within one dispatch).
                    pending = nxt
                    break
                group.append(nxt)
                total += nxt.n
            self._dispatch(group, total)
        # Queue cancelled: fail whatever is still outstanding (items
        # the cancel discarded AND a pending carry-over).
        self._fail_outstanding(RuntimeError("ServeBatcher closed"))

    def _dispatch(self, group, total: int) -> None:
        scorer = self._scorer
        try:
            if len(group) == 1 and total > scorer.max_rung:
                # One oversized request: the scorer chunks it itself
                # and owns the matching slot accounting.
                req = group[0]
                scores = scorer.score(req.ids, req.vals, req.fields)
                self._slots += scorer.slots_for(total)
            else:
                b = scorer.rung_for(total)
                bi, bv, bf = self._pool(b)
                pos = 0
                any_fields = any(g.fields is not None for g in group)
                for g in group:
                    bi[pos:pos + g.n] = g.ids
                    bv[pos:pos + g.n] = g.vals
                    if any_fields:
                        bf[pos:pos + g.n] = (
                            g.fields if g.fields is not None else 0
                        )
                    pos += g.n
                if pos < b:
                    bi[pos:] = 0
                    bv[pos:] = 0.0
                    if any_fields:
                        bf[pos:] = 0
                scores = scorer.score_rung(
                    bi, bv, bf if any_fields else None, b
                )
                self._slots += b
            self._filled += total
            self._g_fill.set(round(self.batch_fill, 6))
            self._c_batches.add()
            self._c_examples.add(total)
            now = time.perf_counter()
            pos = 0
            for g in group:
                g.scores = np.asarray(scores[pos:pos + g.n], np.float32)
                pos += g.n
                self._t_latency.observe(now - g.t0)
                with self._out_lock:
                    self._outstanding.discard(g)
                    self._g_inflight.set(len(self._outstanding))
                g.event.set()
            # Last reader done (the microbatch copy read g.ids/g.vals):
            # release pooled parse scratch.
            for g in group:
                g.finish()
        except BaseException as e:  # noqa: BLE001 - fail the CLIENTS
            log.warning("serve dispatch failed: %s", e)
            for g in group:
                g.error = e
                with self._out_lock:
                    self._outstanding.discard(g)
                    self._g_inflight.set(len(self._outstanding))
                g.event.set()
                g.finish()

    def _fail_outstanding(self, exc: BaseException) -> None:
        with self._out_lock:
            stale = list(self._outstanding)
            self._outstanding.clear()
            self._g_inflight.set(0)
        for req in stale:
            req.error = exc
            req.event.set()
            req.finish()

    def close(self) -> None:
        """Stop the dispatcher and fail any queued requests.
        Idempotent."""
        with self._out_lock:
            self._closed = True
        self._q.cancel()
        self._thread.join()
