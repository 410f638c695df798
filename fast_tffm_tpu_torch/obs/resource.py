"""Resource and compile observability: process RSS, peak RSS, open file
descriptors and uptime (the ``resource`` block of every record), the
compile sentinel, and the process's kernel and parser builds.

The PyTorch port's copy of ``fast_tffm_tpu/obs/resource.py``
(``read_rss``, ``read_open_fds``, ``basic_block``, ``CompileSentinel``),
with the same key spellings.  The port's compile events are its CUDA
graph captures (:class:`CompileSentinel`) and the builds of its
hand-written kernels and C++ parser (``ops/_build.py``,
``data/native.py``), which :func:`note_build` records process-wide:
``build_block()`` gives their count and seconds as ``builds`` and
``build_s``.  Stdlib-only: the router imports it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

__all__ = ["CompileSentinel", "basic_block", "build_block", "note_build",
           "read_open_fds", "read_rss"]

log = logging.getLogger(__name__)

_BUILDS: list = []  # (tool, target, wall seconds) of this process's builds
_BUILDS_LOCK = threading.Lock()

_PAGE = None  # resolved once; sysconf is a syscall-free lookup after that


def _page_size() -> int:
    global _PAGE
    if _PAGE is None:
        import os

        try:
            _PAGE = os.sysconf("SC_PAGE_SIZE")
        except (ValueError, OSError, AttributeError):  # pragma: no cover
            _PAGE = 4096
    return _PAGE


def read_rss() -> tuple:
    """(rss_bytes, peak_rss_bytes) of THIS process, cheaply.

    ``/proc/self/statm`` field 2 is resident pages (one short read, no
    allocation churn — fine at heartbeat cadence); ``VmHWM`` in
    ``/proc/self/status`` is the kernel's high-water mark, which
    catches a transient spike (an epoch-cache fill, a merge) even when
    the sampler never lands on it.  Non-Linux fallback:
    ``resource.getrusage`` (stdlib) serves ``ru_maxrss`` for both.
    Returns (0, 0) only when every source fails.
    """
    rss = peak = 0
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * _page_size()
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) * 1024
                    break
    except (OSError, ValueError, IndexError):
        pass
    if not rss or not peak:  # pragma: no cover - non-Linux
        try:
            import resource as _res
            import sys as _sys

            # ru_maxrss units differ by platform: kilobytes on Linux,
            # BYTES on macOS (the one platform that actually reaches
            # this fallback, /proc being absent there).
            scale = 1 if _sys.platform == "darwin" else 1024
            maxrss = _res.getrusage(_res.RUSAGE_SELF).ru_maxrss * scale
            rss = rss or maxrss
            peak = peak or maxrss
        except Exception:
            pass
    return rss, max(rss, peak)


def read_open_fds() -> int:
    """Open file-descriptor count of THIS process (one readdir of
    ``/proc/self/fd``), or -1 where /proc is absent.  The fd-leak
    signal for the socket-heavy serving fleet: a replica leaking one
    socket per kept-alive connection climbs here long before accept()
    starts failing.  Alertable as ``open_fds`` (alias for
    ``resource.open_fds``)."""
    import os

    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:  # pragma: no cover - non-Linux
        return -1


def basic_block(t0: float) -> dict:
    """The process-level slice of the ``resource`` block — RSS, uptime,
    open fds — for hosts without a compile sentinel (serve replicas,
    the router).  The trainer builds its richer block in the dispatch
    loop; key spellings here MUST match it so one alert alias covers
    both planes."""
    rss, peak = read_rss()
    out = {
        "rss_mb": round(rss / (1024 * 1024), 1),
        "peak_rss_mb": round(peak / (1024 * 1024), 1),
        "uptime_s": round(time.time() - t0, 3),
    }
    fds = read_open_fds()
    if fds >= 0:
        out["open_fds"] = fds
    return out


def note_build(tool: str, target: str, wall_s: float) -> None:
    """Record one build this process ran (``tool`` is ``nvcc`` or
    ``g++``; ``target`` the library it wrote).  A build found up to date
    is no build."""
    with _BUILDS_LOCK:
        _BUILDS.append((tool, target, float(wall_s)))


def build_block() -> dict:
    """``{"builds": n, "build_s": seconds}`` of this process's builds so
    far (every run of the process sees the same, growing, ledger)."""
    with _BUILDS_LOCK:
        return {"builds": len(_BUILDS),
                "build_s": round(sum(b[2] for b in _BUILDS), 3)}


class CompileSentinel:
    """Accounting for train-step compilations.

    In the port a "compile" is the capture of a super-batch's K steps as
    one CUDA graph (``train/dispatch.py::GraphedSteps``): the trainer
    calls :meth:`record` once per capture with its wall time, its ``k``
    and its classification (expected when ``k`` is
    ``steps_per_dispatch``: the one capture a graphed run makes; the
    eager dispatches compile nothing).  The port has no XLA cost
    analysis, so ``cost`` stays empty and the flops keys are absent.
    The kernel and parser builds (``nvcc`` / ``g++``) are process-wide
    and counted apart, by :func:`note_build` and :func:`build_block`.
    The sentinel:

    - observes the wall time into a ``train.compile`` telemetry timer
      (count == compiles) and bumps ``train.recompiles_unexpected``
      for flagged ones — both resolved lazily from the registry so a
      per-run ``Telemetry.reset()`` never orphans them;
    - writes a self-describing ``record: compile`` JSONL entry through
      the run's writer (same stream as heartbeats);
    - warns loudly on unexpected recompiles (the default-on alert);
    - keeps the steady-state dispatch's cost numbers (largest ``k``
      seen) for the ``resource`` block's throughput attribution.

    Thread-safe: compiles happen on the dispatch loop but snapshots
    run on heartbeat/status threads.
    """

    def __init__(self, telemetry=None, expected_k: int = 1):
        from fast_tffm_tpu_torch.obs import telemetry as telemetry_mod

        self._tel = telemetry if telemetry is not None else telemetry_mod.NULL
        self._lock = threading.Lock()
        self._writer = None
        self.expected_k = int(expected_k)
        self.compiles = 0
        self.compile_s = 0.0
        self.unexpected = 0
        self._cost: dict = {}  # steady-state dispatch cost (largest k)
        self._cost_k = 0

    def set_writer(self, writer) -> None:
        """Attach the run's JsonlWriter (train() owns its lifetime)."""
        self._writer = writer

    def reset(self) -> None:
        """Per-run accounting (mirrors Telemetry.reset): a second
        train() on a warm Trainer reports ITS compiles — usually zero,
        because the AOT cache it feeds from is instance-lived."""
        with self._lock:
            self.compiles = 0
            self.compile_s = 0.0
            self.unexpected = 0
            self._writer = None
            # The cost of the cached steady-state executable still
            # describes what run 2 dispatches; keep it.

    def record(self, wall_s: float, k: int, expected: bool,
               cost: Optional[dict] = None, step: int = 0) -> None:
        """Account one actual compile (cache misses only)."""
        self._tel.timer("train.compile").observe(wall_s)
        cost = cost or {}
        with self._lock:
            self.compiles += 1
            self.compile_s += wall_s
            if not expected:
                self.unexpected += 1
            if cost and k >= self._cost_k:
                self._cost = dict(cost)
                self._cost_k = k
            writer = self._writer
        if not expected:
            self._tel.counter("train.recompiles_unexpected").add()
            log.warning(
                "UNEXPECTED train-step recompile at step %d (k=%d, "
                "%.2fs): the input stream changed shape mid-run "
                "(batch/max_features drift, sort-meta flip, or a "
                "foreign K) — only the documented epoch-tail "
                "K' < steps_per_dispatch compile is whitelisted",
                step, k, wall_s,
            )
        if writer is not None:
            rec = {
                "record": "compile",
                "time": time.time(),
                "step": step,
                "k": k,
                "compile_s": round(wall_s, 4),
                "expected": bool(expected),
            }
            rec.update(cost)
            try:
                writer.write(rec)
            except Exception as e:  # noqa: BLE001 - never kill a compile
                log.warning("compile record write failed: %s", e)

    def reclassify_unexpected(self, k: int, step: int = 0) -> None:
        """Retroactive flag for a short-k compile that was provisionally
        whitelisted as an epoch tail but turned out not to be one (the
        trainer saw another super-batch follow it instead of an epoch
        boundary).  Same counter + warn as an immediate flag; the
        original ``record: compile`` entry stays (its wall time was
        real), only the classification moves."""
        with self._lock:
            self.unexpected += 1
        self._tel.counter("train.recompiles_unexpected").add()
        log.warning(
            "UNEXPECTED train-step recompile at step %d (k=%d): a "
            "short super-batch compiled as a presumed epoch-tail K' "
            "but was NOT followed by an epoch boundary — the input "
            "stream is emitting short super-batches mid-epoch",
            step, k,
        )

    def snapshot(self) -> dict:
        """Compile-side half of the ``resource`` block (flat, numeric
        — safe from any thread, renders straight into Prometheus)."""
        with self._lock:
            out = {
                "compiles": self.compiles,
                "compile_s": round(self.compile_s, 3),
                "recompiles_unexpected": self.unexpected,
            }
            cost = dict(self._cost)
        flops = cost.get("flops", 0.0)
        bytes_acc = cost.get("bytes_accessed", 0.0)
        if flops:
            out["flops_per_dispatch"] = flops
        if bytes_acc:
            out["bytes_per_dispatch"] = bytes_acc
            if flops:
                out["arithmetic_intensity"] = round(flops / bytes_acc, 3)
        for key in ("output_bytes", "temp_bytes"):
            if cost.get(key):
                out[key] = cost[key]
        return out
