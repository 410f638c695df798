"""Process resource readings for the serving processes: RSS, peak RSS,
open file descriptors and uptime, as the ``resource`` block of a record.

The PyTorch port's copy of the process-level half of
``fast_tffm_tpu/obs/resource.py`` (``read_rss``, ``read_open_fds``,
``basic_block``), with the same key spellings.  Stdlib-only: the router
imports it.
"""

from __future__ import annotations

import time

__all__ = ["basic_block", "read_open_fds", "read_rss"]

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
