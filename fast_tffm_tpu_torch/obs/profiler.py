"""The trainer's profiler windows: ``torch.profiler`` in place of the
reference's ``jax.profiler``.

Two windows use it, one at a time in a process (:data:`LOCK`): the
``profile_dir`` window over the dispatches of steps
``[profile_start_step, profile_start_step + profile_steps)``, and the
status endpoint's ``/profile?secs=N`` capture.  Each traces CPU and,
on the card, CUDA activity and writes one Chrome trace
(``chrome://tracing`` or Perfetto loads it).

The edges follow ``tools/profiler_window.py``'s finding: the profiler
drops a kernel whose traced time falls outside its window, and the
window opens some ms after the call that starts it, so on the card the
host pauses :data:`MARGIN_S` after the window opens and, after the
device has finished its work, again before it closes.

A dispatch that replays the CUDA graph of K steps shows as one
``cudaGraphLaunch`` on the host and the graph's kernels on the device,
not as the steps' per-op ranges: the host issued no op.  The eager
dispatches show their ops as usual.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import torch

__all__ = ["LOCK", "MARGIN_S", "ProfileWindow"]

# One window at a time in a process: two overlapping torch.profiler
# sessions would poison each other.
LOCK = threading.Lock()
MARGIN_S = 0.1


class ProfileWindow:
    """One profiler window: :meth:`start`, then :meth:`stop` writes the
    Chrome trace.  ``start`` raises RuntimeError when another window of
    the process is open."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        if not LOCK.acquire(blocking=False):
            raise RuntimeError("another profiler window is open")
        try:
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
        except BaseException:
            self._prof = None
            LOCK.release()
            raise
        if self.cuda:
            time.sleep(MARGIN_S)

    @property
    def open(self) -> bool:
        return self._prof is not None

    def stop(self, path: Optional[str]) -> Optional[str]:
        """Close the window and write its trace to ``path`` (None: drop
        it, as a crashed run does); returns the path written."""
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        try:
            if self.cuda:
                torch.cuda.synchronize()
                time.sleep(MARGIN_S)
            prof.stop()
            if path is not None:
                os.makedirs(os.path.dirname(os.path.abspath(path)),
                            exist_ok=True)
                prof.export_chrome_trace(path)
        finally:
            LOCK.release()
        return path
