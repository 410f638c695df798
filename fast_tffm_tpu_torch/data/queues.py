"""The hand-off rules shared by the parse threads and the transfer stage.

A producer thread puts items into a :class:`ClosableQueue`; it ends its
stream with :data:`SENTINEL` and carries an exception to the consumer
wrapped in a :class:`WorkerError`.  Shutdown cancels the queue, which
wakes every blocked producer and consumer at once (no timed polling):
``put`` then returns False and ``get`` returns :data:`CANCELLED`.
"""

from __future__ import annotations

import threading
from collections import deque

__all__ = ["CANCELLED", "SENTINEL", "ClosableQueue", "WorkerError"]

SENTINEL = object()  # a producer's end of stream
CANCELLED = object()  # ClosableQueue.get after cancel()


class WorkerError:
    """Carries a producer thread's exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class ClosableQueue:
    """Bounded queue whose :meth:`cancel` wakes every blocked producer
    and consumer at once (the reference's ``_ClosableQueue``).  ``put``
    returns False once cancelled; ``get`` returns :data:`CANCELLED`."""

    def __init__(self, maxsize: int):
        self._items: deque = deque()
        self._max = max(1, maxsize)
        self._cv = threading.Condition()
        self._cancelled = False

    def put(self, item) -> bool:
        with self._cv:
            while len(self._items) >= self._max and not self._cancelled:
                self._cv.wait()
            if self._cancelled:
                return False
            self._items.append(item)
            self._cv.notify_all()
            return True

    def get(self):
        with self._cv:
            while not self._items and not self._cancelled:
                self._cv.wait()
            if not self._items:
                return CANCELLED
            item = self._items.popleft()
            self._cv.notify_all()
            return item

    def cancel(self) -> None:
        with self._cv:
            self._cancelled = True
            self._items.clear()
            self._cv.notify_all()
