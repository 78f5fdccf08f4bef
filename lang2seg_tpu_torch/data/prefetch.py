"""Background batch prefetching.

Counterpart of `lang2seg_tpu/data/prefetch.py`: a host thread keeps a
bounded queue of ready batches, so that image decode, resize and mask
decode overlap the card's steps. An exception in the thread surfaces at
the next `get`; `close` stops and joins the thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional


class Prefetcher:
    def __init__(self, next_batch: Callable[[], Any], depth: int = 2):
        self._next = next_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self._next()
            except BaseException as e:   # surfaces on the consumer side
                self._exc = e
                self._q.put(None)
                return
            self._q.put(item)

    def get(self) -> Any:
        item = self._q.get()
        if item is None and self._exc is not None:
            raise self._exc
        return item

    def close(self):
        """Stop the thread and wait for it: the queue is drained until
        the thread, which may be blocked on a full queue, has ended."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.01)
