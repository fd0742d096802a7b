"""Background batch prefetching (host-side data parallelism).

Replaces the reference's torch DataLoader worker pool
(``num_workers``/SharedArray pipeline, SURVEY.md §2.3): batches are built in
a thread pool and queued ahead of the training step so host voxelization /
geometry planning overlaps device compute.  Threads (not processes) suffice:
the heavy work is NumPy/C++ which releases the GIL.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

from ..utils.profiling import span


class Prefetcher:
    """Pull items from ``make_item(i)`` for i in ``indices``, ``workers``
    threads ahead, preserving order."""

    def __init__(self, make_item: Callable[[int], object],
                 indices: Iterable[int], workers: int = 2,
                 queue_depth: int = 4):
        self.make_item = make_item
        self.indices = list(indices)
        self.workers = max(workers, 1)
        self.results: dict = {}
        self.cond = threading.Condition()
        self.next_to_build = 0
        self.queue_depth = queue_depth
        self.next_to_emit = 0
        self.error = None
        self.threads = [threading.Thread(target=self._worker, daemon=True)
                        for _ in range(self.workers)]
        for t in self.threads:
            t.start()

    def _worker(self):
        while True:
            with self.cond:
                while (self.next_to_build - self.next_to_emit
                       >= self.queue_depth and self.error is None):
                    self.cond.wait()
                if self.error is not None:
                    return
                i = self.next_to_build
                if i >= len(self.indices):
                    return
                self.next_to_build += 1
            try:
                item = self.make_item(self.indices[i])
            except Exception as e:  # surfaced on the consumer side
                with self.cond:
                    self.error = e
                    self.cond.notify_all()
                return
            with self.cond:
                self.results[i] = item
                self.cond.notify_all()

    def __iter__(self) -> Iterator:
        # a second iteration would WAIT FOREVER for items the first one
        # already popped — fail loudly instead (list() the prefetcher if a
        # consumer needs multiple passes)
        if getattr(self, "_consumed", False):
            raise RuntimeError("Prefetcher is single-use; wrap in list() "
                               "for multiple passes")
        self._consumed = True
        for i in range(len(self.indices)):
            with span("prefetch.wait"), self.cond:
                while i not in self.results and self.error is None:
                    self.cond.wait()
                if self.error is not None:
                    raise self.error
                item = self.results.pop(i)
                self.next_to_emit = i + 1
                self.cond.notify_all()
            yield item

    def __len__(self):
        return len(self.indices)
