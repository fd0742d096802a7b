"""Host spans and profiler ranges, recorded from the benchmark's side.

:class:`Spans` keeps ``(start, end)`` host times (``time.perf_counter``)
per name in memory; :meth:`Spans.patch` replaces an attribute (a method of
a class or an object, a module's function) with a wrapper that records a
span around each call and, with ``ranges`` on, opens a
``torch.profiler.record_function`` range named ``bench.<name>``, so that
the device trace can attribute the kernels launched inside it.  Every
patch is undone by :meth:`Spans.restore`.  The program itself is not
edited: these spans sit at the calls into its layers.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch


class Spans:
    def __init__(self, ranges: bool = False):
        self.ranges = ranges
        self.times: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self._lock = threading.Lock()
        self._undo: List[Callable[[], None]] = []

    def record(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.times[name].append((t0, t1))

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        ctx = (torch.profiler.record_function("bench." + name)
               if self.ranges else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            try:
                yield
            finally:
                if sync and torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.record(name, t0, time.perf_counter())

    def patch(self, owner, attr: str, name: str, sync: bool = False
              ) -> None:
        """Wrap ``owner.attr`` (a method of a class or an object, or a
        module's function) with a span."""
        orig = getattr(owner, attr)

        # ``wraps`` copies the conv wrappers' ``launches`` counter: they
        # count on whatever function their module's name holds
        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            with self.span(name, sync):
                return orig(*args, **kwargs)

        had = attr in getattr(owner, "__dict__", {})
        setattr(owner, attr, wrapper)

        def undo():
            if hasattr(orig, "launches"):
                orig.launches = wrapper.launches
            if had:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._undo.append(undo)

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()

    def within(self, name: str, t0: float, t1: float
               ) -> List[Tuple[float, float]]:
        """Spans of ``name`` that ended inside ``[t0, t1]``."""
        return [s for s in self.times.get(name, ()) if t0 <= s[1] <= t1]
