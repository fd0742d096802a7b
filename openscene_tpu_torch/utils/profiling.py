"""Profiling: ``torch.profiler`` traces and per-phase wall times.

Counterpart of ``openscene_tpu/utils/profiling.py``.  The reference's only
perf observability is wall-clock data/batch meters with an ETA line
(run/distill.py:299-365, util/util.py:86-102), kept in
``utils.train_utils.AverageMeter``.  This adds tracing of the host and the
card:

    with trace("out/profile"):
        with annotate("train step"):
            train_step(...)

writes a Chrome trace (``chrome://tracing``, Perfetto) into the directory;
``annotate`` labels a region inside it.  ``StepTimer`` gives a per-phase
wall breakdown with a one-line report.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (the CPU, and CUDA where it is available) and write
    its Chrome trace to ``logdir/trace_<pid>_<ns>.json``; yields the
    profiler (``key_averages()`` after the block)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A labelled region inside a trace (``record_function``)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulate named phase durations (host wall clock)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def report(self) -> str:
        parts = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            parts.append(f"{name} {total:.2f}s ({total / max(n, 1):.3f}s x{n})")
        return " | ".join(parts)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
