"""Profiling: ``torch.profiler`` traces and the program's own spans.

Counterpart of ``openscene_tpu/utils/profiling.py``.  The reference's only
perf observability is wall-clock data/batch meters with an ETA line
(run/distill.py:299-365, util/util.py:86-102), kept in
``utils.train_utils.AverageMeter``.  This adds tracing of the host and the
card:

    with trace("out/profile"):
        with annotate("train step"):
            train_step(...)

writes a Chrome trace (``chrome://tracing``, Perfetto) into the directory;
``annotate`` labels a region inside it.

``span(name)`` marks where the program's work happens (the loader's read
and scatter, the prefetch queue's wait, the evaluator's assembly, the
geometry launches and their wait, the forward, the backward and the
optimizer).  Tracing is on exactly while a ``torch.profiler`` profile
records, as inside ``trace``: then each span opens a ``record_function``
range of its name and keeps ``(name, thread, t0, t1)`` host times
(``time.perf_counter``) in a bounded buffer, which :func:`records` copies
and :func:`clear` empties.  The on/off state is the profiler's own
process-wide flag, so worker threads (the prefetch threads, which the
profiler itself does not follow) record exactly when the thread that
started the profile does.  Off, a span is one flag check and a shared null
context.  No span waits for the device: spans time the host, and the
device's time comes from the trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Iterator, List, NamedTuple

import torch
import torch.autograd.profiler as _profiler

# records kept at most: a long run under a profiler drops the oldest
MAX_RECORDS = 1 << 16


class SpanRecord(NamedTuple):
    name: str
    thread: int      # threading.get_ident() of the thread that ran it
    t0: float        # time.perf_counter() at the start
    t1: float        # time.perf_counter() at the end


_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_lock = threading.Lock()
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def _recording(name: str):
    """A span that records: the host clock is read just outside its
    ``record_function`` range's start and just inside its end."""
    rng = torch.profiler.record_function(name)
    t0 = time.perf_counter()
    with rng:
        try:
            yield
        finally:
            rec = SpanRecord(name, threading.get_ident(), t0,
                             time.perf_counter())
            with _lock:
                _records.append(rec)


def span(name: str):
    """A context manager marking one piece of the program's work: records
    while a ``torch.profiler`` profile records, else the shared null
    context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _recording(name)


def records() -> List[SpanRecord]:
    """A copy of the recorded spans, oldest first."""
    with _lock:
        return list(_records)


def clear() -> None:
    with _lock:
        _records.clear()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (the CPU, and CUDA where it is available) and write
    its Chrome trace to ``logdir/trace_<pid>_<ns>.json``; yields the
    profiler (``key_averages()`` after the block).  The program's spans
    record inside it."""
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
