"""The program's own spans (``openscene_tpu_torch.utils.profiling``) read
against the device trace.

While a profile records, the port keeps ``(name, thread, t0, t1)`` host
times (``time.perf_counter``) of its spans.  The benchmark's own spans
hold the same clock's ends, and their ``bench.<name>`` ranges the trace
clock's: :func:`clock_anchors` pairs them, both ends of each, starting
with the window's, and :class:`ProgramSpans` maps a program span onto the
trace's clock by the line fitted through those pairs
(:attr:`ProgramSpans.drift_us`: how far the fitted offset moves over the
window).  The fit, not the window's two ends alone: the window's range is
the profiler's first event, and its start lags the host clock by up to
half a millisecond more than any later range's (H100 host, torch 2.11),
which a line through the two ends would carry into every span; the fit
drops such a pair as an outlier.  Trace events are attributed to spans by
interval:

* :meth:`ProgramSpans.host_ms`: host ms inside the spans of a name;
* :meth:`ProgramSpans.launches`: the trace's launch runtime events inside
  the main thread's spans of a name;
* :meth:`ProgramSpans.device_us`: device time of the kernels, copies and
  sets whose launch event, on any thread (autograd launches the backward
  from its own thread), lies inside the main thread's spans of a name;
* :meth:`ProgramSpans.idle_split`: the window's device-idle time by the
  innermost span the main thread was in, ``None`` for none.

Only spans that ended inside the window count.  A program without the
span API (an older commit) has no records: :func:`from_readings` then
returns None, and so does every reader that uses it.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.devtrace import _merge

Interval = Tuple[float, float]


def program_records() -> Optional[list]:
    """The port's span records, None where it has no span API."""
    from openscene_tpu_torch.utils import profiling
    read = getattr(profiling, "records", None)
    return None if read is None else read()


def _inside(t: float, iv: List[Interval], starts: List[float]) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= iv[i][1]


def _correlation(e: dict):
    return e.get("args", {}).get("correlation")


def clock_anchors(spans, trace) -> List[Interval]:
    """``(host s, trace us)`` pairs, both ends of each of the benchmark's
    spans (``spans.times``) paired in order with its ``bench.<name>``
    ranges, for every name whose ranges all reached the trace (those
    opened in threads the profiler does not follow do not)."""
    pairs = []
    for name, host in spans.times.items():
        ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace.ranges
                        if e["name"] == "bench." + name)
        if ranges and len(ranges) == len(host):
            for (h0, h1), (d0, d1) in zip(sorted(host), ranges):
                pairs += [(h0, d0), (h1, d1)]
    return pairs


def fit_clock(anchors: Sequence[Interval]) -> Tuple[float, float, float]:
    """``(h, d, slope)``: trace us = ``d + (host s - h) * slope``, the least
    squares line through the anchors' offsets, fitted again without the
    pairs off it by more than five median deviations (and 5 us)."""
    h = sum(a for a, _ in anchors) / len(anchors)
    pts = [(a - h, b - 1e6 * a) for a, b in anchors]   # (s, offset us)
    base = sorted(y for _, y in pts)[len(pts) // 2]
    pts = [(x, y - base) for x, y in pts]

    def line(pts):
        n = len(pts)
        mx, my = sum(x for x, _ in pts) / n, sum(y for _, y in pts) / n
        sxx = sum((x - mx) ** 2 for x, _ in pts)
        b = (sum((x - mx) * (y - my) for x, y in pts) / sxx
             if sxx > 0 else 0.0)
        return my - b * mx, b

    a, b = line(pts)
    res = sorted(abs(y - a - b * x) for x, y in pts)
    cut = max(5 * res[len(res) // 2], 5.0)
    kept = [(x, y) for x, y in pts if abs(y - a - b * x) <= cut]
    if len(kept) >= 2:
        a, b = line(kept)
    return h, 1e6 * h + base + a, 1e6 + b


class ProgramSpans:
    """``records``: ``(name, thread, t0, t1)`` host times in seconds;
    ``host_window``: the window's host ends (s); ``anchors``: ``(host s,
    trace us)`` pairs (:func:`clock_anchors`), None for host readings
    alone; ``main``: the ident of the thread that ran the window (this
    process's main thread by default)."""

    def __init__(self, records: Sequence[tuple], host_window: Interval,
                 anchors: Optional[Sequence[Interval]] = None,
                 main: Optional[int] = None):
        h0, h1 = host_window
        self.h, self.d, self.scale = (fit_clock(anchors) if anchors
                                      else (h0, 1e6 * h0, 1e6))
        self.drift_us = (self.scale - 1e6) * (h1 - h0)
        self.main = threading.main_thread().ident if main is None else main
        self.records = [r for r in records if h0 <= r[3] <= h1]

    def to_trace(self, t: float) -> float:
        return self.d + (t - self.h) * self.scale

    def _of(self, name: Optional[str], main: bool) -> list:
        """Records of ``name`` (None: every name), of the main thread
        alone with ``main``."""
        return [r for r in self.records
                if name in (None, r[0]) and (not main or r[1] == self.main)]

    def count(self, name: str, main: bool = True) -> int:
        return len(self._of(name, main))

    def host_ms(self, name: str, main: bool = True) -> float:
        return 1e3 * sum(r[3] - r[2] for r in self._of(name, main))

    def intervals(self, name: str) -> List[Interval]:
        """The main thread's spans of ``name`` on the trace's clock."""
        return _merge([(self.to_trace(r[2]), self.to_trace(r[3]))
                       for r in self._of(name, True)])

    def _launched(self, trace, name: str) -> list:
        iv = self.intervals(name)
        starts = [a for a, _ in iv]
        return [e for e in trace.launch if _inside(e["ts"], iv, starts)]

    def launches(self, trace, name: str) -> int:
        """Launch runtime events (kernels, graphs) inside the spans."""
        return sum(1 for e in self._launched(trace, name)
                   if "Launch" in str(e.get("name", "")))

    def device_us(self, trace, name: str) -> float:
        corr = {_correlation(e) for e in self._launched(trace, name)}
        corr.discard(None)
        return sum(e.get("dur", 0) for e in trace.device
                   if _correlation(e) in corr)

    def _innermost(self) -> List[Tuple[float, float, str]]:
        """The main thread's time cut into disjoint pieces, each with the
        innermost span open over it (spans on one thread nest)."""
        spans = sorted(((self.to_trace(r[2]), self.to_trace(r[3]), r[0])
                        for r in self._of(None, True)),
                       key=lambda s: (s[0], -s[1]))
        out, stack, t = [], [], float("-inf")

        def close(upto: float) -> None:
            nonlocal t
            while stack and stack[-1][0] <= upto:
                end, name = stack.pop()
                if end > t:
                    out.append((t, end, name))
                    t = end

        for a, b, name in spans:
            close(a)
            if stack and a > t:
                out.append((t, a, stack[-1][1]))
            stack.append((b, name))
            t = max(t, a)
        close(float("inf"))
        return out

    def idle_split(self, trace) -> Dict[Optional[str], float]:
        """Device-idle us of the trace's window by the innermost main-thread
        span over it (``None``: in no span)."""
        lo, hi = trace.window
        edges = [lo] + [x for iv in trace._clipped(trace.device)
                        for x in iv] + [hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        segs = self._innermost()
        split: Dict[Optional[str], float] = defaultdict(float)
        i = 0
        for a, b in gaps:
            while i < len(segs) and segs[i][1] <= a:
                i += 1
            covered, j = 0.0, i
            while j < len(segs) and segs[j][0] < b:
                x, y = max(a, segs[j][0]), min(b, segs[j][1])
                if y > x:
                    split[segs[j][2]] += y - x
                    covered += y - x
                j += 1
            split[None] += (b - a) - covered
        return dict(split)

    def idle_unattributed(self, trace) -> Optional[float]:
        """Share of the device-idle time in no main-thread span, in %."""
        split = self.idle_split(trace)
        idle = sum(split.values())
        return 100.0 * split.get(None, 0.0) / idle if idle > 0 else None


def from_readings(r, trace: bool = False) -> Optional[ProgramSpans]:
    """The program's spans of a run's window (``r``: the harness's
    ``Readings``); with ``trace``, mapped onto a device trace that holds
    device work.  None where either is missing."""
    win = r.spans.times.get("window")
    if not win:
        return None
    anchors = None
    if trace:
        if (r.trace is None or r.trace.window is None
                or r.trace.busy_us() <= 0):
            return None
        anchors = clock_anchors(r.spans, r.trace)
    recs = program_records()
    if not recs:
        return None
    return ProgramSpans(recs, win[-1], anchors)


def per_item(r, value: float) -> Optional[float]:
    """``value`` over the window's units of work (steps, scene passes)."""
    n = r.total("items")
    return value / n if n else None
