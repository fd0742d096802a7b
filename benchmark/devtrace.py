"""The device trace of a window: ``torch.profiler`` (CUPTI) around it,
read back from its Chrome trace.

* busy: the union of the device's kernel, copy and set intervals inside
  the ``bench.window`` range;
* :meth:`DeviceTrace.device_us_under`: device time of the work launched
  inside the benchmark's ``bench.<name>`` ranges, attributed through the
  profiler's correlation ids (the runtime call that launched each kernel
  lies inside the range, on the same host thread), not by kernel names;
* :meth:`DeviceTrace.breakdown`: the device operations that took most
  time, and the idle gaps by the innermost ``bench.*`` range the host was
  in when the device went idle.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class DeviceTrace:
    def __init__(self, events: List[dict]):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and e.get("ph") == "X"]
        self.launch = [e for e in events if e.get("cat") in LAUNCH_CATS]
        self.ranges = [e for e in events
                       if e.get("cat") == "user_annotation"
                       and str(e.get("name", "")).startswith("bench.")]
        win = [e for e in self.ranges if e["name"] == "bench.window"]
        self.window: Optional[Tuple[float, float]] = (
            (win[0]["ts"], win[0]["ts"] + win[0]["dur"]) if win else None)

    @classmethod
    def from_profile(cls, prof, path: str) -> "DeviceTrace":
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data.get("traceEvents", []))

    def _clipped(self, events) -> List[Tuple[float, float]]:
        lo, hi = self.window
        iv = []
        for e in events:
            a, b = e["ts"], e["ts"] + e.get("dur", 0)
            a, b = max(a, lo), min(b, hi)
            if b > a:
                iv.append((a, b))
        return _merge(iv)

    def busy_us(self) -> float:
        if self.window is None:
            return 0.0
        return sum(b - a for a, b in self._clipped(self.device))

    def window_us(self) -> float:
        return 0.0 if self.window is None else self.window[1] - self.window[0]

    def copy_us(self, direction: str) -> float:
        """Device time of the copies of one direction (``HtoD``)."""
        return sum(e.get("dur", 0) for e in self.device
                   if e["cat"] == "gpu_memcpy" and direction in e["name"])

    def device_us_under(self, name: str) -> float:
        """Device time of the work launched inside ``bench.<name>``."""
        by_tid: Dict[object, List[Tuple[float, float]]] = defaultdict(list)
        for r in self.ranges:
            if r["name"] == "bench." + name:
                by_tid[r.get("tid")].append((r["ts"], r["ts"] + r["dur"]))
        spans = {t: _merge(v) for t, v in by_tid.items()}
        starts = {t: [a for a, _ in v] for t, v in spans.items()}
        corr = set()
        for e in self.launch:
            iv = spans.get(e.get("tid"))
            if not iv:
                continue
            i = bisect.bisect_right(starts[e.get("tid")], e["ts"]) - 1
            if i >= 0 and e["ts"] <= iv[i][1]:
                corr.add(e.get("args", {}).get("correlation"))
        corr.discard(None)
        return sum(e.get("dur", 0) for e in self.device
                   if e.get("args", {}).get("correlation") in corr)

    def breakdown(self, top: int = 10) -> dict:
        ops: Dict[str, float] = defaultdict(float)
        for e in self.device:
            ops[str(e["name"])[:120]] += e.get("dur", 0) / 1e6
        gaps: Dict[str, float] = defaultdict(float)
        if self.window is not None:
            busy = self._clipped(self.device)
            lo, hi = self.window
            edges = [lo] + [x for iv in busy for x in iv] + [hi]
            inner = [r for r in self.ranges if r["name"] != "bench.window"]
            for a, b in zip(edges[::2], edges[1::2]):
                if b <= a:
                    continue
                mid = (a + b) / 2
                hits = [r for r in inner
                        if r["ts"] <= mid <= r["ts"] + r["dur"]]
                what = (min(hits, key=lambda r: r["dur"])["name"][6:]
                        if hits else "other")
                gaps[what] += (b - a) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def idle_percent(trace: Optional[DeviceTrace]) -> Optional[float]:
    """100 x (1 - busy / window), None without device work."""
    if trace is None or trace.window is None:
        return None
    busy = trace.busy_us()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / trace.window_us())
