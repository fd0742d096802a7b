"""Device time of the work launched inside the port's spans of one name,
on any thread.

The spans inside the port's autograd Functions (``unet.bn`` around the
masked BatchNorm, ``unet.conv1x1`` around the 1x1 convs) open in the
forward on the main thread and in the backward on autograd's own thread;
``program_spans.ProgramSpans.device_us`` reads the main thread's alone.
Here a span of any thread counts, mapped onto the trace's clock by the
same fitted line, and so does a launch event of any thread inside it: in
a train step no other thread launches work while the forward or the
backward runs (the batches are assembled before the window).  A program
without such spans (an older commit) reads None.
"""

from __future__ import annotations

from typing import Optional

from benchmark.devtrace import _merge
from benchmark.program_spans import (_correlation, _inside, from_readings,
                                     per_item)


def device_ms(r, name: str) -> Optional[float]:
    """Device ms a unit of the kernels, copies and sets launched inside
    the port's spans of ``name`` that ended in the window (``r``: the
    harness's ``Readings``)."""
    p = from_readings(r, trace=True)
    if p is None or not p.count(name, main=False):
        return None
    iv = _merge([(p.to_trace(rec[2]), p.to_trace(rec[3]))
                 for rec in p.records if rec[0] == name])
    starts = [a for a, _ in iv]
    corr = {_correlation(e) for e in r.trace.launch
            if _inside(e["ts"], iv, starts)}
    corr.discard(None)
    us = sum(e.get("dur", 0) for e in r.trace.device
             if _correlation(e) in corr)
    return per_item(r, us / 1e3)


def roofline(r, name: str, bound_key: str) -> Optional[float]:
    """The window's least time ``bound_key`` (summed over its units) over
    the device time launched inside the spans of ``name``, in %."""
    ms = device_ms(r, name)
    bound = r.total(bound_key)
    if not ms or bound <= 0:
        return None
    return 100.0 * bound / (ms * r.total("items"))
