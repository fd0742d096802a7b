"""Host ms a scene pass that the main thread blocked in the program's
``prefetch.wait`` spans (``Prefetcher`` waiting for the next scene)."""

from benchmark.program_spans import from_readings, per_item


def read(r):
    p = from_readings(r)
    if p is None or not p.count("prefetch.wait"):
        return None
    return per_item(r, p.host_ms("prefetch.wait"))
