"""Launch runtime events a step (kernels, graphs) in the device trace
inside the program's ``geometry.build`` spans, mapped onto the trace's
clock."""

from benchmark.program_spans import from_readings, per_item


def read(r):
    p = from_readings(r, trace=True)
    if p is None or not p.count("geometry.build"):
        return None
    return per_item(r, p.launches(r.trace, "geometry.build"))
