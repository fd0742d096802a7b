"""Mean host ms a scene pass inside the program's ``eval.assemble`` span
(the raw batch on the level caps: the sorted coordinates, the input and
the 768-d fused features' buffers)."""

from benchmark.program_spans import from_readings, per_item


def read(r):
    p = from_readings(r)
    if p is None or not p.count("eval.assemble"):
        return None
    return per_item(r, p.host_ms("eval.assemble"))
