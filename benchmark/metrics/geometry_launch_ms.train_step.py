"""Mean host ms a step inside the program's ``geometry.build`` spans
(``RawTrainStep.geometry``: the coordinates' upload and the launches of
``build_geometry_parts``, without the wait for the level counts)."""

from benchmark.program_spans import from_readings, per_item


def read(r):
    p = from_readings(r)
    if p is None or not p.count("geometry.build"):
        return None
    return per_item(r, p.host_ms("geometry.build"))
