"""How often the trainers' geometry build replayed its CUDA graph: the
port's ``geometry.replay`` spans (around the graph's replay, inside
``geometry.build``, ``runtime/geometry_route.py`` ``RawTrainStep``) over
its ``geometry.build`` spans, on the main thread.  1.0 when every build
replayed, less when some built eagerly (a batch on an outgrown cap
schedule); None without replay spans (a program whose build is eager) or
without the span API."""

from benchmark.program_spans import from_readings


def read(r):
    p = from_readings(r)
    if p is None:
        return None
    replays = p.count("geometry.replay")
    builds = p.count("geometry.build")
    if not replays or not builds:
        return None
    return replays / builds
