"""Host ms a ``FusedFeatureLoader.get`` inside the program's
``loader.read`` span (the scene's file and its fused features' blob read),
over all the prefetch threads."""

from benchmark.program_spans import from_readings


def read(r):
    p = from_readings(r)
    gets = 0 if p is None else p.count("loader.read", main=False)
    if not gets:
        return None
    return p.host_ms("loader.read", main=False) / gets
