"""Host ms a ``FusedFeatureLoader.get`` inside the program's
``loader.scatter`` spans (the zero-filled full cloud, the features
scattered into it and the voxels' rows gathered from it), over all the
prefetch threads."""

from benchmark.program_spans import from_readings


def read(r):
    p = from_readings(r)
    gets = 0 if p is None else p.count("loader.read", main=False)
    if not gets:
        return None
    return p.host_ms("loader.scatter", main=False) / gets
