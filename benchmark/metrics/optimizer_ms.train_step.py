"""Device ms a step of the kernels, copies and sets whose launch event, on any
thread, lies inside the program's ``train.optimizer`` spans (the learning
rate set, ``optimizer.step()`` and, under a mesh, the buffers' average),
mapped onto the trace's clock."""

from benchmark.program_spans import from_readings, per_item


def read(r):
    p = from_readings(r, trace=True)
    if p is None or not p.count("train.optimizer"):
        return None
    return per_item(r, p.device_us(r.trace, "train.optimizer") / 1e3)
