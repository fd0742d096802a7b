"""Device ms a step of the kernels, copies and sets whose launch event, on any
thread, lies inside the program's ``train.forward`` spans
(``TrainStep.loss_on``: the batch's upload, the model, the loss), mapped
onto the trace's clock."""

from benchmark.program_spans import from_readings, per_item


def read(r):
    p = from_readings(r, trace=True)
    if p is None or not p.count("train.forward"):
        return None
    return per_item(r, p.device_us(r.trace, "train.forward") / 1e3)
