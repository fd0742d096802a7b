"""Device ms a step of the kernels, copies and sets launched inside the
port's ``unet.bn`` spans (the masked BatchNorm's training forward and
backward, ``sparse/ops.py:MaskedBatchNormFn``), any thread, mapped onto
the trace's clock (``benchmark/layer_spans.py``)."""

from benchmark.layer_spans import device_ms


def read(r):
    return device_ms(r, "unet.bn")
