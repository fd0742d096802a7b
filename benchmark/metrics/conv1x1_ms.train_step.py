"""Device ms a step of the kernels, copies and sets launched inside the
port's ``unet.conv1x1`` spans (the 1x1 convs' training forward and
backward, ``sparse/ops.py:Conv1x1Fn``: the bottleneck's, the residual
projections, the constant-input stem's occupancy GEMM), any thread
(``benchmark/layer_spans.py``)."""

from benchmark.layer_spans import device_ms


def read(r):
    return device_ms(r, "unet.conv1x1")
