"""The step's 1x1 GEMMs' least time (``counts_bottleneck.gemm_ms``: per
GEMM the larger of its bytes over 3.35 TB/s and its FLOPs over 989
TFLOP/s, forward, dx and fp32 dW, on valid rows) over the device time
launched inside the port's ``unet.conv1x1`` spans, in %."""

from benchmark.layer_spans import roofline


def read(r):
    return roofline(r, "unet.conv1x1", "conv1x1_bound_ms")
