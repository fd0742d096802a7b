"""The step's masked BatchNorms' least time (``counts_bottleneck.norm_ms``:
bf16 bytes on valid rows, forward x read and out written, backward x and
dy read and dx written, over 3.35 TB/s) over the device time launched
inside the port's ``unet.bn`` spans, in %."""

from benchmark.layer_spans import roofline


def read(r):
    return roofline(r, "unet.bn", "bn_bound_ms")
