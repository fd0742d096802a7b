"""The step's patch attention's least time (``counts_ptv3.attention_ms``:
per block, forward and backward, the larger of its MMA FLOPs over 989
TFLOP/s and its bytes over 3.35 TB/s, real queries against every key of
their patch) over the device time launched inside the port's
``ptv3.attn`` spans, in %."""

from benchmark.layer_spans import roofline


def read(r):
    return roofline(r, "ptv3.attn", "attn_bound_ms")
