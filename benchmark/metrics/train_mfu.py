"""The train step's model FLOPs (``counts.model_flops``: 2 x existing pairs
x Cin x Cout of every conv, forward, dx and dW, from the benchmark's own
pair counts) over the window's wall time x the card's dense bf16 peak
(989 TFLOP/s, H100 SXM at 700 W), in %."""

from benchmark.counts import PEAKS


def read(r):
    if r.trace is None or r.trace.busy_us() <= 0:
        return None  # no device ran: no share of a peak
    secs = r.window[1] - r.window[0]
    return 100.0 * r.total("flops") / (secs * PEAKS["bf16_flops"])
