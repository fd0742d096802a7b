"""The step's conv launches' least time (``counts.launch_bounds_ms``: the
frozen ``bound``/``bound_bwd`` on the benchmark's own pair counts; 32
stencil, 4 down and 4 up convs a forward and a backward) over the device
time of the work launched inside the conv wrappers' calls (the
``bench.conv`` ranges, attributed through the profiler's correlation
ids), in %."""


def read(r):
    if r.trace is None:
        return None
    dev_ms = r.trace.device_us_under("conv") / 1e3
    if dev_ms <= 0:
        return None
    return 100.0 * r.total("conv_bound_ms") / dev_ms
