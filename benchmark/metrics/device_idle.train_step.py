"""Share of the traced window in which the device ran no kernel, copy or
set, in %."""

from benchmark.devtrace import idle_percent


def read(r):
    return idle_percent(r.trace)
