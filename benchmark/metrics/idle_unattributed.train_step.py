"""Share of the traced window's device-idle time during which the main
thread was in none of the program's spans, in %."""

from benchmark.program_spans import from_readings


def read(r):
    p = from_readings(r, trace=True)
    return None if p is None else p.idle_unattributed(r.trace)
