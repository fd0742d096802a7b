"""Mean ms a step of ``RawTrainStep.geometry`` (the level pyramid, kernel
maps, skip plans and edge layouts built on the card, ending in the one
wait for the level counts and the overflow flag, so wall time is its
time): a span from the benchmark's side."""


def read(r):
    return r.span_ms("geometry")
