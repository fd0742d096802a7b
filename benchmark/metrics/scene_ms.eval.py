"""Mean ms of ``ZeroShotEvaluator.scene`` (raw assembly, geometry on the
card, forward, ensemble, text product) to its logits on the host (the span
ends with a device synchronise, as the host copy right after it would
wait)."""


def read(r):
    return r.span_ms("scene")
