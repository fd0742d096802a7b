"""Device ms of the host-to-device copies (``Memcpy HtoD``) a scene pass,
in the traced window."""


def read(r):
    passes = r.total("items")
    if r.trace is None or not passes:
        return None
    us = r.trace.copy_us("HtoD")
    return us / 1e3 / passes if us > 0 else None
