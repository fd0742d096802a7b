"""Device ms a step of the kernels, copies and sets launched inside the
port's ``ptv3.attn`` spans (the serialized patch attention's autograd
Function, ``sparse/patch_attn.py``: forward on the main thread, backward
on autograd's), any thread, mapped onto the trace's clock
(``benchmark/layer_spans.py``)."""

from benchmark.layer_spans import device_ms


def read(r):
    return device_ms(r, "ptv3.attn")
