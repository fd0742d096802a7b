"""How often the training BatchNorm took its CUDA kernels: the port's
``unet.bn_kernel`` spans (around the kernels' launches,
``sparse/batch_norm.py``) over its ``unet.bn`` spans (every training
BatchNorm forward and backward), on any thread (the backward runs on
autograd's).  1.0 when every one launched the kernels; None without
kernel spans (a program whose BatchNorm has no kernels) or without the
span API."""

from benchmark.program_spans import from_readings


def read(r):
    p = from_readings(r)
    if p is None:
        return None
    kernels = p.count("unet.bn_kernel", main=False)
    spans = p.count("unet.bn", main=False)
    if not kernels or not spans:
        return None
    return kernels / spans
