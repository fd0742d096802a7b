"""How often the patch attention took its CUDA kernels: the port's
``ptv3.attn_kernel`` spans (around the kernels' launches,
``sparse/patch_attn.py``) over its ``ptv3.attn`` spans (every attention
forward and backward), on any thread (the backward runs on autograd's).
1.0 when every one launched the kernels; None without kernel spans or
without the span API."""

from benchmark.program_spans import from_readings


def read(r):
    p = from_readings(r)
    if p is None:
        return None
    kernels = p.count("ptv3.attn_kernel", main=False)
    spans = p.count("ptv3.attn", main=False)
    if not kernels or not spans:
        return None
    return kernels / spans
