"""Serialized patch attention (Point Transformer V3): the CUDA kernels'
wrappers, their plain versions and the autograd Function.

Rows of a padded serialized layout (``sparse/serialize.py``) fall into
patches given by ``cu_seqlens`` (``(P + 1,)`` int32, ascending, each patch
at most ``max_len`` rows); every row attends to every row of its own patch
with ``softmax(scale * q k^T) v``, per head, at head dimension 16.
``qkv`` is ``(rows, 3C)`` with head ``h``'s q, k and v at columns
``h*16``, ``C + h*16`` and ``2C + h*16`` (the ``(3, H, 16)`` layout of the
model's qkv projection); the output is ``(rows, C)``.

* :func:`patch_attn_fwd`: ``(out, lse)``, ``lse`` ``(rows, H)`` fp32, the
  log-sum-exp of each row's scaled scores: 1 launch
  (``csrc/patch_attn.cu``, online softmax in fp32);
* :func:`patch_attn_bwd`: ``dqkv`` from ``out``, ``lse`` and the
  cotangent, ``P`` recomputed from ``lse``: 2 launches (``dQ`` over query
  tiles, ``dK`` and ``dV`` over key tiles), no atomics.

A CUDA tensor launches the kernels or raises (bf16, C = 16 H, contiguous);
a CPU tensor takes the plain version (fp32 sums for bf16 and fp32 input,
fp64 for fp64), which is also the kernels' oracle.  Rows outside every
patch are zero in ``out``, ``lse`` and ``dqkv``: the kernels write them,
so the wrappers allocate the outputs without clearing them.  Each wrapper counts its launches
in ``<wrapper>.launches``.  :class:`PatchAttention` runs the forward and
the backward inside the span ``ptv3.attn``, the launches inside
``ptv3.attn_kernel``; the forward keeps ``qkv``, ``out`` and ``lse``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span
from . import _build

_LIB = "patch_attn"
HEAD_DIM = 16


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _patches(cu: torch.Tensor):
    """``(start, end)`` of each non-empty patch, on the host."""
    b = cu.tolist()
    return [(s, e) for s, e in zip(b[:-1], b[1:]) if e > s]


def _heads(qkv: torch.Tensor, heads: int):
    rows, c3 = qkv.shape
    c = c3 // 3
    if c3 != 3 * c or c != heads * HEAD_DIM:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not (rows, 3 x {heads} "
                         f"x {HEAD_DIM})")
    return qkv.view(rows, 3, heads, HEAD_DIM)


def patch_attn_fwd_plain(qkv, cu, heads: int, scale: float):
    """Plain version of :func:`patch_attn_fwd`, one patch at a time."""
    rows, c3 = qkv.shape
    acc = _acc(qkv.dtype)
    q, k, v = _heads(qkv, heads).to(acc).unbind(1)   # (rows, H, 16)
    out = torch.zeros((rows, heads, HEAD_DIM), dtype=acc, device=qkv.device)
    lse = torch.zeros((rows, heads), dtype=acc, device=qkv.device)
    for s, e in _patches(cu):
        sc = torch.einsum("qhd,khd->hqk", q[s:e], k[s:e]) * scale
        lse[s:e] = torch.logsumexp(sc, -1).t()
        out[s:e] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                v[s:e])
    return out.reshape(rows, c3 // 3).to(qkv.dtype), lse


def patch_attn_bwd_plain(qkv, out, lse, dout, cu, heads: int, scale: float):
    """Plain version of :func:`patch_attn_bwd`: ``P = exp(scale q k^T -
    lse)``, ``D = rowsum(dout * out)``, ``dS = P (dout v^T - D)``,
    ``dq = scale dS k``, ``dk = scale dS^T q``, ``dv = P^T dout``."""
    rows, c3 = qkv.shape
    acc = _acc(qkv.dtype)
    q, k, v = _heads(qkv, heads).to(acc).unbind(1)
    o = out.to(acc).view(rows, heads, HEAD_DIM)
    do = dout.to(acc).view(rows, heads, HEAD_DIM)
    lse = lse.to(acc)
    delta = (do * o).sum(-1)                          # (rows, H)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    for s, e in _patches(cu):
        sc = torch.einsum("qhd,khd->hqk", q[s:e], k[s:e]) * scale
        p = torch.exp(sc - lse[s:e].t()[:, :, None])
        dv[s:e] = torch.einsum("hqk,qhd->khd", p, do[s:e])
        dp = torch.einsum("qhd,khd->hqk", do[s:e], v[s:e])
        ds = p * (dp - delta[s:e].t()[:, :, None])
        dq[s:e] = torch.einsum("hqk,khd->qhd", ds, k[s:e]) * scale
        dk[s:e] = torch.einsum("hqk,qhd->khd", ds, q[s:e]) * scale
    return torch.stack([dq, dk, dv], 1).reshape(rows, c3).to(qkv.dtype)


def _check(qkv, cu, heads: int, *others) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"qkv must be a CUDA tensor, got {qkv.device}")
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise TypeError(f"qkv must be contiguous bfloat16, got {qkv.dtype}")
    _heads(qkv, heads)
    if (cu.dtype != torch.int32 or cu.dim() != 1 or cu.device != qkv.device
            or not cu.is_contiguous()):
        raise TypeError("cu_seqlens must be a contiguous int32 vector on "
                        "qkv's card")
    for t in others:
        if t.device != qkv.device or not t.is_contiguous():
            raise ValueError("every tensor must be contiguous on qkv's card")
    if qkv.shape[0] * qkv.shape[1] >= 2 ** 31:
        raise ValueError("fewer than 2**31 elements (32-bit row indices)")


def _bind() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if lib.patch_attn_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.patch_attn_fwd.argtypes = [p] * 4 + [i] * 5 + [f, p]
        lib.patch_attn_fwd.restype = ctypes.c_int
        lib.patch_attn_bwd.argtypes = [p] * 6 + [i] * 5 + [f, p]
        lib.patch_attn_bwd.restype = ctypes.c_int
    return lib


def patch_attn_fwd(qkv, cu, heads: int, scale: float, max_len: int):
    """``(out, lse)`` of the patches ``cu`` of ``qkv`` (see the module).
    CPU tensors take the plain version; CUDA tensors launch the kernel (1
    launch, no wait for the card) or raise."""
    if qkv.device.type == "cpu":
        return patch_attn_fwd_plain(qkv, cu, heads, scale)
    _check(qkv, cu, heads)
    rows, c = qkv.shape[0], qkv.shape[1] // 3
    out = torch.empty((rows, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((rows, heads), dtype=torch.float32, device=qkv.device)
    lib = _bind()
    with span("ptv3.attn_kernel"), torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.patch_attn_fwd(qkv.data_ptr(), out.data_ptr(),
                                 lse.data_ptr(), cu.data_ptr(),
                                 cu.numel() - 1, int(max_len), c, heads,
                                 rows, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"patch_attn_fwd launch failed: cudaError {err}")
    patch_attn_fwd.launches += 1
    return out, lse


patch_attn_fwd.launches = 0


def patch_attn_bwd(qkv, out, lse, dout, cu, heads: int, scale: float,
                   max_len: int):
    """``dqkv`` (rows, 3C) in qkv's dtype for the cotangent ``dout`` of
    ``out``.  CPU tensors take the plain version; CUDA tensors launch the
    kernels (2 launches) or raise."""
    if qkv.device.type == "cpu":
        return patch_attn_bwd_plain(qkv, out, lse, dout, cu, heads, scale)
    dout = dout.to(qkv.dtype).contiguous()
    _check(qkv, cu, heads, out, lse, dout)
    rows, c = qkv.shape[0], qkv.shape[1] // 3
    delta = (dout.float() * out.float()).view(rows, heads, HEAD_DIM).sum(-1)
    dqkv = torch.empty_like(qkv)
    lib = _bind()
    with span("ptv3.attn_kernel"), torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.patch_attn_bwd(qkv.data_ptr(), dout.data_ptr(),
                                 lse.data_ptr(), delta.data_ptr(),
                                 dqkv.data_ptr(), cu.data_ptr(),
                                 cu.numel() - 1, int(max_len), c, heads,
                                 rows, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"patch_attn_bwd launch failed: cudaError {err}")
    patch_attn_bwd.launches += 2
    return dqkv


patch_attn_bwd.launches = 0


class PatchAttention(torch.autograd.Function):
    """``apply(qkv, cu, heads, scale, max_len) -> out``: the forward by
    :func:`patch_attn_fwd`, the backward by :func:`patch_attn_bwd`."""

    @staticmethod
    def forward(ctx, qkv, cu, heads: int, scale: float, max_len: int):
        with span("ptv3.attn"):
            qkv = qkv.contiguous()
            out, lse = patch_attn_fwd(qkv, cu, heads, scale, max_len)
            ctx.save_for_backward(qkv, out, lse, cu)
            ctx.heads, ctx.scale, ctx.max_len = heads, scale, max_len
            return out

    @staticmethod
    def backward(ctx, dout):
        with span("ptv3.attn"):
            qkv, out, lse, cu = ctx.saved_tensors
            dqkv = patch_attn_bwd(qkv, out, lse, dout, cu, ctx.heads,
                                  ctx.scale, ctx.max_len)
            return dqkv, None, None, None, None
