"""k=3 stencil conv: the CUDA kernels, their wrappers, their plain versions
and the autograd Function.

Counterpart of ``openscene_tpu/sparse/pallas_conv.py`` (kernels
``make_fwd_kernel`` and ``make_bwd_kernel``, op ``windowed_sparse_conv``).
The function is

    out[r] = sum_k x[fwd[k, r]] @ W[k]

with ``fwd`` the plain ``ConvPlan.fwd`` map, and its backward, with
``G_k = g[fwd[k]]``,

    dx = sum_k G_k @ W[flip k]^T        dW[flip k] = x^T @ G_k

The TPU kernels' window plans, pair packing and spill corrections have no
counterpart: the CUDA kernels gather rows through ``fwd`` themselves.
``csrc/gather_gemm_fwd.cu`` computes the forward and, on the cotangent, the
backward's ``dx``; ``csrc/gather_gemm_bwd.cu`` computes ``dW``.

``stencil_conv_fwd`` and ``stencil_conv_bwd`` launch the kernels for a CUDA
tensor and take the plain versions only for a CPU tensor; each counts its
launches in ``<wrapper>.launches`` (one per call that reaches the card).
:class:`StencilConv` ties the two into autograd.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ops import gather_matmul_sum, sparse_conv_bwd

_LIB = "gather_gemm_fwd"
_LIB_BWD = "gather_gemm_bwd"

# How gather_wgrad_cuda splits the row reduction: enough blocks to fill the
# card at the small levels, at least this many rows per partial tile so the
# fp32 partials stay a small share of the traffic.
WGRAD_TARGET_BLOCKS = 2048
WGRAD_MIN_ROWS_PER_SPLIT = 1024
_WGRAD_TILE = 64   # csrc/gather_gemm_bwd.cu: BM = BN
_WGRAD_STEP = 32   # csrc/gather_gemm_bwd.cu: BR


def _bind() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    fn = lib.gather_gemm_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bind_bwd() -> ctypes.CDLL:
    lib = _build.load(_LIB_BWD)
    fn = lib.gather_wgrad_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def gather_gemm_cuda(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """Launch ``csrc/gather_gemm_fwd.cu`` once: ``sum_k x[idx[k]] @ w[k]``.

    x: (rows_in, Cin) bf16 CUDA, contiguous; w: (K, Cin, Cout) float weights
    (cast to bf16 here, once per call); idx: (K, rows_out) int32 CUDA,
    contiguous, every entry below rows_in; a negative entry contributes
    zero.  Cin and Cout must be multiples of 8.  Returns (rows_out, Cout)
    bf16.  Raises on anything else, and if the launch is refused.
    """
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.dim() != 2 or w.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"idx{tuple(idx.shape)}: want (N, Cin), "
                         "(K, Cin, Cout), (K, rows_out)")
    K, cin, cout = w.shape
    if x.shape[1] != cin or idx.shape[0] != K:
        raise ValueError(f"x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"idx{tuple(idx.shape)} disagree")
    if cin % 8 or cout % 8:
        raise ValueError(f"Cin={cin} and Cout={cout} must be multiples of 8")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous")
    if w.device != x.device or idx.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}, idx on "
                         f"{idx.device}: all must share one device")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    rows_out = idx.shape[1]
    if max(x.numel(), K * rows_out, rows_out * cout) >= 2 ** 31:
        raise ValueError("sizes beyond the kernel's 32-bit indexing")
    wb = w.to(torch.bfloat16).contiguous()
    out = torch.empty((rows_out, cout), dtype=torch.bfloat16,
                      device=x.device)
    if rows_out == 0:
        return out
    lib = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gather_gemm_fwd_bf16(x.data_ptr(), wb.data_ptr(),
                                       idx.data_ptr(), out.data_ptr(),
                                       rows_out, K, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"gather_gemm_fwd launch failed: cudaError {err}")
    return out


def wgrad_split(rows: int, K: int, ca: int, cb: int):
    """(rows_per_split, splits) of one ``gather_wgrad_cuda`` call."""
    tiles = -(-ca // _WGRAD_TILE) * -(-cb // _WGRAD_TILE)
    want = max(1, WGRAD_TARGET_BLOCKS // (K * tiles))
    per = max(WGRAD_MIN_ROWS_PER_SPLIT, -(-rows // want))
    per = -(-per // _WGRAD_STEP) * _WGRAD_STEP
    return per, max(1, -(-rows // per))


def gather_wgrad_cuda(a: torch.Tensor, b: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """Launch ``csrc/gather_gemm_bwd.cu``: ``dw[k] = a^T @ b[idx[k]]``.

    a: (rows, Ca) bf16 CUDA, contiguous; b: (rows_b, Cb) bf16, contiguous;
    idx: (K, rows) int32, contiguous, every entry below rows_b (a negative
    entry contributes zero).  Ca and Cb must be multiples of 8.  Returns
    (K, Ca, Cb) fp32, deterministic (fixed-order sum of row-split partials).
    Raises on anything else, and if a launch is refused.
    """
    if a.device.type != "cuda":
        raise ValueError(f"a must be a CUDA tensor, got {a.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"a and b must be bfloat16, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"shapes a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"idx{tuple(idx.shape)}: want (rows, Ca), "
                         "(rows_b, Cb), (K, rows)")
    rows, ca = a.shape
    cb = b.shape[1]
    K = idx.shape[0]
    if idx.shape[1] != rows:
        raise ValueError(f"a{tuple(a.shape)} and idx{tuple(idx.shape)} "
                         "disagree")
    if ca % 8 or cb % 8:
        raise ValueError(f"Ca={ca} and Cb={cb} must be multiples of 8")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not (a.is_contiguous() and b.is_contiguous() and idx.is_contiguous()):
        raise ValueError("a, b and idx must be contiguous")
    if b.device != a.device or idx.device != a.device:
        raise ValueError(f"a on {a.device}, b on {b.device}, idx on "
                         f"{idx.device}: all must share one device")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a and b must be 16-byte aligned")
    if max(a.numel(), b.numel(), K * rows) >= 2 ** 31:
        raise ValueError("sizes beyond the kernel's 32-bit indexing")
    out = torch.empty((K, ca, cb), dtype=torch.float32, device=a.device)
    if rows == 0 or K == 0:
        return out.zero_()
    per, splits = wgrad_split(rows, K, ca, cb)
    if splits > 65535:
        raise ValueError(f"{splits} row splits exceed the grid")
    part = out if splits == 1 else torch.empty(
        (splits, K, ca, cb), dtype=torch.float32, device=a.device)
    lib = _bind_bwd()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.gather_wgrad_bf16(a.data_ptr(), b.data_ptr(),
                                    idx.data_ptr(), part.data_ptr(),
                                    out.data_ptr(), rows, K, ca, cb, per,
                                    splits, stream)
    if err != 0:
        raise RuntimeError(f"gather_wgrad launch failed: cudaError {err}")
    return out


def stencil_conv_plain(x: torch.Tensor, w: torch.Tensor, fwd: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch version: one ``index_select`` + fp32 matmul per offset
    (sparse/ops.py:sparse_conv)."""
    return gather_matmul_sum(x, w, fwd).to(x.dtype)


def stencil_conv_fwd(x: torch.Tensor, w: torch.Tensor, fwd: torch.Tensor
                     ) -> torch.Tensor:
    """Stencil conv forward. x: (cap, Cin); w: (K, Cin, Cout) fp32;
    fwd: (K, cap) int32.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16 only) or raise."""
    if x.device.type == "cpu":
        return stencil_conv_plain(x, w, fwd)
    out = gather_gemm_cuda(x, w, fwd)
    stencil_conv_fwd.launches += 1
    return out


stencil_conv_fwd.launches = 0


# Plain PyTorch version of the backward: ``(dx, dW)`` with dx in x.dtype and
# dW fp32 (x, w, g, fwd, flip_perm)
stencil_conv_bwd_plain = sparse_conv_bwd


def stencil_conv_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     fwd: torch.Tensor, flip_perm: torch.Tensor):
    """Stencil conv backward: ``(dx, dW)`` for the cotangent ``g`` (cap,
    Cout) of the output; dx (cap, Cin) in x.dtype, dW (K, Cin, Cout) fp32.

    ``g`` must be exactly zero at padded rows; dx then is too.  CPU tensors
    take the plain version; CUDA tensors launch the kernels (x bf16; ``g``
    is cast to bf16 once) or raise.
    """
    if x.device.type == "cpu":
        return stencil_conv_bwd_plain(x, w, g, fwd, flip_perm)
    gb = g.to(torch.bfloat16).contiguous()
    perm = flip_perm.long()
    dx = gather_gemm_cuda(gb, w.index_select(0, perm).transpose(1, 2), fwd)
    # un-permute: the kernel's row k holds dW[flip k]
    dw = gather_wgrad_cuda(x, gb, fwd).index_select(0, perm)
    stencil_conv_bwd.launches += 1
    return dx, dw


stencil_conv_bwd.launches = 0


class StencilConv(torch.autograd.Function):
    """``StencilConv.apply(x, w, fwd, flip_perm)``: forward is
    :func:`stencil_conv_fwd`, backward :func:`stencil_conv_bwd`.

    The zero-padding invariant holds for cotangents too: the backward gathers
    the output's cotangent through the same plan, so it must be exactly zero
    at padded rows (in the model BatchNorm's re-masking sees to it), and the
    returned dx is exactly zero there.
    """

    @staticmethod
    def forward(ctx, x, w, fwd, flip_perm):
        ctx.save_for_backward(x, w, fwd, flip_perm)
        return stencil_conv_fwd(x, w, fwd)

    @staticmethod
    def backward(ctx, g):
        x, w, fwd, flip_perm = ctx.saved_tensors
        dx, dw = stencil_conv_bwd(x, w, g.contiguous(), fwd, flip_perm)
        return dx, dw.to(w.dtype), None, None
