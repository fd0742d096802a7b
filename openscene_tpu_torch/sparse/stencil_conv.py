"""k=3 stencil-conv forward: the CUDA kernel, its wrapper and its plain
version.

Counterpart of ``openscene_tpu/sparse/pallas_conv.py`` (kernel
``make_fwd_kernel``, op ``windowed_sparse_conv``).  The function is

    out[r] = sum_k x[fwd[k, r]] @ W[k]

with ``fwd`` the plain ``ConvPlan.fwd`` map.  The TPU kernel's window plans,
pair packing and spill corrections have no counterpart: the CUDA kernel
(``csrc/gather_gemm_fwd.cu``) gathers rows through ``fwd`` itself.

``stencil_conv_fwd`` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor; ``stencil_conv_fwd.launches`` counts
its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ops import gather_matmul_sum

_LIB = "gather_gemm_fwd"


def _bind() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    fn = lib.gather_gemm_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def gather_gemm_cuda(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """Launch ``csrc/gather_gemm_fwd.cu`` once: ``sum_k x[idx[k]] @ w[k]``.

    x: (rows_in, Cin) bf16 CUDA, contiguous; w: (K, Cin, Cout) float weights
    (cast to bf16 here, once per call); idx: (K, rows_out) int32 CUDA,
    contiguous, every entry in [0, rows_in).  Cin and Cout must be multiples
    of 8.  Returns (rows_out, Cout) bf16.  Raises on anything else, and if
    the launch is refused.
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
