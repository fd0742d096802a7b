"""Pair-packed transpose: the CUDA kernel's wrapper and its plain version.

Counterpart of the Pallas kernel ``scripts/dev_pack_bench.py:
_pack_kernel_call`` (with its pairing pass ``pack_pallas``) and of the
function it is held to, ``openscene_tpu/sparse/pallas_conv.py:_pack_t``:
a (cap, C) bf16 activation becomes (cap/128, C/2, 128) 32-bit words,

    word[r, j] = bits(x[r, 2j]) | bits(x[r, 2j+1]) << 16
    o[t, j, r'] = word[128 t + r', j]

the TPU kernels' gather-ready layout (channel pairs in 32-bit lanes, rows
on the lane axis).  The CUDA kernels of the port read plain row-major rows
and never need it; the kernel exists so every TPU kernel has a counterpart
on the card, and ``scripts/dev_pack_bench.py`` times it.

``pack_pairs_t`` launches ``csrc/pack_pairs_t.cu`` for a CUDA tensor and
takes the plain version only for a CPU tensor; it counts its launches in
``pack_pairs_t.launches``.  The result is int32 (``.view(torch.float32)``
gives the JAX function's float32 bits).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_LIB = "pack_pairs_t"
ROWS = 128  # rows per group: the output's last axis


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise TypeError(f"x must be a 2-d bfloat16 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    cap, c = x.shape
    if c % 2 or cap % ROWS:
        raise ValueError(f"shape {tuple(x.shape)}: C must be even and cap a "
                         f"multiple of {ROWS}")


def pack_pairs_t_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: pair the channels with integer arithmetic,
    then one transposing copy."""
    _check(x)
    cap, c = x.shape
    h = x.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    word = (h[:, 0::2] | (h[:, 1::2] << 16)).to(torch.int32)  # wraps to int32
    return word.reshape(cap // ROWS, ROWS, c // 2).transpose(1, 2).contiguous()


def _bind() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    fn = lib.pack_pairs_t_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def pack_pairs_t(x: torch.Tensor) -> torch.Tensor:
    """(cap, C) bf16 -> (cap/128, C/2, 128) int32 words.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (contiguous, C a
    multiple of 8 for its 16-byte loads) or raise."""
    if x.device.type == "cpu":
        return pack_pairs_t_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    _check(x)
    cap, c = x.shape
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if x.numel() >= 2 ** 31:
        raise ValueError("sizes beyond the kernel's 32-bit indexing")
    out = torch.empty((cap // ROWS, c // 2, ROWS), dtype=torch.int32,
                      device=x.device)
    if cap == 0:
        return out
    lib = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pack_pairs_t_bf16(x.data_ptr(), out.data_ptr(), cap // ROWS,
                                    c // 2, stream)
    if err != 0:
        raise RuntimeError(f"pack_pairs_t launch failed: cudaError {err}")
    pack_pairs_t.launches += 1
    return out


pack_pairs_t.launches = 0
