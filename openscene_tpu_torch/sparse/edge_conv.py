"""k=2 s=2 edge convs: the kernels' wrappers, their plain versions and the
autograd Functions.

Counterpart of ``openscene_tpu/sparse/pallas_edge.py``:

* down conv (kernel ``make_down_kernel``, op ``windowed_down_conv``):
  ``out[p] = sum_{k<8} x_child[fwd[k, p]] @ W[k]`` over ``DownPlan.fwd``.
  The CUDA kernel is the same gather-GEMM-sum source as the stencil conv
  (``csrc/gather_gemm_fwd.cu``) at K = 8; ``down_conv_fwd`` has its own
  launch counter, ``down_conv_fwd.launches``.
* down-conv backward (kernel ``make_up_bwd_kernel``, op ``_down_conv_bwd``),
  over the children: ``dx[c] = g[parent(c)] @ W[offset(c)]^T`` and
  ``dW[k] = x[fwd[k]]^T @ g``.  dx is the gather-GEMM-sum over the index
  ``where(offset(c) == k, parent(c), none)``, dW the row-reduction kernel of
  ``csrc/gather_gemm_bwd.cu``; wrapper ``down_conv_bwd``.
* up conv (``mixed_up_conv``, the model's route, :class:`UpConv`): the
  forward is dense per-offset GEMMs on the parent level and one placement
  gather — plain tensor code (``up_conv_dense_fwd``), as in the JAX
  package, whose model runs no Pallas kernel there either.  Its backward
  (kernel ``make_down_bwd_kernel``, op ``_up_bwd_core``) runs over the
  parents: ``dx[p] = sum_k g[fwd[k, p]] @ W[k]^T`` and ``dW[k] = x^T @
  g[fwd[k]]``, the same two CUDA kernels; wrapper ``up_conv_bwd``.
* up conv over the children (kernel ``make_up_kernel``, op
  ``windowed_up_conv``, :class:`KernelUpConv`): ``out[c] = x[parent(c)] @
  W[offset(c)]``, each child row multiplied once by its own weight
  (``csrc/up_conv_fwd.cu``, wrapper ``up_conv_fwd``, rows grouped by
  offset here); its backward is ``up_conv_bwd``.  Not on the model's path:
  the per-op benchmark (``scripts/dev_bench_ops.py``) times it against the
  model's route.

Every wrapper takes its plain version only for a CPU tensor and counts its
launches in ``<wrapper>.launches`` (one per call that reaches the card).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ops import (gather_matmul_sum, matmul_f32, sparse_down_conv_bwd,
                  sparse_up_conv, sparse_up_conv_bwd)
from .stencil_conv import gather_gemm_cuda, gather_wgrad_cuda
from .types import DownPlan

_LIB_UP = "up_conv_fwd"
UP_TILE = 64  # csrc/up_conv_fwd.cu: BM, the child rows of one tile


def down_conv_plain(x: torch.Tensor, w: torch.Tensor, fwd: torch.Tensor
                    ) -> torch.Tensor:
    """Plain PyTorch version: one ``index_select`` + fp32 matmul per offset
    (sparse/ops.py:sparse_down_conv)."""
    return gather_matmul_sum(x, w, fwd).to(x.dtype)


def down_conv_fwd(x: torch.Tensor, w: torch.Tensor, fwd: torch.Tensor
                  ) -> torch.Tensor:
    """Down conv forward. x: (child_cap, Cin); w: (8, Cin, Cout) fp32;
    fwd: (8, parent_cap) int32.  Returns (parent_cap, Cout).  CPU tensors
    take the plain version; CUDA tensors launch the kernel (bf16 only) or
    raise."""
    if x.device.type == "cpu":
        return down_conv_plain(x, w, fwd)
    out = gather_gemm_cuda(x, w, fwd)
    down_conv_fwd.launches += 1
    return out


down_conv_fwd.launches = 0


# Plain PyTorch version of the backward (x, w, g, plan) -> (dx, dW)
down_conv_bwd_plain = sparse_down_conv_bwd


def down_conv_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                  plan: DownPlan):
    """Down conv backward: ``(dx, dW)`` for the cotangent ``g`` (parent_cap,
    Cout); dx (child_cap, Cin) in x.dtype, dW (8, Cin, Cout) fp32.

    ``g`` must be exactly zero at padded parent rows; dx then is exactly
    zero at padded child rows.  CPU tensors take the plain version; CUDA
    tensors launch the kernels (x bf16; ``g`` is cast to bf16 once) or raise.
    """
    if x.device.type == "cpu":
        return down_conv_bwd_plain(x, w, g, plan)
    gb = g.to(torch.bfloat16).contiguous()
    # one weight per child: offset k sees the child's parent, every other
    # offset a negative index, which the kernel reads as a zero row
    offsets = torch.arange(w.shape[0], dtype=torch.int32, device=x.device)
    idx = torch.where(plan.child_offset[None, :] == offsets[:, None],
                      plan.child_parent[None, :],
                      plan.child_parent.new_full((), -1))
    dx = gather_gemm_cuda(gb, w.transpose(1, 2), idx.contiguous())
    dw = gather_wgrad_cuda(gb, x, plan.fwd).transpose(1, 2).contiguous()
    down_conv_bwd.launches += 1
    return dx, dw


down_conv_bwd.launches = 0


class DownConv(torch.autograd.Function):
    """``DownConv.apply(x, w, fwd, child_parent, child_offset)``: forward is
    :func:`down_conv_fwd`, backward :func:`down_conv_bwd`.

    The output's cotangent must be exactly zero at padded parent rows (the
    model's BatchNorm re-masks); the returned dx is exactly zero at padded
    child rows."""

    @staticmethod
    def forward(ctx, x, w, fwd, child_parent, child_offset):
        ctx.save_for_backward(x, w, fwd, child_parent, child_offset)
        return down_conv_fwd(x, w, fwd)

    @staticmethod
    def backward(ctx, g):
        x, w, *plan = ctx.saved_tensors
        dx, dw = down_conv_bwd(x, w, g.contiguous(), DownPlan(*plan))
        return dx, dw.to(w.dtype), None, None, None


# mixed_up_conv's forward, the model's route: dense GEMMs on the parent
# level + one placement gather (x: (parent_cap, Cin); w: (8, Cin, Cout) ->
# (child_cap, Cout))
up_conv_dense_fwd = sparse_up_conv


def up_conv_plain(x: torch.Tensor, w: torch.Tensor, plan: DownPlan
                  ) -> torch.Tensor:
    """Plain PyTorch version of kernel 5: the child rows of each offset
    gather their parents and take one fp32 matmul with that offset's
    weight, rounded once.  x: (parent_cap, Cin); w: (8, Cin, Cout) fp32.
    Returns (child_cap, Cout) in x.dtype."""
    wc = w.to(x.dtype)
    out = x.new_zeros((plan.child_parent.shape[0], w.shape[2]))
    for k in range(w.shape[0]):
        rows = (plan.child_offset == k).nonzero()[:, 0]
        src = x.index_select(0, plan.child_parent.index_select(0, rows))
        out[rows] = matmul_f32(src, wc[k]).to(x.dtype)
    return out


def group_children(child_offset: torch.Tensor, n_offsets: int = 8):
    """Child rows grouped by offset for ``csrc/up_conv_fwd.cu``, on the
    device and without waiting for it: a stable sort into ``n_offsets``
    segments, each padded to a multiple of ``UP_TILE`` rows.  Returns
    ``(tile_rows, tile_k)``: (tiles * UP_TILE,) int32 child indices (-1 in
    the padding) and (tiles,) int32 offsets (-1 past the last segment), for
    the static ``tiles = ceil(child_cap / UP_TILE) + n_offsets``."""
    dev = child_offset.device
    cap = child_offset.shape[0]
    off = child_offset.to(torch.int64)
    order = torch.argsort(off, stable=True)
    soff = off[order]
    ks = torch.arange(n_offsets, device=dev)
    start = torch.searchsorted(soff, ks)
    count = torch.searchsorted(soff, ks, right=True) - start
    padded = (count + UP_TILE - 1) // UP_TILE * UP_TILE
    pend = torch.cumsum(padded, 0)
    pstart = pend - padded
    tiles = -(-cap // UP_TILE) + n_offsets
    dest = pstart[soff] + torch.arange(cap, device=dev) - start[soff]
    tile_rows = torch.full((tiles * UP_TILE,), -1, dtype=torch.int32,
                           device=dev)
    tile_rows[dest] = order.to(torch.int32)
    tile_k = torch.searchsorted(
        pend, torch.arange(tiles, device=dev) * UP_TILE, right=True)
    tile_k = torch.where(tile_k < n_offsets, tile_k,
                         torch.full_like(tile_k, -1)).to(torch.int32)
    return tile_rows, tile_k


def _bind_up() -> ctypes.CDLL:
    lib = _build.load(_LIB_UP)
    fn = lib.up_conv_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def up_conv_fwd(x: torch.Tensor, w: torch.Tensor, plan: DownPlan
                ) -> torch.Tensor:
    """Up conv forward over the children (kernel 5).  x: (parent_cap, Cin),
    exactly zero at padded rows; w: (8, Cin, Cout) fp32; plan: the edge's
    DownPlan (``child_parent``, ``child_offset`` in 0..7, int32, each
    parent index below parent_cap).  Returns (child_cap, Cout); padded
    child rows are exactly zero.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (x bf16, Cin and Cout multiples of 8) or
    raise."""
    if x.device.type == "cpu":
        return up_conv_plain(x, w, plan)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    K, cin, cout = w.shape
    cp, co = plan.child_parent, plan.child_offset
    if x.dim() != 2 or x.shape[1] != cin or K != 8:
        raise ValueError(f"x{tuple(x.shape)} and w{tuple(w.shape)} disagree")
    if cin % 8 or cout % 8:
        raise ValueError(f"Cin={cin} and Cout={cout} must be multiples of 8")
    if cp.dtype != torch.int32 or co.dtype != torch.int32:
        raise TypeError("child_parent and child_offset must be int32")
    if not (x.is_contiguous() and cp.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("x and child_parent must be contiguous, x 16-byte "
                         "aligned")
    if w.device != x.device or cp.device != x.device or co.device != x.device:
        raise ValueError("x, w and the plan must share one device")
    child_cap = cp.shape[0]
    if max(x.numel(), child_cap * cout) >= 2 ** 31:
        raise ValueError("sizes beyond the kernel's 32-bit indexing")
    if child_cap == 0:
        return torch.empty((0, cout), dtype=torch.bfloat16, device=x.device)
    out = launch_up_conv(x, w.to(torch.bfloat16).contiguous(), cp,
                         *group_children(co))
    up_conv_fwd.launches += 1
    return out


def launch_up_conv(x: torch.Tensor, wb: torch.Tensor,
                   child_parent: torch.Tensor, tile_rows: torch.Tensor,
                   tile_k: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/up_conv_fwd.cu`` on rows already grouped by
    :func:`group_children` (``up_conv_fwd`` checks the arguments; wb is
    the bf16 weight).  Returns (child_cap, Cout) bf16."""
    cout = wb.shape[2]
    out = torch.empty((child_parent.shape[0], cout), dtype=torch.bfloat16,
                      device=x.device)
    lib = _bind_up()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.up_conv_fwd_bf16(x.data_ptr(), wb.data_ptr(),
                                   child_parent.data_ptr(),
                                   tile_rows.data_ptr(), tile_k.data_ptr(),
                                   out.data_ptr(), tile_k.shape[0],
                                   wb.shape[1], cout, stream)
    if err != 0:
        raise RuntimeError(f"up_conv_fwd launch failed: cudaError {err}")
    return out


up_conv_fwd.launches = 0


# Plain PyTorch version of the backward (x, w, g, plan) -> (dx, dW)
up_conv_bwd_plain = sparse_up_conv_bwd


def up_conv_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                plan: DownPlan):
    """Up conv backward: ``(dx, dW)`` for the cotangent ``g`` (child_cap,
    Cout); dx (parent_cap, Cin) in x.dtype, dW (8, Cin, Cout) fp32.

    ``g`` must be exactly zero at padded child rows; dx then is exactly
    zero at padded parent rows.  CPU tensors take the plain version; CUDA
    tensors launch the kernels (x bf16; ``g`` is cast to bf16 once) or raise.
    """
    if x.device.type == "cpu":
        return up_conv_bwd_plain(x, w, g, plan)
    gb = g.to(torch.bfloat16).contiguous()
    dx = gather_gemm_cuda(gb, w.transpose(1, 2), plan.fwd)
    dw = gather_wgrad_cuda(x, gb, plan.fwd)
    up_conv_bwd.launches += 1
    return dx, dw


up_conv_bwd.launches = 0


class UpConv(torch.autograd.Function):
    """``UpConv.apply(x, w, fwd, child_parent, child_offset)``, the model's
    up conv: forward is :func:`up_conv_dense_fwd` (plain tensor code),
    backward :func:`up_conv_bwd`.

    The output's cotangent must be exactly zero at padded child rows (the
    model's BatchNorm re-masks); the returned dx is exactly zero at padded
    parent rows."""

    @staticmethod
    def forward(ctx, x, w, fwd, child_parent, child_offset):
        ctx.save_for_backward(x, w, fwd, child_parent, child_offset)
        return up_conv_dense_fwd(x, w,
                                 DownPlan(fwd, child_parent, child_offset))

    @staticmethod
    def backward(ctx, g):
        x, w, *plan = ctx.saved_tensors
        dx, dw = up_conv_bwd(x, w, g.contiguous(), DownPlan(*plan))
        return dx, dw.to(w.dtype), None, None, None


class KernelUpConv(UpConv):
    """``KernelUpConv.apply(x, w, fwd, child_parent, child_offset)``: the
    up conv with kernel 5 as its forward (:func:`up_conv_fwd`, the
    counterpart of ``windowed_up_conv``) and the same backward as
    :class:`UpConv` (:func:`up_conv_bwd`, kernel 4, as in the JAX package).
    """

    @staticmethod
    def forward(ctx, x, w, fwd, child_parent, child_offset):
        ctx.save_for_backward(x, w, fwd, child_parent, child_offset)
        return up_conv_fwd(x, w, DownPlan(fwd, child_parent, child_offset))
