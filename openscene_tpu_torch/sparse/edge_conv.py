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
* up conv (``mixed_up_conv``): the forward is dense per-offset GEMMs on the
  parent level and one placement gather — plain tensor code, as in the JAX
  package, where no Pallas kernel runs it either.  Its backward (kernel
  ``make_down_bwd_kernel``, op ``_up_bwd_core``) runs over the parents:
  ``dx[p] = sum_k g[fwd[k, p]] @ W[k]^T`` and ``dW[k] = x^T @ g[fwd[k]]``,
  the same two CUDA kernels; wrapper ``up_conv_bwd``.

Every wrapper takes its plain version only for a CPU tensor and counts its
launches in ``<wrapper>.launches`` (one per call that reaches the card).
"""

from __future__ import annotations

import torch

from .ops import (gather_matmul_sum, sparse_down_conv_bwd, sparse_up_conv,
                  sparse_up_conv_bwd)
from .stencil_conv import gather_gemm_cuda, gather_wgrad_cuda
from .types import DownPlan


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


# mixed_up_conv's forward: dense GEMMs on the parent level + one placement
# gather (x: (parent_cap, Cin); w: (8, Cin, Cout) -> (child_cap, Cout))
up_conv_fwd = sparse_up_conv


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
    """``UpConv.apply(x, w, fwd, child_parent, child_offset)``: forward is
    :func:`up_conv_fwd` (plain tensor code), backward :func:`up_conv_bwd`.

    The output's cotangent must be exactly zero at padded child rows (the
    model's BatchNorm re-masks); the returned dx is exactly zero at padded
    parent rows."""

    @staticmethod
    def forward(ctx, x, w, fwd, child_parent, child_offset):
        ctx.save_for_backward(x, w, fwd, child_parent, child_offset)
        return up_conv_fwd(x, w, DownPlan(fwd, child_parent, child_offset))

    @staticmethod
    def backward(ctx, g):
        x, w, *plan = ctx.saved_tensors
        dx, dw = up_conv_bwd(x, w, g.contiguous(), DownPlan(*plan))
        return dx, dw.to(w.dtype), None, None, None
