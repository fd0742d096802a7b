"""k=2 s=2 edge convs: the down-conv kernel's wrapper and plain version, and
the up-conv forward as plain tensor code.

Counterpart of ``openscene_tpu/sparse/pallas_edge.py``:

* down conv (kernel ``make_down_kernel``, op ``windowed_down_conv``):
  ``out[p] = sum_{k<8} x_child[fwd[k, p]] @ W[k]`` over ``DownPlan.fwd``.
  The CUDA kernel is the same gather-GEMM-sum source as the stencil conv
  (``csrc/gather_gemm_fwd.cu``) at K = 8; ``down_conv_fwd`` has its own
  launch counter, ``down_conv_fwd.launches``.
* up conv (``mixed_up_conv``'s forward): dense per-offset GEMMs on the
  parent level and one placement gather — plain tensor code, as in the JAX
  package, where no Pallas kernel runs it either.
"""

from __future__ import annotations

import torch

from .ops import gather_matmul_sum, sparse_up_conv
from .stencil_conv import gather_gemm_cuda


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


# mixed_up_conv's forward: dense GEMMs on the parent level + one placement
# gather (x: (parent_cap, Cin); w: (8, Cin, Cout) -> (child_cap, Cout))
up_conv_fwd = sparse_up_conv
