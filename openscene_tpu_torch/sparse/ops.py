"""Sparse tensor ops on padded static-shape buffers: the plain versions.

Counterpart of ``openscene_tpu/sparse/ops.py`` (forward only).  Rows
``[0, num)`` of every buffer are valid; padded rows, including the reserved
null row ``cap-1``, are exactly zero, and every gather that has no source
points into that zero padding, so the convolutions need no masking.

Precision: weights are stored fp32 and cast to the activation dtype
(bfloat16 on the main path); gathered rows times weights are summed in fp32
and the sum is cast back to the activation dtype.  Every product of two
bf16 values is exact in fp32, so the plain version differs from a kernel
only in the order of its fp32 sums.

These functions are the oracles of the CUDA kernels and the CPU path of
their wrappers (:mod:`.stencil_conv`, :mod:`.edge_conv`).  The model calls
the wrappers, never these convolutions directly.
"""

from __future__ import annotations

import torch

from .types import DownPlan


def valid_mask(num: int, cap: int, dtype=torch.float32, device=None):
    """(cap, 1) mask of valid rows."""
    return (torch.arange(cap, device=device)[:, None] < int(num)).to(dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two same-dtype operands, multiplied and summed in fp32.

    Callers cast the fp32 result back to their activation dtype, which
    reproduces a bf16 x bf16 product with fp32 accumulation on any device.
    """
    return torch.matmul(a.float(), b.float())


def gather_matmul_sum(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """``sum_k x[idx[k]] @ w[k]`` in fp32: one ``index_select`` and one
    matmul per offset.

    x: (rows_in, Cin); w: (K, Cin, Cout) fp32, cast to x.dtype;
    idx: (K, rows_out) int.  Returns (rows_out, Cout) fp32.
    """
    wc = w.to(x.dtype)
    acc = torch.zeros((idx.shape[1], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    for k in range(idx.shape[0]):
        acc += matmul_f32(x.index_select(0, idx[k]), wc[k])
    return acc


def sparse_conv(x, w, fwd):
    """Stride-1 stencil convolution on one level.

    x: (cap, Cin) activations, zeros at padded rows; w: (K, Cin, Cout) fp32;
    fwd: (K, cap) int gather plan.  Returns (cap, Cout) in x.dtype.
    """
    return gather_matmul_sum(x, w, fwd).to(x.dtype)


def sparse_down_conv(x, w, plan: DownPlan):
    """kernel=2, stride=2 down conv: fine level -> coarse level.

    x: (child_cap, Cin); w: (8, Cin, Cout); returns (parent_cap, Cout).
    Each child feeds exactly one (parent, offset) pair.
    """
    return gather_matmul_sum(x, w, plan.fwd).to(x.dtype)


def sparse_up_conv(x, w, plan: DownPlan):
    """kernel=2, stride=2 transposed conv: coarse level -> fine level.

    x: (parent_cap, Cin); w: (8, Cin, Cout); returns (child_cap, Cout).
    Dense per-offset GEMMs on the (small) coarse level, then ONE gather to
    place each child's value — the exact inverse of the down conv on the
    cached finer coordinates (ME transpose-conv semantics).
    """
    y = matmul_f32(x.unsqueeze(0), w.to(x.dtype)).to(x.dtype)  # (8, P, Cout)
    flat_idx = plan.child_offset.long() * x.shape[0] + plan.child_parent
    return y.reshape(-1, w.shape[-1]).index_select(0, flat_idx)


def masked_batch_norm(x, mask, num, gamma, beta, running_mean, running_var,
                      *, train: bool, momentum: float = 0.1,
                      eps: float = 1e-5):
    """BatchNorm over valid rows only (MinkowskiBatchNorm semantics).

    x: (cap, C); mask: (cap, 1) fp32; num: valid-row count.
    Returns (out, new_running_mean, new_running_var); out is computed in
    fp32 and re-masked so padded rows stay exactly zero despite beta.
    """
    xf = x.float()
    n = float(max(int(num), 1))
    if train:
        mean = (xf * mask).sum(0) / n
        centered = (xf - mean) * mask
        var = (centered * centered).sum(0) / n  # biased, like torch BN
        unbiased = var * n / max(n - 1.0, 1.0)
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps)
    out = ((xf - mean) * inv * gamma + beta) * mask
    return out.to(x.dtype), new_mean, new_var


def relu(x):
    return torch.relu(x)
