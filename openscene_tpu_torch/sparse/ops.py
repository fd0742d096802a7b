"""Sparse tensor ops on padded static-shape buffers: the plain versions.

Counterpart of ``openscene_tpu/sparse/ops.py``: the forward functions and
their backward functions, written out as the JAX package's VJPs are.  Rows
``[0, num)`` of every buffer are valid; padded rows, including the reserved
null row ``cap-1``, are exactly zero, and every gather that has no source
points into that zero padding, so the convolutions need no masking.

Precision: weights are stored fp32 and cast to the activation dtype
(bfloat16 on the main path); gathered rows times weights are summed in fp32
and the sum is cast back to the activation dtype (fp64 activations, which
only the tests use, are multiplied and summed in fp64).  Every product of
two bf16 values is exact in fp32, so the plain version differs from a kernel
only in the order of its fp32 sums.

The backward functions keep the same discipline: the cotangent ``g`` is
cast to the activation dtype once, ``dx`` is accumulated over the offsets in
fp32 and rounded once, and ``dW`` is an fp32 sum of products.  Autograd of
the plain forward would instead round ``dx`` once per offset (one
``index_add`` per ``index_select``).  They gather ``g`` through the same
plans as the forward, so they assume ``g`` is exactly zero at padded rows
(true in the model: BatchNorm re-masks its output), and they return ``dx``
exactly zero there.

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


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two same-dtype operands, multiplied and summed in fp32
    (fp64 operands stay fp64).

    Callers cast the fp32 result back to their activation dtype, which
    reproduces a bf16 x bf16 product with fp32 accumulation on any device.
    """
    acc = _acc_dtype(a.dtype)
    return torch.matmul(a.to(acc), b.to(acc))


def gather_matmul_sum(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """``sum_k x[idx[k]] @ w[k]`` in fp32: one ``index_select`` and one
    matmul per offset.

    x: (rows_in, Cin); w: (K, Cin, Cout) fp32, cast to x.dtype;
    idx: (K, rows_out) int.  Returns (rows_out, Cout) fp32.
    """
    wc = w.to(x.dtype)
    acc = torch.zeros((idx.shape[1], w.shape[2]),
                      dtype=_acc_dtype(x.dtype), device=x.device)
    for k in range(idx.shape[0]):
        acc += matmul_f32(x.index_select(0, idx[k]), wc[k])
    return acc


def sparse_conv(x, w, fwd):
    """Stride-1 stencil convolution on one level.

    x: (cap, Cin) activations, zeros at padded rows; w: (K, Cin, Cout) fp32;
    fwd: (K, cap) int gather plan.  Returns (cap, Cout) in x.dtype.
    """
    return gather_matmul_sum(x, w, fwd).to(x.dtype)


def gather_wgrad(a: torch.Tensor, b: torch.Tensor, idx: torch.Tensor
                 ) -> torch.Tensor:
    """``dw[k] = a^T @ b[idx[k]]`` in fp32: the weight gradient of a
    gather-GEMM-sum, whose reduction runs over the rows.

    a: (rows, Ca); b: (rows_b, Cb), same dtype; idx: (K, rows) int.
    Returns (K, Ca, Cb) fp32.
    """
    at = a.t()
    return torch.stack([matmul_f32(at, b.index_select(0, idx[k]))
                        for k in range(idx.shape[0])])


def sparse_conv_bwd(x, w, g, fwd, flip_perm):
    """Backward of :func:`sparse_conv`: ``(dx, dW)`` for the cotangent ``g``
    of its output.  One gather of ``g`` per offset serves both: with
    ``G_k = g[fwd[k]]`` (the transpose map of the mirrored offset),

        dx = sum_k G_k @ w[flip k]^T        dW[flip k] = x^T @ G_k

    dx: (cap, Cin) in x.dtype; dW: (K, Cin, Cout) fp32.
    """
    g = g.to(x.dtype)
    w_flip_t = w.index_select(0, flip_perm.long()).transpose(1, 2)
    dx = gather_matmul_sum(g, w_flip_t, fwd).to(x.dtype)
    dw_flip = gather_wgrad(x, g, fwd)
    # un-permute: row k of the result holds dW[k]
    return dx, dw_flip.index_select(0, flip_perm.long())


def sparse_down_conv(x, w, plan: DownPlan):
    """kernel=2, stride=2 down conv: fine level -> coarse level.

    x: (child_cap, Cin); w: (8, Cin, Cout); returns (parent_cap, Cout).
    Each child feeds exactly one (parent, offset) pair.
    """
    return gather_matmul_sum(x, w, plan.fwd).to(x.dtype)


def sparse_down_conv_bwd(x, w, g, plan: DownPlan):
    """Backward of :func:`sparse_down_conv`.  Each child has one (parent,
    offset) pair, so ``dx[c] = g[parent(c)] @ w[offset(c)]^T`` is a
    transform of the (small) parent level and one placement gather, and
    ``dW[k] = x[fwd[k]]^T @ g``.

    g: (parent_cap, Cout).  dx: (child_cap, Cin) in x.dtype; dW fp32.
    """
    g = g.to(x.dtype)
    y = matmul_f32(g.unsqueeze(0), w.transpose(1, 2).to(x.dtype)
                   ).to(x.dtype)                             # (8, P, Cin)
    flat_idx = plan.child_offset.long() * g.shape[0] + plan.child_parent
    dx = y.reshape(-1, x.shape[1]).index_select(0, flat_idx)
    dw = gather_wgrad(g, x, plan.fwd).transpose(1, 2)
    return dx, dw


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


def sparse_up_conv_bwd(x, w, g, plan: DownPlan):
    """Backward of :func:`sparse_up_conv`, over the parent rows: with
    ``G_k = g[fwd[k]]`` (the child of each parent at offset k),

        dx = sum_k G_k @ w[k]^T             dW[k] = x^T @ G_k

    g: (child_cap, Cout).  dx: (parent_cap, Cin) in x.dtype; dW fp32.
    """
    g = g.to(x.dtype)
    dx = gather_matmul_sum(g, w.transpose(1, 2), plan.fwd).to(x.dtype)
    return dx, gather_wgrad(x, g, plan.fwd)


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
