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

The model's BatchNorm and 1x1 convs have no kernel of their own: the model
calls :func:`masked_batch_norm` and :func:`conv1x1` here, which train
through autograd Functions (spans ``unet.bn`` and ``unet.conv1x1``, in
the forward and the backward) that keep the compute-dtype input for the
backward, not fp32 copies of it.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
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


def matmul_rounded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' dtype: fp32 (fp64) products and sums,
    rounded once.  On CUDA a bf16 GEMM with fp32 accumulation (cuBLAS;
    ``device.resolve_device`` turns reduced-precision reductions off); on
    the CPU :func:`matmul_f32` and a cast."""
    if a.is_cuda:
        return torch.matmul(a, b)
    return matmul_f32(a, b).to(a.dtype)


class Conv1x1Fn(torch.autograd.Function):
    """A 1x1 conv ``x @ w`` (x: (rows, Cin) in the compute dtype, w: (Cin,
    Cout) fp32) whose backward keeps ``x`` and the weight cast to x's
    dtype, not fp32 copies.

    Forward and ``dx`` are :func:`matmul_rounded` (fp32 sums, one rounding
    to x's dtype), as ``matmul_f32(...).to(x.dtype)`` computes them; ``dW``
    is fp32 (on CUDA cuBLAS's GEMM with an fp32 output).  ``dx`` is skipped
    where ``x`` needs no gradient (the constant-input stem's occupancy).
    Zero rows of ``x`` and of the cotangent give zero rows of the output
    and of ``dx``.
    """

    @staticmethod
    def forward(ctx, x, w):
        with span("unet.conv1x1"):
            wc = w.to(x.dtype)
            ctx.save_for_backward(x, wc)
            ctx.w_dtype = w.dtype
            return matmul_rounded(x, wc)

    @staticmethod
    def backward(ctx, g):
        with span("unet.conv1x1"):
            x, wc = ctx.saved_tensors
            g = g.to(x.dtype)
            dx = (matmul_rounded(g, wc.t()) if ctx.needs_input_grad[0]
                  else None)
            if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
                dw = torch.mm(x.t(), g, out_dtype=torch.float32)
            else:
                dw = matmul_f32(x.t(), g)
            return dx, dw.to(ctx.w_dtype)


def conv1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w: (Cin, Cout) fp32, cast to x's dtype) in x's dtype, fp32
    sums rounded once: :class:`Conv1x1Fn` where autograd records, the same
    product under ``no_grad`` (eval), which so records no ``unet.conv1x1``
    span, a span of training."""
    if torch.is_grad_enabled():
        return Conv1x1Fn.apply(x, w)
    return matmul_rounded(x, w.to(x.dtype))


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


def masked_batch_norm_plain(x, mask, num, gamma, beta, running_mean,
                            running_var, *, train: bool,
                            momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm over valid rows only (MinkowskiBatchNorm semantics), as
    plain ops: the oracle of :class:`MaskedBatchNormFn`, and the eval
    path of :func:`masked_batch_norm`.

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
        new_mean, new_var = _running(mean, var, n, running_mean,
                                     running_var, momentum)
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps)
    out = ((xf - mean) * inv * gamma + beta) * mask
    return out.to(x.dtype), new_mean, new_var


def _running(mean, var, n: float, running_mean, running_var,
             momentum: float):
    """The running buffers moved towards the batch's mean and unbiased
    variance."""
    unbiased = var * n / max(n - 1.0, 1.0)
    return ((1 - momentum) * running_mean + momentum * mean,
            (1 - momentum) * running_var + momentum * unbiased)


class MaskedBatchNormFn(torch.autograd.Function):
    """Training-mode masked BatchNorm whose backward keeps only the input
    in its own dtype, the mask and per-channel statistics.

    ``apply(x, mask, n, gamma, beta, eps) -> (out, mean, var)``: the
    forward is :func:`masked_batch_norm_plain`'s, op for op; autograd of
    those ops would keep about four fp32 ``(cap, C)`` copies of a bf16
    input.  The backward recomputes ``xf - mean`` from ``x`` and takes the
    gradient of the same ops in the order autograd takes them: through
    ``out * mask``, ``+ beta``, ``* gamma`` and ``* inv``; through
    ``rsqrt``, the variance's sum and ``centered * centered`` (the two
    equal halves added); each ``xf - mean`` hands ``-sum`` of its gradient
    to ``mean``, which goes back through ``(xf * mask).sum(0) / n``; the
    three gradients of ``xf`` are added in that order.  So ``dx``,
    ``dgamma`` and ``dbeta`` equal the plain ops' autograd bit for bit in
    every dtype, and ``dx`` is exactly zero at padded rows.  ``mean`` and
    ``var`` carry no gradient (the running buffers' update reads them).
    """

    @staticmethod
    def forward(ctx, x, mask, n: float, gamma, beta, eps: float):
        with span("unet.bn"):
            xf = x.float()
            mean = (xf * mask).sum(0) / n
            centered = (xf - mean) * mask
            var = (centered * centered).sum(0) / n
            del centered
            inv = torch.rsqrt(var + eps)
            out = ((xf - mean) * inv * gamma + beta) * mask
            ctx.save_for_backward(x, mask, mean, inv, gamma)
            ctx.n = n
            ctx.mark_non_differentiable(mean, var)
            return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        with span("unet.bn"):
            x, mask, mean, inv, gamma = ctx.saved_tensors
            n = ctx.n
            a = x.float() - mean                   # xf - mean, recomputed
            g = dy.float() * mask                  # out = d * mask
            dbeta = g.sum(0)                       # d = c + beta
            dgamma = (g * (a * inv)).sum(0)        # c = b * gamma
            g = g * gamma
            dinv = (g * a).sum(0)                  # b = (xf - mean) * inv
            dxf = g * inv
            del g
            dvar = -0.5 * dinv * inv.pow(3)        # inv = rsqrt(var + eps)
            a.mul_(mask)                           # cen
            dc = (dvar / n) * a                    # var = sum(cen * cen) / n
            del a
            dc = (dc + dc) * mask                  # cen = (xf - mean) * mask
            dmean = -dxf.sum(0) - dc.sum(0)        # both xf - mean
            dxf += dc
            del dc
            dxf += (dmean / n) * mask              # mean = sum(xf * mask) / n
            return (dxf.to(x.dtype), None, None, dgamma.to(gamma.dtype),
                    dbeta.to(gamma.dtype), None)


def masked_batch_norm(x, mask, num, gamma, beta, running_mean, running_var,
                      *, train: bool, momentum: float = 0.1,
                      eps: float = 1e-5):
    """BatchNorm over valid rows only (MinkowskiBatchNorm semantics).

    x: (cap, C); mask: (cap, 1) fp32; num: valid-row count.
    Returns (out, new_running_mean, new_running_var); out is computed in
    fp32 and re-masked so padded rows stay exactly zero despite beta.
    Training runs :class:`MaskedBatchNormFn` (the plain forward, a
    backward that keeps the input and per-channel statistics); eval runs
    the plain ops.
    """
    if not train:
        return masked_batch_norm_plain(
            x, mask, num, gamma, beta, running_mean, running_var,
            train=False, momentum=momentum, eps=eps)
    n = float(max(int(num), 1))
    out, mean, var = MaskedBatchNormFn.apply(x, mask, n, gamma, beta, eps)
    return (out,) + _running(mean, var, n, running_mean, running_var,
                             momentum)


def relu(x):
    return torch.relu(x)


def masked_global_avg_pool(x, mask, num, batch_ids, num_batches: int):
    """Per-scene average over valid rows (MinkowskiGlobalPooling).

    x: (cap, C); mask: (cap, 1) fp32; batch_ids: (cap,) int scene id per
    row (padded rows may hold any id: they are masked); ``num`` is unused,
    as in the JAX op.  Returns (num_batches, C) fp32 (fp64 for fp64 x)."""
    acc = _acc_dtype(x.dtype)
    xm = x.to(acc) * mask.to(acc)
    one_hot = (batch_ids.long()[:, None]
               == torch.arange(num_batches, device=x.device)[None, :])
    one_hot = one_hot.to(acc) * mask.to(acc)
    sums = one_hot.t() @ xm
    counts = one_hot.sum(0)[:, None]
    return sums / counts.clamp_min(1.0)
