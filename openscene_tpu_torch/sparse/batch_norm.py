"""Training-mode masked BatchNorm on the card: the CUDA kernels' wrappers,
their plain versions and the autograd Function of the kernel route.

``csrc/masked_bn.cu`` computes the training BatchNorm of
:func:`.ops.masked_batch_norm` over the valid rows ``[0, num)`` of a
``(cap, C)`` buffer, with the ReLU that follows it in the model folded in
where the caller asks for it:

* :func:`masked_bn_fwd`: a statistics pass (Welford partials of row
  splits), a finalize launch (the splits merged in a fixed order: ``mean``
  and ``inv = 1 / sqrt(var + eps)``, the running buffers moved in place)
  and a normalise pass (``relu?((x - mean) * inv * gamma + beta)``, exact
  zeros at the padded rows): 3 launches;
* :func:`masked_bn_bwd`: a pass of the sums of ``g`` and ``g * xhat``
  (``g`` the cotangent, times the ReLU's mask, recomputed from ``x``), a
  finalize launch into ``dbeta`` and ``dgamma`` and a ``dx`` pass (the
  closed form ``gamma * inv * (g - dbeta / n - xhat * dgamma / n)``, exact
  zeros at the padded rows): 3 launches.

Both are deterministic (fixed-order reductions, no atomics).  A CUDA
tensor launches the kernels or raises (bf16 or fp32 activations, fp32
parameters and buffers, a contiguous input); a CPU tensor takes the plain
version, which computes the same closed forms in plain ops and counts no
launch.  Each wrapper counts its launches in ``<wrapper>.launches``.

:class:`MaskedBatchNormKernelFn` is the training route on the card that
:func:`.ops.masked_batch_norm` dispatches to; on the CPU it runs
:class:`.ops.MaskedBatchNormFn`.  The Function keeps ``x`` in its own
dtype and four per-channel vectors (``mean``, ``inv``, ``gamma``,
``beta``) for the backward, never an fp32 ``(cap, C)`` copy.  Its forward
and backward run inside the span ``unet.bn``, and the launches inside
``unet.bn_kernel``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.profiling import span
from . import _build

_LIB = "masked_bn"
THREADS = 256       # threads a block (csrc/masked_bn.cu)
UNROLL = 4          # rows a thread has in flight
MAX_GROUPS = 32     # channel groups a block's row
BLOCKS_PER_SM = 4   # the reduce passes' least blocks an SM
MAX_SPLITS = 1024   # the reduce passes' row splits, unless filling needs more
MAX_GRID_Y = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Tiling(NamedTuple):
    vec: int     # channels a thread: one 16-byte vector, or 1
    tx: int      # channel groups a block
    splits: int  # row splits of the reduce passes (grid.y)
    rps: int     # valid rows a split
    blocks: int  # row blocks of the elementwise passes (grid.y)


def tiling(c: int, num: int, cap: int, vec: int, sms: int) -> Tiling:
    """The kernels' launch shape for ``(cap, C)`` with ``num`` valid rows,
    ``vec`` channels a thread, on a card of ``sms`` SMs.

    A block's 256 threads are ``tx`` channel groups (at most 32; C in as
    few equal tiles as that allows) by ``256 // tx`` row lanes.  The reduce
    passes split the valid rows so that the grid gives every SM at least
    ``BLOCKS_PER_SM`` blocks where the rows allow it (each thread ``UNROLL``
    rows or more), and up to ``MAX_SPLITS`` splits of at least 4
    ``UNROLL`` a thread beyond that (the last splits may hold no row).
    The elementwise passes give each block ``UNROLL`` rows a lane over all
    ``cap`` rows."""
    groups = c // vec
    tiles = -(-groups // MAX_GROUPS)
    tx = -(-groups // tiles)
    lanes = THREADS // tx
    rows = max(num, 1)
    most = max(1, rows // (lanes * UNROLL))
    fill = -(-BLOCKS_PER_SM * sms // tiles)
    many = most // 4
    splits = min(most, max(fill, min(many, MAX_SPLITS)), MAX_GRID_Y)
    rps = -(-rows // splits)
    blocks = max(1, min(-(-cap // (lanes * UNROLL)), MAX_GRID_Y))
    return Tiling(vec, tx, splits, rps, blocks)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tiling(x, num: int, *tensors, ld: int = 0) -> Tiling:
    """:func:`tiling` for ``x`` on its card: 16-byte vectors where C, the
    row stride ``ld`` (C by default) and every pointer allow them."""
    cap, c = x.shape
    v = 16 // x.element_size()
    if c % v or (ld or c) % v or any(t.data_ptr() % 16 for t in tensors):
        v = 1
    index = x.device.index
    return tiling(c, num, cap, v, _sm_count(
        torch.cuda.current_device() if index is None else index))


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def masked_bn_fwd_plain(x, num: int, gamma, beta, running_mean, running_var,
                        *, relu: bool = False, momentum: float = 0.1,
                        eps: float = 1e-5):
    """Plain version of :func:`masked_bn_fwd`: the same statistics (the
    biased variance about the mean), the running buffers moved in place,
    and ``(out, stats)`` with ``stats = [mean; inv]`` in fp32 (fp64 for
    fp64 ``x``)."""
    acc = _acc(x.dtype)
    n = float(max(num, 1))
    xv = x[:num].to(acc)
    mean = xv.sum(0) / n
    var = ((xv - mean) ** 2).sum(0) / n
    inv = 1.0 / torch.sqrt(var + eps)
    unbiased = var * n / max(n - 1.0, 1.0)
    with torch.no_grad():
        running_mean.copy_((1 - momentum) * running_mean + momentum * mean)
        running_var.copy_((1 - momentum) * running_var + momentum * unbiased)
    y = (xv - mean) * inv * gamma.to(acc) + beta.to(acc)
    if relu:
        y = torch.relu(y)
    out = torch.zeros_like(x)
    out[:num] = y.to(x.dtype)
    return out, torch.stack([mean, inv])


def masked_bn_bwd_plain(x, dy, stats, gamma, beta, num: int, *,
                        relu: bool = False):
    """Plain version of :func:`masked_bn_bwd`: ``(dx, dgamma, dbeta)`` by
    the closed form, the ReLU's mask recomputed from ``x``; ``dx`` in x's
    dtype, exactly zero at the padded rows."""
    acc = _acc(x.dtype)
    n = float(max(num, 1))
    mean, inv = stats[0].to(acc), stats[1].to(acc)
    gm, bt = gamma.to(acc), beta.to(acc)
    xh = (x[:num].to(acc) - mean) * inv
    g = dy[:num].to(acc)
    if relu:
        g = torch.where(xh * gm + bt > 0, g, torch.zeros_like(g))
    dbeta = g.sum(0)
    dgamma = (g * xh).sum(0)
    dx = torch.zeros_like(x)
    dx[:num] = (gm * inv * (g - dbeta / n - xh * dgamma / n)).to(x.dtype)
    return dx, dgamma, dbeta


def _check(x, num: int, params) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 2:
        raise TypeError(f"x must be a 2-d bfloat16 or float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    c = x.shape[1]
    for p in params:
        if (p.dtype != torch.float32 or p.shape != (c,)
                or p.device != x.device or not p.is_contiguous()):
            raise TypeError(f"per-channel tensors must be contiguous fp32 "
                            f"({c},) on {x.device}, got {p.dtype} "
                            f"{tuple(p.shape)} on {p.device}")
    if (not 0 <= num <= x.shape[0] or c == 0 or x.numel() >= 2 ** 31
            or x.shape[0] >= 2 ** 30):
        raise ValueError(f"num={num}, shape {tuple(x.shape)}: need 0 <= num "
                         f"<= cap < 2**30, C > 0 and fewer than 2**31 "
                         f"elements (the kernels' 32-bit row indices)")


def _bind() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if lib.masked_bn_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.masked_bn_fwd.argtypes = [p] * 8 + [i] * 10 + [f, f, p]
        lib.masked_bn_fwd.restype = ctypes.c_int
        lib.masked_bn_bwd.argtypes = [p, p, i] + [p] * 6 + [i] * 10 + [p]
        lib.masked_bn_bwd.restype = ctypes.c_int
    return lib


def masked_bn_fwd(x, num: int, gamma, beta, running_mean, running_var, *,
                  relu: bool = False, momentum: float = 0.1,
                  eps: float = 1e-5):
    """Training BatchNorm of ``x`` (cap, C) over rows ``[0, num)``, then
    ReLU with ``relu``: ``(out, stats)``, ``out`` in x's dtype (exactly 0 at
    the padded rows), ``stats`` (2, C) fp32 ``[mean; inv]``.  Moves
    ``running_mean`` / ``running_var`` in place (momentum, unbiased
    variance).  CPU tensors take the plain version; CUDA tensors launch the
    kernels (3 launches) or raise."""
    if x.device.type == "cpu":
        return masked_bn_fwd_plain(x, num, gamma, beta, running_mean,
                                   running_var, relu=relu,
                                   momentum=momentum, eps=eps)
    _check(x, num, (gamma, beta, running_mean, running_var))
    cap, c = x.shape
    t = _tiling(x, num, x)
    out = torch.empty_like(x)
    stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    part = torch.empty((2, t.splits, c), dtype=torch.float32,
                       device=x.device)
    lib = _bind()
    with span("unet.bn_kernel"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.masked_bn_fwd(
            x.data_ptr(), out.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(),
            stats.data_ptr(), part.data_ptr(), _DTYPES[x.dtype],
            int(t.vec > 1), int(relu), cap, num, c, t.tx, t.splits, t.rps,
            t.blocks, momentum, eps, stream)
    if err != 0:
        raise RuntimeError(f"masked_bn_fwd launch failed: cudaError {err}")
    masked_bn_fwd.launches += 3
    return out, stats


masked_bn_fwd.launches = 0


def masked_bn_bwd(x, dy, stats, gamma, beta, num: int, *,
                  relu: bool = False):
    """Backward of :func:`masked_bn_fwd` for the cotangent ``dy`` of
    ``out``: ``(dx, dgamma, dbeta)``, ``dx`` in x's dtype (exactly 0 at the
    padded rows; ``dy`` is read on the valid rows only), the two fp32.
    ``dy`` may have a row stride (a column slice of a concatenation's
    gradient).  CPU tensors take the plain version; CUDA tensors launch the
    kernels (3 launches) or raise."""
    if x.device.type == "cpu":
        return masked_bn_bwd_plain(x, dy, stats, gamma, beta, num,
                                   relu=relu)
    _check(x, num, (gamma, beta))
    cap, c = x.shape
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")
    dy = dy.to(x.dtype)
    if dy.stride(1) != 1 or dy.stride(0) < c:
        dy = dy.contiguous()
    if (stats.dtype != torch.float32 or stats.shape != (2, c)
            or not stats.is_contiguous()):
        raise TypeError("stats must be the forward's contiguous (2, C) fp32")
    t = _tiling(x, num, x, dy, ld=dy.stride(0))
    dx = torch.empty_like(x)
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    part = torch.empty((2, t.splits, c), dtype=torch.float32,
                       device=x.device)
    lib = _bind()
    with span("unet.bn_kernel"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.masked_bn_bwd(
            x.data_ptr(), dy.data_ptr(), dy.stride(0), stats.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), dx.data_ptr(),
            sums.data_ptr(), part.data_ptr(), _DTYPES[x.dtype],
            int(t.vec > 1), int(relu), cap, num, c, t.tx, t.splits, t.rps,
            t.blocks, stream)
    if err != 0:
        raise RuntimeError(f"masked_bn_bwd launch failed: cudaError {err}")
    masked_bn_bwd.launches += 3
    return dx, sums[1], sums[0]


masked_bn_bwd.launches = 0


class MaskedBatchNormKernelFn(torch.autograd.Function):
    """``apply(x, num, gamma, beta, running_mean, running_var, relu,
    momentum, eps) -> out``: training BatchNorm over rows ``[0, num)``
    (then ReLU with ``relu``) by :func:`masked_bn_fwd`, the running
    buffers moved in place; the backward by :func:`masked_bn_bwd` from
    ``x`` and the per-channel ``mean``, ``inv``, ``gamma`` and ``beta``."""

    @staticmethod
    def forward(ctx, x, num: int, gamma, beta, running_mean, running_var,
                relu: bool, momentum: float, eps: float):
        with span("unet.bn"):
            out, stats = masked_bn_fwd(x, num, gamma, beta, running_mean,
                                       running_var, relu=relu,
                                       momentum=momentum, eps=eps)
            ctx.save_for_backward(x, stats, gamma, beta)
            ctx.num, ctx.relu = num, relu
            return out

    @staticmethod
    def backward(ctx, dy):
        with span("unet.bn"):
            x, stats, gamma, beta = ctx.saved_tensors
            dx, dgamma, dbeta = masked_bn_bwd(x, dy, stats, gamma, beta,
                                              ctx.num, relu=ctx.relu)
            return (dx, None, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype),
                    None, None, None, None, None)
