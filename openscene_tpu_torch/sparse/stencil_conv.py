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

Most neighbours are missing (about 6 of 27 exist on 2 cm surface scans) and
point at zero padding rows.  :func:`build_conv_skip` derives from ``fwd``
the :class:`~.types.ConvSkip` that lets the kernels skip them: the forward
and ``dx`` walk tiles of rows sorted by their neighbour masks and multiply
only the offsets a tile holds; ``dW`` reduces each offset over its compacted
list of rows whose neighbour exists.  One skip plan per level serves every
conv on it, in both directions.  :func:`fwd_tiles` and :func:`wgrad_tiles`
choose the kernels' tiles and row splits from the shapes alone.

``stencil_conv_fwd`` and ``stencil_conv_bwd`` launch the kernels for a CUDA
tensor and take the plain versions only for a CPU tensor; each counts its
launches in ``<wrapper>.launches`` (one per call that reaches the card).
:class:`StencilConv` ties the two into autograd.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from .ops import gather_matmul_sum, sparse_conv_bwd
from .types import ConvSkip

_LIB = "gather_gemm_fwd"
_LIB_BWD = "gather_gemm_bwd"

# The skip plan (ConvSkip): rows of sorted ``order`` per ``tile_mask``
# entry; the forward kernel's row tiles are 1, 2 or 4 of them and OR their
# masks
TILE_ROWS = 32

# csrc/gather_gemm_fwd.cu and csrc/gather_gemm_bwd.cu: every warp computes a
# 32 x 32 tile, at most 16 warps a block
WARP_TILE = 32
MAX_WARPS = 16
FWD_ROW_TILES = (32, 64, 128)
FWD_COL_TILES = (32, 64, 96, 128, 160, 192, 256)
WGRAD_TILES = (32, 64, 96, 128)
# fwd_tiles: row tiles of at most FWD_WARPS warps (larger blocks hold fewer
# per SM); offset groups while fewer than FWD_TARGET_BLOCKS blocks would run
# and each group keeps FWD_MIN_STEPS 32-channel steps or more; a skip plan
# leaves about FWD_SKIP_SHARE of the offsets in a tile (2 cm scans, PERF.md)
FWD_WARPS = 12
FWD_MAX_GROUPS = 8
FWD_TARGET_BLOCKS = 1024
FWD_MIN_STEPS = 8
FWD_SKIP_SHARE = 0.45
# gather_wgrad_cuda's row splits: aim at about this many blocks that have
# rows, at least WGRAD_MIN_ROWS rows per split (so the fp32 partial tiles
# stay a small share of the traffic) and at most WGRAD_MAX_ROWS; with a
# skip plan only about a quarter of the bound's rows hold a pair
WGRAD_TARGET_BLOCKS = 1024
WGRAD_SKIP_FILL = 4
WGRAD_MIN_ROWS = 512
WGRAD_MAX_ROWS = 4096
_WGRAD_STEP = 32            # csrc/gather_gemm_bwd.cu: BR


def sorted_masks(bits: torch.Tensor):
    """``(nbr_mask, order, tile_mask)`` of a (K, rows) bool matrix: bit k of
    row r's mask is ``bits[k, r]``, ``order`` the rows stably sorted by
    mask, ``tile_mask`` the OR over each ``TILE_ROWS`` entries of
    ``order``, all int32 (the first three fields of :class:`ConvSkip` and of
    :class:`~.types.EdgeSkip`).  Plain tensor ops, deterministic."""
    K, rows = bits.shape
    if K > 31:
        raise ValueError(f"K={K} offsets do not fit an int32 neighbour mask")
    dev = bits.device
    weight = torch.ones((), dtype=torch.int64, device=dev) << torch.arange(
        K, device=dev)
    nbr = (bits.to(torch.int64) * weight[:, None]).sum(0)
    order = torch.argsort(nbr, stable=True)
    tiles = -(-rows // TILE_ROWS)
    sb = torch.zeros((K, tiles * TILE_ROWS), dtype=torch.bool, device=dev)
    sb[:, :rows] = bits[:, order]
    tmask = (sb.reshape(K, tiles, TILE_ROWS).any(2).to(torch.int64)
             * weight[:, None]).sum(0)
    return (nbr.to(torch.int32), order.to(torch.int32),
            tmask.to(torch.int32))


def build_conv_skip(fwd: torch.Tensor, num) -> ConvSkip:
    """The :class:`ConvSkip` of a stencil plan ``fwd`` (K, cap) int32 with
    ``num`` valid rows (an int or a 0-d tensor on ``fwd``'s device).

    Plain tensor ops, the same on the CPU and on the card, deterministic (a
    stable sort, a cumulative-sum compaction) and with no read back to the
    host.  ``order`` sorts all rows by ``nbr_mask`` in one stable sort: a
    sort within windows of rows kept the gathers more local but loosened
    the tile masks, and lost on the card (PERF.md)."""
    K, cap = fwd.shape
    dev = fwd.device
    num = torch.as_tensor(num, device=dev)
    rows = torch.arange(cap, device=dev)
    bits = (fwd < num) & (rows < num)[None, :]                  # (K, cap)
    nbr, order, tmask = sorted_masks(bits)
    pos = torch.cumsum(bits, 1, dtype=torch.int64) - 1
    flat = torch.where(bits, pos + (torch.arange(K, device=dev) * cap)[:, None],
                       torch.full_like(pos, K * cap))
    pair = torch.full((K * cap + 1,), cap - 1, dtype=torch.int32, device=dev)
    pair[flat.reshape(-1)] = rows.to(torch.int32).expand(K, cap).reshape(-1)
    return ConvSkip(nbr_mask=nbr, order=order, tile_mask=tmask,
                    pair_rows=pair[:K * cap].reshape(K, cap),
                    pair_count=bits.sum(1).to(torch.int32))


def _fit(c: int, tiles) -> Tuple[int, int]:
    """(tile, count) covering width ``c``: the fewest columns computed, each
    tile charged 64 more for the gather it repeats."""
    return min(((t, -(-c // t)) for t in tiles),
               key=lambda tn: (tn[1] * (tn[0] + 64), tn[1]))


@functools.lru_cache(maxsize=None)
def fwd_tiles(rows: int, K: int, cin: int, cout: int, skip: bool = False
              ) -> Tuple[int, int, int]:
    """(row tile, column tile, offset groups) of one ``gather_gemm_cuda``
    call (``skip``: with a skip plan).

    The column tile fits ``cout`` (96, 128, 192, 256; 384 as 2 x 192), so a
    block gathers each row once.  The row tile is the largest of 128, 64,
    32 rows within ``FWD_WARPS`` warps.  Where the row tiles leave the card
    short of ``FWD_TARGET_BLOCKS`` blocks (the small levels) and a tile's
    steps (its offsets times the 32-channel chunks of ``cin``) are many,
    each tile's offsets are split over 2, 4 or 8 blocks whose fp32 partials
    are added in order: each halving keeps ``FWD_MIN_STEPS`` steps or more
    per block, so the partials' traffic stays small against the work."""
    bn, n_col = _fit(cout, FWD_COL_TILES)
    bm = next(t for t in sorted(FWD_ROW_TILES, reverse=True)
              if t == min(FWD_ROW_TILES)
              or (t // WARP_TILE) * (bn // WARP_TILE) <= FWD_WARPS)
    blocks = -(-rows // bm) * n_col
    offsets = math.ceil(K * FWD_SKIP_SHARE) if skip else K
    steps = offsets * -(-cin // 32)
    groups = 1
    while (groups * 2 <= min(K, FWD_MAX_GROUPS)
           and blocks * groups < FWD_TARGET_BLOCKS
           and steps >= 2 * groups * FWD_MIN_STEPS):
        groups *= 2
    return bm, bn, groups


@functools.lru_cache(maxsize=None)
def wgrad_tiles(rows: int, K: int, ca: int, cb: int, skip: bool,
                min_rows: int = WGRAD_MIN_ROWS) -> Tuple[int, int, int, int]:
    """(a tile, b tile, rows per split, splits) of one ``gather_wgrad_cuda``
    call over at most ``rows`` rows per offset (the level's rows: a bound
    known on the host, so no count is read back); splits of at least
    ``min_rows`` rows."""
    bma, ta = _fit(ca, WGRAD_TILES)
    bnb, tb = _fit(cb, WGRAD_TILES)
    target = WGRAD_TARGET_BLOCKS * (WGRAD_SKIP_FILL if skip else 1)
    per = -(-max(rows, 1) * K * ta * tb // target)
    per = min(max(per, min_rows), WGRAD_MAX_ROWS)
    per = -(-per // _WGRAD_STEP) * _WGRAD_STEP
    return bma, bnb, per, max(1, -(-rows // per))


def _bind() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    fn = lib.gather_gemm_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bind_bwd() -> ctypes.CDLL:
    lib = _build.load(_LIB_BWD)
    fn = lib.gather_wgrad_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check_index_arrays(arrays, shapes, device: int, what: str) -> None:
    """Each of ``arrays`` (a NamedTuple of index tensors) int32, contiguous,
    on cuda:``device`` and of its shape in ``shapes`` (by field name): the
    kernels read plans unchecked."""
    for name, t in zip(arrays._fields, arrays):
        if t.shape != shapes[name] or t.dtype != torch.int32:
            raise ValueError(f"{what}.{name}: {t.dtype} {tuple(t.shape)}, "
                             f"want int32 {shapes[name]}")
        if t.get_device() != device or not t.is_contiguous():
            raise ValueError(f"{what}.{name} must be contiguous on "
                             f"cuda:{device}")


def _check_skip(skip, K: int, rows: int, device: int) -> None:
    """The wrappers' checks of a :class:`ConvSkip` (or of the
    :class:`~.types.EdgeSkip` its first three fields make) of a (K, rows)
    plan on cuda:``device``."""
    if K > 31:
        raise ValueError(f"a skip plan needs K <= 31 offsets, got {K}")
    check_index_arrays(skip, {"nbr_mask": (rows,), "order": (rows,),
                              "tile_mask": (-(-rows // TILE_ROWS),),
                              "pair_rows": (K, rows), "pair_count": (K,)},
                       device, "skip")


def launch_gather_gemm(x: torch.Tensor, wb: torch.Tensor, idx: torch.Tensor,
                       skip, bm: int, bn: int, groups: int = 1,
                       w_nk: bool = False, staged: bool = False
                       ) -> torch.Tensor:
    """One launch of ``csrc/gather_gemm_fwd.cu`` with the row and column
    tiles and offset groups given (``gather_gemm_cuda`` checks the
    arguments; wb is the bf16 weight, (K, Cout, Cin) if ``w_nk``;
    ``staged``: the staged 16-byte epilogue, one offset group only).
    Returns (rows_out, Cout) bf16."""
    K, cin, cout = wb.shape
    if w_nk:
        cin, cout = cout, cin
    rows_out = idx.shape[1]
    dev = x.device
    out = torch.empty((rows_out, cout), dtype=torch.bfloat16, device=dev)
    if rows_out == 0:
        return out
    part = None if groups == 1 else torch.empty(
        (groups, rows_out, cout), dtype=torch.float32, device=dev)
    lib = _bind()
    order, tile_mask, nbr_mask = ((None, None, None) if skip is None else
                                  (skip.order, skip.tile_mask, skip.nbr_mask))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_gemm_fwd_bf16(
            x.data_ptr(), wb.data_ptr(), idx.data_ptr(), _ptr(order),
            _ptr(tile_mask), _ptr(nbr_mask), _ptr(part), out.data_ptr(),
            rows_out, K, cin, cout, bm, bn, TILE_ROWS, groups, int(w_nk),
            int(staged), stream)
    if err != 0:
        raise RuntimeError(f"gather_gemm_fwd launch failed: cudaError {err}")
    return out


def gather_gemm_cuda(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                     skip=None, w_nk: bool = False,
                     tiles: Optional[Tuple[int, int, int]] = None,
                     staged: bool = False) -> torch.Tensor:
    """Launch ``csrc/gather_gemm_fwd.cu`` once: ``sum_k x[idx[k]] @ w[k]``,
    or ``sum_k x[idx[k]] @ w[k]^T`` with ``w_nk``.

    x: (rows_in, Cin) bf16 CUDA, contiguous; w: (K, Cin, Cout) float weights
    ((K, Cout, Cin) with ``w_nk``, read transposed inside the kernel; cast
    to bf16 here where they are not); idx: (K, rows_out) int32 CUDA,
    contiguous, every entry below rows_in; a negative entry contributes
    zero.  Cin and Cout must be multiples of 8.  ``skip``: a
    :class:`ConvSkip` of ``idx`` (K <= 31), or an
    :class:`~.types.EdgeSkip` (its first three fields); the kernel then
    multiplies only the offsets each tile of sorted rows holds, and x must
    be exactly zero at every row ``idx`` points to where the skip plan says
    no neighbour is.  ``tiles``: (row tile, column tile, offset groups),
    by default :func:`fwd_tiles`'s.  ``staged``: the epilogue that stages
    the tile and stores 16-byte row vectors (one offset group only).
    Returns (rows_out, Cout) bf16.  Raises on anything else, and if the
    launch is refused.
    """
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.dim() != 2 or w.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"idx{tuple(idx.shape)}: want (N, Cin), "
                         "(K, Cin, Cout), (K, rows_out)")
    K, cin, cout = w.shape
    if w_nk:
        cin, cout = cout, cin
    if x.shape[1] != cin or idx.shape[0] != K:
        raise ValueError(f"x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"idx{tuple(idx.shape)} disagree")
    if cin % 8 or cout % 8:
        raise ValueError(f"Cin={cin} and Cout={cout} must be multiples of 8")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous")
    d = x.get_device()
    if w.get_device() != d or idx.get_device() != d:
        raise ValueError(f"x on {x.device}, w on {w.device}, idx on "
                         f"{idx.device}: all must share one device")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    rows_out = idx.shape[1]
    if max(x.numel(), K * rows_out, rows_out * cout) >= 2 ** 31:
        raise ValueError("sizes beyond the kernel's 32-bit indexing")
    if skip is not None:
        _check_skip(skip, K, rows_out, d)
    return launch_gather_gemm(
        x, w.to(torch.bfloat16).contiguous(), idx, skip,
        *(tiles or fwd_tiles(rows_out, K, cin, cout, skip is not None)),
        w_nk=w_nk, staged=staged)


def launch_gather_wgrad(a: torch.Tensor, b: torch.Tensor, idx, pairs,
                        bma: int, bnb: int, per: int, splits: int,
                        amap: Optional[torch.Tensor] = None,
                        seg_tile: int = 0) -> torch.Tensor:
    """``csrc/gather_gemm_bwd.cu`` with the tiles and row splits given
    (``gather_wgrad_cuda`` and the edge convs' backward wrappers check the
    arguments).  ``pairs``: ``(pair_rows, pair_count)`` or None (dense);
    with ``amap`` they are segments of ``seg_tile``-padded lists of b's
    rows (:class:`~.types.EdgeGroups`), a's row being ``amap[b's row]``,
    and ``idx`` is unused.  Returns (K, Ca, Cb) fp32."""
    rows, ca = a.shape
    cb = b.shape[1]
    K = idx.shape[0] if amap is None else pairs[1].shape[0]
    dev = a.device
    out = torch.empty((K, ca, cb), dtype=torch.float32, device=dev)
    if rows == 0 or K == 0:
        return out.zero_()
    if splits > 65535:
        raise ValueError(f"{splits} row splits exceed the grid")
    part = out if splits == 1 else torch.empty(
        (splits, K, ca, cb), dtype=torch.float32, device=dev)
    lib = _bind_bwd()
    pair_rows, pair_count = pairs if pairs is not None else (None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_wgrad_bf16(
            a.data_ptr(), b.data_ptr(), _ptr(idx), _ptr(pair_rows),
            _ptr(pair_count), _ptr(amap), part.data_ptr(), out.data_ptr(),
            rows, K, ca, cb, bma, bnb, per, splits, seg_tile, stream)
    if err != 0:
        raise RuntimeError(f"gather_wgrad launch failed: cudaError {err}")
    return out


def gather_wgrad_cuda(a: torch.Tensor, b: torch.Tensor, idx: torch.Tensor,
                      skip: Optional[ConvSkip] = None) -> torch.Tensor:
    """Launch ``csrc/gather_gemm_bwd.cu``: ``dw[k] = a^T @ b[idx[k]]``.

    a: (rows, Ca) bf16 CUDA, contiguous; b: (rows_b, Cb) bf16, contiguous;
    idx: (K, rows) int32, contiguous, every entry below rows_b (a negative
    entry contributes zero).  Ca and Cb must be multiples of 8.  ``skip``:
    the :class:`ConvSkip` of ``idx`` (K <= 31); the kernel then reduces over
    each offset's pair list only, so ``a`` or ``b[idx]`` must be exactly
    zero at every row left out.  Returns (K, Ca, Cb) fp32, deterministic
    (fixed-order sum of row-split partials).  Raises on anything else, and
    if a launch is refused.
    """
    if not a.is_cuda:
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
    d = a.get_device()
    if b.get_device() != d or idx.get_device() != d:
        raise ValueError(f"a on {a.device}, b on {b.device}, idx on "
                         f"{idx.device}: all must share one device")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a and b must be 16-byte aligned")
    if max(a.numel(), b.numel(), K * rows) >= 2 ** 31:
        raise ValueError("sizes beyond the kernel's 32-bit indexing")
    if skip is not None:
        _check_skip(skip, K, rows, d)
    pairs = None if skip is None else (skip.pair_rows, skip.pair_count)
    return launch_gather_wgrad(a, b, idx, pairs,
                               *wgrad_tiles(rows, K, ca, cb, skip is not None))


def stencil_conv_plain(x: torch.Tensor, w: torch.Tensor, fwd: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch version: one ``index_select`` + fp32 matmul per offset
    (sparse/ops.py:sparse_conv)."""
    return gather_matmul_sum(x, w, fwd).to(x.dtype)


def stencil_conv_fwd(x: torch.Tensor, w: torch.Tensor, fwd: torch.Tensor,
                     skip: Optional[ConvSkip] = None) -> torch.Tensor:
    """Stencil conv forward. x: (cap, Cin), exactly zero at padded rows;
    w: (K, Cin, Cout) fp32; fwd: (K, cap) int32; skip: the plan's
    :class:`ConvSkip` or None (dense).  CPU tensors take the plain version
    (which needs no skip plan); CUDA tensors launch the kernel (bf16 only)
    or raise."""
    if x.device.type == "cpu":
        return stencil_conv_plain(x, w, fwd)
    out = gather_gemm_cuda(x, w, fwd, skip)
    stencil_conv_fwd.launches += 1
    return out


stencil_conv_fwd.launches = 0


# Plain PyTorch version of the backward: ``(dx, dW)`` with dx in x.dtype and
# dW fp32 (x, w, g, fwd, flip_perm)
stencil_conv_bwd_plain = sparse_conv_bwd


def stencil_conv_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     fwd: torch.Tensor, flip_perm: torch.Tensor,
                     skip: Optional[ConvSkip] = None):
    """Stencil conv backward: ``(dx, dW)`` for the cotangent ``g`` (cap,
    Cout) of the output; dx (cap, Cin) in x.dtype, dW (K, Cin, Cout) fp32.

    ``g`` must be exactly zero at padded rows; dx then is too.  ``skip``:
    the plan's :class:`ConvSkip` or None; ``dx`` reads the same ``fwd`` as
    the forward and so shares its skip plan.  CPU tensors take the plain
    version; CUDA tensors launch the kernels (x bf16; ``g`` is cast to bf16
    once) or raise.
    """
    if x.device.type == "cpu":
        return stencil_conv_bwd_plain(x, w, g, fwd, flip_perm)
    gb = g.to(torch.bfloat16).contiguous()
    dx = gather_gemm_cuda(gb, w.index_select(0, flip_perm).transpose(1, 2),
                          fwd, skip)
    # un-permute: the kernel's row k holds dW[flip k]
    dw = gather_wgrad_cuda(x, gb, fwd, skip).index_select(0, flip_perm)
    stencil_conv_bwd.launches += 1
    return dx, dw


stencil_conv_bwd.launches = 0


class StencilConv(torch.autograd.Function):
    """``StencilConv.apply(x, w, plan)`` with ``plan`` a
    :class:`~.types.ConvPlan`: forward is :func:`stencil_conv_fwd`,
    backward :func:`stencil_conv_bwd`, both with the plan's own ``fwd``,
    ``flip_perm`` and skip plan (None: dense).  Taking the plan as one
    object keeps a skip plan with the ``fwd`` it was built from: the
    kernels read it unchecked.

    The zero-padding invariant holds for cotangents too: the backward gathers
    the output's cotangent through the same plan, so it must be exactly zero
    at padded rows (in the model BatchNorm's re-masking sees to it), and the
    returned dx is exactly zero there.
    """

    @staticmethod
    def forward(ctx, x, w, plan):
        ctx.save_for_backward(x, w)
        ctx.plan = plan
        return stencil_conv_fwd(x, w, plan.fwd, plan.skip)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        p = ctx.plan
        dx, dw = stencil_conv_bwd(x, w, g.contiguous(), p.fwd, p.flip_perm,
                                  p.skip)
        return dx, dw.to(w.dtype), None
