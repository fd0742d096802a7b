"""k=2 s=2 edge convs: the kernels' wrappers, their plain versions, their
tile choosers and the autograd Functions.

Counterpart of ``openscene_tpu/sparse/pallas_edge.py``.  Every kernel reads
the edge's own layouts (:func:`with_edge_layouts`, built once per batch with
the plans in both geometry paths): the children grouped by offset
(:class:`~.types.EdgeGroups`) and the parents sorted by which children
they hold (:class:`~.types.EdgeSkip`), so each multiplies only the (child,
offset) pairs that exist.  Times and bounds below: MinkUNet18A on 2 cm
scans, an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).

* down conv forward (:class:`DownConv`; replaces TPU kernel 3,
  ``make_down_kernel``, op ``windowed_down_conv``): ``out[p] = sum_{k<8}
  x_child[fwd[k, p]] @ W[k]``, ``csrc/gather_gemm_fwd.cu`` in skip mode on
  the edge's ``EdgeSkip``: tiles of mask-sorted parents multiply only the
  offsets they hold (about 2.4 of 8).  Wrapper ``down_conv_fwd``, tiles
  from :func:`down_tiles`; at edge 0 of a 120,695-voxel scene 0.0162 ms
  against a bound of 0.0035 (0.0265 densely).
* down conv backward (replaces TPU kernel 6, ``make_up_bwd_kernel``, op
  ``_down_conv_bwd``), over the children: ``dx[c] = g[parent(c)] @
  W[offset(c)]^T`` is ``csrc/up_conv_fwd.cu`` with ``W_NK`` on the groups
  (each child row multiplied once, ``W[k]^T`` read in the kernel; tiles
  from :func:`down_dx_tiles`), and ``dW[k] = sum_{offset(c)=k} x[c]^T
  g[parent(c)]`` is ``csrc/gather_gemm_bwd.cu`` in group mode over each
  offset's own children (:func:`down_wgrad_tiles`).  Wrapper
  ``down_conv_bwd``; at edge 0 of a 263,063-voxel batch 0.0508 ms against
  a bound of 0.0128, dx and dW together (0.1968 in the design replaced: a
  K=8 gather-GEMM with 7 of 8 indices empty, and a dense dW).
* up conv, the model's (:class:`UpConv`): the forward runs over the
  children (kernel ``make_up_kernel``, op ``windowed_up_conv``):
  ``out[c] = x[parent(c)] @ W[offset(c)]``, each child row multiplied once
  by its own weight (``csrc/up_conv_fwd.cu``, wrapper ``up_conv_fwd``).
  Its backward (kernel ``make_down_bwd_kernel``, op ``_up_bwd_core``) runs
  over the parents: ``dx[p] = sum_k g[fwd[k, p]] @ W[k]^T`` and ``dW[k] =
  x^T @ g[fwd[k]]`` (wrapper ``up_conv_bwd``).  The JAX package's model
  takes a dense route forward instead (per-offset GEMMs on the parent level
  and one placement gather, ``ops.sparse_up_conv``), measured faster on
  its TPU; on an NVIDIA H100 80GB HBM3 at 700 W kernel 5 is faster at
  every edge of MinkUNet18A (PERF.md), so the port has one route.

Every wrapper takes its plain version only for a CPU tensor and counts its
launches in ``<wrapper>.launches`` (one per call that reaches the card); a
CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .ops import (matmul_f32, sparse_down_conv, sparse_down_conv_bwd,
                  sparse_up_conv_bwd)
from .stencil_conv import (FWD_COL_TILES, MAX_WARPS, TILE_ROWS, _fit,
                           check_index_arrays, gather_gemm_cuda,
                           launch_gather_wgrad, sorted_masks, wgrad_tiles)
from .types import DownPlan, EdgeGroups, EdgeSkip

_LIB_UP = "up_conv_fwd"
# csrc/up_conv_fwd.cu: BM, the child rows of one tile, and the padding of
# each offset's segment in EdgeGroups (128-row tiles were no faster on the
# card, PERF.md)
EDGE_TILE = 64
# up_tiles: tiles per block for about UP_TARGET_BLOCKS blocks (fitted to
# scripts/dev_up_tiles.py on the card), at most UP_MAX_TPB; a block's
# shared memory at most UP_SMEM bytes (227 KB a block on an NVIDIA H100
# 80GB HBM3, 700 W)
UP_TARGET_BLOCKS = 300
UP_MAX_TPB = 16
UP_SMEM = 232448
# down_tiles (fitted to scripts/dev_down_tiles.py on the card): 128-row
# tiles of mask-sorted parents; offset groups, at most DOWN_MAX_GROUPS,
# while the tiles give fewer than DOWN_TARGET_BLOCKS blocks
DOWN_ROW_TILE = 128
DOWN_TARGET_BLOCKS = 128
DOWN_MAX_GROUPS = 4
# down_dx_tiles: tiles per block for about DOWN_DX_TARGET_WARPS warps over
# all blocks (a 32-column tile is a block of 2 warps), at most
# DOWN_DX_MAX_TPB; down_wgrad_tiles: wgrad_tiles' row splits, at least
# DOWN_WGRAD_MIN_ROWS rows each (the up conv's dW, on wider tiles, keeps
# WGRAD_MIN_ROWS: 128-row splits lost up to 2x there, PERF.md)
DOWN_DX_TARGET_WARPS = 1800
DOWN_DX_MAX_TPB = 8
DOWN_WGRAD_MIN_ROWS = 128


def build_edge_groups(child_offset: torch.Tensor, child_num,
                      n_offsets: int = 8) -> EdgeGroups:
    """The :class:`~.types.EdgeGroups` of an edge: its ``child_num`` valid
    children (rows below ``child_num``, an int or a 0-d tensor on
    ``child_offset``'s device) stably sorted by ``child_offset`` into
    ``n_offsets`` segments, each padded to a multiple of ``EDGE_TILE``
    rows.  Padded children are left out.  Plain tensor ops, the same on the
    CPU and on the card, deterministic (a stable sort, searches and a
    cumulative sum) and with no read back to the host; built once per batch
    with the plans."""
    dev = child_offset.device
    cap = child_offset.shape[0]
    num = torch.as_tensor(child_num, device=dev)
    pos = torch.arange(cap, device=dev)
    # padded children sort last, under a key past the last offset
    key = torch.where(pos < num, child_offset.to(torch.int64), n_offsets)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    ks = torch.arange(n_offsets, device=dev)
    start = torch.searchsorted(skey, ks)
    count = torch.searchsorted(skey, ks, right=True) - start
    padded = (count + EDGE_TILE - 1) // EDGE_TILE * EDGE_TILE
    pend = torch.cumsum(padded, 0)
    tiles = -(-cap // EDGE_TILE) + n_offsets
    k = skey.clamp(max=n_offsets - 1)
    dest = torch.where(skey < n_offsets, pend[k] - padded[k] + pos - start[k],
                       tiles * EDGE_TILE)            # padded: a dump slot
    rows = torch.full((tiles * EDGE_TILE + 1,), -1, dtype=torch.int32,
                      device=dev)
    rows[dest] = order.to(torch.int32)
    tile_k = torch.searchsorted(
        pend, torch.arange(tiles, device=dev) * EDGE_TILE, right=True)
    tile_k = torch.where(tile_k < n_offsets, tile_k,
                         torch.full_like(tile_k, -1)).to(torch.int32)
    return EdgeGroups(rows=rows[:tiles * EDGE_TILE], tile_k=tile_k,
                      count=count.to(torch.int32))


def build_edge_skip(fwd: torch.Tensor, child_num, parent_num) -> EdgeSkip:
    """The :class:`~.types.EdgeSkip` of an edge's ``fwd`` (8, parent_cap):
    bit k of parent p's mask is set iff ``fwd[k, p]`` is below the child
    level's ``child_num`` and ``p`` below the parent level's
    ``parent_num`` (ints or 0-d tensors on ``fwd``'s device).  Plain tensor
    ops, deterministic, no read back to the host."""
    dev = fwd.device
    cn = torch.as_tensor(child_num, device=dev)
    pn = torch.as_tensor(parent_num, device=dev)
    bits = (fwd < cn) & (torch.arange(fwd.shape[1], device=dev) < pn)[None, :]
    return EdgeSkip(*sorted_masks(bits))


def with_edge_layouts(plan: DownPlan, child_num, parent_num) -> DownPlan:
    """``plan`` with its :class:`~.types.EdgeGroups` and
    :class:`~.types.EdgeSkip`, the layouts the up conv's kernels read (both
    geometry paths call it, once per edge per batch)."""
    return plan._replace(
        groups=build_edge_groups(plan.child_offset, child_num),
        skip=build_edge_skip(plan.fwd, child_num, parent_num))


def _segments(groups: EdgeGroups):
    """(offset, child rows) of each segment of ``groups`` (reads the counts
    back: the plain version's and the tests' walk)."""
    start = 0
    for k, n in enumerate(groups.count.tolist()):
        yield k, groups.rows[start:start + n].long()
        start += -(-n // EDGE_TILE) * EDGE_TILE


def up_conv_plain(x: torch.Tensor, w: torch.Tensor, plan: DownPlan
                  ) -> torch.Tensor:
    """Plain PyTorch version of kernel 5, driven by the plan's groups: the
    children of each offset's segment gather their parents and take one
    fp32 matmul with that offset's weight, rounded once; the padded
    children stay zero.  x: (parent_cap, Cin); w: (8, Cin, Cout) fp32.
    Returns (child_cap, Cout) in x.dtype."""
    if plan.groups is None:
        raise ValueError("the up conv needs the plan's EdgeGroups "
                         "(edge_conv.with_edge_layouts)")
    wc = w.to(x.dtype)
    out = x.new_zeros((plan.child_parent.shape[0], w.shape[2]))
    for k, rows in _segments(plan.groups):
        src = x.index_select(0, plan.child_parent.index_select(0, rows))
        out[rows] = matmul_f32(src, wc[k]).to(x.dtype)
    return out


def _up_smem(cin: int, bn: int, tpb: int, w_nk: bool = False) -> int:
    """Shared-memory bytes of one ``csrc/up_conv_fwd.cu`` block (``w_nk``:
    W[k]'s slab stored as bn rows of Cin)."""
    cinp = -(-cin // 32) * 32
    slab = bn * (cinp + 8) if w_nk else cinp * (bn + 8)
    return ((slab + EDGE_TILE * (bn + 8) + 4 * EDGE_TILE * 40) * 2
            + (2 * tpb * EDGE_TILE + tpb) * 4)


def _child_tiles(child_cap: int, cin: int, cout: int, w_nk: bool,
                 target, max_tpb: int = UP_MAX_TPB) -> Tuple[int, int]:
    """(column tile, tiles per block) of one ``csrc/up_conv_fwd.cu`` launch.

    The column tile fits ``cout`` (96 as one 96-column slab), narrowed
    where W[k]'s Cin x tile slab would not fit shared memory (the wide
    bottleneck archs).  A block walks ``tiles per block`` 64-row tiles with
    one staged weight slab: as many as keep about ``target(column tile)``
    blocks (rounded), at most ``max_tpb``."""
    bn, n_col = _fit(cout, FWD_COL_TILES)
    while _up_smem(cin, bn, UP_MAX_TPB, w_nk) > UP_SMEM:
        bn -= 32
        n_col = -(-cout // bn)
    tiles = -(-child_cap // EDGE_TILE) + 8
    blocks = target(bn)
    tpb = min(max_tpb, max(1, (2 * tiles * n_col + blocks)
                           // (2 * blocks)))
    return bn, tpb


@functools.lru_cache(maxsize=None)
def up_tiles(child_cap: int, cin: int, cout: int) -> Tuple[int, int]:
    """(column tile, tiles per block) of one ``up_conv_fwd`` launch
    (:func:`_child_tiles`, about ``UP_TARGET_BLOCKS`` blocks)."""
    return _child_tiles(child_cap, cin, cout, False,
                        lambda bn: UP_TARGET_BLOCKS)


def _bind_up() -> ctypes.CDLL:
    lib = _build.load(_LIB_UP)
    fn = lib.up_conv_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_edge_layouts(plan: DownPlan, device: int) -> None:
    """The CUDA wrappers' checks of an edge's ``child_parent``, groups and
    skip plan: the kernels read them unchecked."""
    if plan.groups is None or plan.skip is None:
        raise ValueError("the edge convs' kernels need the plan's EdgeGroups "
                         "and EdgeSkip (edge_conv.with_edge_layouts)")
    cp = plan.child_parent
    if (cp.dtype != torch.int32 or cp.get_device() != device
            or not cp.is_contiguous()):
        raise ValueError(f"child_parent: {cp.dtype} on {cp.device}, want "
                         f"contiguous int32 on cuda:{device}")
    child_cap = cp.shape[0]
    parent_cap = plan.fwd.shape[1]
    tiles = -(-child_cap // EDGE_TILE) + 8
    check_index_arrays(plan.groups, {"rows": (tiles * EDGE_TILE,),
                                     "tile_k": (tiles,), "count": (8,)},
                       device, "groups")
    check_index_arrays(plan.skip, {
        "nbr_mask": (parent_cap,), "order": (parent_cap,),
        "tile_mask": (-(-parent_cap // TILE_ROWS),)}, device, "skip")


def up_conv_fwd(x: torch.Tensor, w: torch.Tensor, plan: DownPlan
                ) -> torch.Tensor:
    """Up conv forward over the children (kernel 5).  x: (parent_cap, Cin),
    exactly zero at padded rows; w: (8, Cin, Cout) float; plan: the edge's
    DownPlan with its groups (``child_parent`` int32, each parent index
    below parent_cap).  Returns (child_cap, Cout); padded child rows are
    exactly zero.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (x bf16, Cin and Cout multiples of 8; w cast to bf16 where
    it is not) or raise."""
    if x.device.type == "cpu":
        return up_conv_plain(x, w, plan)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    K, cin, cout = w.shape
    cp = plan.child_parent
    if x.dim() != 2 or x.shape[1] != cin or K != 8:
        raise ValueError(f"x{tuple(x.shape)} and w{tuple(w.shape)} disagree")
    if cin % 8 or cout % 8:
        raise ValueError(f"Cin={cin} and Cout={cout} must be multiples of 8")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    d = x.get_device()
    if w.get_device() != d:
        raise ValueError("x, w and the plan must share one device")
    _check_edge_layouts(plan, d)
    child_cap = cp.shape[0]
    if max(x.numel(), child_cap * cout) >= 2 ** 31:
        raise ValueError("sizes beyond the kernel's 32-bit indexing")
    if child_cap == 0:
        return torch.empty((0, cout), dtype=torch.bfloat16, device=x.device)
    out = launch_up_conv(x, w.to(torch.bfloat16).contiguous(), cp,
                         plan.groups, *up_tiles(child_cap, cin, cout))
    up_conv_fwd.launches += 1
    return out


def launch_up_conv(x: torch.Tensor, wb: torch.Tensor,
                   child_parent: torch.Tensor, groups: EdgeGroups, bn: int,
                   tpb: int, w_nk: bool = False) -> torch.Tensor:
    """One launch of ``csrc/up_conv_fwd.cu`` with the column tile and tiles
    per block given (``up_conv_fwd`` and ``down_conv_bwd`` check the
    arguments; wb is the bf16 weight, (8, Cout, Cin) and read transposed if
    ``w_nk``).  Returns (child_cap, Cout) bf16."""
    cin, cout = wb.shape[1], wb.shape[2]
    if w_nk:
        cin, cout = cout, cin
    child_cap = child_parent.shape[0]
    out = torch.empty((child_cap, cout), dtype=torch.bfloat16,
                      device=x.device)
    lib = _bind_up()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.up_conv_fwd_bf16(
            x.data_ptr(), wb.data_ptr(), child_parent.data_ptr(),
            groups.rows.data_ptr(), groups.tile_k.data_ptr(),
            groups.count.data_ptr(), out.data_ptr(), groups.tile_k.shape[0],
            child_cap, cin, cout, bn, tpb, int(w_nk), stream)
    if err != 0:
        raise RuntimeError(f"up_conv_fwd launch failed: cudaError {err}")
    return out


up_conv_fwd.launches = 0


# Plain PyTorch version of the backward (x, w, g, plan) -> (dx, dW)
up_conv_bwd_plain = sparse_up_conv_bwd


@functools.lru_cache(maxsize=None)
def up_dx_tiles(parent_cap: int, cin: int, cout: int) -> Tuple[int, int, int]:
    """(row tile, column tile, offset groups) of the up-conv ``dx`` launch
    (``Cout -> Cin`` over the parents), fitted to
    ``scripts/dev_up_tiles.py`` on the card: 64-row tiles (128 lost at
    every edge), a column tile that fits ``cin`` up to 128 columns, and 2
    offset groups where the tiles leave fewer than ``UP_TARGET_BLOCKS``
    blocks."""
    bn, n_col = _fit(cin, [t for t in FWD_COL_TILES if t <= 128])
    blocks = -(-parent_cap // 64) * n_col
    return 64, bn, 2 if blocks < UP_TARGET_BLOCKS else 1


def up_wgrad_tiles(parent_cap: int, cin: int, cout: int):
    """``wgrad_tiles`` of the up conv's ``dW``: each offset's children are
    at most the parents (one child per parent and offset)."""
    return wgrad_tiles(parent_cap, 8, cin, cout, True)


def up_conv_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                plan: DownPlan):
    """Up conv backward (kernel 4): ``(dx, dW)`` for the cotangent ``g``
    (child_cap, Cout); dx (parent_cap, Cin) in x.dtype, dW (8, Cin, Cout)
    fp32.

    ``dx[p] = sum_k g[fwd[k, p]] @ W[k]^T`` runs over the parents sorted by
    the edge's skip plan, multiplying only the offsets a tile of parents
    holds, with ``W[k]^T`` read inside the kernel (``csrc/gather_gemm_fwd.cu``
    with ``w_nk``); ``dW[k] = sum_c x[parent(c)]^T g[c]`` reduces each
    offset over its own children, read from the groups
    (``csrc/gather_gemm_bwd.cu`` in group mode).  ``g`` must be exactly
    zero at padded child rows; dx then is exactly zero at padded parent
    rows.  CPU tensors take the plain version; CUDA tensors launch the
    kernels (x bf16; ``g`` and ``w`` are cast to bf16 where they are not)
    or raise.
    """
    if x.device.type == "cpu":
        return up_conv_bwd_plain(x, w, g, plan)
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    K, cin, cout = w.shape
    pcap, ccap = plan.fwd.shape[1], plan.child_parent.shape[0]
    if (K != 8 or x.shape != (pcap, cin) or g.shape != (ccap, cout)
            or cin % 8 or cout % 8):
        raise ValueError(f"x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"g{tuple(g.shape)} and the plan disagree")
    d = x.get_device()
    _check_edge_layouts(plan, d)
    gb = g.to(torch.bfloat16).contiguous()
    wb = w.to(torch.bfloat16).contiguous()
    if not x.is_contiguous() or x.data_ptr() % 16 or gb.data_ptr() % 16:
        raise ValueError("x must be contiguous, x and g 16-byte aligned")
    if gb.get_device() != d:
        raise ValueError("x, g and the plan must share one device")
    dx = gather_gemm_cuda(gb, wb, plan.fwd, plan.skip, w_nk=True,
                          tiles=up_dx_tiles(pcap, cin, cout))
    dw = launch_gather_wgrad(
        x, gb, None, (plan.groups.rows, plan.groups.count),
        *up_wgrad_tiles(pcap, cin, cout), amap=plan.child_parent,
        seg_tile=EDGE_TILE)
    up_conv_bwd.launches += 1
    return dx, dw


up_conv_bwd.launches = 0


class UpConv(torch.autograd.Function):
    """``UpConv.apply(x, w, plan)`` with ``plan`` the edge's
    :class:`~.types.DownPlan` (with its groups and skip plan on the card):
    the model's up conv, forward :func:`up_conv_fwd` (kernel 5, the
    counterpart of ``windowed_up_conv``'s forward), backward
    :func:`up_conv_bwd` (kernel 4).  Taking the plan as one object keeps
    the layouts with the plan they were built from: the kernels read them
    unchecked.  The weight is cast to the activations' dtype once, and the
    backward reuses that copy.

    The output's cotangent must be exactly zero at padded child rows (the
    model's BatchNorm re-masks); the returned dx is exactly zero at padded
    parent rows."""

    @staticmethod
    def forward(ctx, x, w, plan):
        wc = w.to(x.dtype)
        ctx.save_for_backward(x, wc)
        ctx.plan, ctx.w_dtype = plan, w.dtype
        return up_conv_fwd(x, wc, plan)

    @staticmethod
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        dx, dw = up_conv_bwd(x, wc, g.contiguous(), ctx.plan)
        return dx, dw.to(ctx.w_dtype), None


# Plain PyTorch versions of the down conv: (x, w, plan) -> out and
# (x, w, g, plan) -> (dx, dW)
down_conv_plain = sparse_down_conv
down_conv_bwd_plain = sparse_down_conv_bwd


@functools.lru_cache(maxsize=None)
def down_tiles(parent_cap: int, cin: int, cout: int
               ) -> Tuple[int, int, int, bool]:
    """(row tile, column tile, offset groups, staged epilogue) of the down
    conv's forward launch (``csrc/gather_gemm_fwd.cu`` in skip mode over
    the parents).  The column tile fits ``cout``; where 128-row tiles give
    the card fewer than ``DOWN_TARGET_BLOCKS`` blocks (the small edges),
    each tile's offsets are split over 2 or 4 blocks; with one group the
    tile is staged and stored as 16-byte row vectors."""
    bn, n_col = _fit(cout, FWD_COL_TILES)
    bm = DOWN_ROW_TILE
    while (bm // 32) * (bn // 32) > MAX_WARPS:
        bm //= 2
    blocks = -(-parent_cap // bm) * n_col
    groups = 1
    while groups < DOWN_MAX_GROUPS and blocks * groups < DOWN_TARGET_BLOCKS:
        groups *= 2
    return bm, bn, groups, groups == 1


def down_conv_fwd(x: torch.Tensor, w: torch.Tensor, plan: DownPlan
                  ) -> torch.Tensor:
    """Down conv forward (kernel 3).  x: (child_cap, Cin), exactly zero at
    padded rows; w: (8, Cin, Cout) float; plan: the edge's DownPlan with its
    skip plan.  Returns (parent_cap, Cout); padded parent rows are exactly
    zero.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (x bf16, Cin and Cout multiples of 8; w cast to bf16 where it is
    not) or raise."""
    if x.device.type == "cpu":
        return down_conv_plain(x, w, plan)
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    _check_edge_layouts(plan, x.get_device())
    _, cin, cout = w.shape
    *tiles, staged = down_tiles(plan.fwd.shape[1], cin, cout)
    out = gather_gemm_cuda(x, w, plan.fwd, plan.skip, tiles=tuple(tiles),
                           staged=staged)
    down_conv_fwd.launches += 1
    return out


down_conv_fwd.launches = 0


@functools.lru_cache(maxsize=None)
def down_dx_tiles(child_cap: int, cin: int, cout: int) -> Tuple[int, int]:
    """(column tile, tiles per block) of the down conv's ``dx`` launch
    (``csrc/up_conv_fwd.cu`` with ``W_NK``: ``Cout -> Cin`` over the
    children): :func:`_child_tiles` for the transposed slab, with about
    ``DOWN_DX_TARGET_WARPS`` warps over all blocks and at most
    ``DOWN_DX_MAX_TPB`` tiles a block (the sweep's times are flat from 4
    to 12 tiles at the JAX bench's 8 scenes, and rise beyond)."""
    return _child_tiles(child_cap, cout, cin, True,
                        lambda bn: DOWN_DX_TARGET_WARPS // (2 * bn // 32),
                        DOWN_DX_MAX_TPB)


@functools.lru_cache(maxsize=None)
def down_wgrad_tiles(parent_cap: int, cin: int, cout: int):
    """``wgrad_tiles`` of the down conv's ``dW^T`` launch (``a`` = the
    parents' cotangent, Cout wide; ``b`` = the children, Cin wide), in
    splits of at least ``DOWN_WGRAD_MIN_ROWS`` rows."""
    return wgrad_tiles(parent_cap, 8, cout, cin, True, DOWN_WGRAD_MIN_ROWS)


def down_conv_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                  plan: DownPlan):
    """Down conv backward (kernel 6): ``(dx, dW)`` for the cotangent ``g``
    (parent_cap, Cout); dx (child_cap, Cin) in x.dtype, dW (8, Cin, Cout)
    fp32.

    ``dx[c] = g[parent(c)] @ W[offset(c)]^T`` runs over the edge's groups,
    each child row multiplied once with ``W[k]^T`` read in the kernel
    (``csrc/up_conv_fwd.cu`` with ``w_nk``); ``dW[k] = sum_c x[c]^T
    g[parent(c)]`` reduces each offset over its own children
    (``csrc/gather_gemm_bwd.cu`` in group mode, ``a = g`` through
    ``child_parent``, ``b = x``: ``dW^T``, transposed here).  ``g`` must be
    exactly zero at padded parent rows; dx is exactly zero at padded child
    rows.  CPU tensors take the plain version; CUDA tensors launch the
    kernels (x bf16; ``g`` and ``w`` are cast to bf16 where they are not)
    or raise.
    """
    if x.device.type == "cpu":
        return down_conv_bwd_plain(x, w, g, plan)
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    K, cin, cout = w.shape
    pcap, ccap = plan.fwd.shape[1], plan.child_parent.shape[0]
    if (K != 8 or x.shape != (ccap, cin) or g.shape != (pcap, cout)
            or cin % 8 or cout % 8):
        raise ValueError(f"x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"g{tuple(g.shape)} and the plan disagree")
    d = x.get_device()
    _check_edge_layouts(plan, d)
    gb = g.to(torch.bfloat16).contiguous()
    wb = w.to(torch.bfloat16).contiguous()
    if not x.is_contiguous() or x.data_ptr() % 16 or gb.data_ptr() % 16:
        raise ValueError("x must be contiguous, x and g 16-byte aligned")
    if gb.get_device() != d or wb.get_device() != d:
        raise ValueError("x, w, g and the plan must share one device")
    if max(x.numel(), gb.numel()) >= 2 ** 31:
        raise ValueError("sizes beyond the kernels' 32-bit indexing")
    dx = launch_up_conv(gb, wb, plan.child_parent, plan.groups,
                        *down_dx_tiles(ccap, cin, cout), w_nk=True)
    dw = launch_gather_wgrad(
        gb, x, None, (plan.groups.rows, plan.groups.count),
        *down_wgrad_tiles(pcap, cin, cout), amap=plan.child_parent,
        seg_tile=EDGE_TILE).transpose(1, 2).contiguous()
    down_conv_bwd.launches += 1
    return dx, dw


down_conv_bwd.launches = 0


class DownConv(torch.autograd.Function):
    """``DownConv.apply(x, w, plan)`` with ``plan`` the edge's
    :class:`~.types.DownPlan` (with its groups and skip plan on the card):
    the model's down conv, forward :func:`down_conv_fwd` (kernel 3),
    backward :func:`down_conv_bwd` (kernel 6).  Taking the plan as one
    object keeps the layouts with the plan they were built from: the
    kernels read them unchecked.  The weight is cast to the activations'
    dtype once, and the backward reuses that copy.

    The output's cotangent must be exactly zero at padded parent rows (the
    model's BatchNorm re-masks); the returned dx is exactly zero at padded
    child rows."""

    @staticmethod
    def forward(ctx, x, w, plan):
        wc = w.to(x.dtype)
        ctx.save_for_backward(x, wc)
        ctx.plan, ctx.w_dtype = plan, w.dtype
        return down_conv_fwd(x, wc, plan)

    @staticmethod
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        dx, dw = down_conv_bwd(x, wc, g.contiguous(), ctx.plan)
        return dx, dw.to(ctx.w_dtype), None
