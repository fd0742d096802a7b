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

The up conv's kernels read two layouts of the edge, built once per batch
with the plans (:func:`with_edge_layouts`, in both geometry paths): the
children grouped by offset (:class:`~.types.EdgeGroups`), which kernel 5
walks tile by tile and ``dW`` reduces segment by segment, and the parents
sorted by which children they hold (:class:`~.types.EdgeSkip`), with
which ``dx`` multiplies only the offsets a tile of parents holds.

Every wrapper takes its plain version only for a CPU tensor and counts its
launches in ``<wrapper>.launches`` (one per call that reaches the card).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .ops import (gather_matmul_sum, matmul_f32, sparse_down_conv_bwd,
                  sparse_up_conv_bwd)
from .stencil_conv import (FWD_COL_TILES, TILE_ROWS, _fit,
                           check_index_arrays, gather_gemm_cuda,
                           gather_wgrad_cuda, launch_gather_wgrad,
                           sorted_masks, wgrad_tiles)
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


def _up_smem(cin: int, bn: int, tpb: int) -> int:
    """Shared-memory bytes of one ``csrc/up_conv_fwd.cu`` block."""
    return (((-(-cin // 32) * 32 + EDGE_TILE) * (bn + 8)
             + 4 * EDGE_TILE * 40) * 2 + (2 * tpb * EDGE_TILE + tpb) * 4)


@functools.lru_cache(maxsize=None)
def up_tiles(child_cap: int, cin: int, cout: int) -> Tuple[int, int]:
    """(column tile, tiles per block) of one ``up_conv_fwd`` launch.

    The column tile fits ``cout`` (96 as one 96-column slab), narrowed
    where W[k]'s Cin x tile slab would not fit shared memory (the wide
    bottleneck archs).  A block walks ``tiles per block`` 64-row tiles with
    one staged weight slab: as many as keep about ``UP_TARGET_BLOCKS``
    blocks (rounded), at most ``UP_MAX_TPB``."""
    bn, n_col = _fit(cout, FWD_COL_TILES)
    while _up_smem(cin, bn, UP_MAX_TPB) > UP_SMEM:
        bn -= 32
        n_col = -(-cout // bn)
    tiles = -(-child_cap // EDGE_TILE) + 8
    tpb = min(UP_MAX_TPB,
              max(1, (2 * tiles * n_col + UP_TARGET_BLOCKS)
                  // (2 * UP_TARGET_BLOCKS)))
    return bn, tpb


def _bind_up() -> ctypes.CDLL:
    lib = _build.load(_LIB_UP)
    fn = lib.up_conv_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_edge_layouts(plan: DownPlan, device: int) -> None:
    """The CUDA wrappers' checks of an edge's groups and skip plan: the
    kernels read them unchecked."""
    if plan.groups is None or plan.skip is None:
        raise ValueError("the up conv's kernels need the plan's EdgeGroups "
                         "and EdgeSkip (edge_conv.with_edge_layouts)")
    child_cap = plan.child_parent.shape[0]
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
    if cp.dtype != torch.int32:
        raise TypeError("child_parent must be int32")
    if not (x.is_contiguous() and cp.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("x and child_parent must be contiguous, x 16-byte "
                         "aligned")
    d = x.get_device()
    if w.get_device() != d or cp.get_device() != d:
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
                   tpb: int) -> torch.Tensor:
    """One launch of ``csrc/up_conv_fwd.cu`` with the column tile and tiles
    per block given (``up_conv_fwd`` checks the arguments; wb is the bf16
    weight).  Returns (child_cap, Cout) bf16."""
    cin, cout = wb.shape[1], wb.shape[2]
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
            child_cap, cin, cout, bn, tpb, stream)
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
    if plan.child_parent.get_device() != d or gb.get_device() != d:
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
