"""Spatial sharding of ONE oversized scene over several GPUs (halo exchange).

Counterpart of ``openscene_tpu/parallel/spatial.py``.  A scene whose voxels
do not fit one device is split over D ranks by sorted coordinate key, and
each k=3 stencil conv exchanges the rows its shard boundary needs:

* Rows are sorted by packed coordinate key (``sparse.geometry.pack_coords``)
  and split into D contiguous ranges, one a rank.  The sort order is
  spatially coherent, so most stencil neighbours stay on their shard.
* Each shard's k^3 plan ``fwd`` (K, cap_d) reads an *extended* buffer
  ``[local rows (cap_d) | halo rows (H)]``; a missing neighbour points into
  the shard's own zero padding ``[n_d, cap_d)``.  The halo rows are the
  sorted-unique remote neighbours; each rank publishes an export list of
  the E rows some other shard needs.
* Exchange: one gather of the (D, E, C) export pool per conv.  On NCCL it
  is ``all_gather_into_tensor``; on gloo (the CPU, and two ranks sharing one
  card), which has no ``all_gather`` for CUDA tensors, it is an
  ``all_reduce`` of a zero-filled pool holding the rank's own slice, as
  ``parallel/mesh.py:gather_head`` gathers the head.

:func:`build_spatial_shards`, :func:`shard_rows` and :func:`unshard_rows`
are copies of the JAX package's NumPy functions, bit for bit.  What the port
adds is the per-rank device plan (:class:`ShardPlan`, :func:`shard_plan`)
and the conv, :class:`SpatialConv`, whose forward is kernel 1 (the stencil
forward of ``csrc/gather_gemm_fwd.cu``) over the extended buffer and whose
backward is kernel 1 on the cotangent with the weight read transposed
(``dx``) and kernel 2 (``csrc/gather_gemm_bwd.cu``, ``dW``).  The JAX
package differentiates through ``all_gather`` and lets the transpose route
the halo cotangents home; here the backward does it by hand: the halo rows
of ``d_ext`` are scattered into a zero pool cotangent, summed over the
group, and each rank adds its own E rows into ``dx``; ``dW`` is summed over
the group, as ``shard_map`` sums a replicated weight's cotangent.

Where the model's stencil plans and these differ (and the code that
handles it):

* Existence.  ``stencil_conv.build_conv_skip`` decides by default that a
  neighbour exists where ``fwd < num``; here every halo neighbour sits at
  ``cap_d + j >= num``, and the transpose plan marks a missing pair with
  -1.  Both skip plans are built from explicit existence bits
  (:func:`shard_plan`).
* The transpose.  The model's ``dx`` reuses ``fwd`` with flipped weights,
  a symmetry the extended buffer lacks (halo rows have no outputs here, and
  a row's mirrored neighbour may be remote).  ``bwd`` (K, cap_d + H) is
  built by inverting ``fwd``: each extended row is the offset-k neighbour of
  at most one output row; every other entry, the padding rows' included,
  is -1, so ``d_ext`` is exactly zero there.
* Zero rows.  ``x``'s padding rows ``[n_d, cap_d)`` stay zero through
  :func:`shard_rows` and every conv: ``y`` and ``dx`` are exactly zero at
  padded rows.

``ppermute`` to the O(1) neighbouring shards instead of a gather over all D
is the bandwidth-optimal upgrade once D grows; the per-owner export lists
are its send lists.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..sparse.geometry import offset_key_delta, pack_coords
from ..sparse.ops import gather_matmul_sum, gather_wgrad
from ..sparse.stencil_conv import (conv_skip_from_bits, gather_gemm_cuda,
                                   gather_wgrad_cuda)
from ..sparse.types import ConvSkip, flip_permutation, stencil_offsets


class SpatialShards(NamedTuple):
    """Host-built plan for one spatially sharded level.

    coords:     (D, cap_d, 4) int32 — per-shard padded voxel coords.
    num:        (D,)   int32 — valid rows of each shard.
    fwd:        (D, K, cap_d) int32 — gather plan into the extended buffer
                ``[local (cap_d) | halo (H)]``; missing neighbors point into
                the shard's own zero padding.
    export_idx: (D, E) int32 — local rows each device publishes to the pool.
    halo_src:   (D, H) int32 — positions into the flattened (D*E,) pool.
    flip_perm:  (K,)   int32 — mirrored-offset permutation (diagnostics).
    perm:       (N,)   int32 — input row of each global sorted position.
    starts:     (D+1,) int64 — sorted-range boundary of each shard.
    """
    coords: np.ndarray
    num: np.ndarray
    fwd: np.ndarray
    export_idx: np.ndarray
    halo_src: np.ndarray
    flip_perm: np.ndarray
    perm: np.ndarray
    starts: np.ndarray

    @property
    def n_shards(self) -> int:
        return self.fwd.shape[0]

    @property
    def cap_d(self) -> int:
        return self.fwd.shape[2]

    @property
    def halo_cap(self) -> int:
        return self.halo_src.shape[1]


def _round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def build_spatial_shards(coords: np.ndarray, n_shards: int,
                         kernel_size: int = 3,
                         round_to: int = 8) -> SpatialShards:
    """Split one scene's voxels into D contiguous sorted ranges and build
    per-shard stencil plans with halo/export exchange lists.

    ``coords``: (N, 4) int (batch, x, y, z) UNIQUE voxels (any row order).
    ``round_to`` rounds cap_d, E and H up: 8 keeps the kernels' bf16 rows
    16-byte aligned in the extended buffer.
    """
    coords = np.asarray(coords, dtype=np.int32)
    N = coords.shape[0]
    D = int(n_shards)
    keys = pack_coords(coords)
    if len(np.unique(keys)) != N:
        raise ValueError("spatial sharding expects unique voxel coords")
    perm = np.argsort(keys, kind="stable").astype(np.int32)
    skeys = keys[perm]
    scoords = coords[perm]

    starts = np.linspace(0, N, D + 1).astype(np.int64)
    counts = np.diff(starts)
    # >= 1 spare zero row per shard so missing neighbors always have a
    # zero-padding target even in the fullest shard
    cap_d = _round_up(int(counts.max()) + 1, round_to)

    offsets = stencil_offsets(kernel_size)
    K = len(offsets)
    deltas = offset_key_delta(offsets)

    fwd = np.zeros((D, K, cap_d), dtype=np.int32)
    halo_lists = []
    # remote global-sorted positions requested FROM each owner, per owner
    requested = [[] for _ in range(D)]
    # per-shard raw probe results kept for the remote rewrite second pass
    probe_pos = []
    for d in range(D):
        lo, hi = int(starts[d]), int(starts[d + 1])
        n_d = hi - lo
        # missing neighbors: spread across this shard's zero padding
        # [n_d, cap_d) (single-row nulls serialize the gather)
        pad = np.uint32(cap_d - n_d)
        flat = (np.arange(K * cap_d, dtype=np.uint32)
                * np.uint32(2654435761))
        fwd[d] = (n_d + (flat % pad).astype(np.int32)).reshape(K, cap_d)

        probes = skeys[lo:hi][None, :] + deltas[:, None]      # (K, n_d)
        pos = np.searchsorted(skeys, probes)
        pos_c = np.minimum(pos, N - 1)
        found = (skeys[pos_c] == probes) if N else np.zeros_like(pos, bool)
        gpos = np.where(found, pos_c, -1)                     # (K, n_d)
        local = found & (gpos >= lo) & (gpos < hi)
        remote = found & ~local
        fwd[d][:, :n_d][local] = (gpos[local] - lo).astype(np.int32)
        halo_d = np.unique(gpos[remote]).astype(np.int64)
        halo_lists.append(halo_d)
        owners = np.searchsorted(starts, halo_d, side="right") - 1
        for o in np.unique(owners):
            requested[o].append(halo_d[owners == o])
        probe_pos.append((gpos, remote, halo_d))

    export_rows = [np.unique(np.concatenate(r)) if r else
                   np.empty(0, dtype=np.int64) for r in requested]
    E = _round_up(max(len(e) for e in export_rows), round_to)
    H = _round_up(max(len(h) for h in halo_lists), round_to)

    export_idx = np.zeros((D, E), dtype=np.int32)
    halo_src = np.zeros((D, H), dtype=np.int32)
    out_coords = np.full((D, cap_d, 4), 2 ** 20, dtype=np.int32)
    num = np.zeros((D,), dtype=np.int32)
    for d in range(D):
        lo, hi = int(starts[d]), int(starts[d + 1])
        num[d] = hi - lo
        out_coords[d, :hi - lo] = scoords[lo:hi]
        e = export_rows[d]
        export_idx[d, :len(e)] = (e - lo).astype(np.int32)

        gpos, remote, halo_d = probe_pos[d]
        if len(halo_d):
            owners = np.searchsorted(starts, halo_d, side="right") - 1
            pool_pos = np.empty(len(halo_d), dtype=np.int32)
            for o in np.unique(owners):
                m = owners == o
                pool_pos[m] = (o * E + np.searchsorted(
                    export_rows[o], halo_d[m])).astype(np.int32)
            halo_src[d, :len(halo_d)] = pool_pos
            # rewrite remote fwd entries to extended-buffer halo slots
            slot = cap_d + np.searchsorted(halo_d, gpos[remote])
            fwd[d][:, :num[d]][remote] = slot.astype(np.int32)

    return SpatialShards(
        coords=out_coords, num=num, fwd=fwd, export_idx=export_idx,
        halo_src=halo_src, flip_perm=flip_permutation(offsets),
        perm=perm, starts=starts)


def shard_rows(x: np.ndarray, shards: SpatialShards) -> np.ndarray:
    """(N, C) input-order row features -> (D, cap_d, C) zero-padded shards."""
    D, cap_d = shards.n_shards, shards.cap_d
    out = np.zeros((D, cap_d) + x.shape[1:], dtype=x.dtype)
    xs = np.asarray(x)[shards.perm]
    for d in range(D):
        lo, hi = int(shards.starts[d]), int(shards.starts[d + 1])
        out[d, :hi - lo] = xs[lo:hi]
    return out


def unshard_rows(y, shards: SpatialShards) -> np.ndarray:
    """(D, cap_d, C) shard outputs -> (N, C) in the ORIGINAL row order."""
    y = np.asarray(y)
    ys = np.concatenate(
        [y[d, :int(shards.num[d])] for d in range(shards.n_shards)], axis=0)
    out = np.empty_like(ys)
    out[shards.perm] = ys
    return out


# ---- the per-rank device plan ----

class ShardPlan(NamedTuple):
    """One rank's plan of a :class:`SpatialShards` level, on its device.

    fwd:        (K, cap_d) int32 — the shard's gather plan into the
                extended buffer ``[local (cap_d) | halo (H)]``.
    bwd:        (K, cap_d + H) int32 — the transpose plan: the output row
                whose offset-k neighbour is extended row e, -1 where none
                is (padding rows, local and halo, are all -1).
    fwd_skip:   :class:`~..sparse.types.ConvSkip` of ``fwd`` from its
                existence bits (local or remote neighbour found).
    bwd_skip:   :class:`ConvSkip` of ``bwd`` (``bwd >= 0``).
    export_idx: (E,) int32 — local rows this rank publishes; the first
                ``n_export`` are valid, the rest 0.
    halo_src:   (H,) int32 — positions into the (D*E,) pool; the first
                ``n_halo`` are valid, the rest 0.
    rank, n_shards, num: this rank, D, and its valid rows.
    """
    fwd: torch.Tensor
    bwd: torch.Tensor
    fwd_skip: ConvSkip
    bwd_skip: ConvSkip
    export_idx: torch.Tensor
    n_export: int
    halo_src: torch.Tensor
    n_halo: int
    rank: int
    n_shards: int
    num: int

    @property
    def cap_d(self) -> int:
        return self.fwd.shape[1]

    @property
    def halo_cap(self) -> int:
        return self.halo_src.shape[0]

    @property
    def export_cap(self) -> int:
        return self.export_idx.shape[0]


def fwd_exists(shards: SpatialShards, rank: int) -> np.ndarray:
    """(K, cap_d) bool: whether each (offset, output row) pair of the
    rank's ``fwd`` has a neighbour, local (``< num``) or remote
    (``>= cap_d``); missing ones point into ``[num, cap_d)``."""
    f = shards.fwd[rank]
    n = int(shards.num[rank])
    exists = (f < n) | (f >= shards.cap_d)
    exists[:, n:] = False
    return exists


def transpose_plan(shards: SpatialShards, rank: int) -> np.ndarray:
    """The rank's (K, cap_d + H) transpose plan: ``bwd[k, fwd[k, r]] = r``
    for every pair that exists, -1 elsewhere."""
    f = shards.fwd[rank]
    K, cap_d = f.shape
    bwd = np.full((K, cap_d + shards.halo_cap), -1, dtype=np.int32)
    ks, rs = np.nonzero(fwd_exists(shards, rank))
    bwd[ks, f[ks, rs]] = rs.astype(np.int32)
    return bwd


def _valid_lengths(shards: SpatialShards):
    """``(n_export, n_halo)`` per shard: the valid prefixes of the padded
    export and halo lists (every halo slot is read by some ``fwd`` entry,
    every export row by some shard's halo)."""
    D, cap_d = shards.n_shards, shards.cap_d
    E = shards.export_idx.shape[1]
    n_halo = np.zeros(D, np.int64)
    for d in range(D):
        f = shards.fwd[d][:, :int(shards.num[d])]
        if (f >= cap_d).any():
            n_halo[d] = int(f.max()) - cap_d + 1
    used = np.concatenate([shards.halo_src[d, :n_halo[d]] for d in range(D)])
    n_export = np.zeros(D, np.int64)
    for o in range(D):
        mine = used[(used >= o * E) & (used < (o + 1) * E)]
        if len(mine):
            n_export[o] = int(mine.max()) - o * E + 1
    return n_export, n_halo


def shard_plan(shards: SpatialShards, rank: int, device) -> ShardPlan:
    """This rank's :class:`ShardPlan` on ``device``.  The skip plans come
    from explicit existence bits (``conv_skip_from_bits``), never from
    ``fwd < num``: ``build_conv_skip``'s rule marks every halo neighbour
    missing, and counts the transpose plan's -1 entries as pairs."""
    dev = torch.device(device)
    n_export, n_halo = _valid_lengths(shards)
    num = int(shards.num[rank])
    fwd = torch.as_tensor(shards.fwd[rank], device=dev)
    bwd = torch.as_tensor(transpose_plan(shards, rank), device=dev)
    fwd_skip = conv_skip_from_bits(torch.as_tensor(
        fwd_exists(shards, rank), device=dev))
    bwd_skip = conv_skip_from_bits(bwd >= 0)
    return ShardPlan(
        fwd=fwd, bwd=bwd, fwd_skip=fwd_skip, bwd_skip=bwd_skip,
        export_idx=torch.as_tensor(shards.export_idx[rank], device=dev),
        n_export=int(n_export[rank]),
        halo_src=torch.as_tensor(shards.halo_src[rank], device=dev),
        n_halo=int(n_halo[rank]), rank=int(rank),
        n_shards=shards.n_shards, num=num)


# ---- the exchange ----

def gather_pool(export: torch.Tensor, plan: ShardPlan, group) -> torch.Tensor:
    """The (D*E, C) pool of every rank's export rows, in rank order, over
    ``group`` (None: the default group).  NCCL gathers it; gloo, which has
    no ``all_gather`` for CUDA tensors, sums a zero-filled pool holding this
    rank's slice (in fp32, exact: one term is nonzero)."""
    D, (E, C) = plan.n_shards, export.shape
    if dist.get_backend(group) == "nccl":
        pool = export.new_empty((D * E, C))
        dist.all_gather_into_tensor(pool, export.contiguous(), group=group)
        return pool
    pool = torch.zeros((D, E, C), dtype=torch.float32, device=export.device)
    pool[plan.rank] = export
    dist.all_reduce(pool, group=group)
    return pool.view(D * E, C).to(export.dtype)


def return_halo_grad(d_halo: torch.Tensor, plan: ShardPlan, group
                     ) -> torch.Tensor:
    """The transpose of the gather: each rank's halo cotangents (H, C)
    scattered into a zero (D*E, C) fp32 pool at their valid ``halo_src``,
    summed over ``group``; returns this rank's (E, C) fp32 rows.  The
    padded halo entries (0) add nothing."""
    D, E = plan.n_shards, plan.export_cap
    C = d_halo.shape[1]
    pool = torch.zeros((D * E, C), dtype=torch.float32,
                       device=d_halo.device)
    n = plan.n_halo
    if n:
        pool.index_add_(0, plan.halo_src[:n].long(), d_halo[:n].float())
    dist.all_reduce(pool, group=group)
    return pool[plan.rank * E:(plan.rank + 1) * E]


# ---- the conv's two halves: kernels on the card, plain on the CPU ----

def spatial_conv_plain(ext: torch.Tensor, w: torch.Tensor, plan: ShardPlan
                       ) -> torch.Tensor:
    """Plain PyTorch version of the forward: ``sum_k ext[fwd[k]] @ W[k]``,
    one ``index_select`` and fp32 matmul per offset."""
    return gather_matmul_sum(ext, w, plan.fwd).to(ext.dtype)


def spatial_conv_fwd(ext: torch.Tensor, w: torch.Tensor, plan: ShardPlan
                     ) -> torch.Tensor:
    """The shard's conv over its extended buffer ``ext`` (cap_d + H, Cin):
    (cap_d, Cout).  A CPU tensor takes the plain version; a CUDA tensor
    launches kernel 1 (``gather_gemm_cuda``, bf16) with the existence-built
    skip plan, or raises."""
    if ext.device.type == "cpu":
        return spatial_conv_plain(ext, w, plan)
    out = gather_gemm_cuda(ext, w, plan.fwd, plan.fwd_skip)
    spatial_conv_fwd.launches += 1
    return out


spatial_conv_fwd.launches = 0


def spatial_conv_bwd_plain(ext: torch.Tensor, w: torch.Tensor,
                           g: torch.Tensor, plan: ShardPlan):
    """Plain PyTorch version of the backward through the transpose plan:
    ``d_ext = sum_k g[bwd[k]] @ W[k]^T`` (cap_d + H, Cin) in ext.dtype and
    ``dW[k] = ext^T @ g[bwd[k]]`` fp32, this rank's share (a -1 entry reads
    a zero row appended to g)."""
    g = g.to(ext.dtype)
    gz = torch.cat([g, g.new_zeros((1, g.shape[1]))])
    idx = torch.where(plan.bwd < 0, g.shape[0], plan.bwd)
    d_ext = gather_matmul_sum(gz, w.transpose(1, 2), idx).to(ext.dtype)
    return d_ext, gather_wgrad(ext, gz, idx)


def spatial_conv_bwd(ext: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     plan: ShardPlan):
    """``(d_ext, dW)`` of the shard's conv for the cotangent ``g`` (cap_d,
    Cout), before the exchange: d_ext (cap_d + H, Cin) in ext.dtype, dW
    (K, Cin, Cout) fp32 this rank's share.  A CPU tensor takes the plain
    version; a CUDA tensor launches kernel 1 on ``g`` through ``bwd`` with
    W read transposed (``w_nk``) and kernel 2 (``gather_wgrad_cuda``), both
    on ``bwd``'s skip plan, or raises."""
    if ext.device.type == "cpu":
        return spatial_conv_bwd_plain(ext, w, g, plan)
    gb = g.to(torch.bfloat16).contiguous()
    d_ext = gather_gemm_cuda(gb, w, plan.bwd, plan.bwd_skip, w_nk=True)
    dw = gather_wgrad_cuda(ext, gb, plan.bwd, plan.bwd_skip)
    spatial_conv_bwd.launches += 1
    return d_ext, dw


spatial_conv_bwd.launches = 0


class SpatialConv(torch.autograd.Function):
    """``SpatialConv.apply(x, w, plan, group)``: this rank's shard
    (cap_d, Cin) -> (cap_d, Cout) of the conv over the whole scene, the
    halo exchanged over ``group`` (None: the default group).  ``x`` must be
    exactly zero at its padding rows; ``y`` and ``dx`` then are too."""

    @staticmethod
    def forward(ctx, x, w, plan: ShardPlan, group):
        export = x.index_select(0, plan.export_idx)
        halo = gather_pool(export, plan, group).index_select(0, plan.halo_src)
        # a fresh contiguous buffer: the kernels' rows stay 16-byte aligned
        ext = torch.cat([x, halo]).contiguous()
        ctx.save_for_backward(ext, w)
        ctx.plan, ctx.group = plan, group
        return spatial_conv_fwd(ext, w, plan)

    @staticmethod
    def backward(ctx, g):
        ext, w = ctx.saved_tensors
        plan, group = ctx.plan, ctx.group
        d_ext, dw = spatial_conv_bwd(ext, w, g.contiguous(), plan)
        dist.all_reduce(dw, group=group)
        cap_d = plan.cap_d
        mine = return_halo_grad(d_ext[cap_d:], plan, group)
        dx = d_ext[:cap_d]
        n = plan.n_export
        if n:
            # the remote rows' cotangents join the local ones in fp32 and
            # are rounded once; the padded export entries (0) add nothing
            dx = dx.float().index_add_(0, plan.export_idx[:n].long(),
                                       mine[:n]).to(d_ext.dtype)
        return dx, dw.to(w.dtype), None, None


def make_spatial_conv(group, shards: SpatialShards, device=None):
    """This rank's spatially sharded stencil conv: ``f(x_shard, w) ->
    y_shard`` with ``x_shard`` (cap_d, Cin) on ``device`` and ``w`` (K,
    Cin, Cout) the same on every rank.  ``group``: the initialised process
    group of the D ranks (None: the default group; one rank is a group of
    one).  This rank's shard is its rank in ``group``: NCCL's gather
    places each rank's export rows by that rank.  ``device`` resolves as
    every entry point's does (``cuda``, this process's card, unless the
    caller asks for the CPU; raises without CUDA).  Differentiable: the
    backward returns the halo cotangents to their owners and sums ``dW``
    over the group."""
    if not dist.is_initialized():
        raise RuntimeError("make_spatial_conv needs an initialised process "
                           "group (torchrun, or parallel.launch.spawn)")
    if dist.get_world_size(group) != shards.n_shards:
        raise ValueError(f"{shards.n_shards} shards over a group of "
                         f"{dist.get_world_size(group)} ranks")
    plan = shard_plan(shards, dist.get_rank(group), resolve_device(device))

    def f(x_shard: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return SpatialConv.apply(x_shard, w, plan, group)

    f.plan, f.group = plan, group
    return f
