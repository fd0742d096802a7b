"""Geometry plans built on the device from the level-0 coordinates.

Counterpart of ``openscene_tpu/sparse/geometry_device.py``: the kernel maps,
the strided coordinate hierarchy and the transpose-conv reuse are built on
the batch's device from nothing but the padded level-0 voxel coordinates, so
the host ships a (cap0, 4) int32 array per batch instead of some 200 MB of
prebuilt plans, and the k=5 stem of a constant-input model comes out as a
(125, cap0) occupancy matrix that never exists as an index plan.

Every plan is bit-identical to the NumPy builder (:mod:`.geometry`) for the
same caps: the same offset order, the same spread-null formula for missing
neighbours and padded rows, the same parent ranks (tested in
``tests/test_torch_geometry_device.py``).

Design (all shapes static, from the caps; each level's ``num`` is a 0-d
tensor on the device, so the build never waits for the device):

* **Keys**: one int64 per voxel, ``((b*2^16 + x+2^14)*2^16 + y+2^14)*2^16
  + z+2^14``.  The host packer keeps coordinates within +-2^14, so a stencil
  offset is a constant key delta that never carries across fields, key
  order is lexicographic (b, x, y, z) order, and ``key >> 16`` names the
  voxel's (b, x, y) column.  Padded rows get a sentinel above every key.
  The JAX package packs the same fields into two int32 keys and searches a
  128-ary pivot tree, the TPU's way to the same answer; here one
  ``torch.searchsorted`` does it.
* **Stencil probing** uses the z-contiguity of lex-sorted voxels: for each
  (dx, dy) column of the stencil one search finds the first row at or after
  (x+dx, y+dy, z-r); every target z+dz (|dz| <= r <= 2) then lies within
  that anchor's next four z values, which a 5-bit mask per row (``_zmask``)
  records, and its row is the anchor's plus the mask's popcount below it.
  A k=5 plan costs 24 searches per row instead of 124, and the level-0 k=3
  plan reuses the stem's anchors (its 8 columns are among the stem's 24).
* **Down edges** sort the children's parent keys (stable) and rank the
  distinct ones with a cumulative sum over first occurrences.
* **Null rows** use the host builder's multiplicative shuffle, whose uint32
  wraparound is computed in int64 and masked to 32 bits.

Every k=3 plan carries its skip plan (``ConvPlan.skip``, built by
``stencil_conv.build_conv_skip`` from the plan and the level's 0-d ``num``,
no host read), and every edge its groups and skip plan (``DownPlan.groups``
and ``.skip``, ``edge_conv.with_edge_layouts`` from the plan and both
levels' 0-d ``num``), the same as ``geometry.geometry_to_device`` builds
for the host plans.

``n_scenes`` switches the stencil probing to the occupancy-grid prober of
:mod:`.grid`.  The overflow flag (a 0-d bool tensor) is set when a coarse
level outgrows its cap or a scene leaves the grid; the plans are then not
valid and the caller builds the batch on the host instead
(``runtime/distill.py``).  The JAX package's window plans are TPU layout
devices that the CUDA kernels do not read: ``windows=True`` raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .edge_conv import with_edge_layouts
from .stencil_conv import build_conv_skip
from .types import (ConvPlan, DownPlan, LevelGeometry, UNetGeometry,
                    flip_permutation, stencil_offsets)

_F = 16                     # bits of a key field
_H = 1 << 14                # coordinate headroom offset (geometry.py)
_SENTINEL = 1 << 20         # padded-row coordinate (geometry._pad_level)
_KEY_PAD = 1 << 62          # padded-row key: above every valid key
_REACH = 4                  # z reach of the anchor mask (covers 2r, r <= 2)
_SHUFFLE = 2654435761       # geometry._spread_nulls' multiplier


def popcount(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each element of an int64 tensor holding values in
    [0, 2^32) (SWAR: torch has no popcount)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def null_rows(shape: Sequence[int], num: torch.Tensor, cap: int
              ) -> torch.Tensor:
    """``geometry._spread_nulls`` on the device: ``num + (i * 2654435761 mod
    2^32) mod max(cap - num, 1)`` for the flat index ``i``, as int32."""
    n = 1
    for s in shape:
        n *= int(s)
    num = num.to(torch.int64)
    pad = torch.clamp(cap - num, min=1)
    flat = torch.arange(n, dtype=torch.int64, device=num.device)
    flat = (flat * _SHUFFLE) & 0xFFFFFFFF
    return (num + flat % pad).to(torch.int32).reshape(tuple(shape))


def keys_of(coords: torch.Tensor, num: torch.Tensor):
    """(cap, 4) int32 lex-sorted coords -> (keys int64 (cap,), valid bool);
    padded rows get the sentinel key."""
    cap = coords.shape[0]
    c = coords.to(torch.int64)
    key = c[:, 0]
    for d in range(1, 4):
        key = (key << _F) + (c[:, d] + _H)
    valid = torch.arange(cap, device=coords.device) < num
    return torch.where(valid, key, torch.full_like(key, _KEY_PAD)), valid


def _shift(a: torch.Tensor, s: int, fill) -> torch.Tensor:
    """``b[i] = a[i + s]`` (s may be negative), ``fill`` beyond the ends."""
    out = torch.full_like(a, fill)
    if s > 0:
        out[:-s] = a[s:]
    else:
        out[-s:] = a[:s]
    return out


def _zmask(key: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    """(cap,) int64: bit d (1.._REACH) set iff the voxel's column holds z + d;
    bit 0 always set.  Rows of a column are consecutive with increasing z,
    so z + d can only be one of rows i+1 .. i+d."""
    cap = key.shape[0]
    col, z = key >> _F, key & 0xFFFF
    rows = torch.arange(cap, device=key.device)
    mask = torch.ones_like(key)
    for s in range(1, _REACH + 1):
        d = _shift(z, s, -9) - z
        hit = ((_shift(col, s, -1) == col) & (d <= _REACH)
               & (rows + s < num))
        mask = mask | torch.where(hit, 1 << d.clamp(0, _REACH),
                                  torch.zeros_like(d))
    return mask


def _own_column(key: torch.Tensor, num: torch.Tensor, dz: int):
    """(exists, row) of the voxel at z + dz in the row's own column: one of
    rows i + sign(dz) * s, s in 1..|dz|."""
    cap = key.shape[0]
    col, z = key >> _F, key & 0xFFFF
    rows = torch.arange(cap, device=key.device)
    ok = torch.zeros(cap, dtype=torch.bool, device=key.device)
    row = torch.zeros_like(rows)
    for s in range(1, abs(dz) + 1):
        step = s if dz > 0 else -s
        nrow = rows + step
        m = ((_shift(col, step, -1) == col) & (_shift(z, step, -9) == z + dz)
             & (nrow >= 0) & (nrow < num))
        ok = ok | m
        row = torch.where(m, nrow.clamp(0, cap - 1), row)
    return ok, row


class Probes:
    """Anchors of one level's (dx, dy) columns (see the module doc)."""

    def __init__(self, key, num, cols: List[Tuple[int, int]], r: int):
        cap = key.shape[0]
        self.cols = cols
        self.key = key
        zm = _zmask(key, num)
        delta = torch.tensor([(dx << 2 * _F) + (dy << _F) - r
                              for dx, dy in cols], dtype=torch.int64,
                             device=key.device)
        self.pos = torch.searchsorted(key, key[None, :] + delta[:, None])
        i = self.pos.clamp(max=cap - 1)
        self.a_key = key[i]
        self.a_zm = zm[i]
        self.a_val = i < num

    def hits(self, dx: int, dy: int, dz: int):
        """(exists, row) of offset (dx, dy, dz) through its column's anchor
        (any anchor reach up to 2 serves: the row comes from the mask)."""
        g = self.cols.index((dx, dy))
        cap = self.key.shape[0]
        target = self.key + ((dx << 2 * _F) + (dy << _F) + dz)
        a_key = self.a_key[g]
        colmatch = self.a_val[g] & ((a_key >> _F) == (target >> _F))
        delta = (target & 0xFFFF) - (a_key & 0xFFFF)
        d = delta.clamp(0, _REACH)
        zm = self.a_zm[g]
        exists = (colmatch & (delta >= 0) & (delta <= _REACH)
                  & (((zm >> d) & 1) == 1))
        below = zm & ((1 << d) - 1)
        row = (self.pos[g] + popcount(below)).clamp(max=cap - 1)
        return exists, row


def _columns(kernel_size: int) -> List[Tuple[int, int]]:
    return sorted({(int(dx), int(dy)) for dx, dy, _ in
                   stencil_offsets(kernel_size).tolist() if (dx, dy) != (0, 0)})


def _flip(kernel_size: int, device) -> torch.Tensor:
    return torch.as_tensor(flip_permutation(stencil_offsets(kernel_size)),
                           device=device)


def build_self_plan_device(coords: torch.Tensor, num: torch.Tensor,
                           kernel_size: int,
                           shared: Optional[Probes] = None) -> ConvPlan:
    """Stride-1 stencil plan of one level: ``fwd[k, r]`` = row of
    ``coord_r + offset_k``, or a spread-null row when absent.  ``shared``:
    the anchors of a wider stencil on the same level (the stem's), whose
    columns contain this one's."""
    cap = coords.shape[0]
    offsets = stencil_offsets(kernel_size)
    r = kernel_size // 2
    key, valid = keys_of(coords, num)
    probes = shared if shared is not None else Probes(
        key, num, _columns(kernel_size), r)
    nulls = null_rows((len(offsets), cap), num, cap)
    rows = torch.arange(cap, dtype=torch.int32, device=coords.device)
    fwd = []
    for k, (dx, dy, dz) in enumerate(offsets.tolist()):
        if dx == 0 and dy == 0:
            if dz == 0:
                fwd.append(torch.where(valid, rows, nulls[k]))
                continue
            exists, row = _own_column(key, num, dz)
        else:
            exists, row = probes.hits(dx, dy, dz)
        fwd.append(torch.where(valid & exists, row.to(torch.int32), nulls[k]))
    return ConvPlan(fwd=torch.stack(fwd),
                    flip_perm=_flip(kernel_size, coords.device))


def build_stem_occupancy_device(coords: torch.Tensor, num: torch.Tensor,
                                kernel_size: int = 5,
                                dtype: torch.dtype = torch.bfloat16):
    """(K, cap) stencil occupancy, all the k=5 stem of a constant-input
    model needs (the occupancy GEMM of ``models/sparse_unet.py``), and the
    level's anchors for :func:`build_self_plan_device` to reuse.  Returns
    ``(occupancy, probes)``."""
    r = kernel_size // 2
    assert r <= 2, kernel_size  # the anchor mask reaches 2r <= 4
    key, valid = keys_of(coords, num)
    probes = Probes(key, num, _columns(kernel_size), r)
    occ = []
    for dx, dy, dz in stencil_offsets(kernel_size).tolist():
        if dx == 0 and dy == 0:
            exists = (torch.ones_like(valid) if dz == 0
                      else _own_column(key, num, dz)[0])
        else:
            exists = probes.hits(dx, dy, dz)[0]
        occ.append(exists & valid)
    return torch.stack(occ).to(dtype), probes


def build_down_edge_device(coords: torch.Tensor, num: torch.Tensor,
                           coarse_cap: int):
    """Parent level and k=2 s=2 plan of one fine level (device form of
    ``geometry.build_down_edge``; parents come out in lex order).  Returns
    ``(LevelGeometry, DownPlan)``; the parent count may exceed
    ``coarse_cap - 1``, which the caller flags as overflow (the plans are
    then not valid, but every index stays inside its array)."""
    cap = coords.shape[0]
    dev = coords.device
    c = coords.to(torch.int64)
    valid = torch.arange(cap, device=dev) < num
    # arithmetic shift = floor division by 2, negatives as numpy does
    pc = torch.cat([c[:, :1], c[:, 1:] >> 1], dim=1)
    pkey, _ = keys_of(pc, num)
    skey, perm = torch.sort(pkey, stable=True)
    svalid = perm < num
    prev = torch.cat([skey.new_full((1,), -1), skey[:-1]])
    is_new = (skey != prev) & svalid
    gid = torch.cumsum(is_new.to(torch.int64), 0) - 1      # parent rank
    n_parent = is_new.sum()

    # parent coordinates, lex order, into the padded coarse level (one dump
    # row past the end takes whatever does not land)
    pcoords = torch.full((coarse_cap + 1, 4), _SENTINEL, dtype=torch.int32,
                         device=dev)
    tgt = torch.where(is_new & (gid < coarse_cap - 1), gid,
                      torch.full_like(gid, coarse_cap))
    pcoords[tgt] = pc[perm].to(torch.int32)
    pcoords = pcoords[:coarse_cap].contiguous()
    pcoords[coarse_cap - 1] = _SENTINEL

    # child -> parent rank, in child order
    child_parent = torch.zeros(cap, dtype=torch.int64, device=dev)
    child_parent[perm] = torch.where(svalid, gid, torch.zeros_like(gid))
    child_parent = torch.where(valid, child_parent.to(torch.int32),
                               null_rows((cap,), n_parent, coarse_cap))
    rem = c[:, 1:] - (pc[:, 1:] << 1)
    off = (rem[:, 0] * 2 + rem[:, 1]) * 2 + rem[:, 2]
    child_offset = torch.where(valid, off, torch.zeros_like(off)).to(
        torch.int32)

    fwd = torch.cat([null_rows((8 * coarse_cap,), num, cap),
                     torch.zeros(1, dtype=torch.int32, device=dev)])
    cpar = child_parent.to(torch.int64)
    flat = torch.where(valid & (cpar >= 0) & (cpar < coarse_cap),
                       off * coarse_cap + cpar,
                       torch.full_like(off, 8 * coarse_cap))
    fwd[flat] = torch.arange(cap, dtype=torch.int32, device=dev)
    fwd = fwd[:8 * coarse_cap].reshape(8, coarse_cap)
    level = LevelGeometry(coords=pcoords, num=n_parent)
    return level, DownPlan(fwd=fwd, child_parent=child_parent,
                           child_offset=child_offset)


def build_geometry_parts(coords: torch.Tensor, num, caps: Sequence[int],
                         stem_kernel: int = 5, num_levels: int = 5,
                         windows: bool = False, stem_occupancy: bool = False,
                         n_scenes: Optional[int] = None,
                         grid_dims0: Optional[Tuple[int, int, int]] = None):
    """The UNet geometry of a padded level-0 batch, built on ``coords``'
    device.  Returns ``(UNetGeometry, overflow)``: each level's ``num`` and
    ``overflow`` are 0-d tensors (:func:`with_host_counts` reads them with
    one wait for the device).

    coords: (caps[0], 4) int32, lex-sorted valid rows first, sentinel-padded
    (``data/batch.py``); num: valid rows (int or 0-d tensor); caps: the
    per-level capacities.  ``stem_occupancy=True`` builds the k=5 stem as a
    (K, cap0) bf16 occupancy matrix only (``geo.stem.fwd`` is None), for a
    constant-input model.  ``n_scenes`` switches the stencil probing to the
    occupancy grid of :mod:`.grid`, sized by ``grid_dims0`` (level-0
    extents, default ``grid.DEFAULT_DIMS0``).  ``overflow`` is set when a
    coarse level outgrows its cap or a scene leaves the grid."""
    if windows:
        raise NotImplementedError(
            "window plans are layout devices of the JAX package's TPU "
            "kernels; the CUDA kernels read the plain plans")
    if coords.shape[0] != caps[0]:
        raise ValueError(f"coords cap {coords.shape[0]} != caps[0] {caps[0]}")
    dev = coords.device
    num = torch.as_tensor(num, dtype=torch.int64, device=dev)
    levels = [LevelGeometry(coords=coords, num=num)]
    downs = []
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for lvl in range(num_levels - 1):
        coarse, plan = build_down_edge_device(
            levels[lvl].coords, levels[lvl].num, int(caps[lvl + 1]))
        overflow = overflow | (coarse.num > int(caps[lvl + 1]) - 1)
        levels.append(coarse)
        downs.append(plan)

    stem_occ = None
    stem = ConvPlan(fwd=None, flip_perm=_flip(stem_kernel, dev))
    if n_scenes is not None:
        from . import grid as gridmod
        dims0 = tuple(grid_dims0) if grid_dims0 else gridmod.DEFAULT_DIMS0
        grids = []
        for lvl, lv in enumerate(levels):
            g = gridmod.build_level_grid(lv.coords, lv.num, n_scenes,
                                         gridmod.dims_for_level(lvl, dims0))
            overflow = overflow | g.overflow
            grids.append(g)
        if stem_occupancy:
            stem_occ, self3_l0 = gridmod.stem_and_self3_from_grid(
                grids[0], num, stem_kernel)
        else:
            stem, self3_l0 = gridmod.stem_plan_and_self3_from_grid(
                grids[0], num, stem_kernel)
        self3 = [self3_l0] + [
            gridmod.self_plan_from_grid(grids[lvl], levels[lvl].num, 3)
            for lvl in range(1, num_levels)]
    else:
        if stem_occupancy:
            stem_occ, l0_probes = build_stem_occupancy_device(
                coords, num, stem_kernel)
        else:
            key0, _ = keys_of(coords, num)
            l0_probes = Probes(key0, num, _columns(stem_kernel),
                               stem_kernel // 2)
            stem = build_self_plan_device(coords, num, stem_kernel,
                                          shared=l0_probes)
        # L0's k=3 plan reuses the stem's anchors: its 8 columns are among
        # the stem's 24, and the row comes from the anchor's mask whatever
        # the anchor's reach
        self3 = [build_self_plan_device(lv.coords, lv.num, 3,
                                        shared=l0_probes if lvl == 0
                                        else None)
                 for lvl, lv in enumerate(levels)]
    # each level's skip plan, built once per batch and shared by every k=3
    # conv on the level, forward and backward
    self3 = [p._replace(skip=build_conv_skip(p.fwd, lv.num))
             for p, lv in zip(self3, levels)]
    # each edge's groups and skip plan, read by the up conv's kernels
    downs = [with_edge_layouts(d, levels[e].num, levels[e + 1].num)
             for e, d in enumerate(downs)]
    geo = UNetGeometry(levels=tuple(levels), stem=stem, self3=tuple(self3),
                       down=tuple(downs), stem_occ=stem_occ)
    return geo, overflow


def with_host_counts(geo: UNetGeometry, overflow: torch.Tensor):
    """Read every level's ``num`` and the overflow flag in one transfer
    (the one wait for the device per built batch).  Returns ``(geo with int
    nums, overflow bool)``: the model sizes its masks and BatchNorm
    statistics from host ints.  The plans, skip plans included, are kept
    as they are."""
    vals = torch.stack([overflow.to(torch.int64)]
                       + [torch.as_tensor(l.num).to(torch.int64)
                          for l in geo.levels]).tolist()
    levels = tuple(LevelGeometry(coords=l.coords, num=int(n))
                   for l, n in zip(geo.levels, vals[1:]))
    return geo._replace(levels=levels), bool(vals[0])


def build_unet_geometry_device(coords: torch.Tensor, num,
                               caps: Sequence[int], stem_kernel: int = 5,
                               num_levels: int = 5) -> UNetGeometry:
    """The full 5-level geometry with index plans only (the stem as a k=5
    plan), level counts read back to the host.  Raises OverflowError when a
    level outgrows its cap, as the NumPy builder does."""
    geo, overflow = build_geometry_parts(coords, num, caps, stem_kernel,
                                         num_levels)
    geo, over = with_host_counts(geo, overflow)
    if over:
        raise OverflowError(
            f"a level outgrew its cap (caps {tuple(caps)}, counts "
            f"{[l.num for l in geo.levels]}); re-bucket with larger caps")
    return geo
