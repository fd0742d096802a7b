"""Host-side geometry-plan builder (NumPy).

Builds the full :class:`UNetGeometry` for a batch of voxelized scenes:
the coordinate hierarchy over strides (1, 2, 4, 8, 16) and every kernel map
the UNet needs, padded to static capacities.  A copy of
``openscene_tpu/sparse/geometry.py`` that builds no window plans (the CUDA
kernels read the plain ``fwd`` maps, so ``wplans`` and ``ewplans`` stay
empty).  As there, the self plans and the down edges take the C++ builder of
:mod:`.native` when it is available (``g++`` present) and NumPy otherwise;
both give the same arrays bit for bit.

This is the functional replacement of MinkowskiEngine's CoordinateManager
(kernel-map construction, strided coordinate generation, transpose-conv
coordinate reuse — see SURVEY.md §2.2).

Capacity policy: ``cap0`` is the geometric bucket covering the stride-1 voxel
count; lower-level caps are bucketed from their own counts (or fixed ratios
of ``cap0``).  Each cap includes one reserved null row (index cap-1) that
stays zero in every feature buffer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import native
from .edge_conv import with_edge_layouts
from .serialize import serialize_levels
from .stencil_conv import build_conv_skip
from .types import (ConvPlan, DownPlan, LevelGeometry, UNetGeometry,
                    flip_permutation, stencil_offsets)

# Packed-key layout: (batch | x | y | z) in 16-bit fields of an int64.
# Key packing is linear in the coordinates, so a stencil offset is a constant
# key delta — neighbor probes become one vectorized add + searchsorted.
_SHIFT = np.int64(1) << np.int64(14)  # headroom so fields never underflow
_FIELD = 16


def pack_coords(coords: np.ndarray) -> np.ndarray:
    """(N, 4) int coords -> int64 keys. Coords must fit in +-2^14 per axis."""
    c = coords.astype(np.int64)
    if c.size and (c[:, 1:].min() < -_SHIFT or c[:, 1:].max() >= _SHIFT):
        raise ValueError(
            f"coordinate outside the +-2^14 packed-key field (got range "
            f"[{c[:, 1:].min()}, {c[:, 1:].max()}]); at 2cm voxels that is a "
            f">327m scene — re-center or coarsen the voxel grid")
    k = c[:, 0]
    for d in range(1, 4):
        k = (k << np.int64(_FIELD)) | (c[:, d] + _SHIFT)
    return k


def level_counts(coords: np.ndarray, num_levels: int = 5) -> List[int]:
    """Unique-voxel count at every stride level, without building any kernel
    maps (cheap capacity calibration)."""
    c = np.asarray(coords).astype(np.int64)
    counts: List[int] = []
    for l in range(num_levels):
        _, idx = np.unique(pack_coords(c), return_index=True)
        counts.append(len(idx))
        if l < num_levels - 1:
            c = c[idx]
            c = np.concatenate([c[:, :1], np.floor_divide(c[:, 1:], 2)],
                               axis=1)
    return counts


def offset_key_delta(offsets: np.ndarray) -> np.ndarray:
    """Key delta of each stencil offset (K,) int64 (batch field untouched).

    Arithmetic (not bitwise) since offsets may be negative; correct as long as
    no coordinate field under/overflows its 16-bit slot (guaranteed by the
    +-2^14 headroom in pack_coords).
    """
    o = offsets.astype(np.int64)
    base = np.int64(1) << np.int64(_FIELD)
    return (o[:, 0] * base + o[:, 1]) * base + o[:, 2]


def _bucket(n: int, growth: float = 1.3, min_bucket: int = 4096) -> int:
    """Smallest geometric-series capacity holding n valid rows + 1 null row,
    rounded to a multiple of 512 (the same ladder as the JAX package, so
    both packages pad a batch to identical shapes)."""
    cap = min_bucket
    while cap - 1 < n:
        cap = int(-(-cap * growth // 256) * 256)
    return int(-(-cap // 512) * 512)


@dataclass(frozen=True)
class GeometryCaps:
    """Static capacity schedule for the 5-level hierarchy.

    ``ratios=None`` (default) buckets every level's actual count
    independently.  Fixed ratios of cap0 give one shape per cap0 bucket.
    """
    cap0: int
    level_ratios: Optional[Tuple[float, ...]] = None
    fixed: Optional[Tuple[int, ...]] = None  # exact per-level caps

    def cap_for(self, level: int, count: int) -> int:
        if self.fixed is not None:
            return self.fixed[level]
        if level == 0:
            return self.cap0
        if self.level_ratios is None:
            return _bucket(count)
        def rup(x):
            return int(-(-x // 512) * 512)
        return rup(self.cap0 * self.level_ratios[level - 1])

    @property
    def caps(self) -> Tuple[int, ...]:
        assert self.level_ratios is not None, "caps undefined without ratios"
        def rup(x):
            return int(-(-x // 512) * 512)
        return (self.cap0,) + tuple(rup(self.cap0 * r) for r in self.level_ratios)

    @staticmethod
    def for_count(n: int, growth: float = 1.3, min_bucket: int = 4096) -> "GeometryCaps":
        return GeometryCaps(cap0=_bucket(n, growth, min_bucket))


def _spread_nulls(shape, num: int, cap: int) -> np.ndarray:
    """Null gather targets spread across the (all-zero) padding region
    [num, cap). Pointing every missing neighbor at one row serializes the
    gather on that hot row; any padded row is an equally valid zero
    source."""
    pad = np.uint32(max(cap - num, 1))
    flat = np.arange(int(np.prod(shape)), dtype=np.uint32)
    flat *= np.uint32(2654435761)  # wrapping multiply: cheap pseudo-shuffle
    return (num + (flat % pad).astype(np.int32)).reshape(shape)


def _lookup(sorted_keys: np.ndarray, order: np.ndarray, probes: np.ndarray,
            null_rows: np.ndarray) -> np.ndarray:
    """Row index of each probe key, or the given per-slot null row when
    absent."""
    pos = np.searchsorted(sorted_keys, probes)
    pos_c = np.minimum(pos, len(sorted_keys) - 1)
    found = (len(sorted_keys) > 0) & (sorted_keys[pos_c] == probes)
    return np.where(found, order[pos_c], null_rows).astype(np.int32)


def _pad_level(coords: np.ndarray, cap: int) -> LevelGeometry:
    n = coords.shape[0]
    if n > cap - 1:
        raise OverflowError(
            f"level needs {n} rows but cap={cap} (one row reserved); "
            "re-bucket with a larger cap0")
    out = np.full((cap, 4), 2 ** 20, dtype=np.int32)  # sentinel coords
    out[:n] = coords.astype(np.int32)
    return LevelGeometry(coords=out, num=np.int32(n))


def build_self_plan(level: LevelGeometry, kernel_size: int,
                    sorted_keys: Optional[np.ndarray] = None,
                    order: Optional[np.ndarray] = None) -> ConvPlan:
    """Stride-1 stencil plan: fwd[k, r] = row of (coord_r + offset_k)."""
    cap = level.cap
    n = int(level.num)
    offsets = stencil_offsets(kernel_size)
    K = len(offsets)
    fwd = _spread_nulls((K, cap), n, cap)
    if native.available():
        native.build_self_plan_native(level.coords, n, cap, offsets, fwd)
        return ConvPlan(fwd=fwd, flip_perm=flip_permutation(offsets))

    valid = level.coords[:n]
    keys = pack_coords(valid)
    if sorted_keys is None:
        order = np.argsort(keys).astype(np.int32)
        sorted_keys = keys[order]
    deltas = offset_key_delta(offsets)
    center = K // 2  # odd stencils: center offset is the identity map
    for k in range(K):
        if k == center:
            fwd[k, :n] = np.arange(n, dtype=np.int32)
            continue
        fwd[k, :n] = _lookup(sorted_keys, order, keys + deltas[k], fwd[k, :n])
    return ConvPlan(fwd=fwd, flip_perm=flip_permutation(offsets))


def build_down_edge(fine: LevelGeometry, coarse_cap: Optional[int] = None,
                    cap_fn=None) -> Tuple[LevelGeometry, DownPlan]:
    """Parent level (coords = unique floor(child/2)) + the k=2 s=2 plan.

    No probing needed: each child belongs to exactly one (parent, offset), so
    the fwd map is a host-side scatter of child rows.  ``cap_fn(count)`` may
    be passed instead of a fixed cap to size the level after counting.
    """
    n = int(fine.num)
    if native.available():
        return _build_down_edge_native(fine, n, coarse_cap, cap_fn)
    child = fine.coords[:n].astype(np.int64)
    parent_coords = child.copy()
    parent_coords[:, 1:] = np.floor_divide(child[:, 1:], 2)
    pkeys = pack_coords(parent_coords)
    uniq_keys, first_idx, inverse = np.unique(
        pkeys, return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    if coarse_cap is None:
        coarse_cap = cap_fn(len(first_idx))
    coarse = _pad_level(parent_coords[first_idx], coarse_cap)
    n_parent = len(first_idx)

    # offset id in x-major order over (0,1)^3: (dx*2 + dy)*2 + dz
    rem = (child[:, 1:] - parent_coords[:, 1:] * 2).astype(np.int32)
    off_id = (rem[:, 0] * 2 + rem[:, 1]) * 2 + rem[:, 2]

    child_parent = _spread_nulls((fine.cap,), n_parent, coarse_cap)
    child_parent[:n] = inverse.astype(np.int32)
    child_offset = np.zeros(fine.cap, dtype=np.int32)
    child_offset[:n] = off_id

    fwd = _spread_nulls((8, coarse_cap), n, fine.cap)
    fwd[off_id, inverse] = np.arange(n, dtype=np.int32)
    return coarse, DownPlan(fwd=fwd, child_parent=child_parent,
                            child_offset=child_offset)


def _build_down_edge_native(fine: LevelGeometry, n: int,
                            coarse_cap: Optional[int], cap_fn
                            ) -> Tuple[LevelGeometry, DownPlan]:
    """:func:`build_down_edge` by the C++ builder.  It numbers the parents in
    their order of first appearance; they are renumbered in lex order, the
    order of the NumPy builder, so the coarse level stays sorted."""
    # without a fixed cap, fine.cap + 1 rows hold any parent count (n_parent
    # <= n <= fine.cap - 1), so only a fixed cap can overflow
    cap_guess = coarse_cap if coarse_cap is not None else fine.cap + 1
    pc, cp, off_id = native.build_down_edge_native(fine.coords, n, cap_guess)
    n_parent = len(pc)
    if coarse_cap is None:
        coarse_cap = cap_fn(n_parent)
    order = np.lexsort((pc[:, 3], pc[:, 2], pc[:, 1], pc[:, 0]))
    inv = np.empty_like(order)
    inv[order] = np.arange(n_parent)
    coarse = _pad_level(pc[order], coarse_cap)
    child_parent = _spread_nulls((fine.cap,), n_parent, coarse_cap)
    child_parent[:n] = inv[cp].astype(np.int32)
    child_offset = np.zeros(fine.cap, dtype=np.int32)
    child_offset[:n] = off_id
    fwd = _spread_nulls((8, coarse_cap), n, fine.cap)
    fwd[child_offset[:n], child_parent[:n]] = np.arange(n, dtype=np.int32)
    return coarse, DownPlan(fwd=fwd, child_parent=child_parent,
                            child_offset=child_offset)


def build_unet_geometry(coords: np.ndarray, caps: Optional[GeometryCaps] = None,
                        stem_kernel: int = 5, num_levels: int = 5
                        ) -> UNetGeometry:
    """Full geometry for a 4-down/4-up UNet from batched voxel coords.

    coords: (N, 4) int — (batch, x, y, z) at stride 1 (deduplicated),
    lex-sorted by (batch, x, y, z) as data/batch.py delivers them (any order
    gives a correct plan; sorted rows keep the gathers local).
    """
    coords = np.asarray(coords)
    if caps is None:
        caps = GeometryCaps.for_count(coords.shape[0])

    levels: List[LevelGeometry] = [_pad_level(coords, caps.cap_for(0, coords.shape[0]))]
    downs: List[DownPlan] = []
    for l in range(num_levels - 1):
        coarse, plan = build_down_edge(
            levels[l], cap_fn=lambda n, lvl=l + 1: caps.cap_for(lvl, n))
        levels.append(coarse)
        downs.append(plan)

    stem = build_self_plan(levels[0], stem_kernel)
    self3 = tuple(build_self_plan(lv, 3) for lv in levels)
    return UNetGeometry(levels=tuple(levels), stem=stem, self3=self3,
                        down=tuple(downs))


def _check_rows(fwd: np.ndarray, rows_in: int, what: str) -> None:
    """Every gather index must address a row of its source buffer: the CUDA
    kernels read through these indices unchecked."""
    if fwd.size and (fwd.min() < 0 or fwd.max() >= rows_in):
        raise ValueError(f"{what}: gather index outside [0, {rows_in})")


def geometry_to_device(geo: UNetGeometry, device,
                       patch: Optional[int] = None) -> UNetGeometry:
    """The same geometry with every plan array as an int32 tensor on
    ``device``; each level's ``num`` stays a host int (it sizes masks and
    BatchNorm statistics without a device round trip).  Each k=3 plan gets
    its skip plan (``stencil_conv.build_conv_skip``) and each edge its
    groups and skip plan (``edge_conv.with_edge_layouts``), built on
    ``device``, bit-identical to the ones
    ``geometry_device.build_geometry_parts`` builds for the same plans.
    ``patch``: the patch size of a serialized model (Point Transformer
    V3), whose orders and patch layouts (``serialize.serialize_levels``,
    for the scenes the host coordinates hold) go into ``serial``; None
    (the UNets) builds none.  Raises if a gather index lies outside its
    source level."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    def plan(p, cap, what, num=None):
        if p is None:
            return None
        _check_rows(np.asarray(p.fwd), cap, what)
        fwd = t(p.fwd)
        skip = None if num is None else build_conv_skip(fwd, int(num))
        return ConvPlan(fwd=fwd, flip_perm=t(p.flip_perm), skip=skip)

    caps = [l.cap for l in geo.levels]
    for e, d in enumerate(geo.down):
        _check_rows(np.asarray(d.fwd), caps[e], f"down[{e}].fwd")
        _check_rows(np.asarray(d.child_parent), caps[e + 1],
                    f"down[{e}].child_parent")

    levels = tuple(LevelGeometry(coords=t(l.coords), num=int(l.num))
                   for l in geo.levels)
    down = tuple(with_edge_layouts(
        DownPlan(fwd=t(d.fwd), child_parent=t(d.child_parent),
                 child_offset=t(d.child_offset)),
        int(geo.levels[e].num), int(geo.levels[e + 1].num))
        for e, d in enumerate(geo.down))
    serial = ()
    if patch is not None:
        n0 = int(geo.levels[0].num)
        scene = np.asarray(geo.levels[0].coords)[:n0, 0]
        serial = serialize_levels(levels, down, patch,
                                  int(scene.max()) + 1 if n0 else 1)
    return UNetGeometry(
        levels=levels, stem=plan(geo.stem, caps[0], "stem.fwd"),
        self3=tuple(plan(p, caps[l], f"self3[{l}].fwd", geo.levels[l].num)
                    for l, p in enumerate(geo.self3)),
        down=down, serial=serial)
