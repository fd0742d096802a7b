"""Occupancy-grid stencil probing for the on-device geometry builder.

Counterpart of ``openscene_tpu/sparse/grid.py``.  Instead of searching the
sorted keys, each level scatters one bit per voxel into a dense bitmask
(z packed 32 to a word, per-scene bounding-box offsets so the scenes of a
batch share one shape) and takes one exclusive cumulative sum of the words'
popcounts.  The grid's (b, x, y, z) traversal order is the batch's lex sort
order (``data/batch.py``), so a set bit's rank is its voxel's row:

    row = rank[word] + popcount(word & (bits below z))

Layout: ``words`` is (B * nx_p * ny_p, nzw + 1) with a zero guard word at
the end of every (b, x, y) column, padded by ``PAD`` on each side of x, y
and z so |dx|, |dy|, |dz| <= 2 probes never leave the array.  A probe of
column (x+dx, y+dy) reads the column's word at ``(z - r) >> 5`` and the one
after it (the guard word when z is near the top): all 2r+1 targets z+dz lie
in those two words.  The JAX package packs the same words and ranks into a
(R, 128) row table for the TPU's aligned 128-lane gathers; here three plain
gathers per column serve.

Exactness: the plans are bit-identical to the NumPy builder's (same offset
order, same spread-null formula; ``tests/test_torch_geometry_device.py``).
A scene whose extent exceeds the grid sets ``overflow`` and the caller
builds that batch on the host (``runtime/geometry_route.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .geometry_device import flip_perm_on, null_rows, popcount
from .types import ConvPlan

PAD = 2  # grid border so |dx|, |dy|, |dz| <= 2 probes never leave the array

# Default per-level grid extents (voxels): level 0 sized for ~15 m ScanNet
# scans at 2 cm (768 * 0.02 = 15.4 m) and 5.1 m ceilings; halved per level.
DEFAULT_DIMS0 = (768, 768, 256)


def dims_for_level(level: int,
                   dims0: Tuple[int, int, int] = DEFAULT_DIMS0
                   ) -> Tuple[int, int, int]:
    """Grid extents of a stride level.

    A coarse extent is floor(max/2^l) - floor(min/2^l) + 1, which can exceed
    dims0 >> l (e.g. min=1, max=dims0 at level 1): the exact bound is
    ceil((dims0-1)/2^l) + 1, so a scene that fits level 0 never overflows a
    coarser level."""
    if level == 0:
        return tuple(dims0)
    q = 1 << level
    d = tuple(-(-(v - 1) // q) + 1 for v in dims0)
    return (max(d[0], 8), max(d[1], 8), max(d[2], 32))


class LevelGrid(NamedTuple):
    """Occupancy bits and ranks of one level, plus each row's grid place."""
    words: torch.Tensor    # (ncol * (nzw + 1),) int64: 32 z bits per word
    rank: torch.Tensor     # same shape: set bits in all earlier words
    col: torch.Tensor      # (cap,) int64 (b * nx_p + xs) * ny_p + ys
    zs: torch.Tensor       # (cap,) int64 bbox-shifted z (>= PAD when valid)
    valid: torch.Tensor    # (cap,) bool
    overflow: torch.Tensor  # () bool: a valid voxel lies outside the grid
    ny_p: int              # y extent with padding
    nzw: int               # z words per column (one guard word follows)


def build_level_grid(coords: torch.Tensor, num, n_scenes: int,
                     dims: Tuple[int, int, int]) -> LevelGrid:
    """Scatter one level's voxels into its bitmask (module doc)."""
    nx, ny, nz = dims
    nzw = (nz + 2 * PAD + 31) // 32
    nx_p, ny_p = nx + 2 * PAD, ny + 2 * PAD
    B = n_scenes
    dev = coords.device
    c = coords.to(torch.int64)
    cap = c.shape[0]
    valid = torch.arange(cap, device=dev) < num
    b = c[:, 0]

    # per-scene bounding-box minima (rows of no scene go to a dump row)
    in_batch = valid & (b >= 0) & (b < B)
    slot = torch.where(in_batch, b, torch.full_like(b, B))
    lo = torch.full((B + 1, 3), 1 << 40, dtype=torch.int64, device=dev)
    lo = lo.scatter_reduce(0, slot[:, None].expand(cap, 3), c[:, 1:],
                           reduce="amin")
    shift = lo[slot]
    s = torch.where(in_batch[:, None], c[:, 1:] - shift + PAD,
                    torch.full_like(c[:, 1:], PAD))
    xs, ys, zs = s[:, 0], s[:, 1], s[:, 2]
    over = valid & ~(in_batch & (xs < nx + PAD) & (ys < ny + PAD)
                     & (zs < nz + PAD))
    inside = valid & ~over

    ncol = B * nx_p * ny_p
    nwords = ncol * (nzw + 1)
    col = (torch.where(inside, b, torch.zeros_like(b)) * nx_p + xs) * ny_p + ys
    flat = torch.where(inside, col * (nzw + 1) + (zs >> 5),
                       torch.full_like(col, nwords))
    # voxels are unique, so every bit is added once (add == or); int64 keeps
    # bit 31 clear of the sign
    words = torch.zeros(nwords + 1, dtype=torch.int64, device=dev)
    words.scatter_add_(0, flat, 1 << (zs & 31))
    words = words[:nwords]
    pc = popcount(words)
    rank = torch.cumsum(pc, 0) - pc
    return LevelGrid(words=words, rank=rank,
                     col=torch.where(inside, col, torch.zeros_like(col)),
                     zs=torch.where(inside, zs, torch.full_like(zs, PAD)),
                     valid=valid, overflow=over.any(), ny_p=ny_p, nzw=nzw)


def _column_hits(g: LevelGrid, dx: int, dy: int, r: int, want_rows: bool):
    """{dz: (exists, row or None)} for dz in [-r, r] in column (dx, dy):
    two word gathers (and one rank gather) for the whole column."""
    last = g.words.shape[0] - 2
    w0 = (g.zs - r) >> 5
    i = ((g.col + dx * g.ny_p + dy) * (g.nzw + 1) + w0).clamp(0, last)
    lo, hi = g.words[i], g.words[i + 1]
    if want_rows:
        rank_lo = g.rank[i]
        rank_hi = rank_lo + popcount(lo)
    out = {}
    for dz in range(-r, r + 1):
        zq = g.zs + dz
        in_lo = (zq >> 5) == w0
        bit = zq & 31
        word = torch.where(in_lo, lo, hi)
        exists = ((word >> bit) & 1) == 1
        row = None
        if want_rows:
            row = (torch.where(in_lo, rank_lo, rank_hi)
                   + popcount(word & ((1 << bit) - 1)))
        out[dz] = (exists, row)
    return out


def _grid_plans(g: LevelGrid, num, r_big: int, big: str, want_k3: bool):
    """One pass over the dx-planes of a (2 r_big + 1)^3 stencil.

    ``big``: "plan" (index plan of the wide stencil), "occ" (its occupancy,
    bf16) or "none".  ``want_k3``: also the k=3 plan, whose offsets are the
    wide stencil's interior.  Returns (wide result or None, k=3 plan or
    None)."""
    cap = g.col.shape[0]
    dev = g.col.device
    rows = torch.arange(cap, dtype=torch.int32, device=dev)
    K = (2 * r_big + 1) ** 3
    nulls = null_rows((K, cap), num, cap) if big == "plan" else None
    nulls3 = null_rows((27, cap), num, cap) if want_k3 else None
    wide, small = [None] * K, [None] * 27

    def plan_row(exists, row, null):
        return torch.where(g.valid & exists,
                           row.clamp(max=cap - 1).to(torch.int32), null)

    for dx in range(-r_big, r_big + 1):
        for dy in range(-r_big, r_big + 1):
            inner = abs(dx) <= 1 and abs(dy) <= 1 and want_k3
            hits = _column_hits(g, dx, dy, r_big,
                                want_rows=big == "plan" or inner)
            for dz in range(-r_big, r_big + 1):
                exists, row = hits[dz]
                centre = dx == 0 and dy == 0 and dz == 0
                k = ((dx + r_big) * (2 * r_big + 1) + dy + r_big) \
                    * (2 * r_big + 1) + dz + r_big
                if big == "plan":
                    wide[k] = (torch.where(g.valid, rows, nulls[k]) if centre
                               else plan_row(exists, row, nulls[k]))
                elif big == "occ":
                    wide[k] = g.valid if centre else g.valid & exists
                if inner and abs(dz) <= 1:
                    k3 = ((dx + 1) * 3 + dy + 1) * 3 + dz + 1
                    small[k3] = (torch.where(g.valid, rows, nulls3[k3])
                                 if centre else plan_row(exists, row,
                                                         nulls3[k3]))
    out_wide = None
    if big == "plan":
        out_wide = ConvPlan(fwd=torch.stack(wide),
                            flip_perm=flip_perm_on(2 * r_big + 1, dev))
    elif big == "occ":
        out_wide = torch.stack(wide).to(torch.bfloat16)
    out_small = None
    if want_k3:
        out_small = ConvPlan(fwd=torch.stack(small),
                             flip_perm=flip_perm_on(3, dev))
    return out_wide, out_small


def self_plan_from_grid(g: LevelGrid, num, kernel_size: int) -> ConvPlan:
    """Stride-1 stencil plan from the grid; bit-identical to
    ``geometry.build_self_plan``."""
    r = kernel_size // 2
    assert r <= PAD, kernel_size
    if kernel_size == 3:
        return _grid_plans(g, num, 1, "none", True)[1]
    return _grid_plans(g, num, r, "plan", False)[0]


def stem_and_self3_from_grid(g: LevelGrid, num, stem_kernel: int = 5
                             ) -> Tuple[torch.Tensor, ConvPlan]:
    """(stem occupancy (K5, cap) bf16, k=3 plan) in one pass: the k=3
    offsets are the interior of the stem's dx-planes."""
    assert stem_kernel == 5, stem_kernel
    return _grid_plans(g, num, 2, "occ", True)


def stem_plan_and_self3_from_grid(g: LevelGrid, num, stem_kernel: int = 5
                                  ) -> Tuple[ConvPlan, ConvPlan]:
    """(k=5 plan, k=3 plan) in one pass, for a colour-input stem."""
    assert stem_kernel == 5, stem_kernel
    return _grid_plans(g, num, 2, "plan", True)
