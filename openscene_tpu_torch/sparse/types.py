"""Core data structures of the sparse-conv engine.

Replaces MinkowskiEngine's CoordinateManager + kernel maps
(the reference's L0 dependency, see SURVEY.md §2.2) with a functional,
static-shape design:

* A :class:`LevelGeometry` per tensor stride holds the (padded) voxel
  coordinates of that level.  Row ``cap-1`` of every per-level feature buffer
  is a reserved **null row** that is always zero; every gather index that has
  no source points at it, so missing stencil neighbors contribute exact zeros
  without any masking in the hot loop.

* A :class:`ConvPlan` holds, for each kernel offset ``k``, the input row
  feeding each output row (``fwd[k, r]``).  Because a fixed offset maps each
  output to at most one input (and vice versa), every per-offset map is a
  partial bijection; its transpose is the map of the mirrored offset
  (``flip_perm``).  Convolutions therefore never scatter — forward and
  backward are both gather → batched GEMM → sum, the tensor-core-friendly
  formulation (vs. MinkowskiEngine's gather-GEMM-scatter-add).

* A :class:`DownPlan` additionally stores the child->parent assignment
  (each child voxel feeds exactly one (parent, offset) pair for the
  kernel_size=2, stride=2 convs of the UNet), so the transpose (upsampling)
  convolution is a dense GEMM followed by ONE gather.

Coordinate convention (matches MinkowskiEngine, models/mink_unet.py usage):
coordinates at tensor stride ``s`` are stored in units of ``s`` (i.e. already
divided by the stride); a stride-2 downsample maps ``c -> floor(c / 2)``.
Kernel offsets for odd kernel sizes are centered (e.g. -1..1 for k=3); for
even kernel sizes they span ``0..k-1`` (ME's convention for the k=2 s=2
down/up convs).
"""

from __future__ import annotations

import itertools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

NULL = -1  # placeholder in docs; actual null index is cap-1 per level


class LevelGeometry(NamedTuple):
    """Voxel set of one tensor stride. All arrays padded to static ``cap``.

    coords: (cap, 4) int32 — (batch, x, y, z) in units of this level's stride;
            rows >= num hold a sentinel; row cap-1 is the reserved null row.
    num:    () int32 — number of valid voxels (num <= cap-1).
    """
    coords: np.ndarray
    num: np.ndarray

    @property
    def cap(self) -> int:
        return self.coords.shape[0]


class ConvSkip(NamedTuple):
    """Which (row, offset) pairs of a :class:`ConvPlan` hold a neighbour: the
    layout the CUDA stencil kernels read to skip the missing ones (built by
    ``sparse/stencil_conv.py:build_conv_skip`` from ``fwd`` and ``num``
    alone; the part the TPU kernels' window plans played).

    nbr_mask:   (cap,) int32 — bit k set iff ``fwd[k, r] < num`` (and
                ``r < num``), or where the plan's own existence bits say
                so (the spatial shards' plans, ``parallel/spatial.py``);
                padded rows 0.  K <= 31.
    order:      (cap,) int32 — the rows stably sorted by ``nbr_mask``.
    tile_mask:  (ceil(cap / TILE_ROWS),) int32 — OR of ``nbr_mask`` over each
                tile of ``TILE_ROWS`` consecutive entries of ``order``.
    pair_rows:  (K, cap) int32 — for each offset, the rows whose neighbour
                exists, ascending; padded with ``cap - 1`` (a zero row).
    pair_count: (K,) int32 — the number of such rows per offset.
    """
    nbr_mask: np.ndarray
    order: np.ndarray
    tile_mask: np.ndarray
    pair_rows: np.ndarray
    pair_count: np.ndarray


class ConvPlan(NamedTuple):
    """Stride-1 stencil conv plan on one level (self edge).

    fwd:       (K, cap) int32 — input row for (offset k, output row r);
               missing neighbors and padded rows point at the null row.
    flip_perm: (K,) int32 — index of the mirrored offset (-delta), used by the
               backward pass (transpose of a partial bijection).
    skip:      optional :class:`ConvSkip` of ``fwd``, set on the device
               plans of the k=3 convs (``geometry_to_device``,
               ``build_geometry_parts``); None runs the kernels densely.
    """
    fwd: np.ndarray
    flip_perm: np.ndarray
    skip: Optional[ConvSkip] = None

    @property
    def K(self) -> int:
        return self.fwd.shape[0]


class EdgeGroups(NamedTuple):
    """The valid child rows of a :class:`DownPlan` grouped by offset: the
    layout the CUDA up-conv kernels read (``csrc/up_conv_fwd.cu`` walks its
    tiles, the up-conv ``dW`` reduces each offset over its segment; built by
    ``sparse/edge_conv.py:build_edge_groups`` from ``child_offset`` and the
    child level's ``num`` alone).  Padded children are in no segment.

    rows:   (tiles * EDGE_TILE,) int32 — the valid children stably sorted by
            offset, ascending within each offset; each offset's segment
            starts on a multiple of ``EDGE_TILE`` (64) and is padded with
            -1.  ``tiles = ceil(child_cap / EDGE_TILE) + 8``, static.
    tile_k: (tiles,) int32 — the offset of each ``EDGE_TILE``-row tile of
            ``rows``; -1 past the last segment.
    count:  (8,) int32 — the valid children of each offset (segment k
            starts at ``EDGE_TILE * sum_{j<k} ceil(count[j] / EDGE_TILE)``).
    """
    rows: np.ndarray
    tile_k: np.ndarray
    count: np.ndarray


class EdgeSkip(NamedTuple):
    """Which children each parent of a :class:`DownPlan` holds: the layout
    the up-conv backward's ``dx`` (over the parents, through
    ``csrc/gather_gemm_fwd.cu``) reads to skip the missing ones; the first
    three fields of a :class:`ConvSkip`, with the child level's ``num`` for
    the neighbour bit and the parent level's for the rows (built by
    ``sparse/edge_conv.py:build_edge_skip``).

    nbr_mask:  (parent_cap,) int32 — bit k set iff ``fwd[k, p]`` is a valid
               child (and ``p`` a valid parent); padded parents 0.
    order:     (parent_cap,) int32 — the parents stably sorted by
               ``nbr_mask``.
    tile_mask: (ceil(parent_cap / TILE_ROWS),) int32 — OR of ``nbr_mask``
               over each tile of ``TILE_ROWS`` consecutive entries of
               ``order``.
    """
    nbr_mask: np.ndarray
    order: np.ndarray
    tile_mask: np.ndarray


class DownPlan(NamedTuple):
    """kernel=2, stride=2 down-conv edge between two levels.

    fwd:          (8, parent_cap) int32 — child row for (offset, parent row).
    child_parent: (child_cap,) int32 — parent row of each child (null-padded).
    child_offset: (child_cap,) int32 — offset id (0..7) of each child within
                  its parent; 0 for padded rows.
    groups:       optional :class:`EdgeGroups` of the children, and
    skip:         optional :class:`EdgeSkip` of the parents: set on the
                  device plans (``geometry_to_device``,
                  ``build_geometry_parts``), where the up conv's kernels
                  need them; None from the NumPy builder.
    """
    fwd: np.ndarray
    child_parent: np.ndarray
    child_offset: np.ndarray
    groups: Optional[EdgeGroups] = None
    skip: Optional[EdgeSkip] = None


class UNetGeometry(NamedTuple):
    """Full geometry plan for a 4-down/4-up sparse UNet forward pass.

    levels:  LevelGeometry per stride (1, 2, 4, 8, 16).
    stem:    k=5 ConvPlan on level 0.
    self3:   k=3 ConvPlan per level (residual blocks run at every level).
    down:    DownPlan per edge (level i -> i+1); also serves the transposed
             up-convolutions on the decoder path.
    wplans:  per-level window plans of the JAX package's TPU kernels; the
             port builds none and leaves this empty.
    """
    levels: Tuple[LevelGeometry, ...]
    stem: ConvPlan
    self3: Tuple[ConvPlan, ...]
    down: Tuple[DownPlan, ...]
    wplans: Tuple = ()
    stem_occ: Optional[object] = None  # (K, cap0) occupancy (compute dtype);
    # set by the device builder for constant-input models so the k=5 stem
    # never materializes its (K, cap0) int32 index plan
    ewplans: Tuple = ()  # per-down-edge window plans (empty in the port)


def stencil_offsets(kernel_size: int, dimension: int = 3) -> np.ndarray:
    """Kernel offset list (K, dim) in canonical x-major order.

    Odd kernels are centered (-(k-1)/2 .. +(k-1)/2); even kernels span
    0 .. k-1 (MinkowskiEngine's convention for its k=2 s=2 convs).
    """
    if kernel_size % 2 == 1:
        r = kernel_size // 2
        axis = range(-r, r + 1)
    else:
        axis = range(kernel_size)
    return np.array(list(itertools.product(*[axis] * dimension)), dtype=np.int32)


def flip_permutation(offsets: np.ndarray) -> np.ndarray:
    """For centered stencils: perm[k] = index of -offsets[k]."""
    key = {tuple(o): i for i, o in enumerate(offsets.tolist())}
    perm = np.array([key[tuple((-o).tolist())] for o in offsets], dtype=np.int32)
    return perm
