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


class ConvPlan(NamedTuple):
    """Stride-1 stencil conv plan on one level (self edge).

    fwd:       (K, cap) int32 — input row for (offset k, output row r);
               missing neighbors and padded rows point at the null row.
    flip_perm: (K,) int32 — index of the mirrored offset (-delta), used by the
               backward pass (transpose of a partial bijection).
    """
    fwd: np.ndarray
    flip_perm: np.ndarray

    @property
    def K(self) -> int:
        return self.fwd.shape[0]


class DownPlan(NamedTuple):
    """kernel=2, stride=2 down-conv edge between two levels.

    fwd:          (8, parent_cap) int32 — child row for (offset, parent row).
    child_parent: (child_cap,) int32 — parent row of each child (null-padded).
    child_offset: (child_cap,) int32 — offset id (0..7) of each child within
                  its parent; 0 for padded rows.
    """
    fwd: np.ndarray
    child_parent: np.ndarray
    child_offset: np.ndarray


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
