"""Per-rank batches of a data-parallel run.

Counterpart of ``openscene_tpu/data/sharded.py``.  Every rank draws the
same permutation of the train split from the shared seed, and rank ``d``
takes scenes ``[d * per_rank, (d + 1) * per_rank)`` of each global batch of
``per_rank * n_ranks`` scenes: the JAX trainer's split of a batch over its
devices (openscene_tpu/runtime/distill.py:469,494).

The JAX package's ``stack_batches``, ``_grow_raw`` and the
``assemble_sharded_*`` functions have no counterpart here.  They stack the
devices' batches on a leading axis and pad them to one shared set of caps,
because one compiled program runs every device.  A rank of the port is a
process of its own that holds one batch, assembled on the rank's own
running caps, so nothing is stacked or padded across ranks.  The two cap
helpers below are the JAX package's, for callers that do calibrate one cap
family for several batches.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..sparse.geometry import GeometryCaps, _bucket


def rank_indices(order: np.ndarray, batch_index: int, per_rank: int,
                 n_ranks: int, rank: int) -> np.ndarray:
    """Rank ``rank``'s scene indices of global batch ``batch_index`` of the
    permutation ``order``."""
    start = (batch_index * n_ranks + rank) * per_rank
    return order[start:start + per_rank]


def fixed_caps_from_counts(counts_per_level: Sequence[int],
                           margin: float = 0.06,
                           extra: int = 32) -> GeometryCaps:
    """Bucketed per-level caps with headroom over observed counts.

    The margin covers count drift the calibration pass cannot see — the
    per-batch random global coordinate shift changes coarse-level voxel
    counts (floor(c/2) grouping depends on shift parity), typically by a
    few percent."""
    fixed = tuple(_bucket(int(n * (1.0 + margin)) + extra)
                  for n in counts_per_level)
    return GeometryCaps(cap0=fixed[0], fixed=fixed)


def merge_caps(a: GeometryCaps, b: GeometryCaps) -> GeometryCaps:
    """Elementwise max of two fixed-cap schedules (caps only ever grow)."""
    fixed = tuple(max(x, y) for x, y in zip(a.fixed, b.fixed))
    return GeometryCaps(cap0=fixed[0], fixed=fixed)
