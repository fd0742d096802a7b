"""The val loader's voxelization, worked out again from the seed.

A frozen copy of the rule that the reference repository's
``dataset/voxelizer.py`` and ``dataset/feature_loader.py`` (val split,
``eval_all``) apply, and that the evaluator's ``test_repeats`` protocol
seeds (``run/evaluate.py``): repeat 0 voxelizes scene ``i`` with the
generator ``default_rng((0, i))``, repeat ``r > 0`` with ``default_rng((s_r,
i))`` where ``s_1, s_2, ...`` are ``integers(10000)`` draws of
``default_rng(manual_seed)``.  Per scene: three rotation angles (x and y in
+-pi/64, z in +-pi), the three axis rotations shuffled and multiplied, a
scale in [0.9, 1.1] over the voxel size, ``floor`` of the rotated and
scaled points, shifted to a zero minimum; the first point of each voxel
represents it.  With one fused-feature file per scene no draw picks a file.

Written in NumPy with the same float64 expressions, so the floors land on
the same voxels; the dedup is by coordinates (the reference's 64-bit FNV
key of the same coordinates, and ``np.unique``'s first index, pick the same
point).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

ROTATION_BOUND = ((-np.pi / 64, np.pi / 64), (-np.pi / 64, np.pi / 64),
                  (-np.pi, np.pi))
SCALE_BOUND = (0.9, 1.1)


def repeat_seeds(manual_seed: int, repeats: int) -> List[int]:
    rng = np.random.default_rng(manual_seed)
    return [0] + [int(rng.integers(10000)) for _ in range(repeats - 1)]


def _rotation(axis_ind: int, theta: float) -> np.ndarray:
    axis = np.zeros(3)
    axis[axis_ind] = 1.0
    kx, ky, kz = axis
    K = np.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


class Voxels(NamedTuple):
    coords: np.ndarray       # (V, 3) int64
    rep: np.ndarray          # (V,) the point that represents each voxel
    inverse: np.ndarray      # (P,) voxel of each point


def voxelize(points: np.ndarray, voxel_size: float, seed: int,
             index: int) -> Voxels:
    rng = np.random.default_rng((seed, int(index)))
    mats = [_rotation(a, float(rng.uniform(*b)))
            for a, b in enumerate(ROTATION_BOUND)]
    rng.shuffle(mats)
    m_r = np.eye(4)
    m_r[:3, :3] = mats[0] @ mats[1] @ mats[2]
    m_v = np.eye(4)
    np.fill_diagonal(m_v[:3, :3],
                     1.0 / voxel_size * float(rng.uniform(*SCALE_BOUND)))
    rigid = m_r @ m_v
    homo = np.hstack((points, np.ones((points.shape[0], 1),
                                      dtype=points.dtype)))
    c = np.floor(homo @ rigid.T[:, :3])
    c = np.floor(c - c.min(0)).astype(np.int64)
    _, rep, inverse = np.unique(c, axis=0, return_index=True,
                                return_inverse=True)
    return Voxels(c[rep], rep, inverse.reshape(-1))
