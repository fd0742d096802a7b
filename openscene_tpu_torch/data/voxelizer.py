"""Point-cloud -> voxel-grid transform with train-time augmentation.

Same semantics as the reference ``dataset/voxelizer.py:15-140``:

* optional random per-axis rotation composed in a random axis order,
* random isotropic scale in ``scale_augmentation_bound`` times 1/voxel_size,
* floor to integer grid, translate so min coordinate is 0,
* first-point-wins dedup via :func:`sparse_quantize`,
* optional clip box with translation augmentation,
* normals (feat dims 3:6 when >6 dims) rotated by the same rotation.

Note: like the reference, rotation/scale augmentation applies whenever
``use_augmentation=True`` regardless of eval/train — this is the voxelization
randomness the eval protocol's ``test_repeats`` averages over.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .quantize import sparse_quantize


def _axis_angle_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rotation matrix about ``axis`` by ``theta`` (Rodrigues)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    kx, ky, kz = axis
    K = np.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


class Voxelizer:
    def __init__(
        self,
        voxel_size: float = 1.0,
        clip_bound=None,
        use_augmentation: bool = False,
        scale_augmentation_bound: Optional[Tuple[float, float]] = None,
        rotation_augmentation_bound=None,
        translation_augmentation_ratio_bound=None,
        ignore_label: int = 255,
        rng: Optional[np.random.Generator] = None,
    ):
        self.voxel_size = voxel_size
        self.clip_bound = clip_bound
        self.ignore_label = ignore_label
        self.use_augmentation = use_augmentation
        self.scale_augmentation_bound = scale_augmentation_bound
        self.rotation_augmentation_bound = rotation_augmentation_bound
        self.translation_augmentation_ratio_bound = translation_augmentation_ratio_bound
        self.rng = rng if rng is not None else np.random.default_rng()

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def get_transformation_matrix(self, rng=None
                                  ) -> Tuple[np.ndarray, np.ndarray]:
        rng = rng if rng is not None else self.rng
        voxelization_matrix, rotation_matrix = np.eye(4), np.eye(4)
        rot_mat = np.eye(3)
        if self.use_augmentation and self.rotation_augmentation_bound is not None:
            rot_mats = []
            for axis_ind, rot_bound in enumerate(self.rotation_augmentation_bound):
                theta = 0.0
                axis = np.zeros(3)
                axis[axis_ind] = 1.0
                if rot_bound is not None:
                    theta = float(rng.uniform(*rot_bound))
                rot_mats.append(_axis_angle_matrix(axis, theta))
            rng.shuffle(rot_mats)
            rot_mat = rot_mats[0] @ rot_mats[1] @ rot_mats[2]
        rotation_matrix[:3, :3] = rot_mat
        scale = 1.0 / self.voxel_size
        if self.use_augmentation and self.scale_augmentation_bound is not None:
            scale *= float(rng.uniform(*self.scale_augmentation_bound))
        np.fill_diagonal(voxelization_matrix[:3, :3], scale)
        return voxelization_matrix, rotation_matrix

    def clip(self, coords: np.ndarray, center=None, trans_aug_ratio=None) -> np.ndarray:
        bound_min = coords.min(0).astype(float)
        bound_max = coords.max(0).astype(float)
        bound_size = bound_max - bound_min
        if center is None:
            center = bound_min + bound_size * 0.5
        if trans_aug_ratio is not None:
            center = center + trans_aug_ratio * bound_size
        lim = self.clip_bound
        keep = np.ones(coords.shape[0], dtype=bool)
        for d in range(3):
            keep &= (coords[:, d] >= lim[d][0] + center[d]) & (
                coords[:, d] < lim[d][1] + center[d])
        return keep

    def voxelize(self, coords, feats, labels, center=None, link=None,
                 return_ind: bool = False, rng=None):
        """``rng`` overrides the shared generator for this call: callers
        that voxelize from worker threads (data/prefetch.py) pass a
        per-scene derived generator so results do not depend on thread
        interleaving (the loaders derive default_rng((seed, index)))."""
        rng = rng if rng is not None else self.rng
        assert coords.shape[1] == 3 and coords.shape[0] == feats.shape[0] and coords.shape[0]
        if self.clip_bound is not None:
            trans_aug_ratio = np.zeros(3)
            if self.use_augmentation and self.translation_augmentation_ratio_bound is not None:
                for axis_ind, bound in enumerate(self.translation_augmentation_ratio_bound):
                    trans_aug_ratio[axis_ind] = float(rng.uniform(*bound))
            clip_inds = self.clip(coords, center, trans_aug_ratio)
            if clip_inds.sum():
                coords, feats = coords[clip_inds], feats[clip_inds]
                if labels is not None:
                    labels = labels[clip_inds]

        M_v, M_r = self.get_transformation_matrix(rng=rng)
        rigid = M_v
        if self.use_augmentation:
            rigid = M_r @ rigid

        homo = np.hstack((coords, np.ones((coords.shape[0], 1), dtype=coords.dtype)))
        coords_aug = np.floor(homo @ rigid.T[:, :3])
        coords_aug = np.floor(coords_aug - coords_aug.min(0))

        inds, inds_reconstruct = sparse_quantize(coords_aug, return_index=True)
        coords_aug, feats, labels = coords_aug[inds], feats[inds], labels[inds]

        # rotate normal channels if present
        if feats.shape[1] > 6:
            feats = feats.copy()
            feats[:, 3:6] = feats[:, 3:6] @ M_r[:3, :3].T

        if return_ind:
            return coords_aug, feats, labels, np.asarray(inds_reconstruct), inds
        if link is not None:
            return coords_aug, feats, labels, np.asarray(inds_reconstruct), link[inds]
        return coords_aug, feats, labels, np.asarray(inds_reconstruct)
