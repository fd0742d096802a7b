"""Voxel quantization: integer-coordinate hashing and first-point-wins dedup.

Same numerical behavior as the reference's ``dataset/voxelization_utils.py``
(FNV64-1A / ravel hashing + ``np.unique`` dedup), which is also the convention
MinkowskiEngine's coordinate manager implements.  The device-side sparse
engine (:mod:`openscene_tpu_torch.sparse`) reuses these exact semantics so that
voxel ordering is reproducible between host pipeline and geometry plans.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """Row-wise FNV64-1A hash of an integer coordinate matrix (N, D)."""
    assert arr.ndim == 2
    arr = arr.astype(np.uint64, copy=True)
    h = np.full(arr.shape[0], _FNV_OFFSET, dtype=np.uint64)
    for j in range(arr.shape[1]):
        h = h * _FNV_PRIME
        h = np.bitwise_xor(h, arr[:, j])
    return h


def ravel_hash_vec(arr: np.ndarray) -> np.ndarray:
    """Fortran-order ravel of coordinates after shifting to the origin."""
    assert arr.ndim == 2
    arr = arr - arr.min(0)
    arr = arr.astype(np.uint64, copy=False)
    arr_max = arr.max(0).astype(np.uint64) + np.uint64(1)
    keys = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1] - 1):
        keys += arr[:, j]
        keys *= arr_max[j + 1]
    keys += arr[:, -1]
    return keys


def sparse_quantize(
    coords: np.ndarray,
    feats: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    ignore_label: int = 255,
    set_ignore_label_when_collision: bool = False,
    return_index: bool = False,
    hash_type: str = "fnv",
    quantization_size: Union[float, np.ndarray] = 1,
):
    """Quantize points to voxels with first-point-wins dedup.

    Returns, depending on arguments (mirroring
    ``dataset/voxelization_utils.py:44-137``):

    * with labels + return_index: ``(inds, filtered_labels)``
    * with labels: ``(discrete_coords[inds], feats[inds], filtered_labels)``
    * without labels + return_index (default when neither feats nor labels
      given): ``(inds, inds_reverse)`` where ``inds_reverse[p]`` is the voxel
      row of original point ``p``
    * without labels: quantized coords (and feats).
    """
    use_label = labels is not None
    use_feat = feats is not None
    if not use_label and not use_feat:
        return_index = True
    assert hash_type in ("ravel", "fnv"), hash_type
    assert coords.ndim == 2, coords.shape

    dim = coords.shape[1]
    if np.isscalar(quantization_size):
        qsize = np.full(dim, float(quantization_size))
    else:
        qsize = np.asarray(quantization_size, dtype=np.float64)
        assert qsize.shape == (dim,)
    discrete = np.floor(coords / qsize)

    key = fnv_hash_vec(discrete) if hash_type == "fnv" else ravel_hash_vec(discrete)

    if use_label:
        _, inds, counts = np.unique(key, return_index=True, return_counts=True)
        filtered_labels = labels[inds]
        if set_ignore_label_when_collision:
            filtered_labels = filtered_labels.copy()
            filtered_labels[counts > 1] = ignore_label
        if return_index:
            return inds, filtered_labels
        return discrete[inds], feats[inds], filtered_labels

    _, inds, inds_reverse = np.unique(key, return_index=True, return_inverse=True)
    inds_reverse = inds_reverse.reshape(-1)  # numpy>=2 keeps input shape
    if return_index:
        return inds, inds_reverse
    if use_feat:
        return discrete[inds], feats[inds]
    return discrete[inds]
