"""Scene file IO.

Native format is ``.npz`` (coords float32/64 (N,3) meters, colors (N,3) in
[-1,1], labels (N,) int with 255=ignore).  Reference ``.pth`` scene files
(torch-pickled ``(coords, colors, labels)`` tuples, see
``scripts/preprocess/preprocess_3d_scannet.py``) and fused-feature ``.pt``
blobs (``{'feat': (M,C) fp16, 'mask_full': (N,) bool}``,
``scripts/feature_fusion/fusion_util.py:70-90``) are read through torch (CPU)
when available, so the published datasets drop in unchanged.
"""

from __future__ import annotations

import os
from glob import glob
from os.path import join
from typing import Dict, List, Optional, Tuple

import numpy as np


def _to_numpy(x):
    if hasattr(x, "numpy"):  # torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def load_scene(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(coords, colors, labels). Handles the nuScenes color=0 sentinel and the
    -100 ignore label exactly like the reference loaders
    (dataset/point_loader.py:148-154)."""
    if path.endswith(".npz"):
        data = np.load(path)
        coords = data["coords"]
        colors = data["colors"] if "colors" in data else np.zeros_like(coords)
        labels = data["labels"] if "labels" in data else np.full(
            len(coords), 255, dtype=np.int64)
    else:
        import torch
        coords, colors, labels = torch.load(path, map_location="cpu",
                                            weights_only=False)
        coords = _to_numpy(coords)
        labels = _to_numpy(labels)
        if np.isscalar(colors) and colors == 0:
            colors = np.zeros_like(coords)
        else:
            colors = _to_numpy(colors)
    labels = labels.copy()
    labels[labels == -100] = 255
    return coords, colors, labels.astype(np.int64)


def save_scene(path: str, coords: np.ndarray, colors: np.ndarray,
               labels: np.ndarray) -> None:
    np.savez_compressed(path, coords=coords.astype(np.float32),
                        colors=colors.astype(np.float32),
                        labels=labels.astype(np.int16))


def load_fused_features(path: str) -> Dict[str, np.ndarray]:
    """{'feat': (M, C) fp16, 'mask_full': (N,) bool} fused-feature blob."""
    if path.endswith(".npz"):
        data = np.load(path)
        return {"feat": data["feat"], "mask_full": data["mask_full"]}
    import torch
    blob = torch.load(path, map_location="cpu", weights_only=False)
    out = {k: _to_numpy(v) for k, v in blob.items()}
    return out


def save_fused_features(path: str, feat: np.ndarray,
                        mask_full: np.ndarray) -> None:
    np.savez_compressed(path, feat=feat.astype(np.float16),
                        mask_full=mask_full.astype(bool))


def list_scenes(data_root: str, split: str) -> List[str]:
    """Sorted scene file list under data_root/split (reference glob pattern,
    dataset/point_loader.py:80), accepting both .pth and .npz."""
    split = split or ""
    paths = sorted(glob(join(data_root, split, "*.pth")) +
                   glob(join(data_root, split, "*.npz")))
    return paths


def scene_name(path: str, dataset_name: str) -> str:
    """Scene id used to locate fused-feature files
    (dataset/feature_loader.py:82-85): scannet scene files end in
    '_vh_clean_2.pth' (15 chars stripped); others strip the extension."""
    base = path.split("/")[-1]
    if "scannet" in dataset_name and base.endswith(".pth"):
        return base[:-15]
    return base.rsplit(".", 1)[0]
