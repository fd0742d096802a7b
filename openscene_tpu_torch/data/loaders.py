"""Scene datasets: 3D points and fused 2D features.

Framework-agnostic re-implementations of the reference's torch Datasets
(``dataset/point_loader.py:54-177``, ``dataset/feature_loader.py:12-189``)
with identical sampling semantics:

* input features default to constant (1,1,1) unless ``input_color``;
* coordinates get a batch column; voxelization applies rotation/scale
  augmentation (always — this is the eval-repeat randomness);
* ``eval_all`` keeps unvoxelized labels + reconstruction indices;
* train scenes pick one of the N fused-feature chunk files at random;
* the fused-feature/voxel alignment follows feature_loader.py:125-172 but in
  the equivalent direct form: a voxel keeps a feature iff its representative
  point is masked, and the compact feature row is
  ``cumsum(mask_full)[vox_ind] - 1``.

An in-RAM scene cache replaces the reference's /dev/shm SharedArray cache
(``use_shm``).
"""

from __future__ import annotations

from glob import glob
from os.path import join
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from . import augment as t
from .scene_io import (list_scenes, load_fused_features, load_scene,
                       scene_name)
from .voxelizer import Voxelizer


class SceneSample(NamedTuple):
    coords: np.ndarray          # (Nvox, 3) int voxel coords (no batch col)
    feats: np.ndarray           # (Nvox, 3) float32 input features
    labels: np.ndarray          # (Nvox,) int64 (or (Norig,) when eval_all)
    inds_reconstruct: Optional[np.ndarray]  # (Norig,) voxel row per point
    feat_3d: Optional[np.ndarray]  # (Nmask, D) fp16 fused features
    feat_mask: Optional[np.ndarray]  # (Nvox,) bool voxel-has-feature


SCALE_AUGMENTATION_BOUND = (0.9, 1.1)
ROTATION_AUGMENTATION_BOUND = ((-np.pi / 64, np.pi / 64),
                               (-np.pi / 64, np.pi / 64), (-np.pi, np.pi))
TRANSLATION_AUGMENTATION_RATIO_BOUND = ((-0.2, 0.2), (-0.2, 0.2), (0, 0))
ELASTIC_DISTORT_PARAMS = ((0.2, 0.4), (0.8, 1.6))


class Point3DLoader:
    def __init__(self, datapath_prefix: str, voxel_size: float = 0.05,
                 split: str = "train", aug: bool = False,
                 memcache: bool = False, identifier: int = 1233,
                 loop: int = 1, eval_all: bool = False,
                 input_color: bool = False, seed: int = 0,
                 data_aug_color_trans_ratio: float = 0.1,
                 data_aug_color_jitter_std: float = 0.05,
                 data_aug_hue_max: float = 0.5,
                 data_aug_saturation_max: float = 0.2):
        self.split = split
        self.data_paths = list_scenes(datapath_prefix, split)
        if not self.data_paths:
            raise FileNotFoundError(
                f"0 scene files under {datapath_prefix}/{split}")
        self.dataset_name = datapath_prefix.rstrip("/").split("/")[-1]
        self.voxel_size = voxel_size
        self.aug = aug
        self.loop = loop
        self.eval_all = eval_all
        self.input_color = input_color
        self.memcache = memcache
        self._cache: Dict[int, Tuple] = {}
        self._seed = seed
        self.rng = np.random.default_rng(seed)

        self.voxelizer = Voxelizer(
            voxel_size=voxel_size, clip_bound=None, use_augmentation=True,
            scale_augmentation_bound=SCALE_AUGMENTATION_BOUND,
            rotation_augmentation_bound=ROTATION_AUGMENTATION_BOUND,
            translation_augmentation_ratio_bound=TRANSLATION_AUGMENTATION_RATIO_BOUND,
            rng=self.rng)
        if aug:
            self.prevoxel_transforms = t.Compose(
                [t.ElasticDistortion(ELASTIC_DISTORT_PARAMS, rng=self.rng)])
            self.input_transforms = t.Compose([
                t.RandomHorizontalFlip("z", is_temporal=False, rng=self.rng),
                t.ChromaticAutoContrast(rng=self.rng),
                t.ChromaticTranslation(data_aug_color_trans_ratio, rng=self.rng),
                t.ChromaticJitter(data_aug_color_jitter_std, rng=self.rng),
                t.HueSaturationTranslation(data_aug_hue_max,
                                           data_aug_saturation_max, rng=self.rng),
            ])

    def reseed(self, seed: int) -> None:
        """Reseed every RNG (the eval repeats protocol)."""
        self._seed = seed
        self.rng = np.random.default_rng(seed)
        self.voxelizer.rng = self.rng
        if self.aug:
            self.prevoxel_transforms.reseed(self.rng)
            self.input_transforms.reseed(self.rng)

    def _rng_for(self, index_long: int) -> np.random.Generator:
        """Per-scene generator derived from (seed, index): voxelization
        randomness becomes independent of CALL ORDER and prefetch-thread
        interleaving, so eval runs reproduce exactly under test_workers>1.
        (The train-time aug transforms still share self.rng — training
        randomness has no reproducibility contract across worker counts.)"""
        return np.random.default_rng((self._seed, int(index_long)))

    def __len__(self) -> int:
        return len(self.data_paths) * self.loop

    def _load_raw(self, index: int):
        if self.memcache and index in self._cache:
            return self._cache[index]
        coords, colors, labels = load_scene(self.data_paths[index])
        colors = (colors + 1.0) * 127.5  # scale to 0..255 like the reference
        out = (coords, colors, labels)
        if self.memcache:
            self._cache[index] = out
        return out

    def get(self, index_long: int) -> SceneSample:
        index = index_long % len(self.data_paths)
        locs_in, feats_in, labels_in = self._load_raw(index)
        locs = self.prevoxel_transforms(locs_in) if self.aug else locs_in
        locs, feats, labels, inds_rec = self.voxelizer.voxelize(
            locs, feats_in, labels_in, rng=self._rng_for(index_long))
        if self.eval_all:
            labels = labels_in
        if self.aug:
            locs, feats, labels = self.input_transforms(locs, feats, labels)
        feats = self._input_feats(feats, len(locs))
        return SceneSample(coords=locs.astype(np.int32), feats=feats,
                           labels=labels.astype(np.int64),
                           inds_reconstruct=inds_rec if self.eval_all else None,
                           feat_3d=None, feat_mask=None)

    def _input_feats(self, feats: np.ndarray, n: int) -> np.ndarray:
        if self.input_color:
            return (feats / 127.5 - 1.0).astype(np.float32)
        # reference hack: constant (1,1,1) input (point_loader.py:166-169)
        return np.ones((n, 3), dtype=np.float32)

    def __getitem__(self, i):
        return self.get(i)


def align_fused_features(mask_full: np.ndarray, vox_ind: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Map voxels to compact fused-feature rows.

    Returns (feat_mask (Nvox,) bool, feat_rows (Nkeep,) int64): voxel v keeps
    a feature iff mask_full[vox_ind[v]]; its compact row is
    cumsum(mask_full)[vox_ind[v]] - 1.  Equivalent to the reference's index
    gymnastics (dataset/feature_loader.py:125-144) — property-tested against
    a literal transcription in tests/test_feature_alignment.py.
    """
    feat_mask = mask_full[vox_ind]
    rows_all = np.cumsum(mask_full) - 1
    feat_rows = rows_all[vox_ind[feat_mask]]
    return feat_mask, feat_rows


class FusedFeatureLoader(Point3DLoader):
    def __init__(self, datapath_prefix: str, datapath_prefix_feat: str,
                 voxel_size: float = 0.05, split: str = "train",
                 aug: bool = False, memcache: bool = False,
                 identifier: int = 7791, loop: int = 1,
                 eval_all: bool = False, input_color: bool = False,
                 seed: int = 0):
        super().__init__(datapath_prefix=datapath_prefix,
                         voxel_size=voxel_size, split=split, aug=aug,
                         memcache=memcache, identifier=identifier, loop=loop,
                         eval_all=eval_all, input_color=input_color, seed=seed)
        self.datapath_feat = datapath_prefix_feat

        # count per-scene feature chunk files; drop scenes with none
        # (reference feature_loader.py:36-56; nuScenes has exactly one)
        if "nuscenes" in self.dataset_name:
            self.list_occur = None
        else:
            occur, keep_paths = [], []
            for p in self.data_paths:
                name = scene_name(p, self.dataset_name)
                files = glob(join(self.datapath_feat, name + "_*.npz")) + \
                    glob(join(self.datapath_feat, name + "_*.pt"))
                if files:
                    keep_paths.append(p)
                    occur.append(len(files))
            self.data_paths = keep_paths
            self.list_occur = occur
        if not self.data_paths:
            raise FileNotFoundError("0 scenes with fused features")

    def _load_feat_blob(self, index: int, rng=None):
        rng = rng if rng is not None else self.rng
        name = scene_name(self.data_paths[index], self.dataset_name)
        if self.list_occur is None:
            candidates = (glob(join(self.datapath_feat, name + ".npz")) +
                          glob(join(self.datapath_feat, name + ".pt")))
            path = candidates[0]
        else:
            n_occur = self.list_occur[index]
            k = int(rng.integers(n_occur)) if n_occur > 1 else 0
            candidates = (glob(join(self.datapath_feat, f"{name}_{k}.npz")) +
                          glob(join(self.datapath_feat, f"{name}_{k}.pt")))
            path = candidates[0]
        blob = load_fused_features(path)
        feat = blob["feat"]
        if feat.ndim > 2:  # legacy (M, C, 1) storage
            feat = feat[..., 0]
        mask_full = blob["mask_full"].astype(bool)
        if "mask" in blob:  # legacy 3-key format: visibility subselect
            vis = np.zeros(len(feat), dtype=bool)
            vis[blob["mask"].astype(np.int64)] = True
            feat = feat[vis]
            new_full = mask_full.copy()
            new_full[mask_full] = vis
            mask_full = new_full
        return feat, mask_full

    def get(self, index_long: int) -> SceneSample:
        index = index_long % len(self.data_paths)
        rng = self._rng_for(index_long)
        locs_in, feats_in, labels_in = self._load_raw(index)
        feat_3d, mask_full = self._load_feat_blob(index, rng)

        locs = self.prevoxel_transforms(locs_in) if self.aug else locs_in
        if self.split == "train":
            locs, feats, labels, inds_rec, vox_ind = self.voxelizer.voxelize(
                locs_in, feats_in, labels_in, return_ind=True, rng=rng)
            feat_mask, feat_rows = align_fused_features(mask_full, vox_ind)
            feat_3d = feat_3d[feat_rows]
        else:
            # val/test: scatter features to the full cloud, evaluate all
            # points (feature_loader.py:109-113,167-172)
            full = np.zeros((len(locs_in), feat_3d.shape[1]), dtype=feat_3d.dtype)
            full[mask_full] = feat_3d
            locs, feats, labels, inds_rec, vox_ind = self.voxelizer.voxelize(
                locs, feats_in, labels_in, return_ind=True, rng=rng)
            feat_3d = full[vox_ind]
            feat_mask = mask_full[vox_ind]
        if self.eval_all:
            labels = labels_in
        if self.aug:
            locs, feats, labels = self.input_transforms(locs, feats, labels)
        feats = self._input_feats(feats, len(locs))
        return SceneSample(coords=locs.astype(np.int32), feats=feats,
                           labels=labels.astype(np.int64),
                           inds_reconstruct=inds_rec if self.eval_all else None,
                           feat_3d=feat_3d, feat_mask=feat_mask)
