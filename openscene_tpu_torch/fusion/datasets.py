"""Per-dataset camera/view adapters for the fusion job.

Carries the reference's per-dataset constants and camera-selection logic
(scripts/feature_fusion/{scannet,matterport,nuscenes,replica}_openseg.py):

| dataset    | image     | depth scale | vis_thres | cut | views            |
|------------|-----------|-------------|-----------|-----|------------------|
| scannet    | 320x240   | 1000        | 0.25      | 10  | every k-th frame |
| matterport | 640x512   | 4000        | 0.02      | 10  | cameras inside the region bbox (test regions with none: nearest 100) |
| nuscenes   | 800x450   | (no depth)  | front-z   | 5   | 6 fixed cameras  |
| replica    | 640x360   | 6553.5      | 0.25      | 10  | every k-th frame, global intrinsics |

Save policies (reference {scannet,replica,nuscenes}_openseg.py main()):
scannet/matterport train = 20k points x 5 random chunk files; replica =
whole cloud (2M-point cap) x 1 file for every split
(replica_openseg.py:140-141); nuscenes = ONE whole-scene blob of the
labeled-points pre-mask composed with visibility
(nuscenes_openseg.py:44-49,97-102).

A NumPy-only copy of ``openscene_tpu.fusion.datasets``.  PIL is imported
inside ``_load_depth``: the ScanNet, Matterport and Replica adapters read
depth PNGs and so run on a host that has PIL; the nuScenes adapter reads
``.npy`` files only.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from glob import glob
from os.path import basename, join
from typing import List, Optional, Tuple

import numpy as np

from .mapper import adjust_intrinsic, make_intrinsic


@dataclass
class FusionSpec:
    image_dim: Tuple[int, int]
    depth_scale: Optional[float]
    vis_thres: float
    cut_bound: int
    feat_dim: int = 768
    n_split_points: int = 20000
    num_rand_file_per_scene: int = 5


SPECS = {
    "scannet": FusionSpec((320, 240), 1000.0, 0.25, 10),
    "matterport": FusionSpec((640, 512), 4000.0, 0.02, 10),
    "nuscenes": FusionSpec((800, 450), None, 0.25, 5),
    # replica_openseg.py:125,140-141: vis 0.25, whole-cloud single-file save
    "replica": FusionSpec((640, 360), 6553.5, 0.25, 10,
                          n_split_points=2_000_000,
                          num_rand_file_per_scene=1),
}

SCANNET_INTRINSIC = adjust_intrinsic(
    make_intrinsic(577.870605, 577.870605, 319.5, 239.5),
    (640, 480), (320, 240))


def _load_depth(path: str, scale: float) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path), dtype=np.float32) / scale


def scannet_views(scene_2d_dir: str, spec: FusionSpec, every: int = 1):
    """(pose, intrinsic 3x3, depth) per selected frame; the 2D preprocessing
    already keeps every 20th frame (scannet_sensordata export)."""
    poses = sorted(glob(join(scene_2d_dir, "pose", "*.txt")))
    for i, pose_path in enumerate(poses):
        if i % every != 0:
            continue
        frame = basename(pose_path)[:-4]
        pose = np.loadtxt(pose_path)
        depth = _load_depth(join(scene_2d_dir, "depth", frame + ".png"),
                            spec.depth_scale)
        yield frame, pose, SCANNET_INTRINSIC[:3, :3], depth


def matterport_cameras(building_2d_dir: str):
    """All (name, intrinsic, extrinsic) of a building: per-image pose/intr
    text files (reference fusion_util.py:142-162)."""
    img_names = sorted(glob(join(building_2d_dir, "color", "*.jpg")))
    out = []
    for img in img_names:
        name = basename(img)[:-4]
        pose = np.loadtxt(join(building_2d_dir, "pose", name + ".txt"))
        intr = np.loadtxt(join(building_2d_dir, "intrinsic", name + ".txt"))
        out.append((name, intr, pose))
    return out


def matterport_region_views(building_2d_dir: str, locs: np.ndarray,
                            spec: FusionSpec, split: str = "train"):
    """Cameras whose position lies inside the region's bbox; test regions
    with zero inside-views take the 100 nearest cameras
    (reference fusion_util.py:164-200)."""
    cams = matterport_cameras(building_2d_dir)
    if not cams:
        return []
    pos = np.stack([c[2][:3, -1] for c in cams])
    lo, hi = locs.min(0), locs.max(0)
    inside = np.flatnonzero(((pos > lo) & (pos < hi)).all(axis=1))
    if split == "test" and len(inside) == 0:
        centroid = (lo + hi) / 2
        inside = np.argsort(np.linalg.norm(pos - centroid, axis=-1))[:100]
    views = []
    for i in inside:
        name, intr, pose = cams[i]
        # Matterport depth images are named {pano}_dT_Y.png for color
        # {pano}_iT_Y.jpg (preprocess/matterport_2d.py:depth_name_for)
        pano, img_type, yaw = name.split("_")
        depth_path = join(building_2d_dir, "depth",
                          f"{pano}_d{img_type[1]}_{yaw}.png")
        if not os.path.exists(depth_path):  # legacy same-stem naming
            depth_path = join(building_2d_dir, "depth", name + ".png")
        depth = (_load_depth(depth_path, spec.depth_scale)
                 if os.path.exists(depth_path) else None)
        views.append((name, pose, intr[:3, :3], depth))
    return views


NUSCENES_CAMERAS = ("back", "back_left", "back_right",
                    "front", "front_left", "front_right")


def nuscenes_views(scene_2d_dir: str):
    """6 fixed cameras, ONE keyframe each (the preprocessor exports the last
    timestamp only): ``pose/{cam}.npy`` + ``K/{cam}.npy`` — the layout of
    preprocess/nuscenes_2d.py and the reference fusion script
    (scripts/feature_fusion/nuscenes_openseg.py:57-75). No depth ->
    front-facing occlusion only."""
    for cam in NUSCENES_CAMERAS:
        pose_path = join(scene_2d_dir, "pose", cam + ".npy")
        if not os.path.exists(pose_path):
            continue
        pose = np.load(pose_path)
        intr = np.load(join(scene_2d_dir, "K", cam + ".npy"))
        yield cam, pose, intr[:3, :3], None


def replica_views(scene_2d_dir: str, spec: FusionSpec, every: int = 1):
    """Global ``intrinsics.txt`` (written next to the scene dirs by
    preprocess/replica_2d.py) + per-frame poses. The preprocessor already
    keeps every 10th rendered frame, so the fusion pass reads all exported
    frames (reference replica_openseg.py:61,153-158)."""
    intr_path = join(os.path.dirname(scene_2d_dir.rstrip("/")),
                     "intrinsics.txt")
    if not os.path.exists(intr_path):  # legacy per-scene location
        intr_path = join(scene_2d_dir, "intrinsic.txt")
    intr = np.loadtxt(intr_path)
    poses = sorted(glob(join(scene_2d_dir, "pose", "*.txt")),
                   key=lambda p: int(basename(p)[:-4]))
    for i, pose_path in enumerate(poses):
        if i % every != 0:
            continue
        name = basename(pose_path)[:-4]
        pose = np.loadtxt(pose_path)
        depth = _load_depth(join(scene_2d_dir, "depth", name + ".png"),
                            spec.depth_scale)
        yield name, pose, intr[:3, :3], depth
