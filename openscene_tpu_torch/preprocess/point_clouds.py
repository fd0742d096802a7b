"""3D preprocessing: raw dataset meshes/lidar -> framework scene files.

Re-builds the reference's per-dataset preprocessing scripts
(scripts/preprocess/preprocess_3d_{scannet,matterport,nuscenes,replica}.py)
on the self-contained PLY reader, writing ``.npz`` scenes (coords float32,
colors in [-1,1], labels int with 255=ignore).  CLI:

    python -m openscene_tpu_torch.preprocess.point_clouds scannet \
        --in_path /data/scannet/scans --out_dir data/scannet_3d/train \
        --scene_list dataset/scannet/scannetv2_train.txt
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from os.path import basename, join
from typing import Optional

import numpy as np

from ..data.scene_io import save_scene
from ..utils.ply import read_ply

# nyu40 id -> ScanNet-20 train id (ids outside the benchmark 20 -> 255),
# reference preprocess_3d_scannet.py:8-10
SCANNET20_VALID_NYU40 = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24,
                         28, 33, 34, 36, 39)


def scannet_remapper() -> np.ndarray:
    remap = np.full(150, 255, dtype=np.int64)
    for i, nyu_id in enumerate(SCANNET20_VALID_NYU40):
        remap[nyu_id] = i
    return remap


# nuScenes-lidarseg 32 raw categories -> 16 benchmark classes (1-based then
# shifted; -1/unmapped -> 255), reference preprocess_3d_nuscenes.py:47-67
def nuscenes_remapper() -> np.ndarray:
    remap = np.full(32, 256, dtype=np.int64)
    assign = {7: (2, 3, 4, 6), 1: (9,), 8: (12,), 2: (14,), 3: (15, 16),
              4: (17,), 5: (18,), 6: (21,), 9: (22,), 10: (23,), 11: (24,),
              12: (25,), 13: (26,), 14: (27,), 15: (28,), 16: (30,)}
    for cls16, raw_ids in assign.items():
        for r in raw_ids:
            remap[r] = cls16
    return remap - 1  # 0-based classes; unmapped becomes 255


def process_scannet_scene(ply_path: str, out_dir: str) -> str:
    """_vh_clean_2.ply + .labels.ply -> scene .npz."""
    labels_path = ply_path[:-3] + "labels.ply"
    v = read_ply(ply_path)["vertex"]
    coords = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    colors = np.stack([v["red"], v["green"], v["blue"]],
                      axis=1).astype(np.float64) / 127.5 - 1
    lab = read_ply(labels_path)["vertex"]["label"].astype(np.int64)
    labels = scannet_remapper()[np.clip(lab, 0, 149)]
    out = join(out_dir, basename(ply_path)[:-4] + ".npz")
    save_scene(out, coords, colors, labels)
    return out


def process_nuscenes_scene(ply_path: str, out_dir: str,
                           export_all_points: bool = False) -> str:
    """Lidar scene.ply -> coords + 16-class labels; no colors (the loaders
    detect the zero-color sentinel)."""
    v = read_ply(ply_path)["vertex"]
    names = v.dtype.names
    coords = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    category = v[names[-1]].astype(np.int64)
    if not export_all_points:
        ts_path = ply_path[:-9] + "scene-timestamps.npy"
        if os.path.exists(ts_path):
            ts = np.load(ts_path)
            mask = (ts == ts.max()).reshape(-1)
            coords, category = coords[mask], category[mask]
    category[category == -1] = 0
    labels = nuscenes_remapper()[np.clip(category, 0, 31)]
    scene_name = ply_path.split("/")[-2]
    out = join(out_dir, scene_name + ".npz")
    save_scene(out, coords, np.zeros_like(coords), labels)
    return out


def process_replica_scene(ply_path: str, out_dir: str) -> str:
    """Replica mesh -> coords/colors, labels=255 (no GT,
    preprocess_3d_replica.py)."""
    v = read_ply(ply_path)["vertex"]
    coords = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    if "red" in (v.dtype.names or ()):
        colors = np.stack([v["red"], v["green"], v["blue"]],
                          axis=1).astype(np.float64) / 127.5 - 1
    else:
        colors = np.zeros_like(coords)
    labels = np.full(len(coords), 255, dtype=np.int64)
    out = join(out_dir, basename(ply_path)[:-4] + ".npz")
    save_scene(out, coords, colors, labels)
    return out


def process_matterport_region(ply_path: str, out_dir: str,
                              category_to_class: np.ndarray) -> str:
    """Region ply with per-face category_id -> per-vertex majority label
    (reference preprocess_3d_matterport.py:59-69), then class remap."""
    data = read_ply(ply_path)
    v = data["vertex"]
    coords = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    colors = np.stack([v["red"], v["green"], v["blue"]],
                      axis=1).astype(np.float64) / 127.5 - 1
    faces = data["face"]
    tri = faces["vertex_indices"] if "vertex_indices" in faces.dtype.names \
        else faces["vertex_index"]
    cat = faces["category_id"].astype(np.int64)
    cat = np.clip(cat, 0, len(category_to_class) - 1)
    face_label = category_to_class[cat]
    # per-vertex vote over incident faces
    n = len(coords)
    counts = np.zeros((n,), dtype=np.int64)
    best = np.full(n, 255, dtype=np.int64)
    tally: dict = {}
    for f_idx in range(len(tri)):
        l = face_label[f_idx]
        if l == 255:
            continue
        for vid in tri[f_idx]:
            key = (vid, l)
            c = tally.get(key, 0) + 1
            tally[key] = c
            if c > counts[vid]:
                counts[vid] = c
                best[vid] = l
    out = join(out_dir, basename(ply_path)[:-4] + ".npz")
    save_scene(out, coords, colors, best)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset",
                    choices=["scannet", "nuscenes", "replica", "matterport"])
    ap.add_argument("--in_path", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--scene_list", default="")
    ap.add_argument("--export_all_points", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    if args.dataset == "scannet":
        scenes = ([l.strip() for l in open(args.scene_list)]
                  if args.scene_list else
                  sorted(os.listdir(args.in_path)))
        for scene in scenes:
            for f in glob(join(args.in_path, scene, "*_vh_clean_2.ply")):
                print(process_scannet_scene(f, args.out_dir))
    elif args.dataset == "nuscenes":
        for f in sorted(glob(join(args.in_path, "*", "scene.ply"))):
            print(process_nuscenes_scene(f, args.out_dir,
                                         args.export_all_points))
    elif args.dataset == "replica":
        for f in sorted(glob(join(args.in_path, "*", "*_mesh.ply")) +
                        glob(join(args.in_path, "*.ply"))):
            print(process_replica_scene(f, args.out_dir))
    else:
        raise SystemExit("matterport requires the category mapping table; "
                         "use process_matterport_region() directly")


if __name__ == "__main__":
    main()
