"""Matterport3D 2D preprocessing: undistorted RGB-D + per-image cameras.

Re-implements the reference ``scripts/preprocess/preprocess_2d_matterport.py``
(obtain_intr_extr_matterport:14-46, process_one_scene:48-77): for every
undistorted color image of a building,

* color resized to 640x512 (nearest) -> ``{out}/{scene}/color/{name}.jpg``
* matching depth image (``..._iT_Y.jpg`` -> ``..._dT_Y.png``) resized uint16
  -> ``{out}/{scene}/depth/{name}.png``
* camera-to-world pose from the building's undistorted_camera_parameters
  ``.conf``, with the Y/Z column sign flip the reference applies
  (``pose[:3,1] *= -1; pose[:3,2] *= -1``) -> ``pose/{name}.txt``
* per-image intrinsics rescaled from 1280x1024 -> ``intrinsic/{name}.txt``

This is exactly the layout ``fusion/datasets.py:matterport_cameras`` consumes.

    python -m openscene_tpu_torch.preprocess.matterport_2d \
        --in_path /data/matterport/scans --out_dir data/matterport_2d \
        --scene_list datasets/matterport/scenes_train.txt
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from os.path import basename, join
from typing import List, Tuple

import numpy as np

from ..fusion.mapper import adjust_intrinsic
from .images_2d import (load_depth_u16, load_image, read_lines, resize_color,
                        resize_depth_u16, save_color, save_depth_u16)

IMG_DIM = (640, 512)
ORIGINAL_IMG_DIM = (1280, 1024)


def parse_camera_conf(path: str) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Parse a Matterport ``.conf``: (img_names, intrinsics (N,3,3),
    camera-to-world extrinsics (N,4,4)).

    Each ``intrinsics_matrix`` line covers the following 6 ``scan`` lines
    (reference preprocess_2d_matterport.py:14-46)."""
    img_names: List[str] = []
    intrinsics: List[np.ndarray] = []
    extrinsics: List[np.ndarray] = []
    for line in read_lines(path):
        if "intrinsics_matrix" in line:
            vals = [v for v in line.replace("intrinsics_matrix", "").split(" ")
                    if v]
            K = np.asarray(vals, dtype=float).reshape(3, 3)
            intrinsics.extend([K] * 6)
        elif line.startswith("scan"):
            parts = [v for v in line.split(" ") if v]
            img_names.append(parts[2])
            extrinsics.append(np.asarray(parts[3:19], dtype=float).reshape(4, 4))
    return img_names, np.stack(intrinsics), np.stack(extrinsics)


def depth_name_for(color_name: str) -> str:
    """``{pano}_iT_Y.jpg`` -> ``{pano}_dT_Y.png`` (reference lines 60-63)."""
    pano, img_type, yaw = color_name.split("_")
    return f"{pano}_d{img_type[1]}_{yaw[0]}.png"


def process_one_image(fn: str, scene_in: str, scene_out: str,
                      img_names: List[str], intr: np.ndarray,
                      poses: np.ndarray) -> None:
    name = basename(fn)
    stem = name[:-4]
    idx = img_names.index(name)

    img = resize_color(load_image(fn), IMG_DIM, nearest=True)
    save_color(join(scene_out, "color", name), img)

    dname = depth_name_for(name)
    depth = load_depth_u16(join(scene_in, "undistorted_depth_images", dname))
    depth = resize_depth_u16(depth, IMG_DIM, nearest=True)
    save_depth_u16(join(scene_out, "depth", dname), depth)

    pose = poses[idx].copy()
    pose[:3, 1] *= -1.0
    pose[:3, 2] *= -1.0
    np.savetxt(join(scene_out, "pose", stem + ".txt"), pose)

    K = adjust_intrinsic(intr[idx], ORIGINAL_IMG_DIM, IMG_DIM)
    np.savetxt(join(scene_out, "intrinsic", stem + ".txt"), K)


def process_scene(scene: str, in_path: str, out_dir: str) -> int:
    scene_in = join(in_path, scene)
    scene_out = join(out_dir, scene)
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(join(scene_out, sub), exist_ok=True)
    conf = join(scene_in, "undistorted_camera_parameters", f"{scene}.conf")
    img_names, intr, poses = parse_camera_conf(conf)
    files = sorted(glob(join(scene_in, "undistorted_color_images", "*.jpg")))
    for fn in files:
        process_one_image(fn, scene_in, scene_out, img_names, intr, poses)
    return len(files)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--in_path", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--scene_list", required=True,
                    help="e.g. datasets/matterport/scenes_train.txt")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for scene in read_lines(args.scene_list):
        n = process_scene(scene, args.in_path, args.out_dir)
        print(f"{scene}: {n} images")


if __name__ == "__main__":
    main()
