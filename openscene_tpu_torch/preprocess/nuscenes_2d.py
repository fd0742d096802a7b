"""nuScenes 2D preprocessing: 6-camera keyframe export.

Re-implements the reference ``scripts/preprocess/preprocess_2d_nuscenes.py``
(process_one_sequence:26-55): per scene, the LAST timestamp's 6 camera images
are exported,

* color resized to 800x450 (bilinear) -> ``{out}/{scene}/color/{cam}.jpg``
* camera-to-scene pose (``cam2scene.txt``)  -> ``{out}/{scene}/pose/{cam}.npy``
* intrinsics rescaled from 1600x900        -> ``{out}/{scene}/K/{cam}.npy``

This is the exact layout the reference fusion script reads
(``scripts/feature_fusion/nuscenes_openseg.py:57-75``) and that
``fusion/datasets.py:nuscenes_views`` consumes.

    python -m openscene_tpu_torch.preprocess.nuscenes_2d \
        --in_path /data/nuscenes/train --out_dir data/nuscenes_2d/train
"""

from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np

from ..fusion.mapper import adjust_intrinsic
from .images_2d import load_image, resize_color, save_color

CAM_LOCS = ("back", "back_left", "back_right",
            "front", "front_left", "front_right")
IMG_SIZE = (800, 450)
ORIGINAL_IMG_DIM = (1600, 900)


def _load_matrix(path: str) -> np.ndarray:
    return np.asarray([[float(v) for v in ln.split(" ") if v]
                       for ln in open(path).read().splitlines() if ln.strip()])


def process_one_sequence(scene: str, data_path: str, out_dir: str) -> None:
    out_color = join(out_dir, scene, "color")
    out_pose = join(out_dir, scene, "pose")
    out_k = join(out_dir, scene, "K")
    for d in (out_color, out_pose, out_k):
        os.makedirs(d, exist_ok=True)

    frames_dir = join(data_path, scene, "frames")
    timestamp = sorted(os.listdir(frames_dir))[-1]  # last timestamp only
    for cam in CAM_LOCS:
        cam_dir = join(frames_dir, timestamp, cam)
        img = load_image(join(cam_dir, "color_image.jpg"))
        save_color(join(out_color, cam + ".jpg"),
                   resize_color(img, IMG_SIZE, nearest=False))
        pose = _load_matrix(join(cam_dir, "cam2scene.txt"))
        np.save(join(out_pose, cam + ".npy"), pose)
        K = _load_matrix(join(cam_dir, "K.txt"))
        K = adjust_intrinsic(K, ORIGINAL_IMG_DIM, IMG_SIZE)
        np.save(join(out_k, cam + ".npy"), K)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--in_path", required=True,
                    help="original nuScenes split dir (contains scene dirs)")
    ap.add_argument("--out_dir", required=True)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for scene in sorted(os.listdir(args.in_path)):
        process_one_sequence(scene, args.in_path, args.out_dir)
        print(f"{scene} done")


if __name__ == "__main__":
    main()
