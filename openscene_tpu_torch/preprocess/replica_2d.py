"""Replica 2D preprocessing: RGB-D frames + trajectory poses.

Re-implements the reference ``scripts/preprocess/preprocess_2d_replica.py``
(process_one_scene:9-27): every ``sample_freq``-th rendered frame of the 8
Replica scenes,

* color ``frame{NNNNNN}.jpg`` resized to 640x360 -> ``{out}/{scene}/color/{id}.jpg``
* depth ``depth{NNNNNN}.png`` resized uint16     -> ``{out}/{scene}/depth/{id}.png``
  (bilinear for parity with the reference's cv2.INTER_LINEAR)
* pose row ``traj.txt[id * sample_freq]``        -> ``{out}/{scene}/pose/{id}.txt``
* ONE global ``{out}/intrinsics.txt`` (fx=fy=600 at 1200x680, rescaled)

matching the reference fusion script's reads
(``scripts/feature_fusion/replica_openseg.py:61-84,153-158``).

    python -m openscene_tpu_torch.preprocess.replica_2d \
        --in_path /data/Replica --out_dir data/replica_processed/replica_2d
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from os.path import basename, join

import numpy as np

from ..fusion.mapper import adjust_intrinsic, make_intrinsic
from .images_2d import (load_depth_u16, load_image, resize_color,
                        resize_depth_u16, save_color, save_depth_u16)

SCENES = ("office0", "office1", "office2", "office3",
          "office4", "room0", "room1", "room2")
IMG_DIM = (640, 360)
ORIGINAL_IMG_DIM = (1200, 680)


def process_one_frame(fn: str, scene_out: str, pose_list: np.ndarray,
                      sample_freq: int) -> None:
    name = basename(fn)
    img_id = int(name.split("frame")[-1].split(".")[0]) // sample_freq

    img = resize_color(load_image(fn), IMG_DIM, nearest=False)
    save_color(join(scene_out, "color", f"{img_id}.jpg"), img)

    depth_path = join(os.path.dirname(fn),
                      name.replace(".jpg", ".png").replace("frame", "depth"))
    depth = resize_depth_u16(load_depth_u16(depth_path), IMG_DIM,
                             nearest=False)
    save_depth_u16(join(scene_out, "depth", f"{img_id}.png"), depth)

    np.savetxt(join(scene_out, "pose", f"{img_id}.txt"), pose_list[img_id])


def process_scene(scene: str, in_path: str, out_dir: str,
                  sample_freq: int) -> int:
    scene_out = join(out_dir, scene)
    for sub in ("color", "depth", "pose"):
        os.makedirs(join(scene_out, sub), exist_ok=True)
    poses = np.loadtxt(join(in_path, scene, "traj.txt")).reshape(-1, 4, 4)
    pose_list = poses[::sample_freq]
    files = sorted(glob(join(in_path, scene, "results", "frame*.jpg")))
    files = files[::sample_freq]
    for fn in files:
        process_one_frame(fn, scene_out, pose_list, sample_freq)
    return len(files)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--in_path", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--sample_freq", type=int, default=10)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    intr = make_intrinsic(fx=600.0, fy=600.0, mx=599.5, my=339.5)
    intr = adjust_intrinsic(intr, ORIGINAL_IMG_DIM, IMG_DIM)
    np.savetxt(join(args.out_dir, "intrinsics.txt"), intr)

    for scene in SCENES:
        n = process_scene(scene, args.in_path, args.out_dir, args.sample_freq)
        print(f"{scene}: {n} frames")


if __name__ == "__main__":
    main()
