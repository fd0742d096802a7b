"""ScanNet 2D preprocessing: stream `.sens` RGB-D binaries to frame folders.

Re-implements the reference's ScanNet SensReader usage
(scripts/preprocess/preprocess_2d_scannet.py + scannet_sensordata.py): every
``frame_skip``-th frame's color (jpeg), zlib-ushort depth, and camera pose are
exported, color resized to 320x240, plus a global intrinsics.txt. Uses PIL
in place of imageio/cv2 (imported inside ``export_scene``); decoding is
streaming (one frame in memory at a time).  A copy of
``openscene_tpu.preprocess.scannet_2d``.

    python -m openscene_tpu_torch.preprocess.scannet_2d \
        --in_path /data/scannet/scans --out_dir data/scannet_2d \
        --scene_list datasets/scannet/scannetv2_train.txt
"""

from __future__ import annotations

import argparse
import io
import os
import struct
import zlib
from glob import glob
from os.path import join
from typing import Iterator, Tuple

import numpy as np

COLOR_COMPRESSION = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
DEPTH_COMPRESSION = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort",
                     2: "occi_ushort"}


class SensStream:
    """Streaming .sens reader (format v4)."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        f = self.f
        version = struct.unpack("I", f.read(4))[0]
        assert version == 4, f"unsupported .sens version {version}"
        strlen = struct.unpack("Q", f.read(8))[0]
        self.sensor_name = f.read(strlen)
        self.intrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.extrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.intrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.extrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.color_compression = COLOR_COMPRESSION[
            struct.unpack("i", f.read(4))[0]]
        self.depth_compression = DEPTH_COMPRESSION[
            struct.unpack("i", f.read(4))[0]]
        self.color_width, self.color_height = struct.unpack("II", f.read(8))
        self.depth_width, self.depth_height = struct.unpack("II", f.read(8))
        self.depth_shift = struct.unpack("f", f.read(4))[0]
        self.num_frames = struct.unpack("Q", f.read(8))[0]

    def frames(self) -> Iterator[Tuple[np.ndarray, bytes, bytes]]:
        """Yields (camera_to_world, color_bytes, depth_bytes) per frame."""
        f = self.f
        for _ in range(self.num_frames):
            pose = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
            f.read(16)  # color/depth timestamps
            color_n, depth_n = struct.unpack("QQ", f.read(16))
            color = f.read(color_n)
            depth = f.read(depth_n)
            yield pose, color, depth

    def close(self):
        self.f.close()


def export_scene(sens_path: str, out_dir: str, image_size=(320, 240),
                 frame_skip: int = 20) -> int:
    from PIL import Image
    sd = SensStream(sens_path)
    for sub in ("color", "depth", "pose"):
        os.makedirs(join(out_dir, sub), exist_ok=True)
    assert sd.color_compression == "jpeg", sd.color_compression
    assert sd.depth_compression == "zlib_ushort", sd.depth_compression
    count = 0
    for i, (pose, color, depth) in enumerate(sd.frames()):
        if i % frame_skip != 0:
            continue
        img = Image.open(io.BytesIO(color)).resize(image_size, Image.BILINEAR)
        img.save(join(out_dir, "color", f"{i}.jpg"))
        d = np.frombuffer(zlib.decompress(depth), np.uint16).reshape(
            sd.depth_height, sd.depth_width)
        Image.fromarray(d).save(
            join(out_dir, "depth", f"{i}.png"))
        np.savetxt(join(out_dir, "pose", f"{i}.txt"), pose)
        count += 1
    # global color intrinsics (the fusion job rescales to image_size itself)
    np.savetxt(join(out_dir, "intrinsic.txt"), sd.intrinsic_color)
    sd.close()
    return count


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--in_path", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--scene_list", default="")
    ap.add_argument("--frame_skip", type=int, default=20)
    args = ap.parse_args()
    scenes = ([l.strip() for l in open(args.scene_list)] if args.scene_list
              else sorted(os.listdir(args.in_path)))
    for scene in scenes:
        for sens in glob(join(args.in_path, scene, "*.sens")):
            n = export_scene(sens, join(args.out_dir, scene),
                             frame_skip=args.frame_skip)
            print(f"{scene}: exported {n} frames")


if __name__ == "__main__":
    main()
