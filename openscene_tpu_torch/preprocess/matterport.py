"""Matterport3D preprocessing: region plys -> per-vertex labels for the
21/40/80/160-class benchmarks.

Mirrors the reference's two scripts:
* preprocess_3d_matterport.py — face category_id -> nyu40 -> 21-class remap
  (the 20 ScanNet classes + ceiling), per-vertex majority vote over faces;
* preprocess_3d_matterport_K_num_classes.py — the long-tail K-class variants
  map category_id -> nyuClass NAME -> index in MATTERPORT_LABELS_K (the
  published top-K lists are shipped in labels.py, so no instance counting is
  needed here).

Category tables come from ``datasets/matterport/category_mapping.tsv``.

    python -m openscene_tpu_torch.preprocess.matterport \
        --in_path /data/matterport/v1/scans --out_dir data/matterport_3d_160/train \
        --scene_list datasets/matterport/scenes_train.txt --num_classes 160
"""

from __future__ import annotations

import argparse
import csv
import os
from glob import glob
from os.path import basename, join
from typing import Dict

import numpy as np

from ..labels import (MATTERPORT_LABELS_21, MATTERPORT_LABELS_40,
                      MATTERPORT_LABELS_80, MATTERPORT_LABELS_160)
from .point_clouds import SCANNET20_VALID_NYU40, process_matterport_region

LABELSETS = {21: MATTERPORT_LABELS_21, 40: MATTERPORT_LABELS_40,
             80: MATTERPORT_LABELS_80, 160: MATTERPORT_LABELS_160}


def load_category_mapping(tsv_path: str):
    """category index -> (nyu40 id, nyuClass name)."""
    nyu40_of: Dict[int, int] = {}
    nyuclass_of: Dict[int, str] = {}
    with open(tsv_path) as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            idx = int(row["index"])
            nyuclass_of[idx] = (row.get("nyuClass") or "").strip()
            try:
                nyu40_of[idx] = int(float(row["nyu40id"]))
            except (ValueError, KeyError):
                nyu40_of[idx] = 0
    return nyu40_of, nyuclass_of


def category_to_class_table(tsv_path: str, num_classes: int) -> np.ndarray:
    """(max_category+1,) category_id -> class index (255 = ignore)."""
    nyu40_of, nyuclass_of = load_category_mapping(tsv_path)
    max_cat = max(nyu40_of) if nyu40_of else 0
    table = np.full(max_cat + 2, 255, dtype=np.int64)
    if num_classes == 21:
        # nyu40 -> the 20 benchmark ids, plus ceiling (nyu40 id 22) as 21st
        nyu_to_21 = np.full(41, 255, dtype=np.int64)
        for i, nyu_id in enumerate(SCANNET20_VALID_NYU40):
            nyu_to_21[nyu_id] = i
        nyu_to_21[22] = 20  # ceiling
        for cat, nyu in nyu40_of.items():
            if 0 <= nyu <= 40:
                table[cat] = nyu_to_21[nyu]
    else:
        labels = LABELSETS[num_classes]
        index_of = {name: i for i, name in enumerate(labels)}
        for cat, name in nyuclass_of.items():
            table[cat] = index_of.get(name, 255)
    return table


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--in_path", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--scene_list", default="")
    ap.add_argument("--num_classes", type=int, default=21,
                    choices=[21, 40, 80, 160])
    ap.add_argument("--category_mapping",
                    default="datasets/matterport/category_mapping.tsv")
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    table = category_to_class_table(args.category_mapping, args.num_classes)
    scenes = ([l.strip() for l in open(args.scene_list)] if args.scene_list
              else sorted(os.listdir(args.in_path)))
    for scene in scenes:
        for ply in sorted(glob(join(args.in_path, scene,
                                    "region_segmentations", "*.ply"))):
            out = process_matterport_region(ply, args.out_dir, table)
            # name regions building_regionN like the reference
            new = join(args.out_dir, f"{scene}_{basename(ply)[:-4]}.npz")
            os.replace(out, new)
            print(new)


if __name__ == "__main__":
    main()
