"""Multi-view fusion CLI: the entry point replacing the reference's per-dataset
fusion scripts (scripts/feature_fusion/*_openseg.py).

2D teacher features come from a pluggable source:
* ``--feat_dir DIR``: precomputed per-frame feature maps
  ``DIR/<scene>/<frame>.npy`` of shape (C, H, W) — the recommended path
  (export once from OpenSeg/LSeg, fuse on the GPU);
* ``--openseg_model PATH``: run the frozen OpenSeg TF SavedModel live
  (requires tensorflow, imported inside ``make_openseg_feature_fn``; matches
  fusion_util.extract_openseg_img_feature).  The port's tests and its GPU
  smoke run never take this path.

Fusion runs on ``--device`` (``cuda`` unless ``--device cpu``; ``cuda``
without a GPU raises).  The ScanNet, Matterport and Replica views read depth
PNGs through PIL (``datasets._load_depth``), so those datasets fuse on a host
that has PIL; nuScenes reads ``.npy`` poses and intrinsics and no depth.

Idempotent: scenes whose outputs already exist are skipped; shard manually
with ``--process_id_range lo,hi`` (reference scannet_openseg.py:52-59,176-186).

    python -m openscene_tpu_torch.fusion.run_fusion scannet \
        --data_root data/scannet_3d/train --data_root_2d data/scannet_2d \
        --out_dir data/scannet_multiview_openseg --feat_dir feats/ --split train
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from os.path import basename, exists, join
from typing import Callable, Optional

import numpy as np

from ..data.scene_io import (list_scenes, load_scene, save_fused_features,
                             scene_name)
from ..device import resolve_device
from .datasets import (SPECS, matterport_region_views, nuscenes_views,
                       replica_views, scannet_views)
from .fuse import MultiViewFuser, save_fused_feature


def make_precomputed_feature_fn(feat_dir: str, scene: str, frames):
    def fn(i):
        return np.load(join(feat_dir, scene, frames[i] + ".npy"))
    return fn


def make_openseg_feature_fn(model_path: str, image_dim, img_dir: str, frames):
    """Live OpenSeg inference (frozen teacher, fusion_util.py:42-68)."""
    import tensorflow as tf2
    import tensorflow.compat.v1 as tf
    model = tf2.saved_model.load(model_path)
    emb = tf.zeros([1, 1, 768])

    def fn(i):
        with open(join(img_dir, frames[i] + ".jpg"), "rb") as f:
            img_bytes = f.read()
        results = model.signatures["serving_default"](
            inp_image_bytes=tf.convert_to_tensor(img_bytes),
            inp_text_emb=emb)
        info = results["image_info"]
        crop = [int(info[0, 0] * info[2, 0]), int(info[0, 1] * info[2, 1])]
        feat = results["ppixel_ave_feat"][:, :crop[0], :crop[1]]
        feat = tf.image.resize(feat, [image_dim[1], image_dim[0]],
                               method="nearest")[0]
        return np.transpose(np.asarray(feat, dtype=np.float32), (2, 0, 1))

    return fn


def fuse_dataset(dataset: str, data_root: str, data_root_2d: str,
                 out_dir: str, split: str = "train", feat_dir: str = "",
                 openseg_model: str = "", process_id_range=None,
                 seed: int = 0, feat_dim: int = 0, device=None):
    """Fuse every scene of ``data_root`` on ``device`` (``cuda`` unless
    ``"cpu"``) and save it by the dataset's policy."""
    device = resolve_device(device)
    spec = SPECS[dataset]
    if feat_dim:  # e.g. 512 for lseg teachers; default = spec (768, openseg)
        from dataclasses import replace
        spec = replace(spec, feat_dim=feat_dim)
    scene_paths = list_scenes(data_root, "")
    if not scene_paths:
        scene_paths = list_scenes(os.path.dirname(data_root.rstrip("/")),
                                  basename(data_root.rstrip("/")))
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    fuser = MultiViewFuser(spec.image_dim, spec.vis_thres, spec.cut_bound,
                           use_depth=spec.depth_scale is not None,
                           feat_dim=spec.feat_dim, device=device)

    n_files = (spec.num_rand_file_per_scene if split == "train" else 1)
    for i, path in enumerate(scene_paths):
        if process_id_range and not (process_id_range[0] <= i
                                     < process_id_range[1]):
            continue
        sid = scene_name(path, f"{dataset}_3d")
        done_marker = (f"{sid}.npz" if dataset == "nuscenes"
                       else f"{sid}_{n_files - 1}.npz")
        if exists(join(out_dir, done_marker)):
            print(f"{sid}: exists, skip")
            continue
        coords, _, labels = load_scene(path)

        mask_entire = None
        if dataset == "nuscenes":
            # the reference fuses ONLY points with GT labels and composes
            # that pre-mask with visibility in the saved mask_full
            # (nuscenes_openseg.py:44-49,97-102)
            mask_entire = labels != 255
            coords = coords[mask_entire]
            if not mask_entire.any():
                print(f"{sid}: no labeled points, skip")
                continue

        if dataset == "scannet":
            view_iter = list(scannet_views(join(data_root_2d, sid), spec))
        elif dataset == "matterport":
            building = sid.split("_")[0]
            view_iter = matterport_region_views(
                join(data_root_2d, building), coords, spec, split)
        elif dataset == "nuscenes":
            view_iter = list(nuscenes_views(join(data_root_2d, sid)))
        else:
            view_iter = list(replica_views(join(data_root_2d, sid), spec))
        if not view_iter:
            print(f"{sid}: no views, skip")
            continue
        frames = [v[0] for v in view_iter]
        views = [(v[1], v[2], v[3]) for v in view_iter]
        if feat_dir:
            feature_fn = make_precomputed_feature_fn(feat_dir, sid, frames)
        elif openseg_model:
            feature_fn = make_openseg_feature_fn(
                openseg_model, spec.image_dim,
                join(data_root_2d, sid, "color"), frames)
        else:
            raise SystemExit("need --feat_dir or --openseg_model")

        feat_bank, point_ids = fuser.fuse_scene(coords, views, feature_fn)
        if dataset == "nuscenes":
            # ONE whole-scene blob; mask_full = labeled-pre-mask AND visible
            # (nuscenes_openseg.py:97-102)
            vis = np.zeros(len(coords), dtype=bool)
            vis[point_ids] = True
            mask_full = mask_entire.copy()
            mask_full[mask_entire] = vis
            save_fused_features(join(out_dir, f"{sid}.npz"),
                                feat_bank[vis].astype(np.float16), mask_full)
        elif split == "train" or dataset == "replica":
            # replica exports the whole cloud for every split via the same
            # chunked saver with a 2M-point cap (replica_openseg.py:140-141)
            save_fused_feature(feat_bank, point_ids, len(coords), out_dir,
                               sid, n_files, spec.n_split_points, rng)
        else:
            mask = np.zeros(len(coords), dtype=bool)
            mask[point_ids] = True
            save_fused_features(join(out_dir, f"{sid}_0.npz"),
                                feat_bank[mask].astype(np.float16), mask)
        print(f"{sid}: fused {len(views)} views, "
              f"{len(point_ids)}/{len(coords)} points visible")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=list(SPECS))
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--data_root_2d", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--feat_dir", default="")
    ap.add_argument("--openseg_model", default="")
    ap.add_argument("--process_id_range", default="",
                    help="lo,hi manual sharding")
    ap.add_argument("--feat_dim", type=int, default=0,
                    help="override teacher feature dim (512 for lseg)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    pir = (tuple(int(v) for v in args.process_id_range.split(","))
           if args.process_id_range else None)
    fuse_dataset(args.dataset, args.data_root, args.data_root_2d,
                 args.out_dir, args.split, args.feat_dir, args.openseg_model,
                 pir, feat_dim=args.feat_dim, device=args.device)


if __name__ == "__main__":
    main()
