"""Supervised baseline evaluation (the reference's ``run/eval_mink.py``), on
one CUDA device by default.

Counterpart of ``openscene_tpu/runtime/eval_seg.py`` (its single-device
branch): labelset-free eval of the trained segmentation UNet with the
summed-logit repeats protocol (the loader reseeded before every repeat); the
nuScenes labeled subset; ``gt.npy`` / ``pred.npy`` in ``save_folder``.  Each
scene's geometry is built on the device under ``device_geometry`` (``auto``:
on for CUDA), else on the host (``train_seg.SegSceneLogits``).  Multi-device
eval is not ported yet (ROADMAP).

Run: ``python -m openscene_tpu_torch.runtime.eval_seg --config
configs/scannet/mink.yaml [--device cuda|cpu] [key value]*``
"""

from __future__ import annotations

import os
import sys
from os.path import join
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import metrics
from ..config import Config, dataset_name_from_root, load_cli
from ..data.loaders import Point3DLoader
from ..device import resolve_device
from ..models.sparse_unet import MinkUNet
from ..utils.train_utils import get_logger
from .evaluate import load_weights
from .train_seg import SegSceneLogits

log = get_logger()


def evaluate_seg(cfg: Config, model: Optional[MinkUNet] = None,
                 device=None) -> Dict[str, float]:
    """mIoU of every repeat (``repeat_<r>``), of the summed logits
    (``accumulated``) and the final one (``miou``).  Without ``model`` the
    weights come from ``cfg.model_path`` (the port's or the JAX package's
    checkpoints, ``evaluate.load_weights``), random from
    ``cfg.manual_seed`` without a path."""
    if cfg.data_parallel > 1:
        raise NotImplementedError(
            "multi-device eval (data_parallel > 1) is not ported yet")
    dev = resolve_device(device)
    dataset_name = dataset_name_from_root(cfg.data_root)
    if model is None:
        model = MinkUNet(3, cfg.classes, cfg.arch_3d,
                         generator=torch.Generator().manual_seed(
                             cfg.manual_seed))
        load_weights(model, cfg)
    model = model.to(dev).eval()
    scenes = SegSceneLogits(cfg, model, dev)
    loader = Point3DLoader(
        datapath_prefix=cfg.data_root, voxel_size=cfg.voxel_size,
        split=cfg.split, aug=False, memcache=cfg.use_shm, eval_all=True,
        input_color=cfg.input_color, seed=cfg.manual_seed)

    results: Dict[str, float] = {}
    store: Optional[List[np.ndarray]] = None
    rng = np.random.default_rng(cfg.manual_seed)
    is_nuscenes = "nuscenes_3d" in dataset_name
    for rep in range(cfg.test_repeats):
        loader.reseed(int(rng.integers(10000)))
        preds, gts = [], []
        for i in range(len(loader.data_paths)):
            logits, label = scenes(loader.get(i))
            if is_nuscenes:  # evaluation points are a labeled subset
                keep = label != 255
                label, logits = label[keep], logits[keep]
            preds.append(logits)
            gts.append(label)
        gt = np.concatenate(gts)
        logits = np.concatenate(preds)
        cur = metrics.evaluate(logits.argmax(1), gt, dataset=dataset_name)
        results[f"repeat_{rep}"] = cur
        if cfg.test_repeats > 1:
            if store is None:
                store = [p.copy() for p in preds]
            else:
                for s, p in zip(store, preds):
                    s += p
            acc = metrics.evaluate(np.concatenate(store).argmax(1), gt,
                                   dataset=dataset_name, stdout=True)
            results["accumulated"] = acc
            log.info("repeat %d mIoU %.4f accumulated %.4f", rep + 1, cur,
                     acc)
        else:
            results["accumulated"] = cur
            log.info("mIoU %.4f", cur)
        if cfg.save_folder:
            os.makedirs(cfg.save_folder, exist_ok=True)
            np.save(join(cfg.save_folder, "gt.npy"), gt)
            final = (np.concatenate(store) if store is not None
                     else logits).argmax(1)
            np.save(join(cfg.save_folder, "pred.npy"), final)
    results["miou"] = results["accumulated"]
    return results


def main(argv=None):
    cfg, device = load_cli(argv if argv is not None else sys.argv[1:])
    results = evaluate_seg(cfg, device=device)
    log.info("final mIoU: %.4f", results["miou"])
    return results


if __name__ == "__main__":
    main()
