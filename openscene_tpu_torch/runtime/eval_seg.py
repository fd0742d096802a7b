"""Supervised baseline evaluation (the reference's ``run/eval_mink.py``), on
one CUDA device by default.

Counterpart of ``openscene_tpu/runtime/eval_seg.py``: labelset-free eval
of the trained segmentation UNet with the summed-logit repeats protocol (the
loader reseeded before every repeat); the nuScenes labeled subset;
``gt.npy`` / ``pred.npy`` in ``save_folder``.  Each scene's geometry is
built on the device under ``device_geometry`` (``auto``: on for CUDA), else
on the host (``train_seg.SegSceneLogits``).

Multi-GPU (``data_parallel``, one process per GPU), as the zero-shot
evaluator (``runtime/evaluate.py``): the data ranks take the scenes
round-robin on shared running caps, rank 0 gathers every scene's logits
and labels round by round and runs the protocol, and every rank returns
its results.  Launch with torchrun, the config's ``coordinator_address``/
``num_processes``/``process_id``, or ``main`` alone, which starts
``data_parallel`` local processes.

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
from ..parallel import launch
from ..parallel.mesh import broadcast_from_main, gather_to_main, mesh_for
from ..utils.train_utils import get_logger
from .evaluate import load_weights, rank_scene_rounds
from .train_seg import SegSceneLogits

log = get_logger()


def evaluate_seg(cfg: Config, model: Optional[MinkUNet] = None,
                 device=None) -> Dict[str, float]:
    """mIoU of every repeat (``repeat_<r>``), of the summed logits
    (``accumulated``) and the final one (``miou``).  Without ``model`` the
    weights come from ``cfg.model_path`` (the port's or the JAX package's
    checkpoints, ``evaluate.load_weights``), random from
    ``cfg.manual_seed`` without a path."""
    dev = resolve_device(device)
    mesh = mesh_for("eval_seg", cfg.data_parallel, device=dev)
    dataset_name = dataset_name_from_root(cfg.data_root)
    if model is None:
        model = MinkUNet(3, cfg.classes, cfg.arch_3d,
                         generator=torch.Generator().manual_seed(
                             cfg.manual_seed))
        load_weights(model, cfg)
    model = model.to(dev).eval()
    scenes = SegSceneLogits(cfg, model, dev, mesh)
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
        for logits, label in _scene_rows(scenes, loader, mesh):
            if is_nuscenes:  # evaluation points are a labeled subset
                keep = label != 255
                label, logits = label[keep], logits[keep]
            preds.append(logits)
            gts.append(label)
        if mesh is not None and not mesh.is_main:
            continue  # rank 0 holds every scene's rows
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
    if mesh is None or mesh.is_main:
        results["miou"] = results["accumulated"]
    if mesh is not None:
        results = broadcast_from_main(results, mesh)
    return results


def _scene_rows(scenes: SegSceneLogits, loader: Point3DLoader, mesh):
    """``(logits, labels)`` of every scene in scene order (on rank 0 under
    a mesh, gathered round by round; none on the other ranks)."""
    for _, sample, caps in rank_scene_rounds(
            loader.get, len(loader.data_paths), mesh, scenes.geometry):
        row = None if sample is None else scenes(sample, caps)
        if mesh is None:
            yield row
            continue
        for r in gather_to_main(row, mesh) or ():
            if r is not None:
                yield r


def _evaluate(cfg: Config, device=None) -> Dict[str, float]:
    """One rank's evaluation (``main``'s work on every rank)."""
    results = evaluate_seg(cfg, device=device)
    log.info("final mIoU: %.4f", results["miou"])
    return results


def main(argv=None):
    cfg, device = load_cli(argv if argv is not None else sys.argv[1:])
    return launch.run(_evaluate, cfg, device)


if __name__ == "__main__":
    main()
