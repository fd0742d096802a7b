"""One command from a reference checkpoint to an mIoU table.

Counterpart of ``scripts/eval_reference_checkpoint.py`` of the JAX
package: the parity drill that runs the day a published OpenScene
checkpoint (a MinkowskiEngine ``*.pth.tar``) and its fused features are at
hand::

    python -m openscene_tpu_torch.scripts.eval_reference_checkpoint \\
        ckpt.pth.tar --config configs/scannet/ours_openseg_pretrained.yaml \\
        --modes distill,ensemble,fusion [--device cuda|cpu] [key value]*

Steps:

1. **Region-order probe** (``utils/convert_checkpoint.probe_region_order``,
   on ``device``): the checkpoint converted under both candidate kernel
   region orders, each run on the first val scene; the order whose distill
   output aligns with the scene's fused 2D features wins.  The wrong order
   scrambles every 27-tap kernel, so a trained checkpoint decides by a wide
   margin; under ``--min-margin`` the drill exits nonzero.  Skipped when
   ``--region-order`` or the config's ``region_order`` pins the order.
2. **Conversion** (``runtime/evaluate.load_model_for_eval``): the
   checkpoint read as ``model_path`` under that order, ``module.``
   prefixes stripped, once for the modes that run the model.
3. **Zero-shot eval** of each mode (``runtime/evaluate.ZeroShotEvaluator``;
   with ``data_parallel`` over that many ranks, as ``runtime/evaluate``'s
   ``main`` runs them).
4. The mIoU table to freeze as the parity anchor, and the same values
   unrounded on a ``# exact mIoU`` JSON line.

``device`` resolves as every entry point of the port does: ``cuda``
unless the caller asks for the CPU, and an error without CUDA.
"""

from __future__ import annotations

import argparse
import functools
import json
from glob import glob
from os.path import join
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from ..config import load_config
from ..data.scene_io import list_scenes, scene_name
from ..device import resolve_device
from ..parallel import launch
from ..runtime.evaluate import ZeroShotEvaluator, load_model_for_eval
from ..utils.convert_checkpoint import (load_probe_scene,
                                        load_torch_checkpoint,
                                        probe_region_order)


def _probe_inputs(cfg):
    """``(coords, feat_3d, mask)`` of the first val scene (the first scene
    of the tree without a val split) and its first fused blob, from the
    config's data roots (``convert_checkpoint.load_probe_scene``)."""
    paths = (list_scenes(cfg.data_root, cfg.split or "val")
             or list_scenes(cfg.data_root, ""))
    if not paths:
        raise FileNotFoundError(f"no scenes under {cfg.data_root}")
    name = scene_name(paths[0], cfg.data_root)
    blobs = sorted(glob(join(cfg.data_root_2d_fused_feature, name + "*")))
    if not blobs:
        raise FileNotFoundError(f"no fused blob for probe scene {name} under "
                                f"{cfg.data_root_2d_fused_feature}")
    return load_probe_scene(paths[0], blobs[0])


def _is_main() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def run_drill(ckpt: str, cfg, modes: Sequence[str], region_order: str = "",
              min_margin: float = 0.05, text_features=None,
              allow_pseudo_text: bool = False, device=None
              ) -> Tuple[str, Dict[str, Dict[str, float]]]:
    """Probe -> convert -> eval each mode; returns ``(region_order, {mode:
    results})``.  Raises ``SystemExit`` when the probe's margin is under
    ``min_margin``."""
    dev = resolve_device(device)
    cfg = cfg.copy(model_path=ckpt)
    order = region_order or cfg.region_order
    if not order:
        sd = load_torch_checkpoint(ckpt)
        coords, full, mask_full = _probe_inputs(cfg)
        order, scores = probe_region_order(sd, cfg.arch_3d, coords, full,
                                           mask_full,
                                           voxel_size=cfg.voxel_size,
                                           device=dev)
        ranked = sorted(scores.values(), reverse=True)
        margin = ranked[0] - ranked[1]
        if _is_main():
            print(f"# region-order probe: {scores} -> {order} "
                  f"(margin {margin:.4f})", flush=True)
        if margin < min_margin:
            raise SystemExit(
                f"region-order probe margin {margin:.4f} < {min_margin}: "
                "refusing to pick a side; pass --region-order explicitly")
    cfg = cfg.copy(region_order=order)

    table = {}
    model = None
    for mode in modes:
        mcfg = cfg.copy(feature_type=mode)
        if mode != "fusion" and model is None:
            model = load_model_for_eval(mcfg, dev)
        ev = ZeroShotEvaluator(mcfg, None if mode == "fusion" else model,
                               text_features=text_features,
                               allow_pseudo_text=allow_pseudo_text,
                               device=dev)
        table[mode] = ev.run()
    return order, table


def _rank(ckpt, modes, region_order, min_margin, cfg, device):
    """One rank's drill (``launch.run`` calls ``fn(cfg, device)``)."""
    return run_drill(ckpt, cfg, modes, region_order=region_order,
                     min_margin=min_margin, device=device)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(
        description="region-order probe -> conversion -> zero-shot eval "
                    "table of a reference checkpoint")
    ap.add_argument("checkpoint", help="reference *.pth(.tar)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--modes", default="distill,ensemble,fusion")
    ap.add_argument("--region-order", default="",
                    help="skip the probe and pin x_fastest / z_fastest")
    ap.add_argument("--min-margin", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="cfg 'key value' pairs")
    args = ap.parse_intermixed_args(argv)  # overrides before or after --*

    cfg = load_config(args.config, tuple(args.overrides))
    modes = [m.strip() for m in args.modes.split(",")]
    order, table = launch.run(
        functools.partial(_rank, args.checkpoint, modes, args.region_order,
                          args.min_margin), cfg, args.device)
    if not _is_main():
        return order, table
    print(f"\n# parity table ({args.checkpoint}, region_order={order})")
    print(f"{'mode':<10} {'mIoU':>8}")
    for mode, res in table.items():
        print(f"{mode:<10} {res['miou']:>8.4f}")
    print("# exact mIoU: "
          + json.dumps({mode: res["miou"] for mode, res in table.items()}),
          flush=True)
    return order, table


if __name__ == "__main__":
    main()
