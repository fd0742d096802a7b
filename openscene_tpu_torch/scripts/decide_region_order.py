"""One-command MinkowskiEngine region-order decision for a reference
checkpoint.

Counterpart of ``scripts/decide_region_order.py`` of the JAX package.  The
published OpenScene checkpoints store each conv kernel as a (K, C_in,
C_out) stack whose K axis follows MinkowskiEngine's kernel-region order;
which spatial axis runs fastest there cannot be read from the file
(``utils/convert_checkpoint.py``).  Given the checkpoint and one real
scene::

    python -m openscene_tpu_torch.scripts.decide_region_order \\
        ckpt.pth.tar scene.npz scene_fused.npz [--device cuda|cpu]

converts the checkpoint under both candidate orders, runs each on the
scene (``convert_checkpoint.probe_region_order``, on ``device``: ``cuda``
unless the caller asks for the CPU) and prints the mean cosine of the
distill output with the scene's fused 2D features per order.  A trained
model aligns with its targets only under the right order, so the decision
is a wide-margin argmax; under ``--min-margin`` the command prints
``AMBIGUOUS`` and returns 1 instead of picking a side.  Otherwise it prints
the converter's command for the chosen order.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from ..device import resolve_device
from ..utils.convert_checkpoint import (load_probe_scene,
                                        load_torch_checkpoint,
                                        probe_region_order)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="pick a reference checkpoint's kernel region order")
    ap.add_argument("checkpoint", help="reference *.pth.tar")
    ap.add_argument("scene",
                    help="preprocessed scene .npz (coords/colors/labels)")
    ap.add_argument("features", help="fused 2D-feature .npz for the scene")
    ap.add_argument("--arch", default="MinkUNet18A")
    ap.add_argument("--voxel-size", type=float, default=0.02)
    ap.add_argument("--min-margin", type=float, default=0.05,
                    help="required |cos(best) - cos(other)| to decide")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    sd = load_torch_checkpoint(args.checkpoint)
    coords, full, mask_full = load_probe_scene(args.scene, args.features)
    best, scores = probe_region_order(sd, args.arch, coords, full, mask_full,
                                      voxel_size=args.voxel_size,
                                      device=device)
    ranked = sorted(scores.values(), reverse=True)
    margin = ranked[0] - ranked[1]
    print(f"scores: {scores}")
    print(f"decision: region_order={best} (margin {margin:.4f})")
    if margin < args.min_margin:
        print(f"AMBIGUOUS: margin {margin:.4f} < {args.min_margin}; "
              "probe another scene or a different checkpoint", file=sys.stderr)
        return 1
    print("convert with:\n  python -m openscene_tpu_torch.utils."
          f"convert_checkpoint {args.checkpoint} out/model_converted.pth "
          f"--arch {args.arch} --region_order {best}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
