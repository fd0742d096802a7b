"""DisNet: the 3D distillation model wrapper.

Picks the CLIP-space output dimension from the 2D feature extractor
(openseg -> 768, lseg -> 512) and builds a sparse UNet with 3 input channels
(reference ``models/disnet.py:21-40``), or a Point Transformer V3
(``models/ptv3.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .ptv3 import ARCHS as PTV3_ARCHS
from .ptv3 import PTv3
from .sparse_unet import MinkUNet

FEATURE_DIMS = {"openseg": 768, "lseg": 512}


def output_dim(feature_2d_extractor: str) -> int:
    for k, v in FEATURE_DIMS.items():
        if k in feature_2d_extractor:
            return v
    raise NotImplementedError(feature_2d_extractor)


def build_disnet(cfg, generator: Optional[torch.Generator] = None):
    """The distillation model of a Config, randomly initialised: a
    :class:`PTv3` for a Point Transformer V3 ``arch_3d`` (its shuffles
    and DropPath seeded by ``cfg.manual_seed``), else a
    :class:`MinkUNet`."""
    dim = output_dim(cfg.feature_2d_extractor)
    if cfg.arch_3d in PTV3_ARCHS:
        return PTv3(3, dim, cfg.arch_3d, generator=generator,
                    seed=cfg.manual_seed)
    return MinkUNet(3, dim, cfg.arch_3d, generator=generator)
