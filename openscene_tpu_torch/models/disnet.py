"""DisNet: the 3D distillation model wrapper.

Picks the CLIP-space output dimension from the 2D feature extractor
(openseg -> 768, lseg -> 512) and builds a sparse UNet with 3 input channels
(reference ``models/disnet.py:21-40``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .sparse_unet import MinkUNet

FEATURE_DIMS = {"openseg": 768, "lseg": 512}


def output_dim(feature_2d_extractor: str) -> int:
    for k, v in FEATURE_DIMS.items():
        if k in feature_2d_extractor:
            return v
    raise NotImplementedError(feature_2d_extractor)


def build_disnet(cfg, generator: Optional[torch.Generator] = None
                 ) -> MinkUNet:
    """The distillation model of a Config, randomly initialised."""
    return MinkUNet(3, output_dim(cfg.feature_2d_extractor), cfg.arch_3d,
                    generator=generator)
