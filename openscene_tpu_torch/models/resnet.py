"""Sparse ResNet classifiers (ResNet14/18/34/50/101).

Counterpart of ``openscene_tpu/models/resnet.py`` (reference
``models/resnet_base.py:139-160``, part of the model zoo, unused by the
OpenScene pipeline) as an ``nn.Module``: a k=5 stem, four stages of a k=2
s=2 down conv and residual blocks, a per-scene global average pool over the
coarsest level, and a linear head.

It is built from the UNet's parts (``models/sparse_unet.py``): the stem and
every k=3 conv run kernel 1 (``csrc/gather_gemm_fwd.cu``; the stem densely,
K = 125 > 31 offsets leaves it no skip plan, its 3 colour channels
zero-padded to 8), the down convs kernel 3, and in a backward pass kernels
2 and 6.  The input is colour, not the constant feature, so the geometry
carries the stem as an index plan: ``build_unet_geometry`` on the host, or
``sparse.geometry_device.build_geometry_parts(..., stem_occupancy=False)``
on the card.

Parameter names follow the JAX tree (``conv0``, ``bn0.*``, ``conv1-4``,
``bn1-4``, ``block1-4.<i>.*``, ``fc.w``, ``fc.b``), so
:func:`openscene_tpu_torch.convert.resnet_params_from_jax` carries
``init_resnet``'s (params, state) across one to one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..sparse.ops import masked_global_avg_pool, valid_mask
from ..sparse.types import UNetGeometry
from .sparse_unet import (Block, MaskedBatchNorm, _conv_weight,
                          _edge_down_conv, _stencil_conv)


@dataclass(frozen=True)
class ResNetArchSpec:
    block: str
    layers: Tuple[int, ...]
    planes: Tuple[int, ...] = (64, 128, 256, 512)
    init_dim: int = 64

    @property
    def expansion(self) -> int:
        return 1 if self.block == "basic" else 4


RESNET_ARCHS: Dict[str, ResNetArchSpec] = {
    "ResNet14": ResNetArchSpec("basic", (1, 1, 1, 1)),
    "ResNet18": ResNetArchSpec("basic", (2, 2, 2, 2)),
    "ResNet34": ResNetArchSpec("basic", (3, 4, 6, 3)),
    "ResNet50": ResNetArchSpec("bottleneck", (3, 4, 6, 3)),
    "ResNet101": ResNetArchSpec("bottleneck", (3, 4, 23, 3)),
}


class ResNet(nn.Module):
    """``forward(x, geo, num_batches)`` maps (cap0, in_channels) colour
    activations (the compute dtype) on the geometry ``geo`` (plan arrays on
    x's device, the stem as an index plan) to (num_batches, num_classes)
    fp32 logits.  Training mode takes BatchNorm's batch statistics and
    updates its buffers, as ``MinkUNet`` does."""

    def __init__(self, in_channels: int, num_classes: int,
                 arch: str = "ResNet18",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        a = RESNET_ARCHS[arch]
        g = generator
        self.conv0 = _conv_weight(125, in_channels, a.init_dim, g)
        self.bn0 = MaskedBatchNorm(a.init_dim)
        inplanes = a.init_dim
        for i in range(1, 5):
            setattr(self, f"conv{i}", _conv_weight(8, inplanes, inplanes, g))
            setattr(self, f"bn{i}", MaskedBatchNorm(inplanes))
            blocks = []
            for _ in range(a.layers[i - 1]):
                blocks.append(Block(a.block, inplanes, a.planes[i - 1],
                                    a.expansion, g))
                inplanes = a.planes[i - 1] * a.expansion
            setattr(self, f"block{i}", nn.ModuleList(blocks))
        self.fc = nn.ParameterDict({
            "w": nn.Parameter(torch.randn((inplanes, num_classes),
                                          generator=g) * 0.01),
            "b": nn.Parameter(torch.zeros(num_classes))})

    def forward(self, x, geo: UNetGeometry, num_batches: int):
        dev = x.device
        masks = [valid_mask(l.num, l.cap, device=dev) for l in geo.levels]
        nums = [int(l.num) for l in geo.levels]
        out = self.bn0(_stencil_conv(x, self.conv0, geo.stem), masks[0],
                       nums[0], relu=True)
        for i in range(1, 5):
            out = _edge_down_conv(out, getattr(self, f"conv{i}"),
                                  geo.down[i - 1])
            out = getattr(self, f"bn{i}")(out, masks[i], nums[i], relu=True)
            for blk in getattr(self, f"block{i}"):
                out = blk(out, geo.self3[i], masks[i], nums[i])
        pooled = masked_global_avg_pool(out, masks[4], nums[4],
                                        geo.levels[4].coords[:, 0],
                                        num_batches)
        return pooled @ self.fc["w"] + self.fc["b"]
