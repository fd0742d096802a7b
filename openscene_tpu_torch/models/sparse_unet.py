"""Sparse UNet family (MinkUNet14/18/34/50/101, plane variants A-D).

Counterpart of ``openscene_tpu/models/sparse_unet.py`` as an ``nn.Module``
(reference ``models/mink_unet.py:30-263``, ``models/resnet_base.py:31-136``):

* 4 down / 4 up UNet with a kernel-size-5 stem, kernel-2 stride-2
  down/transposed convs, residual blocks (BasicBlock or Bottleneck) at every
  level, skip concatenation on exactly-cached finer coordinates, and a final
  1x1 projection.
* All convolutions are bias-free (MinkowskiConvolution default); BatchNorm
  carries (gamma, beta) parameters and (mean, var) running-stat buffers.

Parameter names mirror the JAX package's pytree (``conv0``, ``bn0.gamma``,
``block1.0.conv1``, ``block1.0.bn1.mean``, ``final`` ...), and conv weights
keep its (K, C_in, C_out) fp32 layout and offset order, so
:func:`openscene_tpu_torch.convert.params_from_jax` carries weights across
one to one.

Init: He-normal with std = sqrt(2 / (K * C_out)) on conv kernels (fan-out
over the kernel volume, reference ``models/resnet_base.py:73-80``), drawn
from a ``torch.Generator``; BN gamma=1, beta=0.

In training mode (``model.train()``) BatchNorm takes batch statistics over
the valid rows and updates its running buffers, and the sparse convs carry
their gradients through the autograd Functions of ``sparse/stencil_conv.py``
and ``sparse/edge_conv.py``, whose backward is a CUDA kernel on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..sparse.edge_conv import DownConv, UpConv
from ..parallel.mesh import grad_sum
from ..sparse.ops import (_acc_dtype, masked_batch_norm, matmul_f32, relu,
                          valid_mask)
from ..sparse.stencil_conv import StencilConv
from ..sparse.types import ConvPlan, DownPlan, UNetGeometry


def _stencil_conv(x, w, plan: ConvPlan):
    """Stencil conv (k=3 blocks; k=5 stem on non-constant input): the CUDA
    kernel's wrapper at every level, with the plan's skip plan (None for
    the stem, which runs densely).  Input channels that are not a multiple
    of 8 (the 3-channel colour stem) are zero-padded, which adds exact
    zeros, so the kernel's 16-byte row vectors apply; autograd of the pad
    drops the padded rows of dW again."""
    cin = w.shape[1]
    pad = -cin % 8
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    return StencilConv.apply(x.contiguous(), w, plan)


def _edge_down_conv(x, w, plan: DownPlan):
    """k=2 s=2 down conv: the CUDA kernels' wrappers on every edge, with the
    plan's groups and skip plan."""
    return DownConv.apply(x.contiguous(), w, plan)


def _edge_up_conv(x, w, plan: DownPlan):
    """k=2 s=2 up conv over the children: the CUDA kernels' wrappers on
    every edge, with the plan's groups and skip plan."""
    return UpConv.apply(x.contiguous(), w, plan)


def _conv1x1(x, w):
    """1x1 conv = plain matmul (kernel volume 1); keeps padded rows zero."""
    return matmul_f32(x, w[0].to(x.dtype)).to(x.dtype)


@dataclass(frozen=True)
class UNetArch:
    block: str  # 'basic' (expansion 1) | 'bottleneck' (expansion 4)
    layers: Tuple[int, ...]  # residual blocks per stage (8 stages)
    planes: Tuple[int, ...]  # base planes per stage (8 stages)
    init_dim: int = 32

    @property
    def expansion(self) -> int:
        return 1 if self.block == "basic" else 4


ARCHS: Dict[str, UNetArch] = {
    "MinkUNet14A": UNetArch("basic", (1,) * 8, (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet14B": UNetArch("basic", (1,) * 8, (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet14C": UNetArch("basic", (1,) * 8, (32, 64, 128, 256, 192, 192, 128, 128)),
    "MinkUNet14D": UNetArch("basic", (1,) * 8, (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet18A": UNetArch("basic", (2,) * 8, (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet18B": UNetArch("basic", (2,) * 8, (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet18D": UNetArch("basic", (2,) * 8, (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet34A": UNetArch("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 64)),
    "MinkUNet34B": UNetArch("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 32)),
    "MinkUNet34C": UNetArch("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96)),
    "MinkUNet50": UNetArch("bottleneck", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96)),
    "MinkUNet101": UNetArch("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96)),
}


def _conv_weight(k_volume: int, cin: int, cout: int,
                 generator: Optional[torch.Generator]) -> nn.Parameter:
    std = (2.0 / (k_volume * cout)) ** 0.5
    return nn.Parameter(torch.randn((k_volume, cin, cout),
                                    generator=generator) * std)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a padded buffer, output re-masked;
    see sparse/ops.py:masked_batch_norm.  Eval mode normalises with the
    running statistics; training mode with the batch's and moves the
    ``mean``/``var`` buffers towards them (momentum 0.1, unbiased variance)."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, mask, num):
        out, mean, var = masked_batch_norm(
            x, mask, num, self.gamma, self.beta, self.mean, self.var,
            train=self.training)
        if self.training:
            with torch.no_grad():
                self.mean.copy_(mean)
                self.var.copy_(var)
        return out


class Block(nn.Module):
    """One residual block.  Downsample 1x1 conv when shapes change
    (reference models/resnet_base.py:82-118; stride is always 1 here)."""

    def __init__(self, block: str, cin: int, planes: int, expansion: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.block = block
        cout = planes * expansion
        if block == "basic":
            self.conv1 = _conv_weight(27, cin, planes, generator)
            self.bn1 = MaskedBatchNorm(planes)
            self.conv2 = _conv_weight(27, planes, planes, generator)
            self.bn2 = MaskedBatchNorm(planes)
        else:
            self.conv1 = _conv_weight(1, cin, planes, generator)
            self.bn1 = MaskedBatchNorm(planes)
            self.conv2 = _conv_weight(27, planes, planes, generator)
            self.bn2 = MaskedBatchNorm(planes)
            self.conv3 = _conv_weight(1, planes, cout, generator)
            self.bn3 = MaskedBatchNorm(cout)
        if cin != cout:
            self.down = _conv_weight(1, cin, cout, generator)
            self.down_bn = MaskedBatchNorm(cout)

    def forward(self, x, plan: ConvPlan, mask, num):
        residual = x
        if self.block == "basic":
            out = relu(self.bn1(_stencil_conv(x, self.conv1, plan), mask, num))
            out = self.bn2(_stencil_conv(out, self.conv2, plan), mask, num)
        else:
            out = relu(self.bn1(_conv1x1(x, self.conv1), mask, num))
            out = relu(self.bn2(_stencil_conv(out, self.conv2, plan), mask,
                                num))
            out = self.bn3(_conv1x1(out, self.conv3), mask, num)
        if hasattr(self, "down"):
            residual = self.down_bn(_conv1x1(x, self.down), mask, num)
        return relu(out + residual)


class MinkUNet(nn.Module):
    """``forward(x, geo)`` maps (cap0, in_channels) activations on the
    geometry ``geo`` (plan arrays on x's device, see
    ``sparse.geometry_to_device``) to (cap0, out_channels) fp32 features."""

    def __init__(self, in_channels: int, out_channels: int,
                 arch: str = "MinkUNet18A",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        a = ARCHS[arch]
        g = generator
        self.conv0 = _conv_weight(125, in_channels, a.init_dim, g)
        self.bn0 = MaskedBatchNorm(a.init_dim)
        inplanes = a.init_dim

        def stage(i, cin):
            blocks = []
            for _ in range(a.layers[i]):
                blocks.append(Block(a.block, cin, a.planes[i], a.expansion, g))
                cin = a.planes[i] * a.expansion
            return nn.ModuleList(blocks), cin

        for i in range(1, 5):  # encoder: conv{i} down + block{i}
            setattr(self, f"conv{i}", _conv_weight(8, inplanes, inplanes, g))
            setattr(self, f"bn{i}", MaskedBatchNorm(inplanes))
            blocks, inplanes = stage(i - 1, inplanes)
            setattr(self, f"block{i}", blocks)

        enc_out = [a.init_dim] + [a.planes[i] * a.expansion for i in range(4)]
        for j, i in enumerate(range(4, 8)):  # decoder: convtr{i} + block{i+1}
            up_out = a.planes[i]
            setattr(self, f"convtr{i}", _conv_weight(8, inplanes, up_out, g))
            setattr(self, f"bntr{i}", MaskedBatchNorm(up_out))
            blocks, inplanes = stage(i, up_out + enc_out[3 - j])
            setattr(self, f"block{i + 1}", blocks)

        self.final = _conv_weight(1, inplanes, out_channels, g)

    def _stage(self, name, x, plan, mask, num):
        for blk in getattr(self, name):
            x = blk(x, plan, mask, num)
        return x

    def forward(self, x, geo: UNetGeometry, constant_input: bool = False,
                return_prehead: bool = False):
        """x: (cap0, in_ch) activations in the compute dtype.

        ``constant_input``: the reference's default input is the constant
        (1,1,1) feature (point_loader.py:166-169).  Then the k=5 stem reduces
        exactly to ``occupancy @ sum_cin(W)`` — one GEMM instead of 125
        gathers of 3-channel rows.  Only valid when x rows are (1,..,1) at
        valid rows, 0 at padded.  The occupancy is ``geo.stem_occ`` where
        the device builder made it, else ``geo.stem.fwd < num``.

        Returns (cap0, out_ch) fp32, or the (cap0, C) pre-head activations
        with ``return_prehead``.
        """
        dev = x.device
        masks = [valid_mask(l.num, l.cap, device=dev) for l in geo.levels]
        nums = [int(l.num) for l in geo.levels]

        if constant_input:
            # (K, cap0): built directly by the device builder, else derived
            # from the stem plan
            occ = (geo.stem_occ if geo.stem_occ is not None
                   else geo.stem.fwd < nums[0]).to(x.dtype)
            wsum = self.conv0.sum(dim=1).to(x.dtype)     # (K, Cout)
            out = matmul_f32(occ.t(), wsum).to(x.dtype)
        else:
            out = _stencil_conv(x, self.conv0, geo.stem)
        out = relu(self.bn0(out, masks[0], nums[0]))

        enc = [out]
        for i in range(1, 5):
            out = _edge_down_conv(out, getattr(self, f"conv{i}"),
                                  geo.down[i - 1])
            out = relu(getattr(self, f"bn{i}")(out, masks[i], nums[i]))
            out = self._stage(f"block{i}", out, geo.self3[i], masks[i],
                              nums[i])
            enc.append(out)

        # decoder: convtr{i} from level (8-i) down to level (7-i), skip-concat
        for j, i in enumerate(range(4, 8)):
            lvl = 3 - j
            out = _edge_up_conv(out, getattr(self, f"convtr{i}"),
                                geo.down[lvl])
            out = relu(getattr(self, f"bntr{i}")(out, masks[lvl], nums[lvl]))
            out = torch.cat([out, enc[lvl]], dim=1)
            out = self._stage(f"block{i + 1}", out, geo.self3[lvl],
                              masks[lvl], nums[lvl])

        if return_prehead:
            return out
        return self.head(out)

    def head(self, x, grad_group=None):
        """The 1x1 head on the (cap0, C) pre-head activations: (cap0, D)
        fp32, or this rank's columns when ``final`` holds a model group's
        column shard.  ``grad_group``: the input's gradient is summed over
        that group, in the fp32 of the product (``parallel/mesh.py``)."""
        xa = grad_sum(x.to(_acc_dtype(x.dtype)), grad_group)
        w = self.final[0].to(x.dtype)
        return torch.matmul(xa, w.to(xa.dtype)).to(x.dtype).float()
