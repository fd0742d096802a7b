"""Point Transformer V3 (PT-v3m1) as a distillation backbone.

Pointcept's ``PT-v3m1`` (``pointcept/models/point_transformer_v3/
point_transformer_v3m1_base.py``; Wu et al., CVPR 2024) on the port's
sparse geometry, configured as ``configs/scannet/semseg-pt-v3m1-0-base.py``
publishes it (:data:`ARCHS`):

* **Stem.**  A k=5 submanifold conv (no bias), BatchNorm, GELU.
* **Encoder.**  Five stages; each but the first opens with a pooling
  (``Linear(Cin, Cout)``, a max over the children of each parent voxel,
  BatchNorm, GELU), then its blocks.
* **Block.**  ``x += LN(Linear(SubMConv_k3(x) + b))`` (the conditional
  position encoding); ``x += DropPath(Attn(LN1(x)))``;
  ``x += DropPath(MLP(LN2(x)))``, ``MLP = Linear(C, 4C), GELU,
  Linear(4C, C)``.
* **Attn.**  ``qkv = Linear(C, 3C)``, laid out as ``(3, H, 16)``, gathered
  in the block's serialized order (``i % 4`` of the level's shuffled
  orders) into patches (``sparse/serialize.py``), attention within each
  patch (``sparse/patch_attn.py``: the CUDA kernels on the card), scattered
  back and projected by ``Linear(C, C)``.
* **Decoder.**  Four stages from the coarsest up; each opens with an
  unpooling (``proj(coarse)[parent] + proj_skip(skip)``, each proj
  ``Linear``, BatchNorm, GELU), then its blocks.
* **Head.**  ``final``: a bias-free 1x1 projection to the distillation
  width, applied by :meth:`head` (the cosine loss takes the pre-head
  features, as it does :class:`.sparse_unet.MinkUNet`'s).

BatchNorm is the port's masked BatchNorm (``eps`` 1e-3, momentum 0.01: on
the card the kernels of ``sparse/batch_norm.py``), LayerNorm ``eps`` 1e-5,
GELU exact.  Rows past a level's ``num`` are zero at every block's input
and output (the stencil conv reads the null row); the pooling's max runs
over a parent's existing children (the edge plan's ``fwd``).

Randomness, reproducible from ``seed`` alone:

* each training forward draws the permutation of the four orders of each
  level from its own generator (seeded with ``seed``), recorded in
  :attr:`PTv3.last_orders`; a level's orders are the finer level's,
  permuted again (Pointcept's ``shuffle_orders`` at serialization and at
  each pooling).  Eval keeps the published order;
* DropPath keeps a row with a hash of ``(seed, step, site, the row's
  voxel coordinates)`` (:func:`keep_rows`), ``site`` the drop path's place
  in the forward (2 per block), ``step`` the trainer's update count.

Parameter names follow Pointcept's modules (``enc2.blocks.0.attn.qkv.weight``,
``dec0.unpool.bn_skip.gamma``); conv kernels keep the port's (K, Cin, Cout)
layout, Linear weights torch's (Cout, Cin).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import grad_sum
from ..sparse.ops import _acc_dtype, conv1x1, valid_mask
from ..sparse.patch_attn import HEAD_DIM, PatchAttention
from .sparse_unet import MaskedBatchNorm, _conv_weight, _stencil_conv


@dataclass(frozen=True)
class PTv3Arch:
    enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 2)
    enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    enc_num_head: Tuple[int, ...] = (2, 4, 8, 16, 32)
    dec_depths: Tuple[int, ...] = (2, 2, 2, 2)
    dec_channels: Tuple[int, ...] = (64, 64, 128, 256)
    dec_num_head: Tuple[int, ...] = (4, 4, 8, 16)
    patch_size: int = 1024
    mlp_ratio: int = 4
    drop_path: float = 0.3
    stem_kernel: int = 5
    bn_eps: float = 1e-3
    bn_momentum: float = 0.01
    ln_eps: float = 1e-5

    def enc_drop_path(self) -> List[float]:
        return torch.linspace(0, self.drop_path,
                              sum(self.enc_depths)).tolist()

    def dec_drop_path(self, s: int) -> List[float]:
        """Decoder stage ``s``'s rates: its slice of ``linspace(0, rate,
        sum(dec_depths))``, reversed."""
        rates = torch.linspace(0, self.drop_path,
                               sum(self.dec_depths)).tolist()
        lo = sum(self.dec_depths[:s])
        return rates[lo:lo + self.dec_depths[s]][::-1]


ARCHS: Dict[str, PTv3Arch] = {"PTv3m1": PTv3Arch()}
N_ORDERS = 4


def serial_patch(arch_3d: str) -> Optional[int]:
    """The patch size a geometry build serializes for ``arch_3d``, None
    for an architecture that reads no serialization."""
    a = ARCHS.get(arch_3d)
    return None if a is None else a.patch_size


# -- DropPath's counter hash (32-bit words in int64 arithmetic) ------------

M32 = 0xFFFFFFFF


def mix32(x):
    """A 32-bit integer mixer of ints or int64 tensors in [0, 2^32): every
    product stays below 2^63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & M32
    return x ^ (x >> 16)


def drop_key(seed: int, step: int, site: int) -> int:
    h = mix32(int(seed) & M32)
    h = mix32(h ^ ((int(seed) >> 32) & M32))
    h = mix32(h ^ (int(step) & M32))
    return mix32(h ^ (int(site) & M32))


def keep_rows(coords: torch.Tensor, key: int, rate: float) -> torch.Tensor:
    """(rows,) bool: DropPath's keep mask of a level's rows, from each
    row's (scene, x, y, z) and ``key`` (:func:`drop_key`); a row is kept
    with probability ``1 - rate``."""
    c = coords.to(torch.int64)
    k = ((c[:, 0] * 65536 + c[:, 1]) * 65536 + c[:, 2]) * 65536 + c[:, 3]
    h = mix32((k & M32) ^ key)
    h = mix32(h ^ ((k >> 32) & M32))
    return h < int(round((1.0 - rate) * 2 ** 32))


# -- modules -----------------------------------------------------------------


class Linear(nn.Module):
    """``x @ W^T + b`` with the fp32 parameters cast to x's dtype; ``W``
    drawn at the scale of torch's default (``kaiming_uniform_(a=5**0.5)``:
    std ``(3 Cin)^-1/2``), ``b`` zero."""

    def __init__(self, cin: int, cout: int, generator, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn((cout, cin), generator=generator) * (3 * cin) ** -0.5)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class LayerNorm(nn.Module):
    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[1],), self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class Level:
    """What a level's layers read: its plans, serialization, valid-row
    mask and count, the orders of its blocks and its DropPath keys."""

    def __init__(self, geo, lvl: int, serial, orders: Sequence[int],
                 dtype, keys):
        lv = geo.levels[lvl]
        self.num = int(lv.num)
        self.coords, self.plan, self.serial = lv.coords, geo.self3[lvl], \
            serial
        self.mask = valid_mask(self.num, lv.coords.shape[0],
                               device=lv.coords.device)
        self.rows = self.mask.to(dtype)
        self.orders, self.keys = orders, keys


class Attention(nn.Module):
    def __init__(self, c: int, heads: int, patch: int, generator):
        super().__init__()
        self.heads, self.patch = heads, patch
        self.scale = HEAD_DIM ** -0.5
        self.qkv = Linear(c, 3 * c, generator)
        self.proj = Linear(c, c, generator)

    def forward(self, x, level: Level, order: int):
        ser = level.serial
        qkv = self.qkv(x).index_select(0, ser.gather[order])
        out = PatchAttention.apply(qkv, ser.cu_seqlens, self.heads,
                                   self.scale, self.patch)
        return self.proj(out.index_select(0, ser.scatter[order]))


class Block(nn.Module):
    def __init__(self, c: int, heads: int, a: PTv3Arch, rate: float,
                 generator):
        super().__init__()
        self.rate = rate
        self.cpe_conv = _conv_weight(27, c, c, generator)
        self.cpe_bias = nn.Parameter(torch.zeros(c))
        self.cpe_linear = Linear(c, c, generator)
        self.cpe_norm = LayerNorm(c, a.ln_eps)
        self.norm1 = LayerNorm(c, a.ln_eps)
        self.attn = Attention(c, heads, a.patch_size, generator)
        self.norm2 = LayerNorm(c, a.ln_eps)
        self.fc1 = Linear(c, a.mlp_ratio * c, generator)
        self.fc2 = Linear(a.mlp_ratio * c, c, generator)

    def _drop(self, h, level: Level, site: int):
        if not self.training or self.rate <= 0.0:
            return h
        keep = keep_rows(level.coords, level.keys(site), self.rate)
        return h * (keep.to(h.dtype) / (1.0 - self.rate))[:, None]

    def forward(self, x, level: Level, order: int, site: int):
        cpe = _stencil_conv(x, self.cpe_conv, level.plan) \
            + self.cpe_bias.to(x.dtype)
        x = x + self.cpe_norm(self.cpe_linear(cpe))
        x = x + self._drop(self.attn(self.norm1(x), level, order), level,
                           site)
        h = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        x = x + self._drop(h, level, site + 1)
        return x * level.rows


class Pooling(nn.Module):
    """Stride-2 pooling over the edge plan of the finer level."""

    def __init__(self, cin: int, cout: int, a: PTv3Arch, generator):
        super().__init__()
        self.proj = Linear(cin, cout, generator)
        self.bn = MaskedBatchNorm(cout, a.bn_eps, a.bn_momentum)

    def forward(self, x, plan, fine: Level, coarse: Level):
        y = self.proj(x)
        fwd = plan.fwd.to(torch.int64)                   # (8, parent cap)
        kids = y.index_select(0, fwd.reshape(-1)).view(
            *fwd.shape, y.shape[1])
        kids = torch.where((fwd < fine.num)[..., None], kids,
                           torch.full((), float("-inf"), dtype=y.dtype,
                                      device=y.device))
        top = torch.where(coarse.mask > 0, kids.amax(0),
                          torch.zeros((), dtype=y.dtype, device=y.device))
        return F.gelu(self.bn(top, coarse.mask, coarse.num))


class _ToChildren(torch.autograd.Function):
    """``x[child_parent]`` whose backward sums each parent's children
    over the edge plan's ``fwd`` in fp32 (fp64 for fp64), a fixed order."""

    @staticmethod
    def forward(ctx, x, plan, child_num: int):
        ctx.plan, ctx.child_num = plan, child_num
        return x.index_select(0, plan.child_parent.to(torch.int64))

    @staticmethod
    def backward(ctx, g):
        fwd = ctx.plan.fwd.to(torch.int64)
        acc = _acc_dtype(g.dtype)
        dx = torch.zeros((fwd.shape[1], g.shape[1]), dtype=acc,
                         device=g.device)
        for k in range(fwd.shape[0]):
            gk = g.index_select(0, fwd[k]).to(acc)
            dx += torch.where((fwd[k] < ctx.child_num)[:, None], gk,
                              torch.zeros((), dtype=acc, device=g.device))
        return dx.to(g.dtype), None, None


class Unpooling(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int, a: PTv3Arch,
                 generator):
        super().__init__()
        self.proj = Linear(cin, cout, generator)
        self.bn = MaskedBatchNorm(cout, a.bn_eps, a.bn_momentum)
        self.proj_skip = Linear(cskip, cout, generator)
        self.bn_skip = MaskedBatchNorm(cout, a.bn_eps, a.bn_momentum)

    def forward(self, x, skip, plan, fine: Level, coarse: Level):
        up = F.gelu(self.bn(self.proj(x), coarse.mask, coarse.num))
        s = F.gelu(self.bn_skip(self.proj_skip(skip), fine.mask, fine.num))
        return s + _ToChildren.apply(up, plan, fine.num)


class Stage(nn.Module):
    """A stage's blocks after its pooling (``pool``) or unpooling
    (``unpool``); ``first_site``: its first block's DropPath site."""

    def __init__(self, blocks: List[Block], first_site: int,
                 pool: Optional[Pooling] = None,
                 unpool: Optional[Unpooling] = None):
        super().__init__()
        self.pool, self.unpool = pool, unpool
        self.blocks = nn.ModuleList(blocks)
        self.first_site = first_site

    def run_blocks(self, x, level: Level):
        for i, blk in enumerate(self.blocks):
            x = blk(x, level, level.orders[i % N_ORDERS],
                    self.first_site + 2 * i)
        return x


class PTv3(nn.Module):
    """``forward(x, geo)`` maps (cap0, in_channels) activations on the
    geometry ``geo`` to (cap0, out_channels) fp32 features, or the
    pre-head features with ``return_prehead``.  ``geo.serial`` must hold
    the serialization: the geometry route builds it for this architecture,
    on the card or with the host plans (``runtime/geometry_route.py``,
    ``sparse.geometry.geometry_to_device(..., patch)``)."""

    takes_step = True  # the trainer hands ``step`` to the forward

    def __init__(self, in_channels: int, out_channels: int,
                 arch="PTv3m1", generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        super().__init__()
        a = ARCHS[arch] if isinstance(arch, str) else arch
        self.arch, self.seed = a, int(seed)
        g = generator
        c0 = a.enc_channels[0]
        self.conv0 = _conv_weight(a.stem_kernel ** 3, in_channels, c0, g)
        self.bn0 = MaskedBatchNorm(c0, a.bn_eps, a.bn_momentum)
        enc_rates, site = a.enc_drop_path(), 0
        for s, (depth, c, h) in enumerate(zip(a.enc_depths, a.enc_channels,
                                             a.enc_num_head)):
            first = sum(a.enc_depths[:s])
            blocks = [Block(c, h, a, enc_rates[first + i], g)
                      for i in range(depth)]
            pool = (Pooling(a.enc_channels[s - 1], c, a, g) if s else None)
            setattr(self, f"enc{s}", Stage(blocks, site, pool=pool))
            site += 2 * depth
        dec_in = list(a.dec_channels) + [a.enc_channels[-1]]
        for s in reversed(range(len(a.dec_depths))):
            c, h = a.dec_channels[s], a.dec_num_head[s]
            rates = a.dec_drop_path(s)
            blocks = [Block(c, h, a, rates[i], g)
                      for i in range(a.dec_depths[s])]
            unpool = Unpooling(dec_in[s + 1], a.enc_channels[s], c, a, g)
            setattr(self, f"dec{s}", Stage(blocks, site, unpool=unpool))
            site += 2 * a.dec_depths[s]
        self.final = _conv_weight(1, a.dec_channels[0], out_channels, g)
        self._orders = torch.Generator().manual_seed(self.seed)
        self.last_orders: Optional[List[List[int]]] = None

    def level_orders(self) -> List[List[int]]:
        """Each level's four orders (indices into ``serialize.ORDERS``):
        in training each level's a fresh permutation of the finer
        level's (recorded in ``last_orders``); in eval the published
        order."""
        n = len(self.arch.enc_depths)
        if not self.training:
            return [list(range(N_ORDERS))] * n
        perms = [torch.randperm(N_ORDERS, generator=self._orders).tolist()
                 for _ in range(n)]
        self.last_orders = perms
        out, cur = [], list(range(N_ORDERS))
        for p in perms:
            cur = [cur[i] for i in p]
            out.append(cur)
        return out

    def forward(self, x, geo, constant_input: bool = False,
                return_prehead: bool = False, step: int = 0):
        """x: (cap0, in_ch) activations in the compute dtype (rows past
        ``num`` zero); ``constant_input``: the rows are (1, .., 1), and the
        stem is the occupancy GEMM (``MinkUNet.forward``); ``step``: the
        trainer's update count, which keys DropPath's masks."""
        if len(geo.serial) != len(geo.levels):
            raise ValueError(
                "PTv3 needs the geometry's serialization (geo.serial): "
                "build the geometry through the geometry route, or upload "
                "host plans with geometry_to_device(geo, device, "
                f"patch={self.arch.patch_size})")
        orders = self.level_orders()

        def keys(site):
            return drop_key(self.seed, step, site)

        levels = [Level(geo, l, geo.serial[l], orders[l], x.dtype, keys)
                  for l in range(len(geo.levels))]
        l0 = levels[0]
        if constant_input:
            occ = (geo.stem_occ if geo.stem_occ is not None
                   else geo.stem.fwd < l0.num).to(x.dtype)
            out = conv1x1(occ.t(), self.conv0.sum(dim=1))
        else:
            out = _stencil_conv(x, self.conv0, geo.stem)
        out = F.gelu(self.bn0(out, l0.mask, l0.num))

        skips = []
        for s in range(len(self.arch.enc_depths)):
            stage = getattr(self, f"enc{s}")
            if s:
                skips.append(out)
                out = stage.pool(out, geo.down[s - 1], levels[s - 1],
                                  levels[s])
            out = stage.run_blocks(out, levels[s])
        for s in reversed(range(len(self.arch.dec_depths))):
            stage = getattr(self, f"dec{s}")
            out = stage.unpool(out, skips[s], geo.down[s], levels[s],
                              levels[s + 1])
            out = stage.run_blocks(out, levels[s])
        if return_prehead:
            return out
        return self.head(out)

    def head(self, x, grad_group=None):
        """``MinkUNet.head``: the bias-free 1x1 projection ``final``."""
        xa = grad_sum(x.to(_acc_dtype(x.dtype)), grad_group)
        w = self.final[0].to(x.dtype)
        return torch.matmul(xa, w.to(xa.dtype)).to(x.dtype).float()
