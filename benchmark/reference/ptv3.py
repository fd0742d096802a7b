"""Plain Point Transformer V3 (PT-v3m1) and its distill train steps, in
float32 with TF32 off.

Follows Pointcept's ``pointcept/models/point_transformer_v3/
point_transformer_v3m1_base.py`` and ``pointcept/models/utils/
serialization/`` as ``configs/scannet/semseg-pt-v3m1-0-base.py``
configures them (:data:`ARCHS`): a k=5 submanifold stem with BatchNorm and
GELU; five encoder stages (a stride-2 serialized pooling before each but
the first) and four decoder stages (a serialized unpooling before each) of
blocks ``x += LN(Linear(SubMConv_k3(x)))``, ``x += DropPath(Attn(LN1(x)))``,
``x += DropPath(MLP(LN2(x)))``; patch attention of 1024 points in four
shuffled space-filling-curve orders.  Serialization, padding and
attention are written here from those definitions:

* codes ``scene << 3 depth | curve(grid)``, ``depth = bit_length(max grid
  + 1)``: ``z`` by interleaving the bits (x the most significant of each
  triple, Pointcept's ``xyz2key``), ``hilbert`` by Skilling's transform on
  the bit planes and a Gray decode of the interleaved bits (Pointcept's
  ``hilbert.encode``), the ``-trans`` orders with x and y swapped;
* a pooled level's codes are a child's codes shifted right by 3, its
  orders permuted again by that level's shuffle;
* ``get_padding_and_inverse``: the scene loop as Pointcept writes it;
* attention one chunk of patches at a time (:class:`_PatchAttention`,
  which keeps q, k, v and the log-sum-exp and recomputes the scores in
  its backward: the memory of a 1M-voxel batch).

The convolutions, 1x1 products, ``quant`` and BatchNorm are
``minkunet.py``'s (BatchNorm ``eps`` 1e-3; running statistics not kept),
the neighbour search ``geometry.py``'s.  Departures from Pointcept, each
for a reason:

* The program trains in bf16 with its own attention kernel; Pointcept in
  fp16 with flash attention.  This reference is float32.
* The grid coordinate is the voxel coordinate after OpenScene's random
  global shift (non-negative), not each scene's coordinate less its
  minimum: the pooled levels are then the program's parent voxels.
* Three constant input channels (OpenScene's ``input_color: false``); no
  SphereCrop; a bias-free head ``final`` to the distillation width, as
  the MinkUNets'.
* The orders' shuffles are the program's draws, handed in (``orders``:
  per level a permutation of the finer level's four); DropPath keeps a
  row by a hash of ``(seed, step, site, voxel)`` (:func:`keep_rows`, the
  program's rule) instead of ``torch.bernoulli``.
* The pooling's max hands a gradient to every child that ties for it, in
  equal shares (``scatter_reduce``'s rule; ``torch_scatter``'s
  ``segment_csr`` gives it to one).
* ``checkpoint`` recomputes each block in the backward
  (``torch.utils.checkpoint``), as ``bottleneck.py`` does.

:func:`train_steps` is ``bottleneck.train_steps`` (cosine loss, Adam at
``10 * base_lr`` times the poly factor) on this forward.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

from . import geometry, minkunet
from .minkunet import Quant, batch_norm, conv, identity
from .train import cosine_loss

ARCHS = {
    "PTv3m1": {"enc_depths": [2, 2, 2, 6, 2],
               "enc_channels": [32, 64, 128, 256, 512],
               "enc_num_head": [2, 4, 8, 16, 32],
               "dec_depths": [2, 2, 2, 2],
               "dec_channels": [64, 64, 128, 256],
               "dec_num_head": [4, 4, 8, 16],
               "patch_size": 1024, "mlp_ratio": 4, "drop_path": 0.3,
               "stem_kernel": 5},
}
BN_EPS, LN_EPS = 1e-3, 1e-5
HEAD_DIM = 16
CHUNK_SCORES = 1 << 27   # score elements of one chunk of patches


# -- parameters ----------------------------------------------------------------


def param_shapes(a: dict, in_ch: int, out_ch: int) -> Dict[str, tuple]:
    """Name -> shape of every parameter and BatchNorm buffer, named as the
    program's ``state_dict``: conv kernels (K, Cin, Cout), Linear weights
    (Cout, Cin)."""
    shapes: Dict[str, tuple] = {}

    def bn(name, c):
        for s in ("gamma", "beta", "mean", "var"):
            shapes[f"{name}.{s}"] = (c,)

    def lin(name, cin, cout):
        shapes[name + ".weight"] = (cout, cin)
        shapes[name + ".bias"] = (cout,)

    def ln(name, c):
        shapes[name + ".weight"] = (c,)
        shapes[name + ".bias"] = (c,)

    def blocks(pre, n, c):
        h = a["mlp_ratio"] * c
        for i in range(n):
            b = f"{pre}.blocks.{i}"
            shapes[b + ".cpe_conv"] = (27, c, c)
            shapes[b + ".cpe_bias"] = (c,)
            lin(b + ".cpe_linear", c, c)
            ln(b + ".cpe_norm", c)
            ln(b + ".norm1", c)
            lin(b + ".attn.qkv", c, 3 * c)
            lin(b + ".attn.proj", c, c)
            ln(b + ".norm2", c)
            lin(b + ".fc1", c, h)
            lin(b + ".fc2", h, c)

    enc, dec = a["enc_channels"], a["dec_channels"]
    shapes["conv0"] = (a["stem_kernel"] ** 3, in_ch, enc[0])
    shapes["final"] = (1, dec[0], out_ch)
    bn("bn0", enc[0])
    for s, n in enumerate(a["enc_depths"]):
        if s:
            lin(f"enc{s}.pool.proj", enc[s - 1], enc[s])
            bn(f"enc{s}.pool.bn", enc[s])
        blocks(f"enc{s}", n, enc[s])
    dec_in = list(dec) + [enc[-1]]
    for s in reversed(range(len(a["dec_depths"]))):
        lin(f"dec{s}.unpool.proj", dec_in[s + 1], dec[s])
        bn(f"dec{s}.unpool.bn", dec[s])
        lin(f"dec{s}.unpool.proj_skip", enc[s], dec[s])
        bn(f"dec{s}.unpool.bn_skip", dec[s])
        blocks(f"dec{s}", a["dec_depths"][s], dec[s])
    return shapes


def make_weights(a: dict, in_ch: int, out_ch: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Weights from ``seed`` on ``device``, in one normal draw in
    :func:`param_shapes`' order: conv kernels He-normal (std sqrt(2 / (K
    Cout))), Linear weights at torch's default scale (std (3 Cin)^-1/2);
    biases 0; LayerNorm 1 / 0; BatchNorm gamma 1, beta 0, running mean 0,
    variance 1; float32."""
    shapes = param_shapes(a, in_ch, out_ch)
    drawn = [k for k, s in shapes.items()
             if len(s) == 3 or k.endswith(".weight") and len(s) == 2]
    total = sum(int(torch.Size(shapes[k]).numel()) for k in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if k in drawn:
            n = int(torch.Size(s).numel())
            std = ((2.0 / (s[0] * s[2])) ** 0.5 if len(s) == 3
                   else (3.0 * s[1]) ** -0.5)
            out[k] = flat[at:at + n].view(s) * std
            at += n
        elif k.endswith((".gamma", ".var")) or (
                k.endswith(".weight") and len(s) == 1):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


# -- serialization ---------------------------------------------------------


def z_order(x, y, z, depth: int) -> torch.Tensor:
    key = torch.zeros_like(x)
    for i in range(depth):
        key = key | (((x >> i) & 1) << (3 * i + 2)) \
            | (((y >> i) & 1) << (3 * i + 1)) | (((z >> i) & 1) << (3 * i))
    return key


def hilbert(x, y, z, depth: int) -> torch.Tensor:
    """Skilling's transform on the (N, 3, depth) bit planes, most
    significant first, then the interleaved bits Gray-decoded."""
    locs = torch.stack([x, y, z], 1)
    shifts = torch.arange(depth - 1, -1, -1, device=x.device)
    bits = ((locs[:, :, None] >> shifts) & 1).bool()     # (N, 3, depth)
    for b in range(depth):
        for d in range(3):
            on = bits[:, d, b].clone()
            low0 = bits[:, 0, b + 1:] ^ on[:, None]
            bits[:, 0, b + 1:] = low0
            flip = ~on[:, None] & (bits[:, 0, b + 1:] ^ bits[:, d, b + 1:])
            bits[:, d, b + 1:] ^= flip
            bits[:, 0, b + 1:] ^= flip
    gray = bits.transpose(1, 2).reshape(len(x), 3 * depth).long()
    binary = torch.cumsum(gray, 1) % 2          # prefix xor
    weights = 1 << torch.arange(3 * depth - 1, -1, -1, device=x.device)
    return (binary * weights).sum(1)


def codes_of(coords: torch.Tensor, depth: int) -> torch.Tensor:
    """(4, N) codes of (N, 4) level-0 coordinates in the orders ``z``,
    ``z-trans``, ``hilbert``, ``hilbert-trans``."""
    b, x, y, z = coords.long().unbind(1)
    curves = [z_order(x, y, z, depth), z_order(y, x, z, depth),
              hilbert(x, y, z, depth), hilbert(y, x, z, depth)]
    return torch.stack([(b << 3 * depth) | c for c in curves])


def padding_and_inverse(offset: List[int], patch: int, device):
    """Pointcept's ``get_padding_and_inverse`` (flash attention's fixed
    patch size) on scene end offsets ``offset``: ``(pad, unpad,
    cu_seqlens)``."""
    offset = torch.tensor(offset, device=device)
    bincount = torch.diff(offset, prepend=offset.new_zeros(1))
    bincount_pad = torch.div(bincount + patch - 1, patch,
                             rounding_mode="trunc") * patch
    mask_pad = bincount > patch
    bincount_pad = ~mask_pad * bincount + mask_pad * bincount_pad
    _offset = F.pad(offset, (1, 0))
    _offset_pad = F.pad(torch.cumsum(bincount_pad, dim=0), (1, 0))
    pad = torch.arange(int(_offset_pad[-1]), device=device)
    unpad = torch.arange(int(_offset[-1]), device=device)
    cu_seqlens = []
    for i in range(len(offset)):
        unpad[_offset[i]:_offset[i + 1]] += _offset_pad[i] - _offset[i]
        if bincount[i] != bincount_pad[i]:
            r = int(bincount[i] % patch)
            e = int(_offset_pad[i + 1])
            pad[e - patch + r:e] = pad[e - 2 * patch + r:e - patch]
        pad[_offset_pad[i]:_offset_pad[i + 1]] -= _offset_pad[i] - _offset[i]
        cu_seqlens.append(torch.arange(int(_offset_pad[i]),
                                       int(_offset_pad[i + 1]), patch,
                                       device=device))
    cu = F.pad(torch.cat(cu_seqlens), (0, 1), value=int(_offset_pad[-1]))
    return pad, unpad, cu


class LevelOrders:
    """A level's four orders and inverses (in its shuffled list) and its
    patch layout."""

    def __init__(self, codes: torch.Tensor, scenes: torch.Tensor,
                 patch: int):
        self.codes = codes
        self.order = torch.argsort(codes, dim=1, stable=True)
        self.inverse = torch.argsort(self.order, dim=1)
        counts = torch.bincount(scenes)
        offset = torch.cumsum(counts[counts > 0], 0).tolist()
        self.pad, self.unpad, self.cu = padding_and_inverse(
            offset, patch, codes.device)


def serialize(levels, edges, orders: Sequence[Sequence[int]],
              patch: int) -> List[LevelOrders]:
    """Every level's :class:`LevelOrders`: level 0's codes at the batch's
    depth, permuted by ``orders[0]``; each coarser level's a child's
    codes shifted right by 3, permuted by its own ``orders[l]``."""
    c0 = levels[0].coords
    depth = int(int(c0[:, 1:].max()) + 1).bit_length()
    codes = codes_of(c0, depth)[list(orders[0])]
    out = [LevelOrders(codes, c0[:, 0], patch)]
    for lvl in range(1, len(levels)):
        parent, _ = edges[lvl - 1]
        n = levels[lvl].coords.shape[0]
        up = torch.empty((4, n), dtype=codes.dtype, device=codes.device)
        up[:, parent] = codes >> 3
        codes = up[list(orders[lvl])]
        out.append(LevelOrders(codes, levels[lvl].coords[:, 0], patch))
    return out


# -- DropPath's hash (the program's rule, written out again) -----------------

M32 = 0xFFFFFFFF


def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & M32
    return x ^ (x >> 16)


def drop_key(seed: int, step: int, site: int) -> int:
    h = _mix32(int(seed) & M32)
    h = _mix32(h ^ ((int(seed) >> 32) & M32))
    h = _mix32(h ^ (int(step) & M32))
    return _mix32(h ^ (int(site) & M32))


def keep_rows(coords: torch.Tensor, key: int, rate: float) -> torch.Tensor:
    c = coords.long()
    k = ((c[:, 0] * 65536 + c[:, 1]) * 65536 + c[:, 2]) * 65536 + c[:, 3]
    h = _mix32(_mix32((k & M32) ^ key) ^ ((k >> 32) & M32))
    return h < int(round((1.0 - rate) * 2 ** 32))


# -- layers ------------------------------------------------------------------


def lin(p, name: str, x, quant: Quant = identity):
    return minkunet.linear(x, p[name + ".weight"].t()[None], quant) \
        + p[name + ".bias"]


def layer_norm(p, name: str, x):
    return F.layer_norm(x, (x.shape[1],), p[name + ".weight"],
                        p[name + ".bias"], LN_EPS)


class _PatchAttention(torch.autograd.Function):
    """Softmax attention within each patch of ``cu`` over ``qkv`` (rows,
    3C) laid out (3, H, 16); patches of one length run as a batch, a chunk
    at a time.  Keeps q, k, v, the output and the log-sum-exp; the
    backward recomputes the scores."""

    @staticmethod
    def forward(ctx, qkv, cu, heads: int, quant: Quant):
        rows = qkv.shape[0]
        q, k, v = (quant(t) for t in qkv.view(rows, 3, heads, HEAD_DIM)
                   .unbind(1))
        out = torch.zeros_like(q)
        lse = q.new_zeros((rows, heads))
        for idx in _chunks(cu, heads):
            s = torch.einsum("pqhd,pkhd->phqk", q[idx], k[idx]) \
                * HEAD_DIM ** -0.5
            lse[idx] = torch.logsumexp(s, -1).transpose(1, 2)
            pr = quant(torch.softmax(s, -1))
            out[idx] = torch.einsum("phqk,pkhd->pqhd", pr, v[idx])
        ctx.save_for_backward(q, k, v, out, lse, cu)
        ctx.heads, ctx.quant = heads, quant
        return out.reshape(rows, heads * HEAD_DIM)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, cu = ctx.saved_tensors
        quant = ctx.quant
        rows = q.shape[0]
        do = quant(g.reshape(out.shape))
        delta = (do * out).sum(-1)
        dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
        scale = HEAD_DIM ** -0.5
        for idx in _chunks(cu, ctx.heads):
            s = torch.einsum("pqhd,pkhd->phqk", q[idx], k[idx]) * scale
            pr = torch.exp(s - lse[idx].transpose(1, 2)[..., None])
            dv[idx] = torch.einsum("phqk,pqhd->pkhd", quant(pr), do[idx])
            dp = torch.einsum("pqhd,pkhd->phqk", do[idx], v[idx])
            ds = quant(pr * (dp - delta[idx].transpose(1, 2)[..., None]))
            dq[idx] = torch.einsum("phqk,pkhd->pqhd", ds, k[idx]) * scale
            dk[idx] = torch.einsum("phqk,pqhd->pkhd", ds, q[idx]) * scale
        return (torch.stack([dq, dk, dv], 1).reshape(rows, -1), None, None,
                None)


def _chunks(cu: torch.Tensor, heads: int):
    """(patches, length) row indices of the patches of ``cu``, those of
    one length together, at most ``CHUNK_SCORES`` scores a chunk."""
    starts, ends = cu[:-1], cu[1:]
    lengths = ends - starts
    for n in torch.unique(lengths).tolist():
        if n == 0:
            continue
        sel = starts[lengths == n]
        step = max(1, CHUNK_SCORES // (heads * n * n))
        for i in range(0, len(sel), step):
            s = sel[i:i + step]
            yield s[:, None] + torch.arange(n, device=cu.device)


def attention(p, pre: str, x, lv: LevelOrders, order: int, heads: int,
              quant: Quant):
    qkv = lin(p, pre + ".qkv", x, quant)
    idx = lv.order[order][lv.pad]
    feat = _PatchAttention.apply(qkv[idx], lv.cu, heads, quant)
    feat = feat[lv.unpad[lv.inverse[order]]]
    return lin(p, pre + ".proj", feat, quant)


def forward(p: Dict[str, torch.Tensor], a: dict, coords: torch.Tensor,
            x: torch.Tensor, orders: Sequence[Sequence[int]], step: int,
            seed: int, train: bool = True, quant: Quant = identity,
            checkpoint: bool = False) -> torch.Tensor:
    """(N0, in_ch) features on the voxels ``coords`` (N0, 4) ->
    (N0, out_ch) float32; ``orders``: each level's shuffle, ``step`` and
    ``seed``: DropPath's keys (training only)."""
    levels, edges = geometry.pyramid(coords)
    stem = geometry.stencil_pairs(levels[0], a["stem_kernel"])
    self3 = [geometry.stencil_pairs(lv, 3) for lv in levels]
    ser = serialize(levels, edges, orders, a["patch_size"])
    enc_rates = torch.linspace(0, a["drop_path"],
                               sum(a["enc_depths"])).tolist()
    dec_all = torch.linspace(0, a["drop_path"],
                             sum(a["dec_depths"])).tolist()

    def block(pre, x, lvl, i, heads, rate, site):
        lc = levels[lvl].coords

        def drop(h, s):
            if not train or rate <= 0.0:
                return h
            keep = keep_rows(lc, drop_key(seed, step, s), rate)
            return h * (keep.to(h.dtype) / (1.0 - rate))[:, None]

        cpe = conv(x, p[pre + ".cpe_conv"], self3[lvl], quant) \
            + p[pre + ".cpe_bias"]
        x = x + layer_norm(p, pre + ".cpe_norm",
                           lin(p, pre + ".cpe_linear", cpe, quant))
        h = attention(p, pre + ".attn", layer_norm(p, pre + ".norm1", x),
                      ser[lvl], i % 4, heads, quant)
        x = x + drop(h, site)
        h = lin(p, pre + ".fc2", F.gelu(lin(
            p, pre + ".fc1", layer_norm(p, pre + ".norm2", x), quant)),
            quant)
        return x + drop(h, site + 1)

    def stage(pre, x, lvl, n, heads, rates, site):
        for i in range(n):
            args = (f"{pre}.blocks.{i}", x, lvl, i, heads, rates[i],
                    site + 2 * i)
            if checkpoint and torch.is_grad_enabled():
                x = _checkpoint(block, *args, use_reentrant=False)
            else:
                x = block(*args)
        return x

    def bn_gelu(x, name):
        return F.gelu(batch_norm(x, p, name, train, eps=BN_EPS))

    out = bn_gelu(conv(x, p["conv0"], stem, quant), "bn0")
    skips, site = [], 0
    for s, n in enumerate(a["enc_depths"]):
        if s:
            skips.append(out)
            parent, _ = edges[s - 1]
            y = lin(p, f"enc{s}.pool.proj", out, quant)
            top = y.new_full((levels[s].coords.shape[0], y.shape[1]),
                             float("-inf"))
            top = top.scatter_reduce(0, parent[:, None].expand_as(y), y,
                                     "amax", include_self=True)
            out = bn_gelu(top, f"enc{s}.pool.bn")
        first = sum(a["enc_depths"][:s])
        out = stage(f"enc{s}", out, s, n, a["enc_num_head"][s],
                    enc_rates[first:first + n], site)
        site += 2 * n
    for s in reversed(range(len(a["dec_depths"]))):
        parent, _ = edges[s]
        up = bn_gelu(lin(p, f"dec{s}.unpool.proj", out, quant),
                     f"dec{s}.unpool.bn")
        out = bn_gelu(lin(p, f"dec{s}.unpool.proj_skip", skips[s], quant),
                      f"dec{s}.unpool.bn_skip") + up[parent]
        n = a["dec_depths"][s]
        lo = sum(a["dec_depths"][:s])
        out = stage(f"dec{s}", out, s, n, a["dec_num_head"][s],
                    dec_all[lo:lo + n][::-1], site)
        site += 2 * n
    return minkunet.linear(out, p["final"], quant)


def train_steps(p0: Dict[str, torch.Tensor], batches: Sequence, cfg: dict,
                max_iter: int, orders: Sequence, seed: int,
                quant: Quant = identity, drop_half: bool = False,
                checkpoint: bool = True) -> dict:
    """Distill ``len(batches)`` steps from ``p0``; a batch is ``(coords
    (N, 4), target (N, D), mask (N,))``, ``orders[i]`` step ``i``'s
    shuffles.  Returns ``bottleneck.train_steps``' readings: the losses,
    the first step's head output (on the host), each leaf's norm of the
    first step's gradient and of the change after the last step."""
    a = ARCHS[cfg["arch_3d"]]
    names = [k for k in p0 if minkunet.trainable(k)]
    p = {k: v.clone() for k, v in p0.items()}
    state: Dict[str, tuple] = {}
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    for it, (coords, target, mask) in enumerate(batches):
        if drop_half:
            keep = coords.shape[0] // 2
            coords, target, mask = coords[:keep], target[:keep], mask[:keep]
        leaves = [p[k].requires_grad_(True) for k in names]
        x = torch.ones((coords.shape[0], 3), dtype=p["conv0"].dtype,
                       device=coords.device)
        out = forward(p, a, coords, x, orders[it], it, seed, train=True,
                      quant=quant, checkpoint=checkpoint)
        loss = cosine_loss(out, target.float(), mask)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if it == 0:
            out1 = out.detach().cpu()
        del out, loss
        poly = max(1.0 - it / max_iter, 0.0) ** cfg["power"]
        lr = cfg["base_lr"] * 10.0 * poly
        t = it + 1
        with torch.no_grad():
            for k, g in zip(names, grads):
                if it == 0:
                    grad1[k] = float(g.norm())
                m, v = state.get(k, (torch.zeros_like(g),
                                     torch.zeros_like(g)))
                m = 0.9 * m + 0.1 * g
                v = 0.999 * v + 0.001 * g * g
                state[k] = (m, v)
                step = (m / (1 - 0.9 ** t)) / (
                    (v / (1 - 0.999 ** t)).sqrt() + 1e-8)
                p[k] = p[k].detach() - lr * step
        del grads
    change = {k: float((p[k] - p0[k]).norm()) for k in names}
    return {"losses": losses, "out1": out1, "grad1": grad1,
            "change": change}
