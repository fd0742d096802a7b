"""Plain bottleneck MinkUNet (MinkUNet50 and MinkUNet101) and its distill
train steps, in float32 with TF32 off.

Follows MinkowskiEngine's ``examples/minkunet.py`` (``MinkUNet101``), which
the reference repository copies in ``models/mink_unet.py`` with
``models/resnet_base.py``'s ``Bottleneck``: the k=5 stem, four k=2 s=2
down convs, bottleneck blocks (a 1x1 conv to ``planes``, a 3x3x3 conv, a
1x1 conv to ``4 planes``, each followed by BatchNorm; a 1x1 projection
with BatchNorm on the residual where the width changes), four k=2 s=2
transposed convs with skip concatenation, a 1x1 head.  The convs, the 1x1
products, BatchNorm and the weights' draw are ``minkunet.py``'s; its
departures hold here too.  Besides:

* ``checkpoint`` recomputes each block in the backward from its input
  (``torch.utils.checkpoint``): the same arithmetic, in a memory that fits
  the cell's 1.1M-voxel batch once the program is freed.
* :func:`train_steps` is ``train.py``'s distillation (cosine loss on the
  voxels with a target, Adam at ``10 * base_lr`` times the poly factor),
  on this forward.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from . import geometry, minkunet
from .minkunet import Quant, batch_norm, conv, identity, linear
from .train import cosine_loss

EXPANSION = 4
ARCHS = {
    "MinkUNet50": {"layers": [2, 3, 4, 6, 2, 2, 2, 2],
                   "planes": [32, 64, 128, 256, 256, 128, 96, 96],
                   "init_dim": 32},
    "MinkUNet101": {"layers": [2, 3, 4, 23, 2, 2, 2, 2],
                    "planes": [32, 64, 128, 256, 256, 128, 96, 96],
                    "init_dim": 32},
}


def param_shapes(arch: str, in_ch: int, out_ch: int) -> Dict[str, tuple]:
    """Name -> shape of every parameter and BatchNorm buffer, named as the
    program's ``state_dict``."""
    a = ARCHS[arch]
    shapes: Dict[str, tuple] = {}

    def bn(name, c):
        for s in ("gamma", "beta", "mean", "var"):
            shapes[f"{name}.{s}"] = (c,)

    def stage(name, n, cin, planes):
        cout = planes * EXPANSION
        for b in range(n):
            pre = f"{name}.{b}"
            shapes[pre + ".conv1"] = (1, cin, planes)
            bn(pre + ".bn1", planes)
            shapes[pre + ".conv2"] = (27, planes, planes)
            bn(pre + ".bn2", planes)
            shapes[pre + ".conv3"] = (1, planes, cout)
            bn(pre + ".bn3", cout)
            if cin != cout:
                shapes[pre + ".down"] = (1, cin, cout)
                bn(pre + ".down_bn", cout)
            cin = cout
        return cin

    c = a["init_dim"]
    shapes["conv0"] = (125, in_ch, c)
    bn("bn0", c)
    enc = [c]
    for i in range(1, 5):
        shapes[f"conv{i}"] = (8, c, c)
        bn(f"bn{i}", c)
        c = stage(f"block{i}", a["layers"][i - 1], c, a["planes"][i - 1])
        enc.append(c)
    for j, i in enumerate(range(4, 8)):
        up = a["planes"][i]
        shapes[f"convtr{i}"] = (8, c, up)
        bn(f"bntr{i}", up)
        c = stage(f"block{i + 1}", a["layers"][i], up + enc[3 - j], up)
    shapes["final"] = (1, c, out_ch)
    return shapes


def make_weights(arch: str, in_ch: int, out_ch: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Weights from ``seed`` on ``device``, drawn as
    ``minkunet.make_weights`` draws them (one He-normal draw over every
    conv kernel in :func:`param_shapes`' order; BatchNorm gamma 1, beta 0,
    running mean 0, variance 1); float32."""
    shapes = param_shapes(arch, in_ch, out_ch)
    convs = [k for k, s in shapes.items() if len(s) == 3]
    total = sum(int(torch.Size(shapes[k]).numel()) for k in convs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if len(s) == 3:
            n = int(torch.Size(s).numel())
            out[k] = flat[at:at + n].view(s) * (2.0 / (s[0] * s[2])) ** 0.5
            at += n
        elif k.endswith((".gamma", ".var")):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def forward(p: Dict[str, torch.Tensor], geo: geometry.Geometry,
            x: torch.Tensor, arch: str = "MinkUNet101", train: bool = True,
            quant: Quant = identity, checkpoint: bool = False
            ) -> torch.Tensor:
    """(N0, in_ch) level-0 features -> (N0, out_ch) float32."""
    a = ARCHS[arch]

    def bottleneck(pre, x, lvl):
        out = torch.relu(batch_norm(linear(x, p[pre + ".conv1"], quant), p,
                                    pre + ".bn1", train))
        out = torch.relu(batch_norm(conv(out, p[pre + ".conv2"],
                                         geo.self3[lvl], quant), p,
                                    pre + ".bn2", train))
        out = batch_norm(linear(out, p[pre + ".conv3"], quant), p,
                         pre + ".bn3", train)
        res = x
        if pre + ".down" in p:
            res = batch_norm(linear(x, p[pre + ".down"], quant), p,
                             pre + ".down_bn", train)
        return torch.relu(out + res)

    def stage(name, x, lvl, n):
        for b in range(n):
            pre = f"{name}.{b}"
            if checkpoint and torch.is_grad_enabled():
                x = _checkpoint(bottleneck, pre, x, lvl, use_reentrant=False)
            else:
                x = bottleneck(pre, x, lvl)
        return x

    out = torch.relu(batch_norm(conv(x, p["conv0"], geo.stem, quant), p,
                                "bn0", train))
    enc: List[torch.Tensor] = [out]
    for i in range(1, 5):
        out = conv(out, p[f"conv{i}"], geo.down[i - 1], quant)
        out = torch.relu(batch_norm(out, p, f"bn{i}", train))
        out = stage(f"block{i}", out, i, a["layers"][i - 1])
        enc.append(out)
    for j, i in enumerate(range(4, 8)):
        lvl = 3 - j
        out = conv(out, p[f"convtr{i}"], geo.up[lvl], quant)
        out = torch.relu(batch_norm(out, p, f"bntr{i}", train))
        out = torch.cat([out, enc[lvl]], 1)
        out = stage(f"block{i + 1}", out, lvl, a["layers"][i])
    return linear(out, p["final"], quant)


def train_steps(p0: Dict[str, torch.Tensor], batches: Sequence, cfg: dict,
                max_iter: int, quant: Quant = identity,
                drop_half: bool = False, checkpoint: bool = True) -> dict:
    """Distill ``len(batches)`` steps from ``p0``; a batch is ``(coords
    (N, 4), target (N, D), mask (N,))``.  Returns what
    ``train.train_steps`` returns: the losses, the first step's head output
    (on the host), each leaf's norm of the first step's gradient and of the
    change after the last step.  The steps compute in ``p0``'s dtype
    (float32 here; the CPU tests also take float64)."""
    names = [k for k in p0 if minkunet.trainable(k)]
    p = {k: v.clone() for k, v in p0.items()}
    state: Dict[str, tuple] = {}
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    for it, (coords, target, mask) in enumerate(batches):
        if drop_half:
            keep = coords.shape[0] // 2
            coords, target, mask = coords[:keep], target[:keep], mask[:keep]
        geo = geometry.build(coords)
        leaves = [p[k].requires_grad_(True) for k in names]
        x = torch.ones((coords.shape[0], 3), dtype=p["conv0"].dtype,
                       device=coords.device)
        out = forward(p, geo, x, cfg["arch_3d"], train=True, quant=quant,
                      checkpoint=checkpoint)
        loss = cosine_loss(out, target.float(), mask)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if it == 0:
            out1 = out.detach().cpu()
        del geo, out, loss
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
