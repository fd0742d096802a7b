"""Plain MinkUNet (basic blocks), in float32 with TF32 off.

Follows the reference repository's ``models/mink_unet.py`` and
``models/resnet_base.py`` (MinkUNet18A: a k=5 stem, four k=2 s=2 down convs,
two basic blocks a stage, four k=2 s=2 transposed convs with skip
concatenation, a 1x1 head; bias-free convs, BatchNorm with gamma/beta and
eps 1e-5, ReLU).  Departures, each for a reason:

* The parameters are a flat dict named as the program's ``state_dict``
  (``conv0``, ``block1.0.conv1``, ``bn0.gamma`` ...), conv weights (K, Cin,
  Cout) in x-major offset order: the benchmark makes one set of weights and
  hands it to both sides.
* Convs are gather -> matmul -> ``index_add_`` per offset over the pair
  lists of ``geometry.py`` (MinkowskiEngine's gather-GEMM-scatter), with a
  hand-written backward that gathers again instead of keeping 27 gathered
  copies: the same products, in a memory that fits a 1.1M-voxel batch.
* ``quant`` rounds every product's two operands (forward and backward)
  before the float32 product: the identity for the reference, fp8 e4m3
  with a per-tensor scale for the control (``control.py``).
* Running statistics are not updated: no compared number reads them.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from .geometry import Geometry, Pairs

Quant = Callable[[torch.Tensor], torch.Tensor]
ARCHS = {"MinkUNet18A": {"layers": [2] * 8,
                         "planes": [32, 64, 128, 256, 128, 128, 96, 96],
                         "init_dim": 32}}


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with a per-tensor scale (amax -> 448)."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _PairConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, pairs: Pairs, quant: Quant):
        ctx.save_for_backward(x, w)
        ctx.pairs, ctx.quant = pairs, quant
        out = x.new_zeros((pairs.n_out, w.shape[2]))
        xq = quant(x)
        for k, (o, i) in enumerate(zip(pairs.out_rows, pairs.in_rows)):
            if o.numel():
                out.index_add_(0, o, xq.index_select(0, i) @ quant(w[k]))
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pairs, q = ctx.pairs, ctx.quant
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(w)
        xq, gq = q(x), q(g)
        for k, (o, i) in enumerate(zip(pairs.out_rows, pairs.in_rows)):
            if not o.numel():
                continue
            gk = gq.index_select(0, o)
            dw[k] = xq.index_select(0, i).t() @ gk
            if dx is not None:
                dx.index_add_(0, i, gk @ q(w[k]).t())
        return dx, dw, None, None


def conv(x, w, pairs: Pairs, quant: Quant = identity):
    return _PairConv.apply(x, w, pairs, quant)


class _Linear(torch.autograd.Function):
    """1x1 conv whose products, forward and backward, take ``quant``'s
    operands (a float8 cast has no gradient of its own)."""

    @staticmethod
    def forward(ctx, x, w, quant: Quant):
        ctx.save_for_backward(x, w)
        ctx.quant = quant
        return quant(x) @ quant(w[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        q = ctx.quant
        gq = q(g)
        return gq @ q(w[0]).t(), (q(x).t() @ gq)[None], None


def linear(x, w, quant: Quant = identity):
    """1x1 conv (kernel volume 1)."""
    if quant is identity:
        return x @ w[0]
    return _Linear.apply(x, w, quant)


def batch_norm(x, p: Dict[str, torch.Tensor], name: str, train: bool,
               eps: float = 1e-5):
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    else:
        mean, var = p[name + ".mean"], p[name + ".var"]
    return (x - mean) * torch.rsqrt(var + eps) * p[name + ".gamma"] \
        + p[name + ".beta"]


def param_shapes(arch: str, in_ch: int, out_ch: int) -> Dict[str, tuple]:
    """Name -> shape of every parameter and BatchNorm buffer."""
    a = ARCHS[arch]
    shapes: Dict[str, tuple] = {}

    def bn(name, c):
        for s in ("gamma", "beta", "mean", "var"):
            shapes[f"{name}.{s}"] = (c,)

    def stage(name, n, cin, planes):
        for b in range(n):
            pre = f"{name}.{b}"
            shapes[pre + ".conv1"] = (27, cin, planes)
            bn(pre + ".bn1", planes)
            shapes[pre + ".conv2"] = (27, planes, planes)
            bn(pre + ".bn2", planes)
            if cin != planes:
                shapes[pre + ".down"] = (1, cin, planes)
                bn(pre + ".down_bn", planes)
            cin = planes
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
    """Weights from ``seed`` on ``device``, in one draw: He-normal conv
    kernels (std sqrt(2 / (K Cout)), the reference's ``kaiming_normal_``
    with fan-out over the kernel volume), BatchNorm gamma 1, beta 0,
    running mean 0 and variance 1; float32."""
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


def forward(p: Dict[str, torch.Tensor], geo: Geometry, x: torch.Tensor,
            arch: str = "MinkUNet18A", train: bool = True,
            quant: Quant = identity) -> torch.Tensor:
    """(N0, in_ch) level-0 features -> (N0, out_ch) float32."""
    a = ARCHS[arch]

    def block(name, x, lvl, n):
        for b in range(n):
            pre = f"{name}.{b}"
            out = torch.relu(batch_norm(
                conv(x, p[pre + ".conv1"], geo.self3[lvl], quant), p,
                pre + ".bn1", train))
            out = batch_norm(conv(out, p[pre + ".conv2"], geo.self3[lvl],
                                  quant), p, pre + ".bn2", train)
            res = x
            if pre + ".down" in p:
                res = batch_norm(linear(x, p[pre + ".down"], quant), p,
                                 pre + ".down_bn", train)
            x = torch.relu(out + res)
        return x

    out = torch.relu(batch_norm(conv(x, p["conv0"], geo.stem, quant), p,
                                "bn0", train))
    enc: List[torch.Tensor] = [out]
    for i in range(1, 5):
        out = conv(out, p[f"conv{i}"], geo.down[i - 1], quant)
        out = torch.relu(batch_norm(out, p, f"bn{i}", train))
        out = block(f"block{i}", out, i, a["layers"][i - 1])
        enc.append(out)
    for j, i in enumerate(range(4, 8)):
        lvl = 3 - j
        out = conv(out, p[f"convtr{i}"], geo.up[lvl], quant)
        out = torch.relu(batch_norm(out, p, f"bntr{i}", train))
        out = torch.cat([out, enc[lvl]], 1)
        out = block(f"block{i + 1}", out, lvl, a["layers"][i])
    return linear(out, p["final"], quant)


def trainable(name: str) -> bool:
    """Parameters (not BatchNorm running statistics)."""
    return not name.endswith((".mean", ".var"))
