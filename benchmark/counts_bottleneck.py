"""Operation and byte counts of the bottleneck MinkUNet's train step, from
coordinates alone (the level counts and stencil pairs of
``counts.LevelCounts``, the benchmark's own neighbour search).

The yardstick of ``train_mfu``, ``conv_roofline.train_step``,
``conv1x1_roofline.train_step`` and ``bn_roofline.train_step`` in the
bottleneck cells; ``counts.py`` holds the basic-block MinkUNet's.

* :func:`wrapper_convs`: the convolutions of one forward that go through
  the port's conv wrappers: per encoder stage its down conv and one 3x3x3
  conv a block, per decoder stage its up conv and one 3x3x3 conv a block
  (MinkUNet101: 40 stencil, 4 down and 4 up convs).
* :func:`gemms`: the 1x1 convs (each block's two, the residual
  projections, the constant-input stem's occupancy GEMM), the head apart.
* :func:`batch_norms`: every BatchNorm, with its level and width.
* :func:`step_facts`: a train step's model FLOPs (2 x pairs x Cin x Cout
  of every conv, the 1x1s and the head; forward, ``dx`` and ``dW``; the
  stem has no ``dx``) and least times on valid rows and existing pairs:
  the wrapper convs through ``counts.bound``/``bound_bwd`` (their
  launches, as ``counts.launch_bounds_ms``); each 1x1 GEMM the larger of
  its bytes (bf16 operands and output, fp32 ``dW``) over the HBM
  bandwidth and its FLOPs over the bf16 peak, forward and backward; each
  BatchNorm's bytes, bf16, forward reading x and writing out, backward
  reading x and dy and writing dx.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from .counts import PEAKS, Conv, LevelCounts, bound, bound_bwd, conv_pairs

EXPANSION = 4


class Gemm(NamedTuple):
    level: int
    cin: int
    cout: int
    dx: bool = True   # the stem's occupancy takes no gradient


class Norm(NamedTuple):
    level: int
    channels: int


def _stages(arch: dict):
    """``(level, cin, planes, blocks)`` of the 8 stages, in order, and the
    up convs' ``(edge, cin, cout)``."""
    layers, planes, c = arch["layers"], arch["planes"], arch["init_dim"]
    enc, out, ups = [c], [], []
    for i in range(4):
        out.append((i + 1, c, planes[i], layers[i]))
        c = planes[i] * EXPANSION
        enc.append(c)
    for j, i in enumerate(range(4, 8)):
        lvl = 3 - j
        ups.append((lvl, c, planes[i]))
        out.append((lvl, planes[i] + enc[lvl], planes[i], layers[i]))
        c = planes[i] * EXPANSION
    return enc, out, ups


def wrapper_convs(arch: dict) -> List[Conv]:
    enc, stages, ups = _stages(arch)
    out: List[Conv] = []
    for i in range(4):
        out.append(Conv("down", i, enc[i], enc[i]))
        lvl, _, planes, n = stages[i]
        out += [Conv("stencil", lvl, planes, planes)] * n
    for j in range(4):
        lvl, cin, cout = ups[j]
        out.append(Conv("up", lvl, cin, cout))
        _, _, planes, n = stages[4 + j]
        out += [Conv("stencil", lvl, planes, planes)] * n
    return out


def gemms(arch: dict) -> List[Gemm]:
    """The 1x1 GEMMs of a forward; the stem's is (K=125 occupancy columns
    -> init_dim) at level 0, its input channels summed into its weight
    first."""
    _, stages, _ = _stages(arch)
    out = [Gemm(0, 125, arch["init_dim"], dx=False)]
    for lvl, cin, planes, n in stages:
        cout = planes * EXPANSION
        for b in range(n):
            out += [Gemm(lvl, cin, planes), Gemm(lvl, planes, cout)]
            if cin != cout:
                out.append(Gemm(lvl, cin, cout))
            cin = cout
    return out


def batch_norms(arch: dict) -> List[Norm]:
    enc, stages, _ = _stages(arch)
    out = [Norm(0, arch["init_dim"])]
    for i in range(4):
        out.append(Norm(i + 1, enc[i]))
    for k, (lvl, cin, planes, n) in enumerate(stages):
        if k >= 4:
            out.append(Norm(lvl, planes))          # bntr after the up conv
        cout = planes * EXPANSION
        for b in range(n):
            out += [Norm(lvl, planes), Norm(lvl, planes), Norm(lvl, cout)]
            if cin != cout:
                out.append(Norm(lvl, cout))
            cin = cout
    return out


def _ms(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["bf16_flops"]) * 1e3


def gemm_ms(g: Gemm, rows: int) -> float:
    """Least ms of one 1x1 GEMM's forward and backward on ``rows`` rows."""
    fwd = _ms((rows * g.cin + rows * g.cout + g.cin * g.cout) * 2,
              2.0 * rows * g.cin * g.cout)
    # dW: x and g read (bf16), the bf16 weight, fp32 dW written; dx: g and
    # the weight read, dx written
    nbytes = (rows * g.cin + rows * g.cout) * 2 + g.cin * g.cout * (2 + 4)
    flops = 2.0 * rows * g.cin * g.cout
    if g.dx:
        nbytes += rows * g.cin * 2
        flops *= 2
    return fwd + _ms(nbytes, flops)


def norm_ms(nm: Norm, rows: int) -> float:
    """Least ms of one BatchNorm's forward and backward on ``rows`` valid
    rows, bf16: 2 (forward) + 3 (backward) passes over (rows, C)."""
    return _ms(5 * rows * nm.channels * 2, 0.0)


def step_facts(arch: dict, counts: LevelCounts, in_ch: int, out_ch: int
               ) -> Dict[str, float]:
    """A train step's ``flops``, ``conv_bound_ms`` (the wrapper convs),
    ``conv1x1_bound_ms`` and ``bn_bound_ms``."""
    n = counts.num
    stem = 2.0 * counts.pairs5 * in_ch * arch["init_dim"]
    fwd = stem
    conv_ms = 0.0
    for cv in wrapper_convs(arch):
        p = conv_pairs(cv, counts)
        fwd += 2.0 * p * cv.cin * cv.cout
        if cv.kind == "stencil":
            m = n[cv.level]
            conv_ms += bound(27, m, m, p, cv.cin, cv.cout)
            conv_ms += bound_bwd(m, m, 27 * m, p, 27, cv.cin, cv.cout)
        elif cv.kind == "down":
            nc, np_ = n[cv.level], n[cv.level + 1]
            conv_ms += bound(8, nc, np_, p, cv.cin, cv.cout, n_idx=p)
            conv_ms += bound_bwd(nc, np_, 2 * nc, p, 8, cv.cin, cv.cout)
        else:  # up: x on the parents, output on the children
            nc, np_ = n[cv.level], n[cv.level + 1]
            conv_ms += _ms((np_ * cv.cin + nc * cv.cout) * 2 + 2 * nc * 4
                           + 8 * cv.cin * cv.cout * 2,
                           2.0 * nc * cv.cin * cv.cout)
            conv_ms += bound_bwd(np_, nc, 8 * np_, p, 8, cv.cin, cv.cout)
    gemm_list = gemms(arch)
    for g in gemm_list[1:]:   # the stem's FLOPs are its k=5 conv's, above
        fwd += 2.0 * n[g.level] * g.cin * g.cout
    last = arch["planes"][7] * EXPANSION
    fwd += 2.0 * n[0] * last * out_ch
    return {"flops": 3.0 * fwd - stem,
            "conv_bound_ms": conv_ms,
            "conv1x1_bound_ms": sum(gemm_ms(g, n[g.level])
                                    for g in gemm_list),
            "bn_bound_ms": sum(norm_ms(b, n[b.level])
                               for b in batch_norms(arch))}
