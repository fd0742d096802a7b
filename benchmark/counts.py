"""Operation and byte counts of the MinkUNet step, from coordinates alone.

The yardstick of the per-layer metrics ``train_mfu`` and
``conv_roofline.*``: every number here comes from a batch's level-0 voxel
coordinates (the benchmark's own neighbour search in
``reference/geometry.py``), never from the plans the program builds.

* :func:`bound` and :func:`bound_bwd` are frozen copies of
  ``chip_smoke.py``'s least-time formulas (H100 SXM, dense bf16 peak and
  HBM bandwidth): each input row read once, each output row written once,
  the int32 plan entries and the bf16 weights (fp32 dW in the backward).
* :func:`conv_launches` lists the convolutions of one MinkUNet forward that
  go through the port's conv wrappers (32 stencil convs, 4 down and 4 up
  convs of MinkUNet18A), with their rows, pairs and widths.
* :func:`model_flops` counts 2 x pairs x Cin x Cout for every conv (the
  constant-input stem, the 1x1 residual projections and the head
  included), forward plus ``dx`` and ``dW`` for a train step (the stem has
  no ``dx``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

# Published peaks of one NVIDIA H100 SXM (dense, no sparsity), 700 W.
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def bound(K, rows_in, rows_out, pairs, cin, cout, n_idx=None):
    """Least ms of a conv forward (rows_in, cin) -> (rows_out, cout): each
    input row read once, each output row written once, ``n_idx`` int32
    index entries (by default K per output row), the bf16 weights; 2 *
    cin * cout operations per (offset, row) pair."""
    n_idx = K * rows_out if n_idx is None else n_idx
    nbytes = (rows_in * cin + rows_out * cout) * 2 + n_idx * 4 \
        + K * cin * cout * 2
    flops = 2.0 * pairs * cin * cout
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["bf16_flops"]) * 1e3


def bound_bwd(rows_x, rows_g, n_idx, pairs, K, cin, cout):
    """Least ms of one conv backward, dx and dW together: x, g and dx rows
    once (bf16), the int32 plan entries, the bf16 weights and the fp32 dW;
    two products of 2 * cin * cout operations per (offset, row) pair."""
    nbytes = (2 * rows_x * cin + rows_g * cout) * 2 + n_idx * 4 \
        + K * cin * cout * (2 + 4)
    flops = 2 * 2.0 * pairs * cin * cout
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["bf16_flops"]) * 1e3


class LevelCounts(NamedTuple):
    """Counts of one batch: valid voxels per level, existing (row, offset)
    pairs of the k=3 stencil per level (centre included) and of the k=5
    stem at level 0."""
    num: Sequence[int]
    pairs3: Sequence[int]
    pairs5: int


class Conv(NamedTuple):
    kind: str      # "stencil" | "down" | "up"
    level: int     # stencil: its level; down/up: the edge (child level)
    cin: int
    cout: int


def unet_convs(arch: dict) -> List[Conv]:
    """The wrapper convs of one forward of a basic-block MinkUNet, in order:
    per encoder stage its down conv and two 3x3 convs a block, per decoder
    stage its up conv and two 3x3 convs a block."""
    layers, planes, c = arch["layers"], arch["planes"], arch["init_dim"]
    enc = [c]
    out: List[Conv] = []
    for i in range(4):
        out.append(Conv("down", i, c, c))
        for _ in range(layers[i]):
            out += [Conv("stencil", i + 1, c, planes[i]),
                    Conv("stencil", i + 1, planes[i], planes[i])]
            c = planes[i]
        enc.append(c)
    for j, i in enumerate(range(4, 8)):
        lvl = 3 - j
        out.append(Conv("up", lvl, c, planes[i]))
        c = planes[i] + enc[lvl]
        for _ in range(layers[i]):
            out += [Conv("stencil", lvl, c, planes[i]),
                    Conv("stencil", lvl, planes[i], planes[i])]
            c = planes[i]
    return out


def projections(arch: dict) -> List[Conv]:
    """The 1x1 residual projections (where a block's width changes)."""
    layers, planes, c = arch["layers"], arch["planes"], arch["init_dim"]
    enc, out = [c], []
    for i in range(4):
        for _ in range(layers[i]):
            if c != planes[i]:
                out.append(Conv("proj", i + 1, c, planes[i]))
            c = planes[i]
        enc.append(c)
    for j, i in enumerate(range(4, 8)):
        lvl = 3 - j
        c = planes[i] + enc[lvl]
        for _ in range(layers[i]):
            if c != planes[i]:
                out.append(Conv("proj", lvl, c, planes[i]))
            c = planes[i]
    return out


def conv_pairs(conv: Conv, counts: LevelCounts) -> int:
    """Existing (row, offset) pairs of one conv: the stencil's at its level;
    one per child on an edge."""
    return (counts.pairs3[conv.level] if conv.kind == "stencil"
            else counts.num[conv.level])


def launch_bounds_ms(arch: dict, counts: LevelCounts, train: bool
                     ) -> Dict[str, float]:
    """Least ms of the wrapper convs of one forward (and backward, with
    ``train``), summed by wrapper, on valid rows and existing pairs."""
    out = {"fwd": 0.0, "bwd": 0.0}
    for cv in unet_convs(arch):
        p, n = conv_pairs(cv, counts), counts.num
        if cv.kind == "stencil":
            m = n[cv.level]
            out["fwd"] += bound(27, m, m, p, cv.cin, cv.cout)
            out["bwd"] += bound_bwd(m, m, 27 * m, p, 27, cv.cin, cv.cout)
        elif cv.kind == "down":
            nc, np_ = n[cv.level], n[cv.level + 1]
            out["fwd"] += bound(8, nc, np_, p, cv.cin, cv.cout, n_idx=p)
            out["bwd"] += bound_bwd(nc, np_, 2 * nc, p, 8, cv.cin, cv.cout)
        else:  # up: x on the parents, output on the children
            nc, np_ = n[cv.level], n[cv.level + 1]
            nbytes = (np_ * cv.cin + nc * cv.cout) * 2 + 2 * nc * 4 \
                + 8 * cv.cin * cv.cout * 2
            flops = 2.0 * nc * cv.cin * cv.cout
            out["fwd"] += max(nbytes / PEAKS["hbm_bytes_per_s"],
                              flops / PEAKS["bf16_flops"]) * 1e3
            out["bwd"] += bound_bwd(np_, nc, 8 * np_, p, 8, cv.cin, cv.cout)
    if not train:
        out["bwd"] = 0.0
    return out


def model_flops(arch: dict, counts: LevelCounts, in_ch: int, out_ch: int,
                train: bool) -> float:
    """Model FLOPs of one forward (``train``: forward, dx and dW) of a
    basic-block MinkUNet on this batch: 2 x pairs x Cin x Cout for every
    conv; the stem (k=5 on ``in_ch`` channels) has no dx."""
    n = counts.num
    fwd = 2.0 * counts.pairs5 * in_ch * arch["init_dim"]
    stem = fwd
    for cv in unet_convs(arch):
        fwd += 2.0 * conv_pairs(cv, counts) * cv.cin * cv.cout
    for pj in projections(arch):
        fwd += 2.0 * n[pj.level] * pj.cin * pj.cout
    last = arch["planes"][7]
    fwd += 2.0 * n[0] * last * out_ch
    if not train:
        return fwd
    return 3.0 * fwd - stem
