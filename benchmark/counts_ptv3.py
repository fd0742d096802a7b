"""Operation and byte counts of the Point Transformer V3 train step, from
coordinates alone (the level counts and stencil pairs of
``counts.LevelCounts`` and each level's voxels a scene, from the
benchmark's own neighbour search, ``reference/geometry.py``).

The yardstick of ``train_mfu``, ``conv_roofline.train_step``,
``conv1x1_roofline.train_step``, ``bn_roofline.train_step`` and
``attn_roofline.train_step`` in the PTv3 cell.

* :func:`attn_pairs`: a level's (query, key) pairs of one head: each
  scene's real queries against every key of their patch, duplicates
  included (a scene of more than ``patch`` voxels is padded to patches of
  ``patch`` keys; a smaller scene is one patch of its own length).
* :func:`attention_ms`: the least time of one block's attention, forward
  and backward, each the larger of its MMA FLOPs over the bf16 peak and
  its bytes over the HBM bandwidth.  FLOPs: ``2 x 16`` a pair and head for
  each product, 2 products forward (``QK^T``, ``PV``) and 5 backward
  (the scores again, ``dP``, ``dV``, ``dQ``, ``dK``, as flash attention
  takes them).  Bytes (bf16, real rows): q, k, v read and o and the fp32
  log-sum-exp written forward; q, k, v, o, dO and the log-sum-exp read
  and dq, dk, dv written backward.  The exponentials (one a pair forward,
  one backward) are counted (``attn_exp``), not bounded: a polynomial
  ``exp2`` on the FMA pipes can beat the MUFU's rate.
* :func:`step_facts`: a train step's model FLOPs (every conv, Linear,
  attention product and the head; forward, ``dx`` and ``dW``, the
  attention's backward its 4 products; the stem has no ``dx``) and least
  times: the 22 xCPE convs through ``counts.bound``/``bound_bwd`` (the
  conv wrappers' launches; the stem is the occupancy GEMM), the stem's
  GEMM (``counts_bottleneck.gemm_ms``), the 13 BatchNorms
  (``counts_bottleneck.norm_ms``) and the attention.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .counts import PEAKS, LevelCounts, bound, bound_bwd
from .counts_bottleneck import Gemm, Norm, gemm_ms, norm_ms

HEAD_DIM = 16


def attn_pairs(scene_counts: Sequence[int], patch: int) -> int:
    """(query, key) pairs of one head over a level's scenes."""
    return int(sum(n * (patch if n > patch else n) for n in scene_counts))


def _ms(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["bf16_flops"]) * 1e3


def attention_ms(rows: int, pairs: int, channels: int) -> float:
    """Least ms of one block's attention forward and backward on ``rows``
    real rows of ``channels`` (``channels / 16`` heads), ``pairs`` (query,
    key) pairs a head."""
    heads = channels // HEAD_DIM
    prod = 2.0 * HEAD_DIM * pairs * heads
    fwd = _ms(rows * (4 * channels * 2 + heads * 4), 2 * prod)
    bwd = _ms(rows * (5 * channels * 2 + heads * 4 + 3 * channels * 2),
              5 * prod)
    return fwd + bwd


def blocks(a: dict) -> List[tuple]:
    """``(level, channels)`` of every block of a forward."""
    out = [(s, c) for s, (n, c) in enumerate(zip(a["enc_depths"],
                                                  a["enc_channels"]))
           for _ in range(n)]
    return out + [(s, a["dec_channels"][s])
                  for s in reversed(range(len(a["dec_depths"])))
                  for _ in range(a["dec_depths"][s])]


def batch_norms(a: dict) -> List[Norm]:
    """The stem's, each pooling's and each unpooling's two BatchNorms."""
    enc, dec = a["enc_channels"], a["dec_channels"]
    out = [Norm(0, enc[0])]
    out += [Norm(s, enc[s]) for s in range(1, len(enc))]
    for s in range(len(dec)):
        out += [Norm(s + 1, dec[s]), Norm(s, dec[s])]
    return out


def step_facts(a: dict, counts: LevelCounts, scenes: Sequence[Sequence[int]],
               in_ch: int, out_ch: int) -> Dict[str, float]:
    """A train step's ``flops``, ``conv_bound_ms`` (the xCPE convs),
    ``conv1x1_bound_ms`` (the stem's GEMM), ``bn_bound_ms``,
    ``attn_bound_ms`` and ``attn_exp``; ``scenes[l]``: level ``l``'s
    voxels of each scene."""
    n = counts.num
    patch, ratio = a["patch_size"], a["mlp_ratio"]
    enc, dec = a["enc_channels"], a["dec_channels"]
    stem = 2.0 * counts.pairs5 * in_ch * enc[0]
    fwd = stem + 2.0 * n[0] * dec[0] * out_ch
    conv_ms = attn_ms = exps = 0.0
    for lvl, c in blocks(a):
        m, pairs = n[lvl], attn_pairs(scenes[lvl], patch)
        fwd += 2.0 * counts.pairs3[lvl] * c * c
        fwd += 2.0 * m * c * c * (1 + 3 + 1 + 2 * ratio)   # the Linears
        fwd += 2 * 2.0 * HEAD_DIM * pairs * (c // HEAD_DIM)
        conv_ms += bound(27, m, m, counts.pairs3[lvl], c, c)
        conv_ms += bound_bwd(m, m, 27 * m, counts.pairs3[lvl], 27, c, c)
        attn_ms += attention_ms(m, pairs, c)
        exps += 2.0 * pairs * (c // HEAD_DIM)
    for s in range(1, len(enc)):                          # poolings
        fwd += 2.0 * n[s - 1] * enc[s - 1] * enc[s]
    dec_in = list(dec) + [enc[-1]]
    for s in range(len(dec)):                             # unpoolings
        fwd += 2.0 * (n[s + 1] * dec_in[s + 1] + n[s] * enc[s]) * dec[s]
    return {"flops": 3.0 * fwd - stem,
            "conv_bound_ms": conv_ms,
            "conv1x1_bound_ms": gemm_ms(Gemm(0, a["stem_kernel"] ** 3,
                                             enc[0], dx=False), n[0]),
            "bn_bound_ms": sum(norm_ms(b, n[b.level])
                               for b in batch_norms(a)),
            "attn_bound_ms": attn_ms,
            "attn_exp": exps}
