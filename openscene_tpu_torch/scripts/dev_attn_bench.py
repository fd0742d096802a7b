"""Serialized patch attention on the card: kernels, plain version, library.

At levels 0 and 3 of a PT-v3m1 batch (each level's voxels a scene, as
``chip_smoke.py`` reads them from the PTv3 cell's first batch, or given;
the widths of the level's blocks there, :func:`cell_levels`), one forward
and backward of the patch attention (patches of 1024, head dimension 16,
bf16; random q, k, v and cotangent) through

* the CUDA kernels (``sparse/patch_attn.py``, the port's route);
* the plain version (``patch_attn_fwd_plain`` / ``_bwd_plain``, one
  patch at a time in fp32), the CPU path and oracle;
* ``torch.nn.functional.scaled_dot_product_attention`` on the patches
  padded to (P, H, 1024, 16) with a key mask: the library yardstick,
  timed here only and never called by the port.

Device ms of each (the host's enqueue hidden behind a sleep kernel), the
kernels' forward and backward alone, the least time (the larger of the
MMA FLOPs over 989 TFLOP/s and the bytes over 3.35 TB/s, forward and
backward each, :func:`bound`; ``benchmark/tests/test_bench_ptv3.py``
holds it equal to ``benchmark/counts_ptv3.py:attention_ms``, the
yardstick of ``attn_roofline``) and its share.  It raises
unless the kernels' output, log-sum-exp and gradients lie within 2e-2
(3e-2 for the gradients) of the largest value of the plain version's on
the same bf16 operands, two runs are bit-equal and the launches are 1 and
2.

Run on the card: ``python -m openscene_tpu_torch.scripts.dev_attn_bench
--scenes '[[...level 0...], ..., [...level 4...]]' [--iters 10]`` (the
PTv3 cell's notes print its first batch's).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.ptv3 import ARCHS
from ..sparse import patch_attn, serialize
from .timing import card_line, device_time_ms

PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12   # H100 SXM, dense bf16
PATCH = ARCHS["PTv3m1"].patch_size


def cell_levels(scenes: Sequence[Sequence[int]]) -> List[Tuple]:
    """``(name, channels, voxels a scene)`` of the two levels timed, from
    each level's voxels a scene of a PT-v3m1 batch: level 0 at the first
    decoder stage's width, level 3 at the fourth encoder stage's."""
    a = ARCHS["PTv3m1"]
    return [("L0 dec", a.dec_channels[0], list(scenes[0])),
            ("L3 enc", a.enc_channels[3], list(scenes[3]))]


def bound(counts: Sequence[int], c: int) -> Tuple[float, str]:
    """``(least ms, what bounds it)`` of the forward and backward over
    scenes of ``counts`` voxels at width ``c``: each pass the larger of its
    MMA FLOPs over the peak and its bytes over HBM's bandwidth (forward:
    q, k, v read, o and the fp32 log-sum-exp written; backward: q, k, v,
    o, dO and the log-sum-exp read, dq, dk and dv written); ``"ops"``,
    ``"bytes"`` or ``"bytes+ops"`` where the passes differ."""
    heads = c // patch_attn.HEAD_DIM
    pairs = sum(n * (PATCH if n > PATCH else n) for n in counts)
    rows = sum(counts)
    prod = 2.0 * patch_attn.HEAD_DIM * pairs * heads
    ms, by = 0.0, set()
    for nbytes, flops in ((rows * (8 * c + 4 * heads), 2 * prod),
                          (rows * (16 * c + 4 * heads), 5 * prod)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS
        ms += max(t_bytes, t_ops) * 1e3
        by.add("bytes" if t_bytes > t_ops else "ops")
    return ms, "+".join(sorted(by))


def _inputs(counts: Sequence[int], c: int, device, gen):
    counts_t = torch.tensor(counts, device=device)
    cap = sum(counts) + 1
    _, _, cu = serialize.patch_layout(counts_t, PATCH, cap)
    rows = cap + len(counts) * PATCH
    inside = torch.arange(rows, device=device) < cu[-1].long()
    qkv = (torch.randn((rows, 3 * c), generator=gen, device=device) * 1.5
           * inside[:, None]).bfloat16()
    dout = (torch.randn((rows, c), generator=gen, device=device)
            * inside[:, None]).bfloat16()
    return qkv, dout, cu


def _library(qkv, dout, cu, heads: int):
    """SDPA on the patches padded to PATCH rows, forward and backward."""
    b = cu.tolist()
    starts = torch.tensor(b[:-1], device=qkv.device)
    lens = torch.tensor(b[1:], device=qkv.device) - starts
    keep = lens > 0
    starts, lens = starts[keep], lens[keep]
    pos = torch.arange(PATCH, device=qkv.device)
    valid = pos[None] < lens[:, None]                      # (P, K)
    idx = torch.where(valid, starts[:, None] + pos[None], 0)

    def run():
        x = qkv.detach().requires_grad_(True)
        t = x[idx].view(len(idx), PATCH, 3, heads, patch_attn.HEAD_DIM)
        q, k, v = (t[:, :, i].transpose(1, 2) for i in range(3))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=valid[:, None, None, :])
        g = dout[idx].view(len(idx), PATCH, heads,
                           patch_attn.HEAD_DIM).transpose(1, 2)
        out.backward(g)
        return x.grad
    return run


def bench_level(name: str, c: int, counts: Sequence[int], iters: int,
                device) -> Dict:
    gen = torch.Generator(device=device).manual_seed(0)
    heads = c // patch_attn.HEAD_DIM
    qkv, dout, cu = _inputs(counts, c, device, gen)
    scale = patch_attn.HEAD_DIM ** -0.5
    f0 = patch_attn.patch_attn_fwd.launches
    b0 = patch_attn.patch_attn_bwd.launches
    out, lse = patch_attn.patch_attn_fwd(qkv, cu, heads, scale, PATCH)
    dq = patch_attn.patch_attn_bwd(qkv, out, lse, dout, cu, heads, scale,
                                   PATCH)
    if (patch_attn.patch_attn_fwd.launches - f0,
            patch_attn.patch_attn_bwd.launches - b0) != (1, 2):
        raise AssertionError("launches are not 1 and 2")
    out2, lse2 = patch_attn.patch_attn_fwd(qkv, cu, heads, scale, PATCH)
    dq2 = patch_attn.patch_attn_bwd(qkv, out, lse, dout, cu, heads, scale,
                                    PATCH)
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)
            and torch.equal(dq, dq2)):
        raise AssertionError("two runs differ")
    ref_out, ref_lse = patch_attn.patch_attn_fwd_plain(qkv, cu, heads, scale)
    ref_dq = patch_attn.patch_attn_bwd_plain(qkv, ref_out, ref_lse, dout, cu,
                                             heads, scale)
    errs = {}
    for what, got, want, tol in (("out", out, ref_out, 2e-2),
                                 ("lse", lse, ref_lse, 2e-2),
                                 ("dqkv", dq, ref_dq, 3e-2)):
        err = float((got.float() - want.float()).abs().max())
        errs[what] = err / float(want.float().abs().max())
        if errs[what] > tol:
            raise AssertionError(f"{name}: {what} off by {errs[what]:.3g} "
                                 f"of its largest value")
    del ref_out, ref_lse, ref_dq

    def kernels():
        o, s = patch_attn.patch_attn_fwd(qkv, cu, heads, scale, PATCH)
        patch_attn.patch_attn_bwd(qkv, o, s, dout, cu, heads, scale, PATCH)

    def plain():
        o, s = patch_attn.patch_attn_fwd_plain(qkv, cu, heads, scale)
        patch_attn.patch_attn_bwd_plain(qkv, o, s, dout, cu, heads, scale)

    fwd_ms = device_time_ms(
        lambda: patch_attn.patch_attn_fwd(qkv, cu, heads, scale, PATCH),
        iters=iters)
    bwd_ms = device_time_ms(
        lambda: patch_attn.patch_attn_bwd(qkv, out, lse, dout, cu, heads,
                                          scale, PATCH), iters=iters)
    ms = device_time_ms(kernels, iters=iters)
    plain_ms = device_time_ms(plain, iters=1, warmup=1)
    library_ms = device_time_ms(_library(qkv, dout, cu, heads), iters=iters)
    least, by = bound(counts, c)
    return {"shape": f"{name} rows={sum(counts)} C={c} H={heads}",
            "ms": ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": least, "bound_by": by,
            "roofline_pct": 100.0 * least / ms, "rel_err": errs}


def bench_attn(levels: Sequence[Tuple], iters: int = 10) -> List[Dict]:
    """:func:`bench_level` of each ``(name, channels, voxels a scene)``
    (:func:`cell_levels`)."""
    if not torch.cuda.is_available():
        raise RuntimeError("dev_attn_bench needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    return [bench_level(name, c, counts, iters, dev)
            for name, c, counts in levels]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--scenes", required=True,
                    help="JSON list of each level's voxels a scene (the "
                         "PTv3 cell's notes print its first batch's); "
                         "levels 0 and 3 are timed")
    args = ap.parse_args(argv)
    print(card_line(), flush=True)
    for row in bench_attn(cell_levels(json.loads(args.scenes)),
                          iters=args.iters):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
