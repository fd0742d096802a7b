"""Tile sweep of the stencil kernels on the card.

Builds the geometry of one synthetic train batch on the card (as
``dev_bench_ops`` does, with each level's skip plan) and, at MinkUNet18A's
stencil widths, times ``csrc/gather_gemm_fwd.cu`` (forward and ``dx``) and
``csrc/gather_gemm_bwd.cu`` (``dW``) under every legal row tile, column
tile, offset-group count and row split, beside the configuration that
``stencil_conv.fwd_tiles`` / ``wgrad_tiles`` choose and the im2col
yardstick (``index_select`` + ``torch.matmul``).  Each line is one JSON
object: device milliseconds with the host's enqueue hidden
(``timing.device_time_ms``) and, for the chosen configuration, the
wrapper's CUDA-event time of back-to-back calls (``timing.time_ms``, which
counts the host too where it is slower).  Every configuration's output is
held against the chosen one's: bit-equal for the forward without offset
groups (the same fp32 sum order per row), within one bf16 ulp of the scale
with them, and within ``1e-4`` of the scale for ``dW``.

Run on the card: ``python -m openscene_tpu_torch.scripts.dev_stencil_tiles
[--scenes 2] [--iters 20]``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..sparse import stencil_conv as sc
from ..sparse.geometry import _bucket, _pad_level, level_counts
from ..sparse.geometry_device import build_geometry_parts, with_host_counts
from .dev_bench_ops import HERE, synthetic_batch
from .timing import card_line, device_time_ms, time_ms

# (level, Cin, Cout) of the forward and dx launches of MinkUNet18A's k=3
# convs (dx of a Cin->Cout conv is a Cout->Cin launch)
FWD_CASES = ((0, 128, 96), (0, 96, 96), (0, 96, 128), (1, 32, 32),
             (1, 160, 96), (2, 64, 64), (2, 256, 128), (3, 384, 128),
             (3, 128, 384), (4, 256, 256))
# (level, Ca, Cb) of the dW launches (a = x, b = g)
WGRAD_CASES = ((0, 128, 96), (0, 96, 96), (1, 32, 32), (2, 256, 128),
               (3, 384, 128), (4, 256, 256))


def fwd_configs(rows, cin, cout):
    """Every legal (bm, bn, groups), the chooser's first."""
    chosen = sc.fwd_tiles(rows, 27, cin, cout, True)
    out = [chosen]
    bns = {chosen[1]} | {t for t in sc.FWD_COL_TILES
                         if t >= 64 and -(-cout // t) * t - cout < t}
    for bm in sc.FWD_ROW_TILES:
        for bn in sorted(bns):
            if (bm // 32) * (bn // 32) > sc.MAX_WARPS:
                continue
            for groups in (1, 2, 4, 8):
                if (bm, bn, groups) not in out:
                    out.append((bm, bn, groups))
    return out


def wgrad_configs(rows, ca, cb):
    """Every legal (bma, bnb, rows per split, splits), the chooser's
    first."""
    chosen = sc.wgrad_tiles(rows, 27, ca, cb, True)
    out = [chosen]
    fits = [[t for t in sc.WGRAD_TILES if -(-c // t) * t - c < t]
            for c in (ca, cb)]
    for bma in fits[0]:
        for bnb in fits[1]:
            if (bma // 32) * (bnb // 32) > sc.MAX_WARPS:
                continue
            for per in (256, 512, 1024, 2048, 4096):
                cfg = (bma, bnb, per, -(-rows // per))
                if cfg not in out and cfg[3] <= 65535:
                    out.append(cfg)
    return out


def sweep(geo, iters, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16

    def acts(lv, c):
        x = torch.randn((lv.cap, c), generator=gen, device="cuda")
        x[lv.num:] = 0
        return x.to(bf16)

    for level, cin, cout in FWD_CASES:
        lv, plan = geo.levels[level], geo.self3[level]
        x = acts(lv, cin)
        w = torch.randn((27, cin, cout), generator=gen, device="cuda") * 0.05
        wb = w.to(bf16)
        chosen = sc.fwd_tiles(lv.cap, 27, cin, cout, True)
        ref = sc.launch_gather_gemm(x, wb, plan.fwd, plan.skip, *chosen)
        # without offset groups every row sums in the same order
        ref1 = sc.launch_gather_gemm(x, wb, plan.fwd, plan.skip,
                                     *chosen[:2], 1)

        def im2col():
            g = x.index_select(0, plan.fwd.reshape(-1)).reshape(
                27, lv.cap, cin)
            return torch.matmul(g.transpose(0, 1).reshape(lv.cap, -1),
                                wb.reshape(27 * cin, cout))

        base = {"kernel": "gather_gemm_fwd", "level": level,
                "shape": f"{cin}->{cout}", "cap": lv.cap, "num": lv.num}
        print(json.dumps({**base, "wrapper_events_ms": time_ms(
            lambda: sc.stencil_conv_fwd(x, w, plan.fwd, plan.skip), "cuda",
            iters), "wrapper_device_ms": device_time_ms(
            lambda: sc.stencil_conv_fwd(x, w, plan.fwd, plan.skip), iters),
            "im2col_device_ms": device_time_ms(im2col, iters),
            "dense_device_ms": device_time_ms(
                lambda: sc.launch_gather_gemm(
                    x, wb, plan.fwd, None,
                    *sc.fwd_tiles(lv.cap, 27, cin, cout)), iters)}),
            flush=True)
        for i, cfg in enumerate(fwd_configs(lv.cap, cin, cout)):
            out = sc.launch_gather_gemm(x, wb, plan.fwd, plan.skip, *cfg)
            err = (out.float() - ref.float()).abs().max().item()
            if (cfg[2] == 1 and not torch.equal(out, ref1)) or not \
                    err <= 2.0 ** -7 * ref.float().abs().max().item():
                raise AssertionError(f"{base} {cfg}: differs by {err}")
            print(json.dumps({**base, "bm_bn_groups": cfg, "chosen": i == 0,
                              "device_ms": device_time_ms(
                                  lambda: sc.launch_gather_gemm(
                                      x, wb, plan.fwd, plan.skip, *cfg),
                                  iters)}), flush=True)

    for level, ca, cb in WGRAD_CASES:
        lv, plan = geo.levels[level], geo.self3[level]
        a, b = acts(lv, ca), acts(lv, cb)
        ref = sc.gather_wgrad_cuda(a, b, plan.fwd, plan.skip)
        pairs = (plan.skip.pair_rows, plan.skip.pair_count)
        tol = 1e-4 * ref.abs().max().item()

        def library():
            g = b.index_select(0, plan.fwd.reshape(-1)).reshape(
                27, lv.cap, cb)
            return torch.matmul(a.t().unsqueeze(0), g)

        base = {"kernel": "gather_wgrad", "level": level,
                "shape": f"{ca}x{cb}", "cap": lv.cap, "num": lv.num,
                "pairs": int(plan.skip.pair_count.sum().item())}
        print(json.dumps({**base, "wrapper_events_ms": time_ms(
            lambda: sc.gather_wgrad_cuda(a, b, plan.fwd, plan.skip), "cuda",
            iters), "library_device_ms": device_time_ms(library, iters),
            "dense_device_ms": device_time_ms(
                lambda: sc.gather_wgrad_cuda(a, b, plan.fwd), iters)}),
            flush=True)
        for i, cfg in enumerate(wgrad_configs(lv.cap, ca, cb)):
            out = sc.launch_gather_wgrad(a, b, plan.fwd, pairs, *cfg)
            err = (out - ref).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{base} {cfg}: differs by {err}")
            print(json.dumps({**base, "bma_bnb_per_splits": cfg,
                              "chosen": i == 0, "device_ms": device_time_ms(
                                  lambda: sc.launch_gather_wgrad(
                                      a, b, plan.fwd, pairs, *cfg),
                                  iters)}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dev_stencil_tiles needs a CUDA device")
    from ..device import resolve_device
    resolve_device("cuda")
    coords, num = synthetic_batch(
        args.scenes, os.path.join(HERE, "build", "stencil_tiles_data"))
    coords = coords[:num]
    caps = tuple(_bucket(c) for c in level_counts(coords))
    c0 = torch.as_tensor(_pad_level(coords, caps[0]).coords, device="cuda")
    geo, over = with_host_counts(*build_geometry_parts(
        c0, num, caps, n_scenes=args.scenes))
    if over:
        raise AssertionError(f"geometry overflowed (caps {caps})")
    print(f"# {num} voxels, {args.scenes} scenes, caps {caps}, valid "
          f"{[lv.num for lv in geo.levels]} [{card_line()}]", flush=True)
    sweep(geo, args.iters)


if __name__ == "__main__":
    main()
