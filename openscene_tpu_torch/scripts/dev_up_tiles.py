"""Tile sweep of the up conv's kernels on the card (kernels 5 and 4).

Builds the geometry of one synthetic train batch on the card (as
``dev_stencil_tiles`` does, every edge with its groups and skip plan) and,
at MinkUNet18A's four up-conv widths, times

* ``csrc/up_conv_fwd.cu`` (kernel 5) under every legal column tile and
  tiles-per-block count, beside the configuration
  ``edge_conv.up_tiles`` chooses, the wrapper ``up_conv_fwd`` and the dense
  route (``ops.sparse_up_conv``, the JAX package model's forward).  Every
  configuration sums each row in the same order, so its output must equal
  the chosen one's bit for bit, and the chosen one must be within one bf16
  ulp of the scale of the plain version;
* the up-conv backward (kernel 4): the wrapper ``up_conv_bwd`` against the
  plain version (``dx`` one bf16 ulp, ``dW`` 1e-4 of the scale) and
  against the design it replaced (both products dense over every parent
  and offset: ``gather_gemm_cuda`` on a transposed weight copy and
  ``gather_wgrad_cuda`` without a skip plan), and its two launches apart:
  ``dx`` (``gather_gemm_fwd.cu`` with the edge's skip plan, ``W[k]^T`` read
  in the kernel) under every legal row tile, column tile and offset-group
  count, ``dW`` (``gather_gemm_bwd.cu`` over the groups) under every legal
  tile and row split.

Each line is one JSON object of device milliseconds with the host's
enqueue hidden (``timing.device_time_ms``); the wrappers' lines also give
CUDA-event times of back-to-back calls (``timing.time_ms``, which count the
host too where it is slower).

Run on the card: ``python -m openscene_tpu_torch.scripts.dev_up_tiles
[--scenes 2] [--iters 20]``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..sparse import edge_conv as ec
from ..sparse import stencil_conv as sc
from ..sparse.geometry import _bucket, _pad_level, level_counts
from ..sparse.geometry_device import build_geometry_parts, with_host_counts
from ..sparse.ops import sparse_up_conv
from .dev_bench_ops import HERE, UP_CH, synthetic_batch
from .timing import card_line, device_time_ms, time_ms

BF16_ULP = 2.0 ** -7


def up_configs(child_cap, cin, cout):
    """Every legal (bn, tpb) of kernel 5, the chooser's first."""
    chosen = ec.up_tiles(child_cap, cin, cout)
    out = [chosen]
    for bn in sc.FWD_COL_TILES:
        if -(-cout // bn) * bn - cout >= bn:
            continue
        for tpb in (1, 2, 4, 8, 16):
            if (bn, tpb) not in out and ec._up_smem(cin, bn, tpb) \
                    <= ec.UP_SMEM:
                out.append((bn, tpb))
    return out


def dx_configs(rows, cin, cout):
    """Every legal (bm, bn, groups) of the up-conv ``dx`` (a Cout -> Cin
    launch over the parents), the chooser's first."""
    chosen = ec.up_dx_tiles(rows, cin, cout)
    out = [chosen]
    for bm in sc.FWD_ROW_TILES:
        for bn in sc.FWD_COL_TILES:
            if (-(-cin // bn) * bn - cin >= bn
                    or (bm // 32) * (bn // 32) > sc.MAX_WARPS):
                continue
            for groups in (1, 2, 4):
                if (bm, bn, groups) not in out:
                    out.append((bm, bn, groups))
    return out


def wgrad_configs(rows, ca, cb, chosen):
    """Every legal (bma, bnb, per, splits) of a group-mode ``dW`` launch
    over at most ``rows`` rows per offset (``a`` Ca wide, ``b`` Cb wide),
    the chooser's pick ``chosen`` first; the splits tried include the one
    ``wgrad_tiles`` picks under its default floor, ``WGRAD_MIN_ROWS``."""
    out = [chosen]
    stencil = sc.wgrad_tiles(rows, 8, ca, cb, True)
    pers = sorted({128, 192, 256, 384, 512, 1024, 2048, 4096, stencil[2]})
    fits = [[t for t in sc.WGRAD_TILES if -(-c // t) * t - c < t]
            for c in (ca, cb)]
    for bma in fits[0]:
        for bnb in fits[1]:
            if (bma // 32) * (bnb // 32) > sc.MAX_WARPS:
                continue
            for per in pers:
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

    for edge in range(4):
        cin, cout = UP_CH[edge]
        plan = geo.down[edge]
        child, parent = geo.levels[edge], geo.levels[edge + 1]
        x, g = acts(parent, cin), acts(child, cout)
        w = torch.randn((8, cin, cout), generator=gen, device="cuda") * \
            (2.0 / (8 * cout)) ** 0.5
        wb = w.to(bf16)
        base = {"edge": edge, "shape": f"{cin}->{cout}",
                "child_cap": child.cap, "child_num": child.num,
                "parent_cap": parent.cap, "parent_num": parent.num}

        # kernel 5
        chosen = ec.up_tiles(child.cap, cin, cout)
        ref = ec.launch_up_conv(x, wb, plan.child_parent, plan.groups,
                                *chosen)
        plain = ec.up_conv_plain(x, w, plan)
        err = (ref.float() - plain.float()).abs().max().item()
        if not err <= BF16_ULP * plain.float().abs().max().item() \
                or ref[child.num:].any():
            raise AssertionError(f"{base}: kernel 5 differs from its plain "
                                 f"version by {err} (or padded rows)")
        print(json.dumps({**base, "kernel": "up_conv_fwd",
                          "max_abs_err": err,
                          "wrapper_device_ms": device_time_ms(
                              lambda: ec.up_conv_fwd(x, w, plan), iters),
                          "wrapper_events_ms": time_ms(
                              lambda: ec.up_conv_fwd(x, w, plan), "cuda",
                              iters),
                          "dense_route_device_ms": device_time_ms(
                              lambda: sparse_up_conv(x, w, plan), iters)}),
              flush=True)
        for i, cfg in enumerate(up_configs(child.cap, cin, cout)):
            out = ec.launch_up_conv(x, wb, plan.child_parent, plan.groups,
                                    *cfg)
            if not torch.equal(out, ref):
                raise AssertionError(f"{base} {cfg}: differs from "
                                     f"{chosen}")
            print(json.dumps({**base, "kernel": "up_conv_fwd",
                              "bn_tpb": cfg, "chosen": i == 0,
                              "device_ms": device_time_ms(
                                  lambda: ec.launch_up_conv(
                                      x, wb, plan.child_parent, plan.groups,
                                      *cfg), iters)}), flush=True)

        # kernel 4: the wrapper, the plain version, the replaced design
        dx, dw = ec.up_conv_bwd(x, w, g, plan)
        dx_p, dw_p = ec.up_conv_bwd_plain(x, w, g, plan)
        err_x = (dx.float() - dx_p.float()).abs().max().item()
        err_w = (dw - dw_p).abs().max().item()
        if not (err_x <= BF16_ULP * dx_p.float().abs().max().item()
                and err_w <= 1e-4 * dw_p.abs().max().item()
                and not dx[parent.num:].any()):
            raise AssertionError(f"{base}: kernel 4 differs from its plain "
                                 f"version: dx {err_x}, dW {err_w}")

        def replaced():
            return (sc.gather_gemm_cuda(g, w.transpose(1, 2), plan.fwd),
                    sc.gather_wgrad_cuda(x, g, plan.fwd))

        print(json.dumps({**base, "kernel": "up_conv_bwd",
                          "dx_max_abs_err": err_x, "dw_max_abs_err": err_w,
                          "wrapper_device_ms": device_time_ms(
                              lambda: ec.up_conv_bwd(x, w, g, plan), iters),
                          "wrapper_events_ms": time_ms(
                              lambda: ec.up_conv_bwd(x, w, g, plan), "cuda",
                              iters),
                          "replaced_dense_device_ms": device_time_ms(
                              replaced, iters)}), flush=True)
        ref_dx = sc.launch_gather_gemm(g, wb, plan.fwd, plan.skip,
                                       *dx_configs(parent.cap, cin, cout)[0],
                                       w_nk=True)
        for i, cfg in enumerate(dx_configs(parent.cap, cin, cout)):
            out = sc.launch_gather_gemm(g, wb, plan.fwd, plan.skip, *cfg,
                                        w_nk=True)
            e = (out.float() - ref_dx.float()).abs().max().item()
            if not e <= BF16_ULP * ref_dx.float().abs().max().item():
                raise AssertionError(f"{base} dx {cfg}: differs by {e}")
            print(json.dumps({**base, "kernel": "up_conv_bwd dx",
                              "bm_bn_groups": cfg, "chosen": i == 0,
                              "device_ms": device_time_ms(
                                  lambda: sc.launch_gather_gemm(
                                      g, wb, plan.fwd, plan.skip, *cfg,
                                      w_nk=True), iters)}), flush=True)
        pairs = (plan.groups.rows, plan.groups.count)
        for i, cfg in enumerate(wgrad_configs(
                parent.cap, cin, cout,
                ec.up_wgrad_tiles(parent.cap, cin, cout))):
            def launch(cfg=cfg):
                return sc.launch_gather_wgrad(
                    x, g, None, pairs, *cfg, amap=plan.child_parent,
                    seg_tile=ec.EDGE_TILE)
            e = (launch() - dw).abs().max().item()
            if not e <= 1e-4 * dw.abs().max().item():
                raise AssertionError(f"{base} dW {cfg}: differs by {e}")
            print(json.dumps({**base, "kernel": "up_conv_bwd dW",
                              "bma_bnb_per_splits": cfg, "chosen": i == 0,
                              "device_ms": device_time_ms(launch, iters)}),
                  flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dev_up_tiles needs a CUDA device")
    from ..device import resolve_device
    resolve_device("cuda")
    coords, num = synthetic_batch(
        args.scenes, os.path.join(HERE, "build", "up_tiles_data"))
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
