"""Tile sweep of the down conv's kernels on the card (kernels 3 and 6).

Builds the geometry of one synthetic train batch on the card per scene
count (as ``dev_up_tiles`` does, every edge with its groups and skip plan)
and, at MinkUNet18A's four down-conv widths, times

* the forward (kernel 3, ``csrc/gather_gemm_fwd.cu`` in skip mode on the
  edge's ``EdgeSkip``) under every legal row tile, column tile and offset
  group count, with the fragment epilogue and with the staged 16-byte
  epilogue, beside the configuration ``edge_conv.down_tiles`` chooses, the
  wrapper ``down_conv_fwd`` and the design it replaced (every offset at
  every parent, :func:`replaced_down_fwd`);
* the backward (kernel 6): the wrapper ``down_conv_bwd`` against the plain
  version (``dx`` one bf16 ulp, ``dW`` 1e-4 of the scale) and the design it
  replaced (:func:`replaced_down_bwd`), and its two launches apart: ``dx``
  (``csrc/up_conv_fwd.cu`` with ``W_NK`` over the groups) under every
  legal column tile and tiles-per-block count, ``dW``
  (``csrc/gather_gemm_bwd.cu`` in group mode) under every legal tile and
  row split;
* the staged epilogue on the stencil forward at L0 128 -> 96 (TPU kernel
  1's main shape), on and off, at ``fwd_tiles``' pick.

Every configuration's output is held against the chosen one's (one bf16
ulp of the scale; ``dW`` 1e-4), and bit for bit against the others that sum
each row in the same order (one offset group; every ``dx`` tile).  Each
line is one JSON object of device milliseconds with the host's enqueue
hidden (``timing.device_time_ms``); after each batch one ``best`` line per
kernel and edge puts the sweep's fastest configuration beside the chooser's
pick.

Run on the card: ``python -m openscene_tpu_torch.scripts.dev_down_tiles
[--scenes 2 8] [--iters 20]``.
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
from .dev_bench_ops import DOWN_CH, HERE, synthetic_batch
from .dev_up_tiles import wgrad_configs
from .timing import card_line, device_time_ms, time_ms

BF16_ULP = 2.0 ** -7


def replaced_down_fwd(x, w, plan):
    """The down-conv forward before the redesign: every offset at every
    parent (``gather_gemm_fwd.cu`` in dense mode)."""
    return sc.gather_gemm_cuda(x, w, plan.fwd)


def replaced_down_bwd(x, w, g, plan):
    """The down-conv backward before the redesign: ``dx`` a K=8
    gather-GEMM over the children on a transposed weight, with 7 of each
    child's 8 indices -1, and ``dW^T`` a dense K=8 reduction over every
    parent."""
    gb = g.to(torch.bfloat16).contiguous()
    offsets = torch.arange(8, dtype=torch.int32, device=x.device)
    idx = torch.where(plan.child_offset[None, :] == offsets[:, None],
                      plan.child_parent[None, :],
                      plan.child_parent.new_full((), -1))
    dx = sc.gather_gemm_cuda(gb, w.transpose(1, 2), idx.contiguous())
    dw = sc.gather_wgrad_cuda(gb, x, plan.fwd).transpose(1, 2).contiguous()
    return dx, dw


def fwd_configs(rows, cin, cout):
    """Every legal (bm, bn, groups, staged) of the down-conv forward, the
    chooser's first."""
    out = [ec.down_tiles(rows, cin, cout)]
    for bm in sc.FWD_ROW_TILES:
        for bn in sc.FWD_COL_TILES:
            if (-(-cout // bn) * bn - cout >= bn
                    or (bm // 32) * (bn // 32) > sc.MAX_WARPS):
                continue
            for groups, staged in ((1, False), (1, True), (2, False),
                                   (4, False), (8, False)):
                if (bm, bn, groups, staged) not in out:
                    out.append((bm, bn, groups, staged))
    return out


def dx_configs(child_cap, cin, cout):
    """Every legal (bn, tpb) of the down-conv ``dx`` (a Cout -> Cin launch
    of ``up_conv_fwd.cu`` with ``W_NK``), the chooser's first."""
    out = [ec.down_dx_tiles(child_cap, cin, cout)]
    for bn in sc.FWD_COL_TILES:
        if -(-cin // bn) * bn - cin >= bn:
            continue
        for tpb in (1, 2, 3, 4, 6, 8, 12, 16):
            if (bn, tpb) not in out and ec._up_smem(cout, bn, tpb, True) \
                    <= ec.UP_SMEM:
                out.append((bn, tpb))
    return out


def _best_lines(rows):
    """{kernel, edge, best config and ms, chosen config and ms} per
    (kernel, edge) of the sweep's rows."""
    out = []
    for key in sorted({(r["kernel"], r["edge"]) for r in rows}):
        group = [r for r in rows if (r["kernel"], r["edge"]) == key]
        best = min(group, key=lambda r: r["device_ms"])
        chosen = next(r for r in group if r["chosen"])
        out.append({"best": key[0], "edge": key[1],
                    "best_config": best["config"],
                    "best_ms": best["device_ms"],
                    "chosen_config": chosen["config"],
                    "chosen_ms": chosen["device_ms"]})
    return out


def sweep(geo, iters, scenes, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16

    def acts(lv, c):
        x = torch.randn((lv.cap, c), generator=gen, device="cuda")
        x[lv.num:] = 0
        return x.to(bf16)

    rows = []

    def row(base, kernel, cfg, chosen, fn):
        r = {**base, "kernel": kernel, "config": cfg, "chosen": chosen,
             "device_ms": device_time_ms(fn, iters)}
        rows.append(r)
        print(json.dumps(r), flush=True)

    def close(a, b, what):
        e = (a.float() - b.float()).abs().max().item()
        if not e <= BF16_ULP * b.float().abs().max().item():
            raise AssertionError(f"{what}: differs by {e}")
        return e

    for edge in range(4):
        c = DOWN_CH[edge]
        plan = geo.down[edge]
        child, parent = geo.levels[edge], geo.levels[edge + 1]
        x, g = acts(child, c), acts(parent, c)
        w = torch.randn((8, c, c), generator=gen, device="cuda") * \
            (2.0 / (8 * c)) ** 0.5
        wb = w.to(bf16)
        base = {"scenes": scenes, "edge": edge, "shape": f"{c}->{c}",
                "child_cap": child.cap, "child_num": child.num,
                "parent_cap": parent.cap, "parent_num": parent.num}

        # kernel 3: the wrapper, the plain version, the replaced design
        out = ec.down_conv_fwd(x, w, plan)
        err = close(out, ec.down_conv_plain(x, w, plan), f"{base} fwd")
        if out[parent.num:].any():
            raise AssertionError(f"{base}: padded parent rows not zero")
        print(json.dumps({**base, "kernel": "down_conv_fwd",
                          "max_abs_err": err,
                          "wrapper_device_ms": device_time_ms(
                              lambda: ec.down_conv_fwd(x, w, plan), iters),
                          "wrapper_events_ms": time_ms(
                              lambda: ec.down_conv_fwd(x, w, plan), "cuda",
                              iters),
                          "replaced_dense_device_ms": device_time_ms(
                              lambda: replaced_down_fwd(x, w, plan),
                              iters)}), flush=True)
        one = None  # the first one-group output: the others' bits
        for i, (bm, bn, groups, staged) in enumerate(
                fwd_configs(parent.cap, c, c)):
            def launch(bm=bm, bn=bn, groups=groups, staged=staged):
                return sc.launch_gather_gemm(x, wb, plan.fwd, plan.skip, bm,
                                             bn, groups, staged=staged)
            got = launch()
            if groups == 1:
                one = got if one is None else one
                if not torch.equal(got, one):
                    raise AssertionError(f"{base} fwd {(bm, bn, staged)}: "
                                         "one-group outputs differ")
            close(got, out, f"{base} fwd {(bm, bn, groups)}")
            row(base, "down_conv_fwd", [bm, bn, groups, staged], i == 0,
                launch)

        # kernel 6: the wrapper, the plain version, the replaced design
        dx, dw = ec.down_conv_bwd(x, w, g, plan)
        dx_p, dw_p = ec.down_conv_bwd_plain(x, w, g, plan)
        err_x = close(dx, dx_p, f"{base} dx")
        err_w = (dw - dw_p).abs().max().item()
        if not (err_w <= 1e-4 * dw_p.abs().max().item()
                and not dx[child.num:].any()):
            raise AssertionError(f"{base}: kernel 6 dW differs by {err_w} "
                                 "(or padded dx rows)")
        print(json.dumps({**base, "kernel": "down_conv_bwd",
                          "dx_max_abs_err": err_x, "dw_max_abs_err": err_w,
                          "wrapper_device_ms": device_time_ms(
                              lambda: ec.down_conv_bwd(x, w, g, plan),
                              iters),
                          "wrapper_events_ms": time_ms(
                              lambda: ec.down_conv_bwd(x, w, g, plan),
                              "cuda", iters),
                          "replaced_dense_device_ms": device_time_ms(
                              lambda: replaced_down_bwd(x, w, g, plan),
                              iters)}), flush=True)
        for i, cfg in enumerate(dx_configs(child.cap, c, c)):
            def launch(cfg=cfg):
                return ec.launch_up_conv(g, wb, plan.child_parent,
                                         plan.groups, *cfg, w_nk=True)
            if not torch.equal(launch(), dx):
                raise AssertionError(f"{base} dx {cfg}: not bit-equal to "
                                     "the chosen one")
            row(base, "down_conv_bwd dx", list(cfg), i == 0, launch)
        pairs = (plan.groups.rows, plan.groups.count)
        # dW^T: a = the parents' cotangent (Cout), b = the children (Cin)
        for i, cfg in enumerate(wgrad_configs(
                parent.cap, c, c, ec.down_wgrad_tiles(parent.cap, c, c))):
            def launch(cfg=cfg):
                return sc.launch_gather_wgrad(
                    g, x, None, pairs, *cfg, amap=plan.child_parent,
                    seg_tile=ec.EDGE_TILE)
            e = (launch().transpose(1, 2) - dw).abs().max().item()
            if not e <= 1e-4 * dw.abs().max().item():
                raise AssertionError(f"{base} dW {cfg}: differs by {e}")
            row(base, "down_conv_bwd dW", list(cfg), i == 0, launch)

    # the staged epilogue at the stencil forward's L0 128 -> 96
    plan = geo.self3[0]
    x = acts(geo.levels[0], 128)
    wb = (torch.randn((27, 128, 96), generator=gen, device="cuda")
          * (2.0 / (27 * 96)) ** 0.5).to(bf16)
    bm, bn, groups = sc.fwd_tiles(geo.levels[0].cap, 27, 128, 96, True)
    base = {"scenes": scenes, "edge": "L0 stencil", "shape": "128->96"}
    ref = sc.launch_gather_gemm(x, wb, plan.fwd, plan.skip, bm, bn, groups)
    for staged in (False, True):
        cfg = (bm, bn, 1 if staged else groups)

        def launch(cfg=cfg, staged=staged):
            return sc.launch_gather_gemm(x, wb, plan.fwd, plan.skip, *cfg,
                                         staged=staged)
        close(launch(), ref, f"{base} staged={staged}")
        row(base, "stencil_conv_fwd", list(cfg) + [staged], not staged,
            launch)
    for r in _best_lines(rows):
        print(json.dumps({"scenes": scenes, **r}), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", type=int, nargs="+", default=[2, 8])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dev_down_tiles needs a CUDA device")
    from ..device import resolve_device
    resolve_device("cuda")
    card = card_line()
    for scenes in args.scenes:
        coords, num = synthetic_batch(
            scenes, os.path.join(HERE, "build", f"down_tiles_data{scenes}"))
        coords = coords[:num]
        caps = tuple(_bucket(c) for c in level_counts(coords))
        c0 = torch.as_tensor(_pad_level(coords, caps[0]).coords,
                             device="cuda")
        geo, over = with_host_counts(*build_geometry_parts(
            c0, num, caps, n_scenes=scenes))
        if over:
            raise AssertionError(f"geometry overflowed (caps {caps})")
        print(f"# {num} voxels, {scenes} scenes, caps {caps}, valid "
              f"{[lv.num for lv in geo.levels]} [{card}]", flush=True)
        sweep(geo, args.iters, scenes)
        del geo, c0
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
