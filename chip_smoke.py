#!/usr/bin/env python3
"""On-card smoke run of ``openscene_tpu_torch`` (one NVIDIA Hopper GPU).

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. prints the card's name and power limit (``nvidia-smi``) and builds every
   CUDA kernel of the port from ``openscene_tpu_torch/csrc`` (four sources,
   one ``nvcc`` each, all started together) into ``build/kernels``;
2. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (forward kernels on scene 0's geometry, backward
   kernels on the first train batch's, the stencil kernels with each
   level's skip plan; tolerance: one bf16 ulp of the output scale,
   ``2**-7 * max|plain|``, for activations and input gradients, with padded
   rows exactly zero; ``1e-4`` of the scale for the fp32 weight gradients,
   which differ only in the order of their fp32 sums; every kernel
   bit-identical across two launches on the same inputs) and times the
   kernel, the plain version and a library yardstick (``index_select`` +
   ``torch.matmul``, the im2col formulation, which the port never calls):
   device times with the host's enqueue hidden behind a sleep kernel, and
   the kernel's and the library call's host-inclusive times of back-to-back
   calls beside them;
3. builds the first train batch's geometry on the card from its level-0
   coordinates, with the occupancy grid and with the search path (stem
   occupancy on), and requires every array to equal the NumPy builder's for
   the same caps bit for bit, and every level's skip plan to equal the one
   built for the host plans, with no overflow; prints the build times, the
   NumPy planner's time and the bytes a raw and a host-geometry batch copy
   to the card; then prints the skip plans' shares (pairs with a neighbour,
   (tile, offset) steps the forward runs) and build time;
4. holds kernel 5 (the up conv over the children, ``up_conv_fwd``) against
   its plain version at the four edges of that batch (one bf16 ulp, padded
   rows exactly 0) beside the model's dense route, and drives kernel 7 (the
   pair-packed transpose, ``pack_pairs_t``) through its benchmark
   (``scripts/dev_pack_bench.bench_pack``) at its five shapes, where kernel,
   plain version and one PyTorch call must be bit-equal;
5. drives the serving path: zero-shot evaluation of MinkUNet18A at 768-d
   OpenSeg width through ``runtime.evaluate.ZeroShotEvaluator`` on ``cuda``,
   in ensemble and distill modes, on 2 synthetic ScanNet-like scenes at 2 cm
   (about 125k voxels each), random weights from a seed and pseudo text
   embeddings.  Every kernel's launch counter is set to 0 just before each
   run and read just after: each stencil-conv kernel must launch 32 times
   and the down-conv kernel 4 times per scene forward.  The outputs must be
   finite, and one scene's logits from the kernel path must match the same
   model run through the plain versions on the card;
6. drives the training path: ``runtime.distill.DistillTrainer`` on ``cuda``
   (device geometry ``auto``, so on), MinkUNet18A, 768-d, cosine loss,
   bf16, batches of 2 synthetic train scenes at 2 cm (about 270k voxels),
   3 steps.  The launch counters are set to 0 before each step and read
   after it: 32 stencil and 4 down-conv forward launches and 32 stencil, 4
   down-conv and 4 up-conv backward launches per step, and no overflow.
   Losses must be finite and the third below the first.  One step through
   device geometry and one through host geometry on the same batch, caps
   and starting state must give the same loss and gradients exactly.  Each
   is profiled once, and the stencil sources' device ms are printed beside
   the previous design's.  Then
   one more step runs from the same model and optimizer state through the
   kernels, through the plain versions, and through the plain versions in
   fp32: the loss and the updated parameters of the first two must agree,
   and the kernel path's gradients must be as close to the fp32 step's as
   the plain bf16 path's are (``compare_train_step`` states the limits and
   why bf16 noise is measured rather than assumed);
7. runs the per-op benchmark (``scripts/dev_bench_ops.bench_ops``) on the
   train batch with few iterations: the main path of kernel 5;
8. prints the card line, one ``{"kernels": [...]}`` JSON line, and last
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, and the script exits non-zero without the last
line.  It also exits non-zero when CUDA is unavailable, or when the port's
package is not beside it.
"""

import functools
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BF16_ULP = 2.0 ** -7
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
N_SCENES = 2
DENSITY = 2200.0            # bench.py's synthetic ScanNet density
VOXEL = 0.02
DIM = 768
ARCH = "MinkUNet18A"
MODES = ("ensemble", "distill")
STENCILS_PER_FORWARD = 32
DOWNS_PER_FORWARD = 4
UPS_PER_FORWARD = 4
TRAIN_BATCH = 2
TRAIN_STEPS = 3
DW_TOL = 1e-4               # weight gradients: fraction of max|plain dW|
RESOLVED = 0.1              # an element's |fp32 grad| over its tensor's max
PARAM_TOL_RESOLVED = 0.5    # updated parameters, kernels against plain, as
PARAM_TOL_MEAN = 0.02       # fractions of the step's learning rate
PARAM_TOL_ALL = 1.0
BENCH_ITERS = 3             # per-op benchmark on the train batch
# PERF.md §5: device ms of the two stencil kernels (gather_gemm_fwd,
# gather_wgrad) in a profiled raw train step of the dense split-row design
# that preceded the skip plans, on an NVIDIA H100 80GB HBM3 at 700 W
DENSE_DESIGN_TRAIN_CONV_MS = (53.8, 36.3)
REPLACES = {
    "stencil_conv_fwd": "openscene_tpu/sparse/pallas_conv.py:371",
    "stencil_conv_bwd": "openscene_tpu/sparse/pallas_conv.py:447",
    "down_conv_fwd": "openscene_tpu/sparse/pallas_edge.py:312",
    "up_conv_bwd": "openscene_tpu/sparse/pallas_edge.py:374",
    "down_conv_bwd": "openscene_tpu/sparse/pallas_edge.py:522",
    "up_conv_fwd": "openscene_tpu/sparse/pallas_edge.py:454",
    "pack_pairs_t": "scripts/dev_pack_bench.py:42"}
FWD_SOURCE = "openscene_tpu_torch/csrc/gather_gemm_fwd.cu"
BWD_SOURCE = "openscene_tpu_torch/csrc/gather_gemm_bwd.cu"
SOURCES = {"stencil_conv_fwd": FWD_SOURCE, "down_conv_fwd": FWD_SOURCE,
           "stencil_conv_bwd": BWD_SOURCE, "up_conv_bwd": BWD_SOURCE,
           "down_conv_bwd": BWD_SOURCE,
           "up_conv_fwd": "openscene_tpu_torch/csrc/up_conv_fwd.cu",
           "pack_pairs_t": "openscene_tpu_torch/csrc/pack_pairs_t.cu"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def device_ms(fn, iters=20, warmup=3):
    """Device milliseconds per call of ``fn`` with the host's enqueue hidden
    behind a sleep kernel (``scripts/timing.py:device_time_ms``): the
    kernels', plain versions' and library calls' times."""
    from openscene_tpu_torch.scripts.timing import device_time_ms
    return device_time_ms(fn, iters, warmup)


def cuda_time_ms(fn, iters=20, warmup=3):
    """CUDA-event milliseconds per call of back-to-back calls of ``fn``:
    where the host enqueues more slowly than the device runs, the host's
    time (a wrapper's "host_ms", launch-bound builds)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_dataset(root):
    from openscene_tpu_torch.data.synthetic import build_synthetic_dataset
    shutil.rmtree(root, ignore_errors=True)
    return build_synthetic_dataset(root, n_train=TRAIN_BATCH, n_val=N_SCENES,
                                   dim=DIM, density=DENSITY)


def eval_config(d3, dfeat, mode):
    from openscene_tpu_torch.config import Config
    return Config(data_root=d3, data_root_2d_fused_feature=dfeat,
                  feature_2d_extractor="openseg", voxel_size=VOXEL,
                  split="val", feature_type=mode, arch_3d=ARCH,
                  test_repeats=1, test_workers=2, manual_seed=0,
                  allow_pseudo_text=True, text_embedding_cache="")


def train_config(d3, dfeat):
    from openscene_tpu_torch.config import Config
    return Config(data_root=d3, data_root_2d_fused_feature=dfeat,
                  feature_2d_extractor="openseg", voxel_size=VOXEL,
                  arch_3d=ARCH, loss_type="cosine",
                  compute_dtype="bfloat16", batch_size=TRAIN_BATCH,
                  epochs=1, loop=TRAIN_STEPS + 7, workers=1,
                  evaluate=False, manual_seed=0, allow_pseudo_text=True,
                  text_embedding_cache="",
                  save_path=os.path.join(HERE, "build", "smoke_exp"))


def bound(K, rows_in, rows_out, pairs, cin, cout):
    """Least time on an H100 SXM for (rows_in, cin) -> (rows_out, cout):
    each input row read once, each output row written once, K index entries
    per output row, the bf16 weights; 2*cin*cout operations per (offset,
    row) pair.  Returns (ms, "bytes" or "operations")."""
    nbytes = (rows_in * cin + rows_out * cout) * 2 + K * rows_out * 4 \
        + K * cin * cout * 2
    flops = 2.0 * pairs * cin * cout
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_case(name, wrapper, plain, x, w, idx, n_in, n_out):
    """Compare one kernel with its plain version and time both."""
    import torch
    K, cin, cout = w.shape
    out = wrapper(x, w, idx)
    ref = plain(x, w, idx)
    again = wrapper(x, w, idx)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = BF16_ULP * ref.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name} {cin}->{cout}: max|kernel-plain| "
                             f"{err} > {tol}")
    if out[n_out:].any():
        raise AssertionError(f"{name}: padded output rows are not zero")
    if not torch.equal(out, again):
        raise AssertionError(f"{name} {cin}->{cout}: two launches differ")
    wb = w.to(torch.bfloat16)
    rows = idx.shape[1]

    def im2col():
        g = x.index_select(0, idx.reshape(-1)).reshape(K, rows, cin)
        return torch.matmul(g.transpose(0, 1).reshape(rows, K * cin),
                            wb.reshape(K * cin, cout))

    # bound of this data: valid rows, and only the (offset, row) pairs whose
    # neighbour exists; the dense bound counts every row of the caps and
    # all K offsets, the work the kernel's design does
    pairs = int((idx[:, :n_out] < n_in).sum().item())
    bound_ms, bound_by = bound(K, n_in, n_out, pairs, cin, cout)
    dense_ms, dense_by = bound(K, x.shape[0], rows, K * rows, cin, cout)
    return {"shape": f"K={K} {cin}->{cout} rows_in={x.shape[0]} "
                     f"rows_out={rows} (valid {n_in}->{n_out}, "
                     f"{pairs} neighbour pairs)",
            "max_abs_err": err, "tol": tol, "deterministic": True,
            "ms": device_ms(lambda: wrapper(x, w, idx)),
            "host_ms": cuda_time_ms(lambda: wrapper(x, w, idx)),
            "plain_ms": device_ms(lambda: plain(x, w, idx), iters=5),
            "library_ms": device_ms(im2col, iters=5),
            "library_host_ms": cuda_time_ms(im2col, iters=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "dense_bound_ms": dense_ms, "dense_bound_by": dense_by}


def kernels_phase(geo):
    """Each kernel at the main path's shapes, on scene 0's geometry."""
    import torch
    from openscene_tpu_torch.sparse.edge_conv import (down_conv_fwd,
                                                      down_conv_plain)
    from openscene_tpu_torch.sparse.stencil_conv import (stencil_conv_fwd,
                                                         stencil_conv_plain)
    g = torch.Generator(device="cuda").manual_seed(0)

    def acts(level, c):
        lv = geo.levels[level]
        x = torch.randn((lv.cap, c), generator=g, device="cuda")
        x[lv.num:] = 0
        return x.to(torch.bfloat16)

    def weights(K, cin, cout):
        return torch.randn((K, cin, cout), generator=g, device="cuda") * \
            (2.0 / (K * cout)) ** 0.5

    stencil = []
    for level, cin, cout in ((0, 128, 96), (0, 96, 96), (4, 256, 256)):
        n = geo.levels[level].num
        skip = geo.self3[level].skip
        if skip is None:
            raise AssertionError(f"level {level}: the plan has no skip plan")
        stencil.append(kernel_case(
            "stencil_conv_fwd",
            functools.partial(stencil_conv_fwd, skip=skip),
            stencil_conv_plain, acts(level, cin), weights(27, cin, cout),
            geo.self3[level].fwd, n, n))
    # the k=5 stem on colour input (off the main path, whose input is the
    # constant feature): 3 channels zero-padded to 8, K = 125
    n = geo.levels[0].num
    stencil.append(kernel_case(
        "stencil_conv_fwd", stencil_conv_fwd, stencil_conv_plain,
        acts(0, 8), weights(125, 8, 32), geo.stem.fwd, n, n))
    down = [kernel_case(
        "down_conv_fwd", down_conv_fwd, down_conv_plain, acts(0, 32),
        weights(8, 32, 32), geo.down[0].fwd, geo.levels[0].num,
        geo.levels[1].num)]
    return {"stencil_conv_fwd": stencil, "down_conv_fwd": down}


def bound_bwd(rows_x, rows_g, n_idx, pairs, K, cin, cout):
    """Least time on an H100 SXM for one conv backward, dx and dW together:
    x, g and dx rows once (bf16), the int32 plan entries, the bf16 weights
    and the fp32 dW; two products of 2*cin*cout operations per (offset, row)
    pair.  Returns (ms, "bytes" or "operations")."""
    nbytes = (2 * rows_x * cin + rows_g * cout) * 2 + n_idx * 4 \
        + K * cin * cout * (2 + 4)
    flops = 2 * 2.0 * pairs * cin * cout
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bwd_case(name, kernel, plain, library, n_dx, shape, bounds):
    """Compare one backward wrapper with its plain version and time it,
    the plain version and the library formulation.  ``kernel``, ``plain``
    and ``library`` are closures over the same inputs returning (dx, dW);
    ``bounds`` = ((data ms, by), (dense ms, by))."""
    import torch
    dx, dw = kernel()
    dx_p, dw_p = plain()
    dx2, dw2 = kernel()
    torch.cuda.synchronize()
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError(f"{name} {shape}: two launches differ")
    err_x = (dx.float() - dx_p.float()).abs().max().item()
    tol_x = BF16_ULP * dx_p.float().abs().max().item()
    err_w = (dw - dw_p).abs().max().item()
    tol_w = DW_TOL * dw_p.abs().max().item()
    if dw.dtype != torch.float32 or dw.shape != dw_p.shape:
        raise AssertionError(f"{name}: dW {dw.dtype} {tuple(dw.shape)}")
    if not (err_x <= tol_x and err_w <= tol_w):
        raise AssertionError(f"{name} {shape}: max|dx - plain| {err_x} (tol "
                             f"{tol_x}), max|dW - plain| {err_w} (tol "
                             f"{tol_w})")
    if dx[n_dx:].any():
        raise AssertionError(f"{name}: padded dx rows are not zero")
    (b_ms, b_by), (d_ms, d_by) = bounds
    return {"shape": shape, "max_abs_err": err_x, "tol": tol_x,
            "dw_max_abs_err": err_w, "dw_tol": tol_w, "deterministic": True,
            "ms": device_ms(kernel),
            "host_ms": cuda_time_ms(kernel),
            "plain_ms": device_ms(plain, iters=5),
            "library_ms": device_ms(library, iters=5),
            "library_host_ms": cuda_time_ms(library, iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "dense_bound_ms": d_ms, "dense_bound_by": d_by}


def kernels_phase_bwd(geo):
    """Each backward wrapper at the train path's shapes, on the geometry of
    one train batch."""
    import torch
    from openscene_tpu_torch.sparse.edge_conv import (
        down_conv_bwd, down_conv_bwd_plain, up_conv_bwd, up_conv_bwd_plain)
    from openscene_tpu_torch.sparse.stencil_conv import (
        stencil_conv_bwd, stencil_conv_bwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16

    def acts(level, c):
        lv = geo.levels[level]
        x = torch.randn((lv.cap, c), generator=gen, device="cuda")
        x[lv.num:] = 0
        return x.to(bf16)

    def weights(K, cin, cout):
        return torch.randn((K, cin, cout), generator=gen, device="cuda") * \
            (2.0 / (K * cout)) ** 0.5

    def gathered(t, idx):  # (K, rows, C): the im2col buffer
        return t.index_select(0, idx.reshape(-1)).reshape(
            idx.shape[0], idx.shape[1], t.shape[1])

    stencil = []
    for level, cin, cout in ((0, 128, 96), (0, 96, 96), (4, 256, 256)):
        lv, plan = geo.levels[level], geo.self3[level]
        n, cap, K = lv.num, lv.cap, 27
        x, g, w = acts(level, cin), acts(level, cout), weights(K, cin, cout)
        wft = w.index_select(0, plan.flip_perm.long()).transpose(1, 2) \
            .to(bf16).reshape(K * cout, cin)

        def library(x=x, g=g, plan=plan, wft=wft, cap=cap):
            G = gathered(g, plan.fwd)
            dx = torch.matmul(G.transpose(0, 1).reshape(cap, -1), wft)
            dw = torch.matmul(x.t().unsqueeze(0), G)
            return dx, dw.index_select(0, plan.flip_perm.long())

        pairs = int((plan.fwd[:, :n] < n).sum().item())
        stencil.append(bwd_case(
            "stencil_conv_bwd",
            lambda x=x, w=w, g=g, p=plan: stencil_conv_bwd(
                x, w, g, p.fwd, p.flip_perm, p.skip),
            lambda x=x, w=w, g=g, p=plan: stencil_conv_bwd_plain(
                x, w, g, p.fwd, p.flip_perm),
            library, n,
            f"K=27 {cin}->{cout} rows={cap} (valid {n}, {pairs} neighbour "
            "pairs)",
            (bound_bwd(n, n, K * n, pairs, K, cin, cout),
             bound_bwd(cap, cap, K * cap, K * cap, K, cin, cout))))

    up, down = [], []
    for edge, up_w, down_w in ((0, (96, 96), (32, 32)),
                               (1, (128, 96), (32, 32))):
        plan = geo.down[edge]
        child, parent = geo.levels[edge], geo.levels[edge + 1]
        nc, np_, ccap, pcap = child.num, parent.num, child.cap, parent.cap
        what = (f"child rows {ccap} (valid {nc}), parent rows {pcap} "
                f"(valid {np_})")

        # up conv: x on the parents, g on the children
        cin, cout = up_w
        x, g, w = acts(edge + 1, cin), acts(edge, cout), weights(8, cin, cout)
        wt = w.transpose(1, 2).to(bf16).reshape(8 * cout, cin)

        def library(x=x, g=g, plan=plan, wt=wt, pcap=pcap):
            G = gathered(g, plan.fwd)
            dx = torch.matmul(G.transpose(0, 1).reshape(pcap, -1), wt)
            return dx, torch.matmul(x.t().unsqueeze(0), G)

        up.append(bwd_case(
            "up_conv_bwd",
            lambda x=x, w=w, g=g, p=plan: up_conv_bwd(x, w, g, p),
            lambda x=x, w=w, g=g, p=plan: up_conv_bwd_plain(x, w, g, p),
            library, np_, f"K=8 {cin}->{cout} {what}",
            (bound_bwd(np_, nc, 8 * np_, nc, 8, cin, cout),
             bound_bwd(pcap, ccap, 8 * pcap, 8 * pcap, 8, cin, cout))))

        # down conv: x on the children, g on the parents
        cin, cout = down_w
        x, g, w = acts(edge, cin), acts(edge + 1, cout), weights(8, cin, cout)
        wt = w.transpose(1, 2).to(bf16)

        def library(x=x, g=g, plan=plan, wt=wt, cin=cin, pcap=pcap):
            y = torch.matmul(g.unsqueeze(0), wt).reshape(-1, cin)
            dx = y.index_select(
                0, plan.child_offset.long() * pcap + plan.child_parent)
            return dx, torch.matmul(gathered(x, plan.fwd).transpose(1, 2), g)

        down.append(bwd_case(
            "down_conv_bwd",
            lambda x=x, w=w, g=g, p=plan: down_conv_bwd(x, w, g, p),
            lambda x=x, w=w, g=g, p=plan: down_conv_bwd_plain(x, w, g, p),
            library, nc, f"K=8 {cin}->{cout} {what}",
            (bound_bwd(nc, np_, 8 * np_ + 2 * nc, nc, 8, cin, cout),
             bound_bwd(ccap, pcap, 8 * pcap + 2 * ccap, 8 * pcap, 8, cin,
                       cout))))
    return {"stencil_conv_bwd": stencil, "up_conv_bwd": up,
            "down_conv_bwd": down}


def skip_phase(geo, card):
    """The skip plans of the train batch's levels: build time on the card,
    the share of (row, offset) pairs that hold a neighbour and the share of
    (tile, offset) steps the forward kernel runs at L0 128->96's row tile."""
    from openscene_tpu_torch.sparse import stencil_conv as sc

    def build_all():
        return [sc.build_conv_skip(p.fwd, lv.num)
                for p, lv in zip(geo.self3, geo.levels)]
    out = {"build_ms": cuda_time_ms(build_all, iters=5), "levels": []}
    for lvl, skip in enumerate(build_all()):
        n, cap = geo.levels[lvl].num, geo.levels[lvl].cap
        pairs = int(skip.pair_count.sum().item())
        tm = skip.tile_mask.cpu().tolist()
        bm = sc.fwd_tiles(cap, 27, 128, 96, True)[0]
        per = bm // sc.TILE_ROWS
        steps = 0
        for t in range(0, len(tm), per):
            m = 0
            for v in tm[t:t + per]:
                m |= v
            steps += bin(m).count("1")
        row = {"level": lvl, "pair_share": pairs / (27 * n),
               "pairs_per_row": pairs / n,
               "active_tile_offset_share": steps / (-(-cap // bm) * 27),
               "tile_rows": bm}
        out["levels"].append(row)
        print(f"skip plan L{lvl}: pairs {row['pair_share']:.4f} of 27*num "
              f"({row['pairs_per_row']:.3f} per row), active (tile, offset) "
              f"steps {row['active_tile_offset_share']:.4f} at {bm}-row "
              f"tiles", flush=True)
    print(f"skip plan build ms (5 levels, CUDA events): "
          f"{out['build_ms']:.4f} [{card}]", flush=True)
    return out


def geo_arrays(geo):
    """{name: tensor} of every array of a geometry (levels, plans, edges,
    stem occupancy), for a bit-for-bit comparison."""
    out = {}
    for i, lv in enumerate(geo.levels):
        out[f"levels[{i}].coords"] = lv.coords
    for name, plan in [("stem", geo.stem)] + [
            (f"self3[{i}]", p) for i, p in enumerate(geo.self3)]:
        if plan.fwd is not None:
            out[f"{name}.fwd"] = plan.fwd
        out[f"{name}.flip_perm"] = plan.flip_perm
    for e, d in enumerate(geo.down):
        for f in d._fields:
            out[f"down[{e}].{f}"] = getattr(d, f)
    return out


def geometry_phase(raw, caps, host_geo, t_numpy, card, host_dev):
    """The raw batch's geometry built on the card, grid and search paths,
    stem occupancy on, against the NumPy builder's for the same caps; and
    each level's skip plan against the one ``geometry_to_device`` built on
    the card for the NumPy plans (``host_dev``)."""
    import numpy as np
    import torch
    from openscene_tpu_torch.sparse.geometry_device import (
        build_geometry_parts, with_host_counts)
    dev = torch.device("cuda")
    coords = torch.as_tensor(raw.coords, device=dev)
    num = int(raw.num)
    ref = {k: np.asarray(v) for k, v in geo_arrays(host_geo).items()}
    ref_occ = (np.asarray(host_geo.stem.fwd)
               < int(host_geo.levels[0].num)).astype(np.float32)
    times = {}
    for path, n_scenes in (("grid", TRAIN_BATCH), ("search", None)):
        def build():
            return build_geometry_parts(coords, num, caps,
                                        stem_occupancy=True,
                                        n_scenes=n_scenes)
        geo, over = with_host_counts(*build())
        if over:
            raise AssertionError(
                f"geometry on the card ({path}) overflowed for caps {caps}: "
                "the scenes leave the grid (set grid_dims0) or a level cap")
        got = geo_arrays(geo)
        if set(got) != set(ref) - {"stem.fwd"}:
            raise AssertionError(f"{path}: arrays {sorted(got)}")
        for name, arr in got.items():
            if not np.array_equal(arr.cpu().numpy(), ref[name]):
                raise AssertionError(f"{path}: {name} differs from the NumPy "
                                     "builder's")
        if [lv.num for lv in geo.levels] != [int(lv.num)
                                             for lv in host_geo.levels]:
            raise AssertionError(f"{path}: level counts differ")
        if not np.array_equal(geo.stem_occ.float().cpu().numpy(), ref_occ):
            raise AssertionError(f"{path}: stem occupancy differs")
        for lvl, (p, q) in enumerate(zip(geo.self3, host_dev.self3)):
            for f in p.skip._fields:
                if not torch.equal(getattr(p.skip, f), getattr(q.skip, f)):
                    raise AssertionError(f"{path}: self3[{lvl}].skip.{f} "
                                         "differs from the host path's")
        del geo, got
        torch.cuda.synchronize()
        t0 = time.time()
        with_host_counts(*build())
        wall = time.time() - t0
        times[path] = (cuda_time_ms(build, iters=5, warmup=1), wall * 1e3)
    # what each step copies to the card: the level-0 buffers (features,
    # 768-d fp16 targets, mask) in both cases, and the geometry: the raw
    # batch's coordinates or every plan array of the host builder
    common = sum(np.asarray(a).nbytes for a in (raw.feats, raw.feat_3d,
                                                 raw.mask))
    raw_geo = np.asarray(raw.coords).nbytes
    host_geo_bytes = sum(a.nbytes for a in ref.values())
    print(f"geometry on the card: {len(ref) - 1} arrays and the stem "
          f"occupancy bit-identical to the NumPy builder, the 5 levels' skip "
          f"plans to the host path's (caps {caps}), no "
          f"overflow; build grid {times['grid'][0]:.3f} ms (wall with the "
          f"count read {times['grid'][1]:.1f} ms), search "
          f"{times['search'][0]:.3f} ms (wall {times['search'][1]:.1f} ms); "
          f"NumPy planner {t_numpy * 1e3:.1f} ms; geometry bytes to the "
          f"card per batch: raw {raw_geo} ({raw_geo / 2**20:.1f} MiB), "
          f"host {host_geo_bytes} ({host_geo_bytes / 2**20:.1f} MiB), "
          f"besides {common} ({common / 2**20:.1f} MiB) of features, "
          f"targets and mask in both [{card}]", flush=True)
    return {"build_grid_ms": times["grid"][0],
            "build_search_ms": times["search"][0],
            "numpy_planner_ms": t_numpy * 1e3, "raw_geometry_bytes": raw_geo,
            "host_geometry_bytes": host_geo_bytes, "level0_bytes": common}


def up_kernel_phase(geo):
    """Kernel 5 against its plain version at the four edges of the train
    batch (MinkUNet18A's decoder widths), timed beside the model's dense
    route (the library yardstick)."""
    import torch
    from openscene_tpu_torch.sparse.edge_conv import (group_children,
                                                      launch_up_conv,
                                                      up_conv_dense_fwd,
                                                      up_conv_fwd,
                                                      up_conv_plain)
    from openscene_tpu_torch.sparse.types import DownPlan
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for edge, (cin, cout) in ((0, (96, 96)), (1, (128, 96)), (2, (128, 128)),
                              (3, (256, 128))):
        plan = DownPlan(*geo.down[edge])
        child, parent = geo.levels[edge], geo.levels[edge + 1]
        x = torch.randn((parent.cap, cin), generator=gen, device="cuda")
        x[parent.num:] = 0
        x = x.to(torch.bfloat16)
        w = torch.randn((8, cin, cout), generator=gen, device="cuda") * \
            (2.0 / (8 * cout)) ** 0.5
        out = up_conv_fwd(x, w, plan)
        ref = up_conv_plain(x, w, plan)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_ULP * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"up_conv_fwd edge {edge} {cin}->{cout}: "
                                 f"max|kernel-plain| {err} > {tol}")
        if out[child.num:].any():
            raise AssertionError("up_conv_fwd: padded child rows not zero")
        # bytes: parent rows read, child rows written, child_parent,
        # child_offset and the grouped index, the weights; operations: one
        # product per valid child
        nbytes = (parent.num * cin + child.num * cout) * 2 \
            + 3 * child.num * 4 + 8 * cin * cout * 2
        flops = 2.0 * child.num * cin * cout
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        wb = w.to(torch.bfloat16)
        grouped = group_children(plan.child_offset)
        cases.append({
            "shape": f"edge {edge} K=8 {cin}->{cout} parent rows "
                     f"{parent.cap} (valid {parent.num}), child rows "
                     f"{child.cap} (valid {child.num})",
            "max_abs_err": err, "tol": tol,
            "ms": device_ms(lambda: up_conv_fwd(x, w, plan)),
            "host_ms": cuda_time_ms(lambda: up_conv_fwd(x, w, plan)),
            "plain_ms": device_ms(lambda: up_conv_plain(x, w, plan),
                                  iters=5),
            "library_ms": device_ms(
                lambda: up_conv_dense_fwd(x, w, plan), iters=5),
            # the launch alone and the grouping alone (both inside "ms")
            "launch_only_ms": device_ms(lambda: launch_up_conv(
                x, wb, plan.child_parent, *grouped)),
            "grouping_ms": device_ms(
                lambda: group_children(plan.child_offset)),
            "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"})
    return cases


def compare_raw_host(trainer, raw, caps, host_batch):
    """One step through device geometry and one through host geometry on
    the same batch, caps and starting state: with bit-identical plans and
    deterministic kernels the loss and every gradient must be identical.
    The trainer's state is put back afterwards."""
    import copy
    import torch
    model, opt, step = trainer.model, trainer.optimizer, trainer.step_fn
    state0 = copy.deepcopy(model.state_dict())
    opt0 = copy.deepcopy(opt.state_dict())
    it0 = step.it

    def run(fn):
        model.load_state_dict(state0)
        opt.load_state_dict(copy.deepcopy(opt0))
        step.it = it0
        zero_counts()
        loss = fn()
        torch.cuda.synchronize()
        if read_counts() != expected(TRAIN_LAUNCHES):
            raise AssertionError(f"launches {read_counts()}")
        return (loss, {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: p.detach().clone() for n, p in model.named_parameters()})

    def raw_step():
        loss, over = trainer._raw_step(caps)(raw)
        if over:
            raise AssertionError("the raw step overflowed")
        return loss

    loss_r, grads_r, params_r = run(raw_step)
    loss_h, grads_h, params_h = run(lambda: step(host_batch))
    same_g = [n for n in grads_h if torch.equal(grads_r[n], grads_h[n])]
    same_p = [n for n in params_h if torch.equal(params_r[n], params_h[n])]
    print(f"raw step vs host step (same batch, caps {caps}, same state): "
          f"loss {loss_r.item():.9g} vs {loss_h.item():.9g}, "
          f"{len(same_g)}/{len(grads_h)} gradients and {len(same_p)}/"
          f"{len(params_h)} updated parameters identical", flush=True)
    if not (torch.equal(loss_r, loss_h) and len(same_g) == len(grads_h)
            and len(same_p) == len(params_h)):
        raise AssertionError("the device-geometry step differs from the "
                             "host-geometry step")
    model.load_state_dict(state0)
    opt.load_state_dict(copy.deepcopy(opt0))
    step.it = it0


def profile_device(fn, what):
    """Device time by kernel of one call of ``fn`` under torch.profiler."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []  # device-side events only: kernels and copies
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("Activity Buffer")):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"profiler[{what}]: no device time recorded (not measured)",
              flush=True)
    for ms, n, key in rows[:10]:
        print(f"profiler[{what}]: {ms:9.3f} ms {100 * ms / busy:5.1f}% "
              f"x{n:<4d} {key[:90]}", flush=True)
    return busy, rows


def conv_kernel_ms(rows):
    """{kernel: (launches, device ms)} of the two stencil sources' kernels
    in a profile (the offset groups' and the row splits' partial sums have
    a reduce each)."""
    out = {}
    for name in ("gather_gemm_fwd_kernel", "reduce_groups_kernel",
                 "gather_wgrad_kernel", "reduce_partials_kernel"):
        hit = [r for r in rows if name in r[2]]
        out[name] = (sum(r[1] for r in hit), sum(r[0] for r in hit))
    return out


def breakdown(step, model, text, sample, dim):
    """Host and device time of one scene: batch assembly (voxels are already
    loaded), the step to its synchronised end, and the device time by
    kernel under torch.profiler."""
    import torch
    from openscene_tpu_torch.data.batch import assemble_eval_batch
    t0 = time.time()
    batch = assemble_eval_batch([sample], dim)
    t_host = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    step(model, text, batch)
    torch.cuda.synchronize()
    t_step = time.time() - t0
    print(f"scene 0 breakdown: host assembly (geometry plans) "
          f"{t_host * 1e3:.1f} ms, device step (plans to device, forward, "
          f"text product) {t_step * 1e3:.1f} ms", flush=True)
    busy, _ = profile_device(lambda: step(model, text, batch), "eval")
    if busy:
        print(f"profiler[eval]: device busy {busy:.3f} ms in the profiled "
              f"step (unprofiled step {t_step * 1e3:.1f} ms)", flush=True)


def plain_path():
    """Context manager: the autograd Functions call the plain versions,
    forward and backward (for the on-card comparison of a whole forward or
    train step only)."""
    import contextlib
    from openscene_tpu_torch.sparse import edge_conv, stencil_conv

    wrappers()  # hold the kernel wrappers themselves before the names move

    def fwd_plain(x, w, fwd, skip=None):  # the plain versions need no skip
        return stencil_conv.stencil_conv_plain(x, w, fwd)

    def bwd_plain(x, w, g, fwd, flip_perm, skip=None):
        return stencil_conv.stencil_conv_bwd_plain(x, w, g, fwd, flip_perm)

    swaps = [(stencil_conv, "stencil_conv_fwd", fwd_plain),
             (stencil_conv, "stencil_conv_bwd", bwd_plain),
             (edge_conv, "down_conv_fwd", edge_conv.down_conv_plain),
             (edge_conv, "down_conv_bwd", edge_conv.down_conv_bwd_plain),
             (edge_conv, "up_conv_bwd", edge_conv.up_conv_bwd_plain)]

    @contextlib.contextmanager
    def ctx():
        saved = [getattr(mod, name) for mod, name, _ in swaps]
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        try:
            yield
        finally:
            for (mod, name, _), fn in zip(swaps, saved):
                setattr(mod, name, fn)
    return ctx()


@functools.lru_cache(maxsize=None)
def wrappers():
    """{name: wrapper} of the seven kernel wrappers, each with
    ``.launches``.  Looked up once, so that the counts set and read are
    those of the kernel wrappers also while :func:`plain_path` has the
    modules' names point at the plain versions."""
    from openscene_tpu_torch.sparse.edge_conv import (down_conv_bwd,
                                                      down_conv_fwd,
                                                      up_conv_bwd,
                                                      up_conv_fwd)
    from openscene_tpu_torch.sparse.pack import pack_pairs_t
    from openscene_tpu_torch.sparse.stencil_conv import (stencil_conv_bwd,
                                                         stencil_conv_fwd)
    return {"stencil_conv_fwd": stencil_conv_fwd,
            "down_conv_fwd": down_conv_fwd,
            "stencil_conv_bwd": stencil_conv_bwd,
            "down_conv_bwd": down_conv_bwd, "up_conv_bwd": up_conv_bwd,
            "up_conv_fwd": up_conv_fwd, "pack_pairs_t": pack_pairs_t}


def zero_counts():
    for w in wrappers().values():
        w.launches = 0


def read_counts():
    return {name: w.launches for name, w in wrappers().items()}


def expected(counts):
    """Every wrapper's count: ``counts``, and 0 for the rest."""
    out = dict.fromkeys(wrappers(), 0)
    out.update(counts)
    return out


TRAIN_LAUNCHES = {"stencil_conv_fwd": STENCILS_PER_FORWARD,
                  "down_conv_fwd": DOWNS_PER_FORWARD,
                  "stencil_conv_bwd": STENCILS_PER_FORWARD,
                  "down_conv_bwd": DOWNS_PER_FORWARD,
                  "up_conv_bwd": UPS_PER_FORWARD}


def train_phase(trainer, batches, card):
    """TRAIN_STEPS steps of the trainer on ``cuda`` through
    ``trainer.train_step``, device geometry on: raw batches, geometry built
    on the card.  Returns the launches counted.  ``batches`` yields
    ``(RawDistillBatch, caps)`` (host loading and assembly are timed around
    ``next``)."""
    import math
    import torch
    total = dict.fromkeys(wrappers(), 0)
    losses, voxels, t_host, t_dev = [], 0, 0.0, 0.0
    overflows = trainer.overflows
    t_all = time.time()
    for i in range(TRAIN_STEPS):
        t0 = time.time()
        batch = next(batches)
        host = time.time() - t0
        raw, caps = batch
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.time()
        loss = float(trainer.train_step(batch))
        torch.cuda.synchronize()
        dev = time.time() - t0
        got = read_counts()
        if got != expected(TRAIN_LAUNCHES):
            raise AssertionError(f"train step {i}: launches {got}, want "
                                 f"{expected(TRAIN_LAUNCHES)}")
        if not math.isfinite(loss):
            raise AssertionError(f"train step {i}: loss {loss}")
        for k in total:
            total[k] += got[k]
        losses.append(loss)
        voxels += int(raw.num)
        t_host += host
        t_dev += dev
        print(f"train step {i}: loss {loss:.6f}, {int(raw.num)} voxels "
              f"(level caps {caps}), host load + raw assembly "
              f"{host * 1e3:.1f} ms, device step (coordinates to the card, "
              f"geometry, forward, loss, backward, Adam) {dev * 1e3:.1f} ms",
              flush=True)
    dt = time.time() - t_all
    if trainer.overflows != overflows:
        raise AssertionError("device geometry overflowed during training")
    if not losses[2] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    print(f"train: {ARCH} {DIM}-d cosine bf16, device geometry, batch of "
          f"{TRAIN_BATCH} scenes, {TRAIN_STEPS} steps, {voxels} voxels in "
          f"{dt:.3f}s -> {TRAIN_STEPS / dt:.4f} steps/s, {voxels / dt:.1f} "
          f"voxels/s (host {t_host:.3f}s, device steps {t_dev:.3f}s; step 0 "
          f"includes the allocator's warm-up), 0 overflows [{card}]",
          flush=True)
    return total


def host_batch_from_caps(raw, caps):
    """The host-geometry DistillBatch of a raw batch at the raw batch's own
    caps (``host_batch_from_raw`` re-buckets them)."""
    from openscene_tpu_torch.data.batch import DistillBatch
    from openscene_tpu_torch.sparse.geometry import (GeometryCaps,
                                                     build_unet_geometry)
    n = int(raw.num)
    geo = build_unet_geometry(raw.coords[:n], caps=GeometryCaps(
        cap0=caps[0], fixed=caps))
    return DistillBatch(geo=geo, feats=raw.feats, feat_3d=raw.feat_3d,
                        mask=raw.mask, labels=raw.labels, num_voxels=n)


def assembly_times(trainer, card):
    """Host ms to assemble one 2-scene batch (scenes already loaded): raw
    (concatenate, sort, level counts, pad) against host geometry (the same
    and the NumPy planner)."""
    import numpy as np
    from openscene_tpu_torch.data.batch import (assemble_distill_batch,
                                                assemble_raw_distill_batch)
    samples = [trainer.train_data.get(i) for i in range(TRAIN_BATCH)]
    t0 = time.time()
    assemble_raw_distill_batch(samples, DIM, rng=np.random.default_rng(0))
    t_raw = time.time() - t0
    t0 = time.time()
    assemble_distill_batch(samples, DIM, rng=np.random.default_rng(0))
    t_host = time.time() - t0
    print(f"host assembly of one {TRAIN_BATCH}-scene batch: raw "
          f"{t_raw * 1e3:.1f} ms, host geometry {t_host * 1e3:.1f} ms "
          f"[{card}]", flush=True)
    return t_raw * 1e3, t_host * 1e3


def compare_train_step(trainer, batch):
    """One step from the same model and optimizer state three times on the
    card: through the kernels (bf16), through the plain versions (bf16), and
    through the plain versions in fp32 as the yardstick of bf16 noise.

    The bf16 paths take the same fp32 sums of the same exact bf16 products
    in another order, so each conv output and input gradient may differ by
    one bf16 ulp.  Behind training-mode BatchNorm a gradient is what is left
    after the cotangent's mean and its component along the activations
    cancel, so that noise is a large share of some tensors (10% and more of
    a BatchNorm beta's norm); a fixed limit on kernel against plain would
    only measure bf16.  Held instead: the loss within 1e-3 relative; the
    kernel path's gradients no farther from the fp32 step's than the plain
    bf16 path's are (all parameters together: at most 1.25x + 0.01 in
    relative L2; each parameter: at most 3x + 0.05); and the parameters after
    the update against the plain path's.  Adam moves a weight by about lr
    per step whatever the gradient's scale, so any two steps lie within
    2*lr of each other and that says nothing; held are the distances a
    right step keeps: PARAM_TOL_RESOLVED * lr on the elements whose fp32
    gradient is resolved (at least RESOLVED of its tensor's largest), where
    bf16 noise cannot turn Adam's ratio of moments, PARAM_TOL_MEAN * lr on
    the mean over all elements, PARAM_TOL_ALL * lr on every element; and the
    parameters moved at all.  Returns the summary it prints."""
    import copy
    import statistics
    import torch
    model, opt, step = trainer.model, trainer.optimizer, trainer.step_fn
    state0 = copy.deepcopy(model.state_dict())
    opt0 = copy.deepcopy(opt.state_dict())
    it0 = step.it

    def run(cdtype):
        model.load_state_dict(state0)
        opt.load_state_dict(copy.deepcopy(opt0))
        step.it, saved = it0, step.cdtype
        step.cdtype = cdtype
        try:
            loss = float(step(batch))
        finally:
            step.cdtype = saved
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        if not all(torch.isfinite(g).all() for g in grads.values()):
            raise AssertionError("a gradient is not finite")
        return loss, grads, params

    zero_counts()
    loss_k, grads_k, params_k = run(torch.bfloat16)
    if read_counts() != expected(TRAIN_LAUNCHES):
        raise AssertionError(f"compared step: launches {read_counts()}")
    with plain_path():
        zero_counts()
        loss_p, grads_p, params_p = run(torch.bfloat16)
        loss_32, grads_32, _ = run(torch.float32)
        if any(read_counts().values()):
            raise AssertionError("the plain path launched a kernel")

    def dist(a, b):  # per parameter and all together, relative L2 to b
        each = {n: ((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-30)
                    ).item() for n in b}
        num = sum((a[n] - b[n]).norm().item() ** 2 for n in b) ** 0.5
        return each, num / sum(b[n].norm().item() ** 2 for n in b) ** 0.5

    k32, k32_all = dist(grads_k, grads_32)
    p32, p32_all = dist(grads_p, grads_32)
    kp, kp_all = dist(grads_k, grads_p)
    worst = max(k32, key=lambda n: k32[n] / (3 * p32[n] + 0.05))
    lr = trainer.schedule(it0)
    dparam, dresolved, dsum, count = 0.0, 0.0, 0.0, 0
    for n, p in params_p.items():
        diff = (params_k[n] - p).abs()
        g32 = grads_32[n].abs()
        resolved = diff[g32 >= RESOLVED * g32.max()]
        dparam = max(dparam, diff.max().item())
        dresolved = max(dresolved, resolved.max().item())
        dsum, count = dsum + diff.sum().item(), count + diff.numel()
    moved = max((params_k[n] - state0[n]).abs().max().item()
                for n in params_p)
    out = {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_fp32": loss_32,
           "grad_rel_l2_kernels_vs_fp32": k32_all,
           "grad_rel_l2_plain_vs_fp32": p32_all,
           "grad_rel_l2_kernels_vs_plain": kp_all,
           "per_param_kernels_vs_plain_median": statistics.median(
               kp.values()),
           "per_param_kernels_vs_plain_max": max(kp.values()),
           "worst_param": worst, "worst_kernels_vs_fp32": k32[worst],
           "worst_plain_vs_fp32": p32[worst],
           "param_max_abs_diff": dparam,
           "param_resolved_max_abs_diff": dresolved,
           "param_mean_abs_diff": dsum / count,
           "param_max_abs_move": moved, "lr": lr}
    print(f"train-step parity (kernels vs plain vs fp32 plain on the card, "
          f"same state and batch): {json.dumps(out)}", flush=True)
    if not (abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
            and k32_all <= 1.25 * p32_all + 0.01
            and k32[worst] <= 3 * p32[worst] + 0.05
            and 0 < moved and dparam <= PARAM_TOL_ALL * lr
            and dresolved <= PARAM_TOL_RESOLVED * lr
            and dsum / count <= PARAM_TOL_MEAN * lr):
        raise AssertionError("kernel-path and plain-path train steps "
                             "disagree")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda is not available; this script needs a "
            "CUDA GPU")
        return 2
    if not os.path.isdir(os.path.join(HERE, "openscene_tpu_torch")):
        log("chip_smoke: run it from a checkout of the repository "
            "(openscene_tpu_torch/ must sit beside chip_smoke.py)")
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    from openscene_tpu_torch.data.batch import assemble_eval_batch
    from openscene_tpu_torch.device import resolve_device
    from openscene_tpu_torch.runtime.distill import DistillTrainer
    from openscene_tpu_torch.runtime.evaluate import (ZeroShotEvaluator,
                                                      load_model_for_eval,
                                                      make_eval_step)
    from openscene_tpu_torch.scripts.dev_bench_ops import bench_ops
    from openscene_tpu_torch.scripts.dev_pack_bench import bench_pack
    from openscene_tpu_torch.sparse import _build
    from openscene_tpu_torch.sparse.geometry import geometry_to_device

    # ---- 1. device and build ----
    card = card_line()
    print(f"card: {card}", flush=True)
    device = resolve_device("cuda")
    t0 = time.time()
    libs = _build.build_all()
    print(f"build: {len(libs)} kernel source(s) in {time.time() - t0:.1f}s "
          f"({', '.join(os.path.relpath(p, HERE) for p in libs.values())})",
          flush=True)
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)

    # ---- data: synthetic scenes at bench density, 768-d features ----
    t0 = time.time()
    d3, dfeat = make_dataset(os.path.join(HERE, "build", "smoke_data"))
    print(f"data: {TRAIN_BATCH} train and {N_SCENES} val scenes written in "
          f"{time.time() - t0:.1f}s", flush=True)

    # ---- 2. kernels against their plain versions ----
    cfg = eval_config(d3, dfeat, "ensemble")
    ev = ZeroShotEvaluator(cfg, load_model_for_eval(cfg, device),
                           allow_pseudo_text=True, device=device)
    loader = ev._loader()
    samples = [loader.get(i) for i in range(N_SCENES)]
    batch0 = assemble_eval_batch([samples[0]], DIM)
    geo0 = geometry_to_device(batch0.geo, device)
    print(f"scene 0: level caps {[l.cap for l in geo0.levels]}, valid rows "
          f"{[l.num for l in geo0.levels]}", flush=True)
    cases = kernels_phase(geo0)

    trainer = DistillTrainer(train_config(d3, dfeat), allow_pseudo_text=True,
                             device=device)
    if not trainer.device_geometry:
        raise AssertionError("device_geometry 'auto' is off on cuda")
    batches = trainer._epoch_batches()
    raw, caps = next(batches)
    # the NumPy builder on the raw batch's caps: the reference of the
    # geometry built on the card and the backward kernels' geometry
    t0 = time.time()
    host_geo = host_batch_from_caps(raw, caps).geo
    t_numpy = time.time() - t0
    tgeo = geometry_to_device(host_geo, device)
    print(f"train batch: {int(raw.num)} voxels, level caps {caps}, valid "
          f"rows {[l.num for l in tgeo.levels]}", flush=True)
    cases.update(kernels_phase_bwd(tgeo))
    geo_stats = geometry_phase(raw, caps, host_geo, t_numpy, card, tgeo)
    skip_stats = skip_phase(tgeo, card)
    cases["up_conv_fwd"] = up_kernel_phase(tgeo)
    del tgeo
    # kernel 7: its benchmark is its main path (the launches counted)
    zero_counts()
    pack_rows = bench_pack(iters=20)
    main_launches = {"pack_pairs_t": read_counts()["pack_pairs_t"]}
    cases["pack_pairs_t"] = [dict(r, shape=f"cap={r['shape'][0]} "
                                  f"C={r['shape'][1]}", max_abs_err=0.0,
                                  tol=0.0) for r in pack_rows]
    for name, shapes in cases.items():
        for c in shapes:
            print(f"kernel {name} {c['shape']}: {c['ms']:.4f} ms"
                  + (f" (host-inclusive {c['host_ms']:.4f})" if "host_ms" in c
                     else "") + f", plain "
                  f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}"
                  + (f" (host-inclusive {c['library_host_ms']:.4f})"
                     if "library_host_ms" in c else "") + ", "
                  f"bound {c['bound_ms']:.5f} ({c['bound_by']})"
                  + (f", dense {c['dense_bound_ms']:.5f} "
                     f"({c['dense_bound_by']})" if "dense_bound_ms" in c
                     else "")
                  + (", bit-equal" if name == "pack_pairs_t" else
                     f", max err {c['max_abs_err']:.3e}")
                  + (f", launch alone {c['launch_only_ms']:.4f}, grouping "
                     f"alone {c['grouping_ms']:.4f}" if "grouping_ms" in c
                     else "")
                  + (f", dW err {c['dw_max_abs_err']:.3e} of tol "
                     f"{c['dw_tol']:.3e}" if "dw_tol" in c else "")
                  + f" [{card}]", flush=True)

    # ---- 3. the serving path ----
    model = ev.model
    launches = dict.fromkeys(wrappers(), 0)
    n_voxels = sum(len(s.coords) for s in samples)
    for mode in MODES:
        mev = ZeroShotEvaluator(eval_config(d3, dfeat, mode), model,
                                allow_pseudo_text=True, device=device)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.time()
        res = mev.run()
        torch.cuda.synchronize()
        dt = time.time() - t0
        got = read_counts()
        want = expected(dict(stencil_conv_fwd=STENCILS_PER_FORWARD * N_SCENES,
                             down_conv_fwd=DOWNS_PER_FORWARD * N_SCENES))
        if got != want:
            raise AssertionError(f"{mode}: launches {got}, want {want}")
        if not np.isfinite(res["miou"]):
            raise AssertionError(f"{mode}: mIoU {res['miou']}")
        for k in launches:
            launches[k] += got[k]
        print(f"eval {mode}: {ARCH} {DIM}-d, {N_SCENES} scenes, {n_voxels} "
              f"voxels in {dt:.3f}s -> {N_SCENES / dt:.4f} scenes/s, "
              f"{n_voxels / dt:.1f} voxels/s, mIoU {res['miou']:.4f} "
              f"(random weights, pseudo text) [{card}]", flush=True)
    forwards = len(MODES) * N_SCENES
    breakdown(make_eval_step("ensemble", constant_input=True), model,
              ev.text, samples[0], DIM)

    # one scene through the kernels and through the plain versions
    step = make_eval_step("distill", constant_input=True)
    logits_k = step(model, ev.text, batch0)[0][:batch0.num_points]
    with plain_path():
        logits_p = step(model, ev.text, batch0)[0][:batch0.num_points]
    torch.cuda.synchronize()
    if not (torch.isfinite(logits_k).all() and logits_k.shape[1] == 20):
        raise AssertionError("kernel-path logits are not finite (N, 20)")
    scale = logits_p.abs().max().item()
    lerr = (logits_k - logits_p).abs().max().item()
    top2 = logits_p.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) >= 1e-3
    agree = (logits_k.argmax(1) == logits_p.argmax(1))[clear].float().mean()
    print(f"slice parity (scene 0, distill logits, kernels vs plain on the "
          f"card): max|diff| {lerr:.3e} of scale {scale:.3e}, argmax "
          f"agreement {agree.item():.5f} off near-ties", flush=True)
    if not (lerr <= 4 * BF16_ULP * scale and agree.item() >= 0.995):
        raise AssertionError("kernel path and plain path disagree")
    del ev, model, logits_k, logits_p

    # ---- 4. the training path, geometry built on the card ----
    del raw, host_geo
    t_raw_asm, t_host_asm = assembly_times(trainer, card)
    train_launches = train_phase(trainer, batches, card)
    for k in launches:
        launches[k] += train_launches[k]
    pbatch = next(batches)
    praw, pcaps = pbatch
    host_batch = host_batch_from_caps(praw, pcaps)
    compare_raw_host(trainer, praw, pcaps, host_batch)
    for what, fn in (("train raw", lambda: trainer.train_step(pbatch)),
                     ("train host", lambda: trainer.step_fn(host_batch))):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        t_step = time.time() - t0
        busy, prow = profile_device(fn, what)
        if busy:
            conv = conv_kernel_ms(prow)
            print(f"profiler[{what}]: device busy {busy:.3f} ms in the "
                  f"profiled train step (unprofiled step "
                  f"{t_step * 1e3:.1f} ms, {int(praw.num)} voxels); stencil "
                  f"sources {json.dumps(conv)} (launches, ms): "
                  f"{sum(v[1] for v in conv.values()):.3f} ms against the "
                  f"dense design's {DENSE_DESIGN_TRAIN_CONV_MS[0]} + "
                  f"{DENSE_DESIGN_TRAIN_CONV_MS[1]} ms [{card}]", flush=True)
    compare_train_step(trainer, host_batch)

    # ---- 5. the per-op benchmark on the train batch: kernel 5's path ----
    zero_counts()
    t0 = time.time()
    bench = bench_ops(praw.coords, int(praw.num), n_scenes=TRAIN_BATCH,
                      iters=BENCH_ITERS)
    main_launches["up_conv_fwd"] = read_counts()["up_conv_fwd"]
    for row in bench:
        print(f"bench_ops: {json.dumps(row)} [{card}]", flush=True)
    print(f"bench_ops: {len(bench)} rows in {time.time() - t0:.1f}s",
          flush=True)
    for k, n in main_launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched on its main path")
        launches[k] += n

    # ---- 6. report ----
    kernels = []
    for name, shapes in cases.items():
        main_shape = shapes[0]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_per_train_step": train_launches[name] / TRAIN_STEPS,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shapes": shapes}
        if name in ("stencil_conv_fwd", "down_conv_fwd"):
            entry["launches_per_forward"] = (
                launches[name] - train_launches[name]) / forwards
        elif name in main_launches:
            entry["main_path"] = ("scripts/dev_bench_ops.py:bench_ops"
                                  if name == "up_conv_fwd" else
                                  "scripts/dev_pack_bench.py:bench_pack")
        else:
            entry["also_launches"] = FWD_SOURCE + " (dx)"
        kernels.append(entry)
    print(f"skip plans: {json.dumps(skip_stats)}", flush=True)
    print(f"geometry: {json.dumps(geo_stats)}; host assembly ms raw "
          f"{t_raw_asm:.1f}, host geometry {t_host_asm:.1f}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
