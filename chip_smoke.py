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
   calls beside them.  The down conv's kernels (3 and 6) run at MinkUNet18A's
   four edges on the edge's own layouts, each beside its launches alone
   and the design it replaced (``scripts/dev_down_tiles.py``);
3. builds the first train batch's geometry on the card from its level-0
   coordinates, with the occupancy grid and with the search path (stem
   occupancy on), and requires every array to equal the NumPy builder's for
   the same caps bit for bit, and every level's skip plan and every edge's
   groups and skip plan to equal the ones built for the host plans, with no
   overflow; prints the build times, the NumPy planner's time and the bytes
   a raw and a host-geometry batch copy to the card; then prints the skip
   plans' shares (pairs with a neighbour, (tile, offset) steps the forward
   runs) and the build times of the levels' skip plans and of the edges'
   layouts;
4. holds kernel 5 (the up conv over the children, ``up_conv_fwd``) against
   its plain version at the four edges of that batch (one bf16 ulp, padded
   rows exactly 0, bit-identical across two launches) beside the dense
   route that the JAX package's model takes, with its launch alone and the
   groups' build alone, and drives kernel 7 (the pair-packed transpose,
   ``pack_pairs_t``) through its benchmark
   (``scripts/dev_pack_bench.bench_pack``) at its five shapes, where kernel,
   plain version and one PyTorch call must be bit-equal; then times the
   training BatchNorm's kernels (``scripts/dev_bn_bench.bench_bn``, forward
   and backward with the ReLU at the level-0 and level-4 widths of
   MinkUNet18A and MinkUNet101) beside the plain Function they replace
   on the card and ``torch.nn.functional.batch_norm``; each output must
   lie within its sum-order tolerance of the plain ops' autograd, two runs
   must be bit-equal and each direction must make 3 launches;
5. drives the serving path: zero-shot evaluation of MinkUNet18A at 768-d
   OpenSeg width through ``runtime.evaluate.ZeroShotEvaluator`` on ``cuda``,
   in ensemble and distill modes, on 2 synthetic ScanNet-like scenes at 2 cm
   (about 125k voxels each), random weights from a seed and pseudo text
   embeddings, first with each scene's geometry built on the card
   (``device_geometry auto``), then planned on the host (``off``): voxels/s
   of both routes, no overflow.  Every kernel's launch counter is set to 0
   just before each run and read just after: each stencil-conv kernel must
   launch 32 times and the down-conv and up-conv kernels 4 times each per
   scene forward.  The outputs must be finite.  Each scene in each mode
   then goes through both routes on the same level caps: the point logits
   must be bit-equal and the argmax agree at every point (per-scene host
   and device ms printed), and one card-route distill step is profiled (it
   copies no fused features).  The C++ kernel-map builder must be
   available on the card's host; scene 0's host planner ms with it and with
   NumPy, plans bit-identical.  One scene's logits from the kernel path
   must match the same model run through the plain versions on the card;
6. drives the training path: ``runtime.distill.DistillTrainer`` on ``cuda``
   (device geometry ``auto``, so on), MinkUNet18A, 768-d, cosine loss,
   bf16, batches of 2 synthetic train scenes at 2 cm (about 270k voxels),
   3 steps.  The launch counters are set to 0 before each step and read
   after it: 32 stencil, 4 down-conv and 4 up-conv forward launches and 32
   stencil, 4 down-conv and 4 up-conv backward launches per step, and no
   overflow, and 3 forward and 3 backward launches of the BatchNorm
   kernels for each of the model's BatchNorms.
   Losses must be finite and the third below the first.  One step through
   device geometry and one through host geometry on the same batch, caps
   and starting state must give the same loss and gradients exactly.  Each
   is profiled once, and the conv kernels' device ms are printed (every
   instantiation of each template: ``up_conv_fwd_kernel`` counts the up
   conv's forward and the down conv's ``dx``), the two gather-GEMM
   sources' beside the previous design's.  Then
   one more step runs from the same model and optimizer state through the
   kernels, through the plain versions, and through the plain versions in
   fp32: the loss and the updated parameters of the first two must agree,
   and the kernel path's gradients must be as close to the fp32 step's as
   the plain bf16 path's are (``compare_train_step`` states the limits and
   why bf16 noise is measured rather than assumed).  The host ms to load
   and assemble a raw 2-scene train batch, in a child process with the
   package's allocator tuning (``utils/hostmem``) and in one without.
   Then Point Transformer V3 (PT-v3m1) at the PTv3 cell's size: the
   trainer of ``benchmark/configs/scannet_openseg_ptv3.json`` on that
   cell's rooms (``benchmark/data.py``, its workload's 3 batches of 8
   rooms), 3 steps through the same loop, the launches counted per step:
   one stencil conv forward and backward and one attention forward and 2
   backward launches per block, 3 + 3 BatchNorm launches per BatchNorm,
   finite losses, no overflow.  Then its attention kernels
   (``scripts/dev_attn_bench.bench_attn``, forward and backward) at
   levels 0 and 3 of that run's first batch, each level's voxels a scene
   read from its coordinates, beside their plain version and the
   library's padded attention; within 2e-2 (3e-2 for the gradients) of
   the plain version's largest value, bit-equal twice, 1 + 2 launches;
7. drives supervised segmentation: ``runtime.train_seg.SegTrainer`` on
   ``cuda`` with ``configs/scannet/mink.yaml`` (MinkUNet18A, 3 -> 20
   classes, cross-entropy, SGD, constant input, bf16) on batches of its 8
   synthetic scenes at 2 cm, geometry built on the card, 3 steps with the
   launches counted per step as in 6; one step on a 2-scene batch through
   the kernels, the plain versions and fp32 as in 6 (SGD's updated
   parameters held to the gradients' distance); the last 8-scene batch's
   geometry through a new ``RawTrainStep`` of the trainer (the build
   captured as a CUDA graph, then replayed) against the eager build bit
   for bit, the replay at most 3 launch events inside ``geometry.build``
   (the count's fill, the graph's launch), in a pool of its own and in
   the trainer's shared pool, the build's host and device ms, the
   replay's beside the eager build's, and each capture's bytes;
   ``runtime.eval_seg.evaluate_seg`` on the 2 val scenes at one repeat,
   32/4/4 launches per scene: voxels/s and the mIoU of barely trained
   weights (a smoke value);
8. drives multi-GPU (``parallel/``, one process per GPU): (a) NCCL at world
   size 1 through torchrun's environment (``maybe_initialize_distributed``):
   one distill step at ``data_parallel -1`` with the reductions running must
   equal a step without a process group on the same batch, caps and state,
   bit for bit; (b) two ranks on ``cuda:0`` over gloo, spawned by
   ``parallel/launch.spawn``, MinkUNet18A at 768-d, bf16: distill at
   data=2 (one train scene a rank; 32/4/4 launches forward and backward on
   each rank; the reduced loss the mean of the ranks' one-process losses on
   the same batches and caps, within two fp32 eps; the parameters those of
   Adam on the mean one-process gradient, within two fp32 eps of each
   parameter; parameters and buffers bit-identical on both ranks), the head
   sharded at data=1 x model=2 on one 2-scene batch (an SGD step against
   the one-process step on the same batch: in bf16 through the kernels the
   loss within 1e-3 relative and 32/4/4 launches each way; in fp32 through
   the plain versions, as ``tests/test_parallel.py`` holds the JAX package's
   head sharding, also every tensor's update within 1e-3 of its scale and
   the head gathered from the shards: bf16's rounding of the split sums
   moves near-cancelling BatchNorm gradients by more), one
   ``mink.yaml`` seg step at data=2 (the loss the mean, the histograms the
   sum of the one-process steps') and ``ZeroShotEvaluator`` in distill mode
   over the 2 val scenes, one a rank (the results equal the one-process
   evaluator's, every scene on the one-process caps with bit-equal
   logits); each rank's step ms and voxels/s beside the one-process step's
   (two ranks share one card: no scaling numbers) and the phase's wall
   time;
9. drives multi-view fusion (``fusion.fuse.MultiViewFuser`` on ``cuda``)
   at the ScanNet spec (320x240, ``SCANNET_INTRINSIC``, vis_thres 0.25,
   cut_bound 10) and OpenSeg width: (a) scene 0 at bench density (186,927
   points) over 100 look_at views inside the room, depth z-buffered from
   the points, 768-d fp16 maps built on the host from the class prototypes
   of each pixel's nearest point's label; wall ms, the maps' host ms, the
   copies' and kernels' device ms of a profiled run of 10 views, views/s,
   scenes/s and peak device memory; where a point's views agree on the
   label, the argmax of its fused feature against the prototypes must be
   its label at >= 99% of such points; (b) 4 of those views' sums and
   counts against a float64 NumPy transcription of the reference loop,
   every visibility disagreement a .5 tie within 1e-3 px or a depth test
   within 1e-4 of its threshold, sums within 1e-5 of the scale; (c)
   ``run_fusion.fuse_dataset("nuscenes")`` on the card on a layout of
   ``.npy`` cameras and no depth (no PIL), against the reference fusion
   script's transcription (mask equal, features within one fp16 ulp); (d)
   scene 0's fused features as a val blob through ``ZeroShotEvaluator`` in
   fusion mode on the card: finite logits, the feature mask on the voxels
   fusion saw.  None of the seven kernels launches;
10. drives spatial sharding of one scene (``parallel/spatial.py``): (a)
   NCCL at world size 1 through torchrun's environment, ``SpatialConv`` at
   D=1 on scene 0 (120,695 voxels) at MinkUNet18A's L0 width 128->96; (b)
   two ranks on ``cuda:0`` over gloo, D=2 over scene 0 at the L0 widths
   32->32, 128->96 and 96->96.  On every rank, forward and backward of a
   seeded cotangent through autograd against the one-card ``StencilConv``
   on scene 0's level-0 plan on the same inputs: ``y`` and ``dx`` within
   one bf16 ulp of the output scale with padded rows exactly zero, ``dW``
   within ``DW_TOL`` of its scale (caps differ, so tiles differ: not
   bit-equal); one ``spatial_conv_fwd`` and one ``spatial_conv_bwd``
   launch per conv and none of the model's wrappers; the two wrappers
   against their plain versions on the rank's extended buffer and against
   a second launch; ``dW`` bit-identical on both ranks.  Per rank: cap_d,
   the halo H, the exports E, the exchange's and the conv's ms beside the
   one-card conv's (two ranks share one card: no scaling numbers);
11. drives the sparse ResNet classifiers (``models/resnet.py``): ResNet18
   and ResNet50 at their published widths, 3 colour channels -> 20
   classes, random weights from a seed, on the first 2-scene train batch
   with its geometry built on the card (the stem as an index plan): an
   eval forward (finite logits, kernels against plain by the eval phase's
   rule) and a train-mode forward and backward of a fixed cotangent
   through the kernels, the plain versions and fp32 (gradients held as
   ``compare_train_step`` holds the UNet's); 17 stencil and 4 down-conv
   launches per forward and the same per backward; forward and backward
   ms.  Earlier, right after the train phase: one val scene through
   ``ZeroShotEvaluator`` in distill mode with ``vis_input``/``vis_pred``/
   ``vis_gt`` (three PLYs of the scene's point count, two ``.txt``
   legends), ``_epoch_end_viz`` on the train phase's last batch (three
   PLYs), and one distill train step inside ``utils/profiling.trace``
   (the trace names the gather-GEMM kernels and the ``annotate`` region);
12. drives the reference-checkpoint drill
   (``scripts/eval_reference_checkpoint.py``) at MinkUNet18A 768-d on the
   2 val scenes: a random MinkowskiEngine-format checkpoint written as a
   ``.pth.tar`` with ``module.`` prefixes; for each kernel region order a
   drill root (links to the smoke tree) whose val scene 0 blob is the
   converted model's own output under that order, where the probe
   (``probe_region_order``, two forwards on the card) must pick that order
   by at least the default margin 0.05; the drill's command line as a
   subprocess on the card over distill, ensemble and fusion, whose probe
   must pick ``x_fastest`` and whose mIoU table must be bit-equal to a
   direct ``ZeroShotEvaluator`` run with the order pinned and the same
   ``model_path``; ``main`` under a ``--min-margin`` above the achieved
   margin must exit nonzero after the probe alone.  32 / 4 / 4 launches of
   rows 1, 3 and 5 per forward around the probes, the direct run and the
   gate; the probe's wall ms and each mode's voxels/s;
13. runs the per-op benchmark (``scripts/dev_bench_ops.bench_ops``) on the
   train batch with few iterations: each up conv forward and
   forward+backward by the model's route against the dense route;
14. prints the eval, train, hostmem, ptv3, seg, dist, fusion, spatial,
   resnet, exports, drill, BatchNorm and attention summaries, the card
   line, one ``{"kernels": [...]}`` JSON line (each kernel's launches on
   the main paths, the spatial, ResNet, drill and PTv3 paths included,
   the attention's measured in the PTv3 train steps), and last
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
# MinkUNet18A's up convs, (Cin, Cout) by edge: level e+1 -> level e
UP_WIDTHS = ((96, 96), (128, 96), (128, 128), (256, 128))
# its down convs' widths (Cin = Cout) by edge: level e -> level e+1
DOWN_WIDTHS = (32, 32, 64, 128)
TRAIN_BATCH = 2
TRAIN_STEPS = 3
# supervised segmentation: configs/scannet/mink.yaml's model and batch
SEG_CONFIG = os.path.join("configs", "scannet", "mink.yaml")
SEG_BATCH = 8
SEG_STEPS = 3
SEG_TRAIN_SCENES = 8
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
UP_SOURCE = "openscene_tpu_torch/csrc/up_conv_fwd.cu"
SOURCES = {"stencil_conv_fwd": FWD_SOURCE, "down_conv_fwd": FWD_SOURCE,
           "stencil_conv_bwd": BWD_SOURCE, "up_conv_bwd": BWD_SOURCE,
           "down_conv_bwd": BWD_SOURCE, "up_conv_fwd": UP_SOURCE,
           "pack_pairs_t": "openscene_tpu_torch/csrc/pack_pairs_t.cu"}
# the backward wrappers' dx launches
ALSO_LAUNCHES = {"stencil_conv_bwd": FWD_SOURCE + " (dx)",
                 "up_conv_bwd": FWD_SOURCE + " (dx)",
                 "down_conv_bwd": UP_SOURCE + " (dx, W_NK)"}


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


def bound(K, rows_in, rows_out, pairs, cin, cout, n_idx=None):
    """Least time on an H100 SXM for (rows_in, cin) -> (rows_out, cout):
    each input row read once, each output row written once, ``n_idx`` int32
    index entries (by default K per output row), the bf16 weights;
    2*cin*cout operations per (offset, row) pair.  Returns (ms, "bytes" or
    "operations")."""
    n_idx = K * rows_out if n_idx is None else n_idx
    nbytes = (rows_in * cin + rows_out * cout) * 2 + n_idx * 4 \
        + K * cin * cout * 2
    flops = 2.0 * pairs * cin * cout
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_case(name, wrapper, plain, x, w, arg, idx, n_in, n_out,
                also=None, idx_per_pair=False):
    """Compare one kernel with its plain version and time both: the wrapper
    and the plain version take ``(x, w, arg)``, ``idx`` is the gather plan
    (K, rows_out) of the im2col yardstick and of the bound; ``also``:
    {key: closure} timed beside them (a launch alone, a replaced design);
    ``idx_per_pair``: the data's bound reads one index entry per neighbour
    pair (an edge: one per child), not K per output row."""
    import torch
    K, cin, cout = w.shape
    out = wrapper(x, w, arg)
    ref = plain(x, w, arg)
    again = wrapper(x, w, arg)
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
    bound_ms, bound_by = bound(K, n_in, n_out, pairs, cin, cout,
                               pairs if idx_per_pair else None)
    dense_ms, dense_by = bound(K, x.shape[0], rows, K * rows, cin, cout)
    return {"shape": f"K={K} {cin}->{cout} rows_in={x.shape[0]} "
                     f"rows_out={rows} (valid {n_in}->{n_out}, "
                     f"{pairs} neighbour pairs)",
            "max_abs_err": err, "tol": tol, "deterministic": True,
            "ms": device_ms(lambda: wrapper(x, w, arg)),
            "host_ms": cuda_time_ms(lambda: wrapper(x, w, arg)),
            "plain_ms": device_ms(lambda: plain(x, w, arg), iters=5),
            "library_ms": device_ms(im2col, iters=5),
            "library_host_ms": cuda_time_ms(im2col, iters=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "dense_bound_ms": dense_ms, "dense_bound_by": dense_by,
            **{k: device_ms(fn) for k, fn in (also or {}).items()}}


def kernels_phase(geo):
    """Each forward kernel at the main path's shapes, on scene 0's
    geometry: the stencil conv with each level's skip plan, the down conv at
    the four edges with the edge's skip plan."""
    import torch
    from openscene_tpu_torch.scripts.dev_down_tiles import replaced_down_fwd
    from openscene_tpu_torch.sparse.edge_conv import (down_conv_fwd,
                                                      down_conv_plain,
                                                      down_tiles)
    from openscene_tpu_torch.sparse.stencil_conv import (launch_gather_gemm,
                                                         stencil_conv_fwd,
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
        fwd = geo.self3[level].fwd
        stencil.append(kernel_case(
            "stencil_conv_fwd",
            functools.partial(stencil_conv_fwd, skip=skip),
            stencil_conv_plain, acts(level, cin), weights(27, cin, cout),
            fwd, fwd, n, n))
    # the k=5 stem on colour input (off the main path, whose input is the
    # constant feature): 3 channels zero-padded to 8, K = 125
    n = geo.levels[0].num
    stencil.append(kernel_case(
        "stencil_conv_fwd", stencil_conv_fwd, stencil_conv_plain,
        acts(0, 8), weights(125, 8, 32), geo.stem.fwd, geo.stem.fwd, n, n))
    down = []
    for edge, c in enumerate(DOWN_WIDTHS):
        plan = geo.down[edge]
        # the weight as DownConv hands it on: cast to bf16 once
        x, wb = acts(edge, c), weights(8, c, c).to(torch.bfloat16)
        *tiles, staged = down_tiles(plan.fwd.shape[1], c, c)
        down.append(kernel_case(
            "down_conv_fwd", down_conv_fwd, down_conv_plain, x, wb, plan,
            plan.fwd, geo.levels[edge].num, geo.levels[edge + 1].num,
            also={"launch_only_ms": lambda x=x, wb=wb, p=plan, t=tiles,
                  s=staged: launch_gather_gemm(x, wb, p.fwd, p.skip, *t,
                                               staged=s),
                  "replaced_ms": lambda x=x, wb=wb, p=plan:
                  replaced_down_fwd(x, wb, p)}, idx_per_pair=True))
        down[-1]["shape"] = f"edge {edge} " + down[-1]["shape"]
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
    from openscene_tpu_torch.scripts.dev_down_tiles import replaced_down_bwd
    from openscene_tpu_torch.sparse.edge_conv import (
        EDGE_TILE, down_conv_bwd, down_conv_bwd_plain, down_dx_tiles,
        down_wgrad_tiles, launch_up_conv, up_conv_bwd, up_conv_bwd_plain,
        up_dx_tiles, up_wgrad_tiles)
    from openscene_tpu_torch.sparse.stencil_conv import (
        gather_gemm_cuda, gather_wgrad_cuda, launch_gather_wgrad,
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
    for edge, (cin, cout) in enumerate(UP_WIDTHS):
        plan = geo.down[edge]
        child, parent = geo.levels[edge], geo.levels[edge + 1]
        nc, np_, ccap, pcap = child.num, parent.num, child.cap, parent.cap
        what = (f"child rows {ccap} (valid {nc}), parent rows {pcap} "
                f"(valid {np_})")
        # up conv: x on the parents, g on the children
        x, g, w = acts(edge + 1, cin), acts(edge, cout), weights(8, cin, cout)
        wt = w.transpose(1, 2).to(bf16).reshape(8 * cout, cin)
        wb = w.to(bf16)

        def library(x=x, g=g, plan=plan, wt=wt, pcap=pcap):
            G = gathered(g, plan.fwd)
            dx = torch.matmul(G.transpose(0, 1).reshape(pcap, -1), wt)
            return dx, torch.matmul(x.t().unsqueeze(0), G)

        def replaced(x=x, g=g, w=w, plan=plan):
            # the design it replaced: both products dense over every
            # parent and offset, on a transposed bf16 copy of W
            return (gather_gemm_cuda(g, w.transpose(1, 2), plan.fwd),
                    gather_wgrad_cuda(x, g, plan.fwd))

        case = bwd_case(
            "up_conv_bwd",
            lambda x=x, w=wb, g=g, p=plan: up_conv_bwd(x, w, g, p),
            lambda x=x, w=wb, g=g, p=plan: up_conv_bwd_plain(x, w, g, p),
            library, np_, f"edge {edge} K=8 {cin}->{cout} {what}",
            (bound_bwd(np_, nc, 8 * np_, nc, 8, cin, cout),
             bound_bwd(pcap, ccap, 8 * pcap, 8 * pcap, 8, cin, cout)))
        # its two launches apart, and the design it replaced
        case.update(
            dx_ms=device_ms(lambda g=g, p=plan: gather_gemm_cuda(
                g, wb, p.fwd, p.skip, w_nk=True,
                tiles=up_dx_tiles(pcap, cin, cout))),
            dw_ms=device_ms(lambda x=x, g=g, p=plan: launch_gather_wgrad(
                x, g, None, (p.groups.rows, p.groups.count),
                *up_wgrad_tiles(pcap, cin, cout), amap=p.child_parent,
                seg_tile=EDGE_TILE)),
            replaced_ms=device_ms(replaced))
        up.append(case)

    for edge, c in enumerate(DOWN_WIDTHS):
        plan = geo.down[edge]
        child, parent = geo.levels[edge], geo.levels[edge + 1]
        nc, np_, ccap, pcap = child.num, parent.num, child.cap, parent.cap
        what = (f"child rows {ccap} (valid {nc}), parent rows {pcap} "
                f"(valid {np_})")
        # down conv: x on the children, g on the parents
        cin = cout = c
        x, g, w = acts(edge, cin), acts(edge + 1, cout), weights(8, cin, cout)
        wt = w.transpose(1, 2).to(bf16)
        wb = w.to(bf16)

        def library(x=x, g=g, plan=plan, wt=wt, cin=cin, pcap=pcap):
            y = torch.matmul(g.unsqueeze(0), wt).reshape(-1, cin)
            dx = y.index_select(
                0, plan.child_offset.long() * pcap + plan.child_parent)
            return dx, torch.matmul(gathered(x, plan.fwd).transpose(1, 2), g)

        case = bwd_case(
            "down_conv_bwd",
            lambda x=x, w=wb, g=g, p=plan: down_conv_bwd(x, w, g, p),
            lambda x=x, w=wb, g=g, p=plan: down_conv_bwd_plain(x, w, g, p),
            library, nc, f"edge {edge} K=8 {cin}->{cout} {what}",
            # the data's bound reads the edge's map once: child_parent and
            # the grouped rows, two entries per child; the dense one, the
            # (8, parent) plan
            (bound_bwd(nc, np_, 2 * nc, nc, 8, cin, cout),
             bound_bwd(ccap, pcap, 8 * pcap, 8 * pcap, 8, cin, cout)))
        # its two launches apart, and the design it replaced
        case.update(
            dx_ms=device_ms(lambda g=g, p=plan: launch_up_conv(
                g, wb, p.child_parent, p.groups,
                *down_dx_tiles(ccap, cin, cout), w_nk=True)),
            dw_ms=device_ms(lambda x=x, g=g, p=plan: launch_gather_wgrad(
                g, x, None, (p.groups.rows, p.groups.count),
                *down_wgrad_tiles(pcap, cin, cout), amap=p.child_parent,
                seg_tile=EDGE_TILE)),
            replaced_ms=device_ms(lambda x=x, g=g, p=plan:
                                  replaced_down_bwd(x, wb, g, p)))
        down.append(case)
    return {"stencil_conv_bwd": stencil, "up_conv_bwd": up,
            "down_conv_bwd": down}


def skip_phase(geo, card):
    """The skip plans of the train batch's levels: build time on the card,
    the share of (row, offset) pairs that hold a neighbour and the share of
    (tile, offset) steps the forward kernel runs at L0 128->96's row tile;
    and the build time of the edges' groups and skip plans."""
    from openscene_tpu_torch.sparse import stencil_conv as sc
    from openscene_tpu_torch.sparse.edge_conv import with_edge_layouts

    def build_all():
        return [sc.build_conv_skip(p.fwd, lv.num)
                for p, lv in zip(geo.self3, geo.levels)]
    def build_edges():
        return [with_edge_layouts(d, geo.levels[e].num,
                                  geo.levels[e + 1].num)
                for e, d in enumerate(geo.down)]
    out = {"build_ms": cuda_time_ms(build_all, iters=5),
           "edge_layouts_build_ms": cuda_time_ms(build_edges, iters=5),
           "levels": []}
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
          f"{out['build_ms']:.4f}; edge layouts (groups and skip plans, 4 "
          f"edges): {out['edge_layouts_build_ms']:.4f} [{card}]", flush=True)
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
        for f in ("fwd", "child_parent", "child_offset"):
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
        for e, (d, h) in enumerate(zip(geo.down, host_dev.down)):
            for part in ("groups", "skip"):
                for f, a, b in zip(getattr(d, part)._fields,
                                   getattr(d, part), getattr(h, part)):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{path}: down[{e}].{part}.{f} "
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
          f"plans and the 4 edges' groups and skip plans to the host path's "
          f"(caps {caps}), no "
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


GRAPH_LAUNCHES = 3   # a replayed build: the count's fill, the graph launch


def geometry_leaves(x, name="geo"):
    """(name, tensor or int) of every array and count of a geometry."""
    import torch
    if isinstance(x, torch.Tensor):
        yield name, x
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for f in x._fields:
            yield from geometry_leaves(getattr(x, f), f"{name}.{f}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from geometry_leaves(v, f"{name}[{i}]")
    elif x is not None:
        yield name, int(x)


def same_geometry(got, want, what):
    """Raise unless two geometries hold the same arrays and counts, bit
    for bit; returns how many they hold."""
    import torch
    got, want = dict(geometry_leaves(got)), dict(geometry_leaves(want))
    if set(got) != set(want):
        raise AssertionError(f"{what}: arrays {sorted(set(got) ^ set(want))}")
    for k, w in want.items():
        g = got[k]
        same = (g.dtype == w.dtype and torch.equal(g, w)
                if isinstance(w, torch.Tensor) else g == w)
        if not same:
            raise AssertionError(f"{what}: {k} differs from the eager build")
    return len(want)


def build_span_trace(fn):
    """One call of ``fn`` under the profiler: the launch events inside its
    ``geometry.build`` range, the range's host ms and the device ms of the
    work they launched (by correlation id)."""
    import tempfile
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    rng = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == "geometry.build"]
    if len(rng) != 1:
        raise AssertionError(f"{len(rng)} geometry.build ranges in a build")
    a, b = rng[0]["ts"], rng[0]["ts"] + rng[0]["dur"]
    launch = [e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and a <= e["ts"] <= b]
    corr = {e.get("args", {}).get("correlation") for e in launch} - {None}
    dev_us = sum(e.get("dur", 0) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and e.get("args", {}).get("correlation") in corr)
    return {"launches": sum(1 for e in launch
                            if "Launch" in str(e.get("name", ""))),
            "host_ms": (b - a) / 1e3, "device_ms": dev_us / 1e3}


def geometry_graph_check(trainer, raw, caps, card):
    """A train batch's geometry through two new ``RawTrainStep``s of the
    trainer (the build captured as a CUDA graph on the first call, then
    replayed), one in its own pool and one in the pool of the trainer's
    graphs, against the eager build, bit for bit, with no overflow, also
    after the trainer's own graph replayed in between; profiled again, the
    replay must make at most GRAPH_LAUNCHES launch events inside
    ``geometry.build``.  Prints the build's host and device ms, the
    replay's beside the eager build's, and the bytes each capture reserved
    (the graph's own pool and input buffers; one more schedule in the
    shared pool)."""
    import torch
    from openscene_tpu_torch.runtime.geometry_route import (RawTrainStep,
                                                            build_on_card)
    route = trainer.geometry
    grid = dict(n_scenes=route.n_scenes if route.grid_enabled else None,
                grid_dims0=tuple(trainer.cfg.grid_dims0) or None)
    steps, pool, over = {}, {}, False
    for what, handle in (("own", None), ("shared", route.pool)):
        steps[what] = RawTrainStep(trainer.step_fn, caps, **grid,
                                   pool=handle)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        over = steps[what].geometry(raw)[1] or over
        torch.cuda.synchronize()
        pool[what] = torch.cuda.memory_reserved() - reserved
    rs = steps["own"]

    def eager():
        return build_on_card(rs.eager, raw.coords, raw.num)

    want, want_over = eager()
    if over or want_over or rs._graph is None:
        raise AssertionError(f"geometry graph: overflow {over} (eager "
                             f"{want_over}), graph {rs._graph is not None}")
    n = same_geometry(rs.geometry(raw)[0], want, "geometry graph, replay")
    # the shared pool: a graph replayed right after another graph of the
    # pool still gives the eager plans
    mine = route.raw_step(trainer.step_fn, caps)
    for what, step in (("the trainer's", mine), ("one more", steps["shared"]),
                       ("the trainer's", mine)):
        same_geometry(step.geometry(raw)[0], want,
                      f"geometry graph, replay of {what} in the shared pool")
    rows = {}
    for what, fn in (("replay", lambda: rs.geometry(raw)), ("eager", eager)):
        fn()
        rows[what] = build_span_trace(fn)
    same_geometry(rs.geometry(raw)[0], want, "geometry graph, later replay")
    # untraced: the host's ms to hand the build to the card (copy, count,
    # launch; no wait), and the call's wall ms to its counts on the host
    for what, launch, call in (
            ("replay", lambda: rs._replay(raw.coords, raw.num),
             lambda: rs.geometry(raw)),
            ("eager", lambda: rs.eager(raw.coords, raw.num), eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launch()
        rows[what]["untraced_host_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        rows[what]["untraced_wall_ms"] = (time.perf_counter() - t0) * 1e3
    if rows["replay"]["launches"] > GRAPH_LAUNCHES:
        raise AssertionError(f"geometry graph: {rows['replay']['launches']} "
                             f"launch events in a replayed build, want at "
                             f"most {GRAPH_LAUNCHES}")
    r, e = rows["replay"], rows["eager"]
    print(f"geometry graph: {int(raw.num)} voxels of {trainer.cfg.batch_size}"
          f" scenes (caps {tuple(caps)}, "
          f"{'grid' if grid['n_scenes'] else 'search'}), replay bit-identical "
          f"to the eager build ({n} arrays and counts), no overflow, in its "
          f"own pool and in the trainer's; "
          f"profiled, inside geometry.build: replay {r['launches']} launch "
          f"events, host {r['host_ms']:.3f} ms, device {r['device_ms']:.3f} "
          f"ms; eager {e['launches']} launch events, host "
          f"{e['host_ms']:.3f} ms, device {e['device_ms']:.3f} ms; "
          f"untraced host ms to launch (wall to the counts): replay "
          f"{r['untraced_host_ms']:.3f} ({r['untraced_wall_ms']:.3f}), "
          f"eager {e['untraced_host_ms']:.3f} ({e['untraced_wall_ms']:.3f}); "
          f"reserved by the capture in its own pool {pool['own']} bytes "
          f"({pool['own'] / 2**30:.2f} GiB), by one more schedule in the "
          f"trainer's pool {pool['shared']} bytes "
          f"({pool['shared'] / 2**30:.2f} GiB) [{card}]", flush=True)
    return {"replay": r, "eager": e, "pool_bytes": pool["own"],
            "shared_pool_bytes": pool["shared"], "arrays": n}


def up_kernel_phase(geo):
    """Kernel 5 against its plain version at the four edges of the train
    batch (MinkUNet18A's decoder widths), with the plan's groups, timed
    beside the dense route of the JAX package's model (the library
    yardstick), with its launch alone and the groups' build alone."""
    import torch
    from openscene_tpu_torch.sparse.edge_conv import (build_edge_groups,
                                                      launch_up_conv,
                                                      up_conv_fwd,
                                                      up_conv_plain,
                                                      up_tiles)
    from openscene_tpu_torch.sparse.ops import sparse_up_conv
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for edge, (cin, cout) in enumerate(UP_WIDTHS):
        plan = geo.down[edge]
        child, parent = geo.levels[edge], geo.levels[edge + 1]
        x = torch.randn((parent.cap, cin), generator=gen, device="cuda")
        x[parent.num:] = 0
        x = x.to(torch.bfloat16)
        w = torch.randn((8, cin, cout), generator=gen, device="cuda") * \
            (2.0 / (8 * cout)) ** 0.5
        out = up_conv_fwd(x, w, plan)
        ref = up_conv_plain(x, w, plan)
        again = up_conv_fwd(x, w, plan)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_ULP * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"up_conv_fwd edge {edge} {cin}->{cout}: "
                                 f"max|kernel-plain| {err} > {tol}")
        if out[child.num:].any():
            raise AssertionError("up_conv_fwd: padded child rows not zero")
        if not torch.equal(out, again):
            raise AssertionError(f"up_conv_fwd edge {edge}: two launches "
                                 "differ")
        # bytes: parent rows read, child rows written, the grouped child
        # index and child_parent, the weights; operations: one product per
        # valid child
        nbytes = (parent.num * cin + child.num * cout) * 2 \
            + 2 * child.num * 4 + 8 * cin * cout * 2
        flops = 2.0 * child.num * cin * cout
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        wb = w.to(torch.bfloat16)
        tiles = up_tiles(child.cap, cin, cout)
        cases.append({
            "shape": f"edge {edge} K=8 {cin}->{cout} parent rows "
                     f"{parent.cap} (valid {parent.num}), child rows "
                     f"{child.cap} (valid {child.num}), tiles (bn, tpb) "
                     f"{tiles}",
            "max_abs_err": err, "tol": tol, "deterministic": True,
            "ms": device_ms(lambda: up_conv_fwd(x, w, plan)),
            "host_ms": cuda_time_ms(lambda: up_conv_fwd(x, w, plan)),
            "plain_ms": device_ms(lambda: up_conv_plain(x, w, plan),
                                  iters=5),
            "library_ms": device_ms(lambda: sparse_up_conv(x, w, plan),
                                    iters=5),
            "library_host_ms": cuda_time_ms(
                lambda: sparse_up_conv(x, w, plan), iters=5),
            # the launch alone (inside "ms"), and the groups' build alone,
            # done once per batch with the plans (not inside "ms")
            "launch_only_ms": device_ms(lambda: launch_up_conv(
                x, wb, plan.child_parent, plan.groups, *tiles)),
            "groups_build_ms": device_ms(lambda: build_edge_groups(
                plan.child_offset, child.num)),
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
        geo, over = trainer.geometry.raw_step(step, caps).geometry(raw)
        if over:
            raise AssertionError("the raw step overflowed")
        return step.run(geo, *step.parts(raw))

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
    """{kernel: (launches, device ms)} of the two gather-GEMM sources'
    kernels in a profile (the offset groups' and the row splits' partial
    sums have a reduce each; they also run the up conv's dx and both convs'
    dW) and of ``csrc/up_conv_fwd.cu``: every instantiation of each
    template, so ``up_conv_fwd_kernel`` counts the up conv's forward and
    the down conv's dx (``W_NK``), 8 launches per train step."""
    out = {}
    for name in ("gather_gemm_fwd_kernel", "reduce_groups_kernel",
                 "gather_wgrad_kernel", "reduce_partials_kernel",
                 "up_conv_fwd_kernel"):
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
    print(f"scene 0 breakdown (host geometry, ensemble): host assembly "
          f"(geometry plans) "
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
    from openscene_tpu_torch.sparse import batch_norm, edge_conv, stencil_conv

    wrappers()  # hold the kernel wrappers themselves before the names move
    bn_wrappers()

    def fwd_plain(x, w, fwd, skip=None):  # the plain versions need no skip
        return stencil_conv.stencil_conv_plain(x, w, fwd)

    def bwd_plain(x, w, g, fwd, flip_perm, skip=None):
        return stencil_conv.stencil_conv_bwd_plain(x, w, g, fwd, flip_perm)

    swaps = [(stencil_conv, "stencil_conv_fwd", fwd_plain),
             (stencil_conv, "stencil_conv_bwd", bwd_plain),
             (edge_conv, "down_conv_fwd", edge_conv.down_conv_plain),
             (edge_conv, "down_conv_bwd", edge_conv.down_conv_bwd_plain),
             (edge_conv, "up_conv_fwd", edge_conv.up_conv_plain),
             (edge_conv, "up_conv_bwd", edge_conv.up_conv_bwd_plain),
             (batch_norm, "masked_bn_fwd", batch_norm.masked_bn_fwd_plain),
             (batch_norm, "masked_bn_bwd", batch_norm.masked_bn_bwd_plain)]

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


@functools.lru_cache(maxsize=None)
def bn_wrappers():
    """The training BatchNorm's two kernel wrappers (3 launches each per
    BatchNorm and direction), held like :func:`wrappers`'."""
    from openscene_tpu_torch.sparse.batch_norm import (masked_bn_bwd,
                                                       masked_bn_fwd)
    return masked_bn_fwd, masked_bn_bwd


def bn_counts():
    return tuple(w.launches for w in bn_wrappers())


def bn_modules(model):
    return sum(type(m).__name__ == "MaskedBatchNorm"
               for m in model.modules())


def attn_wrappers():
    """The patch attention's two kernel wrappers (1 forward and 2 backward
    launches per attention)."""
    from openscene_tpu_torch.sparse.patch_attn import (patch_attn_bwd,
                                                       patch_attn_fwd)
    return patch_attn_fwd, patch_attn_bwd


def attn_counts():
    return tuple(w.launches for w in attn_wrappers())


def attn_modules(model):
    return sum(type(m).__name__ == "Attention" for m in model.modules())


def zero_counts():
    for w in (*wrappers().values(), *bn_wrappers(), *attn_wrappers()):
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
                  "up_conv_fwd": UPS_PER_FORWARD,
                  "stencil_conv_bwd": STENCILS_PER_FORWARD,
                  "down_conv_bwd": DOWNS_PER_FORWARD,
                  "up_conv_bwd": UPS_PER_FORWARD}


def train_phase(trainer, batches, card, what, steps=TRAIN_STEPS,
                falls=True, want=TRAIN_LAUNCHES):
    """``steps`` steps of a trainer on ``cuda`` through
    ``trainer.train_step``, device geometry on: raw batches, geometry built
    on the card.  Returns the launches counted and a summary.  ``batches``
    yields ``(raw batch, caps)`` (host loading and assembly are timed around
    ``next``); ``falls``: the last loss must be below the first; ``want``:
    the conv wrappers' launches a step."""
    import math
    import torch
    total = dict.fromkeys((*wrappers(), "masked_batch_norm", "patch_attn"),
                          0)
    want_bn = (3 * bn_modules(trainer.model),) * 2
    n_attn = attn_modules(trainer.model)
    want_attn = (n_attn, 2 * n_attn)
    losses, voxels, t_host, t_dev = [], 0, 0.0, 0.0
    overflows = trainer.overflows
    t_all = time.time()
    for i in range(steps):
        t0 = time.time()
        batch = next(batches)
        host = time.time() - t0
        raw, caps = batch
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.time()
        out = trainer.train_step(batch)
        loss = float(out[0] if isinstance(out, tuple) else out)
        torch.cuda.synchronize()
        dev = time.time() - t0
        got = read_counts()
        if got != expected(want):
            raise AssertionError(f"train step {i}: launches {got}, want "
                                 f"{expected(want)}")
        if bn_counts() != want_bn:
            raise AssertionError(f"train step {i}: BatchNorm kernel "
                                 f"launches {bn_counts()}, want {want_bn}")
        if attn_counts() != want_attn:
            raise AssertionError(f"train step {i}: attention kernel "
                                 f"launches {attn_counts()}, want "
                                 f"{want_attn}")
        if not math.isfinite(loss):
            raise AssertionError(f"train step {i}: loss {loss}")
        for k in got:
            total[k] += got[k]
        total["masked_batch_norm"] += sum(bn_counts())
        total["patch_attn"] += sum(attn_counts())
        losses.append(loss)
        voxels += int(raw.num)
        t_host += host
        t_dev += dev
        print(f"{what} step {i}: loss {loss:.6f}, {int(raw.num)} voxels "
              f"(level caps {caps}), host load + raw assembly "
              f"{host * 1e3:.1f} ms, device step (coordinates to the card, "
              f"geometry, forward, loss, backward, update) {dev * 1e3:.1f} "
              f"ms", flush=True)
    dt = time.time() - t_all
    if trainer.overflows != overflows:
        raise AssertionError("device geometry overflowed during training")
    if falls and not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    summary = {"steps": steps, "voxels": voxels, "seconds": dt,
               "steps_per_s": steps / dt, "voxels_per_s": voxels / dt,
               "host_s": t_host, "device_s": t_dev, "losses": losses}
    print(f"{what}: device geometry, batch of {trainer.cfg.batch_size} "
          f"scenes, {steps} steps, {voxels} voxels in {dt:.3f}s -> "
          f"{steps / dt:.4f} steps/s, {voxels / dt:.1f} voxels/s (host "
          f"{t_host:.3f}s, device steps {t_dev:.3f}s; step 0 includes the "
          f"allocator's warm-up), 0 overflows [{card}]", flush=True)
    return total, summary


PTV3_CELL = "distill_step.scannet_openseg_ptv3"


def level_scenes(coords, num, levels=5):
    """Each level's voxels a scene of a level-0 (scene, x, y, z) array:
    level ``l`` holds the distinct ``coord >> l`` of each scene."""
    import numpy as np
    c = np.asarray(coords[:num]).astype(np.int64)
    scenes = int(c[:, 0].max()) + 1
    out = []
    for lvl in range(levels):
        u = np.unique(np.c_[c[:, :1], c[:, 1:] >> lvl], axis=0)
        out.append(np.bincount(u[:, 0], minlength=scenes).tolist())
    return out


def ptv3_phase(card, device):
    """PT-v3m1 at the PTv3 cell's size: the trainer of its configuration
    on its workload's rooms, :data:`TRAIN_STEPS` steps through
    :func:`train_phase` (every launch counted), then the attention kernels
    at levels 0 and 3 of the first batch.  Returns the launches, the
    summary and ``bench_attn``'s rows."""
    import torch
    from benchmark import data
    from openscene_tpu_torch.config import Config
    from openscene_tpu_torch.runtime.distill import DistillTrainer
    from openscene_tpu_torch.scripts.dev_attn_bench import (bench_attn,
                                                            cell_levels)
    bench = os.path.join(HERE, "benchmark")
    with open(os.path.join(bench, "workloads", PTV3_CELL + ".json")) as f:
        wl = json.load(f)
    with open(os.path.join(bench, "configs", wl["config"] + ".json")) as f:
        cfg = json.load(f)
    root = os.path.join(HERE, "build", "smoke_ptv3_data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ds = data.write(root, wl, 0, device, dim=cfg["feature_dim"],
                    num_classes=cfg["classes"],
                    fused_dir="scannet_multiview_openseg")
    trainer = DistillTrainer(Config(
        data_root=ds.data_root, data_root_2d_fused_feature=ds.fused_root,
        feature_2d_extractor=cfg["feature_2d_extractor"],
        classes=cfg["classes"], arch_3d=cfg["arch_3d"],
        voxel_size=cfg["voxel_size"], aug=cfg["aug"],
        input_color=cfg["input_color"], use_shm=cfg["use_shm"],
        workers=cfg["workers"], batch_size=cfg["batch_size"],
        base_lr=cfg["base_lr"], loss_type=cfg["loss_type"],
        loop=wl["loop"], epochs=cfg["epochs"], power=cfg["power"],
        compute_dtype=cfg["compute_dtype"], evaluate=False, manual_seed=0,
        save_path="", embedding_file=ds.text_file, text_embedding_cache=""),
        device=device)
    batches = list(trainer._epoch_batches())
    print(f"ptv3: {len(batches)} batches of {cfg['batch_size']} rooms "
          f"written and assembled in {time.time() - t0:.1f}s", flush=True)
    blocks = attn_modules(trainer.model)
    launches, summary = train_phase(
        trainer, iter(batches), card,
        f"train {cfg['arch_3d']} 3->{cfg['feature_dim']} cosine Adam bf16",
        falls=False, want={"stencil_conv_fwd": blocks,
                           "stencil_conv_bwd": blocks})
    raw, _ = batches[0]
    scenes = level_scenes(raw.coords, int(raw.num))
    summary["first_batch_voxels_a_scene"] = scenes
    summary["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del trainer, batches, raw
    torch.cuda.empty_cache()
    rows = bench_attn(cell_levels(scenes))
    for r in rows:
        print(f"kernel patch_attn {r['shape']} (bf16, forward and "
              f"backward): {r['ms']:.4f} ms (forward {r['fwd_ms']:.4f}, "
              f"backward {r['bwd_ms']:.4f}), plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.5f} "
              f"({r['bound_by']}, {r['roofline_pct']:.1f}%), error of the "
              f"largest value: {json.dumps(r['rel_err'])}; bit-equal, "
              f"launches 1 + 2 [{card}]", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return launches, summary, rows


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


def compare_train_step(trainer, batch, what="train"):
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
    parameters moved at all.  SGD (the seg trainer) moves each weight by lr
    times its gradient from the same momentum buffer and decay, so its
    updated parameters are held tighter: the kernel path's no farther from
    the plain path's, in L2 over all parameters, than lr times the two
    gradients' distance (1.01x) plus two fp32 ulps of the parameters.
    Returns the summary it prints."""
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
            out = step(batch)
            loss = float(out[0] if isinstance(out, tuple) else out)
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
    if (read_counts() != expected(TRAIN_LAUNCHES)
            or bn_counts() != (3 * bn_modules(model),) * 2):
        raise AssertionError(f"compared step: launches {read_counts()}, "
                             f"BatchNorm {bn_counts()}")
    with plain_path():
        zero_counts()
        loss_p, grads_p, params_p = run(torch.bfloat16)
        loss_32, grads_32, _ = run(torch.float32)
        if any(read_counts().values()) or any(bn_counts()):
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
    sgd = isinstance(opt, torch.optim.SGD)
    if sgd:  # the update is linear in the gradient
        pdist = sum((params_k[n] - params_p[n]).norm().item() ** 2
                    for n in params_p) ** 0.5
        gdist = sum((grads_k[n] - grads_p[n]).norm().item() ** 2
                    for n in params_p) ** 0.5
        pnorm = sum(p.norm().item() ** 2 for p in params_p.values()) ** 0.5
        sgd_limit = 1.01 * lr * gdist + 2 * 2.0 ** -23 * pnorm
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
    if sgd:
        out.update(param_l2_kernels_vs_plain=pdist, sgd_limit=sgd_limit)
    print(f"{what}-step parity (kernels vs plain vs fp32 plain on the card, "
          f"same state and batch): {json.dumps(out)}", flush=True)
    if sgd:
        params_ok = pdist <= sgd_limit
    else:
        params_ok = (dparam <= PARAM_TOL_ALL * lr
                     and dresolved <= PARAM_TOL_RESOLVED * lr
                     and dsum / count <= PARAM_TOL_MEAN * lr)
    if not (abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
            and k32_all <= 1.25 * p32_all + 0.01
            and k32[worst] <= 3 * p32[worst] + 0.05
            and 0 < moved and params_ok):
        raise AssertionError("kernel-path and plain-path train steps "
                             "disagree")
    return out

def eval_routes_phase(cfg, model, text, samples, card):
    """Zero-shot eval of each scene in each mode through the card's geometry
    and through the host's on the same level caps (the scene's own): the
    point logits must be bit-equal and the argmax agree at every point.
    Per scene: the host ms (assembly; the host route's includes its
    planner) and the device ms (the card route's includes the geometry
    build; both the step to its synchronised end).  Then one card-route
    distill step under the profiler: it copies no fused features."""
    import torch
    from openscene_tpu_torch.data.batch import (assemble_eval_batch,
                                                assemble_raw_eval_batch)
    from openscene_tpu_torch.runtime.evaluate import make_eval_step
    from openscene_tpu_torch.runtime.geometry_route import SceneGeometry
    from openscene_tpu_torch.sparse.geometry import GeometryCaps
    geometry = SceneGeometry(cfg, model.final.device)
    rows = []
    for mode in MODES:
        step = make_eval_step(mode, constant_input=True)
        fused = mode != "distill"
        for i, sample in enumerate(samples):
            torch.cuda.synchronize()
            t0 = time.time()
            raw, caps = assemble_raw_eval_batch([sample], DIM,
                                                need_fused=fused)
            t1 = time.time()
            geo, over = geometry.build(raw.coords, raw.num, caps.fixed)
            if over:
                raise AssertionError(f"scene {i}: the card's geometry "
                                     f"overflowed (caps {caps.fixed})")
            n = raw.num_points
            card_logits = step(model, text, raw, geo)[0][:n].cpu()
            t2 = time.time()
            batch = assemble_eval_batch(
                [sample], DIM, caps=GeometryCaps(cap0=caps.cap0,
                                                 fixed=caps.fixed),
                need_fused=fused)
            t3 = time.time()
            host_logits = step(model, text, batch)[0][:n].cpu()
            t4 = time.time()
            if (raw.feat_3d is None) != (mode == "distill"):
                raise AssertionError(f"{mode}: feat_3d assembled wrongly")
            equal = torch.equal(card_logits, host_logits)
            agree = bool((card_logits.argmax(1)
                          == host_logits.argmax(1)).all())
            row = {"mode": mode, "scene": i, "voxels": int(raw.num),
                   "caps": caps.fixed, "bit_equal": equal,
                   "argmax_agree": agree,
                   "card_host_ms": (t1 - t0) * 1e3,
                   "card_device_ms": (t2 - t1) * 1e3,
                   "host_host_ms": (t3 - t2) * 1e3,
                   "host_device_ms": (t4 - t3) * 1e3}
            rows.append(row)
            print(f"eval routes {mode} scene {i}: {row['voxels']} voxels, "
                  f"caps {caps.fixed}; card geometry: host {row['card_host_ms']:.1f} "
                  f"ms, device {row['card_device_ms']:.1f} ms; host geometry: "
                  f"host {row['host_host_ms']:.1f} ms, device "
                  f"{row['host_device_ms']:.1f} ms; logits bit-equal {equal}, "
                  f"argmax agree {agree} [{card}]", flush=True)
            if not (equal and agree):
                raise AssertionError(f"{mode} scene {i}: card and host "
                                     "geometry give other logits")
    raw, caps = assemble_raw_eval_batch([samples[0]], DIM, need_fused=False)
    geo, _ = geometry.build(raw.coords, raw.num, caps.fixed)
    step = make_eval_step("distill", constant_input=True)
    busy, prow = profile_device(lambda: step(model, text, raw, geo),
                                "eval card distill")
    copies = sum(r[0] for r in prow if "Memcpy HtoD" in r[2])
    print(f"profiler[eval card distill]: device busy {busy:.3f} ms, "
          f"Memcpy HtoD {copies:.3f} ms (no fused features) [{card}]",
          flush=True)
    return rows, {"busy_ms": busy, "memcpy_htod_ms": copies}


def native_phase(sample, card):
    """The C++ kernel-map builder must be available on the card's host; the
    host planner's ms for scene 0 with it and with NumPy (best of two), and
    the two plans bit-identical."""
    import numpy as np
    from openscene_tpu_torch.data.batch import assemble_raw_eval_batch
    from openscene_tpu_torch.sparse import geometry as G
    from openscene_tpu_torch.sparse import native
    if not native.available():
        raise AssertionError("the native kernel-map builder is unavailable "
                             "on the card's host (g++)")
    raw, _ = assemble_raw_eval_batch([sample], DIM, need_fused=False)
    coords = raw.coords[:int(raw.num)]

    def plan():
        times = []
        for _ in range(2):
            t0 = time.time()
            geo = G.build_unet_geometry(coords)
            times.append((time.time() - t0) * 1e3)
        return geo, min(times)

    geo_native, t_native = plan()
    available = native.available
    native.available = lambda: False
    try:
        geo_numpy, t_numpy = plan()
    finally:
        native.available = available
    a, b = geo_arrays(geo_native), geo_arrays(geo_numpy)
    if set(a) != set(b) or not all(np.array_equal(a[k], b[k]) for k in a):
        raise AssertionError("native and NumPy plans differ")
    print(f"native planner: available, library "
          f"{os.path.relpath(native.library_path(), HERE)}; scene 0 "
          f"({int(raw.num)} voxels) host planner {t_native:.1f} ms native, "
          f"{t_numpy:.1f} ms NumPy, plans bit-identical [{card}]", flush=True)
    return {"native_ms": t_native, "numpy_ms": t_numpy,
            "voxels": int(raw.num)}


HOSTMEM_CHILD = r"""
import json, sys, time, types
root3d, rootfeat, mode, batches = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
if mode == "without":  # the package's import then leaves malloc as it is
    stub = types.ModuleType("openscene_tpu_torch.utils.hostmem")
    stub.warm_malloc = lambda threshold=0: False
    stub._done = False
    sys.modules[stub.__name__] = stub
import numpy as np
from openscene_tpu_torch.data.batch import assemble_raw_distill_batch
from openscene_tpu_torch.data.loaders import FusedFeatureLoader
hostmem = sys.modules["openscene_tpu_torch.utils.hostmem"]
loader = FusedFeatureLoader(datapath_prefix=root3d, datapath_prefix_feat=rootfeat,
                            voxel_size=%r, split="train", aug=True, loop=batches,
                            seed=0)
rng, caps, rows = np.random.default_rng(0), None, []
for k in range(batches):
    t0 = time.time()
    samples = [loader.get(%d * k + j) for j in range(%d)]
    t1 = time.time()
    _, caps = assemble_raw_distill_batch(samples, %d, caps=caps, rng=rng)
    rows.append([(t1 - t0) * 1e3, (time.time() - t1) * 1e3])
print(json.dumps({"warm_malloc": bool(hostmem._done), "batches": rows}))
"""


def hostmem_phase(d3, dfeat, card, batches=3):
    """Host ms to load and assemble a raw 2-scene train batch, in a child
    process with the package's allocator tuning (``utils/hostmem``) and in
    one without it (the mallopt is process-wide, so each reading has its own
    process)."""
    code = HOSTMEM_CHILD % (VOXEL, TRAIN_BATCH, TRAIN_BATCH, DIM)
    out = {}
    for mode in ("with", "without"):
        proc = subprocess.run(
            [sys.executable, "-c", code, d3, dfeat, mode, str(batches)],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"hostmem child ({mode}) failed: "
                                 f"{proc.stderr[-2000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        if res["warm_malloc"] != (mode == "with"):
            raise AssertionError(f"hostmem child ({mode}): warm_malloc "
                                 f"{res['warm_malloc']}")
        out[mode] = res["batches"]
        print(f"hostmem {mode} warm_malloc: {TRAIN_BATCH}-scene raw train "
              f"batches, host ms (load + voxelize, assemble): "
              + ", ".join(f"({a:.1f}, {b:.1f})" for a, b in res["batches"])
              + f" [{card}]", flush=True)
    return out


# multi-view fusion at the ScanNet spec (fusion/datasets.py SPECS["scannet"])
FUSION_VIEWS = 100          # ScanNet's every-20th-frame export of a scene
FUSION_PROFILED_VIEWS = 10  # views of the profiled run (device split)
FUSION_CHECK_VIEWS = 4      # views held against the float64 reference loop
FUSION_AGREE = 0.99         # argmax = label share where the views agree
FUSION_FEAT_TOL = 1e-5      # card sums against float64, of their scale
TIE_PX = 1e-3               # a projected coordinate this close to a .5 tie
DEPTH_EDGE = 1e-4           # a depth test this close to its threshold
CLASSES = 20


def look_at(eye, target):
    """camera_to_world with +z looking from eye to target
    (``tests/test_fusion.py:look_at_pose``)."""
    import numpy as np
    fwd = np.asarray(target, float) - np.asarray(eye, float)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 0, 1.0])
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0, 0])
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up, fwd, eye
    return pose


def zbuffer(pose, intr, coords, W, H):
    """(depth (H, W) fp32, 0 where no point; nearest point's index (H, W),
    -1 there): the points themselves z-buffered, vectorised."""
    import numpy as np
    inv = np.linalg.inv(pose)
    p = coords @ inv[:3, :3].T + inv[:3, 3]
    z = p[:, 2]
    ok = z > 1e-6
    u = np.round(p[ok, 0] * intr[0, 0] / z[ok] + intr[0, 2])
    v = np.round(p[ok, 1] * intr[1, 1] / z[ok] + intr[1, 2])
    idx = np.flatnonzero(ok)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    pix = (v[inb] * W + u[inb]).astype(np.int64)
    idx, zz = idx[inb], z[idx[inb]]
    order = np.lexsort((zz, pix))  # by pixel, nearest first
    first = np.ones(len(order), bool)
    first[1:] = pix[order[1:]] != pix[order[:-1]]
    sel = order[first]
    depth = np.zeros(H * W, np.float32)
    depth[pix[sel]] = zz[sel]
    nearest = np.full(H * W, -1, np.int64)
    nearest[pix[sel]] = idx[sel]
    return depth.reshape(H, W), nearest.reshape(H, W)


def fusion_scene():
    """Scene 0 at bench density (a ScanNet-sized room), FUSION_VIEWS look_at
    cameras at eye height inside the room looking across it, each view's
    depth z-buffered from the scene's points and its label image: the
    label of the nearest labelled point (the 2% of points marked ignore lie
    on the same surfaces), the background index CLASSES where there is
    none."""
    import numpy as np
    from openscene_tpu_torch.data.synthetic import make_scene
    from openscene_tpu_torch.fusion.datasets import SCANNET_INTRINSIC, SPECS
    coords, colors, labels = make_scene(0, density=DENSITY)
    W, H = SPECS["scannet"].image_dim
    intr = SCANNET_INTRINSIC[:3, :3]
    rng = np.random.default_rng(0)
    labelled = np.flatnonzero(labels != 255)
    lo, hi = coords.min(0), coords.max(0)
    centre, ext = (lo + hi) / 2, hi - lo
    cams, label_imgs = [], []
    for i in range(FUSION_VIEWS):
        ang = 2 * np.pi * i / FUSION_VIEWS + rng.uniform(-0.2, 0.2)
        r = rng.uniform(0.1, 0.45)
        eye = centre + [r * ext[0] * np.cos(ang), r * ext[1] * np.sin(ang),
                        0.0]
        eye[2] = lo[2] + rng.uniform(1.0, 1.8)
        target = centre - (eye - centre) * rng.uniform(0.5, 1.5)
        target[2] = lo[2] + rng.uniform(0.2, 1.2)
        pose = look_at(eye, target)
        depth, _ = zbuffer(pose, intr, coords, W, H)
        _, nearest = zbuffer(pose, intr, coords[labelled], W, H)
        cams.append((pose, intr, depth))
        label_imgs.append(np.where(nearest >= 0,
                                   labels[labelled[nearest]], CLASSES))
    return coords, colors, labels, cams, np.stack(label_imgs)


def feature_maps(label_imgs, dim):
    """The teacher stand-in: ``fn(i)`` -> view i's (dim, H, W) fp16 map,
    each pixel its label's prototype (``class_prototypes(CLASSES, dim)``),
    zeros without a point; and the prototypes."""
    import numpy as np
    from openscene_tpu_torch.data.synthetic import class_prototypes
    protos = class_prototypes(CLASSES, dim)
    table = np.vstack([protos, np.zeros((1, dim), np.float32)]).T.astype(
        np.float16).view(np.uint16)  # (dim, CLASSES + 1)

    def fn(i):
        lab = label_imgs[i]
        out = np.empty((dim,) + lab.shape, np.uint16)
        for c in range(dim):  # per channel: 3x faster than one take
            np.take(table[c], lab, out=out[c], mode="clip")
        return out.view(np.float16)
    return fn, protos


def fusion_reference_check(fuser, coords, cams, fn, spec, card):
    """(b) the card's sum_feat and counter over the first
    FUSION_CHECK_VIEWS views against a float64 NumPy transcription of the
    reference loop (``PointCloudToImageMapper``, as
    ``tests/test_fusion.py:177-199`` writes it).  Every visibility or pixel
    disagreement must be a projected coordinate within TIE_PX of a .5 tie or
    a depth test within DEPTH_EDGE (relative) of its threshold; sums of the
    points mapped alike in every view agree within FUSION_FEAT_TOL of the
    scale, their counts exactly."""
    import numpy as np
    import torch
    from openscene_tpu_torch.fusion.mapper import (PointCloudToImageMapper,
                                                   compute_mapping_torch)
    sub = cams[:FUSION_CHECK_VIEWS]
    W, H = spec.image_dim
    sum_feat, counter = fuser.accumulate(coords, sub, fn)
    dev = sum_feat.device
    v, u, vis = compute_mapping_torch(
        torch.as_tensor(np.stack([c[0] for c in sub]), device=dev),
        torch.as_tensor(np.stack([c[1] for c in sub]), device=dev),
        torch.as_tensor(coords, dtype=torch.float32, device=dev),
        torch.as_tensor(np.stack([c[2] for c in sub]), device=dev),
        (W, H), spec.vis_thres, spec.cut_bound)
    v, u, vis = v.cpu().numpy(), u.cpu().numpy(), vis.cpu().numpy()
    if not np.array_equal(counter.cpu().numpy(), vis.sum(0)):
        raise AssertionError("fusion: the fuser's counter is not the sum of "
                             "its views' visibility")
    mapper = PointCloudToImageMapper(spec.image_dim, spec.vis_thres,
                                     spec.cut_bound)
    n = len(coords)
    ref_sum = np.zeros((n, fuser.feat_dim))
    ref_cnt = np.zeros(n, np.int64)
    alike = np.ones(n, bool)
    kinds = {"tie": 0, "depth_edge": 0, "unexplained": 0}
    homo = np.concatenate([coords, np.ones((n, 1))], axis=1).T
    for j, (pose, intr, depth) in enumerate(sub):
        mapping = mapper.compute_mapping(pose, coords, depth, intr)
        mask = mapping[:, 2] == 1
        fmap = fn(j)
        ref_sum[mask] += fmap[:, mapping[mask, 0], mapping[mask, 1]].T
        ref_cnt[mask] += 1
        differ = (mask != vis[j]) | (mask & ((mapping[:, 0] != v[j])
                                             | (mapping[:, 1] != u[j])))
        alike &= ~differ
        if not differ.any():
            continue
        p = np.linalg.inv(pose) @ homo[:, differ]
        uf = p[0] * intr[0][0] / p[2] + intr[0][2]
        vf = p[1] * intr[1][1] / p[2] + intr[1][2]
        tie = ((np.abs(uf - np.floor(uf) - 0.5) < TIE_PX)
               | (np.abs(vf - np.floor(vf) - 0.5) < TIE_PX))
        edge = np.zeros(len(uf), bool)
        for rows, cols in ((np.round(vf), np.round(uf)),
                           (v[j][differ], u[j][differ])):
            rows = np.clip(rows, 0, H - 1).astype(np.int64)
            cols = np.clip(cols, 0, W - 1).astype(np.int64)
            d = depth[rows, cols].astype(np.float64)
            thr = spec.vis_thres * d
            edge |= np.abs(np.abs(d - p[2]) - thr) <= DEPTH_EDGE * thr
        kinds["tie"] += int(tie.sum())
        kinds["depth_edge"] += int((edge & ~tie).sum())
        kinds["unexplained"] += int((~tie & ~edge).sum())
    got_sum = sum_feat.cpu().numpy()
    got_cnt = counter.cpu().numpy()
    scale = float(np.abs(ref_sum).max())
    err = float(np.abs(got_sum[alike] - ref_sum[alike]).max())
    out = dict(kinds, views=len(sub), points_mapped_alike=int(alike.sum()),
               visible_card=int((got_cnt > 0).sum()),
               visible_ref=int((ref_cnt > 0).sum()), max_abs_err=err,
               scale=scale, tol=FUSION_FEAT_TOL * scale)
    print(f"fusion vs float64 reference loop ({len(sub)} views at "
          f"{W}x{H}, {n} points): disagreements {kinds['tie']} at a .5 "
          f"tie, {kinds['depth_edge']} at the depth threshold, "
          f"{kinds['unexplained']} unexplained; sums of "
          f"{out['points_mapped_alike']} points mapped alike: max|diff| "
          f"{err:.3e} of scale {scale:.3e} [{card}]", flush=True)
    if kinds["unexplained"]:
        raise AssertionError(f"fusion: {kinds['unexplained']} visibility "
                             "disagreements with the float64 reference "
                             "are neither ties nor depth-threshold cases")
    if not np.array_equal(got_cnt[alike], ref_cnt[alike]):
        raise AssertionError("fusion: counts differ from the reference")
    if not err <= FUSION_FEAT_TOL * scale:
        raise AssertionError(f"fusion: sums differ from the float64 "
                             f"reference by {err} (scale {scale})")
    return out


def fusion_cli_check(device, card):
    """(c) ``fuse_dataset("nuscenes")`` on the card, on a layout of
    ``.npy`` poses and intrinsics and no depth (no PIL on the way), as
    ``tests/test_fusion.py:139-176`` builds one: the blob's mask equals the
    reference fusion script's literal transcription, its features within
    one fp16 ulp of it."""
    import numpy as np
    from openscene_tpu_torch.fusion.datasets import SPECS
    from openscene_tpu_torch.fusion.mapper import (PointCloudToImageMapper,
                                                   make_intrinsic)
    from openscene_tpu_torch.fusion.run_fusion import fuse_dataset
    root = os.path.join(HERE, "build", "smoke_fusion", "nuscenes")
    shutil.rmtree(root, ignore_errors=True)
    spec = SPECS["nuscenes"]
    W, H = spec.image_dim
    C, n, sid, cams = 8, 400, "scene0", ("back", "front")
    rng = np.random.default_rng(0)
    coords = (rng.random((n, 3)) * [20, 20, 4] - [10, 10, 2]).astype(
        np.float32)
    labels = np.full(n, 255, np.int64)
    labels[rng.choice(n, n // 2, replace=False)] = rng.integers(0, 16,
                                                                n // 2)
    d3 = os.path.join(root, "nuscenes_3d")
    os.makedirs(d3)
    np.savez(os.path.join(d3, f"{sid}.npz"), coords=coords, labels=labels)
    intr = make_intrinsic(400.0, 400.0, W / 2, H / 2)
    poses = {"back": look_at([0, -25, 1], [0, 0, 0]),
             "front": look_at([0, 25, 1], [0, 0, 0])}
    fmaps = {}
    for cam in cams:
        for sub, arr in (("pose", poses[cam]), ("K", intr)):
            os.makedirs(os.path.join(root, "nuscenes_2d", sid, sub),
                        exist_ok=True)
            np.save(os.path.join(root, "nuscenes_2d", sid, sub,
                                 f"{cam}.npy"), arr)
        fmaps[cam] = rng.standard_normal((C, H, W)).astype(np.float32)
        os.makedirs(os.path.join(root, "feats", sid), exist_ok=True)
        np.save(os.path.join(root, "feats", sid, f"{cam}.npy"), fmaps[cam])
    out_dir = os.path.join(root, "out")
    fuse_dataset("nuscenes", d3, os.path.join(root, "nuscenes_2d"), out_dir,
                 split="train", feat_dir=os.path.join(root, "feats"),
                 feat_dim=C, device=device)
    blob = np.load(os.path.join(out_dir, f"{sid}.npz"))
    # --- literal transcription of the reference fusion script ---
    mask_entire = labels != 255
    locs = coords.astype(np.float64)[mask_entire]
    m = locs.shape[0]
    counter = np.zeros((m, 1))
    sum_features = np.zeros((m, C))
    vis_id = np.zeros((m, len(cams)), dtype=int)
    mapper = PointCloudToImageMapper(spec.image_dim,
                                     cut_bound=spec.cut_bound)
    for img_id, cam in enumerate(cams):
        mapping = np.ones([m, 4], dtype=int)
        mapping[:, 1:4] = mapper.compute_mapping(poses[cam], locs,
                                                 depth=None, intrinsic=intr)
        mask = mapping[:, 3]
        vis_id[:, img_id] = mask
        feat_2d_3d = fmaps[cam][:, mapping[:, 1], mapping[:, 2]].T
        counter[mask != 0] += 1
        sum_features[mask != 0] += feat_2d_3d[mask != 0]
    counter[counter == 0] = 1e-5
    feat_bank = sum_features / counter
    point_ids = np.unique(np.nonzero(vis_id)[0])
    mask = np.zeros(m, dtype=bool)
    mask[point_ids] = True
    ref_mask_full = mask_entire.copy()
    ref_mask_full[mask_entire] = mask
    ref_feat = feat_bank[mask].astype(np.float16)
    got = blob["feat"]
    ulp = np.spacing(np.abs(ref_feat)).astype(np.float32)
    diff = np.abs(got.astype(np.float32) - ref_feat.astype(np.float32))
    out = {"points": n, "labelled": int(mask_entire.sum()),
           "visible": int(mask.sum()), "feat_equal": int((diff == 0).sum()),
           "feat_values": int(diff.size),
           "max_diff_in_ulps": float((diff / ulp).max()) if diff.size
           else 0.0}
    print(f"fusion cli nuscenes (fuse_dataset on the card, no depth, no "
          f"PIL): {out['visible']} of {out['labelled']} labelled points "
          f"visible, mask_full equal: "
          f"{np.array_equal(blob['mask_full'], ref_mask_full)}, feat "
          f"{out['feat_equal']}/{out['feat_values']} values equal, max "
          f"{out['max_diff_in_ulps']:.2f} fp16 ulp [{card}]", flush=True)
    if not (out["visible"] > 20
            and np.array_equal(blob["mask_full"], ref_mask_full)
            and got.shape == ref_feat.shape and (diff <= ulp).all()):
        raise AssertionError("fusion: the nuScenes blob differs from the "
                             "reference fusion script's transcription")
    return out


def fusion_eval_check(scene, bank, ids, protos, device, card):
    """(d) stage 1 into stage 3: scene 0's fused features saved as a val
    blob ``{sid}_0.npz`` and ``ZeroShotEvaluator`` run on them in fusion
    mode on the card, the prototypes as text: finite logits, and the
    feature mask set on every voxel whose points fusion all saw and on no
    voxel whose points it saw none of."""
    import numpy as np
    from openscene_tpu_torch.config import Config
    from openscene_tpu_torch.data.scene_io import (save_fused_features,
                                                   save_scene)
    from openscene_tpu_torch.runtime.evaluate import ZeroShotEvaluator
    coords, colors, labels = scene
    root = os.path.join(HERE, "build", "smoke_fusion", "eval")
    shutil.rmtree(root, ignore_errors=True)
    d3 = os.path.join(root, "scannet_3d")
    dfeat = os.path.join(root, "scannet_multiview")
    os.makedirs(os.path.join(d3, "val"))
    os.makedirs(dfeat)
    sid = "scene0000_00"
    seen = np.zeros(len(coords), bool)
    seen[ids] = True
    save_scene(os.path.join(d3, "val", sid + ".npz"), coords, colors, labels)
    save_fused_features(os.path.join(dfeat, f"{sid}_0.npz"),
                        bank[seen].astype(np.float16), seen)
    cfg = Config(data_root=d3, data_root_2d_fused_feature=dfeat,
                 feature_2d_extractor="openseg", voxel_size=VOXEL,
                 split="val", feature_type="fusion", test_repeats=1,
                 test_workers=1, manual_seed=0, text_embedding_cache="")
    ev = ZeroShotEvaluator(cfg, text_features=protos, device=device)
    t0 = time.time()
    res = ev.run()
    dt = time.time() - t0
    sample = ev._loader().get(0)
    out, n = ev.scene(sample, ev.step)
    logits = out[0][:n]
    mask = out[1][:n].cpu().numpy() > 0.5
    vox = np.asarray(sample.inds_reconstruct)
    size = np.bincount(vox)
    n_seen = np.bincount(vox, weights=seen)
    all_seen, none_seen = (n_seen == size)[vox], (n_seen == 0)[vox]
    wrong = int(((all_seen & ~mask) | (none_seen & mask)).sum())
    stats = {"points": int(n), "voxels": int(len(size)),
             "mask_points": int(mask.sum()), "seen_points": int(seen.sum()),
             "seen_covered": float((mask & seen).sum() / seen.sum()),
             "wrong_mask_points": wrong, "miou": res["miou"],
             "seconds": dt}
    print(f"fusion into eval (ZeroShotEvaluator fusion mode on the card, "
          f"prototypes as text): {n} points in {stats['voxels']} voxels, "
          f"feature mask on {stats['mask_points']} points, fusion saw "
          f"{stats['seen_points']} ({stats['seen_covered']:.4f} of them "
          f"masked), {wrong} points masked against their voxel's points, "
          f"mIoU {res['miou']:.4f}, {dt:.2f}s [{card}]", flush=True)
    if not (logits.shape == (len(coords), CLASSES)
            and bool(logits.isfinite().all()) and np.isfinite(res["miou"])):
        raise AssertionError("fusion eval: logits or mIoU not finite")
    if wrong:
        raise AssertionError(f"fusion eval: {wrong} points' feature mask "
                             "disagrees with what fusion saw")
    return stats


def fusion_phase(card, device):
    """Multi-view fusion on ``cuda`` at the ScanNet spec (320x240,
    ``SCANNET_INTRINSIC``, vis_thres 0.25, cut_bound 10), OpenSeg width:
    (a) ``MultiViewFuser.fuse_scene`` of scene 0 over FUSION_VIEWS views, timed
    (wall, the teacher's host ms) and profiled on FUSION_PROFILED_VIEWS
    views (copies and kernels), the argmax gate; (b)-(d) the reference
    loop, the nuScenes CLI path and the evaluator, as their functions say.
    Fusion launches none of the seven kernels: their counts stay 0."""
    import numpy as np
    import torch
    from openscene_tpu_torch.fusion.datasets import SPECS
    from openscene_tpu_torch.fusion.fuse import MultiViewFuser
    from openscene_tpu_torch.fusion.mapper import compute_mapping_torch
    t_phase = time.time()
    t0 = time.time()
    coords, colors, labels, cams, label_imgs = fusion_scene()
    fn, protos = feature_maps(label_imgs, DIM)
    print(f"fusion data: {len(coords)} points, {len(cams)} views "
          f"z-buffered in {time.time() - t0:.1f}s", flush=True)
    spec = SPECS["scannet"]
    W, H = spec.image_dim
    fuser = MultiViewFuser(spec.image_dim, spec.vis_thres, spec.cut_bound,
                           use_depth=True, feat_dim=DIM, device=device)
    host_s = [0.0]

    def timed_fn(i):
        t = time.perf_counter()
        fmap = fn(i)
        host_s[0] += time.perf_counter() - t
        return fmap

    zero_counts()
    fuser.fuse_scene(coords, cams[:2], fn)  # staging buffers, first calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bank, ids = fuser.fuse_scene(coords, cams, timed_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    busy, rows = profile_device(
        lambda: fuser.fuse_scene(coords, cams[:FUSION_PROFILED_VIEWS], fn),
        "fusion")
    h2d = sum(r[0] for r in rows if "HtoD" in r[2])
    d2h = sum(r[0] for r in rows if "DtoH" in r[2])
    copies = sum(r[0] for r in rows if r[2].startswith("Memcpy"))
    # each point's sampled labels over the views that see it, on the card
    dev = torch.device(device)
    coords_t = torch.as_tensor(coords, dtype=torch.float32, device=dev)
    labs = torch.as_tensor(label_imgs.reshape(len(cams), -1), device=dev)
    lo = torch.full((len(coords),), CLASSES + 1, dtype=labs.dtype,
                    device=dev)
    hi = torch.full_like(lo, -1)
    for s in range(0, len(cams), 4):
        chunk = cams[s:s + 4]
        v, u, vis = compute_mapping_torch(
            torch.as_tensor(np.stack([c[0] for c in chunk]), device=dev),
            torch.as_tensor(np.stack([c[1] for c in chunk]), device=dev),
            coords_t,
            torch.as_tensor(np.stack([c[2] for c in chunk]), device=dev),
            (W, H), spec.vis_thres, spec.cut_bound)
        lab = torch.gather(labs[s:s + len(chunk)], 1, (v * W + u).long())
        lo = torch.minimum(lo, torch.where(vis, lab, CLASSES + 1).amin(0))
        hi = torch.maximum(hi, torch.where(vis, lab, -1).amax(0))
    lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
    if not np.array_equal(np.flatnonzero(hi >= 0), ids):
        raise AssertionError("fusion: point_ids differ from the views' "
                             "visibility")
    sel = np.flatnonzero((hi >= 0) & (lo == hi) & (labels != 255))
    pred = (torch.as_tensor(bank[sel], device=dev)
            @ torch.as_tensor(protos, device=dev).t()).argmax(1).cpu()
    share = float((pred.numpy() == labels[sel]).mean())
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"fusion launched conv kernels: {launches}")
    stats = {
        "points": len(coords), "views": len(cams), "dim": DIM,
        "image": [W, H], "visible": int(len(ids)), "wall_ms": wall * 1e3,
        "feature_fn_host_ms": host_s[0] * 1e3,
        "profiled_views": FUSION_PROFILED_VIEWS,
        "profiled_h2d_ms": h2d, "profiled_d2h_ms": d2h,
        "profiled_device_ms": busy - copies,
        "views_per_s": len(cams) / wall, "scenes_per_s": 1.0 / wall,
        "peak_device_bytes": int(peak), "agree_points": int(len(sel)),
        "argmax_share": share}
    print(f"fusion (a): {len(coords)} points, {len(cams)} views "
          f"{W}x{H} {DIM}-d fp16, {len(ids)} points visible; wall "
          f"{wall * 1e3:.1f} ms ({len(cams) / wall:.2f} views/s, "
          f"{1 / wall:.4f} scenes/s), of it feature_fn {host_s[0] * 1e3:.1f}"
          f" ms on the host; profiled {FUSION_PROFILED_VIEWS} views: HtoD "
          f"{h2d:.3f} ms, DtoH {d2h:.3f} ms, kernels {busy - copies:.3f} "
          f"ms; peak device memory {peak / 2**20:.1f} MiB; argmax = label "
          f"at {share:.5f} of {len(sel)} points whose views agree "
          f"[{card}]", flush=True)
    if share < FUSION_AGREE:
        raise AssertionError(f"fusion: argmax = label at {share} < "
                             f"{FUSION_AGREE}")
    zero_counts()
    stats["reference"] = fusion_reference_check(fuser, coords, cams, fn,
                                                spec, card)
    stats["cli_nuscenes"] = fusion_cli_check(device, card)
    stats["eval"] = fusion_eval_check((coords, colors, labels), bank, ids,
                                      protos, device, card)
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"fusion launched conv kernels: {launches}")
    stats["phase_s"] = time.time() - t_phase
    print(f"fusion phase: {stats['phase_s']:.1f}s", flush=True)
    return stats


def seg_config(d3):
    """``configs/scannet/mink.yaml`` (MinkUNet18A, 3 -> 20 classes, batch 8,
    SGD, constant input, bf16), on the synthetic scenes: epochs of
    SEG_STEPS batches, two epochs' schedule (the learning rate is not yet
    0 at the compared step)."""
    from openscene_tpu_torch.config import load_config
    loop = SEG_STEPS * SEG_BATCH // SEG_TRAIN_SCENES
    return load_config(os.path.join(HERE, SEG_CONFIG), (
        "data_root", d3, "epochs", "2", "loop", str(loop),
        "batch_size", str(SEG_BATCH), "evaluate", "False", "workers", "2",
        "test_repeats", "1", "manual_seed", "0", "save_folder", "",
        "save_path", os.path.join(HERE, "build", "smoke_seg_exp")))


def seg_phase(card, device):
    """Supervised segmentation on ``cuda``: SEG_STEPS steps of
    ``SegTrainer`` on SEG_BATCH-scene batches, geometry built on the card
    (launches counted per step); one step on a 2-scene batch through the
    kernels, the plain versions and fp32; ``evaluate_seg`` on the val
    scenes at one repeat."""
    import numpy as np
    import torch
    from openscene_tpu_torch.data.batch import assemble_seg_batch
    from openscene_tpu_torch.data.loaders import Point3DLoader
    from openscene_tpu_torch.data.synthetic import build_synthetic_dataset
    from openscene_tpu_torch.runtime.eval_seg import evaluate_seg
    from openscene_tpu_torch.runtime.train_seg import SegTrainer
    root = os.path.join(HERE, "build", "smoke_seg_data")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    d3, _ = build_synthetic_dataset(root, n_train=SEG_TRAIN_SCENES,
                                    n_val=N_SCENES, dim=8, density=DENSITY)
    print(f"seg data: {SEG_TRAIN_SCENES} train and {N_SCENES} val scenes "
          f"written in {time.time() - t0:.1f}s", flush=True)
    cfg = seg_config(d3)
    if (cfg.arch_3d, cfg.classes, cfg.batch_size, cfg.input_color) != (
            ARCH, 20, SEG_BATCH, False):
        raise AssertionError(f"{SEG_CONFIG} is not MinkUNet18A 3 -> 20, "
                             "batch 8, constant input")
    trainer = SegTrainer(cfg, device=device)
    if not trainer.geometry.on:
        raise AssertionError("device_geometry 'auto' is off on cuda")
    seen = []

    def recorded(batches):
        for b in batches:
            seen.append(b)
            yield b

    launches, summary = train_phase(
        trainer, recorded(trainer._epoch_batches()), card,
        f"seg train {ARCH} 3->20 CE SGD bf16", steps=SEG_STEPS, falls=False)
    graph = geometry_graph_check(trainer, *seen[-1], card)
    samples = [trainer.train_data.get(i) for i in range(2)]
    batch = assemble_seg_batch(samples, rng=np.random.default_rng(0),
                               shift=True)
    parity = compare_train_step(trainer, batch, what="seg")
    # evaluation: the val scenes' voxels as evaluate_seg voxelizes them
    loader = Point3DLoader(datapath_prefix=d3, voxel_size=cfg.voxel_size,
                           split="val", eval_all=True, seed=cfg.manual_seed)
    loader.reseed(int(np.random.default_rng(cfg.manual_seed).integers(
        10000)))
    voxels = sum(len(loader.get(i).coords) for i in range(N_SCENES))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    res = evaluate_seg(cfg, trainer.model, device=device)
    torch.cuda.synchronize()
    dt = time.time() - t0
    got = read_counts()
    want = expected(dict(stencil_conv_fwd=STENCILS_PER_FORWARD * N_SCENES,
                         down_conv_fwd=DOWNS_PER_FORWARD * N_SCENES,
                         up_conv_fwd=UPS_PER_FORWARD * N_SCENES))
    if got != want:
        raise AssertionError(f"seg eval: launches {got}, want {want}")
    if not 0.0 <= res["miou"] <= 1.0:
        raise AssertionError(f"seg eval: mIoU {res['miou']}")
    for k in got:
        launches[k] += got[k]
    print(f"seg eval: {ARCH} 3->20, {N_SCENES} val scenes, {voxels} voxels "
          f"in {dt:.3f}s -> {voxels / dt:.1f} voxels/s, mIoU "
          f"{res['miou']:.4f} (after {SEG_STEPS} steps from random weights: "
          f"a smoke value, not an accuracy) [{card}]", flush=True)
    return launches, {"train": summary, "parity": parity, "graph": graph,
                      "eval": {"voxels": voxels, "seconds": dt,
                               "voxels_per_s": voxels / dt,
                               "miou": res["miou"]}}


DIST_DEVICE = "cuda:0"      # both ranks of (b) on the one card, by name
DIST_TIMEOUT = 600          # seconds for the two spawned ranks
DIST_SGD_LR = 1e-2          # the head-sharding check's SGD step
DIST_CAVEAT = ("two ranks share one card: these are no scaling numbers")


def free_port():
    """A free TCP port on localhost (the world-1 NCCL group's store)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def state_of(model):
    """Copies of a model's parameters and buffers, by name."""
    return {n: t.detach().clone() for n, t in
            list(model.named_parameters()) + list(model.named_buffers())}


def dist_nccl_phase(d3, dfeat, card):
    """(a) NCCL at world size 1, through torchrun's environment: one
    distill step at ``data_parallel -1`` with the reductions running must
    equal a step without a process group on the same batch, caps and
    state, bit for bit (loss, parameters, BatchNorm buffers)."""
    import torch
    import torch.distributed as dist
    from openscene_tpu_torch.device import resolve_device
    from openscene_tpu_torch.parallel.mesh import (
        default_backend, maybe_initialize_distributed)
    from openscene_tpu_torch.runtime.distill import DistillTrainer
    cfg = train_config(d3, dfeat)
    ref = DistillTrainer(cfg, allow_pseudo_text=True, device=DIST_DEVICE)
    if ref.mesh is not None:
        raise AssertionError("a mesh without a process group")
    batch = next(ref._epoch_batches())
    init = state_of(ref.model)
    loss_ref = float(ref.train_step(batch))
    after_ref = state_of(ref.model)
    del ref
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    try:
        if not maybe_initialize_distributed(cfg, DIST_DEVICE):
            raise AssertionError("torchrun's environment made no group")
        backend = dist.get_backend()
        tr = DistillTrainer(cfg, allow_pseudo_text=True, device=DIST_DEVICE)
        if tr.mesh is None or (tr.mesh.data, tr.mesh.model) != (1, 1):
            raise AssertionError(f"data_parallel -1 on one rank: {tr.mesh}")
        if any(not torch.equal(v, init[n])
               for n, v in state_of(tr.model).items()):
            raise AssertionError("the two trainers start apart")
        torch.cuda.synchronize()
        zero_counts()
        loss = float(tr.train_step(batch))
        torch.cuda.synchronize()
        got = read_counts()
        after = state_of(tr.model)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    if (backend != default_backend(resolve_device(DIST_DEVICE))
            or got != expected(TRAIN_LAUNCHES)):
        raise AssertionError(f"(a): backend {backend}, launches {got}")
    diff = [n for n, v in after_ref.items() if not torch.equal(v, after[n])]
    print(f"dist (a) NCCL world size 1 ({backend}, torchrun environment): "
          f"step with the reductions vs without a process group, same "
          f"batch ({int(batch[0].num)} voxels), caps and state: loss "
          f"{loss!r} vs {loss_ref!r}, {len(after) - len(diff)}/{len(after)} "
          f"parameters and buffers bit-equal, launches {got} [{card}]",
          flush=True)
    if loss != loss_ref or diff:
        raise AssertionError(f"(a): not bit-equal: {diff[:5]}")
    return got


def _rank_record(fn):
    """``(result, device ms)`` of ``fn()`` between two synchronisations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t0) * 1e3


def _dist_dp(d3, dfeat, dev):
    """Distill at data=2, one scene a rank: the one-process step and the
    data-parallel step from the same state on this rank's batch and caps,
    and Adam from that state on the ranks' mean one-process gradient."""
    import copy
    import torch
    import torch.distributed as dist
    from openscene_tpu_torch.runtime.distill import DistillTrainer
    tr = DistillTrainer(train_config(d3, dfeat).copy(data_parallel=2),
                        allow_pseudo_text=True, device=dev)
    if (tr.mesh.data, tr.mesh.model, tr.per_dev_batch) != (2, 1, 1):
        raise AssertionError(f"dp mesh {tr.mesh}")
    batch = next(tr._epoch_batches())
    step, model, opt = tr.step_fn, tr.model, tr.optimizer
    state0 = copy.deepcopy(model.state_dict())
    opt0 = copy.deepcopy(opt.state_dict())

    def restore():
        model.load_state_dict(state0)
        opt.load_state_dict(copy.deepcopy(opt0))
        step.it = 0

    step.mesh = None
    tr.train_step(batch)  # the rank's first step warms the card up
    restore()
    loss_one, ms_one = _rank_record(lambda: float(tr.train_step(batch)))
    grads = [p.grad.clone() for p in model.parameters()]
    restore()
    step.mesh = tr.mesh
    zero_counts()
    loss_dp, ms_dp = _rank_record(lambda: float(tr.train_step(batch)))
    counts = read_counts()
    same = _same_on_ranks(state_of(model).values())
    params_dp = [p.detach().clone() for p in model.parameters()]
    # the reference: Adam on the mean of the ranks' one-process gradients
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= 2
    restore()
    at = 0
    for p in model.parameters():
        p.grad = flat[at:at + p.numel()].view_as(p).clone()
        at += p.numel()
    for group in opt.param_groups:
        group["lr"] = tr.schedule(0)
    opt.step()
    err = max((a - p.detach()).abs().max().item()
              for a, p in zip(params_dp, model.parameters()))
    bound = max((2 * torch.finfo(torch.float32).eps * p.detach().abs()
                 ).max().item() for p in model.parameters())
    losses = [None, None]
    dist.all_gather_object(losses, loss_one)
    return dict(loss_dp=loss_dp, loss_one=loss_one, losses_one=losses,
                ms_one=ms_one, ms_dp=ms_dp, voxels=int(batch[0].num),
                caps=list(batch[1]), counts=counts, param_err=err,
                param_bound=bound, same=same)


def _same_on_ranks(tensors):
    """Whether every rank holds bit-identical ``tensors`` (parameters and
    buffers)."""
    import torch
    import torch.distributed as dist
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    same = torch.tensor([int(torch.equal(flat, ref))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


def _dist_head(d3, dfeat, dev):
    """Head sharding at data=1 x model=2 on one 2-scene batch: an SGD step
    of the sharded head (the trainer's own device-geometry path) against
    the one-process step on the same batch, caps and weights, in bf16
    through the kernels and in fp32 through the plain versions."""
    import contextlib
    import copy
    import torch
    from openscene_tpu_torch.models.sparse_unet import MinkUNet
    from openscene_tpu_torch.parallel.mesh import gather_head
    from openscene_tpu_torch.runtime.distill import (DistillTrainer,
                                                     RawTrainStep,
                                                     make_train_step)
    cfg = train_config(d3, dfeat).copy(data_parallel=1, model_parallel=2)
    tr = DistillTrainer(cfg, allow_pseudo_text=True, device=dev)
    if (tr.mesh.data, tr.mesh.model) != (1, 2) or \
            tr.model.final.shape[-1] != DIM // 2:
        raise AssertionError(f"head mesh {tr.mesh}")
    raw, caps = next(tr._epoch_batches())
    full = MinkUNet(3, DIM, ARCH, generator=torch.Generator().manual_seed(
        cfg.manual_seed)).to(dev)
    before = state_of(full)
    if not torch.equal(gather_head(tr.model.final.detach(), tr.mesh),
                       before["final"]):
        raise AssertionError("the shards are not the one-process head")
    full0 = copy.deepcopy(full.state_dict())
    sharded0 = copy.deepcopy(tr.model.state_dict())

    def sgd_step(model, mesh, ccfg):
        sgd = torch.optim.SGD(model.parameters(), lr=DIST_SGD_LR)
        return make_train_step(ccfg, model, sgd, lambda it: DIST_SGD_LR, dev,
                               mesh=mesh)

    out = {}
    for name, ccfg, ctx in (
            ("bf16", cfg, contextlib.nullcontext),
            ("fp32", cfg.copy(compute_dtype="float32"), plain_path)):
        tr.model.load_state_dict(sharded0)
        full.load_state_dict(full0)
        with ctx():
            tr.step_fn = sgd_step(tr.model, tr.mesh, ccfg)
            tr.geometry.raw_steps = {}
            zero_counts()
            loss_sh, ms_sh = _rank_record(
                lambda: float(tr.train_step((raw, caps))))
            counts = read_counts()
            one = sgd_step(full, None, ccfg)

            def one_step():
                geo, _ = RawTrainStep(one, caps,
                                      tr.per_dev_batch).geometry(raw)
                return float(one.run(geo, *one.parts(raw)))
            loss_one, ms_one = _rank_record(one_step)
        got = state_of(tr.model)
        got["final"] = gather_head(got["final"], tr.mesh)
        ref = state_of(full)
        worst, worst_name = 0.0, ""
        for n, _ in full.named_parameters():
            u, u_ref = got[n] - before[n], ref[n] - before[n]
            ulps = 2 * torch.finfo(torch.float32).eps * ref[n].abs()
            r = (((u - u_ref).abs() - ulps).clamp_min(0).max()
                 / u_ref.abs().max().clamp_min(1e-30)).item()
            if r > worst:
                worst, worst_name = r, n
        head = ((got["final"] - ref["final"]).abs().max()
                / (ref["final"] - before["final"]).abs().max()).item()
        out[name] = dict(loss_sharded=loss_sh, loss_one=loss_one,
                         ms_sharded=ms_sh, ms_one=ms_one, counts=counts,
                         update_err=worst, update_err_param=worst_name,
                         head_update_err=head,
                         same=_same_on_ranks(got.values()))
    out["voxels"] = int(raw.num)
    return out


def _dist_seg(seg_d3, dev):
    """One mink.yaml seg step at data=2, one scene a rank, against the
    one-process step on the same batch, caps and state."""
    import copy
    import torch.distributed as dist
    from openscene_tpu_torch.runtime.train_seg import SegTrainer
    cfg = seg_config(seg_d3).copy(batch_size=2, data_parallel=2, workers=1)
    tr = SegTrainer(cfg, device=dev)
    batch = next(tr._epoch_batches())
    step, model, opt = tr.step_fn, tr.model, tr.optimizer
    state0 = copy.deepcopy(model.state_dict())
    opt0 = copy.deepcopy(opt.state_dict())
    step.mesh = None
    one, ms_one = _rank_record(lambda: [
        t.cpu().numpy() for t in tr.train_step(batch)])
    model.load_state_dict(state0)
    opt.load_state_dict(opt0)
    step.it, step.mesh = 0, tr.mesh
    zero_counts()
    dp, ms_dp = _rank_record(lambda: [
        t.cpu().numpy() for t in tr.train_step(batch)])
    counts = read_counts()
    ones = [None, None]
    dist.all_gather_object(ones, one)
    return dict(loss_dp=float(dp[0]), hist_dp=[h.tolist() for h in dp[1:]],
                losses_one=[float(o[0]) for o in ones],
                hist_sum=[(ones[0][k] + ones[1][k]).tolist()
                          for k in (1, 2, 3)],
                ms_one=ms_one, ms_dp=ms_dp, voxels=int(batch[0].num),
                counts=counts, same=_same_on_ranks(state_of(model).values()))


def eval_scene_logits(ev):
    """Run ``ev``; returns (results, {scene: logits}, {scene: caps})."""
    logits, caps, built = {}, {}, []
    scene_outputs, build = ev._scene_outputs, ev.geometry.build

    def record_build(coords, num, c):
        built.append(tuple(c))
        return build(coords, num, c)

    def recording(rounds, step):
        for i, sample, out, n in scene_outputs(rounds, step):
            if sample is not None:
                logits[i] = out[0][:n].float().cpu().numpy()
                caps[i] = built[-1]
            yield i, sample, out, n

    ev.geometry.build, ev._scene_outputs = record_build, recording
    return ev.run(), logits, caps


def _dist_eval(d3, dfeat, dev):
    """ZeroShotEvaluator in distill mode over the val scenes, one a rank."""
    from openscene_tpu_torch.runtime.evaluate import (ZeroShotEvaluator,
                                                      load_model_for_eval)
    cfg = eval_config(d3, dfeat, "distill").copy(data_parallel=2,
                                                 test_workers=1)
    ev = ZeroShotEvaluator(cfg, load_model_for_eval(cfg, dev),
                           allow_pseudo_text=True, device=dev)
    zero_counts()
    (res, logits, caps), ms = _rank_record(lambda: eval_scene_logits(ev))
    return dict(results=res, logits=logits, caps=caps, ms=ms,
                counts=read_counts(), overflows=ev.geometry.overflows)


def _dist_rank(d3, dfeat, seg_d3):
    """One rank of the two on ``cuda:0`` (gloo): every part, in the same
    order on both; rank 0 returns both ranks' records."""
    import torch
    import torch.distributed as dist
    dev = DIST_DEVICE
    out = {}
    for name, fn in (("dp", lambda: _dist_dp(d3, dfeat, dev)),
                     ("head", lambda: _dist_head(d3, dfeat, dev)),
                     ("seg", lambda: _dist_seg(seg_d3, dev)),
                     ("eval", lambda: _dist_eval(d3, dfeat, dev))):
        out[name] = fn()
        torch.cuda.empty_cache()
    parts = [None, None]
    dist.all_gather_object(parts, out)
    return parts


def dist_phase(d3, dfeat, seg_d3, card):
    """The distributed phase: (a) NCCL at world size 1 in this process; (b)
    two ranks spawned on ``cuda:0`` over gloo (module docstring).  Returns
    rank 0's launch counts of its data-parallel step and a summary."""
    import numpy as np
    import torch
    from openscene_tpu_torch.parallel.launch import spawn
    from openscene_tpu_torch.runtime.evaluate import (ZeroShotEvaluator,
                                                      load_model_for_eval)
    t_phase = time.time()
    nccl_counts = dist_nccl_phase(d3, dfeat, card)
    # the one-process evaluator's per-scene logits, before the ranks
    cfg = eval_config(d3, dfeat, "distill").copy(test_workers=1)
    res_one, logits_one, caps_one = eval_scene_logits(ZeroShotEvaluator(
        cfg, load_model_for_eval(cfg, DIST_DEVICE), allow_pseudo_text=True,
        device=DIST_DEVICE))
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = spawn(_dist_rank, 2, d3, dfeat, seg_d3, backend="gloo",
                  device=DIST_DEVICE, timeout=DIST_TIMEOUT)
    t_ranks = time.time() - t0
    want = expected(TRAIN_LAUNCHES)
    summary = {"nccl_world1_launches": nccl_counts, "ranks_s": t_ranks}
    # distill data parallel
    dp = [r["dp"] for r in ranks]
    mean = sum(dp[0]["losses_one"]) / 2
    loss_err = abs(dp[0]["loss_dp"] - mean)
    loss_bound = 2 * float(np.finfo(np.float32).eps) * abs(mean)
    for r, d in enumerate(dp):
        print(f"dist (b) data parallel rank {r}: {d['voxels']} voxels "
              f"(caps {d['caps']}); one-process step {d['ms_one']:.1f} ms "
              f"({d['voxels'] / d['ms_one'] * 1e3:.1f} voxels/s), "
              f"data-parallel step {d['ms_dp']:.1f} ms "
              f"({d['voxels'] / d['ms_dp'] * 1e3:.1f} voxels/s); launches "
              f"{d['counts']} ({DIST_CAVEAT}) [{card}]", flush=True)
    print(f"dist (b) data parallel: reduced loss {dp[0]['loss_dp']!r}, mean "
          f"of the one-process losses {mean!r} (|diff| {loss_err:.3e}, bound "
          f"{loss_bound:.3e}); parameters against Adam on the mean "
          f"one-process gradient: max |diff| {dp[0]['param_err']:.3e} "
          f"(rank 1 {dp[1]['param_err']:.3e}), bound (2 fp32 eps of the "
          f"parameter) {dp[0]['param_bound']:.3e}; identical on both ranks "
          f"{dp[0]['same'] and dp[1]['same']}", flush=True)
    if not (all(d["counts"] == want for d in dp)
            and dp[0]["loss_dp"] == dp[1]["loss_dp"]
            and loss_err <= loss_bound
            and all(d["param_err"] <= d["param_bound"] for d in dp)
            and dp[0]["same"] and dp[1]["same"]):
        raise AssertionError("(b) data parallel: a check failed")
    # head sharding: bf16 through the kernels (loss and launches), fp32
    # through the plain versions (every update, as tests/test_parallel.py)
    hd = [r["head"] for r in ranks]
    for name in ("bf16", "fp32"):
        h = hd[0][name]
        rel = abs(h["loss_sharded"] - h["loss_one"]) / abs(h["loss_one"])
        h["loss_rel"] = rel
        print(f"dist (b) head sharding data=1 x model=2, {name} "
              f"{'kernels' if name == 'bf16' else 'plain versions'}, "
              f"{hd[0]['voxels']} voxels, SGD {DIST_SGD_LR}: loss "
              f"{h['loss_sharded']!r} vs one-process {h['loss_one']!r} (rel "
              f"{rel:.3e}, limit 1e-3); worst update error "
              f"{h['update_err']:.3e} of its scale ({h['update_err_param']}"
              f"{', limit 1e-3' if name == 'fp32' else ''}), gathered head "
              f"{h['head_update_err']:.3e}; sharded step "
              f"{h['ms_sharded']:.1f} ms, one-process {h['ms_one']:.1f} ms "
              f"({DIST_CAVEAT}); launches {h['counts']} [{card}]",
              flush=True)
    b16 = [d["bf16"] for d in hd]
    f32 = [d["fp32"] for d in hd]
    if not (hd[0]["bf16"]["loss_rel"] <= 1e-3
            and hd[0]["fp32"]["loss_rel"] <= 1e-3
            and all(d["counts"] == want and d["same"] for d in b16)
            and all(d["update_err"] <= 1e-3 and d["head_update_err"] <= 1e-3
                    and not any(d["counts"].values()) and d["same"]
                    for d in f32)
            and all(a["loss_sharded"] == b["loss_sharded"]
                    for a, b in (b16, f32))):
        raise AssertionError("(b) head sharding: a check failed")
    # seg
    sg = [r["seg"] for r in ranks]
    s = sg[0]
    smean = sum(s["losses_one"]) / 2
    for r, d in enumerate(sg):
        print(f"dist (b) seg rank {r}: {d['voxels']} voxels; one-process "
              f"step {d['ms_one']:.1f} ms, data-parallel step "
              f"{d['ms_dp']:.1f} ms ({DIST_CAVEAT}); launches {d['counts']} "
              f"[{card}]", flush=True)
    print(f"dist (b) seg data=2: loss {s['loss_dp']!r} vs mean "
          f"{smean!r}; histograms equal the sum of the one-process ones "
          f"{s['hist_dp'] == s['hist_sum']}", flush=True)
    if not (abs(s["loss_dp"] - smean) <= 2 * float(
            np.finfo(np.float32).eps) * abs(smean)
            and s["hist_dp"] == s["hist_sum"] == sg[1]["hist_dp"]
            and all(d["counts"] == want and d["same"] for d in sg)):
        raise AssertionError("(b) seg: a check failed")
    # eval
    ev = [r["eval"] for r in ranks]
    same_caps, bit_equal, worst = 0, 0, 0.0
    for d in ev:
        for i, lg in d["logits"].items():
            if d["caps"][i] == caps_one[i]:
                same_caps += 1
                bit_equal += int(np.array_equal(lg, logits_one[i]))
            worst = max(worst, float(np.abs(lg - logits_one[i]).max()))
    n_scenes = sum(len(d["logits"]) for d in ev)
    print(f"dist (b) eval distill, {n_scenes} scenes over 2 ranks: mIoU "
          f"{ev[0]['results']['miou']!r} vs one-process "
          f"{res_one['miou']!r}; {same_caps}/{n_scenes} scenes on the "
          f"one-process caps, of them {bit_equal} with bit-equal logits "
          f"(max |diff| over all {worst:.3e}); rank ms "
          f"{[round(d['ms'], 1) for d in ev]} ({DIST_CAVEAT}) [{card}]",
          flush=True)
    if not (ev[0]["results"] == ev[1]["results"] == res_one
            and n_scenes == len(logits_one) == same_caps == bit_equal
            and not any(d["overflows"] for d in ev)):
        raise AssertionError("(b) eval: a check failed")
    dt = time.time() - t_phase
    print(f"dist phase: {dt:.1f}s wall ((a), the one-process eval, and "
          f"{t_ranks:.1f}s of the two ranks) [{card}]", flush=True)
    summary.update(seconds=dt, dp=dp, head=hd, seg=sg,
                   eval=[{"ms": d["ms"], "miou": d["results"]["miou"]}
                         for d in ev])
    for d in dp:
        d.pop("losses_one")
    return dp[0]["counts"], summary


# ---- spatial sharding of one scene (parallel/spatial.py) ----

SPATIAL_A_WIDTHS = ((128, 96),)             # MinkUNet18A's widest L0 conv
SPATIAL_B_WIDTHS = ((32, 32), (128, 96), (96, 96))  # its L0 convs
SPATIAL_SHARDS = 2
SPATIAL_TIMEOUT = 300       # seconds for the two spawned ranks
# per spatial conv, forward and backward: one kernel-1 launch forward
# (spatial_conv_fwd), one kernel-1 (dx) and one kernel-2 (dW) backward
# (spatial_conv_bwd); no other kernel wrapper launches
SPATIAL_LAUNCHES = {"spatial_conv_fwd": 1, "spatial_conv_bwd": 1}


def spatial_counts(reset=False):
    """{name: launches} of the two spatial wrappers (set to 0 first with
    ``reset``)."""
    from openscene_tpu_torch.parallel import spatial as sp
    ws = {"spatial_conv_fwd": sp.spatial_conv_fwd,
          "spatial_conv_bwd": sp.spatial_conv_bwd}
    if reset:
        for w in ws.values():
            w.launches = 0
    return {k: w.launches for k, w in ws.items()}


def spatial_inputs(n, cin, cout, seed):
    """Scene-order activations (n, cin), cotangent (n, cout) and weights
    (27, cin, cout) from a numpy seed: the same arrays in every process."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, cin), dtype=np.float32)
    g = rng.standard_normal((n, cout), dtype=np.float32)
    w = rng.standard_normal((27, cin, cout), dtype=np.float32) * \
        np.float32((2.0 / (27 * cout)) ** 0.5)
    return x, g, w


def one_card_conv(x, g, w, level0, dev):
    """The one-card reference: ``StencilConv`` on scene 0's level-0 plan
    (host arrays ``level0`` = (fwd, flip_perm, num), its skip plan built
    here), forward and backward; returns (y, dx, dW, device ms of the
    forward kernel)."""
    import torch
    from openscene_tpu_torch.sparse.stencil_conv import (StencilConv,
                                                         build_conv_skip,
                                                         stencil_conv_fwd)
    from openscene_tpu_torch.sparse.types import ConvPlan
    fwd_np, flip_np, n = level0
    fwd = torch.as_tensor(fwd_np, device=dev)
    plan = ConvPlan(fwd=fwd, flip_perm=torch.as_tensor(flip_np, device=dev),
                    skip=build_conv_skip(fwd, n))
    cap = fwd.shape[1]
    x0 = torch.zeros((cap, x.shape[1]), dtype=torch.bfloat16, device=dev)
    x0[:n] = torch.as_tensor(x, device=dev)
    g0 = torch.zeros((cap, g.shape[1]), dtype=torch.bfloat16, device=dev)
    g0[:n] = torch.as_tensor(g, device=dev)
    x0.requires_grad_()
    wt = torch.as_tensor(w, device=dev).requires_grad_()
    y = StencilConv.apply(x0, wt, plan)
    y.backward(g0)
    ms = device_ms(lambda: stencil_conv_fwd(x0.detach(), wt.detach(), fwd,
                                            plan.skip))
    return y.detach(), x0.grad, wt.grad, ms


def spatial_case(f, shards, rank, x, g, w, ref, dev):
    """One rank's ``SpatialConv`` of the scene through ``f`` (forward and
    backward, the launches counted), held against the one-card ``ref`` on
    this shard's rows, then its kernels against their plain versions on the
    extended buffer and against a second launch.  Returns a record of small
    numbers (errors, tolerances, sizes, ms, counts, dW's digest)."""
    import hashlib
    import torch
    from openscene_tpu_torch.parallel import spatial as sp
    y_ref, dx_ref, dw_ref, one_ms = ref
    lo, hi = int(shards.starts[rank]), int(shards.starts[rank + 1])
    n_d, cap_d = hi - lo, shards.cap_d
    rows = torch.as_tensor(shards.perm[lo:hi].astype("int64"), device=dev)

    def shard(a):
        t = torch.zeros((cap_d, a.shape[1]), dtype=torch.bfloat16,
                        device=dev)
        t[:n_d] = torch.as_tensor(a, device=dev).index_select(0, rows).to(
            torch.bfloat16)
        return t

    xs, gs = shard(x), shard(g)
    xs.requires_grad_()
    wt = torch.as_tensor(w, device=dev).requires_grad_()
    torch.cuda.synchronize()
    zero_counts()
    spatial_counts(reset=True)
    t0 = time.time()
    y = f(xs, wt)
    y.backward(gs)
    torch.cuda.synchronize()
    main_ms = (time.time() - t0) * 1e3
    counts = {**read_counts(), **spatial_counts()}
    dx, dw = xs.grad, wt.grad
    scale_y = y_ref.float().abs().max().item()
    scale_dx = dx_ref.float().abs().max().item()
    scale_dw = dw_ref.abs().max().item()
    rec = {
        "rank": rank, "num": n_d, "cap_d": cap_d, "H": shards.halo_cap,
        "n_halo": f.plan.n_halo, "E": f.plan.export_cap,
        "n_export": f.plan.n_export, "counts": counts, "main_ms": main_ms,
        "one_card_ms": one_ms,
        "y_err": (y[:n_d].float() - y_ref.index_select(0, rows).float())
        .abs().max().item(), "y_tol": BF16_ULP * scale_y,
        "dx_err": (dx[:n_d].float() - dx_ref.index_select(0, rows).float())
        .abs().max().item(), "dx_tol": BF16_ULP * scale_dx,
        "dw_err": (dw - dw_ref).abs().max().item(), "dw_tol": DW_TOL * scale_dw,
        "pads_zero": not (y[n_d:].any() or dx[n_d:].any()),
        "dw_digest": hashlib.sha256(dw.cpu().numpy().tobytes()).hexdigest()}
    # the exchange and the kernels alone, on this rank's extended buffer
    plan, group = f.plan, f.group
    xd, wd = xs.detach(), wt.detach()

    def build_ext():
        halo = sp.gather_pool(xd.index_select(0, plan.export_idx), plan,
                              group).index_select(0, plan.halo_src)
        return torch.cat([xd, halo]).contiguous()

    ext = build_ext()
    reps = 5
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        build_ext()
    torch.cuda.synchronize()
    rec["exchange_ms"] = (time.time() - t0) * 1e3 / reps
    y_k = sp.spatial_conv_fwd(ext, wd, plan)
    y_p = sp.spatial_conv_plain(ext, wd, plan)
    d_k, w_k = sp.spatial_conv_bwd(ext, wd, gs, plan)
    d_p, w_p = sp.spatial_conv_bwd_plain(ext, wd, gs, plan)
    y_2 = sp.spatial_conv_fwd(ext, wd, plan)
    d_2, w_2 = sp.spatial_conv_bwd(ext, wd, gs, plan)
    torch.cuda.synchronize()
    rec.update(
        plain_y_err=(y_k.float() - y_p.float()).abs().max().item(),
        plain_y_tol=BF16_ULP * y_p.float().abs().max().item(),
        plain_dext_err=(d_k.float() - d_p.float()).abs().max().item(),
        plain_dext_tol=BF16_ULP * d_p.float().abs().max().item(),
        plain_dw_err=(w_k - w_p).abs().max().item(),
        plain_dw_tol=DW_TOL * w_p.abs().max().item(),
        deterministic=bool(torch.equal(y_k, y_2) and torch.equal(d_k, d_2)
                           and torch.equal(w_k, w_2)),
        conv_ms=device_ms(lambda: sp.spatial_conv_fwd(ext, wd, plan)),
        bwd_ms=device_ms(lambda: sp.spatial_conv_bwd(ext, wd, gs, plan)),
        plain_ms=device_ms(lambda: sp.spatial_conv_plain(ext, wd, plan),
                           iters=5))
    return rec


def spatial_ok(rec, world):
    """Whether one rank's record passes every check (launches as stated:
    one of each spatial wrapper, none of the seven model wrappers)."""
    want = {**expected({}), **SPATIAL_LAUNCHES}
    return (rec["counts"] == want and rec["pads_zero"]
            and rec["deterministic"]
            and rec["y_err"] <= rec["y_tol"]
            and rec["dx_err"] <= rec["dx_tol"]
            and rec["dw_err"] <= rec["dw_tol"]
            and rec["plain_y_err"] <= rec["plain_y_tol"]
            and rec["plain_dext_err"] <= rec["plain_dext_tol"]
            and rec["plain_dw_err"] <= rec["plain_dw_tol"]
            and (world > 1 or rec["n_halo"] == 0))


def spatial_print(what, cin, cout, rec, card):
    print(f"spatial {what} {cin}->{cout} rank {rec['rank']}: {rec['num']} "
          f"rows, cap_d {rec['cap_d']}, halo H {rec['H']} ({rec['n_halo']} "
          f"valid), exports E {rec['E']} ({rec['n_export']} valid); "
          f"exchange {rec['exchange_ms']:.3f} ms, conv {rec['conv_ms']:.4f} "
          f"ms (one-card conv {rec['one_card_ms']:.4f} ms), backward "
          f"{rec['bwd_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, forward "
          f"+ backward through autograd {rec['main_ms']:.1f} ms; y err "
          f"{rec['y_err']:.3e} (tol {rec['y_tol']:.3e}), dx "
          f"{rec['dx_err']:.3e} ({rec['dx_tol']:.3e}), dW "
          f"{rec['dw_err']:.3e} ({rec['dw_tol']:.3e}); kernels vs plain y "
          f"{rec['plain_y_err']:.3e}, d_ext {rec['plain_dext_err']:.3e}, dW "
          f"{rec['plain_dw_err']:.3e}; launches "
          f"{ {k: v for k, v in rec['counts'].items() if v} } [{card}]",
          flush=True)


def _spatial_rank(coords, level0, widths, device):
    """One of the two ranks on ``device`` (gloo): for each width, the
    one-card reference on this rank, then the rank's SpatialConv over
    D=2 shards; rank 0 returns both ranks' records."""
    import torch
    import torch.distributed as dist
    from openscene_tpu_torch.parallel.spatial import (build_spatial_shards,
                                                      make_spatial_conv)
    dev = torch.device(device)
    shards = build_spatial_shards(coords, SPATIAL_SHARDS)
    f = make_spatial_conv(None, shards, device=dev)
    out = []
    for i, (cin, cout) in enumerate(widths):
        x, g, w = spatial_inputs(len(coords), cin, cout, seed=100 + i)
        ref = one_card_conv(x, g, w, level0, dev)
        out.append(spatial_case(f, shards, dist.get_rank(), x, g, w, ref,
                                dev))
        torch.cuda.empty_cache()
    parts = [None, None]
    dist.all_gather_object(parts, out)
    return parts


def spatial_phase(geo0, card, device=DIST_DEVICE):
    """(spatial a): NCCL at world size 1 through torchrun's environment,
    SpatialConv at D=1 on scene 0 at 128->96 against StencilConv; (spatial
    b): two ranks on ``device`` (the one card) over gloo, D=2 over scene 0
    at the three L0 widths.  Returns (the launch counts of (a) and of rank
    0 in (b), summary)."""
    import torch
    import torch.distributed as dist
    from openscene_tpu_torch.parallel.launch import spawn
    from openscene_tpu_torch.parallel.mesh import (
        default_backend, maybe_initialize_distributed)
    from openscene_tpu_torch.parallel.spatial import (build_spatial_shards,
                                                      make_spatial_conv)
    t_phase = time.time()
    n = int(geo0.levels[0].num)
    coords = geo0.levels[0].coords[:n].cpu().numpy()
    level0 = (geo0.self3[0].fwd.cpu().numpy(),
              geo0.self3[0].flip_perm.cpu().numpy(), n)
    dev = torch.device(device)
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    recs_a = []
    try:
        if not maybe_initialize_distributed(None, dev):
            raise AssertionError("torchrun's environment made no group")
        backend = dist.get_backend()
        shards = build_spatial_shards(coords, 1)
        f = make_spatial_conv(None, shards, device=dev)
        for i, (cin, cout) in enumerate(SPATIAL_A_WIDTHS):
            x, g, w = spatial_inputs(n, cin, cout, seed=100 + i)
            ref = one_card_conv(x, g, w, level0, dev)
            recs_a.append(spatial_case(f, shards, 0, x, g, w, ref, dev))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    if backend != default_backend(dev):
        raise AssertionError(f"(spatial a): backend {backend}")
    for (cin, cout), rec in zip(SPATIAL_A_WIDTHS, recs_a):
        spatial_print("(a) NCCL world size 1, D=1, scene 0", cin, cout, rec,
                      card)
        if not spatial_ok(rec, 1):
            raise AssertionError(f"(spatial a) {cin}->{cout}: a check "
                                 f"failed: {rec}")
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = spawn(_spatial_rank, SPATIAL_SHARDS, coords, level0,
                  SPATIAL_B_WIDTHS, device, backend="gloo", device=device,
                  timeout=SPATIAL_TIMEOUT)
    t_ranks = time.time() - t0
    for i, (cin, cout) in enumerate(SPATIAL_B_WIDTHS):
        recs = [r[i] for r in ranks]
        for rec in recs:
            spatial_print(f"(b) gloo, D={SPATIAL_SHARDS} on one card, scene "
                          "0", cin, cout, rec, card)
        same = len({r["dw_digest"] for r in recs}) == 1
        print(f"spatial (b) {cin}->{cout}: dW bit-identical on both ranks "
              f"{same} ({DIST_CAVEAT})", flush=True)
        if not (same and all(spatial_ok(r, SPATIAL_SHARDS) for r in recs)
                and all(r["n_halo"] > 0 for r in recs)):
            raise AssertionError(f"(spatial b) {cin}->{cout}: a check "
                                 f"failed: {recs}")
    dt = time.time() - t_phase
    print(f"spatial phase: {dt:.1f}s wall ({t_ranks:.1f}s of the two ranks) "
          f"[{card}]", flush=True)

    def strip(r):
        return {k: v for k, v in r.items() if k != "dw_digest"}

    summary = {"seconds": dt, "ranks_s": t_ranks,
               "a": [strip(r) for r in recs_a],
               "b": [[strip(r[i]) for r in ranks]
                     for i in range(len(SPATIAL_B_WIDTHS))]}
    a_counts = {k: sum(r["counts"][k] for r in recs_a)
                for k in SPATIAL_LAUNCHES}
    b_counts = {k: sum(rec["counts"][k] for rec in ranks[0])
                for k in SPATIAL_LAUNCHES}
    return a_counts, b_counts, summary


# ---- the sparse ResNet classifiers (models/resnet.py) ----

RESNET_ARCHS_SMOKE = ("ResNet18", "ResNet50")
RESNET_CLASSES = 20
# per forward, for ResNet18 and ResNet50 alike: the k=5 stem and 16 k=3
# convs, and the 4 down convs; the backward the same counts
RESNET_LAUNCHES = {"stencil_conv_fwd": 17, "down_conv_fwd": 4}
RESNET_BWD_LAUNCHES = {"stencil_conv_bwd": 17, "down_conv_bwd": 4}


def resnet_phase(first, card, device):
    """ResNet18 and ResNet50 at their published widths, 3 colour channels
    -> 20 classes, random weights from a seed, on the first 2-scene train
    batch (``first`` = (level-0 coords, num, caps)) with its geometry built
    on the card, the stem as an index plan: an eval forward (logits finite,
    kernels against plain by the eval phase's rule), and a train-mode
    forward and backward with a fixed cotangent through the kernels, the
    plain versions and the plain versions in fp32 (gradients held as
    ``compare_train_step`` holds the UNet's), and the same in eval mode
    (BatchNorm on its running statistics: behind training-mode BatchNorm
    and the global pool the bf16 gradients of either path are mostly
    rounding, 0.4-1.3 of the fp32 ones' norm in a CPU rehearsal, so only
    the eval-mode gate holds the convs' backward tightly).  Launch counts
    checked;
    forward and backward ms.  Returns (the launches of both archs' eval
    forwards and train steps through the kernels, summary)."""
    import contextlib
    import copy
    import numpy as np
    import torch
    from openscene_tpu_torch.models import ResNet
    from openscene_tpu_torch.sparse.geometry_device import (
        build_geometry_parts, with_host_counts)
    t_phase = time.time()
    coords, num, caps = first
    geo, overflow = with_host_counts(*build_geometry_parts(
        torch.as_tensor(coords, device=device), num, caps,
        stem_occupancy=False, n_scenes=TRAIN_BATCH))
    if overflow or geo.stem.fwd is None or geo.stem.fwd.shape[0] != 125:
        raise AssertionError("ResNet geometry: overflow or no stem plan")
    rng = np.random.default_rng(7)
    cap0 = geo.levels[0].cap
    colours = np.zeros((cap0, 3), np.float32)
    colours[:num] = rng.uniform(-1, 1, (num, 3))
    cot = torch.as_tensor(rng.standard_normal((TRAIN_BATCH, RESNET_CLASSES),
                                              dtype=np.float32),
                          device=device)
    x32 = torch.as_tensor(colours, device=device)
    xb = x32.to(torch.bfloat16)
    want_eval = expected(RESNET_LAUNCHES)
    want_train = expected({**RESNET_LAUNCHES, **RESNET_BWD_LAUNCHES})
    summary, counts = {}, dict.fromkeys(wrappers(), 0)
    for arch in RESNET_ARCHS_SMOKE:
        model = ResNet(3, RESNET_CLASSES, arch,
                       generator=torch.Generator().manual_seed(0)).to(device)
        state0 = copy.deepcopy(model.state_dict())
        # eval: kernels against plain
        model.eval()
        with torch.no_grad():
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.time()
            logits_k = model(xb, geo, TRAIN_BATCH)
            torch.cuda.synchronize()
            fwd_ms = (time.time() - t0) * 1e3
            got_eval = read_counts()
            with plain_path():
                logits_p = model(xb, geo, TRAIN_BATCH)
        scale = logits_p.abs().max().item()
        lerr = (logits_k - logits_p).abs().max().item()
        top2 = logits_p.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) >= 1e-3
        agree = ((logits_k.argmax(1) == logits_p.argmax(1))[clear]
                 .float().mean().item() if clear.any() else 1.0)
        eval_ok = (torch.isfinite(logits_k).all().item()
                   and logits_k.shape == (TRAIN_BATCH, RESNET_CLASSES)
                   and lerr <= 4 * BF16_ULP * scale and agree >= 0.995
                   and got_eval == want_eval)

        # one forward and backward of <logits, cot> per path, in train mode
        # (BatchNorm on the batch's statistics) and in eval mode (on the
        # running ones, where no cancellation hides the convs' backward)
        def run(x, plain, train):
            model.load_state_dict(state0)
            model.train(train)
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.time()
            with (plain_path() if plain else contextlib.nullcontext()):
                out = model(x, geo, TRAIN_BATCH)
                torch.cuda.synchronize()
                t1 = time.time()
                (out * cot).sum().backward()
                torch.cuda.synchronize()
            t2 = time.time()
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
            return (out.detach(), grads, read_counts(), (t1 - t0) * 1e3,
                    (t2 - t1) * 1e3)

        def rel(a, b):
            each = {n: ((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-30)
                        ).item() for n in b}
            num_ = sum((a[n] - b[n]).norm().item() ** 2 for n in b) ** 0.5
            return each, num_ / sum(b[n].norm().item() ** 2
                                    for n in b) ** 0.5

        rec = {"eval_forward_ms": fwd_ms, "logits_err": lerr,
               "logits_scale": scale, "argmax_agreement": agree,
               "eval_launches": got_eval, "voxels": int(num)}
        grads_ok = True
        for mode, train in (("train", True), ("eval", False)):
            out_k, g_k, got_k, f_ms, b_ms = run(xb, False, train)
            out_p, g_p, got_p, _, _ = run(xb, True, train)
            _, g_32, _, _, _ = run(x32, True, train)
            k32, k32_all = rel(g_k, g_32)
            p32, p32_all = rel(g_p, g_32)
            worst = max(k32, key=lambda n: k32[n] / (3 * p32[n] + 0.05))
            terr = (out_k.float() - out_p.float()).abs().max().item()
            tscale = out_p.abs().max().item()
            grads_ok = grads_ok and (
                all(torch.isfinite(g).all().item() for g in g_k.values())
                and got_k == want_train and not any(got_p.values())
                and terr <= 4 * BF16_ULP * tscale
                and k32_all <= 1.25 * p32_all + 0.01
                and k32[worst] <= 3 * p32[worst] + 0.05)
            rec[mode] = {
                "forward_ms": f_ms, "backward_ms": b_ms, "logits_err": terr,
                "logits_scale": tscale, "grad_rel_l2_kernels_vs_fp32":
                k32_all, "grad_rel_l2_plain_vs_fp32": p32_all,
                "worst_param": worst, "worst_kernels_vs_fp32": k32[worst],
                "worst_plain_vs_fp32": p32[worst], "launches": got_k}
            if train:
                got_train = got_k
        summary[arch] = rec
        print(f"resnet {arch} 3->{RESNET_CLASSES} on the first "
              f"{TRAIN_BATCH}-scene train batch ({int(num)} voxels, caps "
              f"{list(caps)}; geometry on the card, stem as an index plan): "
              f"{json.dumps(rec)} [{card}]", flush=True)
        if not (eval_ok and grads_ok):
            raise AssertionError(f"resnet {arch}: a check failed")
        for k in counts:
            counts[k] += got_train[k] + got_eval[k]
        del model
        torch.cuda.empty_cache()
    dt = time.time() - t_phase
    summary["seconds"] = dt
    print(f"resnet phase: {dt:.1f}s wall [{card}]", flush=True)
    return counts, summary


# ---- the eval and trainer exports, and profiling ----

def exports_phase(trainer, batch, d3, dfeat, card, device):
    """One val scene through ``ZeroShotEvaluator`` in distill mode with
    ``vis_input``/``vis_pred``/``vis_gt`` on the card (three PLYs with the
    scene's point count and two ``.txt`` legends; the card's machine has
    no matplotlib, so no ``.jpg`` is asked for); ``_epoch_end_viz`` on the
    train phase's last batch (three PLYs); one distill train step inside
    ``utils/profiling.trace`` (the trace names the gather-GEMM kernels and
    the ``annotate`` region).  Returns a summary."""
    import torch
    from openscene_tpu_torch.data.scene_io import load_scene
    from openscene_tpu_torch.runtime.evaluate import (ZeroShotEvaluator,
                                                      load_model_for_eval)
    from openscene_tpu_torch.utils.ply import read_ply
    from openscene_tpu_torch.utils.profiling import annotate, trace
    t_phase = time.time()
    out = {}
    folder = os.path.join(HERE, "build", "smoke_vis")
    shutil.rmtree(folder, ignore_errors=True)
    cfg = eval_config(d3, dfeat, "distill").copy(
        vis_input=True, vis_pred=True, vis_gt=True, save_folder=folder,
        test_workers=1)
    ev = ZeroShotEvaluator(cfg, load_model_for_eval(cfg, device),
                           allow_pseudo_text=True, device=device)
    loader = ev._loader()
    loader.data_paths = loader.data_paths[:1]
    ev._loader = lambda: loader
    res = ev.run()
    n_points = len(load_scene(str(loader.data_paths[0]))[0])
    plys = ["0_input.ply", "0_distill.ply", "0_gt.ply"]
    sizes = {p: len(read_ply(os.path.join(folder, p))["vertex"])
             for p in plys}
    legends = [t for t in ("0_labels_distill.jpg.txt", "0_labels_gt.jpg.txt")
               if os.path.isfile(os.path.join(folder, t))]
    out["eval_vis"] = {"files": sorted(os.listdir(folder)),
                       "points": n_points, "ply_points": sizes,
                       "miou": res["miou"]}
    print(f"exports: eval vis (distill, 1 val scene, {n_points} points): "
          f"{sorted(os.listdir(folder))}, PLY points {sizes} [{card}]",
          flush=True)
    if not (all(v == n_points for v in sizes.values()) and len(legends) == 2):
        raise AssertionError("eval vis exports: a check failed")
    # the trainer's epoch-end dump, from the train phase's last batch
    last = os.path.join(trainer.cfg.save_path, "result", "last")
    shutil.rmtree(last, ignore_errors=True)
    trainer._epoch_end_viz(0, batch)
    got = sorted(os.listdir(last))
    want = ["gt_1.ply", "openseg_1.ply", "pred_1.ply"]
    pts = {p: len(read_ply(os.path.join(last, p))["vertex"]) for p in want
           if p in got}
    out["epoch_end_viz"] = {"files": got, "points": pts}
    print(f"exports: epoch-end viz of the last train batch: {got}, points "
          f"{pts} [{card}]", flush=True)
    if got != want or len(set(pts.values())) != 1 or not min(pts.values()):
        raise AssertionError("epoch-end viz: a check failed")
    # one train step inside trace
    tdir = os.path.join(HERE, "build", "smoke_trace")
    shutil.rmtree(tdir, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.time()
    with trace(tdir):
        with annotate("smoke distill train step"):
            trainer.train_step(batch)
    t_trace = time.time() - t0
    files = os.listdir(tdir)
    with open(os.path.join(tdir, files[0])) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    found = {k: any(k in nm for nm in names)
             for k in ("gather_gemm_fwd_kernel", "gather_wgrad_kernel",
                       "smoke distill train step")}
    out["trace"] = {"files": files, "found": found, "seconds": t_trace}
    print(f"exports: profiling.trace of one distill train step "
          f"({t_trace:.1f}s with the trace): {files}, names found {found} "
          f"[{card}]", flush=True)
    if len(files) != 1 or not all(found.values()):
        raise AssertionError("profiling trace: a check failed")
    dt = time.time() - t_phase
    out["seconds"] = dt
    print(f"exports and profiling phase: {dt:.1f}s wall [{card}]", flush=True)
    return out


DRILL_CONFIG = os.path.join("configs", "synthetic", "smoke.yaml")
DRILL_MODES = ("distill", "ensemble", "fusion")
DRILL_MIN_MARGIN = 0.05     # the drill's default --min-margin
DRILL_SEED = 11
DRILL_TIMEOUT = 300         # seconds for the drill's command line
DRILL_LAUNCHES = {"stencil_conv_fwd": STENCILS_PER_FORWARD,
                  "down_conv_fwd": DOWNS_PER_FORWARD,
                  "up_conv_fwd": UPS_PER_FORWARD}


def me_state_dict(arch, cout, seed):
    """A random reference checkpoint's state dict of ``arch`` (basic
    blocks): MinkowskiEngine's names, (K, Cin, Cout) kernels in its region
    order, 1x1 kernels (Cin, Cout), BatchNorm as ``bn.weight/bias/
    running_mean/running_var``, ``layers`` blocks a stage (the writer of
    ``tests/test_unet_golden_parity.py:_me_state_dict``, one block a stage,
    generalised, with its scales)."""
    import numpy as np
    from openscene_tpu_torch.models.sparse_unet import ARCHS
    a = ARCHS[arch]
    if a.block != "basic":
        raise ValueError(f"{arch}: only basic blocks are written")
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, K, cin, cout):
        sd[name + ".kernel"] = (rng.standard_normal((K, cin, cout))
                                * (2.0 / np.sqrt(K * cin))).astype(np.float32)

    def conv1(name, cin, cout):
        sd[name + ".kernel"] = (rng.standard_normal((cin, cout))
                                / np.sqrt(cin)).astype(np.float32)

    def bn(name, c):
        sd[name + ".bn.weight"] = (0.5 + rng.random(c)).astype(np.float32)
        sd[name + ".bn.bias"] = (0.2 * rng.standard_normal(c)).astype(
            np.float32)
        sd[name + ".bn.running_mean"] = (0.1 * rng.standard_normal(c)).astype(
            np.float32)
        sd[name + ".bn.running_var"] = (0.5 + rng.random(c)).astype(
            np.float32)

    def stage(b, cin, planes):
        for j in range(a.layers[b - 1]):
            prefix = f"block{b}.{j}"
            conv(prefix + ".conv1", 27, cin, planes)
            bn(prefix + ".norm1", planes)
            conv(prefix + ".conv2", 27, planes, planes)
            bn(prefix + ".norm2", planes)
            if cin != planes:
                conv1(prefix + ".downsample.0", cin, planes)
                bn(prefix + ".downsample.1", planes)
            cin = planes
        return planes

    conv("conv0p1s1", 125, 3, a.init_dim)
    bn("bn0", a.init_dim)
    inplanes = a.init_dim
    enc_out = [a.init_dim]
    for i in range(1, 5):
        conv(f"conv{i}p{2 ** (i - 1)}s2", 8, inplanes, inplanes)
        bn(f"bn{i}", inplanes)
        inplanes = stage(i, inplanes, a.planes[i - 1])
        enc_out.append(inplanes)
    for j, i in enumerate(range(4, 8)):
        conv(f"convtr{i}p{2 ** (8 - i)}s2", 8, inplanes, a.planes[i])
        bn(f"bntr{i}", a.planes[i])
        inplanes = stage(i + 1, a.planes[i] + enc_out[3 - j], a.planes[i])
    conv1("final", inplanes, cout)
    return sd


def drill_teachers(sd, points, device):
    """The converted checkpoint's own output under each region order at
    every point of the probe scene: voxelized and run as
    ``probe_region_order`` runs it (one point per voxel, constant bf16
    input, on the card), each point taking its voxel's row.  Rows scaled to
    unit length: the probe's cosine does not see the scale, and raw outputs
    could overflow fp16 blobs.  Returns ``{order: (points, DIM) fp32}``."""
    import numpy as np
    import torch
    from openscene_tpu_torch.data.batch import assemble_distill_batch
    from openscene_tpu_torch.data.loaders import SceneSample
    from openscene_tpu_torch.models.sparse_unet import MinkUNet
    from openscene_tpu_torch.sparse.geometry import geometry_to_device
    from openscene_tpu_torch.utils.convert_checkpoint import (REGION_ORDERS,
                                                              _port_state_dict)
    coords = np.floor(points / VOXEL).astype(np.int32)
    coords -= coords.min(0)
    keys = (coords[:, 0].astype(np.int64) * 2 ** 42
            + coords[:, 1].astype(np.int64) * 2 ** 21 + coords[:, 2])
    _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    n = len(first)
    sample = SceneSample(coords=coords[first],
                         feats=np.ones((n, 3), np.float32),
                         labels=np.zeros(n, np.int64), inds_reconstruct=None,
                         feat_3d=np.zeros((0, 1), np.float16),
                         feat_mask=np.zeros(n, bool))
    batch = assemble_distill_batch([sample], 1, rng=np.random.default_rng(0),
                                   shift=False)
    if not np.array_equal(batch.geo.levels[0].coords[:n, 1:], coords[first]):
        raise AssertionError("drill teacher: rows not in the probe's order")
    geo = geometry_to_device(batch.geo, device)
    x = torch.as_tensor(batch.feats, device=device).to(torch.bfloat16)
    out = {}
    for order in REGION_ORDERS:
        model = MinkUNet(3, DIM, ARCH)
        model.load_state_dict(_port_state_dict(sd, ARCH, order)[0])
        model.to(device).eval()
        with torch.no_grad():
            y = torch.nn.functional.normalize(
                model(x, geo, constant_input=True).float()[:n], dim=1)
        if not bool(y.isfinite().all()):
            raise AssertionError(f"drill teacher ({order}): not finite")
        out[order] = y.cpu().numpy()[inv]
    return out


def drill_overrides(root):
    """The drill's ``key value`` overrides of ``configs/synthetic/smoke.yaml``
    for a drill root, at bench density; the text embeddings from the root's
    ``text.npy``, as a real drill reads CLIP's from a file."""
    return ("data_root", os.path.join(root, "scannet_3d"),
            "data_root_2d_fused_feature",
            os.path.join(root, "scannet_multiview"), "voxel_size", str(VOXEL),
            "arch_3d", ARCH, "embedding_file", os.path.join(root, "text.npy"))


def drill_root(d3, dfeat, name, scene_id, feat, mask):
    """``build/drill/<name>``: symbolic links to the smoke tree's scenes and
    to every fused blob but the probe scene's, which is written anew from
    ``feat`` (the smoke tree itself stays as the other phases read it), and
    the 20 class prototypes as ``text.npy``.  The blob is written without
    compression: zlib takes seconds over 768-d rows of a scene."""
    import numpy as np
    from openscene_tpu_torch.data.synthetic import class_prototypes
    root = os.path.join(HERE, "build", "drill", name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "scannet_multiview"))
    np.save(os.path.join(root, "text.npy"), class_prototypes(CLASSES, DIM))
    os.symlink(d3, os.path.join(root, "scannet_3d"))
    for f in sorted(os.listdir(dfeat)):
        if not f.startswith(scene_id):
            os.symlink(os.path.join(dfeat, f),
                       os.path.join(root, "scannet_multiview", f))
    np.savez(os.path.join(root, "scannet_multiview", f"{scene_id}_0.npz"),
             feat=feat.astype(np.float16), mask_full=mask)
    return root


def drill_phase(d3, dfeat, n_voxels, card, device):
    """The reference-checkpoint drill (``scripts/eval_reference_checkpoint``)
    at MinkUNet18A 768-d on the smoke tree's val scenes at bench density.
    A random MinkowskiEngine-format checkpoint (``module.`` prefixes) is
    written; for each region order a drill root gets a probe-scene blob
    made of the converted model's own output under that order, and the
    probe (``probe_region_order`` on the card) must pick that order by at
    least the default margin.  The drill's command line then runs as a
    subprocess on the card over distill, ensemble and fusion: its order
    must be ``x_fastest`` and every mode's mIoU bit-equal to a direct
    ``ZeroShotEvaluator`` run here with the order pinned and the same
    ``model_path``.  ``main`` under a ``--min-margin`` above the margin
    must exit nonzero after the probe alone.  Launches are counted around
    the probes, the direct run and the gate: 32 / 4 / 4 of rows 1, 3 and
    5 per forward.  Returns ``(launches, summary)``."""
    import numpy as np
    import torch
    from openscene_tpu_torch.config import load_config
    from openscene_tpu_torch.data.scene_io import (list_scenes,
                                                   load_fused_features,
                                                   load_scene, scene_name)
    from openscene_tpu_torch.runtime.evaluate import (ZeroShotEvaluator,
                                                      load_model_for_eval)
    from openscene_tpu_torch.scripts import eval_reference_checkpoint as drill
    from openscene_tpu_torch.utils.convert_checkpoint import (
        load_torch_checkpoint, probe_region_order)
    t_phase = time.time()
    out = {}
    base = os.path.join(HERE, "build", "drill")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    ckpt = os.path.join(base, f"ref_{ARCH.lower()}.pth.tar")
    sd = me_state_dict(ARCH, DIM, DRILL_SEED)
    torch.save({"state_dict": {"module." + k: torch.from_numpy(v)
                               for k, v in sd.items()}, "epoch": 0}, ckpt)
    scene = list_scenes(d3, "val")[0]
    scene_id = scene_name(scene, d3)
    points = load_scene(scene)[0]
    mask = load_fused_features(os.path.join(dfeat, f"{scene_id}_0.npz")
                               )["mask_full"].astype(bool)
    roots = {o: drill_root(d3, dfeat, o, scene_id, feat[mask], mask)
             for o, feat in drill_teachers(sd, points, device).items()}
    launches = {}
    sd = load_torch_checkpoint(ckpt)  # what the drill reads

    # the probe on each root: it must find the order that made the teacher
    zero_counts()
    probe = {}
    for made, root in roots.items():
        cfg = load_config(DRILL_CONFIG, drill_overrides(root))
        coords, full, fmask = drill._probe_inputs(cfg)
        torch.cuda.synchronize()
        t0 = time.time()
        best, scores = probe_region_order(sd, ARCH, coords, full, fmask,
                                          voxel_size=VOXEL, device=device)
        ms = (time.time() - t0) * 1e3
        margin = max(scores.values()) - min(scores.values())
        probe[made] = {"picked": best, "scores": scores, "margin": margin,
                       "ms": ms}
        print(f"drill probe (teacher made under {made}): {len(points)} "
              f"points, scores {scores} -> {best}, margin {margin:.4f}, "
              f"{ms:.1f} ms wall (2 conversions, 2 forwards) [{card}]",
              flush=True)
        if best != made or margin < DRILL_MIN_MARGIN:
            raise AssertionError(f"drill probe: teacher {made} gave {best} "
                                 f"by {margin:.4f}")
    launches["probe"] = read_counts()
    want = expected({k: v * 2 * len(roots) for k, v in DRILL_LAUNCHES.items()})
    if launches["probe"] != want:
        raise AssertionError(f"drill probe: launches {launches['probe']}, "
                             f"want {want}")
    out["probe"] = probe

    # the direct evaluator run: the x_fastest root, the order pinned
    cfg = load_config(DRILL_CONFIG, drill_overrides(roots["x_fastest"])
                      ).copy(model_path=ckpt, region_order="x_fastest")
    zero_counts()
    model = load_model_for_eval(cfg.copy(feature_type="distill"), device)
    direct, rates = {}, {}
    for mode in DRILL_MODES:
        ev = ZeroShotEvaluator(cfg.copy(feature_type=mode),
                               None if mode == "fusion" else model,
                               device=device)
        torch.cuda.synchronize()
        t0 = time.time()
        direct[mode] = ev.run()["miou"]
        torch.cuda.synchronize()
        rates[mode] = n_voxels / (time.time() - t0)
        print(f"drill eval {mode} (direct, region_order x_fastest): "
              f"{N_SCENES} scenes, {n_voxels} voxels, {rates[mode]:.1f} "
              f"voxels/s, mIoU {direct[mode]!r} (random weights, the "
              f"class prototypes as text) [{card}]", flush=True)
    launches["eval"] = read_counts()
    forwards = N_SCENES * sum(m != "fusion" for m in DRILL_MODES)
    want = expected({k: v * forwards for k, v in DRILL_LAUNCHES.items()})
    if launches["eval"] != want:
        raise AssertionError(f"drill eval: launches {launches['eval']}, "
                             f"want {want}")
    if not all(np.isfinite(v) for v in direct.values()):
        raise AssertionError(f"drill eval: mIoU {direct}")
    del model, ev
    out["eval"] = {"miou": direct, "voxels_per_s": rates}

    # the drill's command line, on the card in a process of its own
    cmd = [sys.executable, "-m",
           "openscene_tpu_torch.scripts.eval_reference_checkpoint", ckpt,
           "--config", DRILL_CONFIG, "--modes", ",".join(DRILL_MODES),
           "--device", str(device), *drill_overrides(roots["x_fastest"])]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=DRILL_TIMEOUT)
    t_cli = time.time() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        if line.strip():
            print(f"drill cli: {line}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"drill cli exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    probe_line = next(ln for ln in lines if ln.startswith(
        "# region-order probe: "))
    table = json.loads(next(ln for ln in lines if ln.startswith(
        "# exact mIoU: "))[len("# exact mIoU: "):])
    print(f"drill cli: {t_cli:.1f}s wall, a process of its own (startup "
          f"and probe included); table bit-equal to the direct run: "
          f"{table == direct} [{card}]", flush=True)
    if "-> x_fastest " not in probe_line or table != direct:
        raise AssertionError(f"drill cli: {probe_line!r}, table {table} "
                             f"against the direct run's {direct}")
    out["cli"] = {"seconds": t_cli, "table": table}

    # the margin gate: above the achieved margin the drill refuses
    high = probe["x_fastest"]["margin"] + 0.01
    zero_counts()
    try:
        drill.main([ckpt, "--config", DRILL_CONFIG, "--modes", "distill",
                    "--min-margin", f"{high:.6f}", "--device", str(device),
                    *drill_overrides(roots["x_fastest"])])
        code = 0
    except SystemExit as e:
        code = e.code
    launches["gate"] = read_counts()
    print(f"drill gate (--min-margin {high:.4f}): exit {code!r}, launches "
          f"{ {k: launches['gate'][k] for k in DRILL_LAUNCHES} } [{card}]",
          flush=True)
    want = expected({k: v * 2 for k, v in DRILL_LAUNCHES.items()})
    if code in (0, None) or launches["gate"] != want:
        raise AssertionError("drill gate: did not stop after the probe")
    out["gate"] = {"exit": str(code)}
    out["forwards"] = {"probe": 2 * len(roots), "eval": forwards, "gate": 2}
    dt = time.time() - t_phase
    out["seconds"] = dt
    print(f"drill phase: {dt:.1f}s wall [{card}]", flush=True)
    return launches, out


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
    from openscene_tpu_torch.scripts.dev_bn_bench import bench_bn
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
    if not trainer.geometry.on:
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
    # the training BatchNorm's kernels (no TPU kernel): beside the plain
    # Function they replace on the card and the library's batch_norm
    bn_rows = bench_bn()
    for r in bn_rows:
        print(f"kernel masked_batch_norm {r['shape']} (bf16, ReLU, forward "
              f"and backward): {r['ms']:.4f} ms (forward {r['fwd_ms']:.4f}, "
              f"backward {r['bwd_ms']:.4f}), plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.5f} "
              f"(bytes, {r['roofline_pct']:.1f}%), share of the "
              f"tolerance to the plain ops used: "
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          r["tolerance_used"].items())
              + f"; bit-equal, launches 3 + 3 [{card}]", flush=True)
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
                  + (f", launch alone {c['launch_only_ms']:.4f}"
                     if "launch_only_ms" in c else "")
                  + (f", groups' build alone {c['groups_build_ms']:.4f}"
                     if "groups_build_ms" in c else "")
                  + (f", dx alone {c['dx_ms']:.4f}, dW alone "
                     f"{c['dw_ms']:.4f}" if "dx_ms" in c else "")
                  + (f", the replaced design {c['replaced_ms']:.4f}"
                     if "replaced_ms" in c else "")
                  + (f", dW err {c['dw_max_abs_err']:.3e} of tol "
                     f"{c['dw_tol']:.3e}" if "dw_tol" in c else "")
                  + f" [{card}]", flush=True)

    # ---- 3. the serving path: geometry on the card, then on the host ----
    model = ev.model
    launches = dict.fromkeys(wrappers(), 0)
    n_voxels = sum(len(s.coords) for s in samples)
    eval_rates = {}
    for route, dg in (("card", "auto"), ("host", "off")):
        for mode in MODES:
            mev = ZeroShotEvaluator(
                eval_config(d3, dfeat, mode).copy(device_geometry=dg), model,
                allow_pseudo_text=True, device=device)
            if mev.geometry.on != (route == "card"):
                raise AssertionError(f"{route} route: device_geometry "
                                     f"{dg!r} resolved to {mev.geometry.on}")
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.time()
            res = mev.run()
            torch.cuda.synchronize()
            dt = time.time() - t0
            got = read_counts()
            want = expected(dict(
                stencil_conv_fwd=STENCILS_PER_FORWARD * N_SCENES,
                down_conv_fwd=DOWNS_PER_FORWARD * N_SCENES,
                up_conv_fwd=UPS_PER_FORWARD * N_SCENES))
            if got != want:
                raise AssertionError(f"{route} {mode}: launches {got}, want "
                                     f"{want}")
            if not np.isfinite(res["miou"]):
                raise AssertionError(f"{route} {mode}: mIoU {res['miou']}")
            if mev.geometry.overflows:
                raise AssertionError(f"{route} {mode}: {mev.geometry.overflows}"
                                     " scenes overflowed on the card")
            for k in launches:
                launches[k] += got[k]
            eval_rates[f"{route} {mode}"] = n_voxels / dt
            print(f"eval {mode} ({route} geometry): {ARCH} {DIM}-d, "
                  f"{N_SCENES} scenes, {n_voxels} voxels in {dt:.3f}s -> "
                  f"{N_SCENES / dt:.4f} scenes/s, {n_voxels / dt:.1f} "
                  f"voxels/s, mIoU {res['miou']:.4f} (random weights, "
                  f"pseudo text), {mev.geometry.overflows} overflows "
                  f"[{card}]", flush=True)
    forwards = 2 * len(MODES) * N_SCENES
    eval_launches = dict(launches)
    route_rows, route_profile = eval_routes_phase(
        eval_config(d3, dfeat, "distill"), model, ev.text, samples, card)
    native_stats = native_phase(samples[0], card)
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
    first = (raw.coords, int(raw.num), tuple(caps))  # ResNet's batch
    del raw, host_geo
    t_raw_asm, t_host_asm = assembly_times(trainer, card)
    train_launches, train_summary = train_phase(
        trainer, batches, card, f"train {ARCH} {DIM}-d cosine Adam bf16")
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
            gemm = sum(v[1] for k, v in conv.items()
                       if k != "up_conv_fwd_kernel")
            print(f"profiler[{what}]: device busy {busy:.3f} ms in the "
                  f"profiled train step (unprofiled step "
                  f"{t_step * 1e3:.1f} ms, {int(praw.num)} voxels); conv "
                  f"kernels {json.dumps(conv)} (launches, ms; "
                  f"up_conv_fwd_kernel: the up conv's forward and the down "
                  f"conv's dx): the two "
                  f"gather-GEMM sources {gemm:.3f} ms against the "
                  f"dense design's {DENSE_DESIGN_TRAIN_CONV_MS[0]} + "
                  f"{DENSE_DESIGN_TRAIN_CONV_MS[1]} ms [{card}]", flush=True)
    compare_train_step(trainer, host_batch)
    exports_stats = exports_phase(trainer, pbatch, d3, dfeat, card, device)
    del trainer, batches, host_batch
    hostmem_stats = hostmem_phase(d3, dfeat, card)
    ptv3_launches, ptv3_summary, attn_rows = ptv3_phase(card, device)

    # ---- 5. supervised segmentation: train and eval, mink.yaml ----
    seg_launches, seg_stats = seg_phase(card, device)
    for k in launches:
        launches[k] += seg_launches[k]

    # ---- 6. multi-GPU: NCCL at world size 1, two ranks over gloo ----
    dist_launches, dist_stats = dist_phase(
        d3, dfeat, os.path.join(HERE, "build", "smoke_seg_data",
                                "scannet_3d"), card)
    for k in launches:  # rank 0's data-parallel step
        launches[k] += dist_launches[k]

    # ---- 7. multi-view fusion at the ScanNet spec, 768-d ----
    fusion_stats = fusion_phase(card, device)

    # ---- 8. spatial sharding of one scene; the ResNet classifiers ----
    spatial_a, spatial_b, spatial_stats = spatial_phase(geo0, card)
    for name, sp in (("stencil_conv_fwd", "spatial_conv_fwd"),
                     ("stencil_conv_bwd", "spatial_conv_bwd")):
        launches[name] += spatial_a[sp] + spatial_b[sp]  # rank 0's in (b)
    resnet_launches, resnet_stats = resnet_phase(first, card, device)
    for k in launches:
        launches[k] += resnet_launches[k]

    # ---- 9. the reference-checkpoint drill at full width ----
    drill_launches, drill_stats = drill_phase(d3, dfeat, n_voxels, card,
                                              device)
    for k in launches:
        launches[k] += sum(c[k] for c in drill_launches.values())

    # ---- 10. the per-op benchmark on the train batch ----
    t0 = time.time()
    bench = bench_ops(praw.coords, int(praw.num), n_scenes=TRAIN_BATCH,
                      iters=BENCH_ITERS)
    for row in bench:
        print(f"bench_ops: {json.dumps(row)} [{card}]", flush=True)
    print(f"bench_ops: {len(bench)} rows in {time.time() - t0:.1f}s",
          flush=True)
    for k, n in main_launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched on its main path")
        launches[k] += n

    # ---- 11. report ----
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
            "dist_rank_launches": dist_launches[name],
            "resnet_launches": resnet_launches[name],
            "drill_launches": {part: c[name]
                               for part, c in drill_launches.items()},
            "shapes": shapes}
        sp = {"stencil_conv_fwd": "spatial_conv_fwd",
              "stencil_conv_bwd": "spatial_conv_bwd"}.get(name)
        if sp:  # the spatial conv's wrapper launches this kernel
            entry["spatial_launches"] = {"wrapper": sp, "a": spatial_a[sp],
                                         "b_rank0": spatial_b[sp]}
        if name in ("stencil_conv_fwd", "down_conv_fwd", "up_conv_fwd"):
            entry["launches_per_forward"] = eval_launches[name] / forwards
        elif name in main_launches:
            entry["main_path"] = "scripts/dev_pack_bench.py:bench_pack"
        else:
            entry["also_launches"] = ALSO_LAUNCHES[name]
        kernels.append(entry)
    kernels.append({
        "name": "masked_batch_norm", "route": "cuda",
        "source": "openscene_tpu_torch/csrc/masked_bn.cu",
        "replaces": "no pallas_call (the JAX package leaves BatchNorm to "
                    "XLA)",
        "launches_per_train_step": (train_launches["masked_batch_norm"]
                                    / TRAIN_STEPS),
        "tolerance_used": max(max(r["tolerance_used"].values())
                              for r in bn_rows),
        "ms": bn_rows[0]["ms"], "plain_ms": bn_rows[0]["plain_ms"],
        "bound_ms": bn_rows[0]["bound_ms"],
        "bound_by": bn_rows[0]["bound_by"],
        "library_ms": bn_rows[0]["library_ms"],
        "main_path": "sparse/batch_norm.py:MaskedBatchNormKernelFn",
        "shapes": bn_rows})
    kernels.append({
        "name": "patch_attn", "route": "cuda",
        "source": "openscene_tpu_torch/csrc/patch_attn.cu",
        "replaces": "no pallas_call (the JAX package has no Point "
                    "Transformer)",
        "model": "PTv3m1",
        "launches_per_train_step": (ptv3_launches["patch_attn"]
                                    / TRAIN_STEPS),
        "rel_err": attn_rows[0]["rel_err"],
        "ms": attn_rows[0]["ms"], "plain_ms": attn_rows[0]["plain_ms"],
        "bound_ms": attn_rows[0]["bound_ms"],
        "bound_by": attn_rows[0]["bound_by"],
        "library_ms": attn_rows[0]["library_ms"],
        "main_path": "sparse/patch_attn.py:PatchAttention",
        "shapes": attn_rows})
    print(f"skip plans: {json.dumps(skip_stats)}", flush=True)
    print(f"geometry: {json.dumps(geo_stats)}; host assembly ms raw "
          f"{t_raw_asm:.1f}, host geometry {t_host_asm:.1f}", flush=True)
    print(f"eval: {json.dumps({'voxels_per_s': eval_rates, 'scenes': route_rows, 'card_distill_profile': route_profile, 'native': native_stats})}",
          flush=True)
    print(f"train: {json.dumps(train_summary)}; hostmem: "
          f"{json.dumps(hostmem_stats)}", flush=True)
    print(f"ptv3: {json.dumps(ptv3_summary)}", flush=True)
    print(f"seg: {json.dumps(seg_stats)}", flush=True)
    print(f"dist: {json.dumps(dist_stats)}", flush=True)
    print(f"fusion: {json.dumps(fusion_stats)}", flush=True)
    print(f"spatial: {json.dumps(spatial_stats)}", flush=True)
    print(f"resnet: {json.dumps(resnet_stats)}", flush=True)
    print(f"exports: {json.dumps(exports_stats)}", flush=True)
    print(f"drill: {json.dumps(drill_stats)}", flush=True)
    print(f"bn: {json.dumps(bn_rows)}", flush=True)
    print(f"attn: {json.dumps(attn_rows)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
