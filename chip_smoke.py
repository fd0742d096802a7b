#!/usr/bin/env python3
"""On-card smoke run of ``openscene_tpu_torch`` (one NVIDIA Hopper GPU).

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. prints the card's name and power limit (``nvidia-smi``) and builds every
   CUDA kernel of the port from ``openscene_tpu_torch/csrc`` with ``nvcc``
   into ``build/kernels``;
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (tolerance: one bf16 ulp of the output scale,
   ``2**-7 * max|plain|``; padded rows exactly zero) and times the kernel,
   the plain version and a library yardstick (one ``index_select`` + one
   ``torch.matmul``, the im2col formulation, which the port never calls);
3. drives the main path: zero-shot evaluation of MinkUNet18A at 768-d
   OpenSeg width through ``runtime.evaluate.ZeroShotEvaluator`` on ``cuda``,
   in ensemble and distill modes, on 2 synthetic ScanNet-like scenes at 2 cm
   (about 125k voxels each), random weights from a seed and pseudo text
   embeddings.  Every kernel's launch counter is set to 0 just before each
   run and read just after: each stencil-conv kernel must launch 32 times
   and the down-conv kernel 4 times per scene forward.  The outputs must be
   finite, and one scene's logits from the kernel path must match the same
   model run through the plain versions on the card;
4. prints the card line, one ``{"kernels": [...]}`` JSON line, and last
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, and the script exits non-zero without the last
line.  It also exits non-zero when CUDA is unavailable, or when the port's
package is not beside it.
"""

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


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_time_ms(fn, iters=20, warmup=3):
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
    return build_synthetic_dataset(root, n_train=0, n_val=N_SCENES, dim=DIM,
                                   density=DENSITY)


def eval_config(d3, dfeat, mode):
    from openscene_tpu_torch.config import Config
    return Config(data_root=d3, data_root_2d_fused_feature=dfeat,
                  feature_2d_extractor="openseg", voxel_size=VOXEL,
                  split="val", feature_type=mode, arch_3d=ARCH,
                  test_repeats=1, test_workers=2, manual_seed=0,
                  allow_pseudo_text=True, text_embedding_cache="")


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
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = BF16_ULP * ref.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name} {cin}->{cout}: max|kernel-plain| "
                             f"{err} > {tol}")
    if out[n_out:].any():
        raise AssertionError(f"{name}: padded output rows are not zero")
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
            "max_abs_err": err, "tol": tol,
            "ms": cuda_time_ms(lambda: wrapper(x, w, idx)),
            "plain_ms": cuda_time_ms(lambda: plain(x, w, idx), iters=5),
            "library_ms": cuda_time_ms(im2col, iters=5),
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
        stencil.append(kernel_case(
            "stencil_conv_fwd", stencil_conv_fwd, stencil_conv_plain,
            acts(level, cin), weights(27, cin, cout),
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(model, text, batch)
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
    print(f"scene 0 breakdown: host assembly (geometry plans) "
          f"{t_host * 1e3:.1f} ms, device step (plans to device, forward, "
          f"text product) {t_step * 1e3:.1f} ms", flush=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print("profiler: no device time recorded (not measured)", flush=True)
    for ms, n, key in rows[:10]:
        print(f"profiler: {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<4d} "
              f"{key[:90]}", flush=True)
    if rows:
        print(f"profiler: device busy {busy:.3f} ms in the profiled step "
              f"(unprofiled step {t_step * 1e3:.1f} ms)", flush=True)


def plain_path(model_module):
    """Context manager: the model calls the plain versions (for the
    on-card comparison of a whole forward only)."""
    import contextlib
    from openscene_tpu_torch.sparse.edge_conv import down_conv_plain
    from openscene_tpu_torch.sparse.stencil_conv import stencil_conv_plain

    @contextlib.contextmanager
    def ctx():
        saved = model_module.stencil_conv_fwd, model_module.down_conv_fwd
        model_module.stencil_conv_fwd = stencil_conv_plain
        model_module.down_conv_fwd = down_conv_plain
        try:
            yield
        finally:
            model_module.stencil_conv_fwd, model_module.down_conv_fwd = saved
    return ctx()


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
    from openscene_tpu_torch.models import sparse_unet
    from openscene_tpu_torch.runtime.evaluate import (ZeroShotEvaluator,
                                                      load_model_for_eval,
                                                      make_eval_step)
    from openscene_tpu_torch.sparse import _build
    from openscene_tpu_torch.sparse.edge_conv import down_conv_fwd
    from openscene_tpu_torch.sparse.geometry import geometry_to_device
    from openscene_tpu_torch.sparse.stencil_conv import stencil_conv_fwd

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

    # ---- data: 2 synthetic scenes at bench density, 768-d features ----
    t0 = time.time()
    d3, dfeat = make_dataset(os.path.join(HERE, "build", "smoke_data"))
    print(f"data: {N_SCENES} scenes written in {time.time() - t0:.1f}s",
          flush=True)

    # ---- 2. kernels against their plain versions ----
    cfg = eval_config(d3, dfeat, "ensemble")
    ev = ZeroShotEvaluator(cfg, load_model_for_eval(cfg, device),
                           allow_pseudo_text=True, device=device)
    loader = ev._loader()
    samples = [loader.get(i) for i in range(N_SCENES)]
    batch0 = assemble_eval_batch([samples[0]], DIM)
    geo0 = geometry_to_device(batch0.geo, device)
    caps = [l.cap for l in geo0.levels]
    nums = [l.num for l in geo0.levels]
    print(f"scene 0: level caps {caps}, valid rows {nums}", flush=True)
    cases = kernels_phase(geo0)

    # ---- 3. the main path ----
    model = ev.model
    launches = {"stencil_conv_fwd": 0, "down_conv_fwd": 0}
    n_voxels = sum(len(s.coords) for s in samples)
    for mode in MODES:
        mev = ZeroShotEvaluator(eval_config(d3, dfeat, mode), model,
                                allow_pseudo_text=True, device=device)
        torch.cuda.synchronize()
        stencil_conv_fwd.launches = 0
        down_conv_fwd.launches = 0
        t0 = time.time()
        res = mev.run()
        torch.cuda.synchronize()
        dt = time.time() - t0
        got = {"stencil_conv_fwd": stencil_conv_fwd.launches,
               "down_conv_fwd": down_conv_fwd.launches}
        want = {"stencil_conv_fwd": STENCILS_PER_FORWARD * N_SCENES,
                "down_conv_fwd": DOWNS_PER_FORWARD * N_SCENES}
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
    with plain_path(sparse_unet):
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

    # ---- 4. report ----
    replaces = {"stencil_conv_fwd": "openscene_tpu/sparse/pallas_conv.py:371",
                "down_conv_fwd": "openscene_tpu/sparse/pallas_edge.py:312"}
    kernels = []
    for name, shapes in cases.items():
        main_shape = shapes[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "openscene_tpu_torch/csrc/gather_gemm_fwd.cu",
            "replaces": replaces[name], "launches": launches[name],
            "launches_per_forward": launches[name] / forwards,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shapes": shapes})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
