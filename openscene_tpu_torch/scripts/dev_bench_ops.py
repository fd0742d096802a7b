"""Per-op times of the distillation train step's sparse ops on the card.

Counterpart of ``scripts/dev_bench_ops.py`` of the JAX package.  It builds
the full geometry of one batch on the card (``sparse/geometry_device.py``,
the grid prober and the search path, stem occupancy on) and times with CUDA
events, at MinkUNet18A's widths:

* the k=3 stencil convs per level at the JAX bench's ``level_shapes``:
  forward and forward+backward, through the kernels (with the level's skip
  plan) and through the plain versions;
* the k=2 s=2 down convs per edge (``down_ch``), kernels and plain;
* the up convs per edge (``up_ch``) three ways: the model's route
  (``UpConv``: dense parent GEMMs + one gather forward, kernel 4 backward),
  the kernel route (``KernelUpConv``: kernel 5 forward, kernel 4
  backward) and the plain versions of both kernels;
* the stem occupancy GEMM (125 x 3 x 32);
* the geometry build itself.

Coordinates come from ``--coords`` (an ``.npz`` with ``coords`` (N, 4) and
``num``, as the JAX package's ``scripts/dev_make_bench_coords.py`` writes)
or from ``--scenes N`` synthetic ScanNet-like scenes (2 cm, bench density)
written under ``build/`` and assembled as a train batch.

Run on the card: ``python -m openscene_tpu_torch.scripts.dev_bench_ops
[--coords FILE | --scenes 8] [--iters 10]``.  :func:`bench_ops` takes
``(coords, num)`` directly.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..sparse.edge_conv import (KernelUpConv, UpConv, down_conv_bwd,
                                down_conv_bwd_plain, down_conv_fwd,
                                down_conv_plain, up_conv_bwd_plain,
                                up_conv_plain)
from ..sparse.geometry import _bucket, _pad_level, level_counts
from ..sparse.geometry_device import build_geometry_parts, with_host_counts
from ..sparse.ops import matmul_f32
from ..sparse.stencil_conv import (stencil_conv_bwd, stencil_conv_bwd_plain,
                                   stencil_conv_fwd, stencil_conv_plain)
from .timing import card_line, time_ms

# the JAX bench's shapes (MinkUNet18A): (Cin, Cout) of the stencil convs per
# level, the down convs' channels per edge, the up convs' (Cin, Cout) per
# edge (decoder convtr(7-e) maps level e+1 to level e)
LEVEL_SHAPES = {0: [(96 + 32, 96), (96, 96)],
                1: [(96 + 64, 96), (96, 96), (32, 32)],
                2: [(128 + 128, 128), (128, 128), (64, 64)],
                3: [(128 + 256, 128), (128, 128)],
                4: [(256, 256)]}
DOWN_CH = [32, 32, 64, 128]
UP_CH = {3: (256, 128), 2: (128, 128), 1: (128, 96), 0: (96, 96)}
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def bench_ops(coords: np.ndarray, num: int, n_scenes: Optional[int] = None,
              iters: int = 10, device="cuda", seed: int = 0,
              levels=(0, 1, 2, 3, 4), edges=(0, 1, 2, 3)) -> List[Dict]:
    """Rows ``{"op", "shape", <route>_f_ms, <route>_fb_ms, ...}`` for one
    batch of lex-sorted level-0 ``coords`` (N, 4) (the first ``num`` rows
    are used).  ``n_scenes``: scenes in the batch, for the grid prober
    (None: the search path only).  Times are CUDA-event milliseconds on a
    CUDA ``device``; on the CPU they time the plain versions on the host."""
    dev = torch.device(device)
    coords = np.asarray(coords)[:int(num)]
    counts = level_counts(coords)
    caps = tuple(_bucket(c) for c in counts)
    c0 = torch.as_tensor(_pad_level(coords, caps[0]).coords, device=dev)
    rows: List[Dict] = []

    builds = [("search", None)] + ([("grid", n_scenes)] if n_scenes else [])
    geo = None
    for name, ns in builds:
        def build(ns=ns):
            return build_geometry_parts(c0, int(num), caps,
                                        stem_occupancy=True, n_scenes=ns)
        g, over = with_host_counts(*build())
        if over:
            raise AssertionError(f"geometry build ({name}) overflowed "
                                 f"(caps {caps})")
        geo = geo or g
        rows.append({"op": f"geometry build ({name}, stem occupancy)",
                     "shape": f"caps {caps} counts {counts}",
                     "ms": time_ms(build, dev, iters)})

    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16

    def acts(level, c):
        lv = geo.levels[level]
        x = torch.randn((lv.cap, c), generator=gen, device=dev)
        x[lv.num:] = 0
        return x.to(bf16)

    def weights(K, cin, cout):
        return torch.randn((K, cin, cout), generator=gen, device=dev) * \
            (2.0 / (K * cout)) ** 0.5

    def timed(**fns):
        return {f"{k}_ms": time_ms(f, dev, iters) for k, f in fns.items()}

    for lvl in levels:
        plan = geo.self3[lvl]
        for cin, cout in LEVEL_SHAPES[lvl]:
            x, g, w = acts(lvl, cin), acts(lvl, cout), weights(27, cin, cout)
            a = (x, w, plan.fwd)
            b = (x, w, g, plan.fwd, plan.flip_perm)
            rows.append({"op": f"L{lvl} stencil", "shape": f"{cin}x{cout}",
                         **timed(kernel_f=lambda: stencil_conv_fwd(
                                     *a, plan.skip),
                                 kernel_fb=lambda: (
                                     stencil_conv_fwd(*a, plan.skip),
                                     stencil_conv_bwd(*b, plan.skip)),
                                 plain_f=lambda: stencil_conv_plain(*a),
                                 plain_fb=lambda: (stencil_conv_plain(*a),
                                                   stencil_conv_bwd_plain(
                                                       *b)))})

    for e in edges:
        plan = geo.down[e]
        c = DOWN_CH[e]
        x, g, w = acts(e, c), acts(e + 1, c), weights(8, c, c)
        a, b = (x, w, plan.fwd), (x, w, g, plan)
        rows.append({"op": f"E{e} down", "shape": f"{c}x{c}",
                     **timed(kernel_f=lambda: down_conv_fwd(*a),
                             kernel_fb=lambda: (down_conv_fwd(*a),
                                                down_conv_bwd(*b)),
                             plain_f=lambda: down_conv_plain(*a),
                             plain_fb=lambda: (down_conv_plain(*a),
                                               down_conv_bwd_plain(*b)))})

        cin, cout = UP_CH[e]
        xu, gu, wu = acts(e + 1, cin), acts(e, cout), weights(8, cin, cout)
        xg = xu.detach().requires_grad_()
        args = (wu, *plan)

        def fb(fn):
            def run():
                fn.apply(xg, *args).backward(gu)
            return run

        b = (xu, wu, gu, plan)
        rows.append({"op": f"E{e} up", "shape": f"{cin}x{cout}",
                     **timed(model_f=lambda: UpConv.apply(xu, *args),
                             model_fb=fb(UpConv),
                             kernel_f=lambda: KernelUpConv.apply(xu, *args),
                             kernel_fb=fb(KernelUpConv),
                             plain_f=lambda: up_conv_plain(xu, wu, plan),
                             plain_fb=lambda: (up_conv_plain(xu, wu, plan),
                                               up_conv_bwd_plain(*b)))})

    w0 = weights(125, 3, 32)
    occ = geo.stem_occ
    rows.append({"op": "stem occupancy GEMM", "shape": "125x3x32",
                 **timed(f=lambda: matmul_f32(occ.t(),
                                              w0.sum(1).to(occ.dtype)))})
    for r in rows:
        r["device"] = str(dev)
    return rows


def synthetic_batch(n_scenes: int, root: str):
    """(coords, num) of ``n_scenes`` synthetic train scenes at 2 cm and the
    bench density, assembled as one raw train batch."""
    from ..data.batch import assemble_raw_distill_batch
    from ..data.loaders import FusedFeatureLoader
    from ..data.synthetic import build_synthetic_dataset
    d3, dfeat = build_synthetic_dataset(root, n_train=n_scenes, n_val=1,
                                        dim=8, density=2200.0)
    loader = FusedFeatureLoader(d3, dfeat, voxel_size=0.02, split="train",
                                aug=False, seed=0)
    samples = [loader.get(i) for i in range(n_scenes)]
    raw, _ = assemble_raw_distill_batch(samples, 8,
                                        rng=np.random.default_rng(0))
    return raw.coords, int(raw.num)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coords", default=None,
                    help=".npz with coords (N, 4) and num")
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dev_bench_ops needs a CUDA device")
    from ..device import resolve_device
    resolve_device("cuda")
    if args.coords:
        d = np.load(args.coords)
        coords, num = d["coords"], int(d["num"])
        n_scenes = int(coords[:num, 0].max()) + 1
    else:
        n_scenes = args.scenes
        coords, num = synthetic_batch(
            n_scenes, os.path.join(HERE, "build", "bench_ops_data"))
    name = card_line()
    print(f"# {num} voxels, {n_scenes} scenes [{name}]", flush=True)
    for r in bench_ops(coords, num, n_scenes=n_scenes, iters=args.iters):
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
