"""Device memory of the trainers' geometry graphs on the card.

Two modes, one JSON line each on stdout:

* ``cell``: one untraced run of a benchmark cell (``benchmark/run.py``'s
  ``run_cell``), with the peaks read as its measured window ends, before
  the cell frees its state: ``torch.cuda.max_memory_reserved`` (what the
  card holds, a CUDA graph's pool included), ``max_memory_allocated``
  (the benchmark's ``memory_peak_bytes``, which misses the blocks a graph
  keeps between replays), the bytes of the graph pools' segments, and the
  trainer's cap schedules and graphs.
* ``epoch``: ``SegTrainer`` (the seg cell's config, ``workers`` loader
  threads) over ``epochs`` epochs of a room set ``copies`` times the seg
  cell's (new rooms of the same shapes, so new voxel counts; ``spread``
  scales each new room's floor plan by a factor drawn from 1 +- spread),
  ``loop`` passes an epoch, batches built by the trainer's own loader
  threads on running caps.  After each step it
  records the schedules and graphs the trainer holds and the reserved
  bytes; it prints the steps at which a new schedule appeared, the bytes
  then, and the peaks.

Runs on the parent of the graphs too (no pool: 0 graph bytes), so the
two can be compared on one card::

    python scripts/dev_graph_memory.py cell --cell seg_step.scannet_mink
    python scripts/dev_graph_memory.py epoch --copies 6 --loop 3 --epochs 4
    python scripts/dev_graph_memory.py epoch --copies 12 --loop 2 \
        --epochs 3 --spread 0.4 --workers 6
"""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pool_bytes(torch) -> int:
    """Bytes of the segments that belong to a CUDA graph's pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def holdings(torch, trainer) -> dict:
    steps = trainer.geometry.raw_steps.values()
    return {"schedules": len(steps),
            "graphs": sum(getattr(s, "_graph", None) is not None
                          for s in steps),
            "reserved": torch.cuda.memory_reserved(),
            "max_reserved": torch.cuda.max_memory_reserved(),
            "max_allocated": torch.cuda.max_memory_allocated()}


def cell(args) -> dict:
    import torch
    from benchmark import run
    wl = run.load_json(run.BENCH, "workloads", args.cell + ".json")
    entry = importlib.import_module("benchmark.entries." + wl["entry"])
    setup, seen = entry.setup, {}

    def recorded(ctx, fault=""):
        driver = setup(ctx, fault=fault)
        free = driver.free

        def at_window_end():
            torch.cuda.synchronize()
            seen.update(holdings(torch, driver.trainer),
                        graph_pool_bytes=pool_bytes(torch))
            free()
        driver.free = at_window_end
        return driver
    entry.setup = recorded
    res = run.run_cell(args.cell, args.seed, args.seconds, trace=False)
    return {"mode": "cell", "cell": args.cell, "seed": args.seed,
            "correct": res["correct"], "metrics": {
                k: v["value"] for k, v in res["metrics"].items()}, **seen}


def epoch(args) -> dict:
    import torch
    from benchmark import data, run
    from openscene_tpu_torch.config import Config
    from openscene_tpu_torch.runtime.train_seg import SegTrainer
    wl = copy.deepcopy(run.load_json(run.BENCH, "workloads",
                                     "seg_step.scannet_mink.json"))
    cfg = run.load_json(run.BENCH, "configs", wl["config"] + ".json")
    rng = np.random.default_rng(args.seed)
    wl["train"]["rooms"] = [
        [[sx * f, sy * f], boxes] for _ in range(args.copies)
        for (sx, sy), boxes in wl["train"]["rooms"]
        for f in [rng.uniform(1 - args.spread, 1 + args.spread)]]
    dev = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="graph_memory_")
    t0 = time.perf_counter()
    ds = data.write(root, wl, args.seed, dev)
    run_cfg = Config(
        data_root=ds.data_root, classes=cfg["classes"],
        arch_3d=cfg["arch_3d"], voxel_size=cfg["voxel_size"], aug=cfg["aug"],
        input_color=cfg["input_color"], use_shm=cfg["use_shm"],
        workers=args.workers or cfg["workers"], batch_size=cfg["batch_size"],
        base_lr=cfg["base_lr"], loop=args.loop, epochs=args.epochs,
        power=cfg["power"], momentum=cfg["momentum"],
        weight_decay=cfg["weight_decay"], ignore_label=cfg["ignore_label"],
        evaluate=False, compute_dtype=cfg["compute_dtype"],
        manual_seed=args.seed % (1 << 31), save_path="")
    trainer = SegTrainer(run_cfg, device=dev)
    setup_s = time.perf_counter() - t0
    new, steps, voxels, t0 = [], 0, [], time.perf_counter()
    for e in range(args.epochs):
        for batch in trainer._epoch_batches():
            loss, *_ = trainer.train_step(batch)
            float(loss)
            steps += 1
            voxels.append(int(batch[0].num))
            h = holdings(torch, trainer)
            if not new or h["schedules"] != new[-1]["schedules"]:
                new.append({"step": steps, "epoch": e, "caps": list(batch[1]),
                            **h, "graph_pool_bytes": pool_bytes(torch)})
    torch.cuda.synchronize()
    shutil.rmtree(root, ignore_errors=True)
    return {"mode": "epoch", "seed": args.seed, "rooms": len(
        wl["train"]["rooms"]), "spread": args.spread, "loop": args.loop,
        "epochs": args.epochs, "workers": run_cfg.workers,
        "steps": steps, "voxels_min_max": [min(voxels), max(voxels)],
        "setup_s": setup_s, "steps_s": time.perf_counter() - t0,
        "new_schedules": new, "end": {**holdings(torch, trainer),
                                      "graph_pool_bytes": pool_bytes(torch)},
        "overflows": trainer.overflows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("cell", "epoch"))
    ap.add_argument("--cell", default="seg_step.scannet_mink")
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--copies", type=int, default=6)
    ap.add_argument("--loop", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--spread", type=float, default=0.0)
    ap.add_argument("--workers", type=int, default=0)
    args = ap.parse_args()
    from benchmark import run
    run._environment()
    import torch
    out = (cell if args.mode == "cell" else epoch)(args)
    out["card"] = torch.cuda.get_device_name()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
