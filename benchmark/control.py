"""The readings that the limits of ``correct`` are set from.

    python benchmark/control.py --workload <cell> --seeds <a,b,...> \\
        [--faults <n>] [--fault <name>]

For each seed: the cell's set-up as a run makes it and one timed unit
(the program's first train steps are made in set-up; an evaluator's
checked passes in the unit), then the numbers that a run compares, of the
program against the reference, and for the first ``--faults`` seeds also
of the control (the reference in fp8, the precision below the
configuration's bf16) and of the faults the entry plants in the
reference, against the same reference.  ``--fault`` plants one of the
entry's faults in the program, whose readings are then keyed by the
fault's name.  One JSON line a seed.  The benchmark's own runs never run
this; it needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run  # noqa: E402


def readings(cell: str, seed: int, faults: bool, device: str = "cuda",
             workload: dict = None, config: dict = None,
             fault: str = "") -> dict:
    import importlib
    import shutil
    import tempfile

    from benchmark.spans import Spans
    workload = workload or run.load_json(run.BENCH, "workloads",
                                         cell + ".json")
    config = config or run.load_json(run.BENCH, "configs",
                                     workload["config"] + ".json")
    entry = importlib.import_module("benchmark.entries." + workload["entry"])
    data_dir = tempfile.mkdtemp(prefix="bench_", dir=tempfile.gettempdir())
    try:
        import torch
        ctx = run.Context(cell, workload, config, seed, torch.device(device),
                          data_dir, Spans())
        driver = entry.setup(ctx, fault=fault)
        driver.unit()
        driver.free()
        out = driver.control(faults)
        if fault:
            out[fault] = out.pop("program")
        return out
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    run._environment()
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.time()
        out = readings(args.workload, seed, i < args.faults,
                       fault=args.fault)
        flat = {f"{who}.{k}": v for who, d in out.items()
                for k, v in d.items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": round(time.time() - t, 1), **flat}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
