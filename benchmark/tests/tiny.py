"""Tiny versions of the cells' files for CPU runs: the same configuration,
rooms shrunk to a few thousand voxels, geometry built by the device path
on the CPU."""

import copy

from benchmark import run


def workload(cell: str) -> dict:
    wl = copy.deepcopy(run.load_json(run.BENCH, "workloads",
                                     cell + ".json"))
    for split in ("train", "val"):
        if split in wl:
            n = len(wl[split]["rooms"])
            wl[split]["density"] = 150
            wl[split]["rooms"] = [[[0.3 + 0.02 * i, 0.3], [5, 12]]
                                  for i in range(n)]
    wl["device_geometry"] = "on"
    return wl


def config(cell: str) -> dict:
    wl = run.load_json(run.BENCH, "workloads", cell + ".json")
    return run.load_json(run.BENCH, "configs", wl["config"] + ".json")


def run_cpu(cell: str, seed: int = 5, trace: bool = False, fault: str = "",
            seconds: float = 0.1) -> dict:
    run._environment()
    return run.run_cell(cell, seed, seconds, trace, device="cpu",
                        workload=workload(cell), config=config(cell),
                        fault=fault)
