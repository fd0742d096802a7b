"""Run one benchmark cell once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's file ``benchmark/workloads/<cell>.json`` names its configuration
(``benchmark/configs/<config>.json``), the entry driver
(``benchmark/entries/<entry>.py``) and the traffic's parameters;
``benchmark/limits/<cell>.json`` holds the limit of each number that
``correct`` compares; the metrics the cell reports are those
``BENCHMARK.json`` gives it, each per-layer metric read by
``benchmark/metrics/<metric>.py``.  Nothing here is specific to one cell.

A run: make the inputs from the seed (under ``$TMPDIR``), set up and warm
up (``setup_s`` is from process start to the first timed unit), time
units of work back to back until ``--seconds`` have passed (the window
ends with the unit that crosses it; a rate is all the window's work over
all its time), read the memory peak, free the program's state, compare
what the timed path produced with the plain reference
(``benchmark/reference``), and print the result as the last line of
standard output, the compared numbers beside their limits last on standard
error.  ``--trace 1`` runs the window under ``torch.profiler`` with the
benchmark's spans and reports the per-layer metrics instead.

Exits non-zero, with no result, without enough CUDA devices, in a process
that has loaded JAX or the JAX package by the time the result is made (the
last step, after the reference and the metric readers), when a compared
number has no limit, or when a step raises.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from os.path import abspath, dirname, join  # noqa: E402

BENCH = dirname(abspath(__file__))
ROOT = dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "openscene_tpu")
# A traced window is at most this long: the profiler's trace of a longer
# train-step window takes minutes to export and read.
TRACE_SECONDS = 10.0


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX through
    ``transformers``."""
    cache = join(ROOT, "build", "bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", join(cache, "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", join(cache, "triton"))
    for k in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[k] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``openscene_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(join(*parts)) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def metric_reader(name: str):
    path = join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What an entry driver gets: the cell's files, the seed, the device,
    a scratch directory for its inputs and the spans."""

    def __init__(self, cell: str, workload: dict, config: dict, seed: int,
                 device, data_dir: str, spans):
        self.cell, self.workload, self.config = cell, workload, config
        self.seed, self.device, self.data_dir = seed, device, data_dir
        self.spans = spans


class Readings:
    """What a per-layer metric reader gets: spans, the window's units and
    host times, the device trace (None without one) and the card."""

    def __init__(self, spans, units, window, trace, card):
        self.spans, self.units, self.window = spans, units, window
        self.trace, self.card = trace, card

    def span_ms(self, name: str):
        """Mean ms of the spans of ``name`` that ended in the window."""
        s = self.spans.within(name, *self.window)
        return 1e3 * sum(b - a for a, b in s) / len(s) if s else None

    def total(self, key: str) -> float:
        return float(sum(u.get(key, 0) for u in self.units))


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: dict = None,
             workload: dict = None, config: dict = None,
             fault: str = "") -> dict:
    """One run of ``cell``; returns the result object.  ``workload`` and
    ``config`` default to the cell's files, ``bench`` to
    ``BENCHMARK.json``; ``fault`` plants one of the entry's faults (the
    tests' look at what ``correct`` catches).  Raises ``SystemExit`` if
    the process holds JAX or the JAX package once all else is done."""
    import torch
    from benchmark import devtrace
    from benchmark.spans import Spans

    bench = bench or load_json(ROOT, "BENCHMARK.json")
    workload = workload or load_json(BENCH, "workloads", cell + ".json")
    config = config or load_json(BENCH, "configs",
                                 workload["config"] + ".json")
    e2e, layer = cell_metrics(bench, cell)
    entry = importlib.import_module("benchmark.entries." + workload["entry"])
    dev = torch.device(device)
    spans = Spans(ranges=trace)
    data_dir = tempfile.mkdtemp(prefix="bench_", dir=tempfile.gettempdir())
    try:
        ctx = Context(cell, workload, config, seed, dev, data_dir, spans)
        driver = entry.setup(ctx, fault=fault)
        for line in driver.notes():
            print(line, file=sys.stderr, flush=True)
        if trace:
            driver.install_spans(spans)
        prof = devtrace.profiler() if trace else None
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if trace:
            seconds = min(seconds, TRACE_SECONDS)
        units = []
        t0 = time.perf_counter()
        setup_s = time.time() - T_START
        if prof is not None:
            prof.__enter__()
        try:
            with spans.span("window"):
                while True:
                    u = driver.unit()
                    u["t"] = time.perf_counter()
                    units.append(u)
                    if u["t"] - t0 >= seconds:
                        break
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            spans.restore()
        t1 = units[-1]["t"]
        card = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
        for line in driver.notes():
            print(line, file=sys.stderr, flush=True)
        driver.free()
        limits = load_json(BENCH, "limits", cell + ".json")
        checks = {k: {"value": v, "limit": limits[k]}
                  for k, v in driver.check().items()}
        result = {"correct": all(c["value"] <= c["limit"]
                                 for c in checks.values()),
                  "attempted": int(sum(u["items"] for u in units)),
                  "failed": 0, "metrics": {}, "device": card}
        if trace:
            t_read = time.perf_counter()
            dtrace = devtrace.DeviceTrace.from_profile(
                prof, join(data_dir, "trace.json"))
            print(f"trace read in {time.perf_counter() - t_read:.1f} s: "
                  f"{len(dtrace.device)} device events", file=sys.stderr)
            readings = Readings(spans, units, (t0, t1), dtrace, card)
            for m in layer:
                v = metric_reader(m["name"])(readings)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v,
                                                    "unit": m["unit"]}
            card["busy_s"] = dtrace.busy_us() / 1e6
            card["window_s"] = dtrace.window_us() / 1e6
            result["breakdown"] = dtrace.breakdown()
        else:
            for m in e2e:
                if m["name"] == "setup_s":
                    v = setup_s
                elif m["unit"] == "voxels/s":
                    v = sum(u["voxels"] for u in units) / (t1 - t0)
                else:
                    raise ValueError(f"no rule for the metric {m['name']}")
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        result["checks"] = checks
        found = forbidden_modules()
        if found:
            raise SystemExit(f"loaded in this process: {found}")
        return result
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    wl = load_json(BENCH, "workloads", args.workload + ".json")
    chips = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
