"""Whole runs of the harness on the CPU at a tiny size: the refusal without
a card, no JAX in the process, the per-layer readers' silence without a
device, and ``correct`` coming out false under each fault a cell can have
and under the control."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import control, run
from benchmark.tests import tiny

SEG, EVAL = "seg_step.scannet_mink", "zeroshot_eval.scannet_openseg"
DEVICE_METRICS = ("train_mfu", "conv_roofline.train_step",
                  "device_idle.train_step", "h2d_ms.eval",
                  "device_idle.eval")


def test_cpu_run_refuses():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        SEG, "--seed", "3", "--seconds", "1", "--trace",
                        "0"], cwd=run.ROOT, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "openscene_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert not {"openscene_tpu", "jax"} & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "openscene_tpu.sparse", sys)
    assert "openscene_tpu" in run.forbidden_modules()


@pytest.mark.parametrize("stub", [False, True])
def test_run_loads_no_jax(stub):
    """A whole tiny run in a fresh process leaves no module whose top-level
    name is jax, jaxlib, flax or openscene_tpu; where something after the
    window loads one (here a per-layer reader that loads a stub named
    ``jax``), the run exits non-zero and prints nothing."""
    code = ("import json, sys, types; sys.path.insert(0, %r)\n"
            "from benchmark.tests import tiny\n"
            "from benchmark import run\n"
            "def reader(readings):\n"
            "    sys.modules['jax'] = types.ModuleType('jax')\n"
            "if %r:\n"
            "    run.metric_reader = lambda name: reader\n"
            "tiny.run_cpu(%r, trace=%r)\n"
            "print(json.dumps(run.forbidden_modules()))"
            % (run.ROOT, stub, SEG, stub))
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=900)
    if stub:
        assert p.returncode != 0 and p.stdout.strip() == ""
        assert "['jax']" in p.stderr, p.stderr[-2000:]
        return
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("cell", [SEG, EVAL])
def test_traced_cpu_run_reports_no_device_metric(cell):
    res = tiny.run_cpu(cell, trace=True)
    assert not set(DEVICE_METRICS) & set(res["metrics"])
    assert res["metrics"], "the host spans' readers found nothing"
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [(SEG, "unchanged"),
                                        (SEG, "half_batch"),
                                        (SEG, "labels"),
                                        (EVAL, "logits")])
def test_fault_is_not_correct(cell, fault):
    assert tiny.run_cpu(cell, fault=fault)["correct"] is False


@pytest.mark.parametrize("cell", [SEG, EVAL])
def test_control_reads_above_the_program(cell):
    """At a tiny size the fp8 control reads above the bf16 program on every
    compared number (whether it crosses a limit set at the cell's size is
    the card test's to show)."""
    out = control.readings(cell, 8, True, device="cpu",
                           workload=tiny.workload(cell),
                           config=tiny.config(cell))
    for k, c in out["fp8"].items():
        assert c > out["program"][k], k


@pytest.mark.card
@pytest.mark.parametrize("cell", [SEG, EVAL])
def test_control_on_the_card(card, cell):
    """At the cell's own size: the program within every limit, the fp8
    control beyond one."""
    run._environment()
    limits = run.load_json(run.BENCH, "limits", cell + ".json")
    out = control.readings(cell, 4000000001, True)
    assert all(v <= limits[k] for k, v in out["program"].items())
    assert any(v > limits[k] for k, v in out["fp8"].items())
