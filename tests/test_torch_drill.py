"""The port's reference-checkpoint drill, region-order decision,
synthetic-data command and launchers against the JAX package's scripts,
on the CPU.

The fixture is the JAX drill test's (``tests/test_eval_converted_checkpoint
.py:test_checkpoint_drill_one_command``): a synthetic MinkowskiEngine-format
MinkUNet14A ``.pth.tar`` (``module.`` prefixes) and a synthetic tree of one
train and one val scene (density 250, all classes), evaluated at 5 cm with
a 32-d head, from ``configs/synthetic/smoke.yaml`` with overrides.  The val
scene's fused blob is replaced by the converted model's own output under
``x_fastest`` (as ``tests/test_torch_viz.py:probe_case`` builds it), so the
probe has an order to find.

* (a) ``run_drill`` against the JAX ``run_drill`` over distill, ensemble
  and fusion: the same order with a margin of at least 0.05, each probe
  score within 1e-4 of the JAX one, each mode's mIoU within 1e-3.
* (b) ``main`` under a ``--min-margin`` above that margin exits nonzero
  (the probe's answer taken from (a)); ``--region-order`` skips the probe
  and gives (a)'s distill mIoU.
* (c) ``decide_region_order.main`` on the val scene's files: returns 0 and
  prints ``region_order=x_fastest`` with the JAX probe's scores within
  1e-4; returns 1 under a ``--min-margin`` above the margin.
* (d) ``make_synthetic_data.main`` at a tiny size writes the files of the
  JAX script (run as a subprocess on the CPU) with bit-equal arrays.
* (e) ``sh run/torch_eval.sh`` in fusion mode on the CPU (text from an
  ``embedding_file``) exits 0 with the evaluator's final mIoU in its teed,
  timestamped log; a run that fails makes it exit nonzero.
"""

import ast
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout
from glob import glob
from os.path import join
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import openscene_tpu.runtime.evaluate as JE
from openscene_tpu.config import load_config as jax_load_config
from openscene_tpu_torch.config import load_config
from openscene_tpu_torch.data.batch import assemble_distill_batch
from openscene_tpu_torch.data.loaders import SceneSample
from openscene_tpu_torch.data.scene_io import (load_fused_features,
                                               load_scene,
                                               save_fused_features)
from openscene_tpu_torch.data.synthetic import (build_synthetic_dataset,
                                                class_prototypes)
from openscene_tpu_torch.models import MinkUNet, disnet
from openscene_tpu_torch.runtime import evaluate as E
from openscene_tpu_torch.scripts import decide_region_order as decide
from openscene_tpu_torch.scripts import eval_reference_checkpoint as drill
from openscene_tpu_torch.scripts import make_synthetic_data
from openscene_tpu_torch.sparse.geometry import geometry_to_device
from openscene_tpu_torch.utils import convert_checkpoint as cc
from tests.test_torch_unet import _one_thread  # noqa: F401
from tests.test_unet_golden_parity import _me_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = join(REPO, "configs", "synthetic", "smoke.yaml")
ARCH = "MinkUNet14A"
DIM = 32
VOXEL = 0.05
MODES = ("distill", "ensemble", "fusion")
MIN_MARGIN = 0.05


def _jax_script(name):
    """A module of the JAX package's ``scripts/``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _teacher(sd, points):
    """The converted model's output under ``x_fastest`` at every point: one
    row per voxel, voxelized and run (bf16 input, constant) as
    ``probe_region_order`` does, each point taking its voxel's row."""
    coords = np.floor(points / VOXEL).astype(np.int32)
    coords -= coords.min(0)
    keys = (coords[:, 0].astype(np.int64) * 2 ** 42
            + coords[:, 1].astype(np.int64) * 2 ** 21 + coords[:, 2])
    _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    n = len(first)
    sample = SceneSample(coords=coords[first],
                         feats=np.ones((n, 3), np.float32),
                         labels=np.zeros(n, np.int64), inds_reconstruct=None,
                         feat_3d=np.zeros((0, DIM), np.float16),
                         feat_mask=np.zeros(n, bool))
    batch = assemble_distill_batch([sample], DIM, shift=False)
    # the rows are the voxels in key order, the order of np.unique's
    np.testing.assert_array_equal(batch.geo.levels[0].coords[:n, 1:],
                                  coords[first])
    model = MinkUNet(3, DIM, ARCH)
    model.load_state_dict(cc._port_state_dict(sd, ARCH, "x_fastest")[0])
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(batch.feats).to(torch.bfloat16),
                           geometry_to_device(batch.geo, "cpu"),
                           constant_input=True).float().numpy()[:n]
    return out[inv]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drill")
    sd = _me_state_dict(np.random.default_rng(5), cout=DIM)
    ckpt = str(tmp / "model_best.pth.tar")
    torch.save({"state_dict": {"module." + k: torch.from_numpy(v)
                               for k, v in sd.items()}, "epoch": 77}, ckpt)
    d3, dfeat = build_synthetic_dataset(str(tmp), n_train=1, n_val=1,
                                        dim=DIM, density=250.0,
                                        all_classes=True,
                                        num_rand_file_per_scene=1)
    scene = join(d3, "val", "scene0001_00.npz")
    blob = join(dfeat, "scene0001_00_0.npz")
    points, _, _ = load_scene(scene)
    mask = load_fused_features(blob)["mask_full"]
    save_fused_features(blob, _teacher(sd, points)[mask], mask)
    overrides = ("data_root", d3, "data_root_2d_fused_feature", dfeat,
                 "voxel_size", str(VOXEL), "arch_3d", ARCH, "split", "val",
                 "test_repeats", "1", "manual_seed", "0")
    return SimpleNamespace(sd=sd, ckpt=ckpt, scene=scene, blob=blob,
                           overrides=overrides,
                           text=class_prototypes(20, DIM))


def _probe_scores(stdout, prefix):
    line = next(ln for ln in stdout.splitlines() if ln.startswith(prefix))
    return ast.literal_eval(line[len(prefix):].split(" -> ")[0])


@pytest.fixture(scope="module")
def drills(case):
    """Both packages' ``run_drill`` on the case, with their probe scores."""
    jax_drill = _jax_script("eval_reference_checkpoint")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JE, "output_dim", lambda _: DIM)
        with redirect_stdout(out):
            jorder, jtable = jax_drill.run_drill(
                case.ckpt, jax_load_config(SMOKE, case.overrides),
                list(MODES), min_margin=MIN_MARGIN,
                text_features=case.text)
    jscores = _probe_scores(out.getvalue(), "# region-order probe: ")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(disnet, "output_dim", lambda _: DIM)
        with redirect_stdout(out):
            order, table = drill.run_drill(
                case.ckpt, load_config(SMOKE, case.overrides), list(MODES),
                min_margin=MIN_MARGIN, text_features=case.text,
                device="cpu")
    scores = _probe_scores(out.getvalue(), "# region-order probe: ")
    return SimpleNamespace(order=order, table=table, scores=scores,
                           jorder=jorder, jtable=jtable, jscores=jscores)


def _margin(scores):
    ranked = sorted(scores.values(), reverse=True)
    return ranked[0] - ranked[1]


def test_drill_matches_jax(drills):
    assert drills.order == drills.jorder == "x_fastest"
    assert set(drills.scores) == set(drills.jscores) == set(cc.REGION_ORDERS)
    for order, v in drills.scores.items():
        assert abs(v - drills.jscores[order]) <= 1e-4, (order, v,
                                                       drills.jscores)
    assert _margin(drills.scores) >= MIN_MARGIN
    assert _margin(drills.jscores) >= MIN_MARGIN
    assert list(drills.table) == list(drills.jtable) == list(MODES)
    for mode in MODES:
        got, want = drills.table[mode]["miou"], drills.jtable[mode]["miou"]
        assert np.isfinite(got) and abs(got - want) <= 1e-3, (mode, got,
                                                              want)


def test_drill_main_margin_gate_and_pinned_order(case, drills, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(disnet, "output_dim", lambda _: DIM)
    monkeypatch.setattr(E, "output_dim", lambda _: DIM)
    monkeypatch.setattr(E, "extract_text_features",
                        lambda *a, **kw: case.text)
    argv = [case.ckpt, "--config", SMOKE, *case.overrides, "--device", "cpu",
            "--modes", "distill"]
    # the probe's answer on these inputs is (a)'s: only the gate runs here
    monkeypatch.setattr(drill, "probe_region_order",
                        lambda *a, **kw: (drills.order, drills.scores))
    high = f"{_margin(drills.scores) + 0.01:.6f}"
    with pytest.raises(SystemExit) as e:
        drill.main(argv + ["--min-margin", high])
    assert e.value.code not in (0, None) and "refusing" in str(e.value.code)
    assert "# parity table" not in capsys.readouterr().out

    def no_probe(*a, **kw):
        raise AssertionError("the probe ran with the order pinned")
    monkeypatch.setattr(drill, "probe_region_order", no_probe)
    order, table = drill.main(argv + ["--region-order", "x_fastest"])
    out = capsys.readouterr().out
    assert order == "x_fastest" and "region-order probe" not in out
    assert "region_order=x_fastest)" in out
    assert re.search(r"^distill +\d\.\d{4}$", out, re.M)
    exact = json.loads(out.split("# exact mIoU: ")[1].splitlines()[0])
    assert (exact["distill"] == table["distill"]["miou"]
            == drills.table["distill"]["miou"])


def test_decide_region_order_matches_jax(case, drills, monkeypatch,
                                         capsys):
    argv = [case.ckpt, case.scene, case.blob, "--arch", ARCH,
            "--voxel-size", str(VOXEL), "--device", "cpu"]
    assert decide.main(argv) == 0
    out = capsys.readouterr().out
    assert "decision: region_order=x_fastest" in out
    assert "--region_order x_fastest" in out
    # the JAX drill's probe ran on the same scene, blob and voxel size
    scores = _probe_scores(out, "scores: ")
    for order, v in scores.items():
        assert abs(v - drills.jscores[order]) <= 1e-4, (order, v,
                                                       drills.jscores)
    monkeypatch.setattr(decide, "probe_region_order",
                        lambda *a, **kw: ("x_fastest", scores))
    assert decide.main(argv + ["--min-margin",
                               f"{_margin(scores) + 0.01:.6f}"]) == 1
    assert "AMBIGUOUS" in capsys.readouterr().err


def _tree(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob(join(root, "**", "*.npz"), recursive=True))


def test_make_synthetic_data_matches_jax(tmp_path):
    args = ["--n_train", "1", "--n_val", "1", "--dim", "16",
            "--density", "250"]
    make_synthetic_data.main(["--root", str(tmp_path / "port"), *args])
    proc = subprocess.run(
        [sys.executable, join(REPO, "scripts", "make_synthetic_data.py"),
         "--root", str(tmp_path / "jax"), *args],
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = _tree(tmp_path / "jax")
    assert names == _tree(tmp_path / "port") and len(names) == 5
    for name in names:
        with np.load(tmp_path / "jax" / name) as want, \
                np.load(tmp_path / "port" / name) as got:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype, (name, k)
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{name}:{k}")


def test_torch_eval_launcher(tmp_path):
    d3, dfeat = build_synthetic_dataset(str(tmp_path / "data"), n_train=0,
                                        n_val=1, dim=768, density=60.0,
                                        num_rand_file_per_scene=1)
    # text from a file: the pseudo-text fallback first tries a local CLIP
    # through transformers, whose import alone takes 15-20 s here
    text = str(tmp_path / "text.npy")
    np.save(text, class_prototypes(20, 768))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PATH": os.path.dirname(sys.executable) + os.pathsep
           + os.environ.get("PATH", "")}
    exp = tmp_path / "exp"
    proc = subprocess.run(
        ["sh", join("run", "torch_eval.sh"), str(exp), SMOKE, "fusion",
         "data_root", d3, "data_root_2d_fused_feature", dfeat,
         "embedding_file", text, "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:]
    logs = glob(str(exp / "eval-*.log"))
    assert len(logs) == 1
    assert re.fullmatch(r"eval-\d{8}_\d{6}\.log", os.path.basename(logs[0]))
    with open(logs[0]) as f:
        text = f.read()
    line = re.search(r"final mIoU: \d\.\d{4}", text)
    assert line and line.group(0) in proc.stdout  # teed
    # a run that fails: a stand-in ``python`` on the PATH exits 3
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "python").write_text("#!/bin/sh\necho stand-in run \"$@\"\n"
                                 "exit 3\n")
    (fake / "python").chmod(0o755)
    proc = subprocess.run(
        ["sh", join("run", "torch_eval.sh"), str(tmp_path / "bad"), SMOKE,
         "fusion", "--device", "cpu"], cwd=REPO,
        env={**env, "PATH": f"{fake}{os.pathsep}{env['PATH']}"},
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 3, proc.stdout
    with open(glob(str(tmp_path / "bad" / "eval-*.log"))[0]) as f:
        assert "stand-in run -u -m openscene_tpu_torch.runtime.evaluate" \
            in f.read()
