"""The port's exports, checkpoint fetch, profiling and region-order probe
against the JAX package's, on the CPU and with no network.

* ``ZeroShotEvaluator`` in fusion mode with ``vis_input``/``vis_pred``/
  ``vis_gt``: the file set of ``tests/test_e2e_eval.py:test_eval_viz_exports``
  on the same synthetic scenes and text, every PLY and ``.txt`` legend
  byte-equal to the JAX evaluator's (the ``.jpg`` legends need matplotlib
  and are not compared).
* ``DistillTrainer._epoch_end_viz`` on one host batch against the JAX
  trainer's method on the same batch, weights and text (run on a stand-in
  ``self``): the fused-label and ground-truth clouds byte-equal, the
  predictions' colours equal at >= 99% of the points (both forwards in
  fp32; an argmax may flip at a near-tie); ``train_epoch`` writes the
  three clouds.
* ``is_url`` on the JAX function's cases; ``fetch_checkpoint`` on a cache
  hit, and an offline miss raising ``RuntimeError`` (``urlretrieve``
  patched to fail: nothing is downloaded); ``load_weights`` reading a
  cached URL.
* ``StepTimer.report()`` equal to the JAX one; ``trace`` writing a Chrome
  trace with an ``annotate`` region on the CPU.
* ``probe_region_order`` (MinkUNet14A, a small scene whose "fused
  features" are the model's own output under ``x_fastest``, so that order
  scores about 1): the scores within 1e-4 of the JAX function's, the same
  order chosen; ``convert_checkpoint.main`` (with the probe) writes a file
  that ``load_weights`` reads into the state_dict of
  ``convert_state_dict``.
"""

import json
import os
import urllib.error
import urllib.request
from os.path import join
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openscene_tpu.data.synthetic import build_synthetic_dataset
from openscene_tpu_torch.config import Config
from openscene_tpu_torch.convert import params_from_jax
from openscene_tpu_torch.models import MinkUNet
from openscene_tpu_torch.runtime import distill as D
from openscene_tpu_torch.runtime import evaluate as E
from openscene_tpu_torch.utils import convert_checkpoint as cc
from openscene_tpu_torch.utils.ply import read_ply
from tests.test_torch_distill import (ARCH, DIM, _trainer_cfg,  # noqa: F401
                                      head32, samples, synth)
from tests.test_torch_unet import _one_thread, numpy_unet_trees  # noqa: F401
from tests.test_unet_golden_parity import _me_state_dict

COUT = 20  # _me_state_dict's head


# ---- the evaluator's exports ----

@pytest.fixture(scope="module")
def eval_synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_viz")
    return build_synthetic_dataset(str(root), n_train=1, n_val=2, dim=96,
                                   density=800.0, all_classes=True)


def _eval_cfg(cls, d3, dfeat, folder):
    return cls(data_root=d3, data_root_2d_fused_feature=dfeat,
               feature_2d_extractor="openseg", voxel_size=0.05, split="val",
               feature_type="fusion", test_repeats=1,
               mark_no_feature_to_unknown=True, manual_seed=0,
               vis_input=True, vis_pred=True, vis_gt=True,
               save_folder=str(folder))


def test_eval_vis_exports_equal_jax(eval_synth, tmp_path):
    from openscene_tpu.config import Config as JaxConfig
    from openscene_tpu.data.synthetic import class_prototypes
    from openscene_tpu.runtime.evaluate import \
        ZeroShotEvaluator as JaxEvaluator
    d3, dfeat = eval_synth
    text = class_prototypes(20, 96)
    JaxEvaluator(_eval_cfg(JaxConfig, d3, dfeat, tmp_path / "jax"),
                 text_features=text).run()
    res = E.ZeroShotEvaluator(_eval_cfg(Config, d3, dfeat, tmp_path / "port"),
                              text_features=text, device="cpu").run()
    assert res["miou"] > 0.75
    files = set(os.listdir(tmp_path / "port"))
    for i in range(2):
        assert {f"{i}_input.ply", f"{i}_fusion.ply", f"{i}_gt.ply",
                f"{i}_labels_fusion.jpg.txt",
                f"{i}_labels_gt.jpg.txt"} <= files, files
    assert files == set(os.listdir(tmp_path / "jax"))
    for name in sorted(files):
        if name.endswith((".ply", ".txt")):
            with open(tmp_path / "port" / name, "rb") as a, \
                    open(tmp_path / "jax" / name, "rb") as b:
                assert a.read() == b.read(), name
    n_points = len(np.load(join(d3, "val", sorted(os.listdir(
        join(d3, "val")))[0]))["coords"])
    assert len(read_ply(str(tmp_path / "port" / "0_gt.ply"))["vertex"]) \
        == n_points


# ---- the trainer's epoch-end dump ----

def _colors(path):
    v = read_ply(str(path))["vertex"]
    return np.stack([v["red"], v["green"], v["blue"]], 1), \
        np.stack([v["x"], v["y"], v["z"]], 1)


def test_epoch_end_viz_matches_jax(synth, samples, tmp_path, head32):
    import openscene_tpu.runtime.distill as jd
    from openscene_tpu.config import Config as JaxConfig
    from openscene_tpu.data.batch import \
        assemble_distill_batch as jax_assemble
    from openscene_tpu.labels import labelset_and_palette
    from openscene_tpu_torch.data.batch import assemble_distill_batch
    params, state = numpy_unet_trees(ARCH, 3, DIM, seed=2)
    cfg = _trainer_cfg(synth, tmp_path / "port", epochs=1, evaluate=False,
                       compute_dtype="float32")
    tr = D.DistillTrainer(cfg, device="cpu")
    # the call site, without the updates: three clouds after the epoch
    tr.train_step = lambda batch: torch.zeros(())
    tr.train_epoch(0)
    last = tmp_path / "port" / "result" / "last"
    assert {"openseg_1.ply", "pred_1.ply", "gt_1.ply"} <= set(
        os.listdir(last))
    tr.model.load_state_dict(params_from_jax(params, state, ARCH))
    batch = assemble_distill_batch(samples[:1], DIM,
                                   rng=np.random.default_rng(5))
    tr._epoch_end_viz(4, batch)

    jcfg = JaxConfig(arch_3d=ARCH, compute_dtype="float32",
                     feature_2d_extractor="openseg",
                     save_path=str(tmp_path / "jax"))
    jbatch = jax_assemble(samples[:1], DIM, rng=np.random.default_rng(5),
                          windows=False)
    fake = SimpleNamespace(
        mesh=None, _viz_fwd=None, cfg=jcfg,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        state=jax.tree_util.tree_map(jnp.asarray, state),
        text=tr.text.numpy(), palette=labelset_and_palette("scannet")[1])
    jd.DistillTrainer._epoch_end_viz(fake, 4, jbatch)
    jlast = tmp_path / "jax" / "result" / "last"
    for name in ("openseg_5.ply", "gt_5.ply"):
        assert (last / name).read_bytes() == (jlast / name).read_bytes()
    got, pts = _colors(last / "pred_5.ply")
    ref, jpts = _colors(jlast / "pred_5.ply")
    assert np.array_equal(pts, jpts) and len(pts) > 100
    assert (got == ref).all(1).mean() >= 0.99


# ---- checkpoint fetch ----

URL = "https://example.invalid/models/model.pth"


def _no_network(monkeypatch, exc):
    def retrieve(url, filename=None, *a, **kw):
        raise exc
    monkeypatch.setattr(urllib.request, "urlretrieve", retrieve)


def test_is_url_matches_jax():
    from openscene_tpu.runtime.evaluate import is_url as jax_is_url
    for p in ("http://a/b.pth", "https://a/b.pth.tar", "HTTPS://A/B",
              "ftp://a/b", "s3://bucket/x", "/local/model.pth", "model.pth",
              "", "file:///tmp/x", "http:/no-slashes"):
        assert E.is_url(p) == jax_is_url(p), p


def test_fetch_checkpoint_cache_hit_and_offline_miss(tmp_path, monkeypatch):
    _no_network(monkeypatch, AssertionError("no download on a cache hit"))
    cached = tmp_path / "model.pth"
    cached.write_bytes(b"weights")
    assert E.fetch_checkpoint(URL, str(tmp_path)) == str(cached)
    _no_network(monkeypatch, urllib.error.URLError("no network"))
    with pytest.raises(RuntimeError, match="could not download"):
        E.fetch_checkpoint(URL.replace("model.pth", "other.pth"),
                           str(tmp_path))
    assert not (tmp_path / "other.pth").exists()


def test_load_weights_reads_a_cached_url(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    _no_network(monkeypatch, AssertionError("no download on a cache hit"))
    cache = tmp_path / ".cache" / "openscene_tpu_torch" / "checkpoints"
    cache.mkdir(parents=True)
    src = MinkUNet(3, COUT, ARCH, generator=torch.Generator().manual_seed(3))
    torch.save(src.state_dict(), cache / "model.pth")
    model = MinkUNet(3, COUT, ARCH)
    E.load_weights(model, Config(model_path=URL, arch_3d=ARCH))
    for name, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[name], v), name


# ---- profiling ----

def test_step_timer_report_matches_jax():
    from openscene_tpu.utils.profiling import StepTimer as JaxTimer
    from openscene_tpu_torch.utils.profiling import StepTimer
    timers = StepTimer(), JaxTimer()
    for t in timers:
        for name, total, n in (("data", 1.25, 4), ("step", 3.5, 4),
                               ("save", 0.1234, 1)):
            t.totals[name] += total
            t.counts[name] += n
        with t.phase("io"):
            pass
        t.totals["io"] = 0.5
    assert timers[0].report() == timers[1].report()
    assert timers[0].report().startswith("step 3.50s (0.875s x4) | data")
    timers[0].reset()
    assert timers[0].report() == ""


def test_trace_writes_a_chrome_trace(tmp_path):
    from openscene_tpu_torch.utils.profiling import annotate, trace
    with trace(str(tmp_path / "prof")) as prof:
        with annotate("viz-test-region"):
            torch.ones((64, 64)).matmul(torch.ones((64, 64))).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "prof" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "viz-test-region" for e in events)
    assert any(e.key == "viz-test-region" for e in prof.key_averages())


# ---- the region-order probe and the converter's command line ----

@pytest.fixture(scope="module")
def probe_case():
    """An ME-named state dict, and a small scene (one point per 2 cm voxel)
    whose "fused features" are the converted model's own fp32 output under
    ``x_fastest``, a tenth of the points without one."""
    from openscene_tpu_torch.data.batch import assemble_distill_batch
    from openscene_tpu_torch.data.loaders import SceneSample
    from openscene_tpu_torch.sparse.geometry import geometry_to_device
    from tests.test_torch_unet import _surface_coords
    sd = _me_state_dict(np.random.default_rng(21))
    vox = _surface_coords(4, n=1500, span=40)[:, 1:]
    rng = np.random.default_rng(22)
    order = rng.permutation(len(vox))
    points = (vox[order] + 0.25 + 0.5 * rng.random((len(vox), 3))) * 0.02
    keys = vox[:, 0].astype(np.int64) * 2 ** 42 \
        + vox[:, 1].astype(np.int64) * 2 ** 21 + vox[:, 2]
    sorted_vox = vox[np.argsort(keys)]
    sample = SceneSample(coords=sorted_vox - sorted_vox.min(0),
                         feats=np.ones((len(vox), 3), np.float32),
                         labels=np.zeros(len(vox), np.int64),
                         inds_reconstruct=None,
                         feat_3d=np.zeros((0, COUT), np.float16),
                         feat_mask=np.zeros(len(vox), bool))
    batch = assemble_distill_batch([sample], COUT, shift=False)
    state_dict, _ = cc._port_state_dict(sd, ARCH, "x_fastest")
    model = MinkUNet(3, COUT, ARCH)
    model.load_state_dict(state_dict)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(batch.feats),
                           geometry_to_device(batch.geo, "cpu"),
                           constant_input=True).numpy()[:len(vox)]
    # point j lies in voxel order[j], the (sorted) row rank of its key
    rank = np.empty(len(vox), np.int64)
    rank[np.argsort(keys)] = np.arange(len(vox))
    feat = out[rank[order]]
    mask = rng.random(len(vox)) > 0.1
    return sd, points, feat, mask


def test_probe_region_order_matches_jax(probe_case):
    from openscene_tpu.utils.convert_checkpoint import \
        probe_region_order as jax_probe
    sd, points, feat, mask = probe_case
    best, scores = cc.probe_region_order(sd, ARCH, points, feat, mask,
                                         device="cpu")
    jbest, jscores = jax_probe(sd, ARCH, points, feat, mask)
    assert best == jbest == "x_fastest"
    assert set(scores) == set(jscores) == set(cc.REGION_ORDERS)
    for order, v in scores.items():
        assert abs(v - jscores[order]) <= 1e-4, (order, v, jscores[order])
    assert scores["x_fastest"] > 0.99 > scores["z_fastest"]


def test_convert_main_writes_what_load_weights_reads(probe_case, tmp_path):
    sd, points, feat, mask = probe_case
    src = str(tmp_path / "ref.pth.tar")
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v)
                               for k, v in sd.items()}}, src)
    scene = str(tmp_path / "scene.npz")
    np.savez(scene, coords=points.astype(np.float32),
             colors=np.zeros_like(points, np.float32),
             labels=np.zeros(len(points), np.int64))
    fused = str(tmp_path / "scene_fused.npz")
    np.savez(fused, feat=feat[mask].astype(np.float16), mask_full=mask)
    dst = str(tmp_path / "converted.pth")
    cc.main([src, dst, "--arch", ARCH, "--out_channels", str(COUT),
             "--region_order", "z_fastest", "--probe_scene",
             f"{scene},{fused}", "--device", "cpu"])
    model = MinkUNet(3, COUT, ARCH)
    E.load_weights(model, Config(model_path=dst, arch_3d=ARCH))
    params, state = cc.convert_state_dict(sd, ARCH, region_order="x_fastest")
    want = params_from_jax(params, state, ARCH)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, v in want.items():
        assert torch.equal(got[name], v), name
    with pytest.raises(ValueError, match="out_channels"):
        cc.main([src, dst, "--arch", ARCH, "--out_channels", "768"])
