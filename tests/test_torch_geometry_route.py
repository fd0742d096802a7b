"""The one geometry route (``runtime/geometry_route.py``) on the CPU with
``device_geometry on``, port only (MinkUNet14A, fp32, the synthetic set at
10 cm).

Each of its four consumers (the trainer's step, the epoch-end export, the
zero-shot scene, the seg scene) builds its geometry through
``build_on_card``, once a batch or scene, and never calls its host builder
when the build fits.  A build forced to report an overflow goes to that
consumer's host builder once and counts once.
"""

import numpy as np
import pytest
import torch

from openscene_tpu.data.synthetic import class_prototypes
from openscene_tpu_torch.data.loaders import Point3DLoader
from openscene_tpu_torch.models import MinkUNet
from openscene_tpu_torch.runtime import distill as D
from openscene_tpu_torch.runtime import evaluate as E
from openscene_tpu_torch.runtime import geometry_route as G
from openscene_tpu_torch.runtime import train_seg as S
from tests.test_torch_distill import (ARCH, DIM, _trainer_cfg,  # noqa: F401
                                      head32, synth)
from tests.test_torch_unet import _one_thread  # noqa: F401

CONSUMERS = ("train_step", "epoch_end_export", "zeroshot_scene",
             "seg_scene")


@pytest.fixture
def calls(monkeypatch):
    """Counts of the route's builds and of the host builders' calls; with
    ``force`` every build reports an overflow."""
    calls = {"build": 0, "host": 0, "force": False}
    build = G.build_on_card

    def counted_build(*args, **kwargs):
        calls["build"] += 1
        geo, overflow = build(*args, **kwargs)
        return geo, overflow or calls["force"]
    monkeypatch.setattr(G, "build_on_card", counted_build)

    for mod, name in ((G, "host_batch_from_raw"),
                      (E, "assemble_eval_batch"),
                      (S, "assemble_seg_batch")):
        def counted(*args, _host=getattr(mod, name), **kwargs):
            calls["host"] += 1
            return _host(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)
    return calls


def _consumer(which, synth, tmp_path):
    """``(run, owner)``: one call of the consumer, and the object whose
    ``overflows`` counts its host fallbacks."""
    d3, dfeat = synth
    if which in ("train_step", "epoch_end_export"):
        tr = D.DistillTrainer(_trainer_cfg(
            synth, tmp_path, device_geometry="on", evaluate=False,
            voxel_size=0.1), device="cpu")
        batch = next(tr._epoch_batches())
        if which == "train_step":
            return lambda: tr.train_step(batch), tr
        return lambda: tr._epoch_end_viz(0, batch), tr
    sample = Point3DLoader(datapath_prefix=d3, voxel_size=0.1, split="val",
                           aug=False, eval_all=True, seed=1).get(0)
    gen = torch.Generator().manual_seed(0)
    if which == "seg_scene":
        cfg = _trainer_cfg(synth, tmp_path, device_geometry="on",
                           classes=20, compute_dtype="float32")
        scenes = S.SegSceneLogits(cfg, MinkUNet(3, 20, ARCH, generator=gen),
                                  torch.device("cpu"))
        return lambda: scenes(sample), scenes.geometry
    cfg = _trainer_cfg(synth, tmp_path, device_geometry="on", split="val",
                       feature_type="distill", voxel_size=0.1)
    ev = E.ZeroShotEvaluator(cfg, MinkUNet(3, DIM, ARCH, generator=gen),
                             text_features=class_prototypes(20, DIM),
                             device="cpu")
    return lambda: ev.scene(sample, ev.step), ev.geometry


@pytest.mark.parametrize("overflow", [False, True],
                         ids=["fits", "overflows"])
@pytest.mark.parametrize("which", CONSUMERS)
def test_consumer_builds_once_and_falls_back_once(synth, tmp_path, head32,
                                                  calls, which, overflow):
    run, owner = _consumer(which, synth, tmp_path)
    calls["force"] = overflow
    out = run()
    assert calls["build"] == 1
    assert calls["host"] == owner.overflows == int(overflow)
    if which == "train_step":
        assert torch.isfinite(out) and owner.global_step == 1
    elif which == "zeroshot_scene":
        assert torch.isfinite(out[0][0][:out[1]]).all()
    elif which == "seg_scene":
        assert np.isfinite(out[0]).all() and len(out[0]) == len(out[1])
    else:
        assert (tmp_path / "result" / "last" / "pred_1.ply").exists()
