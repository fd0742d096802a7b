"""The train step on geometry built on the device, on the CPU (port only:
fp32, MinkUNet14A, a 32-d head; two small seeded scenes, and the synthetic
set at 10 cm for the trainer's epoch).

* ``RawTrainStep`` (search path and occupancy grid) against the host step
  on the same batch, caps and starting state: loss, every gradient, every
  updated parameter and BatchNorm buffer identical.  Both steps run the
  same plain versions on plans that are bit-identical, so nothing but the
  stem's occupancy (built directly, or compared from the stem plan) could
  differ, and it is exact.
* An overflowing build leaves the model, the optimizer and ``it`` as they
  were, and the trainer's route trains the batch exactly as the host step
  does; after ``grid_overflow_limit`` overflows in a row the grid prober is
  off.
* The model with ``geo.stem_occ`` equals the model with the stem plan.
* ``DistillTrainer``: ``device_geometry on`` trains an epoch on the CPU,
  ``auto`` on the CPU builds on the host.
"""

import numpy as np
import pytest
import torch

from openscene_tpu_torch.config import Config
from openscene_tpu_torch.data.batch import (DistillBatch, RawDistillBatch,
                                            assemble_distill_batch,
                                            assemble_raw_distill_batch)
from openscene_tpu_torch.data.loaders import SceneSample
from openscene_tpu_torch.models import MinkUNet
from openscene_tpu_torch.runtime import distill as D
from openscene_tpu_torch.runtime import geometry_route as G
from openscene_tpu_torch.sparse.geometry import (GeometryCaps,
                                                 geometry_to_device)
from openscene_tpu_torch.sparse.types import ConvPlan
from tests.test_torch_distill import (ARCH, DIM, _trainer_cfg,  # noqa: F401
                                      head32, synth)
from tests.test_torch_unet import _one_thread  # noqa: F401

GRID_DIMS0 = (256, 256, 128)   # holds the scenes of these tests


@pytest.fixture(scope="module")
def samples():
    """Two seeded scenes of about 1,400 voxels, fused targets on 80%."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        coords = np.unique(rng.integers(0, 24, size=(1500, 3)), axis=0)
        feat_mask = rng.random(len(coords)) < 0.8
        out.append(SceneSample(
            coords=coords.astype(np.int32),
            feats=np.ones((len(coords), 3), np.float32),
            labels=rng.integers(0, 5, len(coords)).astype(np.int64),
            inds_reconstruct=None,
            feat_3d=rng.standard_normal(
                (int(feat_mask.sum()), DIM)).astype(np.float32),
            feat_mask=feat_mask))
    return out


def _step(seed=0):
    cfg = Config(arch_3d=ARCH, base_lr=1e-3, loss_type="cosine",
                 compute_dtype="float32", manual_seed=0)
    model = MinkUNet(3, DIM, ARCH,
                     generator=torch.Generator().manual_seed(seed))
    opt, schedule = D.make_optimizer(cfg, model, max_iter=10)
    return D.make_train_step(cfg, model, opt, schedule, "cpu")


def _snapshot(step):
    m = step.model
    return ({n: p.grad.clone() for n, p in m.named_parameters()},
            {k: v.clone() for k, v in m.state_dict().items()})


def _assert_same_state(a, b):
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("n_scenes", [None, 2], ids=["search", "grid"])
def test_raw_step_equals_host_step(samples, n_scenes):
    raw, caps = assemble_raw_distill_batch(samples, DIM,
                                           rng=np.random.default_rng(3))
    host = assemble_distill_batch(samples, DIM, caps=caps,
                                  rng=np.random.default_rng(3))
    np.testing.assert_array_equal(raw.coords, host.geo.levels[0].coords)
    np.testing.assert_array_equal(raw.feat_3d, host.feat_3d)
    step_h, step_r = _step(), _step()
    _assert_same_state(step_h.model.state_dict(), step_r.model.state_dict())
    loss_h = step_h(host)
    geo, over = G.RawTrainStep(step_r, caps.fixed, n_scenes=n_scenes,
                               grid_dims0=GRID_DIMS0).geometry(raw)
    assert not over and torch.isfinite(loss_h)
    loss_r = step_r.run(geo, *step_r.parts(raw))
    assert torch.equal(loss_r, loss_h)
    (gh, sh), (gr, sr) = _snapshot(step_h), _snapshot(step_r)
    _assert_same_state(gr, gh)
    _assert_same_state(sr, sh)
    assert step_r.it == step_h.it == 1


def test_overflow_leaves_state_and_falls_back_to_the_host(synth, tmp_path,
                                                          head32, samples):
    raw, caps = assemble_raw_distill_batch(samples, DIM,
                                           rng=np.random.default_rng(4))
    bad = (caps.fixed[0], 256) + caps.fixed[2:]   # level 1 outgrows 256
    cfg = _trainer_cfg(synth, tmp_path, device_geometry="on", evaluate=False,
                       batch_size=2)
    tr, ref = (D.DistillTrainer(cfg, device="cpu") for _ in range(2))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}

    _, over = tr.geometry.raw_step(tr.step_fn, bad).geometry(raw)
    assert over
    _assert_same_state(tr.model.state_dict(), before)
    assert tr.step_fn.it == 0 and not tr.optimizer.state

    # the trainer builds the batch on the host and trains it there
    loss = tr.train_step((raw, bad))
    hb = G.host_batch_from_raw(raw)
    assert torch.equal(loss, ref.step_fn(hb))
    assert tr.overflows == 1 and tr.global_step == ref.global_step == 1
    _assert_same_state(tr.model.state_dict(), ref.model.state_dict())

    # the host batch is the one the host assembly gives at its own caps
    n = int(raw.num)
    direct = assemble_distill_batch(samples, DIM,
                                    caps=GeometryCaps.for_count(n),
                                    rng=np.random.default_rng(4))
    for f in ("feats", "feat_3d", "mask", "labels"):
        np.testing.assert_array_equal(getattr(hb, f), getattr(direct, f))
    for a, b in zip(hb.geo.self3 + (hb.geo.stem,),
                    direct.geo.self3 + (direct.geo.stem,)):
        np.testing.assert_array_equal(a.fwd, b.fwd)


def test_grid_disabled_after_overflow_limit(synth, tmp_path, head32,
                                            samples):
    cfg = _trainer_cfg(synth, tmp_path, device_geometry="on", evaluate=False,
                       batch_size=2, grid_dims0=(8, 8, 8),
                       grid_overflow_limit=2)
    tr = D.DistillTrainer(cfg, device="cpu")
    raw, caps = assemble_raw_distill_batch(samples, DIM,
                                           rng=np.random.default_rng(5))
    batch = (raw, caps.fixed)
    tr.train_step(batch)
    assert tr.overflows == 1 and tr.geometry.grid_enabled
    tr.train_step(batch)
    assert tr.overflows == 2 and not tr.geometry.grid_enabled
    assert tr.geometry.overflow_streak == 0
    tr.train_step(batch)   # the search path has no grid to outgrow
    assert tr.overflows == 2 and tr.global_step == 3
    steps = tr.geometry.raw_steps
    assert set(steps) == {(caps.fixed, True), (caps.fixed, False)}
    assert steps[(caps.fixed, False)].n_scenes is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_model_stem_occupancy_equals_stem_plan(samples, dtype):
    batch = assemble_distill_batch(samples, DIM, rng=np.random.default_rng(6))
    geo = geometry_to_device(batch.geo, "cpu")
    occ = (geo.stem.fwd < geo.levels[0].num).to(torch.bfloat16)
    geo_occ = geo._replace(stem=ConvPlan(fwd=None,
                                         flip_perm=geo.stem.flip_perm),
                           stem_occ=occ)
    model = MinkUNet(3, DIM, ARCH,
                     generator=torch.Generator().manual_seed(1)).eval()
    x = torch.as_tensor(batch.feats).to(dtype)
    with torch.no_grad():
        a = model(x, geo, constant_input=True)
        b = model(x, geo_occ, constant_input=True)
    assert torch.isfinite(a).all() and torch.equal(a, b)


def test_trainer_device_geometry_on_trains_an_epoch_on_cpu(synth, tmp_path,
                                                           head32):
    cfg = _trainer_cfg(synth, tmp_path, device_geometry="on", epochs=1,
                       batch_size=2, evaluate=False, grid_dims0=GRID_DIMS0,
                       voxel_size=0.1)
    tr = D.DistillTrainer(cfg, device="cpu")
    assert tr.geometry.on
    init = {k: v.clone() for k, v in tr.model.state_dict().items()}
    first = next(tr._epoch_batches())
    assert isinstance(first, tuple) and isinstance(first[0],
                                                   RawDistillBatch)
    tr.fit()
    assert tr.global_step == tr.batches_per_epoch and tr.overflows == 0
    assert tr.geometry.grid_enabled
    assert all(k[1] for k in tr.geometry.raw_steps)
    assert any(not torch.equal(v, init[k])
               for k, v in tr.model.state_dict().items())


@pytest.mark.parametrize("setting,on", [("auto", False), ("on", True),
                                        ("true", True), ("off", False)])
def test_trainer_device_geometry_setting_on_cpu(synth, tmp_path, head32,
                                                setting, on):
    tr = D.DistillTrainer(_trainer_cfg(synth, tmp_path, evaluate=False,
                                       device_geometry=setting),
                          device="cpu")
    assert tr.geometry.on == on
    batch = next(tr._epoch_batches())
    assert isinstance(batch, DistillBatch) != on
