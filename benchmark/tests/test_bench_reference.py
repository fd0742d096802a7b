"""The plain reference against the port's plain path (CPU, float32) at a
tiny size: the seg train step, the val loader's voxelization and the
ensemble evaluation."""

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.reference import ensemble, minkunet, train
from benchmark.reference.voxelize import repeat_seeds, voxelize

ARCH = "MinkUNet18A"


def _samples(seed=0, n_scenes=2):
    from openscene_tpu_torch.data.loaders import SceneSample
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_scenes):
        c = np.unique(rng.integers(0, 14, (700, 3)), axis=0).astype(np.int32)
        lab = rng.integers(0, 20, len(c))
        lab[rng.random(len(c)) < 0.1] = 255
        out.append(SceneSample(c, np.ones((len(c), 3), np.float32), lab,
                               None, None, None))
    return out


def test_seg_step_matches_port():
    from openscene_tpu_torch.config import Config
    from openscene_tpu_torch.data.batch import assemble_seg_batch
    from openscene_tpu_torch.models.sparse_unet import MinkUNet
    from openscene_tpu_torch.runtime.train_seg import (make_seg_optimizer,
                                                       make_seg_train_step)
    cfg = {"arch_3d": ARCH, "ignore_label": 255, "base_lr": 0.01,
           "power": 0.9, "momentum": 0.9, "weight_decay": 1e-4}
    pcfg = Config(arch_3d=ARCH, classes=20, compute_dtype="float32",
                  base_lr=0.01, weight_decay=1e-4, momentum=0.9, power=0.9)
    w = minkunet.make_weights(ARCH, 3, 20, 11, "cpu")
    model = MinkUNet(3, 20, ARCH)
    model.load_state_dict({k: w[k] for k in model.state_dict()})
    opt, sched = make_seg_optimizer(pcfg, model, 100)
    step = make_seg_train_step(pcfg, model, opt, sched, torch.device("cpu"))
    batches, losses = [], []
    for s in range(2):
        b = assemble_seg_batch(_samples(s))
        n = b.num_voxels
        batches.append((torch.from_numpy(b.geo.levels[0].coords[:n]).long(),
                        torch.from_numpy(b.labels[:n]).long()))
        losses.append(float(step(b)[0]))
    ref = train.train_steps(w, batches, cfg, 100)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    # the second step's gradient is taken at weights that already differ
    # by rounding, and the tiny batches' steps are large: 1% after two
    for k, p in model.named_parameters():
        d = float((p.detach() - w[k]).norm())
        assert abs(d - ref["change"][k]) <= 1e-2 * max(ref["change"][k],
                                                       1e-4), k


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    wl = {"val": {"density": 300, "rooms": [[[0.3, 0.3], [4, 11]],
                                            [[0.35, 0.3], [3, 9, 15]]],
                  "fused": {"noise": 0.1, "visible": 0.85}}}
    root = str(tmp_path_factory.mktemp("val"))
    return data.write(root, wl, 21, "cpu", dim=768,
                      fused_dir="scannet_multiview_openseg")


def _loader(ds):
    from openscene_tpu_torch.data.loaders import FusedFeatureLoader
    return FusedFeatureLoader(datapath_prefix=ds.data_root,
                              datapath_prefix_feat=ds.fused_root,
                              voxel_size=0.02, split="val", aug=False,
                              eval_all=True)


@pytest.mark.parametrize("rep", [0, 2])
def test_voxelize_matches_loader(val_set, rep):
    loader = _loader(val_set)
    seed = repeat_seeds(77, 3)[rep]
    if rep:
        loader.reseed(seed)
    for i, path in enumerate(val_set.val_files):
        s = loader.get(i)
        pts, feat, mask = data.load_val(path, val_set.fused_root)
        vox = voxelize(pts, 0.02, seed, i)
        assert len(vox.coords) == len(s.coords)
        assert np.array_equal(vox.coords[vox.inverse],
                              s.coords[s.inds_reconstruct])
        assert np.array_equal(mask[vox.rep][vox.inverse],
                              s.feat_mask[s.inds_reconstruct])


def test_ensemble_matches_port(val_set):
    from openscene_tpu_torch.data.batch import assemble_eval_batch
    from openscene_tpu_torch.models.sparse_unet import MinkUNet
    from openscene_tpu_torch.runtime.evaluate import make_eval_step
    w = minkunet.make_weights(ARCH, 3, 768, 4, "cpu")
    model = MinkUNet(3, 768, ARCH)
    model.load_state_dict({k: w[k] for k in model.state_dict()})
    model.eval()
    text = torch.from_numpy(np.load(val_set.text_file))
    step = make_eval_step("ensemble", compute_dtype=torch.float32)
    loader = _loader(val_set)
    for i, path in enumerate(val_set.val_files):
        batch = assemble_eval_batch([loader.get(i)], 768)
        got = step(model, text, batch)[0][:batch.num_points].numpy()
        pts, feat, mask = data.load_val(path, val_set.fused_root)
        ref = ensemble.scene_logits(w, pts, feat, mask, text, 0.02, 0, i,
                                    ARCH).numpy()
        rms = np.sqrt(np.mean(ref ** 2))
        assert np.abs(got - ref).max() <= 1e-3 * rms
