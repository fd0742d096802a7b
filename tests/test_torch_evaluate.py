"""The slice as a whole: the port's ZeroShotEvaluator against the JAX
package's, on the CPU.

A 2-scene synthetic dataset (``build_synthetic_dataset``, 96-d prototype
features, as tests/test_e2e_eval.py builds it) goes through both evaluators
in fusion, distill and ensemble modes, MinkUNet14A, with seeded numpy
weights carried across by ``params_from_jax`` and the class prototypes as
text embeddings.

Tolerances, per mode:

* per-point logits: fusion is the same fp32 product on both sides
  (``rtol=atol=1e-5``); distill and ensemble go through the bf16 UNet,
  whose outputs drift by a few bf16 ulps between the two frameworks, so
  logits must agree to ``4 * 2**-7`` of the logit scale at 99.5% of the
  points — the rest allows for the ensemble choosing the other feature at a
  near-tie of the two normalized maxima;
* argmax agreement >= 99.5% at points whose reference top-2 margin is at
  least 1e-3;
* mIoU from ``run()`` equal to 1e-3.

Geometry built on the device (``device_geometry on``, here on the CPU)
against the host route: on the same level caps the logits are equal bit for
bit (the plans are, and the forward is deterministic), and ``run()`` gives
the host route's mIoU to 1e-3 (its caps grow across scenes, so padding
differs); a scene whose device geometry overflows is planned on the host
and gives the host route's logits exactly.  Distill mode builds and copies
no ``feat_3d``.
"""

import numpy as np
import pytest
import torch

from openscene_tpu.config import Config as JaxConfig
from openscene_tpu.data.synthetic import (build_synthetic_dataset,
                                          class_prototypes)
from openscene_tpu.runtime.evaluate import \
    ZeroShotEvaluator as JaxZeroShotEvaluator
from openscene_tpu_torch.config import Config
from openscene_tpu_torch.convert import params_from_jax
from openscene_tpu_torch.models import MinkUNet
from openscene_tpu_torch.data.batch import assemble_eval_batch
from openscene_tpu_torch.runtime.evaluate import (ZeroShotEvaluator,
                                                  make_eval_step)
from openscene_tpu_torch.sparse.geometry import GeometryCaps
from openscene_tpu_torch.sparse.edge_conv import down_conv_fwd
from openscene_tpu_torch.sparse.stencil_conv import stencil_conv_fwd
from tests.test_torch_unet import _one_thread, numpy_unet_trees  # noqa: F401

ARCH = "MinkUNet14A"
DIM = 96


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_torch_eval")
    d3, dfeat = build_synthetic_dataset(str(root), n_train=0, n_val=2,
                                        dim=DIM, density=300.0,
                                        all_classes=True)
    params, state = numpy_unet_trees(ARCH, 3, DIM, seed=0)
    model = MinkUNet(3, DIM, ARCH)
    model.load_state_dict(params_from_jax(params, state, ARCH))
    return d3, dfeat, params, state, model


def _cfgs(d3, dfeat, mode):
    kw = dict(data_root=d3, data_root_2d_fused_feature=dfeat,
              feature_2d_extractor="openseg", voxel_size=0.05, split="val",
              feature_type=mode, test_repeats=1, test_workers=1,
              mark_no_feature_to_unknown=True, manual_seed=0, arch_3d=ARCH)
    return JaxConfig(**kw), Config(**kw)


def _run(ev, to_numpy):
    """``ev.run()`` and the per-point logits it produced on the way."""
    logits = []
    scene_outputs = ev._scene_outputs

    def recording(samples, step):
        for i, sample, out, n in scene_outputs(samples, step):
            logits.append(to_numpy(out[0])[:n])
            yield i, sample, out, n

    ev._scene_outputs = recording
    miou = ev.run()["miou"]
    return np.concatenate(logits), miou


@pytest.mark.parametrize("mode", ["fusion", "distill", "ensemble"])
def test_evaluator_matches_jax(setup, mode):
    d3, dfeat, params, state, model = setup
    text = class_prototypes(20, DIM)
    jcfg, cfg = _cfgs(d3, dfeat, mode)
    with_model = mode != "fusion"
    jev = JaxZeroShotEvaluator(jcfg, params if with_model else None,
                               state if with_model else None,
                               text_features=text)
    ev = ZeroShotEvaluator(cfg, model if with_model else None,
                           text_features=text, device="cpu")

    ref, miou_ref = _run(jev, lambda a: np.asarray(a, np.float32))
    got, miou = _run(ev, lambda t: t.float().numpy())
    assert got.shape == ref.shape and np.isfinite(got).all()
    if mode == "fusion":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        scale = np.abs(ref).max()
        close = (np.abs(got - ref) <= 4 * 2.0 ** -7 * scale).all(1)
        assert close.mean() >= 0.995, close.mean()
    top2 = np.sort(ref, 1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) >= 1e-3
    agree = got.argmax(1) == ref.argmax(1)
    assert agree[clear].mean() >= 0.995, agree[clear].mean()

    assert abs(miou - miou_ref) <= 1e-3, (miou, miou_ref)
    assert stencil_conv_fwd.launches == 0 and down_conv_fwd.launches == 0


def test_load_model_for_eval(setup, tmp_path):
    from openscene_tpu_torch.runtime.evaluate import load_model_for_eval
    from openscene_tpu_torch.utils.convert_checkpoint import \
        convert_state_dict
    from tests.test_unet_golden_parity import _me_state_dict
    d3, dfeat, params, state, model = setup
    _, cfg = _cfgs(d3, dfeat, "fusion")
    assert load_model_for_eval(cfg, "cpu") is None

    _, cfg = _cfgs(d3, dfeat, "distill")
    # random init from the config's seed, deterministic
    a, b = (load_model_for_eval(cfg, "cpu").state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)

    # the port's own state_dict, saved by torch
    own = MinkUNet(3, 768, ARCH,
                   generator=torch.Generator().manual_seed(9)).state_dict()
    cfg.model_path = str(tmp_path / "own.pth")
    torch.save(own, cfg.model_path)
    got = load_model_for_eval(cfg, "cpu").state_dict()
    assert all(torch.equal(got[k], own[k]) for k in own)

    # a reference MinkowskiEngine checkpoint, converted on load
    me = _me_state_dict(np.random.default_rng(4), cout=768)
    cfg.model_path = str(tmp_path / "ref.pth.tar")
    torch.save({"state_dict": {"module." + k: torch.from_numpy(v)
                               for k, v in me.items()}}, cfg.model_path)
    got = load_model_for_eval(cfg, "cpu").state_dict()
    want = params_from_jax(*convert_state_dict(me, ARCH), ARCH)
    assert all(torch.equal(got[k], want[k]) for k in want)

    # a truncated flax-msgpack file (the JAX package's checkpoints load
    # through tests/test_torch_checkpoint.py)
    cfg.model_path = str(tmp_path / "model_best.ckpt")
    (tmp_path / "model_best.ckpt").write_bytes(b"\x81\xa5flax!")
    with pytest.raises(ValueError, match="msgpack.*truncated"):
        load_model_for_eval(cfg, "cpu")


def test_cli_main_matches_jax_in_fusion_mode(tmp_path):
    """``python -m openscene_tpu_torch.runtime.evaluate --device cpu`` end
    to end on a 768-d scene, text embeddings from a file, with the
    per-point feature dump."""
    from openscene_tpu.runtime.evaluate import main as jax_main
    from openscene_tpu_torch.runtime.evaluate import main
    d3, dfeat = build_synthetic_dataset(str(tmp_path / "d768"), n_train=0,
                                        n_val=1, dim=768, density=150.0)
    emb = str(tmp_path / "text.npy")
    np.save(emb, class_prototypes(20, 768))
    args = ["data_root", d3, "data_root_2d_fused_feature", dfeat,
            "feature_type", "fusion", "test_repeats", "1", "voxel_size",
            "0.05", "test_workers", "1", "embedding_file", emb,
            "manual_seed", "0"]
    dump = ["save_feature_as_numpy", "True", "save_folder"]
    got = main(["--device", "cpu"] + args + dump + [str(tmp_path / "port")])
    ref = jax_main(args + dump + [str(tmp_path / "jax")])
    assert got["miou"] > 0.1  # signal: prototype text on prototype features
    assert abs(got["miou"] - ref["miou"]) <= 1e-6
    name = "scene0000_00_openscene_feat_fusion.npy"
    feat = np.load(tmp_path / "port" / name)
    assert feat.dtype == np.float16 and feat.shape[1] == 768
    np.testing.assert_array_equal(feat, np.load(tmp_path / "jax" / name))


def _evaluators(setup, mode, **kw):
    """(device-geometry evaluator, host-geometry evaluator) on the CPU."""
    d3, dfeat, params, state, model = setup
    text = class_prototypes(20, DIM)
    _, cfg = _cfgs(d3, dfeat, mode)
    return tuple(ZeroShotEvaluator(cfg.copy(device_geometry=dg, **kw), model,
                                   text_features=text, device="cpu")
                 for dg in ("on", "auto"))


@pytest.mark.parametrize("mode", ["distill", "ensemble"])
def test_device_geometry_matches_host_on_equal_caps(setup, mode):
    dev, host = _evaluators(setup, mode)
    assert dev.geometry.on and not host.geometry.on
    loader = dev._loader()
    for i in range(len(loader.data_paths)):
        sample = loader.get(i)
        got, n = dev.scene(sample, dev.step)
        caps = dev.geometry.caps
        batch = assemble_eval_batch([sample], DIM, caps=GeometryCaps(
            cap0=caps.cap0, fixed=caps.fixed))
        ref = host.step(host.model, host.text, batch)
        assert n == batch.num_points
        assert torch.equal(got[0][:n], ref[0][:n])
        assert torch.equal(got[1][:n], ref[1][:n])
    assert dev.geometry.overflows == 0
    miou_dev, miou_host = dev.run()["miou"], host.run()["miou"]
    assert abs(miou_dev - miou_host) <= 1e-3


def test_overflowing_scene_takes_the_host_route(setup, caplog):
    # a level-0 grid of 8^3 cells holds none of the scenes: every scene
    # overflows on the device and is planned on the host
    dev, host = _evaluators(setup, "distill", grid_dims0=(8, 8, 8))
    loader = dev._loader()
    for i in range(len(loader.data_paths)):
        sample = loader.get(i)
        got, n = dev.scene(sample, dev.step)
        ref, m = host.scene(sample, host.step)
        assert n == m and torch.equal(got[0], ref[0])
    assert dev.geometry.overflows == len(loader.data_paths)
    assert "planning the scene on the host" in caplog.text


@pytest.mark.parametrize("mode", ["distill", "ensemble"])
def test_only_fusion_and_ensemble_copy_feat_3d(setup, mode):
    seen = []
    for ev in _evaluators(setup, mode):
        step = ev.step

        def recording(model, text, batch, geo=None, step=step):
            seen.append(batch.feat_3d)
            return step(model, text, batch, geo)

        ev.step = recording  # run() steps every scene through self.step
        ev.run()
    assert len(seen) == 4
    assert all((f is None) == (mode == "distill") for f in seen)
    # the distill step never touches feat_3d; fusion needs it
    d3, dfeat, params, state, model = setup
    sample = ZeroShotEvaluator(_cfgs(d3, dfeat, "fusion")[1],
                               text_features=class_prototypes(20, DIM),
                               device="cpu")._loader().get(0)
    batch = assemble_eval_batch([sample], DIM, need_fused=False)
    text = torch.as_tensor(class_prototypes(20, DIM))
    out = make_eval_step("distill")(model, text, batch)
    assert torch.isfinite(out[0]).all()
    with pytest.raises((TypeError, RuntimeError)):
        make_eval_step("fusion")(None, text, batch)
