"""The port's supervised segmentation (``runtime/train_seg.py``,
``runtime/eval_seg.py``) against the JAX package's, on the CPU.

* ``cross_entropy_ignore`` and ``focal_loss``: values and gradients against
  the JAX functions with no, some and every label ignored (``rtol=1e-5``,
  gradients ``1e-4`` of their scale; all ignored gives 0 and no gradient).
* ``make_seg_optimizer``: three SGD updates (momentum, coupled weight
  decay, the poly learning rate read before each update) against optax's
  ``add_decayed_weights`` + ``sgd(momentum)`` on the same gradients, the
  same fp32 operations in the same order: equal to ``rtol=1e-6``.
* Two seg train steps against the JAX package's ``make_seg_train_step``
  from the same weights (``params_from_jax``) on the same batches, fp32
  compute, MinkUNet14A at 5 cm (the base of ``tests/test_seg.py``), at
  ``lr(0) = 1e-4`` so that the first update does not move the second
  step's gradients: ``tests/test_torch_distill.py``'s fp32 gates for the
  loss (``rtol=1e-5``) and the gradients (all together ``1e-2`` relative L2,
  each tensor ``5e-2``).  The distill test also holds the first step's
  median tensor to ``1e-4``, "no gate can move a median"; here the weights
  times ``1 + 1e-7 * N(0, 1)`` alone move the port's median tensor by
  2-7e-4 (fp32 rounding behind BatchNorm at the coarse levels, three weight
  seeds), and the JAX comparison measured 0.5-1.4e-3, so the median is held
  to 10x that sensitivity, measured in the test.  The parameters after each
  step within ``1e-2`` of the step's update, in L2 over all parameters (SGD
  moves each weight by ``lr`` times its gradient plus momentum and decay,
  with no Adam sign freedom; measured 1.6e-3), BatchNorm buffers
  ``rtol=1e-4``, and the steps' IoU histograms equal to the JAX step's;
  ``iou_histograms`` equals ``metrics.intersection_and_union`` exactly.
* ``SegTrainer``: ``fit`` for one epoch (host geometry, and geometry built
  on the device's code path on the CPU), checkpoints, resume.
* ``evaluate_seg``: mIoU of every repeat within ``1e-3`` of the JAX
  package's ``evaluate_seg`` on the same weights and data (bf16, 2 repeats,
  ``save_folder`` written), with device and host geometry.
* ``python -m ...train_seg`` / ``...eval_seg`` ``main`` with ``--device cpu``
  and ``configs/scannet/mink.yaml``.
"""

import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import openscene_tpu.runtime.train_seg as js
from openscene_tpu import metrics as jax_metrics
from openscene_tpu.config import Config as JaxConfig
from openscene_tpu.data.batch import \
    assemble_seg_batch as jax_assemble_seg_batch
from openscene_tpu.data.synthetic import build_synthetic_dataset
from openscene_tpu.models import apply_unet
from openscene_tpu.runtime.eval_seg import evaluate_seg as jax_evaluate_seg
from openscene_tpu_torch.config import Config
from openscene_tpu_torch.convert import flatten_tree, params_from_jax
from openscene_tpu_torch.data.batch import assemble_seg_batch
from openscene_tpu_torch.data.loaders import Point3DLoader
from openscene_tpu_torch.models import MinkUNet
from openscene_tpu_torch.runtime import eval_seg as E
from openscene_tpu_torch.runtime import train_seg as S
from openscene_tpu_torch.sparse.stencil_conv import stencil_conv_fwd
from tests.test_torch_unet import _one_thread, numpy_unet_trees  # noqa: F401

ARCH = "MinkUNet14A"
CLASSES = 20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- losses and the optimizer ----

def _logits_labels(seed, ignore):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((60, CLASSES)).astype(np.float32) * 2
    labels = rng.integers(0, CLASSES, 60)
    if ignore == "some":
        labels[rng.random(60) < 0.3] = 255
    elif ignore == "all":
        labels[:] = 255
    return logits, labels.astype(np.int32)


@pytest.mark.parametrize("ignore", ["none", "some", "all"])
@pytest.mark.parametrize("kind", ["ce", "focal"])
def test_losses_match_jax(kind, ignore):
    logits, labels = _logits_labels(0, ignore)
    if kind == "ce":
        jfn = js.cross_entropy_ignore
        fn = S.cross_entropy_ignore
    else:
        def jfn(z, lab):
            return js.focal_loss(jax.nn.softmax(z, -1), lab, CLASSES)

        def fn(z, lab):
            return S.focal_loss(torch.softmax(z, -1), lab, CLASSES)
    ref, gref = jax.value_and_grad(jfn)(jnp.asarray(logits),
                                        jnp.asarray(labels))
    z = torch.from_numpy(logits).requires_grad_()
    loss = fn(z, torch.from_numpy(labels))
    loss.backward()
    gref = np.asarray(gref)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(z.grad.numpy(), gref, rtol=0,
                               atol=1e-4 * max(np.abs(gref).max(), 1e-30))
    if ignore == "all":
        assert loss.item() == 0.0 and not z.grad.any()
    else:
        assert loss.item() > 0


def test_focal_loss_mean_matches_jax():
    logits, labels = _logits_labels(1, "some")
    p = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    ref = js.focal_loss(jnp.asarray(p), jnp.asarray(labels), CLASSES,
                        gamma=1.5, reduce="mean")
    got = S.focal_loss(torch.from_numpy(p), torch.from_numpy(labels),
                       CLASSES, gamma=1.5, reduce="mean")
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_seg_optimizer_matches_optax():
    kw = dict(base_lr=0.1, momentum=0.9, weight_decay=1e-2, power=0.9)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    rng = np.random.default_rng(2)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32)
             for _ in range(3)]
    model = torch.nn.Linear(3, 4, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0))
    opt, schedule = S.make_seg_optimizer(cfg, model, max_iter=5)
    jopt, jschedule = js.make_seg_optimizer(jcfg, max_iter=5)
    assert isinstance(opt, torch.optim.SGD)
    assert opt.param_groups[0]["momentum"] == 0.9
    assert opt.param_groups[0]["weight_decay"] == 1e-2
    jw = jnp.asarray(w0)
    jstate = jopt.init(jw)
    for it, g in enumerate(grads):
        assert schedule(it) == pytest.approx(float(jschedule(it)), rel=1e-6)
        model.weight.grad = torch.from_numpy(g)
        for group in opt.param_groups:  # as TrainStep.run does
            group["lr"] = schedule(it)
        opt.step()
        upd, jstate = jopt.update(jnp.asarray(g), jstate, jw)
        jw = optax.apply_updates(jw, upd)
        np.testing.assert_allclose(model.weight.detach().numpy(),
                                   np.asarray(jw), rtol=1e-6, atol=1e-7)
    assert schedule(5) == 0.0 and schedule(9) == 0.0


def test_iou_histograms_match_metrics():
    rng = np.random.default_rng(3)
    pred = rng.integers(0, CLASSES, 500)
    labels = rng.integers(0, CLASSES, 500)
    labels[rng.random(500) < 0.2] = 255
    got = S.iou_histograms(torch.from_numpy(pred), torch.from_numpy(labels),
                           CLASSES)
    ref = jax_metrics.intersection_and_union(pred, labels, CLASSES, 255)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---- train steps ----

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The synthetic set of ``tests/test_seg.py``."""
    root = tmp_path_factory.mktemp("torch_seg_synth")
    d3, _ = build_synthetic_dataset(str(root), n_train=2, n_val=1,
                                    dim=16, density=300.0)
    return d3


def _base(d3, save_path, **kw):
    base = dict(data_root=d3, voxel_size=0.05, arch_3d=ARCH,
                classes=CLASSES, batch_size=2, loop=2, epochs=2,
                base_lr=0.05, aug=True, manual_seed=0, evaluate=False,
                print_freq=1, save_path=str(save_path), use_shm=True,
                test_repeats=2, split="val", workers=1)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def seg_batches(synth):
    loader = Point3DLoader(datapath_prefix=synth, voxel_size=0.05,
                           split="train", aug=True, loop=1, seed=0)
    samples = [loader.get(i) for i in range(2)]
    port = [assemble_seg_batch(samples, rng=np.random.default_rng(i),
                               shift=True) for i in range(2)]
    ref = [jax_assemble_seg_batch(samples, rng=np.random.default_rng(i),
                                  shift=True, windows=False)
           for i in range(2)]
    return port, ref


def _rel_l2_all(a, b):
    num = sum(np.linalg.norm(a[n] - b[n]) ** 2 for n in b)
    return (num / sum(np.linalg.norm(b[n]) ** 2 for n in b)) ** 0.5


@pytest.fixture(scope="module")
def step_records(synth, seg_batches):
    """Two fp32 seg steps of both packages from the same weights."""
    port_batches, jax_batches = seg_batches
    kw = dict(arch_3d=ARCH, classes=CLASSES, base_lr=1e-4, momentum=0.9,
              weight_decay=1e-4, power=0.9, compute_dtype="float32")
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    params, state = numpy_unet_trees(ARCH, 3, CLASSES, seed=5)
    model = MinkUNet(3, CLASSES, ARCH)
    model.load_state_dict(params_from_jax(params, state, ARCH))
    sensitivity = _perturbed_grads(cfg, model, port_batches[0])
    opt, schedule = S.make_seg_optimizer(cfg, model, max_iter=10)
    step = S.make_seg_train_step(cfg, model, opt, schedule, "cpu")
    jopt, _ = js.make_seg_optimizer(jcfg, max_iter=10)
    jstep = js.make_seg_train_step(jcfg, jopt)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    jopt_state = jopt.init(jparams)

    @jax.jit
    def jax_grads(p, s, b):
        def loss_fn(p_):
            out, _ = apply_unet(p_, s, jnp.asarray(b.feats), b.geo,
                                arch=ARCH, train=True, constant_input=True)
            return js.cross_entropy_ignore(out, jnp.asarray(b.labels))
        return jax.grad(loss_fn)(p)

    records = []
    for pb, jb in zip(port_batches, jax_batches):
        before = flatten_tree(jparams)
        gref = flatten_tree(jax_grads(jparams, jstate, jb))
        (jparams, jstate, jopt_state, jloss, ji, ju,
         jt) = jstep(jparams, jstate, jopt_state, jb)
        loss, inter, union, tgt = step(pb)
        records.append(dict(
            loss=float(loss), jloss=float(jloss), gref=gref, before=before,
            hist=[h.numpy() for h in (inter, union, tgt)],
            jhist=[np.asarray(h) for h in (ji, ju, jt)],
            grads={n: p.grad.numpy().copy()
                   for n, p in model.named_parameters()},
            params={n: p.detach().numpy().copy()
                    for n, p in model.named_parameters()},
            pref=flatten_tree(jparams), sref=flatten_tree(jstate),
            buffers={n: v.numpy().copy() for n, v in model.named_buffers()}))
    assert step.it == 2
    records[0]["sensitivity"] = sensitivity
    return records


def _perturbed_grads(cfg, model, batch):
    """The port's fp32 gradients of ``batch`` at the model's weights and at
    the weights times ``1 + 1e-7 * N(0, 1)``: how far fp32 rounding alone
    moves each tensor's gradient at this point, {name: relative L2}."""
    out = []
    for eps in (0.0, 1e-7):
        m = MinkUNet(3, CLASSES, ARCH)
        m.load_state_dict(model.state_dict())
        gen = torch.Generator().manual_seed(11)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=gen))
        opt, schedule = S.make_seg_optimizer(cfg, m, max_iter=10)
        S.make_seg_train_step(cfg, m, opt, schedule, "cpu")(batch)
        out.append({n: p.grad.numpy().copy() for n, p in m.named_parameters()})
    return {n: np.linalg.norm(out[1][n] - g) / np.linalg.norm(g)
            for n, g in out[0].items()}


@pytest.mark.parametrize("n_steps", [1, 2])
def test_seg_train_steps_match_jax(step_records, n_steps):
    for i, r in enumerate(step_records[:n_steps]):
        np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-5)
        grads, gref = r["grads"], r["gref"]
        assert set(grads) == set(gref)
        each = {n: np.linalg.norm(grads[n] - g) / np.linalg.norm(g)
                for n, g in gref.items()}
        assert _rel_l2_all(grads, gref) <= 1e-2
        assert max(each.values()) <= 5e-2, max(each, key=each.get)
        if i == 0:  # the median tensor: within the model's own fp32 noise
            noise = np.median(list(r["sensitivity"].values()))
            assert np.median(list(each.values())) <= 10 * noise
        # |port - JAX| over |JAX update|, all parameters together
        moved = {n: r["pref"][n] - r["before"][n] for n in gref}
        assert _rel_l2_all(r["params"], r["pref"]) * np.sqrt(
            sum(np.linalg.norm(v) ** 2 for v in r["pref"].values())
            / sum(np.linalg.norm(v) ** 2 for v in moved.values())) <= 1e-2
        assert set(r["buffers"]) == set(r["sref"])
        for n, v in r["sref"].items():
            np.testing.assert_allclose(r["buffers"][n], v, err_msg=n,
                                       rtol=1e-4, atol=1e-6)
        for h, jh in zip(r["hist"], r["jhist"]):
            np.testing.assert_array_equal(h, jh)
    assert stencil_conv_fwd.launches == 0


# ---- trainer and evaluator ----

def test_trainer_fits_checkpoints_and_resumes(synth, tmp_path):
    cfg = Config(**_base(synth, tmp_path, epochs=1, evaluate=True,
                         voxel_size=0.1))
    tr = S.SegTrainer(cfg, device="cpu")
    assert not tr.geometry.on and tr.batches_per_epoch == 2
    init = {k: v.clone() for k, v in tr.model.state_dict().items()}
    best = tr.fit()
    assert tr.global_step == 2 and 0.0 <= best <= 1.0
    assert any(not torch.equal(v, init[k])
               for k, v in tr.model.state_dict().items())
    last = join(str(tmp_path), "model", "model_last.ckpt")
    payload = torch.load(last, weights_only=False)
    assert set(payload) == {"epoch", "model", "optimizer", "best_iou"}
    assert payload["epoch"] == 1 and payload["best_iou"] == best

    rs = S.SegTrainer(Config(**_base(synth, tmp_path, epochs=2, resume=last,
                                     voxel_size=0.1)), device="cpu")
    assert rs.start_epoch == 1 and rs.global_step == 2
    assert rs.best_iou == best
    for k, v in rs.model.state_dict().items():
        assert torch.equal(v, tr.model.state_dict()[k]), k
    old, new = tr.optimizer.state_dict(), rs.optimizer.state_dict()
    assert old["state"].keys() == new["state"].keys() and old["state"]
    for i, st in old["state"].items():
        assert torch.equal(st["momentum_buffer"],
                           new["state"][i]["momentum_buffer"])
    loss, _ = rs.train_epoch(1)
    assert np.isfinite(loss) and rs.global_step == 4


def test_trainer_on_device_geometry_trains(synth, tmp_path):
    cfg = Config(**_base(synth, tmp_path, epochs=1, device_geometry="on",
                         voxel_size=0.1))
    tr = S.SegTrainer(cfg, device="cpu")
    assert tr.geometry.on
    loss, miou = tr.train_epoch(0)
    assert np.isfinite(loss) and 0.0 <= miou <= 1.0
    assert tr.global_step == 2 and tr.overflows == 0


@pytest.mark.parametrize("geometry", ["host", "device"])
def test_evaluate_seg_matches_jax(synth, tmp_path, geometry):
    base = _base(synth, tmp_path)
    params, state = numpy_unet_trees(ARCH, 3, CLASSES, seed=6)
    ref = jax_evaluate_seg(JaxConfig(**base,
                                     save_folder=str(tmp_path / "jax")),
                           params, state)
    model = MinkUNet(3, CLASSES, ARCH)
    model.load_state_dict(params_from_jax(params, state, ARCH))
    cfg = Config(**base, device_geometry="on" if geometry == "device"
                 else "off", save_folder=str(tmp_path / "out"))
    got = E.evaluate_seg(cfg, model, device="cpu")
    assert set(got) == set(ref) == {"repeat_0", "repeat_1", "accumulated",
                                    "miou"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-3, (k, got[k], ref[k])
    pred = np.load(tmp_path / "out" / "pred.npy")
    assert pred.shape == np.load(tmp_path / "out" / "gt.npy").shape


def test_cli_mains_on_cpu(synth, tmp_path):
    cfg = join(REPO, "configs", "scannet", "mink.yaml")
    common = ["--config", cfg, "--device", "cpu", "data_root", synth,
              "voxel_size", "0.1", "arch_3d", ARCH, "use_shm", "True",
              "manual_seed", "0"]
    best = S.main(common + ["batch_size", "2", "loop", "1", "epochs", "1",
                            "workers", "2", "save_path", str(tmp_path)])
    assert 0.0 <= best <= 1.0
    ckpt = join(str(tmp_path), "model", "model_last.ckpt")
    assert os.path.exists(ckpt)
    out = E.main(common + ["model_path", ckpt, "test_repeats", "1",
                           "save_folder", str(tmp_path / "eval")])
    assert 0.0 <= out["miou"] <= 1.0
    assert os.path.exists(tmp_path / "eval" / "pred.npy")
    with pytest.raises(FileNotFoundError):
        E.main(common + ["model_path", str(tmp_path / "none.ckpt")])


@pytest.mark.parametrize("entry", ["train", "eval"])
def test_entry_points_refuse_what_is_not_ported(entry, monkeypatch,
                                                tmp_path):
    """Multi-GPU training or eval without the process group it asks for
    raises and names the ways to start one; without CUDA the default
    device raises."""
    if entry == "train":
        with pytest.raises(RuntimeError, match="train_seg.*torchrun.*main"):
            S.SegTrainer(Config(data_parallel=2), device="cpu")
    else:
        with pytest.raises(RuntimeError, match="eval_seg.*torchrun.*main"):
            E.evaluate_seg(Config(data_parallel=2), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        (S.main if entry == "train" else E.main)(
            ["epochs", "1", "save_path", str(tmp_path)])
