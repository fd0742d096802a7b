"""The port's distillation train path against the JAX package's, on the CPU.

* the three losses: values and gradients against the JAX functions, with an
  all-zero output row inside the mask and with an empty mask;
* ``make_optimizer``'s learning rate at steps 0, 1 and ``max_iter``;
* ``assemble_distill_batch`` / ``assemble_seg_batch``: bit-identical to the
  JAX package's on the same samples and rng;
* one and three train steps of ``make_train_step`` against the JAX package's
  on the same ``DistillBatch``es (one scene under three random shifts, the
  second with negated targets;
  MinkUNet14A, 32-d head, weights carried by ``params_from_jax``): loss, every gradient by name (``flatten_tree``),
  every parameter and BatchNorm buffer after each update;
* ``utils/train_utils.py`` against the JAX package's schedules and meters;
* ``DistillTrainer``: two epochs on the synthetic set, validation,
  last/best checkpoints, resume, ``load_model_for_eval``, ``main``.

Tolerances of the train steps.  Two things are discrete and no precision
removes them.  A ReLU whose input is within rounding of zero opens on one
side and stays shut on the other, and at the coarse levels (143 voxels here)
one such gate is a percent of a conv's gradient: the losses agree to 1e-7
while single tensors' gradients differ by up to a few percent.  And Adam's
update is ``lr * m / (sqrt(v) + 1e-8)``, about ``lr * sign(g)`` on the first
step, so an element whose gradient is at the rounding noise moves by ``lr``
on one side and ``-lr`` on the other.  The steps run at ``lr(0) = 1e-6`` so
that this freedom stays out of the next step's gradients.

fp32 compute (tight), at every step: loss ``rtol=1e-5``; all gradients
together within ``1e-2`` relative L2 and each tensor within ``5e-2`` (room
for a few gates; measured 2e-3 and 2e-2 at worst), and on the first step the
median tensor within ``1e-4`` (measured 2e-6: no gate can move a median);
every parameter element within ``2 * sum(lr)`` of the reference (the sign
freedom above) and the mean over all elements within ``5e-3 * sum(lr)``
(measured 5e-4); the elements whose reference gradient is resolved within
``0.25 * sum(lr)``, where resolved means ``|g| >= 1e-3 max|g|`` of its tensor
on the first step (measured 0.03) and ``|g| >= 0.1 max|g|`` at every step so
far on the later ones (measured 0.06: by then a gate has moved single
gradients by 1e-3 of their tensor, and the second batch's negated targets
leave an update of a twentieth of ``lr`` that hangs on Adam's moments);
BatchNorm buffers ``rtol=1e-4``.

bf16 compute (loose, and why): each layer rounds activations and their
gradients to bf16, and behind training-mode BatchNorm a gradient is what is
left after large cancellations, so the two frameworks' bf16 gradients differ
by some 10% of their norm: exactly as far as each of them is from the fp32
gradients.  Held at every step, against the JAX fp32 gradients of that step
as the yardstick (the fp32 run's weights are within a few ``lr`` of the bf16
run's): all gradients together no farther (relative L2) from the yardstick
than ``1.25x`` the JAX bf16 gradients are, plus 0.01 (measured 0.118 against
0.114), and each tensor no farther than ``3x`` plus 0.05 (measured 0.42 of
that limit).  Loss within ``1e-3``.  Parameters: every element within
``2.5 * sum(lr)`` (a flipped sign gives 2, fp32 rounding of a weight of
order 1 the rest; measured 2.03), the mean over all elements within
``0.25 * sum(lr)`` (measured 0.14) and over each tensor within
``0.6 * sum(lr)`` (measured 0.31): a moment or bias correction that is off
moves every element and shows in the means.  BatchNorm buffers within one
bf16 ulp of their scale (``2**-7``).
"""

import json
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openscene_tpu.runtime.distill as jd
from openscene_tpu.config import Config as JaxConfig
from openscene_tpu.data.batch import \
    assemble_distill_batch as jax_assemble_distill_batch
from openscene_tpu.data.batch import \
    assemble_seg_batch as jax_assemble_seg_batch
from openscene_tpu.data.synthetic import build_synthetic_dataset
from openscene_tpu.models import apply_unet
from openscene_tpu_torch.config import Config
from openscene_tpu_torch.convert import flatten_tree, params_from_jax
from openscene_tpu_torch.data.batch import (assemble_distill_batch,
                                            assemble_seg_batch)
from openscene_tpu_torch.data.loaders import (FusedFeatureLoader,
                                              Point3DLoader)
from openscene_tpu_torch.models import MinkUNet
from openscene_tpu_torch.runtime import distill as D
from openscene_tpu_torch.sparse.edge_conv import (down_conv_bwd,
                                                  down_conv_fwd, up_conv_bwd)
from openscene_tpu_torch.sparse.stencil_conv import (stencil_conv_bwd,
                                                     stencil_conv_fwd)
from tests.test_torch_unet import _one_thread, numpy_unet_trees  # noqa: F401

ARCH = "MinkUNet14A"
DIM = 32
MAX_ITER = 10


# ---- losses ----

def _loss_inputs(seed, n=40, d=16, empty_mask=False):
    rng = np.random.default_rng(seed)
    out = rng.standard_normal((n, d)).astype(np.float32)
    target = rng.standard_normal((n, d)).astype(np.float32)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    out[3] = 0.0      # an all-zero output row inside the mask
    mask[3] = 1.0
    out[n - 5:] = 0   # padded rows: zero output, zero target, outside it
    target[n - 5:] = 0
    mask[n - 5:] = 0
    if empty_mask:
        mask[:] = 0
    return out, target, mask


@pytest.mark.parametrize("empty_mask", [False, True], ids=["mask", "empty"])
@pytest.mark.parametrize("kind", ["cosine", "l1"])
def test_distill_losses_match_jax(kind, empty_mask):
    out, target, mask = _loss_inputs(0, empty_mask=empty_mask)
    jfn = jd.cosine_distill_loss if kind == "cosine" else jd.l1_distill_loss
    fn = D.cosine_distill_loss if kind == "cosine" else D.l1_distill_loss
    for tdtype, jdtype in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
        tj = jnp.asarray(target).astype(jdtype)
        ref, gref = jax.value_and_grad(jfn)(jnp.asarray(out), tj,
                                            jnp.asarray(mask))
        o = torch.from_numpy(out).requires_grad_()
        loss = fn(o, torch.from_numpy(target).to(tdtype),
                  torch.from_numpy(mask))
        loss.backward()
        assert torch.isfinite(o.grad).all()
        np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(o.grad.numpy(), np.asarray(gref),
                                   rtol=1e-4, atol=1e-7)
        if empty_mask:
            assert loss.item() == 0.0 and not o.grad.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cosine_head_loss_matches_jax(dtype):
    rng = np.random.default_rng(1)
    n, c, d = 48, 12, 20
    feats, target, mask = _loss_inputs(2, n=n, d=c)
    target = rng.standard_normal((n, d)).astype(np.float32) * \
        (np.arange(n) < n - 5)[:, None]
    w = (rng.standard_normal((1, c, d)) * 0.3).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ft = torch.from_numpy(feats).to(dtype)
    tt = torch.from_numpy(target).to(dtype)
    fj = jnp.asarray(ft.float().numpy()).astype(jdtype)
    tj = jnp.asarray(tt.float().numpy()).astype(jdtype)
    ref, (gf, gw) = jax.value_and_grad(jd.cosine_head_loss, (0, 1))(
        fj, jnp.asarray(w), tj, jnp.asarray(mask))
    f = ft.clone().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = D.cosine_head_loss(f, wt, tt, torch.from_numpy(mask))
    loss.backward()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(loss.item(), float(ref), rtol=tol)
    gf = np.asarray(gf, np.float32)
    np.testing.assert_allclose(f.grad.float().numpy(), gf, rtol=0,
                               atol=tol * np.abs(gf).max())
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=0,
                               atol=tol * np.abs(np.asarray(gw)).max())
    # the same function of the parameters as the loss on the head's output
    if dtype == torch.float32:
        full = D.cosine_distill_loss(ft @ wt[0], tt, torch.from_numpy(mask))
        np.testing.assert_allclose(loss.item(), full.item(), rtol=1e-5)


def test_make_optimizer_learning_rate():
    cfg = Config(base_lr=1e-4, lr_multiplier=10.0, power=0.9)
    jcfg = JaxConfig(base_lr=1e-4, lr_multiplier=10.0, power=0.9)
    model = torch.nn.Linear(2, 2)
    opt, schedule = D.make_optimizer(cfg, model, MAX_ITER)
    _, jschedule = jd.make_optimizer(jcfg, MAX_ITER)
    assert isinstance(opt, torch.optim.Adam)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0.0 and group["lr"] == schedule(0)
    assert schedule(0) == pytest.approx(1e-3)
    assert schedule(MAX_ITER) == 0.0 and schedule(MAX_ITER + 3) == 0.0
    for it in (0, 1, 5, MAX_ITER):
        assert schedule(it) == pytest.approx(float(jschedule(it)), rel=1e-5)
    # the step trains update number `it` at lr(it): step 0 at lr(0)
    step = D.make_train_step(cfg, model, opt, schedule, "cpu")
    assert step.it == 0


def test_train_utils_match_jax(tmp_path):
    from openscene_tpu.utils import train_utils as jtu
    from openscene_tpu_torch.utils import train_utils as tu
    for it in (0, 3, 99):
        assert tu.poly_learning_rate(1e-3, it, 100, 0.9) == \
            jtu.poly_learning_rate(1e-3, it, 100, 0.9)
        assert tu.step_learning_rate(1e-3, it, 30) == \
            jtu.step_learning_rate(1e-3, it, 30)
    meters = tu.AverageMeter(), jtu.AverageMeter()
    for m in meters:
        m.update(2.0, 3)
        m.update(4.0)
    assert vars(meters[0]) == vars(meters[1]) and meters[0].avg == 2.5
    writer = tu.ScalarWriter(str(tmp_path))
    writer.add_scalar("loss", 0.5, 7)
    with open(writer.path) as f:
        row = json.loads(f.read())
    assert (row["tag"], row["value"], row["step"]) == ("loss", 0.5, 7)
    state = {"epoch": 3, "model": {"w": torch.ones(2)}, "best_iou": 0.25}
    path = tu.save_checkpoint(state, False, str(tmp_path / "model"))
    assert not os.path.exists(tmp_path / "model" / "model_best.ckpt")
    tu.save_checkpoint(state, True, str(tmp_path / "model"))
    got = tu.load_checkpoint(str(tmp_path / "model" / "model_best.ckpt"))
    assert got["epoch"] == 3 and torch.equal(got["model"]["w"], torch.ones(2))
    assert path.endswith("model_last.ckpt")


# ---- batches ----

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_torch_distill")
    return build_synthetic_dataset(str(root), n_train=2, n_val=1, dim=DIM,
                                   density=300.0, num_rand_file_per_scene=1)


@pytest.fixture(scope="module")
def samples(synth):
    d3, dfeat = synth
    loader = FusedFeatureLoader(
        datapath_prefix=d3, datapath_prefix_feat=dfeat, voxel_size=0.05,
        split="train", aug=True, loop=1, seed=0)
    return [loader.get(i) for i in range(2)]


def _assert_trees_equal(a, b):
    la, lb = (jax.tree_util.tree_leaves_with_path(t) for t in (a, b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_assemble_distill_batch_identical_to_jax(samples):
    got = assemble_distill_batch(samples, DIM, rng=np.random.default_rng(3))
    ref = jax_assemble_distill_batch(samples, DIM,
                                     rng=np.random.default_rng(3),
                                     windows=False)
    assert got.feat_3d.dtype == np.float16 and got.mask.sum() > 0
    _assert_trees_equal(got._replace(geo=got.geo._replace(wplans=())),
                        ref._replace(geo=ref.geo._replace(wplans=())))
    # the shift moved the coordinates, the same way for the whole batch
    plain = assemble_distill_batch(samples, DIM, shift=False)
    n = got.num_voxels
    assert (got.geo.levels[0].coords[:n, 1:].min(0)
            > plain.geo.levels[0].coords[:n, 1:].min(0)).any()


@pytest.mark.parametrize("eval_all", [False, True])
def test_assemble_seg_batch_identical_to_jax(synth, eval_all):
    loader = Point3DLoader(datapath_prefix=synth[0], voxel_size=0.05,
                           split="val", aug=False, eval_all=eval_all, seed=1)
    sample = loader.get(0)
    got = assemble_seg_batch([sample], eval_all=eval_all)
    ref = jax_assemble_seg_batch([sample], eval_all=eval_all, windows=False)
    _assert_trees_equal(got._replace(geo=got.geo._replace(wplans=())),
                        ref._replace(geo=ref.geo._replace(wplans=())))
    assert (got.num_points > 0) == eval_all


# ---- train steps ----

@pytest.fixture(scope="module")
def batches(samples):
    """Scene 0 under three random shifts (one set of caps, so each JAX
    function compiles once).  The second batch's targets are negated: the
    cosine loss's gradient then opposes the first step's, so the second and
    third updates hang on Adam's first moment and its bias correction, not
    on the gradient's sign alone (``test_make_optimizer_learning_rate``
    holds the betas and eps themselves)."""
    out = [assemble_distill_batch(samples[:1], DIM,
                                  rng=np.random.default_rng(i))
           for i in range(3)]
    assert len({b.geo.levels[0].cap for b in out}) == 1
    out[1] = out[1]._replace(feat_3d=-out[1].feat_3d)
    return out


def _fresh_model():
    params, state = numpy_unet_trees(ARCH, 3, DIM, seed=2)
    model = MinkUNet(3, DIM, ARCH)
    model.load_state_dict(params_from_jax(params, state, ARCH))
    return params, state, model


def _run_steps(batches, compute_dtype, base_lr=1e-7):
    """Three steps of the port's and of the JAX package's train step on the
    same weights and batches; one record per step."""
    kw = dict(arch_3d=ARCH, base_lr=base_lr, lr_multiplier=10.0,
              loss_type="cosine", compute_dtype=compute_dtype, manual_seed=0)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    params, state, model = _fresh_model()
    opt, schedule = D.make_optimizer(cfg, model, MAX_ITER)
    step = D.make_train_step(cfg, model, opt, schedule, "cpu")
    jopt, _ = jd.make_optimizer(jcfg, MAX_ITER)
    jstep = jd.make_train_step(jcfg, jopt)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    jopt_state = jopt.init(jparams)
    cdt = jnp.float32 if compute_dtype == "float32" else jnp.bfloat16

    @jax.jit
    def jax_grads(p, s, b):  # the loss of make_train_step, differentiated
        def loss_fn(p_):
            out, _ = apply_unet(p_, s, jnp.asarray(b.feats).astype(cdt),
                                b.geo, arch=ARCH, train=True,
                                constant_input=True)
            return jd.cosine_distill_loss(
                out, jnp.asarray(b.feat_3d).astype(cdt), jnp.asarray(b.mask))
        return jax.grad(loss_fn)(p)

    records, lr_sum = [], 0.0
    for i, b in enumerate(batches):
        gref = flatten_tree(jax_grads(jparams, jstate, b))
        jparams, jstate, jopt_state, jloss = jstep(jparams, jstate,
                                                   jopt_state, b)
        loss = float(step(b))
        assert step.it == i + 1
        lr_sum += schedule(i)
        records.append(dict(
            loss=loss, jloss=float(jloss), gref=gref, lr_sum=lr_sum,
            grads={n: p.grad.numpy().copy()
                   for n, p in model.named_parameters()},
            params={n: p.detach().numpy().copy()
                    for n, p in model.named_parameters()},
            pref=flatten_tree(jparams), sref=flatten_tree(jstate),
            buffers={n: v.numpy().copy()
                     for n, v in model.named_buffers()}))
    return records


@pytest.fixture(scope="module")
def step_records(batches):
    cache = {}

    def get(compute_dtype):
        if compute_dtype not in cache:
            cache[compute_dtype] = _run_steps(batches, compute_dtype)
        return cache[compute_dtype]
    return get


def _rel_l2_all(a, b):
    num = sum(np.linalg.norm(a[n] - b[n]) ** 2 for n in b)
    return (num / sum(np.linalg.norm(b[n]) ** 2 for n in b)) ** 0.5


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_steps_match_jax(step_records, compute_dtype, n_steps):
    fp32 = compute_dtype == "float32"
    records = step_records(compute_dtype)[:n_steps]
    for i, r in enumerate(records):
        np.testing.assert_allclose(r["loss"], r["jloss"],
                                   rtol=1e-5 if fp32 else 1e-3)
        grads, gref = r["grads"], r["gref"]
        assert set(grads) == set(gref)
        if fp32:
            each = {n: np.linalg.norm(grads[n] - g) / np.linalg.norm(g)
                    for n, g in gref.items()}
            assert _rel_l2_all(grads, gref) <= 1e-2
            assert max(each.values()) <= 5e-2, max(each, key=each.get)
            if i == 0:
                assert np.median(list(each.values())) <= 1e-4
        else:
            # the JAX fp32 gradients of the same step: the bf16 yardstick
            yard = step_records("float32")[i]["gref"]
            ours, theirs = _rel_l2_all(grads, yard), _rel_l2_all(gref, yard)
            assert ours <= 1.25 * theirs + 0.01, (ours, theirs)
            for n, y in yard.items():
                ours = np.linalg.norm(grads[n] - y) / np.linalg.norm(y)
                theirs = np.linalg.norm(gref[n] - y) / np.linalg.norm(y)
                assert ours <= 3 * theirs + 0.05, (n, ours, theirs)

        lr_sum, total, count = r["lr_sum"], 0.0, 0
        for n, p in r["params"].items():
            diff = np.abs(p - r["pref"][n])
            total, count = total + diff.sum(), count + diff.size
            assert diff.max() <= (2 if fp32 else 2.5) * lr_sum, n
            if fp32:
                resolved = np.ones(diff.shape, bool)
                for past in records[:i + 1]:
                    g = np.abs(past["gref"][n])
                    resolved &= g >= (1e-3 if i == 0 else 0.1) * g.max()
                assert diff[resolved].max() <= 0.25 * lr_sum, n
            else:
                assert diff.mean() <= 0.6 * lr_sum, n
        assert total / count <= (5e-3 if fp32 else 0.25) * lr_sum
        assert set(r["buffers"]) == set(r["sref"])
        for n, v in r["sref"].items():
            np.testing.assert_allclose(
                r["buffers"][n], v, err_msg=n, rtol=1e-4 if fp32 else 0,
                atol=1e-6 if fp32 else 2.0 ** -7 * np.abs(v).max())
    for w in (stencil_conv_fwd, stencil_conv_bwd, down_conv_fwd,
              down_conv_bwd, up_conv_bwd):
        assert w.launches == 0


def test_memory_efficient_loss_step_matches_plain_loss(batches):
    """``memory_efficient_loss`` trains on the same loss: one fp32 step with
    and without it gives the same loss and gradients (1e-4 of each scale)."""
    got = {}
    for flag in (False, True):
        cfg = Config(arch_3d=ARCH, compute_dtype="float32", base_lr=1e-6,
                     memory_efficient_loss=flag)
        _, _, model = _fresh_model()
        opt, schedule = D.make_optimizer(cfg, model, MAX_ITER)
        loss = float(D.make_train_step(cfg, model, opt, schedule, "cpu")(
            batches[0]))
        got[flag] = loss, {n: p.grad.numpy()
                           for n, p in model.named_parameters()}
    np.testing.assert_allclose(got[True][0], got[False][0], rtol=1e-5)
    for n, g in got[False][1].items():
        np.testing.assert_allclose(got[True][1][n], g, rtol=0, err_msg=n,
                                   atol=1e-4 * np.abs(g).max())


# ---- the trainer ----

def _trainer_cfg(synth, save_path, **kw):
    d3, dfeat = synth
    base = dict(data_root=d3, data_root_2d_fused_feature=dfeat,
                feature_2d_extractor="openseg", voxel_size=0.05,
                arch_3d=ARCH, batch_size=1, loop=1, epochs=2, workers=1,
                base_lr=1e-3, loss_type="cosine", aug=True, manual_seed=0,
                evaluate=True, eval_freq=1, save_freq=1, print_freq=1,
                save_path=str(save_path), use_shm=True,
                allow_pseudo_text=True, text_embedding_cache="")
    base.update(kw)
    return Config(**base)


@pytest.fixture
def head32(monkeypatch):
    """A 32-d head to match the synthetic features, wherever the port asks
    for the extractor's width."""
    from openscene_tpu_torch import text
    from openscene_tpu_torch.models import disnet
    from openscene_tpu_torch.runtime import evaluate
    for mod in (D, disnet, evaluate):
        monkeypatch.setattr(mod, "output_dim", lambda _: DIM)
    monkeypatch.setattr(text, "clip_model_for_extractor",
                        lambda _: ("pseudo", DIM))


def test_trainer_trains_validates_checkpoints_and_resumes(synth, tmp_path,
                                                          head32):
    cfg = _trainer_cfg(synth, tmp_path)
    # fit() from the seeded init: two epochs, validation after each
    tr = D.DistillTrainer(cfg, device="cpu")
    assert tr.batches_per_epoch == 2 and tr.max_iter == 4
    init = {k: v.clone() for k, v in tr.model.state_dict().items()}
    again = D.DistillTrainer(cfg, device="cpu").model.state_dict()
    assert all(torch.equal(v, init[k]) for k, v in again.items())
    best = tr.fit()
    assert tr.global_step == 4 and 0.0 <= best <= 1.0
    with open(join(str(tmp_path), "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    scalars = {(r["tag"], r["step"]): r["value"] for r in rows}
    assert scalars["loss_train", 2] < scalars["loss_train", 1]
    for tag in ("loss_val", "mIoU_val", "mAcc_val", "allAcc_val"):
        assert np.isfinite([scalars[tag, 1], scalars[tag, 2]]).all()
    assert any(not torch.equal(v, init[k])
               for k, v in tr.model.state_dict().items())

    # last and best checkpoints
    last = join(str(tmp_path), "model", "model_last.ckpt")
    assert os.path.exists(last) and os.path.exists(
        join(str(tmp_path), "model", "model_best.ckpt"))
    payload = torch.load(last, weights_only=False)
    assert set(payload) == {"epoch", "model", "optimizer", "best_iou"}
    assert payload["epoch"] == 2 and payload["best_iou"] == best

    # resume restores parameters, buffers, optimizer state and epoch
    rs = D.DistillTrainer(_trainer_cfg(synth, tmp_path, resume=last,
                                       epochs=3), device="cpu")
    assert rs.start_epoch == 2 and rs.global_step == 4
    assert rs.best_iou == best
    for k, v in rs.model.state_dict().items():
        assert torch.equal(v, tr.model.state_dict()[k]), k
    old, new = tr.optimizer.state_dict(), rs.optimizer.state_dict()
    assert old["state"].keys() == new["state"].keys() and old["state"]
    for i, st in old["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(torch.as_tensor(st[key]),
                               torch.as_tensor(new["state"][i][key]))
    assert rs.fit() >= best  # trains the third epoch only
    assert torch.load(last, weights_only=False)["epoch"] == 3

    # the trainer's checkpoint loads through the evaluator's loader
    from openscene_tpu_torch.runtime.evaluate import load_model_for_eval
    ecfg = _trainer_cfg(synth, tmp_path, model_path=last,
                        feature_type="distill")
    model = load_model_for_eval(ecfg, "cpu")
    assert not model.training
    for k, v in rs.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_main_runs_one_epoch_on_cpu(synth, tmp_path, head32):
    d3, dfeat = synth
    best = D.main(["--device", "cpu", "data_root", d3,
                   "data_root_2d_fused_feature", dfeat, "voxel_size", "0.05",
                   "arch_3d", ARCH, "batch_size", "2", "loop", "1", "epochs",
                   "1", "workers", "2", "manual_seed", "0",
                   "allow_pseudo_text", "True", "text_embedding_cache", "",
                   "save_path", str(tmp_path / "exp")])
    assert 0.0 <= best <= 1.0
    assert os.path.exists(tmp_path / "exp" / "model" / "model_last.ckpt")


@pytest.mark.parametrize("kw,error,match", [
    (dict(data_parallel=2), RuntimeError, "torchrun.*main"),
    (dict(model_parallel=5), ValueError, "must divide the distill head's "
     "D=768"),
    (dict(device_geometry="on", data_parallel=2), RuntimeError,
     "torchrun.*main"),
], ids=["kw0-multi-GPU", "kw1-multi-GPU", "kw2-multi-GPU"])
def test_trainer_refuses_what_is_not_ported(kw, error, match):
    """Multi-GPU training without the process group it asks for raises and
    names the ways to start one (torchrun, or ``main``, which starts the
    ranks); a model axis that does not divide the head's D raises."""
    with pytest.raises(error, match=match):
        D.DistillTrainer(Config(**kw), device="cpu")
