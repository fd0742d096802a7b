"""The port's reader of the JAX package's flax-msgpack checkpoints
(``utils/flax_msgpack.py``, ``utils/train_utils.py:load_flax_checkpoint``,
``convert.optimizer_state_from_optax``), on the CPU.

The JAX package's ``save_checkpoint`` writes a distillation payload (Adam)
and a segmentation payload (SGD with momentum and weight decay), each after
one JAX train step, so that every optimizer moment is nonzero.

* Every array of the port's reading equals flax's ``msgpack_restore`` bit
  for bit, dtype included, also with ``flax.serialization.MAX_CHUNK_SIZE``
  set small (chunked arrays), and for np scalars (ExtType 3), bfloat16
  arrays and the plain msgpack types.
* ``load_model_for_eval`` on the distillation file gives the port's model
  exactly ``params_from_jax`` of the file's trees, and the JAX forward's
  logits (fp32, ``rtol=1e-4``, ``atol=1e-4`` of the scale:
  summation order only).
* ``DistillTrainer`` and ``SegTrainer`` resume from the files: weights,
  optimizer state, step count, epoch and best mIoU as written.  The port's
  next fp32 step from the file's state lands where the JAX package's next
  step does: Adam within ``test_torch_distill.py``'s fp32 parameter gates
  (every element ``2 * lr``, the mean ``5e-3 * lr``), SGD within ``1e-2``
  of the step's update in L2, as ``test_torch_seg.py`` holds it; and a
  fresh optimizer state misses by far more, so the moments matter.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openscene_tpu.runtime.distill as jd
import openscene_tpu.runtime.train_seg as js
from openscene_tpu.config import Config as JaxConfig
from openscene_tpu.data.batch import \
    assemble_seg_batch as jax_assemble_seg_batch
from openscene_tpu.models import apply_unet
from openscene_tpu.utils.train_utils import save_checkpoint
from openscene_tpu_torch.config import Config
from openscene_tpu_torch.convert import (flatten_tree,
                                         optimizer_state_from_optax,
                                         params_from_jax)
from openscene_tpu_torch.data.batch import assemble_seg_batch
from openscene_tpu_torch.models import MinkUNet
from openscene_tpu_torch.runtime import distill as D
from openscene_tpu_torch.runtime import train_seg as S
from openscene_tpu_torch.runtime.evaluate import load_model_for_eval
from openscene_tpu_torch.sparse.geometry import (build_unet_geometry,
                                                 geometry_to_device)
from openscene_tpu_torch.utils import flax_msgpack
from openscene_tpu_torch.utils.train_utils import (load_flax_checkpoint,
                                                   read_checkpoint)
from tests.test_torch_distill import (ARCH, DIM, _trainer_cfg,  # noqa: F401
                                      batches, head32, samples, synth)
from tests.test_torch_unet import (_one_thread, _surface_coords,  # noqa: F401
                                   numpy_unet_trees)

CLASSES = 20
MAX_ITER = 10


def _jax_run(kind, port_batches, jax_batches, tmp_path):
    """One JAX step from seeded weights, the checkpoint after it, and the
    JAX package's next step.  Returns (path, params after the next step,
    the trees saved, the configs)."""
    kw = dict(arch_3d=ARCH, compute_dtype="float32", manual_seed=0)
    if kind == "adam":
        kw.update(base_lr=1e-7, lr_multiplier=10.0, loss_type="cosine")
        cfg, jcfg = Config(**kw), JaxConfig(**kw)
        params, state = numpy_unet_trees(ARCH, 3, DIM, seed=2)
        jopt, _ = jd.make_optimizer(jcfg, MAX_ITER)
        jstep = jd.make_train_step(jcfg, jopt)
    else:
        kw.update(base_lr=1e-4, momentum=0.9, weight_decay=1e-4,
                  classes=CLASSES)
        cfg, jcfg = Config(**kw), JaxConfig(**kw)
        params, state = numpy_unet_trees(ARCH, 3, CLASSES, seed=5)
        jopt, _ = js.make_seg_optimizer(jcfg, MAX_ITER)
        jstep = js.make_seg_train_step(jcfg, jopt)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s = jax.tree_util.tree_map(jnp.asarray, state)
    o = jopt.init(p)
    p, s, o, *_ = jstep(p, s, o, jax_batches[0])
    saved = {"epoch": 1, "params": p, "state": s, "opt_state": o,
             "best_iou": 0.25}
    saved = jax.tree_util.tree_map(np.array, saved)  # before donation
    path = save_checkpoint(saved, False, str(tmp_path / kind))
    p2, *_ = jstep(p, s, o, jax_batches[1])
    return path, flatten_tree(p2), saved, cfg


@pytest.fixture(scope="module")
def runs(batches, samples, tmp_path_factory):
    """The Adam (distillation) and SGD (segmentation) JAX runs."""
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    seg_port = [assemble_seg_batch(samples, rng=np.random.default_rng(i),
                                   shift=True) for i in range(2)]
    seg_jax = [jax_assemble_seg_batch(samples, rng=np.random.default_rng(i),
                                      shift=True, windows=False)
               for i in range(2)]
    return {"adam": (_jax_run("adam", batches, batches, tmp), batches),
            "sgd": (_jax_run("sgd", seg_port, seg_jax, tmp), seg_port)}


def _assert_same_arrays(got, ref):
    got, ref = flatten_tree(got), flatten_tree(ref)
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name]
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_reader_gives_flax_arrays_bit_for_bit(runs, kind):
    (path, _, saved, _), _ = runs[kind]
    with open(path, "rb") as f:
        ref = flax.serialization.msgpack_restore(f.read())
    got = load_flax_checkpoint(path)
    assert set(got) == {"epoch", "params", "state", "opt_state", "best_iou"}
    assert isinstance(got["params"]["block1"], list)   # lists rebuilt
    _assert_same_arrays(got, ref)
    payload, is_flax = read_checkpoint(path)
    assert is_flax and int(payload["epoch"]) == 1
    assert float(payload["best_iou"]) == 0.25


def test_chunked_arrays(monkeypatch, tmp_path):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((7, 5)).astype(np.float32),
            "i": np.arange(40, dtype=np.int64).reshape(2, 4, 5),
            "small": np.float32([1.5, 2.5]), "epoch": 3}
    path = save_checkpoint(tree, False, str(tmp_path))
    with open(path, "rb") as f:
        data = f.read()
    assert flax_msgpack.CHUNKED.encode() in data
    ref = flax.serialization.msgpack_restore(data)
    got = load_flax_checkpoint(path)
    _assert_same_arrays(got, ref)
    np.testing.assert_array_equal(got["w"], tree["w"])


def test_scalars_bf16_and_plain_types():
    tree = {"f32": np.float32(1.5), "i64": np.int64(-3),
            "u8": np.uint8(200), "bf16": jnp.asarray([1.0, -2.5, 3.0e38],
                                                      jnp.bfloat16),
            "f16": np.float16([0.5, 65504.0]), "none": None, "t": True,
            "f": False, "x": 2.5, "neg": -7, "big": 2 ** 40,
            "nbig": -(2 ** 35), "s": "chair", "b": b"\x00\x01",
            "long": "x" * 300, "nested": {"0": np.zeros(3, np.int32),
                                          "1": np.ones((0, 2))}}
    data = flax.serialization.msgpack_serialize(tree)
    got = flax_msgpack.loads(data)
    ref = flax.serialization.msgpack_restore(data)
    for k in ("f32", "i64", "u8"):
        assert type(got[k]) is type(ref[k]) and got[k] == ref[k]
    np.testing.assert_array_equal(got["bf16"],
                                  np.asarray(ref["bf16"], np.float32))
    assert got["bf16"].dtype == np.float32
    for k in ("none", "t", "f", "x", "neg", "big", "nbig", "s", "b", "long"):
        assert got[k] == ref[k] and type(got[k]) is type(ref[k]), k
    _assert_same_arrays(got["nested"], ref["nested"])
    assert flax_msgpack.rebuild_lists(got)["nested"][0].dtype == np.int32


def test_broken_files_raise(tmp_path):
    good = flax.serialization.msgpack_serialize({"a": np.ones(3)})
    for name, data in (("cut", good[:-5]), ("tail", good + b"\x00")):
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match="msgpack"):
            read_checkpoint(str(path))
    with pytest.raises(ValueError, match="ExtType 5"):
        flax_msgpack.loads(b"\x81\xa1a\xd4\x05\x00")
    torch.save({"model": {}}, tmp_path / "own.ckpt")
    payload, is_flax = read_checkpoint(str(tmp_path / "own.ckpt"))
    assert not is_flax and payload == {"model": {}}


def test_load_model_for_eval_gives_jax_forward(tmp_path):
    params, state = numpy_unet_trees(ARCH, 3, 512, seed=3)
    path = save_checkpoint({"epoch": 2, "params": params, "state": state,
                            "best_iou": 0.5}, False, str(tmp_path))
    cfg = Config(feature_type="distill", feature_2d_extractor="lseg",
                 arch_3d=ARCH, model_path=path)
    model = load_model_for_eval(cfg, "cpu")
    want = params_from_jax(params, state, ARCH)
    got = model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

    coords = _surface_coords(4)
    geo = build_unet_geometry(coords)
    n = len(coords)
    x = (np.arange(geo.levels[0].cap)[:, None] < n).astype(np.float32) * \
        np.ones((1, 3), np.float32)
    ref, _ = jax.jit(lambda p, s, xx: apply_unet(
        p, s, xx, geo, arch=ARCH, train=False, constant_input=True))(
            params, state, jnp.asarray(x))
    ref = np.asarray(ref)
    with torch.no_grad():
        out = model(torch.from_numpy(x), geometry_to_device(geo, "cpu"),
                    constant_input=True).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref[:n]).max())


def _port_step(kind, cfg, payload, batch, fresh=False):
    """The port's next step from the checkpoint's weights and optimizer
    state (or a fresh optimizer state), as a resumed trainer takes it."""
    classes = DIM if kind == "adam" else CLASSES
    model = MinkUNet(3, classes, ARCH)
    model.load_state_dict(params_from_jax(payload["params"],
                                          payload["state"], ARCH))
    make = D.make_optimizer if kind == "adam" else S.make_seg_optimizer
    opt, schedule = make(cfg, model, MAX_ITER)
    it = optimizer_state_from_optax(opt, model, payload["opt_state"])
    assert it == 1
    if fresh:
        opt.state.clear()
    step_cls = D.TrainStep if kind == "adam" else S.SegTrainStep
    step_cls(cfg, model, opt, schedule, "cpu", it=it)(batch)
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_resumed_step_lands_on_the_jax_next_step(runs, kind):
    (path, ref, saved, cfg), port_batches = runs[kind]
    payload = load_flax_checkpoint(path)
    got = _port_step(kind, cfg, payload, port_batches[1])
    fresh = _port_step(kind, cfg, payload, port_batches[1], fresh=True)
    before = flatten_tree(payload["params"])

    def dist(p):
        return sum(np.linalg.norm(p[n] - ref[n]) ** 2 for n in ref) ** 0.5

    if kind == "adam":
        lr = cfg.base_lr * cfg.lr_multiplier * (1 - 1 / MAX_ITER) ** 0.9
        diffs = [np.abs(got[n] - ref[n]) for n in ref]
        assert max(d.max() for d in diffs) <= 2 * lr
        assert (sum(d.sum() for d in diffs)
                / sum(d.size for d in diffs)) <= 5e-3 * lr
    else:
        update = sum(np.linalg.norm(ref[n] - before[n]) ** 2
                     for n in ref) ** 0.5
        assert dist(got) <= 1e-2 * update
    assert dist(fresh) > 10 * dist(got)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_trainers_resume_from_jax_checkpoints(runs, synth, tmp_path, head32,
                                              kind):
    (path, _, saved, _), _ = runs[kind]
    if kind == "adam":
        tr = D.DistillTrainer(_trainer_cfg(synth, tmp_path, resume=path,
                                           evaluate=False), device="cpu")
    else:
        tr = S.SegTrainer(Config(data_root=synth[0], voxel_size=0.05,
                                 arch_3d=ARCH, classes=CLASSES,
                                 batch_size=1, evaluate=False,
                                 save_path=str(tmp_path), resume=path),
                          device="cpu")
    assert tr.start_epoch == 1 and tr.best_iou == 0.25
    assert tr.global_step == 1
    want = params_from_jax(saved["params"], saved["state"], ARCH)
    assert all(torch.equal(tr.model.state_dict()[k], want[k]) for k in want)
    moments = ({"exp_avg": saved["opt_state"][0].mu,
                "exp_avg_sq": saved["opt_state"][0].nu}
               if kind == "adam"
               else {"momentum_buffer": saved["opt_state"][1][0].trace})
    for key, tree in moments.items():
        flat = flatten_tree(tree)
        for n, p in tr.model.named_parameters():
            np.testing.assert_array_equal(tr.optimizer.state[p][key].numpy(),
                                          flat[n], err_msg=f"{key} {n}")
    if kind == "adam":
        p = next(tr.model.parameters())
        assert float(tr.optimizer.state[p]["step"]) == 1.0
    tr.train_step(next(iter(tr._epoch_batches())))
    assert tr.global_step == 2
    assert os.path.isfile(path)
