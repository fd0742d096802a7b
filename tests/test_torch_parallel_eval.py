"""The port's multi-GPU seg train step, validation, both evaluators and the
distill CLI at ``data=2``, in gloo process groups of CPU processes
(``parallel/launch.py:spawn``, a file store under a fresh temporary
directory, a timeout on every run), against the port's one-process runs and
the JAX package's sharded functions.  The rank runs start in the background
while the JAX references compile.

* Seg train step (``make_seg_train_step(mesh=data 2)`` of the JAX package on
  its stacked sub-batches of ``tests/test_parallel.py``'s two scenes,
  rebuilt by the port on its own tighter caps, MinkUNet14A, 20 classes,
  fp32, SGD at ``lr(0) = 1e-4``): ``tests/test_torch_seg.py``'s gates, loss
  ``rtol=1e-5``, the parameters within ``1e-2`` of the update in L2 over all
  parameters, BatchNorm buffers ``rtol=1e-4, atol=1e-6``, histograms equal
  to the JAX step's; the loss the mean and the histograms the sums of the
  port's one-process steps on the two batches.  Parameters and buffers
  bit-identical on both ranks.
* Validation (``DistillTrainer.validate``, ``SegTrainer.validate``) and both
  evaluators (``ZeroShotEvaluator`` in distill mode with geometry built on
  the device's code path, 2 repeats, and in fusion mode; ``evaluate_seg``
  with host geometry) over 3 val scenes, so the last round leaves
  rank 1 without a scene: every result equal to the port's one-process
  run's exactly, on every rank; the level caps of every scene's device
  geometry equal to the one-process run's (shared over each round); the
  mIoU within ``1e-3`` of the JAX package's sharded evaluators
  (``data_parallel 2``), the tolerance of ``tests/test_torch_evaluate.py``
  and ``tests/test_torch_seg.py``.
* ``distill.main`` with ``data_parallel 2`` on the CPU starts its two ranks
  itself, trains one epoch, validates and writes one checkpoint (rank 0)
  that the one-process evaluator reads: the counterpart of
  ``test_cli_data_parallel_training`` at two ranks.
"""

import functools
import json
from concurrent.futures import ThreadPoolExecutor
from os.path import join

import numpy as np
import pytest
import torch
import torch.distributed as dist

from openscene_tpu_torch.config import Config
from openscene_tpu_torch.data.batch import assemble_seg_batch
from openscene_tpu_torch.data.loaders import Point3DLoader
from openscene_tpu_torch.models import MinkUNet
from openscene_tpu_torch.parallel import launch
from openscene_tpu_torch.parallel.mesh import get_mesh
from openscene_tpu_torch.runtime import distill as D
from openscene_tpu_torch.runtime import eval_seg as E
from openscene_tpu_torch.runtime import train_seg as S
from openscene_tpu_torch.runtime.evaluate import (SceneGeometry,
                                                  ZeroShotEvaluator)
from openscene_tpu_torch.sparse.geometry import (GeometryCaps, _bucket,
                                                 level_counts)

ARCH = "MinkUNet14A"
DIM = 32
CLASSES = 20
TIMEOUT = 240  # seconds for one spawned run of ranks


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch in the test process, as on the ranks (which
    set their own), so that one-process and rank results compare bit for
    bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- what runs on each rank, and on one process (top level: the ranks
# import this module) ----

def _seg_cfg(**kw):
    return Config(**{"arch_3d": ARCH, "classes": CLASSES, "base_lr": 1e-4,
                     "momentum": 0.9, "weight_decay": 1e-4, "power": 0.9,
                     "compute_dtype": "float32", **kw})


def _seg_step(state_dict, batch, mesh):
    cfg = _seg_cfg()
    model = MinkUNet(3, CLASSES, ARCH)
    model.load_state_dict(state_dict)
    opt, schedule = S.make_seg_optimizer(cfg, model, max_iter=10)
    step = S.make_seg_train_step(cfg, model, opt, schedule, "cpu",
                                 mesh=mesh)
    loss, *hist = step(batch)
    return dict(loss=float(loss), hist=[h.numpy() for h in hist],
                params={n: p.detach().numpy().copy()
                        for n, p in model.named_parameters()},
                buffers={n: v.numpy().copy()
                         for n, v in model.named_buffers()})


def _recording(geometry: SceneGeometry, log: list):
    """Record the level caps of every device-geometry build."""
    build = geometry.build

    def record(coords, num, caps):
        log.append(tuple(caps))
        return build(coords, num, caps)
    geometry.build = record


def _evaluations(env, mesh):
    """Validation and the evaluators on this process (``mesh`` None: one
    process): their results and the caps of the device-geometry builds."""
    from types import SimpleNamespace
    d3, dfeat = env["data"]
    dev = torch.device("cpu")
    out, caps = {}, {}
    seg_model = MinkUNet(3, CLASSES, ARCH)
    seg_model.load_state_dict(env["seg_state"])
    model = MinkUNet(3, DIM, ARCH)
    model.load_state_dict(env["state"])
    text = torch.from_numpy(env["text"])
    n_dp, d = (1, 0) if mesh is None else (mesh.data, mesh.data_index)
    val = Point3DLoader(datapath_prefix=d3, voxel_size=0.1, split="val",
                        aug=False, eval_all=True, seed=1)
    cfg = Config(classes=CLASSES, compute_dtype="float32", arch_3d=ARCH)
    trainer = SimpleNamespace(cfg=cfg, model=model.eval(), text=text,
                              val_data=val, data_index=d, n_dp=n_dp,
                              mesh=mesh, device=dev,
                              val_step=D.make_val_step(cfg, mesh))
    out["distill validate"] = D.DistillTrainer.validate(trainer)
    seg_trainer = SimpleNamespace(
        cfg=_seg_cfg(data_root=d3, voxel_size=0.1, device_geometry="on"),
        model=seg_model, device=dev, mesh=mesh, val_data=val, n_dp=n_dp,
        train_data=SimpleNamespace(dataset_name="scannet_3d"))
    out["seg validate"] = S.SegTrainer.validate(seg_trainer)
    dp = 2 if mesh is not None else -1
    for mode, dg in (("distill", "on"), ("fusion", "auto")):
        ecfg = Config(data_root=d3, data_root_2d_fused_feature=dfeat,
                      feature_2d_extractor="openseg", voxel_size=0.1,
                      split="val", feature_type=mode, test_repeats=2,
                      test_workers=2, manual_seed=0, arch_3d=ARCH,
                      compute_dtype="float32", device_geometry=dg,
                      data_parallel=dp)
        ev = ZeroShotEvaluator(ecfg, model if mode != "fusion" else None,
                               text_features=env["text"], device="cpu")
        caps[mode] = []
        _recording(ev.geometry, caps[mode])
        out[f"eval {mode}"] = ev.run()
    scfg = _seg_cfg(data_root=d3, voxel_size=0.1, split="val",
                    test_repeats=1, manual_seed=0, save_folder="",
                    data_parallel=dp)
    out["eval_seg"] = E.evaluate_seg(scfg, seg_model, device="cpu")
    return out, caps


def _eval_ranks(env):
    """On two ranks: the data=2 seg step, then the evaluations."""
    torch.set_num_threads(1)
    mesh = get_mesh(2, 1, "cpu")
    seg = _seg_step(env["seg_state"], env["seg_batches"][mesh.data_index],
                    mesh)
    evals, caps = _evaluations(env, mesh)
    parts = [None] * 2
    dist.all_gather_object(parts, (evals, caps,
                                   {k: seg[k] for k in ("loss", "hist")}))
    return seg, parts, _same_on_both_ranks(seg)


def _same_on_both_ranks(seg) -> bool:
    """Whether both ranks hold bit-identical parameters and buffers."""
    flat = torch.cat([torch.from_numpy(v).reshape(-1) for k in (
        "params", "buffers") for v in seg[k].values()])
    other = flat.clone()
    dist.broadcast(other, src=0)
    same = torch.tensor([int(torch.equal(flat, other))])
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


# ---- the parent ----

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from openscene_tpu.data.sharded import assemble_sharded_seg_batches
    from openscene_tpu.data.synthetic import (build_synthetic_dataset,
                                              class_prototypes)
    from openscene_tpu_torch.convert import params_from_jax
    from tests.test_torch_unet import numpy_unet_trees

    from __graft_entry__ import _synthetic_batch
    per_dev = [_synthetic_batch(n_points=3000, dim=DIM, seed=5 + d,
                                voxel=0.1, rng=np.random.default_rng(d))
               for d in range(2)]
    jbatches, _ = assemble_sharded_seg_batches(
        per_dev, rng=np.random.default_rng(1))
    counts = np.max([level_counts(np.asarray(jbatches.geo.levels[0].coords
                                             )[d][:int(n)])
                     for d, n in enumerate(np.asarray(jbatches.num_voxels))],
                    axis=0)
    fixed = tuple(_bucket(int(c * 1.06) + 32, min_bucket=512)
                  for c in counts)
    rng = np.random.default_rng(1)
    seg_batches = [assemble_seg_batch(
        s, caps=GeometryCaps(cap0=fixed[0], fixed=fixed), rng=rng,
        shift=True) for s in per_dev]
    for d, b in enumerate(seg_batches):  # the JAX package's sub-batches
        n = b.num_voxels
        assert n == int(np.asarray(jbatches.num_voxels)[d])
        for name in ("feats", "labels"):
            np.testing.assert_array_equal(
                getattr(b, name)[:n], np.asarray(getattr(jbatches, name))[d]
                [:n])
    root = tmp_path_factory.mktemp("parallel_eval")
    data = build_synthetic_dataset(str(root / "d32"), n_train=0, n_val=3,
                                   dim=DIM, density=150.0, all_classes=True)
    seg_params, seg_state = numpy_unet_trees(ARCH, 3, CLASSES, seed=5)
    params, state = numpy_unet_trees(ARCH, 3, DIM, seed=0)
    return dict(
        data=data, text=class_prototypes(CLASSES, DIM),
        jbatches=jbatches, seg_batches=seg_batches,
        seg_tree=(seg_params, seg_state), tree=(params, state),
        seg_state=params_from_jax(seg_params, seg_state, ARCH),
        state=params_from_jax(params, state, ARCH), root=root)


def _cli(root):
    """``distill.main`` with data_parallel 2 on the CPU (its ranks under the
    test's timeout)."""
    from openscene_tpu.data.synthetic import build_synthetic_dataset
    d3, dfeat = build_synthetic_dataset(str(root / "d768"), n_train=2,
                                        n_val=1, dim=768, density=80.0,
                                        num_rand_file_per_scene=1)
    args = ["--device", "cpu", "data_root", d3,
            "data_root_2d_fused_feature", dfeat,
            "feature_2d_extractor", "openseg", "voxel_size", "0.1",
            "arch_3d", ARCH, "batch_size", "2", "loop", "1", "epochs", "1",
            "workers", "1", "evaluate", "True", "eval_freq", "1",
            "save_freq", "1", "print_freq", "1", "manual_seed", "0",
            "data_parallel", "2", "allow_pseudo_text", "True",
            "text_embedding_cache", "", "save_path", str(root / "exp")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(launch, "spawn",
                   functools.partial(launch.spawn, timeout=TIMEOUT))
        mp.setenv("OMP_NUM_THREADS", "1")  # the ranks share the host
        best = D.main(args)
    return best, d3, dfeat, str(root / "exp")


@pytest.fixture(scope="module")
def runs(env):
    """The two-rank runs (the rank functions, and ``distill.main``'s own
    ranks) and the one-process evaluations, started together in the
    background while the JAX references compile."""
    rank_env = {k: env[k] for k in ("data", "text", "seg_batches",
                                    "seg_state", "state")}
    with ThreadPoolExecutor(3) as pool:
        yield {"ranks": pool.submit(launch.spawn, _eval_ranks, 2, rank_env,
                                    device="cpu", timeout=TIMEOUT),
               "cli": pool.submit(_cli, env["root"]),
               "one process": pool.submit(_evaluations, env, None)}


def test_seg_step_data_parallel_matches_jax_sharded_step(env, runs):
    import jax
    import jax.numpy as jnp
    from openscene_tpu.config import Config as JaxConfig
    from openscene_tpu.parallel.mesh import (get_mesh as jax_mesh,
                                             replicate, shard_batch)
    from openscene_tpu.runtime import train_seg as js
    from openscene_tpu_torch.convert import flatten_tree

    kw = dict(arch_3d=ARCH, classes=CLASSES, base_lr=1e-4, momentum=0.9,
              weight_decay=1e-4, power=0.9, compute_dtype="float32")
    jcfg = JaxConfig(**kw)
    mesh = jax_mesh(data=2, model=1, devices=jax.devices()[:2])
    jopt, _ = js.make_seg_optimizer(jcfg, max_iter=10)
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    p, s = (tree(t) for t in env["seg_tree"])
    step = js.make_seg_train_step(jcfg, jopt, mesh=mesh)
    jp, js_, _, jloss, ji, ju, jt = step(
        replicate(mesh, p), replicate(mesh, s),
        replicate(mesh, jopt.init(p)), shard_batch(mesh, env["jbatches"]))
    one = [_seg_step(env["seg_state"], b, None) for b in env["seg_batches"]]
    seg, parts, same = runs["ranks"].result()
    assert same  # parameters and buffers bit-identical on both ranks
    assert parts[0][2]["loss"] == parts[1][2]["loss"] == seg["loss"]

    np.testing.assert_allclose(seg["loss"], float(jloss), rtol=1e-5)
    np.testing.assert_allclose(seg["loss"], np.mean([o["loss"] for o in one]),
                               rtol=1e-6)
    for h, jh, a, b in zip(seg["hist"], (ji, ju, jt), one[0]["hist"],
                           one[1]["hist"]):
        np.testing.assert_array_equal(h, np.asarray(jh))
        np.testing.assert_array_equal(h, a + b)
    pref, before = flatten_tree(jp), flatten_tree(env["seg_tree"][0])
    assert set(seg["params"]) == set(pref)
    diff = sum(np.linalg.norm(seg["params"][n] - v) ** 2
               for n, v in pref.items())
    moved = sum(np.linalg.norm(v - before[n]) ** 2 for n, v in pref.items())
    assert (diff / moved) ** 0.5 <= 1e-2
    for n, v in flatten_tree(js_).items():
        np.testing.assert_allclose(seg["buffers"][n], v, rtol=1e-4, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("what", ["distill validate", "seg validate",
                                  "eval distill", "eval fusion", "eval_seg"])
def test_validation_and_evaluators_equal_one_process(runs, what):
    ref, ref_caps = runs["one process"].result()
    _, parts, _ = runs["ranks"].result()
    for evals, caps, _ in parts:  # every rank returns the results
        got = evals[what]
        if what == "distill validate":  # the loss sums in another order
            np.testing.assert_allclose(got[0], ref[what][0], rtol=1e-12)
            got = (ref[what][0],) + tuple(got[1:])
        assert got == ref[what], (what, got, ref[what])
    if what == "eval distill":
        # the device-geometry caps of every scene, shared over each round
        # (2 repeats of 3 scenes: rank 0 builds 4, rank 1 2)
        built = parts[0][1]["distill"] + parts[1][1]["distill"]
        assert len(ref_caps["distill"]) == 6
        assert sorted(built) == sorted(ref_caps["distill"])
        assert [ref_caps["distill"][i] for i in (0, 2, 3, 5)] == \
            parts[0][1]["distill"]


@pytest.mark.parametrize("which", ["evaluate", "eval_seg"])
def test_evaluators_match_jax_sharded_evaluators(env, runs, which):
    from openscene_tpu.config import Config as JaxConfig
    from openscene_tpu.runtime.eval_seg import evaluate_seg
    from openscene_tpu.runtime.evaluate import \
        ZeroShotEvaluator as JaxZeroShotEvaluator
    d3, dfeat = env["data"]
    _, parts, _ = runs["ranks"].result()
    if which == "evaluate":
        params, state = env["tree"]
        jcfg = JaxConfig(data_root=d3, data_root_2d_fused_feature=dfeat,
                         feature_2d_extractor="openseg", voxel_size=0.1,
                         split="val", feature_type="distill", test_repeats=2,
                         test_workers=2, manual_seed=0, arch_3d=ARCH,
                         compute_dtype="float32", data_parallel=2)
        jev = JaxZeroShotEvaluator(jcfg, params, state,
                                   text_features=env["text"])
        assert jev.mesh is not None
        ref, got = jev.run(), parts[0][0]["eval distill"]
    else:
        params, state = env["seg_tree"]
        jcfg = JaxConfig(data_root=d3, voxel_size=0.1, split="val",
                         arch_3d=ARCH, classes=CLASSES, test_repeats=1,
                         manual_seed=0, save_folder="",
                         compute_dtype="float32", data_parallel=2)
        ref, got = evaluate_seg(jcfg, params, state), parts[0][0]["eval_seg"]
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-3, (k, got[k], ref[k])


def test_cli_data_parallel_training(runs):
    from openscene_tpu_torch.runtime.evaluate import load_model_for_eval
    best, d3, dfeat, exp = runs["cli"].result()
    assert np.isfinite(best) and 0.0 <= best <= 1.0
    last = join(exp, "model", "model_last.ckpt")
    payload = torch.load(last, weights_only=False)
    assert payload["epoch"] == 1 and payload["best_iou"] == best
    assert payload["model"]["final"].shape == (1, 96, 768)
    with open(join(exp, "scalars.jsonl")) as f:
        tags = [json.loads(line)["tag"] for line in f]
    assert tags.count("loss_train") == 1 and tags.count("mIoU_val") == 1
    cfg = Config(data_root=d3, data_root_2d_fused_feature=dfeat,
                 feature_2d_extractor="openseg", voxel_size=0.1,
                 split="val", feature_type="distill", test_repeats=1,
                 test_workers=1, arch_3d=ARCH, model_path=last,
                 allow_pseudo_text=True, text_embedding_cache="")
    model = load_model_for_eval(cfg, "cpu")
    for k, v in payload["model"].items():
        assert torch.equal(model.state_dict()[k], v), k
    res = ZeroShotEvaluator(cfg, model, device="cpu").run()
    assert 0.0 <= res["miou"] <= 1.0
