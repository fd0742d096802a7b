"""The port's multi-GPU train steps against the JAX package's sharded steps,
in gloo process groups of CPU processes (``parallel/launch.py:spawn``, a
file store under a fresh temporary directory, a timeout on every run).

Inputs are those of ``tests/test_parallel.py``: two synthetic scenes of
3000 points at 10 cm (``__graft_entry__._synthetic_batch``), one a data
rank, MinkUNet14A with a 32-d head, seeded numpy weights
(``test_torch_unet.numpy_unet_trees``) carried across by ``params_from_jax``,
fp32 compute.  The ranks' batches are the JAX package's stacked sub-batches
(``assemble_sharded_distill_batches``), rebuilt by the port's
``assemble_distill_batch`` with the same rng and checked equal to them on
their valid rows.  The spawned runs start in the background while the JAX
references compile.

* Data parallel, ``data=2`` (Adam at ``lr(0) = 1e-6``): one step on host
  geometry and one on raw batches whose geometry the port's device builder
  makes on the CPU (the same coordinates: the same shift draws), both
  against ``make_train_step(mesh=data 2)`` on the host batches.
  ``tests/test_torch_distill.py``'s fp32 step tolerances: loss
  ``rtol=1e-5``; every parameter element within ``2 * lr`` of the
  reference (Adam's first step is about ``lr * sign(g)``), the mean over all
  elements within ``5e-3 * lr``, the elements whose gradient is resolved
  (``|g| >= 1e-3`` of its tensor's largest, of the ranks' averaged
  gradient: the JAX step returns none) within ``0.25 * lr``; BatchNorm
  buffers ``rtol=1e-4, atol=1e-6``.  Parameters and buffers bit-identical
  on both ranks.  The port pads the ranks' batches to its own, tighter
  caps (a third of the CPU time); padded rows change no result.
* Head sharding, ``data=2 x model=2`` (cosine and ``memory_efficient_loss``,
  four ranks) and ``data=1 x model=2`` (l1, on the two ranks after their
  data-parallel steps), SGD at ``1e-2`` as
  ``test_model_axis_head_sharding_matches_single`` takes it (Adam's
  saturated first step would hide the gradient).  Against the port's
  one-process steps (the update of the mean one-process gradient), that
  test's tolerance: every tensor's update within ``1e-3`` of the
  reference update's largest element plus two fp32 ulps of the parameter
  (the rounding of ``p + u``), BatchNorm buffers ``rtol=1e-6``.  Against
  the JAX sharded step: loss ``rtol=1e-5``, and the updates held to
  ``tests/test_torch_distill.py``'s fp32 gradient gates (all tensors
  together within ``1e-2`` relative L2, each within ``5e-2``: single ReLU
  gates open on one side and shut on the other), buffers ``rtol=1e-4``.
  The head is gathered from the shards; every rank's full parameters are
  bit-identical.  The l1 run also takes one Adam step and round-trips its
  checkpoint: the gathered head and Adam moments hold every rank's shard
  at its columns, and ``_resume`` gives each rank back exactly its shard.
* The mesh's layout against the JAX ``Mesh((4, 2))``, ``data/sharded.py``
  against the JAX package's, and the refusals of a run without the process
  group it asks for, checked without spawning.
"""

import hashlib
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from openscene_tpu_torch.config import Config
from openscene_tpu_torch.data.batch import (assemble_distill_batch,
                                            assemble_raw_distill_batch)
from openscene_tpu_torch.models import MinkUNet
from openscene_tpu_torch.parallel.launch import spawn
from openscene_tpu_torch.parallel.mesh import (gather_head, get_mesh,
                                               head_columns, mesh_for,
                                               mesh_layout, shard_head)
from openscene_tpu_torch.runtime import distill as D
from openscene_tpu_torch.runtime.geometry_route import RawTrainStep
from openscene_tpu_torch.sparse.geometry import (GeometryCaps, _bucket,
                                                 level_counts)

ARCH = "MinkUNet14A"
DIM = 32
MAX_ITER = 100
SGD_LR = 1e-2
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


# ---- what runs on each rank (top level: the ranks import this module) ----

def _digest(tree) -> str:
    """A hash of every array of a nested dict (bit-identity across ranks
    without sending the arrays)."""
    h = hashlib.sha256()
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            h.update(_digest(v).encode())
        elif isinstance(v, np.ndarray):
            h.update(k.encode() + v.tobytes())
        else:
            h.update(f"{k}={v!r}".encode())
    return h.hexdigest()


def _ranks_result(out):
    """``(rank 0's out, every rank's digest of its out)`` on rank 0."""
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, _digest(out))
    return out, digests


def _snapshot(model, mesh):
    """Full-width parameters (the head gathered) and buffers, as numpy."""
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    params["final"] = gather_head(params["final"], mesh)
    return ({n: p.numpy() for n, p in params.items()},
            {n: b.numpy().copy() for n, b in model.named_buffers()})


def _cfg(**kw):
    base = dict(arch_3d=ARCH, base_lr=1e-7, lr_multiplier=10.0,
                loss_type="cosine", compute_dtype="float32", manual_seed=0)
    base.update(kw)
    return Config(**base)


def _two_ranks(state_dict, host_batches, raw_batches, ckpt):
    """On two ranks: the data=2 Adam steps (:func:`_dp_steps`), then on a
    data=1 x model=2 mesh over the same ranks the l1 SGD step and the
    checkpoint round trip (:func:`_head_steps`)."""
    torch.set_num_threads(1)
    dp = _dp_steps(state_dict, host_batches, raw_batches)
    return dp, _head_steps(state_dict, host_batches, 1, 2, ("l1",), ckpt)


def _dp_steps(state_dict, host_batches, raw_batches):
    """One Adam step at data=2 on host geometry, one on raw batches."""
    mesh = get_mesh(2, 1, "cpu")
    d = mesh.data_index
    out = {}
    for kind in ("host", "raw"):
        cfg = _cfg()
        model = MinkUNet(3, DIM, ARCH)
        model.load_state_dict(state_dict)
        opt, schedule = D.make_optimizer(cfg, model, MAX_ITER)
        step = D.make_train_step(cfg, model, opt, schedule, "cpu",
                                 mesh=mesh)
        if kind == "host":
            loss = step(host_batches[d])
        else:
            raw, caps = raw_batches[d]
            geo, overflow = RawTrainStep(step, caps, n_scenes=1).geometry(
                raw)
            assert not overflow
            loss = step.run(geo, *step.parts(raw))
        params, buffers = _snapshot(model, mesh)
        out[kind] = dict(loss=float(loss), params=params, buffers=buffers,
                         grads={n: p.grad.numpy().copy()
                                for n, p in model.named_parameters()},
                         lr=schedule(0))
    return _ranks_result(out)


def _sgd_model(cfg, state_dict, mesh):
    """A model from ``state_dict`` (the head cut to this rank's columns)
    and its SGD train step."""
    model = MinkUNet(3, DIM, ARCH)
    model.load_state_dict(state_dict)
    shard_head(model, mesh)
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
    return model, D.make_train_step(cfg, model, opt, lambda it: SGD_LR,
                                    "cpu", mesh=mesh)


def _kind_cfg(kind):
    return _cfg(loss_type="l1" if kind == "l1" else "cosine",
                memory_efficient_loss=kind == "memory_efficient")


def _head_rank(state_dict, batches, data, model_axis, kinds):
    torch.set_num_threads(1)
    return _head_steps(state_dict, batches, data, model_axis, kinds)


def _head_steps(state_dict, batches, data, model_axis, kinds, ckpt=None):
    """SGD steps on a data x model mesh, one per loss kind; with ``ckpt``
    also an Adam step whose checkpoint rank 0 writes there and every rank
    resumes from."""
    mesh = get_mesh(data, model_axis, "cpu")
    batch = batches[mesh.data_index]
    out = {}
    for kind in kinds:
        model, step = _sgd_model(_kind_cfg(kind), state_dict, mesh)
        loss = float(step(batch))
        params, buffers = _snapshot(model, mesh)
        out[kind] = dict(loss=loss, params=params, buffers=buffers)
    result = _ranks_result(out)
    if ckpt is None:
        return result
    checks = [None] * dist.get_world_size()
    dist.all_gather_object(checks, _checkpoint_round_trip(
        _kind_cfg(kinds[0]), state_dict, batch, mesh, ckpt))
    return result + (checks,)


def _checkpoint_round_trip(cfg, state_dict, batch, mesh, path):
    """One Adam step with the head split over the model group, the
    checkpoint (head and moments gathered) written by rank 0 and read back
    by every rank: whether each rank's shard and Adam moments are the
    checkpoint's columns and come back exactly."""
    def trainer():
        model = MinkUNet(3, DIM, ARCH)
        model.load_state_dict(state_dict)
        shard_head(model, mesh)
        opt, schedule = D.make_optimizer(cfg, model, MAX_ITER)
        step = D.make_train_step(cfg, model, opt, schedule, "cpu",
                                 mesh=mesh)
        return SimpleNamespace(cfg=cfg, model=model, optimizer=opt,
                               step_fn=step, mesh=mesh, best_iou=0.5,
                               batches_per_epoch=1)

    tr = trainer()
    tr.step_fn(batch)
    payload = D.TrainerBase._checkpoint(tr, 1)
    if mesh.is_main:
        torch.save(payload, path)
    dist.barrier()
    again = trainer()
    epoch, best = D.TrainerBase._resume(again, path)
    cols = head_columns(mesh, DIM)
    final_i = list(dict(tr.model.named_parameters())).index("final")
    saved = payload["optimizer"]["state"][final_i]
    st0, st1 = (t.optimizer.state[t.model.final] for t in (tr, again))
    moments = ("exp_avg", "exp_avg_sq")
    return dict(
        full_shape=tuple(payload["model"]["final"].shape),
        in_checkpoint=(
            torch.equal(payload["model"]["final"][..., cols],
                        tr.model.final.detach())
            and all(torch.equal(saved[k][..., cols], st0[k])
                    for k in moments)),
        resumed=(torch.equal(again.model.final, tr.model.final)
                 and all(torch.equal(st0[k], st1[k]) for k in moments)
                 and again.step_fn.it == 1 and (epoch, best) == (1, 0.5)))


# ---- the parent: inputs and the JAX references ----

@pytest.fixture(scope="module")
def inputs():
    """Weights, the JAX stacked batches and the port's per-rank batches."""
    from openscene_tpu.data.sharded import assemble_sharded_distill_batches
    from openscene_tpu_torch.convert import params_from_jax
    from tests.test_torch_unet import numpy_unet_trees

    from __graft_entry__ import _synthetic_batch
    per_dev = [_synthetic_batch(n_points=3000, dim=DIM, seed=5 + d,
                                voxel=0.1, rng=np.random.default_rng(d))
               for d in range(2)]
    jbatches, caps = assemble_sharded_distill_batches(
        per_dev, DIM, rng=np.random.default_rng(1))
    # the port pads to its own, tighter caps (a third of the CPU time of
    # the JAX calibration's 4096-row floor); padded rows change nothing
    counts = np.max([level_counts(np.asarray(jbatches.geo.levels[0].coords
                                             )[d][:int(n)])
                     for d, n in enumerate(np.asarray(jbatches.num_voxels))],
                    axis=0)
    fixed = tuple(_bucket(int(c * 1.06) + 32, min_bucket=512)
                  for c in counts)
    pcaps = GeometryCaps(cap0=fixed[0], fixed=fixed)
    rng = np.random.default_rng(1)
    host = [assemble_distill_batch(s, DIM, caps=pcaps, rng=rng)
            for s in per_dev]
    rng = np.random.default_rng(1)
    raw = []
    for s in per_dev:
        r, c = assemble_raw_distill_batch(s, DIM, caps=pcaps, rng=rng)
        raw.append((r, c.fixed))
    for d, b in enumerate(host):  # the JAX package's sub-batches exactly
        n = b.num_voxels
        assert n == int(np.asarray(jbatches.num_voxels)[d])
        for name in ("feats", "feat_3d", "mask"):
            np.testing.assert_array_equal(
                getattr(b, name)[:n], np.asarray(getattr(jbatches, name))[d]
                [:n])
        np.testing.assert_array_equal(
            b.geo.levels[0].coords[:n],
            np.asarray(jbatches.geo.levels[0].coords)[d][:n])
        np.testing.assert_array_equal(raw[d][0].coords[:n],
                                      b.geo.levels[0].coords[:n])
    params, state = numpy_unet_trees(ARCH, 3, DIM, seed=2)
    return dict(params=params, state=state, jbatches=jbatches, host=host,
                raw=raw, state_dict=params_from_jax(params, state, ARCH))


def _jax_step(inputs, opt, data, model_axis, **kw):
    """``make_train_step(mesh=data x model)`` of the JAX package:
    (loss, flat params, flat state)."""
    import jax
    import jax.numpy as jnp
    from openscene_tpu.config import Config as JaxConfig
    from openscene_tpu.parallel.mesh import (get_mesh as jax_mesh,
                                             replicate, shard_batch)
    from openscene_tpu.runtime.distill import make_train_step
    from openscene_tpu_torch.convert import flatten_tree

    cfg = JaxConfig(**{"arch_3d": ARCH, "loss_type": "cosine",
                       "compute_dtype": "float32", **kw})
    mesh = jax_mesh(data=data, model=model_axis,
                    devices=jax.devices()[:data * model_axis])
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    p, s = tree(inputs["params"]), tree(inputs["state"])
    batches = inputs["jbatches"]
    if data == 1:
        batches = jax.tree_util.tree_map(lambda x: np.asarray(x)[:1],
                                         batches)
    step = make_train_step(cfg, opt, mesh=mesh)
    new_p, new_s, _, loss = step(
        replicate(mesh, p, head_sharded=True), replicate(mesh, s),
        replicate(mesh, opt.init(p), head_sharded=True),
        shard_batch(mesh, batches))
    return float(loss), flatten_tree(new_p), flatten_tree(new_s)


@pytest.fixture(scope="module")
def dp_runs(inputs, rank_runs):
    from openscene_tpu.config import Config as JaxConfig
    from openscene_tpu.runtime.distill import make_optimizer
    jopt, _ = make_optimizer(JaxConfig(base_lr=1e-7, lr_multiplier=10.0),
                             MAX_ITER)
    ref = _jax_step(inputs, jopt, 2, 1, base_lr=1e-7, lr_multiplier=10.0)
    return ref, rank_runs["two"].result()[0]


@pytest.fixture(scope="module")
def rank_runs(inputs, tmp_path_factory):
    """The spawned runs, started together in the background while the JAX
    references compile: two ranks (data parallel, then the 1 x 2 head) and
    four (the 2 x 2 head)."""
    path = str(tmp_path_factory.mktemp("head_ckpt") / "model_last.ckpt")
    sd, host = inputs["state_dict"], inputs["host"]
    with ThreadPoolExecutor(2) as pool:
        yield {"two": pool.submit(spawn, _two_ranks, 2, sd, host,
                                  inputs["raw"], path, device="cpu",
                                  timeout=TIMEOUT),
               "four": pool.submit(spawn, _head_rank, 4, sd, host, 2, 2,
                                   ("cosine", "memory_efficient"),
                                   device="cpu", timeout=TIMEOUT)}


@pytest.mark.parametrize("kind", ["host", "raw"])
def test_data_parallel_step_matches_jax_sharded_step(dp_runs, kind):
    (jloss, jparams, jstate), (out, digests) = dp_runs
    assert len(set(digests)) == 1  # every array bit-identical on both ranks
    r = out[kind]
    np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)
    lr = r["lr"]
    assert set(r["params"]) == set(jparams)
    total, count = 0.0, 0
    for n, ref in jparams.items():
        diff = np.abs(r["params"][n] - ref)
        total, count = total + diff.sum(), count + diff.size
        assert diff.max() <= 2 * lr, n
        g = np.abs(r["grads"][n])  # the ranks' average
        assert diff[g >= 1e-3 * g.max()].max() <= 0.25 * lr, n
    assert total / count <= 5e-3 * lr
    assert set(r["buffers"]) == set(jstate)
    for n, v in jstate.items():
        np.testing.assert_allclose(r["buffers"][n], v, rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def _one_process_sgd(inputs, kind, batches):
    """The one-process reference of a sharded SGD step: the update of the
    mean of the one-process gradients of ``batches`` (SGD is linear in the
    gradient), and the mean of their BatchNorm buffers."""
    grads, buffers = [], []
    for b in batches:
        model, step = _sgd_model(_kind_cfg(kind), inputs["state_dict"], None)
        step(b)
        grads.append({n: p.grad.numpy() for n, p in model.named_parameters()})
        buffers.append({n: v.numpy() for n, v in model.named_buffers()})
    mean = lambda ds: {n: sum(d[n] for d in ds) / len(ds) for n in ds[0]}
    return {n: -SGD_LR * g for n, g in mean(grads).items()}, mean(buffers)


@pytest.fixture(scope="module")
def head_runs(inputs, rank_runs):
    import optax
    sgd = optax.sgd(SGD_LR)
    host = inputs["host"]
    kinds = ("cosine", "memory_efficient")
    jax_ref = {k: _jax_step(inputs, sgd, 2, 2,
                            memory_efficient_loss=k != "cosine")
               for k in kinds}
    port_ref = {k: _one_process_sgd(inputs, k, host) for k in kinds}
    runs = {"2x2": (rank_runs["four"].result(), jax_ref, port_ref)}
    runs["1x2"] = (rank_runs["two"].result()[1], {"l1": _jax_step(inputs, sgd, 1, 2, loss_type="l1")},
                   {"l1": _one_process_sgd(inputs, "l1", host[:1])})
    return runs


@pytest.mark.parametrize("mesh,kind", [("2x2", "cosine"),
                                       ("2x2", "memory_efficient"),
                                       ("1x2", "l1")])
def test_head_sharded_step_matches_jax_sharded_step(inputs, head_runs, mesh,
                                                    kind):
    from openscene_tpu_torch.convert import flatten_tree
    ranks, jax_ref, port_ref = head_runs[mesh]
    (out, digests) = ranks[:2]
    assert len(set(digests)) == 1  # every rank's full parameters
    r, (jloss, jparams, jstate) = out[kind], jax_ref[kind]
    np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)
    before = flatten_tree(inputs["params"])
    assert set(r["params"]) == set(jparams) == set(before)
    assert r["params"]["final"].shape == before["final"].shape
    u = {n: r["params"][n] - p0 for n, p0 in before.items()}
    uj = {n: jparams[n] - p0 for n, p0 in before.items()}
    # against the JAX sharded step: test_torch_distill's fp32 gradient gates
    # (SGD's update is -lr times the gradient)
    each = {n: np.linalg.norm(u[n] - uj[n]) / np.linalg.norm(uj[n])
            for n in uj}
    assert max(each.values()) <= 5e-2, max(each, key=each.get)
    num = sum(np.linalg.norm(u[n] - uj[n]) ** 2 for n in uj)
    assert (num / sum(np.linalg.norm(uj[n]) ** 2 for n in uj)) ** 0.5 <= 1e-2
    for n, v in jstate.items():
        np.testing.assert_allclose(r["buffers"][n], v, rtol=1e-4, atol=1e-6,
                                   err_msg=n)
    # against the port's one-process step: test_parallel.py's tolerance
    ref_u, ref_buffers = port_ref[kind]
    for n, up in ref_u.items():
        ulps = 2 * np.spacing(np.abs(r["params"][n]))  # rounding of p + u
        assert (np.abs(u[n] - up) <= 1e-3 * np.abs(up).max() + ulps).all(), n
    for n, v in ref_buffers.items():
        np.testing.assert_allclose(r["buffers"][n], v, rtol=1e-6, atol=1e-7,
                                   err_msg=n)


def test_head_sharded_checkpoint_round_trip(head_runs):
    checks = head_runs["1x2"][0][2]
    assert len(checks) == 2
    for c in checks:
        assert c["full_shape"] == (1, 96, DIM)
        assert c["in_checkpoint"] and c["resumed"], c


def test_mesh_layout_matches_jax_mesh():
    import jax
    from openscene_tpu.parallel.mesh import get_mesh as jax_mesh
    jmesh = jax_mesh(data=4, model=2, devices=jax.devices()[:8])
    ids = np.vectorize(lambda dev: dev.id)(jmesh.devices)
    data_groups, model_groups = mesh_layout(4, 2)
    assert model_groups == ids.tolist()        # a model group: a mesh row
    assert data_groups == ids.T.tolist()       # a data group: a column
    assert data_groups == [[0, 2, 4, 6], [1, 3, 5, 7]]


def test_sharded_helpers_equal_jax():
    """``data/sharded.py``: the cap helpers are the JAX package's, and rank
    ``d``'s scenes of a global batch are the JAX trainer's device ``d``
    slice of it."""
    from openscene_tpu.data import sharded as js
    from openscene_tpu_torch.data import sharded
    counts = (120695, 60211, 15320, 3911, 870)
    for margin, extra in ((0.06, 32), (0.02, 0)):
        got = sharded.fixed_caps_from_counts(counts, margin, extra)
        ref = js.fixed_caps_from_counts(counts, margin, extra)
        assert (got.cap0, got.fixed) == (ref.cap0, ref.fixed)
    a = sharded.fixed_caps_from_counts(counts)
    b = sharded.fixed_caps_from_counts(tuple(c * 2 for c in counts[::-1]))
    ja, jb = (js.fixed_caps_from_counts(c) for c in (
        counts, tuple(c * 2 for c in counts[::-1])))
    assert sharded.merge_caps(a, b).fixed == js.merge_caps(ja, jb).fixed
    order = np.random.default_rng(0).permutation(23)
    per, n_dp = 3, 2
    for i in range(23 // (per * n_dp)):
        batch = order[i * per * n_dp:(i + 1) * per * n_dp]
        for d in range(n_dp):
            np.testing.assert_array_equal(
                sharded.rank_indices(order, i, per, n_dp, d),
                batch[d * per:(d + 1) * per])


def test_runs_without_their_process_group_raise(tmp_path):
    assert not dist.is_initialized()
    assert mesh_for("distill", -1, 1, "cpu", batch_size=8) is None
    assert mesh_for("evaluate", 1, device="cpu") is None
    with pytest.raises(RuntimeError, match="2 ranks.*torchrun --nproc_per_"
                       "node 2 -m openscene_tpu_torch.runtime.evaluate"):
        mesh_for("evaluate", 2, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun.*main"):
        mesh_for("distill", -1, 2, "cpu")
    from openscene_tpu_torch.runtime.evaluate import ZeroShotEvaluator
    with pytest.raises(RuntimeError, match="evaluate.*torchrun.*main"):
        ZeroShotEvaluator(Config(data_parallel=2, feature_type="fusion"),
                          device="cpu")
    with pytest.raises(ValueError, match="2 x 2 mesh needs 4 ranks"):
        # a process group of one rank (a file store of its own)
        dist.init_process_group("gloo", init_method="file://"
                                + str(tmp_path / "store"), world_size=1,
                                rank=0)
        try:
            get_mesh(2, 2, "cpu")
        finally:
            dist.destroy_process_group()
