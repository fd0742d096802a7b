"""The port's sparse ResNet classifiers against the JAX package's
``apply_resnet``, and ``masked_global_avg_pool`` against the JAX op.

ResNet14 (basic blocks) and ResNet50 (bottlenecks) at their published
widths, 3 colour channels -> 20 classes, on a 2-scene batch of surface
scans (the JAX package's host plans, without window plans, on its side;
the port's own host builder on the port's).  Weights are seeded numpy
arrays in ``init_resnet``'s tree layout with nontrivial BatchNorm
parameters and statistics, carried across by ``resnet_params_from_jax``.
fp32 throughout.

* Eval and train forward: logits at ``tests/test_torch_unet.py``'s fp32
  tolerance (``rtol=1e-4``, ``atol=1e-4 * max|ref|``: summation order
  only); in train mode every updated BatchNorm buffer ``rtol=1e-4,
  atol=1e-5``.
* Gradients of the train-mode logits for a fixed cotangent against
  ``jax.grad``, each tensor on its own: the port's relative L2 distance
  from the JAX package's within ``GRAD_RTOL[arch]``.  ResNet14 is held at
  1e-4 (measured at most 2.7e-6 for any tensor).  Behind training-mode
  BatchNorm a gradient is what is left after large cancellations, and
  ResNet50's fp32 gradients move by about 1% of their norm with the order
  of the fp32 sums (the port's and the JAX package's alike), so it is held
  at 5e-2 (measured at most 1.8e-2).  A float64 run of the port
  (BatchNorm in float64 too) shows which side moved: each tensor of both
  fp32 runs within the same bound of it, and the port's gradients as a
  whole no farther from it than 1.25x the JAX package's plus 1e-5
  (measured 1.2e-6 against 1.5e-6 at ResNet14, 7.1e-3 against 1.1e-2 at
  ResNet50).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openscene_tpu.models.resnet import apply_resnet, init_resnet
from openscene_tpu.sparse import ops as jops
from openscene_tpu.sparse.geometry import GeometryCaps as JaxCaps
from openscene_tpu.sparse.geometry import \
    build_unet_geometry as jax_build_geometry
from openscene_tpu_torch.convert import flatten_tree, resnet_params_from_jax
from openscene_tpu_torch.models import ResNet, sparse_unet
from openscene_tpu_torch.sparse.geometry import (GeometryCaps,
                                                 build_unet_geometry,
                                                 geometry_to_device,
                                                 level_counts)
from openscene_tpu_torch.sparse.ops import masked_global_avg_pool
from tests.test_torch_unet import _one_thread, _surface_coords  # noqa: F401

CLASSES = 20
ARCHS = ["ResNet14", "ResNet50"]
# per arch, the bound on each gradient tensor's relative L2 distance
GRAD_RTOL = {"ResNet14": 1e-4, "ResNet50": 5e-2}


def numpy_resnet_trees(arch, cin, classes, seed):
    """Seeded numpy weights as ``init_resnet``'s (params, state) trees:
    He-normal convs, nontrivial BatchNorm parameters and statistics, a
    nonzero head.  Names and shapes from the port's state_dict, nested as
    the JAX tree nests them (``block1.0.bn1.gamma`` ->
    ``params["block1"][0]["bn1"]["gamma"]``)."""
    rng = np.random.default_rng(seed)
    params, state = {}, {}
    for name, v in ResNet(cin, classes, arch).state_dict().items():
        shape = tuple(v.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma", "var"):
            a = 0.5 + rng.random(shape)
        elif leaf in ("beta", "mean", "b"):
            a = 0.2 * rng.standard_normal(shape)
        elif leaf == "w":  # the head (C, classes)
            a = rng.standard_normal(shape) * 0.05
        else:  # conv weight (K, C_in, C_out)
            a = rng.standard_normal(shape) * (2.0 / (shape[0] * shape[2])) ** 0.5
        tree = state if leaf in ("mean", "var") else params
        *path, last = name.split(".")
        for key, nxt in zip(path, path[1:] + [last]):
            if isinstance(tree, list):
                key = int(key)
                while len(tree) <= key:
                    tree.append({})
                tree = tree[key]
            else:
                tree = tree.setdefault(key, [] if nxt.isdigit() else {})
        tree[last] = a.astype(np.float32)
    return params, state


def _caps(coords):
    """Level caps just above each level's count (multiples of 64): the
    default buckets start at 4,096 rows, which at level 4's 512-2048
    channels would spend the test's time on padding."""
    return tuple(-(-(n + 1) // 64) * 64 for n in level_counts(coords))


@pytest.fixture(scope="module")
def batch():
    """Two surface scans as one batch (batch column 0 and 1), their plans
    on both sides, and seeded colour features."""
    a = _surface_coords(2, n=2500, span=64)
    b = _surface_coords(3, n=2500, span=64)
    b[:, 0] = 1
    coords = np.concatenate([a, b])
    caps = _caps(coords)
    geo = build_unet_geometry(coords, caps=GeometryCaps(cap0=caps[0],
                                                        fixed=caps))
    jgeo = jax_build_geometry(coords, caps=JaxCaps(cap0=caps[0], fixed=caps),
                              build_windows=False)
    assert all(int(l.num) >= 16 for l in geo.levels)
    n = len(coords)
    x = np.zeros((geo.levels[0].cap, 3), np.float32)
    x[:n] = np.random.default_rng(6).standard_normal((n, 3))
    cot = np.random.default_rng(8).standard_normal(
        (2, CLASSES)).astype(np.float32)
    return geo, jgeo, x, cot


def _bn64(x, mask, num, gamma, beta, running_mean, running_var, *, train,
          momentum=0.1, eps=1e-5, relu=False):
    """``sparse/ops.py:masked_batch_norm`` in float64 (which the package
    computes in fp32 for every input): the reference run's BatchNorm,
    then ReLU with ``relu``."""
    x, mask = x.double(), mask.double()
    n = float(max(int(num), 1))
    mean = (x * mask).sum(0) / n
    var = (((x - mean) * mask) ** 2).sum(0) / n
    if not train:
        mean, var = running_mean.double(), running_var.double()
    out = ((x - mean) * torch.rsqrt(var + eps) * gamma.double()
           + beta.double()) * mask
    return (torch.relu(out) if relu else out), running_mean, running_var


def _port_grads(model, x, geo, cot):
    out = model(x, geo, 2)
    (out * cot.to(out.dtype)).sum().backward()
    return out, {n: p.grad.double().numpy()
                 for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def runs(batch):
    """Per arch, both packages on the same weights: eval logits; train
    logits, updated statistics and the gradients of ``<logits, cot>``
    (one jitted ``jax.grad`` with the forward as its aux)."""
    geo, jgeo, x, cot = batch
    cache = {}

    def get(arch):
        if arch in cache:
            return cache[arch]
        params, state = numpy_resnet_trees(arch, 3, CLASSES, seed=1)
        xj = jnp.asarray(x)
        ev, _ = jax.jit(lambda p: apply_resnet(
            p, state, xj, jgeo, 2, arch=arch, train=False))(params)

        def loss(p):
            logits, ns = apply_resnet(p, state, xj, jgeo, 2, arch=arch,
                                      train=True)
            return jnp.vdot(logits, jnp.asarray(cot)), (logits, ns)

        grads, (tr, ns) = jax.jit(jax.grad(loss, has_aux=True))(params)
        ref = dict(eval=np.asarray(ev), train=np.asarray(tr),
                   state=flatten_tree(ns), grads=flatten_tree(grads))
        g = geometry_to_device(geo, "cpu")
        xt = torch.from_numpy(x)
        model = ResNet(3, CLASSES, arch)
        model.load_state_dict(resnet_params_from_jax(params, state, arch))
        model.eval()
        with torch.no_grad():
            out_ev = model(xt, g, 2)
        sd = model.state_dict()
        out_tr, grads = _port_grads(model.train(), xt, g,
                                    torch.from_numpy(cot))
        got = dict(eval=out_ev, train=out_tr.detach(), grads=grads,
                   state={n: b.numpy() for n, b in model.named_buffers()})
        model64 = ResNet(3, CLASSES, arch).double()
        model64.load_state_dict(sd)
        with mock.patch.object(sparse_unet, "masked_batch_norm", _bn64):
            _, ref["grads64"] = _port_grads(model64.train(), xt.double(), g,
                                            torch.from_numpy(cot))
        cache[arch] = (got, ref, flatten_tree(state))
        return cache[arch]
    return get


def test_trees_have_init_resnet_structure():
    for arch in ARCHS:
        p_ref, s_ref = jax.eval_shape(
            lambda: init_resnet(jax.random.PRNGKey(0), 3, CLASSES, arch=arch))
        p, s = numpy_resnet_trees(arch, 3, CLASSES, seed=0)
        shapes = lambda t: jax.tree_util.tree_map(np.shape, t)
        assert shapes(p) == shapes(p_ref) and shapes(s) == shapes(s_ref)


def test_params_from_jax_checks_block_counts():
    p, s = numpy_resnet_trees("ResNet14", 3, CLASSES, seed=0)
    with pytest.raises(ValueError, match="block1"):
        resnet_params_from_jax(p, s, "ResNet18")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_resnet_forward_matches_jax(runs, arch, mode):
    got, ref, old = runs(arch)
    out = got[mode]
    assert out.dtype == torch.float32 and out.shape == (2, CLASSES)
    np.testing.assert_allclose(out.numpy(), ref[mode], rtol=1e-4,
                               atol=1e-4 * np.abs(ref[mode]).max())
    if mode == "train":
        assert set(ref["state"]) == set(got["state"])
        for name, v in ref["state"].items():
            assert not np.allclose(v, old[name]), name  # the statistics moved
            np.testing.assert_allclose(got["state"][name], v, rtol=1e-4,
                                       atol=1e-5, err_msg=name)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _rel_all(a, b):
    return (sum(np.linalg.norm(a[n] - g) ** 2 for n, g in b.items())
            / sum(np.linalg.norm(g) ** 2 for g in b.values())) ** 0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_resnet_gradients_match_jax(runs, arch):
    got, ref, _ = runs(arch)
    grads, gref, g64 = got["grads"], ref["grads"], ref["grads64"]
    assert set(grads) == set(gref) == set(g64)
    bound = GRAD_RTOL[arch]
    for n, y in gref.items():
        assert _rel(grads[n], y) <= bound, (n, _rel(grads[n], y))
        assert _rel(y, g64[n]) <= bound, (n, _rel(y, g64[n]))
        assert _rel(grads[n], g64[n]) <= bound, (n, _rel(grads[n], g64[n]))
    ours, theirs = _rel_all(grads, g64), _rel_all(gref, g64)
    assert ours <= 1.25 * theirs + 1e-5, (ours, theirs)


def test_masked_global_avg_pool_matches_jax():
    rng = np.random.default_rng(11)
    cap, num, c, nb = 64, 50, 24, 3
    x = rng.standard_normal((cap, c)).astype(np.float32)
    x[num:] = 0
    ids = rng.integers(0, nb, cap).astype(np.int32)
    ids[num:] = 2 ** 20  # the sentinel of padded coordinates
    ids[ids == 1] = 0    # scene 1 holds no row: its mean is zero
    mask = (np.arange(cap)[:, None] < num).astype(np.float32)
    ref = np.asarray(jops.masked_global_avg_pool(
        jnp.asarray(x), jnp.asarray(mask), num, jnp.asarray(ids), nb))
    got = masked_global_avg_pool(torch.from_numpy(x), torch.from_numpy(mask),
                                 num, torch.from_numpy(ids), nb)
    assert got.dtype == torch.float32 and got.shape == (nb, c)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert not got[1].any()
