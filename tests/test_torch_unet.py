"""The port's MinkUNet forward against the JAX package's ``apply_unet``.

Weights are seeded numpy arrays in the JAX package's (params, state) tree
layout, with nontrivial BatchNorm parameters and statistics, carried across
with ``params_from_jax``; inputs and geometry are the same seeded NumPy
arrays on both sides.  Also the committed
``tests/fixtures/unet_golden.npz`` (a dense float64 torch reference of an
ME-format MinkUNet14A, see tests/test_unet_golden_parity.py), reached
through the port's own ``convert_state_dict``.

The training-mode forward (batch statistics, updated BatchNorm buffers) is
held against ``apply_unet(..., train=True)`` in fp32, for MinkUNet14A and
for the bottleneck MinkUNet50: outputs to the fp32 tolerance below and every
updated ``mean``/``var`` to ``rtol=1e-4, atol=1e-5``.

Tolerances: fp32 ``rtol=1e-4`` with ``atol=1e-4 * max|ref|`` (summation
order only).  bf16: every layer rounds its output to bf16, and a one-ulp
difference in one layer moves the next layer's inputs, so the two sides
drift apart through the network (measured over three weight seeds: largest
error up to 0.6% of the output scale, mean up to 0.05%).  The test holds the
largest error to two bf16 ulps of the scale (2 * 2**-7, about 1.6%) and the
mean to a quarter ulp (2**-9, about 0.2%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openscene_tpu.models import apply_unet, init_unet
from openscene_tpu_torch.convert import flatten_tree, params_from_jax
from openscene_tpu_torch.models import MinkUNet
from openscene_tpu_torch.sparse.edge_conv import down_conv_fwd
from openscene_tpu_torch.sparse.geometry import (build_unet_geometry,
                                                 geometry_to_device)
from openscene_tpu_torch.sparse.stencil_conv import stencil_conv_fwd
from openscene_tpu_torch.utils.convert_checkpoint import (REGION_ORDERS,
                                                          convert_state_dict)
from tests.test_unet_golden_parity import FIXTURE, _me_state_dict

ARCH = "MinkUNet14A"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch for the module (other port test modules import
    this fixture): the suite runs several test processes side by side, and
    spinning intra-op threads would only compete with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surface_coords(seed, n=900, span=26):
    rng = np.random.default_rng(seed)
    pts = set()
    while len(pts) < n:
        x, y = (int(v) for v in rng.integers(0, span, 2))
        z = int(3 + 2 * np.sin(x / 4.0) + 2 * np.cos(y / 5.0))
        pts.add((0, x, y, z + int(rng.integers(0, 2))))
    return np.array(sorted(pts), dtype=np.int32)


def numpy_unet_trees(arch, cin, cout, seed):
    """Seeded numpy weights for both packages, as the JAX package's
    (params, state) trees: He-normal convs, nontrivial BN parameters and
    statistics.  Names and shapes come from the port's state_dict; the trees
    nest them as ``init_unet`` does (``block1.0.bn1.gamma`` ->
    ``params["block1"][0]["bn1"]["gamma"]``)."""
    rng = np.random.default_rng(seed)
    params, state = {}, {}
    for name, v in MinkUNet(cin, cout, arch).state_dict().items():
        shape = tuple(v.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma", "var"):
            a = 0.5 + rng.random(shape)
        elif leaf in ("beta", "mean"):
            a = 0.2 * rng.standard_normal(shape)
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


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    params, state = numpy_unet_trees(ARCH, 3, 24, seed=1)
    coords = _surface_coords(2)
    geo = build_unet_geometry(coords)
    cap, n = geo.levels[0].cap, len(coords)
    x = np.zeros((cap, 3), np.float32)
    x[:n] = rng.standard_normal((n, 3))
    model = MinkUNet(3, 24, ARCH).eval()
    model.load_state_dict(params_from_jax(params, state, ARCH))
    return params, state, geo, x, n, model


def test_trees_have_init_unet_structure():
    p_ref, s_ref = jax.eval_shape(
        lambda: init_unet(jax.random.PRNGKey(0), 3, 24, arch=ARCH))
    p, s = numpy_unet_trees(ARCH, 3, 24, seed=0)
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)
    assert shapes(p) == shapes(p_ref) and shapes(s) == shapes(s_ref)


@pytest.mark.parametrize("dtype,constant_input", [
    (torch.bfloat16, True),   # the eval path: bf16, occupancy stem
    (torch.float32, False),   # exact arithmetic through the k=5 conv stem
], ids=["bf16-occupancy_stem", "fp32-conv_stem"])
def test_unet_forward_matches_jax(case, dtype, constant_input):
    params, state, geo, x, n, model = case
    if constant_input:
        x = (np.arange(x.shape[0])[:, None] < n).astype(np.float32) * \
            np.ones_like(x)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref, _ = jax.jit(lambda p, s, xx: apply_unet(
        p, s, xx, geo, arch=ARCH, train=False,
        constant_input=constant_input))(params, state,
                                        jnp.asarray(x).astype(jdtype))
    ref = np.asarray(ref, np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(dtype),
                    geometry_to_device(geo, "cpu"),
                    constant_input=constant_input)
    assert out.dtype == torch.float32
    out = out.numpy()
    scale = np.abs(ref[:n]).max()
    assert np.isfinite(out).all() and not out[n:].any()
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * scale)
    else:
        err = np.abs(out - ref)[:n]
        assert err.max() <= 2 * 2.0 ** -7 * scale, err.max() / scale
        assert err.mean() <= 2.0 ** -9 * scale, err.mean() / scale
    assert stencil_conv_fwd.launches == 0 and down_conv_fwd.launches == 0


@pytest.mark.parametrize("arch,prehead", [("MinkUNet14A", False),
                                          ("MinkUNet50", True)])
def test_unet_training_forward_matches_jax(arch, prehead):
    # 16 voxels at the coarsest level: batch statistics over a handful of
    # rows would amplify fp32 rounding beyond any summation-order tolerance
    coords = _surface_coords(2, n=2500, span=64)
    geo = build_unet_geometry(coords)
    assert int(geo.levels[4].num) >= 16
    n = len(coords)
    x = np.zeros((geo.levels[0].cap, 3), np.float32)
    x[:n] = np.random.default_rng(6).standard_normal((n, 3))
    params, state = numpy_unet_trees(arch, 3, 24, seed=3)
    model = MinkUNet(3, 24, arch).train()
    model.load_state_dict(params_from_jax(params, state, arch))
    ref, new_state = jax.jit(lambda p, s, xx: apply_unet(
        p, s, xx, geo, arch=arch, train=True, return_prehead=prehead))(
            params, state, jnp.asarray(x))
    ref = np.asarray(ref, np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x), geometry_to_device(geo, "cpu"),
                    return_prehead=prehead).numpy()
    assert out.shape == ref.shape and not out[n:].any()
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref[:n]).max())
    buffers = dict(model.named_buffers())
    want = flatten_tree(new_state)
    assert set(want) == set(buffers)
    old = flatten_tree(state)
    for name, v in want.items():
        assert not np.allclose(v, old[name]), name  # the statistics moved
        np.testing.assert_allclose(buffers[name].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # eval mode reads the buffers and leaves them alone
    model.eval()
    with torch.no_grad():
        model(torch.from_numpy(x), geometry_to_device(geo, "cpu"))
    for name, v in want.items():
        np.testing.assert_allclose(buffers[name].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_prehead_shape(case):
    params, state, geo, x, n, model = case
    with torch.no_grad():
        pre = model(torch.from_numpy(x).to(torch.bfloat16),
                    geometry_to_device(geo, "cpu"), return_prehead=True)
    assert pre.shape == (x.shape[0], 96) and pre.dtype == torch.bfloat16
    assert not pre[n:].any()


@pytest.mark.parametrize("region_order", REGION_ORDERS)
def test_golden_fixture_through_port_converter(region_order):
    z = np.load(FIXTURE)
    c4, feats = z["coords"], z["feats"]
    sd = _me_state_dict(np.random.default_rng(7))
    params, state = convert_state_dict(sd, ARCH, region_order=region_order)
    model = MinkUNet(3, 20, ARCH).eval()
    model.load_state_dict(params_from_jax(params, state, ARCH))
    geo = build_unet_geometry(c4)
    x = np.zeros((geo.levels[0].cap, 3), np.float32)
    x[:len(c4)] = feats
    with torch.no_grad():
        out = model(torch.from_numpy(x), geometry_to_device(geo, "cpu"))
    out = out.numpy()[:len(c4)]
    golden = z[f"golden_{region_order}"]
    scale = np.abs(golden).max()
    np.testing.assert_allclose(out, golden, atol=1e-4 * scale, rtol=1e-3)


@pytest.mark.parametrize("region_order", REGION_ORDERS)
def test_convert_state_dict_trees_match_jax(region_order):
    from openscene_tpu.utils.convert_checkpoint import \
        convert_state_dict as jax_convert
    sd = _me_state_dict(np.random.default_rng(3))
    got = convert_state_dict(sd, ARCH, region_order=region_order)
    ref = jax_convert(sd, ARCH, region_order=region_order)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (path, g), (_, r) in zip(flat_got, flat_ref):
        np.testing.assert_array_equal(g, r, err_msg=str(path))
