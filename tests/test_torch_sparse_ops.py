"""The port's sparse ops against the JAX package's, on the CPU.

(a) The plain stencil, down and up convs and the masked BatchNorm (eval and
    train) of ``openscene_tpu_torch.sparse`` against
    ``openscene_tpu.sparse.ops`` on the same seeded inputs and plans.
(b) The port's stencil and down-conv wrappers against the JAX package's
    windowed Pallas kernels run through the Pallas interpreter.

Tolerances: fp32 rtol = atol = 1e-5 (the two sides sum the same exact
products in another order); bf16 one bf16 ulp of the output scale,
``atol = 2**-7 * max|ref|`` (an fp32 sum rounded to bf16 on each side may
land one ulp apart).  Padded rows must be exactly zero.  On the CPU the
wrappers take their plain versions, so their launch counters stay 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openscene_tpu.sparse import ops as jops
from openscene_tpu.sparse import pallas_conv, pallas_edge
from openscene_tpu.sparse.geometry import GeometryCaps
from openscene_tpu.sparse.geometry import \
    build_unet_geometry as jax_build_geometry
from openscene_tpu_torch.sparse import ops
from openscene_tpu_torch.sparse.edge_conv import (down_conv_fwd, up_conv_fwd,
                                                  with_edge_layouts)
from openscene_tpu_torch.sparse.geometry import build_unet_geometry
from openscene_tpu_torch.sparse.stencil_conv import stencil_conv_fwd
from openscene_tpu_torch.sparse.types import DownPlan
from tests.test_torch_unet import _one_thread  # noqa: F401

BF16_ULP = 2.0 ** -7


def _surface(seed, n, span):
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, span, (n, 2))
    z = (18 + 9 * np.sin(xy[:, 0] / 12) + 9 * np.cos(xy[:, 1] / 15)
         ).astype(int) + rng.integers(0, 3, n)
    return np.unique(np.concatenate([np.zeros((n, 1), int), xy, z[:, None]],
                                    1), axis=0).astype(np.int32)


@pytest.fixture(scope="module")
def geo():
    return build_unet_geometry(_surface(0, 3000, 70))


def _torch_down(geo, edge):
    """Edge ``edge`` of ``geo`` (the port's or the JAX package's NumPy
    plans) as the port's DownPlan of CPU tensors, with the groups and skip
    plan the device plans carry."""
    plan = DownPlan(*(torch.from_numpy(np.asarray(a))
                      for a in geo.down[edge][:3]))
    return with_edge_layouts(plan, int(geo.levels[edge].num),
                             int(geo.levels[edge + 1].num))


def _acts(rng, cap, num, c):
    x = np.zeros((cap, c), np.float32)
    x[:num] = rng.standard_normal((num, c))
    return x


def _pair(x, dtype):
    """The same values as a torch tensor and a jax array of one dtype."""
    t = torch.from_numpy(x).to(dtype)
    j = jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return t, j


def _check(out, ref, num, dtype):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=BF16_ULP * np.abs(ref).max())
    assert not out[num:].any()


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("level,cin,cout", [(0, 32, 64), (2, 96, 96)])
def test_stencil_conv_matches_jax(geo, dtype, level, cin, cout):
    rng = np.random.default_rng(level)
    lv, plan = geo.levels[level], geo.self3[level]
    num = int(lv.num)
    x, xj = _pair(_acts(rng, lv.cap, num, cin), dtype)
    w = (rng.standard_normal((27, cin, cout)) * 0.1).astype(np.float32)
    ref = jops.sparse_conv(xj, jnp.asarray(w), jnp.asarray(plan.fwd),
                           jnp.asarray(plan.flip_perm))
    fwd = torch.from_numpy(plan.fwd)
    _check(ops.sparse_conv(x, torch.from_numpy(w), fwd), ref, num, dtype)
    _check(stencil_conv_fwd(x, torch.from_numpy(w), fwd), ref, num, dtype)
    assert stencil_conv_fwd.launches == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("edge,cin,cout", [(0, 32, 32), (2, 64, 64)])
def test_down_conv_matches_jax(geo, dtype, edge, cin, cout):
    rng = np.random.default_rng(10 + edge)
    child, parent = geo.levels[edge], geo.levels[edge + 1]
    plan = geo.down[edge]
    x, xj = _pair(_acts(rng, child.cap, int(child.num), cin), dtype)
    w = (rng.standard_normal((8, cin, cout)) * 0.2).astype(np.float32)
    ref = jops.sparse_down_conv(xj, jnp.asarray(w),
                                jax.tree_util.tree_map(jnp.asarray, plan))
    tplan = _torch_down(geo, edge)
    num = int(parent.num)
    _check(ops.sparse_down_conv(x, torch.from_numpy(w), tplan), ref, num,
           dtype)
    _check(down_conv_fwd(x, torch.from_numpy(w), tplan), ref, num, dtype)
    assert down_conv_fwd.launches == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("edge,cin,cout", [(0, 64, 32), (3, 256, 128)])
def test_up_conv_matches_jax(geo, dtype, edge, cin, cout):
    rng = np.random.default_rng(20 + edge)
    child, parent = geo.levels[edge], geo.levels[edge + 1]
    plan = geo.down[edge]
    x, xj = _pair(_acts(rng, parent.cap, int(parent.num), cin), dtype)
    w = (rng.standard_normal((8, cin, cout)) * 0.2).astype(np.float32)
    ref = jops.sparse_up_conv(xj, jnp.asarray(w),
                              jax.tree_util.tree_map(jnp.asarray, plan))
    tplan = _torch_down(geo, edge)
    _check(up_conv_fwd(x, torch.from_numpy(w), tplan), ref, int(child.num),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_masked_batch_norm_matches_jax(geo, dtype, train):
    rng = np.random.default_rng(30)
    lv = geo.levels[1]
    cap, num, c = lv.cap, int(lv.num), 48
    x, xj = _pair(_acts(rng, cap, num, c) * 2 + 0.5, dtype)
    gamma, beta, rm = (rng.standard_normal(c).astype(np.float32)
                       for _ in range(3))
    rv = (0.5 + rng.random(c)).astype(np.float32)
    mask = (np.arange(cap)[:, None] < num).astype(np.float32)
    ref = jops.masked_batch_norm(xj, jnp.asarray(mask), jnp.int32(num),
                                 *map(jnp.asarray, (gamma, beta, rm, rv)),
                                 train=train)
    got = ops.masked_batch_norm(x, ops.valid_mask(num, cap), num,
                                *map(torch.from_numpy, (gamma, beta, rm, rv)),
                                train=train)
    _check(got[0], ref[0], num, dtype)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def test_relu_and_valid_mask():
    x = torch.tensor([[-1.0, 2.0], [0.5, -0.0]])
    np.testing.assert_array_equal(ops.relu(x).numpy(),
                                  np.asarray(jops.relu(jnp.asarray(x.numpy()))))
    np.testing.assert_array_equal(
        ops.valid_mask(3, 5).numpy(),
        np.asarray(jops.valid_mask(jnp.int32(3), 5)))


# ---- (b) against the windowed Pallas kernels, run by the interpreter ----

@pytest.fixture(scope="module")
def interpret_mode():
    caches = (pallas_conv._fwd_cached, pallas_conv._bwd_cached,
              pallas_edge._down_cached, pallas_edge._down_bwd_cached,
              pallas_edge._up_cached, pallas_edge._up_bwd_cached)
    pallas_conv.INTERPRET = True
    for c in caches:
        c.cache_clear()
    yield
    pallas_conv.INTERPRET = False
    for c in caches:
        c.cache_clear()


@pytest.fixture(scope="module")
def window_geo():
    """The smallest caps the window plans take (512-row multiples, a
    1024-row child window): the interpreter's time grows with the cap."""
    coords = _surface(1, 1500, 40)  # 1302 voxels at level 0, 695 at level 1
    caps = GeometryCaps(cap0=1536, fixed=(1536, 1024, 512, 512, 512))
    return jax_build_geometry(coords, caps=caps, build_windows=False)


def test_stencil_wrapper_matches_windowed_kernel(interpret_mode, window_geo):
    geo = window_geo
    plan, lv = geo.self3[0], geo.levels[0]
    cap, num = lv.cap, int(lv.num)
    wp = pallas_conv.build_window_plan(plan.fwd, num, cap)
    assert wp is not None
    rng = np.random.default_rng(40)
    x, xj = _pair(_acts(rng, cap, num, 32), torch.bfloat16)
    w = (rng.standard_normal((27, 32, 32)) * 0.1).astype(np.float32)
    ref = pallas_conv.windowed_sparse_conv(
        xj, jnp.asarray(w), jnp.asarray(plan.flip_perm),
        *(jnp.asarray(a) for a in (wp.win_start, wp.lidx, wp.spill_ent,
                                   wp.spill_fwd)))
    out = stencil_conv_fwd(x, torch.from_numpy(w), torch.from_numpy(plan.fwd))
    _check(out, ref, num, torch.bfloat16)
    assert stencil_conv_fwd.launches == 0


def test_down_wrapper_matches_windowed_kernel(interpret_mode, window_geo):
    geo = window_geo
    plan = geo.down[0]
    child, parent = geo.levels[0], geo.levels[1]
    ewp = pallas_edge.build_edge_window_plan(
        plan.fwd, plan.child_parent, plan.child_offset, int(child.num),
        int(parent.num))
    assert ewp is not None
    rng = np.random.default_rng(41)
    x, xj = _pair(_acts(rng, child.cap, int(child.num), 32), torch.bfloat16)
    w = (rng.standard_normal((8, 32, 32)) * 0.2).astype(np.float32)
    ref = pallas_edge.windowed_down_conv(xj, jnp.asarray(w),
                                         *(jnp.asarray(a) for a in ewp))
    out = down_conv_fwd(x, torch.from_numpy(w), _torch_down(geo, 0))
    _check(out, ref, int(parent.num), torch.bfloat16)
    assert down_conv_fwd.launches == 0
