"""The port's conv backward functions and autograd Functions against the
JAX package's VJPs, on the CPU.

(a) ``(dx, dW)`` of ``StencilConv``, ``DownConv`` and ``UpConv`` (which take
    their plain versions on the CPU) against ``jax.grad`` through
    ``sparse_conv`` / ``sparse_down_conv`` / ``sparse_up_conv`` on the same
    seeded inputs, plans and cotangents.
(b) The same against the JAX package's Pallas backward kernels run through
    the Pallas interpreter (``windowed_sparse_conv``, ``windowed_down_conv``,
    ``mixed_up_conv``).
(c) Each Function against autograd of a dense fp64 reference that is written
    without the gather plans.

Cotangents are exactly zero at padded rows, as in the model (BatchNorm
re-masks its output); the returned ``dx`` must then be exactly zero there.

Tolerances.  (a) fp32: 1e-5 of each output's scale (same exact products,
another summation order).  bf16: ``dx`` within one bf16 ulp of its scale
(``2**-7 * max|ref|``: an fp32 sum rounded once on each side), ``dW`` within
1e-3 of its scale (fp32 sums of exact bf16 products).  (b) the tolerances of
tests/test_pallas_conv_logic.py: ``dx`` 2e-2 and ``dW`` 5e-3 of their
scales.  (c) fp64: 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openscene_tpu.sparse import ops as jops
from openscene_tpu.sparse import pallas_conv, pallas_edge
from openscene_tpu_torch.sparse import ops
from openscene_tpu_torch.sparse.edge_conv import (DownConv, UpConv,
                                                  down_conv_bwd, up_conv_bwd)
from openscene_tpu_torch.sparse.geometry import build_unet_geometry
from openscene_tpu_torch.sparse.stencil_conv import (StencilConv,
                                                     stencil_conv_bwd)
from openscene_tpu_torch.sparse.types import ConvPlan
from tests.test_torch_sparse_ops import (_acts, _pair, _torch_down,
                                         geo, interpret_mode,  # noqa: F401
                                         window_geo)
from tests.test_torch_unet import _one_thread  # noqa: F401

BF16_ULP = 2.0 ** -7
DTYPES = [torch.float32, torch.bfloat16]


def _grads(fn, x, w, g):
    """(dx, dW) of a torch Function for the cotangent g."""
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_()
    fn(x, w).backward(g)
    return x.grad, w.grad


def _jax_grads(fn, xj, wj, gj):
    """(dx, dW) of a JAX function for the cotangent gj (its VJP)."""
    _, vjp = jax.vjp(fn, xj, wj)
    return vjp(gj)


def _check(got, ref, num, dtype, dx_tol=None, dw_tol=None):
    (dx, dw), (dx_ref, dw_ref) = got, ref
    dx, dw = dx.float().numpy(), dw.float().numpy()
    dx_ref = np.asarray(dx_ref, np.float32)
    dw_ref = np.asarray(dw_ref, np.float32)
    assert dx.shape == dx_ref.shape and dw.shape == dw_ref.shape
    if dx_tol is None:
        dx_tol, dw_tol = ((1e-5, 1e-5) if dtype == torch.float32
                          else (BF16_ULP, 1e-3))
    assert np.abs(dx - dx_ref).max() <= dx_tol * np.abs(dx_ref).max()
    assert np.abs(dw - dw_ref).max() <= dw_tol * np.abs(dw_ref).max()
    assert not dx[num:].any()


def _stencil_case(geo, level, cin, cout, dtype, seed):
    rng = np.random.default_rng(seed)
    lv, plan = geo.levels[level], geo.self3[level]
    num = int(lv.num)
    x, xj = _pair(_acts(rng, lv.cap, num, cin), dtype)
    g, gj = _pair(_acts(rng, lv.cap, num, cout), dtype)
    w = (rng.standard_normal((27, cin, cout)) * 0.1).astype(np.float32)
    return plan, num, x, xj, g, gj, w


def _edge_case(geo, edge, c_child, c_parent, dtype, seed):
    """Activations on both levels of an edge: (child, parent) pairs."""
    rng = np.random.default_rng(seed)
    child, parent = geo.levels[edge], geo.levels[edge + 1]
    plan = geo.down[edge]
    xc = _pair(_acts(rng, child.cap, int(child.num), c_child), dtype)
    xp = _pair(_acts(rng, parent.cap, int(parent.num), c_parent), dtype)
    return plan, int(child.num), int(parent.num), xc, xp, rng


# ---- (a) against the JAX VJPs ----

@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("level,cin,cout", [(0, 32, 64), (2, 96, 96)])
def test_stencil_conv_grads_match_jax(geo, dtype, level, cin, cout):
    plan, num, x, xj, g, gj, w = _stencil_case(geo, level, cin, cout, dtype,
                                               level)
    fwd, fp = torch.from_numpy(plan.fwd), torch.from_numpy(plan.flip_perm)
    wt = torch.from_numpy(w)
    ref = _jax_grads(lambda a, b: jops.sparse_conv(
        a, b, jnp.asarray(plan.fwd), jnp.asarray(plan.flip_perm)),
        xj, jnp.asarray(w), gj)
    got = _grads(lambda a, b: StencilConv.apply(a, b, ConvPlan(fwd, fp)),
                 x, wt, g)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _check(got, ref, num, dtype)
    # the wrapper and the plain function themselves; fp32 cotangent cast once
    for fn in (stencil_conv_bwd, ops.sparse_conv_bwd):
        _check(fn(x, wt, g.float(), fwd, fp), ref, num, dtype)
    assert stencil_conv_bwd.launches == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("edge,cin,cout", [(0, 32, 32), (2, 64, 96)])
def test_down_conv_grads_match_jax(geo, dtype, edge, cin, cout):
    plan, nc, np_, (x, xj), (g, gj), rng = _edge_case(geo, edge, cin, cout,
                                                      dtype, 10 + edge)
    w = (rng.standard_normal((8, cin, cout)) * 0.2).astype(np.float32)
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    tplan = _torch_down(geo, edge)
    wt = torch.from_numpy(w)
    ref = _jax_grads(lambda a, b: jops.sparse_down_conv(a, b, jplan), xj,
                     jnp.asarray(w), gj)
    got = _grads(lambda a, b: DownConv.apply(a, b, tplan), x, wt, g)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _check(got, ref, nc, dtype)
    for fn in (down_conv_bwd, ops.sparse_down_conv_bwd):
        _check(fn(x, wt, g.float(), tplan), ref, nc, dtype)
    assert down_conv_bwd.launches == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("edge,cin,cout", [(0, 64, 32), (3, 256, 128)])
def test_up_conv_grads_match_jax(geo, dtype, edge, cin, cout):
    plan, nc, np_, (g, gj), (x, xj), rng = _edge_case(geo, edge, cout, cin,
                                                      dtype, 20 + edge)
    w = (rng.standard_normal((8, cin, cout)) * 0.2).astype(np.float32)
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    tplan = _torch_down(geo, edge)
    wt = torch.from_numpy(w)
    ref = _jax_grads(lambda a, b: jops.sparse_up_conv(a, b, jplan), xj,
                     jnp.asarray(w), gj)
    got = _grads(lambda a, b: UpConv.apply(a, b, tplan), x, wt, g)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _check(got, ref, np_, dtype)
    for fn in (up_conv_bwd, ops.sparse_up_conv_bwd):
        _check(fn(x, wt, g.float(), tplan), ref, np_, dtype)
    assert up_conv_bwd.launches == 0


# ---- (b) against the Pallas backward kernels, run by the interpreter ----

PALLAS_TOL = dict(dx_tol=2e-2, dw_tol=5e-3)


def test_stencil_bwd_matches_windowed_kernel(interpret_mode, window_geo):
    plan, num, x, xj, g, gj, w = _stencil_case(window_geo, 0, 32, 32,
                                               torch.bfloat16, 40)
    cap = window_geo.levels[0].cap
    wp = pallas_conv.build_window_plan(plan.fwd, num, cap)
    assert wp is not None
    args = [jnp.asarray(a) for a in (plan.flip_perm, wp.win_start, wp.lidx,
                                     wp.spill_ent, wp.spill_fwd)]
    ref = _jax_grads(lambda a, b: pallas_conv.windowed_sparse_conv(
        a, b, *args), xj, jnp.asarray(w), gj)
    got = stencil_conv_bwd(x, torch.from_numpy(w), g,
                           torch.from_numpy(plan.fwd),
                           torch.from_numpy(plan.flip_perm))
    _check(got, ref, num, torch.bfloat16, **PALLAS_TOL)


def _edge_window_plan(geo):
    plan = geo.down[0]
    ewp = pallas_edge.build_edge_window_plan(
        plan.fwd, plan.child_parent, plan.child_offset,
        int(geo.levels[0].num), int(geo.levels[1].num))
    assert ewp is not None
    return ewp


def test_down_bwd_matches_windowed_kernel(interpret_mode, window_geo):
    plan, nc, np_, (x, xj), (g, gj), rng = _edge_case(
        window_geo, 0, 32, 32, torch.bfloat16, 41)
    w = (rng.standard_normal((8, 32, 32)) * 0.2).astype(np.float32)
    ewp = [jnp.asarray(a) for a in _edge_window_plan(window_geo)]
    ref = _jax_grads(lambda a, b: pallas_edge.windowed_down_conv(a, b, *ewp),
                     xj, jnp.asarray(w), gj)
    tplan = _torch_down(window_geo, 0)
    got = down_conv_bwd(x, torch.from_numpy(w), g, tplan)
    _check(got, ref, nc, torch.bfloat16, **PALLAS_TOL)


def test_up_bwd_matches_mixed_up_conv_kernel(interpret_mode, window_geo):
    plan, nc, np_, (g, gj), (x, xj), rng = _edge_case(
        window_geo, 0, 32, 64, torch.bfloat16, 42)
    w = (rng.standard_normal((8, 64, 32)) * 0.2).astype(np.float32)
    ewp = _edge_window_plan(window_geo)
    args = [jnp.asarray(a) for a in (
        plan.child_parent, plan.child_offset, ewp.dwin_start, ewp.dlidx,
        ewp.dspill_ent, ewp.dspill_fwd)]
    ref = _jax_grads(lambda a, b: pallas_edge.mixed_up_conv(a, b, *args),
                     xj, jnp.asarray(w), gj)
    tplan = _torch_down(window_geo, 0)
    got = up_conv_bwd(x, torch.from_numpy(w), g, tplan)
    _check(got, ref, np_, torch.bfloat16, **PALLAS_TOL)


# ---- (c) against autograd of a dense fp64 reference ----

@pytest.fixture(scope="module")
def tiny():
    """A 6 x 6 x 3 block with holes, its coordinates kept beside the plans."""
    rng = np.random.default_rng(7)
    pts = np.array([[0, x, y, z] for x in range(6) for y in range(6)
                    for z in range(3)], np.int32)
    pts = pts[rng.random(len(pts)) < 0.7]
    return build_unet_geometry(pts)


def _dense_grid(lv):
    coords = np.asarray(lv.coords)[:int(lv.num), 1:]
    return coords, tuple(coords.max(0) + 1)


def _f64(rng, cap, num, c):
    return torch.from_numpy(_acts(rng, cap, num, c).astype(np.float64))


def test_stencil_function_matches_dense_conv3d(tiny):
    lv, plan = tiny.levels[0], tiny.self3[0]
    num, cap = int(lv.num), lv.cap
    coords, dims = _dense_grid(lv)
    rng = np.random.default_rng(0)
    cin, cout = 5, 7
    x, g = _f64(rng, cap, num, cin), _f64(rng, cap, num, cout)
    w = torch.from_numpy(rng.standard_normal((27, cin, cout)))
    cx, cy, cz = (torch.from_numpy(coords[:, i]).long() for i in range(3))

    def dense(x_, w_):
        vol = torch.zeros(dims + (cin,), dtype=torch.float64).index_put(
            (cx, cy, cz), x_[:num])
        vol = vol.permute(3, 0, 1, 2)[None]
        # offsets in x-major order over (-1, 0, 1)^3 = conv3d's kernel layout
        kern = w_.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
        out = torch.nn.functional.conv3d(vol, kern, padding=1)[0]
        return out.permute(1, 2, 3, 0)[cx, cy, cz]

    fwd, fp = torch.from_numpy(plan.fwd), torch.from_numpy(plan.flip_perm)
    out = StencilConv.apply(x, w, ConvPlan(fwd, fp))
    torch.testing.assert_close(out[:num], dense(x, w), rtol=1e-10, atol=1e-10)
    dx, dw = _grads(lambda a, b: StencilConv.apply(a, b, ConvPlan(fwd, fp)),
                    x, w, g)
    dx_ref, dw_ref = _grads(
        lambda a, b: torch.nn.functional.pad(dense(a, b),
                                             (0, 0, 0, cap - num)), x, w, g)
    assert dx.dtype == dw.dtype == torch.float64
    torch.testing.assert_close(dx, dx_ref, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dw, dw_ref, rtol=1e-10, atol=1e-10)
    assert not dx[num:].any()


def _dense_down(x_child, w, child_lv, parent_lv):
    """out[p] = sum over children c of p: x[c] @ w[offset(c)], written with
    coordinates only (no plan): a strided dense conv3d."""
    cc, cdims = _dense_grid(child_lv)
    pc, _ = _dense_grid(parent_lv)
    dims = tuple(2 * ((d + 1) // 2) for d in cdims)
    idx = tuple(torch.from_numpy(cc[:, i]).long() for i in range(3))
    vol = torch.zeros(dims + (x_child.shape[1],), dtype=torch.float64
                      ).index_put(idx, x_child[:len(cc)])
    kern = w.reshape(2, 2, 2, w.shape[1], w.shape[2]).permute(4, 3, 0, 1, 2)
    out = torch.nn.functional.conv3d(vol.permute(3, 0, 1, 2)[None], kern,
                                     stride=2)[0]
    pidx = tuple(torch.from_numpy(pc[:, i]).long() for i in range(3))
    return out.permute(1, 2, 3, 0)[pidx]


def _dense_up(x_parent, w, child_lv, parent_lv):
    """out[c] = x[parent(c)] @ w[offset(c)]: a strided dense transposed
    conv3d read at the child coordinates."""
    cc, _ = _dense_grid(child_lv)
    pc, pdims = _dense_grid(parent_lv)
    pidx = tuple(torch.from_numpy(pc[:, i]).long() for i in range(3))
    vol = torch.zeros(pdims + (x_parent.shape[1],), dtype=torch.float64
                      ).index_put(pidx, x_parent[:len(pc)])
    kern = w.reshape(2, 2, 2, w.shape[1], w.shape[2]).permute(3, 4, 0, 1, 2)
    out = torch.nn.functional.conv_transpose3d(
        vol.permute(3, 0, 1, 2)[None], kern, stride=2)[0]
    idx = tuple(torch.from_numpy(cc[:, i]).long() for i in range(3))
    return out.permute(1, 2, 3, 0)[idx]


@pytest.mark.parametrize("which", ["down", "up"])
def test_edge_functions_match_dense_strided_convs(tiny, which):
    child, parent = tiny.levels[0], tiny.levels[1]
    nc, np_ = int(child.num), int(parent.num)
    tplan = _torch_down(tiny, 0)
    rng = np.random.default_rng(1)
    cin, cout = 5, 6
    w = torch.from_numpy(rng.standard_normal((8, cin, cout)))
    if which == "down":
        x, g = _f64(rng, child.cap, nc, cin), _f64(rng, parent.cap, np_, cout)
        fn, dense, n_in, n_out = DownConv, _dense_down, nc, np_
    else:
        x, g = _f64(rng, parent.cap, np_, cin), _f64(rng, child.cap, nc, cout)
        fn, dense, n_in, n_out = UpConv, _dense_up, np_, nc
    out = fn.apply(x, w, tplan)
    pad = out.shape[0] - n_out
    ref_fn = lambda a, b: torch.nn.functional.pad(
        dense(a, b, child, parent), (0, 0, 0, pad))
    torch.testing.assert_close(out, ref_fn(x, w), rtol=1e-10, atol=1e-10)
    dx, dw = _grads(lambda a, b: fn.apply(a, b, tplan), x, w, g)
    dx_ref, dw_ref = _grads(ref_fn, x, w, g)
    assert dx.dtype == dw.dtype == torch.float64
    torch.testing.assert_close(dx, dx_ref, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dw, dw_ref, rtol=1e-10, atol=1e-10)
    assert not dx[n_in:].any()
