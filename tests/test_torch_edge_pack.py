"""Kernel 5 (the up conv over the children) and kernel 7 (the pair-packed
transpose) of the port: their plain versions against the JAX package's
functions, on the CPU.

* ``up_conv_plain`` (``up_conv_fwd`` on a CPU tensor), driven by the edge's
  groups, against the JAX ``sparse_up_conv``, the forward of the JAX
  model's ``mixed_up_conv`` and the port's ``ops.sparse_up_conv``;
  ``UpConv`` forward, and backward by autograd, against ``jax.vjp`` of
  ``sparse_up_conv`` and against the JAX ``windowed_up_conv``, whose
  forward is kernel 5 and backward kernel 4, run by the Pallas interpreter.
  Tolerances: fp32 1e-5 of the output's scale (the same exact products
  summed in another order); bf16 one bf16 ulp of the scale for outputs and
  ``dx`` (an fp32 sum rounded once on each side), 1e-3 of the scale for
  ``dW``; against the interpreted Pallas kernels the tolerances of
  tests/test_pallas_conv_logic.py (``dx`` 2e-2, ``dW`` 5e-3).  Padded child
  rows of the output, and padded parent rows of ``dx``, exactly zero.
* ``build_edge_groups``: every valid child in exactly one tile of its
  offset, padded children in none.
* ``pack_pairs_t_plain`` (``pack_pairs_t`` on a CPU tensor) against the JAX
  ``_pack_t`` (``openscene_tpu/sparse/pallas_conv.py``), the function the
  JAX package's ``dev_pack_bench.py`` holds its kernel to: bit for bit, on
  random bit patterns (NaNs, infinities and signed zeros included).
* The wrappers refuse a tensor that is neither on the CPU nor on CUDA, and
  the edge layouts' builders stay on their input's device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openscene_tpu.sparse import ops as jops
from openscene_tpu.sparse import pallas_edge
from openscene_tpu.sparse.pallas_conv import _pack_t
from openscene_tpu_torch.sparse import ops
from openscene_tpu_torch.sparse.edge_conv import (EDGE_TILE, UpConv,
                                                  build_edge_groups,
                                                  build_edge_skip,
                                                  up_conv_bwd, up_conv_fwd,
                                                  up_conv_plain)
from openscene_tpu_torch.sparse.pack import pack_pairs_t, pack_pairs_t_plain
from openscene_tpu_torch.sparse.types import DownPlan
from tests.test_torch_sparse_bwd import (PALLAS_TOL, _check, _edge_case,
                                         _edge_window_plan, _grads,
                                         _jax_grads)
from tests.test_torch_sparse_ops import (_torch_down, geo,  # noqa: F401
                                         interpret_mode, window_geo)
from tests.test_torch_unet import _one_thread  # noqa: F401

BF16_ULP = 2.0 ** -7
DTYPES = [torch.float32, torch.bfloat16]


def _plans(geo, edge):
    return (_torch_down(geo, edge),
            jops.DownPlan(*(jnp.asarray(a) for a in geo.down[edge][:3])))


def _check_out(out, ref, num, dtype):
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    tol = 1e-5 if dtype == torch.float32 else BF16_ULP
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()
    assert not out[num:].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("edge,cin,cout", [(0, 32, 64), (2, 96, 96)])
def test_up_conv_plain_matches_jax(geo, dtype, edge, cin, cout):
    plan, nc, _, (g, _), (x, xj), rng = _edge_case(geo, edge, cout, cin,
                                                   dtype, 50 + edge)
    w = (rng.standard_normal((8, cin, cout)) * 0.2).astype(np.float32)
    tplan, jplan = _plans(geo, edge)
    ref = jops.sparse_up_conv(xj, jnp.asarray(w), jplan)
    # the JAX model's route: its forward needs no window plan
    dummy = [jnp.zeros((1,), jnp.int32)] * 4
    mixed = pallas_edge.mixed_up_conv(xj, jnp.asarray(w), jplan.child_parent,
                                      jplan.child_offset, *dummy)
    out = up_conv_fwd(x, torch.from_numpy(w), tplan)
    assert out.dtype == x.dtype
    _check_out(out, ref, nc, dtype)
    _check_out(out, mixed, nc, dtype)
    _check_out(up_conv_plain(x, torch.from_numpy(w), tplan), ref, nc, dtype)
    _check_out(ops.sparse_up_conv(x, torch.from_numpy(w), tplan),
               out.float().numpy(), nc, dtype)
    assert up_conv_fwd.launches == 0
    with pytest.raises(ValueError, match="EdgeGroups"):
        up_conv_plain(x, torch.from_numpy(w), tplan._replace(groups=None))


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_kernel_up_conv_grads_match_jax(geo, dtype):
    plan, nc, np_, (g, gj), (x, xj), rng = _edge_case(geo, 1, 48, 64,
                                                      dtype, 52)
    w = (rng.standard_normal((8, 64, 48)) * 0.2).astype(np.float32)
    tplan, jplan = _plans(geo, 1)

    def fn(a, b):
        return UpConv.apply(a, b, tplan)

    _check_out(fn(x, torch.from_numpy(w)).detach(),
               jops.sparse_up_conv(xj, jnp.asarray(w), jplan), nc, dtype)
    got = _grads(fn, x, torch.from_numpy(w), g)
    ref = _jax_grads(lambda a, b: jops.sparse_up_conv(a, b, jplan), xj,
                     jnp.asarray(w), gj)
    _check(got, ref, np_, dtype)
    # the plain backward alone, fp32 cotangent cast once
    _check(up_conv_bwd(x, torch.from_numpy(w), g.float(), tplan), ref, np_,
           dtype)
    assert up_conv_fwd.launches == up_conv_bwd.launches == 0


def test_kernel_up_conv_matches_windowed_kernel(interpret_mode, window_geo):
    plan, nc, np_, (g, gj), (x, xj), rng = _edge_case(
        window_geo, 0, 32, 64, torch.bfloat16, 53)
    w = (rng.standard_normal((8, 64, 32)) * 0.2).astype(np.float32)
    ewp = [jnp.asarray(a) for a in _edge_window_plan(window_geo)]
    tplan, _ = _plans(window_geo, 0)

    def jfn(a, b):
        return pallas_edge.windowed_up_conv(a, b, *ewp)

    def fn(a, b):
        return UpConv.apply(a, b, tplan)

    _check_out(fn(x, torch.from_numpy(w)).detach(),
               jfn(xj, jnp.asarray(w)), nc, torch.bfloat16)
    got = _grads(fn, x, torch.from_numpy(w), g)
    ref = _jax_grads(jfn, xj, jnp.asarray(w), gj)
    _check(got, ref, np_, torch.bfloat16, **PALLAS_TOL)


def test_group_children_partitions_the_rows(geo):
    for e, d in enumerate(geo.down):
        off = torch.from_numpy(np.asarray(d.child_offset))
        num = int(geo.levels[e].num)
        rows, k, count = build_edge_groups(off, num)
        cap = off.shape[0]
        tiles = -(-cap // EDGE_TILE) + 8
        assert rows.shape == (tiles * EDGE_TILE,) and k.shape == (tiles,)
        assert rows.dtype == k.dtype == count.dtype == torch.int32
        # the valid children, each once; the padded ones in no tile
        got = rows[rows >= 0].sort().values
        assert torch.equal(got, torch.arange(num, dtype=torch.int32))
        assert torch.equal(count.long(), torch.bincount(off[:num].long(),
                                                        minlength=8))
        per_tile = rows.view(tiles, EDGE_TILE)
        for t in range(tiles):
            members = per_tile[t][per_tile[t] >= 0].long()
            if k[t] < 0:
                assert members.numel() == 0
            else:
                assert members.numel() > 0 and (off[members] == k[t]).all()
        # tiles of one offset are contiguous and in row order (stable)
        assert (k[k >= 0].diff() >= 0).all()


@pytest.mark.parametrize("cap,c", [(128, 2), (256, 96), (384, 128),
                                   (1024, 256), (512, 10)])
def test_pack_plain_matches_jax_pack_t(cap, c):
    rng = np.random.default_rng(cap + c)
    bits = rng.integers(0, 2 ** 16, (cap, c), dtype=np.uint16)
    bits[0, :2] = (0x7FC0, 0xFF80)   # a NaN and -inf
    bits[1, :2] = (0x8000, 0x7F80)   # -0 and +inf
    x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    ref = np.asarray(_pack_t(jax.lax.bitcast_convert_type(
        jnp.asarray(bits), jnp.bfloat16)))
    for out in (pack_pairs_t(x), pack_pairs_t_plain(x)):
        assert out.dtype == torch.int32
        assert out.shape == ref.shape == (cap // 128, c // 2, 128)
        np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                      ref.view(np.uint32))
    assert pack_pairs_t.launches == 0
    with pytest.raises(ValueError, match="multiple of 128"):
        pack_pairs_t(x[:100])


def test_wrappers_never_fall_back_off_cpu():
    x = torch.empty((256, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        pack_pairs_t(x)
    plan = DownPlan(*(torch.empty(s, dtype=torch.int32, device="meta")
                      for s in ((8, 64), (256,), (256,))))
    # the edge layouts' builders run where their input lies, without a read
    # back (a meta tensor has no values to read)
    groups = build_edge_groups(plan.child_offset,
                               torch.zeros((), dtype=torch.int64,
                                           device="meta"))
    skip = build_edge_skip(plan.fwd, 256, torch.zeros((), device="meta"))
    assert all(t.device.type == "meta" for t in (*groups, *skip))
    plan = plan._replace(groups=groups, skip=skip)
    w = torch.empty((8, 32, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        up_conv_fwd(x[:64], w, plan)
    with pytest.raises(ValueError, match="CUDA tensor"):
        up_conv_bwd(x[:64], w, x, plan)
    with pytest.raises(ValueError, match="CUDA tensor"):
        UpConv.apply(x[:64], w, plan)
    assert (pack_pairs_t.launches == up_conv_fwd.launches
            == up_conv_bwd.launches == 0)
