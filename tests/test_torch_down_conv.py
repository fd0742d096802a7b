"""The down conv's kernels' iteration and tile choosers, on the CPU.

(a) A plain emulation of the kernels' iteration, on the edge's own layouts
    built from the JAX package's plans of a seeded synthetic scene, equals
    the JAX package's ``sparse_down_conv`` and its VJP (``jax.vjp``):
    the forward as skip-mode tiles of mask-sorted parents
    (``csrc/gather_gemm_fwd.cu`` on the edge's ``EdgeSkip``, active offsets
    only) at the chosen tiles and at 32 and 128 rows; ``dx`` as kernel 5's
    blocks of tiles over the groups with ``W[k]^T``
    (``csrc/up_conv_fwd.cu`` with ``W_NK``) at 1, 3 and the chosen tiles
    per block, every child written once, padded children zero; ``dW`` as
    ``csrc/gather_gemm_bwd.cu`` in group mode with the roles swapped (the
    parents' cotangent through ``child_parent``, the children's
    activations), in ``down_wgrad_tiles``' row splits, transposed.  fp32:
    1e-5 of each output's scale (same exact products, another summation
    order); bf16: one bf16 ulp of the scale (``2**-7 * max|ref|``) for the
    output and ``dx``, 1e-3 of the scale for ``dW``, the tolerances of
    ``tests/test_torch_up_conv.py``.
(b) ``down_tiles``, ``down_dx_tiles`` and ``down_wgrad_tiles`` return
    legal configurations for the down convs of every arch in ``ARCHS``
    (shared memory within the card's, MinkUNet50's 512 -> 512 bottleneck
    edge included).
(c) The model hands ``DownConv`` its geometry's own plan, and ``DownConv``
    hands the wrappers that plan, forward and backward.
"""

import jax
import numpy as np
import pytest
import torch

from openscene_tpu.sparse import ops as jops
from openscene_tpu.sparse.geometry import \
    build_unet_geometry as jax_build_geometry
from openscene_tpu_torch.models import sparse_unet
from openscene_tpu_torch.models.sparse_unet import ARCHS, MinkUNet
from openscene_tpu_torch.sparse import edge_conv as ec
from openscene_tpu_torch.sparse import stencil_conv as sc
from openscene_tpu_torch.sparse.geometry import (build_unet_geometry,
                                                 geometry_to_device)
from tests.test_torch_conv_skip import _emulate_gather_gemm
from tests.test_torch_sparse_ops import _acts, _pair, _surface, _torch_down
from tests.test_torch_unet import _one_thread  # noqa: F401
from tests.test_torch_up_conv import _check, _emulate_up_fwd

BF16_ULP = 2.0 ** -7
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module")
def jgeo():
    """The JAX package's plans of a seeded synthetic scene."""
    return jax_build_geometry(_surface(0, 3000, 70), build_windows=False)


# ---- (a) the kernels' iteration, emulated, against the JAX package ----

def _emulate_down_wgrad(x, g, plan):
    """``csrc/gather_gemm_bwd.cu`` in group mode as the down conv runs it,
    in fp32: offset k over its segment of the groups (its start derived
    from the counts as the kernel derives it), ``a`` the parents'
    cotangent, ``b`` the children, in the row splits of
    ``down_wgrad_tiles``, the partials added in order; returns dW^T."""
    cin, (pcap, cout) = x.shape[1], g.shape
    *_, per, splits = ec.down_wgrad_tiles(pcap, cin, cout)
    rows, count = plan.groups.rows.long(), plan.groups.count.tolist()
    cp = plan.child_parent.long()
    x, g = x.float(), g.float()
    dwt = torch.zeros((8, cout, cin))
    for k in range(8):
        seg0 = sum(-(-count[j] // ec.EDGE_TILE) * ec.EDGE_TILE
                   for j in range(k))
        assert count[k] <= splits * per  # the splits cover every child
        for s in range(splits):
            c = rows[seg0 + s * per:seg0 + min(count[k], (s + 1) * per)]
            dwt[k] = dwt[k] + g[cp[c]].t() @ x[c]
    return dwt


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("edge,cin,cout", [(0, 32, 32), (2, 64, 96)])
def test_emulated_down_kernels_match_jax(jgeo, dtype, edge, cin, cout):
    rng = np.random.default_rng(70 + edge)
    child, parent = jgeo.levels[edge], jgeo.levels[edge + 1]
    n_c, n_p = int(child.num), int(parent.num)
    x, xj = _pair(_acts(rng, child.cap, n_c, cin), dtype)
    g, gj = _pair(_acts(rng, parent.cap, n_p, cout), dtype)
    w = (rng.standard_normal((8, cin, cout)) * 0.2).astype(np.float32)
    wt = torch.from_numpy(w)
    if dtype == torch.bfloat16:  # the kernels multiply bf16 weights
        wt = wt.to(dtype).float()
        w = wt.numpy()
    plan = _torch_down(jgeo, edge)
    jplan = jax.tree_util.tree_map(jax.numpy.asarray, jgeo.down[edge])
    ref, vjp = jax.vjp(lambda a, b: jops.sparse_down_conv(a, b, jplan), xj,
                       jax.numpy.asarray(w))
    dx_ref, dw_ref = vjp(gj)
    tol = BF16_ULP if dtype == torch.bfloat16 else 1e-5

    # the forward: tiles of mask-sorted parents, the offsets they hold
    bm, _, groups, _ = ec.down_tiles(parent.cap, cin, cout)
    for tile, groups in sorted({(bm, groups), (32, 1), (128, 1)}):
        out = _emulate_gather_gemm(x, wt, plan.fwd, plan.skip, tile,
                                   groups).to(dtype)
        _check(out, ref, n_p, tol)
    # the skip plan leaves out most (parent, offset) steps
    steps = sum(bin(m).count("1") for m in plan.skip.tile_mask.tolist())
    assert steps < 8 * len(plan.skip.tile_mask)

    # dx: kernel 5's walk over the groups with W[k]^T
    chosen = ec.down_dx_tiles(child.cap, cin, cout)[1]
    for tpb in sorted({chosen, 1, 3}):  # 3: runs that cross segments
        dx = _emulate_up_fwd(g, wt.transpose(1, 2), plan, tpb).to(dtype)
        _check(dx, dx_ref, n_c, tol)

    # dW: group mode, a = the parents' cotangent, b = the children
    dw = _emulate_down_wgrad(x, g, plan).transpose(1, 2)
    _check(dw, dw_ref, None, 1e-3 if dtype == torch.bfloat16 else 1e-5)


# ---- (b) the tile choosers ----

def _down_widths(arch):
    """Cin = Cout of the four down convs of ``arch``."""
    a = ARCHS[arch]
    return [a.init_dim] + [a.planes[i] * a.expansion for i in range(3)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_down_tile_choosers_legal_for_every_width(arch):
    for c in _down_widths(arch):
        for cap in (4096, 9728, 36864, 136704, 300032, 1115648):
            bm, bn, groups, staged = ec.down_tiles(cap, c, c)
            assert bm in sc.FWD_ROW_TILES and bm % sc.TILE_ROWS == 0
            assert bn % 32 == 0 and 32 <= bn <= 256
            assert (bm // 32) * (bn // 32) <= sc.MAX_WARPS
            assert -(-c // bn) * bn - c < bn
            # the staged epilogue takes one offset group only
            assert groups in (1, 2, 4) and staged == (groups == 1)
            # dx over the children: Cout -> Cin, W[k]^T's slab in shared
            # memory
            bn, tpb = ec.down_dx_tiles(cap, c, c)
            assert bn % 32 == 0 and 32 <= bn <= 256
            assert 1 <= tpb <= ec.DOWN_DX_MAX_TPB
            assert ec._up_smem(c, bn, tpb, True) <= ec.UP_SMEM
            assert -(-c // bn) * bn - c < bn
            # dW: tiles of 32..128 channels, splits covering the parents
            bma, bnb, per, splits = ec.down_wgrad_tiles(cap, c, c)
            assert bma in sc.WGRAD_TILES and bnb in sc.WGRAD_TILES
            assert bma * bnb // 32 ** 2 <= sc.MAX_WARPS
            assert per % 32 == 0 and 1 <= splits <= 65535
            assert (splits - 1) * per < cap <= splits * per
    if arch == "MinkUNet50":
        # the 512-wide bottleneck edge: the slab is narrowed to fit
        bn, tpb = ec.down_dx_tiles(9728, 512, 512)
        assert bn < 256 and ec._up_smem(512, bn, tpb, True) <= ec.UP_SMEM


# ---- (c) the model and DownConv hand on the plan's own layouts ----

def test_down_conv_takes_the_plans_own_layouts(monkeypatch):
    coords = _surface(2, 900, 30)
    geo = geometry_to_device(build_unet_geometry(coords), "cpu")
    seen = []

    def spy(name):
        real = getattr(ec, name)

        def fn(x, w, *args):
            seen.append((name, args[-1]))
            return real(x, w, *args)
        return fn

    for name in ("down_conv_fwd", "down_conv_bwd"):
        monkeypatch.setattr(ec, name, spy(name))
    gen = torch.Generator().manual_seed(0)
    model = MinkUNet(3, 8, "MinkUNet14A", generator=gen).train()
    x = torch.zeros((geo.levels[0].cap, 3))
    x[:geo.levels[0].num] = 1
    model(x, geo, constant_input=True).sum().backward()
    fwd = [p for n, p in seen if n == "down_conv_fwd"]
    bwd = [p for n, p in seen if n == "down_conv_bwd"]
    # encoder order: edges 0, 1, 2, 3 forward, the reverse backward
    assert [id(p) for p in fwd] == [id(geo.down[e]) for e in range(4)]
    assert [id(p) for p in bwd] == [id(p) for p in fwd[::-1]]
    assert all(p.groups is not None and p.skip is not None for p in fwd)
    assert sparse_unet.DownConv is ec.DownConv
