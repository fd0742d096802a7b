"""The skip plan of the stencil kernels and the tile chooser, on the CPU.

(a) ``build_conv_skip`` on the JAX package's own plans (``build_unet_geometry``
    on a seeded synthetic scene, all 5 levels) equals a NumPy derivation:
    neighbour-mask bits, the stable sort, the tile ORs, the pair lists and
    counts; with a 0-d tensor ``num`` it gives the same plan.
(b) The port's device builder run on the CPU (``build_geometry_parts``,
    search and grid paths) and ``geometry_to_device`` of the NumPy builder
    give identical skip plans, and ``with_host_counts`` keeps them.
(c) ``fwd_tiles`` and ``wgrad_tiles`` return legal configurations for every
    width of every arch in ``ARCHS`` and for the K=125 stem and the K=8
    edges.
(d) A plain emulation of the kernels' iteration (forward and ``dx``: tiles of
    sorted rows, active offsets only, missing rows gathered as zeros, with
    and without offset groups; ``dW``:
    the compacted pairs of each offset in row splits summed in order) equals
    the JAX package's ``sparse_conv`` and its VJP (``jax.vjp``).  fp32: 1e-5
    of each output's scale (same exact products, another summation order);
    bf16: one bf16 ulp of the scale (``2**-7 * max|ref|``) for the output and
    ``dx``, 1e-3 of the scale for ``dW``, the tolerances of
    ``tests/test_torch_sparse_bwd.py``.
(e) ``StencilConv`` hands the wrappers the ``fwd`` and the skip plan of the
    one ``ConvPlan`` it is given, forward and backward.
"""

import jax
import numpy as np
import pytest
import torch

from openscene_tpu.sparse import ops as jops
from openscene_tpu.sparse.geometry import \
    build_unet_geometry as jax_build_geometry
from openscene_tpu_torch.models.sparse_unet import ARCHS
from openscene_tpu_torch.sparse import stencil_conv as sc
from openscene_tpu_torch.sparse.geometry import (GeometryCaps,
                                                 build_unet_geometry,
                                                 geometry_to_device)
from openscene_tpu_torch.sparse.types import ConvPlan, ConvSkip
from tests.test_torch_geometry_device import _caps, _port_build, _scenes
from tests.test_torch_sparse_ops import _acts, _pair, _surface
from tests.test_torch_unet import _one_thread  # noqa: F401

BF16_ULP = 2.0 ** -7
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module")
def jgeo():
    """The JAX package's plans of a seeded synthetic scene."""
    return jax_build_geometry(_surface(0, 3000, 70), build_windows=False)


def _numpy_skip(fwd, num, tile_rows):
    """The skip plan written out in NumPy."""
    K, cap = fwd.shape
    bits = (fwd < num) & (np.arange(cap) < num)[None, :]
    mask = (bits.astype(np.int64) << np.arange(K)[:, None]).sum(0)
    order = np.argsort(mask, kind="stable")
    tiles = -(-cap // tile_rows)
    sorted_mask = np.zeros(tiles * tile_rows, np.int64)
    sorted_mask[:cap] = mask[order]
    tile_mask = np.bitwise_or.reduce(sorted_mask.reshape(tiles, tile_rows), 1)
    pair_rows = np.full((K, cap), cap - 1, np.int64)
    for k in range(K):
        rows = np.nonzero(bits[k])[0]
        pair_rows[k, :len(rows)] = rows
    return dict(nbr_mask=mask, order=order, tile_mask=tile_mask,
                pair_rows=pair_rows, pair_count=bits.sum(1))


def _assert_skip_equal(a: ConvSkip, b: ConvSkip, what=""):
    for f in ConvSkip._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype == torch.int32, (what, f)
        assert torch.equal(x, y), (what, f)


# ---- (a) the skip plan against NumPy ----

@pytest.mark.parametrize("level", range(5))
def test_skip_plan_matches_numpy(jgeo, level):
    fwd = np.asarray(jgeo.self3[level].fwd)
    num = int(jgeo.levels[level].num)
    got = sc.build_conv_skip(torch.from_numpy(fwd), num)
    ref = _numpy_skip(fwd, num, sc.TILE_ROWS)
    for f in ConvSkip._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f],
                                      err_msg=f)
    # only rows whose neighbour exists hold pairs; the centre offset of a
    # k=3 stencil pairs every valid row with itself
    assert int(got.pair_count[13]) == num
    assert not got.nbr_mask[num:].any()
    _assert_skip_equal(sc.build_conv_skip(torch.from_numpy(fwd),
                                          torch.tensor(num)), got, "0-d num")


def test_skip_plan_rejects_wide_stencils(jgeo):
    with pytest.raises(ValueError, match="int32 neighbour mask"):
        sc.build_conv_skip(torch.from_numpy(np.asarray(jgeo.stem.fwd)),
                           int(jgeo.levels[0].num))


# ---- (b) the device builder and the host path give the same skip plans ----

@pytest.mark.parametrize("path", ["search", "grid"])
def test_device_and_host_skip_plans_identical(path):
    coords = _scenes(seed=3)
    caps = _caps(coords)
    geo, over = _port_build(coords, caps, path, occ=True)
    assert not over
    host = geometry_to_device(build_unet_geometry(
        coords, caps=GeometryCaps(cap0=caps[0], fixed=caps)), "cpu")
    assert host.stem.skip is None
    for lvl, (p, q) in enumerate(zip(geo.self3, host.self3)):
        assert torch.equal(p.fwd, q.fwd)
        assert p.skip is not None and q.skip is not None
        _assert_skip_equal(p.skip, q.skip, f"level {lvl}")
        # with_host_counts read the counts and kept the skip plans
        assert isinstance(geo.levels[lvl].num, int)
        _assert_skip_equal(p.skip, sc.build_conv_skip(
            p.fwd, geo.levels[lvl].num), f"rebuilt level {lvl}")


# ---- (c) the tile chooser ----

def _widths(arch):
    """(Cin, Cout) of every k=3 conv of ``arch``, forward and ``dx``."""
    a = ARCHS[arch]
    shapes = set()
    enc = [a.init_dim] + [a.planes[i] * a.expansion for i in range(4)]
    cin = a.init_dim
    for i in range(8):
        if i >= 4:
            cin = a.planes[i] + enc[7 - i]
        for _ in range(a.layers[i]):
            if a.block == "basic":
                shapes |= {(cin, a.planes[i]), (a.planes[i], a.planes[i])}
            else:
                shapes.add((a.planes[i], a.planes[i]))
            cin = a.planes[i] * a.expansion
    return shapes | {(co, ci) for ci, co in shapes}


def _assert_fwd_legal(rows, K, cin, cout, skip=False):
    bm, bn, groups = sc.fwd_tiles(rows, K, cin, cout, skip)
    assert bm in sc.FWD_ROW_TILES and bn in sc.FWD_COL_TILES
    assert groups in (1, 2, 4, 8) and groups <= min(K, sc.FWD_MAX_GROUPS)
    assert bm % sc.TILE_ROWS == 0
    warps = (bm // sc.WARP_TILE) * (bn // sc.WARP_TILE)
    assert warps <= sc.MAX_WARPS
    assert warps <= sc.FWD_WARPS or bm == min(sc.FWD_ROW_TILES)
    # offset groups only where the row tiles leave the card short
    assert groups == 1 or -(-rows // bm) * -(-cout // bn) * groups // 2 \
        < sc.FWD_TARGET_BLOCKS
    # no column tile lies wholly past the width, and a width that is a
    # tile is one tile: each row is gathered once
    assert -(-cout // bn) * bn - cout < bn
    if cout in sc.FWD_COL_TILES:
        assert bn == cout, (cout, bn)
    return bm, bn


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tile_chooser_legal_for_every_width(arch):
    for cin, cout in sorted(_widths(arch)):
        for rows in (4096, 9728, 36864, 136704, 300032, 1115648):
            _assert_fwd_legal(rows, 27, cin, cout, True)
            for skip in (False, True):
                bma, bnb, per, splits = sc.wgrad_tiles(rows, 27, cin, cout,
                                                       skip)
                assert -(-cin // bma) * bma - cin < bma
                assert -(-cout // bnb) * bnb - cout < bnb
                assert (splits - 1) * per < rows <= splits * per


def test_tile_chooser_stem_edges_and_small_levels():
    # the colour stem (3 channels padded to 8) and its dx, densely
    for cin, cout in ((8, 32), (32, 8)):
        _assert_fwd_legal(300032, 125, cin, cout)
    # the K=8 edges: down convs, up-conv dx, down-conv dx
    for cin, cout in ((32, 32), (64, 64), (128, 128), (96, 96), (128, 96),
                      (256, 128), (96, 128), (128, 256)):
        _assert_fwd_legal(136704, 8, cin, cout)
        assert sc.wgrad_tiles(136704, 8, cin, cout, False)[3] >= 1
    # the K=8 down conv at 32 channels has too few steps per tile to split
    assert sc.fwd_tiles(61952, 8, 32, 32) == (128, 32, 1)
    # the small levels split each tile's offsets, so they still fill the
    # SMs; L0 does not
    big, _, one = sc.fwd_tiles(300032, 27, 128, 96, True)
    small, _, groups = sc.fwd_tiles(4096, 27, 256, 256, True)
    assert small == min(sc.FWD_ROW_TILES) < big and one == 1 < groups
    assert -(-4096 // small) * groups >= sc.FWD_TARGET_BLOCKS
    assert sc.fwd_tiles(9728, 27, 384, 128, True)[2] == sc.FWD_MAX_GROUPS


# ---- (d) the kernels' iteration, emulated, against the JAX package ----

def _emulate_gather_gemm(x, w, fwd, skip, bm, groups=1):
    """``csrc/gather_gemm_fwd.cu`` in skip mode, in fp32: tiles of ``bm``
    sorted rows, the offsets of the tile's OR in ascending order (split into
    ``groups`` equal shares whose partials are added in order), rows whose
    own bit is clear gathered as zeros, each row written once."""
    K, cap = fwd.shape
    x, w = x.float(), w.float()
    order = skip.order.long()
    nbr = skip.nbr_mask.long()
    tmask = skip.tile_mask.tolist()
    out = torch.zeros((cap, w.shape[2]))
    for r0 in range(0, cap, bm):
        rows = order[r0:r0 + bm]
        m = 0
        for q in range(r0 // sc.TILE_ROWS,
                       min(len(tmask), (r0 + bm) // sc.TILE_ROWS)):
            m |= tmask[q]
        ks = [k for k in range(K) if (m >> k) & 1]
        assert not (nbr[rows] & ~m).any()  # a tile's OR covers its rows
        total = None
        for g in range(groups):
            part = torch.zeros((len(rows), w.shape[2]))
            for k in ks[g * len(ks) // groups:(g + 1) * len(ks) // groups]:
                own = ((nbr[rows] >> k) & 1).float()
                part += (x[fwd[k].long()[rows]] * own[:, None]) @ w[k]
            total = part if total is None else total + part
        out[rows] = total
    return out


def _emulate_wgrad(a, b, fwd, skip):
    """``csrc/gather_gemm_bwd.cu`` in skip mode, in fp32: each offset over
    its compacted pairs, split as ``wgrad_tiles`` splits them, the partials
    added in order."""
    K, rows = fwd.shape
    *_, per, splits = sc.wgrad_tiles(rows, K, a.shape[1], b.shape[1], True)
    a, b = a.float(), b.float()
    dw = torch.zeros((K, a.shape[1], b.shape[1]))
    for k in range(K):
        n_k = int(skip.pair_count[k])
        total = torch.zeros_like(dw[k])
        for s in range(splits):
            p = skip.pair_rows[k, s * per:min(n_k, (s + 1) * per)].long()
            total = total + a[p].t() @ b[fwd[k].long()[p]]
        dw[k] = total
    return dw


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("level,cin,cout", [(0, 32, 64), (1, 96, 96),
                                            (2, 64, 32)])
def test_emulated_kernels_match_jax(jgeo, dtype, level, cin, cout):
    rng = np.random.default_rng(40 + level)
    lv, plan = jgeo.levels[level], jgeo.self3[level]
    num = int(lv.num)
    x, xj = _pair(_acts(rng, lv.cap, num, cin), dtype)
    g, gj = _pair(_acts(rng, lv.cap, num, cout), dtype)
    w = (rng.standard_normal((27, cin, cout)) * 0.1).astype(np.float32)
    fwd = torch.from_numpy(np.asarray(plan.fwd))
    perm = torch.from_numpy(np.asarray(plan.flip_perm)).long()
    skip = sc.build_conv_skip(fwd, num)
    wt = torch.from_numpy(w)
    if dtype == torch.bfloat16:  # the kernels multiply bf16 weights
        wt = wt.to(dtype).float()
        w = wt.numpy()

    def conv(a, b):
        return jops.sparse_conv(a, b, jax.numpy.asarray(plan.fwd),
                                jax.numpy.asarray(plan.flip_perm))

    ref, vjp = jax.vjp(conv, xj, jax.numpy.asarray(w))
    dx_ref, dw_ref = vjp(gj)
    bm = sc.fwd_tiles(lv.cap, 27, cin, cout, True)[0]
    for tile, groups in sorted({(bm, 1), (32, 3), (128, 1)}):
        out = _emulate_gather_gemm(x, wt, fwd, skip, tile, groups).to(dtype)
        dx = _emulate_gather_gemm(
            g, wt.index_select(0, perm).transpose(1, 2), fwd, skip, tile,
            groups).to(dtype)
        _check(out, ref, num, BF16_ULP if dtype == torch.bfloat16 else 1e-5)
        _check(dx, dx_ref, num,
               BF16_ULP if dtype == torch.bfloat16 else 1e-5)
    dw = _emulate_wgrad(x, g, fwd, skip).index_select(0, perm)
    _check(dw, dw_ref, None, 1e-3 if dtype == torch.bfloat16 else 1e-5)


def _check(got, ref, num, tol):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    if num is not None:
        assert not got[num:].any()


# ---- (e) StencilConv keeps a plan's skip plan with its own fwd ----

def test_stencil_conv_takes_the_plans_own_skip(jgeo, monkeypatch):
    plan = jgeo.self3[1]
    num = int(jgeo.levels[1].num)
    fwd = torch.from_numpy(np.asarray(plan.fwd))
    tplan = ConvPlan(fwd, torch.from_numpy(np.asarray(plan.flip_perm)),
                     sc.build_conv_skip(fwd, num))
    seen = []

    def spy(name):
        real = getattr(sc, name)

        def fn(*args):
            seen.append((name, args[-3 if name == "stencil_conv_bwd" else -2],
                         args[-1]))
            return real(*args)
        return fn

    for name in ("stencil_conv_fwd", "stencil_conv_bwd"):
        monkeypatch.setattr(sc, name, spy(name))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_acts(rng, fwd.shape[1], num, 8)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((27, 8, 8)).astype(np.float32))
    sc.StencilConv.apply(x, w.requires_grad_(), tplan).sum().backward()
    assert [s[0] for s in seen] == ["stencil_conv_fwd", "stencil_conv_bwd"]
    for _, f, skip in seen:
        assert f is tplan.fwd and skip is tplan.skip
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
