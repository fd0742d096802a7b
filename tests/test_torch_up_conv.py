"""The up conv's edge layouts, its kernels' iteration and its tile chooser,
on the CPU.

(a) The port's device builder run on the CPU (``build_geometry_parts``,
    search and grid paths) and ``geometry_to_device`` of the NumPy builder
    give bit-identical edge groups and edge skip plans, and
    ``with_host_counts`` keeps them.
(b) ``build_edge_groups`` on the JAX package's own plans equals a NumPy
    derivation: every valid child exactly once, in its offset's segment, in
    ascending order, each segment starting on a tile; padded children
    nowhere; tile offsets and counts agree with ``child_offset``.  With a
    0-d tensor count it gives the same layout.
(c) ``build_edge_skip`` equals a NumPy derivation: each parent's mask is
    ``fwd`` against the child level's ``num`` at the parent level's valid
    rows, the stable sort and the tile ORs.
(d) A plain emulation of the kernels' iteration, on those layouts, equals
    the JAX package's ``sparse_up_conv`` and its VJP (``jax.vjp``): kernel
    5's blocks of tiles with their runs of one offset, the padded children
    written zero, every child row written once; ``dx`` over tiles of
    mask-sorted parents, active offsets only, ``W[k]`` read transposed;
    ``dW`` over each offset's segment of the groups in row splits summed in
    order.  fp32: 1e-5 of each output's scale (same exact products, another
    summation order); bf16: one bf16 ulp of the scale (``2**-7 *
    max|ref|``) for the output and ``dx``, 1e-3 of the scale for ``dW``,
    the tolerances of ``tests/test_torch_sparse_bwd.py``.
(e) ``up_tiles`` and ``up_dx_tiles`` return legal configurations for the
    up convs of every arch in ``ARCHS`` (shared memory within the card's,
    96 columns as one tile).
(f) The model hands ``UpConv`` its geometry's own plan, and ``UpConv``
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
from openscene_tpu_torch.sparse.geometry import (GeometryCaps,
                                                 build_unet_geometry,
                                                 geometry_to_device)
from openscene_tpu_torch.sparse.stencil_conv import TILE_ROWS
from openscene_tpu_torch.sparse.types import EdgeGroups, EdgeSkip
from tests.test_torch_conv_skip import _emulate_gather_gemm
from tests.test_torch_geometry_device import _caps, _port_build, _scenes
from tests.test_torch_sparse_ops import _acts, _pair, _surface, _torch_down
from tests.test_torch_unet import _one_thread  # noqa: F401

BF16_ULP = 2.0 ** -7
DTYPES = [torch.float32, torch.bfloat16]
T = ec.EDGE_TILE


@pytest.fixture(scope="module")
def jgeo():
    """The JAX package's plans of a seeded synthetic scene."""
    return jax_build_geometry(_surface(0, 3000, 70), build_windows=False)


def _assert_same(a, b, what):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype == torch.int32, (what, f)
        assert torch.equal(x, y), (what, f)


# ---- (a) the device builder and the host path give the same layouts ----

@pytest.mark.parametrize("path", ["search", "grid"])
def test_device_and_host_edge_layouts_identical(path):
    coords = _scenes(seed=4)
    caps = _caps(coords)
    geo, over = _port_build(coords, caps, path, occ=True)
    assert not over
    host = geometry_to_device(build_unet_geometry(
        coords, caps=GeometryCaps(cap0=caps[0], fixed=caps)), "cpu")
    for e, (d, h) in enumerate(zip(geo.down, host.down)):
        assert torch.equal(d.fwd, h.fwd)
        assert torch.equal(d.child_offset, h.child_offset)
        _assert_same(d.groups, h.groups, f"edge {e} groups")
        _assert_same(d.skip, h.skip, f"edge {e} skip")
        # with_host_counts read the counts and kept the layouts
        n_c, n_p = geo.levels[e].num, geo.levels[e + 1].num
        assert isinstance(n_c, int) and isinstance(n_p, int)
        again = ec.with_edge_layouts(d, n_c, n_p)
        _assert_same(again.groups, d.groups, f"rebuilt edge {e} groups")
        _assert_same(again.skip, d.skip, f"rebuilt edge {e} skip")


# ---- (b) the groups against NumPy ----

def _numpy_groups(off, num):
    cap = len(off)
    tiles = -(-cap // T) + 8
    rows = np.full(tiles * T, -1, np.int64)
    tile_k = np.full(tiles, -1, np.int64)
    count = np.zeros(8, np.int64)
    start = 0
    for k in range(8):
        members = np.nonzero(off[:num] == k)[0]
        count[k] = len(members)
        rows[start:start + len(members)] = members
        n_tiles = -(-len(members) // T)
        tile_k[start // T:start // T + n_tiles] = k
        start += n_tiles * T
    return dict(rows=rows, tile_k=tile_k, count=count)


@pytest.mark.parametrize("edge", range(4))
def test_edge_groups_match_numpy(jgeo, edge):
    off = np.asarray(jgeo.down[edge].child_offset)
    num = int(jgeo.levels[edge].num)
    got = ec.build_edge_groups(torch.from_numpy(off), num)
    ref = _numpy_groups(off, num)
    for f in EdgeGroups._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f],
                                      err_msg=f)
    # every valid child once, in its offset's segment; padded ones nowhere
    valid = got.rows[got.rows >= 0].long()
    assert torch.equal(valid.sort().values, torch.arange(num))
    for k, rows in ec._segments(got):
        assert (torch.from_numpy(off)[rows] == k).all()
        assert (rows.diff() > 0).all()
    _assert_same(ec.build_edge_groups(torch.from_numpy(off),
                                      torch.tensor(num)), got, "0-d num")


# ---- (c) the edge skip plan against NumPy ----

@pytest.mark.parametrize("edge", range(4))
def test_edge_skip_matches_numpy(jgeo, edge):
    fwd = np.asarray(jgeo.down[edge].fwd)
    n_c = int(jgeo.levels[edge].num)
    n_p = int(jgeo.levels[edge + 1].num)
    got = ec.build_edge_skip(torch.from_numpy(fwd), n_c, n_p)
    pcap = fwd.shape[1]
    bits = (fwd < n_c) & (np.arange(pcap) < n_p)[None, :]
    mask = (bits.astype(np.int64) << np.arange(8)[:, None]).sum(0)
    order = np.argsort(mask, kind="stable")
    tiles = -(-pcap // TILE_ROWS)
    sm = np.zeros(tiles * TILE_ROWS, np.int64)
    sm[:pcap] = mask[order]
    ref = dict(nbr_mask=mask, order=order,
               tile_mask=np.bitwise_or.reduce(sm.reshape(tiles, TILE_ROWS),
                                              1))
    for f in EdgeSkip._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f],
                                      err_msg=f)
    # each valid child is one bit of its parent's mask; padded parents none
    assert int(np.unpackbits(mask.astype(np.uint8)).sum()) == n_c
    assert not got.nbr_mask[n_p:].any()
    _assert_same(ec.build_edge_skip(torch.from_numpy(fwd), torch.tensor(n_c),
                                    torch.tensor(n_p)), got, "0-d nums")


# ---- (d) the kernels' iteration, emulated, against the JAX package ----

def _emulate_up_fwd(x, w, plan, tpb):
    """``csrc/up_conv_fwd.cu`` in fp32: blocks of ``tpb`` tiles, each run of
    one offset multiplied by that offset's weight, the padded children
    written zero; every child row must be written exactly once."""
    g = plan.groups
    rows, tile_k = g.rows.long(), g.tile_k.tolist()
    cp = plan.child_parent.long()
    x, w = x.float(), w.float()
    cap, tiles = cp.shape[0], len(tile_k)
    out = torch.full((cap, w.shape[2]), float("nan"))
    writes = torch.zeros(cap, dtype=torch.int64)
    num = int(g.count.sum())
    out[num:] = 0
    writes[num:] += 1
    for t0 in range(0, tiles, tpb):
        nt, t = min(tpb, tiles - t0), 0
        while t < nt and tile_k[t0 + t] >= 0:
            k = tile_k[t0 + t]
            te = t + 1
            while te < nt and tile_k[t0 + te] == k:
                te += 1
            for tile in range(t0 + t, t0 + te):
                c = rows[tile * T:(tile + 1) * T]
                c = c[c >= 0]
                out[c] = x[cp[c]] @ w[k]
                writes[c] += 1
            t = te
    assert (writes == 1).all()
    return out


def _emulate_up_wgrad(x, g, plan):
    """``csrc/gather_gemm_bwd.cu`` in group mode, in fp32: offset k over its
    segment of the groups (its start derived from the counts as the kernel
    derives it), in the row splits of ``up_wgrad_tiles``, the partials
    added in order."""
    pcap, cin = x.shape
    *_, per, splits = ec.up_wgrad_tiles(pcap, cin, g.shape[1])
    rows, count = plan.groups.rows.long(), plan.groups.count.tolist()
    cp = plan.child_parent.long()
    x, g = x.float(), g.float()
    dw = torch.zeros((8, cin, g.shape[1]))
    for k in range(8):
        seg0 = sum(-(-count[j] // T) * T for j in range(k))
        total = torch.zeros_like(dw[k])
        for s in range(splits):
            c = rows[seg0 + s * per:seg0 + min(count[k], (s + 1) * per)]
            total = total + x[cp[c]].t() @ g[c]
        dw[k] = total
    return dw


def _check(got, ref, num, tol):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    if num is not None:
        assert not got[num:].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("edge,cin,cout", [(0, 32, 64), (2, 96, 96)])
def test_emulated_up_kernels_match_jax(jgeo, dtype, edge, cin, cout):
    rng = np.random.default_rng(60 + edge)
    child, parent = jgeo.levels[edge], jgeo.levels[edge + 1]
    n_c, n_p = int(child.num), int(parent.num)
    x, xj = _pair(_acts(rng, parent.cap, n_p, cin), dtype)
    g, gj = _pair(_acts(rng, child.cap, n_c, cout), dtype)
    w = (rng.standard_normal((8, cin, cout)) * 0.2).astype(np.float32)
    wt = torch.from_numpy(w)
    if dtype == torch.bfloat16:  # the kernels multiply bf16 weights
        wt = wt.to(dtype).float()
        w = wt.numpy()
    plan = _torch_down(jgeo, edge)
    jplan = jax.tree_util.tree_map(jax.numpy.asarray, jgeo.down[edge])
    ref, vjp = jax.vjp(lambda a, b: jops.sparse_up_conv(a, b, jplan), xj,
                       jax.numpy.asarray(w))
    dx_ref, dw_ref = vjp(gj)
    tol = BF16_ULP if dtype == torch.bfloat16 else 1e-5
    chosen = ec.up_tiles(child.cap, cin, cout)[1]
    for tpb in sorted({chosen, 1, 3}):  # 3: runs that cross segments
        out = _emulate_up_fwd(x, wt, plan, tpb).to(dtype)
        _check(out, ref, n_c, tol)
    bm, _, groups = ec.up_dx_tiles(parent.cap, cin, cout)
    for tile, groups in sorted({(bm, groups), (32, 2), (128, 1)}):
        dx = _emulate_gather_gemm(g, wt.transpose(1, 2), plan.fwd, plan.skip,
                                  tile, groups).to(dtype)
        _check(dx, dx_ref, n_p, tol)
    dw = _emulate_up_wgrad(x, g, plan)
    _check(dw, dw_ref, None, 1e-3 if dtype == torch.bfloat16 else 1e-5)


# ---- (e) the tile chooser ----

def _up_widths(arch):
    """(Cin, Cout) of the four up convs of ``arch``."""
    a = ARCHS[arch]
    cin, out = a.planes[3] * a.expansion, []
    for i in range(4, 8):
        out.append((cin, a.planes[i]))
        cin = a.planes[i] * a.expansion
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_up_tile_chooser_legal_for_every_width(arch):
    for cin, cout in _up_widths(arch):
        for cap in (4096, 9728, 36864, 136704, 300032, 1115648):
            bn, tpb = ec.up_tiles(cap, cin, cout)
            assert bn % 32 == 0 and 32 <= bn <= 256
            assert 1 <= tpb <= ec.UP_MAX_TPB
            assert ec._up_smem(cin, bn, tpb) <= ec.UP_SMEM
            # no column tile lies wholly past the width
            assert -(-cout // bn) * bn - cout < bn
            # the backward's dx over the parents: Cout -> Cin
            bm, bn, groups = ec.up_dx_tiles(cap, cin, cout)
            assert bm == 64 and bn in (32, 64, 96, 128) and groups in (1, 2)
            assert -(-cin // bn) * bn - cin < bn
    # MinkUNet18A's decoder: each width one column tile, many tiles per
    # block only where the children are many
    assert [ec.up_tiles(c, ci, co)[0] for c, (ci, co) in zip(
        (9728, 36864, 136704, 300032), _up_widths("MinkUNet18A"))] == \
        [128, 128, 96, 96]
    assert ec.up_tiles(9728, 256, 128)[1] == 1
    assert ec.up_tiles(300032, 96, 96)[1] > 1


# ---- (f) the model and UpConv hand on the plan's own layouts ----

def test_up_conv_takes_the_plans_own_layouts(monkeypatch):
    coords = _surface(2, 900, 30)
    geo = geometry_to_device(build_unet_geometry(coords), "cpu")
    seen = []

    def spy(name):
        real = getattr(ec, name)

        def fn(x, w, *args):
            seen.append((name, args[-1]))
            return real(x, w, *args)
        return fn

    for name in ("up_conv_fwd", "up_conv_bwd"):
        monkeypatch.setattr(ec, name, spy(name))
    gen = torch.Generator().manual_seed(0)
    model = MinkUNet(3, 8, "MinkUNet14A", generator=gen).train()
    x = torch.zeros((geo.levels[0].cap, 3))
    x[:geo.levels[0].num] = 1
    model(x, geo, constant_input=True).sum().backward()
    fwd = [p for n, p in seen if n == "up_conv_fwd"]
    bwd = [p for n, p in seen if n == "up_conv_bwd"]
    # decoder order: edges 3, 2, 1, 0 forward, the reverse backward
    assert [id(p) for p in fwd] == [id(geo.down[e]) for e in (3, 2, 1, 0)]
    assert [id(p) for p in bwd] == [id(p) for p in fwd[::-1]]
    assert all(p.groups is not None and p.skip is not None for p in fwd)
    assert sparse_unet.UpConv is ec.UpConv
