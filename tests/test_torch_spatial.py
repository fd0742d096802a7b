"""Spatial sharding of one scene (``parallel/spatial.py``) against the JAX
package's ``openscene_tpu/parallel/spatial.py`` and the one-device conv.

Inputs are ``tests/test_spatial_sharding.py``'s: its surface-like scene
(``_scene``), seeded numpy features and weights.

* ``build_spatial_shards``, ``shard_rows`` and ``unshard_rows`` equal the
  JAX package's bit for bit at D = 2 and 8.
* The transpose plan equals a dense inversion of ``fwd``, and the skip
  plans count exactly the local and remote neighbours found by a set
  lookup of the coordinates, per offset.  The kernels' iteration, emulated
  on the CPU (``tests/test_torch_conv_skip.py``), gives the plain conv and
  its backward on these skip plans; on the default skip plan of the same
  ``fwd`` (``fwd < num``) it drops the halo neighbours of boundary rows.
* ``SpatialConv`` on D gloo ranks of CPU processes
  (``parallel/launch.spawn``, a timeout on each run), forward at D = 2 and
  4 against ``make_spatial_conv`` on the virtual 8-device mesh and against
  the one-device ``sparse_conv`` (``atol=1e-5``, the JAX test's bound);
  gradients at D = 4 of a fixed cotangent against ``jax.grad`` of the
  one-device conv (``dW`` ``rtol=1e-4, atol=1e-3``; ``dx`` ``atol=1e-4``,
  the JAX test's bounds), ``dW`` identical on every rank.  The ranks run
  in the background while JAX computes its references.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from openscene_tpu_torch.parallel.launch import spawn
from openscene_tpu_torch.parallel.spatial import (
    build_spatial_shards, fwd_exists, make_spatial_conv, shard_plan,
    shard_rows, spatial_conv_bwd_plain, spatial_conv_plain,
    transpose_plan, unshard_rows)
from openscene_tpu_torch.sparse import stencil_conv as sc
from openscene_tpu_torch.sparse.types import stencil_offsets

TIMEOUT = 180  # seconds for one spawned run of ranks
CIN, COUT = 16, 24          # the JAX test's forward widths
GCIN, GCOUT = 8, 8          # and its gradient test's


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- what runs on each rank (top level: the ranks import this module) ----

def _rank_conv(coords, n_shards, x, w, g):
    """This rank's ``SpatialConv`` of the scene's features ``x`` (N, Cin):
    (y shard, and with a cotangent ``g`` (N, Cout) dx shard and dW)."""
    torch.set_num_threads(1)
    shards = build_spatial_shards(coords, n_shards)
    f = make_spatial_conv(None, shards, device="cpu")
    rank = dist.get_rank()
    xs = torch.from_numpy(shard_rows(x, shards)[rank]).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = f(xs, wt)
    out = {"y": y.detach().numpy()}
    if g is not None:
        gs = torch.from_numpy(shard_rows(g, shards)[rank])
        (y * gs).sum().backward()
        out.update(dx=xs.grad.numpy(), dw=wt.grad.numpy())
    return out


def _spatial_rank(fwd_case, grad_case):
    """Every rank's forward of ``fwd_case`` and, where given, gradients of
    ``grad_case``, gathered to rank 0 in rank order."""
    out = {"fwd": _rank_conv(*fwd_case, None)}
    if grad_case is not None:
        out["grad"] = _rank_conv(*grad_case)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, out)
    return parts


# ---- inputs and references ----

def _inputs(seed_x, n, cin, cout, grad=False):
    rng = np.random.default_rng(seed_x)
    x = rng.standard_normal((n, cin)).astype(np.float32)
    w = rng.standard_normal((27, cin, cout)).astype(np.float32) * 0.1
    g = rng.standard_normal((n, cout)).astype(np.float32) if grad else None
    return x, w, g


@pytest.fixture(scope="module")
def scenes():
    from tests.test_spatial_sharding import _scene
    return {"fwd": _scene(), "grad": _scene(nx=32, ny=32, seed=3)}


@pytest.fixture(scope="module")
def cases(scenes):
    c = scenes["fwd"]
    gc = scenes["grad"]
    fx, fw, _ = _inputs(1, len(c), CIN, COUT)
    gx, gw, gg = _inputs(4, len(gc), GCIN, GCOUT, grad=True)
    return {"fwd": (c, fx, fw), "grad": (gc, gx, gw, gg)}


@pytest.fixture(scope="module")
def rank_runs(cases):
    """The spawned runs, started together in the background: D=2 (forward)
    and D=4 (forward and gradients)."""
    c, fx, fw = cases["fwd"]
    gc, gx, gw, gg = cases["grad"]
    with ThreadPoolExecutor(2) as pool:
        yield {2: pool.submit(spawn, _spatial_rank, 2, (c, 2, fx, fw), None,
                              device="cpu", timeout=TIMEOUT),
               4: pool.submit(spawn, _spatial_rank, 4, (c, 4, fx, fw),
                              (gc, 4, gx, gw, gg), device="cpu",
                              timeout=TIMEOUT)}


def _one_device(coords, x, w):
    """The JAX test's one-device reference: ``sparse_conv`` on the scene's
    own plan."""
    from tests.test_spatial_sharding import _reference
    return _reference(coords, x, w)


def _jax_sharded(coords, n_shards, x, w):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from openscene_tpu.parallel import spatial as jsp
    shards = jsp.build_spatial_shards(coords, n_shards, kernel_size=3)
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("space",))
    f = jsp.make_spatial_conv(mesh, shards, axis="space")
    return jsp.unshard_rows(f(jsp.shard_rows(x, shards), jnp.asarray(w)),
                            shards)


# ---- the host builder, bit for bit ----

@pytest.mark.parametrize("n_shards", [2, 8])
def test_builder_bit_equal_to_jax(scenes, n_shards):
    from openscene_tpu.parallel import spatial as jsp
    coords = scenes["fwd"]
    ref = jsp.build_spatial_shards(coords, n_shards, kernel_size=3)
    got = build_spatial_shards(coords, n_shards, kernel_size=3)
    assert got._fields == ref._fields
    for name in ref._fields:
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.halo_cap < got.cap_d
    x = np.random.default_rng(7).standard_normal(
        (len(coords), 5)).astype(np.float32)
    xs = shard_rows(x, got)
    assert np.array_equal(xs, jsp.shard_rows(x, ref))
    assert not any(xs[d, got.num[d]:].any() for d in range(n_shards))
    assert np.array_equal(unshard_rows(xs, got), jsp.unshard_rows(xs, ref))
    assert np.array_equal(unshard_rows(xs, got), x)


# ---- the transpose plan and the skip plans ----

def _neighbour_pairs(coords, shards, d):
    """(K, n_d) bool: found neighbours of shard d's rows by a set lookup of
    the coordinates (local or remote), and which of them are remote."""
    sc_ = np.asarray(coords)[shards.perm]
    owner = {tuple(c): i for i, c in enumerate(sc_.tolist())}
    lo, hi = int(shards.starts[d]), int(shards.starts[d + 1])
    offs = stencil_offsets(3)
    found = np.zeros((len(offs), hi - lo), bool)
    remote = np.zeros_like(found)
    for r in range(hi - lo):
        b, x, y, z = sc_[lo + r]
        for k, (dx, dy, dz) in enumerate(offs.tolist()):
            j = owner.get((b, x + dx, y + dy, z + dz))
            if j is not None:
                found[k, r] = True
                remote[k, r] = not lo <= j < hi
    return found, remote


@pytest.mark.parametrize("n_shards", [2, 4])
def test_transpose_plan_is_the_inverse_of_fwd(scenes, n_shards):
    coords = scenes["grad"]
    shards = build_spatial_shards(coords, n_shards)
    K, cap_d, H = 27, shards.cap_d, shards.halo_cap
    for d in range(n_shards):
        n = int(shards.num[d])
        f = shards.fwd[d]
        dense = np.zeros((K, cap_d + H, cap_d), bool)  # [k, source, output]
        for k in range(K):
            for r in range(n):
                if f[k, r] < n or f[k, r] >= cap_d:
                    dense[k, f[k, r], r] = True
        assert (dense.sum(2) <= 1).all()  # one output per (k, source)
        want = np.where(dense.any(2), dense.argmax(2), -1)
        bwd = transpose_plan(shards, d)
        assert np.array_equal(bwd, want)
        assert (bwd[:, n:cap_d] == -1).all()  # local padding rows
        n_halo = len(np.unique(f[:, :n][f[:, :n] >= cap_d]))
        assert (bwd[:, cap_d + n_halo:] == -1).all()  # halo padding


@pytest.mark.parametrize("n_shards", [2, 4])
def test_skip_plan_pair_counts(scenes, n_shards):
    """The trap of ``build_conv_skip``'s ``fwd < num`` rule: the shards'
    skip plans, built from explicit existence bits, count every local and
    remote neighbour; the default rule loses the remote ones."""
    coords = scenes["grad"]
    shards = build_spatial_shards(coords, n_shards)
    lost = 0
    for d in range(n_shards):
        found, remote = _neighbour_pairs(coords, shards, d)
        n = found.shape[1]
        plan = shard_plan(shards, d, "cpu")
        assert plan.fwd_skip.pair_count.tolist() == found.sum(1).tolist()
        assert plan.bwd_skip.pair_count.tolist() == found.sum(1).tolist()
        assert np.array_equal(fwd_exists(shards, d)[:, :n], found)
        bits = (plan.fwd_skip.nbr_mask[:n, None].numpy()
                >> np.arange(27)) & 1
        assert np.array_equal(bits.T.astype(bool), found)
        default = sc.build_conv_skip(plan.fwd, n)
        assert (default.pair_count.numpy()
                == (found & ~remote).sum(1)).all()
        lost += int(remote.sum())
        assert plan.n_halo == len(np.unique(
            shards.fwd[d][:, :n][shards.fwd[d][:, :n] >= shards.cap_d]))
    assert lost > 0


def _close(got, ref):
    """Within 1e-5 of the reference's scale: the same fp32 products summed
    in another order (``tests/test_torch_conv_skip.py``'s fp32 bound)."""
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_emulated_kernels_on_the_shard_plans(scenes, n_shards):
    """The kernels' iteration (emulated) on the shards' skip plans equals
    the plain conv and its backward over the extended buffer; on the default
    skip plan it drops remote neighbours."""
    from tests.test_torch_conv_skip import (_emulate_gather_gemm,
                                            _emulate_wgrad)
    coords = scenes["grad"]
    shards = build_spatial_shards(coords, n_shards)
    rng = np.random.default_rng(9)
    w = torch.from_numpy((rng.standard_normal((27, 8, 16)) * 0.1)
                         .astype(np.float32))
    differs = 0
    for d in range(n_shards):
        plan = shard_plan(shards, d, "cpu")
        n = plan.num
        ext = torch.zeros((plan.cap_d + plan.halo_cap, 8))
        ext[:n] = torch.from_numpy(rng.standard_normal((n, 8))
                                   .astype(np.float32))
        ext[plan.cap_d:plan.cap_d + plan.n_halo] = torch.from_numpy(
            rng.standard_normal((plan.n_halo, 8)).astype(np.float32))
        g = torch.zeros((plan.cap_d, 16))
        g[:n] = torch.from_numpy(rng.standard_normal((n, 16))
                                 .astype(np.float32))
        y = spatial_conv_plain(ext, w, plan)
        d_ext, dw = spatial_conv_bwd_plain(ext, w, g, plan)
        bm = sc.fwd_tiles(plan.cap_d, 27, 8, 16, True)[0]
        got = _emulate_gather_gemm(ext, w, plan.fwd, plan.fwd_skip, bm)
        _close(got, y)
        got_dx = _emulate_gather_gemm(g, w.transpose(1, 2), plan.bwd,
                                      plan.bwd_skip, 32)
        _close(got_dx, d_ext)
        assert not d_ext[n:plan.cap_d].any()
        assert not d_ext[plan.cap_d + plan.n_halo:].any()
        got_dw = _emulate_wgrad(ext, g, plan.bwd, plan.bwd_skip)
        _close(got_dw, dw)
        wrong = _emulate_gather_gemm(ext, w, plan.fwd,
                                     sc.build_conv_skip(plan.fwd, n), bm)
        differs += int(((wrong - y).abs().amax(1) > 1e-3).sum())
    assert differs > 0


# ---- SpatialConv on gloo ranks ----

@pytest.mark.parametrize("n_shards", [2, 4])
def test_spatial_conv_forward(rank_runs, cases, n_shards):
    coords, x, w = cases["fwd"]
    ref = _one_device(coords, x, w)
    jref = _jax_sharded(coords, n_shards, x, w)
    parts = rank_runs[n_shards].result()
    shards = build_spatial_shards(coords, n_shards)
    ys = np.stack([p["fwd"]["y"] for p in parts])
    for d in range(n_shards):  # padded rows exactly zero
        assert not ys[d, shards.num[d]:].any()
    got = unshard_rows(ys, shards)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jref, rtol=0, atol=1e-5)


def test_spatial_conv_gradients(rank_runs, cases):
    import jax
    import jax.numpy as jnp
    from openscene_tpu.sparse.geometry import _pad_level, build_self_plan
    from openscene_tpu.sparse.ops import sparse_conv
    coords, x, w, g = cases["grad"]
    n = len(coords)
    cap = n + 64
    plan = build_self_plan(_pad_level(coords, cap), kernel_size=3)
    xp = np.zeros((cap, GCIN), np.float32)
    xp[:n] = x
    gp = jnp.asarray(np.concatenate([g, np.zeros((cap - n, GCOUT),
                                                 np.float32)]))

    def loss(xv, wv):
        return jnp.vdot(sparse_conv(xv, wv, jnp.asarray(plan.fwd),
                                    jnp.asarray(plan.flip_perm)), gp)

    rx, rw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(w))
    parts = rank_runs[4].result()
    shards = build_spatial_shards(coords, 4)
    dws = [p["grad"]["dw"] for p in parts]
    assert all(np.array_equal(dw, dws[0]) for dw in dws)
    np.testing.assert_allclose(dws[0], np.asarray(rw), rtol=1e-4, atol=1e-3)
    dxs = np.stack([p["grad"]["dx"] for p in parts])
    for d in range(4):
        assert not dxs[d, shards.num[d]:].any()
    np.testing.assert_allclose(unshard_rows(dxs, shards), np.asarray(rx)[:n],
                               rtol=0, atol=1e-4)
