"""The port's geometry built on the device, against the JAX package's and
against the port's NumPy builder, on the CPU.

* ``build_geometry_parts`` of ``openscene_tpu_torch`` (search path and
  occupancy grid, stem occupancy on and off) on a small 2-scene batch with
  negative coordinates: every array bit-identical, dtype included, to the
  JAX package's ``build_geometry_parts(..., windows=False)`` (two jitted JAX
  builds, one module fixture: each costs some 15 s on the CPU) and to the
  port's NumPy builder for the same caps;
* the overflow flag: a scene larger than the grid, a scene index beyond
  ``n_scenes``, a coarse level that outgrows its cap; a single-voxel scene;
  ``dims_for_level`` against the JAX package's;
* the pieces: popcount, the spread-null rows, ``windows=True`` refused,
  ``build_unet_geometry_device`` raising on overflow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openscene_tpu.sparse import grid as jax_grid
from openscene_tpu.sparse.geometry_device import \
    build_geometry_parts as jax_build_parts
from openscene_tpu_torch.sparse import grid
from openscene_tpu_torch.sparse.geometry import (GeometryCaps, _bucket,
                                                 _spread_nulls,
                                                 build_unet_geometry,
                                                 level_counts)
from openscene_tpu_torch.sparse.geometry_device import (
    build_geometry_parts, build_unet_geometry_device, null_rows, popcount,
    with_host_counts)
from tests.test_torch_unet import _one_thread  # noqa: F401

DIMS0 = (96, 96, 64)   # level-0 grid of the small batch (fits it)
PATHS = [("search", False), ("search", True), ("grid", False),
         ("grid", True)]


def _scenes(seed=0, n_scenes=2, n=700, spread=48, zoff=-17):
    """Lex-sorted multi-scene (N, 4) coords with negative extents: walls
    (z-runs) and scattered voxels."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(n_scenes):
        c = rng.integers(-spread // 2, spread // 2, size=(n, 3))
        c[:, 2] += zoff
        run = c[: n // 4].copy()
        c = np.concatenate([c] + [run + [0, 0, d] for d in (1, 2, 3)])
        rows.append(np.unique(np.concatenate(
            [np.full((len(c), 1), b), c], axis=1), axis=0))
    coords = np.concatenate(rows).astype(np.int32)
    return coords[np.lexsort((coords[:, 3], coords[:, 2], coords[:, 1],
                              coords[:, 0]))]


def _caps(coords):
    return tuple(_bucket(c) for c in level_counts(coords))


def _padded(coords, cap):
    out = np.full((cap, 4), 2 ** 20, dtype=np.int32)
    out[:len(coords)] = coords
    return out


def _port_build(coords, caps, path, occ, n_scenes=2, dims0=DIMS0):
    geo, over = build_geometry_parts(
        torch.from_numpy(_padded(coords, caps[0])), len(coords), caps,
        stem_occupancy=occ, n_scenes=n_scenes if path == "grid" else None,
        grid_dims0=dims0)
    return with_host_counts(geo, over)


def _arrays(geo):
    """{name: numpy array} of every array of a geometry."""
    out = {}
    for i, lv in enumerate(geo.levels):
        out[f"levels[{i}].coords"] = lv.coords
        out[f"levels[{i}].num"] = np.int64(lv.num)
    plans = [("stem", geo.stem)] + [(f"self3[{i}]", p)
                                    for i, p in enumerate(geo.self3)]
    for name, p in plans:
        if p.fwd is not None:
            out[f"{name}.fwd"] = p.fwd
        out[f"{name}.flip_perm"] = p.flip_perm
    for e, d in enumerate(geo.down):
        # the index arrays; the port's edge layouts are compared with the
        # host path's in tests/test_torch_up_conv.py
        for f in ("fwd", "child_parent", "child_offset"):
            out[f"down[{e}].{f}"] = getattr(d, f)
    occ = geo.stem_occ
    if isinstance(occ, torch.Tensor):
        out["stem_occ"] = occ.float().numpy()
    elif occ is not None:
        out["stem_occ"] = np.asarray(occ, np.float32)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_same(got, ref):
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))
    for k in ref:
        assert got[k].dtype == ref[k].dtype, (k, got[k].dtype, ref[k].dtype)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def batch():
    coords = _scenes()
    caps = _caps(coords)
    host = build_unet_geometry(coords, caps=GeometryCaps(cap0=caps[0],
                                                         fixed=caps))
    return coords, caps, host


@pytest.fixture(scope="module")
def jax_geos(batch):
    """The JAX package's builds: search path with the stem plan, grid path
    with the stem occupancy."""
    coords, caps, _ = batch
    padded, n = jnp.asarray(_padded(coords, caps[0])), jnp.int32(len(coords))
    out = {}
    for path, occ in (("search", False), ("grid", True)):
        geo, over = jax.jit(lambda c, m, occ=occ, path=path: jax_build_parts(
            c, m, caps, stem_occupancy=occ,
            n_scenes=2 if path == "grid" else None, grid_dims0=DIMS0))(
                padded, n)
        assert not bool(over)
        out[path] = jax.tree_util.tree_map(np.asarray, geo)
    return out


def _host_ref(host, occ):
    ref = _arrays(host)
    if occ:
        ref["stem_occ"] = (ref.pop("stem.fwd")
                           < int(host.levels[0].num)).astype(np.float32)
    return ref


@pytest.mark.parametrize("path,occ", PATHS)
def test_device_builder_matches_numpy_builder(batch, path, occ):
    coords, caps, host = batch
    geo, over = _port_build(coords, caps, path, occ)
    assert not over
    assert (geo.stem.fwd is None) == occ and (geo.stem_occ is None) != occ
    if occ:
        assert geo.stem_occ.dtype == torch.bfloat16
    _assert_same(_arrays(geo), _host_ref(host, occ))


@pytest.mark.parametrize("path,occ", PATHS)
def test_device_builder_matches_jax(batch, jax_geos, path, occ):
    coords, caps, _ = batch
    geo, over = _port_build(coords, caps, path, occ)
    assert not over
    got = _arrays(geo)
    # levels, self3 and edges are path-independent in both packages; the
    # stem plan comes from the JAX search build, the occupancy from its
    # grid build
    ref = _arrays(jax_geos["grid" if occ else "search"])
    _assert_same(got, ref)


def test_overflow_scene_outside_the_grid():
    coords = _scenes(seed=1, spread=120)   # wider than a 64-voxel grid
    caps = _caps(coords)
    _, over = _port_build(coords, caps, "grid", True, dims0=(64, 64, 64))
    assert over
    # the search path has no grid to leave
    _, over = _port_build(coords, caps, "search", True, dims0=(64, 64, 64))
    assert not over
    # a scene index beyond n_scenes leaves the grid too
    _, over = _port_build(coords, caps, "grid", True, n_scenes=1,
                          dims0=(256, 256, 256))
    assert over
    g = grid.build_level_grid(torch.from_numpy(_padded(coords, caps[0])),
                              len(coords), 2, (64, 64, 64))
    assert bool(g.overflow)


@pytest.mark.parametrize("path", ["search", "grid"])
def test_overflow_coarse_level_outgrows_its_cap(path):
    coords = _scenes(seed=2)
    caps = _caps(coords)
    small = (caps[0], 256) + caps[2:]           # level 1 holds 255 rows
    assert level_counts(coords)[1] > 255
    geo, over = _port_build(coords, small, path, True)
    assert over
    assert geo.levels[1].num == level_counts(coords)[1]
    with pytest.raises(OverflowError):
        build_unet_geometry_device(
            torch.from_numpy(_padded(coords, caps[0])), len(coords), small)


@pytest.mark.parametrize("path,occ", PATHS)
def test_single_voxel_scene(path, occ):
    coords = np.array([[0, -3, 5, -7]], np.int32)
    caps = (4096,) * 5
    host = build_unet_geometry(coords, caps=GeometryCaps(cap0=4096,
                                                         fixed=caps))
    geo, over = _port_build(coords, caps, path, occ, n_scenes=1)
    assert not over
    _assert_same(_arrays(geo), _host_ref(host, occ))


def test_build_unet_geometry_device_matches_numpy(batch):
    coords, caps, host = batch
    geo = build_unet_geometry_device(
        torch.from_numpy(_padded(coords, caps[0])), len(coords), caps)
    _assert_same(_arrays(geo), _arrays(host))
    with pytest.raises(NotImplementedError, match="window plans"):
        build_geometry_parts(torch.from_numpy(_padded(coords, caps[0])),
                             len(coords), caps, windows=True)


def test_dims_for_level_matches_jax_and_never_overflows():
    for dims0 in ((64, 64, 64), (768, 768, 256), (97, 33, 300)):
        for level in range(5):
            assert grid.dims_for_level(level, dims0) == \
                jax_grid.dims_for_level(level, dims0)
    assert grid.DEFAULT_DIMS0 == jax_grid.DEFAULT_DIMS0
    # a scene exactly filling level 0 fits every coarser level
    pts = np.array([[0, 1, 1, 1], [0, 64, 64, 64]], np.int32)
    for level in range(5):
        c = pts.copy()
        c[:, 1:] >>= level
        g = grid.build_level_grid(torch.from_numpy(_padded(c, 256)), 2, 1,
                                  grid.dims_for_level(level, (64, 64, 64)))
        assert not bool(g.overflow), level


def test_popcount_and_null_rows():
    rng = np.random.default_rng(5)
    v = np.concatenate([rng.integers(0, 2 ** 32, 1000, dtype=np.uint64),
                        [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.int64)
    ref = np.array([bin(int(x)).count("1") for x in v])
    np.testing.assert_array_equal(popcount(torch.from_numpy(v)).numpy(), ref)
    for num, cap in ((0, 512), (100, 512), (511, 512), (3, 4096)):
        got = null_rows((27, cap), torch.tensor(num), cap)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      _spread_nulls((27, cap), num, cap))
