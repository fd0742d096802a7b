"""The port's geometry plans and eval batches are bit-identical to the JAX
package's.

The same seeded scenes go through ``openscene_tpu`` (with and without its
native C++ kernel-map builder) and ``openscene_tpu_torch`` (its own copy of
the C++ builder where g++ is present; ``tests/test_torch_native.py`` holds it
against its NumPy builder); every array of the resulting ``UNetGeometry`` and ``EvalBatch`` must
match exactly, dtype included.
"""

import numpy as np
import pytest
import torch

from openscene_tpu.data.batch import assemble_eval_batch as jax_assemble
from openscene_tpu.data.loaders import SceneSample as JaxSample
from openscene_tpu.sparse import native
from openscene_tpu.sparse.geometry import \
    build_unet_geometry as jax_build_geometry
from openscene_tpu_torch.data.batch import assemble_eval_batch
from openscene_tpu_torch.data.loaders import SceneSample
from openscene_tpu_torch.sparse.geometry import (build_unet_geometry,
                                                 level_counts)


def _surface(seed, n, span, batches):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, batches, n)
    xy = rng.integers(0, span, (n, 2))
    z = (5 + 4 * np.sin(xy[:, 0] / 6) + 4 * np.cos(xy[:, 1] / 7)).astype(int)
    z = z + rng.integers(0, 2, n)
    c = np.unique(np.stack([b, xy[:, 0], xy[:, 1], z], 1), axis=0)
    return c.astype(np.int32)


SCENES = [(0, 700, 30, 1), (1, 2500, 60, 2), (2, 1800, 45, 3)]


def _assert_tree_equal(a, b, path="geo"):
    if isinstance(a, tuple):  # NamedTuples and tuples of plans
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _plan_fields(p):
    """A stencil plan's index arrays; the port's plans also carry an
    optional skip plan (None from the NumPy builder), which the JAX
    package's plans do not have."""
    return None if p is None else (p.fwd, p.flip_perm)


def _down_fields(d):
    """An edge's index arrays; the port's plans also carry optional groups
    and a skip plan (None from the NumPy builder)."""
    return (d.fwd, d.child_parent, d.child_offset)


def _geo_fields(geo):
    return (geo.levels, _plan_fields(geo.stem),
            tuple(_plan_fields(p) for p in geo.self3),
            tuple(_down_fields(d) for d in geo.down))


@pytest.fixture(params=["native", "numpy"])
def jax_builder(request, monkeypatch):
    """Run the JAX package's builder on its C++ path or its NumPy path."""
    if request.param == "native":
        assert native.available(), "the C++ builder must build here (g++)"
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("scene", SCENES, ids=lambda s: f"seed{s[0]}")
def test_geometry_bit_identical(jax_builder, scene):
    coords = _surface(*scene)
    ref = jax_build_geometry(coords, build_windows=False)
    geo = build_unet_geometry(coords)
    _assert_tree_equal(_geo_fields(geo), _geo_fields(ref))
    assert geo.wplans == () and geo.ewplans == ()
    assert [int(l.num) for l in geo.levels] == level_counts(coords)


def _samples(seed, n_scenes, dim):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_scenes):
        c = _surface(seed * 10 + s, 900, 35, 1)[:, 1:]
        nv = len(c)
        n_pts = nv + 200
        inds = np.concatenate([np.arange(nv), rng.integers(0, nv, 200)])
        mask = rng.random(nv) < 0.8
        out.append(dict(
            coords=c, feats=np.ones((nv, 3), np.float32),
            labels=rng.integers(0, 20, n_pts).astype(np.int64),
            inds_reconstruct=inds,
            feat_3d=rng.standard_normal((nv, dim)).astype(np.float16),
            feat_mask=mask))
    return out


@pytest.mark.parametrize("need_model", [True, False])
def test_eval_batch_bit_identical(jax_builder, need_model):
    raw = _samples(3, 2, 16)
    ref = jax_assemble([JaxSample(**s) for s in raw], 16,
                       need_model=need_model, windows=False)
    got = assemble_eval_batch([SceneSample(**s) for s in raw], 16,
                              need_model=need_model)
    for name in ("feats", "feat_3d", "mask", "labels", "inds_reconstruct"):
        _assert_tree_equal(getattr(got, name), getattr(ref, name), name)
    assert (got.num_points, got.num_voxels) == (ref.num_points,
                                               ref.num_voxels)
    _assert_tree_equal(_geo_fields(got.geo), _geo_fields(ref.geo))


def test_geometry_to_device_rejects_out_of_range_index():
    from openscene_tpu_torch.sparse.geometry import geometry_to_device
    geo = build_unet_geometry(_surface(*SCENES[0]))
    dev = geometry_to_device(geo, "cpu")
    assert dev.self3[0].fwd.dtype == torch.int32
    assert [l.num for l in dev.levels] == [int(l.num) for l in geo.levels]
    bad = geo.self3[1].fwd.copy()
    bad[3, 7] = geo.levels[1].cap
    geo = geo._replace(self3=geo.self3[:1] + (geo.self3[1]._replace(fwd=bad),)
                       + geo.self3[2:])
    with pytest.raises(ValueError, match=r"self3\[1\]"):
        geometry_to_device(geo, "cpu")
