"""The port's C++ kernel-map builder (``sparse/native.py``,
``csrc/kernel_map.cpp``) against its NumPy builder and the JAX package's
C++ builder, on the CPU.

Exact, every array and dtype: the self plans (k=3 and the k=5 stem) and the
down edges of seeded surface scenes of 1-3 batches, alone and through
``build_unet_geometry`` (the down edges renumbered from first-appearance
order to lex order), with free and with fixed caps; a fixed cap too small
raises ``OverflowError`` on both builders.  Without a compiler the NumPy
builder plans alone and the log says so once.  The tests that need the C++
builder skip where g++ is missing.
"""

import logging
import shutil

import numpy as np
import pytest

from openscene_tpu.sparse import native as jax_native
from openscene_tpu_torch.sparse import geometry as G
from openscene_tpu_torch.sparse import native
from openscene_tpu_torch.sparse.types import stencil_offsets
from tests.test_torch_geometry import SCENES, _assert_tree_equal, _surface


@pytest.fixture
def cxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the C++ builder cannot be built here")
    assert native.available()
    assert native.library_path().startswith(native.BUILD_DIR)


def _numpy(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.mark.parametrize("scene", SCENES, ids=lambda s: f"seed{s[0]}")
@pytest.mark.parametrize("k", [3, 5])
def test_self_plan_matches_numpy_and_jax(cxx, monkeypatch, scene, k):
    level = G._pad_level(_surface(*scene), 4096)
    got = G.build_self_plan(level, k)
    n, cap = int(level.num), level.cap
    offsets = stencil_offsets(k)
    ref_jax = G._spread_nulls((len(offsets), cap), n, cap)
    jax_native.build_self_plan_native(level.coords, n, cap, offsets, ref_jax)
    _numpy(monkeypatch)
    ref = G.build_self_plan(level, k)
    _assert_tree_equal(got, ref)
    _assert_tree_equal(got.fwd, ref_jax)


@pytest.mark.parametrize("scene", SCENES, ids=lambda s: f"seed{s[0]}")
def test_down_edges_match_numpy_and_jax(cxx, monkeypatch, scene):
    level = G._pad_level(_surface(*scene), 4096)
    n = int(level.num)
    # the raw C ABI against the JAX package's binding of its own copy
    pc, cp, off = native.build_down_edge_native(level.coords, n, 4096)
    jfwd = np.zeros((8, 4096), np.int32)
    jpc, jcp, joff = jax_native.build_down_edge_native(level.coords, n,
                                                       4096, jfwd)
    for a, b in ((pc, jpc), (cp, jcp), (off, joff)):
        np.testing.assert_array_equal(a, b)
    free = G.build_down_edge(level, cap_fn=G._bucket)
    fixed = G.build_down_edge(level, coarse_cap=2048)
    with pytest.raises(OverflowError):
        G.build_down_edge(level, coarse_cap=8)
    _numpy(monkeypatch)
    _assert_tree_equal(free, G.build_down_edge(level, cap_fn=G._bucket))
    _assert_tree_equal(fixed, G.build_down_edge(level, coarse_cap=2048))
    with pytest.raises(OverflowError):
        G.build_down_edge(level, coarse_cap=8)


@pytest.mark.parametrize("fixed", [False, True], ids=["bucketed", "fixed"])
def test_unet_geometry_matches_numpy(cxx, monkeypatch, fixed):
    coords = _surface(*SCENES[1])
    caps = None
    if fixed:
        counts = G.level_counts(coords)
        caps = G.GeometryCaps(cap0=G._bucket(counts[0]),
                              fixed=tuple(G._bucket(c) + 512 for c in counts))
    got = G.build_unet_geometry(coords, caps=caps)
    _numpy(monkeypatch)
    _assert_tree_equal(got, G.build_unet_geometry(coords, caps=caps))


def test_without_a_compiler_numpy_plans(monkeypatch, tmp_path, caplog):
    coords = _surface(*SCENES[0])
    _numpy(monkeypatch)
    ref = G.build_unet_geometry(coords)
    monkeypatch.undo()
    # a fresh binding whose build fails: no library, one warning, NumPy
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available() and not native.available()
        got = G.build_unet_geometry(coords)
    warned = [r for r in caplog.records if "unavailable" in r.getMessage()]
    assert len(warned) == 1
    _assert_tree_equal(got, ref)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.build_self_plan_native(coords, 1, 4096, stencil_offsets(3),
                                      np.zeros((27, 4096), np.int32))
