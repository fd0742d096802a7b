"""The trainers' geometry build replayed as one CUDA graph
(``runtime/geometry_route.py`` ``RawTrainStep``), and the build's
per-device constants that make it capturable.

On the CPU:

* ``build_geometry_parts`` with the constants made once per device, the
  voxel count given as an int or as a 0-d tensor, on the grid path and on
  the search path, with and without the stem occupancy: every array
  bit-identical to the NumPy builder's for the same caps;
* a CPU ``RawTrainStep`` builds eagerly (no ``geometry.replay`` span) and
  gives ``card_build``'s geometry;
* ``TrainGeometry`` hands every schedule's step its one graph pool, keeps
  the steps of schedules that the running caps outgrew (a batch still on
  one replays), and releases every grid step once it drops the grid (a
  stub step).

With CUDA (skipped without it): three batches replayed under one key give
the eager build's plans and counts bit for bit, also with the graph of a
second schedule in the same pool replayed between them; a batch that
leaves the grid is flagged, and the in-cap batch after it replays
correctly.
Imports no JAX.

    python -m pytest tests/test_torch_geometry_graph.py -q
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openscene_tpu_torch.config import Config
from openscene_tpu_torch.data.batch import merge_counts
from openscene_tpu_torch.runtime import geometry_route
from openscene_tpu_torch.runtime.geometry_route import (RawTrainStep,
                                                        TrainGeometry,
                                                        build_on_card,
                                                        card_build)
from openscene_tpu_torch.sparse.geometry import (GeometryCaps,
                                                 build_unet_geometry,
                                                 level_counts)
from openscene_tpu_torch.sparse.geometry_device import (build_geometry_parts,
                                                        flip_perm_on,
                                                        with_host_counts)
from openscene_tpu_torch.utils import profiling

DIMS0 = (96, 96, 64)   # level-0 grid of the small batches (fits them)


def _scenes(seed, n_scenes=2, n=400, spread=40, far=0):
    """Lex-sorted (N, 4) coords of ``n_scenes`` scenes with negative
    extents, z-runs and scattered voxels; ``far``: one more voxel of the
    last scene that far along x."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(n_scenes):
        c = rng.integers(-spread // 2, spread // 2, size=(n, 3))
        run = c[: n // 4]
        c = np.concatenate([c, run + [0, 0, 1], run + [0, 0, 2]])
        if far and b == n_scenes - 1:
            c = np.concatenate([c, [[far, 0, 0]]])
        rows.append(np.concatenate([np.full((len(c), 1), b), c], axis=1))
    coords = np.unique(np.concatenate(rows), axis=0).astype(np.int32)
    return coords[np.lexsort((coords[:, 3], coords[:, 2], coords[:, 1],
                              coords[:, 0]))]


def _caps(*batches):
    """The running caps that hold every batch."""
    caps = None
    for coords in batches:
        caps = merge_counts(level_counts(coords), caps)
    return caps.fixed


def _raw(coords, caps):
    padded = np.full((caps[0], 4), 2 ** 20, dtype=np.int32)
    padded[:len(coords)] = coords
    return SimpleNamespace(coords=padded, num=np.int32(len(coords)))


def _leaves(x, name="geo"):
    """(name, tensor or int) of every array and count of a geometry."""
    if isinstance(x, torch.Tensor):
        yield name, x
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for f in x._fields:
            yield from _leaves(getattr(x, f), f"{name}.{f}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{name}[{i}]")
    elif x is not None:
        yield name, int(x)


def _assert_same_geometry(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            assert torch.equal(g.cpu(), w.cpu()), k
        else:
            assert g == w, (k, g, w)


def _step(device):
    return SimpleNamespace(cfg=Config(), device=device)


@pytest.fixture(scope="module")
def batch():
    coords = _scenes(0)
    caps = _caps(coords)
    host = build_unet_geometry(coords, caps=GeometryCaps(cap0=caps[0],
                                                         fixed=caps))
    return coords, caps, host


@pytest.mark.parametrize("num_as", ["int", "tensor"])
@pytest.mark.parametrize("occ", [False, True])
@pytest.mark.parametrize("path", ["search", "grid"])
def test_build_with_device_constants_matches_numpy_builder(batch, path, occ,
                                                           num_as):
    coords, caps, host = batch
    num = len(coords) if num_as == "int" else torch.tensor(len(coords))
    geo, over = with_host_counts(*build_geometry_parts(
        torch.from_numpy(_raw(coords, caps).coords), num, caps,
        stem_occupancy=occ, n_scenes=2 if path == "grid" else None,
        grid_dims0=DIMS0))
    assert not over
    want = {}
    for i, lv in enumerate(host.levels):
        want[f"levels[{i}].coords"] = lv.coords
        want[f"levels[{i}].num"] = np.int64(lv.num)
    for name, p in [("stem", host.stem)] + [
            (f"self3[{i}]", p) for i, p in enumerate(host.self3)]:
        want[f"{name}.fwd"] = p.fwd
        want[f"{name}.flip_perm"] = p.flip_perm
    for e, d in enumerate(host.down):
        for f in ("fwd", "child_parent", "child_offset"):
            want[f"down[{e}].{f}"] = getattr(d, f)
    n = int(host.levels[0].num)
    if occ:
        want["stem_occ"] = (want.pop("stem.fwd") < n).astype(np.float32)
    got = {k: np.asarray(v) for k, v in (
        [(f"levels[{i}].coords", lv.coords) for i, lv in
         enumerate(geo.levels)]
        + [(f"levels[{i}].num", np.int64(lv.num)) for i, lv in
           enumerate(geo.levels)]
        + [(f"{name}.{f}", getattr(p, f)) for name, p in
           [("stem", geo.stem)] + [(f"self3[{i}]", p) for i, p in
                                   enumerate(geo.self3)]
           for f in ("fwd", "flip_perm") if getattr(p, f) is not None]
        + [(f"down[{e}].{f}", getattr(d, f)) for e, d in enumerate(geo.down)
           for f in ("fwd", "child_parent", "child_offset")]
        + ([("stem_occ", geo.stem_occ.float())] if occ else []))}
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype, (k, got[k].dtype, w.dtype)
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    # the index tables are the device's constants, made once
    cpu = torch.device("cpu")
    assert geo.stem.flip_perm is flip_perm_on(5, cpu)
    assert all(p.flip_perm is flip_perm_on(3, cpu) for p in geo.self3)


def test_cpu_raw_step_builds_eagerly():
    coords = _scenes(1)
    caps = _caps(coords)
    step = _step(torch.device("cpu"))
    rs = RawTrainStep(step, caps, n_scenes=2, grid_dims0=DIMS0)
    raw = _raw(coords, caps)
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        geo, over = rs.geometry(raw)
    names = [r.name for r in profiling.records()]
    profiling.clear()
    assert "geometry.build" in names and "geometry.replay" not in names
    assert not rs.replays and rs._graph is None
    assert not over
    want, _ = build_on_card(card_build(step.cfg, step.device, caps,
                                       n_scenes=2, grid_dims0=DIMS0),
                            raw.coords, raw.num)
    _assert_same_geometry(geo, want)


class _StubStep:
    """A raw step that records what it was made with, and its release."""

    def __init__(self, step, caps, n_scenes=None, grid_dims0=None,
                 pool=None, batch_scenes=1):
        self.caps, self.n_scenes, self.pool = caps, n_scenes, pool
        self.released = False

    def release(self):
        self.released = True


def test_train_geometry_keeps_schedules_in_one_pool(monkeypatch):
    monkeypatch.setattr(geometry_route, "RawTrainStep", _StubStep)
    tg = TrainGeometry(Config(grid_overflow_limit=3), torch.device("cpu"),
                       n_scenes=2)
    tg.pool = pool = object()                # the card's graph pool handle
    a = (8192, 4096, 2048, 1024, 512)
    b = (8192, 5120, 2048, 1024, 512)        # outgrows a
    sa, sb = tg.raw_step(None, a), tg.raw_step(None, b)
    assert sa is not sb and sa.pool is pool and sb.pool is pool
    # a batch still on a: the step and its graph stay
    tg.caps = GeometryCaps(cap0=b[0], fixed=b)
    assert tg.raw_step(None, a) is sa and tg.raw_step(None, b) is sb
    assert not sa.released and sb.n_scenes == 2
    # dropping the grid releases every grid step; the search's start anew
    for _ in range(3):
        tg._count(True, b)
    assert not tg.grid_enabled and sa.released and sb.released
    search = tg.raw_step(None, b)
    assert search is not sb and search.n_scenes is None
    assert search.pool is pool and not search.released
    # the CPU has no graphs, nor a pool for them
    assert TrainGeometry(Config(), torch.device("cpu"), 2).pool is None


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs are CUDA's")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n_scenes", [2, None], ids=["grid", "search"])
def test_replays_equal_eager_builds(n_scenes):
    dev = _card()
    batches = [_scenes(s) for s in (2, 3, 4)]
    caps = _caps(*batches)
    wider = tuple(2 * c for c in caps)       # a second schedule
    tg = TrainGeometry(Config(grid_dims0=DIMS0), dev, n_scenes=2)
    tg.grid_enabled = n_scenes is not None
    step = _step(dev)
    rs, other = tg.raw_step(step, caps), tg.raw_step(step, wider)
    assert rs.pool is tg.pool and other.pool is tg.pool
    graph = None
    for coords in batches:
        raw = _raw(coords, caps)
        got, over = rs.geometry(raw)
        graph = graph or rs._graph
        assert rs._graph is graph            # captured once, replayed
        want, want_over = build_on_card(rs.eager, raw.coords, raw.num)
        assert over is False and want_over is False
        _assert_same_geometry(got, want)
        # the other schedule's graph in the same pool, between two replays
        wide = _raw(coords, wider)
        got, over = other.geometry(wide)
        assert over is False
        _assert_same_geometry(
            got, build_on_card(other.eager, wide.coords, wide.num)[0])


@pytest.mark.cuda
def test_overflowed_batch_is_flagged_and_the_next_replays():
    dev = _card()
    inside, wide, after = (_scenes(5), _scenes(6, far=DIMS0[0]),
                           _scenes(7))
    caps = _caps(inside, wide, after)
    step = _step(dev)
    rs = RawTrainStep(step, caps, n_scenes=2, grid_dims0=DIMS0)
    for coords, overflows in ((inside, False), (wide, True),
                              (after, False)):
        raw = _raw(coords, caps)
        got, over = rs.geometry(raw)
        want, want_over = build_on_card(rs.eager, raw.coords, raw.num)
        assert over is overflows and want_over is overflows
        if not overflows:
            _assert_same_geometry(got, want)
    assert rs.replays
