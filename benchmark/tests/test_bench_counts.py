"""The benchmark's pair counts and FLOPs against a brute-force count on a
tiny scene, and the reference's neighbour search against a dictionary."""

import itertools

import numpy as np
import torch

from benchmark import counts
from benchmark.reference import geometry
from benchmark.reference.minkunet import ARCHS


def tiny_coords(seed=0, n=300):
    rng = np.random.default_rng(seed)
    c = np.unique(np.concatenate([np.zeros((n, 1), np.int64),
                                  rng.integers(0, 12, (n, 3))], 1), axis=0)
    d = np.unique(np.concatenate([np.ones((n // 2, 1), np.int64),
                                  rng.integers(3, 9, (n // 2, 3))], 1),
                  axis=0)
    return np.concatenate([c, d])


def brute_levels(c):
    levels = [set(map(tuple, c.tolist()))]
    for _ in range(4):
        levels.append({(b, x // 2, y // 2, z // 2)
                       for b, x, y, z in levels[-1]})
    return levels


def brute_pairs(level, k):
    r = k // 2
    offs = list(itertools.product(range(-r, r + 1), repeat=3))
    return sum((b, x + dx, y + dy, z + dz) in level
               for b, x, y, z in level for dx, dy, dz in offs)


def test_pairs_match_brute_force():
    c = tiny_coords()
    geo = geometry.build(torch.from_numpy(c))
    levels = brute_levels(c)
    assert geo.num == [len(l) for l in levels]
    assert [p.count() for p in geo.self3] == [brute_pairs(l, 3)
                                              for l in levels]
    assert geo.stem.count() == brute_pairs(levels[0], 5)
    for i, (d, u) in enumerate(zip(geo.down, geo.up)):
        assert d.count() == u.count() == len(levels[i])


def test_pairs_join_the_right_rows():
    c = tiny_coords(1)
    lvl = geometry.pyramid(torch.from_numpy(c))[0][0]
    pairs = geometry.stencil_pairs(lvl, 3)
    rows = lvl.coords.numpy()
    for delta, o, i in zip(geometry.offsets(3), pairs.out_rows,
                           pairs.in_rows):
        assert np.array_equal(rows[o.numpy()][:, 1:] + np.array(delta),
                              rows[i.numpy()][:, 1:])


def test_model_flops_by_hand():
    arch = ARCHS["MinkUNet18A"]
    convs = counts.unet_convs(arch)
    assert [c.kind for c in convs].count("stencil") == 32
    assert [c.kind for c in convs].count("down") == 4
    assert [c.kind for c in convs].count("up") == 4
    assert len(counts.projections(arch)) == 7
    n = [1000, 400, 150, 50, 20]
    c = counts.LevelCounts(n, [5 * x for x in n], 7000)
    fwd = 2.0 * 7000 * 3 * 32
    for cv in convs:
        p = c.pairs3[cv.level] if cv.kind == "stencil" else n[cv.level]
        fwd += 2.0 * p * cv.cin * cv.cout
    for pj in counts.projections(arch):
        fwd += 2.0 * n[pj.level] * pj.cin * pj.cout
    fwd += 2.0 * n[0] * 96 * 20
    assert counts.model_flops(arch, c, 3, 20, train=False) == fwd
    assert counts.model_flops(arch, c, 3, 20, train=True) == \
        3 * fwd - 2.0 * 7000 * 3 * 32


def test_bounds_are_the_frozen_formulas():
    # chip_smoke.py's bound / bound_bwd at one shape, by hand
    ms = counts.bound(27, 1000, 1000, 5000, 96, 96)
    nbytes = (1000 * 96 * 2) * 2 + 27 * 1000 * 4 + 27 * 96 * 96 * 2
    assert ms == max(nbytes / 3.35e12, 2.0 * 5000 * 96 * 96 / 989e12) * 1e3
    ms = counts.bound_bwd(1000, 1000, 27000, 5000, 27, 96, 96)
    nbytes = (2 * 1000 * 96 + 1000 * 96) * 2 + 27000 * 4 \
        + 27 * 96 * 96 * 6
    assert ms == max(nbytes / 3.35e12,
                     4.0 * 5000 * 96 * 96 / 989e12) * 1e3
    b = counts.launch_bounds_ms(ARCHS["MinkUNet18A"],
                                counts.LevelCounts([10] * 5, [50] * 5, 90),
                                train=False)
    assert b["bwd"] == 0.0 and b["fwd"] > 0
