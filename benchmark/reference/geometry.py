"""The reference's own neighbour search, from voxel coordinates alone.

Plain PyTorch on any device: a level's voxels are (batch, x, y, z) rows;
level l + 1 holds the unique ``floor(c / 2)`` of level l (MinkowskiEngine's
stride-2 coordinates); a stencil pair exists where ``c + delta`` is a voxel
of the same level (offsets in x-major order, as the reference checkpoints
and the port's weights lay them out); a child's down/up pair is its parent
and its offset ``c - 2 * parent`` (index ``4 ox + 2 oy + oz``).

A conv is described by :class:`Pairs`: per kernel offset, the output rows
and the input rows it joins.  Nothing here reads a plan of the program.
"""

from __future__ import annotations

import itertools
from typing import List, NamedTuple, Tuple

import torch

_FIELD = 1 << 16   # coordinate field of a packed key
_PAD = 4           # headroom so that c + delta stays non-negative


class Pairs(NamedTuple):
    out_rows: List[torch.Tensor]   # per offset, int64
    in_rows: List[torch.Tensor]
    n_out: int

    def count(self) -> int:
        return int(sum(int(o.numel()) for o in self.out_rows))


def offsets(kernel: int) -> List[Tuple[int, int, int]]:
    r = kernel // 2
    axis = range(-r, r + 1) if kernel % 2 else range(kernel)
    return list(itertools.product(axis, axis, axis))


def _keys(c: torch.Tensor) -> torch.Tensor:
    c = c.long()
    k = c[:, 0]
    for d in range(1, 4):
        k = k * _FIELD + (c[:, d] + _PAD)
    return k


class Level(NamedTuple):
    coords: torch.Tensor        # (N, 4) int64
    sorted_keys: torch.Tensor
    order: torch.Tensor


def _level(coords: torch.Tensor) -> Level:
    keys = _keys(coords)
    sk, order = torch.sort(keys)
    return Level(coords, sk, order)


def pyramid(coords0: torch.Tensor, num_levels: int = 5):
    """Levels of a batch (``coords0`` (N, 4) int, unique rows) and, per
    edge, each child's parent row and offset index."""
    levels = [_level(coords0.long())]
    edges = []
    for _ in range(num_levels - 1):
        c = levels[-1].coords
        half = torch.cat([c[:, :1], torch.div(c[:, 1:], 2,
                                              rounding_mode="floor")], 1)
        keys = _keys(half)
        uniq, parent = torch.unique(keys, return_inverse=True)
        coarse = torch.empty((len(uniq), 4), dtype=torch.long,
                             device=c.device)
        coarse[parent] = half
        off = c[:, 1:] - 2 * half[:, 1:]
        edges.append((parent, off[:, 0] * 4 + off[:, 1] * 2 + off[:, 2]))
        levels.append(_level(coarse))
    return levels, edges


def stencil_pairs(level: Level, kernel: int) -> Pairs:
    """Per offset ``delta``: output row r and input row of ``c_r + delta``
    where that voxel exists."""
    c, sk, order = level
    n = c.shape[0]
    outs, ins = [], []
    rows = torch.arange(n, device=c.device)
    for d in offsets(kernel):
        delta = torch.tensor((0,) + d, device=c.device)
        probe = _keys(c + delta)
        pos = torch.searchsorted(sk, probe).clamp_max(n - 1)
        hit = sk[pos] == probe
        outs.append(rows[hit])
        ins.append(order[pos[hit]])
    return Pairs(outs, ins, n)


def down_pairs(parent: torch.Tensor, off: torch.Tensor, n_parent: int
               ) -> Pairs:
    """Down conv: parent row <- child row, per child offset."""
    child = torch.arange(len(parent), device=parent.device)
    sel = [off == k for k in range(8)]
    return Pairs([parent[s] for s in sel], [child[s] for s in sel], n_parent)


def up_pairs(parent: torch.Tensor, off: torch.Tensor) -> Pairs:
    """Up (transposed) conv: child row <- parent row, per child offset."""
    child = torch.arange(len(parent), device=parent.device)
    sel = [off == k for k in range(8)]
    return Pairs([child[s] for s in sel], [parent[s] for s in sel],
                 len(parent))


class Geometry(NamedTuple):
    num: List[int]
    stem: Pairs
    self3: List[Pairs]
    down: List[Pairs]
    up: List[Pairs]


def build(coords0: torch.Tensor) -> Geometry:
    """Every pair list of a 4-down / 4-up UNet on a batch."""
    levels, edges = pyramid(coords0)
    num = [int(l.coords.shape[0]) for l in levels]
    return Geometry(
        num=num, stem=stencil_pairs(levels[0], 5),
        self3=[stencil_pairs(l, 3) for l in levels],
        down=[down_pairs(p, o, num[i + 1]) for i, (p, o) in enumerate(edges)],
        up=[up_pairs(p, o) for p, o in edges])
