"""Point serialization of Point Transformer V3 on the device: the four
space-filling-curve orders of every level and their patch layouts.

Follows Pointcept's ``Point.serialization``, ``SerializedPooling`` and
``SerializedAttention.get_padding_and_inverse`` (``pointcept/models/
point_transformer_v3/point_transformer_v3m1_base.py``,
``pointcept/models/utils/serialization/``):

* **Codes.**  A level-0 voxel's code is ``scene << 48 | curve(grid)``
  (Pointcept shifts the scene by ``3 depth``: the same order), ``grid``
  its (x, y, z) voxel coordinate, which the port keeps non-negative
  (``data/voxelizer.py``, OpenScene's random global shift included).
  ``curve`` is one of :data:`ORDERS`: Morton order with x the most
  significant bit of each triple (``z``), Skilling's 3-D Hilbert index
  at ``depth = bit_length(max grid + 1)`` of the batch (``hilbert``), and
  both with x and y swapped first (``-trans``).  A coarser level's code is
  the code of any of its children shifted right by 3 (Pointcept's pooling
  takes the first child's; all are equal), which is the same curve at one
  bit less depth of the parent's coordinates.
* **Orders.**  Each level's four codes sorted (stable), and their
  inverses.
* **Patches.**  Scene by scene in sorted order: a scene of more than
  ``patch`` voxels is padded to a multiple of ``patch``, the empty slots of
  its last patch taking the voxels ``patch`` positions earlier; a scene of
  ``patch`` voxels or fewer is one patch of its own length.

Every shape is static (from the level caps, ``patch`` and the scenes a
batch holds, ``n_scenes``), and nothing is read back to the host, so the
build runs inside the trainers' CUDA graph (``runtime/geometry_route.py``).
Per level (:class:`LevelSerial`):

* ``gather`` (4, cap + n_scenes * patch): the level row of each padded
  position, per order (``order[pad]`` in Pointcept's terms); positions
  past the last patch point at the null row ``cap - 1``;
* ``scatter`` (4, cap): each level row's padded position
  (``unpad[inverse]``); 0 at padded rows;
* ``cu_seqlens`` (cap // patch + n_scenes + 2,) int32: patch starts in
  the padded positions, then their end repeated.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
MAX_DEPTH = 16           # Pointcept's limit of the code's position bits
SCENE_SHIFT = 3 * MAX_DEPTH
_CODE_PAD = 1 << 62      # padded rows' code: above every valid code


class LevelSerial(NamedTuple):
    gather: torch.Tensor      # (4, cap_pad) int64
    scatter: torch.Tensor     # (4, cap) int64
    cu_seqlens: torch.Tensor  # (patches + 1,) int32


def spread3(v: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of each int64 ``v`` spread to every third bit."""
    v = v & 0xFFFF
    v = (v | (v << 16)) & 0x0000FF0000FF
    v = (v | (v << 8)) & 0x00F00F00F00F
    v = (v | (v << 4)) & 0x0C30C30C30C3
    v = (v | (v << 2)) & 0x249249249249
    return v


def morton3(x, y, z) -> torch.Tensor:
    """Morton code, x the most significant bit of each triple."""
    return (spread3(x) << 2) | (spread3(y) << 1) | spread3(z)


def hilbert3(x, y, z, depth) -> torch.Tensor:
    """Skilling's 3-D Hilbert index at ``depth`` bits (an int or a 0-d
    tensor, at most :data:`MAX_DEPTH`) of coordinates below ``2^depth``:
    the axes' transpose (inverse undo, then Gray encode), interleaved with
    x the most significant bit of each triple."""
    xs = [x, y, z]
    for b in range(MAX_DEPTH - 1, 0, -1):
        q, p = 1 << b, (1 << b) - 1
        active = torch.as_tensor(depth > b, device=x.device)  # in the cube
        for i in range(3):
            on = (xs[i] & q) != 0
            if i == 0:
                x0 = torch.where(on, xs[0] ^ p, xs[0])
            else:
                t = (xs[0] ^ xs[i]) & p
                x0 = torch.where(on, xs[0] ^ p, xs[0] ^ t)
                xs[i] = torch.where(active & ~on, xs[i] ^ t, xs[i])
            xs[0] = torch.where(active, x0, xs[0])
    xs[1] = xs[1] ^ xs[0]
    xs[2] = xs[2] ^ xs[1]
    t = torch.zeros_like(xs[2])
    for b in range(MAX_DEPTH - 1, 0, -1):
        q = 1 << b
        t = torch.where((xs[2] & q) != 0, t ^ (q - 1), t)
    return morton3(*(v ^ t for v in xs))


def curve_codes(grid: torch.Tensor, depth) -> torch.Tensor:
    """(4, N) codes of ``grid`` (N, 3) int64 in :data:`ORDERS`' order."""
    x, y, z = grid.unbind(1)
    return torch.stack([morton3(x, y, z), morton3(y, x, z),
                        hilbert3(x, y, z, depth), hilbert3(y, x, z, depth)])


def batch_depth(coords: torch.Tensor, num) -> torch.Tensor:
    """``bit_length(max grid coordinate + 1)`` of the valid rows of a
    level-0 (cap, 4) buffer, a 0-d int64 tensor (no wait)."""
    valid = torch.arange(coords.shape[0], device=coords.device) < num
    top = torch.where(valid[:, None], coords[:, 1:].to(torch.int64),
                      torch.zeros((), dtype=torch.int64,
                                  device=coords.device)).amax() + 1
    bits = torch.arange(MAX_DEPTH + 8, device=coords.device)
    return ((top >> bits) > 0).sum()


def level0_codes(coords: torch.Tensor, num) -> torch.Tensor:
    """(4, cap) codes of a level-0 buffer; padded rows above every code."""
    cap = coords.shape[0]
    c = coords.to(torch.int64)
    valid = torch.arange(cap, device=coords.device) < num
    grid = torch.where(valid[:, None], c[:, 1:], torch.zeros_like(c[:, 1:]))
    codes = (c[:, 0] << SCENE_SHIFT)[None] | curve_codes(
        grid, batch_depth(coords, num))
    return torch.where(valid[None], codes, torch.full_like(codes, _CODE_PAD))


def parent_codes(codes: torch.Tensor, child_parent: torch.Tensor,
                 child_num, parent_cap: int, parent_num) -> torch.Tensor:
    """(4, parent_cap) codes of a coarser level: each valid child's code
    shifted right by 3 at its parent's row (every child of a parent gives
    the same value); padded parents above every code."""
    dev = codes.device
    valid = torch.arange(codes.shape[1], device=dev) < child_num
    row = torch.where(valid, child_parent.to(torch.int64),
                      torch.full_like(child_parent, parent_cap,
                                      dtype=torch.int64))
    out = torch.full((4, parent_cap + 1), _CODE_PAD, dtype=torch.int64,
                     device=dev)
    out[:, row] = codes >> 3
    out = out[:, :parent_cap]
    pvalid = torch.arange(parent_cap, device=dev) < parent_num
    return torch.where(pvalid[None], out, torch.full_like(out, _CODE_PAD))


def scene_counts(coords: torch.Tensor, num, n_scenes: int) -> torch.Tensor:
    """(n_scenes,) int64 valid rows of each scene of a level buffer."""
    dev = coords.device
    valid = torch.arange(coords.shape[0], device=dev) < num
    scene = torch.where(valid, coords[:, 0].to(torch.int64),
                        torch.full((), n_scenes, dtype=torch.int64,
                                   device=dev)).clamp(0, n_scenes)
    counts = torch.zeros(n_scenes + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, scene, torch.ones_like(scene))
    return counts[:n_scenes]


def _cumsum0(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a.new_zeros(1), torch.cumsum(a, 0)])


def patch_layout(counts: torch.Tensor, patch: int, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(pad, unpad, cu_seqlens)`` of scenes of ``counts`` voxels laid
    out in sorted order (Pointcept's ``get_padding_and_inverse`` on static
    shapes): ``pad`` (cap + S * patch,) the sorted position each padded
    position reads (0 past the last patch), ``unpad`` (cap,) the padded
    position of each sorted position (0 past the valid ones), and
    ``cu_seqlens`` (cap // patch + S + 2,) int32."""
    dev = counts.device
    s = counts.numel()
    n = counts
    padded = torch.where(n > patch, (n + patch - 1) // patch * patch, n)
    n_patch = (n + patch - 1) // patch
    off, off_pad, off_patch = _cumsum0(n), _cumsum0(padded), \
        _cumsum0(n_patch)
    total, total_pad = off[-1], off_pad[-1]

    j = torch.arange(cap + s * patch, device=dev)
    sc = torch.searchsorted(off_pad[1:], j, right=True).clamp_max(s - 1)
    loc = j - off_pad[sc]
    src = off[sc] + torch.where(loc < n[sc], loc, loc - patch)
    pad = torch.where(j < total_pad, src, torch.zeros_like(src))

    i = torch.arange(cap, device=dev)
    si = torch.searchsorted(off[1:], i, right=True).clamp_max(s - 1)
    unpad = torch.where(i < total, i + off_pad[si] - off[si],
                        torch.zeros_like(i))

    k = torch.arange(cap // patch + s + 2, device=dev)
    sk = torch.searchsorted(off_patch[1:], k, right=True).clamp_max(s - 1)
    start = off_pad[sk] + (k - off_patch[sk]) * patch
    cu = torch.where(k < off_patch[-1], start, total_pad)
    return pad, unpad, cu.to(torch.int32)


def level_serial(codes: torch.Tensor, num, counts: torch.Tensor,
                 patch: int) -> LevelSerial:
    """:class:`LevelSerial` of one level's (4, cap) codes."""
    dev = codes.device
    cap = codes.shape[1]
    order = torch.sort(codes, dim=1, stable=True)[1]
    inverse = torch.empty_like(order)
    inverse.scatter_(1, order, torch.arange(cap, device=dev).expand(4, cap))
    pad, unpad, cu = patch_layout(counts, patch, cap)
    inside = torch.arange(pad.numel(), device=dev) < cu[-1].to(torch.int64)
    gather = torch.where(inside[None], order[:, pad],
                         torch.full((), cap - 1, dtype=torch.int64,
                                    device=dev))
    valid = torch.arange(cap, device=dev) < num
    scatter = torch.where(valid[None], unpad[inverse],
                          torch.zeros_like(inverse))
    return LevelSerial(gather=gather, scatter=scatter, cu_seqlens=cu)


def serialize_levels(levels: Sequence, downs: Sequence, patch: int,
                     n_scenes: int) -> Tuple[LevelSerial, ...]:
    """:class:`LevelSerial` of every level of a geometry (``levels``:
    ``LevelGeometry`` with padded coords and ``num``, an int or a 0-d
    tensor; ``downs``: the ``DownPlan`` of each edge, whose
    ``child_parent`` places a child's code at its parent)."""
    codes = level0_codes(levels[0].coords, levels[0].num)
    out = []
    for lvl, lv in enumerate(levels):
        if lvl:
            codes = parent_codes(codes, downs[lvl - 1].child_parent,
                                 levels[lvl - 1].num, lv.coords.shape[0],
                                 lv.num)
        out.append(level_serial(codes, lv.num,
                                scene_counts(lv.coords, lv.num, n_scenes),
                                patch))
    return tuple(out)
