"""Synthetic ScanNet-like rooms and fused features, from the seed.

A copy of the program's generator (``data/synthetic.py``: ``make_scene``,
``class_prototypes``, ``make_fused_features``), changed so that every seed
gives the same set of sizes: each room's extent factors and its boxes'
labels (which set their sizes) come from the traffic file, the seed draws
the rest (the boxes' places, the sampled points, the features) and the
order of the rooms.
The fused features are drawn on the device in one call a scene.

Files are written in the reference's released formats, which the
program's loaders read: ``scannet_3d/<split>/sceneXXXX_00_vh_clean_2.pth``
holds ``torch.save((coords, colors, labels))``; the fused features of a
val scene are ``<fused>/sceneXXXX_00_0.pt`` = ``{'feat': fp16,
'mask_full': bool}``, a train scene's ``chunk_files`` files of
``chunk_points`` random points each (the reference's 20k-point chunks).
"""

from __future__ import annotations

import os
from os.path import join
from typing import List, NamedTuple

import numpy as np
import torch

EXTENT = (5.0, 4.0, 2.6)


def _plane(rng, origin, u, v, density):
    n = max(int(np.linalg.norm(np.cross(u, v)) * density), 1)
    uv = rng.random((n, 2))
    return np.asarray(origin, float) + uv[:, :1] * np.asarray(u) \
        + uv[:, 1:] * np.asarray(v)


def make_room(rng: np.random.Generator, scale, boxes, density: float,
              num_classes: int = 20):
    """One room of ``EXTENT * (scale[0], scale[1], 1)``: floor (label 1),
    four walls (0), one class-coded box per label of ``boxes`` (its label
    sets its size).  Returns (coords (N, 3)
    float32 m, colors (N, 3) float32 in [-1, 1], labels (N,) int64, 2%
    255)."""
    ex, ey, ez = EXTENT[0] * scale[0], EXTENT[1] * scale[1], EXTENT[2]
    parts = [(_plane(rng, np.zeros(3), [ex, 0, 0], [0, ey, 0], density), 1)]
    for origin, u, v in (((0, 0, 0), [ex, 0, 0], [0, 0, ez]),
                         ((0, ey, 0), [ex, 0, 0], [0, 0, ez]),
                         ((0, 0, 0), [0, ey, 0], [0, 0, ez]),
                         ((ex, 0, 0), [0, ey, 0], [0, 0, ez])):
        parts.append((_plane(rng, origin, u, v, density), 0))
    for label in boxes:
        base = 0.25 + 0.05 * label
        size = np.array([base, base * (1.3 if label % 2 else 0.7),
                         0.2 + 0.09 * label]) * rng.uniform(0.95, 1.05, 3)
        pos = rng.uniform(0.2, 0.8, 3) * [ex, ey, 0]
        for d in range(3):
            for s in (0, 1):
                if d == 2 and s == 0:
                    continue
                o = pos.copy()
                o[d] += s * size[d]
                axes = [i for i in range(3) if i != d]
                u, v = np.zeros(3), np.zeros(3)
                u[axes[0]], v[axes[1]] = size[axes[0]], size[axes[1]]
                parts.append((_plane(rng, o, u, v, density), label))
    coords = np.concatenate([p for p, _ in parts])
    labels = np.concatenate([np.full(len(p), l, np.int64) for p, l in parts])
    labels[rng.random(len(labels)) < 0.02] = 255
    colors = np.tanh(rng.standard_normal((len(coords), 3)) * 0.3
                     + labels[:, None] % 7 * 0.2 - 0.5)
    order = rng.permutation(len(coords))
    return (coords[order].astype(np.float32),
            colors[order].astype(np.float32), labels[order])


def class_prototypes(num_classes: int, dim: int, seed: int = 7
                     ) -> np.ndarray:
    """Unit-norm class directions: the text embeddings of every cell (no
    CLIP on the machine) and the centres of the fused features."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((num_classes, dim)).astype(np.float32)
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def fused_features(labels: np.ndarray, protos: torch.Tensor,
                   gen: torch.Generator, rng: np.random.Generator,
                   noise: float, visible: float):
    """(feat (M, D) fp16 on the host, mask_full (N,) bool): the prototype
    of each visible point's label (a random class for 255) plus Gaussian
    noise, normalised."""
    lab = labels.copy()
    ign = lab == 255
    lab[ign] = rng.integers(0, protos.shape[0], int(ign.sum()))
    mask = rng.random(len(lab)) < visible
    idx = torch.from_numpy(lab[mask]).to(protos.device)
    f = torch.randn((len(idx), protos.shape[1]), generator=gen,
                    device=protos.device) * noise + protos[idx]
    f = f / f.norm(dim=1, keepdim=True)
    return f.half().cpu(), mask


def _save(obj, path: str) -> None:
    """``torch.save`` and flush to the disk, so that no write-back of the
    inputs runs inside the timed window."""
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


class Dataset(NamedTuple):
    data_root: str       # .../scannet_3d
    fused_root: str
    text_file: str       # (classes, D) float32 .npy
    val_files: List[str]   # sorted, as the loaders list them


def write(root: str, traffic: dict, seed: int, device, dim: int = 0,
          num_classes: int = 20, fused_dir: str = "scannet_multiview",
          ) -> Dataset:
    """Write the traffic's ``train`` and ``val`` rooms under ``root``."""
    d3, dfeat = join(root, "scannet_3d"), join(root, fused_dir)
    top = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    protos = class_prototypes(num_classes, max(dim, 1))
    text = join(root, "text.npy")
    np.save(text, protos)
    protos_t = torch.from_numpy(protos).to(device)
    idx, val_files = 0, []
    for split in ("train", "val"):
        spec = traffic.get(split)
        if not spec:
            continue
        os.makedirs(join(d3, split), exist_ok=True)
        os.makedirs(dfeat, exist_ok=True)
        rooms = spec["rooms"]
        for slot in top.permutation(len(rooms)):
            scale, boxes = rooms[slot]
            rng = np.random.default_rng((seed, idx))
            coords, colors, labels = make_room(rng, scale, boxes,
                                               spec["density"], num_classes)
            name = f"scene{idx:04d}_00"
            path = join(d3, split, name + "_vh_clean_2.pth")
            _save((coords, colors, labels), path)
            if split == "val":
                val_files.append(path)
            if dim and spec.get("fused"):
                fz = spec["fused"]
                feat, mask = fused_features(labels, protos_t, gen, rng,
                                            fz["noise"], fz["visible"])
                chunks = fz.get("chunk_files", 0)
                if not chunks:
                    _save({"feat": feat, "mask_full": torch.from_numpy(mask)},
                          join(dfeat, f"{name}_0.pt"))
                for k in range(chunks):
                    keep = np.zeros(len(labels), bool)
                    keep[rng.choice(len(labels), min(fz["chunk_points"],
                                                     len(labels)),
                                    replace=False)] = True
                    m = mask & keep
                    _save({"feat": feat[torch.from_numpy(m[mask])],
                           "mask_full": torch.from_numpy(m)},
                          join(dfeat, f"{name}_{k}.pt"))
            idx += 1
    return Dataset(d3, dfeat, text, sorted(val_files))


def load_val(path: str, fused_root: str):
    """(points, feat, mask_full) of a val scene as the files hold them, for
    the reference."""
    coords, _, _ = torch.load(path, weights_only=False)
    name = os.path.basename(path)[:-len("_vh_clean_2.pth")]
    blob = torch.load(join(fused_root, f"{name}_0.pt"))
    return (np.asarray(coords), blob["feat"].numpy(),
            blob["mask_full"].numpy().astype(bool))
