"""Synthetic scene + fused-feature generators.

The execution environment has no real ScanNet/Matterport/nuScenes data, so
integration tests and benchmarks fabricate room-like scenes: axis-aligned
walls/floor/ceiling plus box "furniture", dense at a few-mm sampling so 2cm
voxelization behaves like real scans.  Fused CLIP-like features are generated
from per-class prototype directions so the zero-shot eval pipeline has real
signal (fusion-mode mIoU on clean prototypes must approach 1.0 — used as an
end-to-end correctness probe).
"""

from __future__ import annotations

import os
from os.path import join
from typing import Optional, Tuple

import numpy as np

from .scene_io import save_fused_features, save_scene


def _sample_plane(rng, origin, u_vec, v_vec, density):
    area = np.linalg.norm(np.cross(u_vec, v_vec))
    n = max(int(area * density), 1)
    uv = rng.random((n, 2))
    pts = origin + uv[:, :1] * u_vec + uv[:, 1:] * v_vec
    return pts


def make_scene(seed: int, num_classes: int = 20,
               extent: Tuple[float, float, float] = (5.0, 4.0, 2.6),
               density: float = 4000.0, all_classes: bool = False):
    """One synthetic room. Returns (coords (N,3) m, colors (N,3) in [-1,1],
    labels (N,) int64)."""
    rng = np.random.default_rng(seed)
    ex, ey, ez = (extent[0] * rng.uniform(0.7, 1.3),
                  extent[1] * rng.uniform(0.7, 1.3), extent[2])
    parts = []

    def add(pts, label):
        parts.append((pts, np.full(len(pts), label, dtype=np.int64)))

    # floor (label 1 = 'floor'), walls (0), plus furniture boxes
    add(_sample_plane(rng, np.zeros(3), [ex, 0, 0], [0, ey, 0], density), 1)
    for origin, u, v in [
        (np.zeros(3), [ex, 0, 0], [0, 0, ez]),
        ([0, ey, 0], [ex, 0, 0], [0, 0, ez]),
        (np.zeros(3), [0, ey, 0], [0, 0, ez]),
        ([ex, 0, 0], [0, ey, 0], [0, 0, ez]),
    ]:
        add(_sample_plane(rng, np.asarray(origin, float), u, v, density), 0)

    if all_classes:  # one box per remaining class (full metric coverage)
        box_labels = list(range(2, num_classes))
    else:
        box_labels = [int(rng.integers(2, num_classes))
                      for _ in range(int(rng.integers(3, 8)))]
    for label in box_labels:
        # class-coded box geometry (footprint/height encode the label) so a
        # geometry-only model CAN learn classes — otherwise distillation from
        # constant input features has nothing to generalize from
        base = 0.25 + 0.05 * label
        size = np.array([base, base * (1.3 if label % 2 else 0.7),
                         0.2 + 0.09 * label]) * rng.uniform(0.95, 1.05, 3)
        pos = rng.uniform(0.2, 0.8, 3) * [ex, ey, 0]
        for d in range(3):  # top + 4 sides of the box
            for s in (0, 1):
                if d == 2 and s == 0:
                    continue
                o = pos.copy()
                o[d] += s * size[d]
                axes = [i for i in range(3) if i != d]
                u = np.zeros(3); u[axes[0]] = size[axes[0]]
                v = np.zeros(3); v[axes[1]] = size[axes[1]]
                add(_sample_plane(rng, o, u, v, density), label)

    coords = np.concatenate([p for p, _ in parts])
    labels = np.concatenate([l for _, l in parts])
    # mark a few points ignore (like unannotated regions)
    ignore = rng.random(len(labels)) < 0.02
    labels[ignore] = 255
    colors = np.tanh(rng.standard_normal((len(coords), 3)) * 0.3
                     + labels[:, None] % 7 * 0.2 - 0.5)
    order = rng.permutation(len(coords))
    return coords[order], colors[order], labels[order]


def class_prototypes(num_classes: int, dim: int, seed: int = 7) -> np.ndarray:
    """Unit-norm per-class prototype directions (stand-in for CLIP text
    embeddings in synthetic pipelines)."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((num_classes, dim)).astype(np.float32)
    return protos / np.linalg.norm(protos, axis=1, keepdims=True)


_SCRATCH = {}  # warm reusable compute buffers (cold-page first-touch on
# some hosts is slow; fresh 0.5GB temporaries per scene made
# feature generation ~100x slower than the arithmetic itself)


def make_fused_features(labels: np.ndarray, num_classes: int, dim: int,
                        seed: int, noise: float = 0.1,
                        visible_frac: float = 0.85, chunk: int = 16384):
    """Per-point CLIP-like features from label prototypes + noise.

    Mirrors the reference storage: only 'visible' points carry features
    ({'feat', 'mask_full'}, fusion_util.py:70-90). Ignore-label points get a
    random prototype (2D fusion knows nothing about GT labels).

    Computed in fixed-size chunks through a module-level scratch buffer and
    written once into the final fp16 array — the only cold pages touched are
    the returned buffer's.
    """
    rng = np.random.default_rng(seed)
    protos = class_prototypes(num_classes, dim)
    lab = labels.copy()
    lab[lab == 255] = rng.integers(0, num_classes, (lab == 255).sum())
    mask_full = rng.random(len(lab)) < visible_frac
    lab = lab[mask_full]
    out = np.empty((len(lab), dim), np.float16)
    key = (chunk, dim)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        bufs = (np.empty((chunk, dim), np.float32),
                np.empty((chunk, dim), np.float32))
        _SCRATCH[key] = bufs
    buf, pbuf = bufs
    for i in range(0, len(lab), chunk):
        m = min(chunk, len(lab) - i)
        b = buf[:m]
        rng.standard_normal(dtype=np.float32, out=b)
        b *= noise
        np.take(protos, lab[i:i + m], axis=0, out=pbuf[:m])
        b += pbuf[:m]
        b /= np.linalg.norm(b, axis=1, keepdims=True)
        out[i:i + m] = b
    return out, mask_full


def build_synthetic_dataset(root: str, n_train: int = 4, n_val: int = 2,
                            num_classes: int = 20, dim: int = 768,
                            density: float = 4000.0, seed: int = 0,
                            num_rand_file_per_scene: int = 2,
                            n_split_points: int = 20000,
                            all_classes: bool = False):
    """Write a synthetic dataset tree compatible with the loaders:

    root/scannet_3d/{train,val}/scene_*.npz
    root/scannet_multiview/scene_*_{k}.npz   (train: chunked, val: 1 file)
    """
    d3 = join(root, "scannet_3d")
    dfeat = join(root, "scannet_multiview")
    os.makedirs(dfeat, exist_ok=True)
    rng = np.random.default_rng(seed)
    idx = 0
    for split, count in (("train", n_train), ("val", n_val)):
        os.makedirs(join(d3, split), exist_ok=True)
        for i in range(count):
            coords, colors, labels = make_scene(seed * 1000 + idx,
                                                num_classes, density=density,
                                                all_classes=all_classes)
            name = f"scene{idx:04d}_00"
            save_scene(join(d3, split, name + ".npz"), coords, colors, labels)
            if split == "train":
                # several random-chunk feature files per scene (reference
                # trains on 20k-point chunks, 5 files per scene)
                for k in range(num_rand_file_per_scene):
                    feat, mask_full = make_fused_features(
                        labels, num_classes, dim, seed=idx * 10 + k)
                    chunk = np.zeros(len(labels), dtype=bool)
                    take = min(n_split_points, len(labels))
                    chunk[rng.choice(len(labels), take, replace=False)] = True
                    m = mask_full & chunk
                    save_fused_features(join(dfeat, f"{name}_{k}.npz"),
                                        feat[m[mask_full]], m)
            else:
                feat, mask_full = make_fused_features(labels, num_classes,
                                                      dim, seed=idx * 10)
                save_fused_features(join(dfeat, f"{name}_0.npz"), feat,
                                    mask_full)
            idx += 1
    return d3, dfeat
