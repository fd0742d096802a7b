"""Batch assembly: scenes -> static-shape buffers + geometry.

Counterpart of ``openscene_tpu/data/batch.py`` with host-built geometry
(reference ``collation_fn[_eval_all]``, dataset/feature_loader.py:191-233):

* scenes are concatenated with a batch column, then spatially lex-sorted
  (batch, x, y, z) so every conv gather reads nearby rows;
* everything is padded to geometric capacity buckets (static shapes);
* fused features are placed in a (cap0, D) buffer at their voxel rows;
* for eval, per-point reconstruction indices are remapped through the sort
  permutation and padded to their own bucket.

The train-time per-batch random global coordinate shift
(``coords[:,1:4] += rand(3)*100``, run/distill.py:315) is applied here.

The arrays are NumPy; :func:`openscene_tpu_torch.sparse.geometry_to_device`
moves the geometry to a device.  The ``assemble_raw_*`` functions build no
geometry at all: the step builds it on the device
(``sparse/geometry_device.py``) from the padded level-0 coordinates, for
level caps that only ever grow (:func:`merge_caps`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from ..sparse.geometry import (GeometryCaps, _bucket, _pad_level,
                               build_unet_geometry, level_counts)
from ..sparse.types import UNetGeometry
from .loaders import SceneSample


class DistillBatch(NamedTuple):
    geo: UNetGeometry
    feats: np.ndarray      # (cap0, 3) float32 input features
    feat_3d: np.ndarray    # (cap0, D) float16 fused target features (storage
    # dtype, fusion_util.py:87; cast to compute dtype on device)
    mask: np.ndarray       # (cap0,) float32 1.0 where a fused target exists
    labels: np.ndarray     # (cap0,) int32 voxel labels (for debug/val viz)
    num_voxels: int


class RawDistillBatch(NamedTuple):
    """Train batch without geometry: the device builds the plans from
    ``coords`` inside the train step, so the host ships the level-0 buffers
    only."""
    coords: np.ndarray     # (cap0, 4) int32 lex-sorted, sentinel-padded
    num: np.ndarray        # () int32 valid voxels
    feats: np.ndarray      # (cap0, 3) float32
    feat_3d: np.ndarray    # (cap0, D) float16
    mask: np.ndarray       # (cap0,) float32
    labels: np.ndarray     # (cap0,) int32


class EvalBatch(NamedTuple):
    geo: UNetGeometry
    feats: np.ndarray       # (cap0, 3)
    feat_3d: Optional[np.ndarray]  # (cap0, D) fused features at voxels
    # (fp16); None where the mode does not read them
    mask: np.ndarray        # (cap0,) voxel has fused feature
    labels: np.ndarray      # (ocap,) ORIGINAL per-point labels (255-padded)
    inds_reconstruct: np.ndarray  # (ocap,) voxel row per original point
    num_points: int
    num_voxels: int


class RawEvalBatch(NamedTuple):
    """:class:`EvalBatch` without geometry: the device builds the plans from
    ``coords``."""
    coords: np.ndarray      # (cap0, 4) int32 lex-sorted, sentinel-padded
    num: np.ndarray         # () int32 valid voxels
    feats: np.ndarray
    feat_3d: Optional[np.ndarray]
    mask: np.ndarray
    labels: np.ndarray
    inds_reconstruct: np.ndarray
    num_points: int


class SegBatch(NamedTuple):
    """Supervised segmentation batch; the distill trainer validates on its
    ``eval_all`` form (per-point labels + reconstruction indices)."""
    geo: UNetGeometry
    feats: np.ndarray
    labels: np.ndarray      # (cap0,) int32, 255 at padding
    num_voxels: int
    inds_reconstruct: Optional[np.ndarray] = None
    point_labels: Optional[np.ndarray] = None
    num_points: int = 0


class RawSegBatch(NamedTuple):
    """:class:`SegBatch` without geometry (``coords``, ``num`` as in
    :class:`RawDistillBatch`)."""
    coords: np.ndarray
    num: np.ndarray
    feats: np.ndarray
    labels: np.ndarray
    inds_reconstruct: Optional[np.ndarray] = None
    point_labels: Optional[np.ndarray] = None
    num_points: int = 0


def _concat_sort(samples: Sequence[SceneSample], shift: Optional[np.ndarray]):
    """Concat scenes with batch ids, apply global shift, lex-sort spatially.

    Returns (sorted coords (N,4), perm, inv_perm, scene voxel offsets)."""
    coords_list = []
    offsets = [0]
    for b, s in enumerate(samples):
        c = np.concatenate(
            [np.full((len(s.coords), 1), b, dtype=np.int64),
             s.coords.astype(np.int64)], axis=1)
        coords_list.append(c)
        offsets.append(offsets[-1] + len(c))
    coords = np.concatenate(coords_list)
    if shift is not None:
        coords[:, 1:] += shift.astype(np.int64)
    perm = np.lexsort((coords[:, 3], coords[:, 2], coords[:, 1], coords[:, 0]))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return coords[perm], perm, inv, np.asarray(offsets)


def _random_shift(rng: Optional[np.random.Generator], shift: bool):
    rng = rng if rng is not None else np.random.default_rng()
    return np.floor(rng.random(3) * 100).astype(np.int64) if shift else None


def assemble_distill_batch(samples: Sequence[SceneSample], dim: int,
                           caps: Optional[GeometryCaps] = None,
                           rng: Optional[np.random.Generator] = None,
                           shift: bool = True) -> DistillBatch:
    """Train batch: one random global shift for the whole batch, fp16
    targets placed at the voxel rows that have a fused feature."""
    coords, perm, inv, offs = _concat_sort(samples, _random_shift(rng, shift))
    n = len(coords)
    geo = build_unet_geometry(coords, caps=caps or GeometryCaps.for_count(n))
    feats, feat_3d, mask, labels = _train_buffers(
        samples, dim, geo.levels[0].cap, n, perm, inv, offs)
    return DistillBatch(geo=geo, feats=feats, feat_3d=feat_3d, mask=mask,
                        labels=labels, num_voxels=n)


def _train_buffers(samples, dim, cap0, n, perm, inv, offs):
    """(feats, feat_3d, mask, labels) of a train batch at its voxel rows:
    fp16 targets placed where a fused feature exists."""
    feats = np.zeros((cap0, 3), dtype=np.float32)
    feat_3d = np.zeros((cap0, dim), dtype=np.float16)  # fp16 end to end
    mask = np.zeros(cap0, dtype=np.float32)
    labels = np.full(cap0, 255, dtype=np.int32)
    feats[:n] = np.concatenate([s.feats for s in samples])[perm]
    labels[:n] = np.concatenate([s.labels for s in samples])[perm]
    for b, s in enumerate(samples):
        rows = inv[offs[b] + np.flatnonzero(s.feat_mask)]
        feat_3d[rows] = s.feat_3d
        mask[rows] = 1.0
    return feats, feat_3d, mask, labels


def assemble_raw_distill_batch(samples: Sequence[SceneSample], dim: int,
                               caps: Optional[GeometryCaps] = None,
                               rng: Optional[np.random.Generator] = None,
                               shift: bool = True):
    """Concatenate, sort, pad and place the targets; no kernel maps.
    Returns ``(RawDistillBatch, caps)``.

    ``caps`` is the running schedule (``GeometryCaps`` with ``fixed``
    per-level caps, or None at the first batch), grown by
    :func:`merge_caps` to hold this batch: caps only ever grow, so the
    device builder never outgrows a level cap and a few schedules serve a
    whole run."""
    coords, perm, inv, offs = _concat_sort(samples, _random_shift(rng, shift))
    n = len(coords)
    caps = merge_caps(coords, caps)
    feats, feat_3d, mask, labels = _train_buffers(
        samples, dim, caps.cap0, n, perm, inv, offs)
    return RawDistillBatch(coords=_pad_level(coords, caps.cap0).coords,
                           num=np.int32(n), feats=feats, feat_3d=feat_3d,
                           mask=mask, labels=labels), caps


def merge_caps(coords: np.ndarray, caps: Optional[GeometryCaps]
               ) -> GeometryCaps:
    """The running cap schedule ``caps`` (None at the first batch) grown to
    hold the exact level counts of ``coords`` (five ``np.unique`` passes):
    only the levels whose count no longer fits grow, to the bucket of that
    count."""
    return merge_counts(level_counts(coords), caps)


def merge_counts(counts: Sequence[int], caps: Optional[GeometryCaps]
                 ) -> GeometryCaps:
    """:func:`merge_caps` on the level counts themselves."""
    prev = caps.fixed if caps is not None else (0,) * len(counts)
    fixed = tuple(p if c < p else max(p, _bucket(c))
                  for p, c in zip(prev, counts))
    return GeometryCaps(cap0=fixed[0], fixed=fixed)


def eval_level_counts(samples: Sequence[SceneSample]):
    """The level counts of an eval batch of ``samples`` (no shift), which
    its ``assemble_raw_*`` merges into the running caps."""
    return level_counts(_concat_sort(samples, None)[0])


def assemble_eval_batch(samples: Sequence[SceneSample], dim: int,
                        caps: Optional[GeometryCaps] = None,
                        point_cap: Optional[int] = None,
                        need_model: bool = True,
                        need_fused: bool = True) -> EvalBatch:
    """``need_model=False`` (fusion-mode eval) skips kernel-map construction
    entirely — only the level-0 padding/reconstruction is needed.
    ``need_fused=False`` (distill mode) leaves ``feat_3d`` None."""
    coords, perm, inv, offs = _concat_sort(samples, None)
    n = len(coords)
    if need_model:
        geo = build_unet_geometry(coords,
                                  caps=caps or GeometryCaps.for_count(n))
    else:
        caps = caps or GeometryCaps.for_count(n)
        level0 = _pad_level(coords, caps.cap_for(0, n))
        geo = UNetGeometry(levels=(level0,), stem=None, self3=(),
                           down=(), wplans=())
    feats, feat_3d, mask, labels, inds, n_pts = _eval_buffers(
        samples, dim, geo.levels[0].cap, n, perm, inv, offs, point_cap,
        need_fused)
    return EvalBatch(geo=geo, feats=feats, feat_3d=feat_3d, mask=mask,
                     labels=labels, inds_reconstruct=inds, num_points=n_pts,
                     num_voxels=n)


def assemble_raw_eval_batch(samples: Sequence[SceneSample], dim: int,
                            caps: Optional[GeometryCaps] = None,
                            point_cap: Optional[int] = None,
                            need_fused: bool = True):
    """:func:`assemble_eval_batch` without kernel maps, for geometry built on
    the device: returns ``(RawEvalBatch, caps)``, ``caps`` grown by
    :func:`merge_caps` from the running schedule ``caps``."""
    coords, perm, inv, offs = _concat_sort(samples, None)
    n = len(coords)
    caps = merge_caps(coords, caps)
    feats, feat_3d, mask, labels, inds, n_pts = _eval_buffers(
        samples, dim, caps.cap0, n, perm, inv, offs, point_cap, need_fused)
    return RawEvalBatch(coords=_pad_level(coords, caps.cap0).coords,
                        num=np.int32(n), feats=feats, feat_3d=feat_3d,
                        mask=mask, labels=labels, inds_reconstruct=inds,
                        num_points=n_pts), caps


def _eval_buffers(samples, dim, cap0, n, perm, inv, offs, point_cap,
                  need_fused):
    """(feats, feat_3d or None, mask, point labels, reconstruction indices,
    point count) of an eval batch."""
    feats = np.zeros((cap0, 3), dtype=np.float32)
    feats[:n] = np.concatenate([s.feats for s in samples])[perm]
    feat_3d = (np.zeros((cap0, dim), dtype=np.float16)  # fp16 end to end
               if need_fused else None)
    mask = np.zeros(cap0, dtype=np.float32)
    if samples[0].feat_3d is not None:
        if need_fused:
            feat_3d[:n] = np.concatenate(
                [np.asarray(s.feat_3d, dtype=np.float16)
                 for s in samples])[perm]
        mask[:n] = np.concatenate([s.feat_mask for s in samples])[perm]
    labels, inds, n_pts = _point_buffers(samples, cap0, inv, offs, point_cap)
    return feats, feat_3d, mask, labels, inds, n_pts


def _point_buffers(samples, cap0, inv, offs, point_cap):
    """(per-point labels, voxel row per point, point count), padded to the
    point cap: padded labels 255, padded points at the null voxel."""
    pts = np.concatenate([s.labels for s in samples])
    n_pts = len(pts)
    ocap = point_cap or _bucket(n_pts)
    labels = np.full(ocap, 255, dtype=np.int32)
    labels[:n_pts] = pts
    inds = np.full(ocap, cap0 - 1, dtype=np.int32)  # padding -> null voxel
    inds[:n_pts] = np.concatenate(
        [inv[offs[b] + s.inds_reconstruct] for b, s in enumerate(samples)])
    return labels, inds, n_pts


def assemble_seg_batch(samples: Sequence[SceneSample],
                       caps: Optional[GeometryCaps] = None,
                       rng: Optional[np.random.Generator] = None,
                       shift: bool = False, eval_all: bool = False,
                       point_cap: Optional[int] = None) -> SegBatch:
    coords, perm, inv, offs = _concat_sort(samples, _random_shift(rng, shift))
    n = len(coords)
    geo = build_unet_geometry(coords, caps=caps or GeometryCaps.for_count(n))
    parts = _seg_buffers(samples, geo.levels[0].cap, n, perm, inv, offs,
                         eval_all, point_cap)
    return SegBatch(geo, *parts[:2], n, *parts[2:])


def assemble_raw_seg_batch(samples: Sequence[SceneSample],
                           caps: Optional[GeometryCaps] = None,
                           rng: Optional[np.random.Generator] = None,
                           shift: bool = False, eval_all: bool = False,
                           point_cap: Optional[int] = None):
    """:func:`assemble_seg_batch` without kernel maps, for geometry built on
    the device: returns ``(RawSegBatch, caps)``, ``caps`` grown by
    :func:`merge_caps` from the running schedule ``caps``."""
    coords, perm, inv, offs = _concat_sort(samples, _random_shift(rng, shift))
    n = len(coords)
    caps = merge_caps(coords, caps)
    parts = _seg_buffers(samples, caps.cap0, n, perm, inv, offs, eval_all,
                         point_cap)
    return RawSegBatch(_pad_level(coords, caps.cap0).coords, np.int32(n),
                       *parts), caps


def _seg_buffers(samples, cap0, n, perm, inv, offs, eval_all, point_cap):
    """(feats, voxel labels, reconstruction indices, point labels, point
    count) of a seg batch; the last three None, None, 0 unless
    ``eval_all``, whose voxel labels are all 255."""
    feats = np.zeros((cap0, 3), dtype=np.float32)
    feats[:n] = np.concatenate([s.feats for s in samples])[perm]
    labels = np.full(cap0, 255, dtype=np.int32)
    if not eval_all:
        labels[:n] = np.concatenate([s.labels for s in samples])[perm]
        return feats, labels, None, None, 0
    plabels, inds, n_pts = _point_buffers(samples, cap0, inv, offs,
                                          point_cap)
    return feats, labels, inds, plabels, n_pts
