"""Geometry on the card: the one route of the trainers and the evaluators.

With ``device_geometry`` on (``auto``: on for a CUDA device) the host ships
a batch's or a scene's padded level-0 coordinates on running level caps
that only grow (a raw batch), and the card builds every kernel map
(``sparse/geometry_device.py``, ``sparse/grid.py``) and returns the level
counts and the overflow flag in one wait (:func:`build_on_card`).  A batch
whose geometry overflows its caps or the occupancy grid never runs on those
plans: :meth:`CardGeometry.route` counts and logs it, and builds it again
with the consumer's own host builder.  Without device geometry every batch
is planned on the host.  Training (:class:`TrainGeometry`) drops the grid
prober after ``grid_overflow_limit`` overflows in a row; the evaluators
(:class:`SceneGeometry`) keep it, and under a mesh their data ranks share
the running caps round by round (:func:`rank_scene_rounds`).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.batch import (DistillBatch, RawDistillBatch, RawSegBatch,
                          SegBatch, eval_level_counts, merge_counts)
from ..data.prefetch import Prefetcher
from ..device import device_geometry_on
from ..parallel.mesh import Mesh, all_gather_rows
from ..sparse.geometry import (GeometryCaps, build_unet_geometry,
                               geometry_to_device)
from ..sparse.geometry_device import build_geometry_parts, with_host_counts
from ..utils.profiling import span
from ..utils.train_utils import get_logger

log = get_logger()


def build_on_card(cfg: Config, device, coords, num, caps: Sequence[int],
                  n_scenes: Optional[int] = None,
                  grid_dims0: Optional[Tuple[int, int, int]] = None):
    """``(geometry on the card with host level counts, overflow)`` of a
    padded level-0 batch for ``caps``, by the grid of ``grid_dims0`` for
    ``n_scenes`` scenes, else by the search; invalid under overflow."""
    with span("geometry.build"):
        geo, overflow = build_geometry_parts(
            torch.as_tensor(coords, device=device), int(num), tuple(caps),
            stem_occupancy=not cfg.input_color, n_scenes=n_scenes,
            grid_dims0=grid_dims0)
    return with_host_counts(geo, overflow)


class RawTrainStep:
    """The geometry of a train ``step``'s raw batches
    (:class:`RawDistillBatch`, :class:`RawSegBatch`) on the card, for one
    cap schedule ``caps`` and grid state (``n_scenes`` None: the search)."""

    def __init__(self, step, caps: Sequence[int],
                 n_scenes: Optional[int] = None,
                 grid_dims0: Optional[Tuple[int, int, int]] = None):
        self.step, self.caps = step, tuple(int(c) for c in caps)
        self.n_scenes, self.grid_dims0 = n_scenes, grid_dims0

    def geometry(self, raw: RawDistillBatch):
        """(geometry on the card with host level counts, overflow)."""
        return build_on_card(self.step.cfg, self.step.device, raw.coords,
                             raw.num, self.caps, self.n_scenes,
                             self.grid_dims0)


def host_batch_from_raw(raw):
    """The trainers' host builder: a :class:`DistillBatch` (:class:`SegBatch`)
    of a raw batch on caps bucketed from its own voxel count, the level-0
    buffers cut or padded to its cap (labels with 255)."""
    n = int(raw.num)
    geo = build_unet_geometry(np.asarray(raw.coords[:n]),
                              caps=GeometryCaps.for_count(n))
    cap0 = geo.levels[0].cap

    def fit(a, fill=0.0):
        a = np.asarray(a)
        if a.shape[0] >= cap0:  # rows >= n are padding
            return a[:cap0]
        width = [(0, cap0 - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill)

    if isinstance(raw, RawSegBatch):
        return SegBatch(geo=geo, feats=fit(raw.feats),
                        labels=fit(raw.labels, 255), num_voxels=n)
    return DistillBatch(geo=geo, feats=fit(raw.feats),
                        feat_3d=fit(raw.feat_3d), mask=fit(raw.mask),
                        labels=fit(raw.labels, 255), num_voxels=n)


class CardGeometry:
    """One consumer's route: ``on``, ``cfg.device_geometry`` resolved for
    ``device``, and ``overflows``, the batches built on the host after an
    overflow."""

    what = "batch"  # what one build holds, for the log

    def __init__(self, cfg: Config, device: torch.device):
        self.cfg, self.device = cfg, device
        self.on = device_geometry_on(cfg.device_geometry, device)
        self.overflows = 0

    def route(self, raw, built, host_batch, caps):
        """``(batch, its geometry on the card)``: ``raw`` on ``built``, its
        ``(geometry, overflow)`` for ``caps``, or after an overflow
        :meth:`on_host` of ``host_batch()``."""
        geo, overflow = built
        self._count(overflow, caps)
        if not overflow:
            return raw, geo
        return self.on_host(host_batch())

    def on_host(self, batch):
        """``(batch, its host plans on the card)``."""
        return batch, geometry_to_device(batch.geo, self.device)

    def _count(self, overflow: bool, caps) -> None:
        if overflow:
            self.overflows += 1
            log.warning("device geometry overflowed (caps %s, grid_dims0 "
                        "%s); planning the %s on the host", tuple(caps),
                        tuple(self.cfg.grid_dims0) or "default", self.what)


class TrainGeometry(CardGeometry):
    """A trainer's route: the running caps that its loader threads grow,
    and one :class:`RawTrainStep` per cap schedule and grid state, by the
    grid for ``n_scenes`` scenes a batch until it is dropped."""

    def __init__(self, cfg: Config, device: torch.device, n_scenes: int):
        super().__init__(cfg, device)
        self.n_scenes = n_scenes
        self.caps: Optional[GeometryCaps] = None
        self._caps_lock = threading.Lock()
        self.raw_steps: Dict[Tuple, RawTrainStep] = {}
        self.grid_enabled = True
        self.overflow_streak = 0

    def raw_batch(self, assemble_raw, samples):
        """``(raw batch, its caps)`` of ``assemble_raw(samples, caps)`` on
        the running caps grown to hold ``samples``."""
        with self._caps_lock:
            caps = self.caps
        batch, caps = assemble_raw(samples, caps)
        with self._caps_lock:
            self.caps = caps
        return batch, caps.fixed  # the caps of THIS batch's shapes

    def raw_step(self, step, caps: Tuple[int, ...]) -> RawTrainStep:
        """The device-geometry step of one cap schedule and grid state."""
        key = (caps, self.grid_enabled)
        if key not in self.raw_steps:
            self.raw_steps[key] = RawTrainStep(
                step, caps,
                n_scenes=self.n_scenes if self.grid_enabled else None,
                grid_dims0=tuple(self.cfg.grid_dims0) or None)
        return self.raw_steps[key]

    def on_card(self, step, batch):
        """``(batch, its geometry on the card)`` of a host batch or a
        ``(raw batch, caps)``, whose host builder is
        :func:`host_batch_from_raw`."""
        if isinstance(batch, (DistillBatch, SegBatch)):
            return self.on_host(batch)
        raw, caps = batch
        return self.route(raw, self.raw_step(step, caps).geometry(raw),
                          lambda: host_batch_from_raw(raw), caps)

    def _count(self, overflow: bool, caps) -> None:
        super()._count(overflow, caps)
        self.overflow_streak = self.overflow_streak + 1 if overflow else 0
        limit = self.cfg.grid_overflow_limit
        if (limit > 0 and self.grid_enabled
                and self.overflow_streak >= limit):
            log.warning("%d overflows in a row: dropping the occupancy-grid "
                        "prober (do the scenes exceed grid_dims0=%s?)",
                        self.overflow_streak,
                        tuple(self.cfg.grid_dims0) or "default")
            self.grid_enabled = False
            self.overflow_streak = 0


class SceneGeometry(CardGeometry):
    """The evaluators' route, one scene at a time by the grid on the
    running caps, which the data ranks of ``mesh`` share."""

    what = "scene"

    def __init__(self, cfg: Config, device: torch.device,
                 mesh: Optional[Mesh] = None):
        super().__init__(cfg, device)
        self.mesh = mesh
        self.caps = None  # the running level caps

    def share_caps(self, sample):
        """Every data rank calls it once a round with its scene or None:
        the round's level counts grow the running caps in scene order, as
        on one process.  Returns the caps after this rank's scene, or None
        (no mesh, device geometry or scene: :meth:`on_card` grows them)."""
        if self.mesh is None or not self.on:
            return None
        counts = (eval_level_counts([sample]) if sample is not None
                  else [-1] * 5)
        mine = None
        for r, row in enumerate(all_gather_rows(counts, self.mesh)):
            if row[0] >= 0:
                self.caps = merge_counts(row, self.caps)
                if r == self.mesh.data_index:
                    mine = self.caps
        return mine

    def build(self, coords: np.ndarray, num, caps):
        """:func:`build_on_card` of one scene."""
        return build_on_card(self.cfg, self.device, coords, num, caps,
                             n_scenes=1,
                             grid_dims0=tuple(self.cfg.grid_dims0) or None)

    def on_card(self, assemble_raw, assemble_host, caps=None):
        """``(batch, its geometry on the card)`` of one scene:
        ``assemble_raw(caps) -> (raw batch, caps)`` on ``caps`` (from
        :meth:`share_caps`) or the running caps, or ``assemble_host()``."""
        if not self.on:
            return self.on_host(assemble_host())
        raw, grown = assemble_raw(self.caps if caps is None else caps)
        if caps is None:  # shared caps hold the scene already
            caps = self.caps = grown
        return self.route(raw, self.build(raw.coords, raw.num, caps.fixed),
                          assemble_host, caps.fixed)


def rank_scene_rounds(get, n_scenes: int, mesh: Optional[Mesh],
                      geometry: Optional[SceneGeometry] = None,
                      workers: int = 1):
    """``(scene index, sample, caps)`` of this rank's scene in each round
    of ``W`` scenes, one a data rank (``sample`` None where the last round
    has none), loaded by ``get(i)`` ``workers`` threads ahead; ``caps``:
    :meth:`SceneGeometry.share_caps` of the round (``geometry`` None: no
    sharing).  On one process (``mesh`` None): every scene in order."""
    n_dp, r = (1, 0) if mesh is None else (mesh.data, mesh.data_index)
    mine = range(r, n_scenes, n_dp)
    samples = iter(Prefetcher(get, mine, workers=workers) if workers > 1
                   else (get(i) for i in mine))
    for g in range(0, n_scenes, n_dp):
        i = g + r
        sample = next(samples) if i < n_scenes else None
        caps = None if geometry is None else geometry.share_caps(sample)
        yield i, sample, caps
