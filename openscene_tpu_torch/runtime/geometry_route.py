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

On a CUDA device a trainer's build is one CUDA graph per cap schedule and
grid state (:class:`RawTrainStep`), all in one memory pool: its some 7,800
small kernels, which the host took longer to launch than the card to run,
become one graph launch.  The evaluators' caps grow scene by scene, and
their build stays eager.
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
from ..models.ptv3 import serial_patch
from ..parallel.mesh import Mesh, all_gather_rows
from ..sparse.geometry import (GeometryCaps, build_unet_geometry,
                               geometry_to_device)
from ..sparse.geometry_device import build_geometry_parts, with_host_counts
from ..utils.profiling import span
from ..utils.train_utils import get_logger

log = get_logger()


def card_build(cfg: Config, device, caps: Sequence[int],
               n_scenes: Optional[int] = None,
               grid_dims0: Optional[Tuple[int, int, int]] = None,
               batch_scenes: int = 1):
    """``build(coords, num) -> (geometry, overflow)``, counts as 0-d
    tensors: ``build_geometry_parts`` of a padded level-0 batch on the card
    for ``caps``, by the grid of ``grid_dims0`` for ``n_scenes`` scenes,
    else by the search; with the serialization of ``cfg.arch_3d`` for
    batches of up to ``batch_scenes`` scenes where the model reads one
    (``models/ptv3.py``)."""
    patch = serial_patch(cfg.arch_3d)
    serial = None if patch is None else (patch, batch_scenes)

    def build(coords, num):
        return build_geometry_parts(
            torch.as_tensor(coords, device=device), num, tuple(caps),
            stem_occupancy=not cfg.input_color, n_scenes=n_scenes,
            grid_dims0=grid_dims0, serial=serial)
    return build


def build_on_card(build, coords, num):
    """``(geometry on the card with host level counts, overflow)`` of
    ``build(coords, num)`` (:func:`card_build`, or a captured build's
    replay, :class:`RawTrainStep`); invalid under overflow."""
    with span("geometry.build"):
        geo, overflow = build(coords, num)
    return with_host_counts(geo, overflow)


class RawTrainStep:
    """The geometry of a train ``step``'s raw batches
    (:class:`RawDistillBatch`, :class:`RawSegBatch`) on the card, for one
    cap schedule ``caps`` and grid state (``n_scenes`` None: the search).

    On a CUDA device the first call captures the build as a CUDA graph,
    after one warm-up build, into the memory pool ``pool``
    (a ``torch.cuda.graph_pool_handle()`` that every step of one
    :class:`TrainGeometry` shares; None: the graph's own); every call, the
    first included, copies the batch's coordinates into the graph's input
    buffer, sets its 0-d voxel count with a fill kernel and replays the
    graph on the current stream, after the previous step's work.  The
    plans are those of the eager build (:attr:`eager`, the CPU's), bit for
    bit.

    The geometry :meth:`geometry` returns lives in the pool: it stays
    valid until the next :meth:`geometry` call on any step of the pool (a
    replay may write its scratch where another schedule's outputs lie).
    Both trainers use it up inside ``train_step``; ``DistillTrainer.
    _epoch_end_viz`` replays once more after the epoch's last step, which
    the next step's replay then overwrites."""

    def __init__(self, step, caps: Sequence[int],
                 n_scenes: Optional[int] = None,
                 grid_dims0: Optional[Tuple[int, int, int]] = None,
                 pool=None, batch_scenes: int = 1):
        self.step, self.caps = step, tuple(int(c) for c in caps)
        self.n_scenes, self.grid_dims0, self.pool = n_scenes, grid_dims0, pool
        self.eager = card_build(step.cfg, step.device, self.caps, n_scenes,
                                grid_dims0, batch_scenes)
        self.replays = torch.device(step.device).type == "cuda"
        self._coords = self._num = None  # the graph's input buffers
        self._graph = None               # (CUDAGraph, geometry, overflow)

    def geometry(self, raw: RawDistillBatch):
        """(geometry on the card with host level counts, overflow)."""
        return build_on_card(self._replay if self.replays else self.eager,
                             raw.coords, raw.num)

    def _replay(self, coords, num):
        """``(geometry, overflow)`` of the graph replayed on a batch's
        level-0 ``coords`` and ``num``, captured on the first."""
        if self._coords is None:
            dev = self.step.device
            self._coords = torch.empty((self.caps[0], 4), dtype=torch.int32,
                                       device=dev)
            self._num = torch.zeros((), dtype=torch.int64, device=dev)
        self._coords.copy_(torch.as_tensor(coords))
        self._num.fill_(int(num))
        if self._graph is None:
            self._graph = self._capture()
        graph, geo, overflow = self._graph
        with span("geometry.replay"):
            graph.replay()
        return geo, overflow

    def _capture(self):
        """``(graph, geometry, overflow)``: the build on the input buffers
        (which hold the first batch) captured by ``torch.cuda.graph``.  The
        warm-up build before it makes the per-device constants, which a
        capture may not copy from the host.  It runs on the current stream
        and so reuses that stream's cached blocks: on a side stream, as in
        the ``torch.cuda.graphs`` recipe, it reserved blocks of its own,
        which raised a train step's peak by up to 1.7 GB."""
        with torch.cuda.device(self.step.device):
            self.eager(self._coords, self._num)
            graph = torch.cuda.CUDAGraph()
            # thread_local: the loader threads' host work may go on
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                geo, overflow = self.eager(self._coords, self._num)
        return graph, geo, overflow

    def release(self) -> None:
        """Free the graph: its outputs go back to the pool; a later batch
        would build eagerly."""
        self.replays = False
        self._coords = self._num = self._graph = None


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
        self.patch = serial_patch(cfg.arch_3d)  # None: no serialization

    def route(self, raw, built, host_batch, caps, count: bool = True):
        """``(batch, its geometry on the card)``: ``raw`` on ``built``, its
        ``(geometry, overflow)`` for ``caps``, or after an overflow
        :meth:`on_host` of ``host_batch()``.  ``count=False``: a batch
        built again (the trainer's epoch-end export), which moves no
        counter of the steps."""
        geo, overflow = built
        if count:
            self._count(overflow, caps)
        if not overflow:
            return raw, geo
        return self.on_host(host_batch())

    def on_host(self, batch):
        """``(batch, its host plans on the card)``, with the serialization
        where ``cfg.arch_3d`` reads one."""
        return batch, geometry_to_device(batch.geo, self.device, self.patch)

    def _count(self, overflow: bool, caps) -> None:
        if overflow:
            self.overflows += 1
            log.warning("device geometry overflowed (caps %s, grid_dims0 "
                        "%s); planning the %s on the host", tuple(caps),
                        tuple(self.cfg.grid_dims0) or "default", self.what)


class TrainGeometry(CardGeometry):
    """A trainer's route: the running caps that its loader threads grow,
    and one :class:`RawTrainStep` per cap schedule and grid state, by the
    grid for ``n_scenes`` scenes a batch until it is dropped.  On a CUDA
    device their graphs share one memory pool, ``pool``: each geometry is
    used up before the next build, so a schedule the caps outgrew holds
    only its outputs there, and the pool's scratch is that of the largest
    build."""

    def __init__(self, cfg: Config, device: torch.device, n_scenes: int):
        super().__init__(cfg, device)
        self.n_scenes = n_scenes
        self.caps: Optional[GeometryCaps] = None
        self._caps_lock = threading.Lock()
        self.raw_steps: Dict[Tuple, RawTrainStep] = {}
        self.pool = (torch.cuda.graph_pool_handle()
                     if torch.device(device).type == "cuda" else None)
        self.grid_enabled = True
        self.overflow_streak = 0
        self.export_overflows = 0  # exports built on the host

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
                grid_dims0=tuple(self.cfg.grid_dims0) or None,
                pool=self.pool, batch_scenes=self.n_scenes)
        return self.raw_steps[key]

    def on_card(self, step, batch, export: bool = False):
        """``(batch, its geometry on the card)`` of a host batch or a
        ``(raw batch, caps)``, whose host builder is
        :func:`host_batch_from_raw`.  ``export``: a batch a step has
        already counted, built again for the epoch-end export: its
        overflow counts in ``export_overflows`` alone, and the streak
        that drops the grid stays as the steps left it."""
        if isinstance(batch, (DistillBatch, SegBatch)):
            return self.on_host(batch)
        raw, caps = batch
        built = self.raw_step(step, caps).geometry(raw)
        if export and built[1]:
            self.export_overflows += 1
        return self.route(raw, built, lambda: host_batch_from_raw(raw), caps,
                          count=not export)

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
            for (_, grid), s in self.raw_steps.items():
                if grid:  # no batch takes the grid again
                    s.release()


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
        return build_on_card(
            card_build(self.cfg, self.device, caps, n_scenes=1,
                       grid_dims0=tuple(self.cfg.grid_dims0) or None),
            coords, num)

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
