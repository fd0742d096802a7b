"""Supervised sparse-UNet segmentation baseline (the reference's
``run/train_mink.py``), on one CUDA device by default.

Counterpart of ``openscene_tpu/runtime/train_seg.py``: MinkUNet18A -> class
logits, cross-entropy with ignore 255, SGD with momentum and coupled weight
decay, a poly learning rate (no 10x multiplier here) read at the update
count before each update, per-batch IoU histograms, a val-gated best
checkpoint and a per-batch random global shift (in batch assembly).

Each batch's geometry reaches the step on the card through
``runtime/geometry_route.py``, as the distillation trainer's does.  The IoU
histograms are computed on the device.  Resume takes the port's own
checkpoints and the JAX package's (flax msgpack; optax's SGD trace becomes
torch's ``momentum_buffer``).

Multi-GPU, one process per GPU (``parallel/mesh.py``), as the distillation
trainer: ``data_parallel`` ranks train on their slices of each global batch
and average the gradients, the BatchNorm running statistics and the loss,
and sum the IoU histograms, over the data group; there is no model axis,
as in the JAX package.  Validation takes the scenes round-robin.  Launch
with torchrun, the config's ``coordinator_address``/``num_processes``/
``process_id``, or ``main`` alone, which starts ``data_parallel`` local
processes.

Run: ``python -m openscene_tpu_torch.runtime.train_seg --config
configs/scannet/mink.yaml [--device cuda|cpu] [key value]*``
"""

from __future__ import annotations

import os
import sys
from os.path import isfile, join
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import metrics
from ..config import Config, load_cli
from ..data.batch import (SegBatch, assemble_raw_seg_batch,
                          assemble_seg_batch)
from ..data.loaders import Point3DLoader
from ..models.sparse_unet import MinkUNet
from ..parallel import launch
from ..parallel.mesh import Mesh, replicate, sum_over_data
from ..sparse.types import UNetGeometry
from ..utils.train_utils import (AverageMeter, ScalarWriter, get_logger,
                                 save_checkpoint)
from .distill import TrainerBase, TrainStep, compute_dtype, iou_histograms
from .geometry_route import SceneGeometry, rank_scene_rounds

log = get_logger()


def focal_loss(probs: torch.Tensor, labels: torch.Tensor, num_classes: int,
               gamma: float = 2.0, eps: float = 1e-7,
               reduce: str = "sum") -> torch.Tensor:
    """Focal loss on probabilities (reference util/util.py:261-285): labels
    255, like any label outside ``[0, num_classes)``, have no one-hot
    column and are ignored; probabilities are clamped to [eps, 1 - eps]."""
    lab = torch.where(labels == 255, num_classes, labels.long())
    y = (lab[:, None] == torch.arange(num_classes, device=labels.device)
         ).to(probs.dtype)
    p = probs.clamp(eps, 1.0 - eps)
    loss = -y * torch.log(p) * (1.0 - p) ** gamma
    return loss.mean() if reduce == "mean" else loss.sum()


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore: int = 255) -> torch.Tensor:
    """Mean cross-entropy over the voxels whose label is not ``ignore``
    (torch CrossEntropyLoss semantics; 0 when every label is ignored)."""
    labels = labels.long()
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(1, safe[:, None])[:, 0]
    return (ce * valid).sum() / valid.sum().clamp_min(1)


def make_seg_optimizer(cfg: Config, model: torch.nn.Module, max_iter: int
                       ) -> Tuple[torch.optim.Optimizer,
                                  Callable[[int], float]]:
    """SGD with ``cfg.momentum`` and coupled ``cfg.weight_decay`` (the
    gradient plus ``weight_decay * w`` goes into the momentum buffer, as
    optax's ``add_decayed_weights`` before ``sgd(momentum)`` does) and the
    schedule ``lr(it) = base_lr * max(1 - it/max_iter, 0)**power``, written
    into the optimizer before update number ``it``."""
    def schedule(it: int) -> float:
        return cfg.base_lr * max(1.0 - it / max_iter, 0.0) ** cfg.power

    opt = torch.optim.SGD(model.parameters(), lr=schedule(0),
                          momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay)
    return opt, schedule


class SegTrainStep(TrainStep):
    """``step(batch) -> (loss, inter, union, tgt)``: one SGD update on a
    host-geometry :class:`SegBatch` (:meth:`run` on device geometry, as
    :class:`TrainStep`), with the batch's IoU histograms over its voxels;
    all four are device tensors.  Under a mesh the loss is the data
    group's mean and the histograms its sums."""

    @staticmethod
    def parts(batch) -> tuple:
        return batch.feats, batch.labels

    def loss_on(self, geo: UNetGeometry, feats, labels) -> torch.Tensor:
        dev = self.device
        x = torch.as_tensor(feats, device=dev).to(self.cdtype)
        labels = torch.as_tensor(labels, device=dev).long()
        out = self.model(x, geo, constant_input=not self.cfg.input_color)
        self._hist = iou_histograms(out.detach().argmax(-1), labels,
                                    self.cfg.classes, self.cfg.ignore_label)
        return cross_entropy_ignore(out, labels, self.cfg.ignore_label)

    def run(self, geo: UNetGeometry, feats, labels):
        loss = super().run(geo, feats, labels)
        hist = self._hist
        if self.mesh is not None:
            hist = sum_over_data(hist, self.mesh)
        return (loss,) + tuple(hist)


def make_seg_train_step(cfg: Config, model: MinkUNet,
                        optimizer: torch.optim.Optimizer,
                        schedule: Callable[[int], float], device,
                        it: int = 0, mesh: Optional[Mesh] = None
                        ) -> SegTrainStep:
    return SegTrainStep(cfg, model, optimizer, schedule, device, it, mesh)


class SegSceneLogits:
    """``scenes(sample, caps=None) -> (logits, labels)``: one ``eval_all``
    scene's fp32 logits and labels at its original points, as NumPy arrays,
    on its geometry on the card (:meth:`SceneGeometry.on_card`)."""

    def __init__(self, cfg: Config, model: MinkUNet, device: torch.device,
                 mesh: Optional[Mesh] = None):
        self.cfg, self.model = cfg, model
        self.geometry = SceneGeometry(cfg, device, mesh)

    @torch.no_grad()
    def __call__(self, sample, caps=None):
        batch, geo = self.geometry.on_card(
            lambda caps: assemble_raw_seg_batch([sample], caps=caps,
                                                eval_all=True),
            lambda: assemble_seg_batch([sample], eval_all=True), caps)
        dev = self.model.final.device
        self.model.eval()
        x = torch.as_tensor(batch.feats, device=dev).to(
            compute_dtype(self.cfg))
        out = self.model(x, geo, constant_input=not self.cfg.input_color)
        n = batch.num_points
        inds = torch.as_tensor(batch.inds_reconstruct[:n], device=dev).long()
        return (out.index_select(0, inds).float().cpu().numpy(),
                np.asarray(batch.point_labels[:n]))


class SegTrainer(TrainerBase):
    def __init__(self, cfg: Config, device=None):
        self._init_rank(cfg, device, "train_seg")
        gen = torch.Generator().manual_seed(cfg.manual_seed)
        self.model = MinkUNet(3, cfg.classes, cfg.arch_3d,
                              generator=gen).to(self.device)
        replicate(self.model, self.mesh)
        self.train_data = Point3DLoader(
            datapath_prefix=cfg.data_root, voxel_size=cfg.voxel_size,
            split="train", aug=cfg.aug, memcache=cfg.use_shm, loop=cfg.loop,
            input_color=cfg.input_color, seed=cfg.manual_seed)
        self.batches_per_epoch = max(
            len(self.train_data) // (self.per_dev_batch * self.n_dp), 1)
        self.max_iter = cfg.epochs * self.batches_per_epoch
        self.optimizer, self.schedule = make_seg_optimizer(
            cfg, self.model, self.max_iter)
        self.step_fn = make_seg_train_step(cfg, self.model, self.optimizer,
                                           self.schedule, self.device,
                                           mesh=self.mesh)
        self.rng = np.random.default_rng(cfg.manual_seed)
        self.start_epoch = cfg.start_epoch
        self.best_iou = 0.0
        if cfg.evaluate:
            self.val_data = Point3DLoader(
                datapath_prefix=cfg.data_root, voxel_size=cfg.voxel_size,
                split="val", aug=False, memcache=cfg.use_shm, eval_all=True,
                input_color=cfg.input_color, seed=cfg.manual_seed + 1)
        if cfg.resume and isfile(cfg.resume):
            self.start_epoch, self.best_iou = self._resume(cfg.resume)

    def assemble(self, samples) -> SegBatch:
        return assemble_seg_batch(samples, rng=self.rng, shift=True)

    def assemble_raw(self, samples, caps):
        return assemble_raw_seg_batch(samples, caps=caps, rng=self.rng,
                                      shift=True)

    def train_epoch(self, epoch: int, writer: Optional[ScalarWriter] = None):
        """One epoch; returns (mean loss, train mIoU from the histograms)."""
        cfg = self.cfg
        loss_meter = AverageMeter()
        hist = torch.zeros((3, cfg.classes), dtype=torch.int64,
                           device=self.device)
        for i, batch in enumerate(self._epoch_batches()):
            loss, *h = self.train_step(batch)
            hist += torch.stack(h)
            loss = float(loss)  # waits for the device
            loss_meter.update(loss, cfg.batch_size)
            if (i + 1) % cfg.print_freq == 0:
                inter, _, tgt = hist.cpu().numpy()
                log.info("Epoch: [%d/%d][%d/%d] Loss %.4f Accuracy %.4f",
                         epoch + 1, cfg.epochs, i + 1,
                         self.batches_per_epoch, loss_meter.val,
                         inter.sum() / (tgt.sum() + 1e-10))
            if writer:
                writer.add_scalar("loss_train_batch", loss, self.global_step)
        miou, macc, allacc = metrics.miou_from_histograms(
            *hist.cpu().numpy())
        log.info("Train result at epoch [%d/%d]: mIoU/mAcc/allAcc "
                 "%.4f/%.4f/%.4f", epoch + 1, cfg.epochs, miou, macc, allacc)
        return loss_meter.avg, miou

    def validate(self) -> float:
        """Single-repeat val mIoU at the original points; the data ranks
        take the scenes round-robin and every rank gets the mIoU of all of
        them."""
        scenes = SegSceneLogits(self.cfg, self.model, self.device, self.mesh)
        preds, gts = [], []
        for _, sample, caps in rank_scene_rounds(
                self.val_data.get, len(self.val_data), self.mesh,
                scenes.geometry):
            if sample is not None:
                logits, labels = scenes(sample, caps)
                preds.append(logits.argmax(1))
                gts.append(labels)
        pred, gt = np.concatenate(preds), np.concatenate(gts)
        if self.mesh is not None:
            parts = [None] * self.n_dp
            dist.all_gather_object(parts, (pred, gt))
            pred = np.concatenate([p for p, _ in parts])
            gt = np.concatenate([g for _, g in parts])
        miou = metrics.evaluate(pred, gt,
                                dataset=self.train_data.dataset_name)
        log.info("Val mIoU: %.4f", miou)
        return miou

    def fit(self) -> float:
        cfg = self.cfg
        writer = ScalarWriter(cfg.save_path) if self.is_main else None
        for epoch in range(self.start_epoch, cfg.epochs):
            loss_train, _ = self.train_epoch(epoch, writer)
            epoch_log = epoch + 1
            if writer:
                writer.add_scalar("loss_train", loss_train, epoch_log)
            is_best = False
            if cfg.evaluate and epoch_log % cfg.eval_freq == 0:
                miou = self.validate()
                if writer:
                    writer.add_scalar("mIoU_val", miou, epoch_log)
                is_best = miou > self.best_iou
                self.best_iou = max(self.best_iou, miou)
            if epoch_log % cfg.save_freq == 0:
                payload = self._checkpoint(epoch_log)
                if self.is_main:
                    save_checkpoint(payload, is_best,
                                    join(cfg.save_path, "model"))
        log.info("==>Training done!\nBest Iou: %.3f", self.best_iou)
        return self.best_iou


def train(cfg: Config, device=None) -> float:
    """One rank's training run (``main``'s work on every rank)."""
    os.makedirs(join(cfg.save_path, "model"), exist_ok=True)
    return SegTrainer(cfg, device=device).fit()


def main(argv=None):
    cfg, device = load_cli(argv if argv is not None else sys.argv[1:])
    return launch.run(train, cfg, device)


if __name__ == "__main__":
    main()
