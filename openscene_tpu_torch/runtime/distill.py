"""3D distillation training: regress fused CLIP features from geometry.

Counterpart of ``openscene_tpu/runtime/distill.py`` (reference
``run/distill.py``) on one CUDA device with host-built geometry: a
MinkUNet18A consumes voxelized point clouds (constant-1 input features by
default) and regresses the fused 2D CLIP features with a cosine (or L1) loss
on the voxels that have targets.

Parity details carried over:
* Adam with a poly LR schedule times 10 — the reference's ``index_split=0``
  puts every param group on the 10x branch (run/distill.py:141-142,344-347),
  so the effective LR is ``10 * base_lr * (1 - it/max_it)^power``, read at
  the iteration count *before* each update (step 0 trains at ``lr(0)``);
* per-batch random global coordinate shift (run/distill.py:315), applied in
  batch assembly;
* val-every-epoch mIoU against CLIP text embeddings gates the best
  checkpoint (run/distill.py:219-242).

Voxelization and batch assembly run on the host (ahead of the device in
``workers`` threads); forward, loss, backward and the Adam update run on the
device, the sparse convs and their gradients through the hand-written CUDA
kernels.  Each batch's geometry reaches the step on the card through
``runtime/geometry_route.py`` (:class:`TrainGeometry`).

Multi-GPU (``parallel/mesh.py``): one process per GPU.  ``data_parallel``
ranks each train on their slice of the global batch and average the
gradients, the BatchNorm running statistics and the loss over the data
group; ``model_parallel`` splits the head's output channels (and the
targets, the text columns and the head's Adam moments) over a model group.
Validation takes the scenes round-robin over the data ranks and sums the
IoU histograms.  Rank 0 logs and writes the checkpoints, which hold the
whole head.  A run starts under torchrun (``torchrun --nproc_per_node N -m
openscene_tpu_torch.runtime.distill ...``), with the config's
``coordinator_address``/``num_processes``/``process_id``, or from ``main``
alone, which starts ``data_parallel x model_parallel`` local processes.
After each epoch rank 0 writes a qualitative PLY dump of its last batch
(fused 2D labels, predictions, ground truth) under ``save_path/result/
last``.

Run: ``python -m openscene_tpu_torch.runtime.distill --config <yaml>
[--device cuda|cpu] [key value]*``
"""

from __future__ import annotations

import os
import sys
import time
from os.path import isfile, join
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import metrics
from ..config import Config, dataset_name_from_root, load_cli
from ..convert import optimizer_state_from_optax, params_from_jax
from ..data.batch import (DistillBatch, SegBatch, assemble_distill_batch,
                          assemble_raw_distill_batch, assemble_seg_batch)
from ..data.loaders import FusedFeatureLoader, Point3DLoader
from ..data.sharded import rank_indices
from ..device import resolve_device
from ..labels import labelset_and_palette
from ..models.disnet import output_dim
from ..models.sparse_unet import MinkUNet
from ..parallel import launch
from ..parallel.mesh import (Mesh, average_buffers, average_gradients,
                             gather_head, group_sum, head_shard, mesh_for,
                             mean_over_data, model_axis_size, replicate,
                             shard_head, sum_over_data)
from ..sparse.geometry import geometry_to_device
from ..sparse.types import UNetGeometry
from ..sparse.ops import matmul_f32
from ..text import extract_text_features
from ..utils.profiling import span
from ..utils.train_utils import (AverageMeter, ScalarWriter, get_logger,
                                 read_checkpoint, save_checkpoint)
# RawTrainStep stays importable from here: the benchmark's train entries
# wrap its ``geometry`` for their geometry span
from .geometry_route import RawTrainStep, TrainGeometry  # noqa: F401

log = get_logger()


def _guarded_norms(sq_o: torch.Tensor, sq_t: torch.Tensor):
    """sqrt with a guard: padded rows are exactly zero, d(sqrt)(0) is inf,
    and 0 * inf would leak NaN through the mask."""
    one = torch.ones((), dtype=sq_o.dtype, device=sq_o.device)
    return (torch.sqrt(torch.where(sq_o > 0, sq_o, one)),
            torch.sqrt(torch.where(sq_t > 0, sq_t, one.to(sq_t.dtype))))


def _masked_mean_one_minus(cos: torch.Tensor, mask: torch.Tensor):
    return ((1.0 - cos) * mask).sum() / mask.sum().clamp_min(1.0)


def cosine_distill_loss(out, target, mask, eps: float = 1e-8, group=None):
    """mean over masked voxels of (1 - cos(out, target))
    (run/distill.py:324-326; torch.nn.CosineSimilarity eps semantics).

    ``group``: ``out`` and ``target`` hold this rank's columns of D, and the
    three sums over D are finished over the model group
    (``parallel/mesh.py:group_sum``), as the JAX loss's ``model_axis``."""
    dot = (out * target).sum(-1)
    sq_o = (out * out).sum(-1)
    sq_t = (target * target).sum(-1)
    dot, sq_o, sq_t = group_sum((dot, sq_o, sq_t), group)
    norm_o, norm_t = _guarded_norms(sq_o, sq_t)
    cos = dot / (norm_o * norm_t).clamp_min(eps)
    return _masked_mean_one_minus(cos, mask)


def cosine_head_loss(feats, w_final, target, mask, eps: float = 1e-8,
                     group=None):
    """Cosine distill loss computed in pre-head space.

    With out = feats @ W (the final 1x1 conv, W: (C, D) with D=768/512):
      dot(out, t) = feats . (t @ W^T)          -- (cap, C)
      |out|^2     = feats . (feats @ (W W^T))  -- via the (C, C) Gram matrix
    so the (cap, D) head output and its cotangent never materialize, while
    the loss is the same function of the parameters.  ``group``: ``w_final``
    and ``target`` hold this rank's columns of D, and ``u``, the Gram matrix
    and ``|t|^2``, all sums over D, are finished over the model group."""
    wf = w_final[0] if w_final.dim() == 3 else w_final  # (C, D) or (C, D/m)
    cdtype = feats.dtype
    u = matmul_f32(target.to(cdtype), wf.t().to(cdtype))    # (cap, C)
    gram = wf @ wf.t()
    sq_t = (target.float() ** 2).sum(-1)
    u, gram, sq_t = group_sum((u, gram, sq_t), group)
    f32 = feats.float()
    dot = (f32 * u).sum(-1)
    sq_o = ((f32 @ gram.float()) * f32).sum(-1)
    norm_o, norm_t = _guarded_norms(sq_o, sq_t)
    cos = dot / (norm_o * norm_t).clamp_min(eps)
    return _masked_mean_one_minus(cos, mask)


def l1_distill_loss(out, target, mask, group=None):
    """Mean |out - target| over the masked voxels' D features; ``group``:
    this rank holds D/m of them, summed over the model group."""
    diff = ((out - target).abs() * mask[:, None]).sum()
    (diff,) = group_sum((diff,), group)
    d = out.shape[-1] * (1 if group is None else dist.get_world_size(group))
    return diff / (mask.sum() * d).clamp_min(1.0)


def make_optimizer(cfg: Config, model: torch.nn.Module, max_iter: int
                   ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """Adam (betas 0.9/0.999, eps 1e-8, no weight decay) and the schedule
    ``lr(it) = base_lr * lr_multiplier * max(1 - it/max_iter, 0)**power``.
    The train step writes ``lr(it)`` into the optimizer before update
    number ``it``."""
    def schedule(it: int) -> float:
        frac = max(1.0 - it / max_iter, 0.0)
        return cfg.base_lr * cfg.lr_multiplier * frac ** cfg.power

    opt = torch.optim.Adam(model.parameters(), lr=schedule(0),
                           betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    return opt, schedule


def compute_dtype(cfg: Config) -> torch.dtype:
    return (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
            else torch.float32)


class TrainStep:
    """``step(batch) -> loss``: one update on a host-geometry
    :class:`DistillBatch`.  ``it`` counts the updates taken (the schedule's
    argument); the loss comes back as a 0-d device tensor, so the caller
    decides when to wait for the device.  :meth:`run` takes the geometry
    already on the device (the trainers' way in) and the batch's level-0
    arrays that :meth:`parts` picks; a subclass with its own
    :meth:`parts` and :meth:`loss_on` trains another objective
    (``runtime/train_seg.py``).

    ``mesh`` (one rank of a multi-GPU run, ``parallel/mesh.py``): after the
    backward the gradients are averaged over the data group, and after the
    update the BatchNorm running statistics and the loss; with a model
    axis, ``model.final`` holds this rank's columns of the head and the
    step trains on the same columns of the targets.  Every rank takes the
    same number of collectives in the same order, whatever its batch."""

    def __init__(self, cfg: Config, model: MinkUNet,
                 optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], device, it: int = 0,
                 mesh: Optional[Mesh] = None):
        if cfg.loss_type not in ("cosine", "l1"):
            raise NotImplementedError(cfg.loss_type)
        self.cfg, self.model, self.optimizer = cfg, model, optimizer
        self.schedule, self.device, self.it = schedule, device, it
        self.cdtype = compute_dtype(cfg)
        self.mesh = mesh

    @staticmethod
    def parts(batch) -> tuple:
        """The level-0 arrays :meth:`loss_on` reads, of a host or raw
        batch."""
        return batch.feats, batch.feat_3d, batch.mask

    def loss_on(self, geo: UNetGeometry, feats, feat_3d, mask
                ) -> torch.Tensor:
        """The loss of one batch whose geometry is on the device."""
        cfg, dev = self.cfg, self.device
        x = torch.as_tensor(feats, device=dev).to(self.cdtype)
        # targets ship fp16 from the host (storage dtype); compute in cdtype
        target = torch.as_tensor(head_shard(feat_3d, self.mesh),
                                 device=dev).to(self.cdtype)
        mask = torch.as_tensor(mask, device=dev)
        group = (self.mesh.model_group if model_axis_size(self.mesh) > 1
                 else None)
        feats = self.model(x, geo, constant_input=not cfg.input_color,
                           return_prehead=True)
        if cfg.loss_type == "cosine" and cfg.memory_efficient_loss:
            return cosine_head_loss(feats, self.model.final, target, mask,
                                    group=group)
        out = self.model.head(feats, group)
        if cfg.loss_type == "cosine":
            return cosine_distill_loss(out, target, mask, group=group)
        return l1_distill_loss(out, target, mask, group)

    def run(self, geo: UNetGeometry, *parts) -> torch.Tensor:
        """One update on a batch whose geometry is on the device."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            loss = self.loss_on(geo, *parts)
        with span("train.backward"):
            loss.backward()
            if self.mesh is not None:
                average_gradients(list(self.model.parameters()), self.mesh)
        with span("train.optimizer"):
            lr = self.schedule(self.it)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            if self.mesh is not None:
                average_buffers(self.model, self.mesh)
                loss = mean_over_data(loss, self.mesh)
        self.it += 1
        return loss.detach()

    def __call__(self, batch: DistillBatch) -> torch.Tensor:
        return self.run(geometry_to_device(batch.geo, self.device),
                        *self.parts(batch))


def make_train_step(cfg: Config, model: MinkUNet,
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], device,
                    it: int = 0, mesh: Optional[Mesh] = None) -> TrainStep:
    return TrainStep(cfg, model, optimizer, schedule, device, it, mesh)


def make_val_step(cfg: Config, mesh: Optional[Mesh] = None):
    """Per-batch validation ``step(model, text, batch)``: point-level logits
    vs text + IoU histograms (reference validate(), run/distill.py:403-447).
    Returns (loss_sum, n_valid_points, inter, union, tgt) as device tensors;
    ``batch`` is an ``eval_all`` :class:`SegBatch`.  With a model axis the
    model's output and ``text`` are cut to this rank's columns and the
    logits summed over the model group."""
    cdtype = compute_dtype(cfg)
    const_in = not cfg.input_color
    classes, ignore = cfg.classes, cfg.ignore_label
    group = mesh.model_group if model_axis_size(mesh) > 1 else None

    @torch.no_grad()
    def step(model: MinkUNet, text: torch.Tensor, batch: SegBatch):
        dev = text.device
        model.eval()
        geo = geometry_to_device(batch.geo, dev)
        x = torch.as_tensor(batch.feats, device=dev).to(cdtype)
        out = model(x, geo, constant_input=const_in)
        logits_v = out @ head_shard(text, mesh).t().float()
        if group is not None:
            dist.all_reduce(logits_v, group=group)
        inds = torch.as_tensor(batch.inds_reconstruct, device=dev).long()
        logits = logits_v.index_select(0, inds)
        labels = torch.as_tensor(batch.point_labels, device=dev).long()
        pred = logits.argmax(-1)
        # cross-entropy with ignore 255 (over valid points only)
        logp = torch.log_softmax(logits, dim=-1)
        valid = labels != 255
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        ce = -logp.gather(1, safe[:, None])[:, 0]
        loss_sum = (ce * valid).sum()
        n_valid = valid.sum()
        return (loss_sum, n_valid) + iou_histograms(pred, labels, classes,
                                                    ignore)

    return step


def iou_histograms(pred: torch.Tensor, labels: torch.Tensor, classes: int,
                   ignore: int = 255):
    """Per-class (intersection, union, target) counts on the device, as
    ``metrics.intersection_and_union`` computes them on the host: a
    prediction at an ignored label falls outside every class."""
    labels = labels.long()
    pred = torch.where(labels == ignore, torch.full_like(pred, ignore), pred)
    ids = torch.arange(classes, device=pred.device)
    out_1h = pred[:, None] == ids[None, :]
    tgt = (labels[:, None] == ids[None, :]).sum(0)
    inter = (out_1h & (pred == labels)[:, None]).sum(0)
    return inter, out_1h.sum(0) + tgt - inter, tgt


class TrainerBase:
    """What the trainers share: the rank's place in a multi-GPU run
    (``mesh``, None on one process), its scenes of each global batch
    ``workers`` threads ahead of the step on their geometry on the card
    (``geometry``), and the checkpoints.  The trainer sets ``train_data``,
    ``batches_per_epoch``, ``rng`` and ``step_fn``, and defines
    ``assemble(samples)`` and ``assemble_raw(samples, caps)``."""

    def _init_rank(self, cfg: Config, device, entry: str,
                   model_parallel: int = 1) -> None:
        """``entry``: the runtime module that launches the trainer."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh_for(entry, cfg.data_parallel, model_parallel,
                             self.device, batch_size=cfg.batch_size)
        self.n_dp = 1 if self.mesh is None else self.mesh.data
        self.data_index = 0 if self.mesh is None else self.mesh.data_index
        self.is_main = self.mesh is None or self.mesh.is_main
        # the reference divides the global batch over the ranks
        # (run/distill.py:146)
        self.per_dev_batch = max(cfg.batch_size // self.n_dp, 1)
        if self.mesh is not None:
            log.info("multi-GPU: %d x %d mesh (data x model), %d scenes a "
                     "rank", self.mesh.data, self.mesh.model,
                     self.per_dev_batch)
        self.geometry = TrainGeometry(cfg, self.device, self.per_dev_batch)

    @property
    def global_step(self) -> int:
        return self.step_fn.it

    @property
    def overflows(self) -> int:
        """Batches built on the host after their geometry overflowed."""
        return self.geometry.overflows

    def _epoch_batches(self):
        """Batches built ``workers`` threads ahead of the device step
        (replaces the reference's DataLoader worker pool): host batches, or
        ``(raw batch, caps)`` with device geometry."""
        order = self.rng.permutation(len(self.train_data))

        def build(i):
            idxs = rank_indices(order, i, self.per_dev_batch, self.n_dp,
                                self.data_index)
            samples = [self.train_data.get(j) for j in idxs]
            if not self.geometry.on:
                return self.assemble(samples)
            return self.geometry.raw_batch(self.assemble_raw, samples)

        if self.cfg.workers <= 1:
            for i in range(self.batches_per_epoch):
                yield build(i)
        else:
            from ..data.prefetch import Prefetcher
            yield from Prefetcher(build, range(self.batches_per_epoch),
                                  workers=self.cfg.workers)

    def train_step(self, batch):
        """One update on a batch of :meth:`_epoch_batches`, on its geometry
        on the card (:meth:`TrainGeometry.on_card`); returns the step's
        result (device tensors)."""
        batch, geo = self.geometry.on_card(self.step_fn, batch)
        return self.step_fn.run(geo, *self.step_fn.parts(batch))

    def _resume(self, path: str) -> Tuple[int, float]:
        """Load a checkpoint into the model, the optimizer and the step
        count: the port's own (``torch.save``) or the JAX package's (flax
        msgpack, through ``convert``).  Every rank reads it; with a model
        axis each then keeps its columns of the head and of its Adam
        moments.  Returns ``(epoch, best_iou)``."""
        payload, is_flax = read_checkpoint(path)
        epoch = int(payload.get("epoch", 0))
        sharded = model_axis_size(self.mesh) > 1
        if is_flax:
            sd = params_from_jax(payload["params"], payload["state"],
                                 self.cfg.arch_3d)
            if sharded:
                sd["final"] = head_shard(sd["final"], self.mesh)
            self.model.load_state_dict(sd)
            self.step_fn.it = optimizer_state_from_optax(
                self.optimizer, self.model, payload["opt_state"])
        else:
            sd = dict(payload["model"])
            if sharded:
                sd["final"] = head_shard(sd["final"], self.mesh)
            self.model.load_state_dict(sd)
            self.optimizer.load_state_dict(payload["optimizer"])
            self.step_fn.it = epoch * self.batches_per_epoch
        if sharded:
            state = self.optimizer.state[self.model.final]
            for k in ("exp_avg", "exp_avg_sq"):
                state[k] = head_shard(state[k], self.mesh).clone()
        log.info("resumed from %s (epoch %d, %s checkpoint)", path, epoch,
                 "JAX" if is_flax else "torch")
        return epoch, float(payload.get("best_iou", 0.0))

    def _checkpoint(self, epoch: int) -> dict:
        """The checkpoint after ``epoch``.  Every rank calls it: with a model
        axis the head and its Adam moments are gathered to full width, so
        one GPU reads the checkpoint as it reads a one-GPU run's."""
        model_sd = self.model.state_dict()
        opt_sd = self.optimizer.state_dict()
        if model_axis_size(self.mesh) > 1:
            model_sd["final"] = gather_head(model_sd["final"], self.mesh)
            params = self.optimizer.param_groups[0]["params"]
            i = next(j for j, p in enumerate(params) if p is self.model.final)
            state = dict(opt_sd["state"][i])
            for k in ("exp_avg", "exp_avg_sq"):
                state[k] = gather_head(state[k], self.mesh)
            opt_sd["state"][i] = state
        return {"epoch": epoch, "model": model_sd, "optimizer": opt_sd,
                "best_iou": self.best_iou}


class DistillTrainer(TrainerBase):
    def __init__(self, cfg: Config, allow_pseudo_text: bool = False,
                 device=None):
        self.dim = output_dim(cfg.feature_2d_extractor)
        if self.dim % max(cfg.model_parallel, 1):
            raise ValueError(f"model_parallel={cfg.model_parallel} must "
                             f"divide the distill head's D={self.dim}")
        self._init_rank(cfg, device, "distill", cfg.model_parallel)
        gen = torch.Generator().manual_seed(cfg.manual_seed)
        self.model = MinkUNet(3, self.dim, cfg.arch_3d,
                              generator=gen).to(self.device)
        replicate(self.model, self.mesh)
        shard_head(self.model, self.mesh)
        if cfg.sync_bn and self.mesh is None:
            log.warning("sync_bn=True has no effect on a single device; with "
                        "data_parallel>1 the BN running statistics are "
                        "always averaged over the ranks after each step")
        if model_axis_size(self.mesh) > 1:
            log.info("model_parallel=%d: distill head D-sharded over the "
                     "model group (%d-wide shards)", cfg.model_parallel,
                     self.dim // cfg.model_parallel)

        self.train_data = FusedFeatureLoader(
            datapath_prefix=cfg.data_root,
            datapath_prefix_feat=cfg.data_root_2d_fused_feature,
            voxel_size=cfg.voxel_size, split="train", aug=cfg.aug,
            memcache=cfg.use_shm, loop=cfg.loop,
            input_color=cfg.input_color, seed=cfg.manual_seed)
        self.batches_per_epoch = max(
            len(self.train_data) // (self.per_dev_batch * self.n_dp), 1)
        self.max_iter = cfg.epochs * self.batches_per_epoch
        self.optimizer, self.schedule = make_optimizer(cfg, self.model,
                                                       self.max_iter)
        self.step_fn = make_train_step(cfg, self.model, self.optimizer,
                                       self.schedule, self.device,
                                       mesh=self.mesh)
        self.val_step = make_val_step(cfg, self.mesh)
        self.rng = np.random.default_rng(cfg.manual_seed)
        self.start_epoch = cfg.start_epoch
        self.best_iou = 0.0

        labelset_name = dataset_name_from_root(cfg.data_root)
        labels, self.palette, _ = labelset_and_palette(labelset_name)
        text = extract_text_features(
            labels, cfg.feature_2d_extractor, cfg.data_root, cfg.prompt_eng,
            cfg.text_embedding_cache, embedding_file=cfg.embedding_file,
            allow_pseudo=allow_pseudo_text or cfg.allow_pseudo_text,
            dataset_name=labelset_name)
        self.text = torch.as_tensor(np.asarray(text, dtype=np.float32),
                                    device=self.device)
        if cfg.evaluate:
            self.val_data = Point3DLoader(
                datapath_prefix=cfg.data_root, voxel_size=cfg.voxel_size,
                split="val", aug=False, memcache=cfg.use_shm, eval_all=True,
                input_color=cfg.input_color, seed=cfg.manual_seed + 1)
        if cfg.resume and isfile(cfg.resume):
            self.start_epoch, self.best_iou = self._resume(cfg.resume)

    def assemble(self, samples):
        return assemble_distill_batch(samples, self.dim, rng=self.rng)

    def assemble_raw(self, samples, caps):
        return assemble_raw_distill_batch(samples, self.dim, caps=caps,
                                          rng=self.rng)

    def train_epoch(self, epoch: int, writer: Optional[ScalarWriter] = None):
        loss_meter = AverageMeter()
        data_meter = AverageMeter()
        batch_meter = AverageMeter()
        end = time.time()
        batch = None
        for i, batch in enumerate(self._epoch_batches()):
            data_meter.update(time.time() - end)
            loss = float(self.train_step(batch))  # waits for the device
            loss_meter.update(loss, self.cfg.batch_size)
            batch_meter.update(time.time() - end)
            end = time.time()
            if (i + 1) % self.cfg.print_freq == 0:
                log.info(
                    "Epoch: [%d/%d][%d/%d] Data %.3f (%.3f) Batch %.3f "
                    "(%.3f) Loss %.4f LR %.2e", epoch + 1, self.cfg.epochs,
                    i + 1, self.batches_per_epoch, data_meter.val,
                    data_meter.avg, batch_meter.val, batch_meter.avg,
                    loss_meter.val, self.schedule(self.global_step))
            if writer:
                writer.add_scalar("loss_train_batch", loss, self.global_step)
        # the model group of data rank 0 (every rank of it: the head's
        # logits are summed over it); rank 0 writes
        if (self.cfg.save_path and batch is not None
                and (self.mesh is None or self.mesh.data_index == 0)):
            try:
                self._epoch_end_viz(epoch, batch)
            except Exception as e:  # a qualitative dump never stops training
                log.warning("epoch-end viz failed: %s", e, exc_info=True)
        return loss_meter.avg

    @torch.no_grad()
    def _epoch_end_viz(self, epoch: int, batch) -> None:
        """Epoch-end qualitative PLY dump comparing fused 2D labels, model
        predictions and GT on scene 0 of ``batch``, this rank's last train
        batch (run/distill.py:372-398; the JAX trainer's
        ``_epoch_end_viz``): ``save_path/result/last/{ext}_{epoch}.ply``,
        ``pred_{epoch}.ply`` and ``gt_{epoch}.ply``, at the level-0 voxel
        coordinates of scene 0's voxels that have targets.  The model runs
        in eval mode on the batch's geometry on the card
        (:meth:`TrainGeometry.on_card`)."""
        from ..utils.viz import export_labeled_cloud
        dev = self.device
        batch, geo = self.geometry.on_card(self.step_fn, batch)
        n = int(geo.levels[0].num)
        coords = geo.levels[0].coords[:n].cpu().numpy()
        rows = (np.asarray(batch.mask[:n]) > 0) & (coords[:, 0] == 0)
        if not rows.any():
            return
        was_training = self.model.training
        self.model.eval()
        try:
            x = torch.as_tensor(batch.feats, device=dev).to(
                compute_dtype(self.cfg))
            out = self.model(x, geo, constant_input=not self.cfg.input_color)
        finally:
            self.model.train(was_training)
        sel = torch.as_tensor(np.flatnonzero(rows), device=dev)
        text_t = head_shard(self.text, self.mesh).t().float()
        logits = out.index_select(0, sel) @ text_t
        if model_axis_size(self.mesh) > 1:  # the head's columns summed
            (logits,) = group_sum((logits,), self.mesh.model_group)
        pred_ids = logits.argmax(1).cpu().numpy()
        text_np = self.text.t().float().cpu().numpy()
        img_ids = (np.asarray(batch.feat_3d[:n][rows], dtype=np.float32)
                   @ text_np).argmax(1)
        gt = np.asarray(batch.labels[:n][rows]).copy()
        gt[gt == 255] = self.cfg.classes
        if not self.is_main:
            return
        pcl = coords[rows][:, 1:].astype(np.float32)
        folder = join(self.cfg.save_path, "result", "last")
        os.makedirs(folder, exist_ok=True)
        ext = self.cfg.feature_2d_extractor
        for name, ids in ((f"{ext}_{epoch + 1}", img_ids),
                          (f"pred_{epoch + 1}", pred_ids),
                          (f"gt_{epoch + 1}", gt)):
            export_labeled_cloud(join(folder, f"{name}.ply"), pcl, ids,
                                 self.palette)

    def validate(self) -> Tuple[float, float, float, float]:
        """Loss (the mean of the scenes' mean losses), mIoU, mAcc and
        allAcc of the val split; the data ranks take its scenes
        round-robin and sum their IoU histograms (reference
        ``dist.all_reduce``, run/distill.py:429-431)."""
        loss_sum, n = 0.0, 0
        hist = np.zeros((3, self.cfg.classes))
        for i in range(self.data_index, len(self.val_data), self.n_dp):
            sample = self.val_data.get(i)
            batch = assemble_seg_batch([sample], eval_all=True)
            ls, nv, bi, bu, bt = self.val_step(self.model, self.text, batch)
            loss_sum += float(ls) / max(int(nv), 1)
            n += 1
            hist += torch.stack([bi, bu, bt]).cpu().numpy()
        if self.mesh is not None:
            tot = torch.as_tensor(np.append(hist.ravel(), [loss_sum, n]),
                                  dtype=torch.float64, device=self.device)
            (tot,) = sum_over_data((tot,), self.mesh)
            tot = tot.cpu().numpy()
            hist, (loss_sum, n) = tot[:-2].reshape(hist.shape), tot[-2:]
        miou, macc, allacc = metrics.miou_from_histograms(*hist)
        log.info("Val result: mIoU/mAcc/allAcc %.4f/%.4f/%.4f", miou, macc,
                 allacc)
        return loss_sum / max(n, 1), miou, macc, allacc

    def fit(self):
        cfg = self.cfg
        writer = ScalarWriter(cfg.save_path) if self.is_main else None
        for epoch in range(self.start_epoch, cfg.epochs):
            loss_train = self.train_epoch(epoch, writer)
            epoch_log = epoch + 1
            if writer:
                writer.add_scalar("loss_train", loss_train, epoch_log)
            is_best = False
            if cfg.evaluate and epoch_log % cfg.eval_freq == 0:
                loss_val, miou, macc, allacc = self.validate()
                for tag, v in (("loss_val", loss_val), ("mIoU_val", miou),
                               ("mAcc_val", macc), ("allAcc_val", allacc)):
                    if writer:
                        writer.add_scalar(tag, v, epoch_log)
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
    return DistillTrainer(cfg, device=device).fit()


def main(argv=None):
    cfg, device = load_cli(argv if argv is not None else sys.argv[1:])
    return launch.run(train, cfg, device, cfg.model_parallel)


if __name__ == "__main__":
    main()
