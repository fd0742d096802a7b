"""Process groups and collectives for multi-GPU training and evaluation.

Counterpart of ``openscene_tpu/parallel/mesh.py`` (the reference's DDP/NCCL
stack, run/distill.py:105-150) on ``torch.distributed``.  The JAX package
runs one program over a device mesh; here every GPU runs a process of its
own (torchrun's idiom), and the mesh is a set of process groups over the
ranks, laid out row-major as the JAX ``Mesh((data, model))`` lays out its
devices: ``rank = data_index * model + model_index``.

* ``data`` axis: each rank takes its own slice of the global batch (or its
  own scenes in evaluation).  After the backward the train steps average the
  gradients over the rank's data group (one flat fp32 buffer, one
  ``all_reduce``), then after the update the BatchNorm running statistics
  and the loss, as the JAX step's ``pmean(..., "data")`` does.  BatchNorm's
  batch statistics stay local to each rank, as in the JAX package.
* ``model`` axis (optional, the distill head only): the output channels of
  the 768-d head are split over the ranks of a model group (``final`` is
  (1, C, D/m) on each, with the matching targets, text columns and Adam
  moments).  The losses finish their sums over D with :func:`group_sum`,
  whose backward passes the cotangent through unchanged: each rank's loss is
  the same number, so the cotangent of a summed partial is the cotangent of
  the sum.  The head's input goes through :func:`grad_sum` (identity
  forward, gradient summed over the model group), so the backbone of every
  model rank backpropagates the whole head's cotangent.  Every rank's
  gradients are then the complete gradients of its data shard's loss (its
  own head columns for ``final``), and the one average over the data group
  serves every parameter.  The JAX step reaches the same update through
  ``shard_map``'s transposes and its ``pmean`` over ``model`` and
  ``/ n_model`` on ``final`` (openscene_tpu/runtime/distill.py:196-211).

A process group comes from torchrun's environment, from the config's
``coordinator_address``/``num_processes``/``process_id``
(:func:`maybe_initialize_distributed`), or from the entry points' own local
launch (:mod:`.launch`).  NCCL carries it on CUDA and gloo on the CPU.  The
collectives here are ``all_reduce`` and ``broadcast`` on tensors, which
gloo also runs on CUDA tensors, and the object collectives, which pickle
host objects.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device


def maybe_initialize_distributed(cfg=None, device=None,
                                 backend: Optional[str] = None) -> bool:
    """Join the process group of a multi-process run, once per process,
    before the run touches the device; returns whether a process group
    exists.

    The group is torchrun's when its environment is set (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks
    the card), else the config's: ``coordinator_address`` (``host:port``)
    with ``num_processes`` ranks, this one ``process_id``.  Without either
    nothing happens.  ``backend``: NCCL for a CUDA ``device``, gloo on the
    CPU, unless named (gloo also takes CUDA tensors, which lets two ranks
    share one card)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        kw = {"init_method": "env://"}
    elif cfg is not None and getattr(cfg, "coordinator_address", ""):
        addr = cfg.coordinator_address
        n, pid = int(cfg.num_processes), int(cfg.process_id)
        if n < 1 or not 0 <= pid < n:
            raise ValueError(
                f"coordinator_address {addr!r} needs num_processes >= 1 and "
                f"0 <= process_id < num_processes (got {n}, {pid})")
        kw = {"init_method": addr if "://" in addr else f"tcp://{addr}",
              "world_size": n, "rank": pid}
    else:
        return False
    dev = resolve_device(device)
    dist.init_process_group(backend or default_backend(dev), **kw)
    quiet_other_ranks()
    return True


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def quiet_other_ranks() -> None:
    """Only rank 0 logs progress; the others log warnings and errors."""
    if dist.get_rank() != 0:
        logging.getLogger("main-logger").setLevel(logging.WARNING)


@dataclass(frozen=True)
class Mesh:
    """This rank's place on a ``data`` x ``model`` mesh of process groups:
    ``data_group`` holds the ranks of this rank's model index (the ranks a
    gradient is averaged over), ``model_group`` those of its data index
    (the ranks that split the head's columns).  ``device`` is the rank's
    device, where the small tensors of the collectives live."""
    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Any
    model_group: Any

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def mesh_layout(data: int, model: int
                ) -> Tuple[List[List[int]], List[List[int]]]:
    """``(data groups, model groups)`` of a row-major ``data`` x ``model``
    mesh as rank lists: data group ``m`` holds the ranks of model index
    ``m``, model group ``d`` those of data index ``d``."""
    data_groups = [[d * model + m for d in range(data)] for m in range(model)]
    model_groups = [[d * model + m for m in range(model)]
                    for d in range(data)]
    return data_groups, model_groups


def get_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """The mesh over the process group (``data=-1``: every rank the model
    axis leaves).  Creates every subgroup on every rank in the same order,
    as ``torch.distributed.new_group`` requires."""
    world = dist.get_world_size()
    if data == -1:
        data = world // max(model, 1)
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    data_ranks, model_ranks = mesh_layout(data, model)
    data_groups = [dist.new_group(r) for r in data_ranks]
    model_groups = [dist.new_group(r) for r in model_ranks]
    rank = dist.get_rank()
    return Mesh(data=data, model=model, rank=rank,
                device=resolve_device(device),
                data_group=data_groups[rank % model],
                model_group=model_groups[rank // model])


def mesh_for(entry: str, data_parallel: int, model_parallel: int = 1,
             device=None, batch_size: Optional[int] = None
             ) -> Optional[Mesh]:
    """The mesh an entry point's ``data_parallel`` and ``model_parallel``
    ask for, or None for one process without a process group.

    ``data_parallel=-1`` takes every rank the model axis leaves, capped at
    ``batch_size`` scenes (the reference divides the global batch over the
    ranks); ``1`` is one rank.  The mesh must cover the process group
    exactly: a run that asks for more ranks than it was started with
    raises, naming the ways to start them."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = max(model_parallel, 1)
    n = world // model if data_parallel == -1 else max(data_parallel, 1)
    if data_parallel == -1 and batch_size is not None:
        n = min(n, max(batch_size, 1))
    if n * model != world:
        found = (f"the process group has {world} ranks"
                 if dist.is_initialized() else "this process has none")
        raise RuntimeError(
            f"multi-GPU {entry}: data_parallel={data_parallel} x "
            f"model_parallel={model} needs a process group of {n * model} "
            f"ranks and {found}; launch it with `torchrun --nproc_per_node "
            f"{n * model} -m openscene_tpu_torch.runtime.{entry} ...` (or "
            f"set coordinator_address, num_processes and process_id), or "
            f"through openscene_tpu_torch.runtime.{entry}.main, which "
            f"starts the ranks itself")
    if not dist.is_initialized():
        return None
    return get_mesh(n, model, device)


def model_axis_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.model


def replicate(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Every parameter and buffer of ``module`` takes rank 0's values."""
    if mesh is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


# ---- the head's columns on the model axis ----

def head_columns(mesh: Mesh, width: int) -> slice:
    """This rank's columns of a ``width``-wide head dimension."""
    if width % mesh.model:
        raise ValueError(f"model_parallel={mesh.model} must divide the "
                         f"head's width {width}")
    s = width // mesh.model
    return slice(mesh.model_index * s, (mesh.model_index + 1) * s)


def head_shard(t, mesh: Optional[Mesh]):
    """This rank's columns (last dimension) of a full-width head tensor
    (weights, Adam moments, targets, text embeddings); ``t`` itself without
    a model axis."""
    if model_axis_size(mesh) == 1:
        return t
    return t[..., head_columns(mesh, t.shape[-1])]


def shard_head(model: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Replace ``model.final`` (1, C, D) by this rank's (1, C, D/m)
    columns.  Before the optimizer is made: it holds the parameter."""
    if model_axis_size(mesh) > 1:
        model.final = torch.nn.Parameter(
            head_shard(model.final.detach(), mesh).clone())


def gather_head(shard: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The full-width tensor of the model group's column shards (every
    rank of the group calls it): each rank's shard at its columns, zeros
    elsewhere, summed over the group."""
    if model_axis_size(mesh) == 1:
        return shard
    width = shard.shape[-1] * mesh.model
    full = shard.new_zeros(shard.shape[:-1] + (width,))
    full[..., head_columns(mesh, width)] = shard
    dist.all_reduce(full, group=mesh.model_group)
    return full


# ---- collectives of the steps ----

class _GroupSum(torch.autograd.Function):
    """Sum over a group; the backward passes the cotangent unchanged (every
    rank computes the same function of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradSum(torch.autograd.Function):
    """Identity; the backward sums the cotangent over a group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def group_sum(tensors: Sequence[torch.Tensor], group
              ) -> Tuple[torch.Tensor, ...]:
    """Each tensor summed over ``group`` in fp32 (one ``all_reduce`` of the
    flattened tensors; ``group`` None: the tensors as they are), with the
    backward of :class:`_GroupSum`: the losses' sums over the head's D."""
    if group is None:
        return tuple(tensors)
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    flat = _GroupSum.apply(flat, group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return tuple(out)


def grad_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, with its gradient summed over ``group`` (None: ``x``): the
    head's input when its columns are split over the model group."""
    return x if group is None else _GradSum.apply(x, group)


def _flat_mean_(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Replace each tensor by its mean over the data group: one fp32
    buffer, one ``all_reduce``."""
    if not tensors:
        return
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.data
    at = 0
    for t in tensors:
        t.data.copy_(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()


def average_gradients(params: Sequence[torch.nn.Parameter],
                      mesh: Mesh) -> None:
    """Every gradient averaged over the data group (a missing gradient
    counts as zeros, so every rank sends the same layout)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _flat_mean_([p.grad for p in params], mesh)


def average_buffers(module: torch.nn.Module, mesh: Mesh) -> None:
    """BatchNorm's running statistics averaged over the data group."""
    _flat_mean_(list(module.buffers()), mesh)


def mean_over_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    out = x.detach().float().clone()
    dist.all_reduce(out, group=mesh.data_group)
    return out / mesh.data


def sum_over_data(tensors: Sequence[torch.Tensor], mesh: Mesh
                  ) -> Tuple[torch.Tensor, ...]:
    """Each (integer or float) tensor summed over the data group."""
    out = []
    for t in tensors:
        t = t.clone()
        dist.all_reduce(t, group=mesh.data_group)
        out.append(t)
    return tuple(out)


def all_gather_rows(row: Sequence[int], mesh: Mesh) -> List[List[int]]:
    """Each data rank's ``row`` of integers (all the same length), in data
    order: each rank writes its row into zeros, summed over the group."""
    rows = torch.zeros((mesh.data, len(row)), dtype=torch.int64,
                       device=mesh.device)
    rows[mesh.data_index] = torch.as_tensor(list(row), dtype=torch.int64)
    dist.all_reduce(rows, group=mesh.data_group)
    return rows.cpu().tolist()


def gather_to_main(obj, mesh: Mesh) -> Optional[list]:
    """Every data rank's ``obj`` (a picklable host object) in data order on
    the group's first rank, None on the others."""
    out = [None] * mesh.data if mesh.data_index == 0 else None
    dist.gather_object(obj, out, dst=mesh.model_index,
                       group=mesh.data_group)
    return out


def broadcast_from_main(obj, mesh: Mesh):
    """Rank 0's ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
