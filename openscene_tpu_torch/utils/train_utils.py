"""Training utilities: schedules, meters, checkpointing, logging.

Counterpart of ``openscene_tpu/utils/train_utils.py``.  Parity targets:
``poly_learning_rate`` (util/util.py:111-114), AverageMeter
(util/util.py:86-102), and last/best checkpointing with
{epoch, model, optimizer, best_iou} (util/util.py:18-22,
run/distill.py:234-242), serialized with ``torch.save``.  The JAX
package's flax-msgpack checkpoints are read too (:func:`read_checkpoint`),
by the port's own decoder (:mod:`.flax_msgpack`).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from os.path import join
from typing import Any, Dict, Tuple

import torch

from . import flax_msgpack


def step_learning_rate(base_lr: float, epoch: int, step_epoch: int,
                       multiplier: float = 0.1) -> float:
    return base_lr * (multiplier ** (epoch // step_epoch))


def poly_learning_rate(base_lr: float, curr_iter: int, max_iter: int,
                       power: float = 0.9) -> float:
    return base_lr * (1 - float(curr_iter) / max_iter) ** power


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def get_logger(name: str = "main-logger") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        handler = logging.StreamHandler()
        fmt = "[%(asctime)s %(filename)s line %(lineno)d] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
    return logger


class ScalarWriter:
    """Append-only scalar log (tensorboard stand-in): one JSONL file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = join(logdir, "scalars.jsonl")

    def add_scalar(self, tag: str, value: float, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step), "t": time.time()}) + "\n")

    def close(self):
        pass


def save_checkpoint(payload: Dict[str, Any], is_best: bool, save_dir: str,
                    filename: str = "model_last.ckpt") -> str:
    """``torch.save`` the payload ({epoch, model, optimizer, best_iou} with
    ``model``/``optimizer`` as state dicts); copy to model_best on
    improvement (util/util.py:18-22)."""
    os.makedirs(save_dir, exist_ok=True)
    path = join(save_dir, filename)
    torch.save(payload, path)
    if is_best:
        shutil.copyfile(path, join(save_dir, "model_best.ckpt"))
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Restore a payload written by :func:`save_checkpoint`, on the CPU;
    ``load_state_dict`` moves the tensors to their modules' devices."""
    return torch.load(path, map_location="cpu", weights_only=False)


def load_flax_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint written by the JAX package's ``save_checkpoint``
    (``openscene_tpu/utils/train_utils.py``): the payload
    ``{epoch, params, state, opt_state, best_iou}`` as a tree of NumPy
    arrays (``epoch`` and ``best_iou`` 0-d), flax's list maps rebuilt into
    lists.  ``convert.params_from_jax`` maps ``params``/``state`` onto the
    port's model, ``convert.optimizer_state_from_optax`` ``opt_state`` onto
    its optimizer.  Raises ValueError when the file is no such msgpack."""
    with open(path, "rb") as f:
        tree = flax_msgpack.loads(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: a flax checkpoint holds a map at its top, "
                         f"not {type(tree).__name__}")
    return flax_msgpack.rebuild_lists(tree)


def read_checkpoint(path: str) -> Tuple[Dict[str, Any], bool]:
    """``(payload, is_flax)`` of a checkpoint file: the JAX package's
    flax-msgpack payload (:func:`load_flax_checkpoint`), or whatever
    ``torch.load`` reads (the port's own checkpoints, state dicts, reference
    checkpoints)."""
    with open(path, "rb") as f:
        head = f.read(1)
    if flax_msgpack.looks_like_msgpack_map(head):
        try:
            return load_flax_checkpoint(path), True
        except ValueError as e:
            raise ValueError(f"{path} is not a readable flax-msgpack "
                             f"checkpoint: {e}") from e
    return torch.load(path, map_location="cpu", weights_only=False), False
