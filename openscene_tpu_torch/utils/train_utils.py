"""Training utilities: schedules, meters, checkpointing, logging.

Counterpart of ``openscene_tpu/utils/train_utils.py``.  Parity targets:
``poly_learning_rate`` (util/util.py:111-114), AverageMeter
(util/util.py:86-102), and last/best checkpointing with
{epoch, model, optimizer, best_iou} (util/util.py:18-22,
run/distill.py:234-242), serialized with ``torch.save``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from os.path import join
from typing import Any, Dict

import torch


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
