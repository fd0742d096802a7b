"""Logging helper shared by the port's runtimes (counterpart of
``openscene_tpu/utils/train_utils.py``; the trainer's meters, schedules and
checkpoints come with the training slice)."""

from __future__ import annotations

import logging


def get_logger(name: str = "main-logger") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        handler = logging.StreamHandler()
        fmt = "[%(asctime)s %(filename)s line %(lineno)d] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
    return logger
