"""Device resolution for the port's entry points.

Entry points take a ``device`` argument and run on ``cuda`` unless the
caller asks for the CPU.  Asking for CUDA (explicitly or by default) on a
machine without it raises: nothing silently carries on on the CPU.  A
process of a multi-GPU run takes the card of its ``LOCAL_RANK``
(``parallel/launch.py``, torchrun).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``.  Raises if CUDA is requested but unavailable.

    ``cuda`` without an index is this process's card, ``cuda:LOCAL_RANK``
    (``LOCAL_RANK`` 0 when unset); a card named by its index is taken as
    named, so ranks share a card only when a caller asks for it.  Raises if
    the index is not a card of the host.  The card becomes the current
    device (the kernels launch on the current device).

    On CUDA it also pins the matmul numerics the port relies on: fp32
    matmuls in full fp32 (no TF32) and bf16 matmuls with fp32 reductions.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda is not "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but this host has "
                f"{torch.cuda.device_count()} CUDA device(s) (LOCAL_RANK "
                f"{os.environ.get('LOCAL_RANK', 'unset')})")
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def device_geometry_on(setting: str, device: torch.device) -> bool:
    """Whether a step builds its geometry on the device, by the config's
    ``device_geometry``: ``auto`` is on for a CUDA device and off on the
    CPU; ``on`` also works on the CPU."""
    dg = str(setting).lower()
    return (device.type == "cuda" if dg == "auto"
            else dg in ("on", "true", "1"))
