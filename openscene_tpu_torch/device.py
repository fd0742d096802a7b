"""Device resolution for the port's entry points.

Entry points take a ``device`` argument and run on ``cuda`` unless the
caller asks for the CPU.  Asking for CUDA (explicitly or by default) on a
machine without it raises: nothing silently carries on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``.  Raises if CUDA is requested but unavailable.

    On CUDA it also pins the matmul numerics the port relies on: fp32
    matmuls in full fp32 (no TF32) and bf16 matmuls with fp32 reductions.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda is not "
                "available; pass device='cpu' to run on the CPU")
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
